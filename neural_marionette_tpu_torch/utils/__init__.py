"""Console reporting and the preemption flag of the training CLI."""
