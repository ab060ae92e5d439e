"""Compute ops; ``voxelize`` and ``losses`` carry kernels K1 and K2."""
