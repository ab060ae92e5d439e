"""Demo applications: motion generation, interpolation and retargeting."""
