"""Data layer: the host-side clip pipeline."""
