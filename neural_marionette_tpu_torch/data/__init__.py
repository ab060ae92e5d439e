"""Data layer: datasets, windowing pipeline, loaders, prefetch."""
from .pipeline import (crop_sequence, episodic_normalization,
                       select_window_start, pad_short_sequence,
                       fix_point_count, window_from_sequence)
from .datasets import (DATASETS, load_dataset, PointSequenceDataset, DFAUST,
                       AIST, DeformingThings4DAnimals,
                       DeformingThings4DHumanoids, Panda, InterHand, HanCo,
                       Synthetic)
from .loader import DataLoader, prefetch_to_device

__all__ = [
    "crop_sequence", "episodic_normalization", "select_window_start",
    "pad_short_sequence", "fix_point_count", "window_from_sequence",
    "DATASETS", "load_dataset", "PointSequenceDataset", "DFAUST", "AIST",
    "DeformingThings4DAnimals", "DeformingThings4DHumanoids", "Panda",
    "InterHand", "HanCo", "Synthetic", "DataLoader", "prefetch_to_device",
]
