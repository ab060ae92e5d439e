"""Command-line entry points of the port, run as modules:

    python -m neural_marionette_tpu_torch.cli.train --dataset aist ...
    python -m neural_marionette_tpu_torch.cli.vis_generation --exp_dir ...
    python -m neural_marionette_tpu_torch.cli.vis_interpolation ...
    python -m neural_marionette_tpu_torch.cli.vis_retarget ...

Counterparts of the JAX package's ``train.py`` and ``vis_*.py`` with their
flags. Each runs on ``cuda`` and raises without a card, unless
``--platform cpu``."""
from __future__ import annotations

import torch


def platform_device(platform: str) -> torch.device:
    """``--platform``: ``cpu`` selects the CPU; ``""`` or ``cuda`` the
    card (``api.resolve_device`` raises when there is none)."""
    from ..api import resolve_device
    if platform not in ("", "cpu", "cuda"):
        raise ValueError(f"--platform must be cpu or cuda, got {platform!r}")
    return resolve_device("cpu" if platform == "cpu" else "cuda")
