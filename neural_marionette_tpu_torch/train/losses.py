"""Loss registry: names, weights, and anneal windows.

The port's own copy of ``neural_marionette_tpu/train/losses.py``, the
LOSS_LIST / LOSS_WEIGHTS / ANNEAL_EPOCHS tables of reference
train.py:173-199. Dead losses (kypt_const, graph_vol, gae_recon,
topo_recon, intensity_const) are kept in the registry so logs match the
reference surface.
"""
from __future__ import annotations

from ..config import MarionetteConfig

LOSS_LIST = [
    "recon_loss", "sparsity_loss", "separation_loss", "vol_fit_reg",
    "kypt_const_loss", "local_const_loss", "time_const_loss",
    "sparsity_const_loss", "intensity_const_loss", "graph_traj_loss",
    "graph_vol_loss", "kl_kypt", "kypt_recon_loss", "gae_recon_loss",
    "topo_recon_loss",
]

DETECTOR_LOSSES = LOSS_LIST[:11]
LEARNER_LOSSES = LOSS_LIST[11:]


def loss_weights(cfg: MarionetteConfig) -> dict[str, float]:
    return {
        "recon_loss": cfg.recon_weight,
        "sparsity_loss": cfg.sparse_weight,
        "separation_loss": cfg.sep_weight,
        "vol_fit_reg": cfg.vol_reg_weight,
        "kypt_const_loss": cfg.kypt_const_weight,
        "local_const_loss": cfg.local_const_weight,
        "time_const_loss": cfg.time_const_weight,
        "sparsity_const_loss": cfg.sparsity_const_weight,
        "intensity_const_loss": cfg.intensity_const_weight,
        "graph_traj_loss": cfg.graph_traj_weight,
        "graph_vol_loss": cfg.graph_vol_weight,
        "kypt_recon_loss": cfg.kypt_recon_weight,
        "kl_kypt": cfg.kl_kypt_weight,
        "gae_recon_loss": cfg.gae_recon_weight,
        "topo_recon_loss": cfg.topo_recon_weight,
    }


def anneal_epochs(cfg: MarionetteConfig) -> dict[str, tuple[int, int]]:
    """loss name -> (start, end) active-epoch window; end == -1 => forever.
    Reference train.py:184-193."""
    detector_time = (cfg.detector_start, cfg.detector_end)
    learner_time = (cfg.learner_start, cfg.learner_end)
    table = {name: detector_time for name in DETECTOR_LOSSES}
    table.update({name: learner_time for name in LEARNER_LOSSES})
    return table


def module_active_epochs(cfg: MarionetteConfig) -> dict[str, tuple[int, int]]:
    return {
        "detector": (cfg.detector_start, cfg.detector_end),
        "learner": (cfg.learner_start, cfg.learner_end),
    }
