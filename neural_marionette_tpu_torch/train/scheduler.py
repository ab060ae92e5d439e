"""Loss/module activity scheduling across epochs.

The port's copy of ``neural_marionette_tpu/train/scheduler.py``, host code
as it stands: reference `utils/train_utils.py:20-97` (``LOSS_SCHEDULER``).
Milestone intervals derived from per-loss (start, end) windows select which
losses are optimised and which modules are active at each epoch. The
trainer keeps one step per phase, keyed by :meth:`LossScheduler.phase_key`.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

from ..config import MarionetteConfig
from .losses import LOSS_LIST, anneal_epochs, loss_weights, \
    module_active_epochs

_INF = float("inf")


def _normalize_interval(iv):
    start, end = iv
    if start == -1:
        return (_INF, _INF)
    if end == -1:
        return (start, _INF)
    return (start, end)


@dataclass
class LossScheduler:
    cfg: MarionetteConfig
    loss_names: list = field(default_factory=list)
    milestones: list = field(default_factory=list)
    loss_names_anneal: list = field(default_factory=list)
    module_actives: dict = field(default_factory=dict)
    current_loss_names: list = field(default_factory=list)
    affinity_active: bool = False

    def __post_init__(self):
        cfg = self.cfg
        self.loss_names = list(LOSS_LIST)
        self.weights = loss_weights(cfg)
        anneal = anneal_epochs(cfg)
        checkpoints = {0, _INF}
        for start, end in anneal.values():
            if start >= 0:
                checkpoints.add(start)
            if end >= 0:
                checkpoints.add(end)
        self.milestones = sorted(checkpoints)
        self.loss_names_anneal = [[] for _ in range(len(self.milestones) - 1)]
        for idx, m_start in enumerate(self.milestones[:-1]):
            m_end = self.milestones[idx + 1]
            for name in self.loss_names:
                start, end = anneal[name]
                if start <= m_start and (end >= m_end or end == -1):
                    self.loss_names_anneal[idx].append(name)

        self.module_active_epochs = {
            k: _normalize_interval(v)
            for k, v in module_active_epochs(cfg).items()}
        self.module_actives = {k: False for k in self.module_active_epochs}

    def anneal(self, epoch_id: int) -> None:
        for name, (start, end) in self.module_active_epochs.items():
            if start <= epoch_id < end:
                self.module_actives[name] = True
            elif epoch_id >= end:
                self.module_actives[name] = False
        for idx, m_start in enumerate(self.milestones[:-1]):
            m_end = self.milestones[idx + 1]
            if m_start <= epoch_id < m_end:
                self.current_loss_names = self.loss_names_anneal[idx]
        # affinity gate (reference KyptDetector.anneal, kypt_detector.py:71)
        if self.cfg.keypoints_graph == "affinity_params" \
                and epoch_id >= self.cfg.affinity_anneal:
            self.affinity_active = True

    def active_weights(self) -> dict[str, float]:
        """Weight per loss: configured weight if active this phase, else 0."""
        return {name: (self.weights[name]
                       if name in self.current_loss_names else 0.0)
                for name in self.loss_names}

    def learning_rate(self, epoch_id: int) -> float:
        """Staged LR: lrate, lrate/4 @ firstdecay, lrate/10 @ seconddecay
        (reference train.py:366-374)."""
        cfg = self.cfg
        if epoch_id < cfg.firstdecay:
            return cfg.lrate
        if epoch_id < cfg.seconddecay:
            return cfg.lrate / 4.0
        return cfg.lrate / 10.0

    def phase_key(self):
        """Hashable key of the current phase (one train step each)."""
        return (self.module_actives["detector"],
                self.module_actives["learner"],
                self.affinity_active,
                tuple(sorted(self.current_loss_names)))


class MetricLogger:
    """Per-key running means per epoch (reference LOGGER,
    utils/train_utils.py:215-245)."""

    def __init__(self):
        self.history = []
        self.data = {}

    def add(self, key, val):
        self.data.setdefault(key, []).append(float(val))

    def add_dict(self, metrics):
        for k, v in metrics.items():
            self.add(k, v)

    def mean(self, key):
        vals = self.data.get(key, [])
        return sum(vals) / len(vals) if vals else math.nan

    def reset(self):
        epoch_means = {k: self.mean(k) for k in self.data if self.data[k]}
        self.history.append(epoch_means)
        self.data = {}
        return epoch_means
