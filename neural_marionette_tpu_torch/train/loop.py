"""The training loop: the counterpart of the training part of the JAX
package's ``train.py`` (its epoch loop, ``train.py:192-267``).

    from neural_marionette_tpu_torch.train import Trainer
    trainer = Trainer(cfg)                     # on "cuda", weights from cfg.seed
    for record in trainer.fit(batches):        # re-iterated every epoch
        print(record["epoch"], record["train"]["total_loss"])

``batches`` yields ``(B, T, N, 3)`` float32 point batches (numpy arrays or
tensors); they are voxelized on the device. Per epoch the trainer anneals
the scheduler, extracts the skeleton once when the learner first turns on
(on the host, ``skeleton.extract_skeleton``, from the trained affinity),
sets the staged learning rate (and resets Adam when
``cfg.opt_reset_per_epoch``), keeps one step per scheduler phase, and reads
the step metrics back only every ``_READBACK_EVERY`` steps and at the end
of the epoch, so the host does not wait for the card on every step. With a
``logger_path`` it checkpoints every ``cfg.save_every`` epochs and resumes
from there: from the latest checkpoint, or from epoch ``cfg.resume_epoch``
when that is not ``"0"``.

Two-phase training (reference ``train.py:238-278``, the JAX package's
``train.py:148-181``): a run with ``cfg.pretrained_mode == 1`` (the
dynamics run, ``derive_training_id``) and no checkpoint of its own starts
from a detector run's detector, read from
``<cfg.pretrained_dir>/detector/<cfg.dataset>_detector``, a directory of
the port's checkpoints (``checkpoint.load_params_only``) or, failing that,
the same path plus ``.pth`` in the reference's layout
(``weights.load_reference_detector``). The dynamics keep their initial
values; the schedule keeps the detector frozen from epoch 0, and the
skeleton is extracted from the loaded affinity as the learner turns on.

The dataset families, the loader, validation and the CLI come in later
slices.
"""
from __future__ import annotations

import os
import time
from typing import Iterable, Iterator, Optional

import numpy as np
import torch

from ..api import _DTYPES, resolve_device
from ..config import MarionetteConfig
from ..models import NeuralMarionette, SkeletonArrays
from ..skeleton import Skeleton, extract_skeleton
from ..weights import (init_weights, load_detector_state,
                       load_reference_detector)
from .checkpoint import CheckpointManager, load_params_only
from .scheduler import LossScheduler, MetricLogger
from .state import create_train_state, reset_optimizer, set_learning_rate
from .step import make_generate_step, make_train_step

# Steps between two reads of the step metrics to the host (train.py:255).
_READBACK_EVERY = 50


class Trainer:
    """A model, its train state and scheduler, and the steps per phase."""

    def __init__(self, cfg: MarionetteConfig, device=None,
                 dtype: str = "bfloat16",
                 model: Optional[NeuralMarionette] = None,
                 logger_path: Optional[str] = None,
                 conv_kernel: bool = False):
        """``conv_kernel`` routes the eligible bfloat16 convs of the model it
        builds through kernel K3 (the JAX package's ``NM_PALLAS_CONV=1``);
        a ``model`` passed in keeps its own route."""
        if dtype not in _DTYPES:
            raise ValueError(f"dtype must be one of {sorted(_DTYPES)}")
        self.cfg = cfg
        self.device = resolve_device(device)
        if model is None:
            model = NeuralMarionette(cfg, dtype=_DTYPES[dtype],
                                     device=self.device,
                                     conv_kernel=conv_kernel)
            init_weights(model, torch.Generator().manual_seed(cfg.seed))
        self.model = model
        self.sched = LossScheduler(cfg)
        self.sched.anneal(0)
        self.state = create_train_state(
            cfg, model,
            torch.Generator(self.device).manual_seed(cfg.seed + 2))
        self.skeleton: Optional[Skeleton] = None
        self.train_log = MetricLogger()
        self.start_epoch = 0
        self._steps: dict = {}
        self._gen_steps: dict = {}
        self.ckpt = None
        latest = None
        if logger_path is not None:
            self.ckpt = CheckpointManager(logger_path, cfg.save_que_len)
            latest = self.ckpt.latest_epoch()
        want = None if cfg.resume_epoch == "0" else int(cfg.resume_epoch)
        if want is not None and latest is None:
            raise ValueError("No previous checkpoints from this setting.")
        if latest is not None:
            _, self.skeleton, meta = self.ckpt.restore(self.state, want)
            self.start_epoch = meta["epoch"] + 1
        elif cfg.pretrained_mode == 1:
            self.load_pretrained_detector()

    def load_pretrained_detector(self) -> None:
        """Load the detector run's detector into the model (the dynamics run
        of ``pretrained_mode=1``)."""
        cfg = self.cfg
        pre = os.path.join(cfg.pretrained_dir, "detector",
                           f"{cfg.dataset}_detector")
        if os.path.isdir(pre):
            state, _, _ = load_params_only(pre)
            load_detector_state(self.model, state, source=pre)
        elif os.path.exists(pre + ".pth"):
            load_reference_detector(pre + ".pth", self.model)
        else:
            raise ValueError(f"pretrained file is not existing: {pre}")

    # ------------------------------------------------------------ helpers
    def _to_device(self, batch) -> torch.Tensor:
        host = torch.as_tensor(np.asarray(batch, dtype=np.float32))
        if self.device.type == "cuda":
            return host.pin_memory().to(self.device, non_blocking=True)
        return host.to(self.device)

    def extract_skeleton(self) -> Skeleton:
        """The skeleton of the current affinity, on the host."""
        with torch.no_grad():
            aff = self.model.kypt_detector.get_affinity()
        return extract_skeleton(aff.cpu().numpy())

    def phase_step(self):
        """The train step of the scheduler's current phase (made once)."""
        key = self.sched.phase_key()
        if key not in self._steps:
            s = self.sched
            self._steps[key] = make_train_step(
                self.model, self.cfg, s.active_weights(),
                s.module_actives["detector"], s.module_actives["learner"],
                s.affinity_active)
        return self._steps[key]

    def phase_generate_step(self):
        """The generate step of the scheduler's current phase (made once),
        or None while the learner is off, as the JAX training loop makes it
        beside the phase's train step (``train.py:228``). That loop runs it
        on the first validation batch; validation is not ported yet."""
        s = self.sched
        if not s.module_actives["learner"]:
            return None
        key = s.phase_key()
        if key not in self._gen_steps:
            self._gen_steps[key] = make_generate_step(
                self.model, self.cfg, s.affinity_active)
        return self._gen_steps[key]

    def phase_skeleton(self) -> Optional[SkeletonArrays]:
        """The skeleton the steps take, on the device (None until the
        learner first turns on)."""
        if self.skeleton is None:
            return None
        return SkeletonArrays.from_skeleton(self.skeleton, self.device)

    def _flush(self, pending: list) -> None:
        """Read the pending steps' metrics in one copy to the host."""
        if not pending:
            return
        keys = list(pending[0])
        rows = torch.stack([torch.stack([m[k].float() for k in keys])
                            for m in pending]).cpu().numpy()
        for row in rows:
            self.train_log.add_dict(dict(zip(keys, row)))
        pending.clear()

    # --------------------------------------------------------------- loop
    def train_epoch(self, epoch_id: int, batches: Iterable) -> dict:
        """One epoch over ``batches``; returns its record (epoch, lr,
        seconds, the mean of each metric over the steps, phase)."""
        t0 = time.time()
        sched = self.sched
        sched.anneal(epoch_id)
        if sched.module_actives["learner"] and self.skeleton is None:
            self.skeleton = self.extract_skeleton()
        sk = self.phase_skeleton()
        step = self.phase_step()
        lr = sched.learning_rate(epoch_id)
        set_learning_rate(self.state, lr)
        if self.cfg.opt_reset_per_epoch:
            reset_optimizer(self.cfg, self.state)
        pending = []
        for batch_id, batch in enumerate(batches):
            pending.append(step(self.state, self._to_device(batch), sk))
            if (batch_id + 1) % _READBACK_EVERY == 0:
                self._flush(pending)
        self._flush(pending)
        record = {"epoch": epoch_id, "lr": lr, "time": time.time() - t0,
                  "phase": {"detector": sched.module_actives["detector"],
                            "learner": sched.module_actives["learner"],
                            "affinity": sched.affinity_active},
                  "train": self.train_log.reset()}
        if self.ckpt is not None and epoch_id % self.cfg.save_every == 0:
            self.ckpt.save(epoch_id, self.state, self.skeleton)
        return record

    def fit(self, batches: Iterable,
            nepoch: Optional[int] = None) -> Iterator[dict]:
        """Epochs ``start_epoch .. nepoch-1`` (default ``cfg.nepoch``) over
        ``batches``, re-iterated each epoch; yields each epoch's record."""
        for epoch_id in range(self.start_epoch,
                              self.cfg.nepoch if nepoch is None else nepoch):
            yield self.train_epoch(epoch_id, batches)
            self.start_epoch = epoch_id + 1
