"""The training loop: the counterpart of the training part of the JAX
package's ``train.py`` (its epoch loop, ``train.py:192-267``).

    from neural_marionette_tpu_torch.train import Trainer
    trainer = Trainer(cfg)                     # on "cuda", weights from cfg.seed
    for record in trainer.fit(batches):        # re-iterated every epoch
        print(record["epoch"], record["train"]["total_loss"])

``batches`` yields ``(B, T, N, 3)`` float32 point batches (numpy arrays or
tensors; a tensor already on the trainer's device is used without a copy),
or ``(points, joints)`` tuples as the loader of an ``is_eval`` dataset
yields them (the points train, as ``train.py:249``); the points are
voxelized on the device. Per epoch the trainer anneals
the scheduler, extracts the skeleton once when the learner first turns on
(on the device, ``skeleton_device``, from the trained affinity),
sets the staged learning rate (and resets Adam when
``cfg.opt_reset_per_epoch``), keeps one step per scheduler phase, and reads
the step metrics back only every ``_READBACK_EVERY`` steps and at the end
of the epoch, so the host does not wait for the card on every step (with
``cfg.debug_nans`` every step is checked for non-finite values). With a
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

:meth:`Trainer.validate` runs the phase's eval step over validation
batches and scores them (``eval.py``), as the JAX ``train.py:271-306``
does; the training CLI (``cli/train.py``) puts the loaders, validation,
the logs and the result files around the trainer.
"""
from __future__ import annotations

import os
import time
from typing import Iterable, Iterator, Optional, Sequence

import numpy as np
import torch

from ..api import _DTYPES, resolve_device
from ..config import MarionetteConfig
from ..eval import evaluate
from ..models import NeuralMarionette, SkeletonArrays
from ..ops.voxelize import voxelize
from ..skeleton import Skeleton
from ..skeleton_device import extract_skeleton_host_api
from ..weights import (init_weights, load_detector_state,
                       load_reference_detector)
from .checkpoint import CheckpointManager, load_params_only
from .scheduler import LossScheduler, MetricLogger
from .state import create_train_state, reset_optimizer, set_learning_rate
from .step import make_eval_step, make_generate_step, make_train_step

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
        self.valid_log = MetricLogger()
        #: running scores of the eval metrics over every validation so far
        #: (the semantic histogram, the voxel_chamfer values), as the JAX
        #: ``train.py`` keeps them across epochs
        self.eval_scores: dict = {}
        #: host ms of the last :meth:`validate`'s parts, and the share of
        #: recon voxels at or above 0.5 that ``voxel_chamfer`` saw
        self.validation_stats: dict = {}
        #: the first validation batch of the last :meth:`validate`: its
        #: points, its eval-step tensors (recon, keypoints, affinity) and,
        #: in a learner phase, the generate step's output on it; what the
        #: training CLI's GIFs draw
        self.first_batch: Optional[dict] = None
        #: host ms of each epoch's GIF logging (the training CLI's)
        self.gif_ms: dict = {}
        self.start_epoch = 0
        self._steps: dict = {}
        self._eval_steps: dict = {}
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
        """The points of a batch as a float32 tensor on the steps' device:
        the first element of a ``(points, joints)`` tuple; a tensor that is
        already there as it is, without a copy."""
        if isinstance(batch, tuple):
            batch = batch[0]
        if isinstance(batch, torch.Tensor):
            return batch.to(self.device, torch.float32)
        host = torch.from_numpy(np.ascontiguousarray(batch,
                                                     dtype=np.float32))
        if self.device.type == "cuda":
            return host.pin_memory().to(self.device, non_blocking=True)
        return host

    def extract_skeleton(self) -> Skeleton:
        """The skeleton of the current affinity, extracted on the
        trainer's device (``skeleton_device``, as the JAX ``train.py``);
        ``affinity_ver`` 4 draws its Gumbel noise from a generator seeded
        with ``cfg.seed`` (the JAX ``train.py``'s ``PRNGKey(cfg.seed)``)."""
        gumbel = torch.Generator(self.device).manual_seed(self.cfg.seed)
        with torch.no_grad():
            aff = self.model.kypt_detector.get_affinity(generator=gumbel)
        return extract_skeleton_host_api(aff)

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

    def phase_eval_step(self):
        """The eval step of the scheduler's current phase (made once)."""
        key = self.sched.phase_key()
        if key not in self._eval_steps:
            s = self.sched
            self._eval_steps[key] = make_eval_step(
                self.model, self.cfg, s.active_weights(),
                s.module_actives["detector"], s.module_actives["learner"],
                s.affinity_active)
        return self._eval_steps[key]

    def phase_generate_step(self):
        """The generate step of the scheduler's current phase (made once),
        or None while the learner is off, as the JAX training loop makes it
        beside the phase's train step (``train.py:228``); :meth:`validate`
        runs it on the first validation batch, for the GIFs of the
        training CLI."""
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

    def _flush(self, pending: list, log: Optional[MetricLogger] = None
               ) -> None:
        """Read the pending steps' metrics in one copy to the host."""
        if not pending:
            return
        keys = list(pending[0])
        rows = torch.stack([torch.stack([m[k].float() for k in keys])
                            for m in pending]).cpu().numpy()
        for row in rows:
            (log or self.train_log).add_dict(dict(zip(keys, row)))
        pending.clear()

    def _enter_epoch(self, epoch_id: int) -> None:
        """Anneal the scheduler to ``epoch_id``; extract the skeleton once,
        when the learner first turns on."""
        self.sched.anneal(epoch_id)
        if self.sched.module_actives["learner"] and self.skeleton is None:
            self.skeleton = self.extract_skeleton()

    # --------------------------------------------------------------- loop
    def train_epoch(self, epoch_id: int, batches: Iterable) -> dict:
        """One epoch over ``batches``; returns its record (epoch, lr,
        seconds, the mean of each metric over the steps, phase)."""
        t0 = time.time()
        sched = self.sched
        self._enter_epoch(epoch_id)
        sk = self.phase_skeleton()
        step = self.phase_step()
        lr = sched.learning_rate(epoch_id)
        set_learning_rate(self.state, lr)
        if self.cfg.opt_reset_per_epoch:
            reset_optimizer(self.cfg, self.state)
        pending = []
        for batch_id, batch in enumerate(batches):
            if self.cfg.debug_nans:
                pending.append(self._checked_step(
                    step, self._to_device(batch), sk, epoch_id, batch_id))
            else:
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

    def _checked_step(self, step, batch, sk, epoch_id: int, batch_id: int):
        """One train step for ``cfg.debug_nans`` (the JAX
        ``jax_debug_nans``): the backward under
        ``torch.autograd.detect_anomaly``, then the metrics, ``grad_norm``
        and the updated parameters checked on the device; raises
        ``FloatingPointError`` naming the step, the phase and the first
        non-finite quantity."""
        s = self.sched.module_actives
        where = (f"epoch {epoch_id} step {batch_id} (phase detector="
                 f"{s['detector']}, learner={s['learner']}, affinity="
                 f"{self.sched.affinity_active})")
        try:
            with torch.autograd.detect_anomaly(check_nan=True):
                metrics = step(self.state, batch, sk)
        except RuntimeError as e:
            if "nan" not in str(e).lower():
                raise
            raise FloatingPointError(f"{where}: backward: {e}") from e
        named = list(metrics.items()) + list(self.model.named_parameters())
        finite = torch.stack([torch.isfinite(v).all() for _, v in named])
        if not bool(finite.all()):
            name = named[int(torch.argmin(finite.to(torch.int8)))][0]
            kind = "metric" if name in metrics else "parameter"
            raise FloatingPointError(f"{where}: {kind} {name} is not finite")
        return metrics

    def validate(self, epoch_id: int, batches: Iterable,
                 eval_metrics: Sequence[str] = (),
                 eps: Optional[Sequence] = None,
                 gen_eps=None) -> tuple[dict, dict]:
        """The phase's eval step on each of ``batches`` (points, or
        ``(points, gt_joints)`` tuples), then the ``eval_metrics``
        (``"semantic"``: the keypoints against the GT joints, on batches
        that carry them; ``"voxel_chamfer"``: the recon against the points'
        voxels, kernel K1 on a card), accumulated into
        :attr:`eval_scores` as the JAX ``train.py:271-306`` does.

        Batch ``i`` draws its sample noise (and ``affinity_ver`` 4's
        Gumbel noise) from a generator seeded from ``(cfg.seed, i)`` (the
        JAX loop's ``fold_in(PRNGKey(seed), i)``), or takes ``eps[i]`` (as
        ``HSVRNNBVH.encode`` takes it). The first
        batch is kept in :attr:`first_batch`, with, in a learner phase, the
        generate step's output on it (noise from ``cfg.seed + epoch_id``,
        as ``train.py:288-291``, or ``gen_eps`` as ``HSVRNNBVH.generate``
        takes it). Returns the means over the batches of the step's
        metrics and of each metric's batch score, and the running
        scores."""
        self._enter_epoch(epoch_id)
        sk = self.phase_skeleton()
        step = self.phase_eval_step()
        G = self.cfg.grid_size
        ms = {"eval_step": 0.0, "semantic": 0.0, "voxel_chamfer": 0.0}
        occupancy, n = 0.0, 0
        gen_step = self.phase_generate_step()
        self.first_batch = None
        gen_ms = None
        for batch_id, batch in enumerate(batches):
            points, gt = batch if isinstance(batch, tuple) else (batch, None)
            pts = self._to_device(points)
            seed = int(np.random.SeedSequence(
                (self.cfg.seed, batch_id)).generate_state(1)[0])
            t0 = time.perf_counter()
            metrics, tensors = step(
                pts, sk, generator=torch.Generator(self.device).manual_seed(
                    seed), eps=None if eps is None else eps[batch_id])
            self._flush([metrics], self.valid_log)
            t1 = time.perf_counter()
            ms["eval_step"] += t1 - t0
            if batch_id == 0:
                self.first_batch = dict(points=pts, tensors=tensors, gen=None)
                if gen_step is not None:
                    self.first_batch["gen"] = gen_step(
                        pts, sk, generator=torch.Generator(
                            self.device).manual_seed(self.cfg.seed + epoch_id),
                        eps=gen_eps)
                    if self.device.type == "cuda":   # its time, not the next
                        torch.cuda.synchronize(self.device)   # part's
                    gen_ms = (time.perf_counter() - t1) * 1e3
                t1 = time.perf_counter()
            for name in eval_metrics:
                if name == "semantic":
                    if gt is None:
                        continue
                    params = dict(
                        keypoints=tensors["keypoints"].float().cpu().numpy(),
                        gt_keypoints=_host(gt))
                else:
                    recon = tensors["recon"]
                    # a host read: the card is idle from here
                    occupancy += float((recon >= 0.5).float().mean())
                    t1 = time.perf_counter()
                    params = dict(voxel=voxelize(pts, G), recon=recon)
                out = evaluate(name, self.eval_scores.get(name), params)
                self.eval_scores[name] = out["scores"]
                self.valid_log.add(name, out["scores_log"])
                t2 = time.perf_counter()
                ms[name] += t2 - t1
                t1 = t2
            n += 1
        self.validation_stats = {
            "batches": n,
            **{f"{k}_ms_per_batch": v * 1e3 / max(n, 1)
               for k, v in ms.items()},
            "recon_occupancy": (occupancy / n if n and "voxel_chamfer"
                                in eval_metrics else None),
            "generate_step_ms": gen_ms}
        return self.valid_log.reset(), self.eval_scores

    def fit(self, batches: Iterable,
            nepoch: Optional[int] = None) -> Iterator[dict]:
        """Epochs ``start_epoch .. nepoch-1`` (default ``cfg.nepoch``) over
        ``batches``, re-iterated each epoch; yields each epoch's record."""
        for epoch_id in range(self.start_epoch,
                              self.cfg.nepoch if nepoch is None else nepoch):
            yield self.train_epoch(epoch_id, batches)
            self.start_epoch = epoch_id + 1


def _host(x) -> np.ndarray:
    """A tensor (on any device) or array as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)
