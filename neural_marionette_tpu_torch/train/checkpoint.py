"""Checkpoint and resume with ``torch.save``.

Counterpart of ``neural_marionette_tpu/train/checkpoint.py``: epoch
directories ``<logger_path>/epochs/<epoch>/`` with a ring buffer of the
newest ``save_que_len`` (reference train.py:238-265, 664-673), each holding
``state.pt`` (parameters, optimizer state, the generator's state, the step)
and ``meta.json`` (the epoch, extras, and the extracted skeleton).
Restoring them continues training to the bit.

Loading the published reference ``.pth`` waits for the AIST checkpoint to
be in the repository.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Optional

import numpy as np
import torch

from ..skeleton import Skeleton
from .state import TrainState


def _epoch_dirs(ckpt_root: str) -> list[int]:
    if not os.path.isdir(ckpt_root):
        return []
    return sorted(int(name) for name in os.listdir(ckpt_root)
                  if name.isdigit())


class CheckpointManager:
    """Epoch-directory checkpoints with ring-buffer retention."""

    def __init__(self, logger_path: str, save_que_len: int = 100):
        self.ckpt_root = os.path.abspath(os.path.join(logger_path, "epochs"))
        os.makedirs(self.ckpt_root, exist_ok=True)
        self.save_que_len = save_que_len

    def save(self, epoch: int, state: TrainState,
             skeleton: Optional[Skeleton] = None,
             extra: Optional[dict[str, Any]] = None) -> None:
        existing = _epoch_dirs(self.ckpt_root)
        while len(existing) >= self.save_que_len:
            shutil.rmtree(os.path.join(self.ckpt_root, str(existing[0])))
            existing = existing[1:]
        path = os.path.join(self.ckpt_root, str(epoch))
        if os.path.exists(path):
            shutil.rmtree(path)
        tmp = path + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        torch.save({"model": state.model.state_dict(),
                    "optimizer": state.optimizer.state_dict(),
                    "generator": state.generator.get_state(),
                    "step": state.step}, os.path.join(tmp, "state.pt"))
        meta: dict[str, Any] = {"epoch": epoch}
        if extra:
            meta.update(extra)
        if skeleton is not None:
            meta["skeleton"] = {
                "A": np.asarray(skeleton.A).tolist(),
                "priority_values":
                    np.asarray(skeleton.priority_values).tolist(),
                "priority_indices":
                    np.asarray(skeleton.priority_indices).tolist(),
                "parents": np.asarray(skeleton.parents).tolist(),
            }
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        os.replace(tmp, path)  # a reader never sees half a checkpoint

    def latest_epoch(self) -> Optional[int]:
        dirs = _epoch_dirs(self.ckpt_root)
        return dirs[-1] if dirs else None

    def restore(self, state: TrainState, epoch: Optional[int] = None):
        """Load a checkpoint into ``state`` in place; ``epoch=None`` ->
        the latest. Returns (state, skeleton or None, meta)."""
        if epoch is None:
            epoch = self.latest_epoch()
        if epoch is None:
            raise FileNotFoundError(
                f"no checkpoints under {self.ckpt_root}")
        path = os.path.join(self.ckpt_root, str(epoch))
        payload = torch.load(os.path.join(path, "state.pt"),
                             map_location="cpu", weights_only=True)
        state.model.load_state_dict(payload["model"], strict=True)
        state.optimizer.load_state_dict(payload["optimizer"])
        state.generator.set_state(payload["generator"])
        state.step = int(payload["step"])
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        skeleton = None
        if "skeleton" in meta:
            sk = meta.pop("skeleton")
            skeleton = Skeleton(
                A=np.asarray(sk["A"], np.float32),
                priority_values=np.asarray(sk["priority_values"], np.float32),
                priority_indices=np.asarray(sk["priority_indices"], np.int32),
                parents=np.asarray(sk["parents"], np.int32))
        return state, skeleton, meta
