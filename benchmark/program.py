"""The system under test, as the harness takes it: the port's configuration
from a config file, the port's model with the benchmark's seeded weights,
the port's kernels built, and the counters the traced run reads off the
port's kernel entry points (by wrapping them, not by editing them)."""
from __future__ import annotations

import dataclasses

import torch

from .reference.model import make_params


DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def port_config(model_fields: dict, seed: int, **extra):
    from neural_marionette_tpu_torch.config import MarionetteConfig
    names = {f.name for f in dataclasses.fields(MarionetteConfig)}
    kw = {k: v for k, v in model_fields.items() if k in names}
    kw.update(extra, seed=int(seed))
    return MarionetteConfig(**kw)


def build_kernels(names, device) -> dict:
    """Build the port's CUDA sources ``names`` that are not built yet (into
    the port's ``_build/``, inside the checkout); nothing on the CPU."""
    if device.type != "cuda":
        return {}
    from neural_marionette_tpu_torch import kernels
    return kernels.build(tuple(names))


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device) -> int:
    return torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0


def seeded_model(cfg, model_fields: dict, seed: int, device, conv_kernel):
    """The port's model in the configuration's compute dtype with the
    benchmark's weights; returns (model, the weights as made)."""
    from neural_marionette_tpu_torch.models import NeuralMarionette
    params = make_params(model_fields, seed, device)
    model = NeuralMarionette(cfg, dtype=DTYPES[model_fields["compute_dtype"]],
                             device=device,
                             conv_kernel=conv_kernel)
    model.load_state_dict(params, strict=True)
    return model, params


class Counters:
    """Per-call records of the port's kernel entry points while installed:
    K1's shapes, K2's shapes and occupied voxels (a device count, read
    after the window), K3's operand shapes."""

    def __init__(self):
        self.k1, self.k2, self.k3 = [], [], []
        self._undo = []

    def _patch(self, module, attr, wrap):
        orig = getattr(module, attr)
        setattr(module, attr, wrap(orig))
        self._undo.append((module, attr, orig))

    def install(self):
        from neural_marionette_tpu_torch import api
        from neural_marionette_tpu_torch.ops import conv3d, losses
        from neural_marionette_tpu_torch.train import step

        def k1(orig):
            def voxelize(points, grid_size, dtype=torch.float32):
                out = orig(points, grid_size, dtype=dtype)
                self.k1.append((points.numel() // points.shape[-1]
                                // points.shape[-2], points.shape[-2],
                                grid_size, out.element_size()))
                return out
            return voxelize

        def k2(orig):
            def chamfer_num(kp, occ_flat, grid_size):
                self.k2.append((kp.shape[0], kp.shape[1], grid_size,
                                occ_flat.element_size(),
                                occ_flat.count_nonzero()))
                return orig(kp, occ_flat, grid_size)
            return chamfer_num

        def k3(orig):
            def conv(x, w, b, packed=None):
                self.k3.append((tuple(x.shape), tuple(w.shape)))
                return orig(x, w, b, packed=packed)
            return conv

        self._patch(api, "voxelize", k1)
        self._patch(step, "voxelize", k1)
        self._patch(losses, "chamfer_num", k2)
        self._patch(conv3d, "conv3d", k3)
        return self

    def remove(self):
        for module, attr, orig in reversed(self._undo):
            setattr(module, attr, orig)
        self._undo.clear()

    def k2_calls(self) -> list:
        """(frames, K, G, occupancy bytes, occupied voxels) per call."""
        return [(m, k, g, b, int(n)) for m, k, g, b, n in self.k2]

