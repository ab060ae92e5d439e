"""High-level facade of the port: serving, generation, interpolation and
retargeting.

Counterpart of ``neural_marionette_tpu/api.py`` (``Marionette`` and its
streaming session), on PyTorch and CUDA:

    from neural_marionette_tpu_torch.api import Marionette
    m = Marionette.load("pretrained/aist")        # ours or reference .pth
    gen = m.generate(vox_clip, Tcond=5, Tgen=25)  # motion generation
    itp = m.interpolate(vox_clip, anchor_rate=10) # in-betweening
    ret = m.retarget(source_vox, target_points)   # motion retargeting
    with m.stream() as s:
        for result in s.run(windows):              # (B, T, N, 3) points
            consume(result["keypoints"], result["R"])

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; asked
for ``cuda`` without a card they raise.
"""
from __future__ import annotations

from typing import Iterable, Iterator, Optional, Sequence

import numpy as np
import torch

from .config import MarionetteConfig
from .models import NeuralMarionette, SkeletonArrays
from .ops.voxelize import voxelize, voxelize_np
from .skeleton import Skeleton, extract_skeleton
from .weights import init_weights, state_dict_from_jax


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("neural_marionette_tpu_torch: no CUDA device; "
                           "pass device='cpu' to run on the CPU")
    return dev


_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class Marionette:
    """A model with its weights on one device, and the cached skeleton."""

    def __init__(self, cfg: MarionetteConfig, model: NeuralMarionette,
                 device: torch.device, skeleton: Optional[Skeleton] = None):
        self.cfg = cfg
        self.model = model.eval()
        self.device = device
        self.skeleton = skeleton

    # ------------------------------------------------------------- loading
    @classmethod
    def load(cls, exp_dir: str, device=None, **overrides) -> "Marionette":
        """From an experiment directory: the port's checkpoints or the
        reference's ``opt.pickle`` + ``.pth`` (``apps.common.load_pretrained``)."""
        from .apps.common import load_pretrained
        return load_pretrained(exp_dir, device=device, **overrides)

    @classmethod
    def from_config(cls, cfg: MarionetteConfig, seed: int = 0,
                    device=None, conv_kernel: bool = False) -> "Marionette":
        """Random weights made from ``seed`` (the JAX package's initial
        distributions; not its bits). ``conv_kernel`` routes the eligible
        bfloat16 convs through kernel K3 (the JAX package's
        ``NM_PALLAS_CONV=1``); it applies to bfloat16 models and streams."""
        dev = resolve_device(device)
        model = NeuralMarionette(cfg, device=dev, conv_kernel=conv_kernel)
        init_weights(model, torch.Generator().manual_seed(seed))
        return cls(cfg, model, dev)

    @classmethod
    def from_jax_params(cls, cfg: MarionetteConfig, params,
                        device=None, conv_kernel: bool = False
                        ) -> "Marionette":
        """Weights carried from the JAX package's ``{"params": ...}`` tree."""
        dev = resolve_device(device)
        model = NeuralMarionette(cfg, device=dev, conv_kernel=conv_kernel)
        model.load_state_dict(state_dict_from_jax(params), strict=True)
        return cls(cfg, model, dev)

    # ----------------------------------------------------------- inference
    def voxelize(self, points: np.ndarray) -> np.ndarray:
        """(T, N, 3) normalized points -> (T, G, G, G, 1), on the host."""
        return np.stack([voxelize_np(points[t], self.cfg.grid_size)
                         for t in range(points.shape[0])])

    def clip_tensor(self, vox_clip: np.ndarray) -> torch.Tensor:
        """A clip (T, ...) as a float32 batch of one on the device."""
        return torch.as_tensor(np.asarray(vox_clip, np.float32)[None],
                               device=self.device)

    def extract_skeleton(self) -> Skeleton:
        """Skeleton from the learned affinity (it depends on the weights
        only), extracted once and cached."""
        if self.skeleton is None:
            with torch.inference_mode():
                aff = self.model.kypt_detector.get_affinity()
            self.skeleton = extract_skeleton(aff.cpu().numpy())
        return self.skeleton

    def detect(self, vox_clip: np.ndarray) -> dict:
        """(T, G, G, G, 1) -> keypoints (T, K, 4), heatmaps, recon,
        affinity, skeleton."""
        with torch.inference_mode():
            det = self.model.kypt_detector(self.clip_tensor(vox_clip))
        skeleton = self.extract_skeleton()
        return dict(keypoints=det["keypoints"][0].cpu().numpy(),
                    heatmaps=det["heatmaps"][0].cpu().numpy(),
                    recon=det["recon"][0].cpu().numpy(),
                    affinity=det["affinity"].cpu().numpy(),
                    skeleton=skeleton)

    def encode(self, vox_clip: np.ndarray, seed: int = 0,
               sample_num: int = 10) -> dict:
        """Detector + VRNN encode: keypoints, per-frame global rotations."""
        skeleton = self.extract_skeleton()
        sk = SkeletonArrays.from_skeleton(skeleton, self.device)
        gen = torch.Generator(self.device).manual_seed(seed)
        with torch.inference_mode():
            out = self.model.encode_only(self.clip_tensor(vox_clip), sk,
                                         sample_num=sample_num,
                                         generator=gen)
        return dict(keypoints=out["keypoints"][0].cpu().numpy(),
                    kypt_recon=out["kypt_recon"][0].cpu().numpy(),
                    R=out["R"][0].cpu().numpy(), skeleton=skeleton)

    # --------------------------------------------------------- capabilities
    def generate(self, vox_clip: np.ndarray, Tcond: int = 5, Tgen: int = 25,
                 sample_num: int = 3, seed: int = 2) -> dict:
        """Motion generation (``apps.generation.run_generation``)."""
        from .apps.generation import run_generation
        return run_generation(self, vox_clip, Tcond=Tcond, Tgen=Tgen,
                              sample_num=sample_num, seed=seed)

    def interpolate(self, vox_clip: np.ndarray, anchor_rate: int = 10,
                    sample_num: int = 10000, seed: int = 2) -> dict:
        """In-betweening (``apps.interpolation.run_interpolation``)."""
        from .apps.interpolation import run_interpolation
        return run_interpolation(self, vox_clip, anchor_rate=anchor_rate,
                                 sample_num=sample_num, seed=seed)

    def retarget(self, source_vox: np.ndarray, target_points: np.ndarray,
                 hardness: float = 8.0, mode: str = "ours",
                 seed: int = 0) -> dict:
        """Motion retargeting (``apps.retarget.run_retarget``)."""
        from .apps.retarget import run_retarget
        return run_retarget(self, source_vox, target_points,
                            hardness=hardness, mode=mode, seed=seed)

    # ------------------------------------------------------------ streaming
    def stream(self, dtype: str = "bfloat16", sample_num: int = 10,
               seed: int = 2,
               outputs: Sequence[str] = ("keypoints", "kypt_recon", "R"),
               conv_kernel: Optional[bool] = None) -> "MarionetteStream":
        """Streaming serving session (see :class:`MarionetteStream`)."""
        return MarionetteStream(self, dtype=dtype, sample_num=sample_num,
                                seed=seed, outputs=outputs,
                                conv_kernel=conv_kernel)


class MarionetteStream:
    """Streaming inference over point-cloud windows ``(B, T, N, 3)``:
    host->device copy from pinned memory, voxelization on the device
    (kernel K1), detector encode and VRNN rollout per window.

    Results come back lag-1: ``submit(w)`` enqueues window w and returns
    the *previous* window's outputs (None for the first); ``flush()``
    drains the last; ``run(iterable)`` hides the bookkeeping. Each window's
    outputs are copied to pinned host memory behind its own work, so the
    host queues window w while the card still runs window w-1, and waiting
    for w-1's results does not wait for w.

    ``outputs`` names the keys of ``NeuralMarionette.encode_only`` to
    return (e.g. ``recon`` or a loss scalar); all of them are computed
    every window. Loss scalars cover the padded batch rows too.

    ``conv_kernel`` (default: the marionette's model's) routes the eligible
    bfloat16 convs through kernel K3, the JAX package's ``NM_PALLAS_CONV=1``.
    """

    def __init__(self, marionette: Marionette, dtype: str = "bfloat16",
                 sample_num: int = 10, seed: int = 2,
                 outputs: Sequence[str] = ("keypoints", "kypt_recon", "R"),
                 conv_kernel: Optional[bool] = None):
        if dtype not in _DTYPES:
            raise ValueError(f"dtype must be one of {sorted(_DTYPES)}")
        self.marionette = marionette
        self.cfg = marionette.cfg
        self.device = marionette.device
        self.dtype = _DTYPES[dtype]
        self.sample_num = sample_num
        self.seed = seed
        self.outputs = tuple(outputs)
        base = marionette.model
        if conv_kernel is None:
            conv_kernel = base.conv_kernel
        if (self.dtype, conv_kernel) == (base.dtype, base.conv_kernel):
            self.model = base
        else:
            # same weights (float32), another compute dtype or conv route
            self.model = NeuralMarionette(self.cfg, dtype=self.dtype,
                                          device=self.device,
                                          conv_kernel=conv_kernel).eval()
            self.model.load_state_dict(marionette.model.state_dict())
        self._sk: Optional[SkeletonArrays] = None
        self._pending = None  # (device outputs, true B) of the window in flight
        self._n_submitted = 0
        self._closed = False

    @staticmethod
    def _bucket(b: int) -> int:
        """Round a batch size up to a bucket (1,2,4,8,16,24,32,...), as the
        JAX stream does for its compiled programs."""
        for cap in (1, 2, 4, 8, 16, 24):
            if b <= cap:
                return cap
        return -(-b // 8) * 8

    def _window_generator(self, idx: int) -> torch.Generator:
        """Per-window noise: each window draws its own sample noise, so
        best-of-N selections are not correlated across the stream."""
        seed = int(np.random.SeedSequence([self.seed, idx]).generate_state(1)[0])
        return torch.Generator(self.device).manual_seed(seed)

    def _start_copy(self, out: dict):
        """Queue the device->host copies of the requested outputs behind the
        window's work, into pinned memory, and mark their end with an event;
        numpy has no bfloat16, so bfloat16 outputs come back as float32."""
        host = {}
        for k in self.outputs:
            v = out[k]
            if v.dtype == torch.bfloat16:
                v = v.float()
            if self.device.type == "cuda":
                h = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                host[k] = h.copy_(v, non_blocking=True)
            else:
                host[k] = v
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
        return host, event

    @staticmethod
    def _fetch(pending) -> dict:
        """Wait for one window's copies (not for the windows queued after
        it) and slice the padding rows off."""
        host, event, true_b = pending
        if event is not None:
            event.synchronize()
        res = {}
        for k, v in host.items():
            v = v.numpy()
            res[k] = v if v.ndim == 0 else v[:true_b]
        return res

    def submit(self, window: np.ndarray) -> Optional[dict]:
        """Enqueue one ``(B, T, N, 3)`` window; returns the PREVIOUS
        window's results (None on the first call). B is padded up to a
        bucket with copies of the first row, sliced off at fetch."""
        if self._closed:
            raise RuntimeError("stream already flushed/closed")
        window = np.asarray(window, dtype=np.float32)
        if window.ndim != 4 or window.shape[-1] != 3:
            raise ValueError(f"window must be (B, T, N, 3), got "
                             f"{window.shape}")
        if self._sk is None:
            # the skeleton is extracted once, at the first window
            self._sk = SkeletonArrays.from_skeleton(
                self.marionette.extract_skeleton(), self.device)
        true_b = window.shape[0]
        bucket = self._bucket(true_b)
        if bucket != true_b:
            pad = np.broadcast_to(window[:1],
                                  (bucket - true_b,) + window.shape[1:])
            window = np.concatenate([window, pad], axis=0)
        host = torch.from_numpy(np.ascontiguousarray(window))
        if self.device.type == "cuda":
            host = host.pin_memory()
        idx = self._n_submitted
        self._n_submitted += 1
        with torch.inference_mode():
            pts = host.to(self.device, non_blocking=True)
            vox = voxelize(pts, self.cfg.grid_size, dtype=self.dtype)
            out = self.model.encode_only(vox, self._sk,
                                         sample_num=self.sample_num,
                                         generator=self._window_generator(idx))
            host, event = self._start_copy(out)
        prev, self._pending = self._pending, (host, event, true_b)
        return self._fetch(prev) if prev is not None else None

    def flush(self) -> Optional[dict]:
        """Drain the in-flight window (call once after the last submit)."""
        prev, self._pending = self._pending, None
        self._closed = True
        return self._fetch(prev) if prev is not None else None

    def run(self, windows: Iterable[np.ndarray]) -> Iterator[dict]:
        """Pipeline an iterable of windows; yields one result per window,
        in order."""
        for w in windows:
            res = self.submit(w)
            if res is not None:
                yield res
        tail = self.flush()
        if tail is not None:
            yield tail

    def __enter__(self) -> "MarionetteStream":
        return self

    def __exit__(self, *exc) -> None:
        if not self._closed:
            self.flush()
