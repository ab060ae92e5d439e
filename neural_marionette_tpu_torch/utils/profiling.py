"""Timing and profiling utilities: the counterpart of the JAX package's
``utils/profiling.py`` in PyTorch's idiom.

* :class:`StepTimer`: wall-clock step timing that synchronises the device
  of the step's result, with items-per-second throughput;
* :func:`trace`: a ``torch.profiler`` trace of a code block, written where
  TensorBoard's profile plugin reads it;
* :func:`device_memory_stats`: per CUDA device, the bytes in use, their
  peak and the device's limit;
* :func:`loop_time`: CUDA-event time per call of a function.

The JAX module's ``start_server`` (a live-capture profiler server) has no
counterpart: ``torch.profiler`` has none.
"""
from __future__ import annotations

import contextlib
import time
from typing import Optional

import torch


def _cuda_devices(result) -> set:
    """The CUDA devices of the tensors in ``result`` (nested in lists,
    tuples and dict values)."""
    if isinstance(result, torch.Tensor):
        return {result.device} if result.device.type == "cuda" else set()
    if isinstance(result, dict):
        result = list(result.values())
    if isinstance(result, (list, tuple)):
        return set().union(*(_cuda_devices(r) for r in result))
    return set()


class StepTimer:
    """Wall-clock step timer with device synchronisation."""

    def __init__(self, items_per_step: float = 1.0):
        self.items_per_step = items_per_step
        self.times: list[float] = []
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, result=None) -> float:
        """Ends the step once the devices of ``result``'s CUDA tensors have
        finished their queued work; returns the step's seconds."""
        for dev in _cuda_devices(result):
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        return dt

    @contextlib.contextmanager
    def step(self):
        """``with timer.step() as out: out["result"] = f(...)``."""
        self.start()
        out = {}
        yield out
        self.stop(out.get("result"))

    def mean_time(self, skip: int = 1) -> float:
        ts = self.times[skip:] if len(self.times) > skip else self.times
        return sum(ts) / max(len(ts), 1)

    def throughput(self, skip: int = 1) -> float:
        """items (e.g. voxel sequences) per second."""
        mt = self.mean_time(skip)
        return self.items_per_step / mt if mt > 0 else 0.0


@contextlib.contextmanager
def trace(log_dir: str):
    """A ``torch.profiler`` trace of the block (the CPU, and the card when
    there is one), written under ``log_dir`` for TensorBoard's profile
    plugin (``tensorboard --logdir log_dir``)."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()


def device_memory_stats() -> dict:
    """Per CUDA device: ``bytes_in_use`` and ``peak_bytes_in_use`` of
    PyTorch's allocator and ``bytes_limit``, the device's total memory;
    ``{}`` without a card."""
    stats = {}
    if not torch.cuda.is_available():
        return stats
    for i in range(torch.cuda.device_count()):
        ms = torch.cuda.memory_stats(i)
        _, total = torch.cuda.mem_get_info(i)
        stats[f"cuda:{i}"] = {
            "bytes_in_use": ms.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": ms.get("allocated_bytes.all.peak", 0),
            "bytes_limit": total,
        }
    return stats


def loop_time(fn, *args, iters: int = 20) -> float:
    """Seconds per call of ``fn(*args)``: one warm-up call, then ``iters``
    calls between two CUDA events where an argument is a CUDA tensor, else
    on the host clock.

    The JAX version runs the calls inside one compiled ``fori_loop`` to
    keep a remote device's per-call overhead out of the time. A local card
    needs no loop: the calls queue behind each other and the events time
    the device's work between the first and the last."""
    fn(*args)
    if not _cuda_devices(args):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        return (time.perf_counter() - t0) / iters
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / iters
