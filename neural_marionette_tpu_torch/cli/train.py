"""Training CLI of the port.

    python -m neural_marionette_tpu_torch.cli.train --dataset aist \\
        --exp_name x [--pretrained_mode {0,1}] [--platform cpu]

Counterpart of the JAX package's ``train.py`` (reference ``train.py``): one
flag per ``MarionetteConfig`` field (bools parsed as ints), then
``adjust_config`` (when ``--apply_adjust_config``, the default),
``derive_training_id`` and the seed; train and validation loaders with
prefetch to the card; a :class:`train.Trainer` checkpointing under
``<output_root>/<training_id>/<exp_name>``, resuming from there and, with
``--pretrained_mode 1``, starting from the detector run's detector. Each
epoch trains, validates (``--is_eval``: the semantic score;
``--eval_voxel_chamfer``: the voxel chamfer) and appends its record to
``metrics.jsonl`` (and to TensorBoard when ``torch.utils.tensorboard``
imports). Every epoch below 10 and every ``log_gif_every``-th it draws the
first validation batch on the card (``viz.visualize``): the tracked
keypoints and recon and, in a learner epoch, the generated ones, as
``gifs/<epoch>/{track,gen}_{keypoints,recon}_<i>.gif`` (and TensorBoard
videos), the JAX ``train.py:409-438``. After the last epoch it writes
``semantic_result.csv``,
``chamfer_result.csv`` and ``affinity_result.json``. SIGTERM checkpoints
and exits after the epoch. ``--profile_dir`` writes a ``torch.profiler``
trace of the second epoch's first three steps. Each epoch prints a line
``epoch <n> stats {...}`` (its steps, their p50 host ms from one batch's
arrival to the next's, and on a card the epoch's peak GiB), and the run
ends with ``kernel launches {...}``: the launches of kernels K1-K3 in this
process (0 on the CPU, where the plain versions run).

Over several processes, one per card, each is started with the JAX
flags ``--coordinator_address host:port --num_processes N --process_id i``
(and ``--mesh_data D --mesh_model M``, D x M = N): NCCL between cards,
gloo on the CPU (``parallel.distributed.initialize``). Each process loads
its rows of every batch (``data`` rank = rank // M), the detector splits
the window's frames over the M ranks of a row, and the gradients are
averaged over all N after each step; only rank 0 writes ``opt.json``,
``metrics.jsonl``, TensorBoard, the GIFs, the checkpoints (between two
barriers) and the result files, and prints the stats. A checkpoint
saved by N processes resumes on any number.

It runs on ``cuda`` and raises without a card, unless ``--platform cpu``.
``--compute_dtype bfloat16`` trains in bfloat16 (the default is float32,
as the JAX CLI's); ``--conv_kernel 1`` routes its eligible convs through
kernel K3, the counterpart of running ``train.py`` under
``NM_PALLAS_CONV=1`` (the port reads no environment variable).
``--remat 1`` or ``2`` rematerialises the detector's conv stacks in the
training steps (``config.remat``): the same results in less activation
memory, for more recompute. The TPU layout knobs of the configuration
(strips, upconv, frame chunks) are read and ignored. ``--debug_nans 1``
(the JAX ``jax_debug_nans``) checks every training step on the card and
raises ``FloatingPointError`` at the first non-finite metric,
``grad_norm`` or parameter (``Trainer._checked_step``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import Optional

import numpy as np
import torch

from ..config import (MarionetteConfig, adjust_config, check_supported,
                      derive_training_id)
from ..data import DataLoader, load_dataset, prefetch_to_device
from ..eval import affinity_recovery, semantic_final
from ..ops.voxelize import voxelize
from ..parallel.distributed import (initialize, is_coordinator, shutdown,
                                    warmup_collectives)
from ..parallel.mesh import all_reduce_max, check_batch_shape, make_mesh
from ..train import Trainer
from ..utils.console import COLORS, display_it, display_opts, display_phase
from ..utils.preemption import install_preemption_handler, preempted
from ..viz.visualize import vis_keypoints, vis_recon
from . import platform_device

PROFILED_STEPS = 3


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    for f in dataclasses.fields(MarionetteConfig):
        ftype = type(f.default) if f.default is not None else str
        if ftype is bool:  # bool('0') is True; parse as int then cast
            parser.add_argument(f"--{f.name}", type=lambda s: bool(int(s)),
                                default=f.default)
        else:
            parser.add_argument(f"--{f.name}", type=ftype, default=f.default)
    parser.add_argument("--conv_kernel", type=int, choices=(0, 1), default=0,
                        help="1: route the eligible bfloat16 convs through "
                             "kernel K3 (the JAX package's NM_PALLAS_CONV=1)")
    return parser


def parse_args(argv=None) -> tuple[MarionetteConfig, bool]:
    """(the configuration as given on the command line, ``--conv_kernel``)."""
    ns = vars(build_parser().parse_args(argv))
    conv_kernel = bool(ns.pop("conv_kernel"))
    return MarionetteConfig(**ns), conv_kernel


def prepare_config(cfg: MarionetteConfig) -> MarionetteConfig:
    """``adjust_config`` when asked, then ``derive_training_id``; raises on
    an option value the JAX package rejects too (``check_supported``)."""
    if cfg.compute_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"compute_dtype must be float32 or bfloat16, got "
                         f"{cfg.compute_dtype!r}")
    if cfg.apply_adjust_config:
        cfg = adjust_config(cfg)
    cfg = derive_training_id(cfg)
    check_supported(cfg)
    return cfg


def _make_writer(log_dir: str, purge_step: int):
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError as e:   # tensorboard not installed
        print(f"tensorboard unavailable ({e}); JSONL metrics only")
        return None
    os.makedirs(log_dir, exist_ok=True)
    return SummaryWriter(log_dir=log_dir, purge_step=purge_step,
                         flush_secs=30)


def _profiled(batches, out_dir: str, device: torch.device, epoch_id: int):
    """``batches``, with a ``torch.profiler`` trace of the steps of the
    first ``PROFILED_STEPS`` written to ``out_dir`` (the card synchronised
    before the trace ends)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    running = True

    def stop():
        nonlocal running
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        prof.stop()
        running = False
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, f"trace_epoch{epoch_id}.json")
        prof.export_chrome_trace(path)
        print(f"profiler trace of {PROFILED_STEPS} steps -> {path}")

    try:
        for i, batch in enumerate(batches):
            if i == PROFILED_STEPS:
                stop()
            yield batch
    finally:
        if running:
            stop()


def _write_results(trainer: Trainer, logger_path: str, eval_metrics,
                   gt_aff: Optional[np.ndarray]) -> None:
    """The final eval files (reference evaluate_final, eval_utils.py:
    12-26; the JAX ``train.py:339-373``)."""
    scores = trainer.eval_scores
    for name in eval_metrics:
        if scores.get(name) is None:
            continue
        if name == "semantic":
            score = semantic_final(scores[name])
            out = os.path.join(logger_path, "semantic_result.csv")
            np.savetxt(out, scores[name] / max(scores[name][0].sum(), 1),
                       delimiter=",")
            print(f"final semantic score: {score:.4f} -> {out}")
        elif name == "voxel_chamfer":
            vals = np.asarray(scores[name], dtype=np.float64)
            out = os.path.join(logger_path, "chamfer_result.csv")
            np.savetxt(out, vals, delimiter=",")
            print(f"final voxel chamfer (x1e4): {vals.mean():.4f} -> {out}")
    # how much of the dataset's GT skeleton the extracted skeleton
    # reproduces under the semantic joint assignment
    if gt_aff is not None and trainer.skeleton is not None \
            and scores.get("semantic") is not None:
        rec = affinity_recovery(gt_aff, trainer.skeleton.parents,
                                scores["semantic"])
        out = os.path.join(logger_path, "affinity_result.json")
        with open(out, "w") as f:
            json.dump(rec, f)
        print(f"GT-affinity edge recovery: {rec['recovery']:.4f} "
              f"({rec['recovered']}/{rec['gt_edges']}, "
              f"{rec['collapsed']} collapsed) -> {out}")


def _log_gifs(writer, cfg: MarionetteConfig, logger_path: str,
              epoch_id: int, trainer: Trainer) -> float:
    """The GIF videos of the first validation batch (the JAX
    ``train.py:409-438``): its voxels (kernel K1 on a card) against the
    eval step's recon and keypoints (the affinity's arrows) and, in a
    learner epoch, against the generate step's (the skeleton's
    adjacency); written under ``gifs/<epoch>/`` and given to TensorBoard.
    Returns the host ms."""
    t0 = time.perf_counter()
    first = trainer.first_batch
    vox = voxelize(first["points"], cfg.grid_size)
    n = min(cfg.log_gif_num, vox.shape[0])
    tensors, gen, skeleton = first["tensors"], first["gen"], trainer.skeleton
    dev = trainer.device
    videos = {}
    if "recon" in tensors:
        videos["track/recon"] = vis_recon(
            vox, tensors["recon"], logger_path, epoch_id, log_num=n,
            group="track", device=dev)
    if "keypoints" in tensors:
        videos["track/keypoints"] = vis_keypoints(
            vox, tensors["keypoints"], logger_path, epoch_id,
            affinity=tensors.get("affinity"), log_num=n, group="track",
            device=dev)
    if gen is not None:
        videos["gen/recon"] = vis_recon(
            vox, gen["gen"], logger_path, epoch_id, log_num=n, group="gen",
            Tcond=cfg.Tcond, device=dev)
        videos["gen/keypoints"] = vis_keypoints(
            vox, gen["keypoints"], logger_path, epoch_id,
            affinity=skeleton.A if skeleton is not None else None,
            log_num=n, group="gen", Tcond=cfg.Tcond,
            mode="A" if skeleton is not None else "affinity", device=dev)
    if writer is not None:
        for tag, vid in videos.items():
            t = torch.from_numpy(vid.transpose(0, 1, 4, 2, 3))  # B,T,C,H,W
            for i in range(t.shape[0]):
                writer.add_video(f"{tag}_{i}", t[i:i + 1], epoch_id)
    return (time.perf_counter() - t0) * 1e3


def _epoch_stats(rec: dict, device: torch.device) -> dict:
    """An epoch's steps, their p50 host ms (``Trainer.train_epoch``'s
    ``step_ms``: through the loader) and, on a card, its peak GiB."""
    steps = rec["step_ms"]
    return {"steps": len(steps),
            "step_ms_p50": float(np.median(steps)) if steps else None,
            "peak_gib": (torch.cuda.max_memory_allocated(device) / 2 ** 30
                         if device.type == "cuda" else None)}


def _kernel_launches() -> dict:
    """The launch counts of kernels K1 (voxelize), K2 (chamfer forward and
    backward) and K3 (conv3d) in this process."""
    from ..ops import conv3d, losses
    from ..ops import voxelize as vox
    return {"voxelize": vox.launches, "chamfer_fwd": losses.launches,
            "chamfer_bwd": losses.bwd_launches, "conv3d": conv3d.launches}


def train(cfg: MarionetteConfig, conv_kernel: bool = False) -> Trainer:
    """Train ``cfg`` (as parsed; :func:`prepare_config` is applied here)
    to ``cfg.nepoch``; returns the trainer. With ``--num_processes`` above
    1 or a ``--coordinator_address`` it joins the process group first and
    leaves it at the end."""
    device = platform_device(cfg.platform)
    cfg = prepare_config(cfg)
    bound = initialize(cfg.coordinator_address or None,
                       cfg.num_processes or None,
                       cfg.process_id if cfg.process_id >= 0 else None,
                       device=device)
    if bound is None:
        return _train(cfg, conv_kernel, device, distributed=False)
    try:
        return _train(cfg, conv_kernel, bound, distributed=True)
    finally:
        shutdown()


def _train(cfg: MarionetteConfig, conv_kernel: bool, device: torch.device,
           distributed: bool) -> Trainer:
    mesh = None
    if distributed:
        mesh = make_mesh(cfg.mesh_data, cfg.mesh_model)
        warmup_collectives(mesh, device)
        check_batch_shape(mesh, (cfg.nbatch, cfg.Ttot))
    coord = is_coordinator()
    np.random.seed(cfg.seed)
    install_preemption_handler()
    if coord:
        display_opts(cfg)

    dataset_train = load_dataset(True, cfg)
    dataset_valid = load_dataset(False, cfg)
    logger_path = os.path.join(cfg.output_root, cfg.training_id,
                               cfg.exp_name)
    os.makedirs(logger_path, exist_ok=True)
    if coord:
        cfg.save_json(os.path.join(logger_path, "opt.json"))
    trainer = Trainer(cfg, device=device, dtype=cfg.compute_dtype,
                      logger_path=logger_path, conv_kernel=conv_kernel,
                      mesh=mesh)
    if trainer.start_epoch > 0:
        print(f"{COLORS.OKGREEN}resumed from epoch "
              f"{trainer.start_epoch - 1}{COLORS.ENDC}")
    elif cfg.pretrained_mode == 1:
        print(f"loaded the pretrained detector of {cfg.pretrained_dir}")
    eval_metrics = ["semantic"] if cfg.is_eval else []
    if cfg.eval_voxel_chamfer:  # opt-in: the reference implements it but
        eval_metrics.append("voxel_chamfer")  # never wires it (train.py:332)

    writer = _make_writer(os.path.join(logger_path, "logs"),
                          trainer.start_epoch) if coord else None
    # each data rank loads its rows of the one-process run's batches: its
    # share of every microbatch
    part = dict(process_index=mesh.data_rank, process_count=mesh.data,
                global_draws=True) if mesh is not None else {}
    loader_train = DataLoader(dataset_train, cfg.nbatch, shuffle=True,
                              seed=cfg.seed, num_workers=cfg.num_workers,
                              microbatches=max(int(cfg.grad_accum), 1),
                              **part)
    loader_valid = DataLoader(dataset_valid, cfg.nbatch, shuffle=False,
                              seed=cfg.seed, num_workers=cfg.num_workers,
                              **part)
    metrics_path = os.path.join(logger_path, "metrics.jsonl") if coord \
        else os.devnull
    try:
        with loader_train, loader_valid, open(metrics_path, "a") as log:
            for epoch_id in range(trainer.start_epoch, cfg.nepoch):
                t_epoch = time.time()
                if device.type == "cuda":
                    torch.cuda.reset_peak_memory_stats(device)
                dataset_train.log_epoch(epoch_id)
                dataset_valid.log_epoch(epoch_id)
                trainer.sched.anneal(epoch_id)
                if epoch_id % cfg.log_gif_every == 0 and coord:
                    display_phase(trainer.sched)
                batches = prefetch_to_device(iter(loader_train),
                                             device=device)
                if cfg.profile_dir and epoch_id == trainer.start_epoch + 1 \
                        and coord:
                    batches = _profiled(batches, cfg.profile_dir, device,
                                        epoch_id)
                rec = trainer.train_epoch(epoch_id, batches)
                if coord:
                    display_it("train", "total loss", cfg, epoch_id, 0,
                               rec["train"].get("total_loss", float("nan")))
                valid, _ = trainer.validate(
                    epoch_id, prefetch_to_device(iter(loader_valid),
                                                 device=device),
                    eval_metrics)
                if coord:
                    for name in eval_metrics:
                        if name in valid:
                            display_it("eval", name, cfg, epoch_id, 0,
                                       valid[name])
                record = {"epoch": epoch_id, "lr": rec["lr"],
                          "time": time.time() - t_epoch,
                          "train": rec["train"], "valid": valid}
                log.write(json.dumps(record) + "\n")
                log.flush()
                if writer is not None and epoch_id % cfg.log_every == 0:
                    for part in ("train", "valid"):
                        for k, v in record[part].items():
                            writer.add_scalar(f"{part}/{k}", v, epoch_id)
                if (epoch_id % cfg.log_gif_every == 0 or epoch_id < 10) \
                        and trainer.first_batch is not None and coord:
                    ms = _log_gifs(writer, cfg, logger_path, epoch_id,
                                   trainer)
                    trainer.gif_ms[epoch_id] = ms
                    print(f"epoch {epoch_id}: GIF logging {ms:.1f} ms")
                if coord:
                    print(f"epoch {epoch_id} stats "
                          + json.dumps(_epoch_stats(rec, device)), flush=True)
                stop = preempted()
                if mesh is not None:   # every rank stops at the same epoch
                    stop = all_reduce_max(stop, mesh, device)
                if stop:
                    print(f"{COLORS.FAIL}SIGTERM received: checkpointing "
                          f"and exiting at epoch {epoch_id}{COLORS.ENDC}")
                    trainer.save_checkpoint(epoch_id)
                    return trainer
    finally:
        if writer is not None:
            writer.close()
    if coord:
        _write_results(trainer, logger_path, eval_metrics,
                       dataset_valid.gt_affinity())
    print("kernel launches " + json.dumps(_kernel_launches()))
    print(f"{COLORS.OKGREEN}training complete{COLORS.ENDC}")
    return trainer


def main(argv=None) -> int:
    cfg, conv_kernel = parse_args(argv)
    train(cfg, conv_kernel)
    return 0


if __name__ == "__main__":
    sys.exit(main())
