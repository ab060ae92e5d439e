"""Driver ``train_loop``: the port's trainer fed by its loader.

Set-up writes the AIST++-layout tree from the seed under the run's
``TMPDIR``, builds the trainer (for the dynamics phase, the seeded
detector is saved as a reference-layout ``.pth`` and loaded by the
trainer's own two-phase start), and drives that trainer through its first
steps on the loader's batches, one ``train_epoch`` call a step, keeping
what the correctness check compares. The same trainer and feed then run
the window: ``train_epoch`` over batches until the window's time is up,
then a ``torch.cuda.synchronize()``.

Mix parameters: ``sequences``, ``frames``, ``points`` (the tree),
``workers`` (loader threads), ``prefetch`` (batches copied ahead),
``checked_steps`` (the first steps, which the reference follows),
``trace_steps`` (steps of the traced window), ``ref_chunk`` (clips a
reference chunk), ``kernels`` (the port's CUDA sources to build).
"""
from __future__ import annotations

import gc
import shutil
import tempfile
import time
from pathlib import Path

import torch

from .. import check, inputs, program, trace, work
from ..reference import model as ref
from ..reference.skeleton import extract_skeleton

BETA1 = 0.9  # the port's Adam b1, as optax's


def phase_of(fields: dict) -> str:
    return "dynamics" if fields["pretrained_mode"] == 1 else "detector"


class Feed:
    """The loader's batches, pass after pass, on the card; ``take(n)``
    hands out ``n`` of them, ``until(t)`` hands them out while the clock is
    before ``t``. Records the host time spent waiting in ``next``."""

    def __init__(self, loader, dataset, buffer, device):
        from neural_marionette_tpu_torch.data.loader import prefetch_to_device

        def passes():
            epoch = 0
            while True:
                dataset.log_epoch(epoch)
                yield from loader
                epoch += 1

        self._it = prefetch_to_device(passes(), buffer, device)
        self.wait_s = 0.0
        self.handed = 0

    def _next(self):
        t = time.perf_counter()
        with trace.span("loader_next"):
            b = next(self._it)
        self.wait_s += time.perf_counter() - t
        self.handed += 1
        return b

    def take(self, n):
        for _ in range(n):
            yield self._next()

    def until(self, deadline):
        while time.perf_counter() < deadline:
            yield self._next()


def run(ctx) -> dict:
    from neural_marionette_tpu_torch.data.datasets import AIST
    from neural_marionette_tpu_torch.data.loader import DataLoader
    from neural_marionette_tpu_torch.train import Trainer

    fields, mix, device = ctx.fields, ctx.mix, ctx.device
    phase = phase_of(fields)
    program.build_kernels(mix["kernels"], device)
    work = Path(tempfile.mkdtemp(prefix="bench_", dir=ctx.tmp))
    try:
        inputs.write_aist_tree(work / "data", ctx.seed, mix["sequences"],
                               mix["frames"], mix["points"])
        extra = dict(data_root=str(work / "data"),
                     num_workers=mix["workers"])
        if phase == "dynamics":
            extra["pretrained_dir"] = str(work / "pretrained")
        cfg = program.port_config(fields, ctx.seed, **extra)
        model, params = program.seeded_model(cfg, fields, ctx.seed, device,
                                             fields["conv_kernel"])
        if phase == "dynamics":
            det = work / "pretrained" / "detector"
            det.mkdir(parents=True)
            torch.save({k: v for k, v in params.items()
                        if k.startswith("kypt_detector.")},
                       det / f"{fields['dataset']}_detector.pth")
        before = {k: v.clone() for k, v in params.items()}
        del params
        trainer = Trainer(cfg, device=device, dtype="bfloat16", model=model)
        dataset = AIST(train=True, options=cfg)
        loader = DataLoader(dataset, cfg.nbatch, shuffle=True,
                            num_workers=mix["workers"], seed=cfg.seed,
                            microbatches=max(int(cfg.grad_accum), 1))
        with loader:
            out = _drive(ctx, trainer, Feed(loader, dataset, mix["prefetch"],
                                            device), cfg, before, phase)
        del trainer, model, loader
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        own = reference(ctx, work / "data", phase)
        out["detail"]["program_losses"] = out["cand"]["losses"]
        out["readings"] = _readings(ctx, work / "data", phase,
                                    out.pop("cand"), own)
        out["detail"].update(reference_s=time.perf_counter() - t0,
                             reference_losses=own["losses"],
                             reference_terms=own["terms"])
        out["controls"] = {
            label: _readings(ctx, work / "data", phase,
                             reference(ctx, work / "data", phase, **fault),
                             own)
            for label, fault in ctx.controls.items()}
        return out
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _readings(ctx, data_root, phase, cand, own) -> dict:
    """The numbers compared, ``cand``'s first steps against the reference's
    (``own``). In the dynamics phase the VRNN is judged against the
    reference trained on ``cand``'s own frozen keypoints (the VRNN's
    best-of-N choices turn any difference of its input into jumps), and
    those keypoints are judged by themselves against the reference's."""
    if phase != "dynamics":
        return check.train_readings(cand, own)
    # rows the candidate left out keep the reference's own keypoints
    kp = [torch.cat([c.float(), o[c.shape[0]:]])
          for c, o in zip(cand["keypoints"], own["keypoints"])]
    follow = reference(ctx, data_root, phase, follow=kp)
    out = check.train_readings(cand, follow)
    out["keypoints_gap"] = check.keypoints_gap(cand["keypoints"],
                                               own["keypoints"])
    out["keypoints_mean_gap"] = check.keypoints_gap(
        cand["keypoints"], own["keypoints"], mean=True)
    return out


def _drive(ctx, trainer, feed, cfg, before, phase) -> dict:
    mix = ctx.mix
    B = cfg.nbatch
    losses, terms, mu1, kps, seen = [], [], None, [], []
    # the frozen detector's keypoints of each checked step (the dynamics
    # phase's reference trains its VRNN on them)
    hook = trainer.model.kypt_detector.register_forward_hook(
        lambda mod, args, out: seen.append(out["keypoints"].detach().clone()))
    micro = MicroGrads(trainer.model, phase)
    for s in range(mix["checked_steps"]):
        rec = trainer.train_epoch(0, feed.take(1))
        micro.remove()  # the first step's microbatches only
        kps.append(torch.cat(seen))
        seen.clear()
        losses.append(float(rec["train"]["total_loss"]))
        terms.append({k: float(v) for k, v in rec["train"].items()})
        if s == 0:
            opt = trainer.state.optimizer
            mu1 = {n: m.clone() for n, m in zip(opt.names, opt.mu)}
    hook.remove()
    named = dict(trainer.model.named_parameters())
    after = {k: v.detach().clone() for k, v in named.items()}
    ctx.mark_setup_end()
    result = {"device_peak": None}
    if ctx.trace:
        counters = program.Counters().install()
        hooks = _range_hooks(trainer.model)
        record = {}
        wait0, steps0 = feed.wait_s, feed.handed
        try:
            with trace.traced(record):
                trainer.train_epoch(0, feed.take(mix["trace_steps"]))
        finally:
            for h in hooks:
                h.remove()
            _unwrap_encode(trainer.model)
            counters.remove()
        steps = feed.handed - steps0
        record.update(cell=ctx.cell, clips=steps * B, steps=steps,
                      loader_wait_s=feed.wait_s - wait0,
                      k2_calls=counters.k2_calls(),
                      flops_per_clip=work.useful_flops_per_clip(
                          ctx.fields, phase + "_train"))
        result["record"] = record
        attempted = steps
    else:
        t0 = time.perf_counter()
        n0 = feed.handed
        trainer.train_epoch(0, feed.until(t0 + ctx.seconds))
        program.sync(ctx.device)
        elapsed = time.perf_counter() - t0
        steps = feed.handed - n0
        result["e2e"] = {"clips_per_s": steps * B / elapsed}
        attempted = steps
    result["device_peak"] = program.peak_bytes(ctx.device)
    result.update(attempted=attempted + mix["checked_steps"], failed=0)
    trained = {k for k in before if ref.trained(k, phase)}
    frozen_moved = sum(int(not torch.equal(before[k], after[k]))
                       for k in before if k not in trained)
    grad = {k: mu1[k] / (1.0 - BETA1) for k in trained}
    result["detail"] = {"program_terms": terms}
    result["cand"] = dict(losses=losses, frozen_moved=frozen_moved,
                          keypoints=kps,
                          micro=micro.gradients(max(int(cfg.grad_accum), 1)),
                          **check.norms_of_run(grad, before, after))
    return result


class MicroGrads:
    """The gradient of each microbatch of the first step, as the trained
    leaves accumulate it: a copy of each leaf's ``.grad`` after each of its
    accumulations, differenced."""

    def __init__(self, model, phase):
        self.snaps, self.shapes, self.handles = {}, {}, []
        for name, p in model.named_parameters():
            if ref.trained(name, phase) and p.requires_grad:
                self.snaps[name], self.shapes[name] = [], p.shape
                self.handles.append(p.register_post_accumulate_grad_hook(
                    lambda p, name=name: self.snaps[name].append(
                        p.grad.detach().clone())))

    def remove(self):
        for h in self.handles:
            h.remove()
        self.handles.clear()

    def gradients(self, accum) -> list:
        """Per microbatch, per leaf, its gradient on the host; where fewer
        accumulations reached a leaf than there are microbatches, the last
        ones add nothing."""
        out = [{} for _ in range(accum)]
        for name, snaps in self.snaps.items():
            prev = torch.zeros(self.shapes[name])
            for m in range(accum):
                cur = snaps[m].float().cpu() if m < len(snaps) else prev
                out[m][name] = cur - prev
                prev = cur
        return out


def _range_hooks(model):
    """``bench.*`` ranges around the detector's forward and the VRNN's
    encode."""
    sp = trace.Span("detector")
    hooks = [model.kypt_detector.register_forward_pre_hook(sp.open),
             model.kypt_detector.register_forward_hook(sp.close)]
    dyn = model.dyna_module
    orig = dyn.encode

    def encode(*a, **k):
        with trace.span("vrnn_encode"):
            return orig(*a, **k)

    dyn.encode = encode
    return hooks


def _unwrap_encode(model):
    model.dyna_module.__dict__.pop("encode", None)


def reference(ctx, data_root, phase, prec="fp32", keep_rows=None,
              follow=None, shift=0.0) -> dict:
    """The reference's first steps on the batches it works out from the
    tree, from the weights made again from the seed; in ``prec`` ("low":
    the control), with the faults ``keep_rows`` and ``shift`` if given
    (``reference.model.train_steps``), its VRNN trained on the keypoints
    ``follow`` if given."""
    fields, mix, device = ctx.fields, ctx.mix, ctx.device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rcfg = dict(fields, seed=int(ctx.seed))
    n = mix["checked_steps"]
    batches = inputs.loader_batches(data_root, rcfg, n)
    with torch.no_grad():
        vox = [ref.voxelize(torch.as_tensor(b, device=device),
                            fields["grid_size"]) for b in batches]
    P0 = ref.make_params(fields, ctx.seed, device)
    eps = skeleton = None
    if phase == "dynamics":
        gen = torch.Generator(device).manual_seed(int(ctx.seed) + 2)
        B, T = fields["nbatch"], fields["Ttot"]
        accum = max(int(fields["grad_accum"]), 1)
        # the trainer's draws: one per microbatch, from its generator
        eps = [torch.cat([torch.randn((T, 10, B // accum,
                                       fields["nlatent_kypt"]),
                                      generator=gen, device=device)
                          for _ in range(accum)], dim=2) for _ in range(n)]
        with torch.no_grad():
            aff = ref.Net(P0, fields, ref.Prec()).affinity()
        sk = extract_skeleton(aff.cpu().numpy())
        skeleton = ([int(p) for p in sk.parents],
                    [int(i) for i in sk.priority_indices])
    out = ref.train_steps(P0, fields, phase, vox, ref.Prec(prec),
                          mix["ref_chunk"], eps=eps, skeleton=skeleton,
                          keep_rows=keep_rows, follow=follow, shift=shift)
    side = dict(losses=out["losses"], terms=out["terms"],
                keypoints=out["keypoints"], micro=out["micro"],
                **check.norms_of_run(out["first_grad"], P0, out["params"]))
    return side
