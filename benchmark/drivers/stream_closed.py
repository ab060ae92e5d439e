"""Driver ``stream_closed``: one client streaming point windows through the
port's ``MarionetteStream``, each window submitted as soon as the previous
``submit`` returns (a closed loop).

Set-up builds the model with the seeded weights, extracts the skeleton,
makes a pool of windows from the seed and warms the stream's shapes up on
a stream of its own. The window then runs a fresh stream of the mix's
settings until the window's time is up and flushes it. A window's latency
runs from its ``submit`` call to the return of its results: under the
stream's lag-1 design, the next ``submit`` or the ``flush``.

After the window, a sample of the served windows, drawn from the seed, is
judged against the reference (``check``).

Mix parameters: ``B``, ``N`` (points a frame; T is the configuration's),
``pool`` (distinct windows, cycled), ``warmup`` (windows of the warm-up
stream), ``sample_num`` (best-of-N of the VRNN), ``outputs``,
``conv_kernel``, ``checked`` (windows judged), ``trace_windows``,
``ref_chunk`` (clips a reference chunk), ``kernels``.
"""
from __future__ import annotations

import gc
import statistics
import time

import numpy as np
import torch

from .. import inputs, program, trace, work
from ..reference import model as ref
from ..reference.skeleton import extract_skeleton


def _p95(values):
    return statistics.quantiles(values, n=100, method="inclusive")[94] \
        if len(values) > 1 else values[0]


def run(ctx) -> dict:
    from neural_marionette_tpu_torch.api import Marionette

    fields, mix, device = ctx.fields, ctx.mix, ctx.device
    program.build_kernels(mix["kernels"], device)
    cfg = program.port_config(fields, ctx.seed)
    model, params = program.seeded_model(cfg, fields, ctx.seed, device,
                                         mix["conv_kernel"])
    del params
    m = Marionette(cfg, model, device)
    m.extract_skeleton()
    B, T, N = mix["B"], fields["Ttot"], mix["N"]
    pool = [inputs.serve_window(ctx.seed, i, B, T, N)
            for i in range(mix["pool"])]
    opts = dict(dtype=fields["compute_dtype"], sample_num=mix["sample_num"],
                outputs=tuple(mix["outputs"]), conv_kernel=mix["conv_kernel"])
    with m.stream(seed=inputs.seed_of(ctx.seed, 4), **opts) as warm:
        for i in range(mix["warmup"]):
            warm.submit(pool[i % len(pool)])
        warm.flush()
    program.sync(device)
    stream_seed = inputs.seed_of(ctx.seed, 3)
    stream = m.stream(seed=stream_seed, **opts)
    results, lat = {}, {}
    ctx.mark_setup_end()
    out = {}
    if ctx.trace:
        counters = program.Counters().install()
        sp = trace.Span("detector")
        hooks = [model.kypt_detector.register_forward_pre_hook(sp.open),
                 model.kypt_detector.register_forward_hook(sp.close)]
        record = {}
        try:
            with trace.traced(record):
                n = _loop(stream, pool, results, lat,
                          count=mix["trace_windows"])
        finally:
            for h in hooks:
                h.remove()
            counters.remove()
        record.update(cell=ctx.cell, clips=n * B, windows=n,
                      k1_calls=counters.k1, k3_calls=counters.k3,
                      flops_per_clip=work.useful_flops_per_clip(fields,
                                                                "serve"))
        out["record"] = record
    else:
        t0 = time.perf_counter()
        n = _loop(stream, pool, results, lat, deadline=t0 + ctx.seconds)
        program.sync(device)
        elapsed = time.perf_counter() - t0
        served = [i for i in range(n) if i in results]
        out["e2e"] = {"clips_per_s": len(served) * B / elapsed,
                      "window_ms_p95": _p95([lat[i] * 1e3 for i in served])}
    out["device_peak"] = program.peak_bytes(device)
    out.update(attempted=n, failed=sum(i not in results for i in range(n)))
    del stream, m, model
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    rng = np.random.default_rng(inputs.seed_of(ctx.seed, 5))
    sample = sorted(rng.choice(n, min(mix["checked"], n), replace=False))
    sample = [int(i) for i in sample]
    judge = Judge(ctx, stream_seed, pool)
    out["readings"] = judge.readings(sample, results)
    out["controls"] = {label: judge.readings(sample, None, **fault)
                       for label, fault in ctx.controls.items()}
    return out


def _loop(stream, pool, results, lat, count=None, deadline=None) -> int:
    """Submit windows until ``count`` of them or the ``deadline``; returns
    how many were submitted. Fills ``results`` and ``lat`` (seconds) per
    window index."""
    sent = {}
    i = 0
    while (i < count) if count is not None else \
            (time.perf_counter() < deadline):
        sent[i] = time.perf_counter()
        with trace.span("submit"):
            res = stream.submit(pool[i % len(pool)])
        now = time.perf_counter()
        if res is not None:
            results[i - 1] = res
            lat[i - 1] = now - sent[i - 1]
        i += 1
    res = stream.flush()
    now = time.perf_counter()
    if res is not None and i:
        results[i - 1] = res
        lat[i - 1] = now - sent[i - 1]
    return i


class Judge:
    """The reference's readings of served windows: the keypoints against
    the reference's, and the VRNN outputs by following the served choices
    with the stream's per-window noise worked out again."""

    def __init__(self, ctx, stream_seed, pool):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.ctx, self.stream_seed, self.pool = ctx, stream_seed, pool
        f = ctx.fields
        self.P = ref.make_params(f, ctx.seed, ctx.device)
        with torch.no_grad():
            aff = ref.Net(self.P, f, ref.Prec()).affinity()
        sk = extract_skeleton(aff.cpu().numpy())
        self.parents = [int(p) for p in sk.parents]
        self.order = [int(i) for i in sk.priority_indices]

    def _eps(self, index, B):
        f = self.ctx.fields
        seed = int(np.random.SeedSequence([self.stream_seed, index])
                   .generate_state(1)[0])
        g = torch.Generator(self.ctx.device).manual_seed(seed)
        return torch.randn((f["Ttot"], self.ctx.mix["sample_num"], B,
                            f["nlatent_kypt"]), generator=g,
                           device=self.ctx.device)

    @torch.no_grad()
    def readings(self, sample, results, prec="fp32", rank=0,
                 shift=0.0) -> dict:
        """Worst gaps over ``sample``: served (``results``) against the
        float32 reference, or, with ``results`` None, the reference in
        ``prec`` put in the program's place, with the faults: the VRNN's
        sample of ``rank`` by distance kept, the keypoints' coordinates
        moved by ``shift`` where they are made."""
        ctx, f = self.ctx, self.ctx.fields
        dev = ctx.device
        worst = dict(keypoints_gap=0.0, kypt_recon_gap=0.0, R_gap=0.0,
                     choice_gap=0.0, windows_missing=0.0)
        for i in sample:
            pts = torch.as_tensor(self.pool[i % len(self.pool)], device=dev)
            vox = ref.voxelize(pts, f["grid_size"])
            kp = ref.frozen_keypoints(self.P, f, ref.Prec(), vox,
                                      ctx.mix["ref_chunk"])
            eps = self._eps(i, pts.shape[0])
            net = ref.Net(self.P, f, ref.Prec())
            if results is None:
                low = ref.Net(self.P, f, ref.Prec(prec))
                kp_c = ref.frozen_keypoints(self.P, f, ref.Prec(prec), vox,
                                            ctx.mix["ref_chunk"])
                kp_c[..., :3] += shift
                enc = low.encode(kp_c, self.parents, self.order, eps,
                                 rank=rank)
                served = dict(keypoints=kp_c, kypt_recon=enc["kypt_recon"],
                              R=enc["R"])
            elif i not in results:
                worst["windows_missing"] += 1
                continue
            else:
                served = {k: torch.as_tensor(v, device=dev)
                          for k, v in results[i].items()}
            worst["keypoints_gap"] = max(worst["keypoints_gap"], float(
                (served["keypoints"].float() - kp).abs().max()))
            g = net.encode(kp, self.parents, self.order, eps,
                           follow=(served["kypt_recon"], served["R"]))
            for k in ("kypt_recon_gap", "R_gap", "choice_gap"):
                worst[k] = max(worst[k], g[k.replace("kypt_recon_gap",
                                                     "kypt_gap")])
        return worst
