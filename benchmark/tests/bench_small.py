"""Small sizes of the benchmark's cells for the CPU tests: every width of
the configurations cut so that a run takes seconds on the CPU."""
import torch

from benchmark.registry import Registry
from benchmark.run import execute

SMALL = dict(grid_size=32, feat_dim=32, nkeypoints=6, nlatent_kypt=16,
             nhidden_kypt=32, n_points=256)


def small(cell, compute_dtype=None, **mix_kw):
    """(registry, fields, mix) of ``cell`` at the small sizes."""
    r = Registry()
    c = r.cell(cell)
    f = dict(r.config(c["config"])["model"], **SMALL)
    if compute_dtype:
        f["compute_dtype"] = compute_dtype
    m = dict(r.traffic(c["traffic"]))
    if m["driver"] == "train_loop":
        f.update(Ttot=4, nbatch=4, grad_accum=2, sample_rate=2)
        m.update(sequences=6, frames=10, points=300, workers=2, ref_chunk=2,
                 trace_steps=1)
    else:
        f.update(Ttot=4)
        m.update(B=2, N=256, pool=3, warmup=2, checked=3, ref_chunk=2,
                 trace_windows=3)
    m.update(mix_kw)
    return r, f, m


def run_small(cell, tmp, seed=123456789012, seconds=0.5, compute_dtype=None,
              controls=None, **mix_kw):
    """One run of ``cell`` at the small sizes on the CPU, its data under
    ``tmp``."""
    r, f, m = small(cell, compute_dtype, **mix_kw)
    return execute(r, cell, seed, seconds, False, torch.device("cpu"),
                   str(tmp), controls=controls, fields=f, mix=m)
