"""The port's device skeleton extraction (``skeleton_device``, run here on
the CPU) against the port's host ``skeleton.py`` and the JAX
``skeleton_device`` (jitted), on the cases of ``tests/test_skeleton.py``:
the structured graphs (chain, star, two cliques bridged), the randomized
affinities, the tie-heavy quantized ones and a disconnected graph of
singletons. All three agree to the bit on every field (A, priority
values, priority indices, parents) and dtype. The trainer's and the
marionette's extractions go through it. About 10 s on one core.
"""
import numpy as np
import pytest
import torch

import jax

from neural_marionette_tpu.skeleton_device import (
    extract_skeleton_device as jax_extract_device)

from neural_marionette_tpu_torch.api import Marionette
from neural_marionette_tpu_torch.skeleton import extract_skeleton
from neural_marionette_tpu_torch.skeleton_device import (
    extract_skeleton_device, extract_skeleton_host_api)
from neural_marionette_tpu_torch.train import Trainer

from _torch_port import configs
from test_skeleton import _chain_affinity

FIELDS = ("A", "priority_values", "priority_indices", "parents")


def _star(K=6):
    star = np.zeros((1, K, K), dtype=np.float32)
    for i in range(K):
        for j in range(K):
            star[0, i, j] = 1e-4 * (i * K + j)
    for k in range(1, K):
        star[0, k, 0] = 1.0
        star[0, 0, k] = 0.5 + 0.01 * k
    return star[..., None]


def _two_cliques(K=6):
    two = np.zeros((2, K, K), dtype=np.float32)
    for grp in ([0, 1, 2], [3, 4, 5]):
        for i in grp:
            for j in grp:
                if i != j:
                    two[0, i, j] = 1.0
                    two[1, i, j] = 0.5
    return two[..., None]


def _pairs(K=8):
    """Four disconnected pairs: one bridge attempt leaves the graph in
    several components (unreachable distances, the root fallback)."""
    aff = np.full((1, K, K), 1e-4, np.float32)
    for a in range(0, K, 2):
        aff[0, a, a + 1] = aff[0, a + 1, a] = 1.0
    return aff[..., None]


def _random(seed):
    g = np.random.default_rng(1000 + seed)
    K = int(g.integers(4, 25))
    n = int(g.integers(1, 4))
    return g.uniform(size=(n, K, K, 1)).astype(np.float32)


def _tie_heavy(seed):
    g = np.random.default_rng(50 + seed)
    aff = (g.integers(0, 3, size=(2, 12, 12, 1)) / 2.0).astype(np.float32)
    aff += g.uniform(0, 1e-3, size=aff.shape).astype(np.float32)
    return aff


CASES = {"chain": lambda: _chain_affinity(8), "star": _star,
         "two_cliques": _two_cliques, "pairs": _pairs,
         **{f"random{s}": (lambda s=s: _random(s)) for s in range(10)},
         **{f"ties{s}": (lambda s=s: _tie_heavy(s)) for s in range(5)}}


@pytest.mark.parametrize("case", sorted(CASES))
def test_device_equals_host_and_jax(case):
    aff = CASES[case]()
    host = extract_skeleton(aff)
    port = extract_skeleton_host_api(aff, device="cpu")
    jx = jax.jit(jax_extract_device)(aff)
    for f in FIELDS:
        h, p, j = getattr(host, f), getattr(port, f), \
            np.asarray(getattr(jx, f))
        assert p.dtype == h.dtype, (f, p.dtype, h.dtype)
        assert np.array_equal(p, h), (f, p, h)
        assert np.array_equal(p, j), (f, p, j)


def test_device_skeleton_stays_on_the_affinity_device():
    aff = torch.as_tensor(_random(3))
    dsk = extract_skeleton_device(aff)
    assert all(getattr(dsk, f).device == aff.device for f in FIELDS)
    assert dsk.parents.dtype == torch.int32


def test_trainer_and_marionette_extract_on_the_device():
    _, cfg = configs()
    m = Marionette.from_config(cfg, seed=4, device="cpu")
    trainer = Trainer(cfg, device="cpu", dtype="float32", model=m.model)
    with torch.no_grad():
        aff = m.model.kypt_detector.get_affinity().numpy()
    host = extract_skeleton(aff)
    for sk in (m.extract_skeleton(), trainer.extract_skeleton()):
        for f in FIELDS:
            assert np.array_equal(getattr(sk, f), getattr(host, f)), f
