"""The port's serving entry points on the CPU: the streaming session
against the JAX package's on the same weights and points, its lag-1 and
bucket semantics, and the rule that the port loads neither ``jax`` nor any
module of the JAX package.

Tolerances: keypoints 1e-4 and detector loss scalars 2e-3 relative, as in
test_torch_models.py (the windows are voxelized on each side, by the
port's plain K1 and by ``voxelize_jnp``, to the same occupancy).
"""
import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from neural_marionette_tpu.api import MarionetteStream as JaxStream
from neural_marionette_tpu.apps.common import DemoContext
from neural_marionette_tpu.models import NeuralMarionette as JaxMarionette
from neural_marionette_tpu.models import SkeletonArrays as JaxSkeletonArrays
from neural_marionette_tpu.ops import voxelize_jnp
from neural_marionette_tpu.skeleton import extract_skeleton as jax_skeleton

from neural_marionette_tpu_torch.api import Marionette

from _torch_port import configs, jax_params

REPO = Path(__file__).resolve().parents[1]


def _windows(n, B, T, N=512, seed=0):
    g = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        base = g.uniform(-0.6, 0.1, (B, 1, N, 3))
        drift = np.linspace(0, 0.4, T)[None, :, None, None] * \
            g.uniform(-1, 1, (B, 1, 1, 3))
        out.append((base + drift).astype(np.float32))
    return out


def _is_jax_module(name: str) -> bool:
    return (name == "jax" or name.startswith("jax.")
            or name == "neural_marionette_tpu"
            or name.startswith("neural_marionette_tpu."))


_IMPORT_CHECK = """
import importlib, pkgutil, sys
import neural_marionette_tpu_torch as pkg
import neural_marionette_tpu_torch.api as api
names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                 pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
want = {pkg.__name__ + "." + n for n in (
    "apps.common", "apps.generation", "apps.interpolation", "apps.retarget",
    "retarget", "data.pipeline", "train.step", "weights")}
assert want <= set(names), sorted(want - set(names))
bad = [n for n in sys.modules if n == "jax" or n.startswith("jax.")
       or n == "neural_marionette_tpu"
       or n.startswith("neural_marionette_tpu.")]
assert not bad, bad
import torch
assert not torch.cuda.is_available()
cfg = pkg.MarionetteConfig(grid_size=16, feat_dim=32, nkeypoints=6)
from neural_marionette_tpu_torch.train import Trainer
import shutil, tempfile
from neural_marionette_tpu_torch.apps.common import load_pretrained
opt_dir = tempfile.mkdtemp()
cfg.save_json(opt_dir + "/opt.json")
for entry in (api.Marionette.from_config, Trainer, api.Marionette.load,
              load_pretrained):
    arg = opt_dir if entry in (api.Marionette.load, load_pretrained) else cfg
    try:
        entry(arg)
    except RuntimeError as e:
        assert "no CUDA device" in str(e), e
    else:
        raise AssertionError(f"{entry} without a card did not raise")
shutil.rmtree(opt_dir)
print("clean")
"""


def test_port_imports_no_jax_and_wants_a_card():
    """In a fresh process (this one has jax loaded by conftest): importing
    every module of the port (the apps, ``retarget`` and ``data.pipeline``
    among them) loads neither ``jax`` nor any module of
    ``neural_marionette_tpu``, and the entry points (the serving model, the
    trainer and the loaders of an experiment directory) given no device ask
    for CUDA and raise without a card."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", _IMPORT_CHECK], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and "clean" in res.stdout, res.stderr


@pytest.mark.parametrize("script", ["chip_smoke.py"])
def test_chip_smoke_imports_no_jax_and_refuses_the_cpu(script):
    """The port's GPU script imports nothing of JAX, and without a card
    it exits with a nonzero code before printing any result."""
    tree = ast.parse((REPO / script).read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module]
    assert not [n for n in names if _is_jax_module(n)], names
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, script], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout and '"kernels"' not in res.stdout
    assert '"card"' not in res.stdout


def test_entry_points_take_cpu_when_asked():
    _, cfg = configs()
    m = Marionette.from_config(cfg, seed=3, device="cpu")
    assert m.device.type == "cpu"
    assert all(p.device.type == "cpu" for p in m.model.parameters())
    again = Marionette.from_config(cfg, seed=3, device="cpu")
    for (k, a), b in zip(m.model.state_dict().items(),
                         again.model.state_dict().values()):
        assert torch.equal(a, b), k


def test_stream_lag1_buckets_and_outputs():
    """submit() returns the previous window's results; a ragged B is padded
    to its bucket and sliced back; ``outputs`` may name recon and loss
    scalars; each window draws its own noise."""
    _, cfg = configs()
    m = Marionette.from_config(cfg, seed=0, device="cpu")
    T, K, G = cfg.Ttot, cfg.nkeypoints, cfg.grid_size
    keys = ("keypoints", "kypt_recon", "R", "recon", "vol_fit_reg")
    w = _windows(3, 3, T, seed=1)
    w[1] = w[1][:1]  # B = 1: no padding
    w[2] = w[0]      # the same points as window 0, new noise
    with m.stream(dtype="float32", sample_num=3, outputs=keys) as s:
        assert s.submit(w[0]) is None
        r0 = s.submit(w[1])
        r1 = s.submit(w[2])
        r2 = s.flush()
    assert r0["keypoints"].shape == (3, T, K, 4)
    assert r0["R"].shape == (3, T, K, 3, 3)
    assert r0["recon"].shape == (3, T, G, G, G, 1)
    assert r1["keypoints"].shape == (1, T, K, 4)
    assert r0["vol_fit_reg"].shape == ()
    for r in (r0, r1, r2):
        assert set(r) == set(keys)
        assert all(np.isfinite(v).all() for v in r.values())
    np.testing.assert_array_equal(r0["keypoints"], r2["keypoints"])
    assert not np.array_equal(r0["kypt_recon"], r2["kypt_recon"])
    with pytest.raises(RuntimeError):
        s.submit(w[0])
    with pytest.raises(ValueError):
        m.stream(dtype="float16")


def test_stream_matches_jax_stream():
    """The port's stream and the JAX package's, float32, on the same
    weights and point windows: the skeleton is equal, the keypoints and
    recon agree, and the port's loss scalars agree with the JAX
    ``encode_only`` on the same occupancy (the JAX stream returns only
    per-row outputs; the dynamics draw different noise on the two sides,
    so their outputs are checked in test_torch_models.py)."""
    jcfg, cfg = configs()
    model, params = jax_params(jcfg, seed=2)
    aff = model.apply(params, method=lambda m: m.kypt_detector.get_affinity())
    skeleton = jax_skeleton(np.asarray(aff))
    rows = ("keypoints", "recon")
    scalars = ("recon_loss", "vol_fit_reg", "separation_loss")
    windows = _windows(2, 2, jcfg.Ttot, seed=4)
    js = JaxStream(DemoContext(jcfg, model, params, skeleton),
                   skeleton=skeleton, dtype="float32", sample_num=3,
                   outputs=rows)
    want = list(js.run(windows))

    m = Marionette.from_jax_params(cfg, params, device="cpu")
    got = list(m.stream(dtype="float32", sample_num=3,
                        outputs=rows + scalars).run(windows))
    for a, b in zip(m.skeleton, skeleton):
        np.testing.assert_array_equal(a, b)
    assert len(got) == len(want) == 2
    sk = JaxSkeletonArrays.from_skeleton(skeleton)
    for w_pts, g, w in zip(windows, got, want):
        np.testing.assert_allclose(g["keypoints"], w["keypoints"], rtol=0,
                                   atol=1e-4)
        np.testing.assert_allclose(g["recon"], w["recon"], rtol=0, atol=1e-4)
        vox = voxelize_jnp(jnp.asarray(w_pts), jcfg.grid_size)
        ref = model.apply(params, vox, sk, sample_num=3,
                          method=JaxMarionette.encode_only,
                          rngs={"sample": jax.random.PRNGKey(0)})
        for k in scalars:
            np.testing.assert_allclose(g[k], np.asarray(ref[k]), rtol=2e-3,
                                       err_msg=k)
