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
from neural_marionette_tpu_torch.models import SkeletonArrays

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
import importlib, os, pkgutil, sys
import neural_marionette_tpu_torch as pkg
import neural_marionette_tpu_torch.api as api
names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                 pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
want = {pkg.__name__ + "." + n for n in (
    "apps.common", "apps.generation", "apps.interpolation", "apps.retarget",
    "retarget", "data.pipeline", "train.step", "weights", "data.datasets",
    "data.loader", "data.native", "eval", "cli.train", "cli.vis_generation",
    "cli.vis_interpolation", "cli.vis_retarget", "utils.console",
    "utils.preemption", "viz.raster", "viz.visualize", "viz.image_files",
    "skeleton_device", "cli.flagship", "utils.flops", "utils.profiling",
    "data.meshsample", "data.smpl_np", "data.prepare_dfaust",
    "data.prepare_aistpp", "parallel", "parallel.mesh",
    "parallel.distributed")}
assert want <= set(names), sorted(want - set(names))
bad = [n for n in sys.modules if n == "jax" or n.startswith("jax.")
       or n == "neural_marionette_tpu"
       or n.startswith("neural_marionette_tpu.")
       or n.split(".")[0] == "h5py"]
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
from neural_marionette_tpu_torch.cli import flagship
root = tempfile.mkdtemp()
try:
    flagship.main(["--root", root])
except RuntimeError as e:
    assert "no CUDA device" in str(e), e
else:
    raise AssertionError("cli.flagship without a card did not raise")
assert os.listdir(root) == [], os.listdir(root)
shutil.rmtree(root)
import numpy as np
from neural_marionette_tpu_torch.viz import raster, visualize
for render, args in (
        (raster.splat, (raster.default_camera(), np.zeros((1, 3)),
                        np.zeros((1, 3)))),
        (visualize.vis_recon, (np.zeros((1, 2, 4, 4, 4, 1)),) * 2)):
    try:
        render(*args)
    except RuntimeError as e:
        assert "no CUDA device" in str(e), e
    else:
        raise AssertionError(f"{render} without a card did not raise")
# a render on the CPU, written to files, loads no imaging library
work = tempfile.mkdtemp()
vox = np.zeros((1, 2, 8, 8, 8, 1), np.float32)
vox[:, :, 2:5, 3:6, 1:4] = 1
kp = np.random.default_rng(0).uniform(0, 1, (1, 2, 6, 4))
visualize.vis_keypoints(vox, kp, logger_path=work, affinity=np.ones((6, 6)),
                        mode="A", device="cpu")
from neural_marionette_tpu_torch.apps.generation import render_generation
render_generation(vox, work, Tcond=1, device="cpu")
from neural_marionette_tpu_torch.skeleton_device import \
    extract_skeleton_host_api
extract_skeleton_host_api(np.random.default_rng(1).uniform(
    size=(2, 6, 6, 1)), device="cpu")
# an OBJ whose texture is a JPEG, decoded by the host library
with open(os.path.join(work, "t.obj"), "w") as f:
    f.write("mtllib t.mtl\\nv 0 0 0\\nv 1 0 0\\nv 0 1 0\\nvt 0 0\\nvt 1 0\\n"
            "vt 0 1\\nf 1/1 2/2 3/3\\n")
with open(os.path.join(work, "t.mtl"), "w") as f:
    f.write("map_Kd " + os.path.abspath(
        "tests/torch_textures/jpeg_progressive_420.jpg") + "\\n")
from neural_marionette_tpu_torch.apps.retarget import load_obj_mesh
assert load_obj_mesh(os.path.join(work, "t.obj"))["texture"].shape == \
    (29, 37, 3)
shutil.rmtree(work)
imaging = [n for n in sys.modules if n.split(".")[0] in
           ("matplotlib", "imageio", "PIL", "mpl_toolkits")]
assert not imaging, imaging
from neural_marionette_tpu_torch.data import prefetch_to_device
try:
    next(prefetch_to_device(iter([])))
except RuntimeError as e:
    assert "no CUDA device" in str(e), e
else:
    raise AssertionError("prefetch_to_device without a card did not raise")
from neural_marionette_tpu_torch.parallel.distributed import initialize
try:
    initialize("localhost:1", 2, 0)
except RuntimeError as e:
    assert "no CUDA device" in str(e), e
else:
    raise AssertionError("initialize without a card did not raise")
print("clean")
"""


def test_port_imports_no_jax_and_wants_a_card():
    """In a fresh process (this one has jax loaded by conftest): importing
    every module of the port (the apps, ``retarget``, the data layer with
    the offline preparers, ``eval``, the CLIs with ``cli.flagship``,
    ``viz``, ``skeleton_device``, ``utils.flops`` / ``utils.profiling``
    and ``parallel.*`` among them) loads neither ``jax`` nor any module of
    ``neural_marionette_tpu`` nor ``h5py``, and the entry points (the
    serving model, the trainer, the loaders of an experiment directory,
    the prefetcher, the renders, ``cli.flagship`` without ``--smoke`` and
    the process group's ``initialize``) given no device ask for CUDA and
    raise without a card, the flagship before it writes anything; renders on the CPU,
    written to
    PNG and GIF files, the device skeleton extraction and an OBJ's JPEG
    texture read load none of ``matplotlib``, ``imageio`` and ``PIL``."""
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


# ------------------------------------------------- the stream's pruned work
DEFAULT_OUTPUTS = ("keypoints", "kypt_recon", "R")
LOSS_SCALARS = ("recon_loss", "vol_fit_reg", "separation_loss",
                "sparsity_loss", "local_const_loss", "time_const_loss",
                "sparsity_const_loss", "intensity_const_loss",
                "graph_traj_loss", "kl_kypt", "kypt_recon_loss")


def _pruning_marionette():
    jcfg, cfg = configs()
    _, params = jax_params(jcfg, seed=5)
    return Marionette.from_jax_params(cfg, params, device="cpu"), cfg


@pytest.mark.parametrize("outputs", [DEFAULT_OUTPUTS,
                                     ("recon", "affinity") + LOSS_SCALARS,
                                     ("vol_fit_reg", "heatmaps", "R")])
def test_encode_only_outputs_equal_the_full_path(outputs):
    """``encode_only`` with ``outputs`` returns those keys, each equal to
    the bit to the full path's (the same generator seed: the VRNN draws
    the same noise)."""
    m, cfg = _pruning_marionette()
    vox = torch.from_numpy(np.stack([np.asarray(voxelize_jnp(
        jnp.asarray(w), cfg.grid_size)) for w in _windows(1, 2, cfg.Ttot,
                                                           seed=7)[0]]))
    sk = SkeletonArrays.from_skeleton(m.extract_skeleton())
    with torch.no_grad():
        full = m.model.encode_only(vox, sk, sample_num=3,
                                   generator=torch.Generator().manual_seed(1))
        got = m.model.encode_only(vox, sk, sample_num=3, outputs=outputs,
                                  generator=torch.Generator().manual_seed(1))
    assert set(got) == set(outputs)
    for k in outputs:
        assert torch.equal(got[k], full[k]), k


def _counted_stream(m, outputs, windows):
    """The stream's results over ``windows`` and the calls of the decoder
    and of K2's plain version (the kernel's counterpart on the CPU)."""
    from neural_marionette_tpu_torch.ops import losses as L
    calls = {"decoder": 0, "chamfer": 0}
    plain = L.chamfer_num_plain

    def counted(*a, **k):
        calls["chamfer"] += 1
        return plain(*a, **k)

    with m.stream(dtype="float32", sample_num=3, outputs=outputs) as s:
        hook = s.model.kypt_detector.kypt_to_vox.register_forward_hook(
            lambda *_: calls.__setitem__("decoder", calls["decoder"] + 1))
        L.chamfer_num_plain = counted
        try:
            results = list(s.run(windows))
        finally:
            L.chamfer_num_plain = plain
            hook.remove()
    return results, calls


def test_stream_runs_only_the_work_of_its_outputs():
    """The default window runs neither the decoder nor K2 (its plain
    version here); ``recon`` runs the decoder once a window, ``vol_fit_reg``
    K2 once a window, and a stream of ``recon`` and every loss scalar both,
    as the full path does. The default keys are equal to the bit to those
    of a stream that asks for everything."""
    m, cfg = _pruning_marionette()
    m.extract_skeleton()
    windows = _windows(2, 2, cfg.Ttot, seed=8)
    default, calls = _counted_stream(m, DEFAULT_OUTPUTS, windows)
    assert calls == {"decoder": 0, "chamfer": 0}
    _, calls = _counted_stream(m, ("keypoints", "recon"), windows)
    assert calls == {"decoder": 2, "chamfer": 0}
    _, calls = _counted_stream(m, ("vol_fit_reg",), windows)
    assert calls == {"decoder": 0, "chamfer": 2}
    everything, calls = _counted_stream(
        m, DEFAULT_OUTPUTS + ("recon",) + LOSS_SCALARS, windows)
    assert calls == {"decoder": 2, "chamfer": 2}
    for a, b in zip(default, everything):
        for k in DEFAULT_OUTPUTS:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_unknown_output_raises():
    m, cfg = _pruning_marionette()
    with pytest.raises(KeyError, match="nope"):
        m.stream(outputs=("keypoints", "nope"))
    vox = torch.zeros((1, cfg.Ttot) + (cfg.grid_size,) * 3 + (1,))
    sk = SkeletonArrays.from_skeleton(m.extract_skeleton())
    with pytest.raises(KeyError, match="nope"):
        m.model.encode_only(vox, sk, outputs=("R", "nope"))
