"""The port's render sets, the textured-OBJ reader and ``debug_nans`` on
the CPU against the JAX package.

* ``apps.{generation,interpolation,retarget}.save_outputs`` given the same
  results (no model: voxel clips, keypoints, a skeleton and a retarget
  result made from numpy seeds) write the same inventory of files as the
  JAX functions; every surfel, mesh and skeleton PNG equals the JAX PNG up
  to ``MAX_MISMATCH_SHARE`` of its pixels (the raster's bound,
  ``tests/test_torch_viz.py``; measured: 0); the GIFs decode with the
  frame count and size of the PNG set or video and the port's delays
  (100 ms renders, 150 ms videos). The retarget sets run both ways: a
  point target (surfels) and a textured OBJ mesh.
* ``apps.retarget.load_obj_mesh`` of an OBJ + MTL with a PNG texture equal
  to the JAX package's to the bit; a JPEG texture raises naming the
  format and asking for a PNG; a declared texture that is missing warns
  and gives no texture, the JAX function's None.
* ``debug_nans``: a port ``Trainer`` step and the JAX detector forward
  under ``jax_debug_nans`` (restored after) both raise
  ``FloatingPointError`` on a NaN parameter, and neither raises on the
  clean parameters.

About 60 s on one core (the JAX renders draw with matplotlib and NumPy).
"""
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from PIL import Image

from neural_marionette_tpu.apps import generation as JG
from neural_marionette_tpu.apps import interpolation as JI
from neural_marionette_tpu.apps import retarget as JRT
from neural_marionette_tpu.viz import raster as JR

from neural_marionette_tpu_torch.apps import generation as PG
from neural_marionette_tpu_torch.apps import interpolation as PI
from neural_marionette_tpu_torch.apps import retarget as PRT
from neural_marionette_tpu_torch.retarget import RetargetResult
from neural_marionette_tpu_torch.skeleton import extract_skeleton
from neural_marionette_tpu_torch.train import Trainer
from neural_marionette_tpu_torch.viz.image_files import read_png

from _torch_port import configs, jax_params, moving_vox

MAX_MISMATCH_SHARE = 1e-4
G, K = 16, 6


def _blobs(n, T, seed):
    g = np.random.default_rng(seed)
    vox = np.zeros((n, T, G, G, G, 1), np.float32)
    for s in range(n):
        c = g.integers(6, 10, 3)
        for t in range(T):
            x = c[0] + t - 2   # every frame differs: Pillow merges equal ones
            vox[s, t, x - 3:x + 3, c[1] - 4:c[1] + 4, c[2] - 2:c[2] + 2] = 1
    return vox


def _keypoints(n, T, seed):
    g = np.random.default_rng(seed)
    return np.concatenate([g.uniform(-0.7, 0.7, (n, T, K, 3)),
                           g.uniform(0.3, 1.0, (n, T, K, 1))],
                          -1).astype(np.float32)


def _skeleton(seed=0):
    g = np.random.default_rng(seed)
    return extract_skeleton(g.uniform(size=(2, K, K, 1)).astype(np.float32))


def _inventory(root: Path):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*")
                  if p.is_file())


def _gif_info(path):
    im = Image.open(path)
    delays = []
    for k in range(im.n_frames):
        im.seek(k)
        delays.append(im.info.get("duration"))
    return im.n_frames, im.size, delays


def _check_against_jax(jdir: Path, pdir: Path):
    assert _inventory(pdir) == _inventory(jdir)
    pngs = [p for p in _inventory(pdir) if p.endswith(".png")]
    assert pngs
    for name in pngs:
        j = np.asarray(Image.open(jdir / name).convert("RGB"))
        p = read_png(str(pdir / name))
        assert j.shape == p.shape, name
        share = np.any(j != p, -1).mean()
        assert share <= MAX_MISMATCH_SHARE, (name, share)
    for name in (p for p in _inventory(pdir) if p.endswith(".gif")):
        n, size, delays = _gif_info(pdir / name)
        jn, jsize, _ = _gif_info(jdir / name)
        assert (n, size) == (jn, jsize), name
        assert delays == [150 if name.startswith("gifs") else 100] * n, name


def test_generation_save_outputs_equal_jax(tmp_path):
    S, T, Tcond = 2, 4, 2
    gv = _blobs(S, T, seed=0)
    gv[1, 2] = 0   # an empty frame: white in the GIF, no PNG
    result = dict(gen_voxels=gv, keypoints=_keypoints(S, T, 1),
                  skeleton=_skeleton())
    cond = gv[0, :Tcond]
    JG.save_outputs(result, str(tmp_path / "jax"), vox_cond=cond,
                    Tcond=Tcond)
    stats = PG.save_outputs(result, str(tmp_path / "port"), vox_cond=cond,
                            Tcond=Tcond, device="cpu")
    _check_against_jax(tmp_path / "jax", tmp_path / "port")
    assert stats["render_generation"]["frames"] == S * T
    assert not (tmp_path / "port/gen_result_imgs_1/02.png").exists()


def test_interpolation_save_outputs_equal_jax(tmp_path):
    T = 5
    result = dict(interp_voxels=_blobs(1, T, seed=2)[0],
                  keypoints=_keypoints(1, T, 3)[0], skeleton=_skeleton(1))
    clip = _blobs(1, T, seed=4)[0]
    JI.save_outputs(result, str(tmp_path / "jax"), vox_clip=clip)
    PI.save_outputs(result, str(tmp_path / "port"), vox_clip=clip,
                    device="cpu")
    _check_against_jax(tmp_path / "jax", tmp_path / "port")


def _write_textured_obj(root: Path, texture="png"):
    """A UV sphere of radius 0.5 with quads (fan-triangulated by the
    reader), UVs on every corner, and a 12 x 16 texture."""
    root.mkdir(parents=True, exist_ok=True)
    v, _ = JR.sphere_mesh(0.5, res=6)
    g = np.random.default_rng(5)
    lines = ["mtllib target.mtl"]
    lines += [f"v {a:.6f} {b:.6f} {c:.6f}" for a, b, c in v]
    lines += [f"vt {a:.4f} {b:.4f}" for a, b in g.uniform(size=(len(v), 2))]
    res = 6
    for i in range(res - 1):
        for j in range(2 * res):
            a = i * 2 * res + j + 1
            b = i * 2 * res + (j + 1) % (2 * res) + 1
            lines.append(f"f {a}/{a} {b}/{b} {b + 2 * res}/{b + 2 * res} "
                         f"{a + 2 * res}/{a + 2 * res}")
    (root / "target.obj").write_text("\n".join(lines) + "\n")
    name = f"tex.{'png' if texture == 'png' else 'jpg'}"
    (root / "target.mtl").write_text(f"newmtl m\nmap_Kd {name}\n")
    img = (g.uniform(size=(12, 16, 3)) * 255).astype(np.uint8)
    if texture != "missing":
        Image.fromarray(img).save(root / name)
    return root / "target.obj", img


def test_textured_obj_reads_like_jax(tmp_path):
    path, img = _write_textured_obj(tmp_path / "png")
    j, p = JRT.load_obj_mesh(str(path)), PRT.load_obj_mesh(str(path))
    assert set(j) == set(p)
    for key in j:
        assert j[key].dtype == p[key].dtype, key
        assert np.array_equal(j[key], p[key]), key
    assert np.array_equal(p["texture"], img.astype(np.float32) / 255.0)
    # a JPEG texture (Pillow's default: 4:2:0, quality 75) is decoded by
    # the host library to the bit of the JAX package's imageio read
    jpg, _ = _write_textured_obj(tmp_path / "jpg", texture="jpeg")
    j, p = JRT.load_obj_mesh(str(jpg)), PRT.load_obj_mesh(str(jpg))
    assert set(j) == set(p)
    for key in j:
        assert j[key].dtype == p[key].dtype, key
        assert np.array_equal(j[key], p[key]), key
    assert p["texture"].shape == (12, 16, 3)
    missing, _ = _write_textured_obj(tmp_path / "missing", texture="missing")
    with pytest.warns(UserWarning, match="does not exist"):
        assert PRT.load_obj_mesh(str(missing))["texture"] is None
    assert JRT.load_obj_mesh(str(missing))["texture"] is None


def _retarget_out(target_points, T=2, seed=6):
    g = np.random.default_rng(seed)
    N = len(target_points)
    drift = np.linspace(0, 0.2, T)[:, None, None] * np.array([1.0, 0, 0.5])
    new_points = target_points[None] + drift
    w = g.uniform(size=(N, K))
    src_kp = _keypoints(1, T, seed)[0]
    src_kp[:, 0, 3] = 1.0   # the root valid
    res = RetargetResult(new_points=new_points,
                         new_keypoints=src_kp + np.array([0.1, 0, 0, 0]),
                         skin_weights=w / w.sum(1, keepdims=True))
    return dict(result=res, skeleton=_skeleton(2), source_keypoints=src_kp,
                target_keypoints=src_kp[None, :1])


@pytest.mark.parametrize("target", ["points", "textured_mesh"])
def test_retarget_save_outputs_equal_jax(tmp_path, target):
    T = 2
    source_vox = _blobs(1, T, seed=7)[0]
    if target == "points":
        g = np.random.default_rng(8)
        points = np.round(g.uniform(-0.5, 0.5, (700, 3)) * 10) / 10
        mesh = None
    else:
        path, _ = _write_textured_obj(tmp_path / "obj")
        points, mesh = PRT.load_target_points(str(path), return_mesh=True)
    out = _retarget_out(points, T)
    JRT.save_outputs(out, str(tmp_path / "jax"), source_vox=source_vox,
                     target_mesh=mesh, target_points=points)
    stats = PRT.save_outputs(out, str(tmp_path / "port"),
                             source_vox=source_vox, target_mesh=mesh,
                             target_points=points, device="cpu")
    _check_against_jax(tmp_path / "jax", tmp_path / "port")
    names = _inventory(tmp_path / "port")
    assert ("textured.gif" in names) == (target == "textured_mesh")
    assert {"source.gif", "smooth.gif", "skeleton.gif", "overlay.gif",
            "target.png", "target_skin.png"} <= set(names)
    assert set(stats) == {"host_ms", "render_ms", "encode_ms"}


# ------------------------------------------------------------ debug_nans
def _poison(named_params):
    name, p = next((n, p) for n, p in named_params if p.ndim > 1)
    with torch.no_grad():
        p.view(-1)[0] = float("nan")
    return name


def test_debug_nans_raises_on_nan_parameters_like_jax():
    jcfg, cfg = configs()
    cfg = cfg.replace(debug_nans=1)
    vox, pts = moving_vox(B=1, T=4, G=32, n=128)
    clean = Trainer(cfg, device="cpu", dtype="float32")
    clean.train_epoch(0, [pts])   # no raise
    bad = Trainer(cfg, device="cpu", dtype="float32")
    _poison(bad.model.named_parameters())
    with pytest.raises(FloatingPointError, match="epoch 0 step 0"):
        bad.train_epoch(0, [pts])

    model, params = jax_params(jcfg)

    def fwd(p):
        return model.apply(p, jnp.asarray(vox), method=lambda m, v:
                           m.kypt_detector(v, affinity_active=True))

    poisoned = jax.tree_util.tree_map(np.array, params)
    leaf = jax.tree_util.tree_leaves(
        poisoned["params"]["kypt_detector"]["vox_to_kypt"])[0]
    leaf.flat[0] = np.nan
    before = jax.config.jax_debug_nans
    jax.config.update("jax_debug_nans", True)
    try:
        jax.block_until_ready(jax.jit(fwd)(params))   # no raise
        # eagerly, op by op: a jitted call's check can be skipped when the
        # process already holds an executable of the same computation
        with pytest.raises(FloatingPointError), jax.disable_jit():
            fwd(poisoned)
    finally:
        jax.config.update("jax_debug_nans", before)
    assert jax.config.jax_debug_nans == before
