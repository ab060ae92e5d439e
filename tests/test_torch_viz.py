"""The port's render layer (``viz/``) on the CPU against the JAX package's
``viz`` (NumPy rasterizer, matplotlib figures, imageio files).

* raster: the primitive meshes, ``_align_z`` (the antiparallel case too),
  ``transform``, ``skeleton_geometry``, ``estimate_normals``,
  ``mesh_samples``, ``shade``, ``Camera.project`` and
  ``Camera.from_o3d_json`` equal to the bit; ``splat`` (px 1 and 2, onto a
  given frame, empty input) and ``render_mesh`` / ``render_surfels``
  images equal to the JAX images on a 96 x 80 ``look_at`` camera and at
  the reference camera (1025 x 958), up to ``MAX_MISMATCH_SHARE`` of the
  pixels, each such pixel shown to be an exact depth tie, a depth within
  4 ulp, or a sample within 1e-9 pixel of a rounding boundary (the port
  reproduces NumPy's fused products bit for bit and paints exact depth
  ties in NumPy's order);
  ``splat`` on repeated points (exact ties) equal to the bit;
* files: the PNG read back by imageio equal to ``to_uint8``; the GIF read
  back by Pillow with its frame count, size, 100 ms delay and loop, and a
  mean absolute error no worse than imageio's own GIF of the same frames
  plus 1/255 (whose frames carry no delay and which has no loop
  extension: the JAX package's GIF fault);
* ``vis_*``: the projection within 0.5 px of matplotlib's
  (``proj3d.proj_transform`` then ``transData``) in the one- and
  two-panel figures, the JAX shapes, and each keypoint's colour present
  within 1 px of its matplotlib projection;
* a render asked for on ``cuda`` without a card raises.

About 15 s on one core.
"""
import numpy as np
import pytest
import torch

import matplotlib
matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
from mpl_toolkits.mplot3d import proj3d  # noqa: E402
import imageio.v2 as imageio  # noqa: E402
from PIL import Image  # noqa: E402

from neural_marionette_tpu.viz import raster as JR  # noqa: E402
from neural_marionette_tpu.viz import visualize as JV  # noqa: E402

from neural_marionette_tpu_torch.viz import image_files as F  # noqa: E402
from neural_marionette_tpu_torch.viz import raster as PR  # noqa: E402
from neural_marionette_tpu_torch.viz import visualize as PV  # noqa: E402

MAX_MISMATCH_SHARE = 1e-4
SMALL_CAM = dict(eye=(1.6, 1.2, 2.2), W=96, H=80)


def _cams():
    return {"look_at": (JR.Camera.look_at(**SMALL_CAM),
                        PR.Camera.look_at(**SMALL_CAM)),
            "reference": (JR.default_camera(), PR.default_camera())}


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# --------------------------------------------------------------- raster
def test_primitives_equal_jax_to_the_bit():
    for fn, args in ((JR.sphere_mesh, (0.03,)), (JR.cone_mesh, (0.03, 0.4)),
                     (JR.cylinder_mesh, (0.05, 0.3))):
        jv, jf = fn(*args)
        pv, pf = getattr(PR, fn.__name__)(*args)
        assert np.array_equal(jv, pv) and np.array_equal(jf, pf)
    g = np.random.default_rng(0)
    for d in [g.normal(size=3), np.array([0.0, 0.0, 1.0]),
              np.array([0.0, 0.0, -1.0]), np.array([1e-3, 0.0, -1.0])]:
        assert np.array_equal(JR._align_z(d), PR._align_z(d))
    R = JR._align_z(g.normal(size=3))
    v = g.normal(size=(20, 3))
    assert np.array_equal(JR.transform(v, R=R, t=[1.0, 2, 3]),
                          PR.transform(v, R=R, t=[1.0, 2, 3]))
    assert np.array_equal(JR._spaced_colors(24), PR._spaced_colors(24))


@pytest.mark.parametrize("K", [1, 7])
def test_skeleton_geometry_equals_jax(K):
    g = np.random.default_rng(K)
    kp = g.uniform(-0.7, 0.7, (K, 3))
    kp[-1] = kp[0]   # a zero-length bone is skipped
    parents = np.array([0] + [int(g.integers(0, k)) for k in range(1, K)])
    valid = g.uniform(size=K) > 0.2
    valid[0] = True
    for j, p in zip(JR.skeleton_geometry(kp, parents, valid=valid),
                    PR.skeleton_geometry(kp, parents, valid=valid)):
        assert j.dtype == p.dtype and np.array_equal(j, p)


def test_normals_samples_shade_project_equal_jax():
    g = np.random.default_rng(1)
    pts = np.round(g.uniform(-0.6, 0.6, (700, 3)) * 15) / 15   # a lattice
    assert np.array_equal(JR.estimate_normals(pts),
                          PR.estimate_normals(pts))
    v, f, _ = JR.skeleton_geometry(g.uniform(-0.5, 0.5, (5, 3)),
                                   np.array([0, 0, 1, 1, 3]))
    for jc, pc in _cams().values():
        for a, b in zip(JR.mesh_samples(v, f, jc), PR.mesh_samples(v, f, pc)):
            assert np.array_equal(a, b)
        x = g.uniform(-1, 1, (5000, 3))
        for a, b in zip(jc.project(x), pc.project(torch.as_tensor(x))):
            assert np.array_equal(a, _np(b))
    n = g.normal(size=(5000, 3))
    col = g.uniform(size=(5000, 3)).astype(np.float32)
    want = JR.shade(col, n, (0.3, 0.5, -1.0))
    got = PR.shade(torch.as_tensor(col), torch.as_tensor(n), (0.3, 0.5, -1.0))
    assert got.dtype == torch.float64 and np.array_equal(want, _np(got))


def test_fma_is_correctly_rounded():
    from fractions import Fraction
    g = np.random.default_rng(2)
    a = g.normal(size=2000) * 10.0 ** g.integers(-4, 4, 2000)
    b = g.normal(size=2000)
    c = -a * b * (1 + g.normal(size=2000) * 1e-9)   # cancellation
    got = _np(PR._fma(torch.as_tensor(a), torch.as_tensor(b),
                      torch.as_tensor(c)))
    want = [float(Fraction(x) * Fraction(y) + Fraction(z))
            for x, y, z in zip(a, b, c)]
    assert np.array_equal(got, np.array(want))


def test_camera_from_o3d_json_equals_jax():
    j, p = JR.Camera.from_o3d_json(JR.REFERENCE_CAMERA_JSON), \
        PR.Camera.from_o3d_json(PR.REFERENCE_CAMERA_JSON)
    for a, b in zip(j, p):
        assert np.array_equal(a, b)
    assert (p.W, p.H) == (1025, 958)
    for a, b in zip(PR.default_camera(), p):
        assert np.array_equal(a, b)
    missing = PR.default_camera("/nonexistent/camera.json")
    assert (missing.W, missing.H) == (512, 512)   # the look_at fallback


def _explained(cam, pts, px, rows, cols):
    """Each mismatched pixel an exact depth tie, a depth within 4 ulp of
    the runner-up, or a sample within 1e-9 px of a rounding boundary, in
    the JAX projection."""
    u, v, z = cam.project(np.asarray(pts, np.float64))
    ui, vi = np.round(u).astype(np.int64), np.round(v).astype(np.int64)
    half = (np.abs(np.abs(u - np.floor(u)) - 0.5) < 1e-9) | \
        (np.abs(np.abs(v - np.floor(v)) - 0.5) < 1e-9)
    for r, c in zip(rows, cols):
        best = None
        for rank, (du, dv) in enumerate((du, dv) for du in range(-px + 1, px)
                                         for dv in range(-px + 1, px)):
            hit = np.nonzero((ui + du == c) & (vi + dv == r))[0]
            if len(hit):
                best = hit
        near = (np.abs(ui - c) <= px) & (np.abs(vi - r) <= px)
        if best is None or half[near].any():
            continue
        zs = np.sort(z[best])
        assert len(zs) > 1 and zs[1] - zs[0] <= 4 * np.spacing(zs[0]), \
            f"pixel ({r}, {c}) unexplained"


def _compare(j, p, cam, pts, px):
    j, p = np.asarray(j), _np(p)
    assert j.shape == p.shape and p.dtype == np.float32
    bad = np.any(j != p, -1)
    assert bad.mean() <= MAX_MISMATCH_SHARE, bad.mean()
    _explained(cam, pts, px, *np.nonzero(bad))


@pytest.mark.parametrize("cam_name", ["look_at", "reference"])
@pytest.mark.parametrize("px", [1, 2])
def test_splat_equals_jax(cam_name, px):
    jc, pc = _cams()[cam_name]
    g = np.random.default_rng(px)
    pts = g.uniform(-0.9, 0.9, (4000, 3))
    cols = g.uniform(size=(4000, 3))
    _compare(JR.splat(jc, pts, cols, px=px),
             PR.splat(pc, pts, cols, px=px, device="cpu"), jc, pts, px)
    base = g.uniform(size=(jc.H, jc.W, 3)).astype(np.float32)
    _compare(JR.splat(jc, pts[:500], cols[:500], img=base.copy(), px=px),
             PR.splat(pc, pts[:500], cols[:500], img=base.copy(), px=px,
                      device="cpu"), jc, pts[:500], px)
    empty = PR.splat(pc, np.zeros((0, 3)), np.zeros((0, 3)), img=base,
                     device="cpu")
    assert np.array_equal(_np(empty), base)
    assert np.array_equal(_np(PR.splat(pc, np.zeros((0, 3)),
                                       np.zeros((0, 3)), device="cpu")),
                          JR.splat(jc, np.zeros((0, 3)), np.zeros((0, 3))))


def test_splat_exact_ties_and_offset_order():
    """Exact depth ties paint in NumPy's ``argsort(-z)`` order, as the JAX
    function's; a later offset wins over a nearer sample of an earlier
    one."""
    jc, pc = _cams()["look_at"]
    g = np.random.default_rng(10)
    p = np.repeat(g.uniform(-0.5, 0.5, (40, 3)), 7, axis=0)
    c = g.uniform(size=(len(p), 3))
    for px in (1, 2):
        assert np.array_equal(_np(PR.splat(pc, p, c, px=px, device="cpu")),
                              JR.splat(jc, p, c, px=px))
    near = np.array([[0.1, 0.2, 0.3], [0.0, 0.0, 0.0]])
    near[1] = near[0] + 0.05 * (jc.eye - near[0])   # nearer, next pixel
    assert np.array_equal(_np(PR.splat(pc, near, np.eye(3)[:2], px=2,
                                       device="cpu")),
                          JR.splat(jc, near, np.eye(3)[:2], px=2))


@pytest.mark.parametrize("cam_name", ["look_at", "reference"])
def test_render_mesh_and_surfels_equal_jax(cam_name):
    jc, pc = _cams()[cam_name]
    g = np.random.default_rng(3)
    v, f, c = JR.skeleton_geometry(g.uniform(-0.6, 0.6, (6, 3)),
                                   np.array([0, 0, 1, 2, 2, 4]))
    pts, _, _, _ = JR.mesh_samples(v, f, jc)
    _compare(JR.render_mesh(jc, v, f, vert_colors=c),
             PR.render_mesh(pc, v, f, vert_colors=c, device="cpu"), jc, pts, 1)
    _compare(JR.render_mesh(jc, v, f, color=(0.3, 0.6, 0.9)),
             PR.render_mesh(pc, v, f, color=(0.3, 0.6, 0.9), device="cpu"),
             jc, pts, 1)
    sp = np.round(g.uniform(-0.7, 0.7, (600, 3)) * 12) / 12
    n = JR.estimate_normals(sp)
    cols = np.array([[0.6, 1.0, 0.6]]) * g.uniform(0.2, 1.0, (600, 1))
    base = np.full((jc.H, jc.W, 3), 0.5, np.float32)
    disc_pts = sp[:, None] + 0.03 * g.uniform(-1, 1, (600, 24, 3))
    _compare(JR.render_surfels(jc, sp, n, cols, img=base.copy()),
             PR.render_surfels(pc, sp, n, cols, img=base.copy(),
                               device="cpu"), jc, disc_pts.reshape(-1, 3), 2)


def test_render_frames_equal_one_call_a_frame():
    cam = PR.Camera.look_at(**SMALL_CAM)
    g = np.random.default_rng(4)
    meshes = [dict(zip(("verts", "faces", "vert_colors"),
                       PR.skeleton_geometry(g.uniform(-0.6, 0.6, (4, 3)),
                                            np.array([0, 0, 1, 2]))))
              for _ in range(3)]
    batch = PR.render_mesh_frames(cam, meshes, PR.blank(cam, 3, device="cpu"))
    for i, m in enumerate(meshes):
        assert torch.equal(batch[i], PR.render_mesh(cam, **m, device="cpu"))


def test_render_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cam = PR.Camera.look_at(**SMALL_CAM)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PR.splat(cam, np.zeros((1, 3)), np.zeros((1, 3)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PV.vis_recon(np.zeros((1, 2, 4, 4, 4, 1)), np.zeros((1, 2, 4, 4, 4, 1)))


# ---------------------------------------------------------------- files
def test_png_lossless_and_read_back(tmp_path):
    g = np.random.default_rng(5)
    img = g.uniform(-0.1, 1.1, (37, 53, 3)).astype(np.float32)
    F.save_png(img, str(tmp_path / "a.png"))
    assert np.array_equal(imageio.imread(tmp_path / "a.png"), F.to_uint8(img))
    assert np.array_equal(F.to_uint8(img), JR.to_uint8(img))
    assert np.array_equal(F.to_uint8(torch.as_tensor(img)), JR.to_uint8(img))
    # PNGs written by another encoder (adaptive filters), RGB and RGBA
    rgba = (g.uniform(size=(29, 31, 4)) * 255).astype(np.uint8)
    Image.fromarray(rgba).save(tmp_path / "b.png")
    assert np.array_equal(F.read_png(str(tmp_path / "b.png")), rgba)
    Image.fromarray(rgba[..., :3]).save(tmp_path / "c.png")
    assert np.array_equal(F.read_png(str(tmp_path / "c.png")), rgba[..., :3])


def _gif_frames(path):
    im = Image.open(path)
    out, delays = [], []
    for k in range(im.n_frames):
        im.seek(k)
        delays.append(im.info.get("duration"))
        out.append(np.asarray(im.convert("RGB")).astype(np.float64))
    return out, delays, im.size, im.info.get("loop")


@pytest.mark.parametrize("kind", ["few_colours", "many_colours"])
def test_gif_read_back_by_pillow(tmp_path, kind):
    g = np.random.default_rng(6)
    H, W = 60, 90
    if kind == "few_colours":
        frames = [np.repeat(g.uniform(size=(H, W, 1)) > 0.5, 3, -1)
                  * np.array([0.2, 0.4, 0.8], np.float32) for _ in range(3)]
    else:
        y, x = np.mgrid[0:H, 0:W]
        frames = [np.stack([x / W, y / H, 0.5 + 0.5 * np.sin(x / 7 + k)], -1)
                  .astype(np.float32) for k in range(3)]
        frames.append(g.uniform(size=(H, W, 3)).astype(np.float32))
    F.write_gif([F.to_uint8(f) for f in frames], str(tmp_path / "p.gif"),
                0.1)
    imageio.mimsave(tmp_path / "i.gif", [F.to_uint8(f) for f in frames],
                    duration=0.1)
    got, delays, size, loop = _gif_frames(tmp_path / "p.gif")
    ref, ref_delays, _, ref_loop = _gif_frames(tmp_path / "i.gif")
    assert len(got) == len(frames) and size == (W, H)
    assert delays == [100] * len(frames) and loop == 0
    # the JAX package's writer (imageio 2.37 through Pillow, which reads
    # the duration in ms): no delay, no loop extension (ROADMAP Queue 3)
    assert not any(ref_delays) and ref_loop is None
    for k, f in enumerate(frames):
        want = F.to_uint8(f).astype(np.float64)
        mae = np.abs(got[k] - want).mean() / 255
        mae_ref = np.abs(ref[k] - want).mean() / 255
        assert mae <= mae_ref + 1 / 255, (k, mae, mae_ref)
        if kind == "few_colours":
            assert mae == 0.0


# ------------------------------------------------------------- vis_*
@pytest.mark.parametrize("npanels", [1, 2])
def test_vis_projection_within_half_a_pixel_of_matplotlib(npanels):
    g = np.random.default_rng(7)
    fig = plt.figure(figsize=(3 * npanels, 3), dpi=64)
    axes = [fig.add_subplot(1, npanels, i + 1, projection="3d")
            for i in range(npanels)]
    for ax in axes:
        ax.scatter([0], [0], [0])
        ax.set_xlim(-1, 1)
        ax.set_ylim(-1, 1)
        ax.set_zlim(-1, 1)
        ax.set_axis_off()
    fig.canvas.draw()
    for i, ax in enumerate(axes):
        p = g.uniform(-1.2, 1.2, (500, 3))
        xs, ys, _ = proj3d.proj_transform(p[:, 0], p[:, 1], p[:, 2], ax.M)
        d = ax.transData.transform(np.stack([xs, ys], -1))
        col, row, _, _ = PV.project(PV.view(3, npanels, i),
                                    torch.as_tensor(p))
        assert np.abs(_np(col) - d[:, 0]).max() < 0.5
        assert np.abs((192 - _np(row)) - d[:, 1]).max() < 0.5
    plt.close(fig)


def _clip(G=16, B=2, T=3, seed=8):
    g = np.random.default_rng(seed)
    vox = np.zeros((B, T, G, G, G, 1), np.float32)
    for b in range(B):
        for t in range(T):
            c = g.integers(5, 11, 3)
            vox[b, t, c[0] - 3:c[0] + 3, c[1] - 4:c[1] + 4,
                c[2] - 2:c[2] + 2] = 1
    return vox


@pytest.mark.parametrize("mode", ["affinity", "A"])
def test_vis_shapes_equal_jax(mode):
    g = np.random.default_rng(9)
    vox = _clip()
    K = 6
    kp = np.concatenate([g.uniform(-0.8, 0.8, (2, 3, K, 3)),
                         g.uniform(0, 1, (2, 3, K, 1))], -1)
    aff = g.uniform(size=(2, K, K, 1)) if mode == "affinity" else \
        np.eye(K, k=1) + np.eye(K, k=-1)
    j = JV.vis_keypoints(vox, kp, affinity=aff, mode=mode, Tcond=1,
                         log_num=1)
    p = PV.vis_keypoints(vox, kp, affinity=aff, mode=mode, Tcond=1,
                         log_num=1, device="cpu")
    assert p.shape == j.shape == (1, 3, 192, 192, 3) and p.dtype == j.dtype
    jr = JV.vis_recon(vox, vox * 0.7, Tcond=2)
    pr = PV.vis_recon(vox, vox * 0.7, Tcond=2, device="cpu")
    assert pr.shape == jr.shape == (2, 3, 192, 384, 3) and pr.dtype == jr.dtype
    # white where matplotlib drew nothing near
    assert (p == 255).all(-1).mean() > 0.9


def test_vis_keypoint_colours_at_their_matplotlib_projection():
    """Intensity-1 keypoints, far apart, no voxels: each keypoint's tab20
    colour appears within 1 px of where matplotlib projects it."""
    K = 5
    kp = np.array([[-0.6, -0.5, -0.4, 1], [0.6, 0.5, -0.5, 1],
                   [0.0, 0.7, 0.6, 1], [-0.5, 0.4, 0.6, 1],
                   [0.5, -0.6, 0.3, 1]], np.float64)[None, None]
    vox = np.zeros((1, 1, 8, 8, 8, 1), np.float32)
    img = PV.vis_keypoints(vox, kp, device="cpu")[0, 0]
    fig = plt.figure(figsize=(3, 3), dpi=64)
    ax = fig.add_subplot(111, projection="3d")
    ax.set_xlim(-1, 1)
    ax.set_ylim(-1, 1)
    ax.set_zlim(-1, 1)
    fig.canvas.draw()
    x, y, z = kp[0, 0, :, 0], kp[0, 0, :, 2], kp[0, 0, :, 1]
    xs, ys, _ = proj3d.proj_transform(x, y, z, ax.M)
    d = ax.transData.transform(np.stack([xs, ys], -1))
    plt.close(fig)
    cmap = plt.get_cmap("tab20")
    for k in range(K):
        want = F.to_uint8(np.asarray(cmap(k)[:3], np.float32))
        c, r = d[k, 0], 192 - d[k, 1]
        win = img[int(r) - 1:int(r) + 2, int(c) - 1:int(c) + 2]
        assert (win == want).all(-1).any(), (k, win, want)
