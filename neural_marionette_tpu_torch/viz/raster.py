"""Small software rasterizer for the demo render sets, on the card.

Counterpart of ``neural_marionette_tpu/viz/raster.py`` (the reference
renders its demos with Open3D: surfel "plates" for generation,
vis_generation.py:27-44, 155-192; textured, smooth, skeleton and overlay
views for retargeting, vis_retarget.py:102-153, 399-557), with the same
names. Meshes and surfels become shaded sample points, projected through a
pinhole :class:`Camera` and splatted into the frame.

What runs where:

* on the device (``cuda`` unless the caller passes ``device="cpu"``):
  :meth:`Camera.project`, :func:`shade`, the surfel discs of
  :func:`render_surfels` and :func:`splat`'s selection per pixel, batched
  over every frame of a call (``*_frames``: the frame index is folded into
  the pixel index);
* on the host, by design: the draws of ``np.random.default_rng(0)`` in
  :func:`mesh_samples` and :func:`render_surfels`, so that the samples are
  the JAX package's; :func:`estimate_normals` (``np.argpartition``: on a
  voxel lattice distance ties are the rule, and another top-k would pick
  other neighbours and other normals); the painting order of
  :func:`splat` (see below); the primitive meshes and
  :func:`skeleton_geometry` (tiny).

The device arithmetic keeps the JAX function's float64/float32 steps.
NumPy's ``@`` on the CPU (OpenBLAS) fuses the 3-term dot products into
fused multiply-adds: the projection ``(pts - eye) @ R.T`` computes
``fma(d2, R2, fma(d1, R1, d0 * R0))`` and the shade's ``normals @ l``
``fma(n2, l2, fma(n0, l0, n1 * l1))``. The port computes those with an
exact FMA built from multiplications and additions (:func:`_fma`: Dekker's
product, then a sum rounded to odd), one elementwise operation a kernel,
so the CPU and the card give the same bits and both give NumPy's. Rounding
to pixels is half-to-even, as ``np.round``.

:func:`splat` computes the JAX function exactly, and that function is not a
true z-buffer across splat offsets: the offsets ``(du, dv)`` are painted
in loop order, and within one offset the samples in ``np.argsort(-z)``
order, the last write winning. So a pixel takes its colour from the last
offset that reaches it and, within that offset, from the sample of least
``z``. NumPy's sort is not stable, and its order among exactly equal
depths (frequent on a voxel lattice) follows no rule a device sort could
copy: that one sort, of the depths the device computed, runs on the host
per frame (:func:`_paint_order`); the selection per pixel is two
``scatter_reduce`` passes on the device.
"""
from __future__ import annotations

import json
import os
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..api import resolve_device


# ------------------------------------------------------- exact float64 FMA
def _split(a):
    """Veltkamp's split of a float64 into two 26-bit halves."""
    c = a * 134217729.0   # 2^27 + 1
    hi = c - (c - a)
    return hi, a - hi


def _fma(a, b, c):
    """``a * b + c`` rounded once (round to nearest even), from
    multiplications and additions only (Boldo and Melquiond's emulated
    FMA): the exact product ``uh + ul`` (Dekker), the exact sum ``th + tl``
    of ``c + uh``, ``v = tl + ul`` rounded to odd, then ``th + v``."""
    uh = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    ul = (((ah * bh - uh) + ah * bl) + al * bh) + al * bl
    th = c + uh
    bb = th - c
    tl = (c - (th - bb)) + (uh - bb)
    v = tl + ul
    bb = v - tl
    err = (tl - (v - bb)) + (ul - bb)
    even = (v.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.full_like(v, float("inf")),
                         torch.full_like(v, float("-inf")))
    v = torch.where((err != 0) & even, torch.nextafter(v, toward), v)
    return th + v


# ---------------------------------------------------------------- camera
class Camera(NamedTuple):
    eye: np.ndarray
    R: np.ndarray      # world -> camera rotation (rows = right, up, fwd)
    f: float           # focal length in pixels
    W: int
    H: int
    cx: Optional[float] = None   # principal point (defaults to W/2, H/2)
    cy: Optional[float] = None

    @classmethod
    def look_at(cls, eye, center=(0.0, 0.0, 0.0), up=(0.0, 1.0, 0.0),
                fov_deg: float = 60.0, W: int = 512, H: int = 512):
        eye = np.asarray(eye, np.float64)
        fwd = np.asarray(center, np.float64) - eye
        fwd /= np.linalg.norm(fwd) + 1e-12
        right = np.cross(fwd, np.asarray(up, np.float64))
        right /= np.linalg.norm(right) + 1e-12
        true_up = np.cross(right, fwd)
        R = np.stack([right, true_up, fwd])
        f = 0.5 * W / np.tan(np.deg2rad(fov_deg) / 2)
        return cls(eye=eye, R=R, f=f, W=W, H=H)

    @classmethod
    def from_o3d_json(cls, path: str):
        """Open3D ``PinholeCameraParameters`` JSON -> Camera (the camera of
        every reference demo, ``data/demo/source/source.json``). Open3D
        stores the 4x4 world->camera extrinsic column-major with camera
        axes (x right, y down, z forward); ours are (right, up, fwd), so
        the extrinsic's y row is negated and ``eye = -E[:3,:3]^T @ E[:3,3]``.
        """
        with open(path) as fh:
            d = json.load(fh)
        E = np.asarray(d["extrinsic"], np.float64).reshape(4, 4).T
        K = np.asarray(d["intrinsic"]["intrinsic_matrix"],
                       np.float64).reshape(3, 3).T
        Re, t = E[:3, :3], E[:3, 3]
        eye = -Re.T @ t
        R = np.stack([Re[0], -Re[1], Re[2]])
        return cls(eye=eye, R=R, f=float(K[0, 0]),
                   W=int(d["intrinsic"]["width"]),
                   H=int(d["intrinsic"]["height"]),
                   cx=float(K[0, 2]), cy=float(K[1, 2]))

    def project(self, pts: torch.Tensor):
        """(N, 3) float64 world points (a tensor) -> (u, v, depth) on their
        device; u/v in pixels, depth clamped at 1e-6."""
        cx = self.W / 2 if self.cx is None else self.cx
        cy = self.H / 2 if self.cy is None else self.cy
        eye = [float(e) for e in self.eye]
        R = [[float(r) for r in row] for row in self.R]
        d = [pts[:, i] - eye[i] for i in range(3)]
        p = [_fma(d[2], R[i][2], _fma(d[1], R[i][1], d[0] * R[i][0]))
             for i in range(3)]
        z = torch.clamp_min(p[2], 1e-6)
        f = float(self.f)
        u = cx + f * p[0] / z
        v = cy - f * p[1] / z
        return u, v, z


DEFAULT_CAM = dict(eye=(1.6, 1.2, 2.2), center=(0.0, 0.0, 0.0))

# the vendored copy of the reference's demo camera
REFERENCE_CAMERA_JSON = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "data", "demo", "source",
    "source.json")


def default_camera(json_path: Optional[str] = None) -> Camera:
    """The demos' view: the pinhole camera of ``json_path``, by default the
    vendored reference camera; the look_at fallback when the file is
    absent. (The JAX package also reads ``NM_CAMERA_JSON``; the port reads
    no environment variable.)"""
    path = json_path or REFERENCE_CAMERA_JSON
    if os.path.exists(path):
        return Camera.from_o3d_json(path)
    return Camera.look_at(**DEFAULT_CAM)


# ------------------------------------------------------------- splatting
def _as(x, device, dtype) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device, dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


def blank(cam: Camera, n_frames: int = 1, bg: float = 1.0,
          device=None) -> torch.Tensor:
    """(n_frames, H, W, 3) float32 frames of ``bg``."""
    return torch.full((n_frames, cam.H, cam.W, 3), bg, dtype=torch.float32,
                      device=resolve_device(device))


def _paint_order(z: torch.Tensor, frame: torch.Tensor) -> torch.Tensor:
    """Each sample's position in its frame's ``np.argsort(-z)``, the JAX
    function's painting order, exact ties included (NumPy's default sort
    is not stable, so no rule on the device reproduces its order among
    equal depths; the sort runs on the host, one frame at a time)."""
    zh = z.cpu().numpy()
    fh = frame.cpu().numpy()
    by_frame = np.argsort(fh, kind="stable")
    counts = np.bincount(fh) if len(fh) else np.zeros(0, np.int64)
    pos = np.empty(len(zh), np.int64)
    for sel in np.split(by_frame, np.cumsum(counts)[:-1]):
        pos[sel[np.argsort(-zh[sel])]] = np.arange(len(sel))
    return torch.as_tensor(pos, device=z.device)


def splat_frames(cam: Camera, pts, colors, frame, imgs: torch.Tensor,
                 px: int = 1) -> torch.Tensor:
    """:func:`splat` of samples of several frames in one pass: ``pts``
    (M, 3) float64 and ``colors`` (M, 3) float32 tensors on ``imgs``'s
    device, ``frame`` (M,) the frame of each sample into ``imgs``
    (F, H, W, 3) float32. Returns the painted frames (a new tensor)."""
    F, H, W = imgs.shape[:3]
    out = imgs.reshape(-1, 3).clone()
    if len(pts) == 0:
        return out.reshape(imgs.shape)
    dev = imgs.device
    frame = frame.to(dev)
    u, v, z = cam.project(pts)
    ui = torch.round(u).to(torch.int64)
    vi = torch.round(v).to(torch.int64)
    offs = torch.tensor([(du, dv) for du in range(-px + 1, px)
                         for dv in range(-px + 1, px)], device=dev)
    uu = ui[None, :] + offs[:, :1]
    vv = vi[None, :] + offs[:, 1:]
    ok = (uu >= 0) & (uu < W) & (vv >= 0) & (vv < H)
    pix = ((frame[None, :] * H + vv) * W + uu)[ok]
    rank = torch.arange(len(offs), device=dev)[:, None].expand_as(ok)[ok]
    sample = torch.arange(len(pts), device=dev)[None, :].expand_as(ok)[ok]
    n_pix = F * H * W
    # (a) the last offset that reaches each pixel
    last = torch.full((n_pix,), -1, dtype=torch.int64, device=dev)
    last = last.scatter_reduce(0, pix, rank, "amax")
    keep = rank == last[pix]
    pix, sample = pix[keep], sample[keep]
    # (b) within it the sample painted last: the nearest, exact ties in
    # NumPy's order
    pos = _paint_order(z, frame)[sample]
    top = torch.full((n_pix,), -1, dtype=torch.int64, device=dev)
    top = top.scatter_reduce(0, pix, pos, "amax")
    win = torch.full((n_pix,), -1, dtype=torch.int64, device=dev)
    win = win.scatter_reduce(0, pix, torch.where(pos == top[pix], sample, -1),
                             "amax")
    hit = win >= 0
    out[hit] = colors[win[hit]]
    return out.reshape(imgs.shape)


def _frames_in(cam: Camera, img, device, bg: float = 1.0) -> torch.Tensor:
    """``img`` (H, W, 3) as a batch of one float32 frame on ``device``
    (``img``'s own when it is a tensor and no device is named), or a frame
    of ``bg``."""
    if img is None:
        return blank(cam, 1, bg, device)
    dev = img.device if isinstance(img, torch.Tensor) and device is None \
        else resolve_device(device)
    return _as(img, dev, torch.float32)[None]


def splat(cam: Camera, pts, colors, img=None, px: int = 1, bg: float = 1.0,
          device=None) -> torch.Tensor:
    """Depth-sorted point splat (see the module docstring): ``pts`` (N, 3),
    ``colors`` (N, 3) in [0, 1] (cast to float32); ``px`` the splat
    half-extent in pixels. ``img`` (H, W, 3) keeps every pixel nothing
    reaches. Returns the (H, W, 3) float32 frame on ``device`` (``img``'s
    when it is a tensor)."""
    imgs = _frames_in(cam, img, device, bg)
    dev = imgs.device
    p = _as(pts, dev, torch.float64).reshape(-1, 3)
    c = _as(colors, dev, torch.float32).reshape(-1, 3)
    frame = torch.zeros(len(p), dtype=torch.int64, device=dev)
    return splat_frames(cam, p, c, frame, imgs, px)[0]


def shade(colors, normals, light_dir, ambient: float = 0.35) -> torch.Tensor:
    """Two-sided Lambertian shade, ``colors * (ambient + (1 - ambient) *
    |n . l|)`` clipped to [0, 1], float64 (NumPy's promotion of float32
    colours by float64 normals); tensors on one device."""
    l = np.asarray(light_dir, np.float64)
    l = l / (np.linalg.norm(l) + 1e-12)
    n = normals
    lam = torch.abs(_fma(n[:, 2], float(l[2]),
                         _fma(n[:, 0], float(l[0]), n[:, 1] * float(l[1]))))
    return torch.clamp(colors * (ambient + (1 - ambient) * lam[:, None]),
                       0, 1)


# ------------------------------------------------------- normal estimation
def estimate_normals(points: np.ndarray, k: int = 8,
                     chunk: int = 1024) -> np.ndarray:
    """k-NN PCA normals (the open3d estimate_normals analogue),
    consistently oriented away from the centroid. Host numpy, a copy of
    the JAX function: the k nearest come from ``np.argpartition``, whose
    choice among equally distant points (the rule on a voxel lattice)
    decides the normals."""
    pts = np.asarray(points, np.float64)
    N = len(pts)
    k = min(k, N - 1) if N > 1 else 0
    normals = np.zeros_like(pts)
    if k < 2:
        normals[:, 2] = 1.0
        return normals
    for s in range(0, N, chunk):
        blk = pts[s:s + chunk]
        d = ((blk[:, None] - pts[None]) ** 2).sum(-1)  # (c, N)
        idx = np.argpartition(d, k, axis=1)[:, :k + 1]
        nb = pts[idx]                                   # (c, k+1, 3)
        nb = nb - nb.mean(axis=1, keepdims=True)
        cov = np.einsum("cki,ckj->cij", nb, nb)
        _, vec = np.linalg.eigh(cov)
        normals[s:s + chunk] = vec[:, :, 0]             # smallest eigval
    out = pts - pts.mean(0)
    flip = (normals * out).sum(-1) < 0
    normals[flip] *= -1
    return normals


# ------------------------------------------------------------- primitives
def _align_z(direction: np.ndarray) -> np.ndarray:
    """Rotation taking +z to ``direction`` (reference drawPlate/drawCone
    Rodrigues construction, vis_generation.py:30-38)."""
    line2 = direction / (np.linalg.norm(direction) + 1e-6)
    line1 = np.array([0.0, 0.0, 1.0])
    v = np.cross(line1, line2)
    c = float(np.dot(line1, line2)) + 1e-8
    if abs(c + 1.0) < 1e-4:
        return np.array([[-1.0, 0, 0], [0, 1.0, 0], [0, 0, -1.0]])
    k = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
    return np.eye(3) + k + k @ k / (1 + c)


def sphere_mesh(radius: float, res: int = 12):
    th = np.linspace(0, np.pi, res)
    ph = np.linspace(0, 2 * np.pi, 2 * res, endpoint=False)
    T, P = np.meshgrid(th, ph, indexing="ij")
    verts = radius * np.stack([np.sin(T) * np.cos(P), np.sin(T) * np.sin(P),
                               np.cos(T)], -1).reshape(-1, 3)
    faces = []
    for i in range(res - 1):
        for j in range(2 * res):
            a = i * 2 * res + j
            b = i * 2 * res + (j + 1) % (2 * res)
            faces.append([a, b, a + 2 * res])
            faces.append([b, b + 2 * res, a + 2 * res])
    return verts, np.asarray(faces, np.int64)


def cone_mesh(radius: float, height: float, res: int = 24):
    ph = np.linspace(0, 2 * np.pi, res, endpoint=False)
    base = np.stack([radius * np.cos(ph), radius * np.sin(ph),
                     np.zeros(res)], -1)
    verts = np.concatenate([base, [[0, 0, height]], [[0, 0, 0]]])
    apex, center = res, res + 1
    faces = []
    for j in range(res):
        faces.append([j, (j + 1) % res, apex])
        faces.append([(j + 1) % res, j, center])
    return verts, np.asarray(faces, np.int64)


def cylinder_mesh(radius: float, height: float, res: int = 16):
    ph = np.linspace(0, 2 * np.pi, res, endpoint=False)
    ring = np.stack([radius * np.cos(ph), radius * np.sin(ph)], -1)
    bot = np.concatenate([ring, np.full((res, 1), -height / 2)], -1)
    top = np.concatenate([ring, np.full((res, 1), height / 2)], -1)
    verts = np.concatenate([bot, top, [[0, 0, -height / 2]],
                            [[0, 0, height / 2]]])
    cb, ct = 2 * res, 2 * res + 1
    faces = []
    for j in range(res):
        jn = (j + 1) % res
        faces.append([j, jn, res + j])
        faces.append([jn, res + jn, res + j])
        faces.append([jn, j, cb])
        faces.append([res + j, res + jn, ct])
    return verts, np.asarray(faces, np.int64)


def transform(verts: np.ndarray, R=None, t=None):
    out = verts
    if R is not None:
        out = out @ np.asarray(R).T
    if t is not None:
        out = out + np.asarray(t)
    return out


# -------------------------------------------------------- mesh -> samples
def mesh_samples(verts: np.ndarray, faces: np.ndarray, cam: Camera,
                 density: float = 2.0, max_samples: int = 1_500_000):
    """Barycentric samples + per-sample face normals; sample count scales
    with projected pixel area so coverage has no holes. Host numpy, a copy
    of the JAX function (its ``default_rng(0)`` draws and its counts)."""
    verts = np.asarray(verts, np.float64)
    v0, v1, v2 = (verts[faces[:, i]] for i in range(3))
    fn = np.cross(v1 - v0, v2 - v0)
    area_w = 0.5 * np.linalg.norm(fn, axis=-1)
    fn = fn / (np.linalg.norm(fn, axis=-1, keepdims=True) + 1e-12)
    # projected scale ~ f / depth (the host projection of the JAX package)
    z0 = np.maximum(((v0 - cam.eye) @ cam.R.T)[:, 2], 1e-6)
    px_scale = (cam.f / z0) ** 2
    n_samp = np.minimum(np.ceil(area_w * px_scale * density) + 1,
                        4096).astype(np.int64)
    total = int(n_samp.sum())
    if total > max_samples:
        n_samp = np.maximum((n_samp * (max_samples / total)).astype(np.int64),
                            1)
        total = int(n_samp.sum())
    fid = np.repeat(np.arange(len(faces)), n_samp)
    rng = np.random.default_rng(0)
    r1 = np.sqrt(rng.uniform(size=total))
    r2 = rng.uniform(size=total)
    a, b = 1 - r1, r1 * (1 - r2)
    c = 1 - a - b
    pts = (a[:, None] * v0[fid] + b[:, None] * v1[fid] + c[:, None] * v2[fid])
    bary = np.stack([a, b, c], -1)
    return pts, fn[fid], fid, bary


def _mesh_colors(faces, fid, bary, color=None, vert_colors=None):
    """Per-sample colours: barycentric blends of ``vert_colors`` (float64,
    as NumPy promotes them), else the uniform float32 ``color``."""
    if vert_colors is not None:
        vc = np.asarray(vert_colors, np.float32)
        return (bary[:, :, None] * vc[faces[fid]]).sum(1)
    return np.broadcast_to(np.asarray(color, np.float32), (len(fid), 3))


def mesh_batch(cam: Camera, meshes: Sequence, density: float = 2.0):
    """The host half of :func:`render_mesh_frames`: the samples of one
    mesh per frame (``meshes[i]`` = dict(verts, faces, color or
    vert_colors)), each drawn from ``default_rng(0)`` as one
    ``render_mesh`` call draws them. Returns numpy (points, normals,
    colours, frame) of all samples, float64 but the frame index."""
    pts, nrm, cols, frame = [], [], [], []
    for i, m in enumerate(meshes):
        p, n, fid, bary = mesh_samples(m["verts"], m["faces"], cam, density)
        pts.append(p)
        nrm.append(n)
        # float32 colours are exact in float64, where NumPy shades them
        cols.append(_mesh_colors(m["faces"], fid, bary, m.get("color"),
                                 m.get("vert_colors")).astype(np.float64))
        frame.append(np.full(len(p), i, np.int64))
    return (np.concatenate(pts), np.concatenate(nrm), np.concatenate(cols),
            np.concatenate(frame))


def shade_splat(cam: Camera, pts, normals, colors, frame,
                imgs: torch.Tensor, light=(0.3, 0.5, -1.0),
                px: int = 1) -> torch.Tensor:
    """The device half of :func:`render_mesh_frames`: shade the samples of
    :func:`mesh_batch` and splat them into ``imgs`` (F, H, W, 3)."""
    dev = imgs.device
    shaded = shade(_as(colors, dev, torch.float64),
                   _as(normals, dev, torch.float64), light)
    return splat_frames(cam, _as(pts, dev, torch.float64),
                        shaded.to(torch.float32),
                        _as(frame, dev, torch.int64), imgs, px)


def render_mesh_frames(cam: Camera, meshes: Sequence, imgs: torch.Tensor,
                       light=(0.3, 0.5, -1.0), density: float = 2.0,
                       px: int = 1) -> torch.Tensor:
    """:func:`render_mesh` of one mesh per frame of ``imgs`` (F, H, W, 3)
    in one device pass (:func:`mesh_batch`, then :func:`shade_splat`)."""
    return shade_splat(cam, *mesh_batch(cam, meshes, density), imgs, light,
                       px)


def render_mesh(cam: Camera, verts, faces, color=None, vert_colors=None,
                img=None, light=(0.3, 0.5, -1.0), density: float = 2.0,
                px: int = 1, device=None) -> torch.Tensor:
    """Smooth/flat-shaded mesh render.  ``vert_colors`` (V, 3) gives
    per-vertex (e.g. texture-sampled) colors; else uniform ``color``.
    Returns the (H, W, 3) float32 frame on ``device``."""
    imgs = _frames_in(cam, img, device)
    return render_mesh_frames(
        cam, [dict(verts=verts, faces=faces, color=color,
                   vert_colors=vert_colors)], imgs, light, density, px)[0]


def _disc(radius: float, n_disc: int) -> np.ndarray:
    """The ``n_disc`` disc offsets of a surfel, from ``default_rng(0)``."""
    rng = np.random.default_rng(0)
    r = radius * np.sqrt(rng.uniform(size=n_disc))
    th = rng.uniform(0, 2 * np.pi, size=n_disc)
    return np.stack([r * np.cos(th), r * np.sin(th), np.zeros(n_disc)], -1)


def _norm3(x: torch.Tensor) -> torch.Tensor:
    """``np.linalg.norm(x, axis=-1, keepdims=True)`` for 3-vectors."""
    return torch.sqrt((x[:, 0] * x[:, 0] + x[:, 1] * x[:, 1])
                      + x[:, 2] * x[:, 2])[:, None]


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``np.cross`` of (N, 3) rows (products, then one subtraction)."""
    return torch.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                        a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                        a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], -1)


def render_surfels_frames(cam: Camera, points, normals, colors, frame,
                          imgs: torch.Tensor, radius: float = 0.03,
                          n_disc: int = 24, light=(0.3, 0.5, -1.0),
                          px: int = 2) -> torch.Tensor:
    """:func:`render_surfels` of the points of several frames in one pass:
    ``points``, ``normals`` (N, 3) float64, ``colors`` (N, 3) and ``frame``
    (N,) tensors on ``imgs``'s device; the colours are cast to float32."""
    dev = imgs.device
    disc = torch.as_tensor(_disc(radius, n_disc), device=dev)
    n = normals / (_norm3(normals) + 1e-12)
    helper = torch.where(torch.abs(n[:, 2:3]) < 0.9,
                         torch.tensor([0.0, 0.0, 1.0], device=dev,
                                      dtype=torch.float64),
                         torch.tensor([1.0, 0.0, 0.0], device=dev,
                                      dtype=torch.float64))
    t1 = _cross(n, helper)
    t1 = t1 / (_norm3(t1) + 1e-12)
    t2 = _cross(n, t1)
    # np.einsum("nij,dj->ndi", frame, disc): products summed in j order
    axes = (t1, t2, n)
    off = ((axes[0][:, None, :] * disc[None, :, 0, None]
            + axes[1][:, None, :] * disc[None, :, 1, None])
           + axes[2][:, None, :] * disc[None, :, 2, None])
    pts = points[:, None] + off
    cols = shade(colors.to(torch.float32), n, light).repeat_interleave(n_disc, dim=0)
    return splat_frames(cam, pts.reshape(-1, 3), cols.to(torch.float32),
                        frame.repeat_interleave(n_disc), imgs, px)


def render_surfels(cam: Camera, points, normals, colors, radius=0.03,
                   img=None, n_disc: int = 24, light=(0.3, 0.5, -1.0),
                   px: int = 2, device=None) -> torch.Tensor:
    """Oriented disc "plates" per point (reference drawPlate,
    vis_generation.py:27-44). ``colors`` are cast to float32 and shaded
    in float64, as NumPy promotes them. Returns the (H, W, 3)
    float32 frame on ``device``."""
    imgs = _frames_in(cam, img, device)
    dev = imgs.device
    p = _as(points, dev, torch.float64)
    c = colors if isinstance(colors, torch.Tensor) else \
        torch.as_tensor(np.asarray(colors))
    return render_surfels_frames(
        cam, p, _as(normals, dev, torch.float64), c.to(dev),
        torch.zeros(len(p), dtype=torch.int64, device=dev), imgs, radius,
        n_disc, light, px)[0]


def skeleton_geometry(kypts: np.ndarray, parents: np.ndarray,
                      valid: Optional[np.ndarray] = None,
                      joint_colors: Optional[np.ndarray] = None,
                      bone_color=(0.0, 0.6, 0.1), sphere_radius=0.03):
    """Spheres at joints + cones along bones (reference drawSphere /
    drawCone1/2, vis_retarget.py:102-153).  Returns (verts, faces,
    vert_colors), host numpy."""
    K = len(kypts)
    if valid is None:
        valid = np.ones(K, bool)
    if joint_colors is None:
        joint_colors = _spaced_colors(K)
    av, af, ac = [], [], []
    off = 0

    def add(verts, faces, color):
        nonlocal off
        av.append(verts)
        af.append(faces + off)
        ac.append(np.broadcast_to(np.asarray(color, np.float32),
                                  verts.shape))
        off += len(verts)

    sv, sf = sphere_mesh(sphere_radius)
    for k in range(K):
        if not valid[k]:
            continue
        add(transform(sv, t=kypts[k]), sf, joint_colors[k])
        p = int(parents[k])
        if p == k or not valid[p]:
            continue
        seg = kypts[k] - kypts[p]
        length = float(np.linalg.norm(seg))
        if length < 1e-6:
            continue
        R = _align_z(seg)
        # drawCone1: base at parent + 20% margin, height 80% of the bone
        cv, cf = cone_mesh(0.03, length * 0.8 + 1e-6)
        add(transform(cv, R=R, t=kypts[p] + 0.2 * seg), cf, bone_color)
        # drawCone2: small reversed cone at the parent end
        cv2_, cf2 = cone_mesh(0.03, length * 0.2 + 1e-6)
        cv2_ = transform(cv2_, R=np.diag([1.0, -1.0, -1.0]))  # rotate pi
        add(transform(cv2_, R=R, t=kypts[p] + 0.195 * seg), cf2, bone_color)
    if not av:
        return (np.zeros((0, 3)), np.zeros((0, 3), np.int64),
                np.zeros((0, 3), np.float32))
    return np.concatenate(av), np.concatenate(af), np.concatenate(ac)


def _spaced_colors(K: int) -> np.ndarray:
    h = (np.arange(K) * 0.61803398875) % 1.0
    c = np.stack([np.abs(h * 6 - 3) - 1, 2 - np.abs(h * 6 - 2),
                  2 - np.abs(h * 6 - 4)], -1)
    return np.clip(c, 0.15, 1.0)
