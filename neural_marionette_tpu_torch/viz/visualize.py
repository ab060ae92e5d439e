"""GIF videos of voxels, keypoints and their graph, drawn on the card.

Counterpart of ``neural_marionette_tpu/viz/visualize.py`` (reference
``vis/visualize.py``: ``vis_keypoints`` :15-108, ``vis_recon`` :112-172),
without matplotlib. The JAX package draws one matplotlib 3D figure per
frame; the port draws the same geometry for every frame of a call in one
batched pass on the device (``cuda`` unless the caller passes
``device="cpu"``): occupied voxels in gray, light blue or green, keypoints
in the tab20 colours with their intensity as alpha, the affinity's top-2
directed arrows or the adjacency's undirected lines, on white with the axes
off. Shapes and file names are the JAX functions': ``(n, T, 192, 192, 3)``
and ``(n, T, 192, 384, 3)`` uint8 at ``figsize=3``, ``dpi=64``, and
``gifs/<epoch>/<group>_<name>_<i>.gif`` (150 ms a frame).

The view is matplotlib's default 3D view, written out from
``mpl_toolkits/mplot3d`` (``Axes3D.get_proj``, ``set_top_view``,
``apply_aspect``, ``proj3d``): elevation 30, azimuth -60, camera distance
10, focal length 1, axes limits [-1, 1], box aspect 4:4:3 scaled by
1.8294640721620434 * 25/24 / |(4, 4, 3)|, 2D view limits
[-0.95/10, 0.9/10] on both axes, and the subplot's box (left 0.125, right
0.9, bottom 0.11, top 0.88, wspace 0.2) shrunk to a square and centred.
The data axes are the JAX calls' swap, ``(x, z, y)``.

What is drawn, in matplotlib's order:

* marker diameters ``sqrt(s)`` points (``s=2`` voxels without an edge;
  ``s=40`` keypoints, whose edge of 1.5 points in the face colour is drawn
  over the face), 64/72 pixels a point; a marker smaller than a pixel still
  marks the pixel it falls in;
* every scatter call passes an explicit alpha, which replaces mplot3d's
  depth shade (``to_rgba_array(colors, alpha)``), so there is none;
* ``Axes3D.draw`` sorts the collections (the voxel scatter, one scatter a
  keypoint) by their nearest projected depth, farthest first, and the
  patches (the arrows) the same way, and numbers each list from one offset:
  the i-th collection and the i-th patch share a z-order and draw in that
  order; the lines (``ax.plot``, z-order 2) draw before both; the markers
  of one scatter draw farthest first (one colour and one alpha, so their
  order does not change a pixel; the port draws them in index order);
* arrows ``-|>`` with ``mutation_scale=10``: shrunk by 2 points at each
  end, a head 4 points long and 2 points wide each side, 1.7 points wide;
  lines 2.5 points wide with projecting caps;
* each primitive composites over the frame with its alpha
  (``c * a + dst * (1 - a)``, float32); every pixel whose centre it
  covers, clipped to the axes box.

Matplotlib's anti-aliased edges are not reproduced; its geometry is.
"""
from __future__ import annotations

import math
import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..api import resolve_device
from .image_files import to_uint8, write_gif

DPI = 64
PX_PER_PT = DPI / 72.0
ELEV, AZIM, DIST = 30.0, -60.0, 10.0
SUBPLOT = dict(left=0.125, right=0.9, bottom=0.11, top=0.88, wspace=0.2)
GIF_DELAY_S = 0.15   # the JAX call's duration=0.15

# matplotlib's named colours and the tab20 colormap's 20 entries
GRAY = (0x80 / 255, 0x80 / 255, 0x80 / 255)
LIGHTBLUE = (0xAD / 255, 0xD8 / 255, 0xE6 / 255)
GREEN = (0.0, 0x80 / 255, 0.0)         # "green"
ARROW_GREEN = (0.0, 0.5, 0.0)          # "g"
TAB20 = tuple(tuple(int(h[i:i + 2], 16) / 255 for i in (0, 2, 4)) for h in (
    "1f77b4", "aec7e8", "ff7f0e", "ffbb78", "2ca02c", "98df8a", "d62728",
    "ff9896", "9467bd", "c5b0d5", "8c564b", "c49c94", "e377c2", "f7b6d2",
    "7f7f7f", "c7c7c7", "bcbd22", "dbdb8d", "17becf", "9edae5"))

VOX_S, KP_S, KP_EDGE_PT = 2.0, 40.0, 1.5
ARROW_LW_PT, LINE_LW_PT = 1.7, 2.5
ARROW_SHRINK_PT, HEAD_LEN_PT, HEAD_HALF_PT = 2.0, 4.0, 2.0
NNEIGHBOR = 2
_SUB_BITS = 20   # order of a fragment: (draw rank << 20) | index inside


# ------------------------------------------------------------------ view
class View(NamedTuple):
    """One 3D axes of a figure: the projection matrix ``M`` (data ->
    normalised view), its 2D view limits, the axes box in display pixels
    (x0, y0, w, h; y up) and the canvas size."""
    M: np.ndarray
    lim: tuple
    box: tuple
    W: int
    H: int


def view(figsize: int = 3, npanels: int = 1, panel: int = 0) -> View:
    """matplotlib's default view of subplot ``panel`` of ``1 x npanels``
    3D subplots in a ``(figsize * npanels, figsize)`` inch figure at
    ``DPI`` (see the module docstring)."""
    aspect = np.array([4.0, 4.0, 3.0])
    aspect = aspect * 1.8294640721620434 * 25 / 24 / np.linalg.norm(aspect)
    # world_transformation of the limits [-1, 1] into [0, aspect]
    d = 2.0 / aspect
    world = np.array([[1 / d[0], 0, 0, 1 / d[0]],
                      [0, 1 / d[1], 0, 1 / d[1]],
                      [0, 0, 1 / d[2], 1 / d[2]],
                      [0, 0, 0, 1.0]])
    center = 0.5 * aspect
    e, a = np.deg2rad(ELEV), np.deg2rad(AZIM)
    ps = np.array([np.cos(e) * np.cos(a), np.cos(e) * np.sin(a), np.sin(e)])
    eye = center + DIST * ps
    w = (eye - center) / np.linalg.norm(eye - center)
    u = np.cross([0.0, 0.0, 1.0], w)
    u = u / np.linalg.norm(u)
    v = np.cross(w, u)
    rot, shift = np.eye(4), np.eye(4)
    rot[:3, :3] = [u, v, w]
    shift[:3, 3] = -eye          # focal length 1: the eye itself
    # perspective with zfront -DIST, zback DIST, focal length 1
    persp = np.array([[1.0, 0, 0, 0], [0, 1.0, 0, 0],
                      [0, 0, 0, -DIST], [0, 0, -1.0, 0]])
    M = persp @ (rot @ shift @ world)
    W, H = figsize * npanels * DPI, figsize * DPI
    sp = SUBPLOT
    cell = (sp["right"] - sp["left"]) / (npanels + sp["wspace"] * (npanels - 1))
    x0 = sp["left"] + panel * cell * (1 + sp["wspace"])
    bw, bh = cell, sp["top"] - sp["bottom"]
    # apply_aspect: shrink to a square on the canvas, anchored at the centre
    sh = bw * W / H
    sw = bw if sh <= bh else bh * H / W
    sh = min(sh, bh)
    box = ((x0 + (bw - sw) / 2) * W, (sp["bottom"] + (bh - sh) / 2) * H,
           sw * W, sh * H)
    return View(M, (-0.95 / DIST, 0.9 / DIST), box, W, H)


def project(vw: View, pts: torch.Tensor):
    """(N, 3) float64 data points -> (col, row) canvas pixels (row down,
    pixel centres at .5), the projected depth (larger is farther) and
    whether mplot3d's clip keeps the point (normalised x, y in [-1, 1],
    depth <= 0)."""
    M = [[float(m) for m in row] for row in vw.M]
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    h = [((x * M[r][0] + y * M[r][1]) + z * M[r][2]) + M[r][3]
         for r in range(4)]
    xs, ys, zs = h[0] / h[3], h[1] / h[3], h[2] / h[3]
    lo, hi = vw.lim
    bx, by, bw, bh = vw.box
    col = bx + (xs - lo) / (hi - lo) * bw
    row = vw.H - (by + (ys - lo) / (hi - lo) * bh)
    keep = (xs >= -1) & (xs <= 1) & (ys >= -1) & (ys <= 1) & (zs <= 0)
    return col, row, zs, keep


# -------------------------------------------------------- rasterisation
class _Frags:
    """Fragments of a call's primitives: global pixel, order, colour,
    alpha."""

    def __init__(self, vw: View, device):
        self.dev = device
        self.parts = []
        self.use(vw)

    def use(self, vw: View) -> None:
        """Draw the next primitives into the axes of ``vw`` (one canvas
        size for all): pixel centres outside its box are clipped."""
        self.vw = vw
        bx, by, bw, bh = vw.box
        self.clip = (bx, vw.H - by - bh, bx + bw, vw.H - by)

    def _add(self, prim, frame, col, row, order, rgb, alpha):
        c0, r0, c1, r1 = self.clip
        ok = ((col + 0.5 >= c0) & (col + 0.5 <= c1) & (row + 0.5 >= r0)
              & (row + 0.5 <= r1))
        prim, col, row = prim[ok], col[ok], row[ok]
        pix = (frame[prim] * self.vw.H + row) * self.vw.W + col
        self.parts.append((pix, order[prim], rgb[prim], alpha[prim]))

    def discs(self, frame, cx, cy, r_out, r_in, order, rgb, alpha):
        """Discs (``r_in`` None) or rings ``r_in <= d <= r_out`` of pixel
        radius; a disc also marks the pixel its centre falls in."""
        if len(cx) == 0:
            return
        R = int(math.ceil(r_out)) + 1
        d = torch.arange(-R, R + 1, device=self.dev)
        fc, fr = torch.floor(cx), torch.floor(cy)
        col = fc[:, None, None] + d[None, :, None]
        row = fr[:, None, None] + d[None, None, :]
        dist2 = (col + 0.5 - cx[:, None, None]) ** 2 + \
            (row + 0.5 - cy[:, None, None]) ** 2
        cov = dist2 <= r_out * r_out
        if r_in is None:
            cov |= (d[None, :, None] == 0) & (d[None, None, :] == 0)
        else:
            cov &= dist2 >= r_in * r_in
        prim, i, j = torch.nonzero(cov, as_tuple=True)
        self._add(prim, frame, (fc[prim] + d[i]).long(),
                  (fr[prim] + d[j]).long(), order, rgb, alpha)

    def segments(self, frame, x0, y0, x1, y1, hw, ext, order, rgb, alpha):
        """Thick segments: pixel centres within ``hw`` of the segment
        extended by ``ext`` at both ends; candidates stepped along each
        segment's major axis."""
        if len(x0) == 0:
            return
        dx, dy = x1 - x0, y1 - y0
        length = torch.sqrt(dx * dx + dy * dy)
        tx = torch.where(length > 0, dx / length, torch.ones_like(dx))
        ty = torch.where(length > 0, dy / length, torch.zeros_like(dy))
        horiz = torch.abs(dx) >= torch.abs(dy)
        # major / minor coordinates of the endpoints
        a0 = torch.where(horiz, x0, y0)
        a1 = torch.where(horiz, x1, y1)
        b0 = torch.where(horiz, y0, x0)
        da, db = a1 - a0, torch.where(horiz, dy, dx)
        slope = torch.where(da != 0, db / torch.where(da != 0, da, 1.0),
                            torch.zeros_like(da))
        pad = ext + hw + 1.0
        lo = torch.floor(torch.minimum(a0, a1) - pad)
        n_major = (torch.floor(torch.maximum(a0, a1) + pad) - lo + 1).long()
        B = int(math.ceil(hw * math.sqrt(2.0))) + 2
        steps = torch.arange(int(n_major.max()), device=self.dev)
        band = torch.arange(-B, B + 1, device=self.dev)
        m = lo[:, None] + steps[None, :]                     # (n, L)
        bc = b0[:, None] + (m + 0.5 - a0[:, None]) * slope[:, None]
        minor = torch.floor(bc)[:, :, None] + band[None, None, :]
        major = m[:, :, None].expand_as(minor)
        col = torch.where(horiz[:, None, None], major, minor)
        row = torch.where(horiz[:, None, None], minor, major)
        qx = col + 0.5 - x0[:, None, None]
        qy = row + 0.5 - y0[:, None, None]
        s = qx * tx[:, None, None] + qy * ty[:, None, None]
        nrm = torch.abs(qy * tx[:, None, None] - qx * ty[:, None, None])
        cov = ((steps[None, :, None] < n_major[:, None, None])
               & (s >= -ext) & (s <= length[:, None, None] + ext)
               & (nrm <= hw))
        prim, i, j = torch.nonzero(cov, as_tuple=True)
        self._add(prim, frame, col[prim, i, j].long(),
                  row[prim, i, j].long(), order, rgb, alpha)

    def triangles(self, frame, tri, grow, order, rgb, alpha):
        """Filled triangles ``tri`` (n, 3, 2) grown by ``grow`` pixels (a
        stroke of width ``2 * grow`` with mitred corners)."""
        if len(tri) == 0:
            return
        ext = (tri.amax(1) - tri.amin(1)).amax() + 2 * grow
        S = int(math.ceil(float(ext))) + 2
        d = torch.arange(-S, S + 1, device=self.dev)
        c = tri.mean(1)
        fc, fr = torch.floor(c[:, 0]), torch.floor(c[:, 1])
        col = fc[:, None, None] + d[None, :, None]
        row = fr[:, None, None] + d[None, None, :]
        px, py = col + 0.5, row + 0.5
        # orientation of each triangle, so that inside is positive
        e1, e2 = tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]
        sign = torch.sign(e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0])
        cov = torch.ones(len(tri), len(d), len(d), dtype=torch.bool,
                         device=self.dev)
        for k in range(3):
            a, b = tri[:, k], tri[:, (k + 1) % 3]
            ex, ey = b[:, 0] - a[:, 0], b[:, 1] - a[:, 1]
            le = torch.sqrt(ex * ex + ey * ey).clamp_min(1e-12)
            dist = ((px - a[:, 0, None, None]) * ey[:, None, None]
                    - (py - a[:, 1, None, None]) * ex[:, None, None]) \
                / le[:, None, None]
            cov &= -sign[:, None, None] * dist >= -grow
        prim, i, j = torch.nonzero(cov, as_tuple=True)
        self._add(prim, frame, (fc[prim] + d[i]).long(),
                  (fr[prim] + d[j]).long(), order, rgb, alpha)

    def composite(self, n_frames: int) -> torch.Tensor:
        """Alpha-over every fragment in its order onto white frames;
        returns (n_frames, H, W, 3) float32."""
        vw = self.vw
        img = torch.ones(n_frames * vw.H * vw.W, 3, device=self.dev)
        if not self.parts:
            return img.reshape(n_frames, vw.H, vw.W, 3)
        pix, order, rgb, alpha = (torch.cat(p) for p in zip(*self.parts))
        key = pix * (1 << 30) + order
        key, perm = torch.sort(key)
        pix, rgb, alpha = pix[perm], rgb[perm], alpha[perm]
        idx = torch.arange(len(pix), device=self.dev)
        start = torch.ones_like(pix, dtype=torch.bool)
        start[1:] = pix[1:] != pix[:-1]
        first = torch.cummax(torch.where(start, idx, 0), 0).values
        layer = idx - first
        by_layer = torch.argsort(layer, stable=True)
        counts = torch.bincount(layer).tolist()
        for sel in torch.split(by_layer, counts):
            p = pix[sel]
            a = alpha[sel][:, None]
            img[p] = rgb[sel] * a + img[p] * (1 - a)
        return img.reshape(n_frames, vw.H, vw.W, 3)


def _order(rank: torch.Tensor, sub) -> torch.Tensor:
    return rank * (1 << _SUB_BITS) + sub


def _rgb(colors, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(colors, np.float32), device=device)


def _voxel_points(occ: torch.Tensor):
    """(F, G, G, G) occupancy -> the frame of each nonzero voxel, its
    index inside its frame and its data point ``(x, z, y)`` in [-1, 1]."""
    G = occ.shape[-1]
    f, x, y, z = torch.nonzero(occ != 0, as_tuple=True)
    c = torch.stack([x, z, y], -1).double() / max(G - 1, 1) * 2 - 1
    counts = torch.bincount(f, minlength=occ.shape[0])
    starts = torch.cumsum(counts, 0) - counts
    within = torch.arange(len(f), device=occ.device) - starts[f]
    return f, within, c


class _VoxelScatter(NamedTuple):
    """One voxel scatter a frame, projected: per dot its frame, index
    inside the frame and pixel position; per frame the scatter's sort key
    (nearest projected depth, NaN when empty)."""
    frame: torch.Tensor
    within: torch.Tensor
    col: torch.Tensor
    row: torch.Tensor
    key: torch.Tensor

    @classmethod
    def of(cls, vw: View, occ: torch.Tensor) -> "_VoxelScatter":
        f, within, pts = _voxel_points(occ)
        col, row, zs, keep = project(vw, pts)
        key = torch.full((occ.shape[0],), float("inf"), dtype=torch.float64,
                         device=occ.device)
        key = key.scatter_reduce(0, f[keep], zs[keep], "amin")
        key = torch.where(torch.isinf(key), float("nan"), key)
        return cls(f[keep], within[keep], col[keep], row[keep], key)

    def draw(self, fr: _Frags, colors, rank) -> None:
        """``s=2`` dots without an edge, alpha 0.2: ``colors`` (F, 3) and
        ``rank`` (F,) the scatter's draw rank a frame."""
        f = self.frame
        fr.discs(f, self.col, self.row, math.sqrt(VOX_S) / 2 * PX_PER_PT,
                 None, _order(rank[f], self.within), colors[f],
                 torch.full((len(f),), 0.2, device=f.device))


def _frames_of(x, dev, n) -> torch.Tensor:
    """The first ``n`` of (B, T, G, G, G, 1) as (n * T, G, G, G) on
    ``dev``."""
    t = x[:n] if isinstance(x, torch.Tensor) else \
        torch.as_tensor(np.ascontiguousarray(x[:n]))
    t = t.to(dev)[..., 0]
    return t.reshape(-1, *t.shape[2:])


def vis_keypoints(vox, keypoints, logger_path: Optional[str] = None,
                  nepoch: int = 0, affinity=None, log_num: int = 4,
                  group: str = "track", Tcond: Optional[int] = None,
                  mode: str = "affinity", figsize: int = 3,
                  affinity_threshold: float = 0.2,
                  device=None) -> np.ndarray:
    """(B, T, G, G, G, 1) voxels + (B, T, K, 4) keypoints ->
    (log_num, T, H, W, 3) uint8, and the GIFs under ``logger_path``.

    Keypoint alpha = intensity (clipped to [0.05, 1]); ``mode='affinity'``
    draws each keypoint's top-2 directed arrows of the affinity
    ``(N, K, K, 1)`` (or ``(K, K)``) with alpha = its intensity over the
    frame's largest; ``mode='A'`` the undirected lines of the adjacency
    ``A`` with alpha ``A[i, j]``. Voxels gray, light blue from ``Tcond``
    on. ``affinity_threshold`` is unused, as in the JAX function."""
    dev = resolve_device(device)
    kp_t = keypoints if isinstance(keypoints, torch.Tensor) else \
        torch.as_tensor(np.asarray(keypoints))
    B, T, K = kp_t.shape[:3]
    n = min(log_num, B)
    F = n * T
    occ = _frames_of(vox, dev, n)
    kp = kp_t[:n].to(dev, torch.float64).reshape(F, K, 4)
    vw = view(figsize)
    fr = _Frags(vw, dev)
    t_of = torch.arange(F, device=dev) % T
    late = (t_of >= (Tcond if Tcond is not None else T + 1))[:, None]
    vox_rgb = torch.where(late, _rgb(LIGHTBLUE, dev), _rgb(GRAY, dev))

    arrow_targets, A = None, None
    if affinity is not None:
        aff = affinity.detach().float().cpu().numpy() \
            if isinstance(affinity, torch.Tensor) else np.asarray(affinity)
        if mode == "affinity":
            infl = aff[..., 0].max(axis=0) if aff.ndim == 4 else aff
            arrow_targets = np.argsort(-infl, axis=-1, kind="stable")[
                :, :NNEIGHBOR]
        else:
            A = aff if aff.ndim == 2 else aff[..., 0]

    # keypoints as data points (x, z, y)
    kpts = torch.stack([kp[..., 0], kp[..., 2], kp[..., 1]], -1)
    kcol, krow, kz, kkeep = project(vw, kpts.reshape(-1, 3))
    kz = kz.reshape(F, K)
    alphas = torch.clamp(kp[..., 3], 0, 1)
    lines = [] if A is None else [(i, j) for i in range(K)
                                  for j in range(i + 1, K) if A[i, j] > 0]
    arrows = [] if arrow_targets is None else \
        [(k, int(j)) for k in range(K) for j in arrow_targets[k]]

    # draw ranks: lines first; collections and patches each by depth
    scatter = _VoxelScatter.of(vw, occ)
    coll_keys = torch.cat([scatter.key[:, None], kz], 1).cpu().numpy()
    if arrows:
        ai = torch.tensor([a for a, _ in arrows], device=dev)
        aj = torch.tensor([b for _, b in arrows], device=dev)
        patch_keys = torch.minimum(kz[:, ai], kz[:, aj]).cpu().numpy()
    coll_rank = np.zeros((F, K + 1), np.int64)
    patch_rank = np.zeros((F, len(arrows)), np.int64)
    for f in range(F):
        cs = sorted(range(K + 1), key=lambda i: coll_keys[f, i], reverse=True)
        ps = sorted(range(len(arrows)), key=lambda i: patch_keys[f, i],
                    reverse=True) if arrows else []
        # after the lines: the i-th collection, then the i-th patch
        coll_rank[f, cs] = len(lines) + 2 * np.arange(len(cs))
        patch_rank[f, ps] = len(lines) + 2 * np.arange(len(ps)) + 1
    coll_rank_t = torch.as_tensor(coll_rank, device=dev)
    scatter.draw(fr, vox_rgb, coll_rank_t[:, 0])

    # keypoints: face, then its edge in the face colour
    frame_k = torch.arange(F, device=dev).repeat_interleave(K)
    rgb_k = _rgb([TAB20[k % 20] for k in range(K)], dev).repeat(F, 1)
    a_k = torch.clamp(kp[..., 3], 0.05, 1.0).reshape(-1).float()
    rank_k = coll_rank_t[:, 1:].reshape(-1)
    keep = kkeep
    r_face = math.sqrt(KP_S) / 2 * PX_PER_PT
    hw_edge = KP_EDGE_PT / 2 * PX_PER_PT
    sel = torch.nonzero(keep, as_tuple=True)[0]
    fr.discs(frame_k[sel], kcol[sel], krow[sel], r_face, None,
             _order(rank_k[sel], 0), rgb_k[sel], a_k[sel])
    fr.discs(frame_k[sel], kcol[sel], krow[sel], r_face + hw_edge,
             r_face - hw_edge, _order(rank_k[sel], 1), rgb_k[sel],
             a_k[sel])

    kc, kr = kcol.reshape(F, K), krow.reshape(F, K)
    if arrows:
        max_alpha = alphas.amax(1, keepdim=True) + 1e-5
        a_arrow = torch.clamp(alphas[:, ai] / max_alpha, 0, 1).reshape(-1)
        frame_a = torch.arange(F, device=dev).repeat_interleave(len(arrows))
        x0, y0 = kc[:, ai].reshape(-1), kr[:, ai].reshape(-1)
        x1, y1 = kc[:, aj].reshape(-1), kr[:, aj].reshape(-1)
        dx, dy = x1 - x0, y1 - y0
        le = torch.sqrt(dx * dx + dy * dy)
        ok = le > 2 * ARROW_SHRINK_PT * PX_PER_PT
        tx = torch.where(ok, dx / le.clamp_min(1e-12), 0.0)
        ty = torch.where(ok, dy / le.clamp_min(1e-12), 0.0)
        shrink = ARROW_SHRINK_PT * PX_PER_PT
        sx0, sy0 = x0 + tx * shrink, y0 + ty * shrink
        tipx, tipy = x1 - tx * shrink, y1 - ty * shrink
        hl, hh = HEAD_LEN_PT * PX_PER_PT, HEAD_HALF_PT * PX_PER_PT
        basex, basey = tipx - tx * hl, tipy - ty * hl
        tri = torch.stack([
            torch.stack([tipx, tipy], -1),
            torch.stack([basex - ty * hh, basey + tx * hh], -1),
            torch.stack([basex + ty * hh, basey - tx * hh], -1)], 1)
        rank_a = torch.as_tensor(patch_rank, device=dev).reshape(-1)
        green = _rgb(ARROW_GREEN, dev).expand(len(frame_a), 3)
        lw = ARROW_LW_PT * PX_PER_PT
        sel = torch.nonzero(ok, as_tuple=True)[0]
        fr.segments(frame_a[sel], sx0[sel], sy0[sel], tipx[sel], tipy[sel],
                    lw / 2, 0.0, _order(rank_a[sel], 0), green[sel],
                    a_arrow[sel].float())
        fr.triangles(frame_a[sel], tri[sel], lw / 2, _order(rank_a[sel], 1),
                     green[sel], a_arrow[sel].float())
    if lines:
        li = torch.tensor([a for a, _ in lines], device=dev)
        lj = torch.tensor([b for _, b in lines], device=dev)
        keep2 = (kkeep.reshape(F, K)[:, li] & kkeep.reshape(F, K)[:, lj])
        a_line = torch.tensor([float(np.clip(A[i, j], 0, 1))
                               for i, j in lines], device=dev)
        frame_l = torch.arange(F, device=dev).repeat_interleave(len(lines))
        rank_l = torch.arange(len(lines), device=dev).repeat(F)
        hw = LINE_LW_PT / 2 * PX_PER_PT
        sel = torch.nonzero(keep2.reshape(-1), as_tuple=True)[0]
        fr.segments(frame_l[sel], kc[:, li].reshape(-1)[sel],
                    kr[:, li].reshape(-1)[sel], kc[:, lj].reshape(-1)[sel],
                    kr[:, lj].reshape(-1)[sel], hw, hw, _order(rank_l[sel], 0),
                    _rgb(GREEN, dev).expand(len(sel), 3),
                    a_line.repeat(F)[sel].float())
    video = to_uint8(fr.composite(F)).reshape(n, T, vw.H, vw.W, 3)
    if logger_path is not None:
        save_gifs(video, logger_path, nepoch, group, "keypoints")
    return video


def vis_recon(vox, recon, logger_path: Optional[str] = None, nepoch: int = 0,
              log_num: int = 4, group: str = "track",
              Tcond: Optional[int] = None, figsize: int = 3,
              threshold: float = 0.5, device=None) -> np.ndarray:
    """Side-by-side GT / reconstruction scatter -> (n, T, H, 2W, 3) uint8:
    the GT's occupied voxels in gray on the left, the recon's voxels at or
    above ``threshold`` in green (light blue from ``Tcond`` on) on the
    right."""
    dev = resolve_device(device)
    B, T = (vox.shape if isinstance(vox, torch.Tensor)
            else np.shape(vox))[:2]
    n = min(log_num, B)
    F = n * T
    t_of = torch.arange(F, device=dev) % T
    late = (t_of >= (Tcond if Tcond is not None else T + 1))[:, None]
    fr = _Frags(view(figsize, 2, 0), dev)
    for panel, (occ, rgb) in enumerate((
            (_frames_of(vox, dev, n), _rgb(GRAY, dev).expand(F, 3)),
            (_frames_of(recon, dev, n) >= threshold,
             torch.where(late, _rgb(LIGHTBLUE, dev), _rgb(GREEN, dev))))):
        fr.use(view(figsize, 2, panel))
        _VoxelScatter.of(fr.vw, occ).draw(
            fr, rgb, torch.full((F,), panel, device=dev))
    vw = fr.vw
    video = to_uint8(fr.composite(F)).reshape(n, T, vw.H, vw.W, 3)
    if logger_path is not None:
        save_gifs(video, logger_path, nepoch, group, "recon")
    return video


def save_gifs(video: np.ndarray, logger_path: str, nepoch: int, group: str,
              name: str) -> None:
    """``gifs/<nepoch>/<group>_<name>_<i>.gif`` under ``logger_path``, one
    per video of ``video`` (n, T, H, W, 3) uint8, 150 ms a frame."""
    gif_dir = os.path.join(logger_path, "gifs", str(nepoch))
    os.makedirs(gif_dir, exist_ok=True)
    for i in range(video.shape[0]):
        write_gif(video[i], os.path.join(gif_dir, f"{group}_{name}_{i}.gif"),
                  GIF_DELAY_S)
