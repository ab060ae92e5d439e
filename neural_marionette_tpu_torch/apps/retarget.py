"""Motion retargeting demo (reference vis_retarget.py:154-322).

Counterpart of ``neural_marionette_tpu/apps/retarget.py``: detect a source
clip's keypoints and per-frame global rotations, detect a target shape's
bind-pose keypoints, skin the target points to the learned skeleton, and
replay the source motion on the target by linear blend skinning
(``retarget.retarget_motion``, on the host); the renders are the port's
``viz``, on the card.
"""
from __future__ import annotations

import contextlib
import os
import time
import warnings
import numpy as np
import torch

from ..api import Marionette, resolve_device
from ..data.pipeline import episodic_normalization
from ..models import SkeletonArrays
from ..ops.voxelize import voxelize_np
from ..retarget import retarget_motion
from ..viz import raster as R
from ..viz.image_files import (read_image, to_uint8, unit_interval,
                                write_gif, write_png)
from ..viz.tiff import offset_binary
from .common import detect_and_extract_skeleton

RENDER_DELAY_S = 0.1   # the JAX save_gif's duration=0.1


def load_obj_vertices(path: str) -> np.ndarray:
    """Minimal OBJ vertex reader (the reference uses Open3D; only the
    vertex positions feed the retarget math)."""
    return load_obj_mesh(path)["verts"]


def load_obj_mesh(path: str) -> dict:
    """OBJ reader with faces, per-vertex UVs and the diffuse texture
    (reference renders the target as a textured Open3D mesh,
    vis_retarget.py:399-435).  Returns dict(verts, faces, uv, texture) —
    faces/uv/texture are None when absent."""
    verts, uvs, faces, face_uvs = [], [], [], []
    mtllib = None
    with open(path) as f:
        for line in f:
            p = line.split()
            if not p:
                continue
            if p[0] == "v":
                verts.append([float(p[1]), float(p[2]), float(p[3])])
            elif p[0] == "vt":
                uvs.append([float(p[1]), float(p[2])])
            elif p[0] == "mtllib":
                mtllib = p[1]
            elif p[0] == "f":
                # fan-triangulate n-gon faces; track UVs per emitted
                # triangle (None when a corner lacks a vt index) so one
                # UV-less face doesn't disable texturing for the mesh
                idx = [q.split("/") for q in p[1:]]
                for a, b in zip(range(1, len(idx) - 1),
                                range(2, len(idx))):
                    tri = [idx[0], idx[a], idx[b]]
                    faces.append([int(q[0]) - 1 for q in tri])
                    if all(len(q) > 1 and q[1] for q in tri):
                        face_uvs.append([int(q[1]) - 1 for q in tri])
                    else:
                        face_uvs.append(None)
    verts = np.asarray(verts, np.float64)
    out = dict(verts=verts, faces=None, uv=None, texture=None)
    if faces:
        out["faces"] = np.asarray(faces, np.int64)
    # per-vertex UV: first UV index seen per vertex
    uv_pairs = [(f_v, f_t) for f_v, f_t in zip(faces, face_uvs)
                if f_t is not None]
    if uv_pairs and uvs:
        uv_arr = np.asarray(uvs, np.float64)
        per_vert = np.zeros((len(verts), 2))
        seen = np.zeros(len(verts), bool)
        for f_v, f_t in uv_pairs:
            for v_i, t_i in zip(f_v, f_t):
                if not seen[v_i]:
                    per_vert[v_i] = uv_arr[t_i]
                    seen[v_i] = True
        out["uv"] = per_vert
    if mtllib:
        tex = _find_texture(os.path.join(os.path.dirname(path), mtllib))
        if tex is not None:
            out["texture"] = tex
    return out


def _find_texture(mtl_path: str):
    """The ``map_Kd`` image of an .mtl file as (H, W, 3) float32 RGB in
    [0, 1]; None when the file is absent or declares no texture, and, with
    a warning, when the declared image is missing (the JAX function's
    None). The image is read by ``viz.image_files.read_image`` (PNG, JPEG,
    BMP, TGA, GIF, TIFF, WebP, DDS, QOI, PNM, Sun raster, Radiance HDR,
    JPEG 2000), by the plugin imageio picks for the file's name and
    content: under ``.pbm``, ``.hdr`` and OpenCV's other names, and for
    Radiance HDR under any name, as OpenCV reads it (a TIFF through
    libtiff's codecs, CCITT fax and SGILog among them), which gives (H, W,
    3) uint8 RGB and so a texture equal to the JAX one. A file that is
    present but cannot be read (a PSD, which imageio does not read either, an
    AVIF, an OpenEXR) raises ``ValueError``."""
    if not os.path.exists(mtl_path):
        return None
    tex_file = None
    with open(mtl_path) as f:
        for line in f:
            p = line.split()
            if p and p[0] == "map_Kd":
                tex_file = p[-1]
    if not tex_file:
        return None
    img_path = os.path.join(os.path.dirname(mtl_path), tex_file)
    if not os.path.exists(img_path):
        warnings.warn(f"{mtl_path} names the texture {img_path}, which does "
                      "not exist; the mesh is drawn without it")
        return None
    return texture_rgb(read_image(img_path))


def texture_rgb(img: np.ndarray) -> np.ndarray:
    """(H, W, C) samples of ``viz.image_files.read_image`` -> (H, W, 3)
    float32 in [0, 1]. Where the JAX function's result is an RGB image
    (imageio gives 8-bit samples, C of 3 or more) this is its ``/ 255`` then
    ``[..., :3]``, equal to the bit. Elsewhere it is defined, and
    ``ROADMAP.md`` (Queue 3) lists each case as a fault of the JAX function
    that the port does not share:

    * grey is replicated to RGB and alpha dropped (the JAX function keeps
      3 columns of a grey image and 2 channels of grey + alpha);
    * every integer sample goes through ``image_files.unit_interval``: the
      value and 2^d - 1 rounded to float64, divided there, the quotient
      rounded to float32 (for 8- and 16-bit samples that is float32's own
      division, to the bit). A d-bit unsigned sample is divided by
      2^d - 1: uint8 by 255, uint16 by 65535 (the JAX function divides
      16-bit samples by 255); int32 is Pillow's mode "I" of a PGM past 8
      bits, 0-65535, divided by 65535;
    * a signed d-bit sample (TIFF's int8, int16) is offset by 2^(d-1),
      then divided by 2^d - 1 (the JAX texture is negative);
    * float samples are clipped to [0, 1], NaN read as 0 (the JAX function
      divides them by 255).

    ``read_image`` has already applied the rest of the rules. To a TIFF
    (``viz/tiff.py``; the JAX function gets tifffile's raw samples): a
    palette's indices mapped through its colour map (16-bit entries, so
    / 65535; the JAX texture is the indices); planar samples read as
    (H, W, C) (JAX: (C, H, W)); the first page of several and the first
    plane of an ``ImageDepth`` volume (JAX: all of them); CMYK made RGB as
    Pillow's ``convert("RGB")`` does and YCbCr as libtiff's
    ``TIFFYCbCrToRGB`` does, each from 8-bit samples (a wider sample's high
    byte, a signed one offset first, a float one as ``to_uint8`` makes
    it; JAX: the inks, the YCbCr samples); CIELab, ICCLab and ITULab made
    sRGB by ``viz.tiff.lab_to_rgb`` (JAX: the L, a, b codes); min-is-white
    inverted (JAX: the stored levels); 1-, 2- and 4-bit samples scaled to
    8 bits, a predictor's sum past 2^d - 1 saturated (JAX: the indices);
    32- and 64-bit integers already normalised to float32 by
    ``unit_interval`` (JAX: divided by 255, far past 1); complex samples'
    real parts, then the float rule (as the JAX ``np.asarray(...,
    np.float32)`` keeps them, then divides by 255); packed 5-6-5 RGB as
    tifffile rescales it to 8 bits (equal to the JAX texture). To a CMYK or
    YCCK JPEG, a CMYK JPEG 2000 and a Pillow ``P0CMYK`` or ``PyCMYK`` file,
    Pillow's CMYK made RGB as for TIFF (the JAX texture is C, M, Y); a
    bitmap's bool as 0 and 255; an OpenCV PNM's 8-bit samples as OpenCV
    gives them (16-bit ones cut to their high byte, grey as RGB)."""
    rgb = img[..., :3] if img.shape[-1] >= 3 else np.repeat(img[..., :1], 3,
                                                           axis=-1)
    if img.dtype.kind == "f":
        return np.clip(np.nan_to_num(rgb, nan=0.0), 0, 1).astype(np.float32)
    if img.dtype == np.int32:   # a PGM past 8 bits, Pillow's 0-65535
        return unit_interval(rgb, 16)
    return unit_interval(offset_binary(rgb), 8 * img.dtype.itemsize)


def load_target_points(path: str, scale: float = 0.8, x_trans: float = 0.0,
                       z_trans: float = 0.0, is_bind: bool = False,
                       return_mesh: bool = False):
    """Target shape -> normalized points (reference
    load_voxel_from_real_data_for_mesh, vis_retarget.py:92-100).

    ``return_mesh=True`` additionally returns dict(faces, uv, texture)
    aligned with the returned (deformable) points so the render layer can
    draw the textured/smooth mesh views."""
    mesh = None
    if path.endswith(".obj"):
        mesh = load_obj_mesh(path)
        x = mesh["verts"]
    else:
        x = np.load(path)[..., :3]
    if x.ndim == 3:
        # a (T, N, 3) motion clip was passed where a static target shape
        # belongs — use its first frame (rest pose) rather than crashing
        x = x[0]
    if is_bind:
        x = np.stack([x[:, 0], -x[:, 2], x[:, 1]], axis=-1)
    x = episodic_normalization(x[None], scale, x_trans, z_trans)[0]
    if return_mesh:
        return x, (None if mesh is None else
                   dict(faces=mesh["faces"], uv=mesh["uv"],
                        texture=mesh["texture"]))
    return x


def run_retarget(m: Marionette, source_vox: np.ndarray,
                 target_points: np.ndarray, hardness: float = 8.0,
                 mode: str = "ours", seed: int = 0, eps=None) -> dict:
    """``source_vox`` (T, G, G, G, 1); ``target_points`` (N, 3) in
    [-1, 1]^3. The source is encoded with noise from ``seed``, the target
    from ``seed + 1``, each on the marionette's device, or with ``eps`` =
    (source draws, target draws) as ``HSVRNNBVH.encode`` takes them
    ((T, 10, 1, Z) and (1, 10, 1, Z))."""
    model = m.model
    cfg = m.cfg
    eps_src, eps_tgt = (None, None) if eps is None else eps

    # ---- source: keypoints + per-frame global rotations
    det, skeleton = detect_and_extract_skeleton(m, source_vox)
    source_kp = det["keypoints"].cpu().numpy().copy()  # (1, T, K, 4)
    # freeze intensities to frame 0 for consistent rigs (vis_retarget.py:242)
    source_kp[:, 1:, :, -1] = source_kp[:, :1, :, -1]
    sk = SkeletonArrays.from_skeleton(skeleton, m.device)
    with torch.inference_mode():
        dyn = model.dyna_module.encode(
            torch.as_tensor(source_kp, device=m.device), sk, eps=eps_src,
            generator=torch.Generator(m.device).manual_seed(seed))
        source_R = dyn["R"][0].cpu().numpy()  # (T, K, 3, 3)

        # ---- target: bind-pose keypoints + inverse rotations
        target_vox = voxelize_np(target_points.astype(np.float32),
                                 cfg.grid_size)
        tdet = model.kypt_detector(m.clip_tensor(target_vox[None]),
                                   affinity_active=True)
        target_kp = tdet["keypoints"].cpu().numpy()  # (1, 1, K, 4)
        # transplant source frame-0 intensities (vis_retarget.py:260)
        target_kp = np.concatenate(
            [target_kp[..., :3], source_kp[:1, :1, :, 3:]], axis=-1)
        target_t = torch.as_tensor(target_kp, device=m.device)
        tdyn = model.dyna_module.encode(
            target_t, sk, eps=eps_tgt,
            generator=torch.Generator(m.device).manual_seed(seed + 1))
        target_R = tdyn["R"][0, 0].cpu().numpy()  # (K, 3, 3) bind pose
        # bone offsets from the target pose (vis_retarget.py:275)
        offset = model.dyna_module.get_offset(
            target_t, sk.parents)[0].cpu().numpy()  # (K, 3)

    result = retarget_motion(
        skeleton, source_kp[0], source_R, target_kp[0, 0], target_R,
        target_points, offset, hardness=hardness, mode=mode)
    return dict(result=result, skeleton=skeleton,
                source_keypoints=source_kp[0], target_keypoints=target_kp)


class _Timer:
    """Host ms per part: ``with timer("render_ms"): ...``."""

    def __init__(self, *parts):
        self.ms = dict.fromkeys(parts, 0.0)

    @contextlib.contextmanager
    def __call__(self, part):
        t0 = time.perf_counter()
        yield
        self.ms[part] += (time.perf_counter() - t0) * 1e3


def _write_seq(out_dir: str, name: str, rgb: np.ndarray) -> None:
    """``<name>/%02d.png`` per frame and ``<name without _imgs>.gif``
    (100 ms a frame)."""
    img_dir = os.path.join(out_dir, name)
    os.makedirs(img_dir, exist_ok=True)
    for t, img in enumerate(rgb):
        write_png(img, os.path.join(img_dir, f"{t:02d}.png"))
    write_gif(rgb, os.path.join(out_dir, f"{name[:-5]}.gif"), RENDER_DELAY_S)


def save_outputs(out: dict, out_dir: str, source_vox=None, target_mesh=None,
                 target_points=None, intensity_threshold: float = 0.2,
                 device=None) -> dict:
    """The retarget output inventory of the JAX ``save_outputs``
    (reference vis_retarget.py:325-557): the ``.npy`` exports, then at the
    reference camera (``raster.default_camera()``) the source
    clip's voxels with its skeleton (``source_imgs``, given
    ``source_vox``), the target stills ``target.png`` and
    ``target_skin.png`` (its mesh, textured when ``target_mesh`` carries
    UVs and a texture, else surfels with estimated normals; given
    ``target_points``), and the deformed result as ``smooth_imgs``,
    ``textured_imgs`` (a textured target), ``skeleton_imgs`` and
    ``overlay_imgs`` (given ``source_vox``), each a PNG a frame and a GIF.
    Without faces the deformed points render as surfels of every
    ``len // 6000``-th point. Every set is drawn for all its frames in one
    pass on ``device`` (``cuda`` unless the caller asks for the CPU).
    Returns the host ms of the parts: ``host_ms`` (mesh samples, normals,
    skeleton meshes), ``render_ms`` (the device passes and the copies of
    the frames back), ``encode_ms`` (PNG and GIF files)."""
    os.makedirs(out_dir, exist_ok=True)
    res = out["result"]
    np.save(os.path.join(out_dir, "retargeted_points.npy"), res.new_points)
    np.save(os.path.join(out_dir, "retargeted_keypoints.npy"),
            res.new_keypoints)
    np.save(os.path.join(out_dir, "skin_weights.npy"), res.skin_weights)
    np.save(os.path.join(out_dir, "parents.npy"), out["skeleton"].parents)

    dev = resolve_device(device)
    cam = R.default_camera()
    parents = out["skeleton"].parents
    src_kp = out["source_keypoints"]  # (T, K, 4)
    valid = src_kp[0, :, -1] >= intensity_threshold
    joint_colors = R._spaced_colors(src_kp.shape[1])
    T = res.new_points.shape[0]
    timer = _Timer("host_ms", "render_ms", "encode_ms")

    def blank(n=T):
        return R.blank(cam, n, device=dev)

    def voxel_frames(color):
        """The source voxels of every frame splatted (px 2) onto white."""
        G = source_vox.shape[1]
        f, x, y, z = np.nonzero(source_vox[..., 0])
        coords = np.stack([x, y, z], -1) / ((G - 1) / 2) - 1
        cols = np.tile(np.asarray([color], np.float32), (len(coords), 1))
        return R.splat_frames(
            cam, torch.as_tensor(coords, device=dev),
            torch.as_tensor(cols, device=dev), torch.as_tensor(f, device=dev),
            blank(), px=2)

    def skeletons(kps):
        return R.mesh_batch(cam, [
            dict(zip(("verts", "faces", "vert_colors"),
                     R.skeleton_geometry(kp[:, :3], parents, valid=valid,
                                         joint_colors=joint_colors)))
            for kp in kps])

    def write(name, render):
        with timer("render_ms"):
            rgb = to_uint8(render())
        with timer("encode_ms"):
            _write_seq(out_dir, name, rgb)

    # ---- source clip: occupied-voxel points + skeleton (ref :325-398)
    if source_vox is not None:
        with timer("host_ms"):
            samples = skeletons(src_kp[:T])
        write("source_imgs", lambda: R.shade_splat(
            cam, *samples, voxel_frames([0.45, 0.45, 0.5])))

    # ---- target stills (ref :399-435): textured + skin-weight colors
    faces = (target_mesh or {}).get("faces") if target_mesh else None
    tex_colors = None
    if target_mesh and target_mesh.get("uv") is not None \
            and target_mesh.get("texture") is not None:
        tex = target_mesh["texture"]
        uv = np.clip(target_mesh["uv"], 0, 1)
        h, w = tex.shape[:2]
        tex_colors = tex[((1 - uv[:, 1]) * (h - 1)).astype(int),
                         (uv[:, 0] * (w - 1)).astype(int)]
    if target_points is not None:
        skin_colors = joint_colors[np.argmax(res.skin_weights, axis=-1)]
        gray = np.tile([[0.7, 0.7, 0.7]], (len(target_points), 1))
        if faces is not None:
            base = tex_colors if tex_colors is not None else gray
            with timer("host_ms"):
                samples = R.mesh_batch(cam, [
                    dict(verts=target_points, faces=faces, vert_colors=c)
                    for c in (base, skin_colors)])
            with timer("render_ms"):
                rgb = to_uint8(R.shade_splat(cam, *samples, blank(2)))
        else:
            with timer("host_ms"):
                n = R.estimate_normals(target_points)
            with timer("render_ms"):
                p = np.asarray(target_points, np.float64)
                rgb = to_uint8(R.render_surfels_frames(
                    cam, torch.as_tensor(np.concatenate([p, p]), device=dev),
                    torch.as_tensor(np.concatenate([n, n]), device=dev),
                    torch.as_tensor(np.concatenate([gray, skin_colors]),
                                    device=dev),
                    torch.arange(2, device=dev).repeat_interleave(len(p)),
                    blank(2)))
        with timer("encode_ms"):
            write_png(rgb[0], os.path.join(out_dir, "target.png"))
            write_png(rgb[1], os.path.join(out_dir, "target_skin.png"))

    # ---- deformed result views (ref :436-557)
    def mesh_or_surfels(name, colors, background):
        pts = res.new_points
        if faces is not None:
            with timer("host_ms"):
                samples = R.mesh_batch(cam, [
                    dict(verts=pts[t], faces=faces, vert_colors=colors)
                    for t in range(T)])
            write(name, lambda: R.shade_splat(cam, *samples, background()))
            return
        step = max(pts.shape[1] // 6000, 1)
        sub = pts[:, ::step]
        with timer("host_ms"):
            n = np.concatenate([R.estimate_normals(sub[t])
                                for t in range(T)])
        c = np.asarray(colors)[::step] if np.ndim(colors) > 1 \
            else np.tile(colors, (sub.shape[1], 1))
        write(name, lambda: R.render_surfels_frames(
            cam, torch.as_tensor(sub.reshape(-1, 3), dtype=torch.float64,
                                 device=dev),
            torch.as_tensor(n, device=dev),
            torch.as_tensor(np.tile(c, (T, 1)), device=dev),
            torch.arange(T, device=dev).repeat_interleave(sub.shape[1]),
            background()))

    smooth_base = np.tile([[0.55, 0.75, 0.85]],
                          (res.new_points.shape[1], 1)).astype(np.float32)
    mesh_or_surfels("smooth_imgs", smooth_base, blank)
    if tex_colors is not None:
        mesh_or_surfels("textured_imgs", tex_colors, blank)
    with timer("host_ms"):
        samples = skeletons(res.new_keypoints)
    write("skeleton_imgs", lambda: R.shade_splat(cam, *samples, blank()))
    if source_vox is not None:
        mesh_or_surfels("overlay_imgs", smooth_base,
                        lambda: voxel_frames([0.8, 0.5, 0.5]))
    return timer.ms
