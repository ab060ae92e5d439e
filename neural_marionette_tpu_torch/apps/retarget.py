"""Motion retargeting demo (reference vis_retarget.py:154-322).

Counterpart of ``neural_marionette_tpu/apps/retarget.py``: detect a source
clip's keypoints and per-frame global rotations, detect a target shape's
bind-pose keypoints, skin the target points to the learned skeleton, and
replay the source motion on the target by linear blend skinning
(``retarget.retarget_motion``, on the host). The renders come with the
port's ``viz``.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..api import Marionette
from ..data.pipeline import episodic_normalization
from ..models import SkeletonArrays
from ..ops.voxelize import voxelize_np
from ..retarget import retarget_motion
from .common import detect_and_extract_skeleton


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
    """map_Kd image from an .mtl file, as float RGB (or None)."""
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
        return None
    import imageio
    img = np.asarray(imageio.imread(img_path), np.float32) / 255.0
    return img[..., :3]


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


def save_outputs(out: dict, out_dir: str) -> None:
    """The ``.npy`` exports: retargeted points and keypoints, skin
    weights, parents."""
    os.makedirs(out_dir, exist_ok=True)
    res = out["result"]
    np.save(os.path.join(out_dir, "retargeted_points.npy"), res.new_points)
    np.save(os.path.join(out_dir, "retargeted_keypoints.npy"),
            res.new_keypoints)
    np.save(os.path.join(out_dir, "skin_weights.npy"), res.skin_weights)
    np.save(os.path.join(out_dir, "parents.npy"), out["skeleton"].parents)
