"""Minimal SMPL forward pass, pure numpy (L0 toolchain): a copy of the JAX
package's ``data/smpl_np.py``.

The AIST++ preprocessor needs exactly one thing from the smplx package:
posed SMPL vertices for each motion frame (reference
dataset/aistpp/prepare_aistpp.py:56-63).  That forward pass is standard
linear blend skinning over a 24-joint kinematic tree — implemented here in
numpy so the L0 script executes on hosts without torch/smplx/chumpy.

Model file: a pickle (or ``np.savez``) mapping with at least

    v_template   (V, 3)    rest-pose vertices
    J_regressor  (24, V)   joint regressor (dense or scipy sparse)
    weights      (V, 24)   LBS skinning weights
    kintree_table (2, 24) or parents (24,)
    f / faces    (F, 3)    triangles
    posedirs     (V, 3, 207)  pose blendshapes (optional)
    shapedirs    (V, 3, S)    shape blendshapes (optional; betas=0 here)

— the layout of the published ``basicmodel_m_lbs_10_207_0_v1.1.0.pkl``
(chumpy arrays coerce through ``np.asarray``).  The AIST++ fork's extra
``scaling`` input multiplies the skinned vertices before translation,
matching google-research/aistplusplus_api's SMPL usage.
"""
from __future__ import annotations

import pickle

import numpy as np


def rodrigues(rotvec: np.ndarray) -> np.ndarray:
    """Axis-angle (..., 3) -> rotation matrices (..., 3, 3)."""
    theta = np.linalg.norm(rotvec, axis=-1, keepdims=True)
    axis = rotvec / np.maximum(theta, 1e-12)
    x, y, z = axis[..., 0], axis[..., 1], axis[..., 2]
    zero = np.zeros_like(x)
    K = np.stack([zero, -z, y, z, zero, -x, -y, x, zero],
                 axis=-1).reshape(rotvec.shape[:-1] + (3, 3))
    t = theta[..., None]
    eye = np.broadcast_to(np.eye(3), K.shape)
    return eye + np.sin(t) * K + (1.0 - np.cos(t)) * (K @ K)


def _dense(a) -> np.ndarray:
    if hasattr(a, "toarray"):        # scipy sparse (real SMPL pkl)
        return np.asarray(a.toarray(), dtype=np.float64)
    return np.asarray(a, dtype=np.float64)


class SMPLNumpy:
    """LBS skinning over the SMPL kinematic tree (betas fixed at zero —
    the AIST++ preprocessor never passes shape coefficients)."""

    def __init__(self, model_path: str):
        if model_path.endswith((".npz",)):
            data = dict(np.load(model_path, allow_pickle=True))
        else:
            with open(model_path, "rb") as f:
                data = pickle.load(f, encoding="latin1")
        self.v_template = _dense(data["v_template"])          # (V, 3)
        self.J_regressor = _dense(data["J_regressor"])        # (J, V)
        self.weights = _dense(data["weights"])                # (V, J)
        if "parents" in data:
            self.parents = np.asarray(data["parents"],
                                      dtype=np.int64).reshape(-1)
        else:
            kt = np.asarray(data["kintree_table"], dtype=np.int64)
            self.parents = kt[0].copy()
            self.parents[0] = -1
        self.faces = np.asarray(data.get("f", data.get("faces")),
                                dtype=np.int64)
        self.posedirs = (_dense(data["posedirs"])
                         if "posedirs" in data else None)     # (V, 3, P)
        self.n_joints = self.J_regressor.shape[0]

    # ------------------------------------------------------------- forward
    def forward(self, global_orient: np.ndarray, body_pose: np.ndarray,
                transl: np.ndarray, scaling: float = 1.0) -> np.ndarray:
        """Pose a batch of frames.

        global_orient (T, 1, 3) axis-angle root; body_pose (T, J-1, 3);
        transl (T, 3); scaling scalar.  Returns vertices (T, V, 3)
        float32 — ``scaling * skinned + transl`` (AIST++ fork semantics).
        """
        T = global_orient.shape[0]
        J = self.n_joints
        pose = np.concatenate([global_orient.reshape(T, 1, 3),
                               body_pose.reshape(T, J - 1, 3)], axis=1)
        R = rodrigues(pose)                                   # (T, J, 3, 3)

        v_shaped = self.v_template                            # betas = 0
        joints = self.J_regressor @ v_shaped                  # (J, 3)

        if self.posedirs is not None:
            # pose blendshapes: offsets linear in (R_k - I) of the
            # non-root joints, flattened to 9(J-1) coefficients
            feat = (R[:, 1:] - np.eye(3)).reshape(T, -1)      # (T, 9(J-1))
            P = self.posedirs.reshape(-1, feat.shape[1])      # (3V, P)
            v_posed = v_shaped[None] + (feat @ P.T).reshape(T, -1, 3)
        else:
            v_posed = np.broadcast_to(v_shaped, (T,) + v_shaped.shape)

        # forward kinematics: world transform per joint
        G = np.zeros((T, J, 4, 4))
        G[:, 0, :3, :3] = R[:, 0]
        G[:, 0, :3, 3] = joints[0]
        G[:, 0, 3, 3] = 1.0
        for k in range(1, J):
            local = np.zeros((T, 4, 4))
            local[:, :3, :3] = R[:, k]
            local[:, :3, 3] = joints[k] - joints[self.parents[k]]
            local[:, 3, 3] = 1.0
            G[:, k] = G[:, self.parents[k]] @ local
        # remove the rest-pose joint location (the standard SMPL trick)
        rest = np.einsum("tjab,jb->tja", G[:, :, :3, :3], joints)
        Gs = G.copy()
        Gs[:, :, :3, 3] -= rest

        # skinning
        W = self.weights                                      # (V, J)
        A = np.einsum("vj,tjab->tvab", W, Gs)                 # (T, V, 4, 4)
        verts = (np.einsum("tvab,tvb->tva", A[:, :, :3, :3], v_posed)
                 + A[:, :, :3, 3])
        verts = verts * float(scaling) + transl[:, None, :]
        return verts.astype(np.float32)

    def joints_from_vertices(self, vertices: np.ndarray) -> np.ndarray:
        """(T, V, 3) -> (T, J, 3) via the joint regressor (reference
        prepare_aistpp.py:88-91 einsum)."""
        return np.einsum("jv,tvk->tjk", self.J_regressor,
                         vertices).astype(np.float32)
