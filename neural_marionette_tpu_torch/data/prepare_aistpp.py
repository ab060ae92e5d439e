"""AIST++ offline preprocessor (L0 layer).

Equivalent of reference `dataset/aistpp/prepare_aistpp.py:19-104`: SMPL
forward pass over each motion -> sample 20k surface points/frame + 24 GT
joints (J_regressor) + per-frame yaw root-alignment matrices; 90/10
train/test split; GT affinity from SMPL parents.  Output layout consumed
by ``data.datasets.AIST``:

    <save_dir>/surface/{train,test}/<seq>.npy      (T, 20000, 3)
    <save_dir>/joints/{train,test}/<seq>.npy       (T, 24, 3)
    <save_dir>/root_aligns/{train,test}/<seq>.npy  (T, 3, 3)
    <save_dir>/gt_affinity.npy                     (24, 24)

Self-contained: surface sampling and the SMPL LBS forward are numpy
(``data.meshsample``, ``data.smpl_np``), and the AIST++ motion pkls are
read directly — no smplx/trimesh/aist_plusplus required. A copy of the JAX
package's ``data/prepare_aistpp.py`` on its numpy SMPL path; the JAX
module's optional ``smplx`` forward is not carried over.

    python -m neural_marionette_tpu_torch.data.prepare_aistpp \\
        --anno_dir aist_plusplus_final --smpl_model SMPL_MALE.pkl \\
        --save_dir data/aist_plusplus_smpl_joints
"""
from __future__ import annotations

import argparse
import os
import pickle
import random

import numpy as np

from scipy.spatial.transform import Rotation as R

from .meshsample import sample_surface_with_normals
from .smpl_np import SMPLNumpy

def sample_surface_points(verts: np.ndarray, faces: np.ndarray,
                          n: int = 20000,
                          rng: np.random.Generator | None = None
                          ) -> np.ndarray:
    """Uniform surface samples with face normals -> (n, 6) float32."""
    return sample_surface_with_normals(verts, faces, n, rng)


def yaw_alignment(root_rotvec: np.ndarray) -> np.ndarray:
    """Inverse yaw rotation matrix from the SMPL global orientation
    (reference prepare_aistpp.py:81-83)."""
    euler = R.from_rotvec(root_rotvec).as_euler("xyz", degrees=True)
    return R.from_euler("y", euler[1], degrees=True).as_matrix().T


def load_motion(motion_dir: str, seq: str):
    """AIST++ motion pkl -> (poses (T,72), scaling (1,), trans (T,3)) —
    the AISTDataset.load_motion contract, read directly."""
    with open(os.path.join(motion_dir, seq + ".pkl"), "rb") as f:
        data = pickle.load(f)
    return (np.asarray(data["smpl_poses"], np.float64),
            np.asarray(data["smpl_scaling"], np.float64).reshape(-1),
            np.asarray(data["smpl_trans"], np.float64))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--anno_dir", default="aist_plusplus_final")
    parser.add_argument("--smpl_model", required=True,
                        help="path to the SMPL male model .pkl / .npz")
    parser.add_argument("--save_dir", default="aist_plusplus_smpl_joints")
    parser.add_argument("--n_points", type=int, default=20000)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    random.seed(args.seed)
    rng = np.random.default_rng(args.seed)
    seqs_all = sorted(os.listdir(os.path.join(args.anno_dir, "motions")))
    with open(os.path.join(args.anno_dir, "ignore_list.txt"), "rb") as f:
        ignores = [a.decode("utf-8") for a in f.read().splitlines() if a]
    seqs = [s[:-4] for s in seqs_all
            if not any(s[:26] == ig[:26] for ig in ignores)]
    random.shuffle(seqs)

    motion_dir = os.path.join(args.anno_dir, "motions")
    for split in ("train", "test"):
        for sub in ("surface", "joints", "root_aligns"):
            os.makedirs(os.path.join(args.save_dir, sub, split),
                        exist_ok=True)

    smpl = SMPLNumpy(args.smpl_model)

    # GT affinity from the SMPL kinematic tree (symmetrized parents,
    # reference prepare_aistpp.py:66-74)
    J = len(smpl.parents)
    affinity = np.zeros((J, J), dtype=np.float32)
    for k in range(J):
        parent = int(smpl.parents[k])
        if parent >= 0:
            affinity[k, parent] = affinity[parent, k] = 1.0
    np.save(os.path.join(args.save_dir, "gt_affinity.npy"), affinity)

    total = len(seqs)
    for idx, seq in enumerate(seqs):
        poses, scaling, trans = load_motion(motion_dir, seq)
        vertices = smpl.forward(poses[:, 0:3].reshape(-1, 1, 3),
                                poses[:, 3:].reshape(-1, 23, 3),
                                trans, float(scaling[0]))

        sampled = np.stack([
            sample_surface_points(vertices[t], smpl.faces,
                                  args.n_points, rng)[..., :3]
            for t in range(vertices.shape[0])])
        root_aligns = np.stack([yaw_alignment(poses[t, :3])
                                for t in range(vertices.shape[0])])
        joints = smpl.joints_from_vertices(vertices)

        split = "train" if idx / total <= 0.9 else "test"
        np.save(os.path.join(args.save_dir, "surface", split,
                             seq + ".npy"), sampled)
        np.save(os.path.join(args.save_dir, "root_aligns", split,
                             seq + ".npy"), root_aligns)
        np.save(os.path.join(args.save_dir, "joints", split,
                             seq + ".npy"), joints)
        with open(os.path.join(args.save_dir, f"{split}_list.txt"),
                  "a") as f:
            f.write(seq + "\n")
        print(f"{idx}/{total} {split} {seq} saved")


if __name__ == "__main__":
    main()
