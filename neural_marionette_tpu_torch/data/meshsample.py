"""Uniform mesh-surface point sampling, pure numpy (L0 toolchain): a copy
of the JAX package's ``data/meshsample.py``.

The reference preprocessors lean on ``trimesh.sample.sample_surface`` +
``mesh.face_normals`` (dataset/dfaust/write_sequence_to_obj.py:20-23,
dataset/aistpp/prepare_aistpp.py:13-16) for one thing: N area-uniform
surface samples with their face normals.  That is ~30 lines of numpy —
area-weighted face selection plus the sqrt-trick uniform barycentric draw
— so the L0 scripts here carry no trimesh dependency and run on any host
with numpy alone.
"""
from __future__ import annotations

import numpy as np


def face_normals(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Unit face normals (F, 3) of a triangle mesh (V,3)/(F,3)."""
    v0, v1, v2 = (verts[faces[:, i]] for i in range(3))
    n = np.cross(v1 - v0, v2 - v0)
    norm = np.linalg.norm(n, axis=-1, keepdims=True)
    return n / np.maximum(norm, 1e-12)


def face_areas(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    v0, v1, v2 = (verts[faces[:, i]] for i in range(3))
    return 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=-1)


def sample_surface(verts: np.ndarray, faces: np.ndarray, n: int,
                   rng: np.random.Generator | None = None
                   ) -> tuple[np.ndarray, np.ndarray]:
    """``n`` area-uniform surface samples.

    Returns ``(points (n,3) float64, face_index (n,) int64)`` — the same
    contract as ``trimesh.sample.sample_surface``.  Faces are drawn with
    probability proportional to area; the point within each face is the
    standard uniform barycentric draw (u = 1-sqrt(r1), v = sqrt(r1)*r2).
    """
    if rng is None:
        rng = np.random.default_rng(np.random.randint(0, 2**31 - 1))
    areas = face_areas(verts, faces)
    total = areas.sum()
    if total <= 0:
        raise ValueError("degenerate mesh: zero total surface area")
    fidx = rng.choice(len(faces), size=n, p=areas / total)
    r1 = np.sqrt(rng.random(n))
    r2 = rng.random(n)
    u, v = 1.0 - r1, r1 * r2
    tri = verts[faces[fidx]]                       # (n, 3, 3)
    pts = (u[:, None] * tri[:, 0] + v[:, None] * tri[:, 1]
           + (1.0 - u - v)[:, None] * tri[:, 2])
    return pts, fidx


def sample_surface_with_normals(verts: np.ndarray, faces: np.ndarray,
                                n: int,
                                rng: np.random.Generator | None = None
                                ) -> np.ndarray:
    """(n, 6) float32: [point, unit face normal] — the reference
    preprocessors' ``sample_faces`` output layout."""
    pts, fidx = sample_surface(verts, faces, n, rng)
    normals = face_normals(verts, faces)[fidx]
    return np.hstack([pts, normals]).astype(np.float32)
