"""Forward kinematics over a learned skeleton tree.

Counterpart of ``neural_marionette_tpu/ops/fk.py``: the sequential walks
(the JAX package's scans, here Python loops over the priority order) are the
oracle; the pointer-doubling variants run ceil(log2(K-1)) batched rounds and
are what the VRNN path uses.
"""
from __future__ import annotations

import torch


def fk_global_rotations(R_local: torch.Tensor, priority_indices: torch.Tensor,
                        parents: torch.Tensor,
                        inverse: bool = False) -> torch.Tensor:
    """Compose local -> global rotations along the tree.

    ``R_local``: (B, K, 3, 3); ``priority_indices``/``parents``: (K,) int.
    ``inverse=False``: Rglob[c] = Rglob[parent] @ R[c];
    ``inverse=True``:  Rglob[c] = R[c] @ Rglob[parent]."""
    K = R_local.shape[1]
    Rglob = torch.zeros_like(R_local)
    order = priority_indices.tolist()
    par = parents.tolist()
    for i in range(K):
        idx = order[i]
        Rl = R_local[:, idx]
        if i == 0:
            Rg = Rl
        else:
            Rp = Rglob[:, par[idx]]
            Rg = Rl @ Rp if inverse else Rp @ Rl
        Rglob[:, idx] = Rg
    return Rglob


def fk_positions(R_global: torch.Tensor, offset: torch.Tensor,
                 root_pos: torch.Tensor, priority_indices: torch.Tensor,
                 parents: torch.Tensor) -> torch.Tensor:
    """``pos[c] = R_global[c] @ offset[c] + pos[parent]``, ``pos[root] =
    root_pos``. ``R_global``: (B, K, 3, 3); ``offset``: (B, K, 3);
    ``root_pos``: (B, 3)."""
    B, K = offset.shape[:2]
    pos = torch.zeros((B, K, 3), dtype=offset.dtype, device=offset.device)
    order = priority_indices.tolist()
    par = parents.tolist()
    for i in range(K):
        idx = order[i]
        if i == 0:
            p = root_pos
        else:
            p = torch.einsum("bij,bj->bi", R_global[:, idx], offset[:, idx])
            p = p + pos[:, par[idx]]
        pos[:, idx] = p
    return pos


def _doubling_rounds(K: int) -> int:
    """Smallest t with 2^t >= K-1 (max root distance in a K-node tree)."""
    t = 0
    while (1 << t) < max(K - 1, 1):
        t += 1
    return t


def fk_global_rotations_parallel(R_local: torch.Tensor,
                                 priority_indices: torch.Tensor,
                                 parents: torch.Tensor,
                                 inverse: bool = False) -> torch.Tensor:
    """Pointer-doubling equivalent of :func:`fk_global_rotations`.

    After round t, ``P[k]`` is the ordered product of ``R_local`` over the
    path (ptr[k], k], with the root's own entry fixed to I."""
    K = R_local.shape[1]
    root = priority_indices[0]
    is_root = (torch.arange(K, device=R_local.device) == root)[None, :, None,
                                                                None]
    eye = torch.eye(3, dtype=R_local.dtype, device=R_local.device)
    P = torch.where(is_root, eye.expand_as(R_local), R_local)
    ptr = parents.long()
    for _ in range(_doubling_rounds(K)):
        Pp = P[:, ptr]
        P = (P @ Pp) if inverse else (Pp @ P)
        ptr = ptr[ptr]
    # a 1-element index tensor, not the 0-dim ``root``: indexing with a
    # 0-dim tensor reads it on the host, which waits for the card
    R_root = R_local[:, priority_indices[:1]]  # (B, 1, 3, 3)
    return (P @ R_root) if inverse else (R_root @ P)


def fk_positions_parallel(R_global: torch.Tensor, offset: torch.Tensor,
                          root_pos: torch.Tensor,
                          priority_indices: torch.Tensor,
                          parents: torch.Tensor) -> torch.Tensor:
    """Pointer-doubling equivalent of :func:`fk_positions`: ``pos[k] =
    root_pos + sum over the path (root, k] of Rg[a] @ off[a]``."""
    K = offset.shape[1]
    root = priority_indices[0]
    v = torch.einsum("bkij,bkj->bki", R_global, offset)
    is_root = (torch.arange(K, device=offset.device) == root)[None, :, None]
    v = torch.where(is_root, torch.zeros((), dtype=v.dtype,
                                         device=v.device), v)
    ptr = parents.long()
    for _ in range(_doubling_rounds(K)):
        v = v + v[:, ptr]
        ptr = ptr[ptr]
    return root_pos[:, None, :] + v
