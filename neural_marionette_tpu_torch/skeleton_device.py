"""Skeleton extraction on the device.

Counterpart of ``neural_marionette_tpu/skeleton_device.py``, the device
re-design of the host extraction (``skeleton.py``, reference
``utils/dyna_utils.py:6-171``): all-pairs shortest paths become a K-step
min-plus Floyd-Warshall over the K <= ~32 node graph, and every tie rule of
the host (the component bridge, the float32 1e-5 edge perturbations, the
rank/influence parent rules, the co-parent rule) is written with masked
tensor operations.

Exact arithmetic. The host computes shortest paths in float64 over float32
edge weights ``w = 1 + r``, each perturbation residual ``r`` a small
multiple of 2^-24. A distance is carried here as an exact pair ``(H, R)``:
``H`` the hop count (exact in float32), ``R`` the sum of residuals (all
multiples of 2^-24 below 2^-5, so every float32 partial sum is exact, on
the CPU and on the card). Comparing ``(H, R)`` lexicographically orders
paths as the host's float64 ``H + R`` does, exact ties included, which
fall back to the same lowest-index rule. The perturbed weights replay the
host's sequential float32 ``+= 1e-5`` one addition at a time; the parent
loop runs over the nodes in order because the host mutates ``A_bin`` when
a node falls back to the root.

The extraction runs once per run (when the learner turns on, or at a
demo's first call), outside every timed step. The host ``skeleton.py``
stays as the test oracle.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .api import resolve_device
from .skeleton import Skeleton

BIG_NUM = 1e4


class DeviceSkeleton(NamedTuple):
    A: torch.Tensor                 # (K, K) float32 tree adjacency
    priority_values: torch.Tensor   # (K,) float32 root distances, ascending
    priority_indices: torch.Tensor  # (K,) int32 joints root-first
    parents: torch.Tensor           # (K,) int32


def _lex_lt(h1, r1, h2, r2):
    return (h1 < h2) | ((h1 == h2) & (r1 < r2))


def _floyd_warshall_pair(adj_mask, weights):
    """All-pairs shortest paths over exact (hops, residual) pairs;
    unreachable pairs stay at (BIG_NUM, 0). Zero-weight edges are absent,
    as scipy drops explicit zeros from the host's ``csr_matrix``."""
    K = adj_mask.shape[0]
    edge = (adj_mask > 0) & (weights > 0)
    eye = torch.eye(K, dtype=torch.bool, device=adj_mask.device)
    H = torch.where(edge, 1.0, BIG_NUM).float()
    R = torch.where(edge, weights.float() - 1.0, 0.0).float()
    H = torch.where(eye, 0.0, H)
    R = torch.where(eye, 0.0, R)
    for k in range(K):
        cH = H[:, k, None] + H[None, k, :]
        cR = R[:, k, None] + R[None, k, :]
        better = _lex_lt(cH, cR, H, R)
        H, R = torch.where(better, cH, H), torch.where(better, cR, R)
    return H, R


def _lex_argmin(h, r):
    """First index of the lexicographic minimum of (h, r)."""
    at = h == h.min()
    minr = torch.where(at, r, float("inf")).min()
    return torch.argmax((at & (r == minr)).to(torch.int8))


def _perturbed_weights(A_bin, sum_H, influence):
    """Count the host's 1e-5 edge increments, then replay them in float32:
    for each pair k < kdot of equal distance sums and each common
    neighbour n, the (n, l) and (l, n) edges go up, l the one of {k, kdot}
    LESS attached to n (``skeleton.py``'s perturbation loop)."""
    K = A_bin.shape[0]
    dev = A_bin.device
    eq = sum_H[:, None] == sum_H[None, :]
    upper = torch.ones(K, K, dtype=torch.bool, device=dev).triu(1)
    pair = eq & upper                                          # (k, kdot)
    common = (A_bin[:, None, :] > 0) & (A_bin[None, :, :] > 0)  # (k,kdot,n)
    m = pair[:, :, None] & common
    infl_nk = influence.T   # (node, n): influence[n, node]
    choose_kdot = infl_nk[:, None, :] > infl_nk[None, :, :]    # (k,kdot,n)
    cnt_to_kdot = (m & choose_kdot).sum(0).T                   # (n, kdot)
    cnt_to_k = (m & ~choose_kdot).sum(1).T                     # (n, k)
    cnt = cnt_to_kdot + cnt_to_k
    cnt = cnt + cnt.T
    w = A_bin.float()
    step = torch.tensor(1e-5, dtype=torch.float32, device=dev)
    for i in range(int(cnt.max())):
        w = torch.where(cnt > i, w + step, w)
    return w


def _select_parent(k, A_bin, rank_H, rank_R, influence, root):
    """Node ``k``'s parent (``k`` not the root) under the host's sequential
    tie rules, over its neighbours at once; returns it and ``A_bin`` with the (k, root) edge
    the host adds when ``k`` falls back to the root."""
    K = A_bin.shape[0]
    idx = torch.arange(K, device=A_bin.device)
    neigh = A_bin[k] > 0
    dH = rank_H - rank_H[k]
    dR = rank_R - rank_R[k]
    zero = torch.zeros((), device=A_bin.device)
    is_neg = _lex_lt(dH, dR, zero, zero)
    is_zero = (dH == 0.0) & (dR == 0.0)

    # negative branch: lexicographic argmax of (rank distance, influence[k]),
    # the earliest index on full ties
    neg = neigh & is_neg
    maxH = torch.where(neg, dH, float("-inf")).max()
    at_h = neg & (dH == maxH)
    maxR = torch.where(at_h, dR, float("-inf")).max()
    at_maxd = at_h & (dR == maxR)
    neg_parent = torch.argmax(torch.where(at_maxd, influence[k],
                                          float("-inf")))
    any_neg = neg.any()

    # co-parent branch: for same-rank neighbours n, their common neighbour
    # nn of least rank (below rank[n]; earliest on ties) decides by
    # influence; the LAST qualifying n wins
    same = neigh & is_zero & (idx != k)
    lower = _lex_lt(rank_H[None, :], rank_R[None, :],
                    rank_H[:, None], rank_R[:, None])   # rank[nn] < rank[n]
    nn_valid = (A_bin > 0) & neigh[None, :] & lower      # (n, nn)
    nnH = torch.where(nn_valid, rank_H[None, :], float("inf"))
    at_h2 = nn_valid & (nnH == nnH.min(1, keepdim=True).values)
    nnR = torch.where(at_h2, rank_R[None, :], float("inf"))
    at_r2 = at_h2 & (nnR == nnR.min(1, keepdim=True).values)
    co_parent = torch.argmax(at_r2.to(torch.int8), 1)    # (n,) first index
    has_co = nn_valid.any(1)
    co_ok = has_co & (influence[co_parent, idx] > influence[co_parent, k])
    qual = same & co_ok
    any_co = qual.any()
    co_parent_n = K - 1 - torch.argmax(torch.flip(qual, (0,)).to(torch.int8))

    parent = torch.where(any_co, co_parent_n,
                         torch.where(any_neg, neg_parent, root))
    fallback = ~any_co & ~any_neg
    A_new = A_bin.clone()
    A_new[k, root] = torch.where(fallback, 1.0, A_bin[k, root])
    A_new[root, k] = torch.where(fallback, 1.0, A_bin[root, k])
    return parent, A_new


def extract_skeleton_device(affinity, device=None) -> DeviceSkeleton:
    """Affinity ``(nneighbor, K, K[, 1])`` (a tensor on its device, or an
    array moved to ``device``, ``cuda`` unless the caller asks for the
    CPU) -> :class:`DeviceSkeleton` on that device."""
    if isinstance(affinity, torch.Tensor) and device is None:
        aff = affinity.detach().float()
    else:
        aff = torch.as_tensor(np.asarray(affinity, np.float32)
                              if not isinstance(affinity, torch.Tensor)
                              else affinity.detach(),
                              device=resolve_device(device)).float()
    if aff.ndim == 4:
        aff = aff[..., 0]
    N, K, _ = aff.shape
    dev = aff.device
    idx = torch.arange(K, device=dev)
    influence = aff.max(0).values   # (K, K)

    # top-N neighbours per node (stable: ascending index on ties)
    topk = torch.argsort(-influence, dim=-1, stable=True)[:, :N]
    A_bin = torch.zeros(K, K, device=dev)
    A_bin[idx[:, None], topk] = 1.0
    A_bin = torch.maximum(A_bin, A_bin.T)

    H, _ = _floyd_warshall_pair(A_bin, A_bin)   # unweighted: hops only

    # a single bridge attempt if disconnected
    disconnected = (H >= BIG_NUM).any()
    sum_H0 = H.sum(-1)
    root0 = torch.argmin(sum_H0)
    order = torch.argsort(sum_H0, stable=True)
    rank0 = torch.zeros(K, device=dev)
    rank0[order] = torch.arange(K, device=dev, dtype=torch.float32)
    cand = H[root0] >= BIG_NUM
    min_idx = torch.argmin(torch.where(cand, rank0, float("inf")))
    A_bridged = A_bin.clone()
    A_bridged[root0, min_idx] = 1.0
    A_bridged[min_idx, root0] = 1.0
    A_bin = torch.where(disconnected, A_bridged, A_bin)
    H2, _ = _floyd_warshall_pair(A_bin, A_bin)
    H = torch.where(disconnected, H2, H)

    # 1e-5 perturbations, then weighted shortest paths (exact pairs)
    w = _perturbed_weights(A_bin, H.sum(-1), influence)
    dH, dR = _floyd_warshall_pair(A_bin, w)
    root = _lex_argmin(dH.sum(-1), dR.sum(-1))
    rank_H, rank_R = dH[root], dR[root]

    # parents in node order (A_bin grows on a root fallback)
    parents = []
    root_i = int(root)
    for k in range(K):
        if k == root_i:
            parents.append(root)
            continue
        p, A_bin = _select_parent(k, A_bin, rank_H, rank_R, influence, root)
        parents.append(p)
    parents = torch.stack(parents).to(torch.int64)

    # tree adjacency from the parents
    not_root = parents != idx
    A = torch.zeros(K, K, device=dev)
    A[idx[not_root], parents[not_root]] = 1.0
    A = torch.maximum(A, A.T)

    # priority on the tree with the perturbed weights; a stable two-key
    # sort of the exact pairs orders them as the host's float64 values
    tH, tR = _floyd_warshall_pair(A, w)
    keys_H, keys_R = tH[root], tR[root]
    order1 = torch.argsort(keys_R, stable=True)
    order2 = torch.argsort(keys_H[order1], stable=True)
    priority_indices = order1[order2]
    priority_values = (keys_H + keys_R)[priority_indices]
    return DeviceSkeleton(A=A, priority_values=priority_values.float(),
                          priority_indices=priority_indices.to(torch.int32),
                          parents=parents.to(torch.int32))


def extract_skeleton_host_api(affinity, device=None) -> Skeleton:
    """The device extraction, returned as the host :class:`Skeleton` the
    checkpoints, the steps and the demos take (numpy arrays)."""
    dsk = extract_skeleton_device(affinity, device)
    return Skeleton(A=dsk.A.cpu().numpy(),
                    priority_values=dsk.priority_values.cpu().numpy(),
                    priority_indices=dsk.priority_indices.cpu().numpy(),
                    parents=dsk.parents.cpu().numpy())
