"""Skeleton extraction from a learned affinity graph, for the reference.

A frozen copy of the port's host extraction (``skeleton.py`` there, itself
a transcription of reference ``utils/dyna_utils.py:6-171`` without
networkx), so the benchmark's reference derives the skeleton the port's
VRNN runs over by itself and does not move when the port's code does.
Ties are pinned to ascending index (stable sorts), as there.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
from scipy.sparse import csr_matrix
from scipy.sparse.csgraph import connected_components, dijkstra

BIG_NUM = 1e4


class Skeleton(NamedTuple):
    """Tree structure extracted from the affinity graph.

    A: (K, K) float32 symmetric parent-child adjacency.
    priority_values: (K,) float32 distances from root, ascending.
    priority_indices: (K,) int32 joints ordered root-first by distance.
    parents: (K,) int32 parent of each joint (root points to itself).
    """
    A: np.ndarray
    priority_values: np.ndarray
    priority_indices: np.ndarray
    parents: np.ndarray


def _all_pairs_shortest(adj_mask: np.ndarray,
                        weights: np.ndarray | None = None) -> np.ndarray:
    """Dense all-pairs shortest path lengths; unreachable -> BIG_NUM."""
    w = np.asarray(weights if weights is not None else adj_mask, dtype=np.float64)
    w = np.where(adj_mask > 0, w, 0.0)
    d = dijkstra(csr_matrix(w), directed=False)
    d[np.isinf(d)] = BIG_NUM
    return d


def extract_skeleton(affinity: np.ndarray) -> Skeleton:
    """Affinity ``(nneighbor, K, K[, 1])`` -> :class:`Skeleton`."""
    aff = np.asarray(affinity, dtype=np.float64)
    if aff.ndim == 4:
        aff = aff[..., 0]
    N, K, _ = aff.shape

    influence = aff.max(axis=0)  # (K, K)

    # top-N neighbors per node -> symmetrized binary adjacency.
    # float32 like the reference's torch-derived array: the 1e-5 edge
    # perturbations below accumulate with float32 rounding, and the exact
    # bit pattern decides distance tie-breaks downstream.
    topk = np.argsort(-influence, axis=-1, kind="stable")[:, :N]
    A_bin = np.zeros((K, K), dtype=np.float32)
    A_bin[np.arange(K)[:, None], topk] = 1.0
    A_bin = np.maximum(A_bin, A_bin.T)

    A_dijk = _all_pairs_shortest(A_bin)

    # ensure a single connected component (one bridge attempt, as upstream)
    n_comp, _ = connected_components(csr_matrix(A_bin), directed=False)
    if n_comp > 1:
        root = int(A_dijk.sum(axis=-1).argmin())
        order = np.argsort(A_dijk.sum(axis=-1), kind="stable")
        rank = np.zeros(K)
        rank[order] = np.arange(K)
        candidates = np.where(A_dijk[root] == BIG_NUM)[0]
        min_idx = candidates[0]
        for cand in candidates[1:]:
            if rank[min_idx] > rank[cand]:
                min_idx = cand
        A_bin[root, min_idx] = 1.0
        A_bin[min_idx, root] = 1.0
        A_dijk = _all_pairs_shortest(A_bin)

    # perturb tie-broken edge weights by 1e-5 using influence comparisons
    sum_dist = A_dijk.sum(axis=-1)
    A_bin_temp = A_bin.copy()
    for k in range(K - 1):
        for kdot in range(k + 1, K):
            if sum_dist[k] == sum_dist[kdot]:
                k_set = np.where(A_bin[k])[0]
                kdot_set = set(np.where(A_bin[kdot])[0].tolist())
                for n in k_set:
                    if n in kdot_set:
                        l = kdot if influence[n, k] > influence[n, kdot] else k
                        A_bin_temp[n, l] += np.float32(1e-5)
                        A_bin_temp[l, n] += np.float32(1e-5)

    A_dijk = _all_pairs_shortest(A_bin, weights=A_bin_temp)

    # root = node with min distance-sum; rank = distances from root
    root = int(np.argsort(A_dijk.sum(axis=-1), kind="stable")[0])
    rank = A_dijk[root]
    priority_indices = np.argsort(rank, kind="stable")

    # per-node parent selection with rank/influence tie-breaking
    parents = np.zeros(K, dtype=np.int64)
    for k in range(K):
        if k == root:
            parents[k] = k
            continue
        neighbors = np.where(A_bin[k])[0]
        parent_idx = None
        parent_dist = -1e3
        for n in neighbors:
            rank_dist = rank[n] - rank[k]
            if rank_dist < 0 and rank_dist > parent_dist:
                parent_dist = rank_dist
                parent_idx = n
            elif rank_dist < 0 and rank_dist == parent_dist:
                if influence[k, n] > influence[k, parent_idx]:
                    parent_dist = rank_dist
                    parent_idx = n
            elif rank_dist == 0:
                # co-parent rule: a same-rank neighbor n adopts k if their
                # common lower-rank neighbor is more attached to n than to k
                n_neighbors = np.where(A_bin[n])[0]
                neighbor_set = set(neighbors.tolist())
                co_parent_idx = None
                co_parent_rank = 1e4
                for nn in n_neighbors:
                    if nn in neighbor_set and rank[nn] < rank[n]:
                        if co_parent_rank > rank[nn]:
                            co_parent_idx = nn
                            co_parent_rank = rank[nn]
                if co_parent_idx is not None:
                    if influence[co_parent_idx, n] > influence[co_parent_idx, k]:
                        parent_dist = rank_dist
                        parent_idx = n
        if parent_idx is None:
            parent_idx = root
            A_bin[k, parent_idx] = 1.0
            A_bin[parent_idx, k] = 1.0
        parents[k] = parent_idx

    # tree adjacency from parent-child relationships
    A = np.zeros((K, K), dtype=np.float64)
    for k in range(K):
        if k != parents[k]:
            A[k, parents[k]] = 1.0
            A[parents[k], k] = 1.0

    # re-compute priority on the tree with the perturbed weights
    A_dijk = _all_pairs_shortest(A, weights=A_bin_temp)
    priority_indices = np.argsort(A_dijk[root], kind="stable")
    priority_values = A_dijk[root][priority_indices]

    return Skeleton(
        A=A.astype(np.float32),
        priority_values=priority_values.astype(np.float32),
        priority_indices=priority_indices.astype(np.int32),
        parents=parents.astype(np.int32),
    )
