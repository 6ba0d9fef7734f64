"""Untrusted plain query engine: executes graph operations natively and
produces the results + auxiliary values the operators turn into witnesses.

This is the 'prover runs any exact algorithm' side of the paper (§IV-C): BFS
here, circuits verify. Everything is numpy/vectorized.

The port's own copy of ``repro.graphdb.engine`` (numpy only, unchanged).
"""
from __future__ import annotations

import numpy as np

from .storage import EdgeTable


def expand(t: EdgeTable, src_id: int):
    """Single-source expansion: all (src_id, dst) edges (paper §IV-A)."""
    mask = t.src == src_id
    return t.dst[mask], mask


def expand_set(t: EdgeTable, ids: np.ndarray):
    """Set-based expansion (paper §IV-B): all edges with src in ids."""
    mask = np.isin(t.src, ids)
    return t.src[mask], t.dst[mask], mask


def expand_undirected(t: EdgeTable, src_id: int):
    """Expansion over canonical bidirectional edges."""
    fwd = t.src == src_id
    bwd = t.dst == src_id
    return np.concatenate([t.dst[fwd], t.src[bwd]]), fwd, bwd


def bfs_sssp(t: EdgeTable, node_ids: np.ndarray, src_id: int,
             undirected: bool = True, d_max: int = None):
    """BFS distances + predecessors over the node universe.

    Returns (dist, pred, pred_dist) aligned with node_ids; unreachable nodes
    get d_max, pred 0.
    """
    n = len(node_ids)
    d_max = d_max if d_max is not None else n + 1
    idx_of = {int(v): i for i, v in enumerate(node_ids.tolist())}
    dist = np.full(n, d_max, np.int64)
    pred = np.zeros(n, np.int64)
    s_idx = idx_of[int(src_id)]
    dist[s_idx] = 0
    srcs = t.src if not undirected else np.concatenate([t.src, t.dst])
    dsts = t.dst if not undirected else np.concatenate([t.dst, t.src])
    src_i = np.asarray([idx_of.get(int(v), -1) for v in srcs])
    dst_i = np.asarray([idx_of.get(int(v), -1) for v in dsts])
    ok = (src_i >= 0) & (dst_i >= 0)
    src_i, dst_i = src_i[ok], dst_i[ok]
    frontier = np.asarray([s_idx])
    d = 0
    visited = np.zeros(n, bool)
    visited[s_idx] = True
    while len(frontier):
        on_f = np.isin(src_i, frontier)
        cand_dst = dst_i[on_f]
        cand_src = src_i[on_f]
        new_mask = ~visited[cand_dst]
        if not new_mask.any():
            break
        nd, ns = cand_dst[new_mask], cand_src[new_mask]
        uniq, first = np.unique(nd, return_index=True)
        dist[uniq] = d + 1
        pred[uniq] = node_ids[ns[first]]
        visited[uniq] = True
        frontier = uniq
        d += 1
    pred_dist = np.where(dist > 0, dist - 1, 0)
    pred_dist[dist == d_max] = 0
    return dist, pred, pred_dist


def top_k(values: np.ndarray, k: int, descending: bool = True):
    """Order-by + limit-k (paper §IV-E): returns (mask of selected, pivot)."""
    order = np.argsort(values, kind="stable")
    if descending:
        order = order[::-1]
    sel = np.zeros(len(values), bool)
    k = min(k, len(values))
    sel[order[:k]] = True
    pivot = int(values[order[k - 1]]) if k else 0
    return sel, pivot


def find_path(t: EdgeTable, node_ids: np.ndarray, s: int, tt: int,
              undirected: bool = True):
    """Any path s -> t as a node sequence (reachability witness, §IV-E)."""
    dist, pred, _ = bfs_sssp(t, node_ids, s, undirected)
    idx_of = {int(v): i for i, v in enumerate(node_ids.tolist())}
    if tt not in idx_of or dist[idx_of[tt]] >= len(node_ids) + 1:
        return None
    path = [tt]
    cur = tt
    while cur != s:
        cur = int(pred[idx_of[cur]])
        path.append(cur)
    return np.asarray(path[::-1], np.int64)
