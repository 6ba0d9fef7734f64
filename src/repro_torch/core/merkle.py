"""Merkle tree over BabyBear rows (Poseidon compression).

PyTorch counterpart of ``repro.core.merkle``: leaf i hashes row i, internal
nodes use 2-to-1 compression, and every layer stays on the device as one
tensor.  Each level is one batched permutation (the kernel under the
``cuda`` backend); the lane-batched trees (:func:`commit_lanes`) hash the
level of every lane in that same one launch.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import backend
from . import field as F
from . import hashing as H


@dataclass
class MerkleTree:
    leaves: torch.Tensor         # (n, width) committed rows
    layers: list                 # [(n,8), (n/2,8), ..., (1,8)]

    @property
    def root(self) -> torch.Tensor:
        return self.layers[-1][0]


def commit(rows: torch.Tensor) -> MerkleTree:
    """rows: (n, width) with n a power of two."""
    n = rows.shape[0]
    assert n & (n - 1) == 0, "leaf count must be a power of two"
    layer = H.hash_rows(rows)                       # (n, 8)
    layers = [layer]
    while layer.shape[0] > 1:
        layer = H.compress(layer[0::2], layer[1::2])
        layers.append(layer)
    return MerkleTree(leaves=rows, layers=layers)


def open_at(tree: MerkleTree, indices: torch.Tensor):
    """Open leaves at ``indices`` (k,). Returns (rows (k,width), path (k,d,8))."""
    rows = tree.leaves[indices]
    sibs = []
    idx = indices
    for layer in tree.layers[:-1]:
        sibs.append(layer[idx ^ 1])
        idx = idx // 2
    path = torch.stack(sibs, dim=1) if sibs else \
        rows.new_zeros((len(indices), 0, 8))
    return rows, path


# ---------------------------------------------------------------------------
# lane-batched trees (prover_batch): L same-shaped commitments in one pass.
# ``hash_rows``/``compress`` take leading batch dims and every hash is
# row-independent, so lane l of the batched tree equals ``commit(rows[l])``.
# ---------------------------------------------------------------------------
@dataclass
class BatchedMerkleTree:
    leaves: torch.Tensor         # (L, n, width) committed rows
    layers: list                 # [(L,n,8), (L,n/2,8), ..., (L,1,8)]

    @property
    def roots(self) -> torch.Tensor:
        return self.layers[-1][:, 0]                    # (L, 8)


def commit_lanes(rows: torch.Tensor) -> BatchedMerkleTree:
    """rows: (L, n, width) with n a power of two: L trees in lockstep."""
    n = rows.shape[1]
    assert n & (n - 1) == 0, "leaf count must be a power of two"
    layer = H.hash_rows(rows)                           # (L, n, 8)
    layers = [layer]
    while layer.shape[1] > 1:
        layer = H.compress(layer[:, 0::2], layer[:, 1::2])
        layers.append(layer)
    return BatchedMerkleTree(leaves=rows, layers=layers)


def open_lanes(tree: BatchedMerkleTree, indices: torch.Tensor):
    """Open per-lane leaves at ``indices`` (L, k).  Returns (rows (L,k,width),
    path (L,k,d,8)); lane l equals ``open_at(tree_l, indices[l])``."""
    def take(t, idx):
        return torch.gather(t, 1, idx[:, :, None].expand(-1, -1, t.shape[2]))

    idx = indices
    rows = take(tree.leaves, idx)
    sibs = []
    for layer in tree.layers[:-1]:
        sibs.append(take(layer, idx ^ 1))
        idx = idx // 2
    path = torch.stack(sibs, dim=2) if sibs else \
        rows.new_zeros(tuple(idx.shape) + (0, 8))
    return rows, path


def compress_pair(left, right, device=None) -> np.ndarray:
    """Host-facing 2-to-1 node hash: (8,), (8,) -> (8,) uint32."""
    with backend.use(None, device) as (_, device):
        l = F.tensor(np.asarray(left).reshape(1, 8), device)
        r = F.tensor(np.asarray(right).reshape(1, 8), device)
        return F.to_numpy(H.compress(l, r)[0])


def verify_open(root, indices, rows, path) -> bool:
    """Vectorized path check: True when every opening hashes to ``root``.
    All arguments are tensors on one device."""
    node = H.hash_rows(rows)                       # (k, 8)
    idx = indices
    for d in range(path.shape[1]):
        sib = path[:, d]
        is_right = (idx & 1).bool()[:, None]
        left = torch.where(is_right, sib, node)
        right = torch.where(is_right, node, sib)
        node = H.compress(left, right)
        idx = idx // 2
    return bool((node == root[None, :]).all())
