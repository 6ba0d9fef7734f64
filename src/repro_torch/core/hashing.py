"""Poseidon2-shaped permutation over BabyBear and the sponge built on it.

PyTorch counterpart of ``repro.core.hashing``.  The parameters are rebuilt
with numpy exactly as the reference builds them, so states, digests and
every challenge derived from them are bit-identical.

:func:`permute` dispatches through the active compute backend
(:mod:`repro_torch.core.backend`): ``cuda`` runs the hand-written kernel,
``torch`` runs :func:`permute_ref` below.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from . import backend
from . import field as F

WIDTH = 16          # state lanes
RATE = 8            # sponge rate (lanes absorbed/squeezed per block)
DIGEST = 8          # digest lanes
FULL_ROUNDS = 8     # 4 at start + 4 at end
PARTIAL_ROUNDS = 14
SBOX_DEG = 7        # gcd(7, p-1) = 1 -> permutation


@functools.lru_cache(maxsize=None)
def _params():
    """(mds (16,16), round_constants (n_rounds,16)) as numpy uint32."""
    # DFT-style matrix: M[i][j] = w^(i*j) with w a 16th root of unity.
    w = F.root_of_unity(WIDTH)
    mds = np.zeros((WIDTH, WIDTH), np.uint32)
    for i in range(WIDTH):
        for j in range(WIDTH):
            mds[i, j] = pow(w, i * j, F.P)
    rng = np.random.default_rng(20250713)
    n_rounds = FULL_ROUNDS + PARTIAL_ROUNDS
    rc = (rng.integers(0, F.P, size=(n_rounds, WIDTH), dtype=np.int64)).astype(np.uint32)
    return mds, rc


@functools.lru_cache(maxsize=None)
def _params_on(device: torch.device):
    mds, rc = _params()
    return (torch.from_numpy(mds.astype(np.int64)).to(device),
            torch.from_numpy(rc.astype(np.int64)).to(device))


def _sbox(x):
    x2 = F.fmul(x, x)
    x4 = F.fmul(x2, x2)
    x6 = F.fmul(x4, x2)
    return F.fmul(x6, x)


def _matmul_mod(state, mat):
    """(batch..., 16) x (16, 16) modular matmul: each product is reduced
    before the 16-term sum (16 * 2^31 < 2^36)."""
    prod = state[..., :, None] * mat % F.P
    return prod.sum(dim=-2) % F.P


def permute(state: torch.Tensor) -> torch.Tensor:
    """Apply the permutation to (..., 16) BabyBear states via the active
    backend (the backends are bit-identical)."""
    return backend.active().permute(state)


def permute_ref(state: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch permutation: 4 full rounds, 14 partial rounds
    (S-box on lane 0 only), 4 full rounds; x^7 S-box; 16x16 MDS."""
    mds, rc = _params_on(state.device)
    state = state.to(F.I64) % F.P
    half = FULL_ROUNDS // 2
    r = 0
    for _ in range(half):
        state = _sbox(F.fadd(state, rc[r]))
        state = _matmul_mod(state, mds)
        r += 1
    for _ in range(PARTIAL_ROUNDS):
        state = F.fadd(state, rc[r])
        state = torch.cat([_sbox(state[..., :1]), state[..., 1:]], dim=-1)
        state = _matmul_mod(state, mds)
        r += 1
    for _ in range(half):
        state = _sbox(F.fadd(state, rc[r]))
        state = _matmul_mod(state, mds)
        r += 1
    return state


def compress(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """2-to-1 compression for Merkle: (..., 8),(..., 8) -> (..., 8)."""
    return permute(torch.cat([left, right], dim=-1))[..., :DIGEST]


def hash_bytes(data: bytes, device=None) -> np.ndarray:
    """Sponge-hash a byte string -> (8,) uint32 BabyBear digest.

    3 bytes per lane little-endian, zero-padded to a multiple of 3, with two
    leading lanes carrying the byte length (docs/protocol.md §6).  Runs on
    ``device`` (default: the active backend's)."""
    data = bytes(data)
    n = len(data)
    pad = (-n) % 3
    chunks = np.frombuffer(data + b"\x00" * pad, np.uint8)
    chunks = chunks.reshape(-1, 3).astype(np.int64)
    lanes = chunks[:, 0] | (chunks[:, 1] << 8) | (chunks[:, 2] << 16)
    head = np.array([n & 0xFFFFFF, n >> 24], np.int64)
    with backend.use(None, device) as (_, device):
        row = F.tensor(np.concatenate([head, lanes])[None, :], device)
        return F.to_numpy(hash_rows(row)[0])


def hash_rows(rows: torch.Tensor) -> torch.Tensor:
    """Sponge-hash each row of (..., n, k) field elements -> (..., n, 8).

    k is zero-padded to a multiple of RATE; RATE lanes are absorbed per
    permutation, and lane 15 starts at the padded length."""
    *batch, n, k = rows.shape
    pad = (-k) % RATE
    if pad:
        rows = torch.cat([rows, rows.new_zeros(tuple(batch) + (n, pad))],
                         dim=-1)
        k += pad
    state = rows.new_zeros(tuple(batch) + (n, WIDTH))
    state[..., WIDTH - 1] = k % F.P
    for blk in range(k // RATE):
        chunk = rows[..., blk * RATE:(blk + 1) * RATE]
        state = torch.cat([F.fadd(state[..., :RATE], chunk),
                           state[..., RATE:]], dim=-1)
        state = permute(state)
    return state[..., :DIGEST]
