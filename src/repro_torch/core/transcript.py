"""Fiat-Shamir transcript: a sponge over the Poseidon permutation.

PyTorch counterpart of ``repro.core.transcript.Transcript``.  The sponge
state stays on the device between blocks, and every block goes through
``hashing.permute`` (the kernel under the ``cuda`` backend); only squeezes
copy lanes back to the host.  Challenges are Fp4 elements (4 squeezed
lanes) or query indices, returned as numpy arrays.
"""
from __future__ import annotations

import numpy as np
import torch

from . import backend
from . import field as F
from . import hashing as H


class Transcript:
    def __init__(self, label: str = "zkgraph", device=None):
        # the backend and device every permutation of this sponge runs on
        self._pin = backend.resolve(None, device)
        self.device = self._pin[1]
        self._state = torch.zeros(H.WIDTH, dtype=F.I64, device=self.device)
        self.absorb_bytes(label.encode())

    def _permute(self, state):
        with backend.use(*self._pin):
            return H.permute(state[None])[0]

    # -- absorption ---------------------------------------------------------
    def absorb_bytes(self, data: bytes):
        vals = np.frombuffer(data.ljust((len(data) + 3) // 4 * 4, b"\0"), np.uint32)
        self.absorb(vals % np.uint32(F.P))

    def absorb(self, values):
        """values: array-like or tensor of field elements (flattened),
        absorbed RATE lanes per block with a permutation after each."""
        if isinstance(values, torch.Tensor):
            vals = values.to(self.device, F.I64).reshape(-1) % F.P
        else:
            vals = F.tensor(np.asarray(values, np.uint64).reshape(-1),
                            self.device)
        n = vals.numel()
        if n == 0:
            return
        # a short last block adds zeros to the remaining rate lanes, which
        # leaves them unchanged
        blocks = torch.zeros(-(-n // H.RATE) * H.RATE, dtype=F.I64,
                             device=self.device)
        blocks[:n] = vals
        for blk in blocks.reshape(-1, H.RATE):
            st = torch.cat([F.fadd(self._state[:H.RATE], blk),
                            self._state[H.RATE:]])
            self._state = self._permute(st)

    def absorb_digest(self, digest):
        self.absorb(digest)

    # -- squeezing ----------------------------------------------------------
    def _squeeze_lanes(self, k: int) -> np.ndarray:
        out = []
        while len(out) < k:
            out.extend(self._state[:H.RATE].tolist())
            self._state = self._permute(self._state)
        return np.asarray(out[:k], np.uint32)

    def challenge_ext(self) -> np.ndarray:
        """One Fp4 challenge, shape (4,) uint32."""
        return self._squeeze_lanes(4)

    def challenge_fp(self) -> int:
        return int(self._squeeze_lanes(1)[0])

    def challenge_indices(self, n: int, domain_size: int) -> np.ndarray:
        """n query indices in [0, domain_size) (power of two)."""
        lanes = self._squeeze_lanes(n)
        return (lanes % np.uint32(domain_size)).astype(np.int64)
