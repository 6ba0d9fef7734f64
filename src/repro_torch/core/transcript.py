"""Fiat-Shamir transcript: a sponge over the Poseidon permutation.

PyTorch counterpart of ``repro.core.transcript`` (``Transcript`` and the
lane-batched ``BatchedTranscript``).  The sponge state stays on the device
between blocks, and every block goes through ``hashing.permute`` (the
kernel under the ``cuda`` backend); only squeezes copy lanes back to the
host.  Challenges are Fp4 elements (4 squeezed lanes) or query indices,
returned as numpy arrays.
"""
from __future__ import annotations

import numpy as np
import torch

from . import backend
from . import field as F
from . import hashing as H


class BatchedTranscript:
    """``lanes`` independent transcripts advanced in lockstep.

    Same-shaped proofs follow one absorb/squeeze schedule and differ only
    in the absorbed values, so their states form one (lanes, 16) tensor
    and each sponge block is one batched permutation.  Lane ``l``, fed lane
    ``l``'s values, runs exactly the state sequence of a solo transcript
    fed the same values, since the permutation is row-independent.
    """

    def __init__(self, label: str = "zkgraph", lanes: int = 1, device=None):
        # the backend and device every permutation of this sponge runs on
        self._pin = backend.resolve(None, device)
        self.device = self._pin[1]
        self.lanes = lanes
        self._state = torch.zeros((lanes, H.WIDTH), dtype=F.I64,
                                  device=self.device)
        data = label.encode()
        vals = np.frombuffer(data.ljust((len(data) + 3) // 4 * 4, b"\0"),
                             np.uint32)
        self.absorb_shared(vals % np.uint32(F.P))

    def _permute(self, states):
        with backend.use(*self._pin):
            return H.permute(states)

    # -- absorption ---------------------------------------------------------
    def absorb(self, values):
        """values: array-like or tensor reshapable to (lanes, m) field
        elements, lane ``l`` absorbing row ``l``; RATE lanes a block with a
        permutation after each."""
        if isinstance(values, torch.Tensor):
            vals = values.to(self.device, F.I64).reshape(self.lanes, -1) % F.P
        else:
            vals = F.tensor(np.asarray(values, np.uint64)
                            .reshape(self.lanes, -1), self.device)
        m = vals.shape[1]
        if m == 0:
            return
        # a short last block adds zeros to the remaining rate lanes, which
        # leaves them unchanged
        blocks = torch.zeros((self.lanes, -(-m // H.RATE) * H.RATE),
                             dtype=F.I64, device=self.device)
        blocks[:, :m] = vals
        for b in range(0, blocks.shape[1], H.RATE):
            st = torch.cat([F.fadd(self._state[:, :H.RATE],
                                   blocks[:, b:b + H.RATE]),
                            self._state[:, H.RATE:]], dim=1)
            self._state = self._permute(st)

    def absorb_shared(self, values):
        """Absorb the same flat values into every lane (circuit digests,
        labels: anything lane-independent)."""
        v = np.asarray(values, np.uint64).reshape(-1)
        self.absorb(np.broadcast_to(v, (self.lanes, v.size)))

    def absorb_digest(self, digests):
        """digests: (lanes, 8), one Merkle root per lane."""
        self.absorb(digests)

    # -- squeezing ----------------------------------------------------------
    def _squeeze_lanes(self, k: int) -> np.ndarray:
        out = []
        got = 0
        while got < k:
            out.append(self._state[:, :H.RATE].cpu().numpy())
            self._state = self._permute(self._state)
            got += H.RATE
        return np.concatenate(out, axis=1)[:, :k].astype(np.uint32)

    def challenge_ext(self) -> np.ndarray:
        """One Fp4 challenge per lane, shape (lanes, 4) uint32."""
        return self._squeeze_lanes(4)

    def challenge_indices(self, n: int, domain_size: int) -> np.ndarray:
        """(lanes, n) query indices in [0, domain_size) (power of two)."""
        lanes = self._squeeze_lanes(n)
        return (lanes % np.uint32(domain_size)).astype(np.int64)


class Transcript:
    """One transcript: the single lane of a :class:`BatchedTranscript`."""

    def __init__(self, label: str = "zkgraph", device=None):
        self._sponge = BatchedTranscript(label, 1, device)
        self.device = self._sponge.device

    def absorb(self, values):
        """values: array-like or tensor of field elements (flattened)."""
        self._sponge.absorb(values)

    def absorb_digest(self, digest):
        self._sponge.absorb(digest)

    def challenge_ext(self) -> np.ndarray:
        """One Fp4 challenge, shape (4,) uint32."""
        return self._sponge.challenge_ext()[0]

    def challenge_fp(self) -> int:
        return int(self._sponge._squeeze_lanes(1)[0, 0])

    def challenge_indices(self, n: int, domain_size: int) -> np.ndarray:
        """n query indices in [0, domain_size) (power of two)."""
        return self._sponge.challenge_indices(n, domain_size)[0]
