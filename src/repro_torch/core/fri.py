"""FRI low-degree argument over Fp4 codewords.

PyTorch counterpart of ``repro.core.fri`` (the solo prover and verifier).
Codewords live on a multiplicative coset ``shift * H_N`` in *natural* order,
so the fold pairs are (i, i + N/2):  -x_i = x_{i+N/2}.

    fold(f)[i] = (f(x) + f(-x))/2 + beta * (f(x) - f(-x)) / (2 x)

Each committed layer stores leaf i = concat(f[i], f[i + N/2]) (8 lanes).
Codewords stay on the device; the proof's fields are host numpy arrays.
:func:`fri_prove_lanes` proves L same-length codewords in lockstep.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import field as F
from . import merkle
from . import poly
from .transcript import Transcript

_INV2 = pow(2, F.P - 2, F.P)


@dataclass(frozen=True)
class FriConfig:
    blowup: int = 4          # LDE rate 1/blowup
    n_queries: int = 32
    final_size: int = 32     # stop folding at this codeword length
    shift: int = poly.COSET_SHIFT


@dataclass
class FriProof:
    layer_roots: list          # np (8,) per committed layer
    final_codeword: np.ndarray  # (final_size, 4)
    query_indices: np.ndarray   # (q,) indices into [0, N/2)
    layer_openings: list       # per layer: (rows (q,8), paths (q,depth,8))

    def size_fields(self) -> int:
        """Proof size in field elements."""
        total = len(self.layer_roots) * 8 + self.final_codeword.size
        for rows, paths in self.layer_openings:
            total += int(np.prod(rows.shape)) + int(np.prod(paths.shape))
        return total

    def to_bytes(self) -> bytes:
        from . import wire
        return wire.encode_fri_proof(self)

    @staticmethod
    def from_bytes(raw: bytes) -> "FriProof":
        from . import wire
        return wire.decode_fri_proof(raw)


def _inv_points(n: int, shift: int, device) -> torch.Tensor:
    """x_i^-1 = shift^-1 * w^-i for the first half of shift * H_n."""
    w_inv = pow(F.root_of_unity(n), F.P - 2, F.P)
    s_inv = pow(shift, F.P - 2, F.P)
    return F.fmul(F.powers(w_inv, n // 2, device), s_inv)


def _fold(codeword: torch.Tensor, beta: torch.Tensor, shift: int) -> torch.Tensor:
    """One FRI fold of an Fp4 codeword (N,4) on coset shift*H_N -> (N/2,4)."""
    n = codeword.shape[0]
    half = n // 2
    lo, hi = codeword[:half], codeword[half:]
    inv_pts = _inv_points(n, shift, codeword.device)
    even = F.emul_fp(F.eadd(lo, hi), _INV2)
    odd = F.emul_fp(F.esub(lo, hi), F.fmul(inv_pts, _INV2))
    return F.eadd(even, F.emul(beta.expand(odd.shape), odd))


def _layer_leaves(codeword: torch.Tensor) -> torch.Tensor:
    n = codeword.shape[0]
    return torch.cat([codeword[: n // 2], codeword[n // 2:]], dim=-1)  # (N/2, 8)


def fri_prove(codeword: torch.Tensor, tx: Transcript, cfg: FriConfig) -> FriProof:
    """codeword: (N, 4) Fp4 evals on cfg.shift * H_N."""
    n = codeword.shape[0]
    dev = codeword.device
    trees = []
    roots = []
    words = []
    shift = cfg.shift
    cur = codeword
    while cur.shape[0] > cfg.final_size:
        tree = merkle.commit(_layer_leaves(cur))
        trees.append(tree)
        words.append(cur)
        roots.append(F.to_numpy(tree.root))
        tx.absorb_digest(tree.root)
        beta = F.tensor(tx.challenge_ext(), dev)
        cur = _fold(cur, beta, shift)
        shift = shift * shift % F.P
    final_codeword = F.to_numpy(cur)
    tx.absorb(cur.reshape(-1))

    q_idx = tx.challenge_indices(cfg.n_queries, n // 2)
    openings = []
    idx = torch.from_numpy(q_idx).to(dev)
    for tree, word in zip(trees, words):
        half = word.shape[0] // 2
        idx = idx % half
        rows, paths = merkle.open_at(tree, idx)
        openings.append((F.to_numpy(rows), F.to_numpy(paths)))
    return FriProof(roots, final_codeword, q_idx, openings)


# ---------------------------------------------------------------------------
# lane-batched proving (prover_batch): L same-length codewords fold, commit
# and open in lockstep with per-lane challenges.  Lane l's FriProof equals
# ``fri_prove(codewords[l], solo_tx, cfg)`` when the transcripts agree:
# every op is the solo op with a leading lane dim.
# ---------------------------------------------------------------------------
def _fold_lanes(codewords: torch.Tensor, beta: torch.Tensor,
                shift: int) -> torch.Tensor:
    """One fold of (L, N, 4) codewords with per-lane betas (L, 4)."""
    half = codewords.shape[1] // 2
    lo, hi = codewords[:, :half], codewords[:, half:]
    inv_pts = _inv_points(codewords.shape[1], shift, codewords.device)
    even = F.emul_fp(F.eadd(lo, hi), _INV2)
    odd = F.emul_fp(F.esub(lo, hi), F.fmul(inv_pts, _INV2))
    return F.eadd(even, F.emul(beta[:, None, :].expand(odd.shape), odd))


def fri_prove_lanes(codewords: torch.Tensor, btx, cfg: FriConfig) -> list:
    """codewords: (L, N, 4) on cfg.shift * H_N; ``btx`` a
    :class:`~repro_torch.core.transcript.BatchedTranscript` of L lanes.
    Returns one :class:`FriProof` per lane."""
    lanes, n = codewords.shape[0], codewords.shape[1]
    dev = codewords.device
    trees = []
    roots = []                 # per committed layer: (L, 8) np
    words = []
    shift = cfg.shift
    cur = codewords
    while cur.shape[1] > cfg.final_size:
        half = cur.shape[1] // 2
        tree = merkle.commit_lanes(torch.cat([cur[:, :half], cur[:, half:]],
                                             dim=-1))
        trees.append(tree)
        words.append(cur)
        roots.append(F.to_numpy(tree.roots))
        btx.absorb_digest(tree.roots)
        beta = F.tensor(btx.challenge_ext(), dev)       # (L, 4)
        cur = _fold_lanes(cur, beta, shift)
        shift = shift * shift % F.P
    final_codewords = F.to_numpy(cur)                   # (L, final, 4)
    btx.absorb(cur.reshape(lanes, -1))

    q_idx = btx.challenge_indices(cfg.n_queries, n // 2)   # (L, q)
    openings = []              # per layer: (rows (L,q,8), paths (L,q,d,8))
    idx = torch.from_numpy(q_idx).to(dev)
    for tree, word in zip(trees, words):
        idx = idx % (word.shape[1] // 2)
        rows, paths = merkle.open_lanes(tree, idx)
        openings.append((F.to_numpy(rows), F.to_numpy(paths)))
    return [
        FriProof([r[l] for r in roots], final_codewords[l], q_idx[l],
                 [(rows[l], paths[l]) for rows, paths in openings])
        for l in range(lanes)]


def fri_verify(proof: FriProof, tx: Transcript, cfg: FriConfig, n: int):
    """Replay the transcript and check folds/paths/degree.

    Returns (ok, query_indices (q,), layer0 (lo (q,4), hi (q,4), idx), None)
    where layer0 holds the opened evaluations of the first codeword at
    indices ``q_idx`` and ``q_idx + n/2`` — the caller checks them against
    the DEEP composition recomputed from the trace openings.
    """
    dev = tx.device
    betas = []
    for root in proof.layer_roots:
        tx.absorb_digest(np.asarray(root))
        betas.append(F.tensor(tx.challenge_ext(), dev))
    tx.absorb(np.asarray(proof.final_codeword).reshape(-1))
    q_idx = tx.challenge_indices(cfg.n_queries, n // 2)
    if not np.array_equal(q_idx, proof.query_indices):
        return False, q_idx, None, None

    ok = True
    shift = cfg.shift
    size = n
    idx = torch.from_numpy(q_idx).to(dev)
    prev_fold = None          # expected folded value at current layer index
    prev_idx = None
    layer0 = None
    for li, (root, (rows, paths)) in enumerate(zip(proof.layer_roots,
                                                   proof.layer_openings)):
        half = size // 2
        idx = idx % half
        rows = F.tensor(rows, dev)
        ok &= merkle.verify_open(F.tensor(root, dev), idx, rows,
                                 F.tensor(paths, dev))
        lo, hi = rows[:, :4], rows[:, 4:]
        if li == 0:
            layer0 = (F.to_numpy(lo), F.to_numpy(hi), idx.cpu().numpy())
        if prev_fold is not None:
            # the folded value from the previous layer must appear at slot
            # lo/hi depending on whether prev index < half
            pick_hi = (prev_idx >= half)[:, None]
            expect = torch.where(pick_hi, hi, lo)
            ok &= bool((expect == prev_fold).all())
        # fold to next layer
        x_inv = F.finv(F.fmul(poly.domain_points(size, 1, dev)[idx], shift))
        even = F.emul_fp(F.eadd(lo, hi), _INV2)
        odd = F.emul_fp(F.esub(lo, hi), F.fmul(x_inv, _INV2))
        prev_fold = F.eadd(even, F.emul(betas[li].expand(odd.shape), odd))
        prev_idx = idx
        shift = shift * shift % F.P
        size = half
    # final layer: folded values must match the plain codeword
    final = F.tensor(proof.final_codeword, dev)
    if prev_fold is not None:
        ok &= bool((final[prev_idx % size] == prev_fold).all())
    # degree check on the final codeword: interpolate on coset shift*H_size
    deg_bound = max(size // cfg.blowup, 1)
    w_inv = pow(F.root_of_unity(size), F.P - 2, F.P)
    s_inv = pow(shift, F.P - 2, F.P)
    n_inv = pow(size, F.P - 2, F.P)
    ij = np.outer(np.arange(size), np.arange(size))
    wm = F.tensor(np.vectorize(lambda e: pow(w_inv, int(e), F.P))(ij)
                  .astype(np.int64), dev)
    # c_j = n^{-1} s^{-j} sum_i v_i w^{-ij}
    sums = (final[:, None, :] * wm[:, :, None] % F.P).sum(dim=0) % F.P
    sj = F.tensor([pow(s_inv, j, F.P) * n_inv % F.P for j in range(size)], dev)
    coeffs = F.fmul(sums, sj[:, None])
    ok &= bool((coeffs[deg_bound:] == 0).all())
    return ok, q_idx, layer0, None

