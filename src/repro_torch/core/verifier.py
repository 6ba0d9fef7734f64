"""Verifier for the DEEP-ALI + FRI PLONKish proofs.

PyTorch counterpart of ``repro.core.verifier``: replays the Fiat-Shamir
transcript, checks the constraint identity at the OOD point, recomputes the
DEEP composition at each FRI query from the Merkle openings, and checks the
FRI folds and degree bound.  Runs on the device the keys were made for.
"""
from __future__ import annotations

import numpy as np
import torch

from . import backend as be
from . import field as F
from . import fri as fri_mod
from . import merkle
from . import poly
from .plonkish import ADVICE, DATA, FIXED, INSTANCE
from .prover import (Keys, Proof, _row0_index, combine_constraints,
                     opening_schedule)
from .transcript import Transcript

BASIS = [np.eye(4, dtype=np.uint32)[c] for c in range(4)]


class _ScalarExtOps:
    """Base columns evaluated at z are Fp4 scalars: use ext arithmetic."""
    add = staticmethod(F.eadd)
    sub = staticmethod(F.esub)
    mul = staticmethod(F.emul)

    @staticmethod
    def const(v, like):
        out = torch.zeros(4, dtype=F.I64, device=like.device)
        out[0] = v % F.P
        return out


def verify(keys: Keys, instance_np: np.ndarray, proof: Proof,
           expected_data_root: np.ndarray = None,
           label: str = "zkgraph") -> bool:
    with be.use(keys.backend, keys.device):
        return _verify_impl(keys, instance_np, proof, expected_data_root,
                            label)


def _verify_impl(keys: Keys, instance_np, proof: Proof, expected_data_root,
                 label: str) -> bool:
    circuit, cfg = keys.circuit, keys.cfg
    dev = keys.device
    n, B = circuit.n_rows, cfg.blowup
    nl = n * B

    # the paper's "declared dataset" check: the proof must be rooted in the
    # published dataset commitment
    if expected_data_root is not None and \
            not np.array_equal(proof.data_root, np.asarray(expected_data_root)):
        return False

    inst = F.tensor(instance_np, dev) if circuit.n_instance \
        else torch.zeros((0, n), dtype=F.I64, device=dev)
    tx = Transcript(label, dev)
    tx.absorb(circuit.digest_seed())
    if circuit.n_instance:
        tx.absorb_digest(merkle.commit(inst.T).root)
    tx.absorb_digest(proof.data_root)
    tx.absorb_digest(proof.advice_root)
    alpha = F.tensor(tx.challenge_ext(), dev)
    beta = F.tensor(tx.challenge_ext(), dev)
    tx.absorb_digest(proof.ext_root)
    alpha_c = F.tensor(tx.challenge_ext(), dev)
    tx.absorb_digest(proof.quotient_root)
    z = F.tensor(tx.challenge_ext(), dev)

    # -- recompute public-poly openings, assemble the full opening table -----
    sched = opening_schedule(circuit, B)
    inst_coeffs = poly.intt(inst) if circuit.n_instance else inst
    w_n = F.root_of_unity(n)
    openings = dict(proof.openings)
    rots = sorted({r for (k, _, r) in sched if k in (FIXED, INSTANCE)})
    for rot in rots:
        zr = F.emul_fp(z, pow(w_n, rot, F.P))
        for kind, coeffs in ((FIXED, keys.fixed_coeffs), (INSTANCE, inst_coeffs)):
            idxs = [i for (k, i, rr) in sched if k == kind and rr == rot]
            if not idxs:
                continue
            vals = poly.eval_at_ext(coeffs[idxs], zr)
            for i, v in zip(idxs, F.to_numpy(vals)):
                openings[(kind, i, rot)] = v
    # transcript absorbs ALL openings in schedule order (must match prover)
    for key in sched:
        if key not in openings:
            return False
        tx.absorb(openings[key])
    opened = {k: F.tensor(v, dev) for k, v in openings.items()}
    basis = [F.tensor(b, dev) for b in BASIS]

    # -- constraint identity at z ---------------------------------------------
    def base_getter(kind, idx, rot):
        return opened[(kind, idx, rot)]

    def ext_getter(col, rot):
        acc = torch.zeros(4, dtype=F.I64, device=dev)
        for c in range(4):
            acc = F.eadd(acc, F.emul(basis[c], opened[("ext", col * 4 + c, rot)]))
        return acc

    like = torch.zeros(4, dtype=F.I64, device=dev)  # scalar ext template
    row0_val = (base_getter(FIXED, _row0_index(circuit), 0) if circuit.gps
                else like)
    c_at_z = combine_constraints(
        circuit, base_getter, ext_getter, alpha, beta, alpha_c,
        like, _ScalarExtOps, lambda v: v, row0_val)

    q_at_z = torch.zeros(4, dtype=F.I64, device=dev)
    z_pow_n = F.epow(z, n)
    zk = F.tensor(F.EXT_ONE, dev)
    for k in range(B):
        seg = torch.zeros(4, dtype=F.I64, device=dev)
        for c in range(4):
            seg = F.eadd(seg, F.emul(basis[c], opened[("quotient", k * 4 + c, 0)]))
        q_at_z = F.eadd(q_at_z, F.emul(zk, seg))
        zk = F.emul(zk, z_pow_n)
    zh_at_z = F.esub(z_pow_n, F.tensor(F.EXT_ONE, dev))
    if not torch.equal(c_at_z, F.emul(q_at_z, zh_at_z)):
        return False

    # -- DEEP + FRI -------------------------------------------------------------
    gamma = F.tensor(tx.challenge_ext(), dev)
    ok, q_idx, layer0, _ = fri_mod.fri_verify(proof.fri_proof, tx, cfg.fri(), nl)
    if not ok:
        return False
    lo, hi, pair_idx = layer0
    idx_all = np.concatenate([pair_idx, pair_idx + nl // 2])
    idx_dev = torch.from_numpy(idx_all).to(dev)

    # Merkle openings of committed trees at the queried rows
    col_counts = {"data": circuit.n_data, "advice": circuit.n_advice,
                  "ext": circuit.n_ext * 4, "quotient": B * 4}
    roots = {"data": proof.data_root, "advice": proof.advice_root,
             "ext": proof.ext_root, "quotient": proof.quotient_root}
    rowvals = {}
    for name in ("data", "advice", "ext", "quotient"):
        rows, paths = proof.tree_openings[name]
        if col_counts[name] == 0:
            continue
        if rows.shape[0] != len(idx_all) or rows.shape[1] != col_counts[name]:
            return False
        rows_t = F.tensor(rows, dev)
        if not merkle.verify_open(F.tensor(roots[name], dev), idx_dev, rows_t,
                                  F.tensor(paths, dev)):
            return False
        rowvals[name] = rows_t

    # recompute DEEP composition at each queried point
    committed = [(k, i, r) for (k, i, r) in sched
                 if k in (DATA, ADVICE, "ext", "quotient")]
    groups = {}
    for (k, i, r) in committed:
        groups.setdefault(r, []).append((k, i))
    pts = poly.domain_points(nl, cfg.shift, dev)[idx_dev]
    nq = len(idx_all)
    deep = torch.zeros((nq, 4), dtype=F.I64, device=dev)
    g_pow = gamma
    name_of = {DATA: "data", ADVICE: "advice", "ext": "ext",
               "quotient": "quotient"}
    for r in sorted(groups):
        zr = F.emul_fp(z, pow(w_n, r, F.P))
        inv_d = F.ebatch_inv(F.esub(F.ext(pts), zr.expand(nq, 4)))
        num = torch.zeros((nq, 4), dtype=F.I64, device=dev)
        for (k, i) in groups[r]:
            vals = rowvals[name_of[k]][:, i]
            diff = F.esub(F.ext(vals), opened[(k, i, r)].expand(nq, 4))
            num = F.eadd(num, F.emul(g_pow.expand(nq, 4), diff))
            g_pow = F.emul(g_pow, gamma)
        deep = F.eadd(deep, F.emul(num, inv_d))
    expect = np.concatenate([lo, hi], axis=0)
    return bool(np.array_equal(F.to_numpy(deep), expect))
