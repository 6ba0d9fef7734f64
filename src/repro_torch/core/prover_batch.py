"""Lane-batched DEEP-ALI + FRI prover: L same-shaped witnesses, one pass.

PyTorch counterpart of ``repro.core.prover_batch``.  Same-shaped steps of
different queries follow one Fiat-Shamir schedule and differ only in the
absorbed values, so their witnesses stack behind a leading lane axis ``L``
and every phase (NTT/LDE, Merkle levels, sponge blocks, constraint
evaluation, FRI folds) runs as one batched launch for all lanes.

This is the port's one prover body: the solo ``prover.prove`` is its
one-lane case.  Lane ``l`` of :func:`prove_batch` gives a
:class:`~.prover.Proof` whose wire bytes equal those of
``prove(keys, *witnesses[l])`` (timings aside): every op takes a leading
lane dim, all field ops are exact, hashing and the NTT are row-independent,
and the lanes' challenge streams never mix
(:class:`~.transcript.BatchedTranscript`).

Layout conventions (one-lane shape -> lane shape):
  witness columns   (c, n)     -> (L, c, n)
  LDE matrices      (c, nl)    -> (L, c, nl)
  ext/Fp4 values    (n, 4)     -> (L, n, 4)
  challenges        (4,)       -> (L, 4), passed as (L, 1, 4) to
                                  ``prover.build_ext_columns`` and
                                  ``combine_constraints``, which broadcast
  Merkle digests    (8,)       -> (L, 8)
"""
from __future__ import annotations

import time

import numpy as np
import torch

from . import backend as be
from . import field as F
from . import fri as fri_mod
from . import merkle
from . import poly
from . import prover as pv
from .plonkish import ADVICE, DATA, FIXED, INSTANCE, BaseOps
from .transcript import BatchedTranscript

__all__ = ["prove_batch"]


def prove_batch(keys: pv.Keys, witnesses: list, label: str = "zkgraph",
                placement=None) -> list:
    """Prove L same-shaped witnesses as one lane-batched pass.

    ``witnesses``: list of ``(advice_np, instance_np, data_np)`` triples,
    all for ``keys.circuit``.  Returns one :class:`~.prover.Proof` per lane,
    wire-byte-identical (timings aside) to ``prover.prove(keys, ...)`` of
    that lane.  Runs under ``keys.backend`` on ``keys.device``.
    ``placement`` exists only to match ``repro.core.prover_batch``'s
    signature, where it is a JAX mesh placement of the lane axis; the port
    has no counterpart yet, so only ``None`` (everything on the keys'
    device) is accepted.
    """
    if placement is not None:
        raise NotImplementedError(
            "prove_batch: lane placement across devices is not ported "
            "(ROADMAP Queue 1 item 11, serving); pass placement=None")
    with be.use(keys.backend, keys.device):
        return _prove_batch_impl(keys, witnesses, label)


def _prove_batch_impl(keys: pv.Keys, witnesses: list, label: str) -> list:
    circuit, cfg = keys.circuit, keys.cfg
    dev = keys.device
    n, B = circuit.n_rows, cfg.blowup
    nl = n * B
    lanes = len(witnesses)
    assert lanes >= 1, "prove_batch needs at least one lane"
    t0 = time.perf_counter()
    timings = {}

    adv_list, inst_list, data_list = [], [], []
    for advice_np, instance_np, data_np in witnesses:
        if data_np is None:
            data_np = np.zeros((0, n), np.uint32)
        pv.auto_multiplicities(circuit, data_np, advice_np, instance_np)
        adv_list.append(advice_np)
        inst_list.append(instance_np)
        data_list.append(data_np)

    def stack(arrs, count):
        if count == 0:
            return torch.zeros((lanes, 0, n), dtype=F.I64, device=dev)
        return F.tensor(np.stack([np.asarray(a, np.int64) for a in arrs]),
                        dev)

    advice = stack(adv_list, circuit.n_advice)             # (L, n_adv, n)
    data = stack(data_list, circuit.n_data)
    inst = stack(inst_list, circuit.n_instance)

    btx = BatchedTranscript(label, lanes, dev)
    btx.absorb_shared(circuit.digest_seed())
    if circuit.n_instance:
        btx.absorb_digest(merkle.commit_lanes(inst.transpose(1, 2)).roots)

    zero_roots = np.zeros((lanes, 8), np.uint32)

    # --- phase 0: commit the dataset (the declared-DB binding) --------------
    data_coeffs = poly.intt(data) if circuit.n_data else data
    data_lde = pv._lde(data, B, cfg.shift)
    data_tree = merkle.commit_lanes(data_lde.transpose(1, 2)) \
        if circuit.n_data else None
    data_roots = F.to_numpy(data_tree.roots) if data_tree else zero_roots
    btx.absorb_digest(data_roots)

    # --- phase 1: commit advice -------------------------------------------
    adv_coeffs = poly.intt(advice) if circuit.n_advice else advice
    adv_lde = pv._lde(advice, B, cfg.shift)
    adv_tree = merkle.commit_lanes(adv_lde.transpose(1, 2)) \
        if circuit.n_advice else None
    adv_roots = F.to_numpy(adv_tree.roots) if adv_tree else zero_roots
    btx.absorb_digest(adv_roots)
    timings["commit_advice"] = time.perf_counter() - t0

    alpha = F.tensor(btx.challenge_ext(), dev)             # (L, 4)
    beta = F.tensor(btx.challenge_ext(), dev)

    # --- phase 2: ext columns ----------------------------------------------
    t1 = time.perf_counter()
    fixed_n = F.tensor(np.stack(circuit.fixed_cols) if circuit.fixed_cols
                       else np.zeros((0, n), np.int64), dev)
    fixed_n_lanes = fixed_n.expand((lanes,) + tuple(fixed_n.shape))

    def getter_n(kind, idx, rot):
        src = {FIXED: fixed_n_lanes, ADVICE: advice, INSTANCE: inst,
               DATA: data}[kind]
        return torch.roll(src[:, idx], -rot, dims=-1)

    like_n = torch.zeros((lanes, n), dtype=F.I64, device=dev)
    # (L, 1, 4) challenges broadcast against the (L, n, 4) lane values
    ext_cols = pv.build_ext_columns(circuit, getter_n, like_n, alpha[:, None],
                                    beta[:, None])
    n_ext = circuit.n_ext
    ext_base = ext_cols.permute(0, 1, 3, 2).reshape(lanes, n_ext * 4, n) \
        if n_ext else torch.zeros((lanes, 0, n), dtype=F.I64, device=dev)
    ext_coeffs = poly.intt(ext_base) if n_ext else ext_base
    ext_lde = pv._lde(ext_base, B, cfg.shift)
    ext_tree = merkle.commit_lanes(ext_lde.transpose(1, 2)) if n_ext else None
    ext_roots = F.to_numpy(ext_tree.roots) if ext_tree else zero_roots
    btx.absorb_digest(ext_roots)
    timings["phase2_ext"] = time.perf_counter() - t1

    alpha_c = F.tensor(btx.challenge_ext(), dev)

    # --- quotient -----------------------------------------------------------
    t2 = time.perf_counter()
    fixed_lde = keys.fixed_lde.expand((lanes,) + tuple(keys.fixed_lde.shape))
    inst_lde = pv._lde(inst, B, cfg.shift)

    def getter_lde(kind, idx, rot):
        src = {FIXED: fixed_lde, ADVICE: adv_lde, INSTANCE: inst_lde,
               DATA: data_lde}[kind]
        return torch.roll(src[:, idx], -B * rot, dims=-1)

    def ext_getter_lde(col, rot):
        comps = [torch.roll(ext_lde[:, col * 4 + c], -B * rot, dims=-1)
                 for c in range(4)]
        return torch.stack(comps, dim=-1)

    like_lde = torch.zeros((lanes, nl), dtype=F.I64, device=dev)
    row0_lde = (getter_lde(FIXED, pv._row0_index(circuit), 0)
                if circuit.gps else like_lde)
    c_lde = pv.combine_constraints(circuit, getter_lde, ext_getter_lde,
                                   alpha[:, None], beta[:, None],
                                   alpha_c[:, None], like_lde, BaseOps, F.ext,
                                   row0_lde)
    # Z_H(x_i) = x_i^N - 1 = shift^N * (w_nl^N)^i - 1: period-B sequence in i,
    # the same for every lane
    wn = F.root_of_unity(nl)
    ratio = pow(wn, n, F.P)
    zh_inv = []
    acc = pow(cfg.shift, n, F.P)
    for _ in range(B):
        zh_inv.append(pow((acc - 1) % F.P, F.P - 2, F.P))
        acc = acc * ratio % F.P
    zh_inv = F.tensor(zh_inv, dev).repeat(n)
    q_evals = F.fmul(c_lde, zh_inv[None, :, None])
    q_coeffs = poly.coset_coeffs(q_evals.transpose(1, 2), cfg.shift)
    q_segments = q_coeffs.reshape(lanes, 4, B, n) \
        .permute(0, 2, 1, 3).reshape(lanes, B * 4, n)
    q_lde = pv._lde_from_coeffs(q_segments, B, cfg.shift)
    q_tree = merkle.commit_lanes(q_lde.transpose(1, 2))
    q_roots = F.to_numpy(q_tree.roots)
    btx.absorb_digest(q_roots)
    timings["quotient"] = time.perf_counter() - t2

    # --- OOD openings --------------------------------------------------------
    t3 = time.perf_counter()
    z = F.tensor(btx.challenge_ext(), dev)                 # (L, 4)
    sched = pv.opening_schedule(circuit, B)
    coeff_src = {FIXED: keys.fixed_coeffs.expand(
                     (lanes,) + tuple(keys.fixed_coeffs.shape)),
                 INSTANCE: poly.intt(inst) if circuit.n_instance else inst,
                 DATA: data_coeffs, ADVICE: adv_coeffs, "ext": ext_coeffs,
                 "quotient": q_segments}
    w_n = F.root_of_unity(n)
    openings = {}              # (kind, i, rot) -> (L, 4) np
    rots = sorted({r for (_, _, r) in sched})
    for rot in rots:
        zr = F.emul_fp(z, pow(w_n, rot, F.P))
        for kind in (FIXED, INSTANCE, DATA, ADVICE, "ext", "quotient"):
            idxs = [i for (k, i, rr) in sched if k == kind and rr == rot]
            if not idxs:
                continue
            vals = F.to_numpy(poly.eval_at_ext(coeff_src[kind][:, idxs],
                                               zr))        # (L, m, 4)
            for j, i in enumerate(idxs):
                openings[(kind, i, rot)] = vals[:, j]
    for key in sched:
        btx.absorb(openings[key])
    timings["ood_openings"] = time.perf_counter() - t3

    # --- DEEP composition -----------------------------------------------------
    t4 = time.perf_counter()
    gamma = F.tensor(btx.challenge_ext(), dev)
    pts_ext = F.ext(poly.domain_points(nl, cfg.shift, dev))   # (nl, 4)
    committed = [(k, i, r) for (k, i, r) in sched
                 if k in (DATA, ADVICE, "ext", "quotient")]
    lde_src = {DATA: data_lde, ADVICE: adv_lde, "ext": ext_lde,
               "quotient": q_lde}
    deep = torch.zeros((lanes, nl, 4), dtype=F.I64, device=dev)
    g_pow = gamma
    groups = {}
    for (k, i, r) in committed:
        groups.setdefault(r, []).append((k, i))
    for r in sorted(groups):
        zr = F.emul_fp(z, pow(w_n, r, F.P))
        inv_d = F.ebatch_inv(F.esub(pts_ext[None], zr[:, None, :]))
        num = torch.zeros((lanes, nl, 4), dtype=F.I64, device=dev)
        for (k, i) in groups[r]:
            diff = F.esub(F.ext(lde_src[k][:, i]),
                          F.tensor(openings[(k, i, r)], dev)[:, None, :])
            num = F.eadd(num, F.emul(g_pow[:, None, :].expand(lanes, nl, 4),
                                     diff))
            g_pow = F.emul(g_pow, gamma)
        deep = F.eadd(deep, F.emul(num, inv_d))
    timings["deep"] = time.perf_counter() - t4

    # --- FRI -------------------------------------------------------------------
    t5 = time.perf_counter()
    fproofs = fri_mod.fri_prove_lanes(deep, btx, cfg.fri())
    timings["fri"] = time.perf_counter() - t5

    # --- query openings ---------------------------------------------------------
    q_idx = torch.from_numpy(np.stack([fp.query_indices for fp in fproofs])) \
        .to(dev)
    idx_all = torch.cat([q_idx, q_idx + nl // 2], dim=1)
    n_open = idx_all.shape[1]
    tree_rows = {}             # name -> (rows (L,k,w), paths (L,k,d,8)) np
    for name, tree in (("data", data_tree), ("advice", adv_tree),
                       ("ext", ext_tree), ("quotient", q_tree)):
        if tree is None:
            tree_rows[name] = (np.zeros((lanes, n_open, 0), np.uint32),
                               np.zeros((lanes, n_open, 0, 8), np.uint32))
        else:
            rows, paths = merkle.open_lanes(tree, idx_all)
            tree_rows[name] = (F.to_numpy(rows), F.to_numpy(paths))
    timings["total"] = time.perf_counter() - t0

    # --- per-lane Proof assembly ---------------------------------------------
    proofs = []
    for l in range(lanes):
        sent = {k: v[l] for k, v in openings.items()
                if k[0] in (DATA, ADVICE, "ext", "quotient")}
        tree_openings = {name: (rows[l], paths[l])
                         for name, (rows, paths) in tree_rows.items()}
        proofs.append(pv.Proof(data_roots[l], adv_roots[l], ext_roots[l],
                               q_roots[l], sent, fproofs[l], tree_openings,
                               dict(timings)))
    return proofs
