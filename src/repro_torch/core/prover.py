"""DEEP-ALI + FRI prover for PLONKish circuits.

PyTorch counterpart of ``repro.core.prover``.  Pipeline (paper §III-B):
  witness finalize -> commit phase-1 advice -> draw alpha, beta (Eq. (1)
  tuple compression + bus denominators) -> build phase-2 ext columns (logUp
  running sums) -> commit -> combine constraints -> quotient -> OOD
  openings at z -> DEEP composition -> FRI -> query openings.

Witnesses arrive as host numpy arrays; every column, LDE, tree and
codeword of the proof lives on the device the keys were made for, and the
:class:`Proof` holds host numpy arrays again.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field as dc_field

import numpy as np
import torch

from . import backend as be
from . import field as F
from . import fri as fri_mod
from . import merkle
from . import poly
from .plonkish import (ADVICE, DATA, FIXED, INSTANCE, BaseOps, Circuit,
                       eval_expr)
from .transcript import Transcript


@dataclass(frozen=True)
class ProverConfig:
    blowup: int = 4
    n_queries: int = 32
    fri_final_size: int = 32
    shift: int = poly.COSET_SHIFT
    # compute backend and device for keygen/prove (repro_torch.core.backend);
    # None = ambient selection (ZKGRAPH_TORCH_BACKEND, default "cuda" on
    # cuda:0).  compare=False: execution policy, never serialized, never
    # part of cfg equality or proof acceptance.
    backend: str = dc_field(default=None, compare=False)
    device: str = dc_field(default=None, compare=False)

    def fri(self) -> fri_mod.FriConfig:
        return fri_mod.FriConfig(self.blowup, self.n_queries,
                                 self.fri_final_size, self.shift)


@dataclass
class Keys:
    """PK/VK: fixed-column coefficient/LDE caches."""
    circuit: Circuit
    cfg: ProverConfig
    fixed_coeffs: torch.Tensor    # (n_fixed, N)
    fixed_lde: torch.Tensor       # (n_fixed, N*blowup)
    backend: str = "cuda"         # resolved backend keygen ran under
    device: torch.device = None   # device the caches live on


@dataclass
class Proof:
    data_root: np.ndarray
    advice_root: np.ndarray
    ext_root: np.ndarray
    quotient_root: np.ndarray
    openings: dict                 # (kind, idx, rot) -> np (4,) for committed kinds
    fri_proof: fri_mod.FriProof
    tree_openings: dict            # tree name -> (rows, paths) at [q, q+half]
    timings: dict = dc_field(default_factory=dict)

    def size_fields(self) -> int:
        total = 24 + self.fri_proof.size_fields()
        total += 4 * len(self.openings)
        for rows, paths in self.tree_openings.values():
            total += int(np.prod(rows.shape)) + int(np.prod(paths.shape))
        return total

    def to_bytes(self) -> bytes:
        from . import wire
        return wire.encode_proof(self)

    @staticmethod
    def from_bytes(raw: bytes) -> "Proof":
        from . import wire
        return wire.decode_proof(raw)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------
def _lde(cols: torch.Tensor, blowup: int, shift: int) -> torch.Tensor:
    if cols.shape[0] == 0:
        return cols.new_zeros((0, cols.shape[1] * blowup))
    return poly.coset_lde(cols, blowup, shift)


def _lde_from_coeffs(coeffs: torch.Tensor, blowup: int, shift: int) -> torch.Tensor:
    n = coeffs.shape[-1]
    scaled = F.fmul(coeffs, F.powers(shift, n, coeffs.device))
    return poly.ntt(poly._zero_pad(scaled, n * blowup))


def _cumsum_mod(x: torch.Tensor, axis=0) -> torch.Tensor:
    # n * P < 2^63 for every circuit size the field allows
    return torch.cumsum(x, dim=axis) % F.P


def _no_grand_products(circuit: Circuit):
    if circuit.gps:
        raise NotImplementedError(
            f"circuit {circuit.name!r} uses a grand-product argument "
            f"({[g.name for g in circuit.gps]}); repro_torch has not ported "
            f"it yet (ROADMAP Queue 2: the Fp4 grand-product kernel)")


def opening_schedule(circuit: Circuit, blowup: int):
    """Deterministic list of (kind, index, rot) openings at z*w^rot.

    kinds: fixed/instance (verifier-computed), advice, ext (components),
    quotient (components). Every committed polynomial appears at least at
    rot 0 so the DEEP argument binds it.
    """
    rotset = circuit.rotation_set()
    sched = []
    for kind, count in ((FIXED, circuit.n_fixed), (INSTANCE, circuit.n_instance),
                        (DATA, circuit.n_data), (ADVICE, circuit.n_advice)):
        for i in range(count):
            rots = {r for (k, j, r) in rotset if k == kind and j == i} | {0}
            for r in sorted(rots):
                sched.append((kind, i, r))
    for c in range(circuit.n_ext * 4):
        for r in (0, 1):
            sched.append(("ext", c, r))
    for c in range(blowup * 4):
        sched.append(("quotient", c, 0))
    return sched


def auto_multiplicities(circuit: Circuit, data_np: np.ndarray,
                        advice_np: np.ndarray, instance_np: np.ndarray):
    """Fill auto-multiplicity advice columns for lookup buses (host-side).

    t-side counts land only on rows where the bus t_sel is active, and on the
    first selected occurrence of each distinct tuple.
    """
    n = circuit.n_rows

    def getter(kind, idx, rot):
        src = {FIXED: None, ADVICE: advice_np, INSTANCE: instance_np,
               DATA: data_np}[kind]
        col = circuit.fixed_cols[idx] if kind == FIXED else src[idx]
        return torch.from_numpy(np.roll(col, -rot).astype(np.int64) % F.P)

    def host(e):
        return eval_expr(e, getter, BaseOps, like).numpy()

    like = torch.zeros(n, dtype=F.I64)
    for bus in circuit.buses:
        if bus.auto_mult_col < 0:
            continue
        f_vals = np.stack([host(e) for e in bus.f_tuple], axis=1)
        t_vals = np.stack([host(e) for e in bus.t_tuple], axis=1)
        m_f = host(bus.m_f)
        t_sel = host(bus.t_sel)
        both = np.concatenate([t_vals, f_vals], axis=0)
        _, inv = np.unique(both, axis=0, return_inverse=True)
        inv = inv.reshape(-1)
        code_t, code_f = inv[:n], inv[n:]
        counts = np.zeros(int(inv.max()) + 1, np.int64)
        np.add.at(counts, code_f, m_f)
        sel_rows = np.nonzero(t_sel != 0)[0]
        u_t, first_sel = np.unique(code_t[sel_rows], return_index=True)
        m_t = np.zeros(n, np.int64)
        m_t[sel_rows[first_sel]] = counts[u_t]
        advice_np[bus.auto_mult_col] = (m_t % F.P).astype(np.uint32)


# ---------------------------------------------------------------------------
# keygen
# ---------------------------------------------------------------------------
def keygen(circuit: Circuit, cfg: ProverConfig = ProverConfig()) -> Keys:
    with be.use(cfg.backend, cfg.device) as (backend, device):
        _no_grand_products(circuit)
        circuit.assign_ext_cols()
        fixed = F.tensor(np.stack(circuit.fixed_cols) if circuit.fixed_cols
                         else np.zeros((0, circuit.n_rows), np.int64), device)
        coeffs = poly.intt(fixed) if circuit.n_fixed else fixed
        lde = _lde(fixed, cfg.blowup, cfg.shift)
        return Keys(circuit, cfg, coeffs, lde, backend.name, device)


# ---------------------------------------------------------------------------
# phase-2 ext column construction
# ---------------------------------------------------------------------------
def build_ext_columns(circuit: Circuit, getter_n, like_n, alpha, beta):
    """Returns (n_ext, N, 4) ext columns: the bus running sums."""
    from .plonkish import compress_tuple
    _no_grand_products(circuit)
    n = circuit.n_rows
    cols = []
    for bus in circuit.buses:
        f_vals = [eval_expr(e, getter_n, BaseOps, like_n) for e in bus.f_tuple]
        t_vals = [eval_expr(e, getter_n, BaseOps, like_n) for e in bus.t_tuple]
        m_f = eval_expr(bus.m_f, getter_n, BaseOps, like_n)
        m_t = eval_expr(bus.m_t * bus.t_sel, getter_n, BaseOps, like_n)
        d_f = F.eadd(beta.expand(n, 4), compress_tuple(f_vals, alpha))
        d_t = F.eadd(beta.expand(n, 4), compress_tuple(t_vals, alpha))
        # m_f/d_f - m_t/d_t = (m_f*d_t - m_t*d_f) / (d_f*d_t)
        num = F.esub(F.fmul(d_t, m_f[:, None]), F.fmul(d_f, m_t[:, None]))
        inc = F.emul(num, F.ebatch_inv(F.emul(d_f, d_t)))
        h = _cumsum_mod(inc, axis=0)
        h = torch.cat([h.new_zeros((1, 4)), h[:-1]], dim=0)
        cols.append(h)
    if not cols:
        return like_n.new_zeros((0, n, 4))
    return torch.stack(cols)


# ---------------------------------------------------------------------------
# constraint evaluation (shared shape between LDE-domain and OOD-point)
# ---------------------------------------------------------------------------
def combine_constraints(circuit: Circuit, base_getter, ext_getter, alpha, beta,
                        alpha_c, like_base, ops, ext_of_base):
    """Evaluate sum_i alpha_c^i * constraint_i.

    ``base_getter``: base-column access returning ops-domain values.
    ``ext_getter(col, rot)``: ext helper column value (always Fp4-shaped).
    ``ext_of_base(v)``: lift a base-domain value into the ext accumulator space.
    Returns the combined accumulator (ext space).
    """
    _no_grand_products(circuit)
    acc = None
    a_pow = None

    def add_term(val_ext):
        nonlocal acc, a_pow
        if acc is None:
            acc = val_ext
            a_pow = alpha_c
        else:
            acc = F.eadd(acc, F.emul(a_pow.expand(val_ext.shape), val_ext))
            a_pow = F.emul(a_pow, alpha_c)

    for _, gate in circuit.gates:
        v = eval_expr(gate, base_getter, ops, like_base)
        add_term(ext_of_base(v))

    def compress(exprs):
        vals = [eval_expr(e, base_getter, ops, like_base) for e in exprs]
        out = ext_of_base(vals[0])
        apow = alpha
        for v in vals[1:]:
            out = F.eadd(out, F.emul(apow.expand(out.shape), ext_of_base(v)))
            apow = F.emul(apow, alpha)
        return out

    def mul_base(val_ext, base_v):
        return F.emul(val_ext, ext_of_base(base_v))

    for bus in circuit.buses:
        c_f = compress(bus.f_tuple)
        d_f = F.eadd(beta.expand(c_f.shape), c_f)
        d_t = F.eadd(beta.expand(d_f.shape), compress(bus.t_tuple))
        h = ext_getter(bus.ext_col, 0)
        h1 = ext_getter(bus.ext_col, 1)
        m_f = eval_expr(bus.m_f, base_getter, ops, like_base)
        m_t = eval_expr(bus.m_t * bus.t_sel, base_getter, ops, like_base)
        term = F.emul(F.esub(h1, h), F.emul(d_f, d_t))
        term = F.esub(term, mul_base(d_t, m_f))
        term = F.eadd(term, mul_base(d_f, m_t))
        add_term(term)
    if acc is None:
        acc = torch.zeros_like(ext_of_base(ops.const(0, like_base)))
    return acc


# ---------------------------------------------------------------------------
# prove
# ---------------------------------------------------------------------------
def prove(keys: Keys, advice_np: np.ndarray, instance_np: np.ndarray,
          data_np: np.ndarray = None, label: str = "zkgraph") -> Proof:
    """Prove under the backend and device that produced these Keys.  Proof
    bytes are bit-identical across backends."""
    with be.use(keys.backend, keys.device):
        return _prove_impl(keys, advice_np, instance_np, data_np, label)


def _prove_impl(keys: Keys, advice_np: np.ndarray, instance_np: np.ndarray,
                data_np: np.ndarray = None, label: str = "zkgraph") -> Proof:
    circuit, cfg = keys.circuit, keys.cfg
    dev = keys.device
    n, B = circuit.n_rows, cfg.blowup
    nl = n * B
    t0 = time.perf_counter()
    timings = {}

    if data_np is None:
        data_np = np.zeros((0, n), np.uint32)
    auto_multiplicities(circuit, data_np, advice_np, instance_np)
    advice = F.tensor(advice_np, dev)
    data = F.tensor(data_np, dev) if circuit.n_data \
        else torch.zeros((0, n), dtype=F.I64, device=dev)
    inst = F.tensor(instance_np, dev) if circuit.n_instance \
        else torch.zeros((0, n), dtype=F.I64, device=dev)

    tx = Transcript(label, dev)
    tx.absorb(circuit.digest_seed())
    if circuit.n_instance:
        # bind public I/O by a Merkle root (one digest, not O(N) sponge blocks)
        tx.absorb_digest(merkle.commit(inst.T).root)

    zero_root = np.zeros(8, np.uint32)

    # --- phase 0: commit the dataset (the declared-DB binding) --------------
    data_coeffs = poly.intt(data) if circuit.n_data else data
    data_lde = _lde(data, B, cfg.shift)
    data_tree = merkle.commit(data_lde.T) if circuit.n_data else None
    data_root = F.to_numpy(data_tree.root) if data_tree else zero_root
    tx.absorb_digest(data_root)

    # --- phase 1: commit advice -------------------------------------------
    adv_coeffs = poly.intt(advice) if circuit.n_advice else advice
    adv_lde = _lde(advice, B, cfg.shift)
    adv_tree = merkle.commit(adv_lde.T) if circuit.n_advice else None
    adv_root = F.to_numpy(adv_tree.root) if adv_tree else zero_root
    tx.absorb_digest(adv_root)
    timings["commit_advice"] = time.perf_counter() - t0

    alpha = F.tensor(tx.challenge_ext(), dev)
    beta = F.tensor(tx.challenge_ext(), dev)

    # --- phase 2: ext columns ----------------------------------------------
    t1 = time.perf_counter()
    fixed_n = F.tensor(np.stack(circuit.fixed_cols) if circuit.fixed_cols
                       else np.zeros((0, n), np.int64), dev)

    def getter_n(kind, idx, rot):
        src = {FIXED: fixed_n, ADVICE: advice, INSTANCE: inst, DATA: data}[kind]
        return torch.roll(src[idx], -rot)

    like_n = torch.zeros(n, dtype=F.I64, device=dev)
    ext_cols = build_ext_columns(circuit, getter_n, like_n, alpha, beta)
    n_ext = circuit.n_ext
    ext_base = ext_cols.permute(0, 2, 1).reshape(n_ext * 4, n) if n_ext \
        else torch.zeros((0, n), dtype=F.I64, device=dev)
    ext_coeffs = poly.intt(ext_base) if n_ext else ext_base
    ext_lde = _lde(ext_base, B, cfg.shift)
    ext_tree = merkle.commit(ext_lde.T) if n_ext else None
    ext_root = F.to_numpy(ext_tree.root) if ext_tree else zero_root
    tx.absorb_digest(ext_root)
    timings["phase2_ext"] = time.perf_counter() - t1

    alpha_c = F.tensor(tx.challenge_ext(), dev)

    # --- quotient -----------------------------------------------------------
    t2 = time.perf_counter()
    fixed_lde, inst_lde = keys.fixed_lde, _lde(inst, B, cfg.shift)

    def getter_lde(kind, idx, rot):
        src = {FIXED: fixed_lde, ADVICE: adv_lde, INSTANCE: inst_lde,
               DATA: data_lde}[kind]
        return torch.roll(src[idx], -B * rot)

    def ext_getter_lde(col, rot):
        comps = [torch.roll(ext_lde[col * 4 + c], -B * rot) for c in range(4)]
        return torch.stack(comps, dim=-1)

    like_lde = torch.zeros(nl, dtype=F.I64, device=dev)
    c_lde = combine_constraints(circuit, getter_lde, ext_getter_lde, alpha, beta,
                                alpha_c, like_lde, BaseOps, F.ext)
    # Z_H(x_i) = x_i^N - 1 = shift^N * (w_nl^N)^i - 1: period-B sequence in i
    wn = F.root_of_unity(nl)
    ratio = pow(wn, n, F.P)
    zh_inv = []
    acc = pow(cfg.shift, n, F.P)
    for _ in range(B):
        zh_inv.append(pow((acc - 1) % F.P, F.P - 2, F.P))
        acc = acc * ratio % F.P
    zh_inv = F.tensor(zh_inv, dev).repeat(n)
    q_evals = F.fmul(c_lde, zh_inv[:, None])
    q_coeffs = poly.coset_coeffs(q_evals.T, cfg.shift)    # (4, NL)
    q_segments = q_coeffs.reshape(4, B, n).permute(1, 0, 2).reshape(B * 4, n)
    q_lde = _lde_from_coeffs(q_segments, B, cfg.shift)
    q_tree = merkle.commit(q_lde.T)
    q_root = F.to_numpy(q_tree.root)
    tx.absorb_digest(q_root)
    timings["quotient"] = time.perf_counter() - t2

    # --- OOD openings --------------------------------------------------------
    t3 = time.perf_counter()
    z = F.tensor(tx.challenge_ext(), dev)
    sched = opening_schedule(circuit, B)
    coeff_src = {FIXED: keys.fixed_coeffs, INSTANCE: poly.intt(inst) if
                 circuit.n_instance else inst, DATA: data_coeffs,
                 ADVICE: adv_coeffs, "ext": ext_coeffs, "quotient": q_segments}
    w_n = F.root_of_unity(n)
    openings = {}
    rots = sorted({r for (_, _, r) in sched})
    for rot in rots:
        zr = F.emul_fp(z, pow(w_n, rot, F.P))
        for kind in (FIXED, INSTANCE, DATA, ADVICE, "ext", "quotient"):
            idxs = [i for (k, i, rr) in sched if k == kind and rr == rot]
            if not idxs:
                continue
            vals = poly.eval_at_ext(coeff_src[kind][idxs], zr)
            for i, v in zip(idxs, F.to_numpy(vals)):
                openings[(kind, i, rot)] = v
    for key in sched:
        tx.absorb(openings[key])
    timings["ood_openings"] = time.perf_counter() - t3

    # --- DEEP composition -----------------------------------------------------
    t4 = time.perf_counter()
    gamma = F.tensor(tx.challenge_ext(), dev)
    pts = poly.domain_points(nl, cfg.shift, dev)          # (NL,)
    committed = [(k, i, r) for (k, i, r) in sched
                 if k in (DATA, ADVICE, "ext", "quotient")]
    lde_src = {DATA: data_lde, ADVICE: adv_lde, "ext": ext_lde,
               "quotient": q_lde}
    deep = torch.zeros((nl, 4), dtype=F.I64, device=dev)
    g_pow = gamma
    groups = {}
    for (k, i, r) in committed:
        groups.setdefault(r, []).append((k, i))
    for r in sorted(groups):
        zr = F.emul_fp(z, pow(w_n, r, F.P))
        inv_d = F.ebatch_inv(F.esub(F.ext(pts), zr.expand(nl, 4)))
        num = torch.zeros((nl, 4), dtype=F.I64, device=dev)
        for (k, i) in groups[r]:
            diff = F.esub(F.ext(lde_src[k][i]),
                          F.tensor(openings[(k, i, r)], dev).expand(nl, 4))
            num = F.eadd(num, F.emul(g_pow.expand(nl, 4), diff))
            g_pow = F.emul(g_pow, gamma)
        deep = F.eadd(deep, F.emul(num, inv_d))
    timings["deep"] = time.perf_counter() - t4

    # --- FRI -------------------------------------------------------------------
    t5 = time.perf_counter()
    fproof = fri_mod.fri_prove(deep, tx, cfg.fri())
    timings["fri"] = time.perf_counter() - t5

    # --- query openings ---------------------------------------------------------
    q_idx = torch.from_numpy(fproof.query_indices).to(dev)
    idx_all = torch.cat([q_idx, q_idx + nl // 2])
    tree_openings = {}
    for name, tree in (("data", data_tree), ("advice", adv_tree),
                       ("ext", ext_tree), ("quotient", q_tree)):
        if tree is None:
            tree_openings[name] = (np.zeros((len(idx_all), 0), np.uint32),
                                   np.zeros((len(idx_all), 0, 8), np.uint32))
        else:
            rows, paths = merkle.open_at(tree, idx_all)
            tree_openings[name] = (F.to_numpy(rows), F.to_numpy(paths))
    timings["total"] = time.perf_counter() - t0

    # strip fixed/instance openings from the transmitted proof (verifier
    # recomputes them); keep data/advice/ext/quotient
    sent = {k: v for k, v in openings.items()
            if k[0] in (DATA, ADVICE, "ext", "quotient")}
    return Proof(data_root, adv_root, ext_root, q_root, sent, fproof,
                 tree_openings, timings)
