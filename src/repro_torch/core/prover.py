"""DEEP-ALI + FRI prover for PLONKish circuits.

PyTorch counterpart of ``repro.core.prover``.  Pipeline (paper §III-B):
  witness finalize -> commit phase-1 advice -> draw alpha, beta (Eq. (1)
  tuple compression + bus denominators) -> build phase-2 ext columns (logUp
  running sums / Eq. (2) running products) -> commit -> combine constraints
  -> quotient -> OOD openings at z -> DEEP composition -> FRI -> query
  openings.

Witnesses arrive as host numpy arrays; every column, LDE, tree and
codeword of the proof lives on the device the keys were made for, and the
:class:`Proof` holds host numpy arrays again.
"""
from __future__ import annotations

from dataclasses import dataclass, field as dc_field

import numpy as np
import torch

from . import backend as be
from . import field as F
from . import fri as fri_mod
from . import poly
from .plonkish import (ADVICE, DATA, FIXED, INSTANCE, BaseOps, Circuit,
                       eval_expr)


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
    """(..., c, n) evaluations -> (..., c, n*blowup) coset LDE (c may be 0)."""
    if cols.shape[-2] == 0:
        return cols.new_zeros(tuple(cols.shape[:-1])
                              + (cols.shape[-1] * blowup,))
    return poly.coset_lde(cols, blowup, shift)


def _lde_from_coeffs(coeffs: torch.Tensor, blowup: int, shift: int) -> torch.Tensor:
    n = coeffs.shape[-1]
    scaled = F.fmul(coeffs, F.powers(shift, n, coeffs.device))
    return poly.ntt(poly._zero_pad(scaled, n * blowup))


def _cumsum_mod(x: torch.Tensor, axis=0) -> torch.Tensor:
    # n * P < 2^63 for every circuit size the field allows
    return torch.cumsum(x, dim=axis) % F.P


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
        circuit.assign_ext_cols()
        if circuit.gps and "__row0" not in circuit.fixed_names:
            onehot = np.zeros(circuit.n_rows, np.uint32)
            onehot[0] = 1
            circuit.add_fixed("__row0", onehot)
        fixed = F.tensor(np.stack(circuit.fixed_cols) if circuit.fixed_cols
                         else np.zeros((0, circuit.n_rows), np.int64), device)
        coeffs = poly.intt(fixed) if circuit.n_fixed else fixed
        lde = _lde(fixed, cfg.blowup, cfg.shift)
        return Keys(circuit, cfg, coeffs, lde, backend.name, device)


def _row0_index(circuit: Circuit) -> int:
    """Fixed-column index of the ``__row0`` one-hot (keygen adds it to
    every circuit with a grand product)."""
    return circuit.fixed_names.index("__row0")


# ---------------------------------------------------------------------------
# phase-2 ext column construction
# ---------------------------------------------------------------------------
def build_ext_columns(circuit: Circuit, getter_n, like_n, alpha, beta):
    """Returns (..., n_ext, N, 4) ext columns: bus running sums then GP
    products.  Columns are (N,), or (L, N) for the lane-batched prover with
    (L, 1, 4) challenges; every op is elementwise over the leading axes."""
    from .plonkish import compress_tuple
    n = circuit.n_rows
    cols = []
    for bus in circuit.buses:
        f_vals = [eval_expr(e, getter_n, BaseOps, like_n) for e in bus.f_tuple]
        t_vals = [eval_expr(e, getter_n, BaseOps, like_n) for e in bus.t_tuple]
        m_f = eval_expr(bus.m_f, getter_n, BaseOps, like_n)
        m_t = eval_expr(bus.m_t * bus.t_sel, getter_n, BaseOps, like_n)
        d_f = F.eadd(beta, compress_tuple(f_vals, alpha))
        d_t = F.eadd(beta, compress_tuple(t_vals, alpha))
        # m_f/d_f - m_t/d_t = (m_f*d_t - m_t*d_f) / (d_f*d_t)
        num = F.esub(F.fmul(d_t, m_f[..., None]), F.fmul(d_f, m_t[..., None]))
        inc = F.emul(num, F.ebatch_inv(F.emul(d_f, d_t)))
        h = _cumsum_mod(inc, axis=-2)
        cols.append(torch.cat([torch.zeros_like(h[..., :1, :]),
                               h[..., :-1, :]], dim=-2))
    for gp in circuit.gps:
        c1 = [eval_expr(e, getter_n, BaseOps, like_n) for e in gp.c1_tuple]
        c2 = [eval_expr(e, getter_n, BaseOps, like_n) for e in gp.c2_tuple]
        s1 = eval_expr(gp.sel1, getter_n, BaseOps, like_n)
        s2 = eval_expr(gp.sel2, getter_n, BaseOps, like_n)
        one = F.ext_one(like_n.shape, like_n.device)
        d1 = F.eadd(beta, compress_tuple(c1, alpha))
        d2 = F.eadd(beta, compress_tuple(c2, alpha))
        f1 = F.eadd(F.fmul(d1, s1[..., None]),
                    F.fmul(one, F.fsub(torch.ones_like(s1), s1)[..., None]))
        f2 = F.eadd(F.fmul(d2, s2[..., None]),
                    F.fmul(one, F.fsub(torch.ones_like(s2), s2)[..., None]))
        ratio = F.emul(f1, F.ebatch_inv(f2))
        # Eq. (2) exclusive running product: Z[0]=1, Z[i]=prod_{j<i} —
        # dispatched (cuda: the running-product kernel; torch: plain), one
        # (L, N, 4) call for every lane
        gpe = be.active().grand_product_ext
        cols.append(gpe(ratio.reshape(-1, n, 4)).reshape(ratio.shape))
    if not cols:
        return like_n.new_zeros(tuple(like_n.shape[:-1]) + (0, n, 4))
    return torch.stack(cols, dim=-3)


# ---------------------------------------------------------------------------
# constraint evaluation (shared shape between LDE-domain and OOD-point)
# ---------------------------------------------------------------------------
def combine_constraints(circuit: Circuit, base_getter, ext_getter, alpha, beta,
                        alpha_c, like_base, ops, ext_of_base, row0_val):
    """Evaluate sum_i alpha_c^i * constraint_i.

    Challenges broadcast against the values: (4,) for one proof, (L, 1, 4)
    against the lane-batched prover's (L, N, 4) values.
    ``base_getter``: base-column access returning ops-domain values.
    ``ext_getter(col, rot)``: ext helper column value (always Fp4-shaped).
    ``ext_of_base(v)``: lift a base-domain value into the ext accumulator space.
    ``row0_val``: evaluation of the __row0 one-hot fixed column (or None).
    Returns the combined accumulator (ext space).
    """
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
    for gp in circuit.gps:
        c1 = compress(gp.c1_tuple)
        d1 = F.eadd(beta.expand(c1.shape), c1)
        d2 = F.eadd(beta.expand(d1.shape), compress(gp.c2_tuple))
        s1 = eval_expr(gp.sel1, base_getter, ops, like_base)
        s2 = eval_expr(gp.sel2, base_getter, ops, like_base)
        one_b = ops.const(1, like_base)
        f1 = F.eadd(mul_base(d1, s1), ext_of_base(ops.sub(one_b, s1)))
        f2 = F.eadd(mul_base(d2, s2), ext_of_base(ops.sub(one_b, s2)))
        z = ext_getter(gp.ext_col, 0)
        z1 = ext_getter(gp.ext_col, 1)
        add_term(F.esub(F.emul(z1, f2), F.emul(z, f1)))
        # boundary Z[row0] = 1
        one_e = torch.zeros_like(z)
        one_e[..., 0] = 1
        add_term(F.emul(ext_of_base(row0_val), F.esub(z, one_e)))
    if acc is None:
        acc = torch.zeros_like(ext_of_base(ops.const(0, like_base)))
    return acc


# ---------------------------------------------------------------------------
# prove
# ---------------------------------------------------------------------------
def prove(keys: Keys, advice_np: np.ndarray, instance_np: np.ndarray,
          data_np: np.ndarray = None, label: str = "zkgraph") -> Proof:
    """Prove under the backend and device that produced these Keys.  Proof
    bytes are bit-identical across backends.

    The one-lane case of :func:`~repro_torch.core.prover_batch.prove_batch`:
    the port keeps one prover body, and lane ``l`` of an L-lane batch gives
    the same bytes as this call on lane ``l``'s witness."""
    from .prover_batch import prove_batch   # prover_batch imports this module
    return prove_batch(keys, [(advice_np, instance_np, data_np)], label)[0]
