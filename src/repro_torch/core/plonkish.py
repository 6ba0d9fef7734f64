"""PLONKish constraint system (Halo2-style) over BabyBear.

PyTorch counterpart of ``repro.core.plonkish``.  The expression DSL, the
argument specs and :class:`Circuit` are the reference's, unchanged (pure
Python and numpy; ``Circuit.digest_seed`` is absorbed into the transcript,
so it must give the same list).  The field-generic evaluation
(:class:`BaseOps`, :class:`ExtOps`, :func:`eval_expr`) and
:func:`compress_tuple` run on int64 tensors.

Column kinds (paper §II-B):
* fixed    — circuit structure: selectors, range tables, constants (public)
* advice   — private witness (phase 1)
* instance — public I/O (query results, claimed scalars)
* ext      — phase-2 Fp4 helper columns built by the framework itself
             (logUp running sums of the buses)
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field as dc_field
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from . import field as F

FIXED, ADVICE, INSTANCE, DATA = "fixed", "advice", "instance", "data"


# ---------------------------------------------------------------------------
# Expression DSL
# ---------------------------------------------------------------------------
class Expr:
    def __add__(self, other):
        return _Bin("add", self, _wrap(other))

    __radd__ = __add__

    def __sub__(self, other):
        return _Bin("sub", self, _wrap(other))

    def __rsub__(self, other):
        return _Bin("sub", _wrap(other), self)

    def __mul__(self, other):
        return _Bin("mul", self, _wrap(other))

    __rmul__ = __mul__

    def __neg__(self):
        return _Bin("sub", Const(0), self)

    # -- analysis ---------------------------------------------------------
    def degree(self) -> int:
        raise NotImplementedError

    def rotations(self) -> set:
        raise NotImplementedError

    def atoms(self) -> frozenset:
        """All :class:`Col` leaves (kind, index, rot included)."""
        raise NotImplementedError


def _wrap(x):
    if isinstance(x, Expr):
        return x
    return Const(int(x))


@dataclass(frozen=True)
class Const(Expr):
    value: int

    def degree(self):
        return 0

    def rotations(self):
        return set()

    def atoms(self):
        return frozenset()


@dataclass(frozen=True)
class Col(Expr):
    kind: str
    index: int
    rot: int = 0

    def rotate(self, k: int) -> "Col":
        return Col(self.kind, self.index, self.rot + k)

    def degree(self):
        return 1

    def rotations(self):
        return {(self.kind, self.index, self.rot)}

    def atoms(self):
        return frozenset({self})


@dataclass(frozen=True)
class _Bin(Expr):
    op: str
    a: Expr
    b: Expr

    def degree(self):
        if self.op == "mul":
            return self.a.degree() + self.b.degree()
        return max(self.a.degree(), self.b.degree())

    def rotations(self):
        return self.a.rotations() | self.b.rotations()

    def atoms(self):
        return self.a.atoms() | self.b.atoms()


def fixed(i, rot=0):
    return Col(FIXED, i, rot)


def advice(i, rot=0):
    return Col(ADVICE, i, rot)


def instance(i, rot=0):
    return Col(INSTANCE, i, rot)


# Field-generic evaluation ---------------------------------------------------
class BaseOps:
    """Fp ops over int64 tensors."""
    add = staticmethod(F.fadd)
    sub = staticmethod(F.fsub)
    mul = staticmethod(F.fmul)

    @staticmethod
    def const(v, like):
        return torch.full(like.shape, v % F.P, dtype=F.I64, device=like.device)


class ExtOps:
    """Fp4 ops over (..., 4) tensors."""
    add = staticmethod(F.eadd)
    sub = staticmethod(F.esub)
    mul = staticmethod(F.emul)

    @staticmethod
    def const(v, like):
        out = torch.zeros(like.shape, dtype=F.I64, device=like.device)
        out[..., 0] = v % F.P
        return out


def eval_expr(expr: Expr, getter: Callable, ops, like):
    """Evaluate an expression tree. ``getter(kind, index, rot)`` returns the
    column evaluations; ``like`` is a template value for Const shaping."""
    if isinstance(expr, Const):
        return ops.const(expr.value, like)
    if isinstance(expr, Col):
        return getter(expr.kind, expr.index, expr.rot)
    assert isinstance(expr, _Bin)
    a = eval_expr(expr.a, getter, ops, like)
    b = eval_expr(expr.b, getter, ops, like)
    return getattr(ops, expr.op)(a, b)


# ---------------------------------------------------------------------------
# Argument specs
# ---------------------------------------------------------------------------
@dataclass
class Bus:
    """logUp bus:  sum_rows [ m_f/(β + α·f) − m_t/(β + α·t) ] == 0.

    With ``auto_multiplicity`` the framework counts how many times each
    t-tuple is matched by the (selected) f-tuples and fills m_t itself —
    then the bus is a *lookup* (f ⊆ t). With both multiplicities given as
    expressions and equal cardinality it is a *multiset equality* (the
    paper's permutation argument, Eq. (1)+(2) reformulated additively).
    """
    name: str
    f_tuple: Sequence[Expr]
    t_tuple: Sequence[Expr]
    m_f: Expr = Const(1)
    m_t: Optional[Expr] = None            # None => auto multiplicity column
    t_sel: Expr = Const(1)                # gates the valid t-side region
    auto_mult_col: int = -1               # advice col auto-allocated
    ext_col: int = -1                     # helper column index (set by circuit)

    def exprs(self) -> tuple:
        """Every base-column expression the bus constraint touches."""
        return (*self.f_tuple, *self.t_tuple, self.m_f, self.m_t, self.t_sel)


@dataclass
class GrandProduct:
    """The paper's Eq. (2) running-product permutation argument.

    Z[0] = 1;  Z[i+1] = Z[i] * (β + α·c1[i]) / (β + α·c2[i]) on selected rows
    (unselected rows contribute factor 1);  Z wraps to 1.
    Tuple compression via α per Eq. (1).
    """
    name: str
    c1_tuple: Sequence[Expr]
    c2_tuple: Sequence[Expr]
    sel1: Expr = Const(1)
    sel2: Expr = Const(1)
    ext_col: int = -1

    def exprs(self) -> tuple:
        """Every base-column expression the argument touches."""
        return (*self.c1_tuple, *self.c2_tuple, self.sel1, self.sel2)


@dataclass
class Circuit:
    n_rows: int
    name: str = "circuit"
    fixed_cols: list = dc_field(default_factory=list)     # list[np.ndarray (N,)]
    fixed_names: list = dc_field(default_factory=list)
    advice_names: list = dc_field(default_factory=list)
    instance_names: list = dc_field(default_factory=list)
    data_names: list = dc_field(default_factory=list)     # committed dataset cols
    gates: list = dc_field(default_factory=list)          # [(name, Expr)]
    buses: list = dc_field(default_factory=list)
    gps: list = dc_field(default_factory=list)
    _range_tables: dict = dc_field(default_factory=dict)  # bits -> fixed col idx
    # memoized session shape digest (SHA-256 over fixed cols + constraints);
    # invalidated by every structural mutation below — the keygen cache pays
    # the hash once per circuit object instead of once per ensure() call
    _shape_digest: Optional[str] = dc_field(
        default=None, repr=False, compare=False)

    def _mutated(self):
        self._shape_digest = None

    # -- column allocation --------------------------------------------------
    def add_fixed(self, name: str, values) -> Col:
        self._mutated()
        vals = np.zeros(self.n_rows, np.uint32)
        arr = np.asarray(values, np.int64) % F.P
        vals[: len(arr)] = arr.astype(np.uint32)
        self.fixed_cols.append(vals)
        self.fixed_names.append(name)
        return Col(FIXED, len(self.fixed_cols) - 1)

    def add_advice(self, name: str) -> Col:
        self._mutated()
        self.advice_names.append(name)
        return Col(ADVICE, len(self.advice_names) - 1)

    def add_instance(self, name: str) -> Col:
        self._mutated()
        self.instance_names.append(name)
        return Col(INSTANCE, len(self.instance_names) - 1)

    def add_data(self, name: str) -> Col:
        """Private dataset column: committed in its own tree whose root is the
        paper's 'declared dataset' commitment (verifier compares roots)."""
        self._mutated()
        self.data_names.append(name)
        return Col(DATA, len(self.data_names) - 1)

    # -- constraints ----------------------------------------------------------
    def add_gate(self, name: str, expr: Expr, max_degree: int = 4):
        self._mutated()
        d = expr.degree()
        assert d <= max_degree, f"gate {name} degree {d} > {max_degree}"
        self.gates.append((name, expr))

    def add_bus(self, name, f_tuple, t_tuple, m_f=Const(1), m_t=None,
                t_sel=Const(1)) -> Bus:
        self._mutated()
        bus = Bus(name, tuple(f_tuple), tuple(t_tuple), m_f, m_t, t_sel)
        if m_t is None:
            col = self.add_advice(f"{name}/mult")
            bus.auto_mult_col = col.index
            bus.m_t = col
        self.buses.append(bus)
        return bus

    def add_multiset_equal(self, name, tuple_a, sel_a, tuple_b, sel_b):
        """Paper §IV-A 'Edge Correctness': multiset {a | sel_a} == {b | sel_b}."""
        return self.add_bus(name, tuple_a, tuple_b, m_f=sel_a, m_t=sel_b)

    def add_grand_product(self, name, c1, c2, sel1=Const(1), sel2=Const(1)):
        self._mutated()
        gp = GrandProduct(name, tuple(c1), tuple(c2), sel1, sel2)
        self.gps.append(gp)
        return gp

    def add_range_check(self, name: str, expr: Expr, bits: int,
                        sel: Optional[Expr] = None):
        """expr ∈ [0, 2^bits) via limb decomposition + table lookups.

        Limb width adapts to the circuit size (table must fit in n_rows).
        ``sel`` (degree ≤ 1) gates the check to a region: unselected rows may
        hold arbitrary expr values with zero limbs. Returns the advice limb
        columns the witness code must fill — use :func:`fill_range_limbs`.
        """
        limb_bits = min(16, max(1, int(math.log2(self.n_rows))))
        n_limbs = (bits + limb_bits - 1) // limb_bits
        table_col = self._range_table(limb_bits)
        limbs = []
        acc: Expr = Const(0)
        shift = 1
        for j in range(n_limbs):
            c = self.add_advice(f"{name}/limb{j}")
            limbs.append(c)
            acc = acc + Const(shift) * c
            shift = (shift << limb_bits) % F.P
            self.add_bus(f"{name}/limb{j}/range", [c], [table_col],
                         m_f=sel if sel is not None else Const(1))
        recompose = acc - expr
        if sel is not None:
            recompose = sel * recompose
        self.add_gate(f"{name}/recompose", recompose)
        return limbs, limb_bits

    def _range_table(self, limb_bits: int) -> Col:
        if limb_bits in self._range_tables:
            return Col(FIXED, self._range_tables[limb_bits])
        size = 1 << limb_bits
        assert size <= self.n_rows, "range table exceeds circuit rows"
        col = self.add_fixed(f"range{limb_bits}", np.arange(size))
        self._range_tables[limb_bits] = col.index
        return col

    # -- metadata -------------------------------------------------------------
    @property
    def n_fixed(self):
        return len(self.fixed_cols)

    @property
    def n_advice(self):
        return len(self.advice_names)

    @property
    def n_instance(self):
        return len(self.instance_names)

    @property
    def n_data(self):
        return len(self.data_names)

    @property
    def n_ext(self):
        return len(self.buses) + len(self.gps)

    def assign_ext_cols(self):
        i = 0
        for b in self.buses:
            b.ext_col = i
            i += 1
        for g in self.gps:
            g.ext_col = i
            i += 1

    def constraint_exprs(self):
        """Iterate ``(kind, name, exprs)`` over every constraint — the one
        enumeration the analyzer, opening schedule, and rotation set share.
        ``kind`` is "gate" / "bus" / "gp"; ``exprs`` is the tuple of
        base-column expressions the constraint evaluates."""
        for name, e in self.gates:
            yield "gate", name, (e,)
        for b in self.buses:
            yield "bus", b.name, b.exprs()
        for g in self.gps:
            yield "gp", g.name, g.exprs()

    def rotation_set(self) -> set:
        """All (kind, col, rot) base-column accesses + ext rotations {0,1}."""
        rots = set()
        for _, _, exprs in self.constraint_exprs():
            for e in exprs:
                rots |= e.rotations()
        return rots

    def referenced_cols(self) -> dict:
        """kind -> set of column indices appearing in any constraint."""
        refs = {FIXED: set(), ADVICE: set(), INSTANCE: set(), DATA: set()}
        for k, i, _ in self.rotation_set():
            refs[k].add(i)
        return refs

    def gate_info(self) -> list:
        """Per-gate metadata for analysis/reporting: name, AST degree, and
        the rotation accesses it performs."""
        return [dict(name=name, degree=e.degree(),
                     rotations=sorted(e.rotations()))
                for name, e in self.gates]

    def digest_seed(self) -> list:
        """Cheap structural fingerprint absorbed into the transcript."""
        return [self.n_rows, self.n_fixed, self.n_advice, self.n_instance,
                self.n_data, len(self.gates), len(self.buses), len(self.gps),
                sum(ord(c) for c in self.name) % F.P]


# ---------------------------------------------------------------------------
# Tuple compression
# ---------------------------------------------------------------------------
def compress_tuple(vals: Sequence[torch.Tensor], alpha: torch.Tensor) -> torch.Tensor:
    """Paper Eq. (1) generalized: sum_j alpha^j v_j (Fp inputs, Fp4 output)."""
    acc = F.ext(vals[0])
    apow = alpha
    for v in vals[1:]:
        acc = F.eadd(acc, F.emul(apow, F.ext(v)))
        apow = F.emul(apow, alpha)
    return acc
