"""Operator registry: plan-node types -> circuit adapters.

Each adapter knows how to lower one IR node kind to a primitive operator
circuit:

* ``shape(db, node, env)``   — serializable build kwargs (circuit geometry)
* ``build(shape)``           — construct the circuit (no data needed, so the
                               *verifier* can rebuild it from a proof bundle)
* ``witness(db, op, node, env)`` — run the untrusted engine + fill columns
* ``extract_outputs(op, instance)`` — public outputs for chaining, read from
                               the instance only (so the verifier can extract
                               them from a *verified* proof)
* ``chained_cols(node, env)`` — recompute a chained intermediate table from
                               earlier outputs (prover and verifier must
                               agree bit-for-bit; this is the chain glue)

Registering a new operator is ``register(MyAdapter())`` — the planner,
session, and verifier pick it up without modification.

PyTorch-port counterpart of ``repro.core.operators.registry``: the adapter
base class and the ``Expand`` adapter (IS5's operator).  A plan node whose
adapter is not ported yet raises ``NotImplementedError`` naming the node.
"""
from __future__ import annotations

import numpy as np

from ...graphdb import tables
from ...graphdb.storage import pad_pow2
from .. import field as F
from .. import ir
from . import expansion
from .common import Operator

_BY_KIND: dict = {}    # node type -> adapter instance
_BY_NAME: dict = {}    # adapter name -> adapter instance


def register(adapter):
    """Register an adapter for its node type. Later registrations for the
    same node type override earlier ones (so projects can swap circuits)."""
    _BY_KIND[adapter.kind] = adapter
    _BY_NAME[adapter.name] = adapter
    return adapter


#: plan-node types whose circuits repro_torch has not ported yet
_NOT_PORTED = (ir.SetExpand, ir.OrderBy, ir.SSSP, ir.NameFilter, ir.Filter,
               ir.Aggregate)


def adapter_for(node):
    try:
        return _BY_KIND[type(node)]
    except KeyError:
        if isinstance(node, _NOT_PORTED):
            raise NotImplementedError(
                f"plan node {type(node).__name__} has no adapter in "
                f"repro_torch yet (ROADMAP Queue 1: the remaining "
                f"operators)") from None
        raise KeyError(f"no adapter registered for node type "
                       f"{type(node).__name__}") from None


def adapter_named(name: str):
    try:
        return _BY_NAME[name]
    except KeyError:
        raise KeyError(f"no adapter named {name!r}; "
                       f"known: {sorted(_BY_NAME)}") from None


def build_operator(name: str, shape: dict) -> Operator:
    """Verifier-side circuit reconstruction from a bundle's step record."""
    return adapter_named(name).build(shape)


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------
def _table_cols(db, table, env: ir.Env) -> np.ndarray:
    # memoized per execution: shape() and witness() share the resolution
    key = ("cols", table)
    cols = env.memo.get(key)
    if cols is None:
        if isinstance(table, ir.BaseTable):
            cols = tables.base_table_cols(db, table.desc)
        elif isinstance(table, ir.Chained):
            cols = table.resolve_cols(env)
        else:
            raise TypeError(f"unsupported table ref {table!r}")
        env.memo[key] = cols
    return cols


def _desc_of(table) -> str:
    return table.desc if isinstance(table, ir.BaseTable) else "chained"


def _selected(op: Operator, instance, col: str) -> np.ndarray:
    sel = instance[op.handles["out_sel"].index] == 1
    return instance[op.handles[col].index][sel].astype(np.int64)


class Adapter:
    kind: type = None
    name: str = ""
    #: serializable circuit-geometry schema: shape-dict key -> exact type.
    #: The wire codec and the verifier both reject a step whose declared
    #: shape deviates from this (extra/missing keys, bool-vs-int confusion).
    shape_schema: dict = {}

    def data_desc(self, node) -> str:
        return _desc_of(node.table)

    def shape_flags(self, node) -> dict:
        """The shape fields derivable from the plan node alone (no db, no
        outputs). The verifier pins these against a bundle's declared shape
        — a prover cannot flip semantic circuit flags (reverse, bidirectional,
        …) on a base-table step."""
        return {}

    def manifest_pins(self, node, env: ir.Env, manifest, geo) -> dict:
        """Shape fields pinned by the owner's PUBLISHED manifest for a
        base-table step (``geo`` is the table's :class:`TableGeometry`).
        Together with :meth:`shape_flags` and the published-size membership
        check this pins the step's full circuit geometry — the verifier
        never trusts row counts from the prover's bundle."""
        return dict(n_rows=pad_pow2(geo.n_table_rows),
                    m_edges=geo.n_table_rows)

    def check_instance(self, op: Operator, instance, node, env: ir.Env) -> bool:
        """Verifier-side: the public inputs embedded in the instance must
        equal the plan-resolved bindings — otherwise a prover could answer a
        *different* query (other source id, other id set) than the one the
        bundle claims in ``params``."""
        return True

    def chained_cols(self, node, env: ir.Env) -> np.ndarray:
        assert isinstance(node.table, ir.Chained), \
            f"{self.name} step is bound to a base table, not chained"
        return _table_cols(None, node.table, env)   # shares the env memo


def _col_equals(op: Operator, instance, handle: str, value: int) -> bool:
    col = np.asarray(instance[op.handles[handle].index], np.int64)
    return bool((col == int(value) % F.P).all())


# ---------------------------------------------------------------------------
# Expand (§IV-A edge-list) — also the base for NameFilter
# ---------------------------------------------------------------------------
class ExpandAdapter(Adapter):
    kind = ir.Expand
    name = "expand"
    shape_schema = dict(n_rows=int, m_edges=int, with_prop=bool, reverse=bool)

    def _source(self, node, env):
        return int(ir.resolve(node.source, env))

    def _flags(self, node):
        return node.with_prop, node.reverse

    def shape_flags(self, node) -> dict:
        with_prop, reverse = self._flags(node)
        return dict(with_prop=with_prop, reverse=reverse)

    def shape(self, db, node, env: ir.Env) -> dict:
        cols = _table_cols(db, node.table, env)
        return dict(n_rows=pad_pow2(cols.shape[1]), m_edges=int(cols.shape[1]),
                    **self.shape_flags(node))

    def build(self, shape: dict) -> Operator:
        return expansion.build_edge_list(**shape)

    def witness(self, db, op: Operator, node, env: ir.Env):
        cols = _table_cols(db, node.table, env)
        with_prop, _ = self._flags(node)
        return expansion.witness_edge_list(
            op, cols[0], cols[1], self._source(node, env),
            cols[2] if with_prop else None)

    def extract_outputs(self, op: Operator, instance) -> dict:
        out = dict(src=_selected(op, instance, "C_s"),
                   dst=_selected(op, instance, "C_t"))
        if op.handles["with_prop"]:
            out["prop"] = _selected(op, instance, "C_p")
        return out

    def check_instance(self, op, instance, node, env: ir.Env) -> bool:
        return _col_equals(op, instance, "id_s", self._source(node, env))


register(ExpandAdapter())
