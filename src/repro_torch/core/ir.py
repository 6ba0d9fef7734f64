"""Declarative query-plan IR (paper §III-D, expansion-centric decomposition).

A query is a :class:`Plan`: a chain of typed plan nodes, each lowered to one
primitive operator circuit, glued by *public* intermediate tables.  Node
inputs are **bindings** — small declarative expressions resolved by the
executor against the query parameters and the public outputs of earlier
nodes:

* :class:`Param` — a query parameter (``Param("person")``)
* :class:`Lit` — a literal value
* :class:`Out` — a previous node's public output (``Out(2, "dst")``)
* :class:`App` — a pure host-side transform of resolved bindings (frontier
  computation, concatenation, …); this is untrusted glue, every value that
  matters flows through a committed table or a public instance column.

Node data tables are either a :class:`BaseTable` (bound to the owner's
published dataset commitment) or :class:`Chained` (columns drawn from earlier
nodes' public outputs; the verifier recomputes the root itself — step k's
public output *is* step k+1's committed table).

Each LDBC query is a small pure function returning a plan; the generic
:func:`execute` runs the untrusted engine, builds witnesses through the
operator registry, and wires the chained commitments.  New operators plug in
via :mod:`repro_torch.core.operators.registry` without touching this module.

PyTorch-port copy of ``repro.core.ir``: the plan nodes and plan functions are the
reference's (pure data); the executor runs over the port's own operator
registry, where a node type without a ported adapter raises
``NotImplementedError``.
"""
from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import Any, Callable, Optional, Tuple

import numpy as np

QUERIES = ["IS3", "IS4", "IS5", "IC1", "IC2", "IC8", "IC9", "IC13"]


# ---------------------------------------------------------------------------
# bindings
# ---------------------------------------------------------------------------
_NO_DEFAULT = object()


@dataclass(frozen=True)
class Param:
    """A query parameter, with an optional default."""
    name: str
    default: Any = _NO_DEFAULT


@dataclass(frozen=True)
class Lit:
    value: Any


@dataclass(frozen=True)
class Out:
    """Public output ``key`` of plan node ``step`` (an index into the plan)."""
    step: int
    key: str


@dataclass(frozen=True)
class App:
    """Pure transform applied to resolved bindings: ``fn(*args)``."""
    fn: Callable
    args: Tuple = ()

    def __repr__(self):
        return f"App({getattr(self.fn, '__name__', self.fn)}, {self.args})"


Binding = Any   # Param | Lit | Out | App


@dataclass
class Env:
    """Resolution environment: query params + per-node public outputs.

    ``memo`` caches resolved table columns / id sets within one execution so
    an adapter's ``shape`` and ``witness`` don't redo the host-side work."""
    params: dict
    outputs: list = dc_field(default_factory=list)
    memo: dict = dc_field(default_factory=dict)


def resolve(b: Binding, env: Env):
    if isinstance(b, Param):
        if b.name in env.params:
            return env.params[b.name]
        if b.default is not _NO_DEFAULT:
            return b.default
        raise KeyError(f"missing query parameter {b.name!r}")
    if isinstance(b, Lit):
        return b.value
    if isinstance(b, Out):
        return env.outputs[b.step][b.key]
    if isinstance(b, App):
        return b.fn(*[resolve(a, env) for a in b.args])
    return b


# ---------------------------------------------------------------------------
# table references
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class BaseTable:
    """A published base table, referenced by registry descriptor."""
    desc: str


@dataclass(frozen=True)
class Chained:
    """An intermediate table whose columns are earlier nodes' public outputs.

    The verifier recomputes its data root from the (already verified) public
    instances of the referenced nodes — the chain glue of §III-D.
    """
    cols: Tuple[Binding, ...]

    def resolve_cols(self, env: Env) -> np.ndarray:
        arrs = [np.asarray(resolve(c, env), np.int64) for c in self.cols]
        if len(arrs[0]) == 0:
            return np.zeros((len(arrs), 1), np.int64)
        return np.stack(arrs)


TableRef = Any   # BaseTable | Chained


# ---------------------------------------------------------------------------
# plan nodes
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class Expand:
    """Single-source expansion (§IV-A), edge-list circuit.

    Outputs: ``src``, ``dst`` (+ ``prop`` when ``with_prop``)."""
    table: TableRef
    source: Binding
    with_prop: bool = False
    reverse: bool = False


@dataclass(frozen=True)
class SetExpand:
    """Set-based expansion (§IV-B), optionally integrated-BiRC (§IV-D).

    Outputs: ``src``, ``dst``."""
    table: TableRef
    ids: Binding
    bidirectional: bool = False


@dataclass(frozen=True)
class OrderBy:
    """Order-by + limit-k over a chained (value, payload) table (§IV-E).

    Outputs: ``vals``, ``pay`` (sorted)."""
    values: Binding
    payload: Binding
    k: Binding
    descending: bool = True


@dataclass(frozen=True)
class SSSP:
    """Single-source shortest-path verification (§IV-C), integrated BiRC.

    ``edge_table`` names the GraphDB edge table the untrusted BFS runs over;
    ``table`` is the published commitment binding for the circuit's data.
    Outputs: ``distances`` (all nodes), plus ``dist``/``distance`` (-1 when
    unreachable) when a target is given."""
    table: TableRef
    source: Binding
    target: Optional[Binding] = None
    edge_table: str = "person_knows_person"


@dataclass(frozen=True)
class NameFilter:
    """Attribute filter: keep (id, attr) pairs whose attr equals ``name``.

    Lowered to a reversed expansion over a chained pair table.
    Outputs: ``src`` (the attr), ``dst`` (the matching ids)."""
    table: TableRef
    name: Binding


@dataclass(frozen=True)
class Filter:
    """Order-predicate filter over a chained (id, value) pair table: keep
    rows whose value compares against the public ``threshold`` under ``cmp``
    (one of ``ge``/``gt``/``le``/``lt``/``eq``/``ne``).

    Outputs: ``src`` (the passing ids), ``dst`` (their values)."""
    table: TableRef
    cmp: str
    threshold: Binding


@dataclass(frozen=True)
class Aggregate:
    """Scalar aggregation over a chained single-column value table:
    ``agg`` is ``count`` (of nonzero entries), ``sum`` (mod P), or ``min``.

    Outputs: ``value`` (the aggregate, a public scalar)."""
    table: TableRef
    agg: str


@dataclass(frozen=True)
class Plan:
    name: str
    nodes: Tuple
    result: dict     # result key -> Binding


# ---------------------------------------------------------------------------
# binding transforms (pure, host-side glue)
# ---------------------------------------------------------------------------
def _concat(*arrs):
    return np.concatenate([np.asarray(a, np.int64) for a in arrs])


def _uniq_concat(*arrs):
    return np.unique(_concat(*arrs))


def _singleton(x):
    return np.asarray([x], np.int64)


def _nonzero(a):
    """Strip id 0 — the padding row Chained materializes for empty inputs."""
    a = np.asarray(a, np.int64)
    return a[a != 0]


def _length_or_1(a):
    return max(len(a), 1)


def _cap20(a):
    return min(20, max(len(a), 1))


def _new_frontier(p, new_dst, *prev_dsts):
    """BFS frontier: nodes first reached this hop (IC1's hop glue)."""
    seen = {int(p)}
    for d in prev_dsts:
        seen |= set(np.asarray(d, np.int64).tolist())
    nxt = [x for x in np.asarray(new_dst, np.int64).tolist() if x not in seen]
    return np.unique(np.asarray(nxt, np.int64)) if nxt else _singleton(p)


def _friends_minus(p, *dsts):
    f = _uniq_concat(*dsts)
    return f[f != int(p)]


# ---------------------------------------------------------------------------
# the LDBC SNB interactive plans (paper §V) — each a small pure function
# ---------------------------------------------------------------------------
def plan_is3() -> Plan:
    """Friends of p with friendship dates, newest first."""
    p = Param("person")
    fwd = Expand(BaseTable("knows_date"), p, with_prop=True)
    bwd = Expand(BaseTable("knows_date"), p, with_prop=True, reverse=True)
    dates = App(_concat, (Out(0, "prop"), Out(1, "prop")))
    friends = App(_concat, (Out(0, "dst"), Out(1, "dst")))
    top = OrderBy(dates, friends, k=App(_length_or_1, (friends,)))
    return Plan("IS3", (fwd, bwd, top),
                dict(friends=Out(2, "pay"), dates=Out(2, "vals")))


def plan_is4() -> Plan:
    """Content + creation date of a message."""
    st = Expand(BaseTable("comment_content_date"), Param("message"),
                with_prop=True)
    return Plan("IS4", (st,), dict(content=Out(0, "dst"), date=Out(0, "prop")))


def plan_is5() -> Plan:
    """Creator of a message."""
    st = Expand(BaseTable("hasCreator"), Param("message"))
    return Plan("IS5", (st,), dict(creator=Out(0, "dst")))


def plan_ic1() -> Plan:
    """Persons named firstName within 3 hops of p, top-20."""
    p = Param("person")
    hop1 = SetExpand(BaseTable("knows"), App(_singleton, (p,)),
                     bidirectional=True)
    hop2 = SetExpand(BaseTable("knows"),
                     App(_new_frontier, (p, Out(0, "dst"))),
                     bidirectional=True)
    hop3 = SetExpand(BaseTable("knows"),
                     App(_new_frontier, (p, Out(1, "dst"), Out(0, "dst"))),
                     bidirectional=True)
    cand = App(_uniq_concat, (Out(0, "dst"), Out(1, "dst"), Out(2, "dst")))
    names = SetExpand(BaseTable("person_firstName"), cand)
    filt = NameFilter(Chained((Out(3, "src"), Out(3, "dst"))),
                      Param("firstName"))
    matches = Out(4, "dst")
    top = OrderBy(matches, matches, k=App(_cap20, (matches,)))
    return Plan("IC1", (hop1, hop2, hop3, names, filt, top),
                dict(persons=Out(5, "pay")))


def _plan_messages_by(friends: Binding, hops: tuple, name: str) -> Plan:
    """Shared IC2/IC9 tail: messages by the friend set, newest first."""
    i = len(hops)
    msgs = SetExpand(BaseTable("hasCreator_rev"), friends)
    dated = SetExpand(BaseTable("comment_date"), Out(i, "dst"))
    top = OrderBy(Out(i + 1, "dst"), Out(i + 1, "src"), k=Param("k", 20))
    return Plan(name, hops + (msgs, dated, top),
                dict(messages=Out(i + 2, "pay"), dates=Out(i + 2, "vals")))


def plan_ic2() -> Plan:
    """Recent messages by friends of p."""
    hop = SetExpand(BaseTable("knows"), App(_singleton, (Param("person"),)),
                    bidirectional=True)
    friends = App(_uniq_concat, (Out(0, "dst"),))
    return _plan_messages_by(friends, (hop,), "IC2")


def plan_ic9() -> Plan:
    """Recent messages by friends and friends-of-friends of p."""
    p = Param("person")
    hop1 = SetExpand(BaseTable("knows"), App(_singleton, (p,)),
                     bidirectional=True)
    hop2 = SetExpand(BaseTable("knows"), App(_uniq_concat, (Out(0, "dst"),)),
                     bidirectional=True)
    friends = App(_friends_minus, (p, Out(0, "dst"), Out(1, "dst")))
    return _plan_messages_by(friends, (hop1, hop2), "IC9")


def plan_ic8() -> Plan:
    """Recent replies to p's messages."""
    mine = Expand(BaseTable("hasCreator"), Param("person"), reverse=True)
    replies = SetExpand(BaseTable("replyOf_rev"), Out(0, "dst"))
    dated = SetExpand(BaseTable("comment_date"), Out(1, "dst"))
    top = OrderBy(Out(2, "dst"), Out(2, "src"), k=Param("k", 20))
    return Plan("IC8", (mine, replies, dated, top),
                dict(replies=Out(3, "pay"), dates=Out(3, "vals")))


def plan_ic13() -> Plan:
    """Shortest-path distance between two persons (-1 if unreachable)."""
    st = SSSP(BaseTable("knows_nodes"), Param("person1"),
              target=Param("person2"))
    return Plan("IC13", (st,), dict(distance=Out(0, "distance")))


PLAN_BUILDERS = {
    "IS3": plan_is3, "IS4": plan_is4, "IS5": plan_is5, "IC1": plan_ic1,
    "IC2": plan_ic2, "IC8": plan_ic8, "IC9": plan_ic9, "IC13": plan_ic13,
}

def build_plan(qname: str) -> Plan:
    make = PLAN_BUILDERS.get(qname)
    if make is None:
        raise KeyError(f"unknown query {qname!r}; known: "
                       f"{sorted(PLAN_BUILDERS)}")
    return make()


# ---------------------------------------------------------------------------
# the generic IR executor
# ---------------------------------------------------------------------------
@dataclass
class Step:
    """One executed plan node: circuit + witness + chaining metadata."""
    op: Any                 # operators.common.Operator
    advice: np.ndarray
    instance: np.ndarray
    data: np.ndarray
    data_desc: str          # base-table descriptor or "chained"
    outputs: dict = dc_field(default_factory=dict)
    kind: str = ""          # registry adapter name
    shape: dict = dc_field(default_factory=dict)   # serializable build kwargs


@dataclass
class QueryRun:
    name: str
    steps: list
    result: dict


def execute(db, plan: Plan, params: dict) -> QueryRun:
    """Run the untrusted engine over every plan node, build each operator
    circuit + witness via the registry, and extract the public outputs that
    feed later nodes (the chained-commitment wiring)."""
    return execute_slice(db, plan, params, 0, len(plan.nodes))


def execute_slice(db, plan: Plan, params: dict, lo: int, hi: int,
                  seeds: Optional[dict] = None) -> QueryRun:
    """Run ``plan.nodes[lo:hi]`` only, with the outputs of earlier nodes
    pre-seeded from ``seeds`` (the entry point a federated owner uses to
    prove its sub-plan).

    ``seeds`` maps ``(step, key) -> int64 array``: the hand-off values a
    coordinator collected from the owners of the preceding segments.  Steps
    before ``lo`` get placeholder output dicts holding only the seeded
    keys, so a slice that reaches for an unseeded output fails loudly
    (``KeyError``) instead of recomputing another owner's data.  The
    ``result`` dict is resolved only when the slice runs to the end of the
    plan (``hi == len(plan.nodes)``); earlier slices return ``{}``."""
    from .operators import registry
    if not (0 <= lo <= hi <= len(plan.nodes)):
        raise ValueError(f"slice [{lo}, {hi}) out of range for "
                         f"{len(plan.nodes)}-node plan {plan.name!r}")
    env = Env(dict(params))
    env.outputs.extend({} for _ in range(lo))
    for (step, key), val in sorted((seeds or {}).items()):
        if not (isinstance(step, int) and 0 <= step < lo):
            raise ValueError(
                f"seeded output ({step!r}, {key!r}) is not a step before "
                f"the slice start {lo}")
        env.outputs[step][key] = np.asarray(val, np.int64)
    steps = []
    for node in plan.nodes[lo:hi]:
        ad = registry.adapter_for(node)
        shape = ad.shape(db, node, env)
        op = ad.build(shape)
        advice, instance, data = ad.witness(db, op, node, env)
        outputs = ad.extract_outputs(op, instance)
        env.outputs.append(outputs)
        steps.append(Step(op, advice, instance, data, ad.data_desc(node),
                          outputs, kind=ad.name, shape=shape))
    result = {}
    if hi == len(plan.nodes):
        result = {k: resolve(b, env) for k, b in plan.result.items()}
    return QueryRun(plan.name, steps, result)
