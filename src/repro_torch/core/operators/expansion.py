"""Single-source expansion (paper §IV-A), edge-list circuit design.

Edge-list: flag column + inverse-trick completeness gates + one multiset
permutation argument binding the public output table to the flagged edges.

PyTorch-port copy of the edge-list half of ``repro.core.operators.expansion``
(the CSR comparison design is not ported yet).
"""
from __future__ import annotations

import numpy as np

from ..plonkish import Circuit
from .common import Operator, eq_flag_gadget, fill_eq_flag, pad_col, region_selector


# ---------------------------------------------------------------------------
# edge-list format
# ---------------------------------------------------------------------------
def build_edge_list(n_rows: int, m_edges: int, with_prop: bool = False,
                    reverse: bool = False) -> Operator:
    """``reverse=True`` expands along incoming edges (flag on B, output
    (B, A)) over the *same* committed table — used for undirected relations
    and inverted traversals without re-committing data."""
    c = Circuit(n_rows, name="expand_el" + ("_rev" if reverse else ""))
    A = c.add_data("A")
    B = c.add_data("B")
    P = c.add_data("Val") if with_prop else None
    sel_e = region_selector(c, "sel_edge", m_edges)
    id_s = c.add_instance("id_s")
    out_sel = c.add_instance("out_sel")
    C_s = c.add_instance("C_s")
    C_t = c.add_instance("C_t")
    C_p = c.add_instance("C_p") if with_prop else None
    key, other = (B, A) if reverse else (A, B)
    fl, inv = eq_flag_gadget(c, "flag", key, id_s, sel_e)
    out_tuple = [C_s, C_t] + ([C_p] if with_prop else [])
    edge_tuple = [key, other] + ([P] if with_prop else [])
    c.add_multiset_equal("out_perm", out_tuple, out_sel, edge_tuple, fl)
    op = Operator(c.name, c)
    op.handles = dict(A=A, B=B, P=P, sel_e=sel_e, id_s=id_s, out_sel=out_sel,
                      C_s=C_s, C_t=C_t, C_p=C_p, fl=fl, inv=inv,
                      m_edges=m_edges, with_prop=with_prop, reverse=reverse)
    return op


def witness_edge_list(op: Operator, src, dst, id_s: int, prop=None):
    h = op.handles
    n = op.circuit.n_rows
    m = h["m_edges"]
    assert len(src) == m
    data = op.new_data()
    advice = op.new_advice()
    inst = op.new_instance()
    data[h["A"].index] = pad_col(src, n)
    data[h["B"].index] = pad_col(dst, n)
    if h["with_prop"]:
        data[h["P"].index] = pad_col(prop, n)
    key_col = data[h["B"].index] if h["reverse"] else data[h["A"].index]
    other_col = data[h["A"].index] if h["reverse"] else data[h["B"].index]
    sel = np.zeros(n, np.int64)
    sel[:m] = 1
    fill_eq_flag(advice, h["fl"], h["inv"], key_col, np.full(n, id_s), sel)
    flv = advice[h["fl"].index].astype(bool)
    k = int(flv.sum())
    inst[h["id_s"].index] = id_s
    inst[h["out_sel"].index, :k] = 1
    inst[h["C_s"].index, :k] = id_s
    inst[h["C_t"].index, :k] = other_col[flv]
    if h["with_prop"]:
        inst[h["C_p"].index, :k] = data[h["P"].index][flv]
    return advice, inst, data
