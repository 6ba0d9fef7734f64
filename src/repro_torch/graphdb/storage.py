"""Graph storage: edge-list tables (the paper's chosen format, §III-E) plus
dataset commitments (the 'declared dataset' the prover is bound to).

Node identifiers are positive integers; 0 is reserved as the dummy/sentinel
value used for padding rows (the ZKSQL-style dummy tag, §III-B).

The port's own copy of ``repro.graphdb.storage`` (numpy only, unchanged).
"""
from __future__ import annotations

from dataclasses import dataclass, field as dc_field

import numpy as np


@dataclass
class EdgeTable:
    """Directed edge list. Undirected relationships (person_knows_person) are
    stored canonically once; operators either canonicalize in-circuit (BiRC,
    §IV-D) or the table is pre-expanded via :func:`expand_bidirectional`."""
    src: np.ndarray
    dst: np.ndarray
    props: dict = dc_field(default_factory=dict)   # name -> np.ndarray

    def __len__(self):
        return len(self.src)

    def sorted_by_src(self) -> "EdgeTable":
        order = np.argsort(self.src, kind="stable")
        return EdgeTable(self.src[order], self.dst[order],
                         {k: v[order] for k, v in self.props.items()})

    def to_csr(self, node_ids: np.ndarray):
        """CSR arrays (paper §IV-A): col (targets), row_ptr, node_lut."""
        order = np.argsort(self.src, kind="stable")
        s, d = self.src[order], self.dst[order]
        node_lut = np.asarray(node_ids)
        row_ptr = np.zeros(len(node_lut) + 1, np.int64)
        counts = {nid: 0 for nid in node_lut.tolist()}
        idx_of = {nid: i for i, nid in enumerate(node_lut.tolist())}
        for x in s.tolist():
            counts[x] = counts.get(x, 0) + 1
        for i, nid in enumerate(node_lut.tolist()):
            row_ptr[i + 1] = row_ptr[i] + counts.get(nid, 0)
        # stable ordering of col by node_lut order
        col = np.zeros(len(s), np.int64)
        cursor = row_ptr[:-1].copy()
        for ss, dd in zip(s.tolist(), d.tolist()):
            i = idx_of[ss]
            col[cursor[i]] = dd
            cursor[i] += 1
        return col, row_ptr, node_lut


def expand_bidirectional(t: EdgeTable) -> EdgeTable:
    """Preprocessing strategy from Table IV: duplicate each edge in both
    directions (doubles the committed rows)."""
    return EdgeTable(np.concatenate([t.src, t.dst]),
                     np.concatenate([t.dst, t.src]),
                     {k: np.concatenate([v, v]) for k, v in t.props.items()})


@dataclass
class GraphDB:
    n_nodes: int                          # persons (node universe for traversal)
    node_ids: np.ndarray                  # person ids (1-based, unique)
    tables: dict                          # name -> EdgeTable
    node_props: dict = dc_field(default_factory=dict)  # prop -> array by id index

    @property
    def id_bits(self) -> int:
        mx = max(int(self.node_ids.max()),
                 *(int(t.dst.max(initial=1)) for t in self.tables.values()),
                 *(int(t.src.max(initial=1)) for t in self.tables.values()))
        return int(mx).bit_length() + 1


def pad_pow2(n: int) -> int:
    return 1 << max(4, (n - 1).bit_length())
