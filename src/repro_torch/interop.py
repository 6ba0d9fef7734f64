"""Carrying data into the port as plain numpy arrays and bytes.

For this system the "weights" are the committed database and the published
manifest.  These helpers take them in forms any producer can hand over —
numpy arrays and canonical bytes — so a test can give ``repro`` and the
port the same data without either package importing the other.
"""
from __future__ import annotations

import numpy as np

from .core import wire
from .core.commit import CommitmentManifest
from .graphdb.storage import EdgeTable, GraphDB


def graphdb_from_numpy(n_nodes: int, node_ids, tables: dict,
                       node_props: dict) -> GraphDB:
    """Build the port's :class:`GraphDB` from plain arrays.

    ``tables`` maps an edge-table name to ``(src, dst, props)`` with
    ``props`` a ``{name: array}`` dict; ``node_props`` maps an entity name
    to its ``{prop: array}`` dict.  Arrays are copied as int64."""
    def arr(a):
        return np.array(a, dtype=np.int64, copy=True)

    return GraphDB(
        n_nodes=int(n_nodes),
        node_ids=arr(node_ids),
        tables={name: EdgeTable(arr(src), arr(dst),
                                {k: arr(v) for k, v in props.items()})
                for name, (src, dst, props) in tables.items()},
        node_props={ent: {k: arr(v) for k, v in props.items()}
                    for ent, props in node_props.items()},
    )


def manifest_from_bytes(raw: bytes) -> CommitmentManifest:
    """The port's decoder applied to canonical manifest bytes (payload kind
    4); raises ``WireFormatError`` on malformed input."""
    return wire.decode_manifest(raw)
