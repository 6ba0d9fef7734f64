"""Synthetic LDBC SNB-like social network (paper §V experimental setup).

Entities: persons and comments. Fact tables:
  * person_knows_person      (undirected, canonical storage, creationDate prop)
  * comment_hasCreator_person (directed comment -> person, creationDate prop)
  * comment_replyOf_comment   (directed)
Sizes are controlled by the fact-table row counts like the paper's 60k/120k/
180k instances. Degree distribution is power-law-ish (preferential rewiring).

The port's own copy of ``repro.graphdb.ldbc`` (numpy only, unchanged).
"""
from __future__ import annotations

import numpy as np

from .storage import EdgeTable, GraphDB

PERSON_BASE = 1            # person ids: 1..n_persons
COMMENT_BASE = 1 << 20     # comment ids start here (disjoint from persons)


def generate(n_knows: int = 2048, n_persons: int = None, seed: int = 0,
             n_comments: int = None) -> GraphDB:
    rng = np.random.default_rng(seed)
    n_persons = n_persons or max(64, n_knows // 16)
    n_comments = n_comments if n_comments is not None else n_knows
    person_ids = np.arange(PERSON_BASE, PERSON_BASE + n_persons, dtype=np.int64)

    # -- person_knows_person: preferential-attachment flavoured ------------
    # weights grow with previous degree; canonical (one direction) storage
    deg_w = np.ones(n_persons)
    srcs = np.empty(n_knows, np.int64)
    dsts = np.empty(n_knows, np.int64)
    block = max(1, n_knows // 16)
    filled = 0
    while filled < n_knows:
        k = min(block, n_knows - filled)
        p = deg_w / deg_w.sum()
        a = rng.choice(n_persons, size=k, p=p)
        b = rng.choice(n_persons, size=k, p=p)
        mask = a != b
        a, b = a[mask], b[mask]
        srcs[filled:filled + len(a)] = person_ids[a]
        dsts[filled:filled + len(a)] = person_ids[b]
        np.add.at(deg_w, a, 1.0)
        np.add.at(deg_w, b, 1.0)
        filled += len(a)
    # canonicalize away duplicates direction-insensitively, keep multiplicity
    dates = rng.integers(20200101, 20250101, size=n_knows).astype(np.int64)
    knows = EdgeTable(srcs, dsts, {"creationDate": dates})

    # -- comments ------------------------------------------------------------
    comment_ids = np.arange(COMMENT_BASE, COMMENT_BASE + n_comments,
                            dtype=np.int64)
    creators = person_ids[rng.choice(n_persons, size=n_comments,
                                     p=deg_w / deg_w.sum())]
    cdates = rng.integers(20200101, 20250101, size=n_comments).astype(np.int64)
    has_creator = EdgeTable(comment_ids.copy(), creators,
                            {"creationDate": cdates})
    # replies point to earlier comments
    reply_src, reply_dst = [], []
    for i in range(1, n_comments):
        if rng.random() < 0.6:
            reply_src.append(int(comment_ids[i]))
            reply_dst.append(int(comment_ids[rng.integers(0, i)]))
    reply_of = EdgeTable(np.asarray(reply_src, np.int64),
                         np.asarray(reply_dst, np.int64))

    node_props = {
        "firstName": rng.integers(1, 2000, size=n_persons).astype(np.int64),
        "lastName": rng.integers(1, 2000, size=n_persons).astype(np.int64),
        "birthday": rng.integers(19500101, 20051231, size=n_persons).astype(np.int64),
    }
    comment_props = {
        "content": rng.integers(1, 1 << 27, size=n_comments).astype(np.int64),
        "creationDate": cdates,
        "length": rng.integers(1, 2000, size=n_comments).astype(np.int64),
    }
    return GraphDB(
        n_nodes=n_persons,
        node_ids=person_ids,
        tables={"person_knows_person": knows,
                "comment_hasCreator_person": has_creator,
                "comment_replyOf_comment": reply_of},
        node_props={"person": node_props, "comment": comment_props},
    )
