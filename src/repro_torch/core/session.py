"""ZKGraph session API: the query-serving entry point.

PyTorch-port counterpart of ``repro.core.session``.  A
:class:`ZKGraphSession` owns the published dataset commitments and a keygen
cache keyed by ``(circuit shape, fixed-columns digest, backend, device)``.

Owner side::

    owner = ZKGraphSession(db, cfg)
    bundle = owner.prove("IS5", dict(message=(1 << 20) + 7))
    raw = bundle.to_bytes()

Verifier side (no database access), trusting one :class:`TrustAnchor`::

    verifier = ZKGraphSession.verifier(
        anchor=TrustAnchor(manifest=owner.commitments), cfg=cfg)
    assert verifier.verify_bytes(raw)

A session runs on the backend and device of its ``ProverConfig``
(``backend``/``device``; by default the ``cuda`` backend on ``cuda:0``).
Constructing one where that cannot run raises
:class:`~repro_torch.core.backend.BackendUnavailableError`; nothing falls
back to the CPU.  The bundle is the canonical wire format of
:mod:`repro_torch.core.wire`, byte-identical to the reference's.
"""
from __future__ import annotations

import hashlib
import threading
from dataclasses import dataclass, field as dc_field

import numpy as np

from . import backend as be
from . import commit, ir, wire
from . import prover as pv
from .commit import CommitmentManifest, MissingCommitmentError
from .operators import registry
from .plonkish import Circuit
from .wire import WireFormatError

__all__ = ["KeygenCache", "MissingCommitmentError", "ProofBundle",
           "StepProof", "TrustAnchor", "WireFormatError", "ZKGraphSession",
           "circuit_shape_digest"]


# ---------------------------------------------------------------------------
# keygen cache
# ---------------------------------------------------------------------------
def circuit_shape_digest(circuit: Circuit) -> str:
    """Digest of everything the constraint system depends on: fixed-column
    values, the column layout, and the full gate/bus/gp *expressions* (two
    circuits that differ only in a constraint polynomial — e.g. ascending vs
    descending order-by — must not share keys).

    Memoized on the circuit (``Circuit._shape_digest``, invalidated by every
    structural mutation): the SHA-256 over all fixed-column bytes is paid
    once per circuit object, not on every cache lookup."""
    if circuit._shape_digest is not None:
        return circuit._shape_digest
    h = hashlib.sha256()
    h.update(repr(circuit.digest_seed()).encode())
    for name, col in zip(circuit.fixed_names, circuit.fixed_cols):
        h.update(name.encode())
        h.update(np.ascontiguousarray(col).tobytes())
    for names in (circuit.advice_names, circuit.instance_names,
                  circuit.data_names):
        h.update("\0".join(names).encode() + b"\1")
    for name, expr in circuit.gates:
        h.update(f"{name}={expr!r}".encode() + b"\1")
    for b in circuit.buses:
        h.update(repr((b.name, b.f_tuple, b.t_tuple, b.m_f, b.m_t,
                       b.t_sel)).encode() + b"\1")
    for g in circuit.gps:
        h.update(repr((g.name, g.c1_tuple, g.c2_tuple, g.sel1,
                       g.sel2)).encode() + b"\1")
    circuit._shape_digest = h.hexdigest()
    return circuit._shape_digest


@dataclass
class KeygenCache:
    """(circuit shape digest, prover config, backend, device) -> Keys.
    Shared by prover and verifier sessions; ``ensure`` attaches cached keys
    to an operator.  The resolved backend name and device are part of the
    key (cached ``Keys`` hold device buffers; PK/LDE caches never cross
    backends or devices).
    Bounded: oldest entries are evicted past ``max_entries`` so a
    long-lived verifier fed ever-fresh shapes cannot grow it without limit.

    Thread-safe with single-flight misses: concurrent ``ensure`` calls for
    the same key (the proving-service hot path — many queries hit the same
    circuit shapes) run keygen exactly once; the other callers block on the
    leader's in-flight event and reuse its Keys (``waits`` counts them).
    Distinct keys keygen concurrently — only bookkeeping is locked, never
    the keygen compute itself."""
    entries: dict = dc_field(default_factory=dict)
    hits: int = 0
    misses: int = 0
    waits: int = 0          # ensure() calls that blocked on another's keygen
    max_entries: int = 128
    _lock: threading.Lock = dc_field(default_factory=threading.Lock,
                                     repr=False, compare=False)
    _inflight: dict = dc_field(default_factory=dict, repr=False,
                               compare=False)   # key -> threading.Event

    @staticmethod
    def _key(op, cfg: pv.ProverConfig):
        name, device = be.resolve(cfg.backend, cfg.device)
        return (op.name, op.circuit.n_rows,
                (cfg.blowup, cfg.n_queries, cfg.fri_final_size, cfg.shift,
                 name, str(device)),
                circuit_shape_digest(op.circuit))

    def ensure(self, op, cfg: pv.ProverConfig):
        """Attach (possibly cached) keys to ``op``; keygen on first sight."""
        key = self._key(op, cfg)
        while True:
            wait_on = None
            with self._lock:
                keys = self.entries.get(key)
                if keys is not None:
                    self.hits += 1
                    self.entries[key] = self.entries.pop(key)  # LRU refresh
                    op.keys = keys
                    return op
                flight = self._inflight.get(key)
                if flight is None:
                    # this caller is the flight leader: keygen outside the
                    # lock (other keys must not serialize behind it)
                    flight = self._inflight[key] = threading.Event()
                    break
                self.waits += 1
                wait_on = flight
            wait_on.wait()
            # leader finished (or failed): re-check the cache / re-elect
        try:
            keys = pv.keygen(op.circuit, cfg)
        except BaseException:
            with self._lock:
                self._inflight.pop(key, None)
            flight.set()        # waiters wake, re-check, one re-leads
            raise
        with self._lock:
            self.misses += 1
            self.entries[key] = keys
            while len(self.entries) > self.max_entries:
                self.entries.pop(next(iter(self.entries)))
            self._inflight.pop(key, None)
        flight.set()
        op.keys = keys
        return op

    def stats(self) -> dict:
        with self._lock:
            return dict(hits=self.hits, misses=self.misses, waits=self.waits,
                        entries=len(self.entries))


# ---------------------------------------------------------------------------
# proof bundle
# ---------------------------------------------------------------------------
@dataclass
class StepProof:
    """One chained step: enough for a verifier to rebuild the circuit,
    re-derive the expected data root, and check the proof."""
    kind: str           # registry adapter name
    shape: dict         # serializable build kwargs
    data_desc: str      # base-table descriptor or "chained"
    instance: np.ndarray
    proof: pv.Proof


@dataclass
class ProofBundle:
    query: str
    params: dict
    steps: list         # [StepProof]
    result: dict        # claimed query result (re-derived by the verifier)
    cfg: pv.ProverConfig
    # digest of the canonical CommitmentManifest this bundle was proven
    # against ((8,) uint32); the verifier fails closed if it does not match
    # the manifest it trusts
    manifest_digest: np.ndarray = None

    def size_fields(self) -> int:
        return sum(s.proof.size_fields() for s in self.steps)

    def prove_seconds(self) -> float:
        return sum(s.proof.timings.get("total", 0.0) for s in self.steps)

    def to_bytes(self) -> bytes:
        """Canonical wire bytes (versioned + deterministic; never pickle)."""
        return wire.encode_bundle(self)

    @staticmethod
    def from_bytes(raw: bytes) -> "ProofBundle":
        """Decode canonical wire bytes.  Any malformed input — truncation,
        bad tags, oversized lengths, wrong dtypes, legacy pickle bytes, a
        mismatched wire version — raises :class:`WireFormatError`; nothing
        attacker-controlled is ever executed."""
        return wire.decode_bundle(raw)


def _values_equal(a, b) -> bool:
    return np.array_equal(np.asarray(a), np.asarray(b))


def _results_equal(a: dict, b: dict) -> bool:
    return set(a) == set(b) and all(_values_equal(a[k], b[k]) for k in a)


# ---------------------------------------------------------------------------
# trust anchor
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class TrustAnchor:
    """One owner's verification trust root, as a single typed value:
    ``TrustAnchor(manifest=m)``, an in-process
    :class:`~repro_torch.core.commit.CommitmentManifest` obtained out of
    band.  (The transparency-log checkpoint and gossip bootstraps are not
    ported yet.)"""
    manifest: CommitmentManifest | None = None

    def resolve(self) -> CommitmentManifest:
        """The manifest this anchor pins; raises ``TypeError`` if empty."""
        if self.manifest is None:
            raise TypeError("TrustAnchor needs a CommitmentManifest")
        return self.manifest


# ---------------------------------------------------------------------------
# the session
# ---------------------------------------------------------------------------
class ZKGraphSession:
    """Owns commitments + keygen cache; proves and verifies query bundles."""

    def __init__(self, db=None, cfg: pv.ProverConfig = None,
                 commitments: CommitmentManifest = None):
        self.db = db
        self.cfg = cfg or pv.ProverConfig()
        # resolve now: a session that cannot run on its backend and device
        # (the default cuda backend without a card) fails here, not later
        self.backend, self.device = be.resolve(self.cfg.backend,
                                               self.cfg.device)
        self._commitments = commitments
        self.cache = KeygenCache()

    def _scope(self):
        return be.use(self.backend, self.device)

    @classmethod
    def verifier(cls, anchor: TrustAnchor, cfg: pv.ProverConfig = None):
        """A verifier-side session: no database, trust root only.  The
        session pins the anchor's manifest digest, and :meth:`verify`
        rejects any bundle whose ``manifest_digest`` differs."""
        if not isinstance(anchor, TrustAnchor):
            raise TypeError("verifier needs anchor=TrustAnchor(manifest=...)")
        return cls(db=None, cfg=cfg, commitments=anchor.resolve())

    # -- owner side ---------------------------------------------------------
    @property
    def commitments(self) -> CommitmentManifest:
        if self._commitments is None:
            self._commitments = self.publish()
        return self._commitments

    def publish(self) -> CommitmentManifest:
        """(Re)compute the owner's commitment manifest (roots + geometry)."""
        assert self.db is not None, "publishing requires the database"
        with self._scope():
            self._commitments = commit.publish_commitments(self.db, self.cfg)
            self._commitments.digest()
        return self._commitments

    def run_query(self, qname: str, params: dict) -> ir.QueryRun:
        """Execute a query plan (engine + witnesses), no proving."""
        return self.run_plan(ir.build_plan(qname), params)

    def run_plan(self, plan: ir.Plan, params: dict) -> ir.QueryRun:
        """Execute an explicit :class:`~repro_torch.core.ir.Plan` object."""
        assert self.db is not None, "query execution requires the database"
        return ir.execute(self.db, plan, params)

    def prove(self, qname: str, params: dict) -> ProofBundle:
        """Prove a registered query by name.

        Resolves ``qname`` through :func:`~repro_torch.core.ir.build_plan`
        and delegates to :meth:`prove_plan`; returns one serializable
        :class:`ProofBundle`."""
        return self.prove_plan(ir.build_plan(qname), params, name=qname)

    def prove_plan(self, plan: ir.Plan, params: dict,
                   name: str = None) -> ProofBundle:
        """Prove an explicit plan object.

        The bundle's ``query`` field is ``name`` (default ``plan.name``);
        the verifier re-resolves that name through
        :func:`~repro_torch.core.ir.build_plan` and checks the proof against
        *its own* resolution, never the prover's plan object."""
        run = self.run_plan(plan, params)
        with self._scope():
            steps = [self.prove_step(st) for st in run.steps]
            digest = self.commitments.digest()
        return ProofBundle(name if name is not None else plan.name,
                           dict(params), steps, run.result, self.cfg, digest)

    # -- step-level prove entry points ---------------------------------------
    def step_shape_key(self, st: ir.Step):
        """The batching key of one executed plan step: two steps with equal
        keys share circuit structure, prover config, backend and device, so
        their witnesses can ride one lane-batched prove
        (:func:`~repro_torch.core.prover_batch.prove_batch`).  It is the
        keygen-cache key: the same Keys, the same transcript schedule."""
        return self.cache._key(st.op, self.cfg)

    def prove_step(self, st: ir.Step) -> StepProof:
        """Prove one executed plan step solo (keygen-cached)."""
        self.cache.ensure(st.op, self.cfg)
        proof = st.op.prove(st.advice, st.instance, st.data)
        return StepProof(st.kind, st.shape, st.data_desc, st.instance, proof)

    def prove_steps(self, steps: list) -> list[StepProof]:
        """Prove same-shaped steps as one lane-batched pass.

        Every step must carry the same :meth:`step_shape_key` (asserted):
        the lanes share Keys and every launch, and each lane's proof bytes
        equal what :meth:`prove_step` gives for it alone.  One step takes
        the solo path.  Returns one :class:`StepProof` per step, in order."""
        if len(steps) == 1:
            return [self.prove_step(steps[0])]
        from . import prover_batch as pvb
        key0 = self.step_shape_key(steps[0])
        for st in steps[1:]:
            assert self.step_shape_key(st) == key0, \
                "prove_steps lanes must share one circuit shape"
        for st in steps:
            self.cache.ensure(st.op, self.cfg)
        proofs = pvb.prove_batch(
            steps[0].op.keys,
            [(st.advice, st.instance, st.data) for st in steps],
            label=steps[0].op.name)
        return [StepProof(st.kind, st.shape, st.data_desc, st.instance, pf)
                for st, pf in zip(steps, proofs)]

    # -- verifier side ------------------------------------------------------
    def verify_bytes(self, raw: bytes,
                     commitments: CommitmentManifest = None) -> bool:
        """Decode + verify a serialized bundle; malformed bytes (including
        legacy pickle and version-mismatched encodings) are simply invalid —
        ``False``, never a crash, never code execution."""
        try:
            bundle = ProofBundle.from_bytes(raw)
        except WireFormatError:
            return False
        return self.verify(bundle, commitments)

    def verify(self, bundle: ProofBundle,
               commitments: CommitmentManifest = None) -> bool:
        """Check every step proof, its dataset-root binding, the published
        circuit geometry, the chained intermediate tables, and the claimed
        result.

        Base tables MUST match a published commitment (missing => raise) and
        their declared circuit geometry MUST match the published manifest
        (``manifest_pins`` + published-size membership) — neither is ever
        taken from prover-supplied data.  Only ``data_desc == "chained"``
        roots are recomputed, and then from the *verifier's own*
        re-derivation of the previous steps' outputs.
        """
        with self._scope():
            return self._verify(bundle, commitments)

    def _verify(self, bundle: ProofBundle,
                commitments: CommitmentManifest = None) -> bool:
        comms = commitments if commitments is not None else self.commitments
        if not isinstance(comms, CommitmentManifest):
            raise TypeError(
                "verification requires the owner's CommitmentManifest "
                "(publish_commitments); a bare root dict has no published "
                "geometry to pin circuit shapes against")
        if bundle.cfg != self.cfg:
            return False    # proof parameters below the session's policy
        # the bundle must have been proven against the SAME published
        # manifest this verifier trusts: a missing or mismatched digest
        # fails closed before any proof work
        if bundle.manifest_digest is None or not np.array_equal(
                np.asarray(bundle.manifest_digest), comms.digest()):
            return False
        try:
            plan = ir.build_plan(bundle.query)
        except KeyError:
            return False    # unknown query name = invalid bundle
        if len(plan.nodes) != len(bundle.steps):
            return False
        env = ir.Env(dict(bundle.params))
        try:
            for node, rec in zip(plan.nodes, bundle.steps):
                if not self._verify_step(comms, node, rec, env):
                    return False
            result = {k: ir.resolve(b, env) for k, b in plan.result.items()}
            return _results_equal(result, bundle.result)
        except MissingCommitmentError:
            raise                   # an owner/deployment problem, not a proof
        except (TypeError, KeyError, ValueError, AssertionError, IndexError):
            return False            # malformed bundle = invalid proof

    def _verify_step(self, comms: CommitmentManifest, node, rec,
                     env: ir.Env) -> bool:
        """Verify ONE plan step against ONE owner's manifest, appending the
        verifier's own re-derived outputs to ``env`` on success.

        This is the sole per-step decision procedure of :meth:`verify`."""
        ad = registry.adapter_for(node)
        if ad.name != rec.kind:
            return False
        # all structural checks happen BEFORE any keygen work, so a
        # malformed bundle cannot make the verifier burn keygen cycles
        desc = ad.data_desc(node)           # the PLAN's binding, never
        if rec.data_desc != desc:           # the bundle's claim
            return False
        try:                                # one schema check, shared
            wire.check_shape_schema(rec.kind, rec.shape)
        except WireFormatError:             # with the wire decoder:
            return False                    # exact keys, bool is not int
        for k, v in ad.shape_flags(node).items():
            if rec.shape.get(k) != v:       # semantic circuit flags are
                return False                # pinned by the plan node
        n_rows = rec.shape.get("n_rows")
        if not isinstance(n_rows, int) or n_rows <= 0:
            return False
        if desc == "chained":
            # the chain glue: step k's table is re-derived from
            # earlier verified outputs, and the declared shape must
            # match that re-derivation exactly
            if ad.shape(None, node, env) != rec.shape:
                return False
            cols = ad.chained_cols(node, env)
            expected = commit.data_root(cols, n_rows, self.cfg,
                                        desc="chained")
        else:
            # base tables: full circuit geometry is pinned against
            # the PUBLISHED manifest (missing tables raise; tampered
            # geometry over a published table is just invalid)
            geo = comms.geometry(desc)
            if n_rows not in geo.sizes:
                return False
            pins = ad.manifest_pins(node, env, comms, geo)
            if any(rec.shape.get(k) != v for k, v in pins.items()):
                return False
            expected = comms.root(desc, n_rows)
        op = self.cache.ensure(
            registry.build_operator(rec.kind, rec.shape), self.cfg)
        # the instance's public inputs must be the CLAIMED query's
        # (params + chained outputs), not whatever was proven
        if not ad.check_instance(op, rec.instance, node, env):
            return False
        if not op.verify(rec.instance, rec.proof,
                         expected_data_root=expected):
            return False
        env.outputs.append(ad.extract_outputs(op, rec.instance))
        return True
