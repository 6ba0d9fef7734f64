"""Canonical proof-bundle wire format: versioned, deterministic, bounded.

PyTorch-port copy of ``repro.core.wire``: the header, the primitive encoder
and decoder, payload kinds 1-4 (bundle, proof, FRI proof, manifest) and the
config codec.  The bytes are the reference's; the decoders build the port's
classes.  (The checkpoint, gossip and federation kinds are not ported yet.)

Attacker-controlled bytes cross the verifier's trust boundary here (paper
§III-C assumes the verifier trusts only the owner's published commitments).
Design rules:

* **No code execution on decode.**  The format is a fixed grammar of tagged
  fields over five primitive kinds (ints, floats, strings, numpy arrays,
  containers); decoding allocates nothing before validating dtype, shape and
  remaining-byte bounds.
* **Versioned.**  Every message starts with ``MAGIC + version + payload
  kind``; a version or kind mismatch raises :class:`WireFormatError` (so a
  verifier fed a legacy / future bundle fails closed instead of
  mis-interpreting bytes).
* **Deterministic.**  Dict entries are sorted by their encoded key bytes and
  the decoder *rejects* out-of-order entries, so every bundle has exactly one
  canonical encoding and ``encode(decode(b)) == b`` byte-for-byte.
* **Bounded.**  Strings, containers, array dims and element counts all have
  hard caps; a length prefix larger than the remaining buffer is an error,
  never an allocation.
* **Schema-checked.**  A step's ``kind`` must name a registered operator
  adapter and its ``shape`` dict must match that adapter's declared
  ``shape_schema`` exactly (key set *and* types, ``bool`` distinct from
  ``int``) — malformed circuit geometry is rejected before the verifier
  does any work.

Grammar (all integers little-endian; the full byte-level spec with golden
test vectors is ``docs/protocol.md``)::

    message   := MAGIC(4) version:u16 kind:u8 body
    bundle    := Q query:str P params:value C cfg(4 x u32) G digest:arr(8,)
                 S nsteps:u32 step* R result:value
    step      := K kind:str H shape:value D desc:str I instance:arr F proof
    proof     := 4 roots:arr(8,) OPEN openings TREE tree_openings
                 FRI friproof T timings:value
    friproof  := roots:[arr(8,)] final:arr(n,4) qidx:arr(i64)
                 openings:[(rows:arr, paths:arr)]
    manifest  := V mver:u32 N n_nodes:i64 E edge_counts T tables R roots
    value     := tagged int | bool | float | str | arr | tuple | list | dict
    arr       := dtype:u8 ndim:u8 dims:u32* raw-bytes

Any deviation — truncation, a flipped tag, an oversized length, a wrong
dtype, trailing bytes — raises :class:`WireFormatError`.
"""
from __future__ import annotations

import struct

import numpy as np

MAGIC = b"ZKGB"
WIRE_VERSION = 3     # the reference's current wire version

# payload kinds (a message's top-level type)
KIND_BUNDLE = 1
KIND_PROOF = 2
KIND_FRI = 3
KIND_MANIFEST = 4

# hard caps: a malformed length prefix can never trigger a large allocation
MAX_STR = 4096
MAX_ITEMS = 1 << 16          # container entries (dict / list / tuple)
MAX_STEPS = 64
MAX_ARR_DIMS = 4
MAX_ARR_ELEMS = 1 << 24      # per-array element cap (64 MiB of int64)
MAX_FRI_LAYERS = 64
MAX_DEPTH = 16               # value-nesting cap (no RecursionError from bytes)
MAX_TABLES = 256             # manifest: registered base-table descriptors
MAX_SIZES = 64               # manifest: published circuit sizes per table
MAX_COLUMNS = 64             # manifest: named columns per table

# value tags
_T_INT, _T_BOOL, _T_FLOAT, _T_STR, _T_ARR, _T_TUPLE, _T_LIST, _T_DICT = \
    range(1, 9)

# struct field tags (explicit, one per field, checked in order)
_F_QUERY, _F_PARAMS, _F_CFG, _F_STEPS, _F_RESULT, _F_DIGEST = \
    0x01, 0x02, 0x03, 0x04, 0x05, 0x06
_F_KIND, _F_SHAPE, _F_DESC, _F_INSTANCE, _F_PROOF = \
    0x10, 0x11, 0x12, 0x13, 0x14
_F_ROOTS, _F_OPENINGS, _F_TREES, _F_FRI, _F_TIMINGS = \
    0x20, 0x21, 0x22, 0x23, 0x24
_F_FRI_ROOTS, _F_FRI_FINAL, _F_FRI_QIDX, _F_FRI_OPENS = \
    0x30, 0x31, 0x32, 0x33
_F_M_VERSION, _F_M_NNODES, _F_M_EDGES, _F_M_TABLES, _F_M_ROOTS = \
    0x40, 0x41, 0x42, 0x43, 0x44

_DTYPES = {0: np.dtype("<u4"), 1: np.dtype("<i8")}
_DTYPE_CODE = {np.dtype(np.uint32): 0, np.dtype(np.int64): 1}

_I64_MIN, _I64_MAX = -(1 << 63), (1 << 63) - 1


class WireFormatError(ValueError):
    """Malformed wire bytes: truncated, mistagged, oversized, mistyped, or
    schema-violating input.  Decoding raises this instead of executing or
    trusting anything; ``ZKGraphSession.verify_bytes`` maps it to ``False``."""


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------
class _Enc:
    def __init__(self):
        self.buf = bytearray()

    def u8(self, v: int):
        self.buf += struct.pack("<B", v)

    def u16(self, v: int):
        self.buf += struct.pack("<H", v)

    def u32(self, v: int):
        if not 0 <= int(v) < (1 << 32):
            raise WireFormatError(f"u32 out of range: {v}")
        self.buf += struct.pack("<I", int(v))

    def i64(self, v: int):
        v = int(v)
        if not _I64_MIN <= v <= _I64_MAX:
            raise WireFormatError(f"integer does not fit in i64: {v}")
        self.buf += struct.pack("<q", v)

    def f64(self, v: float):
        self.buf += struct.pack("<d", float(v))

    def string(self, s: str):
        if not isinstance(s, str):
            raise WireFormatError(f"expected str, got {type(s).__name__}")
        raw = s.encode("utf-8")
        if len(raw) > MAX_STR:
            raise WireFormatError(f"string too long: {len(raw)} > {MAX_STR}")
        self.u32(len(raw))
        self.buf += raw

    def array(self, a, dtype=None, ndim=None):
        a = np.ascontiguousarray(a)
        if dtype is not None:
            a = np.ascontiguousarray(a, np.dtype(dtype))
        code = _DTYPE_CODE.get(a.dtype.newbyteorder("<"))
        if code is None:
            code = _DTYPE_CODE.get(a.dtype)
        if code is None:
            raise WireFormatError(f"unsupported array dtype {a.dtype}")
        if ndim is not None and a.ndim != ndim:
            raise WireFormatError(f"expected {ndim}-d array, got {a.ndim}-d")
        if a.ndim > MAX_ARR_DIMS or a.size > MAX_ARR_ELEMS:
            raise WireFormatError(f"array too large: shape {a.shape}")
        self.u8(code)
        self.u8(a.ndim)
        for d in a.shape:
            self.u32(d)
        self.buf += a.astype(_DTYPES[code], copy=False).tobytes()

    def value(self, v, depth: int = 0):
        if depth > MAX_DEPTH:
            raise WireFormatError(f"value nesting deeper than {MAX_DEPTH}")
        if isinstance(v, bool) or isinstance(v, np.bool_):
            self.u8(_T_BOOL)
            self.u8(1 if v else 0)
        elif isinstance(v, (int, np.integer)):
            self.u8(_T_INT)
            self.i64(v)
        elif isinstance(v, (float, np.floating)):
            self.u8(_T_FLOAT)
            self.f64(v)
        elif isinstance(v, str):
            self.u8(_T_STR)
            self.string(v)
        elif isinstance(v, np.ndarray):
            self.u8(_T_ARR)
            self.array(v)
        elif isinstance(v, tuple):
            self.u8(_T_TUPLE)
            self._seq(v, depth)
        elif isinstance(v, list):
            self.u8(_T_LIST)
            self._seq(v, depth)
        elif isinstance(v, dict):
            self.u8(_T_DICT)
            self._dict(v, depth)
        else:
            raise WireFormatError(
                f"value of type {type(v).__name__} is not wire-encodable")

    def _seq(self, items, depth: int):
        if len(items) > MAX_ITEMS:
            raise WireFormatError(f"container too large: {len(items)}")
        self.u32(len(items))
        for it in items:
            self.value(it, depth + 1)

    def _dict(self, d: dict, depth: int):
        if len(d) > MAX_ITEMS:
            raise WireFormatError(f"dict too large: {len(d)}")
        encoded = []
        for k, v in d.items():
            ek = _Enc()
            ek.value(k, depth + 1)
            encoded.append((bytes(ek.buf), v))
        encoded.sort(key=lambda kv: kv[0])
        for i in range(1, len(encoded)):
            if encoded[i][0] == encoded[i - 1][0]:
                raise WireFormatError("duplicate dict key")
        self.u32(len(encoded))
        for kb, v in encoded:
            self.buf += kb
            self.value(v, depth + 1)


# ---------------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------------
class _Dec:
    def __init__(self, raw: bytes):
        if not isinstance(raw, (bytes, bytearray, memoryview)):
            raise WireFormatError(
                f"expected bytes, got {type(raw).__name__}")
        self.raw = bytes(raw)
        self.pos = 0

    def take(self, n: int) -> bytes:
        if n < 0 or self.pos + n > len(self.raw):
            raise WireFormatError(
                f"truncated input: need {n} bytes at offset {self.pos}, "
                f"have {len(self.raw) - self.pos}")
        out = self.raw[self.pos: self.pos + n]
        self.pos += n
        return out

    def done(self):
        if self.pos != len(self.raw):
            raise WireFormatError(
                f"{len(self.raw) - self.pos} trailing bytes after message")

    def u8(self) -> int:
        return self.take(1)[0]

    def u16(self) -> int:
        return struct.unpack("<H", self.take(2))[0]

    def u32(self) -> int:
        return struct.unpack("<I", self.take(4))[0]

    def i64(self) -> int:
        return struct.unpack("<q", self.take(8))[0]

    def f64(self) -> float:
        return struct.unpack("<d", self.take(8))[0]

    def tag(self, expected: int, what: str):
        got = self.u8()
        if got != expected:
            raise WireFormatError(
                f"bad field tag for {what}: expected {expected:#x}, "
                f"got {got:#x}")

    def string(self) -> str:
        n = self.u32()
        if n > MAX_STR:
            raise WireFormatError(f"string length {n} > {MAX_STR}")
        try:
            return self.take(n).decode("utf-8")
        except UnicodeDecodeError as e:
            raise WireFormatError(f"invalid utf-8 string: {e}") from None

    def array(self, dtype=None, ndim=None, shape=None) -> np.ndarray:
        code = self.u8()
        dt = _DTYPES.get(code)
        if dt is None:
            raise WireFormatError(f"unknown array dtype code {code}")
        if dtype is not None and dt != np.dtype(dtype):
            raise WireFormatError(
                f"expected {np.dtype(dtype)} array, got {dt}")
        nd = self.u8()
        if nd > MAX_ARR_DIMS:
            raise WireFormatError(f"array rank {nd} > {MAX_ARR_DIMS}")
        if ndim is not None and nd != ndim:
            raise WireFormatError(f"expected {ndim}-d array, got {nd}-d")
        dims = []
        elems = 1
        for _ in range(nd):
            d = self.u32()
            dims.append(d)
            elems *= max(d, 1)
            if elems > MAX_ARR_ELEMS:
                raise WireFormatError(f"array too large: dims {dims}")
        if shape is not None and tuple(dims) != tuple(shape):
            raise WireFormatError(
                f"expected array shape {tuple(shape)}, got {tuple(dims)}")
        nbytes = int(np.prod(dims, dtype=np.int64)) * dt.itemsize
        raw = self.take(nbytes)
        # .copy(): callers mutate instances/results; frombuffer is read-only
        return np.frombuffer(raw, dtype=dt).reshape(dims).copy()

    def value(self, depth: int = 0):
        if depth > MAX_DEPTH:
            raise WireFormatError(f"value nesting deeper than {MAX_DEPTH}")
        t = self.u8()
        if t == _T_BOOL:
            b = self.u8()
            if b not in (0, 1):
                raise WireFormatError(f"non-canonical bool byte {b}")
            return bool(b)
        if t == _T_INT:
            return self.i64()
        if t == _T_FLOAT:
            return self.f64()
        if t == _T_STR:
            return self.string()
        if t == _T_ARR:
            return self.array()
        if t in (_T_TUPLE, _T_LIST):
            n = self.u32()
            if n > MAX_ITEMS:
                raise WireFormatError(f"container length {n} > {MAX_ITEMS}")
            items = [self.value(depth + 1) for _ in range(n)]
            return tuple(items) if t == _T_TUPLE else items
        if t == _T_DICT:
            n = self.u32()
            if n > MAX_ITEMS:
                raise WireFormatError(f"dict length {n} > {MAX_ITEMS}")
            out = {}
            prev = None
            for _ in range(n):
                start = self.pos
                k = self.value(depth + 1)
                kb = self.raw[start: self.pos]
                if prev is not None and kb <= prev:
                    raise WireFormatError(
                        "non-canonical dict: keys not strictly sorted")
                prev = kb
                try:
                    out[k] = None
                except TypeError:
                    raise WireFormatError(
                        f"unhashable dict key {k!r}") from None
                out[k] = self.value(depth + 1)
            return out
        raise WireFormatError(f"unknown value tag {t:#x}")


# ---------------------------------------------------------------------------
# schema validation for step shapes
# ---------------------------------------------------------------------------
def check_shape_schema(kind: str, shape) -> dict:
    """Validate a step's declared circuit geometry against the registered
    adapter's ``shape_schema``: exact key set, exact value types (``bool`` is
    *not* accepted where ``int`` is declared, and vice versa)."""
    from .operators import registry
    if not isinstance(shape, dict):
        raise WireFormatError(
            f"step shape must be a dict, got {type(shape).__name__}")
    try:
        schema = registry.adapter_named(kind).shape_schema
    except KeyError:
        raise WireFormatError(f"unknown step kind {kind!r}") from None
    if set(shape) != set(schema):
        raise WireFormatError(
            f"step {kind!r} shape keys {sorted(shape)} do not match "
            f"schema {sorted(schema)}")
    for key, typ in schema.items():
        if type(shape[key]) is not typ:
            raise WireFormatError(
                f"step {kind!r} shape field {key!r} must be "
                f"{typ.__name__}, got {type(shape[key]).__name__}")
    return shape


# ---------------------------------------------------------------------------
# FriProof
# ---------------------------------------------------------------------------
def _fri_to_wire(e: _Enc, fp):
    if len(fp.layer_roots) > MAX_FRI_LAYERS:
        raise WireFormatError(f"too many FRI layers: {len(fp.layer_roots)}")
    if len(fp.layer_openings) != len(fp.layer_roots):
        raise WireFormatError("FRI layer roots/openings count mismatch")
    e.u8(_F_FRI_ROOTS)
    e.u32(len(fp.layer_roots))
    for r in fp.layer_roots:
        e.array(r, dtype=np.uint32, ndim=1)
    e.u8(_F_FRI_FINAL)
    e.array(fp.final_codeword, dtype=np.uint32, ndim=2)
    e.u8(_F_FRI_QIDX)
    e.array(fp.query_indices, dtype=np.int64, ndim=1)
    e.u8(_F_FRI_OPENS)
    e.u32(len(fp.layer_openings))
    for rows, paths in fp.layer_openings:
        e.array(rows, dtype=np.uint32, ndim=2)
        e.array(paths, dtype=np.uint32, ndim=3)


def _fri_from_wire(d: _Dec):
    from .fri import FriProof
    d.tag(_F_FRI_ROOTS, "fri.layer_roots")
    n_layers = d.u32()
    if n_layers > MAX_FRI_LAYERS:
        raise WireFormatError(f"FRI layer count {n_layers} > {MAX_FRI_LAYERS}")
    roots = [d.array(dtype=np.uint32, ndim=1, shape=(8,))
             for _ in range(n_layers)]
    d.tag(_F_FRI_FINAL, "fri.final_codeword")
    final = d.array(dtype=np.uint32, ndim=2)
    if final.shape[1] != 4:
        raise WireFormatError(
            f"final codeword must be (n, 4), got {final.shape}")
    d.tag(_F_FRI_QIDX, "fri.query_indices")
    qidx = d.array(dtype=np.int64, ndim=1)
    d.tag(_F_FRI_OPENS, "fri.layer_openings")
    n_open = d.u32()
    if n_open != n_layers:
        raise WireFormatError(
            f"FRI openings count {n_open} != layer count {n_layers}")
    openings = []
    for _ in range(n_open):
        rows = d.array(dtype=np.uint32, ndim=2)
        paths = d.array(dtype=np.uint32, ndim=3)
        if paths.shape[0] != rows.shape[0]:
            raise WireFormatError("FRI opening rows/paths leaf-count mismatch")
        openings.append((rows, paths))
    return FriProof(roots, final, qidx, openings)


# ---------------------------------------------------------------------------
# Proof
# ---------------------------------------------------------------------------
def _proof_to_wire(e: _Enc, p):
    e.u8(_F_ROOTS)
    for root in (p.data_root, p.advice_root, p.ext_root, p.quotient_root):
        e.array(root, dtype=np.uint32, ndim=1)
    e.u8(_F_OPENINGS)
    keys = sorted(p.openings)
    if len(keys) > MAX_ITEMS:
        raise WireFormatError(f"too many openings: {len(keys)}")
    e.u32(len(keys))
    for (kind, idx, rot) in keys:
        e.string(kind)
        e.u32(idx)
        e.u32(rot)
        e.array(p.openings[(kind, idx, rot)], dtype=np.uint32, ndim=1)
    e.u8(_F_TREES)
    names = sorted(p.tree_openings)
    e.u32(len(names))
    for name in names:
        rows, paths = p.tree_openings[name]
        e.string(name)
        e.array(rows, dtype=np.uint32, ndim=2)
        e.array(paths, dtype=np.uint32, ndim=3)
    e.u8(_F_FRI)
    _fri_to_wire(e, p.fri_proof)
    e.u8(_F_TIMINGS)
    e.value({str(k): float(v) for k, v in p.timings.items()})


def _proof_from_wire(d: _Dec):
    from .prover import Proof
    d.tag(_F_ROOTS, "proof.roots")
    roots = [d.array(dtype=np.uint32, ndim=1, shape=(8,)) for _ in range(4)]
    d.tag(_F_OPENINGS, "proof.openings")
    n = d.u32()
    if n > MAX_ITEMS:
        raise WireFormatError(f"openings count {n} > {MAX_ITEMS}")
    openings = {}
    prev = None
    for _ in range(n):
        kind = d.string()
        idx = d.u32()
        rot = d.u32()
        key = (kind, idx, rot)
        if prev is not None and key <= prev:
            raise WireFormatError("non-canonical openings order")
        prev = key
        openings[key] = d.array(dtype=np.uint32, ndim=1, shape=(4,))
    d.tag(_F_TREES, "proof.tree_openings")
    n = d.u32()
    if n > MAX_ITEMS:
        raise WireFormatError(f"tree openings count {n} > {MAX_ITEMS}")
    trees = {}
    prev = None
    for _ in range(n):
        name = d.string()
        if prev is not None and name <= prev:
            raise WireFormatError("non-canonical tree-openings order")
        prev = name
        rows = d.array(dtype=np.uint32, ndim=2)
        paths = d.array(dtype=np.uint32, ndim=3)
        if paths.shape[0] != rows.shape[0]:
            raise WireFormatError("tree opening rows/paths count mismatch")
        trees[name] = (rows, paths)
    d.tag(_F_FRI, "proof.fri_proof")
    fri_proof = _fri_from_wire(d)
    d.tag(_F_TIMINGS, "proof.timings")
    timings = d.value()
    if not isinstance(timings, dict) or not all(
            isinstance(k, str) and isinstance(v, float)
            for k, v in timings.items()):
        raise WireFormatError("proof timings must be a {str: float} dict")
    return Proof(roots[0], roots[1], roots[2], roots[3], openings, fri_proof,
                 trees, timings)


# ---------------------------------------------------------------------------
# StepProof / ProofBundle
# ---------------------------------------------------------------------------
def _step_to_wire(e: _Enc, step):
    check_shape_schema(step.kind, step.shape)
    e.u8(_F_KIND)
    e.string(step.kind)
    e.u8(_F_SHAPE)
    e.value(step.shape)
    e.u8(_F_DESC)
    e.string(step.data_desc)
    e.u8(_F_INSTANCE)
    e.array(step.instance, dtype=np.uint32, ndim=2)
    e.u8(_F_PROOF)
    _proof_to_wire(e, step.proof)


def _step_from_wire(d: _Dec):
    from .session import StepProof
    d.tag(_F_KIND, "step.kind")
    kind = d.string()
    d.tag(_F_SHAPE, "step.shape")
    shape = check_shape_schema(kind, d.value())
    d.tag(_F_DESC, "step.data_desc")
    desc = d.string()
    d.tag(_F_INSTANCE, "step.instance")
    instance = d.array(dtype=np.uint32, ndim=2)
    d.tag(_F_PROOF, "step.proof")
    proof = _proof_from_wire(d)
    return StepProof(kind, shape, desc, instance, proof)


def _header(e: _Enc, kind: int):
    e.buf += MAGIC
    e.u16(WIRE_VERSION)
    e.u8(kind)


def _check_header(d: _Dec, kind: int):
    magic = d.take(4)
    if magic != MAGIC:
        raise WireFormatError(
            f"bad magic {magic!r}: not a canonical proof message "
            f"(legacy pickle bundles are not accepted)")
    version = d.u16()
    if version != WIRE_VERSION:
        raise WireFormatError(
            f"unsupported wire version {version} (this verifier speaks "
            f"{WIRE_VERSION})")
    got = d.u8()
    if got != kind:
        raise WireFormatError(f"payload kind {got} != expected {kind}")


def encode_bundle(bundle) -> bytes:
    """Canonical bytes for a :class:`repro_torch.core.session.ProofBundle`."""
    e = _Enc()
    _header(e, KIND_BUNDLE)
    e.u8(_F_QUERY)
    e.string(bundle.query)
    e.u8(_F_PARAMS)
    e.value(dict(bundle.params))
    e.u8(_F_CFG)
    _cfg_to_wire(e, bundle.cfg)
    e.u8(_F_DIGEST)
    digest = bundle.manifest_digest
    if digest is None:
        raise WireFormatError(
            "bundle has no manifest_digest: prove against a published "
            "CommitmentManifest (ZKGraphSession.prove sets it)")
    digest = np.asarray(digest)
    if digest.shape != (8,):
        raise WireFormatError(
            f"manifest digest must have shape (8,), got {digest.shape}")
    e.array(digest, dtype=np.uint32, ndim=1)
    if len(bundle.steps) > MAX_STEPS:
        raise WireFormatError(f"too many steps: {len(bundle.steps)}")
    e.u8(_F_STEPS)
    e.u32(len(bundle.steps))
    for step in bundle.steps:
        _step_to_wire(e, step)
    e.u8(_F_RESULT)
    e.value(dict(bundle.result))
    return bytes(e.buf)


def decode_bundle(raw: bytes):
    """Decode + validate canonical bundle bytes; raises
    :class:`WireFormatError` on any malformed input."""
    from .session import ProofBundle
    d = _Dec(raw)
    _check_header(d, KIND_BUNDLE)
    d.tag(_F_QUERY, "bundle.query")
    query = d.string()
    d.tag(_F_PARAMS, "bundle.params")
    params = d.value()
    if not isinstance(params, dict) or not all(
            isinstance(k, str) for k in params):
        raise WireFormatError("bundle params must be a str-keyed dict")
    d.tag(_F_CFG, "bundle.cfg")
    cfg = _cfg_from_wire(d)
    d.tag(_F_DIGEST, "bundle.manifest_digest")
    digest = d.array(dtype=np.uint32, ndim=1, shape=(8,))
    d.tag(_F_STEPS, "bundle.steps")
    n_steps = d.u32()
    if n_steps > MAX_STEPS:
        raise WireFormatError(f"step count {n_steps} > {MAX_STEPS}")
    steps = [_step_from_wire(d) for _ in range(n_steps)]
    d.tag(_F_RESULT, "bundle.result")
    result = d.value()
    if not isinstance(result, dict) or not all(
            isinstance(k, str) for k in result):
        raise WireFormatError("bundle result must be a str-keyed dict")
    d.done()
    return ProofBundle(query, params, steps, result, cfg, digest)


def encode_proof(proof) -> bytes:
    """Standalone canonical bytes for one step's :class:`Proof`."""
    e = _Enc()
    _header(e, KIND_PROOF)
    _proof_to_wire(e, proof)
    return bytes(e.buf)


def decode_proof(raw: bytes):
    d = _Dec(raw)
    _check_header(d, KIND_PROOF)
    p = _proof_from_wire(d)
    d.done()
    return p


def encode_fri_proof(fp) -> bytes:
    """Standalone canonical bytes for a :class:`FriProof`."""
    e = _Enc()
    _header(e, KIND_FRI)
    _fri_to_wire(e, fp)
    return bytes(e.buf)


def decode_fri_proof(raw: bytes):
    d = _Dec(raw)
    _check_header(d, KIND_FRI)
    fp = _fri_from_wire(d)
    d.done()
    return fp


# ---------------------------------------------------------------------------
# CommitmentManifest: the owner's published trust root, canonically encoded
# ---------------------------------------------------------------------------
def _nonneg(v: int, what: str) -> int:
    v = int(v)
    if v < 0:
        raise WireFormatError(f"{what} must be non-negative, got {v}")
    return v


def _root8(root, what: str) -> np.ndarray:
    root = np.asarray(root)
    if root.shape != (8,):
        raise WireFormatError(
            f"{what} must be an (8,) digest, got shape {root.shape}")
    return root


def encode_manifest(manifest) -> bytes:
    """Canonical bytes for a :class:`repro_torch.core.commit.CommitmentManifest`.

    Deterministic (``encode(decode(b)) == b``): edge counts sort by table
    name, geometries by descriptor, roots by ``(descriptor, size)``; the
    decoder rejects out-of-order entries.  Every root entry must name a
    descriptor with published geometry and a size that geometry lists — the
    encoder enforces the same invariants, so the encodable set and the
    decodable set are the same language.  ``commit.manifest_digest``
    over these bytes is the digest bundles and log leaves bind to.
    """
    from .commit import MANIFEST_VERSION
    e = _Enc()
    _header(e, KIND_MANIFEST)
    e.u8(_F_M_VERSION)
    if manifest.version != MANIFEST_VERSION:
        raise WireFormatError(
            f"manifest version {manifest.version} != {MANIFEST_VERSION}")
    e.u32(manifest.version)
    e.u8(_F_M_NNODES)
    e.i64(_nonneg(manifest.n_nodes, "manifest n_nodes"))
    e.u8(_F_M_EDGES)
    if len(manifest.edge_counts) > MAX_TABLES:
        raise WireFormatError(
            f"too many edge tables: {len(manifest.edge_counts)}")
    e.u32(len(manifest.edge_counts))
    for name in sorted(manifest.edge_counts):
        e.string(name)
        e.i64(_nonneg(manifest.edge_counts[name], f"edge count {name!r}"))
    e.u8(_F_M_TABLES)
    if len(manifest.tables) > MAX_TABLES:
        raise WireFormatError(f"too many tables: {len(manifest.tables)}")
    e.u32(len(manifest.tables))
    for desc in sorted(manifest.tables):
        geo = manifest.tables[desc]
        if geo.desc != desc:
            raise WireFormatError(
                f"geometry desc {geo.desc!r} != manifest key {desc!r}")
        e.string(desc)
        e.u32(_nonneg(geo.n_cols, f"{desc!r} n_cols"))
        e.u32(_nonneg(geo.n_table_rows, f"{desc!r} n_table_rows"))
        if len(geo.sizes) > MAX_SIZES:
            raise WireFormatError(
                f"table {desc!r} has too many sizes: {len(geo.sizes)}")
        e.u32(len(geo.sizes))
        prev = -1
        for n in geo.sizes:
            if int(n) <= prev:
                raise WireFormatError(
                    f"table {desc!r} sizes must be strictly increasing")
            prev = int(n)
            e.u32(n)
        if len(geo.columns) > MAX_COLUMNS:
            raise WireFormatError(
                f"table {desc!r} has too many columns: {len(geo.columns)}")
        e.u32(len(geo.columns))
        for col in geo.columns:
            e.string(col)
    e.u8(_F_M_ROOTS)
    if len(manifest.roots) > MAX_TABLES * MAX_SIZES:
        raise WireFormatError(f"too many roots: {len(manifest.roots)}")
    e.u32(len(manifest.roots))
    for desc, size in sorted(manifest.roots):
        geo = manifest.tables.get(desc)
        if geo is None or int(size) not in {int(s) for s in geo.sizes}:
            raise WireFormatError(
                f"root for {(desc, size)} has no matching published geometry")
        e.string(desc)
        e.u32(size)
        e.array(_root8(manifest.roots[(desc, size)], f"root {(desc, size)}"),
                dtype=np.uint32, ndim=1)
    return bytes(e.buf)


def decode_manifest(raw: bytes):
    """Decode + validate canonical manifest bytes (fails closed on any
    malformed, non-canonical, or version-skewed input)."""
    from .commit import MANIFEST_VERSION, CommitmentManifest, TableGeometry
    d = _Dec(raw)
    _check_header(d, KIND_MANIFEST)
    d.tag(_F_M_VERSION, "manifest.version")
    mver = d.u32()
    if mver != MANIFEST_VERSION:
        raise WireFormatError(
            f"unsupported manifest version {mver} (this verifier speaks "
            f"{MANIFEST_VERSION})")
    d.tag(_F_M_NNODES, "manifest.n_nodes")
    n_nodes = d.i64()
    if n_nodes < 0:
        raise WireFormatError(f"negative n_nodes {n_nodes}")
    d.tag(_F_M_EDGES, "manifest.edge_counts")
    n = d.u32()
    if n > MAX_TABLES:
        raise WireFormatError(f"edge table count {n} > {MAX_TABLES}")
    edge_counts = {}
    prev = None
    for _ in range(n):
        name = d.string()
        if prev is not None and name <= prev:
            raise WireFormatError("non-canonical edge-count order")
        prev = name
        count = d.i64()
        if count < 0:
            raise WireFormatError(f"negative edge count for {name!r}")
        edge_counts[name] = count
    d.tag(_F_M_TABLES, "manifest.tables")
    n = d.u32()
    if n > MAX_TABLES:
        raise WireFormatError(f"table count {n} > {MAX_TABLES}")
    tables = {}
    prev = None
    for _ in range(n):
        desc = d.string()
        if prev is not None and desc <= prev:
            raise WireFormatError("non-canonical table-geometry order")
        prev = desc
        n_cols = d.u32()
        n_table_rows = d.u32()
        n_sizes = d.u32()
        if n_sizes > MAX_SIZES:
            raise WireFormatError(f"size count {n_sizes} > {MAX_SIZES}")
        sizes = []
        last = -1
        for _ in range(n_sizes):
            s = d.u32()
            if s <= last:
                raise WireFormatError(
                    f"table {desc!r} sizes not strictly increasing")
            last = s
            sizes.append(s)
        n_columns = d.u32()
        if n_columns > MAX_COLUMNS:
            raise WireFormatError(f"column count {n_columns} > {MAX_COLUMNS}")
        columns = tuple(d.string() for _ in range(n_columns))
        tables[desc] = TableGeometry(desc, n_cols, n_table_rows,
                                     tuple(sizes), columns)
    d.tag(_F_M_ROOTS, "manifest.roots")
    n = d.u32()
    if n > MAX_TABLES * MAX_SIZES:
        raise WireFormatError(f"root count {n} > {MAX_TABLES * MAX_SIZES}")
    roots = {}
    prev = None
    for _ in range(n):
        desc = d.string()
        size = d.u32()
        if prev is not None and (desc, size) <= prev:
            raise WireFormatError("non-canonical root order")
        prev = (desc, size)
        geo = tables.get(desc)
        if geo is None or size not in geo.sizes:
            raise WireFormatError(
                f"root for {(desc, size)} has no matching published geometry")
        roots[(desc, size)] = d.array(dtype=np.uint32, ndim=1, shape=(8,))
    d.done()
    return CommitmentManifest(mver, n_nodes, edge_counts, tables, roots)


# ---------------------------------------------------------------------------
# ProverConfig: the proof parameters a bundle carries (backend and device
# are execution policy and never serialized)
# ---------------------------------------------------------------------------
def _cfg_to_wire(e: _Enc, cfg):
    for v in (cfg.blowup, cfg.n_queries, cfg.fri_final_size, cfg.shift):
        e.u32(v)


def _cfg_from_wire(d: _Dec):
    from .prover import ProverConfig
    return ProverConfig(blowup=d.u32(), n_queries=d.u32(),
                        fri_final_size=d.u32(), shift=d.u32())
