#!/usr/bin/env python3
"""Run repro_torch's paths on one CUDA card and check them.

    python3 chip_smoke.py                 # every phase (the contract run)
    python3 chip_smoke.py --only build,parity,gp,batch,kernel_api
    python3 chip_smoke.py --trace DIR     # also trace one prove with
                                          # torch.profiler into DIR

Phases, one line each, any failure exits non-zero:

1. build      - compile the CUDA kernels from src/repro_torch/kernels/csrc
                (one nvcc per source, in parallel, for sm_90a);
2. parity     - each kernel against its plain PyTorch version on the card,
                exact equality, with CUDA-event timings of both and the
                kernel's device time from torch.profiler;
3. main       - the owner publishes the commitments of an LDBC instance with
                60,000-row fact tables, proves IS5, writes the bundle's
                canonical bytes; a verifier holding only
                TrustAnchor(manifest=...) accepts them and rejects them with
                one byte of the proof's data root flipped;
4. backends   - the same prove on the plain `torch` backend on the card
                gives the same canonical bytes;
5. gp         - the grand-product argument (paper Eq. (2)) at that scale:
                hasCreator's (comment, person) pairs against the same pairs
                sorted by person, in a 65,536-row circuit; keygen, prove,
                verify, a tampered witness rejected, and the `torch`
                backend's proof bytes equal;
6. batch      - prove_batch of four such lanes, and ZKGraphSession.
                prove_steps of two IS5 queries' steps, each lane byte for
                byte its solo proof;
7. kernel_api - the base-field running product, mulmod and fused_mul_add
                through their own entry points;
8. launches   - every kernel launched on the path it names (main: Poseidon
                and the NTT; gp and batch: the Fp4 running product;
                kernel_api: the other three).

The launch counts are set to 0 just before each path (phases 3, 5, 6, 7)
and read just after it.  Before the last line it prints the card's name
and power limit, and one JSON object describing each kernel; the last line
is the result object.  Without a CUDA device, or outside a checkout of the
repository, it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# the card's peaks at 700 W.  Memory: NVIDIA H100 SXM data sheet.  32-bit
# integer multiplies and multiply-adds: 64 per clock per SM on compute
# capability 9.0 (CUDA C++ Programming Guide, arithmetic instruction
# throughput), 132 SMs, 1.98 GHz boost clock.
HBM_BYTES_PER_S = 3.35e12
IMAD_PER_S = 64 * 132 * 1.98e9                       # 1.67e13
# a multiply mod the 31-bit P takes four 32-bit multiplies at least: the low
# and high words of a*b, then Montgomery's m = lo * (-1/P) mod 2^32 and the
# high word of m*P
IMADS_PER_MODMUL = 4
# modular multiplies one permutation needs: x^7 is 4, on 16 lanes in each of
# the 8 full rounds and on lane 0 in the 14 partial ones; the MDS, w^(i*j)
# for the 16th root of unity w, is a 16-point DFT, which a radix-2 FFT does
# with 17 multiplies by twiddles other than 1, once per round
POSEIDON_MODMULS = 4 * (8 * 16 + 14) + 22 * 17        # 942

# every shape the main path gives the kernels' largest launches: IS5's
# 65,536-row circuit (LDE 262,144) and publication's tables of up to 131,072
# rows (intt at 131,072, LDE and leaf hashing at 524,288)
POSEIDON_SHAPES = (1, 63, 64, 65, 130, 262144, 524288)
# the NTT kernel runs up to 11 stages a pass in shared memory: lengths on
# either side of one pass (2^10, 2^11, 2^12) and of two (2^22, 2^23, three
# passes), in batches of 1, 3 and 16, beside the main path's shapes
NTT_SHAPES = ((1, 64), (7, 32), (9, 128), (2, 3, 16), (4, 65536), (2, 262144),
              (2, 131072), (2, 524288)) + tuple(
                  (b, 1 << log_n) for log_n in (10, 11, 12, 22, 23)
                  for b in (1, 3, 16))
TIMED_POSEIDON = 262144            # leaf hashing of a 65,536-row circuit
TIMED_NTT = (2, 262144)            # coset LDE of IS5's two data columns
# running products: the gp path's 65,536-row circuit, and past it up to
# 2^19, the edges of a 512-element Fp4 and a 1,024-element Fp chunk, in 1
# lane ((n, 4) and (n,)) and in 3 and 4 lanes; each checked GP_REPEATS times,
# since a look-back scan that reads a stale status word fails only now and
# then.  Field ops: flat, ragged and the kernel_api path's shapes
GP_SHAPES = (1, 255, 256, 257, 511, 512, 513, 1023, 1024, 1025, 65536, 131072,
             524288)
GP_LANES_CHECKED = (1, 3, 4)
GP_REPEATS = 5
FIELD_SHAPES = ((1,), (257,), (4, 262144), (2, 524288))
TIMED_GP_EXT = 65536               # the gp path's circuit rows
TIMED_GP = 131072                  # the kernel_api path's telescoping check
TIMED_FIELD = (4, 262144)
# modular multiplies of one Fp4 product: 16 products and 3 multiplies by W
FP4_MODMULS = 19
N_FACTS = 60000                    # the paper's smallest LDBC instance
GP_ROWS = 65536                    # hasCreator's 60,000 rows, zero-padded
GP_LANES = 4
MESSAGE = (1 << 20) + 7

# every kernel of the port: its source, the TPU kernel body it replaces,
# and the path of this script that must launch it
KERNELS = {
    "poseidon_permute": ("src/repro_torch/kernels/csrc/poseidon.cu",
                         "src/repro/kernels/poseidon/poseidon.py:41", "main"),
    "ntt_stage": ("src/repro_torch/kernels/csrc/ntt.cu",
                  "src/repro/kernels/ntt/ntt.py:22", "main"),
    "grand_product_ext": (
        "src/repro_torch/kernels/csrc/grand_product.cu",
        "src/repro/kernels/grand_product/grand_product.py:119", "gp"),
    "grand_product": ("src/repro_torch/kernels/csrc/grand_product.cu",
                      "src/repro/kernels/grand_product/grand_product.py:32",
                      "kernel_api"),
    "mulmod": ("src/repro_torch/kernels/csrc/fieldops.cu",
               "src/repro/kernels/fieldops/fieldops.py:139", "kernel_api"),
    "fused_mul_add": ("src/repro_torch/kernels/csrc/fieldops.cu",
                      "src/repro/kernels/fieldops/fieldops.py:143",
                      "kernel_api"),
}
# kernels a path must launch besides those that name it
ALSO_ON = {"batch": ("grand_product_ext",)}
# the __global__ functions each kernel's wrapper launches, and the memset
# that clears the running products' status words before each launch
SYMBOLS = {
    "poseidon_permute": ("permute_kernel",),
    "ntt_stage": ("ntt_pass_kernel",),
    "grand_product_ext": ("running_product_kernel", "Memset"),
    "mulmod": ("fieldops_kernel",),
}
SYMBOLS["grand_product"] = SYMBOLS["grand_product_ext"]
SYMBOLS["fused_mul_add"] = SYMBOLS["mulmod"]


def log(msg: str):
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int = 10, warm: int = 2) -> float:
    """Warm median of one call, timed with CUDA events."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(torch, fn, symbols, reps: int = 10, traces: int = 3) -> float:
    """The card's own time for one call: the device time of the CUDA
    kernels (and memsets) whose names contain one of ``symbols``, in a
    torch.profiler trace of ``reps`` calls, per call.  Unlike
    :func:`cuda_ms` it leaves out the host's time between the launches.  A
    128 MiB write (a fill kernel, not a memset) before each call evicts the
    50 MB L2 cache, so the inputs come from device memory, as they do on
    the prover's path.  A trace now and then comes back without any of the
    card's activity, so an empty one is taken again, up to ``traces`` in
    all; if none shows the kernels, this raises."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    flush = torch.empty(1 << 24, dtype=torch.int64, device="cuda")
    fn()
    torch.cuda.synchronize()
    for attempt in range(1, traces + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                flush.fill_(1)
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
        mine = [e for e in events if "at::" not in e.key
                and any(sym in e.key for sym in symbols)]
        us = sum(e.self_device_time_total for e in mine)
        if us > 0:
            break
        log(f"[parity]   trace {attempt} of {traces} shows no device time "
            f"of {symbols} ({len(events)} device events in all)")
    else:
        raise AssertionError(f"{traces} traces show no device time of "
                             f"{symbols}")
    log(f"[parity]   device time of {reps} calls from "
        f"{sorted((e.key[:48], e.count) for e in mine)}")
    return us / reps / 1e3


def canonical_proof(proof) -> bytes:
    """Wire bytes of a proof with its wall-clock timings cleared, taken
    from a decoded copy."""
    proof = type(proof).from_bytes(proof.to_bytes())
    proof.timings = {}
    return proof.to_bytes()


def bound(ops: float, nbytes: float) -> tuple:
    """(bound ms, bound_by): the larger of the operation time at the card's
    32-bit multiply rate and the byte time at its memory rate."""
    t_ops, t_bytes = ops / IMAD_PER_S, nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


class Smoke:
    def __init__(self, args):
        import torch
        self.torch = torch
        self.args = args
        self.dev = torch.device("cuda:0")
        self.kernels = {
            name: dict(name=name, route="cuda", source=src, replaces=rep,
                       path=path, launches=None, max_abs_err=None, ms=None,
                       device_ms=None, plain_ms=None, bound_ms=None,
                       bound_by=None, library_ms=None)
            for name, (src, rep, path) in KERNELS.items()}
        self.path_counts = {}          # path -> launch counts of its run
        self._db = None

    def db(self):
        if self._db is None:
            from repro_torch.graphdb import ldbc
            t0 = time.perf_counter()
            self._db = ldbc.generate(n_knows=N_FACTS, n_comments=N_FACTS,
                                     seed=0)
            log(f"[data] ldbc.generate({N_FACTS} knows, {N_FACTS} comments, "
                f"{self._db.n_nodes} persons) in "
                f"{time.perf_counter() - t0:.2f} s")
        return self._db

    def cfg(self):
        from repro_torch.core import prover as pv
        return pv.ProverConfig(blowup=4, n_queries=16, fri_final_size=32)

    def drive(self, path: str, fn):
        """Run one path with every launch count set to 0 just before it,
        and keep the counts read just after it."""
        from repro_torch.core import backend as be
        be.reset_launch_counts()
        out = fn()
        self.torch.cuda.synchronize()
        self.path_counts[path] = be.launch_counts()
        return out

    def record(self, name: str, fn, ms: float, plain: float, ops: float,
               nbytes: float):
        """Keep a kernel's timed numbers: ``ms`` and ``plain`` (CUDA events
        around one call of the wrapper and of the plain version), the
        device time of ``fn`` (the wrapper call) and the bound."""
        b_ms, by = bound(ops, nbytes)
        dev_ms = device_ms(self.torch, fn, SYMBOLS[name])
        self.kernels[name].update(ms=ms, device_ms=dev_ms, plain_ms=plain,
                                  bound_ms=b_ms, bound_by=by)
        log(f"[parity] {name} device time {dev_ms:.5f} ms a call "
            f"(torch.profiler, L2 evicted); wrapper call {ms:.5f} ms (CUDA "
            f"events)")
        log(f"[parity] {name} bound: {ops:.4g} 32-bit multiplies = "
            f"{ops / IMAD_PER_S * 1e3:.5f} ms; {nbytes:.4g} bytes = "
            f"{nbytes / HBM_BYTES_PER_S * 1e3:.5f} ms -> {b_ms:.5f} ms "
            f"({by})")

    def device_line(self, name: str, what: str, fn):
        """Log the device time of one call of ``fn``: at a shape that fills
        one block, the kernel's fixed latency, which no size below it goes
        under; at a path's shape, what that path pays a call."""
        log(f"[parity] {name} at {what}: device time "
            f"{device_ms(self.torch, fn, SYMBOLS[name]):.5f} ms a call")

    # -- 1 ------------------------------------------------------------------
    def phase_build(self):
        from repro_torch.kernels import build
        t0 = time.perf_counter()
        build.load()
        secs = time.perf_counter() - t0
        log(f"[build] {build.build_info['library']} in {secs:.2f} s "
            f"(nvcc {build.build_info['seconds']:.2f} s)")
        for line in build.build_info["log"].splitlines():
            if "registers" in line or "spill" in line or line.startswith("=="):
                log(f"[build]   {line.strip()}")
        log(f"[build] card: {card_line()}")

    # -- 2 ------------------------------------------------------------------
    def phase_parity(self):
        import numpy as np
        torch = self.torch
        from repro_torch.core import backend as be
        from repro_torch.core import field as F
        from repro_torch.kernels.ntt import ops as ntt_ops, ref as ntt_ref
        from repro_torch.kernels.poseidon import ops as pos_ops, ref as pos_ref

        def rand(shape, seed):
            rng = np.random.default_rng(seed)
            return torch.from_numpy(
                rng.integers(0, F.P, size=shape, dtype=np.int64)).to(self.dev)

        def wild(shape, seed):
            """Canonical values with a tenth replaced by values >= P and a
            twentieth by negative int64 values, the first four by the int64
            extremes, -1 and P; made on the card from ``seed``.  The NTT and
            the running products reduce any int64 as their plain versions
            do (floored mod P)."""
            g = torch.Generator(device=self.dev).manual_seed(seed)
            x = torch.randint(0, F.P, shape, generator=g, device=self.dev)
            pick = torch.rand(shape, generator=g, device=self.dev)
            i64 = torch.iinfo(torch.int64)
            big = torch.randint(i64.min, i64.max, shape, generator=g,
                                device=self.dev)
            x = torch.where(pick < 0.05, big, x)
            x = torch.where((pick >= 0.05) & (pick < 0.1), x % F.P + F.P, x)
            x = torch.where((pick >= 0.1) & (pick < 0.15), -x, x)
            edge = torch.tensor([i64.min, i64.max, -1, F.P], device=self.dev)
            flat = x.view(-1)
            flat[:4] = edge[:flat.numel()]
            return x

        err = 0
        for n in POSEIDON_SHAPES:
            x = rand((n, 16), n)
            got, want = pos_ops.permute(x), pos_ref.permute_ref(x)
            torch.cuda.synchronize()
            e = int((got - want).abs().max())
            err = max(err, e)
            ms = cuda_ms(torch, lambda: pos_ops.permute(x))
            plain = cuda_ms(torch, lambda: pos_ref.permute_ref(x), reps=3)
            log(f"[parity] poseidon n={n}: max_abs_err={e} kernel "
                f"{ms:.4f} ms plain {plain:.4f} ms")
            if e != 0:
                raise AssertionError(f"poseidon kernel != plain at n={n}")
            if n == TIMED_POSEIDON:
                # POSEIDON_MODMULS modmuls a state, IMADS_PER_MODMUL each
                self.record("poseidon_permute",
                            lambda: pos_ops.permute(x), ms, plain,
                            n * POSEIDON_MODMULS * IMADS_PER_MODMUL,
                            2 * n * 16 * 8)
        self.kernels["poseidon_permute"]["max_abs_err"] = err

        err = 0
        for shape in NTT_SHAPES:
            for inverse in (False, True):
                x = wild(shape, sum(shape) + inverse)
                before = be.launch_counts()["ntt_stage"]
                got = ntt_ops.ntt(x, inverse=inverse)
                launches = be.launch_counts()["ntt_stage"] - before
                want = ntt_ref.ntt_ref(x, inverse=inverse)
                torch.cuda.synchronize()
                e = int((got - want).abs().max())
                err = max(err, e)
                ms = cuda_ms(torch, lambda: ntt_ops.ntt(x, inverse=inverse))
                plain = cuda_ms(
                    torch, lambda: ntt_ref.ntt_ref(x, inverse=inverse), reps=3)
                log(f"[parity] ntt {shape} inverse={inverse}: max_abs_err={e}"
                    f" launches {launches} kernel {ms:.4f} ms plain "
                    f"{plain:.4f} ms")
                if e != 0:
                    raise AssertionError(
                        f"ntt kernel != plain at {shape} inverse={inverse}")
                log_n = shape[-1].bit_length() - 1
                if launches != len(ntt_ops._passes(log_n)) or (
                        log_n <= 19 and launches > 2):
                    raise AssertionError(f"ntt at {shape} made {launches} "
                                         f"launches")
                if shape == (1, 1 << ntt_ops.MAX_STAGES) and not inverse:
                    self.device_line("ntt_stage", f"{shape} (one block)",
                                     lambda: ntt_ops.ntt(x, inverse=inverse))
                if shape == TIMED_NTT and not inverse:
                    b, n = shape
                    log_n = n.bit_length() - 1
                    self.record("ntt_stage",
                                lambda: ntt_ops.ntt(x, inverse=inverse),
                                ms, plain,
                                b * (n // 2) * log_n * IMADS_PER_MODMUL,
                                2 * b * n * 8)
        self.kernels["ntt_stage"]["max_abs_err"] = err
        self.parity_running_products(wild)
        self.parity_field_ops(rand)

    def parity_running_products(self, wild):
        torch = self.torch
        from repro_torch.core import backend as be
        from repro_torch.kernels.grand_product import ops, ref
        for ext, name in ((True, "grand_product_ext"),
                          (False, "grand_product")):
            kernel = ops.grand_product_ext if ext else ops.grand_product
            plain = ref.grand_product_ext_ref if ext else ref.grand_product_ref
            err = 0
            for lanes, n in ((lanes, n) for lanes in GP_LANES_CHECKED
                             for n in GP_SHAPES):
                shape = ((n,) if lanes == 1 else (lanes, n)) + (
                    (4,) if ext else ())
                x = wild(shape, 10 * n + 2 * lanes + ext)
                want = plain(x)
                before = be.launch_counts()[name]
                for _ in range(GP_REPEATS):
                    got = kernel(x)
                    torch.cuda.synchronize()
                    e = int((got - want).abs().max())
                    err = max(err, e)
                    if e != 0 or got.shape != want.shape:
                        raise AssertionError(f"{name} kernel != plain at "
                                             f"{shape}")
                launches = be.launch_counts()[name] - before
                if launches != GP_REPEATS:
                    raise AssertionError(f"{name} made {launches} launches "
                                         f"in {GP_REPEATS} calls")
                ms = cuda_ms(torch, lambda: kernel(x))
                if lanes == 1 and n == 1:
                    self.device_line(name, f"{shape} (one block)",
                                     lambda: kernel(x))
                if ext and lanes == GP_LANES and n == GP_ROWS:
                    self.device_line(name, f"{shape} (the batch path's)",
                                     lambda: kernel(x))
                timed = lanes == 1 and n == (TIMED_GP_EXT if ext else TIMED_GP)
                plain_ms = (cuda_ms(torch, lambda: plain(x), reps=3)
                            if lanes == 1 else None)
                log(f"[parity] {name} {shape}: max_abs_err={e} in "
                    f"{GP_REPEATS} calls, one launch each; kernel {ms:.4f} ms"
                    + (f" plain {plain_ms:.4f} ms" if plain_ms else ""))
                if timed:
                    # n products, each FP4_MODMULS modmuls (1 in the base
                    # field); (n, 4) or (n,) int64 read once, written once
                    self.record(name, lambda: kernel(x), ms, plain_ms,
                                n * (FP4_MODMULS if ext else 1)
                                * IMADS_PER_MODMUL,
                                2 * n * (4 if ext else 1) * 8)
            self.kernels[name]["max_abs_err"] = err

    def parity_field_ops(self, rand):
        torch = self.torch
        from repro_torch.kernels.fieldops import ops, ref
        for name, k in (("mulmod", 2), ("fused_mul_add", 3)):
            kernel, plain = getattr(ops, name), getattr(ref, name + "_ref")
            err = 0
            for shape in FIELD_SHAPES:
                xs = [rand(shape, sum(shape) + j) for j in range(k)]
                got, want = kernel(*xs), plain(*xs)
                torch.cuda.synchronize()
                e = int((got - want).abs().max())
                err = max(err, e)
                ms = cuda_ms(torch, lambda: kernel(*xs))
                plain_ms = cuda_ms(torch, lambda: plain(*xs), reps=3)
                log(f"[parity] {name} {shape}: max_abs_err={e} kernel "
                    f"{ms:.4f} ms plain {plain_ms:.4f} ms")
                if e != 0 or got.shape != want.shape:
                    raise AssertionError(f"{name} kernel != plain at {shape}")
                if shape == TIMED_FIELD:
                    n = got.numel()
                    # one modmul an element; k inputs read, one output
                    self.record(name, lambda: kernel(*xs), ms, plain_ms,
                                n * IMADS_PER_MODMUL,
                                (k + 1) * n * 8)
            self.kernels[name]["max_abs_err"] = err

    # -- 3 ------------------------------------------------------------------
    def phase_main(self):
        import numpy as np
        torch = self.torch
        from repro_torch.core import backend as be
        from repro_torch.core.session import TrustAnchor, ZKGraphSession

        db, cfg = self.db(), self.cfg()

        be.reset_launch_counts()
        t0 = time.perf_counter()
        owner = ZKGraphSession(db, cfg)
        manifest = owner.publish()
        torch.cuda.synchronize()
        t_pub = time.perf_counter() - t0
        after_pub = be.launch_counts()
        t0 = time.perf_counter()
        bundle = owner.prove("IS5", dict(message=MESSAGE))
        raw = bundle.to_bytes()
        torch.cuda.synchronize()
        t_prove = time.perf_counter() - t0
        after_prove = be.launch_counts()
        verifier = ZKGraphSession.verifier(
            anchor=TrustAnchor(manifest=manifest), cfg=cfg)
        t0 = time.perf_counter()
        ok = verifier.verify_bytes(raw)
        torch.cuda.synchronize()
        t_verify = time.perf_counter() - t0
        self.path_counts["main"] = counts = be.launch_counts()
        if not ok:
            raise AssertionError("the verifier rejected an honest IS5 bundle")
        root = np.asarray(bundle.steps[0].proof.data_root, "<u4").tobytes()
        at = raw.index(root)
        bad = bytearray(raw)
        bad[at] ^= 1
        if verifier.verify_bytes(bytes(bad)):
            raise AssertionError("the verifier accepted a flipped byte")
        sizes = sorted({n for (_, n) in manifest})
        log(f"[main] publish {len(manifest.tables)} tables at sizes {sizes}: "
            f"{t_pub:.3f} s")
        log(f"[main] prove IS5: {t_prove:.3f} s; verify: {t_verify:.3f} s; "
            f"bundle {len(raw)} bytes; flipped byte {at} rejected")
        t = db.tables["comment_hasCreator_person"]
        want = t.dst[t.src == MESSAGE]
        got = bundle.result["creator"]
        if not np.array_equal(got, want):
            raise AssertionError(f"IS5 result {got} != engine's {want}")
        log(f"[main] result creator={got.tolist()} matches the engine")
        for name in ("poseidon_permute", "ntt_stage"):
            log(f"[main] launches {name}: publish {after_pub[name]}, prove "
                f"{after_prove[name] - after_pub[name]}, verify "
                f"{counts[name] - after_prove[name]}")
        self.main = dict(publish_s=t_pub, prove_s=t_prove, verify_s=t_verify,
                         bundle_bytes=len(raw))
        self.owner, self.manifest, self.bundle = owner, manifest, bundle
        if self.args.trace:
            self.trace(owner)

    def trace(self, owner):
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile
        out = Path(self.args.trace)
        out.mkdir(parents=True, exist_ok=True)
        owner.prove("IS5", dict(message=MESSAGE))        # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            owner.prove("IS5", dict(message=MESSAGE))
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        prof.export_chrome_trace(str(out / "prove_is5_trace.json"))
        table = prof.key_averages().table(sort_by="cuda_time_total",
                                          row_limit=25)
        (out / "prove_is5_top.txt").write_text(table)
        from torch.autograd import DeviceType
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
        dev_s = sum(e.self_device_time_total for e in events) / 1e6
        untraced = self.main["prove_s"]
        log(f"[trace] device busy {dev_s:.4f} s in one prove: "
            f"{100 * dev_s / untraced:.1f}% of the untraced prove's "
            f"{untraced:.3f} s wall (the traced one took {wall:.3f} s)")
        for name in ("poseidon_permute", "ntt_stage"):     # IS5's kernels
            mine = [e for e in events if "at::" not in e.key and any(
                sym in e.key for sym in SYMBOLS[name])]
            log(f"[trace] {name}: "
                f"{sum(e.self_device_time_total for e in mine) / 1e3:.3f} ms "
                f"of device time in {sum(e.count for e in mine)} launches")
        for line in table.splitlines()[:16]:
            log(f"[trace] {line}")

    # -- 4 ------------------------------------------------------------------
    def phase_backends(self):
        from repro_torch.core import backend as be
        from repro_torch.core.session import ProofBundle, ZKGraphSession

        def canonical(bundle):
            b = ProofBundle.from_bytes(bundle.to_bytes())
            for step in b.steps:
                step.proof.timings = {}
            return b.to_bytes()

        cfg_t = dataclasses.replace(self.cfg(), backend="torch",
                                    device=str(self.dev))
        before = be.launch_counts()
        t0 = time.perf_counter()
        plain = ZKGraphSession(self.db(), cfg_t)
        manifest_t = plain.publish()
        t_pub = time.perf_counter() - t0
        t0 = time.perf_counter()
        bundle_t = plain.prove("IS5", dict(message=MESSAGE))
        t_plain = time.perf_counter() - t0
        if be.launch_counts() != before:
            raise AssertionError("the torch backend launched a kernel")
        if manifest_t.to_bytes() != self.manifest.to_bytes():
            raise AssertionError("cuda and torch backends published different "
                                 "manifests")
        if canonical(bundle_t) != canonical(self.bundle):
            raise AssertionError("cuda and torch backends gave different bytes")
        log(f"[backends] torch backend on the card: publish {t_pub:.3f} s, "
            f"manifest bytes equal the cuda backend's (all "
            f"{len(manifest_t.tables)} tables at every size); prove "
            f"{t_plain:.3f} s, canonical bundle bytes equal")

    # -- 5 ------------------------------------------------------------------
    def gp_witness(self, perm_seed=None):
        """(circuit, advice) of the Eq. (2) permutation check on hasCreator:
        advice a1, a2 are the table's (comment, person) pairs in table order,
        b1, b2 the same pairs sorted by person (``perm_seed`` None) or under
        ``np.random.default_rng(perm_seed)``'s permutation; rows past the
        table are zero in all four columns."""
        import numpy as np
        from repro_torch.core import field as F
        from repro_torch.core.plonkish import Circuit
        t = self.db().tables["comment_hasCreator_person"]
        c = Circuit(GP_ROWS, name="hasCreator_perm")
        a1, a2 = c.add_advice("a1"), c.add_advice("a2")
        b1, b2 = c.add_advice("b1"), c.add_advice("b2")
        c.add_grand_product("perm", [a1, a2], [b1, b2])
        pairs = np.zeros((GP_ROWS, 2), np.int64)
        pairs[:len(t.src), 0], pairs[:len(t.src), 1] = t.src, t.dst
        if perm_seed is None:
            perm = np.argsort(pairs[:len(t.src), 1], kind="stable")
            perm = np.concatenate([perm, np.arange(len(t.src), GP_ROWS)])
        else:
            perm = np.random.default_rng(perm_seed).permutation(GP_ROWS)
        advice = np.zeros((c.n_advice, GP_ROWS), np.uint32)
        advice[0], advice[1] = pairs[:, 0] % F.P, pairs[:, 1] % F.P
        advice[2], advice[3] = advice[0][perm], advice[1][perm]
        return c, advice

    def phase_gp(self):
        import numpy as np
        torch = self.torch
        from repro_torch.core import backend as be
        from repro_torch.core import field as F
        from repro_torch.core import prover as pv
        from repro_torch.core import verifier as vf
        cfg = self.cfg()
        inst = np.zeros((0, GP_ROWS), np.uint32)
        walls = {}

        def timed(key, fn):
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            walls[key] = time.perf_counter() - t0
            return out

        def run():
            circuit, advice = self.gp_witness()
            keys = timed("keygen", lambda: pv.keygen(circuit, cfg))
            proof = timed("prove", lambda: pv.prove(keys, advice.copy(),
                                                    inst))
            v_keys = timed("verifier keygen", lambda: pv.keygen(
                self.gp_witness()[0], cfg))
            ok = timed("verify", lambda: vf.verify(v_keys, inst, proof))
            return keys, advice, v_keys, proof, ok

        keys, advice, v_keys, proof, ok = self.drive("gp", run)
        if not ok:
            raise AssertionError("the verifier rejected an honest gp proof")
        raw = proof.to_bytes()
        n_pairs = self.db().tables["comment_hasCreator_person"].src.size
        log(f"[gp] hasCreator ({n_pairs} pairs) against itself sorted by "
            f"person, "
            f"{GP_ROWS} rows, LDE {GP_ROWS * cfg.blowup}: " +
            ", ".join(f"{k} {v:.3f} s" for k, v in walls.items()) +
            f"; proof {len(raw)} bytes; grand_product_ext launches "
            f"{self.path_counts['gp']['grand_product_ext']}")
        bad = advice.copy()
        bad[2, 5] = (int(bad[2, 5]) + 1) % F.P
        if vf.verify(v_keys, inst, pv.prove(keys, bad, inst)):
            raise AssertionError("the verifier accepted a tampered gp "
                                 "witness")
        log("[gp] a witness with one b1 cell changed: proof rejected")
        cfg_t = dataclasses.replace(cfg, backend="torch",
                                    device=str(self.dev))
        before = be.launch_counts()
        t0 = time.perf_counter()
        keys_t = pv.keygen(self.gp_witness()[0], cfg_t)
        proof_t = pv.prove(keys_t, advice.copy(), inst)
        torch.cuda.synchronize()
        t_plain = time.perf_counter() - t0
        if be.launch_counts() != before:
            raise AssertionError("the torch backend launched a kernel")
        if canonical_proof(proof_t) != canonical_proof(proof):
            raise AssertionError("cuda and torch backends gave different gp "
                                 "proof bytes")
        log(f"[gp] torch backend on the card: keygen + prove "
            f"{t_plain:.3f} s, no kernel launched, proof bytes equal")
        self.gp = dict(walls, proof_bytes=len(raw), keys=keys)

    # -- 6 ------------------------------------------------------------------
    def phase_batch(self):
        import numpy as np
        torch = self.torch
        from repro_torch.core import prover as pv
        from repro_torch.core import prover_batch as pvb
        from repro_torch.core import verifier as vf
        from repro_torch.core.session import ZKGraphSession
        cfg = self.cfg()
        keys = self.gp["keys"] if hasattr(self, "gp") else \
            pv.keygen(self.gp_witness()[0], cfg)
        inst = np.zeros((0, GP_ROWS), np.uint32)
        lanes = [self.gp_witness(k)[1] for k in range(GP_LANES)]
        owner = self.owner if hasattr(self, "owner") else \
            ZKGraphSession(self.db(), cfg)
        runs = [owner.run_query("IS5", dict(message=m))
                for m in (MESSAGE, MESSAGE + 6)]
        steps = [st for run in runs for st in run.steps]
        key0 = owner.step_shape_key(steps[0])
        if any(owner.step_shape_key(st) != key0 for st in steps[1:]):
            raise AssertionError("the IS5 steps differ in shape")
        walls = {}

        def run():
            t0 = time.perf_counter()
            proofs = pvb.prove_batch(keys, [(a.copy(), inst, None)
                                            for a in lanes])
            torch.cuda.synchronize()
            walls["prove_batch"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            step_proofs = owner.prove_steps(steps)
            torch.cuda.synchronize()
            walls["prove_steps"] = time.perf_counter() - t0
            return proofs, step_proofs

        proofs, step_proofs = self.drive("batch", run)
        t0 = time.perf_counter()
        solos = [pv.prove(keys, a.copy(), inst) for a in lanes]
        torch.cuda.synchronize()
        t_solo = time.perf_counter() - t0
        for k, (pf, solo) in enumerate(zip(proofs, solos, strict=True)):
            if canonical_proof(pf) != canonical_proof(solo):
                raise AssertionError(f"gp lane {k} differs from its solo "
                                     f"proof")
            if not vf.verify(keys, inst, pf):
                raise AssertionError(f"gp lane {k} does not verify")
        log(f"[batch] prove_batch of {GP_LANES} gp lanes ({GP_ROWS} rows, "
            f"permutations from default_rng(0..{GP_LANES - 1})): "
            f"{walls['prove_batch']:.3f} s against {t_solo:.3f} s for "
            f"{GP_LANES} solo proves; each lane equals its solo proof and "
            f"verifies; grand_product_ext launches "
            f"{self.path_counts['batch']['grand_product_ext']}")
        t0 = time.perf_counter()
        for k, (st, sp) in enumerate(zip(steps, step_proofs, strict=True)):
            solo = owner.prove_step(st)
            if canonical_proof(sp.proof) != canonical_proof(solo.proof):
                raise AssertionError(f"IS5 step lane {k} differs from "
                                     f"prove_step")
        torch.cuda.synchronize()
        t_steps = time.perf_counter() - t0
        log(f"[batch] prove_steps of {len(steps)} IS5 steps (messages "
            f"{MESSAGE}, {MESSAGE + 6}): {walls['prove_steps']:.3f} s; each "
            f"equals its prove_step ({len(steps)} solo {t_steps:.3f} s)")
        self.batch = dict(walls, solo_s=t_solo, steps_solo_s=t_steps)

    # -- 7 ------------------------------------------------------------------
    def phase_kernel_api(self):
        import numpy as np
        torch = self.torch
        from repro_torch.core import field as F
        from repro_torch.kernels.fieldops import ops as f_ops, ref as f_ref
        from repro_torch.kernels.grand_product import ops as gp_ops
        n = TIMED_GP
        rng = np.random.default_rng(n)
        vals = torch.from_numpy(rng.integers(1, F.P, size=n - 1)).to(self.dev)
        one = torch.ones(1, dtype=F.I64, device=self.dev)
        # Eq. (2) telescoping: ratios v[i] / v[i-1] of a cyclic sequence
        ratio = F.fmul(torch.cat([vals, one]), F.finv(torch.cat([one, vals])))
        xs = [torch.from_numpy(rng.integers(0, F.P, size=TIMED_FIELD))
              .to(self.dev) for _ in range(3)]

        def run():
            return (gp_ops.grand_product(ratio), f_ops.mulmod(*xs[:2]),
                    f_ops.fused_mul_add(*xs))

        z, prod, fma = self.drive("kernel_api", run)
        total = int(z[-1]) * int(ratio[-1]) % F.P
        if total != 1:
            raise AssertionError(f"telescoping product {total} != 1")
        if not torch.equal(prod, f_ref.mulmod_ref(*xs[:2])):
            raise AssertionError("mulmod != its plain version")
        if not torch.equal(fma, f_ref.fused_mul_add_ref(*xs)):
            raise AssertionError("fused_mul_add != its plain version")
        log(f"[kernel_api] grand_product of {n} telescoping ratios "
            f"multiplies back to 1; mulmod and fused_mul_add at "
            f"{TIMED_FIELD} equal their plain versions")

    # -- 8 ------------------------------------------------------------------
    def phase_launches(self):
        for name, info in self.kernels.items():
            paths = [info["path"]] + [p for p, ks in ALSO_ON.items()
                                      if name in ks]
            for path in paths:
                if path not in self.path_counts:
                    raise AssertionError(f"path {path} of kernel {name} did "
                                         f"not run")
                n = self.path_counts[path][name]
                log(f"[launches] {name}: {n} during the {path} path")
                if n <= 0:
                    raise AssertionError(f"kernel {name} never launched on "
                                         f"the {path} path")
            info["launches"] = self.path_counts[info["path"]][name]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", default="build,parity,main,backends,gp,batch,"
                    "kernel_api,launches",
                    help="comma-separated phases to run")
    ap.add_argument("--trace", default=None,
                    help="directory for a torch.profiler trace of one prove")
    args = ap.parse_args()
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; the port's main "
              "path runs on the card and does not fall back to the CPU",
              file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run this script "
              f"from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    phases = [p for p in args.only.split(",") if p]
    smoke = Smoke(args)
    t_all = time.perf_counter()
    for name in phases:
        t0 = time.perf_counter()
        try:
            getattr(smoke, f"phase_{name}")()
        except Exception:
            log(f"[{name}] FAILED")
            raise
        log(f"[{name}] ok ({time.perf_counter() - t0:.2f} s)")
    log(f"[done] {len(phases)} phases in {time.perf_counter() - t_all:.2f} s")
    print(card_line())
    print(json.dumps({"kernels": list(smoke.kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
