#!/usr/bin/env python3
"""Run repro_torch's main path on one CUDA card and check it.

    python3 chip_smoke.py                 # every phase (the contract run)
    python3 chip_smoke.py --only build,parity
    python3 chip_smoke.py --trace DIR     # also trace one prove with
                                          # torch.profiler into DIR

Phases, one line each, any failure exits non-zero:

1. build    - compile the CUDA kernels from src/repro_torch/kernels/csrc
              (one nvcc per source, in parallel, for sm_90a);
2. parity   - each kernel against its plain PyTorch version on the card,
              exact equality, with CUDA-event timings of both;
3. main     - the owner publishes the commitments of an LDBC instance with
              60,000-row fact tables, proves IS5, writes the bundle's
              canonical bytes; a verifier holding only
              TrustAnchor(manifest=...) accepts them and rejects them with
              one byte of the proof's data root flipped;
4. backends - the same prove on the plain `torch` backend on the card gives
              the same canonical bytes;
5. launches - both kernels were launched during phase 3.

Before the last line it prints the card's name and power limit, and one
JSON object describing each kernel; the last line is the result object.
Without a CUDA device, or outside a checkout of the repository, it exits
non-zero and prints no result.
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
NTT_SHAPES = ((1, 64), (7, 32), (9, 128), (2, 3, 16), (4, 65536), (2, 262144),
              (2, 131072), (2, 524288))
TIMED_POSEIDON = 262144            # leaf hashing of a 65,536-row circuit
TIMED_NTT = (2, 262144)            # coset LDE of IS5's two data columns
N_FACTS = 60000                    # the paper's smallest LDBC instance
MESSAGE = (1 << 20) + 7


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


class Smoke:
    def __init__(self, args):
        import torch
        self.torch = torch
        self.args = args
        self.dev = torch.device("cuda:0")
        self.kernels = {}

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
        from repro_torch.core import field as F
        from repro_torch.kernels.ntt import ops as ntt_ops, ref as ntt_ref
        from repro_torch.kernels.poseidon import ops as pos_ops, ref as pos_ref

        def rand(shape, seed):
            rng = np.random.default_rng(seed)
            return torch.from_numpy(
                rng.integers(0, F.P, size=shape, dtype=np.int64)).to(self.dev)

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
                ops = n * POSEIDON_MODMULS * IMADS_PER_MODMUL
                nbytes = 2 * n * 16 * 8
                bound = max(ops / IMAD_PER_S, nbytes / HBM_BYTES_PER_S)
                self.kernels["poseidon_permute"] = dict(
                    name="poseidon_permute", route="cuda",
                    source="src/repro_torch/kernels/csrc/poseidon.cu",
                    replaces="src/repro/kernels/poseidon/poseidon.py:41",
                    launches=None, max_abs_err=None, ms=ms, plain_ms=plain,
                    bound_ms=bound * 1e3,
                    bound_by=("operations" if ops / IMAD_PER_S
                              >= nbytes / HBM_BYTES_PER_S else "bytes"),
                    library_ms=None)
                log(f"[parity] poseidon bound at n={n}: {POSEIDON_MODMULS} "
                    f"modmuls/state x {IMADS_PER_MODMUL} IMAD at "
                    f"{IMAD_PER_S:.4g}/s = {ops / IMAD_PER_S * 1e3:.5f} ms; "
                    f"{nbytes} bytes = "
                    f"{nbytes / HBM_BYTES_PER_S * 1e3:.5f} ms")
        self.kernels["poseidon_permute"]["max_abs_err"] = err

        err = 0
        for shape in NTT_SHAPES:
            for inverse in (False, True):
                x = rand(shape, sum(shape) + inverse)
                got = ntt_ops.ntt(x, inverse=inverse)
                want = ntt_ref.ntt_ref(x, inverse=inverse)
                torch.cuda.synchronize()
                e = int((got - want).abs().max())
                err = max(err, e)
                ms = cuda_ms(torch, lambda: ntt_ops.ntt(x, inverse=inverse))
                plain = cuda_ms(
                    torch, lambda: ntt_ref.ntt_ref(x, inverse=inverse), reps=3)
                log(f"[parity] ntt {shape} inverse={inverse}: max_abs_err={e}"
                    f" kernel {ms:.4f} ms plain {plain:.4f} ms")
                if e != 0:
                    raise AssertionError(
                        f"ntt kernel != plain at {shape} inverse={inverse}")
                if shape == TIMED_NTT and not inverse:
                    b, n = shape
                    log_n = n.bit_length() - 1
                    ops = b * (n // 2) * log_n * IMADS_PER_MODMUL
                    nbytes = 2 * b * n * 8
                    bound = max(ops / IMAD_PER_S, nbytes / HBM_BYTES_PER_S)
                    self.kernels["ntt_stage"] = dict(
                        name="ntt_stage", route="cuda",
                        source="src/repro_torch/kernels/csrc/ntt.cu",
                        replaces="src/repro/kernels/ntt/ntt.py:22",
                        launches=None, max_abs_err=None, ms=ms,
                        plain_ms=plain, bound_ms=bound * 1e3,
                        bound_by=("operations" if ops / IMAD_PER_S
                                  >= nbytes / HBM_BYTES_PER_S else "bytes"),
                        library_ms=None)
        self.kernels["ntt_stage"]["max_abs_err"] = err

    # -- 3 ------------------------------------------------------------------
    def phase_main(self):
        import numpy as np
        torch = self.torch
        from repro_torch.core import backend as be
        from repro_torch.core import prover as pv
        from repro_torch.core.session import TrustAnchor, ZKGraphSession
        from repro_torch.graphdb import ldbc

        t0 = time.perf_counter()
        db = ldbc.generate(n_knows=N_FACTS, n_comments=N_FACTS, seed=0)
        log(f"[main] ldbc.generate({N_FACTS} knows, {N_FACTS} comments, "
            f"{db.n_nodes} persons) in {time.perf_counter() - t0:.2f} s")
        cfg = pv.ProverConfig(blowup=4, n_queries=16, fri_final_size=32)
        self.cfg, self.db = cfg, db

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
        self.counts = be.launch_counts()
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
        for name in self.counts:
            log(f"[main] launches {name}: publish {after_pub[name]}, prove "
                f"{after_prove[name] - after_pub[name]}, verify "
                f"{self.counts[name] - after_prove[name]}")
        self.main = dict(publish_s=t_pub, prove_s=t_prove, verify_s=t_verify,
                         bundle_bytes=len(raw))
        self.manifest, self.bundle = manifest, bundle
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
        dev_s = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA) / 1e6
        untraced = self.main["prove_s"]
        log(f"[trace] device busy {dev_s:.4f} s in one prove: "
            f"{100 * dev_s / untraced:.1f}% of the untraced prove's "
            f"{untraced:.3f} s wall (the traced one took {wall:.3f} s)")
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

        cfg_t = dataclasses.replace(self.cfg, backend="torch",
                                    device=str(self.dev))
        before = be.launch_counts()
        t0 = time.perf_counter()
        plain = ZKGraphSession(self.db, cfg_t)
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
    def phase_launches(self):
        for name, n in self.counts.items():
            log(f"[launches] {name}: {n} during the main path")
            if n <= 0:
                raise AssertionError(f"kernel {name} never launched")
            self.kernels[name]["launches"] = n


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", default="build,parity,main,backends,launches",
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
    if set(smoke.kernels) == {"poseidon_permute", "ntt_stage"}:
        print(json.dumps({"kernels": list(smoke.kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
