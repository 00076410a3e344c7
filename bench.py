"""Benchmark of the GPU calling path: the alignment kernel, and the 10 Mb run.

    python bench.py kernels   # XLA scan on the card: ms/call, pairs/s
    python bench.py e2e       # 10 Mb / 30x / --nCPU=1, three runs

Runs only on a GPU: without one it exits non-zero and prints no result.
Every result is one JSON line labelled with the device JAX reports
(platform, device_kind, count) and the card's name and power limit from
nvidia-smi.  Each e2e run is its own process, one at a time, so only one
process holds the card; it calls the 10 Mb twice and reports the second
(steady-state) run beside the first (compile or compile-cache loads).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
READ_LENGTHS = (100, 150)
LANES = (2048, 16384, 65536)
DATA_DIR = os.path.join(REPO, ".data", "mb10")
GOLDEN_10MB = os.path.join(REPO, "tests", "goldens", "reference_run",
                           "ref_synth_10mb.vcf.gz")


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def gpu_device() -> dict:
    """The device JAX reports; raises unless it is a GPU."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"no GPU: JAX reports {devs[0].platform!r}")
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def random_pairs(n: int, read_len: int, seed: int = 0):
    """n (haplotype segment, read) pairs: reads copied from the haplotype at
    a random band offset, with ~3 substitutions each, quality 30."""
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", np.uint8)
    hap = rng.choice(bases, size=(n, read_len + 15))
    offs = rng.integers(0, 8, size=n)
    read = hap[np.arange(n)[:, None], offs[:, None] + np.arange(read_len)]
    bi = rng.integers(0, n, 3 * n)
    read[bi, rng.integers(0, read_len, 3 * n)] = rng.choice(bases, 3 * n)
    go = np.full((n, read_len + 15), 45, np.uint8)
    qual = np.full((n, read_len), 30, np.uint8)
    return hap, go, read, qual, np.full(n, read_len, np.int32)


def time_per_call(fn, args, min_s: float = 0.5) -> float:
    """Seconds per call, back-to-back async calls ended by one wait."""
    import jax

    jax.block_until_ready(fn(*args))
    reps, dt = 1, 0.0
    while dt < min_s:
        reps *= 4
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn(*args)
        jax.block_until_ready(out)
        dt = time.perf_counter() - t0
    return dt / reps


def padded_columns(n: int, read_len: int, seed: int = 0):
    """Device columns of n random pairs, padded to the engine's read-length
    bucket as the engine pads them, plus the host arrays."""
    from platypus_tpu.engine.score import _l2_bucket
    from platypus_tpu.ops.align_jax import pad_alignment_inputs

    L2 = _l2_bucket(read_len)
    hap, go, read, qual, rl = random_pairs(n, read_len, seed)
    pad = lambda a, w, v=0: np.pad(a, ((0, 0), (0, w - a.shape[1])),
                                   constant_values=v)
    host = (pad(hap, L2 + 15, ord("N")), pad(go, L2 + 15), pad(read, L2),
            pad(qual, L2), rl)
    return pad_alignment_inputs(*host), host


def bench_kernels() -> None:
    from platypus_tpu.native import native_band_align_pairs
    from platypus_tpu.ops.align_jax import band_align_padded

    device = gpu_device()
    card = card_line()
    for read_len in READ_LENGTHS:
        cols, host = padded_columns(max(LANES), read_len)
        n = 16384
        idx = np.arange(n, dtype=np.int64)
        native = native_band_align_pairs(
            *(a[:n] for a in host[:4]), idx, idx, np.zeros(n, np.int64),
            host[4][:n], 3, 2, os.cpu_count() or 1)
        if native is None:
            raise SystemExit("native CPU kernel unavailable")
        for lanes in LANES:
            args = [c[..., :lanes] for c in cols]
            scores = np.asarray(band_align_padded(*args))
            # The first min(lanes, n) pairs are checked against the native kernel.
            identical = bool(np.array_equal(scores[:n], native[:lanes]))
            dt = time_per_call(band_align_padded, args)
            print(json.dumps({
                "bench": "kernel", "kernel": "xla_scan", "read_len": read_len,
                "lanes": lanes, "ms_per_call": dt * 1e3,
                "pairs_per_s": lanes / dt, "identical_to_native": identical,
                "device": device, "card": card}), flush=True)
            if not identical:
                raise SystemExit(f"scan differs from the native kernel at "
                                 f"read_len={read_len} lanes={lanes}")


def e2e_arm(out: str, region: str) -> None:
    """Two 10 Mb --nCPU=1 runs in this process: the first compiles (or
    loads from the compile cache) and warms the page cache, the second is
    the timed steady state."""
    from platypus_tpu.config import PlatypusConfig
    from platypus_tpu.engine.runner import run_variant_caller
    from platypus_tpu.utils.observability import GLOBAL_METRICS as metrics

    device = gpu_device()
    meta = json.load(open(os.path.join(DATA_DIR, "meta.json")))
    cfg = PlatypusConfig(bam_files=[os.path.join(DATA_DIR, "reads.bam")],
                         ref_file=os.path.join(DATA_DIR, "ref.fa"),
                         regions=[region], output=out, verbosity=1)
    walls = []
    for _ in range(2):
        metrics.reset()
        t0 = time.perf_counter()
        run_variant_caller(cfg)
        walls.append(time.perf_counter() - t0)
    print(json.dumps({
        "bench": "e2e_arm", "warm_wall_s": walls[0],
        "wall_s": walls[1], "reads_per_s": meta["n_reads"] / walls[1],
        "timers_s": dict(metrics.timers),
        "counters": dict(metrics.counters), "device": device}), flush=True)


def bench_e2e() -> None:
    import gzip

    card = card_line()
    subprocess.run([sys.executable, os.path.join(REPO, "tools", "scaling_bench.py"),
                    "--build-only", "--mb", "10", "--workdir",
                    os.path.dirname(DATA_DIR)],
                   check=True, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    golden = [l for l in gzip.open(GOLDEN_10MB, "rt") if not l.startswith("#")]
    env = dict(os.environ, JAX_PLATFORMS="cuda")
    out = os.path.join(DATA_DIR, "bench_e2e.vcf")
    region = "chr20:1-10000001"
    for _ in range(3):
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "e2e-arm",
             "--out", out, "--region", region],
            check=True, capture_output=True, text=True, env=env)
        row = json.loads(res.stdout.strip().splitlines()[-1])
        lines = [l for l in open(out) if not l.startswith("#")]
        row.update(golden_identical=lines == golden, card=card)
        print(json.dumps(row), flush=True)
        if lines != golden:
            raise SystemExit("10 Mb output differs from the golden")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("mode", choices=("kernels", "e2e", "e2e-arm"))
    ap.add_argument("--out")
    ap.add_argument("--region")
    args = ap.parse_args()
    if args.mode == "kernels":
        bench_kernels()
    elif args.mode == "e2e":
        bench_e2e()
    else:
        e2e_arm(args.out, args.region)
    return 0


if __name__ == "__main__":
    sys.exit(main())
