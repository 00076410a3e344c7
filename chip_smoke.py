"""Smoke test of the calling path on the GPU.

    python chip_smoke.py                # one card
    python chip_smoke.py --four-cards   # the mesh path on four cards, only

One card, in order:
  1. the card's name and power limit; JAX must report a GPU;
  2. kernel parity on the card: the alignment scan against the reference
     goldens and, at 16384 lanes of 100 and 150 bp reads, against the
     native CPU kernel (pairs/s of the scan); the traceback scan against
     the scalar oracle and the flank goldens;
  3. `callVariants --nCPU=1` on the 10 Mb / 30x synthetic set: data lines
     byte-identical to tests/goldens/reference_run/ref_synth_10mb.vcf.gz,
     and every alignment pair and some inference windows on the device;
  4. `--nCPU=4` (hybrid pool, auto) on the same data: the same bytes, and
     again with the host workers slowed so the device worker claims
     regions: the same bytes, and alignment and inference on the card in
     the device worker;
  5. `--calculateFlankScore=1` on the first 1 Mb: the same bytes as the
     CPU-pinned run of the same command (docs/PARITY.md §15).
Four cards: `callVariants --meshDevices=4` on the 10 Mb set against the
golden, which the one-card run reproduces byte for byte.

The parent never imports jax: each phase is a child process, one at a
time, so only one process holds the card and no phase shares the host with
another.  The dataset build and the twin of phase 5 are pinned to the CPU.
Wall times here are a smoke's; throughput comes from `bench.py e2e`.  Without a
GPU, or outside the repository, the script exits non-zero and prints no
result.  A failed phase prints {"ok": false, ...} and exits non-zero.  The
last line of a passing run is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import re
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(REPO, ".data")
MB10 = os.path.join(DATA, "mb10")
OUT = os.path.join(REPO, "chiprun_out", "smoke")
GOLDENS = os.path.join(REPO, "tests", "goldens")
REGION_10MB = "chr20:1-10000001"
REGION_1MB = "chr20:1-1000001"
GPU_ENV = dict(os.environ, JAX_PLATFORMS="cuda")
CPU_ENV = dict(os.environ, JAX_PLATFORMS="cpu", PLATYPUS_TPU_PLATFORM="cpu")
# The 10 Mb runs.  At --nCPU=4 the host workers drain the set in ~5 s, before
# the device worker has started, so the pool's own rule rightly leaves the
# card idle (ncpu4).  ncpu4_device slows each host region by 1 s and
# opens the device worker's first claim, so the same data lasts long enough
# for the device worker to claim regions and call them on the card.
HYBRID_RUNS = (
    ("ncpu1", ["--nCPU=1"], GPU_ENV),
    ("ncpu4", ["--nCPU=4"], GPU_ENV),
    ("ncpu4_device", ["--nCPU=4"],
     dict(GPU_ENV, PLATYPUS_TPU_DEVICE_SETTLE="0",
          PLATYPUS_TPU_TEST_HOST_DELAY="1.0")),
)
DEVICE_METRICS = ("alignment_pairs", "device_alignment_pairs",
                  "device_alignment", "device_inference",
                  "device_inference_windows")


class PhaseFailed(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseFailed(msg)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


# ---------------------------------------------------------------------------
# Children (each opens the card on its own)
# ---------------------------------------------------------------------------

def phase_device() -> None:
    from bench import gpu_device

    emit({"phase": "device", "device": gpu_device()})


def phase_kernels() -> None:
    """Kernel parity on the card (prints one JSON line)."""
    import jax
    import numpy as np

    from bench import card_line, gpu_device, padded_columns, time_per_call
    from platypus_tpu.native import native_band_align_pairs
    from platypus_tpu.ops import align_core as ac
    from platypus_tpu.ops.align_jax import (band_align_padded,
                                            band_align_traceback_padded,
                                            pad_alignment_inputs)

    device = gpu_device()
    report = {"phase": "kernels", "device": device, "card": card_line()}

    # (a) the reference goldens, batched by penalties.
    cases = json.load(open(os.path.join(GOLDENS, "align_goldens.json")))
    check(len(cases) >= 300, "fewer than 300 alignment goldens")
    by_pen: dict = {}
    for c in cases:
        by_pen.setdefault((c["gapextend"], c["nucprior"]), []).append(c)
    for (ge, npr), group in by_pen.items():
        L2 = max(len(c["read"]) for c in group)
        B = len(group)
        hap = np.zeros((B, L2 + 15), np.uint8)
        go = np.zeros((B, L2 + 15), np.uint8)
        read = np.zeros((B, L2), np.uint8)
        qual = np.zeros((B, L2), np.uint8)
        for i, c in enumerate(group):
            h = np.frombuffer(c["hap"].encode(), np.uint8)
            r = np.frombuffer(c["read"].encode(), np.uint8)
            hap[i, : len(h)] = h
            go[i, : len(h)] = c["gapopen"]
            read[i, : len(r)] = r
            qual[i, : len(r)] = c["quals"]
        rl = np.array([len(c["read"]) for c in group], np.int32)
        got = np.asarray(band_align_padded(
            *pad_alignment_inputs(hap, go, read, qual, rl),
            gapextend=ge, nucprior=npr))
        check(np.array_equal(got, [c["score"] for c in group]),
              f"the scan differs from the goldens (ge={ge}, npr={npr})")
    report["goldens"] = len(cases)

    # (b) real widths: 16384 lanes of 100 and 150 bp reads.
    lanes = 16384
    for read_len in (100, 150):
        cols, host = padded_columns(lanes, read_len, seed=read_len)
        scan = np.asarray(band_align_padded(*cols))
        idx = np.arange(lanes, dtype=np.int64)
        native = native_band_align_pairs(*host[:4], idx, idx,
                                         np.zeros(lanes, np.int64), host[4],
                                         3, 2, os.cpu_count() or 1)
        check(native is not None, "native CPU kernel unavailable")
        check(np.array_equal(scan, native),
              f"the scan differs from the native kernel at {read_len} bp")
        report[f"pairs_per_s_scan_{read_len}bp"] = (
            lanes / time_per_call(band_align_padded, cols))

    # (c) the traceback scan: scalar oracle on random pairs, flank goldens.
    rng = np.random.default_rng(1234)
    bases = np.frombuffer(b"ACGTN", np.uint8)
    pairs = []
    for k in range(256):
        n = int(rng.integers(10, 151))
        rd = rng.choice(bases[:4], n).astype(np.uint8)
        hp = rng.choice(bases, n + 15, p=[0.24] * 4 + [0.04]).astype(np.uint8)
        if k % 2 == 0:  # near-matching pairs take realistic paths
            hp[4:4 + n] = rd
        pairs.append((hp, rd, rng.integers(5, 40, n).astype(np.uint8),
                      rng.integers(10, 50, n + 15).astype(np.uint8)))
    flank = json.load(open(os.path.join(GOLDENS, "flank_goldens.json")))
    for c in flank:
        pairs.append((np.frombuffer(c["hap"].encode(), np.uint8),
                      np.frombuffer(c["read"].encode(), np.uint8),
                      np.array(c["quals"], np.uint8),
                      np.array(c["gapopen"], np.uint8)))
    L2 = max(len(p[1]) for p in pairs)
    B = len(pairs)
    hap = np.zeros((B, L2 + 15), np.uint8)
    go = np.zeros((B, L2 + 15), np.uint8)
    read = np.zeros((B, L2), np.uint8)
    qual = np.zeros((B, L2), np.uint8)
    for i, (hp, rd, q, g) in enumerate(pairs):
        hap[i, : len(hp)], go[i, : len(hp)] = hp, g
        read[i, : len(rd)], qual[i, : len(rd)] = rd, q
    rl = np.array([len(p[1]) for p in pairs], np.int32)
    score, idx, bp = jax.device_get(band_align_traceback_padded(
        *pad_alignment_inputs(hap, go, read, qual, rl)))
    for i, (hp, rd, q, g) in enumerate(pairs):
        want = ac.band_align_traceback(hp.tobytes(), rd.tobytes(), q, 3, 2, g)
        got = ac.traceback_from_backpointers(
            ac.unpack_backpointers(bp[:, i]), int(idx[i]), hp.tobytes(),
            rd.tobytes())
        check(int(score[i]) == want[0] and got == tuple(want[1:]),
              f"traceback scan differs from the scalar oracle (pair {i})")
    for i, c in enumerate(flank, start=256):
        check(int(score[i]) == c["score"], "traceback scan vs flank golden")
    report["traceback_pairs"] = B
    emit(report)


# ---------------------------------------------------------------------------
# Parent
# ---------------------------------------------------------------------------

def child(phase: str) -> dict:
    res = subprocess.run([sys.executable, os.path.abspath(__file__),
                          "--phase", phase],
                         capture_output=True, text=True, env=GPU_ENV, cwd=REPO)
    if res.returncode != 0:
        raise PhaseFailed(f"{phase}: exit {res.returncode}: {res.stderr[-3000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def data_lines(path: str) -> list:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as fh:
        return [l for l in fh if not l.startswith("#")]


def call_args(out: str, region: str, *extra: str) -> list:
    return [sys.executable, "-m", "platypus_tpu.cli", "callVariants",
            f"--bamFiles={MB10}/reads.bam", f"--refFile={MB10}/ref.fa",
            f"--regions={region}", "-o", out, *extra]


def run_call(name: str, out: str, region: str, *extra: str,
             env=GPU_ENV) -> dict:
    """One CLI run; returns wall time and the engine's metrics (the last
    cumulative summary each process logged, summed over processes)."""
    log = os.path.join(OUT, f"{name}.log")
    t0 = time.perf_counter()
    with open(log, "w") as fh:
        res = subprocess.run(call_args(out, region, *extra), cwd=REPO,
                             stdout=fh, stderr=subprocess.STDOUT,
                             env=dict(env, PLATYPUS_TPU_METRICS="1"))
    wall = time.perf_counter() - t0
    text = open(log).read()
    if res.returncode != 0:
        raise PhaseFailed(f"{name}: exit {res.returncode}: {text[-3000:]}")
    last = {}
    for m in re.finditer(r"\[pid (\d+)\] region \S+ cumulative: (.*)", text):
        last[m.group(1)] = m.group(2)
    metrics: dict = {}
    for summary in last.values():
        for k, v in re.findall(r"(\S+?)=([0-9.]+)s?(?=\s|$)", summary):
            metrics[k] = metrics.get(k, 0.0) + float(v)
    hybrid = re.search(r"hybrid pool: (\d+) regions by host workers, (\d+) "
                       r"by the device worker, (\d+) rescued", text)
    device = re.search(r"device worker pid (\d+) holds", text)
    device_metrics: dict = {}
    if device and device.group(1) in last:
        for k, v in re.findall(r"(\S+?)=([0-9.]+)s?(?=\s|$)",
                               last[device.group(1)]):
            device_metrics[k] = float(v)
    return {"wall_s": wall, "metrics": metrics, "log": text,
            "claims": ([int(x) for x in hybrid.groups()] if hybrid else None),
            "device_pid": device.group(1) if device else None,
            "device_metrics": device_metrics}


def build_dataset() -> int:
    """Build (or reuse) the 10 Mb set on the CPU; returns its read count."""
    t0 = time.perf_counter()
    build = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "scaling_bench.py"),
         "--build-only", "--mb", "10", "--workdir", DATA],
        cwd=REPO, env=CPU_ENV, capture_output=True, text=True)
    check(build.returncode == 0, f"dataset build failed: "
          f"{(build.stdout + build.stderr)[-3000:]}")
    n_reads = json.loads(build.stdout.strip().splitlines()[-1])["n_reads"]
    emit({"phase": "dataset", "n_reads": n_reads,
          "ready_after_s": time.perf_counter() - t0})
    return n_reads


def one_card() -> dict:
    """The one-card phases, one at a time: the times they print are taken
    with no other phase on the host."""
    os.makedirs(OUT, exist_ok=True)
    kern = child("kernels")
    emit(kern)

    n_reads = build_dataset()

    golden = data_lines(os.path.join(GOLDENS, "reference_run",
                                     "ref_synth_10mb.vcf.gz"))
    for name, extra, env in HYBRID_RUNS:
        vcf = os.path.join(OUT, f"{name}.vcf")
        r = run_call(name, vcf, REGION_10MB, *extra, env=env)
        m = r["metrics"]
        row = {"phase": name, "wall_s": r["wall_s"],
               "reads_per_s": n_reads / r["wall_s"],
               "compile_s": m.get("compile", 0.0),
               "first_region_s": _first_region_s(r["log"]),
               "identical_to_golden": data_lines(vcf) == golden,
               **{k: m.get(k, 0.0) for k in DEVICE_METRICS}}
        if r["claims"] is not None:
            row["claims_host_device_rescued"] = r["claims"]
        if r["device_pid"] is not None:
            row["device_worker"] = {k: r["device_metrics"].get(k, 0.0)
                                    for k in DEVICE_METRICS}
        emit(row)
        check(row["identical_to_golden"], f"{name}: data lines differ "
              "from ref_synth_10mb.vcf.gz")
        if name == "ncpu1":
            check(row["alignment_pairs"] > 0
                  and row["device_alignment_pairs"] == row["alignment_pairs"],
                  "ncpu1: not every alignment pair ran on the device")
            check(row["device_alignment"] > 0
                  and row["device_inference"] > 0
                  and row["device_inference_windows"] > 0,
                  "ncpu1: device alignment or inference did not run")
        if name == "ncpu4_device":
            dev = row.get("device_worker", {})
            check(r["claims"] is not None and r["claims"][1] > 0,
                  f"{name}: the device worker claimed no region")
            check(dev.get("device_alignment_pairs", 0) > 0
                  and dev.get("device_inference_windows", 0) > 0,
                  f"{name}: the device worker ran no alignment or "
                  "inference on the card")

    flank_gpu = os.path.join(OUT, "flank_gpu.vcf")
    r = run_call("flank_gpu", flank_gpu, REGION_1MB,
                 "--calculateFlankScore=1")
    # The CPU-pinned twin: the same command on the CPU, with one host
    # worker per region (the output does not depend on --nCPU).
    flank_cpu = os.path.join(OUT, "flank_cpu.vcf")
    twin = run_call("flank_cpu", flank_cpu, REGION_1MB,
                    "--calculateFlankScore=1", "--nCPU=10", env=CPU_ENV)
    same = data_lines(flank_gpu) == data_lines(flank_cpu)
    emit({"phase": "flank", "wall_s": r["wall_s"],
          "cpu_twin_wall_s": twin["wall_s"],
          "records": len(data_lines(flank_gpu)),
          "identical_to_cpu_pinned": same})
    check(same, "flank: GPU and CPU-pinned data lines differ")
    return kern["device"]


def _first_region_s(log: str) -> float:
    m = re.search(r"region \S+ cumulative: .*?region_total=([0-9.]+)s", log)
    return float(m.group(1)) if m else 0.0


def four_cards() -> dict:
    os.makedirs(OUT, exist_ok=True)
    device = child("device")["device"]
    check(device["count"] >= 4, f"four cards wanted, JAX reports {device}")
    n_reads = build_dataset()
    vcf = os.path.join(OUT, "mesh4.vcf")
    r = run_call("mesh4", vcf, REGION_10MB, "--nCPU=1", "--meshDevices=4")
    golden = data_lines(os.path.join(GOLDENS, "reference_run",
                                     "ref_synth_10mb.vcf.gz"))
    mesh = re.search(r"device mesh: (.*)", r["log"])
    row = {"phase": "mesh4", "wall_s": r["wall_s"],
           "reads_per_s": n_reads / r["wall_s"],
           "compile_s": r["metrics"].get("compile", 0.0),
           "mesh": mesh.group(1) if mesh else None,
           "identical_to_golden": data_lines(vcf) == golden}
    emit(row)
    check(row["identical_to_golden"], "mesh4: data lines differ from the golden")
    return {**device, "count": 4}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the --meshDevices=4 path on four cards")
    ap.add_argument("--phase", choices=("device", "kernels"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    if args.phase == "device":
        phase_device()
        return 0
    if args.phase == "kernels":
        phase_kernels()
        return 0

    import platypus_tpu  # noqa: F401 — fails outside the repository

    from bench import card_line

    print(card_line(), flush=True)  # raises without nvidia-smi / a card
    try:
        device = four_cards() if args.four_cards else one_card()
    except PhaseFailed as exc:
        emit({"ok": False, "error": str(exc)[-4000:]})
        return 1
    emit({"ok": True, "device": device})
    return 0


if __name__ == "__main__":
    sys.exit(main())
