"""Benchmark the mesh calling path against the single-device dispatch path
(VERDICT r2 item 7).

Two modes:

* default (real backend, e.g. the GPU): call the same synthetic
  region set twice in one process — once through `--meshDevices`-style
  `mesh_call_region` (one sharded program per region: alignment + fused
  GL/EM/posterior) and once through the standard async dispatch path —
  and report wall, reads/s and data-line parity.
* --curve: windows/s of the sharded region step alone on 1..8 VIRTUAL CPU
  devices (xla_force_host_platform_device_count), the turnkey multi-chip
  scaling harness for when real multi-chip hardware is available.

Usage:
  python tools/mesh_bench.py [--mb 1] [--repeats 2]
  JAX_PLATFORMS=cpu python tools/mesh_bench.py --curve
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tests"))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def bench_real(mb: float, repeats: int) -> None:
    from scaling_bench import build_dataset

    from platypus_tpu.config import PlatypusConfig
    from platypus_tpu.engine.runner import run_single_process

    info = build_dataset(f"/tmp/platypus_tpu_scaling/mb{mb:g}",
                         int(mb * 1e6))
    length = info["length"]
    regions = [("chr20", s, min(s + 100_000, length + 1000))
               for s in range(1000, length + 1000, 100_000)]
    region_flag = [f"chr20:1000-{length + 1000}"]

    results = {}
    lines = {}
    for label, extra in (("dispatch", {}), ("mesh", {"mesh_devices": 1})):
        out = f"/tmp/mesh_bench_{label}.vcf"
        cfg = PlatypusConfig(bam_files=[info["bam"]], ref_file=info["ref"],
                             regions=region_flag, output=out, **extra)
        run_single_process(cfg, regions, out)  # warm (compiles)
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            run_single_process(cfg, regions, out)
            best = min(best, time.perf_counter() - t0)
        results[label] = best
        with open(out) as fh:
            lines[label] = [l for l in fh if not l.startswith("#")]

    import jax

    print(json.dumps({
        "backend": jax.default_backend(),
        "n_reads": info["n_reads"],
        "dispatch_wall_s": round(results["dispatch"], 3),
        "mesh_wall_s": round(results["mesh"], 3),
        "dispatch_reads_per_s": round(info["n_reads"] / results["dispatch"], 1),
        "mesh_reads_per_s": round(info["n_reads"] / results["mesh"], 1),
        "identical_data_lines": lines["dispatch"] == lines["mesh"],
    }))


def bench_curve() -> None:
    os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
    if "xla_force_host_platform_device_count" not in os.environ["XLA_FLAGS"]:
        os.environ["XLA_FLAGS"] += " --xla_force_host_platform_device_count=8"
    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from platypus_tpu.parallel.mesh import (build_calling_step, make_example_batch,
                                            make_mesh)

    # One fixed synthetic window batch, identical across mesh sizes.
    W, Hmax, Rmax, L2 = 256, 8, 64, 96
    batch = make_example_batch(W=W, Hmax=Hmax, Rmax=Rmax, L2=L2, seed=7)
    rows = []
    for n_dev in (1, 2, 4, 8):
        mesh = make_mesh(n_dev)
        step = build_calling_step(mesh)
        with mesh:
            out = step(*batch)  # warm/compile
            jax.block_until_ready(out)
            reps, best = 8, float("inf")
            for _ in range(3):
                t0 = time.perf_counter()
                for _ in range(reps):
                    out = step(*batch)
                jax.block_until_ready(out)
                best = min(best, (time.perf_counter() - t0) / reps)
        rows.append({"devices": n_dev, "windows_per_s": round(W / best, 1),
                     "step_ms": round(best * 1e3, 2)})
        print(json.dumps(rows[-1]))
    base = rows[0]["windows_per_s"]
    for r in rows:
        r["scaling_efficiency"] = round(r["windows_per_s"]
                                        / (base * r["devices"]), 3)
    print(json.dumps({"curve": rows}))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mb", type=float, default=1.0)
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--curve", action="store_true")
    args = ap.parse_args()
    if args.curve:
        bench_curve()
    else:
        bench_real(args.mb, args.repeats)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
