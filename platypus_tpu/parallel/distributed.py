"""Multi-host execution: region sharding across several GPU hosts.

The reference scales with fork()ed share-nothing processes and a temp-file
merge (runner.py:470-504).  Across several hosts the same
structure maps onto jax.distributed:

* every host calls `initialize()` (coordinator discovery via the standard
  JAX env vars / args);
* the region manifest is partitioned deterministically by process index —
  regions are independent given their reference halo, so there is no
  inter-host communication in the calling path;
* each host writes a temp VCF; host 0 gathers completion via a tiny psum
  barrier and merge-sorts the shards (same deterministic merge as the
  single-host path);
* within each host, device-level parallelism is the mesh in
  parallel/mesh.py.

Run: `platypus-tpu callVariants ... --nCPU=1` under
`python -m platypus_tpu.parallel.distributed` on every host, or call
`run_distributed` programmatically.
"""

from __future__ import annotations

import logging
import os
from typing import List, Optional, Tuple

from ..config import PlatypusConfig

logger = logging.getLogger("platypus_tpu")

Region = Tuple[str, int, int]


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> Tuple[int, int]:
    """jax.distributed.initialize with env fallbacks; returns
    (process_index, process_count)."""
    import jax

    if num_processes is not None and num_processes > 1:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    elif os.environ.get("JAX_COORDINATOR_ADDRESS"):
        jax.distributed.initialize()
    return jax.process_index(), jax.process_count()


def shard_regions(regions: List[Region], process_index: int,
                  process_count: int) -> List[Region]:
    """Deterministic round-robin region assignment (the reference's
    runner.py:470-474 scheme, by host instead of by fork)."""
    return [r for i, r in enumerate(regions) if i % process_count == process_index]


def barrier() -> None:
    """Cross-host completion barrier via a trivial psum."""
    import jax
    import jax.numpy as jnp

    if jax.process_count() == 1:
        return
    from jax.experimental import multihost_utils

    multihost_utils.sync_global_devices("platypus_tpu_region_barrier")


def aggregate_metrics(local: dict) -> dict:
    """Sum numeric metrics across every host of the slice.

    One psum over a dense vector (keys are agreed by sorted union via
    process_allgather), so the collective rides the ICI/DCN fabric rather
    than a side channel; the reference has no analogue (its forked workers
    never aggregate).  Works on a single host too (identity)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    if jax.process_count() == 1:
        return dict(local)
    from jax.experimental import multihost_utils

    # Key agreement: the gather is numeric-only, so ship the sorted key
    # list as padded uint8 (two rounds: max length, then bytes).
    blob = ",".join(sorted(local)).encode()
    max_len = int(multihost_utils.process_allgather(
        np.array([len(blob)], np.int64)).max())
    padded = np.zeros(max_len, np.uint8)
    padded[:len(blob)] = np.frombuffer(blob, np.uint8)
    rows = np.asarray(multihost_utils.process_allgather(padded))
    keys = sorted({k for row in rows.reshape(-1, max_len) if max_len
                   for k in bytes(row).rstrip(b"\x00").decode().split(",")
                   if k})
    vec = np.array([float(local.get(k, 0)) for k in keys], np.float64)
    if not keys:
        return {}
    summed = np.asarray(multihost_utils.process_allgather(vec)).reshape(
        -1, len(keys)).sum(axis=0)
    return {k: float(v) for k, v in zip(keys, summed)}


def run_distributed(config: PlatypusConfig,
                    coordinator_address: Optional[str] = None,
                    num_processes: Optional[int] = None,
                    process_id: Optional[int] = None) -> None:
    """Whole-run driver for one host of a multi-host slice."""
    from ..engine.runner import get_regions, merge_vcf_files, run_single_process

    pid, pcount = initialize(coordinator_address, num_processes, process_id)
    regions = get_regions(config)
    mine = shard_regions(regions, pid, pcount)
    logger.info("host %d/%d: %d of %d regions", pid, pcount, len(mine), len(regions))

    temp = f"{config.output}_host{pid}" if pcount > 1 else config.output
    run_single_process(config, mine, temp)

    # Fleet-wide throughput accounting: psum the per-host counters so host
    # 0 logs slice totals (reads, windows, alignment pairs, calls).
    from ..utils.observability import GLOBAL_METRICS

    totals = aggregate_metrics(dict(GLOBAL_METRICS.counters))
    if pid == 0 and totals:
        logger.info("slice totals: %s",
                    " ".join(f"{k}={int(v)}" for k, v in sorted(totals.items())))
    barrier()

    if pcount > 1 and pid == 0:
        merge_vcf_files([f"{config.output}_host{i}" for i in range(pcount)],
                        config.output)
    barrier()


def _main(argv=None) -> int:
    """`python -m platypus_tpu.parallel.distributed` — one host of a
    multi-host run.  Takes the callVariants flag set plus the jax
    .distributed bootstrap flags (env-var fallbacks: JAX_COORDINATOR_ADDRESS
    / JAX_NUM_PROCESSES / JAX_PROCESS_ID)."""
    import argparse
    import logging as _logging
    import sys

    from ..cli import build_config

    _logging.basicConfig(level=_logging.INFO,
                         format="%(asctime)s %(levelname)s %(message)s")
    argv = list(sys.argv[1:] if argv is None else argv)
    boot = argparse.ArgumentParser(add_help=False)
    boot.add_argument("--coordinatorAddress", default=None)
    boot.add_argument("--numProcesses", type=int, default=None)
    boot.add_argument("--processId", type=int, default=None)
    known, rest = boot.parse_known_args(argv)
    if rest and rest[0] == "callVariants":
        rest = rest[1:]
    config = build_config(rest)
    run_distributed(config, coordinator_address=known.coordinatorAddress,
                    num_processes=known.numProcesses,
                    process_id=known.processId)
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
