"""Top-level driver: region generation, worker processes, VCF merge, resume.

Equivalent of the reference driver (/root/reference/src/python/runner.py):

* get_regions: regions flag (chr:start-end list, .txt, .bed), else BAM SQ
  header, else FASTA index; split into bufferSize shards
  (platypusutils.pyx:935-1085);
* run_variant_caller: round-robins region shards over n_cpu worker
  processes writing temp VCFs, k-way heap-merges them (runner.py:391-504,
  29-121, 301-352);
* continue_calling: resume from an interrupted run by parsing the
  platypusOptions header line of the partial VCF (runner.py:197-297).
"""

from __future__ import annotations

import heapq
import logging
import multiprocessing
import os
import sys
from typing import Dict, List, Optional, Sequence, Tuple

from ..config import PlatypusConfig, RuntimeState, derive_runtime
from ..io.bam import BamFile, open_alignment_file
from ..io.fasta import FastaFile
from ..utils.fileio import expand_bam_file_names, open_transparent
from ..vcfout.writer import VCFWriter
logger = logging.getLogger("platypus_tpu")

Region = Tuple[str, int, int]


def get_regions(config: PlatypusConfig) -> List[Region]:
    ref = FastaFile(config.ref_file, parse_ncbi=bool(config.parse_ncbi))
    bam = open_alignment_file(config.bam_files[0], ref_file=config.ref_file)

    regions: List[Region] = []
    if config.regions is not None and os.path.exists(config.regions[0]):
        path = config.regions[0]
        if path.endswith((".txt", ".txt.gz")):
            with open_transparent(path) as fh:
                for line in fh:
                    chrom, span = line.strip().rsplit(":", 1)
                    s, e = span.split("-")
                    # 1-based inclusive region strings; clamp "chr:0-..."
                    # (technically out of contract) to the contig start
                    # instead of producing a negative fetch start.
                    regions.append((chrom, max(0, int(s) - 1), int(e)))
        elif path.endswith((".bed", ".bed.gz")):
            with open_transparent(path) as fh:
                for line in fh:
                    try:
                        cols = line.split("\t")
                        regions.append((cols[0], int(cols[1]), int(cols[2])))
                    except Exception:  # noqa: BLE001
                        continue
    elif config.regions is None:
        header = bam.header_dict()
        if header.get("SQ"):
            regions = [(d["SN"], 0, int(d["LN"])) for d in header["SQ"]]
        else:
            regions = [(name, 0, entry.length) for name, entry in ref.refs.items()]
    else:
        for region in config.regions:
            split = region.rsplit(":", 1)
            chrom = split[0]
            if len(split) == 2 and "-" in split[1]:
                s, e = split[1].split("-")
                regions.append((chrom, max(0, int(s) - 1), int(e)))
            else:
                if chrom in ref.refs:
                    regions.append((chrom, 0, ref.refs[chrom].length))

    # Optional skip list (chr or chr:start-end per line / comma-separated).
    # NB: the reference parses --skipRegionsFile but never applies it
    # (runner.py:386-387,522); here it actually skips.
    skip_spans: List[Region] = []
    if config.skip_regions_file and os.path.exists(config.skip_regions_file):
        with open_transparent(config.skip_regions_file) as fh:
            for token in fh.read().replace(",", "\n").split():
                if ":" in token:
                    c, span = token.rsplit(":", 1)
                    s, e = span.split("-")
                    skip_spans.append((c, int(s) - 1, int(e)))
                else:
                    skip_spans.append((token, 0, 1 << 60))

    def skipped(chrom: str, start: int, end: int) -> bool:
        return any(c == chrom and start < e and end > s for c, s, e in skip_spans)

    final: List[Region] = []
    for chrom, start, end in regions:
        if chrom not in ref.refs:
            logger.warning("Contig %s not in reference; skipping", chrom)
            continue
        if start > ref.refs[chrom].length:
            continue
        if end - start > config.buffer_size:
            for i in range(start, end, config.buffer_size):
                shard = (chrom, i, min(i + config.buffer_size, end))
                if not skipped(*shard):
                    final.append(shard)
        elif not skipped(chrom, start, end):
            final.append((chrom, start, end))
    bam.close()
    ref.close()
    return final


def open_bams(config: PlatypusConfig):
    config.bam_files = expand_bam_file_names(list(config.bam_files))
    bam_files = [open_alignment_file(path, ref_file=config.ref_file)
                 for path in config.bam_files]
    samples_by_bam: Dict[BamFile, List[str]] = {}
    samples: List[str] = []
    for bam in bam_files:
        ss = bam.sample_names()
        samples_by_bam[bam] = ss
        samples.extend(ss)
    return bam_files, samples_by_bam, sorted(set(samples))


def run_single_process(
    config: PlatypusConfig,
    regions: Sequence[Region],
    output_path: str,
    append: bool = False,
    on_region_done=None,
) -> int:
    """One worker: call all given regions into one VCF file.

    `on_region_done(region)` is invoked once per region after its output
    is durably written (flushed) OR it was abandoned by crash containment
    — the hybrid pool's rescue protocol keys off it (RegionClaimSource)."""
    # jax-touching setup only when jax is in play: a CPU-pinned worker runs
    # the native kernels and never imports jax.
    from ..utils.backend import cpu_pinned

    if not cpu_pinned():
        # Settle the platform before any region runs: a device that fails
        # to start must stop the run here, not inside region containment.
        from ..ops.align_jax import configure_compilation_cache
        from ..utils.backend import device_platform

        configure_compilation_cache()
        device_platform()
    bam_files, samples_by_bam, samples = open_bams(config)
    ref_file = FastaFile(config.ref_file, parse_ncbi=bool(config.parse_ncbi))
    rt = derive_runtime(config, n_individuals=len(samples))
    rt.rlen = config.rlen

    if output_path == "-":
        out = sys.stdout
    else:
        out = open(output_path, "a" if append else "w")
    writer = VCFWriter(out, samples, options_line=config.to_json())
    if not append:
        writer.write_header()

    n_written = 0
    # Two-deep region pipeline: region k's device alignments stay in flight
    # while region k+1 does its host-side work (prepare), then k's results
    # are awaited and written (finish) — output order is preserved because
    # finish runs in region order.
    from .region import (begin_region_inference, finish_region_call,
                         prepare_region_call)

    # Three-deep region pipeline: while region k prepares (host work +
    # alignment dispatch), region k-1's alignments are awaited and its
    # GL/EM/posterior programs dispatched, and region k-2's inference —
    # in flight for a whole iteration — is gathered and written.  Output
    # stays in region order because writes only happen in _finish.
    #
    # begin/finish run inline by default (JAX async dispatch keeps the
    # device busy — see the policy comment below).  With
    # PLATYPUS_TPU_INFER_THREAD=1 they instead run on one worker thread,
    # which keeps begin/finish strictly in region order; FastaFile reads
    # are lock-protected and its region cache swap is atomic for that mode.
    aligning = None   # (chrom, start, end, PreparedRegion): alignments in flight

    def _begin(entry):
        chrom, start, end, state = entry
        try:
            begin_region_inference(state, config)
            return entry
        except Exception as exc:  # noqa: BLE001 — region crash containment
            _contain(exc, chrom, start, end)
            return None

    from concurrent.futures import Future, ThreadPoolExecutor

    # Optional: run begin/finish on a dedicated thread so their device
    # awaits overlap the next region's host prep.  Inline is the default:
    # JAX's async dispatch already keeps the device busy, and the finish
    # stage's host Python on a second thread steals the GIL from prepare.
    # PLATYPUS_TPU_INFER_THREAD=1 opts in (covered by a byte-parity test
    # either way).
    use_thread = os.environ.get("PLATYPUS_TPU_INFER_THREAD", "0")
    executor = (ThreadPoolExecutor(max_workers=1, thread_name_prefix="ptpu-infer")
                if use_thread == "1" else None)
    stage_future = None  # in-flight (begin k-1, finish k-2) stage task
    # The finish stage re-caches its own region span; give the inference
    # thread a private FastaFile so it does not evict the cache the main
    # thread's prepare is slicing from (correctness is lock-protected either
    # way — this avoids the cache ping-pong).
    finish_ref = (FastaFile(config.ref_file, parse_ncbi=bool(config.parse_ncbi))
                  if executor is not None else ref_file)

    def _finish(entry):
        nonlocal n_written
        chrom, start, end, state = entry
        try:
            n_written += finish_region_call(state, finish_ref, config, writer)
        except Exception as exc:  # noqa: BLE001 — region crash containment
            _contain(exc, chrom, start, end)
        if on_region_done is not None:
            try:
                out.flush()  # make the region's lines durable first
            except Exception:  # noqa: BLE001
                pass
            on_region_done((chrom, start, end))

    def _stage(entry, prev_begun):
        begun = _begin(entry) if entry is not None else None
        if begun is None and entry is not None and on_region_done is not None:
            on_region_done(tuple(entry[:3]))  # crashed in begin: done (skipped)
        if prev_begun is not None:
            _finish(prev_begun)
        return begun

    def _submit_stage(entry, prev_begun):
        if executor is None:
            f = Future()
            f.set_result(_stage(entry, prev_begun))
            return f
        return executor.submit(_stage, entry, prev_begun)

    def _drain():
        nonlocal aligning, stage_future
        prev = stage_future.result() if stage_future is not None else None
        stage_future = None
        if prev is not None:
            _finish(prev)
        if aligning is not None:
            entry = _begin(aligning)
            aligning = None
            if entry is not None:
                _finish(entry)

    from .region import RegionPrefetch

    # `regions` may be a list or a lazy source (the work-stealing queue of
    # multi-worker runs); iterate with one-region lookahead so the BAM
    # prefetch still has a target.  A worker therefore claims at most one
    # region ahead of the one it is processing.
    region_iter = iter(regions)
    cur = next(region_iter, None)
    prefetch = None  # next region's BAM decode on a helper thread
    index = 0
    while cur is not None:
        chrom, start, end = cur
        if index % 10 == 0:
            logger.info("Processing region %s:%s-%s", chrom, start, end)
        if config.hla_typing:
            if prefetch is not None:  # the HLA path fetches directly
                prefetch.join()
                prefetch = None
            _drain()
            try:
                from .hla import call_hla_variants_in_region

                n_written += call_hla_variants_in_region(
                    chrom, start, end, bam_files, samples_by_bam, ref_file,
                    config, rt, out,
                )
            except Exception as exc:  # noqa: BLE001 — region crash containment
                _contain(exc, chrom, start, end)
            if on_region_done is not None:
                try:
                    out.flush()
                except Exception:  # noqa: BLE001
                    pass
                on_region_done((chrom, start, end))
            cur = next(region_iter, None)
            index += 1
            continue
        try:
            state = prepare_region_call(
                chrom, start, end, bam_files, samples_by_bam, ref_file,
                config, rt, preloaded=prefetch,
            )
        except Exception as exc:  # noqa: BLE001 — region crash containment
            _contain(exc, chrom, start, end)
            state = None
        if state is None and on_region_done is not None:
            on_region_done((chrom, start, end))  # skipped: no output will come
        if prefetch is not None:
            prefetch.join()  # never leave the helper running into a fetch
            prefetch = None
        nxt = next(region_iter, None)
        if nxt is not None:
            nc, ns, ne = nxt
            prefetch = RegionPrefetch(bam_files, samples_by_bam, nc, ns, ne,
                                      config)
        prev_begun = stage_future.result() if stage_future is not None else None
        entry = aligning
        aligning = None
        stage_future = _submit_stage(entry, prev_begun)
        if state is not None:
            aligning = (chrom, start, end, state)
        cur = nxt
        index += 1
    _drain()
    if executor is not None:
        executor.shutdown(wait=True)
    if finish_ref is not ref_file:
        finish_ref.close()
    if output_path != "-":
        out.close()
    for bam in bam_files:
        bam.close()
    ref_file.close()
    return n_written


def _contain(exc: Exception, chrom: str, start: int, end: int) -> None:
    """Region crash containment (the reference skips a region that raises,
    variantcaller.pyx:613-615) — except for a failure of the device or its
    runtime, which is re-raised: the run must not go on without its device
    and quietly emit a VCF with holes."""
    jax = sys.modules.get("jax")
    if jax is not None and isinstance(exc, jax.errors.JaxRuntimeError):
        raise exc
    logger.exception("Region %s:%s-%s will be skipped", chrom, start, end)


def _cap_worker_threads(n_workers: int) -> None:
    """Split the host's cores between concurrent workers.

    Without this each XLA:CPU client (and NumPy's BLAS) spins up a
    cores-wide thread pool, so nCPU workers oversubscribe the machine
    nCPU-fold and parallel efficiency collapses (measured 0.375 at
    nCPU=4 on a 4-core host).  XLA_FLAGS is only read at backend
    creation, so setting it here — before the first device use in this
    spawned process — is early enough even though jax is already
    imported.  PLATYPUS_TPU_WORKER_THREADS overrides the split.
    """
    per = os.environ.get("PLATYPUS_TPU_WORKER_THREADS")
    n = int(per) if per else max(1, (os.cpu_count() or 1) // max(1, n_workers))
    # Publish the budget so in-process pools (assembly tiles, native BGZF
    # inflate) size themselves to the worker's share too.
    os.environ["PLATYPUS_TPU_WORKER_THREADS"] = str(n)
    os.environ.setdefault("PLATYPUS_TPU_INFLATE_THREADS", str(n))
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ.setdefault(var, str(n))
    extra = f"--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads={n}"
    existing = os.environ.get("XLA_FLAGS", "")
    if "intra_op_parallelism_threads" not in existing:
        os.environ["XLA_FLAGS"] = f"{existing} {extra}".strip()


def _n_device_workers(config: PlatypusConfig, n_host: int) -> int:
    """How many device-owner workers to add to the pool (0 or 1: a JAX
    process reserves most of the card's memory, so one process per card).

    Auto (-1): one device worker when a GPU plugin is installed, the run is
    not pinned to the CPU, AND the host workers leave at least one core
    free.  The device worker is not a free rider: its region prep, read
    decode and VCF output are host Python, so on a host already saturated
    by nCPU host workers it steals cycles from them.  With spare cores the
    worker's host share is absorbed by an idle core and the card's
    throughput is additive.  PLATYPUS_TPU_HYBRID_WORKER=1 (or
    --tpuWorkers=1) forces it on.  Decided without opening the card: the
    parent must leave it to the device worker."""
    from ..utils.backend import cpu_pinned, gpu_plugin_installed

    mode = getattr(config, "tpu_workers", -1)
    env = os.environ.get("PLATYPUS_TPU_HYBRID_WORKER")
    if env is not None:
        mode = int(env)
    if mode == 0:
        return 0
    if n_host < 1:
        return 0
    if mode == -1 and (cpu_pinned() or not gpu_plugin_installed()):
        return 0
    if mode == -1 and config.worker_platform not in ("auto", "default"):
        return 0
    if mode == -1 and n_host >= (os.cpu_count() or 1):
        return 0
    return 1


def _queue_regions(q):
    """Drain a pre-filled region queue lazily (work stealing: the region is
    claimed at next() time, not at worker launch).  The parent enqueues one
    None sentinel per worker after the regions; a blocking get avoids the
    spurious-Empty race of get_nowait while the feeder pipe is flushing."""
    while True:
        region = q.get()
        if region is None:
            return
        yield region


class RegionClaimSource:
    """Work-stealing region source over shared claim state, with RESCUE.

    Every worker holds the same position-sorted region list; claiming is
    one shared index += 1 under its lock, so each worker's claimed regions
    are position-sorted (its temp VCF stays sorted for the k-way merge)
    and regions are processed FIFO exactly like a queue design.

    Hybrid-pool hazard: a device worker that is slow on a region (first
    compiles, a busy card) would stall the whole run on a
    claimed-but-unfinished region.  Two defences:

    * BOW-OUT — a device worker only claims while the rest of the pool
      has comfortably more queued work than one of its regions takes
      (remaining > n_host, and its EMA region time <= 0.8 x the time the
      others need to drain what remains, their rate observed from the
      shared index: self-tuning, no cross-process telemetry);
    * RESCUE — once the index is exhausted, host workers re-claim any
      device-claimed-but-uncompleted region (claim_rescue) and call it
      themselves into a dedicated `<output>_rescue_<i>` temp file.
      Output stays byte-identical because every backend produces
      identical data lines (PARITY §15); if the straggler also finishes,
      merge_vcf_files drops the exact-duplicate lines.  The parent
      terminates device workers once every region is completed
      (all_done), so a straggler never extends the run.

    Shared state per region: state 0=unclaimed, 1=host, 2=device,
    3=rescued; completed 0/1 set by mark_done after the region's output
    has been written AND flushed."""

    HOST, DEVICE, RESCUED = 1, 2, 3

    def __init__(self, regions, index, state, completed, n_host: int,
                 is_device: bool = False):
        self.regions = list(regions)
        self.index = index          # multiprocessing.Value('i')
        self.state = state          # multiprocessing.Array('b', N)
        self.completed = completed  # multiprocessing.Array('b', N)
        self.n_host = max(1, n_host)
        self.is_device = is_device
        self._by_region = {tuple(r): i for i, r in enumerate(self.regions)}
        self._ema = None            # my seconds/region
        self._last_claim = None     # (time, index) at my previous claim
        import time as _time

        self._sleep = _time.sleep      # injectable for deterministic tests
        self._now = _time.monotonic    # injectable for deterministic tests

    def __iter__(self):
        if self.is_device and not self._settle_gate():
            return
        while True:
            now = self._now()
            with self.index.get_lock():
                i = self.index.value
                remaining = len(self.regions) - i
                if remaining <= 0:
                    return
                if self.is_device and not self._device_should_claim(
                        i, remaining, now):
                    return
                self.index.value = i + 1
                self.state[i] = self.DEVICE if self.is_device else self.HOST
            if self._last_claim is not None:
                dt = now - self._last_claim[0]
                self._ema = dt if self._ema is None else 0.6 * self._ema + 0.4 * dt
            self._last_claim = (now, i)
            yield self.regions[i]

    def _settle_gate(self) -> bool:
        """First-claim gate for the device consumer: sample the host pool's
        drain rate over a short settle window (the hosts are warm by the
        time the device worker reaches its first claim — JAX init took
        seconds) and claim only if the queue will outlast an estimate of
        the device's FIRST region (JAX start-up, compile or compile-cache
        loads, first dispatches).  On short runs the device worker would
        otherwise claim a region it cannot finish before the hosts empty
        the queue, forcing a rescue and net-slowing the run.  Settle window
        and estimate are env-tunable; PLATYPUS_TPU_DEVICE_SETTLE=0 disables
        the gate."""
        settle = float(os.environ.get("PLATYPUS_TPU_DEVICE_SETTLE", "1.0"))
        if settle <= 0:
            return True
        # The first region measured on an H100 with a cold compile cache
        # (JAX and CUDA start-up, compiles, first dispatches): 13 s.
        first_region_est = float(os.environ.get(
            "PLATYPUS_TPU_DEVICE_FIRST_REGION_EST", "13.0"))
        with self.index.get_lock():
            i1 = self.index.value
        t1 = self._now()
        self._sleep(settle)
        with self.index.get_lock():
            i2 = self.index.value
            remaining = len(self.regions) - i2
        dt = self._now() - t1
        if remaining <= self.n_host:
            return False
        if i2 <= i1 or dt <= 0:
            return True  # hosts not draining: no evidence to bow out on
        others_rate = (i2 - i1) / dt
        claim = remaining / others_rate > first_region_est
        if not claim:
            logger.info(
                "device worker: bowing out before first claim (%d regions "
                "remaining, hosts draining %.1f/s -> ~%.0f s left < %.0f s "
                "first-region estimate)", remaining, others_rate,
                remaining / others_rate, first_region_est)
        return claim

    def _device_should_claim(self, i: int, remaining: int, now) -> bool:
        if remaining <= self.n_host:
            return False
        if self._ema is None or self._last_claim is None:
            return True  # first claim is gated by _settle_gate instead
        dt = now - self._last_claim[0]
        claims_by_others = (i - self._last_claim[1]) - 1
        if dt <= 0 or claims_by_others <= 0:
            return True
        others_rate = claims_by_others / dt
        return self._ema <= 0.8 * remaining / others_rate

    def mark_done(self, region) -> None:
        """Record that a region's output is durably written (flushed)."""
        i = self._by_region.get(tuple(region))
        if i is not None:
            self.completed[i] = 1

    def claim_rescue(self):
        """Claim one device-claimed-but-uncompleted region for re-calling
        (host workers, after the main index is exhausted).  Returns
        (region, index) or None."""
        with self.index.get_lock():
            if self.index.value < len(self.regions):
                return None  # mainline work still available
            for i in range(len(self.regions)):
                if self.state[i] == self.DEVICE and not self.completed[i]:
                    self.state[i] = self.RESCUED
                    return self.regions[i], i
        return None

    def all_done(self) -> bool:
        with self.index.get_lock():
            if self.index.value < len(self.regions):
                return False
            return all(self.completed[i] for i in range(len(self.regions)))

    def claim_counts(self):
        """(host, device, rescued) region counts — parent-side summary of
        how much work the hybrid pool's device worker actually kept."""
        with self.index.get_lock():
            states = list(self.state)
        return (states.count(self.HOST), states.count(self.DEVICE),
                states.count(self.RESCUED))


def _worker_entry(args):
    config_json, regions, path = args[:3]
    service_handle = args[3] if len(args) > 3 else None
    platform_override = args[4] if len(args) > 4 else None
    # Touch the temp file FIRST: the parent may terminate a device worker
    # that is still inside JAX init or its first compile (all regions
    # already completed by the host workers), and the k-way merge must find
    # every worker's temp file.
    open(path, "a").close()
    config = PlatypusConfig.from_json(config_json)
    if service_handle is not None:
        from .device_service import set_service_handle

        set_service_handle(service_handle)
    if platform_override is not None:
        # Hybrid pool: this worker is the device owner — it runs the
        # in-process GPU path (async-pipelined alignment + fused
        # inference) on regions it steals from the shared queue, while
        # its CPU siblings run the native host kernels.
        config.worker_platform = platform_override
    source = None
    if isinstance(regions, RegionClaimSource):
        source = regions
        regions = iter(source)  # shared-index work stealing
    elif not isinstance(regions, (list, tuple)):
        regions = _queue_regions(regions)  # multiprocessing queue (legacy)
    # Honour a platform override in spawned workers (tests set
    # PLATYPUS_TPU_PLATFORM=cpu).  With no env override,
    # config.worker_platform applies — "auto" resolves to "cpu" here: a JAX
    # process reserves most of the card's memory, so only the device worker
    # may open it.
    platform = os.environ.get("PLATYPUS_TPU_PLATFORM") or config.worker_platform
    if platform == "auto":
        platform = "cpu"
    if platform and platform != "default":
        # Set JAX_PLATFORMS so a LAZY jax import honours the pin — a
        # pure-native CPU worker then never pays the ~1.7 s jax import at
        # all; configure jax directly if something already imported it.
        if "jax" in sys.modules:
            import jax

            jax.config.update("jax_platforms", platform)
        else:
            os.environ["JAX_PLATFORMS"] = platform
    if platform == "cpu" or platform_override is not None:
        # Device worker too: cap its HOST-side pools (BGZF inflate, BLAS)
        # to the same per-worker share — its compute rides the card, but
        # its host stages share cores with the CPU siblings.
        _cap_worker_threads(config.n_cpu)
    # Spawned workers start with a fresh root logger; re-apply the
    # verbosity mapping (the reference's fork model inherited it).
    # continuing=True so a shared log file is appended, not truncated.
    setup_logging(config, continuing=True)

    # Test hooks: make the device worker artificially slow per region (the
    # rescue protocol fires deterministically without a slow device), make
    # the host workers slow per region (a short dataset then lasts long
    # enough for the device worker to start and claim: chip_smoke.py), or
    # crash the device worker outright after claiming (the run must fail).
    # tests/test_device_service.py.
    delay = float(os.environ.get("PLATYPUS_TPU_TEST_DEVICE_DELAY", "0") or 0)
    if delay and platform_override is not None:
        regions = _delayed_regions(regions, delay)
    delay = float(os.environ.get("PLATYPUS_TPU_TEST_HOST_DELAY", "0") or 0)
    if delay and platform_override is None:
        regions = _delayed_regions(regions, delay)
    if (platform_override is not None
            and os.environ.get("PLATYPUS_TPU_TEST_DEVICE_CRASH")):
        regions = _crash_after_first_claim(regions)

    if platform_override is not None:
        # The parent terminates a device straggler once every region is
        # durable.  Convert SIGTERM into a SystemExit raised at a Python
        # bytecode boundary so any held claim lock unwinds through its
        # `with` block instead of dying inside the critical section and
        # poisoning the shared semaphore (the parent's all_done /
        # claim_counts and the hosts' final exhaustion checks acquire the
        # same locks).  A worker stuck in a C-level device await doesn't
        # reach a bytecode boundary — the parent hard-kills after a grace
        # period (it is then provably not inside a claim lock).
        import signal as _signal

        def _graceful_term(_sig, _frm):
            raise SystemExit(0)

        _signal.signal(_signal.SIGTERM, _graceful_term)

    if platform_override is not None and platform != "cpu":
        # The device worker exists to run on the card: a process that was
        # not pinned to the CPU and finds no GPU stops here, loudly, before
        # claiming a region.
        from ..utils.backend import device_platform

        if device_platform() != "gpu":
            raise RuntimeError("device worker found no GPU")
        import jax

        logger.info("device worker pid %d holds %s", os.getpid(),
                    jax.devices()[0].device_kind)

    on_done = source.mark_done if source is not None else None
    n = run_single_process(config, regions, path, on_region_done=on_done)

    # Rescue pass (host workers): re-call any device-claimed region whose
    # output never became durable, each into its own `<output>_rescue_<i>`
    # file (trivially sorted; the parent merges them in).  Duplicate lines
    # from a straggler that finished anyway are dropped at merge time.
    if source is not None and not source.is_device:
        while True:
            rescue = source.claim_rescue()
            if rescue is None:
                break
            region, r_idx = rescue
            logger.info("Rescuing region %s:%s-%s from the device worker",
                        *region)
            rescue_path = f"{config.output}_rescue_{r_idx}"
            n += run_single_process(config, [region], rescue_path,
                                    on_region_done=on_done)
    return n


def _delayed_regions(regions, delay: float):
    import time as _time

    for region in regions:
        _time.sleep(delay)
        yield region


def _crash_after_first_claim(regions):
    """Test hook: claim one region, then die hard (os._exit skips every
    handler) — the parent must stop the run and name the device worker."""
    for _region in regions:
        os._exit(17)
    yield from ()  # a generator, even when the device claims nothing


def _chrom_sort_key(chrom: str):
    c = chrom.upper().lstrip("CHR") if chrom.upper().startswith("CHR") else chrom
    try:
        return (0, int(chrom.upper().strip("CHR")), "")
    except Exception:  # noqa: BLE001
        return (1, 0, chrom)


def merge_vcf_files(temp_files: Sequence[str], final_name: str) -> None:
    """k-way merge of sorted temp VCFs (runner.py:301-352).

    Hybrid-pool hardening: (a) a line without a trailing newline (a device
    straggler terminated mid-write) is dropped — its region has a complete
    rescue copy; (b) an exact-duplicate line at the same (chrom, pos) is
    emitted once (the straggler finished AND the rescuer re-called the
    region; both copies are byte-identical by the determinism contract)."""
    out = sys.stdout if final_name == "-" else open(final_name, "w")
    heap = []

    def data_lines(fh):
        # A line without its trailing newline is a mid-write truncation —
        # only possible as a file's last line (a terminated straggler) —
        # and is dropped BEFORE keying: a truncated line can be cut inside
        # its first two columns, where _line_key would raise.  Its region
        # has a complete rescue copy.
        for line in fh:
            if line.endswith("\n"):
                yield line

    for index, name in enumerate(temp_files):
        fh = open(name)
        first_data = None
        for line in fh:
            if line.startswith("#"):
                if index == 0:
                    out.write(line)
            else:
                if line.endswith("\n"):
                    first_data = line
                break
        if first_data is None:
            fh.close()
            os.remove(name)
            continue
        g = data_lines(fh)
        heapq.heappush(heap, (_line_key(first_data), index, first_data, g, fh, name))

    cur_key = None
    cur_lines: set = set()
    while heap:
        _key, index, line, g, fh, name = heapq.heappop(heap)
        pos_key = _key[:2]
        if pos_key != cur_key:
            cur_key = pos_key
            cur_lines.clear()
        if line not in cur_lines:
            cur_lines.add(line)
            out.write(line)
        try:
            nxt = next(g)
            heapq.heappush(heap, (_line_key(nxt), index, nxt, g, fh, name))
        except StopIteration:
            fh.close()
            os.remove(name)
    if final_name != "-":
        out.close()


def _line_key(line: str):
    cols = line.split("\t", 2)
    return (_chrom_sort_key(cols[0]), int(cols[1]))


def setup_logging(config: PlatypusConfig, continuing: bool = False) -> None:
    """Console + log-file handlers with the reference's verbosity mapping
    (runner.py:404-439): console ERROR/WARNING/INFO for verbosity 0/1/>=2,
    file always DEBUG, appended on resume."""
    root = logging.getLogger()
    # DEBUG only matters when a file handler is attached (file gets DEBUG,
    # console is gated per verbosity); INFO otherwise keeps third-party
    # debug chatter out.
    root.setLevel(logging.DEBUG if config.log_file_name else logging.INFO)
    formatter = logging.Formatter("%(asctime)s - %(levelname)s - %(message)s")
    for h in list(root.handlers):
        root.removeHandler(h)
    ch = logging.StreamHandler()
    ch.setFormatter(formatter)
    ch.setLevel({0: logging.ERROR, 1: logging.WARNING}.get(
        int(config.verbosity), logging.INFO))
    root.addHandler(ch)
    if config.log_file_name:
        try:
            fh = logging.FileHandler(config.log_file_name,
                                     "a" if continuing else "w")
            fh.setFormatter(formatter)
            fh.setLevel(logging.DEBUG)
            root.addHandler(fh)
        except OSError:
            logger.warning("Could not open log file %s", config.log_file_name)


def run_variant_caller(config: PlatypusConfig, regions: Optional[List[Region]] = None,
                       continuing: bool = False) -> None:
    setup_logging(config, continuing)
    if config.distributed:
        # Multi-host slice: this process calls its region share, host 0
        # merges (parallel/distributed.py; reference runner.py:470-504 by
        # host instead of by fork).
        from ..parallel.distributed import run_distributed

        run_distributed(config)
        return
    if regions is None:
        regions = get_regions(config)
    regions = sorted(regions, key=lambda r: (_chrom_sort_key(r[0]), r[1], r[2]))

    if config.n_cpu <= 1:
        # Honour the same platform override spawned workers get:
        # PLATYPUS_TPU_PLATFORM (or --workerPlatform) pins a backend.
        # "auto" resolves to the default backend here (the GPU when one is
        # attached) — the single process owns the device.
        platform = os.environ.get("PLATYPUS_TPU_PLATFORM") or config.worker_platform
        if platform and platform not in ("default", "auto"):
            if platform == "cpu":
                # Make the pin visible to utils.backend.cpu_pinned() even
                # when it arrived via --workerPlatform only: every jax
                # touch on the CPU path gates on it.
                os.environ["PLATYPUS_TPU_PLATFORM"] = "cpu"
            if "jax" in sys.modules:
                import jax

                try:
                    jax.config.update("jax_platforms", platform)
                except RuntimeError:
                    pass  # backend already initialised in-process; keep it
            else:
                # jax not loaded yet: pin the backend for any lazy import
                # instead of importing now — a pure-native CPU run then
                # never pays the jax import.
                os.environ["JAX_PLATFORMS"] = platform
        run_single_process(config, regions, config.output, append=continuing)
        return

    # Work-stealing region pool: all regions go into one shared FIFO queue
    # and each worker pulls the next one whenever it finishes (or, via the
    # one-region prefetch lookahead, is about to finish) its current region.
    # This replaces the reference's static round-robin (runner.py:470-482):
    # dense regions no longer stall one worker while the others idle.
    # Output is byte-identical to any static assignment — the queue is FIFO
    # so each worker's regions (hence its temp VCF) stay position-sorted,
    # regions are disjoint, and the k-way merge orders by (chrom, pos).
    n_host = min(config.n_cpu, max(1, len(regions)))
    # Hybrid pool: one additional worker owns the GPU and calls whole
    # regions end-to-end on-device (in-process async-pipelined alignment +
    # fused inference — the single-process device path, no IPC), while
    # the host workers run the native CPU kernels.  All pull from the same
    # work-stealing queue, so load balance is automatic and output is
    # byte-identical across backends (PARITY §15).
    n_device = _n_device_workers(config, n_host)
    n_workers = n_host + n_device
    temp_files = [f"{config.output}_temp_{i}" for i in range(n_workers)]
    # Worker start method: spawn is required whenever jax is (or may be)
    # in play — XLA runtime state does not survive fork.  A CPU-pinned
    # pool whose parent never loaded jax (the CPU-pinned CLI path) forks
    # instead: each worker saves the ~0.4 s interpreter+import startup,
    # and the jax-free parent has no unsafe state to inherit.
    from ..utils.backend import cpu_pinned

    _can_fork = (cpu_pinned() and "jax" not in sys.modules
                 and _n_device_workers(config, n_host) == 0
                 and hasattr(os, "fork"))
    ctx = multiprocessing.get_context("fork" if _can_fork else "spawn")

    # Device-owner service: one extra process owns the GPU and serves the
    # fused GL/EM/posterior batches to every worker (the workers themselves
    # stay on the CPU backend — one JAX process per card).  The server
    # detects at startup whether a GPU is attached and stands down
    # otherwise.  Opt-in (--inferenceService=1); never started beside a
    # device worker.  engine/device_service.py.
    from .device_service import DeviceService, should_start_service

    service = (DeviceService(ctx, n_workers)
               if n_device == 0 and should_start_service(config, n_workers)
               else None)

    import glob as _glob

    for stale in _glob.glob(f"{config.output}_rescue_*"):
        os.remove(stale)  # a crashed previous run must not leak into merge
    for name in temp_files:
        # Truncate up front: a crashed previous run's temp file must not
        # leak stale lines into the merge when this run's worker is
        # terminated before its own "w" open (the entry hook and the
        # parent backstop both touch with "a" and must find it empty).
        open(name, "w").close()

    claim_index = ctx.Value("i", 0)
    claim_state = ctx.Array("b", len(regions))
    claim_completed = ctx.Array("b", len(regions))
    parent_source = RegionClaimSource(regions, claim_index, claim_state,
                                      claim_completed, n_host)
    workers = [
        ctx.Process(target=_worker_entry,
                    args=((config.to_json(),
                           RegionClaimSource(regions, claim_index,
                                             claim_state, claim_completed,
                                             n_host, is_device=i >= n_host),
                           temp_files[i],
                           service.handle_for(i) if service else None,
                           "default" if i >= n_host else None),))
        for i in range(n_workers)
    ]
    for i, p in enumerate(workers):
        p.start()
        if i >= n_host:
            # Yield the device worker to the host workers: its startup
            # alone (interpreter + JAX init, seconds of CPU) steals
            # cycles from the n_cpu pinned workers on a fully-subscribed
            # host — measured up to ~30% on short runs where the settle
            # gate means the device worker contributes nothing.  A niced
            # process still gets idle cores, so long runs lose nothing.
            try:
                os.setpriority(os.PRIO_PROCESS, p.pid, 10)
            except (OSError, AttributeError):
                pass
    terminated_stragglers: List[int] = []
    terminate_deadline: Dict[int, float] = {}

    def died_on_their_own() -> List[int]:
        return [i for i, p in enumerate(workers)
                if p.exitcode not in (None, 0)
                and i not in terminated_stragglers]

    failed: List[int] = []
    try:
        while any(p.is_alive() for p in workers):
            for p in workers:
                p.join(timeout=0.5)
            if service is not None:
                service.check_alive()  # a dead server must not hang workers
            failed = died_on_their_own()
            if failed:
                # A worker that dies on its own fails the run at once: a
                # host worker's claimed regions are gone, and a device
                # worker's death is a device failure, which no host run
                # may stand in for.
                for p in workers:
                    if p.is_alive():
                        p.terminate()
                for p in workers:
                    p.join(timeout=15.0)
                    if p.is_alive():
                        p.kill()
                break
            import time as _time

            for i, deadline in list(terminate_deadline.items()):
                if workers[i].is_alive() and _time.monotonic() > deadline:
                    # Graceful SIGTERM didn't land (stuck in a C-level
                    # device await, where no claim lock is held) — hard
                    # kill so the run can finish.
                    logger.warning("Device worker %d ignored SIGTERM; "
                                   "killing", i)
                    workers[i].kill()
                    del terminate_deadline[i]
            if n_device and parent_source.all_done():
                # Every region's output is durable (rescues included); a
                # device worker still chewing on a straggler region must
                # not extend the run — its duplicate lines are dropped at
                # merge time.
                for i in range(n_host, n_workers):
                    if workers[i].is_alive() and i not in terminate_deadline:
                        logger.info("Terminating device worker %d "
                                    "(all regions complete)", i)
                        # The worker's SIGTERM handler raises SystemExit
                        # at a bytecode boundary, so any held claim lock
                        # unwinds instead of being poisoned; the deadline
                        # covers a worker stuck in a C-level await.
                        workers[i].terminate()
                        terminated_stragglers.append(i)
                        terminate_deadline[i] = (__import__("time")
                                                 .monotonic() + 15.0)
        for p in workers:
            p.join()
        failed = failed or died_on_their_own()
    except KeyboardInterrupt:
        for p in workers:
            p.terminate()
        if service is not None:
            service.stop()
        raise
    if service is not None:
        service.stop()
    if failed:
        # Merging the survivors would emit a VCF with holes, or one the
        # device never finished (the reference's Pool-less fork model had
        # the same blind spot; its Pool-era ancestor re-raised).  Leave the
        # temp files for post-mortem.
        kinds = ["device worker" if i >= n_host else "host worker"
                 for i in failed]
        raise RuntimeError(
            f"{', '.join(kinds)} {failed} exited with "
            f"{[workers[i].exitcode for i in failed]}; the run stops. "
            f"Temp files kept: {temp_files}")
    for i in terminated_stragglers:
        # SIGTERM can land before the worker's entry hook touches its temp
        # file (spawn + JAX init take seconds); the merge needs it present.
        open(temp_files[i], "a").close()
    if n_device:
        n_h, n_d, n_r = parent_source.claim_counts()
        logger.info("hybrid pool: %d regions by host workers, %d by the "
                    "device worker, %d rescued", n_h, n_d, n_r)
    rescue_files = sorted(_glob.glob(f"{config.output}_rescue_*"))
    merge_vcf_files(temp_files + rescue_files, config.output)


def _config_from_reference_header(text: str) -> PlatypusConfig:
    """Parse the REFERENCE's platypusOptions header (py2 dict repr with
    option-dest keys) into a PlatypusConfig, so a crashed run of the
    original Platypus can be resumed by this caller (migration path).
    Unknown reference-only keys are ignored; camelCase keys map through
    the CLI flag table."""
    import ast
    import dataclasses
    import re

    from ..cli import _FLAG_MAP

    d = ast.literal_eval(text)
    fields = {f.name for f in dataclasses.fields(PlatypusConfig)}
    extra = {"rlen": "rlen", "sourceFile": "source_file", "output": "output"}

    def snake(k: str) -> str:
        return re.sub(r"(?<!^)(?=[A-Z])", "_", k).lower()

    kw = {}
    for k, v in d.items():
        f = _FLAG_MAP.get(k) or extra.get(k) or snake(k)
        if f not in fields or v is None:
            continue
        if f in ("source_file", "bam_files", "regions") and isinstance(v, str):
            v = [v]
        kw[f] = v
    return PlatypusConfig(**kw)


def continue_calling(vcf_path: str) -> None:
    """Resume an interrupted run from its partial output VCF
    (runner.py:197-297).  Accepts this caller's JSON options header or
    the reference's py2 dict-repr header."""
    config = None
    last_chrom = None
    last_pos = 0
    with open(vcf_path) as fh:
        for line in fh:
            if line.startswith("##platypusOptions="):
                body = line.split("=", 1)[1].strip()
                try:
                    config = PlatypusConfig.from_json(body)
                except Exception:  # noqa: BLE001 — reference-format header
                    config = _config_from_reference_header(body)
            elif not line.startswith("#"):
                cols = line.split("\t", 2)
                last_chrom = cols[0]
                last_pos = int(cols[1])
    if config is None:
        raise ValueError(f"{vcf_path} has no platypusOptions header; cannot resume")
    if config.n_cpu > 1:
        raise ValueError("Resume is only supported for single-process runs")

    # Resume from the start of the region shard containing the last written
    # call: a region is the atomic unit of progress (runner.py:242-262).
    regions = get_regions(config)
    remaining = []
    resume_floor = 0
    seen_last = last_chrom is None
    for chrom, start, end in regions:
        if last_chrom is None:
            remaining.append((chrom, start, end))
        elif chrom == last_chrom and start <= last_pos - 1 < end:
            seen_last = True
            resume_floor = start
            remaining.append((chrom, start, end))
        elif seen_last:
            remaining.append((chrom, start, end))

    # Copy completed lines into the continuation file.  Name derives from
    # the INPUT file like the reference (runner.py:225: vcfFile.replace);
    # unlike the reference — whose final temp-file merge overwrites the
    # copied prefix, leaving only the new regions' records — the completed
    # prefix is retained, which is what its own log promises ("Complete
    # output (old + new)").  The resumed regions' records are byte-
    # identical to the reference's.
    if vcf_path.endswith(".vcf"):
        new_path = vcf_path[:-4] + "_ContinuedFromFailedProcess.vcf"
    else:
        new_path = vcf_path + "_ContinuedFromFailedProcess.vcf"
    with open(vcf_path) as src, open(new_path, "w") as dst:
        for line in src:
            if line.startswith("#"):
                dst.write(line)
            else:
                cols = line.split("\t", 2)
                if cols[0] != last_chrom or int(cols[1]) - 1 < resume_floor:
                    dst.write(line)
    config.output = new_path
    run_variant_caller(config, regions=remaining, continuing=True)
