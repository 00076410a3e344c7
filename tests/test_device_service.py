"""Device-owner inference service (engine/device_service.py) and the hybrid
pool (engine/runner.py): protocol, rescue of a slow device worker, failure
of a dead one, and byte-identical output vs the in-worker host path.

The server is forced onto the CPU backend (PLATYPUS_TPU_SERVICE_PLATFORM)
so the whole request/response path — spawn, submit, pipelined dispatch,
gather, f64-exactness guard — runs hermetically without a GPU.
"""

import json
import multiprocessing
import os

import numpy as np
import pytest

from synth import SimHaplotype, make_reference, simulate_reads, write_synth_bam


def _make_dataset(workdir, length=30000, seed=7):
    ref_path, ref_seq = make_reference(workdir, length=length, seed=seed)
    variants = [(4000, 1, b"A" if ref_seq[4000] != ord("A") else b"C"),
                (9100, 2, b""),
                (14050, 0, b"GG"),
                (21000, 1, b"T" if ref_seq[21000] != ord("T") else b"G")]
    hap = SimHaplotype(ref_seq, variants)
    reads = simulate_reads([hap, SimHaplotype(ref_seq, [])], 1000,
                           length - 2000, coverage=30, error_rate=0.002,
                           seed=3, fast_errors=True)
    write_synth_bam(workdir, reads, ref_len=length)
    return ref_path


def _run_cli(workdir, ref_path, out, extra_env, extra_args=(), drop_env=(),
             expect_ok=True):
    """Run callVariants in a subprocess so env vars take effect before jax
    and the spawned workers/service inherit them."""
    import subprocess
    import sys

    env = dict(os.environ)
    env.update(extra_env)
    for name in drop_env:
        env.pop(name, None)
    cmd = [sys.executable, "-m", "platypus_tpu.cli", "callVariants",
           f"--bamFiles={workdir}/reads.bam", f"--refFile={ref_path}",
           "--regions=chr20:1000-29000", "-o", out, *extra_args]
    res = subprocess.run(cmd, env=env, capture_output=True, text=True,
                         timeout=500)
    if expect_ok:
        assert res.returncode == 0, res.stderr[-3000:]
    return res


def _data_lines(path):
    return [l for l in open(path) if not l.startswith("#")]


def test_service_output_byte_identical_and_served(tmp_path):
    workdir = str(tmp_path)
    ref_path = _make_dataset(workdir)
    stats_path = f"{workdir}/service_stats.json"

    # Without the service (workers compute f64 host inference).
    _run_cli(workdir, ref_path, f"{workdir}/plain.vcf",
             {"PLATYPUS_TPU_PLATFORM": "cpu",
              "PLATYPUS_TPU_INFERENCE_SERVICE": "0"},
             ("--nCPU=2",))
    # With the service on a forced-CPU server process.
    # A large grace window forces the workers to consume every service
    # response (not just the opportunistic hits), so the result-mapping
    # path is fully exercised and byte-compared.
    # WAIT_READY removes the startup race (a short run could otherwise end
    # before the server initialises — production stays opportunistic).
    _run_cli(workdir, ref_path, f"{workdir}/svc.vcf",
             {"PLATYPUS_TPU_PLATFORM": "cpu",
              "PLATYPUS_TPU_SERVICE_PLATFORM": "cpu",
              "PLATYPUS_TPU_INFERENCE_SERVICE": "1",
              "PLATYPUS_TPU_SERVICE_GRACE": "30",
              "PLATYPUS_TPU_SERVICE_WAIT_READY": "60",
              "PLATYPUS_TPU_SERVICE_STATS": stats_path},
             ("--nCPU=2", "--bufferSize=8000"))

    plain = _data_lines(f"{workdir}/plain.vcf")
    svc = _data_lines(f"{workdir}/svc.vcf")
    assert len(plain) > 0
    assert plain == svc

    # The service really served (not a silent everything-fell-back run).
    stats = json.load(open(stats_path))
    assert stats["requests"] > 0
    assert stats["windows"] > 0
    assert stats["errors"] == 0


def test_service_stands_down_on_pinned_cpu(tmp_path):
    """With the run pinned to CPU and nothing forcing a server backend,
    should_start_service says no, and a spawned server would stand down."""
    from platypus_tpu.config import PlatypusConfig
    from platypus_tpu.engine.device_service import should_start_service

    cfg = PlatypusConfig(bam_files=["x"], ref_file="y", output="z")
    env0 = os.environ.get("PLATYPUS_TPU_INFERENCE_SERVICE")
    os.environ.pop("PLATYPUS_TPU_INFERENCE_SERVICE", None)
    try:
        os.environ["PLATYPUS_TPU_PLATFORM"] = "cpu"
        assert not should_start_service(cfg, 2)
        cfg.inference_service = 1  # explicit force wins
        assert should_start_service(cfg, 2)
        cfg.inference_service = 0
        assert not should_start_service(cfg, 2)
    finally:
        if env0 is not None:
            os.environ["PLATYPUS_TPU_INFERENCE_SERVICE"] = env0


def test_client_falls_back_when_server_down(tmp_path):
    """A dead/absent server must never hang a worker: submit returns None
    once the down event is set, and poll() abandons promptly (NOT_READY)."""
    ctx = multiprocessing.get_context("spawn")
    from platypus_tpu.engine.device_service import (NOT_READY,
                                                    InferenceClient,
                                                    ServiceHandle)

    req_q = ctx.Queue()
    resp_q = ctx.Queue()
    ready = ctx.Event()
    down = ctx.Event()
    client = InferenceClient(ServiceHandle(0, req_q, resp_q, ready, down))
    assert not client.available()          # never became ready
    assert client.submit([{"x": 1}]) is None

    ready.set()
    rid = client.submit([{"hap_mask": np.zeros((1, 2), bool)}])
    assert rid is not None
    down.set()                              # server died mid-flight
    assert client.poll(rid, grace=0.2) is NOT_READY
    # A late response for an abandoned id is silently dropped, and a fresh
    # response is routed to its own id.
    resp_q.put((rid, "ok", [("stale",)]))
    resp_q.put((rid + 1, "ok", [("fresh",)]))
    client._drain(timeout=2.0)
    client._drain(timeout=2.0)
    assert rid not in client._done
    assert client._done[rid + 1] == [("fresh",)]


def test_hybrid_pool_byte_identical(tmp_path):
    """Hybrid pool (nCPU host workers + one device worker): with the run
    pinned to CPU the forced device worker runs the CPU path, and output
    stays byte-identical to the plain pool."""
    workdir = str(tmp_path)
    ref_path = _make_dataset(workdir)
    _run_cli(workdir, ref_path, f"{workdir}/plain.vcf",
             {"PLATYPUS_TPU_PLATFORM": "cpu",
              "PLATYPUS_TPU_HYBRID_WORKER": "0"},
             ("--nCPU=2", "--bufferSize=8000"))
    _run_cli(workdir, ref_path, f"{workdir}/hybrid.vcf",
             {"PLATYPUS_TPU_PLATFORM": "cpu",
              "PLATYPUS_TPU_HYBRID_WORKER": "1"},
             ("--nCPU=2", "--bufferSize=8000"))
    plain = _data_lines(f"{workdir}/plain.vcf")
    hybrid = _data_lines(f"{workdir}/hybrid.vcf")
    assert len(plain) > 0
    assert plain == hybrid


def _mk_sources(regions, n_host=2):
    import multiprocessing

    from platypus_tpu.engine.runner import RegionClaimSource

    ctx = multiprocessing.get_context("spawn")
    idx = ctx.Value("i", 0)
    state = ctx.Array("b", len(regions))
    completed = ctx.Array("b", len(regions))
    host = RegionClaimSource(regions, idx, state, completed, n_host,
                             is_device=False)
    dev = RegionClaimSource(regions, idx, state, completed, n_host,
                            is_device=True)
    parent = RegionClaimSource(regions, idx, state, completed, n_host)
    return host, dev, parent


def test_region_claim_source():
    """Shared-index work stealing: FIFO, disjoint, position-sorted per
    consumer; a device consumer bows out of the tail (remaining <= n_host)."""
    regions = [("chr20", i * 100, (i + 1) * 100) for i in range(10)]
    host, dev, parent = _mk_sources(regions)
    # Deterministic clock: the adaptive bow-out compares microsecond-scale
    # real-time gaps in this synthetic interleave; a counting clock (1s per
    # claim attempt, no settle drain) makes every decision reproducible.
    clock = iter(range(1, 1000))
    dev._now = lambda: float(next(clock))
    dev._sleep = lambda _t: None
    hi = iter(host)
    di = iter(dev)
    got_h, got_d = [], []
    # Interleave: device claims must stop once remaining <= n_host.
    for _ in range(4):
        got_h.append(next(hi))
        got_d.append(next(di))
    # 8 claimed, 2 remain -> device refuses, host drains.
    assert next(di, None) is None
    got_h.extend(hi)
    assert got_d == [regions[1], regions[3], regions[5], regions[7]]
    assert got_h == [regions[0], regions[2], regions[4], regions[6],
                     regions[8], regions[9]]
    # Per-consumer order is position-sorted (temp VCFs stay merge-safe).
    assert got_h == sorted(got_h, key=lambda r: r[1])
    assert got_d == sorted(got_d, key=lambda r: r[1])


def test_device_first_claim_gate():
    """The settle gate samples the hosts' drain rate before the device's
    FIRST claim: a fast-draining short queue makes it bow out entirely; a
    long queue (or idle hosts) still gets claimed."""
    def rig(dev, hi, n):
        """Deterministic settle: the fake sleep advances the fake clock by
        1s and drains n host claims 'during' it."""
        clock = iter([0.0, 1.0] + [float(i) for i in range(2, 100)])
        dev._now = lambda: next(clock)

        def _sleep(_t):
            for _ in range(n):
                next(hi, None)
        dev._sleep = _sleep

    # Short queue, fast drain: 6 regions claimed during the 1s settle ->
    # 4 remaining / 6 rps << 13s estimate -> bow out, zero claims.
    regions = [("chr20", i * 100, (i + 1) * 100) for i in range(10)]
    host, dev, parent = _mk_sources(regions)
    rig(dev, iter(host), 6)
    assert next(iter(dev), None) is None
    # Long queue, same drain rate: 994 remaining / 6 rps > 13s -> claim.
    regions2 = [("chr20", i * 100, (i + 1) * 100) for i in range(1000)]
    host2, dev2, _ = _mk_sources(regions2)
    rig(dev2, iter(host2), 6)
    assert next(iter(dev2), None) == regions2[6]
    # Idle hosts (rate unknown): no evidence to bow out on -> claim.
    host3, dev3, _ = _mk_sources(regions)
    rig(dev3, iter(host3), 0)
    assert next(iter(dev3), None) == regions[0]


def test_region_claim_rescue_protocol():
    """claim_rescue hands device-claimed-but-uncompleted regions to host
    workers exactly once; all_done only once every region is durable."""
    regions = [("chr20", i * 100, (i + 1) * 100) for i in range(8)]
    host, dev, parent = _mk_sources(regions)
    hi, di = iter(host), iter(dev)
    claimed_h = [next(hi) for _ in range(3)]
    claimed_d = [next(di), next(di)]       # device claims 2, finishes 1
    # No rescue while mainline work remains.
    assert host.claim_rescue() is None
    claimed_h += [next(hi) for _ in range(3)]   # index exhausted (8 claimed)
    for r in claimed_h:
        host.mark_done(r)
    dev.mark_done(claimed_d[0])
    assert not parent.all_done()           # one device region outstanding
    rescue = host.claim_rescue()
    assert rescue is not None
    region, r_idx = rescue
    assert region == claimed_d[1]
    assert host.claim_rescue() is None     # claimed exactly once
    host.mark_done(region)
    assert parent.all_done()


def test_merge_drops_straggler_duplicates_and_partial_lines(tmp_path):
    """merge_vcf_files: exact-duplicate lines at one position are emitted
    once; a trailing line without a newline (terminated straggler) drops."""
    from platypus_tpu.engine.runner import merge_vcf_files

    a = tmp_path / "a.vcf"
    b = tmp_path / "b.vcf"
    rec1 = "chr20\t100\t.\tA\tT\t50\tPASS\t.\tGT\t0/1\n"
    rec2 = "chr20\t200\t.\tC\tG\t60\tPASS\t.\tGT\t1/1\n"
    rec3 = "chr20\t300\t.\tG\tA\t70\tPASS\t.\tGT\t0/1\n"
    a.write_text("#H\n" + rec1 + rec2)
    # b: duplicate of rec2 (straggler finished after rescue), a unique rec3,
    # then a partial line (killed mid-write).
    b.write_text("#H\n" + rec2 + rec3 + "chr20\t400\t.\tT\tC\t8")
    out = str(tmp_path / "out.vcf")
    merge_vcf_files([str(a), str(b)], out)
    lines = [l for l in open(out) if not l.startswith("#")]
    assert lines == [rec1, rec2, rec3]

    # A line truncated INSIDE its first two columns (no tab / bare chrom)
    # must also drop, not crash the key computation — and a file whose
    # FIRST data line is truncated must merge as empty.
    c = tmp_path / "c.vcf"
    d = tmp_path / "d.vcf"
    c.write_text("#H\n" + rec1 + "chr2")
    d.write_text("#H\nchr20\t")
    out2 = str(tmp_path / "out2.vcf")
    merge_vcf_files([str(c), str(d)], out2)
    assert [l for l in open(out2) if not l.startswith("#")] == [rec1]


def test_hybrid_straggler_rescued(tmp_path):
    """End-to-end rescue: the device worker is made pathologically slow
    (test hook); output must be complete, duplicate-free and byte-identical
    to the plain pool, with the straggler terminated by the parent."""
    workdir = str(tmp_path)
    ref_path = _make_dataset(workdir)
    _run_cli(workdir, ref_path, f"{workdir}/plain.vcf",
             {"PLATYPUS_TPU_PLATFORM": "cpu",
              "PLATYPUS_TPU_HYBRID_WORKER": "0"},
             ("--nCPU=2", "--bufferSize=6000"))
    _run_cli(workdir, ref_path, f"{workdir}/hybrid.vcf",
             {"PLATYPUS_TPU_PLATFORM": "cpu",
              "PLATYPUS_TPU_HYBRID_WORKER": "1",
              "PLATYPUS_TPU_TEST_DEVICE_DELAY": "120",
              # Disable the first-claim settle gate: the test NEEDS the
              # device worker to claim (and then straggle) so the rescue
              # path actually runs.
              "PLATYPUS_TPU_DEVICE_SETTLE": "0"},
             ("--nCPU=2", "--bufferSize=6000"))
    plain = _data_lines(f"{workdir}/plain.vcf")
    hybrid = _data_lines(f"{workdir}/hybrid.vcf")
    assert len(plain) > 0
    assert plain == hybrid


def test_hybrid_device_crash_rescued(tmp_path):
    """A device worker that dies HARD after claiming (os._exit — no handler
    runs) is a device failure: the parent stops the pool at once, names the
    device worker and its exit code, and writes no merged VCF — the host
    workers' rescue does not stand in for the device.  Slow host workers
    leave regions for the device worker to claim."""
    workdir = str(tmp_path)
    ref_path = _make_dataset(workdir)
    res = _run_cli(workdir, ref_path, f"{workdir}/crash.vcf",
                   {"PLATYPUS_TPU_PLATFORM": "cpu",
                    "PLATYPUS_TPU_HYBRID_WORKER": "1",
                    "PLATYPUS_TPU_TEST_DEVICE_CRASH": "1",
                    "PLATYPUS_TPU_TEST_HOST_DELAY": "5",
                    "PLATYPUS_TPU_DEVICE_SETTLE": "0"},
                   ("--nCPU=2", "--bufferSize=6000"), expect_ok=False)
    assert res.returncode != 0
    assert "device worker [2] exited with [17]" in res.stderr
    assert not os.path.exists(f"{workdir}/crash.vcf")


def test_hybrid_device_worker_without_gpu_fails(tmp_path):
    """A device worker that is not pinned to the CPU and finds no GPU stops
    before its first claim, and the CLI exits non-zero: the hybrid pool
    never turns into a quiet CPU run.  CUDA_VISIBLE_DEVICES hides any card
    on the host running the test; slow host workers keep the run open until
    the device worker has looked for its GPU."""
    workdir = str(tmp_path)
    ref_path = _make_dataset(workdir)
    res = _run_cli(workdir, ref_path, f"{workdir}/nogpu.vcf",
                   {"PLATYPUS_TPU_HYBRID_WORKER": "1",
                    "PLATYPUS_TPU_DEVICE_SETTLE": "0",
                    "PLATYPUS_TPU_TEST_HOST_DELAY": "5",
                    "CUDA_VISIBLE_DEVICES": ""},
                   ("--nCPU=2", "--bufferSize=6000"),
                   drop_env=("PLATYPUS_TPU_PLATFORM", "JAX_PLATFORMS"),
                   expect_ok=False)
    assert res.returncode != 0
    assert "device worker [2] exited with [1]" in res.stderr
    assert not os.path.exists(f"{workdir}/nogpu.vcf")
