"""Runner-level tests: multi-sample joint calling, REFCALL output, resume
and multi-file merge."""

import os

import numpy as np
import pytest

from platypus_tpu.config import PlatypusConfig
from platypus_tpu.engine.runner import (
    continue_calling,
    get_regions,
    merge_vcf_files,
    run_single_process,
)

from synth import SimHaplotype, make_reference, simulate_reads, write_synth_bam


def _parse(path):
    recs = []
    with open(path) as fh:
        for line in fh:
            if line.startswith("#"):
                continue
            cols = line.rstrip("\n").split("\t")
            recs.append(cols)
    return recs


def test_multi_sample_joint_calling(tmp_path):
    """Two samples: one het for a SNP, one hom-ref — joint genotypes."""
    ref_path, ref_seq = make_reference(tmp_path, length=5000, seed=41)
    pos = 2000
    alt = b"A" if ref_seq[pos] != ord("A") else b"G"
    hap_ref = SimHaplotype(ref_seq, [])
    hap_var = SimHaplotype(ref_seq, [(pos, 1, alt)])

    reads_s1 = simulate_reads([hap_ref, hap_var], 1500, 2500, coverage=30, seed=42)
    reads_s2 = simulate_reads([hap_ref, hap_ref], 1500, 2500, coverage=30, seed=43)
    bam1 = write_synth_bam(tmp_path, reads_s1, ref_len=5000, sample="S1",
                           filename="s1.bam")
    bam2 = write_synth_bam(tmp_path, reads_s2, ref_len=5000, sample="S2",
                           filename="s2.bam")

    out = str(tmp_path / "joint.vcf")
    config = PlatypusConfig(bam_files=[bam1, bam2], ref_file=ref_path, output=out)
    run_single_process(config, [("chr20", 1500, 2500)], out)

    recs = [r for r in _parse(out) if int(r[1]) == pos + 1]
    assert recs, "SNP not called in joint mode"
    r = recs[0]
    # Sample columns ordered by sorted sample name: S1 then S2.
    gt_s1 = r[9].split(":")[0]
    gt_s2 = r[10].split(":")[0]
    assert gt_s1 in ("0/1", "1/0")
    assert gt_s2 == "0/0"


def test_ref_calls_output(tmp_path):
    ref_path, ref_seq = make_reference(tmp_path, length=5000, seed=44)
    pos = 2000
    alt = b"A" if ref_seq[pos] != ord("A") else b"G"
    hap_ref = SimHaplotype(ref_seq, [])
    hap_var = SimHaplotype(ref_seq, [(pos, 1, alt)])
    reads = simulate_reads([hap_ref, hap_var], 1200, 2800, coverage=30, seed=45)
    bam = write_synth_bam(tmp_path, reads, ref_len=5000)
    out = str(tmp_path / "refcalls.vcf")
    config = PlatypusConfig(bam_files=[bam], ref_file=ref_path, output=out,
                            output_ref_calls=1, ref_call_block_size=500)
    run_single_process(config, [("chr20", 1200, 2800)], out)
    recs = _parse(out)
    refcalls = [r for r in recs if r[6] == "REFCALL"]
    var_calls = [r for r in recs if r[6] != "REFCALL"]
    assert var_calls, "variant missing"
    assert refcalls, "no REFCALL blocks emitted"
    # REFCALL blocks carry END/Size info and GT ./.
    for r in refcalls:
        assert "END=" in r[7] and "Size=" in r[7]
        assert r[9].split(":")[0] == "./."
    # Coverage-backed blocks get a positive qual.
    assert any(float(r[5]) > 0 for r in refcalls)


def test_merge_vcf_files(tmp_path):
    header = "##fileformat=VCFv4.0\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n"
    f1 = tmp_path / "a.vcf"
    f2 = tmp_path / "b.vcf"
    f1.write_text(header + "chr1\t100\t.\tA\tG\t50\tPASS\t.\nchr2\t50\t.\tC\tT\t50\tPASS\t.\n")
    f2.write_text(header + "chr1\t50\t.\tA\tG\t50\tPASS\t.\nchr1\t200\t.\tC\tT\t50\tPASS\t.\n")
    out = str(tmp_path / "merged.vcf")
    merge_vcf_files([str(f1), str(f2)], out)
    recs = _parse(out)
    keys = [(r[0], int(r[1])) for r in recs]
    assert keys == [("chr1", 50), ("chr1", 100), ("chr1", 200), ("chr2", 50)]
    # temp files are removed after merging
    assert not os.path.exists(str(f1)) and not os.path.exists(str(f2))


def test_resume_from_partial_vcf(tmp_path):
    """continueCalling picks up from the last completed buffer block."""
    ref_path, ref_seq = make_reference(tmp_path, length=8000, seed=46)
    positions = [1500, 3500, 5500]
    variants = []
    for p in positions:
        alt = b"A" if ref_seq[p] != ord("A") else b"G"
        variants.append((p, 1, alt))
    hap_ref = SimHaplotype(ref_seq, [])
    hap_var = SimHaplotype(ref_seq, variants)
    reads = simulate_reads([hap_ref, hap_var], 1000, 6500, coverage=30, seed=47)
    bam = write_synth_bam(tmp_path, reads, ref_len=8000)

    out = str(tmp_path / "full.vcf")
    config = PlatypusConfig(
        bam_files=[bam], ref_file=ref_path, output=out,
        regions=["chr20:1001-6500"], buffer_size=2000,
    )
    run_single_process(config, get_regions(config), out)
    full = _parse(out)
    assert len(full) >= 3

    # Truncate after the first data line to simulate a crash.
    with open(out) as fh:
        lines = fh.readlines()
    first_data = next(i for i, l in enumerate(lines) if not l.startswith("#"))
    partial = str(tmp_path / "partial.vcf")
    with open(partial, "w") as fh:
        fh.writelines(lines[: first_data + 1])

    continue_calling(partial)
    resumed = _parse(str(tmp_path / "partial_ContinuedFromFailedProcess.vcf"))
    assert [(r[0], r[1], r[3], r[4]) for r in resumed] == [
        (r[0], r[1], r[3], r[4]) for r in full
    ]

    # Migration path: resume a REFERENCE-produced partial (py2 dict-repr
    # platypusOptions header with camelCase/dest keys) with this caller.
    ref_header = ("##platypusOptions={'output': %r, 'refFile': %r, "
                  "'regions': ['chr20:1001-6500'], 'bamFiles': [%r], "
                  "'bufferSize': 2000, 'minReads': 2, 'nCPU': 1, "
                  "'rlen': 150, 'sourceFile': None, 'maxHaplotypes': 50, "
                  "'compressReads': 0, 'someUnknownRefOnlyOption': 7}\n"
                  % (out, ref_path, bam))
    ref_partial = str(tmp_path / "refstyle.vcf")
    with open(ref_partial, "w") as fh:
        for l in lines[: first_data + 1]:
            fh.write(ref_header if l.startswith("##platypusOptions=") else l)
    continue_calling(ref_partial)
    resumed2 = _parse(str(tmp_path / "refstyle_ContinuedFromFailedProcess.vcf"))
    assert [(r[0], r[1], r[3], r[4]) for r in resumed2] == [
        (r[0], r[1], r[3], r[4]) for r in full
    ]


def test_multiprocess_run(tmp_path):
    """--nCPU=2: spawn workers draining the shared region queue, merged
    output equals the single-process result."""
    from platypus_tpu.engine.runner import run_variant_caller

    ref_path, ref_seq = make_reference(tmp_path, length=9000, seed=61)
    variants = []
    for p in (1500, 3500, 5500, 7500):
        alt = b"A" if ref_seq[p] != ord("A") else b"G"
        variants.append((p, 1, alt))
    hap_ref = SimHaplotype(ref_seq, [])
    hap_var = SimHaplotype(ref_seq, variants)
    reads = simulate_reads([hap_ref, hap_var], 1000, 8500, coverage=30, seed=62)
    bam = write_synth_bam(tmp_path, reads, ref_len=9000)

    out_single = str(tmp_path / "single.vcf")
    config = PlatypusConfig(
        bam_files=[bam], ref_file=ref_path, output=out_single,
        regions=["chr20:1001-8500"], buffer_size=2000, n_cpu=1,
    )
    run_variant_caller(config)
    single = [(r[0], r[1], r[3], r[4], r[9]) for r in _parse(out_single)]

    out_multi = str(tmp_path / "multi.vcf")
    config2 = PlatypusConfig(
        bam_files=[bam], ref_file=ref_path, output=out_multi,
        regions=["chr20:1001-8500"], buffer_size=2000, n_cpu=2,
    )
    run_variant_caller(config2)
    multi = [(r[0], r[1], r[3], r[4], r[9]) for r in _parse(out_multi)]

    assert len(single) >= 4
    assert multi == single


def test_multi_sample_single_bam_rg_split(tmp_path):
    """One BAM containing two samples via RG tags splits into per-sample
    buffers and genotypes jointly."""
    from platypus_tpu.io.bam import write_bam

    ref_path, ref_seq = make_reference(tmp_path, length=4000, seed=63)
    pos = 2000
    alt = b"A" if ref_seq[pos] != ord("A") else b"G"
    hap_ref = SimHaplotype(ref_seq, [])
    hap_var = SimHaplotype(ref_seq, [(pos, 1, alt)])
    reads_a = simulate_reads([hap_ref, hap_var], 1500, 2500, coverage=30, seed=64)
    reads_b = simulate_reads([hap_ref, hap_ref], 1500, 2500, coverage=30, seed=65)

    # Interleave with distinct RG aux tags by writing a custom BAM.
    import struct

    from platypus_tpu.io.bgzf import BGZFWriter
    from platypus_tpu.io.bam import _SEQ_ENCODE

    path = str(tmp_path / "multi_rg.bam")
    header_text = ("@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:chr20\tLN:4000\n"
                   "@RG\tID:rgA\tSM:ALPHA\n@RG\tID:rgB\tSM:BETA\n")
    all_reads = ([(r, b"rgA") for r in reads_a] + [(r, b"rgB") for r in reads_b])
    all_reads.sort(key=lambda t: t[0]["pos"])
    with BGZFWriter(path) as out:
        out.write(b"BAM\x01")
        ht = header_text.encode()
        out.write(struct.pack("<i", len(ht)) + ht)
        out.write(struct.pack("<i", 1))
        nb = b"chr20\x00"
        out.write(struct.pack("<i", len(nb)) + nb + struct.pack("<i", 4000))
        for rd, rg in all_reads:
            name = rd["name"].encode() + b"\x00"
            cig = [(ln << 4) | op for op, ln in rd["cigar"]]
            seq = rd["seq"]
            packed = bytearray((len(seq) + 1) // 2)
            for i, base in enumerate(seq):
                code = _SEQ_ENCODE.get(base, 15)
                packed[i // 2] |= code << (4 if i % 2 == 0 else 0)
            aux = b"RGZ" + rg + b"\x00"
            body = struct.pack("<iiBBHHHiiii", 0, rd["pos"], len(name), 60, 0,
                               len(cig), rd.get("flag", 0), len(seq), -1, -1, 0)
            body += name + b"".join(struct.pack("<I", w) for w in cig)
            body += bytes(packed) + bytes(rd["qual"]) + aux
            out.write(struct.pack("<i", len(body)) + body)

    out_vcf = str(tmp_path / "rg.vcf")
    config = PlatypusConfig(bam_files=[path], ref_file=ref_path, output=out_vcf)
    run_single_process(config, [("chr20", 1500, 2500)], out_vcf)
    header = next(l for l in open(out_vcf) if l.startswith("#CHROM")).split("\t")
    samples = [s.strip() for s in header[9:]]
    assert samples == ["ALPHA", "BETA"]
    recs = [r for r in _parse(out_vcf) if int(r[1]) == pos + 1]
    assert recs
    assert recs[0][9].split(":")[0] in ("0/1", "1/0")   # ALPHA het
    assert recs[0][10].split(":")[0] == "0/0"           # BETA ref


def test_region_boundary_ownership(tmp_path):
    """A variant near a region boundary is reported exactly once across
    adjacent region shards (ownership = the region its position starts in)."""
    ref_path, ref_seq = make_reference(tmp_path, length=6000, seed=66)
    pos = 3001  # just after the boundary at 3000
    alt = b"A" if ref_seq[pos] != ord("A") else b"G"
    hap_ref = SimHaplotype(ref_seq, [])
    hap_var = SimHaplotype(ref_seq, [(pos, 1, alt)])
    reads = simulate_reads([hap_ref, hap_var], 2500, 3500, coverage=30, seed=67)
    bam = write_synth_bam(tmp_path, reads, ref_len=6000)
    out = str(tmp_path / "bnd.vcf")
    config = PlatypusConfig(bam_files=[bam], ref_file=ref_path, output=out)
    run_single_process(config, [("chr20", 2000, 3000), ("chr20", 3000, 4000)], out)
    recs = [r for r in _parse(out) if int(r[1]) == pos + 1]
    assert len(recs) == 1, f"boundary variant reported {len(recs)} times"


def test_inference_thread_parity(tmp_path, monkeypatch):
    """Forcing the dedicated inference thread (the device-backend pipeline
    policy) on the CPU backend yields byte-identical output to the inline
    path — CI has no GPU, so this is the thread path's only exercise."""
    from platypus_tpu.engine.runner import run_single_process

    ref_path, ref_seq = make_reference(tmp_path, length=9000, seed=71)
    variants = []
    for p in (1500, 2500, 4500, 6500, 7500):
        alt = b"C" if ref_seq[p] != ord("C") else b"T"
        variants.append((p, 1, alt))
    reads = simulate_reads(
        [SimHaplotype(ref_seq, []), SimHaplotype(ref_seq, variants)],
        1000, 8500, coverage=30, seed=72)
    bam = write_synth_bam(tmp_path, reads, ref_len=9000)
    regions = [("chr20", 1000, 3000), ("chr20", 3000, 5000),
               ("chr20", 5000, 8500)]
    config = PlatypusConfig(bam_files=[bam], ref_file=ref_path,
                            regions=["chr20:1001-8500"], buffer_size=2000)

    monkeypatch.setenv("PLATYPUS_TPU_INFER_THREAD", "0")
    inline_out = str(tmp_path / "inline.vcf")
    run_single_process(config, regions, inline_out)

    monkeypatch.setenv("PLATYPUS_TPU_INFER_THREAD", "1")
    threaded_out = str(tmp_path / "threaded.vcf")
    run_single_process(config, regions, threaded_out)

    inline_data = [l for l in open(inline_out) if not l.startswith("##")]
    threaded_data = [l for l in open(threaded_out) if not l.startswith("##")]
    assert len(inline_data) > 5
    assert threaded_data == inline_data


def test_region_string_zero_start_clamped(tmp_path):
    """'chr:0-END' (out of the 1-based contract) must clamp to contig start,
    not produce a negative fetch start that silently empties the first
    shard (regression: chr20:0-10000000 lost all calls in [0, bufferSize))."""
    from synth import make_reference, simulate_reads, SimHaplotype, write_synth_bam

    from platypus_tpu.config import PlatypusConfig
    from platypus_tpu.engine.runner import get_regions

    workdir = str(tmp_path)
    ref_path, ref_seq = make_reference(workdir, length=3000, seed=3)
    reads = simulate_reads([SimHaplotype(ref_seq, [])], 0, 3000, coverage=5,
                           error_rate=0.0, seed=1, fast_errors=True)
    bam = write_synth_bam(workdir, reads, ref_len=3000)

    cfg = PlatypusConfig(bam_files=[bam], ref_file=ref_path,
                         regions=["chr20:0-3000"])
    regions = get_regions(cfg)
    assert regions[0][1] == 0        # clamped, not -1
    cfg2 = PlatypusConfig(bam_files=[bam], ref_file=ref_path,
                          regions=["chr20:1-3000"])
    assert get_regions(cfg2)[0][1] == 0


def test_bam_fetch_negative_start_clamped(tmp_path):
    from synth import make_reference, simulate_reads, SimHaplotype, write_synth_bam
    from platypus_tpu.io.bam import BamFile

    workdir = str(tmp_path)
    ref_path, ref_seq = make_reference(workdir, length=3000, seed=4)
    reads = simulate_reads([SimHaplotype(ref_seq, [])], 0, 3000, coverage=5,
                           error_rate=0.0, seed=1, fast_errors=True)
    bam = write_synth_bam(workdir, reads, ref_len=3000)
    with BamFile(bam) as bf:
        neg = bf.fetch("chr20", -1, 1000)
        zero = bf.fetch("chr20", 0, 1000)
    assert len(neg) == len(zero) > 0


def test_buffer_size_invariant_output(tmp_path):
    """Region shard size must not change the calls (halo + window-ownership
    design): same data lines at bufferSize=30kb and 200kb."""
    from synth import SimHaplotype, make_reference, simulate_reads, write_synth_bam

    from platypus_tpu.cli import main as cli_main

    workdir = str(tmp_path)
    ref_path, ref_seq = make_reference(workdir, length=60000, seed=17)
    variants = [(p, 1, b"A" if ref_seq[p] != ord("A") else b"C")
                for p in range(2500, 58000, 3100)]
    hap = SimHaplotype(ref_seq, variants)
    reads = simulate_reads([hap, SimHaplotype(ref_seq, [])], 1000, 59000,
                           coverage=25, error_rate=0.002, seed=9,
                           fast_errors=True)
    write_synth_bam(workdir, reads, ref_len=60000)

    outs = {}
    for bs in (30000, 200000):
        out = f"{workdir}/out_bs{bs}.vcf"
        rc = cli_main([
            "callVariants", f"--bamFiles={workdir}/reads.bam",
            f"--refFile={ref_path}", "--regions=chr20:1-59000",
            f"--bufferSize={bs}", "-o", out,
        ])
        assert rc == 0
        outs[bs] = [l for l in open(out) if not l.startswith("##")]
    assert len(outs[30000]) > 5
    assert outs[30000] == outs[200000]
