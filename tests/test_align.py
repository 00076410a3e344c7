"""Alignment kernel tests: scalar core, the XLA scan and the native kernel vs
the checked-in reference goldens (generated by tools/make_align_goldens.py
from the compiled reference SSE2 kernel)."""

import json
import os

import numpy as np
import pytest

from platypus_tpu.ops.align_core import band_align_single
from platypus_tpu.ops.align_jax import band_align_batch

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens", "align_goldens.json")


def _load_cases():
    with open(GOLDENS) as fh:
        return json.load(fh)


def test_scalar_core_matches_reference_goldens():
    cases = _load_cases()
    assert len(cases) >= 300
    for i, c in enumerate(cases):
        got = band_align_single(
            c["hap"].encode(),
            c["read"].encode(),
            np.array(c["quals"]),
            c["gapextend"],
            c["nucprior"],
            np.array(c["gapopen"]),
        )
        assert got == c["score"], f"case {i}: got {got}, want {c['score']}"


def test_jax_batch_matches_goldens_grouped_by_penalties():
    """Batch all goldens sharing (gapextend, nucprior) into single padded
    batches — exercises variable read lengths inside one batch."""
    cases = _load_cases()
    by_pen = {}
    for c in cases:
        by_pen.setdefault((c["gapextend"], c["nucprior"]), []).append(c)

    for (ge, npr), group in by_pen.items():
        L2max = max(len(c["read"]) for c in group)
        B = len(group)
        hap = np.zeros((B, L2max + 15), np.int32)
        go = np.zeros((B, L2max + 15), np.int32)
        read = np.zeros((B, L2max), np.int32)
        qual = np.zeros((B, L2max), np.int32)
        rl = np.zeros(B, np.int32)
        for i, c in enumerate(group):
            h = np.frombuffer(c["hap"].encode(), np.uint8)
            r = np.frombuffer(c["read"].encode(), np.uint8)
            hap[i, : len(h)] = h
            go[i, : len(h)] = c["gapopen"]
            read[i, : len(r)] = r
            qual[i, : len(r)] = c["quals"]
            rl[i] = len(r)
        scores = band_align_batch(hap, go, read, qual, rl, gapextend=ge, nucprior=npr)
        want = np.array([c["score"] for c in group])
        np.testing.assert_array_equal(scores, want, err_msg=f"penalties ge={ge} npr={npr}")


def test_exact_match_any_band_offset():
    rng = np.random.default_rng(3)
    hap = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=60)
    for off in range(16):
        read = hap[off : off + 45]
        score = band_align_single(
            bytes(hap[:60].tobytes()),
            bytes(read.tobytes()),
            np.full(45, 30),
            3,
            2,
            np.full(60, 45),
        )
        assert score == 0


def _random_batch(B, L2, seed, max_len=None):
    """B random (hap segment, read) pairs of length <= L2 whose reads are
    copied from the haplotype at a band offset, then mutated; haplotypes
    carry some 'N'."""
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGTN", np.uint8)
    hap = rng.choice(bases, size=(B, L2 + 15),
                     p=[0.24, 0.24, 0.24, 0.24, 0.04]).astype(np.int32)
    go = rng.integers(3, 50, size=(B, L2 + 15)).astype(np.int32)
    read = np.zeros((B, L2), np.int32)
    for b in range(B):
        off = rng.integers(0, 8)
        read[b] = hap[b, off : off + L2]
    read[read == ord("N")] = ord("A")
    mut = rng.integers(0, B, 3 * B), rng.integers(0, L2, 3 * B)
    read[mut] = rng.choice(bases[:4], 3 * B)
    qual = rng.integers(0, 60, size=(B, L2)).astype(np.int32)
    rl = rng.integers(10, (max_len or L2) + 1, size=B).astype(np.int32)
    return hap, go, read, qual, rl


@pytest.mark.parametrize("gapextend,nucprior", [(3, 2), (1, 0), (10, 5)])
@pytest.mark.parametrize("B", [64, 100])
@pytest.mark.parametrize("L2", [128, 160])         # 100 bp / 150 bp buckets
def test_scan_matches_native_kernel(gapextend, nucprior, B, L2):
    """The XLA scan (the GPU's kernel) == the native CPU kernel across
    penalties, batch sizes and the two read-length buckets of 100 and
    150 bp reads, on pairs with 'N' in the haplotype and mixed lengths."""
    from platypus_tpu.native import native_band_align_pairs
    from platypus_tpu.ops.align_jax import band_align_padded, pad_alignment_inputs

    hap, go, read, qual, rl = _random_batch(B, L2, seed=B + L2)
    got = np.asarray(band_align_padded(
        *pad_alignment_inputs(hap, go, read, qual, rl),
        gapextend=gapextend, nucprior=nucprior))
    idx = np.arange(B, dtype=np.int64)
    want = native_band_align_pairs(
        hap.astype(np.uint8), go.astype(np.uint8), read.astype(np.uint8),
        qual.astype(np.uint8), idx, idx, np.zeros(B, np.int64), rl,
        gapextend, nucprior, 1)
    if want is None:  # native library unavailable: the scalar oracle
        want = [band_align_single(hap[b, : rl[b] + 15].astype(np.uint8).tobytes(),
                                  read[b, : rl[b]].astype(np.uint8).tobytes(),
                                  qual[b, : rl[b]], gapextend, nucprior,
                                  go[b, : rl[b] + 15]) for b in range(B)]
    assert got.shape == (B,)
    np.testing.assert_array_equal(got, want)


@pytest.mark.gpu
def test_kernels_on_the_card():
    """The kernel parity phase of chip_smoke.py, on the card."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cuda")
    env.pop("PLATYPUS_TPU_PLATFORM", None)
    res = subprocess.run([sys.executable, "chip_smoke.py", "--phase", "kernels"],
                         cwd=repo, env=env, capture_output=True, text=True)
    assert res.returncode == 0, res.stderr[-3000:]


def test_traceback_and_flank_score_goldens():
    """Traceback mode and flank-score correction vs checked-in goldens."""
    import json
    import os

    golden_path = os.path.join(os.path.dirname(__file__), "goldens",
                               "flank_goldens.json")
    if not os.path.exists(golden_path):
        import pytest

        pytest.skip("flank goldens not generated")
    from platypus_tpu.ops.align_core import band_align_traceback, calculate_flank_score

    with open(golden_path) as fh:
        cases = json.load(fh)
    for c in cases:
        score, aln1, aln2, firstpos = band_align_traceback(
            c["hap"].encode(), c["read"].encode(), np.array(c["quals"]),
            c["gapextend"], c["nucprior"], np.array(c["gapopen"]),
        )
        assert score == c["score"]
        assert aln1.decode() == c["aln1"] and aln2.decode() == c["aln2"]
        assert firstpos == c["firstpos"]
        flank = calculate_flank_score(
            len(c["hap"]), c["flank"], np.array(c["quals"]), np.array(c["gapopen"]),
            c["gapextend"], c["nucprior"], firstpos, aln1, aln2,
        )
        assert flank == c["flank_score"]


@pytest.mark.parametrize("L2max,seed", [(48, 1234), (160, 7)])
def test_traceback_scan_matches_scalar_oracle(L2max, seed):
    """band_align_traceback_padded must reproduce
    ops.align_core.band_align_traceback exactly: traceback-mode scores
    (label bits in the low two bits of every DP cell), the exit
    antidiagonal, and — through unpack_backpointers +
    traceback_from_backpointers — the alignment rows, firstpos and the
    flank penalty (align.c:96-644)."""
    from platypus_tpu.ops import align_core as ac
    from platypus_tpu.ops.align_jax import (band_align_traceback_padded,
                                            pad_alignment_inputs)

    rng = np.random.default_rng(seed)
    B = 24
    bases = np.frombuffer(b"ACGTN", np.uint8)
    haps, reads, quals, gapopens = [], [], [], []
    for k in range(B):
        n = int(rng.integers(10, L2max + 1))
        read = rng.choice(bases[:4], n).astype(np.uint8)
        hap = rng.choice(bases, n + 15,
                         p=[0.24, 0.24, 0.24, 0.24, 0.04]).astype(np.uint8)
        if k % 2 == 0:  # near-matching pairs take realistic paths
            hap[4:4 + n] = read
            for _ in range(int(rng.integers(0, 4))):
                hap[int(rng.integers(0, n + 15))] = rng.choice(bases[:4])
        haps.append(hap)
        reads.append(read)
        quals.append(rng.integers(5, 40, n).astype(np.uint8))
        gapopens.append(rng.integers(10, 50, n + 15).astype(np.uint8))

    hap_m = np.zeros((B, L2max + 15), np.uint8)
    go_m = np.zeros((B, L2max + 15), np.uint8)
    read_m = np.zeros((B, L2max), np.uint8)
    qual_m = np.zeros((B, L2max), np.uint8)
    for k in range(B):
        n = len(reads[k])
        hap_m[k, : n + 15], go_m[k, : n + 15] = haps[k], gapopens[k]
        read_m[k, :n], qual_m[k, :n] = reads[k], quals[k]
    rl = np.array([len(r) for r in reads], np.int32)
    score, idx, bp = (np.asarray(x) for x in band_align_traceback_padded(
        *pad_alignment_inputs(hap_m, go_m, read_m, qual_m, rl),
        gapextend=3, nucprior=2))
    assert bp.shape == ((L2max + 8) * 8, B)

    for k in range(B):
        hb = haps[k].tobytes()
        rb = reads[k].tobytes()
        w_score, w_a1, w_a2, w_fp = ac.band_align_traceback(
            hb, rb, quals[k], 3, 2, gapopens[k])
        bps = ac.unpack_backpointers(bp[:, k])
        a1, a2, fp = ac.traceback_from_backpointers(bps, int(idx[k]), hb, rb)
        assert int(score[k]) == w_score
        assert (a1, a2, fp) == (w_a1, w_a2, w_fp)
        fs_w = ac.calculate_flank_score(len(hb), 4, quals[k], gapopens[k],
                                        3, 2, w_fp, w_a1, w_a2)
        fs_g = ac.calculate_flank_score(len(hb), 4, quals[k], gapopens[k],
                                        3, 2, fp, a1, a2)
        assert fs_w == fs_g
