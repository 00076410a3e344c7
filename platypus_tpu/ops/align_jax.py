"""Batched banded pair-alignment in JAX.

The scalar contract lives in align_core.band_align_single (bit-exact vs the
reference kernel align.c).  Here the same antidiagonal-wavefront recurrence
is written as plain `lax` code that XLA compiles for any backend:

* the *batch* of (read, haplotype-segment) pairs is the vector axis — each
  element advances one alignment; the 8-lane wavefront is the small
  trailing axis so state tensors are [B, 8] int32;
* the sequential dimension (two antidiagonals per step, one read base
  consumed per step) is a `lax.scan` whose xs are the pre-transposed,
  sentinel-padded read/qual/hap columns, so the loop body is pure
  element-wise min/add/compare/shift work — no gathers;
* variable read lengths inside one batch are handled by sentinel padding
  (pad read columns with '0'/qual 64, haplotype columns with 'N', gap-open
  columns clamped to the last real base) plus per-element extraction masks,
  reproducing the reference's exact end conventions.

Scores are integer phred, bit-identical to align_core (tested in
tests/test_align.py on the checked-in reference goldens).  This scan is the
GPU's alignment kernel, in the dispatch path (engine/score.py) and inside
the sharded mesh step (parallel/mesh.py).
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

from .align_core import N_LANES, POS_INF

_N_CHAR = ord("N")
_PAD_CHAR = ord("0")

# Fixed in-checkout cache directory (listed in .gitignore): the path is part
# of the cache key, so a fixed path lets every process of every run from
# this checkout reuse what an earlier one compiled.
CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache")

_cache_configured = False


def configure_compilation_cache() -> None:
    """Enable JAX's persistent compilation cache.

    When JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and no other
    directory is set here; otherwise the cache goes to CHECKOUT_CACHE_DIR.
    Every program is cached, however short its compile, and compile time
    is tracked in the engine's metrics.  Called by the engine and bench
    entry points."""
    global _cache_configured
    if _cache_configured:
        return
    _cache_configured = True
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(CHECKOUT_CACHE_DIR, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", CHECKOUT_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    from ..utils.observability import track_compile_time

    track_compile_time()


# Self-configure at import: this module is the gateway every lazy jax
# user goes through (engine kernels, mesh, bench), so importing it late
# still arms the persistent compile cache before the first compile.
configure_compilation_cache()


def _pad_core(hap_seg, gapopen_seg, read, qual, read_len):
    """Traced sentinel-padding body shared by the upload and gather paths:
    build the 'N'-padded hap columns, end-clamped 4*gapopen columns,
    '0'-padded read columns and 256-padded 4*qual columns from raw
    [B, L] integer inputs."""
    B, L2max = read.shape
    L1max = L2max + 2 * N_LANES
    len1 = (read_len + 15).astype(jnp.int32)

    hp = jnp.full((B, L1max), _N_CHAR, jnp.int32)
    hp = hp.at[:, : hap_seg.shape[1]].set(hap_seg.astype(jnp.int32))
    go = jnp.zeros((B, L1max), jnp.int32)
    go = go.at[:, : gapopen_seg.shape[1]].set(gapopen_seg.astype(jnp.int32))
    cols = jnp.arange(L1max)[None, :]
    hp = jnp.where(cols < len1[:, None], hp, _N_CHAR)
    last_go = jnp.take_along_axis(go, jnp.maximum(len1 - 1, 0)[:, None], axis=1)
    go = jnp.where(cols < len1[:, None], go, last_go)

    rd = jnp.full((B, L2max + N_LANES), _PAD_CHAR, jnp.int32)
    rd = rd.at[:, :L2max].set(read.astype(jnp.int32))
    qd = jnp.full((B, L2max + N_LANES), 64, jnp.int32)
    qd = qd.at[:, :L2max].set(qual.astype(jnp.int32))
    cols2 = jnp.arange(L2max + N_LANES)[None, :]
    rd = jnp.where(cols2 < read_len[:, None], rd, _PAD_CHAR)
    qd = jnp.where(cols2 < read_len[:, None], qd, 64)

    return hp.T, 4 * go.T, rd.T, 4 * qd.T, read_len.astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=())
def _sentinel_pad_device(hap_seg, gapopen_seg, read, qual, read_len):
    return _pad_core(hap_seg, gapopen_seg, read, qual, read_len)


@functools.partial(jax.jit, static_argnames=())
def _gather_pad_device(hap_mat, go_mat, seq_mat, qual_mat,
                       pair_hap, pair_read, pair_seg, read_len):
    """Device-side pair materialisation: gather each pair's haplotype
    segment / read row from the deduplicated matrices, then sentinel-pad.

    Shipping only [H, L1] unique haplotypes, [A, L2] unique reads (once per
    region batch) plus four [B] int32 index vectors per chunk cuts
    host->device transfer ~30x vs uploading gathered per-pair rows.
    """
    L2max = seq_mat.shape[1]
    seg_len = L2max + 15
    cols = pair_seg[:, None] + jnp.arange(seg_len, dtype=jnp.int32)[None, :]
    hap_seg = hap_mat[pair_hap[:, None], cols]
    go_seg = go_mat[pair_hap[:, None], cols]
    read = seq_mat[pair_read]
    qual = qual_mat[pair_read]
    return _pad_core(hap_seg, go_seg, read, qual, read_len)


def gather_pad_device(hap_mat, go_mat, seq_mat, qual_mat,
                      pair_hap, pair_read, pair_seg, read_len):
    """Host wrapper for the per-chunk gather: the matrices should already be
    device arrays (upload them once per region batch with jnp.asarray);
    only the four [B] index/length vectors transfer per call."""
    return _gather_pad_device(
        hap_mat, go_mat, seq_mat, qual_mat,
        jnp.asarray(np.ascontiguousarray(pair_hap, dtype=np.int32)),
        jnp.asarray(np.ascontiguousarray(pair_read, dtype=np.int32)),
        jnp.asarray(np.ascontiguousarray(pair_seg, dtype=np.int32)),
        jnp.asarray(np.ascontiguousarray(read_len, dtype=np.int32)),
    )


def pad_alignment_inputs(
    hap_seg: np.ndarray,
    gapopen_seg: np.ndarray,
    read: np.ndarray,
    qual: np.ndarray,
    read_len: np.ndarray,
):
    """Sentinel padding for the banded kernel.

    hap_seg/gapopen_seg: [B, L1max] with L1max >= max(read_len) + 15;
    read/qual: [B, L2max].  Raw uint8 arrays ship to the device (minimal
    transfer) and a fused jitted program applies the reference's padding
    conventions there.  Returns ([L1,B] hap cols, [L1,B] 4*gapopen cols,
    [S,B] read cols, [S,B] 4*qual cols, read_len) as int32 device arrays.
    """
    return _sentinel_pad_device(
        jnp.asarray(np.ascontiguousarray(hap_seg, dtype=np.uint8)),
        jnp.asarray(np.ascontiguousarray(gapopen_seg, dtype=np.uint8)),
        jnp.asarray(np.ascontiguousarray(read, dtype=np.uint8)),
        jnp.asarray(np.ascontiguousarray(qual, dtype=np.uint8)),
        jnp.asarray(np.ascontiguousarray(read_len, dtype=np.int32)),
    )


def _shift_up(v: jnp.ndarray, new_col: jnp.ndarray) -> jnp.ndarray:
    return jnp.concatenate([new_col[:, None], v[:, :-1]], axis=1)


def _shift_down(v: jnp.ndarray, new_col) -> jnp.ndarray:
    if jnp.ndim(new_col) == 0:
        new_col = jnp.full((v.shape[0],), new_col, v.dtype)
    return jnp.concatenate([v[:, 1:], new_col[:, None]], axis=1)


@functools.partial(jax.jit, static_argnames=("gapextend", "nucprior"))
def band_align_padded(
    hap_cols: jnp.ndarray,    # [L1max, B] int32 ASCII, 'N'-padded
    go4_cols: jnp.ndarray,    # [L1max, B] int32 4*gapopen, end-clamped
    read_cols: jnp.ndarray,   # [L2max+8, B] int32 ASCII, '0'-padded
    qual4_cols: jnp.ndarray,  # [L2max+8, B] int32 4*qual, 256-padded
    read_len: jnp.ndarray,    # [B] int32
    gapextend: int = 3,
    nucprior: int = 2,
) -> jnp.ndarray:
    """Scores [B] int32 (integer phred), given pre-padded column tensors."""
    hap_cols = hap_cols.astype(jnp.int32)
    go4_cols = go4_cols.astype(jnp.int32)
    read_cols = read_cols.astype(jnp.int32)
    qual4_cols = qual4_cols.astype(jnp.int32)
    n_steps, B = read_cols.shape
    L2max = n_steps - N_LANES
    ge = jnp.int32(4 * gapextend)
    npr = jnp.int32(4 * nucprior)
    pos_inf = jnp.int32(POS_INF)
    lane = jnp.arange(N_LANES, dtype=jnp.int32)[None, :]

    m0 = jnp.full((B, N_LANES), POS_INF, jnp.int32)
    seq1win = hap_cols[:N_LANES].T.astype(jnp.int32)
    nqual0 = jnp.where(seq1win == _N_CHAR, 0, POS_INF).astype(jnp.int32)
    gowin0 = go4_cols[:N_LANES].T.astype(jnp.int32)
    seq2win0 = jnp.full((B, N_LANES), POS_INF, jnp.int32)
    qual2win0 = jnp.full((B, N_LANES), 64 * 4, jnp.int32)
    minscore0 = jnp.full((B,), POS_INF, jnp.int32)

    hap_tail = hap_cols[N_LANES:]   # column 8+s2 for s2 in [0, n_steps)
    go_tail = go4_cols[N_LANES:]

    def step(carry, xs):
        (m1, i1, d1, m2, i2, d2, s1w, nq, gow, s2w, q2w, minsc) = carry
        new_seq2, new_qual2, hap_c, go_c, s2 = xs

        # even phase ------------------------------------------------------
        s2w = _shift_up(s2w, new_seq2)
        q2w = _shift_up(q2w, new_qual2)

        init = (lane == s2).astype(jnp.bool_)  # only fires while s2 < 8
        m1 = jnp.where(init, jnp.int32(-0x8000), m1)
        m2 = jnp.where(init, jnp.int32(-0x8000), m2)

        m1 = jnp.minimum(m1, jnp.minimum(i1, d1))

        ext_lane = jnp.clip(s2 - read_len, 0, N_LANES - 1)
        valid = (s2 >= read_len) & (s2 < read_len + N_LANES)
        val = jnp.take_along_axis(m1, ext_lane[:, None], axis=1)[:, 0]
        minsc = jnp.where(valid, jnp.minimum(minsc, val), minsc)

        sub = jnp.minimum(jnp.where(s2w == s1w, 0, q2w), nq)
        m1 = m1 + sub
        d1_new = jnp.minimum(d2 + ge, jnp.minimum(m2, i2) + _shift_down(gow, jnp.int32(0)))
        d1 = _shift_up(d1_new, jnp.full((m1.shape[0],), POS_INF, jnp.int32))
        i1 = jnp.minimum(i2 + ge, m2 + gow) + npr

        # odd phase -------------------------------------------------------
        s1w = _shift_down(s1w, hap_c)
        nq = _shift_down(nq, jnp.where(hap_c == _N_CHAR, 0, POS_INF).astype(jnp.int32))
        gow = _shift_down(gow, go_c)

        m2 = jnp.minimum(m2, jnp.minimum(i2, d2))
        val2 = jnp.take_along_axis(m2, ext_lane[:, None], axis=1)[:, 0]
        minsc = jnp.where(valid, jnp.minimum(minsc, val2), minsc)

        sub2 = jnp.minimum(jnp.where(s2w == s1w, 0, q2w), nq)
        m2 = m2 + sub2
        d2 = jnp.minimum(d1 + ge, jnp.minimum(m1, i1) + gow)
        i2 = jnp.minimum(_shift_down(i1, pos_inf) + ge, _shift_down(m1, pos_inf) + gow) + npr
        i2 = i2.at[:, -1].set(POS_INF)

        return (m1, i1, d1, m2, i2, d2, s1w, nq, gow, s2w, q2w, minsc), None

    xs = (
        read_cols,
        qual4_cols,
        hap_tail,
        go_tail,
        jnp.arange(n_steps, dtype=jnp.int32),
    )
    carry = (m0, m0, m0, m0, m0, m0, seq1win, nqual0, gowin0, seq2win0, qual2win0, minscore0)
    carry, _ = jax.lax.scan(step, carry, xs)
    minscore = carry[-1]
    return (minscore + 0x8000) >> 2


@functools.partial(jax.jit, static_argnames=("gapextend", "nucprior"))
def band_align_traceback_padded(
    hap_cols: jnp.ndarray,    # [L1max, B] int32 ASCII, 'N'-padded
    go4_cols: jnp.ndarray,    # [L1max, B] int32 4*gapopen, end-clamped
    read_cols: jnp.ndarray,   # [L2max+8, B] int32 ASCII, '0'-padded
    qual4_cols: jnp.ndarray,  # [L2max+8, B] int32 4*qual, 256-padded
    read_len: jnp.ndarray,    # [B] int32
    gapextend: int = 3,
    nucprior: int = 2,
):
    """Traceback-mode batched alignment (align.c:96-586 with traceback
    compiled in), for --calculateFlankScore.

    The same wavefront as band_align_padded, except that the low two bits
    of every DP cell carry its predecessor-state label (so scores differ
    by up to 3 quarter-units, exactly like the reference) and each step
    emits its label words as scan outputs.  Returns (scores [B] int32,
    minidx [B] int32, bp [(L2max+8)*8, B] int32): the traceback-mode
    score, the antidiagonal of each pair's first strict minimum, and the
    packed per-step label words (even phase in bits 0-7, odd phase in bits
    8-15).  Feed a pair's bp column through
    ops.align_core.unpack_backpointers + traceback_from_backpointers for
    the alignment rows."""
    hap_cols = hap_cols.astype(jnp.int32)
    go4_cols = go4_cols.astype(jnp.int32)
    read_cols = read_cols.astype(jnp.int32)
    qual4_cols = qual4_cols.astype(jnp.int32)
    n_steps, B = read_cols.shape
    ge = jnp.int32(4 * gapextend)
    npr = jnp.int32(4 * nucprior)
    pos_inf = jnp.int32(POS_INF)
    lane = jnp.arange(N_LANES, dtype=jnp.int32)[None, :]

    def labels(m, i, d):
        # align.c traceback mode: M=..00, I=..01, D=..11 in the low bits.
        word = (m & 3) | ((i & 3) << 2) | ((d & 3) << 6)
        return word, m & ~3, (i & ~3) | 1, (d & ~3) | 3

    def exit_min(minsc, minidx, m, ext_lane, valid, idx):
        val = jnp.take_along_axis(m, ext_lane[:, None], axis=1)[:, 0]
        upd = valid & (val < minsc)
        return jnp.where(upd, val, minsc), jnp.where(upd, idx, minidx)

    def step(carry, xs):
        (m1, i1, d1, m2, i2, d2, s1w, gow, s2w, q2w, minsc, minidx) = carry
        new_seq2, new_qual2, hap_c, go_c, s2 = xs

        # even phase ------------------------------------------------------
        s2w = _shift_up(s2w, new_seq2)
        q2w = _shift_up(q2w, new_qual2)
        init = lane == s2
        m1 = jnp.where(init, jnp.int32(-0x8000), m1)
        m2 = jnp.where(init, jnp.int32(-0x8000), m2)
        m1 = jnp.minimum(m1, jnp.minimum(i1, d1))
        ext_lane = jnp.clip(s2 - read_len, 0, N_LANES - 1)
        valid = (s2 >= read_len) & (s2 < read_len + N_LANES)
        minsc, minidx = exit_min(minsc, minidx, m1, ext_lane, valid, 2 * s2)
        nq = jnp.where(s1w == _N_CHAR, 0, POS_INF).astype(jnp.int32)
        m1 = m1 + jnp.minimum(jnp.where(s2w == s1w, 0, q2w), nq)
        d1_new = jnp.minimum(d2 + ge, jnp.minimum(m2, i2) + _shift_down(gow, jnp.int32(0)))
        d1 = _shift_up(d1_new, jnp.full((B,), POS_INF, jnp.int32))
        i1 = jnp.minimum(i2 + ge, m2 + gow) + npr
        bp_even, m1, i1, d1 = labels(m1, i1, d1)

        # odd phase -------------------------------------------------------
        s1w = _shift_down(s1w, hap_c)
        gow = _shift_down(gow, go_c)
        m2 = jnp.minimum(m2, jnp.minimum(i2, d2))
        minsc, minidx = exit_min(minsc, minidx, m2, ext_lane, valid,
                                 2 * s2 + 1)
        nq = jnp.where(s1w == _N_CHAR, 0, POS_INF).astype(jnp.int32)
        m2 = m2 + jnp.minimum(jnp.where(s2w == s1w, 0, q2w), nq)
        d2 = jnp.minimum(d1 + ge, jnp.minimum(m1, i1) + gow)
        i2 = jnp.minimum(_shift_down(i1, pos_inf) + ge, _shift_down(m1, pos_inf) + gow) + npr
        i2 = i2.at[:, -1].set(POS_INF)
        bp_odd, m2, i2, d2 = labels(m2, i2, d2)

        carry = (m1, i1, d1, m2, i2, d2, s1w, gow, s2w, q2w, minsc, minidx)
        return carry, bp_even | (bp_odd << 8)

    m0 = jnp.full((B, N_LANES), POS_INF, jnp.int32)
    carry = (m0, m0, m0, m0, m0, m0,
             hap_cols[:N_LANES].T, go4_cols[:N_LANES].T,
             jnp.full((B, N_LANES), POS_INF, jnp.int32),
             jnp.full((B, N_LANES), 64 * 4, jnp.int32),
             jnp.full((B,), POS_INF, jnp.int32),
             jnp.full((B,), -1, jnp.int32))
    xs = (read_cols, qual4_cols, hap_cols[N_LANES:], go4_cols[N_LANES:],
          jnp.arange(n_steps, dtype=jnp.int32))
    carry, bp = jax.lax.scan(step, carry, xs)   # bp: [n_steps, B, 8]
    minsc, minidx = carry[-2], carry[-1]
    bp = jnp.transpose(bp, (0, 2, 1)).reshape(n_steps * N_LANES, B)
    return (minsc + 0x8000) >> 2, minidx, bp


def band_align_batch(
    hap_seg: np.ndarray,
    gapopen_seg: np.ndarray,
    read: np.ndarray,
    qual: np.ndarray,
    read_len: np.ndarray,
    gapextend: int = 3,
    nucprior: int = 2,
) -> np.ndarray:
    """Convenience host API: pad then run the jitted scan kernel."""
    padded = pad_alignment_inputs(hap_seg, gapopen_seg, read, qual, read_len)
    return np.asarray(band_align_padded(*padded, gapextend=gapextend, nucprior=nucprior))
