"""Multi-chip execution: device mesh, shardings and the batched calling step.

The reference scales by forking share-nothing processes over genome regions
(runner.py:470-504).  The device equivalent keeps that embarrassing
parallelism but maps it onto a 2-D device mesh:

* axis "win": windows (the data-parallel axis — regions/windows are
  independent given their reference halo);
* axis "lane": the read axis of each window's likelihood tensor — the
  genotype log-likelihood is a sum over reads, so sharding reads across
  "lane" makes XLA insert a cross-device reduce (tensor-parallel style), which
  matters only for pathologically deep windows but exercises the collective
  path.

`build_calling_step` returns a single jitted program: banded alignment for
every (window, hap, read) pair -> log-likelihoods -> genotype GLs -> masked
EM -> per-(window, variant-set) posterior ratios.  GSPMD partitions it from
the input shardings; there is no hand-written communication.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.align_jax import band_align_padded, _gather_pad_device
from ..ops.likelihood_jax import (
    genotype_log_likelihoods_jax,
    rescale_likelihoods_jax,
    em_frequencies_jax,
    infer_window_batch_core,
    scores_to_logliks_jax,
    variant_posterior_ratio_jax,
)


def make_mesh(n_devices: Optional[int] = None, lane: int = 1) -> Mesh:
    """(win, lane) mesh over the first n_devices devices.  The engine keeps
    lane=1, every device on "win": windows are independent, and the cards
    of one host reach each other at one rate, so the shape follows the
    algorithm alone.  lane > 1 also shards each window's reads, which adds
    a cross-device reduce over "lane"; only windows too deep for one device
    would want it."""
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    if len(devices) % lane:
        raise ValueError(f"lane={lane} does not divide {len(devices)} devices")
    return Mesh(np.array(devices).reshape(len(devices) // lane, lane),
                ("win", "lane"))


def build_calling_step(mesh: Mesh, gapextend: int = 3, nucprior: int = 2,
                       em_iters: int = 20):
    """One fused window-batch calling step.

    Inputs (W windows, Hmax haps, Rmax reads, G = Hmax*(Hmax+1)/2 genotypes):
      hap_cols   [L1, W, Hmax]  int32  'N'-padded hap segment columns
      go4_cols   [L1, W, Hmax]  int32
      read_cols  [L2+8, W, Rmax] int32 '0'-padded read columns
      qual4_cols [L2+8, W, Rmax] int32
      read_len   [W, Rmax] int32
      mapq       [W, Rmax] int32
      read_mask  [W, Rmax] bool
      hap_mask   [W, Hmax] bool
      h1, h2     [G] int32 genotype hap indices (shared across windows)
      geno_mask  [W, G] bool
      hap_has_var [W, Hmax] bool (posterior test per window)

    Returns (frequencies [W, Hmax], posterior_ratio [W], scores [W,Hmax,Rmax]).
    """

    def step(hap_cols, go4_cols, read_cols, qual4_cols, read_len, mapq,
             read_mask, hap_mask, h1, h2, geno_mask, hap_has_var):
        L1, W, Hmax = hap_cols.shape
        S, _, Rmax = read_cols.shape

        # Expand to all (window, hap, read) pairs and flatten the batch.
        B = W * Hmax * Rmax
        hap_b = jnp.broadcast_to(hap_cols[:, :, :, None], (L1, W, Hmax, Rmax)).reshape(L1, B)
        go_b = jnp.broadcast_to(go4_cols[:, :, :, None], (L1, W, Hmax, Rmax)).reshape(L1, B)
        read_b = jnp.broadcast_to(read_cols[:, :, None, :], (S, W, Hmax, Rmax)).reshape(S, B)
        qual_b = jnp.broadcast_to(qual4_cols[:, :, None, :], (S, W, Hmax, Rmax)).reshape(S, B)
        rl_b = jnp.broadcast_to(read_len[:, None, :], (W, Hmax, Rmax)).reshape(B)

        scores = band_align_padded(hap_b, go_b, read_b, qual_b, rl_b,
                                   gapextend=gapextend, nucprior=nucprior)
        scores = scores.reshape(W, Hmax, Rmax)

        loglik = scores_to_logliks_jax(scores.astype(jnp.float32),
                                       mapq[:, None, :].astype(jnp.float32))

        def per_window(ll, rmask, hmask, gmask, has_var):
            gl = genotype_log_likelihoods_jax(ll, h1, h2, rmask)[None, :]  # I=1
            has_reads = jnp.array([rmask.any()])
            lik = rescale_likelihoods_jax(gl, gmask, has_reads)
            freq = em_frequencies_jax(lik, h1, h2, Hmax, hmask, has_reads, em_iters)
            ratio = variant_posterior_ratio_jax(lik, freq, has_var, h1, h2, has_reads)
            return freq, ratio[0] if ratio.ndim else ratio

        freqs, ratios = jax.vmap(per_window)(loglik, read_mask, hap_mask,
                                             geno_mask, hap_has_var)
        return freqs, ratios, scores

    # Shardings: windows over 'win'; read axis over 'lane'.
    s = lambda *spec: NamedSharding(mesh, P(*spec))
    in_shardings = (
        s(None, "win", None),          # hap_cols
        s(None, "win", None),          # go4_cols
        s(None, "win", "lane"),        # read_cols
        s(None, "win", "lane"),        # qual4_cols
        s("win", "lane"),              # read_len
        s("win", "lane"),              # mapq
        s("win", "lane"),              # read_mask
        s("win", None),                # hap_mask
        s(None),                        # h1
        s(None),                        # h2
        s("win", None),                # geno_mask
        s("win", None),                # hap_has_var
    )
    out_shardings = (s("win", None), s("win"), s("win", None, "lane"))
    return jax.jit(step, in_shardings=in_shardings, out_shardings=out_shardings)


# --------------------------------------------------------------------------
# Production path: real windows through the mesh
# --------------------------------------------------------------------------

_INT32_BIG = np.int32(np.iinfo(np.int32).max)


def _scatter_infer_core(scores, pair_w, pair_h, pair_r, pair_valid,
                        aligned, short, mapq, onehot, hap_mask, h1, h2,
                        var_mask, has_reads, em_iters: int,
                        use_map_qual_cap: bool):
    """Shared tail of the region programs: scatter-min per-pair scores into
    the [W, Hmax, Rmax] tensor, convert to log-likelihoods (HLA map-qual
    cap when requested) and run the fused GL/EM/posterior inference.

    Returns only what the caller consumes (em, freq, ratios, em_margin) —
    the dense ll/gl_rel/gof tensors used to dominate the device->host
    transfer; the per-window loglik matrices are reconstructed on host
    from the sparse pair scores instead (engine/score.py
    window_loglik_from_pair_scores, bit-identical to the dispatch path)."""
    W, Rmax = aligned.shape
    Hmax = hap_mask.shape[1]
    scores = jnp.where(pair_valid, scores, _INT32_BIG)
    S = jnp.full((W, Hmax, Rmax), _INT32_BIG, jnp.int32)
    S = S.at[pair_w, pair_h, pair_r].min(scores, mode="drop")
    # Short-overlap reads score 0 (probability 1) exactly like the host
    # scatter (engine/score.py PendingAlignments.finalize).
    S = jnp.where(short[:, None, :], 0, S)
    ll = scores_to_logliks_jax(S.astype(jnp.float32),
                               mapq[:, None, :].astype(jnp.float32),
                               use_map_qual_cap=use_map_qual_cap)
    ll = jnp.where(aligned[:, None, :], ll, 0.0)
    ll = jnp.where(hap_mask[:, :, None], ll, 0.0)
    _lik, em, freq, _gof, ratios, _gl_rel, em_margin = infer_window_batch_core(
        ll, onehot, hap_mask, h1, h2, var_mask, has_reads, em_iters)
    return em, freq, ratios, em_margin


def _region_shardings(mesh: Mesh, n_pair_inputs: int, n_pair_outputs: int):
    s = lambda *spec: NamedSharding(mesh, P(*spec))
    pair_s = s(("win", "lane"))   # flat data-parallel axis over all devices
    tail = (
        pair_s, pair_s, pair_s, pair_s,        # scatter destinations
        s("win", None), s("win", None),        # aligned, short
        s("win", None),                        # mapq
        s("win", None, None),                  # onehot
        s("win", None),                        # hap_mask
        s(), s(),                              # h1, h2
        s("win", None, None),                  # var_mask
        s("win", None),                        # has_reads
    )
    out_shardings = (pair_s,) * n_pair_outputs + (
        s("win", None, None),                  # em
        s("win", None),                        # freq
        s("win", None),                        # ratios
        s("win"),                              # em_margin
    )
    return (pair_s,) * n_pair_inputs, tail, out_shardings


@functools.lru_cache(maxsize=None)
def _region_call_step(mesh: Mesh, gapextend: int, nucprior: int,
                      em_iters: int, use_map_qual_cap: bool = False):
    """One jitted sharded program for a region's window batch: on-device
    pair gather -> banded alignment (pairs sharded over ALL devices) ->
    scatter-min into the [W, Hmax, Rmax] score tensor -> log-likelihoods ->
    fused GL/EM/posterior inference (windows sharded over 'win').

    GSPMD partitions everything from the input shardings; the pair->window
    combine is a scatter-min collective over the flattened device axis."""

    def step(hap_mat, go_mat, seq_mat, qual_mat,
             pair_hap, pair_read, pair_seg, pair_len,
             pair_w, pair_h, pair_r, pair_valid,
             aligned, short, mapq, onehot, hap_mask, h1, h2, var_mask,
             has_reads):
        padded = _gather_pad_device(hap_mat, go_mat, seq_mat, qual_mat,
                                    pair_hap, pair_read, pair_seg, pair_len)
        scores = band_align_padded(*padded, gapextend=gapextend,
                                   nucprior=nucprior)          # [PB] int32
        em, freq, ratios, em_margin = _scatter_infer_core(
            scores, pair_w, pair_h, pair_r, pair_valid, aligned, short,
            mapq, onehot, hap_mask, h1, h2, var_mask, has_reads,
            em_iters, use_map_qual_cap)
        return scores, em, freq, ratios, em_margin

    s = lambda *spec: NamedSharding(mesh, P(*spec))
    gather_s, tail, out_shardings = _region_shardings(mesh, 4, 1)
    in_shardings = (s(), s(), s(), s()) + gather_s + tail
    return jax.jit(step, in_shardings=in_shardings,
                   out_shardings=out_shardings)


@functools.lru_cache(maxsize=None)
def _region_call_step_from_scores(mesh: Mesh, em_iters: int,
                                  use_map_qual_cap: bool):
    """Region program for windows whose pair scores were produced outside
    the fused wavefront — the --calculateFlankScore path, where the
    traceback scan computes scores + backpointers and the host applies
    the flank penalty before inference.  Identical scatter/loglik/inference
    tail, windows sharded over 'win'."""

    def step(pair_scores, pair_w, pair_h, pair_r, pair_valid,
             aligned, short, mapq, onehot, hap_mask, h1, h2, var_mask,
             has_reads):
        return _scatter_infer_core(
            pair_scores, pair_w, pair_h, pair_r, pair_valid, aligned,
            short, mapq, onehot, hap_mask, h1, h2, var_mask, has_reads,
            em_iters, use_map_qual_cap)

    score_s, tail, out_shardings = _region_shardings(mesh, 1, 0)
    in_shardings = score_s + tail
    return jax.jit(step, in_shardings=in_shardings,
                   out_shardings=out_shardings)


_ENGINE_MESH = None


def get_engine_mesh(n_devices: int = -1) -> Mesh:
    """Process-wide mesh for the production calling path (-1 = all local
    devices)."""
    global _ENGINE_MESH
    want = None if n_devices in (-1, 0) else n_devices
    if _ENGINE_MESH is None or (
        want is not None and _ENGINE_MESH.devices.size != want
    ):
        _ENGINE_MESH = make_mesh(want)
        import logging

        logging.getLogger("platypus_tpu").info(
            "device mesh: %s over %d x %s", dict(_ENGINE_MESH.shape),
            _ENGINE_MESH.devices.size,
            _ENGINE_MESH.devices.flat[0].device_kind)
    return _ENGINE_MESH


def mesh_call_region(live, n_individuals: int, mesh: Mesh,
                     gapextend: int = 3, nucprior: int = 2,
                     em_iters: int = 100, defer: bool = False):
    """Run REAL prepared windows (engine/caller.prepare_window output with
    their AlignmentRequests) through the sharded region step.

    Returns (loglik_by_idx, inference_by_idx, leftover) where leftover are
    (w_idx, prep) pairs with nothing to align (no pairs) — the caller
    routes those through the standard host dispatch.  HLA map-qual-cap
    windows run the same fused program with the capped loglik conversion;
    --calculateFlankScore windows get their pair scores from the
    traceback scan (+ host flank penalty) and then ride the shared
    scatter/inference program, so every alignable window is mesh-covered."""
    from ..ops.kmer import HASH_NUCS
    from ..ops.likelihood import genotype_index_pairs
    from .batch import WindowInference, enumerate_window_variants, geom_bucket

    from ..engine.score import window_loglik_from_pair_scores

    import os as _os
    import time as _time
    _timers = _os.environ.get("PLATYPUS_TPU_MESH_TIMERS")
    _t0 = _time.perf_counter()
    loglik_by_idx: dict = {}
    inference_by_idx: dict = {}
    leftover: list = []
    groups: dict = {}
    for w_idx, prep in live:
        req = prep.request
        if req is None or req.n_pairs() == 0:
            leftover.append((w_idx, prep))
            continue
        # Sub-bucketing by haplotype-count class keeps small windows from
        # paying the dense G = Hmax(Hmax+1)/2 cost of the region's largest
        # window (the main single-chip overhead vs the dispatch path).
        key = (req.sub_seq.shape[1], bool(req.use_map_qual_cap),
               bool(req.calculate_flank_score),
               geom_bucket(len(prep.all_haps)))
        groups.setdefault(key, []).append((w_idx, prep))

    I = n_individuals
    n_win = mesh.shape["win"]
    n_dev = int(mesh.devices.size)
    round_up = lambda n, m: -(-n // m) * m
    # Two phases: LAUNCH every group's program back-to-back (JAX async
    # dispatch queues them on the device with no host round-trip between),
    # then fetch all outputs in one transfer.  A per-group synchronous
    # fetch would serialize device work behind each round trip.
    launched = []
    for (L2, use_cap, use_flank, _hclass), items in groups.items():
        seg_len = L2 + 15
        Wb = round_up(geom_bucket(len(items)), n_win)
        Hmax = geom_bucket(max(len(p.all_haps) for _, p in items))
        Rmax = geom_bucket(max(len(p.reads) for _, p in items), 64)
        variants_by_item = [enumerate_window_variants(p.all_haps)
                            for _, p in items]
        Vb = geom_bucket(max(1, max(len(v) for v in variants_by_item)))
        HB = geom_bucket(sum(p.request.hap_matrix.shape[0] for _, p in items), 32)
        AB = geom_bucket(sum(p.request.sub_seq.shape[0] for _, p in items), 256)
        L1B = geom_bucket(max(p.request.hap_matrix.shape[1] for _, p in items), 256)
        PB = round_up(geom_bucket(sum(p.request.n_pairs() for _, p in items),
                                  1024), n_dev)

        hap_mat = np.full((HB, L1B), ord("N"), np.uint8)
        go_mat = np.zeros((HB, L1B), np.uint8)
        seq_mat = np.zeros((AB, L2), np.uint8)
        qual_mat = np.zeros((AB, L2), np.uint8)
        pair_hap = np.zeros(PB, np.int32)
        pair_read = np.zeros(PB, np.int32)
        pair_seg = np.zeros(PB, np.int32)
        pair_len = np.full(PB, min(8, L2), np.int32)
        pair_scores = np.zeros(PB, np.int32) if use_flank else None
        pair_w = np.zeros(PB, np.int32)
        pair_h = np.zeros(PB, np.int32)
        pair_r = np.zeros(PB, np.int32)
        pair_valid = np.zeros(PB, bool)
        aligned = np.zeros((Wb, Rmax), bool)
        short = np.zeros((Wb, Rmax), bool)
        mapq = np.zeros((Wb, Rmax), np.int32)
        onehot = np.zeros((Wb, I, Rmax), np.float32)
        hap_mask = np.zeros((Wb, Hmax), bool)
        var_mask = np.zeros((Wb, Vb, Hmax), bool)
        has_reads = np.zeros((Wb, I), bool)

        h_off = a_off = p_off = 0
        for k, (w_idx, prep) in enumerate(items):
            req = prep.request
            H = len(prep.all_haps)
            R = len(prep.reads)
            nh, na = req.hap_matrix.shape[0], req.sub_seq.shape[0]
            np_pairs = req.n_pairs()
            hap_mat[h_off : h_off + nh, : req.hap_matrix.shape[1]] = req.hap_matrix
            go_mat[h_off : h_off + nh, : req.go_matrix.shape[1]] = req.go_matrix
            seq_mat[a_off : a_off + na] = req.sub_seq
            qual_mat[a_off : a_off + na] = req.sub_qual
            sl = slice(p_off, p_off + np_pairs)
            pair_hap[sl] = req.pair_hap + h_off
            pair_read[sl] = req.pair_read + a_off
            pair_seg[sl] = req.pair_seg
            pair_len[sl] = req.sub_len[req.pair_read]
            if use_flank:
                # Flank-corrected scores: the traceback scan on the GPU or
                # the scalar kernel on the CPU, + host penalty.
                from ..engine.score import flank_scores

                pair_scores[sl] = flank_scores(req, gapextend, nucprior)
            pair_w[sl] = k
            pair_h[sl] = req.pair_hap
            pair_r[sl] = req.align_rows[req.pair_read]
            pair_valid[sl] = True
            aligned[k, req.align_rows] = True
            short[k, req.align_rows[req.sub_len < HASH_NUCS]] = True
            mapq[k, :R] = prep.reads.mapq
            if R:
                onehot[k, prep.reads.sample_idx, np.arange(R)] = 1.0
            hap_mask[k, :H] = True
            # Iterate actual (variant, hap) memberships instead of the
            # dense V x H containment loop: same mask, O(sum |hap.variants|).
            vidx = {v: vi for vi, v in enumerate(variants_by_item[k])}
            for h, hap in enumerate(prep.all_haps):
                for v in hap.variants:
                    vi = vidx.get(v)
                    if vi is not None:
                        var_mask[k, vi, h] = True
            n_good = (np.bincount(prep.reads.sample_idx[prep.reads.is_good],
                                  minlength=I) if R else np.zeros(I, np.int64))
            has_reads[k] = n_good > 0
            h_off += nh
            a_off += na
            p_off += np_pairs

        h1, h2 = genotype_index_pairs(Hmax)
        tail_args = (
            jnp.asarray(pair_w), jnp.asarray(pair_h),
            jnp.asarray(pair_r), jnp.asarray(pair_valid),
            jnp.asarray(aligned), jnp.asarray(short), jnp.asarray(mapq),
            jnp.asarray(onehot), jnp.asarray(hap_mask),
            jnp.asarray(h1, jnp.int32), jnp.asarray(h2, jnp.int32),
            jnp.asarray(var_mask), jnp.asarray(has_reads),
        )
        with mesh:
            if use_flank:
                step = _region_call_step_from_scores(mesh, em_iters, use_cap)
                em_d, freq_d, ratio_d, margin_d = step(
                    jnp.asarray(pair_scores), *tail_args)
                sc_d = None
            else:
                step = _region_call_step(mesh, gapextend, nucprior, em_iters,
                                         use_cap)
                sc_d, em_d, freq_d, ratio_d, margin_d = step(
                    jnp.asarray(hap_mat), jnp.asarray(go_mat),
                    jnp.asarray(seq_mat), jnp.asarray(qual_mat),
                    jnp.asarray(pair_hap), jnp.asarray(pair_read),
                    jnp.asarray(pair_seg), jnp.asarray(pair_len),
                    *tail_args,
                )
        launched.append((items, variants_by_item, h1, h2, pair_scores,
                         sc_d, em_d, freq_d, ratio_d, margin_d))
    if _timers:
        print(f"[mesh] pack+launch {len(groups)} groups: "
              f"{_time.perf_counter() - _t0:.3f}s", flush=True)

    # Phase 2: one batched fetch of every group's outputs, then unpack.
    # With defer=True the fetch is handed back as a closure so the caller
    # can hide the device round-trip behind the next region's host work
    # (the pipeline's finish stage resolves it).
    def _fetch():
        import jax

        _tf = _time.perf_counter()
        flat = [d for g in launched for d in g[5:] if d is not None]
        fetched = iter(jax.device_get(flat))
        if _timers:
            print(f"[mesh] device_get: {_time.perf_counter() - _tf:.3f}s",
                  flush=True)
        _tu = _time.perf_counter()
        for (items, variants_by_item, h1, h2, pair_scores,
             sc_d, em_d, freq_d, ratio_d, margin_d) in launched:
            scores_h = (np.asarray(next(fetched)) if sc_d is not None
                        else pair_scores)
            em_h = np.asarray(next(fetched), np.float64)
            freq_h = np.asarray(next(fetched), np.float64)
            ratio_h = np.asarray(next(fetched), np.float64)
            margin_h = np.asarray(next(fetched), np.float64)

            p_off = 0
            for k, (w_idx, prep) in enumerate(items):
                req = prep.request
                H = len(prep.all_haps)
                cols = np.nonzero((h1 < H) & (h2 < H))[0]
                np_pairs = req.n_pairs()
                # Host-side scatter + f64 loglik conversion from the
                # sparse pair scores — bit-identical to the dispatch path.
                loglik_by_idx[w_idx] = window_loglik_from_pair_scores(
                    req, scores_h[p_off : p_off + np_pairs])
                p_off += np_pairs
                inference_by_idx[w_idx] = WindowInference(
                    em=em_h[k][:, cols],
                    frequencies=freq_h[k][:H],
                    ratios={v: float(ratio_h[k, vi])
                            for vi, v in enumerate(variants_by_item[k])},
                    em_margin=float(margin_h[k]),
                )
        if _timers:
            print(f"[mesh] unpack: {_time.perf_counter() - _tu:.3f}s",
                  flush=True)
        return loglik_by_idx, inference_by_idx

    if defer:
        return _fetch, leftover
    loglik_by_idx, inference_by_idx = _fetch()
    return loglik_by_idx, inference_by_idx, leftover


def make_example_batch(W=8, Hmax=4, Rmax=16, L2=24, seed=0):
    """Tiny synthetic window batch for compile checks and the dry run."""
    rng = np.random.default_rng(seed)
    L1 = L2 + 16
    S = L2 + 8
    bases = np.frombuffer(b"ACGT", np.uint8)

    hap_seqs = rng.choice(bases, size=(W, Hmax, L1)).astype(np.int32)
    # Reads copied from hap 0 with noise.
    reads = np.zeros((W, Rmax, L2), np.int32)
    for w in range(W):
        for r in range(Rmax):
            off = rng.integers(0, 8)
            reads[w, r] = hap_seqs[w, r % Hmax, off : off + L2]
    quals = np.full((W, Rmax, L2), 30, np.int32)
    read_len = np.full((W, Rmax), L2, np.int32)
    mapq = np.full((W, Rmax), 60, np.int32)

    hap_cols = np.ascontiguousarray(hap_seqs.transpose(2, 0, 1))
    go4_cols = np.full((L1, W, Hmax), 45 * 4, np.int32)
    read_cols = np.full((S, W, Rmax), ord("0"), np.int32)
    read_cols[:L2] = reads.transpose(2, 0, 1)
    qual4_cols = np.full((S, W, Rmax), 64 * 4, np.int32)
    qual4_cols[:L2] = 4 * quals.transpose(2, 0, 1)

    G = Hmax * (Hmax + 1) // 2
    h1 = np.array([i for i in range(Hmax) for _ in range(i, Hmax)], np.int32)
    h2 = np.array([j for i in range(Hmax) for j in range(i, Hmax)], np.int32)

    read_mask = np.ones((W, Rmax), bool)
    hap_mask = np.ones((W, Hmax), bool)
    geno_mask = np.ones((W, G), bool)
    hap_has_var = np.zeros((W, Hmax), bool)
    hap_has_var[:, 1:] = True

    return (hap_cols, go4_cols, read_cols, qual4_cols, read_len, mapq,
            read_mask, hap_mask, h1, h2, geno_mask, hap_has_var)


def dryrun_multichip(n_devices: int) -> None:
    """Compile + execute the full sharded calling step on an n-device mesh
    (reads sharded over a lane axis of 2 when n is even)."""
    mesh = make_mesh(n_devices, lane=2 if n_devices % 2 == 0 else 1)
    step = build_calling_step(mesh, em_iters=5)
    batch = make_example_batch(W=mesh.shape["win"] * 2, Rmax=mesh.shape["lane"] * 8)
    with mesh:
        freqs, ratios, scores = step(*batch)
        jax.block_until_ready((freqs, ratios, scores))
    assert np.isfinite(np.asarray(ratios)).all()
    assert np.asarray(freqs).shape[1] == 4
