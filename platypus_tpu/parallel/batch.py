"""Bridge from prepared windows to fixed-shape device inference batches.

The per-window inference math (genotype GLs, EM, posterior ratios — the
reference's hot loop #2, cpopulation.pyx:283-457) is a pile of small dense
ops; running it window-by-window on device would drown in dispatch latency.
Instead the region's windows are bucketed by (haplotype count, read count,
variant count) into a few fixed shapes, padded with masks, and each bucket
runs ONE fused jitted program (ops/likelihood_jax.infer_window_batch).

The float64 host path (ops/likelihood.py) remains the numeric oracle and
the CPU path; f32 deviations are bounded (documented in docs/PARITY.md) and
the engine enables this path by default only on the GPU
(config.device_inference).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..candidates.variant import Variant


def geom_bucket(n: int, base: int = 2) -> int:
    """Smallest base*{1,1.5}*2^k >= n (bounds compiled shapes, <=33% pad)."""
    b = base
    while b < n:
        if b + b // 2 >= n:
            return b + b // 2
        b *= 2
    return b


def enumerate_window_variants(all_haps) -> List[Variant]:
    """Unique variants of a window's haplotypes in deterministic first-seen
    order — the exact enumeration finish_window's posterior loop uses, so
    device ratio rows map back by position."""
    out: List[Variant] = []
    seen = set()
    for hap in all_haps:
        for v in hap.variants:
            if v not in seen:
                seen.add(v)
                out.append(v)
    return out


@dataclass
class WindowInference:
    """Device inference results for one window, gathered back to host.

    GL/GOF emission always comes from the f64 host oracle
    (engine/caller.finish_window), so only the EM tables and posterior
    ratios are transferred from the device."""

    em: np.ndarray             # [I, G_w] EM responsibilities
    frequencies: np.ndarray    # [H_w]
    ratios: Dict[Variant, float]  # ln P(no var) - ln P(var)
    # EM convergence-test margin (ops/likelihood_jax.em_frequencies_log_jax):
    # min over iterations of |max_freq_change - tol|.  inf when the loop
    # never ran.  finish_window's f64-exactness guard host-recomputes the
    # window when this is small (the f32/f64 EMs may have stopped at
    # different iterations).
    em_margin: float = float("inf")


class PendingInference:
    """In-flight device inference for a region's windows.

    dispatch_device_inference() launches the fused programs and returns
    immediately (JAX async dispatch keeps them in flight); gather() blocks
    on the transfers.  The split lets the engine keep region k's EM on the
    device while region k+1 does its host work (same pipeline split as
    PendingAlignments in engine/score.py)."""

    def __init__(self):
        self.buckets: list = []  # (items, h1, h2, device result tuple)

    def gather(self) -> Dict[int, WindowInference]:
        out: Dict[int, WindowInference] = {}
        if self.buckets:
            # One batched transfer for the CONSUMED outputs only (EM
            # tables, frequencies, ratios): per-array fetches each pay a
            # full device round trip, device_get overlaps them all, and the
            # device GL/GOF tables never ship.
            import jax

            fetched = jax.device_get(
                [(dev[1], dev[2], dev[4], dev[6]) for _, _, _, dev in self.buckets])
            self.buckets = [(items, h1, h2, dev) for (items, h1, h2, _), dev
                            in zip(self.buckets, fetched)]
        for items, h1, h2, (em_d, freq_d, ratio_d, margin_d) in self.buckets:
            out.update(inference_results_to_windows(
                items, h1, h2,
                np.asarray(em_d, np.float64), np.asarray(freq_d, np.float64),
                np.asarray(ratio_d, np.float64),
                np.asarray(margin_d, np.float64)))
        self.buckets = []
        return out


def run_device_inference(
    live: Sequence[Tuple[int, object]],   # (window index, PreparedWindow)
    loglik_by_idx: Dict[int, np.ndarray],
    n_individuals: int,
    em_iters: int = 100,
) -> Dict[int, WindowInference]:
    """Dispatch + gather in one call (tests)."""
    return dispatch_device_inference(
        live, loglik_by_idx, n_individuals, em_iters=em_iters).gather()


@dataclass
class InferenceBatch:
    """One bucketed, padded window batch ready for the fused program —
    either dispatched locally (dispatch_device_inference) or shipped to
    the device-owner service (engine/device_service.py).  The array
    fields are exactly infer_window_batch's inputs except h1/h2, which
    the consumer derives from hap_mask.shape[1]."""

    items: list                # (w_idx, prep, ll, variants)
    loglik: np.ndarray         # [W, Hb, Rb] float32
    onehot: np.ndarray         # [W, I, Rb] float32
    hap_mask: np.ndarray       # [W, Hb] bool
    var_mask: np.ndarray       # [W, Vb, Hb] bool
    has_reads: np.ndarray      # [W, I] bool

    def arrays(self) -> dict:
        return dict(loglik=self.loglik, onehot=self.onehot,
                    hap_mask=self.hap_mask, var_mask=self.var_mask,
                    has_reads=self.has_reads)


def build_inference_batches(
    live: Sequence[Tuple[int, object]],   # (window index, PreparedWindow)
    loglik_by_idx: Dict[int, np.ndarray],
    n_individuals: int,
) -> List[InferenceBatch]:
    """Bucket + pad every live window into fixed-shape batches."""
    groups: Dict[Tuple[int, int, int], list] = {}
    for w_idx, prep in live:
        ll = loglik_by_idx[w_idx]
        H = len(prep.all_haps)
        R = len(prep.reads)
        if H == 0:
            continue
        if ll.size == 0:
            ll = np.zeros((H, R), np.float64)
        variants = enumerate_window_variants(prep.all_haps)
        key = (geom_bucket(H), geom_bucket(max(1, R), 64),
               geom_bucket(max(1, len(variants))))
        groups.setdefault(key, []).append((w_idx, prep, ll, variants))

    batches: List[InferenceBatch] = []
    I = n_individuals
    for (Hb, Rb, Vb), items in groups.items():
        Wb = geom_bucket(len(items))
        loglik = np.zeros((Wb, Hb, Rb), np.float32)
        onehot = np.zeros((Wb, I, Rb), np.float32)
        hap_mask = np.zeros((Wb, Hb), bool)
        var_mask = np.zeros((Wb, Vb, Hb), bool)
        has_reads = np.zeros((Wb, I), bool)
        for k, (w_idx, prep, ll, variants) in enumerate(items):
            H, R = ll.shape
            loglik[k, :H, :R] = ll
            if R:
                onehot[k, prep.reads.sample_idx, np.arange(R)] = 1.0
            hap_mask[k, :H] = True
            # Invert the (variant in hap) test: iterate each hap's own
            # (small) variant set instead of V x H membership probes.
            vidx = {v: vi for vi, v in enumerate(variants)}
            for h, hap in enumerate(prep.all_haps):
                rows = [vidx[v] for v in hap.variants if v in vidx]
                if rows:
                    var_mask[k, rows, h] = True
            n_good = np.bincount(prep.reads.sample_idx[prep.reads.is_good],
                                 minlength=I) if R else np.zeros(I, np.int64)
            has_reads[k] = n_good > 0
        batches.append(InferenceBatch(items, loglik, onehot, hap_mask,
                                      var_mask, has_reads))
    return batches


def inference_results_to_windows(
    items: list, h1: np.ndarray, h2: np.ndarray,
    em_h: np.ndarray, freq_h: np.ndarray, ratio_h: np.ndarray,
    margin_h: np.ndarray,
) -> Dict[int, WindowInference]:
    """Map one batch's (host-side) result arrays back to WindowInference
    per window index — shared by the local gather and the service client."""
    out: Dict[int, WindowInference] = {}
    for k, (w_idx, prep, ll, variants) in enumerate(items):
        H, R = ll.shape
        cols = np.nonzero((h1 < H) & (h2 < H))[0]
        out[w_idx] = WindowInference(
            em=em_h[k][:, cols],
            frequencies=freq_h[k][:H],
            ratios={v: float(ratio_h[k, vi])
                    for vi, v in enumerate(variants)},
            em_margin=float(margin_h[k]),
        )
    return out


def launch_fused_inference(loglik, onehot, hap_mask, var_mask, has_reads,
                           em_iters: int = 100):
    """Launch ONE fused GL/EM/posterior batch on the device and start the
    device->host copies of the consumed outputs (they stream behind the
    compute).  The single dispatch used by both the in-process pipeline
    (dispatch_device_inference) and the device-owner service
    (engine/device_service.py) — any change to infer_window_batch's output
    tuple must be threaded through exactly here.  Returns (h1, h2, dev)."""
    import jax.numpy as jnp

    from ..ops.likelihood import genotype_index_pairs
    from ..ops.likelihood_jax import infer_window_batch

    Hb = hap_mask.shape[1]
    h1, h2 = genotype_index_pairs(Hb)
    dev = infer_window_batch(
        jnp.asarray(loglik), jnp.asarray(onehot), jnp.asarray(hap_mask),
        jnp.asarray(h1, jnp.int32), jnp.asarray(h2, jnp.int32),
        jnp.asarray(var_mask), jnp.asarray(has_reads), em_iters=em_iters,
    )
    for arr in (dev[1], dev[2], dev[4], dev[6]):
        arr.copy_to_host_async()
    return h1, h2, dev


def dispatch_device_inference(
    live: Sequence[Tuple[int, object]],   # (window index, PreparedWindow)
    loglik_by_idx: Dict[int, np.ndarray],
    n_individuals: int,
    em_iters: int = 100,
) -> PendingInference:
    """Launch the fused GL/EM/posterior program over every live window,
    bucketed by shape; returns a PendingInference to gather() later."""
    from ..utils.observability import GLOBAL_METRICS as metrics

    pending = PendingInference()
    for batch in build_inference_batches(live, loglik_by_idx, n_individuals):
        metrics.count("device_inference_windows", len(batch.items))
        h1, h2, dev = launch_fused_inference(
            batch.loglik, batch.onehot, batch.hap_mask, batch.var_mask,
            batch.has_reads, em_iters=em_iters)
        pending.buckets.append((batch.items, h1, h2, dev))
    return pending
