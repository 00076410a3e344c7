"""Device-side (JAX) genotype-likelihood + EM pipeline.

Mirrors the exact float64 host kernels in ops/likelihood.py (the numeric
oracle, reference cgenotype.pyx/cpopulation.pyx), restructured for batched
device execution:

* fixed-shape masked tensors: a window batch is [W, Hmax] haplotypes,
  [W, Gmax] genotypes, [W, Rmax] reads, with validity masks — windows of any
  real size bucket into the same compiled program;
* the per-read genotype likelihood keeps the reference's three fast paths
  (same-hap; |Δ|>=3; |Δ|<=1e-3), summed over the (possibly device-sharded)
  read axis;
* EM runs a fixed-iteration masked update (lax.fori_loop) — the reference's
  convergence test is a max-change threshold with <=100 iterations; on
  device we run the fixed cap and let converged windows idle (their change
  is ~0), which is branch-free and batch-friendly.

Used by the throughput benchmark and the multi-chip pipeline
(parallel/mesh.py); VCF emission uses the float64 host path.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

LOG_HALF = -0.69314718055994529
MLTOT = -0.23025850929940459
LOG10E = 0.43429448190325182


def scores_to_logliks_jax(scores, mapq, cap: float = -300.0,
                          use_map_qual_cap: bool = False):
    """Device twin of ops.likelihood.scores_to_logliks; use_map_qual_cap
    is the HLA mode (per-read floor at the mapping-wrong probability with
    the smooth truncation above phred 100, chaplotype.pyx:619-676)."""
    prob_map_wrong = MLTOT * mapq
    prob_map_right = jnp.log1p(-jnp.exp(prob_map_wrong))
    if use_map_qual_cap:
        thr, shape = 100.0, 0.5
        trunc = MLTOT * (thr - 1.0 + jnp.power(
            jnp.maximum(scores - thr + 1.0, 0.0), shape) / shape)
        out = jnp.where(scores > thr, trunc, MLTOT * scores + prob_map_right)
        return jnp.maximum(prob_map_wrong, out)
    return jnp.maximum(cap, MLTOT * scores + prob_map_right)


def genotype_log_likelihoods_jax(loglik, hap1_idx, hap2_idx, read_mask):
    """loglik [H, R]; returns gl [G] summed over masked reads."""
    l1 = loglik[hap1_idx]
    l2 = loglik[hap2_idx]
    same = (hap1_idx == hap2_idx)[:, None]
    diff = jnp.abs(l1 - l2)
    mx = jnp.maximum(l1, l2)
    exact = mx + jnp.log1p(jnp.exp(-(diff))) + LOG_HALF  # log(0.5(e^l1+e^l2))
    per_read = jnp.where(
        same, l1,
        jnp.where(diff >= 3.0, LOG_HALF + mx, jnp.where(diff <= 1e-3, l1, exact)),
    )
    per_read = jnp.where(read_mask[None, :], per_read, 0.0)
    return per_read.sum(axis=1)


def rescale_likelihoods_jax(gl, geno_mask, has_reads):
    """gl [I, G] -> relative likelihoods, masked genotypes -> 0."""
    neg = jnp.where(geno_mask[None, :], gl, -jnp.inf)
    mx = jnp.max(neg, axis=1, keepdims=True)
    lik = jnp.maximum(1e-300, jnp.exp(gl - mx))
    lik = jnp.where(geno_mask[None, :], lik, 0.0)
    return jnp.where(has_reads[:, None], lik, jnp.where(geno_mask[None, :], 1.0, 0.0))


def em_frequencies_jax(likelihoods, hap1_idx, hap2_idx, n_haps_max: int,
                       hap_mask, has_reads, n_iters: int = 100):
    """EM over haplotype frequencies for one window (masked, fixed iters)."""
    freq, _resp = em_frequencies_resp_jax(
        likelihoods, hap1_idx, hap2_idx, n_haps_max, hap_mask, has_reads,
        n_iters)
    return freq


def em_frequencies_resp_jax(likelihoods, hap1_idx, hap2_idx, n_haps_max: int,
                            hap_mask, has_reads, n_iters: int = 100,
                            tol=None):
    """EM over haplotype frequencies for one window (masked).

    Returns (frequencies [Hmax], responsibilities [I, G]) — the latter are
    the reference's EMLikelihoods (cpopulation.pyx:415-427), used by
    --useEMLikelihoods genotype calls and the nInd>25 GL marginalisation.

    `tol` reproduces the reference's convergence stop (max frequency change
    <= min(1e-3, 1/(4 nInd)), cpopulation.pyx:678-716): a converged window
    freezes, so the vmapped while_loop (which runs until every lane is done)
    leaves its frequencies at the same fixed point the host path reports.
    None = fixed n_iters (legacy behaviour for the synthetic mesh demo).
    """
    n_haps = jnp.maximum(1, hap_mask.sum())
    n_with_data = jnp.maximum(1, has_reads.sum())
    het = 1.0 + (hap1_idx != hap2_idx)
    lik = jnp.where(has_reads[:, None], likelihoods, 0.0)

    freq0 = jnp.where(hap_mask, 1.0 / n_haps, 0.0)
    w0 = jnp.zeros_like(lik)

    def update(freq):
        w = lik * (freq[hap1_idx] * freq[hap2_idx] * het)[None, :]
        s = w.sum(axis=1, keepdims=True)
        w = jnp.where(s > 0, w / jnp.where(s > 0, s, 1.0), 0.0)
        resp = w.sum(axis=0)
        new = (
            jnp.zeros(n_haps_max, lik.dtype).at[hap1_idx].add(resp).at[hap2_idx].add(resp)
        ) / (2.0 * n_with_data)
        return jnp.where(hap_mask, new, 0.0), w

    if tol is None:
        def body(_, carry):
            freq, _w = carry
            return update(freq)

        freq, w = jax.lax.fori_loop(0, n_iters, body, (freq0, w0))
    else:
        def cond(carry):
            it, _freq, _w, done = carry
            return (it < n_iters) & ~done

        def body(carry):
            it, freq, w, done = carry
            new, new_w = update(freq)
            max_change = jnp.abs(new - freq).max()
            new_done = done | (max_change <= tol)
            freq = jnp.where(done, freq, new)
            w = jnp.where(done, w, new_w)
            return it + 1, freq, w, new_done

        _, freq, w, _ = jax.lax.while_loop(
            cond, body, (jnp.int32(0), freq0, w0, jnp.bool_(False)))
    return freq, jnp.where(has_reads[:, None], w, 0.0)


@functools.partial(jax.jit, static_argnames=("n_iters",))
def window_em_batch(gl, hap1_idx, hap2_idx, geno_mask, hap_mask, has_reads,
                    n_iters: int = 100):
    """Batched over windows: gl [W, I, G] log-likelihoods -> (likelihoods
    [W, I, G], frequencies [W, Hmax])."""

    def per_window(gl_w, h1, h2, gm, hm, hr):
        lik = rescale_likelihoods_jax(gl_w, gm, hr)
        freq = em_frequencies_jax(lik, h1, h2, hap_mask.shape[1], hm, hr, n_iters)
        return lik, freq

    return jax.vmap(per_window)(gl, hap1_idx, hap2_idx, geno_mask, hap_mask, has_reads)


def _lse(x, axis, keepdims=False):
    """Masked logsumexp: all--inf reductions give -inf (not nan)."""
    m = jnp.max(x, axis=axis, keepdims=True)
    m_safe = jnp.where(jnp.isfinite(m), m, 0.0)
    out = m_safe + jnp.log(jnp.sum(jnp.exp(x - m_safe), axis=axis,
                                   keepdims=True))
    out = jnp.where(jnp.isfinite(m), out, -jnp.inf)
    return out if keepdims else jnp.squeeze(out, axis)


LOG2 = 0.6931471805599453


def em_frequencies_log_jax(log_lik, hap1_idx, hap2_idx, n_haps_max: int,
                           hap_mask, has_reads, n_iters: int = 100,
                           tol: float = 1e-3):
    """Log-domain EM over haplotype frequencies (one window, masked).

    The reference EM (cpopulation.pyx:678-716) runs in linear double
    precision, where weak haplotypes converge to genuinely tiny frequencies
    (1e-48..1e-300) that matter for the no-variant renormalisation in the
    posterior ratio.  f32 linear space underflows those to zero, so on
    device the whole loop runs in log space — f32 log-domain covers the
    f64 linear-domain range with ~1e-4 absolute log error (<0.001 phred).

    log_lik [I, G]: relative genotype log-likelihoods (ln of the host
    path's floored values; -inf for masked genotypes).
    Returns (log_freq [Hmax], responsibilities [I, G] linear,
    convergence_margin scalar).

    `convergence_margin` is min over executed iterations of
    |max_freq_change - tol|: how close the reference's stopping test
    (cpopulation.pyx:705-716) came to flipping.  The f64 host EM and this
    f32 EM track each other within rounding error, so they stop at the
    SAME iteration — hence land within f32 error of each other — unless
    some iteration's change sat within that rounding error of tol.  The
    engine host-recomputes windows whose margin is small (the f64
    byte-exactness guard in engine/caller.finish_window).
    """
    log_het = jnp.where(hap1_idx != hap2_idx, LOG2, 0.0)
    ll = jnp.where(has_reads[:, None], log_lik, -jnp.inf)
    n_haps = jnp.maximum(1, hap_mask.sum())
    n_with_data = jnp.maximum(1, has_reads.sum())
    log_freq0 = jnp.where(hap_mask, -jnp.log(n_haps.astype(log_lik.dtype)),
                          -jnp.inf)
    # log A[g, h]: ln(multiplicity of hap h in genotype g) — the M-step's
    # scatter-add as a masked logsumexp contraction.
    counts = (jax.nn.one_hot(hap1_idx, n_haps_max, dtype=log_lik.dtype)
              + jax.nn.one_hot(hap2_idx, n_haps_max, dtype=log_lik.dtype))
    logA = jnp.where(counts > 0, jnp.log(jnp.maximum(counts, 1e-30)), -jnp.inf)
    log_denom = jnp.log(2.0 * n_with_data.astype(log_lik.dtype))
    w0 = jnp.full_like(ll, -jnp.inf)

    def update(log_freq):
        log_w = ll + (log_freq[hap1_idx] + log_freq[hap2_idx] + log_het)[None, :]
        log_s = _lse(log_w, 1, keepdims=True)
        log_wn = jnp.where(jnp.isfinite(log_s), log_w - log_s, -jnp.inf)
        log_resp = _lse(log_wn, 0)                               # [G]
        log_new = _lse(log_resp[:, None] + logA, 0) - log_denom  # [Hmax]
        return jnp.where(hap_mask, log_new, -jnp.inf), log_wn

    def cond(carry):
        it, _lf, _w, done, _margin = carry
        return (it < n_iters) & ~done

    def body(carry):
        it, log_freq, w, done, margin = carry
        new, new_w = update(log_freq)
        # Convergence is the reference's LINEAR max-change test.
        max_change = jnp.abs(jnp.exp(new) - jnp.exp(log_freq)).max()
        margin = jnp.minimum(margin, jnp.abs(max_change - tol))
        new_done = done | (max_change <= tol)
        log_freq = jnp.where(done, log_freq, new)
        w = jnp.where(done, w, new_w)
        return it + 1, log_freq, w, new_done, margin

    _, log_freq, log_wn, _, margin = jax.lax.while_loop(
        cond, body, (jnp.int32(0), log_freq0, w0, jnp.bool_(False),
                     jnp.asarray(jnp.inf, log_lik.dtype)))
    resp = jnp.where(has_reads[:, None], jnp.exp(log_wn), 0.0)
    return log_freq, resp, margin


def genotype_gl_gof_jax(loglik, hap1_idx, hap2_idx, sample_onehot):
    """Per-genotype data log-likelihood + goodness-of-fit sums, all samples.

    loglik [H, R]; sample_onehot [I, R] float (1.0 where the read row belongs
    to sample i — including bad/broken rows, matching the reference's
    per-individual array sweep, cgenotype.pyx:151-185; 0 for padding).
    Returns (gl [I, G], gof_sum [I, G]); the caller divides gof by the
    good-read count and scales by -10.  The [G, R] x [R, I] contractions are
    the MXU-friendly core of hot loop #2 (cpopulation.pyx:283-301)."""
    l1 = loglik[hap1_idx]       # [G, R]
    l2 = loglik[hap2_idx]
    same = (hap1_idx == hap2_idx)[:, None]
    diff = jnp.abs(l1 - l2)
    mx = jnp.maximum(l1, l2)
    exact = mx + jnp.log1p(jnp.exp(-diff)) + LOG_HALF
    per_read = jnp.where(
        same, l1,
        jnp.where(diff >= 3.0, LOG_HALF + mx, jnp.where(diff <= 1e-3, l1, exact)),
    )
    # Precision.HIGHEST: on the GPU an f32 matrix product may run in TF32
    # by default, which keeps ~3 decimal digits of each per-read
    # log-likelihood (e.g. -24.177 -> -24.172); over a 40-read window that
    # shifts the genotype GL by up to ~1 nat and the emitted QUAL by several
    # phred — far outside the f64-exactness guard's rounding-band model.
    # These [G,R]x[R,I] contractions are tiny; full f32 costs nothing.
    gl = jax.lax.dot(per_read, sample_onehot.T.astype(per_read.dtype),
                     precision=jax.lax.Precision.HIGHEST)  # [G, I]
    gof = jax.lax.dot(LOG10E * mx, sample_onehot.T.astype(mx.dtype),
                      precision=jax.lax.Precision.HIGHEST)
    return gl.T, gof.T


def infer_window_batch_core(loglik, sample_onehot, hap_mask, h1, h2,
                            var_hap_mask, has_reads, em_iters: int = 100):
    """Traced body of infer_window_batch (no jit wrapper) so the sharded
    region step (parallel/mesh.py) can inline it after the alignment pass."""
    Hmax = hap_mask.shape[1]
    n_ind = sample_onehot.shape[1]
    tol = min(1e-3, 1.0 / (n_ind * 4))  # reference eps, cpopulation.pyx:705

    def per_window(ll, oh, hm, vm, hr):
        gm = hm[h1] & hm[h2]
        gl, gof = genotype_gl_gof_jax(ll, h1, h2, oh)
        lik = rescale_likelihoods_jax(gl, gm, hr)
        # Everything downstream runs in log space: the host path's relative
        # likelihoods and EM frequencies span far below f32 LINEAR range
        # (1e-300 floor, cpopulation.pyx:304-309; weak-hap frequencies
        # ~1e-48..1e-300 after EM); f32 log-domain holds the full range.
        neg = jnp.where(gm[None, :], gl, -jnp.inf)
        mx = jnp.max(neg, axis=1, keepdims=True)
        gl_rel = jnp.maximum(gl - jnp.where(jnp.isfinite(mx), mx, 0.0), -690.77552)
        gl_rel = jnp.where(gm[None, :], gl_rel, -jnp.inf)
        gl_rel = jnp.where(hr[:, None], gl_rel, jnp.where(gm[None, :], 0.0, -jnp.inf))
        log_freq, em, em_margin = em_frequencies_log_jax(
            gl_rel, h1, h2, Hmax, hm, hr, em_iters, tol=tol)
        freq = jnp.exp(log_freq)
        ratios = jax.vmap(
            lambda hv: variant_posterior_logratio_jax(gl_rel, log_freq, hv,
                                                      h1, h2, hr)
        )(vm)
        # gl_rel doubles as the output likelihood table: exp()ed in float64
        # on host it reaches the reference's 1e-300 floor, which f32 linear
        # space cannot (GL entries between -38 and -300 log10 would
        # saturate otherwise).
        return lik, em, freq, gof, ratios, gl_rel, em_margin

    return jax.vmap(per_window)(loglik, sample_onehot, hap_mask, var_hap_mask,
                                has_reads)


@functools.partial(jax.jit, static_argnames=("em_iters",))
def infer_window_batch(loglik, sample_onehot, hap_mask, h1, h2, var_hap_mask,
                       has_reads, em_iters: int = 100):
    """Fused per-window inference for a bucketed window batch: genotype GLs
    -> relative likelihoods -> EM -> variant posterior ratios, all on device
    (f32) in one program.

    Shapes: loglik [W, Hmax, Rmax] (padded reads must carry loglik 0 and
    onehot 0); sample_onehot [W, I, Rmax]; hap_mask [W, Hmax];
    h1/h2 [G] genotype hap pairs for Hmax (lexicographic i<=j — window-local
    genotypes are the (h1<H_w & h2<H_w) columns, in order);
    var_hap_mask [W, Vmax, Hmax] (False-padded variant rows give ratio 0);
    has_reads [W, I].

    Returns (lik [W, I, G], em_resp [W, I, G], freq [W, Hmax],
    gof_sum [W, I, G], ratios [W, Vmax], gl_rel [W, I, G],
    em_margin [W]) where ratios is
    sum_i (ln P(data_i|no var) - ln P(data_i|var)), gl_rel are the
    relative genotype LOG likelihoods (floored at ln 1e-300; -inf for
    masked genotypes) — exp() them in float64 for full-range linear values
    — and em_margin is each window's EM convergence-test margin (see
    em_frequencies_log_jax; small margin => the engine must host-recompute
    the window for byte-exactness).
    """
    return infer_window_batch_core(loglik, sample_onehot, hap_mask, h1, h2,
                                   var_hap_mask, has_reads, em_iters)


def variant_posterior_logratio_jax(gl_rel, log_freq, hap_has_variant,
                                   hap1_idx, hap2_idx, has_reads):
    """Log-space twin of variant_posterior_ratio_jax: gl_rel [I, G] are
    per-individual relative genotype LOG likelihoods (ln of the host path's
    floored relative likelihoods; -inf for masked genotypes) and log_freq
    [Hmax] the log EM frequencies (-inf for masked haps).  Returns
    sum_i (ln P(data_i|no var) - ln P(data_i|var))."""
    log_fp = jnp.where(hap_has_variant, -jnp.inf, log_freq)
    log_s = _lse(log_fp, 0)
    log_fp = jnp.where(jnp.isfinite(log_s), log_fp - log_s, log_fp)
    log_het = jnp.where(hap1_idx != hap2_idx, LOG2, 0.0)
    lw_var = log_het + log_freq[hap1_idx] + log_freq[hap2_idx]
    lw_novar = log_het + log_fp[hap1_idx] + log_fp[hap2_idx]
    log_min = -708.0

    def log_dot(lw):
        t = lw[None, :] + gl_rel                      # [I, G]
        m = jnp.max(t, axis=1, keepdims=True)
        m_safe = jnp.where(jnp.isfinite(m), m, 0.0)
        out = m_safe[:, 0] + jnp.log(
            jnp.sum(jnp.exp(t - m_safe), axis=1))
        # The host computes each side in LINEAR f64 (floored at e^log_min);
        # reproduce that floor so saturated sides agree exactly.
        return jnp.maximum(jnp.where(jnp.isfinite(m[:, 0]), out, log_min),
                           log_min)

    lv = log_dot(lw_var)
    ln = log_dot(lw_novar)
    return jnp.where(has_reads, ln - lv, 0.0).sum()


def variant_posterior_ratio_jax(likelihoods, frequencies, hap_has_variant,
                                hap1_idx, hap2_idx, has_reads):
    """log P(no var) - log P(var) summed over individuals (one window)."""
    fp = jnp.where(hap_has_variant, 0.0, frequencies)
    s = fp.sum()
    fp = jnp.where(s > 0, fp / jnp.where(s > 0, s, 1.0), fp)
    factor = 1.0 + (hap1_idx != hap2_idx)
    w_var = factor * frequencies[hap1_idx] * frequencies[hap2_idx]
    w_novar = factor * fp[hap1_idx] * fp[hap2_idx]
    # Precision.HIGHEST: avoid the GPU's default TF32 input rounding (see
    # genotype_gl_gof_jax) on the posterior dot products.
    pv = jax.lax.dot(likelihoods, w_var.astype(likelihoods.dtype),
                     precision=jax.lax.Precision.HIGHEST)
    pn = jax.lax.dot(likelihoods, w_novar.astype(likelihoods.dtype),
                     precision=jax.lax.Precision.HIGHEST)
    log_min = -708.0
    lv = jnp.where(pv > 0, jnp.log(jnp.where(pv > 0, pv, 1.0)), log_min)
    ln = jnp.where(pn > 0, jnp.log(jnp.where(pn > 0, pn, 1.0)), log_min)
    return jnp.where(has_reads, ln - lv, 0.0).sum()
