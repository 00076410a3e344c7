"""Parity tests for the fused device GL/EM/posterior path
(ops/likelihood_jax.infer_window_batch + parallel/batch.py) against the
float64 host oracle (ops/likelihood.py) — VERDICT r1 item 2."""

import math

import numpy as np
import pytest

from platypus_tpu.ops import likelihood as lk


def _random_window(rng, H, R, I):
    """Synthetic per-window loglik + read metadata."""
    loglik = -np.abs(rng.normal(3.0, 4.0, size=(H, R)))
    loglik = np.maximum(loglik, -300.0)
    sample_idx = rng.integers(0, I, size=R).astype(np.int32)
    is_good = rng.random(R) < 0.9
    return loglik, sample_idx, is_good


def _host_reference(loglik, sample_idx, is_good, I, var_masks):
    H = loglik.shape[0]
    h1, h2 = lk.genotype_index_pairs(H)
    G = len(h1)
    n_reads = np.array([(is_good & (sample_idx == i)).sum() for i in range(I)])
    gl_by_ind = np.zeros((I, G))
    gof = np.zeros((I, G))
    for i in range(I):
        rows = np.nonzero(sample_idx == i)[0]
        if n_reads[i] == 0:
            continue
        gl, gof_sum = lk.genotype_log_likelihoods(loglik[:, rows], h1, h2)
        gl_by_ind[i] = gl
        gof[i] = gof_sum
    lik = lk.rescale_likelihoods(gl_by_ind, n_reads)
    freq, em, _ = lk.em_haplotype_frequencies(lik, h1, h2, H, n_reads, max_iters=100)
    ratios = []
    for has_var in var_masks:
        fp = np.where(has_var, 0.0, freq)
        s = fp.sum()
        if s > 0:
            fp = fp / s
        factor = 1.0 + (h1 != h2)
        w_var = factor * freq[h1] * freq[h2]
        w_novar = factor * fp[h1] * fp[h2]
        tot = 0.0
        for i in range(I):
            if n_reads[i] == 0:
                continue
            pv = float(np.dot(w_var, lik[i]))
            pn = float(np.dot(w_novar, lik[i]))
            tot += (math.log(pn) if pn > 0 else -708.0) - (
                math.log(pv) if pv > 0 else -708.0)
        ratios.append(tot)
    return lik, em, freq, gof, n_reads, np.array(ratios)


@pytest.mark.parametrize("H,R,I", [(2, 30, 1), (3, 55, 2), (5, 17, 3)])
def test_infer_window_batch_matches_host(H, R, I):
    import jax.numpy as jnp

    from platypus_tpu.ops.likelihood_jax import infer_window_batch

    rng = np.random.default_rng(42 + H)
    loglik, sample_idx, is_good = _random_window(rng, H, R, I)
    V = 2
    var_masks = [rng.random(H) < 0.5 for _ in range(V)]
    for m in var_masks:
        m[0] = False  # ref hap never carries the variant

    host_lik, host_em, host_freq, host_gof, n_reads, host_ratio = _host_reference(
        loglik, sample_idx, is_good, I, var_masks)

    # Pad into a bucketed batch (Hb > H, Rb > R, Vb > V, Wb = 2).
    Hb, Rb, Vb, Wb = H + 2, R + 10, V + 1, 2
    ll = np.zeros((Wb, Hb, Rb), np.float32)
    oh = np.zeros((Wb, I, Rb), np.float32)
    hm = np.zeros((Wb, Hb), bool)
    vm = np.zeros((Wb, Vb, Hb), bool)
    hr = np.zeros((Wb, I), bool)
    ll[0, :H, :R] = loglik
    oh[0, sample_idx, np.arange(R)] = 1.0
    hm[0, :H] = True
    for vi, m in enumerate(var_masks):
        vm[0, vi, :H] = m
    hr[0] = n_reads > 0

    h1b, h2b = lk.genotype_index_pairs(Hb)
    lik_d, em_d, freq_d, gof_d, ratio_d, glrel_d, margin_d = infer_window_batch(
        jnp.asarray(ll), jnp.asarray(oh), jnp.asarray(hm),
        jnp.asarray(h1b, jnp.int32), jnp.asarray(h2b, jnp.int32),
        jnp.asarray(vm), jnp.asarray(hr), em_iters=100)
    assert np.asarray(margin_d).shape == (Wb,)
    assert float(np.asarray(margin_d)[0]) >= 0.0

    cols = np.nonzero((h1b < H) & (h2b < H))[0]
    np.testing.assert_allclose(np.asarray(lik_d)[0][:, cols], host_lik,
                               rtol=2e-4, atol=1e-6)
    # The log-space output table reaches the host's 1e-300 floor after a
    # float64 exp (f32 linear space would saturate at ~1e-38).
    np.testing.assert_allclose(
        np.exp(np.asarray(glrel_d, np.float64))[0][:, cols], host_lik,
        rtol=1e-3, atol=1e-290)
    np.testing.assert_allclose(np.asarray(freq_d)[0][:H], host_freq,
                               rtol=2e-3, atol=1e-4)
    np.testing.assert_allclose(np.asarray(em_d)[0][:, cols], host_em,
                               rtol=2e-3, atol=1e-4)
    np.testing.assert_allclose(np.asarray(gof_d)[0][:, cols], host_gof,
                               rtol=2e-4, atol=1e-3)
    np.testing.assert_allclose(np.asarray(ratio_d)[0][:V], host_ratio,
                               rtol=5e-3, atol=0.25)
    # Padded window row stays finite and silent.
    assert np.isfinite(np.asarray(freq_d)[1]).all()
    assert np.asarray(ratio_d)[1].tolist() == [0.0] * Vb


def test_device_inference_e2e_matches_host_path(tmp_path):
    """Full CLI run with --deviceInference=1 (f32 fused path, CPU backend)
    vs =0 (host float64): same sites, genotypes and QUALs within 1 phred."""
    from synth import SimHaplotype, make_reference, simulate_reads, write_synth_bam

    workdir = str(tmp_path)
    ref_path, ref_seq = make_reference(workdir, length=24000, seed=11)
    variants = [(3000, 1, b"A" if ref_seq[3000] != ord("A") else b"C"),
                (6100, 3, b""),
                (9050, 0, b"TTA"),
                (12500, 1, b"G" if ref_seq[12500] != ord("G") else b"T")]
    hap = SimHaplotype(ref_seq, variants)
    reads = simulate_reads([hap, SimHaplotype(ref_seq, [])], 1000, 15000,
                           coverage=30, error_rate=0.002, seed=5,
                           fast_errors=True)
    write_synth_bam(workdir, reads, ref_len=24000)

    from platypus_tpu.cli import main as cli_main

    outs = {}
    for dev in (0, 1):
        out = f"{workdir}/out_dev{dev}.vcf"
        rc = cli_main([
            "callVariants",
            f"--bamFiles={workdir}/reads.bam",
            f"--refFile={ref_path}",
            "--regions=chr20:1000-15000",
            f"--deviceInference={dev}",
            "-o", out,
        ])
        assert rc == 0
        outs[dev] = [line for line in open(out) if not line.startswith("#")]

    assert len(outs[0]) == len(outs[1]) > 0
    # Full byte equality across inference backends: QUAL/PP/FR come from
    # the device f32 path only when the f64-exactness guard proves the
    # rounding cannot differ (engine/caller._device_window_needs_host);
    # otherwise the window recomputes on the host oracle.  PARITY §15.
    assert outs[0] == outs[1]


def test_f64_guard_margins():
    """Empirical basis for the f64-exactness guard bands
    (engine/caller._PP_BOUNDARY_EPS / _FR_BOUNDARY_EPS): over many random
    windows whose EM convergence margin is comfortable, the f32 device
    deviations from the f64 host oracle must stay below HALF each band —
    i.e. the bands carry >=2x measured worst case (in practice >=10x; the
    assertion is deliberately loose so small batches stay cheap)."""
    import jax.numpy as jnp

    from platypus_tpu.engine.caller import (_EM_MARGIN_EPS, _FR_BOUNDARY_EPS,
                                            _PP_BOUNDARY_EPS)
    from platypus_tpu.ops.likelihood_jax import infer_window_batch

    rng = np.random.default_rng(123)
    max_ratio_phred_dev = 0.0
    max_freq_dev = 0.0
    n_checked = 0
    for trial in range(60):
        H = int(rng.integers(2, 6))
        R = int(rng.integers(8, 60))
        I = int(rng.integers(1, 4))
        loglik, sample_idx, is_good = _random_window(rng, H, R, I)
        V = int(rng.integers(1, 3))
        var_masks = [rng.random(H) < 0.5 for _ in range(V)]
        for m in var_masks:
            m[0] = False
        host_lik, _em, host_freq, _gof, n_reads, host_ratio = _host_reference(
            loglik, sample_idx, is_good, I, var_masks)

        Hb, Rb, Vb = H + 1, R + 4, V
        ll = np.zeros((1, Hb, Rb), np.float32)
        oh = np.zeros((1, I, Rb), np.float32)
        hm = np.zeros((1, Hb), bool)
        vm = np.zeros((1, Vb, Hb), bool)
        hr = np.zeros((1, I), bool)
        ll[0, :H, :R] = loglik
        oh[0, sample_idx, np.arange(R)] = 1.0
        hm[0, :H] = True
        for vi, m in enumerate(var_masks):
            vm[0, vi, :H] = m
        hr[0] = n_reads > 0
        h1b, h2b = lk.genotype_index_pairs(Hb)
        out = infer_window_batch(
            jnp.asarray(ll), jnp.asarray(oh), jnp.asarray(hm),
            jnp.asarray(h1b, jnp.int32), jnp.asarray(h2b, jnp.int32),
            jnp.asarray(vm), jnp.asarray(hr), em_iters=100)
        freq_d = np.asarray(out[2], np.float64)[0][:H]
        ratio_d = np.asarray(out[4], np.float64)[0][:V]
        margin = float(np.asarray(out[6])[0])
        if margin < _EM_MARGIN_EPS:
            continue  # the guard would host-recompute this window anyway
        n_checked += 1
        # Phred-scale deviation of the posterior (prior factors cancel in
        # the derivative bound; 10/ln10 converts ln-ratio error to phred).
        max_ratio_phred_dev = max(
            max_ratio_phred_dev,
            float(np.max(np.abs(ratio_d - host_ratio))) * 10.0 / math.log(10.0))
        max_freq_dev = max(max_freq_dev,
                           float(np.max(np.abs(freq_d - host_freq))))
    assert n_checked >= 30
    assert max_ratio_phred_dev < _PP_BOUNDARY_EPS / 2, max_ratio_phred_dev
    assert max_freq_dev < _FR_BOUNDARY_EPS / 2, max_freq_dev


def test_mesh_covers_flank_and_capped_windows(tmp_path):
    """--calculateFlankScore (and HLA map-qual-cap) windows must ride the
    mesh: pair scores from the traceback path feed the shared
    scatter/inference program (_region_call_step_from_scores), and only
    pair-less windows may be left over (VERDICT r3 item 5)."""
    from synth import SimHaplotype, make_reference, simulate_reads, write_synth_bam

    from platypus_tpu.config import PlatypusConfig, derive_runtime
    from platypus_tpu.engine.caller import finish_window
    from platypus_tpu.engine.region import prepare_region_call
    from platypus_tpu.engine.runner import open_bams
    from platypus_tpu.io.fasta import FastaFile
    from platypus_tpu.parallel.mesh import make_mesh, mesh_call_region

    workdir = str(tmp_path)
    ref_path, ref_seq = make_reference(workdir, length=6000, seed=21)
    alt = SimHaplotype(ref_seq, [
        (1200, 1, b"A" if ref_seq[1200] != ord("A") else b"C"),
        (2500, 0, b"TG"),
        (3900, 2, b""),
    ])
    reads = simulate_reads([SimHaplotype(ref_seq, []), alt], 800, 5200,
                           read_len=80, coverage=24, seed=9)
    bam_path = write_synth_bam(workdir, reads, ref_len=6000)

    config = PlatypusConfig(bam_files=[bam_path], ref_file=ref_path,
                            output="-", calculate_flank_score=1)
    bam_files, samples_by_bam, samples = open_bams(config)
    ref = FastaFile(config.ref_file)
    rt = derive_runtime(config, n_individuals=len(samples))
    rt.rlen = config.rlen
    state = prepare_region_call("chr20", 0, 6000, bam_files,
                                samples_by_bam, ref, config, rt)
    assert state is not None and state.live
    assert any(p.request is not None and p.request.calculate_flank_score
               for _, p in state.live)

    ll_by, inf_by, leftover = mesh_call_region(state.live, len(samples),
                                               make_mesh(8, lane=2))
    assert all(p.request is None or p.request.n_pairs() == 0
               for _, p in leftover), "alignable flank windows left behind"
    assert ll_by

    # The flank-corrected mesh loglik must reproduce the host dispatch
    # (which itself pins device-vs-scalar flank parity) closely enough for
    # identical calls.
    host_ll = {w: ll for (w, _p), ll in
               zip(state.live, state.pending.finalize())} if state.pending \
        else {}
    n_calls = 0
    for w_idx, prep in state.live:
        if w_idx not in inf_by:
            continue
        if w_idx in host_ll:
            np.testing.assert_allclose(ll_by[w_idx], host_ll[w_idx],
                                       rtol=2e-4, atol=2e-4)
        host = finish_window(prep, ll_by[w_idx], ref, config)
        dev = finish_window(prep, ll_by[w_idx], ref, config,
                            inference=inf_by[w_idx])
        if host is None:
            continue
        assert host.genotype_calls == dev.genotype_calls
        assert set(host.variant_posteriors) == set(dev.variant_posteriors)
        n_calls += len(dev.variant_posteriors)
    assert n_calls >= 3
    for bam in bam_files:
        bam.close()
