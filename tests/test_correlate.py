"""Oracle tests for the device correlation core.

Mirrors the reference's differential-testing discipline
(audio_matcher.rs:489-517: MyConvolve vs LibConvolve within 1.2e-5): our
jnp path is compared against scipy.signal.correlate (float64) with an
explicit float tolerance.
"""

import importlib

import numpy as np
import pytest
import scipy.signal

from audio_matcher_tpu.ops import (
    correlate,
    correlate_valid_batch,
    prepare_snippet,
)

TOL = 1.2e-5  # parity: the reference's oracle tolerance


def ref_correlate(within, sample, mode):
    return scipy.signal.correlate(
        np.asarray(within, np.float64), np.asarray(sample, np.float64), mode=mode
    )


@pytest.mark.parametrize("mode", ["full", "same", "valid"])
def test_matches_scipy_modes(mode):
    # parity with the reference's oracle data: test_data(-10..10) vs [1,2,3]
    within = np.arange(-10, 10, dtype=np.float32)
    sample = np.array([1.0, 2.0, 3.0], np.float32)
    got = np.asarray(correlate(within, sample, mode=mode))
    want = ref_correlate(within, sample, mode)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=TOL)


def test_matches_scipy_random(rng):
    within = rng.standard_normal(4000).astype(np.float32)
    sample = rng.standard_normal(50).astype(np.float32)
    got = np.asarray(correlate(within, sample, mode="valid"))
    want = ref_correlate(within, sample, "valid")
    np.testing.assert_allclose(got, want, atol=2e-3)  # f32 FFT on 4k pts
    # relative error against signal scale is tight
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, atol=TOL * 10)


def test_scale_normalizes_perfect_match(rng):
    sample = rng.standard_normal(500).astype(np.float32)
    within = np.concatenate([np.zeros(200, np.float32), sample, np.zeros(300, np.float32)])
    out = np.asarray(correlate(within, sample, mode="valid", scale=True))
    assert abs(out[200] - 1.0) < 1e-3
    assert out.argmax() == 200


def test_batched_valid_equals_single(rng):
    windows = rng.standard_normal((4, 1024)).astype(np.float32)
    sample = rng.standard_normal(100).astype(np.float32)
    prep = prepare_snippet(sample)
    batch = np.asarray(
        correlate_valid_batch(windows, sample, scale=prep.inv_autocorr)
    )
    assert batch.shape == (4, 1024 - 100 + 1)
    for i in range(4):
        want = ref_correlate(windows[i], sample, "valid") * prep.inv_autocorr
        np.testing.assert_allclose(batch[i], want, atol=1e-4)


def test_conjugation_vs_reverse_multiply(rng):
    # parity: the reference's oracle test covers both MyConvolve modes
    # (audio_matcher.rs:489-506: conj and flip-reverse agree)
    within = np.arange(-10, 10, dtype=np.float32)
    sample = np.array([1.0, 2.0, 3.0], np.float32)
    conj = np.asarray(correlate(within, sample, mode="valid"))
    rev = np.asarray(
        correlate(within, sample, mode="valid", use_conjugation=False)
    )
    np.testing.assert_allclose(conj, rev, atol=TOL)
    w = rng.standard_normal(500).astype(np.float32)
    s = rng.standard_normal(64).astype(np.float32)
    for mode in ("full", "same", "valid"):
        np.testing.assert_allclose(
            np.asarray(correlate(w, s, mode=mode)),
            np.asarray(correlate(w, s, mode=mode, use_conjugation=False)),
            atol=1e-4,
        )


def test_degenerate_shorter_within():
    # parity: audio_matcher.rs:454 saturating_sub → single output value
    within = np.array([1.0, 2.0], np.float32)
    sample = np.array([1.0, 1.0, 1.0], np.float32)
    got = np.asarray(correlate(within, sample, mode="valid"))
    assert got.shape == (1,)


@pytest.mark.parametrize("op", ["fft", "ifft", "rfft", "irfft"])
@pytest.mark.parametrize("lead", [(6,), (7,), (2, 3, 5)])
def test_fft_rows_chunks_below_the_element_limit(monkeypatch, rng, op, lead):
    """Above FFT_MAX_ELEMENTS per call, fft_rows splits the leading batch
    into equal chunks (7 rows: a prime count → single-row chunks) and
    returns exactly what one call returns."""
    import jax.numpy as jnp

    C = importlib.import_module("audio_matcher_tpu.ops.correlate")

    n = 64
    width = n // 2 + 1 if op == "irfft" else n
    x = rng.standard_normal((*lead, width))
    if op != "rfft":
        x = x + 1j * rng.standard_normal((*lead, width))
    x = jnp.asarray(x.astype(np.complex64 if op != "rfft" else np.float32))
    want = getattr(jnp.fft, op)(x, n=n)
    monkeypatch.setattr(C, "FFT_MAX_ELEMENTS", 3 * n)
    got = C.fft_rows(op, x, n)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_resident_xla_scan_same_peaks_with_chunked_fft(monkeypatch, rng):
    """The resident multi-query scan on fft_impl="xla" finds the same
    peaks when its batched irfft is forced through fft_rows' chunking."""
    from audio_matcher_tpu.models.matcher import MatchConfig
    C = importlib.import_module("audio_matcher_tpu.ops.correlate")
    from audio_matcher_tpu.parallel.mesh import make_mesh
    from audio_matcher_tpu.parallel.sweep import ShardedScanner

    sr = 1000
    snips = [(rng.standard_normal(sr // 2) * 0.2).astype(np.float32),
             (rng.standard_normal(sr // 3) * 0.2).astype(np.float32)]
    ep = (rng.standard_normal(sr * 12) * 0.05).astype(np.float32)
    ep[2500:2500 + len(snips[0])] = snips[0]
    ep[7100:7100 + len(snips[1])] = snips[1]
    cfg = MatchConfig(fft_impl="xla", chunk_secs=4.0, distance_secs=2.0,
                      slab=2, block=256)

    def scan():
        sc = ShardedScanner(snips, sr, cfg, mesh=make_mesh(1))
        return [[(p.position, p.height) for p in per_q]
                for per_q in sc.scan_resident([ep])[0]]

    want = scan()
    monkeypatch.setattr(C, "FFT_MAX_ELEMENTS", 2 * 8192)
    got = scan()
    assert [[p for p, _ in q] for q in got] == [[p for p, _ in q] for q in want]
    assert [p for p, h in want[0] if h > 0.5] == [2500]
    for gq, wq in zip(got, want):
        np.testing.assert_allclose([h for _, h in gq], [h for _, h in wq],
                                   rtol=1e-5, atol=1e-6)
