"""Device polyphase resampler vs the scipy oracle."""

import math

import numpy as np
import pytest
import scipy.signal

from audio_matcher_tpu.ops.resample import resample_poly_device


@pytest.mark.parametrize(
    "sr_from,sr_to",
    [(44100, 48000), (48000, 44100), (8000, 16000), (22050, 8000)],
)
def test_matches_scipy_resample_poly(rng, sr_from, sr_to):
    x = rng.standard_normal(33333).astype(np.float32)
    g = math.gcd(sr_from, sr_to)
    want = scipy.signal.resample_poly(
        x.astype(np.float64), sr_to // g, sr_from // g
    ).astype(np.float32)
    got = np.asarray(resample_poly_device(x, sr_from, sr_to))
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) < 2e-6


def test_identity_rate(rng):
    x = rng.standard_normal(100).astype(np.float32)
    got = np.asarray(resample_poly_device(x, 8000, 8000))
    np.testing.assert_array_equal(got, x)


def test_cross_rate_match_via_device_resample(rng):
    """A 2x-rate episode resampled on device still yields the exact match
    position at the snippet's rate."""
    from audio_matcher_tpu.models.matcher import MatchConfig, SnippetMatcher

    SR = 8000
    snippet = (rng.standard_normal(SR) * 0.2).astype(np.float32)
    episode = (rng.standard_normal(20 * SR) * 0.05).astype(np.float32)
    episode[6 * SR : 7 * SR] = snippet
    hi = scipy.signal.resample_poly(episode.astype(np.float64), 2, 1).astype(
        np.float32
    )
    back = np.asarray(resample_poly_device(hi, 2 * SR, SR))
    m = SnippetMatcher(
        snippet, SR, MatchConfig(chunk_secs=5, distance_secs=8, slab=2)
    )
    peaks = m.match(back)
    assert peaks and abs(peaks[0].position - 6 * SR) <= 1


def test_wire_int16_device_output(rng):
    """Device-side quantization to the int16 staging wire matches the f32
    result quantized on host (halves the readback bytes)."""
    x = (rng.standard_normal(12345) * 0.12).astype(np.float32)
    f = np.asarray(resample_poly_device(x, 44100, 48000))
    w = np.asarray(resample_poly_device(x, 44100, 48000, wire_int16=True))
    assert w.dtype == np.int16
    want = np.clip(np.round(f * 65535.0), -32768, 32767).astype(np.int16)
    assert np.max(np.abs(w.astype(np.int32) - want.astype(np.int32))) <= 1


def test_bucketed_lengths_share_compiles(rng):
    """Distinct episode lengths inside one bucket reuse the SAME compiled
    conv (real archives have a unique length per file; a per-length
    compile would recur for every file), and bucketed
    results stay exactly scipy-equal."""
    from audio_matcher_tpu.ops import resample as mod

    assert mod._bucket_len(5000) == 5120
    assert mod._bucket_len(5120) == 5120
    assert mod._bucket_len(5121) == 6144
    assert mod._bucket_len(7) == 8
    mod._resample_conv.clear_cache()
    for n in (5000, 5050, 5119, 5120):
        x = rng.standard_normal(n).astype(np.float32)
        got = np.asarray(resample_poly_device(x, 8000, 12000))
        want = scipy.signal.resample_poly(x.astype(np.float64), 3, 2).astype(
            np.float32
        )
        assert got.shape == want.shape
        assert np.max(np.abs(got - want)) < 2e-6
    assert mod._resample_conv._cache_size() == 1


def test_hostio_resample_impl_dispatch(rng):
    """hostio.decode.resample routes impl=device through ops.resample and
    stays scipy-equivalent; int16 wire in/out round-trips correctly."""
    from audio_matcher_tpu.hostio.decode import resample

    # stay well inside the ±0.5 wire clip range (reference PCM grid) so
    # the int16-input comparison below isn't clipped
    x = (rng.standard_normal(3000) * 0.1).astype(np.float32)
    a = resample(x, 8000, 12000, impl="scipy")
    b = resample(x, 8000, 12000, impl="device")
    assert a.shape == b.shape
    assert np.max(np.abs(a - b)) < 2e-6
    w = resample(x, 8000, 12000, impl="device", wire_int16=True)
    ws = resample(x, 8000, 12000, impl="scipy", wire_int16=True)
    assert w.dtype == np.int16 and ws.dtype == np.int16
    assert np.max(np.abs(w.astype(int) - ws.astype(int))) <= 1
    # int16 wire INPUT is interpreted on the reference PCM grid
    xi = np.clip(np.round(x * 65535.0), -32768, 32767).astype(np.int16)
    c = resample(xi, 8000, 12000, impl="device")
    assert np.max(np.abs(c - b)) < 1e-4


def test_resample_exact_length_at_bucket_boundaries(rng):
    """Review r3 (execution-confirmed): with up > down and the input
    length on a bucket boundary, the conv's right pad came up short and
    the output lost up to up-1 samples vs scipy."""
    from scipy.signal import resample_poly

    from audio_matcher_tpu.ops.resample import resample_poly_device

    for n, fr, to in [(1024, 16000, 48000), (1000, 8000, 48000),
                      (8, 8000, 48000), (4410, 44100, 48000)]:
        x = (rng.standard_normal(n) * 0.1).astype(np.float32)
        g = np.gcd(fr, to)
        want = resample_poly(x, to // g, fr // g)
        got = np.asarray(resample_poly_device(x, fr, to))
        assert got.shape == want.shape, (n, fr, to, got.shape, want.shape)
        np.testing.assert_allclose(got, want, atol=1e-5)


def test_resample_batched_2d(rng):
    """Leading dims ride the conv batch dimension."""
    from scipy.signal import resample_poly

    from audio_matcher_tpu.ops.resample import resample_poly_device

    xb = (rng.standard_normal((3, 1024)) * 0.1).astype(np.float32)
    got = np.asarray(resample_poly_device(xb, 16000, 48000))
    want = resample_poly(xb, 3, 1, axis=-1)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5)
