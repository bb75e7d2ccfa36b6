"""Oracle tests for on-device peak picking vs scipy.signal.find_peaks.

The reference relies on the ``find_peaks`` crate (scipy-compatible
prominence/distance semantics, audio_matcher.rs:221-230); we verify our
batched device implementation against scipy directly.
"""

import numpy as np
import pytest
import scipy.signal

from audio_matcher_tpu.ops import find_peaks_device, pick_peaks_batch
import jax.numpy as jnp


def scipy_peaks(x, distance=None, prominence=None):
    kwargs = {}
    if distance is not None and distance > 0:
        kwargs["distance"] = distance
    peaks, props = scipy.signal.find_peaks(
        np.asarray(x, np.float64), prominence=(prominence, None), **kwargs
    )
    return list(peaks), list(props["prominences"])


def test_reference_overshadow_fixture():
    # parity: the reference's overshadow test data (audio_matcher.rs:167-185):
    # [0, .7, .5, 1, .5, .8, 0] → peaks at 1 (prom .2), 3 (prom 1.0), 5 (prom .3)
    x = np.array([0.0, 0.7, 0.5, 1.0, 0.5, 0.8, 0.0], np.float32)
    got = find_peaks_device(x, distance=1, min_prominence=0.0)
    assert [p.position for p in got] == [1, 3, 5]
    np.testing.assert_allclose(
        [p.prominence for p in got], [0.2, 1.0, 0.3], atol=1e-6
    )


@pytest.mark.parametrize("distance", [1, 5, 25])
def test_random_signal_vs_scipy(rng, distance):
    x = rng.standard_normal(2000).astype(np.float32)
    got = find_peaks_device(x, distance=distance, min_prominence=0.3)
    want_pos, want_prom = scipy_peaks(x, distance=distance, prominence=0.3)
    assert [p.position for p in got] == want_pos
    np.testing.assert_allclose(
        [p.prominence for p in got], want_prom, atol=1e-5
    )


def test_smooth_signal_vs_scipy(rng):
    # correlation-like smooth signal: low-pass filtered noise
    x = rng.standard_normal(50_000)
    kernel = np.hanning(101)
    x = np.convolve(x, kernel / kernel.sum(), mode="same").astype(np.float32)
    for distance, prom in [(1, 0.01), (100, 0.05), (5000, 0.0)]:
        got = find_peaks_device(x, distance=distance, min_prominence=prom)
        want_pos, want_prom = scipy_peaks(x, distance=distance, prominence=prom)
        assert [p.position for p in got] == want_pos, (distance, prom)
        np.testing.assert_allclose(
            [p.prominence for p in got], want_prom, atol=1e-5
        )


def test_batched_valid_len_masking(rng):
    x = rng.standard_normal((3, 1000)).astype(np.float32)
    valid = np.array([1000, 500, 10], np.int32)
    pos, h, prom = pick_peaks_batch(
        jnp.asarray(x), jnp.asarray(valid), distance=50, n_peaks=32
    )
    pos, h = np.asarray(pos), np.asarray(h)
    for b in range(3):
        keep = np.isfinite(h[b])
        assert (pos[b][keep] < valid[b] - 1).all()
        assert (pos[b][keep] >= 1).all()
        want_pos, _ = scipy_peaks(x[b][: valid[b]], distance=50, prominence=0.0)
        assert sorted(pos[b][keep].tolist()) == want_pos


def test_block_boundaries():
    # peak whose prominence bases straddle block boundaries
    x = np.zeros(4096, np.float32)
    x[100] = 5.0  # highest
    x[2000] = 3.0  # its nearest-higher is at 100, range min over (100, 2000]
    x[1500] = -2.0  # the range min
    x[3000] = 1.0
    got = find_peaks_device(x, distance=1, min_prominence=0.0, block=512)
    by_pos = {p.position: p for p in got}
    # left walk from 2000 stops at the higher 5.0 peak, spanning the -2.0 dip;
    # right base is the 0.0 floor → prominence = 3.0 - max(-2.0, 0.0)
    assert by_pos[2000].prominence == pytest.approx(3.0)
    want_pos, want_prom = scipy_peaks(x, distance=1, prominence=0.0)
    assert sorted(by_pos) == want_pos
    np.testing.assert_allclose(
        [by_pos[p].prominence for p in want_pos], want_prom, atol=1e-6
    )
