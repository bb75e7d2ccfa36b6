"""Staging paths: int16 wire format + whole-batch single-program scan."""

import numpy as np
import pytest

from audio_matcher_tpu.models import MatchConfig, SnippetMatcher

SR = 8000


@pytest.fixture
def fixture(rng):
    # int16 full scale is ±0.5 in the reference PCM scaling — stay below
    snippet = np.clip(
        rng.standard_normal(2 * SR) * 0.1, -0.45, 0.45
    ).astype(np.float32)
    episodes = []
    # keep insertions further apart than distance_secs=30 so the
    # overshadow pass doesn't (correctly) drop the weaker twin
    offsets = [[5.0], [12.0, 44.0], []]
    for offs in offsets:
        ep = (rng.standard_normal(50 * SR) * 0.03).astype(np.float32)
        for off in offs:
            i = int(off * SR)
            ep[i : i + len(snippet)] = snippet
        episodes.append(ep)
    return snippet, episodes, offsets


def test_int16_transfer_matches_float32(fixture):
    snippet, episodes, offsets = fixture
    cfg32 = MatchConfig(chunk_secs=10, distance_secs=30, slab=4)
    cfg16 = MatchConfig(
        chunk_secs=10, distance_secs=30, slab=4, transfer_dtype="int16"
    )
    m32 = SnippetMatcher(snippet, SR, cfg32)
    m16 = SnippetMatcher(snippet, SR, cfg16)
    for ep in episodes:
        p32 = m32.match(ep)
        p16 = m16.match(ep)
        assert [p.position for p in p16] == [p.position for p in p32]
        for a, b in zip(p16, p32):
            assert a.height == pytest.approx(b.height, abs=1e-3)
            assert a.prominence == pytest.approx(b.prominence, abs=1e-3)


def test_batch_scan_equals_individual(fixture):
    snippet, episodes, offsets = fixture
    cfg = MatchConfig(chunk_secs=10, distance_secs=30, slab=4)
    matcher = SnippetMatcher(snippet, SR, cfg)
    individual = [matcher.match(ep) for ep in episodes]
    batch = matcher.match_staged_batch(matcher.stage_batch(episodes))
    assert len(batch) == len(individual)
    for got, want, offs in zip(batch, individual, offsets):
        assert [p.position for p in got] == [p.position for p in want]
        assert [p.position for p in got] == [int(o * SR) for o in offs]


def test_mulaw8_lossy_transfer(fixture):
    """μ-law int8 wire: positions sample-exact, scores within a few %."""
    snippet, episodes, offsets = fixture
    cfg32 = MatchConfig(chunk_secs=10, distance_secs=30, slab=4)
    cfg8 = MatchConfig(
        chunk_secs=10, distance_secs=30, slab=4, transfer_dtype="mulaw8"
    )
    m32 = SnippetMatcher(snippet, SR, cfg32)
    m8 = SnippetMatcher(snippet, SR, cfg8)
    for ep, offs in zip(episodes, offsets):
        p32 = m32.match(ep)
        p8 = m8.match(ep)
        assert [p.position for p in p8] == [p.position for p in p32]
        assert [p.position for p in p8] == [int(o * SR) for o in offs]
        for a, b in zip(p8, p32):
            assert a.height == pytest.approx(b.height, rel=0.05)


def test_quantize_wire_int16_to_float32():
    """int16 wire values passed with the float32 transfer dtype are
    rescaled back to reference PCM (decoder int16 output fed to a
    float32-configured matcher)."""
    import numpy as np

    from audio_matcher_tpu.models.matcher import quantize_wire

    wire = np.array([-32768, -1, 0, 1, 32767], np.int16)
    back = quantize_wire(wire, "float32")
    np.testing.assert_allclose(
        back, wire.astype(np.float32) / 65535.0, rtol=1e-6
    )
    # f32 input is passed through untouched
    x = np.array([0.25, -0.1], np.float32)
    np.testing.assert_array_equal(quantize_wire(x, "float32"), x)


def test_mulaw_tables_roundtrip():
    from audio_matcher_tpu.models.matcher import (
        _ulaw_tables, quantize_wire,
    )
    import numpy as np

    enc, dec = _ulaw_tables()
    assert enc.shape == (65536,) and dec.shape == (256,)
    x = np.linspace(-0.45, 0.45, 1001).astype(np.float32)
    back = dec[quantize_wire(x, "mulaw8").astype(np.int32)]
    # companded 8-bit: relative error bounded for non-tiny amplitudes
    # μ-law step size is ln(256)/255 ≈ 2.2% relative
    big = np.abs(x) > 0.01
    assert np.max(np.abs(back[big] - x[big]) / np.abs(x[big])) < 0.03


def test_mulaw_encode_lut_view_mapping():
    """The hot encode gathers a pre-ROLLED LUT with the uint16 VIEW of the
    int16 wire (no int32 temp, no +32768 pass) — pin it against the direct
    per-value formula over the ENTIRE int16 range, including a
    non-contiguous input view."""
    import numpy as np

    from audio_matcher_tpu.models.matcher import _MU, quantize_wire

    wire = np.arange(-32768, 32768, dtype=np.int16)
    w = wire.astype(np.float64) / 32768.0
    f = np.sign(w) * np.log1p(_MU * np.abs(w)) / np.log1p(_MU)
    want = np.clip(np.round((f + 1.0) * 127.5), 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(quantize_wire(wire, "mulaw8"), want)
    np.testing.assert_array_equal(
        quantize_wire(wire[::3], "mulaw8"), want[::3]
    )


def test_stage_tail_is_wire_silence():
    """stage()/stage_batch() allocate UNINITIALIZED mulaw8 buffers and
    fill pad tails themselves — every padded element beyond the data must
    be the mu-law silence code (a stray value would correlate)."""
    import numpy as np

    from audio_matcher_tpu.models.matcher import _joined, wire_silence

    snippet = (np.linspace(-0.2, 0.2, SR // 2)).astype(np.float32)
    cfg = MatchConfig(
        chunk_secs=10, distance_secs=30, slab=4, transfer_dtype="mulaw8"
    )
    m = SnippetMatcher(snippet, SR, cfg)
    n = int(12.3 * SR)  # not a chunk multiple: real pad tail
    ep = (np.ones(n) * 0.1).astype(np.float32)
    staged, n_got = m.stage(ep)
    flat = np.asarray(_joined(staged))
    assert n_got == n and len(flat) > n
    assert (flat[n:] == wire_silence("mulaw8")).all()

    handle, ns = m.stage_batch([ep, ep[: n // 2]])
    rows = np.asarray(_joined(handle, rows=2))
    for i, n_i in enumerate(ns):
        assert (rows[i, n_i:] == wire_silence("mulaw8")).all()


def test_batch_scan_int16(fixture):
    snippet, episodes, offsets = fixture
    cfg = MatchConfig(
        chunk_secs=10, distance_secs=30, slab=4, transfer_dtype="int16"
    )
    matcher = SnippetMatcher(snippet, SR, cfg)
    batch = matcher.match_staged_batch(matcher.stage_batch(episodes))
    for got, offs in zip(batch, offsets):
        assert [p.position for p in got] == [int(o * SR) for o in offs]


def test_mulaw_device_decode_matches_table():
    """The arithmetic on-device μ-law expansion (no LUT gather) agrees
    with the f64-derived decode table within f32 rounding."""
    import jax.numpy as jnp
    import numpy as np

    from audio_matcher_tpu.models.matcher import (
        _ulaw_tables, dequantize_on_device,
    )

    _, dec = _ulaw_tables()
    codes = np.arange(256, dtype=np.uint8)
    got = np.asarray(dequantize_on_device(jnp.asarray(codes)))
    # f32 expm1 vs the f64 table: ≲1.6e-5 relative (μ-law's own step is
    # ~2.2% — five hundred times coarser)
    np.testing.assert_allclose(got, dec, rtol=2e-5, atol=5e-7)


def test_pick_slab_rules():
    from audio_matcher_tpu.models.matcher import _divisor_slab, pick_slab

    # short episodes keep the preferred slab (shared compiled shapes)
    for n in range(1, 9):
        assert pick_slab(n, 8) == 8
    # waste within 25% keeps the preferred slab
    assert pick_slab(30, 8) == 8  # pad 32, 6.7%
    assert pick_slab(20, 8) == 8  # pad 24, 20%
    # beyond 25% waste: minimal padded count, ties -> larger slab
    assert pick_slab(10, 8) == 5  # pad 10 not 16 (60% waste)
    assert pick_slab(9, 8) == 5  # pad 10
    assert pick_slab(11, 8) == 6  # pad 12 (ties 4 -> larger)
    assert pick_slab(13, 8) == 8  # pad 16: waste 3/13 = 23% <= 25%
    assert pick_slab(25, 8) == 5  # pad 25 not 32
    # explicit small slabs never adapt (test configs pin 2/3/4)
    for n in (5, 10, 37):
        assert pick_slab(n, 4) == 4
    # every pick stays in the kernel-supported range and never pads
    # worse than the preferred slab would
    for n in range(1, 200):
        s = pick_slab(n, 8)
        assert 4 <= s <= 8
        assert -(-n // s) * s <= -(-n // 8) * 8
        if s != 8:  # adapting must beat the 25%-waste bound it fled
            assert (-(-n // s) * s - n) <= 0.25 * n or n < 8
    assert _divisor_slab(10, 8) == 5
    assert _divisor_slab(32, 8) == 8
    assert _divisor_slab(21, 8) == 7
    assert _divisor_slab(13, 8) == 1


def test_auto_slab_matches_pinned(fixture):
    """slab_auto shrinks the staged buffer of a pad-heavy shape (10
    windows at preferred slab 8 -> slab 5) and returns identical peaks
    through both the matcher and the batch-scanner paths."""
    snippet, episodes, offsets = fixture
    # 50 s episodes at 5 s chunks = 10 windows: the config-#3 pad case
    auto = MatchConfig(chunk_secs=5, distance_secs=30, slab=8)
    pinned = MatchConfig(
        chunk_secs=5, distance_secs=30, slab=8, slab_auto=False
    )
    m_auto = SnippetMatcher(snippet, SR, auto)
    m_pin = SnippetMatcher(snippet, SR, pinned)
    staged_auto = m_auto.stage(episodes[1])
    staged_pin = m_pin.stage(episodes[1])
    assert staged_auto[0].shape[0] < staged_pin[0].shape[0]
    got = m_auto.match_staged(staged_auto)
    want = m_pin.match_staged(staged_pin)
    assert [p.position for p in got] == [p.position for p in want]
    for a, b in zip(got, want):
        assert a.height == pytest.approx(b.height, abs=1e-5)

    from audio_matcher_tpu.parallel.mesh import make_mesh
    from audio_matcher_tpu.parallel.sweep import ShardedScanner

    s_auto = ShardedScanner([snippet], SR, auto, mesh=make_mesh(1))
    s_pin = ShardedScanner([snippet], SR, pinned, mesh=make_mesh(1))
    st_a = s_auto.stage_resident(episodes)
    st_p = s_pin.stage_resident(episodes)
    assert st_a[0].shape[1] < st_p[0].shape[1]
    res_a = s_auto.scan_staged(st_a)
    res_p = s_pin.scan_staged(st_p)
    for per_a, per_p, offs in zip(res_a, res_p, offsets):
        assert [p.position for p in per_a[0]] == [
            p.position for p in per_p[0]
        ]
        assert [p.position for p in per_a[0]] == [int(o * SR) for o in offs]


def test_split_put_single_episode_matches(fixture, monkeypatch):
    """Episodes over AUDIO_MATCHER_PUT_BYTES stage as several
    device_puts re-joined by one on-device concat — identical peaks
    through stage/match_staged and stage_batch/match_staged_batch."""
    snippet, episodes, offsets = fixture
    cfg = MatchConfig(chunk_secs=10, distance_secs=30, slab=4)
    m = SnippetMatcher(snippet, SR, cfg)
    want = [m.match(ep) for ep in episodes]
    monkeypatch.setenv("AUDIO_MATCHER_PUT_BYTES", str(SR * 4 * 11))
    staged = m.stage(episodes[1])
    assert isinstance(staged[0], tuple) and len(staged[0]) > 1
    got = m.match_staged(staged)
    assert [(p.position, p.height) for p in got] == [
        (p.position, p.height) for p in want[1]
    ]
    staged_b = m.stage_batch(episodes)
    assert isinstance(staged_b[0], tuple)
    batch = m.match_staged_batch(staged_b)
    for got_ep, want_ep in zip(batch, want):
        assert [p.position for p in got_ep] == [
            p.position for p in want_ep
        ]


def test_mulaw_pad_is_silence():
    """Wire padding encodes SILENCE per dtype: mu-law code 0 decodes to
    ~-0.5 full scale, so uint8 pads with code 128 (ADVICE r2 #2)."""
    import jax.numpy as jnp

    from audio_matcher_tpu.models.matcher import (
        dequantize_on_device,
        pad_wire_on_device,
        wire_buffer,
        wire_silence,
    )

    assert wire_silence("mulaw8") == 128
    assert wire_silence("int16") == 0
    buf = wire_buffer(16, "mulaw8")
    assert buf.dtype == np.uint8 and (buf == 128).all()
    padded = pad_wire_on_device(jnp.full(4, 7, jnp.uint8), 12)
    assert np.asarray(padded[4:] == 128).all()
    dec = np.asarray(dequantize_on_device(padded))
    assert np.max(np.abs(dec[4:])) < 1e-4  # pad region is near-silent
    # int16/float32 pads stay zero
    p16 = pad_wire_on_device(jnp.full(4, 7, jnp.int16), 12)
    assert np.asarray(p16[4:] == 0).all()
