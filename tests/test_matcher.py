"""End-to-end snippet-matching tests on synthetic audio.

Mirrors the reference's ``short_calc_peaks`` end-to-end test
(audio_matcher.rs:528-577: known snippet found at fixed offsets) but on
generated fixtures, since the reference's res/local assets are private
(SURVEY.md §4 fixture tiers).
"""

import numpy as np
import pytest

from audio_matcher_tpu.models import MatchConfig, SnippetMatcher, calc_chunks
from audio_matcher_tpu.models.matcher import overshadow_filter
from audio_matcher_tpu.ops.peaks import Peak

SR = 8000


def make_episode(rng, secs, snippet, offsets_secs, gains=None):
    episode = (rng.standard_normal(int(secs * SR)) * 0.05).astype(np.float32)
    gains = gains or [1.0] * len(offsets_secs)
    for off, g in zip(offsets_secs, gains):
        i = int(off * SR)
        episode[i : i + len(snippet)] = g * snippet
    return episode


@pytest.fixture
def snippet(rng):
    # band-limited noise snippet, 4 s
    x = rng.standard_normal(4 * SR)
    k = np.hanning(9)
    return np.convolve(x, k / k.sum(), mode="same").astype(np.float32) * 0.2


def test_finds_embedded_snippet_exact_offsets(rng, snippet):
    episode = make_episode(rng, 130, snippet, [21, 100])
    cfg = MatchConfig(chunk_secs=10, distance_secs=30, slab=4)
    peaks = calc_chunks(SR, episode, snippet, scale=True, config=cfg)
    assert [p.position for p in peaks] == [21 * SR, 100 * SR]
    for p in peaks:
        assert p.height == pytest.approx(1.0, abs=0.05)
        assert p.prominence > cfg.min_prominence
    # 21 s is chunk-interior → full prominence; 100 s sits exactly on a hop
    # boundary, where window-local prominence is edge-squashed (preserved
    # reference behavior, SURVEY.md §7 hard part (a))
    assert peaks[0].prominence > 0.5


def test_overlap_region_peak_found_once(rng, snippet):
    # place the match right at a chunk boundary (chunk=10 s → boundary 30 s)
    episode = make_episode(rng, 70, snippet, [29.5])
    cfg = MatchConfig(chunk_secs=10, distance_secs=30, slab=4)
    peaks = calc_chunks(SR, episode, snippet, scale=True, config=cfg)
    assert len(peaks) == 1
    assert peaks[0].position == int(29.5 * SR)


def test_tail_window_shorter_than_chunk(rng, snippet):
    # episode length not a multiple of chunk; match sits in the short tail
    episode = make_episode(rng, 47.3, snippet, [41])
    cfg = MatchConfig(chunk_secs=10, distance_secs=30, slab=4)
    peaks = calc_chunks(SR, episode, snippet, scale=True, config=cfg)
    assert [p.position for p in peaks] == [41 * SR]


def test_n_samples_resize_truncates(rng, snippet):
    episode = make_episode(rng, 60, snippet, [10, 50])
    cfg = MatchConfig(chunk_secs=10, distance_secs=30, slab=4)
    peaks = calc_chunks(
        SR, episode, snippet, config=cfg, n_samples=int(30 * SR)
    )
    # the 50 s match lies beyond the resized stream
    assert [p.position for p in peaks] == [10 * SR]


def test_quieter_copy_overshadowed_within_distance(rng, snippet):
    # two copies 20 s apart with distance 30 s: the louder one wins
    episode = make_episode(rng, 60, snippet, [15, 35], gains=[1.0, 0.4])
    cfg = MatchConfig(chunk_secs=10, distance_secs=30, slab=4)
    peaks = calc_chunks(SR, episode, snippet, config=cfg)
    assert [p.position for p in peaks] == [15 * SR]


def test_both_kept_beyond_distance(rng, snippet):
    episode = make_episode(rng, 90, snippet, [15, 70], gains=[1.0, 0.4])
    cfg = MatchConfig(chunk_secs=10, distance_secs=30, slab=4)
    peaks = calc_chunks(SR, episode, snippet, config=cfg)
    assert [p.position for p in peaks] == [15 * SR, 70 * SR]


def test_overshadow_filter_semantics():
    # parity: the reference's overshadow unit tests (audio_matcher.rs:187-218)
    p_low = Peak(position=1, height=0.7, prominence=0.2)
    p_big = Peak(position=3, height=1.0, prominence=1.0)
    p_mid = Peak(position=5, height=0.8, prominence=0.3)
    sr = 1
    # distance 3 s: both neighbours die; distance 2 s: all survive
    assert overshadow_filter([p_low, p_big, p_mid], sr, 3.0) == [p_big]
    assert overshadow_filter([p_low, p_big, p_mid], sr, 2.0) == [
        p_low, p_big, p_mid,
    ]
    # nothing overshadows the most prominent peak
    assert p_big in overshadow_filter([p_low, p_big, p_mid], sr, 6.0)
    # equal prominence does NOT overshadow (strict comparison)
    q1 = Peak(position=1, height=0.5, prominence=0.5)
    q2 = Peak(position=2, height=0.5, prominence=0.5)
    assert overshadow_filter([q1, q2], sr, 6.0) == [q1, q2]


def test_sample_exact_positions_random_offsets(rng, snippet):
    """Positions are sample-exact for arbitrary (non-aligned) insertion
    points — the BASELINE north-star accuracy requirement."""
    n = int(90 * SR)
    offsets = sorted(
        rng.choice(
            np.arange(SR, n - len(snippet) - SR), size=2, replace=False
        ).tolist()
    )
    if offsets[1] - offsets[0] < 35 * SR:  # keep beyond the dedup distance
        offsets[1] = offsets[0] + 35 * SR
    episode = (rng.standard_normal(n) * 0.05).astype(np.float32)
    for i in offsets:
        episode[i : i + len(snippet)] = snippet
    cfg = MatchConfig(chunk_secs=10, distance_secs=30, slab=4)
    peaks = calc_chunks(SR, episode, snippet, config=cfg)
    assert [p.position for p in peaks] == offsets  # exact, no tolerance


def test_unscaled_raw_prominence(rng, snippet):
    """scale=False with an absolute prominence threshold — the reference's
    direct PeakConfig mode (its ignored end-to-end test uses prominence 15
    on raw correlation values, audio_matcher.rs:560-570)."""
    episode = make_episode(rng, 60, snippet, [25])
    raw_ac = float(np.sum(snippet.astype(np.float64) ** 2))
    cfg = MatchConfig(
        chunk_secs=10, distance_secs=30, slab=4,
        prominence=0.5 * raw_ac, prominence_is_raw=True,
    )
    peaks = calc_chunks(SR, episode, snippet, scale=False, config=cfg)
    assert [p.position for p in peaks] == [25 * SR]
    assert peaks[0].height == pytest.approx(raw_ac, rel=0.05)


def test_matcher_object_reusable_across_episodes(rng, snippet):
    cfg = MatchConfig(chunk_secs=10, distance_secs=30, slab=4)
    matcher = SnippetMatcher(snippet, SR, cfg)
    for offs in ([7], [13, 44]):
        episode = make_episode(rng, 60, snippet, offs)
        got = [p.position for p in matcher.match(episode)]
        assert got == [int(o * SR) for o in offs]


def test_tiny_overlap_shorter_than_snippet_still_finds_match(rng, snippet):
    """Regression (ADVICE r1): an explicit overlap_secs making
    chunk+overlap < snippet length used to stage too little padding and
    produce a 1-sample valid range that could never emit a peak; the
    overlap is now raised to the snippet length (with a warning) so a
    perfect embedded match is found."""
    episode = make_episode(rng, 30, snippet, [9])
    cfg = MatchConfig(
        chunk_secs=1.0, overlap_secs=0.25, distance_secs=5, slab=4
    )
    matcher = SnippetMatcher(snippet, SR, cfg)
    assert matcher.window - matcher.chunk == matcher.overlap
    assert matcher.window >= matcher.chunk + len(snippet)
    peaks = matcher.match(episode)
    assert [p.position for p in peaks] == [9 * SR]


def test_small_but_valid_overlap_keeps_user_semantics(rng, snippet):
    """An explicit overlap >= snippet-length deficit is honored as-is:
    chunk+overlap >= snippet means matches away from hop boundaries are
    still found with the user's (smaller) window."""
    episode = make_episode(rng, 40, snippet, [11])
    cfg = MatchConfig(
        chunk_secs=10.0, overlap_secs=5.0, distance_secs=8, slab=2
    )
    matcher = SnippetMatcher(snippet, SR, cfg)
    assert matcher.overlap == int(5.0 * SR) + 2  # not raised
    peaks = matcher.match(episode)
    assert [p.position for p in peaks] == [11 * SR]


def test_windows_from_episode_matches_naive(rng):
    """The static-slice window builder equals per-window dynamic slices
    for 1-, 2- and 3-chunk-row windows (overlap <, ≈, > chunk)."""
    import jax
    import jax.numpy as jnp

    from audio_matcher_tpu.models.matcher import (
        window_rows, windows_from_episode,
    )

    chunk = 64
    for window in (64, 100, 128, 150, 190):
        k = window_rows(window, chunk)
        slab = 3
        n = (slab * 2 + k) * chunk
        ep = jnp.asarray(rng.standard_normal(n).astype(np.float32))
        for base in (0, slab):
            got = np.asarray(
                windows_from_episode(ep, jnp.int32(base), slab, chunk, window)
            )
            want = np.stack([
                np.asarray(ep)[(base + i) * chunk:(base + i) * chunk + window]
                for i in range(slab)
            ])
            np.testing.assert_array_equal(got, want, err_msg=str(window))


def test_live_progress_groupwise_dispatch(rng, snippet):
    """Live progress (VERDICT r2 weak #1): with a callback present the
    scan dispatches per slab group — starts and finishes INTERLEAVE (the
    bar moves), and results are identical to the single-dispatch path."""
    cfg = MatchConfig(
        chunk_secs=5, distance_secs=30, slab=2,
        progress_slabs_per_dispatch=1,
    )
    episode = (rng.standard_normal(60 * SR) * 0.03).astype(np.float32)
    for off in (7.0, 45.0):
        i = int(off * SR)
        episode[i : i + len(snippet)] = snippet
    m = SnippetMatcher(snippet, SR, cfg)
    silent = m.match(episode)

    events: list[tuple[str, int]] = []
    live = m.match(episode, progress=lambda ph, k: events.append((ph, k)))
    assert [(p.position, p.height) for p in live] == [
        (p.position, p.height) for p in silent
    ]
    n_windows = -(-60 * SR // m.chunk)
    starts = [k for ph, k in events if ph == "start"]
    finishes = [k for ph, k in events if ph == "finish"]
    assert starts == list(range(n_windows))
    assert sorted(finishes) == list(range(n_windows))
    # honest liveness: some window must FINISH before the last one STARTS
    first_finish = events.index(("finish", 0))
    last_start = max(
        i for i, ev in enumerate(events) if ev[0] == "start"
    )
    assert first_finish < last_start, "bar would jump 0->100%"


def test_live_progress_with_adaptive_slab(rng, snippet):
    """Adaptive slab (pick_slab: 10 windows at preferred 8 → slab 5)
    composed with live groupwise dispatch: same peaks as the silent
    adaptive scan AND as a pinned-slab scan."""
    from audio_matcher_tpu.models.matcher import pick_slab

    auto = MatchConfig(
        chunk_secs=5, distance_secs=30, slab=8,
        progress_slabs_per_dispatch=1,
    )
    pinned = MatchConfig(
        chunk_secs=5, distance_secs=30, slab=8, slab_auto=False
    )
    episode = (rng.standard_normal(50 * SR) * 0.03).astype(np.float32)
    for off in (7.0, 41.0):
        i = int(off * SR)
        episode[i : i + len(snippet)] = snippet
    assert pick_slab(10, 8) == 5  # the shape under test
    m = SnippetMatcher(snippet, SR, auto)
    silent = m.match(episode)
    events: list[tuple[str, int]] = []
    live = m.match(episode, progress=lambda ph, k: events.append((ph, k)))
    ref = SnippetMatcher(snippet, SR, pinned).match(episode)
    assert [(p.position, p.height) for p in live] == [
        (p.position, p.height) for p in silent
    ]
    assert [p.position for p in live] == [p.position for p in ref]
    assert [p.position for p in live] == [int(o * SR) for o in (7.0, 41.0)]
    # both phases fired for every real window, interleaved (2 slab
    # groups of 5 windows → first finish before the last start)
    starts = [k for ph, k in events if ph == "start"]
    assert starts == list(range(10))
    first_finish = events.index(("finish", 0))
    last_start = max(i for i, ev in enumerate(events) if ev[0] == "start")
    assert first_finish < last_start


def test_live_progress_odd_group_remainder(rng, snippet):
    """Group size that doesn't divide the slab count: the remainder group
    compiles once and results stay identical."""
    base = MatchConfig(chunk_secs=5, distance_secs=30, slab=2)
    cfg = MatchConfig(
        chunk_secs=5, distance_secs=30, slab=2,
        progress_slabs_per_dispatch=2,
    )
    episode = (rng.standard_normal(57 * SR) * 0.03).astype(np.float32)
    i = int(31.0 * SR)
    episode[i : i + len(snippet)] = snippet
    silent = SnippetMatcher(snippet, SR, base).match(episode)
    live = SnippetMatcher(snippet, SR, cfg).match(
        episode, progress=lambda *a: None
    )
    assert [(p.position, p.height) for p in live] == [
        (p.position, p.height) for p in silent
    ]


def test_no_duplicate_peak_on_window_seam(rng):
    """Review r3 (execution-confirmed): the +2 overlap safety margin puts
    the seam sample inside BOTH adjacent windows' emittable interiors
    with bit-identical prominences — the strictly-greater overshadow rule
    kept both copies. Exact-position duplicates must collapse."""
    sr = 100
    snippet = np.full(10, 0.25, np.float32)
    episode = (rng.standard_normal(3 * sr) * 0.01).astype(np.float32)
    chunk = int(0.5 * sr)
    at = chunk + 1  # the one lag inside both windows' interiors
    episode[at : at + len(snippet)] = snippet
    m = SnippetMatcher(
        snippet, sr,
        # low threshold: the seam-cut triangle's window-local prominence
        # is ~0.10
        MatchConfig(chunk_secs=0.5, distance_secs=0.3, prominence=1.0),
    )
    peaks = m.match(episode)
    positions = [p.position for p in peaks]
    assert len(positions) == len(set(positions)), positions
    assert positions.count(at) == 1


def test_overshadow_filter_collapses_exact_duplicates():
    dup = [Peak(100, 1.0, 0.5), Peak(100, 1.0, 0.5), Peak(400, 1.0, 0.9)]
    out = overshadow_filter(dup, sr=100, distance_secs=1.0)
    assert [p.position for p in out] == [100, 400]


def test_overshadow_filter_fuzz_vs_bruteforce(rng):
    """Property fuzz: overshadow_filter == an independently-written
    brute-force of the reference rule (audio_matcher.rs:136-160: drop a
    peak iff an immediate position-order neighbour within `distance` is
    strictly more prominent), after exact-position dedup."""

    def spec(peaks, sr, distance_secs):
        best = {}
        for p in peaks:
            if p.position not in best or p.prominence > best[p.position].prominence:
                best[p.position] = p
        ordered = sorted(best.values(), key=lambda p: p.position)
        out = []
        for i, p in enumerate(ordered):
            neigh = [
                ordered[j]
                for j in (i - 1, i + 1)
                if 0 <= j < len(ordered)
            ]
            if not any(
                abs(p.position - q.position) / sr < distance_secs
                and q.prominence > p.prominence
                for q in neigh
            ):
                out.append(p)
        return [(p.position, p.prominence) for p in out]

    from audio_matcher_tpu.models.matcher import overshadow_filter

    for trial in range(200):
        n = int(rng.integers(0, 12))
        peaks = [
            Peak(
                int(rng.integers(0, 40)),
                float(rng.integers(1, 5)),
                float(rng.integers(0, 4)) / 2.0,  # frequent exact ties
            )
            for _ in range(n)
        ]
        dist = float(rng.integers(1, 10))
        got = [
            (p.position, p.prominence)
            for p in overshadow_filter(peaks, sr=10, distance_secs=dist)
        ]
        assert got == spec(peaks, 10, dist), (trial, peaks, dist)
