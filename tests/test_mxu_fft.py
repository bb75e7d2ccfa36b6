"""Matmul-FFT oracle tests vs numpy (CPU; the precision carries to the GPU
because HIGHEST-precision matmuls are f32-equivalent on both backends —
no TF32)."""

import numpy as np
import pytest

from audio_matcher_tpu.ops.mxu_fft import cfft, default_factors


@pytest.mark.parametrize("n", [256, 1024, 4096, 1 << 14, 1 << 18])
def test_cfft_matches_numpy(rng, n):
    x = (
        rng.standard_normal((3, n)) + 1j * rng.standard_normal((3, n))
    ).astype(np.complex64)
    got = np.asarray(cfft(x))
    want = np.fft.fft(x)
    scale = np.max(np.abs(want))
    assert np.max(np.abs(got - want)) / scale < 2e-6


@pytest.mark.parametrize("n", [1024, 1 << 16])
def test_icfft_matches_numpy(rng, n):
    x = (
        rng.standard_normal((2, n)) + 1j * rng.standard_normal((2, n))
    ).astype(np.complex64)
    got = np.asarray(cfft(x, inverse=True))
    want = np.fft.ifft(x)
    scale = np.max(np.abs(want))
    assert np.max(np.abs(got - want)) / scale < 2e-6


def test_default_factors():
    assert default_factors(1 << 22) == (256, 128, 128)
    assert np.prod(default_factors(1 << 23)) == 1 << 23
    with pytest.raises(ValueError):
        default_factors(1000)


def test_corr_slab_mxu_matches_numpy(rng):
    """The scan-shaped helper: [B, Q, valid] correlations equal the
    numpy rfft/irfft oracle for odd/even B·Q combinations."""
    from audio_matcher_tpu.ops.mxu_fft import corr_slab_mxu, scrambled_spectra_parts

    n = 1 << 13
    for B, Q in [(4, 3), (3, 2), (2, 1)]:
        W, m = 6000, 500
        valid = W - m + 1
        wins = rng.standard_normal((B, W)).astype(np.float32)
        snips = rng.standard_normal((Q, m)).astype(np.float32)
        Sr, Si = scrambled_spectra_parts(snips, n)
        got = np.asarray(corr_slab_mxu(wins, Sr, Si, valid))
        for b in range(B):
            for q in range(Q):
                want = np.fft.irfft(
                    np.fft.rfft(wins[b], n) * np.conj(np.fft.rfft(snips[q], n)),
                    n,
                )[:valid]
                scale = np.max(np.abs(want)) + 1e-9
                err = np.max(np.abs(got[b, q] - want)) / scale
                assert err < 5e-6, (B, Q, b, q, err)


def test_matcher_peaks_identical_across_fft_impls(rng):
    """Full matcher pipeline: fft_impl='mxu' finds the same peaks at the
    same positions with scores within the reference tolerance (1.2e-5)."""
    from audio_matcher_tpu.models.matcher import MatchConfig, SnippetMatcher

    SR = 8000
    snippet = (rng.standard_normal(2 * SR) * 0.2).astype(np.float32)
    episode = (rng.standard_normal(45 * SR) * 0.05).astype(np.float32)
    for off in (7, 30):
        episode[off * SR : off * SR + len(snippet)] = snippet

    base = dict(chunk_secs=10, distance_secs=15, slab=4)
    got = {}
    for impl in ("xla", "mxu"):
        m = SnippetMatcher(snippet, SR, MatchConfig(fft_impl=impl, **base))
        got[impl] = m.match(episode)
    assert [p.position for p in got["mxu"]] == [
        p.position for p in got["xla"]
    ] == [7 * SR, 30 * SR]
    for a, b in zip(got["xla"], got["mxu"]):
        assert abs(a.height - b.height) < 1.2e-5
        assert abs(a.prominence - b.prominence) < 1.2e-5


def test_sharded_scanner_multi_query_mxu(rng):
    """Multi-query resident scan with the MXU FFT on the 8-device mesh."""
    from audio_matcher_tpu.models.matcher import MatchConfig
    from audio_matcher_tpu.parallel.mesh import make_mesh
    from audio_matcher_tpu.parallel.sweep import ShardedScanner

    SR = 1000
    snippets = [
        (rng.standard_normal(SR // 2) * 0.2).astype(np.float32),
        (rng.standard_normal(SR // 4) * 0.2).astype(np.float32),
    ]
    episodes = []
    for e in range(4):
        ep = (rng.standard_normal(SR * 6) * 0.05).astype(np.float32)
        ep[(e + 1) * SR : (e + 1) * SR + len(snippets[0])] = snippets[0]
        episodes.append(ep)

    cfg_m = MatchConfig(chunk_secs=1.0, distance_secs=2.0, block=256,
                        fft_impl="mxu")
    cfg_x = MatchConfig(chunk_secs=1.0, distance_secs=2.0, block=256)
    mesh = make_mesh(8)
    got_m = ShardedScanner(snippets, SR, cfg_m, mesh).scan_resident(episodes)
    got_x = ShardedScanner(snippets, SR, cfg_x, mesh).scan_resident(episodes)
    for e in range(4):
        for q in range(2):
            pm = [(p.position, round(p.height, 4)) for p in got_m[e][q]]
            px = [(p.position, round(p.height, 4)) for p in got_x[e][q]]
            assert pm == px, (e, q)
        assert any(p.position == (e + 1) * SR for p in got_m[e][0])


def test_xla_packed_impl_equality(rng):
    """fft_impl='xla_packed' (two correlations per inverse FFT) matches
    'xla' exactly enough for identical peaks, single- and multi-query."""
    from audio_matcher_tpu.models.matcher import MatchConfig, SnippetMatcher
    from audio_matcher_tpu.parallel.mesh import make_mesh
    from audio_matcher_tpu.parallel.sweep import ShardedScanner

    SR = 1000
    snippet = (rng.standard_normal(SR // 2) * 0.2).astype(np.float32)
    episode = (rng.standard_normal(8 * SR) * 0.05).astype(np.float32)
    episode[3 * SR : 3 * SR + len(snippet)] = snippet
    base = dict(chunk_secs=1.0, distance_secs=2.0, slab=4, block=256)
    got = {}
    for impl in ("xla", "xla_packed"):
        m = SnippetMatcher(snippet, SR, MatchConfig(fft_impl=impl, **base))
        got[impl] = [(p.position, round(p.height, 5)) for p in m.match(episode)]
    assert got["xla_packed"] == got["xla"]
    assert got["xla"][0][0] == 3 * SR

    # multi-query (odd Q exercises the pad-query slice)
    snippets = [snippet, (rng.standard_normal(SR // 4) * 0.2).astype(np.float32),
                (rng.standard_normal(SR // 3) * 0.2).astype(np.float32)]
    eps = [episode, episode]
    outs = {}
    for impl in ("xla", "xla_packed"):
        cfg = MatchConfig(fft_impl=impl, **base)
        sc = ShardedScanner(snippets, SR, cfg, make_mesh(1))
        outs[impl] = [
            [[(p.position, round(p.height, 5)) for p in pk] for pk in per_q]
            for per_q in sc.scan_resident(eps)
        ]
    assert outs["xla_packed"] == outs["xla"]
