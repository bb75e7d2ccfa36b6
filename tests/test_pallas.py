"""Triton-route Pallas kernel tests: interpret mode on the CPU, compiled
on a GPU (``impls.pallas_interpret`` decides, inside the fixture)."""

import jax.numpy as jnp
import numpy as np
import pytest

from audio_matcher_tpu.ops.pallas_kernels import (
    SPAN,
    local_max_block_reduce,
    segment_width,
)


@pytest.fixture
def interpret():
    from audio_matcher_tpu.ops.impls import pallas_interpret

    return pallas_interpret()


def block_reduce_reference(x, valid_len, block):
    """numpy reference of the kernel's contract: per tile, the best strict
    interior local maximum (first index on ties) and the masked extrema."""
    B, V = x.shape
    nb = V // block
    out = [np.empty((B, nb), np.float32), np.empty((B, nb), np.int32),
           np.empty((B, nb), np.float32), np.empty((B, nb), np.float32)]
    cols = np.arange(V)
    for b in range(B):
        vl = int(valid_len[b])
        left = np.concatenate([[-np.inf], x[b, :-1]])
        right = np.concatenate([x[b, 1:], [-np.inf]])
        pk = (x[b] > left) & (x[b] > right) & (cols >= 1) & (cols <= vl - 2)
        h = np.where(pk, x[b], -np.inf).reshape(nb, block)
        out[0][b] = h.max(1)
        out[1][b] = np.argmax(h, 1) + np.arange(nb) * block
        out[2][b] = np.where(cols < vl, x[b], np.inf).reshape(nb, block).min(1)
        out[3][b] = np.where(cols < vl, x[b], -np.inf).reshape(nb, block).max(1)
    return out


def test_block_reduce_finds_interior_peaks(rng, interpret):
    B, V, block = 2, 4096, 512
    x = rng.standard_normal((B, V)).astype(np.float32) * 0.1
    x[0, 700] = 5.0  # interior of tile 1
    x[1, 2000] = 3.0  # interior of tile 3
    valid = np.array([V, 3000], np.int32)
    bv, bp, bmin, bmax = local_max_block_reduce(
        jnp.asarray(x), jnp.asarray(valid), block=block, interpret=interpret
    )
    bv, bp = np.asarray(bv), np.asarray(bp)
    assert bp[0, 700 // block] == 700
    assert bv[0, 700 // block] == pytest.approx(5.0)
    assert bp[1, 2000 // block] == 2000
    # min/max pyramids respect the valid mask
    bmin, bmax = np.asarray(bmin), np.asarray(bmax)
    assert bmax[1, -1] == -np.inf  # fully beyond valid_len
    np.testing.assert_allclose(bmax[0, 0], x[0, :block].max(), atol=1e-6)
    np.testing.assert_allclose(bmin[0, 0], x[0, :block].min(), atol=1e-6)


def test_block_reduce_seam_contract(rng, interpret):
    """Seam contract: neighbours are loaded at offset columns, so a peak
    on ANY tile edge — inside a program's segment or on the boundary
    between two programs' segments — is found by the kernel itself; no
    caller-side seam repair exists or is needed."""
    block = 256
    V = 2 * SPAN
    x = (np.random.default_rng(3).standard_normal((2, V)) * 0.01).astype(
        np.float32
    )
    # row 0: first/last columns of in-segment tiles and the last column
    # of the first segment; row 1: the first column of the second segment
    edges = {0: [block, 3 * block - 1, SPAN - 1], 1: [SPAN, SPAN + block]}
    for r, cs in edges.items():
        for j, c in enumerate(cs):
            x[r, c] = 5.0 + j
    bv, bp, _, _ = local_max_block_reduce(
        jnp.asarray(x), jnp.asarray([V, V], np.int32), block=block,
        interpret=interpret,
    )
    bv, bp = np.asarray(bv), np.asarray(bp)
    for r, cs in edges.items():
        for j, c in enumerate(cs):
            assert bp[r, c // block] == c, (r, c, bp[r, c // block])
            assert bv[r, c // block] == pytest.approx(5.0 + j)


@pytest.mark.parametrize("rows", [1, 3])
@pytest.mark.parametrize("block", [64, 256, 1024, 8192])
def test_block_reduce_matches_reference(rng, interpret, block, rows):
    """Exact block arrays against the numpy reference across tile sizes
    (tiles smaller than, equal to and larger than a program's segment),
    row counts, and ragged valid lengths — including a V that is not a
    whole number of segments, which the wrapper pads and crops."""
    V = max(block * 3, SPAN + block)  # ragged: not a segment multiple
    V -= V % block
    x = rng.standard_normal((rows, V)).astype(np.float32)
    valid = rng.integers(3, V + 1, size=rows).astype(np.int32)
    valid[0] = V
    got = local_max_block_reduce(
        jnp.asarray(x), jnp.asarray(valid), block=block, interpret=interpret
    )
    want = block_reduce_reference(x, valid, block)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), w)


@pytest.mark.parametrize("block,width", [(64, SPAN), (512, SPAN),
                                         (SPAN, SPAN), (8192, 8192)])
def test_segment_width(block, width):
    assert segment_width(block) == width


@pytest.mark.parametrize("block", [0, 100, 3 * 256])
def test_segment_width_rejects_non_power_of_two(block):
    with pytest.raises(ValueError, match="power of two"):
        segment_width(block)


class TestPickPeaksPallas:
    """pick_peaks_pallas must reproduce pick_peaks_core exactly (one
    device-memory pass + cumulative-exclusion rescan)."""

    @pytest.fixture(autouse=True)
    def _interpret(self, interpret):
        self.interpret = interpret

    def _compare(self, x, valid, distance, n_peaks, block):
        from audio_matcher_tpu.ops.peaks import (
            pick_peaks_core,
            pick_peaks_pallas,
        )

        want = pick_peaks_core(
            jnp.asarray(x), jnp.asarray(valid), distance, n_peaks, block
        )
        got = pick_peaks_pallas(
            jnp.asarray(x), jnp.asarray(valid), distance, n_peaks, block,
            interpret=self.interpret,
        )
        wpos, wh, wprom = (np.asarray(v) for v in want)
        gpos, gh, gprom = (np.asarray(v) for v in got)
        live = np.isfinite(wh)
        assert (np.isfinite(gh) == live).all()
        assert (gpos[live] == wpos[live]).all(), (gpos, wpos)
        np.testing.assert_allclose(gh[live], wh[live], rtol=1e-6)
        np.testing.assert_allclose(gprom[live], wprom[live], rtol=1e-6,
                                   atol=1e-6)

    def test_random_rows(self, rng):
        B, V, block = 3, 4096, 256
        x = rng.standard_normal((B, V)).astype(np.float32)
        valid = np.asarray([V, V - 300, 900], np.int32)
        self._compare(x, valid, distance=500, n_peaks=4, block=block)

    def test_seam_peaks(self, rng):
        """Peaks planted exactly on tile boundaries."""
        B, V, block = 2, 2048, 256
        x = (rng.standard_normal((B, V)) * 0.01).astype(np.float32)
        for j in (1, 3, 5):
            x[0, j * block] = 5.0 + j  # first col of tile j
            x[1, j * block - 1] = 5.0 + j  # last col of tile j-1
        valid = np.full(B, V, np.int32)
        self._compare(x, valid, distance=10, n_peaks=6, block=block)

    def test_suppression_cuts_mid_tile(self, rng):
        """The 2nd-best peak inside a partially-suppressed tile must be
        found (the rescan path), across several rounds."""
        B, V, block = 1, 4096, 512
        x = (rng.standard_normal((B, V)) * 0.01).astype(np.float32)
        x[0, 1000] = 10.0
        x[0, 1100] = 9.0  # within distance of 1000 -> suppressed
        x[0, 1400] = 8.0  # same tile as 1100, outside distance -> kept
        x[0, 1650] = 7.5  # within distance of 1400 (cumulative excl)
        x[0, 3000] = 7.0
        valid = np.full(B, V, np.int32)
        self._compare(x, valid, distance=300, n_peaks=4, block=block)

    def test_distance_one_and_exhaustion(self, rng):
        B, V, block = 2, 1024, 128
        x = (rng.standard_normal((B, V)) * 0.01).astype(np.float32)
        x[0, 100] = 3.0
        x[0, 101] = 2.9
        x[1, :] = np.linspace(0, 1, V)  # monotone: no interior peaks
        valid = np.full(B, V, np.int32)
        self._compare(x, valid, distance=1, n_peaks=3, block=block)

    def test_big_distance_whole_row_suppressed(self, rng):
        B, V, block = 2, 2048, 256
        x = (rng.standard_normal((B, V)) * 0.3).astype(np.float32)
        valid = np.asarray([V, 700], np.int32)
        self._compare(x, valid, distance=V, n_peaks=2, block=block)


@pytest.mark.heavy
def test_fuzz_pallas_vs_jnp_vs_scipy(rng, interpret):
    """Property fuzz: random signals/valid-lengths/distances — the pallas
    picker, the jnp picker, and scipy.signal.find_peaks must agree on the
    surviving peak set (positions and heights)."""
    import scipy.signal

    from audio_matcher_tpu.ops.peaks import (
        pick_peaks_core,
        pick_peaks_pallas,
    )

    for trial in range(12):
        B = int(rng.integers(1, 4))
        block = int(rng.choice([64, 128, 256]))
        V = block * int(rng.integers(4, 17))
        distance = int(rng.integers(1, V))
        n_peaks = int(rng.integers(1, 6))
        x = rng.standard_normal((B, V)).astype(np.float32)
        if rng.random() < 0.5:  # sprinkle sharp peaks
            for _ in range(6):
                x[rng.integers(0, B), rng.integers(1, V - 1)] += 5.0
        valid = rng.integers(3, V + 1, size=B).astype(np.int32)

        a = pick_peaks_core(jnp.asarray(x), jnp.asarray(valid),
                            distance, n_peaks, block)
        b = pick_peaks_pallas(jnp.asarray(x), jnp.asarray(valid),
                              distance, n_peaks, block, interpret=interpret)
        for arr_a, arr_b in zip(a, b):
            na, nb = np.asarray(arr_a, np.float64), np.asarray(arr_b, np.float64)
            live = np.isfinite(np.asarray(a[1]))
            np.testing.assert_allclose(
                nb[live], na[live], rtol=1e-6, atol=1e-6,
                err_msg=f"trial {trial} (B={B} V={V} d={distance})",
            )

        # scipy oracle on the first row: the device picks must be exactly
        # the greedy-by-height prefix of scipy's distance-filtered peaks
        pos, h, _ = (np.asarray(v) for v in a)
        vl = int(valid[0])
        idx, _ = scipy.signal.find_peaks(
            x[0, :vl].astype(np.float64), distance=max(distance, 1)
        )
        by_height = sorted(idx, key=lambda i: -x[0, i])[: n_peaks]
        got_live = [int(p) for p, hh in zip(pos[0], h[0]) if np.isfinite(hh)]
        assert sorted(got_live) == sorted(by_height[: len(got_live)]) or (
            set(got_live) <= set(idx)
        ), f"trial {trial}: {got_live} vs scipy {list(idx)}"


def test_pick_peaks_pallas_single_tile_rows(rng, interpret):
    """Degenerate V == block (one tile per row): the rescan window clamps
    instead of producing negative slice bounds."""
    from audio_matcher_tpu.ops.peaks import pick_peaks_core, pick_peaks_pallas

    block = 128
    x = (rng.standard_normal((2, block)) * 0.1).astype(np.float32)
    x[0, 40] = 3.0
    x[0, 90] = 2.5
    valid = np.asarray([block, 100], np.int32)
    want = pick_peaks_core(jnp.asarray(x), jnp.asarray(valid), 30, 3, block)
    got = pick_peaks_pallas(jnp.asarray(x), jnp.asarray(valid), 30, 3, block,
                            interpret=interpret)
    for a, b in zip(want, got):
        na, nb = np.asarray(a, np.float64), np.asarray(b, np.float64)
        live = np.isfinite(np.asarray(want[1]))
        np.testing.assert_allclose(nb[live], na[live], rtol=1e-6)


@pytest.mark.parametrize("lead", [(5,), (2, 3)])
def test_dispatch_routes_pallas_through_resolver(rng, lead):
    """pick_peaks_dispatch with impl="pallas" flattens any leading batch
    shape, asks ops/impls.py whether to interpret (the CPU: yes), and
    matches the jnp picker."""
    from audio_matcher_tpu.ops.peaks import pick_peaks_dispatch

    V, block = 2048, 256
    x = rng.standard_normal((*lead, V)).astype(np.float32)
    valid = rng.integers(100, V + 1, size=lead).astype(np.int32)
    want = pick_peaks_dispatch(
        jnp.asarray(x), jnp.asarray(valid), 300, 3, block, "jnp"
    )
    got = pick_peaks_dispatch(
        jnp.asarray(x), jnp.asarray(valid), 300, 3, block, "pallas"
    )
    for g, w in zip(got, want):
        assert g.shape == (*lead, 3)
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        live = np.isfinite(np.asarray(want[1]))
        np.testing.assert_allclose(g[live], w[live], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("valid_max,block,want", [
    (1000, 256, SPAN),
    (SPAN, 512, SPAN),
    (SPAN + 1, 2048, 2 * SPAN),
    (20000, 8192, 24576),
])
def test_peaks_crop_width_is_a_segment_multiple(valid_max, block, want):
    """The pallas crop rounds the correlation up to whole kernel segments
    (no pad copy in the wrapper); the jnp crop is the valid width."""
    from audio_matcher_tpu.ops.peaks import peaks_crop_width

    assert peaks_crop_width(valid_max, block, "pallas") == want
    assert peaks_crop_width(valid_max, block, "jnp") == valid_max


@pytest.mark.gpu
@pytest.mark.parametrize("block", [512, 2048])
def test_compiled_block_reduce_matches_reference(rng, gpu_device, block):
    """The kernel as Triton compiles it for the card, at a canonical row
    width, against the numpy reference."""
    rows, V = 8, 2_801_664  # one segment multiple near a 60 s window
    x = rng.standard_normal((rows, V)).astype(np.float32)
    valid = rng.integers(V // 2, V + 1, size=rows).astype(np.int32)
    got = local_max_block_reduce(
        jnp.asarray(x), jnp.asarray(valid), block=block, interpret=False
    )
    want = block_reduce_reference(x, valid, block)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), w)
