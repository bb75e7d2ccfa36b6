"""On-device peak picking: local maxima, distance suppression, prominence.

Device re-design of the reference's per-chunk ``find_peaks`` call
(reference src/matcher/audio_matcher.rs:221-230: the ``find_peaks`` crate with
``min_prominence`` + ``min_distance``, scipy-compatible semantics):

  * local maxima           — vectorized strict-neighbor compare.
    DOCUMENTED DEVIATION: plateaus (runs of exactly-equal adjacent samples)
    are never peaks on the device paths, whereas scipy (and the reference's
    find_peaks crate) report a plateau's midpoint; the >256-peak scipy
    fallback in :func:`find_peaks_device` inherits scipy's plateau
    semantics, so the two paths can disagree on exactly-tied values (e.g.
    hard-clipped correlation). Float correlation of real audio has no
    exact ties in practice, and the deviation is strictly conservative
    (a plateau is never a *strict* maximum).
  * min-distance filter    — iterated masked argmax: each round keeps the
    highest remaining peak and suppresses everything within ``distance``
    samples; this reproduces scipy's sort-by-height greedy exactly, because
    the next argmax is precisely "the highest not-yet-deleted peak", and
    runs as ``lax.scan`` over a small static number of rounds (there can be
    at most ceil(window/distance)+1 survivors).
  * topographic prominence — blockwise two-level search: per-block max/min
    pyramids locate the nearest strictly-higher sample on each side and the
    minimum of the spanned range without any sequential scan over the signal.

Everything is batched over windows ([B, V]) so one jitted call handles a
whole overlap-save slab. Prominence is window-local, like the reference
(which computes prominence per chunk, then dedups across chunks —
SURVEY.md §7 "hard parts (a)": preserved, not "fixed").
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

# plain python floats: jnp scalars here would initialize the JAX backend
# at import time (heavy, and wrong for pure-host users of this package)
_NEG = float("-inf")
_POS = float("inf")


@dataclasses.dataclass(frozen=True)
class Peak:
    """A match peak. ``position`` is the sample index where the snippet
    starts; parity with ``find_peaks::Peak`` (position.start / prominence)."""

    position: int
    height: float
    prominence: float

    def start_secs(self, sr: int) -> float:
        # parity: matcher/mod.rs:127-129 (start_as_duration)
        return self.position / sr


def _masked_rows(x: jax.Array, valid_len: jax.Array):
    """Return (x_for_min [+inf pad], x_for_max [-inf pad], colvalid mask)."""
    V = x.shape[-1]
    cols = jnp.arange(V, dtype=jnp.int32)
    colvalid = cols[None, :] < valid_len[:, None]
    return (
        jnp.where(colvalid, x, _POS),
        jnp.where(colvalid, x, _NEG),
        colvalid,
    )


def _local_max_heights(x: jax.Array, valid_len: jax.Array) -> jax.Array:
    """Heights at strict local maxima, -inf elsewhere.

    A peak needs two real neighbors inside the window's valid range (scipy
    excludes signal edges; the reference inherits that per chunk).
    """
    B, V = x.shape
    cols = jnp.arange(V, dtype=jnp.int32)
    interior = (cols[None, :] >= 1) & (cols[None, :] <= valid_len[:, None] - 2)
    up = jnp.concatenate(
        [jnp.zeros((B, 1), bool), x[:, 1:] > x[:, :-1]], axis=1
    )
    down = jnp.concatenate(
        [x[:, :-1] > x[:, 1:], jnp.zeros((B, 1), bool)], axis=1
    )
    return jnp.where(up & down & interior, x, _NEG)


def _distance_suppress(y: jax.Array, distance: int, n_peaks: int):
    """Iterated masked argmax = scipy's greedy-by-height distance filter.

    Suppression removes peaks with |Δpos| < distance (strict, matching
    scipy's ``_select_by_peak_distance``). Tie caveat: on EXACT equal
    heights scipy processes the highest index first while argmax keeps
    the lowest — surviving sets can differ on ties (float audio
    correlation has no exact ties in practice; same class of deviation
    as the plateau rules in the module docstring). Returns ([B,S] pos,
    [B,S] height); exhausted slots have height -inf.
    """
    V = y.shape[-1]
    cols = jnp.arange(V, dtype=jnp.int32)
    d = max(int(distance), 1)

    def body(y, _):
        idx = jnp.argmax(y, axis=-1).astype(jnp.int32)
        h = jnp.take_along_axis(y, idx[:, None], axis=-1)[:, 0]
        supp = jnp.abs(cols[None, :] - idx[:, None]) < d
        return jnp.where(supp, _NEG, y), (idx, h)

    _, (pos, height) = jax.lax.scan(body, y, None, length=n_peaks)
    return pos.T, height.T  # [B, S]


def _prominences(x_min, x_max, pos, h, valid_len, block: int):
    """Prominence for candidate peaks. x_min/x_max: [B, V] (+inf/-inf masked),
    pos/h: [B, S]."""
    B, V = x_min.shape
    NB = -(-V // block)
    pad = NB * block - V
    x3_min = jnp.pad(x_min, ((0, 0), (0, pad)), constant_values=np.inf).reshape(
        B, NB, block
    )
    x3_max = jnp.pad(x_max, ((0, 0), (0, pad)), constant_values=-np.inf).reshape(
        B, NB, block
    )
    block_min = x3_min.min(-1)  # [B, NB]
    block_max = x3_max.max(-1)
    batch_ix = jnp.arange(B)[:, None]

    def gather_blocks(pb):
        return x3_min[batch_ix, pb], x3_max[batch_ix, pb]

    return _prominences_from_blocks(
        gather_blocks, block_min, block_max, pos, h, block
    )


def _prominences_from_blocks(
    gather_blocks, block_min, block_max, pos, h, block: int
):
    """Prominence from a block pyramid.

    ``gather_blocks(pb [B, S]) → (min_masked, max_masked) [B, S, block]``
    fetches block contents (dense reshape in the jnp path; device-memory
    dynamic-slice gathers in the Pallas path, so no full-array pass is
    needed). block_min/block_max: [B, NB] masked extrema per block.
    """
    NB = block_min.shape[1]

    pb = pos // block  # [B, S]
    r = pos % block
    own_min, own_max = gather_blocks(pb)  # [B, S, block]
    bcols = jnp.arange(block, dtype=jnp.int32)
    bidx = jnp.arange(NB, dtype=jnp.int32)

    def side(left: bool):
        if left:
            in_sel = bcols[None, None, :] < r[..., None]
            blk_sel = bidx[None, None, :] < pb[..., None]
            nearest = lambda m, v, fill: jnp.max(
                jnp.where(m, v, fill), axis=-1
            )
            in_fill, blk_fill = -1, -1
        else:
            in_sel = bcols[None, None, :] > r[..., None]
            blk_sel = bidx[None, None, :] > pb[..., None]
            nearest = lambda m, v, fill: jnp.min(
                jnp.where(m, v, fill), axis=-1
            )
            in_fill, blk_fill = block, NB

        hx = h[..., None]
        # nearest strictly-higher sample within the peak's own block
        in_mask = in_sel & (own_max > hx)
        found_in = jnp.any(in_mask, axis=-1)
        j_in = nearest(in_mask, bcols[None, None, :], in_fill)
        # nearest block (beyond the own block) containing a higher sample
        blk_mask = blk_sel & (block_max[:, None, :] > hx)
        found_blk = jnp.any(blk_mask, axis=-1)
        j_blk = nearest(blk_mask, bidx[None, None, :], blk_fill)
        j_blk_c = jnp.clip(j_blk, 0, NB - 1)
        far_min, far_max = gather_blocks(j_blk_c)  # [B, S, block]
        # position of the higher sample inside the far block
        far_mask = far_max > hx
        j_far = nearest(far_mask, bcols[None, None, :], in_fill)

        if left:
            # min over (j, pos] assembled from up to three pieces
            minA = jnp.min(
                jnp.where(
                    (bcols[None, None, :] > j_in[..., None]) & (bcols[None, None, :] <= r[..., None]),
                    own_min, _POS,
                ), axis=-1,
            )
            part_far = jnp.min(
                jnp.where(bcols[None, None, :] > j_far[..., None], far_min, _POS),
                axis=-1,
            )
            between = (bidx[None, None, :] > j_blk[..., None]) & (
                bidx[None, None, :] < pb[..., None]
            )
            part_mid = jnp.min(
                jnp.where(between, block_min[:, None, :], _POS), axis=-1
            )
            part_own = jnp.min(
                jnp.where(bcols[None, None, :] <= r[..., None], own_min, _POS),
                axis=-1,
            )
            edge_mid = jnp.min(
                jnp.where(bidx[None, None, :] < pb[..., None], block_min[:, None, :], _POS),
                axis=-1,
            )
            minB = jnp.minimum(jnp.minimum(part_far, part_mid), part_own)
            minC = jnp.minimum(edge_mid, part_own)
        else:
            minA = jnp.min(
                jnp.where(
                    (bcols[None, None, :] < j_in[..., None]) & (bcols[None, None, :] >= r[..., None]),
                    own_min, _POS,
                ), axis=-1,
            )
            part_far = jnp.min(
                jnp.where(bcols[None, None, :] < j_far[..., None], far_min, _POS),
                axis=-1,
            )
            between = (bidx[None, None, :] < j_blk[..., None]) & (
                bidx[None, None, :] > pb[..., None]
            )
            part_mid = jnp.min(
                jnp.where(between, block_min[:, None, :], _POS), axis=-1
            )
            part_own = jnp.min(
                jnp.where(bcols[None, None, :] >= r[..., None], own_min, _POS),
                axis=-1,
            )
            edge_mid = jnp.min(
                jnp.where(bidx[None, None, :] > pb[..., None], block_min[:, None, :], _POS),
                axis=-1,
            )
            minB = jnp.minimum(jnp.minimum(part_far, part_mid), part_own)
            minC = jnp.minimum(edge_mid, part_own)

        return jnp.where(found_in, minA, jnp.where(found_blk, minB, minC))

    left_base = side(left=True)
    right_base = side(left=False)
    return h - jnp.maximum(left_base, right_base)


def pick_peaks_core(
    x: jax.Array,
    valid_len: jax.Array,
    distance: int,
    n_peaks: int,
    block: int = 1024,
):
    """Un-jitted core of :func:`pick_peaks_batch` (vmap/shard_map friendly)."""
    x = x.astype(jnp.float32)
    x_min, x_max, _ = _masked_rows(x, valid_len)
    y = _local_max_heights(x_max, valid_len)
    pos, height = _distance_suppress(y, distance, n_peaks)
    prom = _prominences(x_min, x_max, jnp.clip(pos, 0), height, valid_len, block)
    return pos, height, prom


def _row_slices(x, starts, width: int):
    """[B, V] rows, [B] pre-clamped starts → [B, width] windows."""
    def one(row, s):
        return jax.lax.dynamic_slice(row, (s,), (width,))

    return jax.vmap(one)(x, starts)


def _row_slot_slices(x, starts, width: int):
    """[B, V] rows, [B, S] pre-clamped starts → [B, S, width] windows."""
    def one(row, ss):
        return jax.vmap(
            lambda s: jax.lax.dynamic_slice(row, (s,), (width,))
        )(ss)

    return jax.vmap(one)(x, starts)


def _rescan_tile(x, valid_len, picked_pos, tile, d, block):
    """Exact best surviving local max of one tile per row, excluding every
    already-picked exclusion interval (|col - p_j| < d). Exhausted picked
    slots hold a far-negative sentinel, so they exclude nothing."""
    B, V = x.shape
    t = jnp.clip(tile, 0, V // block - 1)
    start = t * block
    # halo window; the slice start clamps near the array edges, so column
    # indices are tracked explicitly and masked back to the tile
    width = min(block + 2, V)
    p0 = jnp.clip(start - 1, 0, max(V - width, 0))
    win = _row_slices(x, p0, width)
    cols = p0[:, None] + 1 + jnp.arange(width - 2, dtype=jnp.int32)[None, :]
    c = win[:, 1:-1]
    left = win[:, :-2]
    right = win[:, 2:]
    in_tile = (cols >= start[:, None]) & (cols < start[:, None] + block)
    interior = (cols >= 1) & (cols <= valid_len[:, None] - 2)
    pk = (c > left) & (c > right) & interior & in_tile
    # cumulative exclusion: |col - p_j| < d for any picked j
    excl = jnp.any(
        jnp.abs(cols[:, None, :] - picked_pos[:, :, None]) < d, axis=1
    )
    h = jnp.where(pk & ~excl, c, _NEG)
    best = jnp.argmax(h, axis=1)
    bi = jnp.arange(B)
    return h[bi, best], cols[bi, best]


def pick_peaks_pallas(
    x: jax.Array,  # [B, V]
    valid_len: jax.Array,
    distance: int,
    n_peaks: int,
    block: int = 2048,
    interpret: bool = False,
):
    """Kernel-backed :func:`pick_peaks_core`: identical semantics, but the
    [B, V] correlation is read ONCE from device memory (one grid pass
    computing per-tile best-local-max + masked extrema,
    ``pallas_kernels.local_max_block_reduce``); every later stage —
    greedy distance suppression (with exact rescan of the ≤2
    partially-suppressed boundary tiles per round, under the CUMULATIVE
    exclusion set) and blockwise prominence — runs on [B, NB] block
    arrays plus small dynamic-slice gathers. ``block`` must be a power
    of two.
    """
    from .pallas_kernels import local_max_block_reduce

    x = x.astype(jnp.float32)
    B, V = x.shape
    if V % block:
        # callers crop the correlation to a block multiple to avoid this
        # copy; fallback for ad-hoc shapes
        x = jnp.pad(x, ((0, 0), (0, block - V % block)))
        V = x.shape[1]
    NB = V // block
    valid_len = valid_len.astype(jnp.int32)
    bv, bp, bmin, bmax = local_max_block_reduce(
        x, valid_len, block=block, interpret=interpret
    )

    d = max(int(distance), 1)
    tile_start = jnp.arange(NB, dtype=jnp.int32)[None, :] * block
    tile_end = tile_start + block - 1

    SENTINEL = jnp.int32(-(1 << 30))  # farther than any distance from cols

    def round_body(carry, r):
        bv, bp, picked = carry
        k = jnp.argmax(bv, axis=1)
        bi = jnp.arange(B)
        h = bv[bi, k]
        pos = bp[bi, k]
        real = jnp.isfinite(h)
        picked = picked.at[:, r].set(jnp.where(real, pos, SENTINEL))
        lo = pos - d + 1
        hi = pos + d - 1
        full = (
            (tile_start >= lo[:, None]) & (tile_end <= hi[:, None])
            & real[:, None]
        )
        bv = jnp.where(full, _NEG, bv)
        for edge in (lo // block, hi // block):
            in_range = (edge >= 0) & (edge < NB) & real
            nv, npos = _rescan_tile(x, valid_len, picked, edge, d, block)
            t = jnp.clip(edge, 0, NB - 1)
            bv = bv.at[bi, t].set(jnp.where(in_range, nv, bv[bi, t]))
            bp = bp.at[bi, t].set(jnp.where(in_range, npos, bp[bi, t]))
        return (bv, bp, picked), (pos, h)

    picked0 = jnp.full((B, n_peaks), SENTINEL, jnp.int32)
    (_, _, _), (pos, height) = jax.lax.scan(
        round_body, (bv, bp, picked0),
        jnp.arange(n_peaks, dtype=jnp.int32),
    )
    pos, height = pos.T, height.T  # [B, S]

    # prominence via the kernel's block extrema + small gathers (no full
    # pass over the correlation)
    cols = jnp.arange(block, dtype=jnp.int32)

    def gather_blocks(pb):
        starts = jnp.clip(pb, 0, NB - 1) * block  # [B, S]
        seg = _row_slot_slices(x, starts, block)  # [B, S, block]
        cv = (starts[..., None] + cols) < valid_len[:, None, None]
        return jnp.where(cv, seg, _POS), jnp.where(cv, seg, _NEG)

    prom = _prominences_from_blocks(
        gather_blocks, bmin, bmax, jnp.clip(pos, 0), height, block
    )
    return pos, height, prom


def pick_peaks_dispatch(
    x, valid_len, distance: int, n_peaks: int, block: int, impl: str
):
    """Route to the jnp or Pallas implementation (identical semantics).

    Accepts any leading batch shape (flattened internally — the Pallas
    grid can't sit under ``vmap``). The Pallas path compiles for the GPU
    and runs in interpret mode on the CPU (``impls.pallas_interpret``),
    so CPU tests exercise the same code.
    """
    from .impls import pallas_interpret

    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    v2 = valid_len.reshape(-1)
    if impl == "pallas":
        out = pick_peaks_pallas(
            x2, v2, distance, n_peaks, block, interpret=pallas_interpret()
        )
    else:
        out = pick_peaks_core(x2, v2, distance, n_peaks, block)
    return tuple(o.reshape(*lead, o.shape[-1]) for o in out)


def peaks_crop_width(valid_max: int, block: int, impl: str) -> int:
    """Static correlation-crop width: the Pallas path wants a whole number
    of kernel segments (``pallas_kernels.segment_width``) so the kernel
    wrapper never pads — a pad would copy the whole correlation volume."""
    if impl == "pallas":
        from .pallas_kernels import segment_width

        unit = segment_width(block)
        return -(-valid_max // unit) * unit
    return valid_max


@partial(jax.jit, static_argnames=("distance", "n_peaks", "block"))
def pick_peaks_batch(
    x: jax.Array,
    valid_len: jax.Array,
    distance: int,
    n_peaks: int,
    block: int = 1024,
):
    """Find up to ``n_peaks`` distance-filtered peaks per window row.

    x: [B, V] correlation scores; valid_len: [B] number of real columns.
    Returns (pos [B,S] int32, height [B,S] f32, prominence [B,S] f32);
    exhausted slots have height == -inf (drop them host-side). Prominence of
    ALL returned candidates is computed (the min-prominence filter is applied
    by the caller, preserving scipy's distance-then-prominence order).
    """
    return pick_peaks_core(x, valid_len, distance, n_peaks, block)


def find_peaks_device(
    x: np.ndarray,
    distance: int = 1,
    min_prominence: float = 0.0,
    n_peaks: int | None = None,
    block: int = 1024,
) -> list[Peak]:
    """Single-signal convenience wrapper (used by tests and the library API).

    Semantics follow scipy.signal.find_peaks(distance=, prominence=):
    strict local maxima, greedy-by-height distance suppression, prominence
    threshold applied last.
    """
    x = np.asarray(x, np.float32)
    V = x.shape[-1]
    if n_peaks is None:
        # at most ceil(V/distance)+1 peaks can survive distance suppression
        n_peaks = min(V // max(int(distance), 1) + 2, max(V // 2, 2))
    if n_peaks > 256:
        # dense-peak regime (tiny min-distance): the iterated-argmax device
        # path would need thousands of rounds; scipy implements exactly the
        # semantics we emulate, so use it host-side for this cold path.
        # NOTE: scipy's plateau handling differs from the device paths on
        # exact ties (module docstring) — surface the switch to callers.
        import logging

        import scipy.signal

        logging.getLogger("audio_matcher.peaks").info(
            "find_peaks_device: %d candidate slots exceed the device "
            "path's 256 — using scipy host-side (plateau-tie semantics "
            "differ from the device kernels on exact ties)", n_peaks,
        )

        kwargs = {"distance": distance} if distance and distance > 1 else {}
        idx, props = scipy.signal.find_peaks(
            x.astype(np.float64), prominence=(float(min_prominence), None), **kwargs
        )
        return [
            Peak(int(p), float(x[p]), float(pr))
            for p, pr in zip(idx, props["prominences"])
        ]
    # bucket the static shape/slot count: per-episode lengths would
    # otherwise compile a fresh 256-round scan program per call. Pad is -inf —
    # never a local maximum — and valid_len masks it anyway.
    n_peaks = 1 << max(int(n_peaks) - 1, 1).bit_length()
    V_pad = max(-(-V // 4096) * 4096, 4096)
    if V_pad != V:
        x = np.pad(x, (0, V_pad - V), constant_values=-np.inf)
    pos, h, prom = pick_peaks_batch(
        jnp.asarray(x)[None, :],
        jnp.asarray([V], jnp.int32),
        distance=int(distance),
        n_peaks=int(n_peaks),
        block=block,
    )
    pos, h, prom = np.asarray(pos[0]), np.asarray(h[0]), np.asarray(prom[0])
    out = [
        Peak(int(p), float(hh), float(pr))
        for p, hh, pr in zip(pos, h, prom)
        if np.isfinite(hh) and pr >= min_prominence
    ]
    out.sort(key=lambda pk: pk.position)
    return out
