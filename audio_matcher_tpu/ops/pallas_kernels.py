"""Pallas kernel for the peak-scan hot path (Triton route, NVIDIA GPUs).

Peak picking is the memory-bound stage that reads the largest array on
the hot path, the [B, V] correlation volume. The plain XLA picker
(``peaks.pick_peaks_core``) re-reads it once per suppression round and
again for the masks and the prominence pyramid. ``local_max_block_reduce``
collapses that to one pass: each program owns one row segment of
``SPAN`` columns and computes, per ``block``-column tile,

  * the tile's best strict local maximum (height + global position)
  * the tile's masked min / max (the prominence pyramid level)

after which suppression rounds and prominence assembly run as ``jnp`` on
the small [B, NB] block arrays (``peaks.pick_peaks_pallas``).

Programs are independent (no carry across the grid). The ±1 neighbours
are masked loads at offset columns, not in-register shifts, so every
column sees its true neighbours — tile and segment edges need no repair.
On the CPU the same kernel runs in interpret mode (tests/test_pallas.py).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

# columns per program: 3 × 16 KB loads of f32 — small enough to stay in
# registers at 8 warps, and a canonical slab (8 windows × 64 queries ×
# ~2.8 M columns) still launches ~350k programs over the 132 SMs
SPAN = 4096
NUM_WARPS = 8


def segment_width(block: int) -> int:
    """Columns per program for a ``block``-column tile (a power of two)."""
    if block <= 0 or block & (block - 1):
        raise ValueError(f"block must be a power of two, got {block}")
    return max(SPAN, block)


def _block_reduce_kernel(
    valid_ref,  # [B] int32 — per-row valid length
    x_ref,  # [B, V] f32 — whole array; each program loads its segment
    best_val_ref,  # [B, NB] out
    best_pos_ref,  # [B, NB] out (int32, global columns)
    bmin_ref,  # [B, NB] out
    bmax_ref,  # [B, NB] out
    *,
    block: int,
    span: int,
):
    row = pl.program_id(0)
    seg = pl.program_id(1)
    width = x_ref.shape[1]
    base = seg * span
    cols = base + jnp.arange(span, dtype=jnp.int32)
    valid = valid_ref[row]

    x = plt.load(x_ref.at[row, pl.ds(base, span)])
    # neighbours as masked loads at offset columns (L1/L2 hits, not extra
    # device-memory passes); index arrays rather than shifted slices so
    # the interpreter never clamps a start and misaligns a neighbour
    left = plt.load(
        x_ref.at[row, cols - 1], mask=cols >= 1, other=float("-inf")
    )
    right = plt.load(
        x_ref.at[row, cols + 1], mask=cols + 1 < width, other=float("-inf")
    )
    colvalid = cols < valid
    interior = (cols >= 1) & (cols <= valid - 2)
    is_peak = (x > left) & (x > right) & interior
    heights = jnp.where(is_peak, x, float("-inf"))

    tiles = span // block
    h2 = heights.reshape(tiles, block)
    r = jnp.argmax(h2, axis=1).astype(jnp.int32)  # first index on ties
    out = pl.ds(seg * tiles, tiles)
    plt.store(best_val_ref.at[row, out], jnp.max(h2, axis=1))
    plt.store(
        best_pos_ref.at[row, out],
        base + jnp.arange(tiles, dtype=jnp.int32) * block + r,
    )
    plt.store(
        bmin_ref.at[row, out],
        jnp.min(
            jnp.where(colvalid, x, float("inf")).reshape(tiles, block),
            axis=1,
        ),
    )
    plt.store(
        bmax_ref.at[row, out],
        jnp.max(
            jnp.where(colvalid, x, float("-inf")).reshape(tiles, block),
            axis=1,
        ),
    )


@partial(jax.jit, static_argnames=("block", "interpret"))
def local_max_block_reduce(
    x: jax.Array,  # [B, V] (V a multiple of block)
    valid_len: jax.Array,  # [B] int32
    block: int = 512,
    interpret: bool = False,
):
    """One-pass per-tile peak/extrema reduction.

    Returns (best_val [B, NB], best_pos [B, NB], bmin [B, NB], bmax [B, NB])
    where NB = V // block; best_pos holds GLOBAL column indices, and a tile
    without a strict interior local maximum has best_val = -inf. V pads to
    a whole number of program segments internally (the pad lies beyond
    every row's valid length) and the outputs crop back to NB tiles.
    """
    B, V = x.shape
    assert V % block == 0, "pad V to a multiple of block"
    span = segment_width(block)
    nb = V // block
    v_pad = -(-V // span) * span
    if v_pad != V:
        x = jnp.pad(x, ((0, 0), (0, v_pad - V)))
    nb_pad = v_pad // block
    out_shape = [
        jax.ShapeDtypeStruct((B, nb_pad), jnp.float32),
        jax.ShapeDtypeStruct((B, nb_pad), jnp.int32),
        jax.ShapeDtypeStruct((B, nb_pad), jnp.float32),
        jax.ShapeDtypeStruct((B, nb_pad), jnp.float32),
    ]
    bv, bp, bmin, bmax = pl.pallas_call(
        partial(_block_reduce_kernel, block=block, span=span),
        grid=(B, v_pad // span),
        out_shape=out_shape,
        compiler_params=plt.CompilerParams(
            num_warps=NUM_WARPS, num_stages=1
        ),
        interpret=interpret,
        backend="triton",
        name="peaks_block_reduce",
    )(valid_len.astype(jnp.int32), x.astype(jnp.float32))
    return bv[:, :nb], bp[:, :nb], bmin[:, :nb], bmax[:, :nb]
