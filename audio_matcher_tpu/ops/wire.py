"""The staging wire grid's DEVICE decode — one definition.

Encode lives host-side in ``models.matcher.quantize_wire`` (LUT-based for
μ-law); this is its traced inverse, used by
``models.matcher.dequantize_on_device`` and the spectrogram scanner,
bit-compatible with the host grid: int16 is value/65535 (the reference's
``(l+r)*0.5/65535`` PCM scale, mp3_reader.rs:12), μ-law (μ=255) expands
arithmetically rather than through a 256-entry LUT gather over the whole
episode.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

MU = 255.0


def dequant_to_f32(x):
    """Wire values (i16 / u8 / f32) → f32 reference-scale PCM (traced;
    plain elementwise ops, usable inside kernel bodies and jit alike)."""
    if x.dtype == jnp.int16:
        return x.astype(jnp.float32) * jnp.float32(1.0 / 65535.0)
    if x.dtype == jnp.uint8:
        b = x.astype(jnp.float32) * jnp.float32(1.0 / 127.5) - 1.0
        mag = jnp.expm1(jnp.abs(b) * jnp.float32(np.log1p(MU)))
        u = jnp.where(b >= 0, mag, -mag) * jnp.float32(1.0 / MU)
        return u * jnp.float32(32768.0 / 65535.0)
    return x.astype(jnp.float32)
