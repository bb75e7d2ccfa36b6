"""Matmul FFT: Cooley-Tukey via DFT matmuls + twiddles (``fft_impl="mxu"``).

An alternative correlation backend to the library FFT: the FFT becomes a
recursive four-step decomposition whose butterflies are DENSE DFT
MATMULS (128–512 points), putting ~97% of the FLOPs on the matrix units:

    X[c + A·d] = Σ_b  W_N^{bc} · (Σ_a x[a·B + b] · W_A^{ac}) · W_B^{bd}
                 ────twiddle────  ───── DFT_A matmul ──────    recurse

Complex arithmetic is hand-split into real matmul pairs so matmul
precision is controllable (``precision=HIGHEST`` ≈ f32-accurate via bf16
pass decomposition). Real signals are packed in PAIRS into one complex
transform (z = a + i·b), which the scan exploits: two query correlations
per inverse FFT.

Verified against numpy's FFT to ~1e-6 relative error (tests/test_mxu_fft.py).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

DEFAULT_PRECISION = jax.lax.Precision.HIGHEST


def default_factors(n: int) -> tuple[int, ...]:
    """Factor n (a power of two) into balanced DFT-matmul radices ≤ 256.

    Per-stage cost is max(bandwidth pass, matmul FLOPs ∝ radix); the
    exponent is split into the fewest parts of ≤ 8 bits, as even as
    possible (2^22 → (256, 128, 128))."""
    if n & (n - 1):
        raise ValueError(f"mxu fft requires a power of two, got {n}")
    e = n.bit_length() - 1
    if e == 0:
        raise ValueError("n must be ≥ 2")
    k = -(-e // 8)
    base, rem = divmod(e, k)
    parts = [base + 1] * rem + [base] * (k - rem)
    return tuple(1 << p for p in parts)


def _dft_mat(n: int, sign: int):
    """[n, n] DFT matrix W^{sign·jk} as (real, imag) f32, built IN-GRAPH.

    (Host constants would be embedded as program literals — tens of MB for
    the twiddles — which bloats remote compiles; iota+cos is cheap.)
    """
    j = jnp.arange(n, dtype=jnp.int32)
    jk = (j[:, None] * j[None, :]) % n  # exact in int32 for n ≤ 512
    phase = (sign * 2.0 * np.pi / n) * jk.astype(jnp.float32)
    return jnp.cos(phase), jnp.sin(phase)


def _twiddle(a: int, m: int, sign: int):
    """[a, m] twiddle W_{a·m}^{sign·c·b} as (real, imag) f32, in-graph.

    c·b < a·m ≤ 2^24 stays exact in f32 for the FFT sizes used here.
    """
    n = a * m
    c = jnp.arange(a, dtype=jnp.float32)[:, None]
    b = jnp.arange(m, dtype=jnp.float32)[None, :]
    phase = (sign * 2.0 * np.pi / n) * (c * b)
    return jnp.cos(phase), jnp.sin(phase)


def _cmatmul(tr, ti, xr, xi, precision):
    """(tr + i·ti) @ (xr + i·xi) as real matmuls.

    t: [c, a]; x: [..., a, m] → [..., c, m]; 4 real matmuls.
    """
    dot = partial(jnp.einsum, "ca,...am->...cm", precision=precision)
    rr = dot(tr, xr)
    ii = dot(ti, xi)
    ri = dot(tr, xi)
    ir = dot(ti, xr)
    return rr - ii, ri + ir


def _cfft_rec(xr, xi, factors, precision, sign):
    """Recursive four-step complex FFT along the LAST axis (length
    prod(factors)); x as separate (real, imag) f32 arrays."""
    a = factors[0]
    n = xr.shape[-1]
    m = n // a
    tr, ti = _dft_mat(a, sign)
    # n = idx_a · m + idx_b → [..., a, m]
    xr = xr.reshape(*xr.shape[:-1], a, m)
    xi = xi.reshape(*xi.shape[:-1], a, m)
    yr, yi = _cmatmul(tr, ti, xr, xi, precision)  # [..., c, m]
    if len(factors) == 1:
        return yr.reshape(*yr.shape[:-2], n), yi.reshape(*yi.shape[:-2], n)
    wr, wi = _twiddle(a, m, sign)
    zr = yr * wr - yi * wi
    zi = yr * wi + yi * wr
    zr, zi = _cfft_rec(zr, zi, factors[1:], precision, sign)  # [..., c, d]
    # k = c + a·d → put d before c, then flatten
    zr = jnp.swapaxes(zr, -1, -2).reshape(*zr.shape[:-2], n)
    zi = jnp.swapaxes(zi, -1, -2).reshape(*zi.shape[:-2], n)
    return zr, zi


def cfft_parts(
    xr,
    xi,
    inverse: bool = False,
    factors: tuple[int, ...] | None = None,
    precision=DEFAULT_PRECISION,
):
    """Complex FFT along the last axis on split (real, imag) f32 arrays.

    Forward matches ``np.fft.fft``; inverse matches ``np.fft.ifft``
    (including the 1/N scale). Returns (real, imag).
    """
    n = xr.shape[-1]
    factors = factors or default_factors(n)
    sign = 1 if inverse else -1
    yr, yi = _cfft_rec(
        jnp.asarray(xr, jnp.float32),
        jnp.asarray(xi, jnp.float32),
        factors, precision, sign,
    )
    if inverse:
        s = jnp.float32(1.0 / n)
        return yr * s, yi * s
    return yr, yi


@partial(jax.jit, static_argnames=("inverse", "factors"))
def cfft(x, inverse: bool = False, factors: tuple[int, ...] | None = None):
    """Convenience complex64 in/out wrapper (jitted)."""
    xr = jnp.real(x).astype(jnp.float32)
    xi = jnp.imag(x).astype(jnp.float32)
    yr, yi = cfft_parts(xr, xi, inverse=inverse, factors=factors)
    return yr + 1j * yi


# ---- scrambled-order plane-packed transforms (the scan's hot path) ----
#
# Complex values ride as a REAL "plane" axis (size 2) so each DFT stage is
# ONE real matmul with contraction 2·radix (instead of 4 separate real
# matmuls): the [2, c, 2, a] block matrix [[D_r, -D_i], [D_i, D_r]] applied
# to the contiguous [2a, m] view. No inter-stage reordering is done (the
# output is digit-reversed, which convolution never notices) and the plane
# axis migrates inward with the recursion, so there are ZERO transpose
# passes in the whole forward→multiply→inverse round trip.
#
# Scrambled layout of a length-n transform with factors (a1, ..., aL):
#   [..., c1, c2, ..., c_{L-1}, 2, c_L]  (flattened to [..., 2n])


def _block_mat(a: int, sign: int, inverse: bool, col_plane_major: bool):
    """[2a, 2a] real block matrix of the (inverse) DFT on plane-packed data.

    Rows are always plane-major ((real block; imag block)). Columns follow
    the operand layout: plane-major (k·a + a_in) for the forward / inverse
    base, or interleaved (a_in·2 + k) for the inverse's (c, 2) flatten.
    """
    tr, ti = _dft_mat(a, -sign if inverse else sign)
    if col_plane_major:
        top = jnp.concatenate([tr, -ti], axis=1)
        bot = jnp.concatenate([ti, tr], axis=1)
    else:
        top = jnp.stack([tr, -ti], axis=2).reshape(a, 2 * a)
        bot = jnp.stack([ti, tr], axis=2).reshape(a, 2 * a)
    return jnp.concatenate([top, bot], axis=0)


def _fft2p_rec(x, factors, precision, sign):
    """x: [..., 2, n] plane-major → scrambled [..., 2n].

    Each stage is ONE standard [2a, 2a] @ [..., 2a, m] matmul (the complex
    block structure lives in the matrix), a plain dense matmul layout.
    Twiddles are materialized once per stage (optimization_barrier) —
    letting XLA fuse the cos/sin into consumers would recompute millions
    of transcendentals per batch row.
    """
    a = factors[0]
    n = x.shape[-1]
    m = n // a
    t2 = _block_mat(a, sign, inverse=False, col_plane_major=True)
    xf = x.reshape(*x.shape[:-2], 2 * a, m)
    y = jnp.einsum("ca,...am->...cm", t2, xf, precision=precision)
    if len(factors) == 1:
        return y.reshape(*y.shape[:-2], 2 * n)  # m == 1
    y = y.reshape(*y.shape[:-2], 2, a, m)
    wr, wi = jax.lax.optimization_barrier(_twiddle(a, m, sign))
    zr = y[..., 0, :, :] * wr - y[..., 1, :, :] * wi
    zi = y[..., 0, :, :] * wi + y[..., 1, :, :] * wr
    z = jnp.stack([zr, zi], axis=-2)  # [..., c, 2, m] — plane moves inward
    out = _fft2p_rec(z, factors[1:], precision, sign)  # [..., c, 2m]
    return out.reshape(*out.shape[:-2], 2 * n)


def _ifft2p_rec(y, factors, precision, sign):
    """Scrambled [..., 2n] → natural [..., 2, n] plane-major (unscaled)."""
    a = factors[0]
    n = y.shape[-1] // 2
    m = n // a
    if len(factors) == 1:
        t2 = _block_mat(a, sign, inverse=True, col_plane_major=True)
        x = jnp.einsum("ac,...c->...a", t2, y, precision=precision)
        return x.reshape(*x.shape[:-1], 2, a)
    y = y.reshape(*y.shape[:-1], a, 2 * m)  # [..., c, 2m-scrambled]
    z = _ifft2p_rec(y, factors[1:], precision, sign)  # [..., c, 2, m]
    wr, wi = jax.lax.optimization_barrier(_twiddle(a, m, -sign))
    zr = z[..., 0, :] * wr - z[..., 1, :] * wi
    zi = z[..., 0, :] * wi + z[..., 1, :] * wr
    z = jnp.stack([zr, zi], axis=-2)  # [..., c, 2, m]
    zf = z.reshape(*z.shape[:-3], 2 * a, m)  # (c, 2) flattened, c-major
    t2 = _block_mat(a, sign, inverse=True, col_plane_major=False)
    x = jnp.einsum("ac,...cm->...am", t2, zf, precision=precision)
    return x.reshape(*x.shape[:-2], 2, n)  # rows are (o, a) o-major


def cfft_scrambled_parts(
    xr, xi, factors: tuple[int, ...], precision=DEFAULT_PRECISION
):
    """Forward FFT to digit-reversed order (split real/imag f32 in/out —
    note the OUT parts are views of the scrambled layout, only meaningful
    to the matching inverse / elementwise complex arithmetic)."""
    x = jnp.stack(
        [jnp.asarray(xr, jnp.float32), jnp.asarray(xi, jnp.float32)],
        axis=-2,
    )
    out = _fft2p_rec(x, factors, precision, -1)  # [..., 2n]
    c_last = factors[-1]
    v = out.reshape(*out.shape[:-1], -1, 2, c_last)
    return v[..., 0, :], v[..., 1, :]  # scrambled-plane views [..., G, cL]


def icfft_scrambled_parts(
    yr, yi, factors: tuple[int, ...], precision=DEFAULT_PRECISION
):
    """Inverse FFT from digit-reversed plane views to natural (with 1/N)."""
    c_last = factors[-1]
    y = jnp.stack([yr, yi], axis=-2)  # [..., G, 2, cL]
    n2 = int(np.prod(y.shape[-3:]))
    y = y.reshape(*y.shape[:-3], n2)
    x = _ifft2p_rec(y, factors, precision, -1)  # [..., 2, n]
    s = jnp.float32(2.0 / n2)
    return x[..., 0, :] * s, x[..., 1, :] * s


def scrambled_spectra_parts(
    x, n: int, factors=None, precision=DEFAULT_PRECISION
):
    """Digit-reversed full spectra of real rows (query-side precompute).

    Returns plane views [..., n//c_last, c_last] — pass them straight to
    :func:`corr_slab_mxu`, which does its complex arithmetic in the same
    scrambled layout.
    """
    factors = factors or default_factors(n)
    x = jnp.asarray(x, jnp.float32)
    if x.shape[-1] < n:
        pad = [(0, 0)] * (x.ndim - 1) + [(0, n - x.shape[-1])]
        x = jnp.pad(x, pad)
    return cfft_scrambled_parts(x, jnp.zeros_like(x), factors, precision)


def corr_slab_mxu(
    windows,  # [B, W] f32 (W ≤ n; zero-padded)
    s_scr_r,  # [Q, n] f32 — DIGIT-REVERSED query spectra (real part),
    s_scr_i,  # [Q, n] f32    from scrambled_spectra_parts
    valid_max: int,
    precision=DEFAULT_PRECISION,
    factors: tuple[int, ...] | None = None,
):
    """All (window, query) valid correlations with every FFT as matmuls.

    The whole round trip stays in DIGIT-REVERSED order (convolution never
    needs natural-order spectra): the forward transform skips the
    inter-stage reordering, the conj-multiply happens scrambled, and the
    inverse consumes scrambled order directly — zero transpose passes.
    Correlation outputs are real, so consecutive (window, query) spectra
    pack in PAIRS into one complex inverse (icfft(Ca + i·Cb) = ca + i·cb),
    so the packing alone halves inverse work.
    Returns [B, Q, valid_max] f32.
    """
    B, W = windows.shape
    Q, G, c_last = s_scr_r.shape
    n = G * c_last
    factors = factors or default_factors(n)
    if W < n:
        windows = jnp.pad(windows, ((0, 0), (0, n - W)))
    # forward: scrambled spectra of each (real) window
    Xr, Xi = cfft_scrambled_parts(
        windows, jnp.zeros_like(windows), factors, precision
    )  # [B, G, cL] plane views
    # correlation spectra C = X · conj(S), elementwise in scrambled layout,
    # flattened over (window, query) and packed in pairs:
    # V = C_{2k} + i·C_{2k+1}
    Cr = (
        Xr[:, None] * s_scr_r[None] + Xi[:, None] * s_scr_i[None]
    )  # [B, Q, G, cL]
    Ci = Xi[:, None] * s_scr_r[None] - Xr[:, None] * s_scr_i[None]
    P = B * Q
    Cr = Cr.reshape(P, G, c_last)
    Ci = Ci.reshape(P, G, c_last)
    if P % 2:
        Cr = jnp.pad(Cr, ((0, 1), (0, 0), (0, 0)))
        Ci = jnp.pad(Ci, ((0, 1), (0, 0), (0, 0)))
    Vr = Cr[0::2] - Ci[1::2]
    Vi = Ci[0::2] + Cr[1::2]
    yr, yi = icfft_scrambled_parts(Vr, Vi, factors, precision)  # [P/2, n]
    c = jnp.stack([yr[..., :valid_max], yi[..., :valid_max]], axis=1)
    return c.reshape(-1, valid_max)[:P].reshape(B, Q, valid_max)
