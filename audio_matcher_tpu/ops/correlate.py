"""FFT cross-correlation on device (the L2 signal-engine core).

Device equivalent of the reference's ``CorrelateAlgo`` implementations
(reference src/matcher/audio_matcher.rs:65-76 trait; :282-344 ``LibConvolve``;
:379-479 ``MyConvolve``): batched real-FFT cross-correlation
``irfft(rfft(within) * conj(rfft(sample)))`` with Full/Same/Valid cropping and
optional normalization by the snippet's inverse autocorrelation so a perfect
match scores ≈ 1.0.

Design differences from the reference (deliberate):
  * FFT length is padded to a power of two ≥ n+m-1 instead of exactly n+m-1 —
    library FFTs (cuFFT) are fastest on pow2 sizes, and the matmul FFT
    (ops/mxu_fft.py) needs them. Linear
    correlation through zero-padded circular FFT is exact for any length
    ≥ n+m-1, so match offsets and scores are unchanged.
  * Whole batches of overlap-save windows go through ONE batched rfft/irfft
    instead of per-chunk FFTs on a thread pool (reference rayon par_bridge,
    audio_matcher.rs:114).
  * Normalization follows the production path (``LibConvolve``): scores are
    ``corr * inv_autocorr`` with ``inv_autocorr = 1/Σ s²`` — the value the
    reference computes lazily via a Valid-mode self-correlation
    (audio_matcher.rs:321-329). The unused ``MyConvolve`` scaling chain
    additionally divides by ``within.len()`` (audio_matcher.rs:442-448),
    which would shrink a perfect match's score to 1/n instead of 1 — an
    inconsistency between the reference's two implementations (its oracle
    test only compares them with ``scale=false``); we deliberately do NOT
    reproduce it.
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

Mode = str  # "full" | "same" | "valid"


# XLA's GPU FFT (cuFFT) returns wrong values once ONE transform call covers
# 2**31 elements or more (measured on the H100: batched irfft and ifft of
# 512 × 2**22 differ from the same rows transformed in chunks, while
# 511 × 2**22 matches exactly). Every batched transform of the scan goes
# through fft_rows, which keeps each call below that.
FFT_MAX_ELEMENTS = (1 << 31) - 1


def fft_rows(op: str, x: jax.Array, n: int) -> jax.Array:
    """``jnp.fft.<op>(x, n=n)`` over the last axis (op: fft, ifft, rfft,
    irfft), computed in leading-batch chunks of at most
    ``FFT_MAX_ELEMENTS`` elements per transform call (``lax.map`` over
    equal chunks — the largest divisor of the row count that fits)."""
    fn = getattr(jnp.fft, op)
    lead = x.shape[:-1]
    rows = math.prod(lead)
    width = max(n, x.shape[-1])  # elements per row on the wider side
    if rows * width <= FFT_MAX_ELEMENTS:
        return fn(x, n=n)
    fit = max(FFT_MAX_ELEMENTS // width, 1)
    chunk = next(d for d in range(min(fit, rows), 0, -1) if rows % d == 0)
    out = jax.lax.map(
        lambda xs: fn(xs, n=n),
        x.reshape(rows // chunk, chunk, x.shape[-1]),
    )
    return out.reshape(*lead, out.shape[-1])


def fft_length(min_len: int) -> int:
    """Smallest power of two ≥ min_len (the FFT size bucket)."""
    n = 1
    while n < min_len:
        n <<= 1
    return n


@dataclasses.dataclass(frozen=True)
class PreparedSnippet:
    """A query snippet preprocessed for repeated correlation.

    Mirrors the role of ``LibConvolve``'s lazily cached sample array +
    inverse autocorrelation (audio_matcher.rs:282-344), but precomputed
    eagerly and kept host-side; the rfft is taken per fft-length on device.
    """

    data: np.ndarray  # f32 [m]
    inv_autocorr: float  # 1 / Σ s²  (scores scale to ≈[-1, 1])

    @property
    def m(self) -> int:
        return int(self.data.shape[-1])


def prepare_snippet(sample: np.ndarray) -> PreparedSnippet:
    sample = np.asarray(sample, dtype=np.float32)
    ac = float(np.sum(sample.astype(np.float64) ** 2))
    inv = 1.0 / ac if ac != 0.0 else 0.0
    return PreparedSnippet(data=sample, inv_autocorr=inv)


@partial(jax.jit, static_argnames=("fft_len", "valid_len"))
def _corr_valid(windows, sample, fft_len: int, valid_len: int):
    x = fft_rows("rfft", windows, fft_len)
    s = fft_rows("rfft", sample, fft_len)
    c = fft_rows("irfft", x * jnp.conj(s), fft_len)
    return c[..., :valid_len]


def correlate_valid_batch(
    windows: jax.Array,
    sample: jax.Array,
    scale: float | None = None,
) -> jax.Array:
    """Valid-mode cross-correlation of a batch of windows against one snippet.

    windows: [..., n] real; sample: [m]. Returns [..., n-m+1] where output j =
    Σ_i windows[j+i]·sample[i], optionally multiplied by ``scale``
    (pass ``PreparedSnippet.inv_autocorr`` for normalized scores).
    """
    n = windows.shape[-1]
    m = sample.shape[-1]
    if n < m:
        raise ValueError(f"window ({n}) shorter than sample ({m})")
    L = fft_length(n + m - 1)
    out = _corr_valid(windows, sample, fft_len=L, valid_len=n - m + 1)
    if scale is not None:
        out = out * jnp.asarray(scale, out.dtype)
    return out


def _centered(arr: jax.Array, length: int) -> jax.Array:
    # parity: audio_matcher.rs:460-464
    start = (arr.shape[-1] - length) // 2
    return arr[..., start : start + length]


def correlate(
    within,
    sample,
    mode: Mode = "valid",
    scale: bool = False,
    use_conjugation: bool = True,
) -> jax.Array:
    """Scipy-compatible 1D cross-correlation with the reference's modes.

    Parity: ``CorrelateAlgo::correlate_with_sample`` (audio_matcher.rs:65-76)
    — Full = lags -(m-1)..n-1, Same = centered n, Valid = centered n-m+1
    (audio_matcher.rs:450-456). ``scale`` multiplies by the snippet's inverse
    autocorrelation (the production ``LibConvolve`` chain).

    ``use_conjugation=False`` selects the reference's alternative
    reverse-multiply formulation (audio_matcher.rs:422-438: correlate as a
    convolution with the time-reversed snippet, plain spectral multiply) —
    mathematically identical, kept for differential testing.
    """
    within = jnp.asarray(within, jnp.float32)
    sample = jnp.asarray(sample, jnp.float32)
    n, m = within.shape[-1], sample.shape[-1]
    L = fft_length(n + m - 1)
    x = fft_rows("rfft", within, L)
    if use_conjugation:
        s = fft_rows("rfft", sample, L)
        c = fft_rows("irfft", x * jnp.conj(s), L)
    else:
        s_rev = fft_rows("rfft", sample[..., ::-1], L)
        conv = fft_rows("irfft", x * s_rev, L)
        # convolution with the reversed snippet = correlation shifted by m-1
        c = jnp.roll(conv, -(m - 1), axis=-1)
    # circular index k holds lag k (k ≥ 0) and lag k-L (k > L-m): rotate so
    # the full output starts at lag -(m-1).
    full = jnp.roll(c, m - 1, axis=-1)[..., : n + m - 1]
    if mode == "full":
        out = full
    elif mode == "same":
        out = _centered(full, n)
    elif mode == "valid":
        # saturating_sub parity for the degenerate n < m case
        out = _centered(full, max(n - m, 0) + 1)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    if scale:
        # zero-energy (silent) snippet: match prepare_snippet's
        # inv_autocorr=0 convention instead of emitting 0/0 NaNs
        energy = jnp.sum(sample * sample)
        out = jnp.where(energy > 0, out / jnp.where(energy > 0, energy, 1.0), 0.0)
    return out


# ------------------------------------------------ packed-inverse XLA path
def full_spectrum(s_half: jax.Array, n: int) -> jax.Array:
    """Hermitian-extend an rfft spectrum [..., n//2+1] to full length n.

    Odd ``n`` has no real Nyquist bin — every bin but DC mirrors (the
    even-only slice dropped the last bin's conjugate and returned n-1
    wrong values)."""
    mid = s_half[..., 1:-1] if n % 2 == 0 else s_half[..., 1:]
    return jnp.concatenate([s_half, jnp.conj(mid[..., ::-1])], axis=-1)


def packed_query_spectra(padded_snippets: jax.Array, fft_len: int):
    """[Q, m] query snippets → [ceil(Q/2), fft_len] complex T with
    T[j] = conj(S_{2j}) + i·conj(S_{2j+1}).

    The correlation spectrum of any window against the query pair is then
    V = X_full · T[j], whose single complex inverse FFT yields BOTH real
    correlations (ifft(Ca + i·Cb) = ca + i·cb). A real inverse transform of
    length n costs about as much as a complex one of length n/2 plus a
    post-pass, so this halves the dominant inverse-FFT work with ONE
    multiply — V is linear in X, so the packing costs nothing extra.
    """
    Q = padded_snippets.shape[0]
    S = fft_rows("rfft", padded_snippets, fft_len)
    Sf = full_spectrum(S, fft_len)
    if Q % 2:
        Sf = jnp.pad(Sf, ((0, 1), (0, 0)))
    return jnp.conj(Sf[0::2]) + 1j * jnp.conj(Sf[1::2])


def corr_slab_xla_packed(
    windows: jax.Array,  # [B, W] f32
    t_spec: jax.Array,  # [Qh, n] complex — packed_query_spectra output
    valid_max: int,
) -> jax.Array:
    """All (window, query) correlations with half the inverse FFTs.

    Returns [B, 2·Qh, valid_max]; the caller slices off a padded odd query.
    """
    n = t_spec.shape[-1]
    B = windows.shape[0]
    # forward also packs window PAIRS: fft(w0 + i·w1) then a full-length
    # hermitian split (Z[-k] = Z[(n-k) mod n]) recovers both spectra —
    # halves the forward transforms on top of the halved inverses
    wp = jnp.pad(windows, ((0, B % 2), (0, 0)))
    z = fft_rows("fft", wp[0::2] + 1j * wp[1::2], n)  # [Bp/2, n]
    zrev = jnp.conj(jnp.roll(z[:, ::-1], 1, axis=1))
    x_even = 0.5 * (z + zrev)
    x_odd = -0.5j * (z - zrev)
    Xf = jnp.stack([x_even, x_odd], axis=1).reshape(-1, n)[:B]
    v = fft_rows("ifft", Xf[:, None, :] * t_spec[None], n)  # [B, Qh, n]
    c = jnp.stack(
        [jnp.real(v[..., :valid_max]), jnp.imag(v[..., :valid_max])],
        axis=2,
    )
    return c.reshape(B, -1, valid_max)


def corr_single_query_packed(
    windows: jax.Array,  # [B, W] f32
    s_full_conj: jax.Array,  # [n] complex — conj(full spectrum) of the query
    valid_max: int,
) -> jax.Array:
    """Single-query variant: WINDOW pairs pack into one complex transform
    each way (fft(w0 + i·w1) is the packed forward; the product against
    one hermitian query spectrum keeps the pair separable on inverse).
    Returns [B, valid_max].
    """
    B = windows.shape[0]
    n = s_full_conj.shape[-1]
    if B % 2:
        windows = jnp.pad(windows, ((0, 1), (0, 0)))
    z = windows[0::2] + 1j * windows[1::2]
    v = fft_rows("ifft", fft_rows("fft", z, n) * s_full_conj[None], n)
    c = jnp.stack(
        [jnp.real(v[..., :valid_max]), jnp.imag(v[..., :valid_max])], axis=1
    )
    return c.reshape(-1, valid_max)[:B]
