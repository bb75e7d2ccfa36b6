"""The snippet matcher: overlap-save chunked scan + global peak dedup.

Device redesign of the reference's ``calc_chunks`` hot path
(reference src/matcher/audio_matcher.rs:88-141): instead of a rayon thread
pool pulling overlapping windows off a lazy decoder iterator and running one
rFFT per chunk, the flat episode is staged into HBM once and the whole scan
runs as ONE jitted device program (``lax.map`` over window slabs: in-HBM
``dynamic_slice`` windowing → batched rFFT → conj-multiply → irFFT →
on-device peak picking), with a single tiny candidate readback. Batches of
episodes compile into a single program as well (``match_staged_batch``).

Preserved reference semantics (SURVEY.md §2 "correctness-critical"):
  * window = chunk + overlap, hop = chunk, overlap = snippet duration × sr
    (audio_matcher.rs:99-105); short tail windows are processed with their
    true length, windows shorter than the snippet yield nothing.
  * Valid-mode correlation, peak positions rebased by chunk_size·chunk_index
    (audio_matcher.rs:119,126 + lib.rs:8-10).
  * per-chunk peak picking with min_prominence = CLI value / 100
    (audio_matcher.rs:44) and min_distance = whole-seconds(distance) × sr
    (audio_matcher.rs:228 — note the deliberate seconds truncation).
  * prominence is window-local; cross-chunk dedup is the sort + "overshadow"
    pass: a peak is dropped iff an immediate neighbour (in position order)
    lies within `distance` and has strictly greater prominence
    (audio_matcher.rs:133-160).
"""

from __future__ import annotations

import dataclasses
import logging
from functools import partial
from typing import Callable, Sequence  # noqa: F401

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.correlate import (
    PreparedSnippet,
    fft_length,
    fft_rows,
    prepare_snippet,
)
from ..ops.peaks import (
    Peak,
    peaks_crop_width,
    pick_peaks_batch,
    pick_peaks_dispatch,
)

log = logging.getLogger("audio_matcher.matcher")

DEFAULT_CHUNK_SECS = 60.0  # parity: matcher/args.rs:68-72
DEFAULT_DISTANCE_SECS = 8 * 60.0  # parity: matcher/args.rs:73-77
DEFAULT_PROMINENCE = 13.0  # parity: matcher/args.rs:16-22


@dataclasses.dataclass(frozen=True)
class MatchConfig:
    """Parity with ``Config``/``PeakConfig`` (audio_matcher.rs:24-53) plus
    device batching knobs."""

    chunk_secs: float = DEFAULT_CHUNK_SECS
    distance_secs: float = DEFAULT_DISTANCE_SECS
    prominence: float = DEFAULT_PROMINENCE  # CLI units; /100 applied internally
    overlap_secs: float | None = None  # None → snippet duration
    # device batching
    slab: int = 8  # windows per device dispatch (the preferred/maximum)
    # shrink the slab when the episode's window count would pad >25%
    # at `slab` (pick_slab) — padded windows are full-price compute and
    # wire bytes. Explicit-slab A/Bs (BENCH_SLAB) set this False.
    slab_auto: bool = True
    block: int = 2048  # prominence pyramid block size
    max_peaks_per_chunk: int = 64  # cap on distance-suppression rounds
    # wire format for episode staging:
    #  "float32" — exact
    #  "int16"   — half the bytes; the source's 16-bit grid (max sample
    #              error 0.5/65535 ≈ 7.6e-6 of full scale)
    #  "mulaw8"  — quarter the bytes; μ-law companded 8-bit (LOSSY:
    #              ~38 dB SNR; match positions stay sample-exact for real
    #              matches, scores shift ~1%)
    transfer_dtype: str = "float32"
    # True: `prominence` is an absolute threshold on (possibly unscaled)
    # correlation values, like the reference's direct PeakConfig
    # construction (audio_matcher.rs:566-568); False: CLI convention /100
    prominence_is_raw: bool = False
    # correlation FFT implementation (ops/impls.py resolves "auto"):
    #  "xla" — jnp.fft rfft/irfft (cuFFT on the GPU); the test oracle
    #  "xla_packed" — XLA FFTs with pair packing: two real correlations
    #          per complex inverse transform (query pairs multi-query,
    #          window pairs single-query); ~1e-6 score difference,
    #          identical peaks, ~0.6x the FFT work of "xla"
    #  "mxu" — matmul four-step FFT with the same packing
    #          (ops/mxu_fft.py), at HIGHEST precision
    fft_impl: str = "xla"
    # peak-pick implementation: "jnp" (multi-pass, ops/peaks.py) or
    # "pallas" (single device-memory pass + block-array rounds through
    # the Triton kernel, identical results)
    peaks_impl: str = "jnp"
    # cross-rate resampling: "auto" (device polyphase when an accelerator
    # is attached, scipy otherwise), "device", or "scipy"
    resample_impl: str = "auto"
    # live progress: slabs per device dispatch when a progress callback is
    # present (SURVEY §2.16 two-phase semantics — the bar advances with
    # real device completion). Each dispatch pays one launch and one
    # readback; the no-callback regime is a single dispatch
    progress_slabs_per_dispatch: int = 4

    @property
    def min_prominence(self) -> float:
        if self.prominence_is_raw:
            return self.prominence
        return self.prominence / 100.0


_I16_SCALE = np.float32(65535.0)
_WIRE_DTYPES = {
    "float32": np.float32,
    "int16": np.int16,
    "mulaw8": np.uint8,
}

# μ-law (μ=255) companding over the reference's ±0.5 full-scale PCM range
_MU = 255.0
_ULAW_ENC_LUT = None  # uint16 VIEW of the int16 wire value → uint8
_ULAW_DEC_TABLE = None  # uint8 → f32 (reference PCM scale)


def _ulaw_tables():
    global _ULAW_ENC_LUT, _ULAW_DEC_TABLE
    if _ULAW_ENC_LUT is None:
        w = np.arange(-32768, 32768, dtype=np.float64) / 32768.0
        f = np.sign(w) * np.log1p(_MU * np.abs(w)) / np.log1p(_MU)
        enc_by_value = np.clip(
            np.round((f + 1.0) * 127.5), 0, 255
        ).astype(np.uint8)
        # indexed by the UINT16 VIEW of the int16 wire (two's complement:
        # v>=0 → v, v<0 → v+65536), so the hot encode is a single gather
        # with no int32 temporary and no +32768 pass (~6 bytes/sample of
        # host memory traffic less on the single-pair staging path)
        _ULAW_ENC_LUT = np.roll(enc_by_value, -32768)
        b = np.arange(256, dtype=np.float64) / 127.5 - 1.0
        u = np.sign(b) * (np.expm1(np.abs(b) * np.log1p(_MU))) / _MU
        # wire grid value/65535 semantics: u spans ±1 of the ±32768 range
        _ULAW_DEC_TABLE = (u * 32768.0 / 65535.0).astype(np.float32)
    return _ULAW_ENC_LUT, _ULAW_DEC_TABLE


def quantize_wire(samples: np.ndarray, transfer_dtype: str) -> np.ndarray:
    """Encode f32 reference-scale PCM (or int16 wire) to the staging dtype."""
    samples = np.asarray(samples)
    if transfer_dtype == "float32":
        if samples.dtype == np.int16:  # wire grid → reference PCM scale
            return samples.astype(np.float32) / _I16_SCALE
        return samples.astype(np.float32)
    if samples.dtype == np.int16:
        wire = samples
    else:
        wire = np.clip(
            np.round(samples.astype(np.float32) * _I16_SCALE), -32768, 32767
        ).astype(np.int16)
    if transfer_dtype == "int16":
        return wire
    if transfer_dtype == "mulaw8":
        enc, _ = _ulaw_tables()
        return enc[np.ascontiguousarray(wire).view(np.uint16)]
    raise ValueError(f"unknown transfer_dtype {transfer_dtype!r}")


def wire_silence(transfer_dtype: str) -> int:
    """Wire value encoding silence: 0 for float32/int16, but mu-law's
    code 0 decodes to ~-0.5 full scale — its zero is code 128."""
    return 128 if transfer_dtype == "mulaw8" else 0


def wire_buffer(shape, transfer_dtype: str) -> np.ndarray:
    """Host staging buffer pre-filled with the wire encoding of silence."""
    dtype = _WIRE_DTYPES[transfer_dtype]
    fill = wire_silence(transfer_dtype)
    if fill == 0:
        return np.zeros(shape, dtype)
    return np.full(shape, fill, dtype)


def wire_buffer_uninit(shape, transfer_dtype: str) -> np.ndarray:
    """Host staging buffer for callers that overwrite the data region and
    silence-fill only the pad TAIL themselves. For the zero-silence wires
    (float32/int16) this is still ``np.zeros`` — calloc's untouched pages
    cost nothing and stay lazily zero, which beats an explicit tail
    write. For mulaw8 (silence code 128) it is ``np.empty``: the full
    ``np.full`` pass the caller's overwrite would waste is skipped, but
    the caller MUST fill every element beyond its data."""
    dtype = _WIRE_DTYPES[transfer_dtype]
    if wire_silence(transfer_dtype) == 0:
        return np.zeros(shape, dtype)
    return np.empty(shape, dtype)


class StagingArena:
    """Reusable host staging buffers for a group-by-group sweep.

    A fresh ``wire_buffer`` per group costs a zeroed allocation of the full
    group bytes (page-fault-bound); the arena instead
    keeps one buffer per (rows, width) shape and re-silences only the
    stale span each row's previous episode wrote beyond the new one.

    Single-flight semantics: rows are overwritten on the next ``get`` for
    the same shape, so a staged device array must be consumed before the
    next group stages. ``sweep_archive``'s stage→scan→stage loop satisfies
    this; the default (arena-less) ``stage_resident`` stays copy-fresh.
    """

    def __init__(self, transfer_dtype: str):
        self.transfer = transfer_dtype
        # single slot: one live (shape → buffer); a new shape evicts the
        # old buffer, so archives with varied episode lengths re-allocate
        # instead of accumulating one pinned buffer per length bucket
        self._key = None
        self._buf = None
        self._fill: list = []

    def get(self, rows: int, width: int) -> np.ndarray:
        key = (rows, width)
        if key != self._key:
            self._key = key
            self._buf = wire_buffer(key, self.transfer)
            self._fill = [0] * rows
        return self._buf

    def write_row(self, rows: int, width: int, i: int, wire: np.ndarray):
        """Copy one episode's wire samples into row ``i``, silencing only
        the stale tail left by the previous occupant."""
        assert self._key == (rows, width), "get() the shape before writing"
        n = len(wire)
        self._buf[i, :n] = wire
        if self._fill[i] > n:
            self._buf[i, n : self._fill[i]] = wire_silence(self.transfer)
        self._fill[i] = n


def dequantize_on_device(episode: jax.Array) -> jax.Array:
    """Device-side inverse of :func:`quantize_wire` (dtype-dispatched).

    μ-law expands arithmetically rather than via a 256-entry LUT gather
    over the whole episode (ops/wire.py).
    """
    from ..ops.wire import dequant_to_f32

    return dequant_to_f32(episode)


def pad_wire_on_device(episode: jax.Array, target: int) -> jax.Array:
    """Pad a staged wire episode to ``target`` samples with SILENCE.

    For int16/float32 wires silence is 0, but the mu-law code 0 decodes
    to ~-0.5 full scale — padding uint8 with zeros would leave a large DC
    step in the pad region. Valid-lag cropping (``valid = win_len - m + 1``)
    means no correlation lag ever touches pad samples, but debug dumps or
    future consumers reading past ``win_len`` should still see silence,
    so uint8 pads with 128 (the mu-law encoding of 0).
    """
    if episode.shape[0] >= target:
        return episode
    pad = (0, target - episode.shape[0])
    if episode.dtype == jnp.uint8:
        return jnp.pad(episode, pad, constant_values=128)
    return jnp.pad(episode, pad)


def window_rows(window: int, chunk: int) -> int:
    """Chunk-rows spanned by one overlap-save window (staging pads the
    episode to whole chunk rows so windows build from static slices)."""
    return -(-window // chunk)


def pick_slab(
    n_windows: int, preferred: int, max_waste: float = 0.25
) -> int:
    """Windows-per-dispatch for an ``n_windows``-row episode.

    The window count pads to a slab multiple, and padded windows are
    full-price compute AND wire bytes: a 10-minute episode's 10 windows
    pad to 16 at slab 8 — 60% waste. When the preferred slab would waste
    more than ``max_waste`` of the real windows, pick the slab in
    [4, preferred) minimizing the padded count (ties → larger slab, fewer
    dispatches).

    Episodes of ≤ ``preferred`` windows keep the preferred slab: the
    absolute waste is small and test/short-clip shapes stay shared
    (compiled programs are bucketed by (slab, n_slabs); CLAUDE.md).
    Deterministic in ``n_windows`` alone, so staging and scanning
    recompute the same value from the same episode length.

    Compile-count trade-off: adapting adds at most a handful of
    (slab, n_slabs) classes beyond the preferred-multiples grid (only
    window counts with >25% waste adapt, i.e. n < 3.5·preferred), each
    a one-time compile per process (kept across processes by the
    persistent compilation cache, utils/runtime.py); the padded-window
    saving recurs per scan.
    ``slab_auto=False`` restores the preferred-multiples-only grid.
    """
    if n_windows <= preferred or preferred <= 4:
        return preferred
    best_s = preferred
    best_pad = -(-n_windows // preferred) * preferred
    if best_pad - n_windows <= max_waste * n_windows:
        return preferred
    for s in range(preferred - 1, 3, -1):
        p = -(-n_windows // s) * s
        if p < best_pad:
            best_s, best_pad = s, p
    return best_s


def _divisor_slab(n_windows_pad: int, preferred: int) -> int:
    """Fallback for buffers staged elsewhere: the largest slab ≤
    ``preferred`` that tiles the padded window count exactly."""
    for s in range(min(preferred, n_windows_pad), 0, -1):
        if n_windows_pad % s == 0:
            return s
    return 1


def effective_slab(cfg, n_windows: int) -> int:
    """:func:`pick_slab` under the config's ``slab_auto`` policy — the
    ONE dispatch point shared by the matcher and the sweep scanners so
    staging and scanning can never disagree."""
    if not getattr(cfg, "slab_auto", True):
        return cfg.slab
    return pick_slab(n_windows, cfg.slab)


def put_bytes_cap() -> int:
    """Max bytes per host→device transfer (``AUDIO_MATCHER_PUT_BYTES``,
    default 768 MB); larger staging buffers go up as equal pieces.
    Whether splitting helps on a PCIe-attached GPU is an open
    measurement (ROADMAP). Values ≤ 0 disable splitting (every splitter
    would otherwise divide by the cap)."""
    import os

    cap = int(
        os.environ.get("AUDIO_MATCHER_PUT_BYTES", str(768 * 2**20))
    )
    return cap if cap > 0 else (1 << 62)


def stage_fence_policy() -> str:
    """How :func:`_device_put_split` paces multi-piece staging
    (``AUDIO_MATCHER_STAGE_FENCE``): ``batch`` (default) dispatches all
    pieces and lets the caller fence afterwards; ``serial`` fences each
    piece before dispatching the next (put+fence per piece). ``batch``
    is the default; ``serial`` is a measurement knob."""
    import os

    policy = os.environ.get("AUDIO_MATCHER_STAGE_FENCE", "batch")
    if policy not in ("batch", "serial"):
        raise ValueError(
            f"AUDIO_MATCHER_STAGE_FENCE must be 'batch' or 'serial', "
            f"got {policy!r}"
        )
    return policy


def _device_put_split(padded: np.ndarray):
    """``device_put`` a wire buffer, split into ≤-cap pieces when it
    exceeds :func:`put_bytes_cap`. 2-D batch buffers flatten first so
    the split is element-granular (a single row can exceed the cap);
    the match paths re-join with ONE on-device concat (+ reshape) —
    staging itself stays execution-free for stage-ahead callers.
    Piece pacing follows :func:`stage_fence_policy`.
    Returns a device array, or a tuple of flat piece arrays."""
    cap = put_bytes_cap()
    if padded.nbytes <= cap:
        return jax.device_put(padded)
    flat = padded.reshape(-1)  # view: C-contiguous staging buffers
    n_pieces = -(-padded.nbytes // cap)
    step = -(-len(flat) // n_pieces)
    serial = stage_fence_policy() == "serial"
    pieces = []
    for i in range(0, len(flat), step):
        d = jax.device_put(flat[i : i + step])
        if serial:
            # put+fence per piece: a transfer fence, not an execution
            # (the execution-free staging contract holds either way)
            d.block_until_ready()
        pieces.append(d)
    return tuple(pieces)


def _joined(episode_dev, rows: int | None = None):
    """Re-join a :func:`_device_put_split` tuple (one device concat);
    ``rows`` restores a 2-D batch layout flattened by the split."""
    if isinstance(episode_dev, tuple):
        episode_dev = jnp.concatenate(episode_dev)
        if rows is not None:
            episode_dev = episode_dev.reshape(rows, -1)
    return episode_dev


def windows_from_episode(episode, base, slab: int, chunk: int, window: int):
    """[slab, window] overlap-save windows starting at ``base·chunk``.

    Built as k static row-shifted slices of a [rows, chunk] view + one
    concat — ``vmap(dynamic_slice)`` over per-window starts would lower
    to an XLA gather instead of plain copies. Requires the staged episode
    padded to ``(n_windows_pad + k)`` whole chunks.
    """
    k = window_rows(window, chunk)
    span = jax.lax.dynamic_slice(
        episode, (base * chunk,), ((slab + k) * chunk,)
    )
    rows = span.reshape(slab + k, chunk)
    wide = jnp.concatenate(
        [rows[s : s + slab] for s in range(k)], axis=1
    )  # [slab, k·chunk]
    return wide[:, :window]


@partial(
    jax.jit,
    static_argnames=("fft_len", "valid_max", "distance", "n_peaks", "block"),
)
def _match_slab(
    windows,  # [B, W] f32
    sample_f,  # [F] complex64 — rfft of snippet at fft_len
    inv_ac,  # scalar f32 (1.0 when unscaled)
    valid_out_len,  # [B] int32
    fft_len: int,
    valid_max: int,
    distance: int,
    n_peaks: int,
    block: int,
):
    """One fused device step: correlate a slab of windows and pick peaks."""
    x = fft_rows("rfft", windows, fft_len)
    c = fft_rows("irfft", x * jnp.conj(sample_f), fft_len)[..., :valid_max]
    c = c * inv_ac
    return pick_peaks_batch(
        c, valid_out_len, distance=distance, n_peaks=n_peaks, block=block
    )


def _corr_windows(windows, sample_f, fft_len: int, valid_max: int,
                  fft_impl: str):
    """[B, W] windows × one query → [B, valid_max] correlations.

    ``sample_f`` is the rfft spectrum [F] for "xla", or the full-length
    split spectra tuple ((1, n) Sr, (1, n) Si) for "mxu" (matmul FFT with
    window-pair packing, ops/mxu_fft.py).
    """
    if fft_impl == "mxu":
        from ..ops.mxu_fft import corr_slab_mxu

        return corr_slab_mxu(windows, sample_f[0], sample_f[1], valid_max)[
            :, 0, :
        ]
    if fft_impl == "xla_packed":
        from ..ops.correlate import corr_single_query_packed

        return corr_single_query_packed(windows, sample_f, valid_max)
    x = fft_rows("rfft", windows, fft_len)
    return fft_rows("irfft", x * jnp.conj(sample_f), fft_len)[..., :valid_max]


@partial(
    jax.jit,
    static_argnames=(
        "chunk", "window", "m", "fft_len", "valid_max",
        "distance", "n_peaks", "block", "slab", "n_slabs", "fft_impl",
        "peaks_impl",
    ),
)
def _match_episode_resident(
    episode,
    n,
    sample_f,
    inv_ac,
    chunk: int,
    window: int,
    m: int,
    fft_len: int,
    valid_max: int,
    distance: int,
    n_peaks: int,
    block: int,
    slab: int,
    n_slabs: int,
    fft_impl: str = "xla",
    peaks_impl: str = "jnp",
    base0=0,
):
    """Whole-episode scan as ONE device program: ``lax.map`` over slabs.

    A single dispatch + single readback — per-call launch and readback
    latency is paid once per episode instead of once per slab.
    ``episode`` may be int16 (the staging wire format); it is rescaled to
    the reference's PCM grid on device. Returns (pos, height, prom) each
    [n_slabs*slab, n_peaks].

    ``base0`` (traced scalar, chunk-row units) offsets the scanned slab
    range — the live-progress path dispatches the same program per slab
    GROUP without recompiling per group position; the caller must have
    padded ``episode`` to cover ``base0 + n_slabs·slab + k_rows`` rows.
    """
    # pad to whole chunk rows ON DEVICE (one cheap device copy of the wire
    # array) so windows build from static row slices; uploading the pad
    # instead would cost host→device bytes on every staging
    k_rows = window_rows(window, chunk)
    target = (n_slabs * slab + k_rows) * chunk
    episode = dequantize_on_device(pad_wire_on_device(episode, target))
    crop = min(peaks_crop_width(valid_max, block, peaks_impl), fft_len)

    def body(base):
        starts = (base + jnp.arange(slab, dtype=jnp.int32)) * chunk
        windows = windows_from_episode(episode, base, slab, chunk, window)
        win_len = jnp.clip(n - starts, 0, window)
        valid = jnp.maximum(win_len - m + 1, 0).astype(jnp.int32)
        c = _corr_windows(windows, sample_f, fft_len, crop, fft_impl)
        c = c * inv_ac
        return pick_peaks_dispatch(
            c, valid, distance, n_peaks, block, peaks_impl
        )

    bases = jnp.arange(n_slabs, dtype=jnp.int32) * slab + jnp.int32(base0)
    pos, h, prom = jax.lax.map(body, bases)
    flat = n_slabs * slab
    return (
        pos.reshape(flat, n_peaks),
        h.reshape(flat, n_peaks),
        prom.reshape(flat, n_peaks),
    )


@partial(
    jax.jit,
    static_argnames=(
        "chunk", "window", "m", "fft_len", "valid_max",
        "distance", "n_peaks", "block", "slab", "n_slabs", "fft_impl",
        "peaks_impl",
    ),
)
def _match_batch_resident(
    episodes,  # [E, Npad] f32 or int16
    ns,  # [E] int32
    sample_f,
    inv_ac,
    chunk: int,
    window: int,
    m: int,
    fft_len: int,
    valid_max: int,
    distance: int,
    n_peaks: int,
    block: int,
    slab: int,
    n_slabs: int,
    fft_impl: str = "xla",
    peaks_impl: str = "jnp",
):
    """Whole BATCH of episodes as one program: one dispatch + one readback
    for E episodes (the batch-scan regime, BASELINE config #3/#5)."""

    def per_episode(args):
        episode, n = args
        return _match_episode_resident.__wrapped__(
            episode, n, sample_f, inv_ac,
            chunk=chunk, window=window, m=m, fft_len=fft_len,
            valid_max=valid_max, distance=distance, n_peaks=n_peaks,
            block=block, slab=slab, n_slabs=n_slabs, fft_impl=fft_impl,
            peaks_impl=peaks_impl,
        )

    return jax.lax.map(per_episode, (episodes, ns))


def overshadow_filter(
    peaks: Sequence[Peak], sr: int, distance_secs: float
) -> list[Peak]:
    """Drop peaks overshadowed by a strictly-more-prominent original
    neighbour within ``distance``. Parity: audio_matcher.rs:136-160.

    Exact-position duplicates collapse first (keep the most prominent):
    the overlap-save seam sample sits in TWO adjacent windows' emittable
    interiors, and their prominences tie bit-exactly — the
    strictly-greater rule alone would keep both copies."""
    best: dict[int, Peak] = {}
    for p in peaks:
        q = best.get(p.position)
        if q is None or p.prominence > q.prominence:
            best[p.position] = p
    peaks = sorted(best.values(), key=lambda p: p.position)
    out = []
    for i, p in enumerate(peaks):
        shadowed = False
        for j in (i - 1, i + 1):
            if 0 <= j < len(peaks):
                q = peaks[j]
                if (
                    abs(p.position - q.position) / sr < distance_secs
                    and q.prominence > p.prominence
                ):
                    shadowed = True
        if not shadowed:
            out.append(p)
    return out


class SnippetMatcher:
    """Pre-plans device programs for one snippet; reusable across episodes.

    Role parity: ``LibConvolve`` + ``calc_chunks`` (the algo object is built
    once per snippet and reused for every ``within`` file,
    matcher/mod.rs:34,81).
    """

    def __init__(
        self,
        snippet: np.ndarray,
        sr: int,
        config: MatchConfig | None = None,
    ):
        self.sr = int(sr)
        self.config = config or MatchConfig()
        self.snippet: PreparedSnippet = prepare_snippet(snippet)
        cfg = self.config
        overlap_secs = (
            cfg.overlap_secs
            if cfg.overlap_secs is not None
            else self.snippet.m / self.sr
        )
        # +2 safety samples: a peak on the exact hop boundary would otherwise
        # sit on the excluded edge column of BOTH adjacent windows (latent
        # edge case in the reference's chunk+overlap decomposition, where
        # window-edge samples can never be local maxima). Positions, scores
        # and hop are unchanged.
        self.overlap = int(round(overlap_secs * self.sr)) + 2
        self.chunk = int(round(cfg.chunk_secs * self.sr))
        if self.chunk + self.overlap < self.snippet.m:
            # A window shorter than the snippet has a 1-sample valid range
            # and can never emit a local maximum — raise the overlap so the
            # valid range covers the full hop plus the snippet. Keeps the
            # window-chunk == overlap invariant that staging relies on.
            log.warning(
                "chunk+overlap (%d samples) < snippet length (%d); raising "
                "overlap to the snippet length so matches stay findable",
                self.chunk + self.overlap, self.snippet.m,
            )
            self.overlap = self.snippet.m + 2
        self.window = self.chunk + self.overlap
        self.valid = self.window - self.snippet.m + 1
        self.fft_len = fft_length(self.window + self.snippet.m - 1)
        self.fft_impl = cfg.fft_impl
        # whole-second truncation parity (audio_matcher.rs:228)
        self.distance_samples = int(cfg.distance_secs) * self.sr
        per_chunk = self.valid // max(self.distance_samples, 1) + 2
        self.n_peaks = min(per_chunk, cfg.max_peaks_per_chunk)
        if per_chunk > cfg.max_peaks_per_chunk:
            log.warning(
                "distance %.1fs allows %d peaks/chunk; capping at %d",
                cfg.distance_secs, per_chunk, cfg.max_peaks_per_chunk,
            )
        # computed lazily: construction stays free of device execution, so
        # staging a batch of episodes never waits behind a compile
        self._sample_f_cache: jax.Array | None = None

    @property
    def _sample_f(self):
        if self._sample_f_cache is None:
            if self.fft_impl == "mxu":
                from ..ops.mxu_fft import scrambled_spectra_parts

                self._sample_f_cache = jax.jit(
                    scrambled_spectra_parts, static_argnames=("n",)
                )(self.snippet.data[None, :], self.fft_len)
            elif self.fft_impl == "xla_packed":
                from ..ops.correlate import full_spectrum

                self._sample_f_cache = jnp.conj(
                    full_spectrum(
                        jnp.fft.rfft(
                            jnp.asarray(self.snippet.data), n=self.fft_len
                        ),
                        self.fft_len,
                    )
                )
            else:
                self._sample_f_cache = jnp.fft.rfft(
                    jnp.asarray(self.snippet.data), n=self.fft_len
                )
        return self._sample_f_cache

    def _effective_slab(self, n_windows: int) -> int:
        return effective_slab(self.config, n_windows)

    def stage(
        self, samples: np.ndarray, n_samples: int | None = None
    ) -> tuple[jax.Array | tuple[jax.Array, ...], int]:
        """Pad/bucket an episode and transfer it to device HBM.

        Staging is split from :meth:`match_staged` so callers can upload a
        whole batch of episodes before the first program execution and time
        the two apart. ``stage`` performs no device computation. ``samples`` may be reference-scale f32 or int16 wire
        values (e.g. straight from ``read_audio_int16``).

        The device handle is an OPAQUE value for :meth:`match_staged`:
        episodes over ``AUDIO_MATCHER_PUT_BYTES`` stage as a tuple of
        piece arrays (re-joined on device at match time), not one array.
        """
        samples = np.ascontiguousarray(samples)
        if n_samples is not None:
            if n_samples <= len(samples):
                samples = samples[:n_samples]
            else:
                samples = np.concatenate(
                    [samples,
                     np.zeros(n_samples - len(samples), samples.dtype)]
                )
        n = len(samples)
        # bucket the padded window count so compiled program shapes are
        # reused across similarly-sized episodes
        n_windows = max(-(-n // self.chunk), 1) if n else 1
        s = self._effective_slab(n_windows)
        n_windows_pad = -(-n_windows // s) * s
        n_pad = n_windows_pad * self.chunk + self.overlap
        wire = quantize_wire(samples, self.config.transfer_dtype)
        padded = wire_buffer_uninit(n_pad, self.config.transfer_dtype)
        padded[:n] = wire
        silence = wire_silence(self.config.transfer_dtype)
        if silence != 0:  # nonzero-silence wires get np.empty: fill the tail
            padded[n:] = silence
        return _device_put_split(padded), n

    def stage_batch(
        self, episodes: Sequence[np.ndarray]
    ) -> tuple[jax.Array | tuple[jax.Array, ...], np.ndarray]:
        """Stage several episodes as ONE device array [E, Npad] (single
        transfer; all episodes bucketed to the largest). Batches over
        ``AUDIO_MATCHER_PUT_BYTES`` stage as a tuple of flat pieces —
        an opaque handle :meth:`match_staged_batch` re-joins on device
        (element-granular split: even a single over-cap row splits)."""
        ns = np.array([len(e) for e in episodes], np.int32)
        n_max = int(ns.max()) if len(ns) else 0
        n_windows = max(-(-n_max // self.chunk), 1)
        s = self._effective_slab(n_windows)
        n_windows_pad = -(-n_windows // s) * s
        n_pad = n_windows_pad * self.chunk + self.overlap
        dtype = _WIRE_DTYPES[self.config.transfer_dtype]
        buf = wire_buffer_uninit(
            (len(episodes), n_pad), self.config.transfer_dtype
        )
        silence = wire_silence(self.config.transfer_dtype)
        fill_tail = silence != 0  # nonzero-silence wires get np.empty
        for i, ep in enumerate(episodes):
            ep = np.asarray(ep)
            if ep.dtype == dtype:
                # already on the wire format (e.g. int16 straight from the
                # native decoder) — plain pack
                buf[i, : len(ep)] = ep
            else:
                buf[i, : len(ep)] = quantize_wire(
                    ep, self.config.transfer_dtype
                )
            if fill_tail:
                buf[i, len(ep):] = silence
        return _device_put_split(buf), ns

    def match(
        self,
        samples: np.ndarray,
        scale: bool = True,
        n_samples: int | None = None,
        progress: Callable[[str, int], None] | None = None,
    ) -> list[Peak]:
        """Scan an episode; returns deduped peaks sorted by position.

        ``n_samples`` resizes the stream (truncate / zero-extend) like the
        reference's duration-estimate ``with_size`` (matcher/mod.rs:78-81).
        ``progress`` receives ("start"|"finish", chunk_index) callbacks —
        the 2-phase per-chunk reporting of SURVEY.md §2.16.
        """
        staged = self.stage(samples, n_samples)
        return self.match_staged(staged, scale=scale, progress=progress)

    def _extract_peaks(
        self, pos, h, prom, n_windows: int, progress=None
    ) -> list[Peak]:
        cfg = self.config
        candidates: list[Peak] = []
        for k in range(n_windows):
            for s in range(pos.shape[1]):
                if np.isfinite(h[k, s]) and prom[k, s] >= cfg.min_prominence:
                    candidates.append(
                        Peak(
                            position=int(pos[k, s]) + self.chunk * k,
                            height=float(h[k, s]),
                            prominence=float(prom[k, s]),
                        )
                    )
            if progress:
                progress("finish", k)
        return overshadow_filter(candidates, self.sr, cfg.distance_secs)

    def match_staged(
        self,
        staged: tuple[jax.Array, int],
        scale: bool = True,
        progress: Callable[[str, int], None] | None = None,
    ) -> list[Peak]:
        """Scan an episode previously uploaded with :meth:`stage`."""
        episode_dev, n = staged
        if n == 0:
            return []
        episode_dev = _joined(episode_dev)
        cfg = self.config
        n_windows = max(-(-n // self.chunk), 1)
        n_windows_pad = (episode_dev.shape[0] - self.overlap) // self.chunk
        B = self._effective_slab(n_windows)
        if n_windows_pad % B:  # buffer staged under a different policy
            B = _divisor_slab(n_windows_pad, cfg.slab)
        inv_ac = np.float32(self.snippet.inv_autocorr if scale else 1.0)

        n_slabs = n_windows_pad // B
        if progress and n_slabs > 1 and cfg.progress_slabs_per_dispatch > 0:
            return self._match_staged_live(
                episode_dev, n, inv_ac, n_windows, n_slabs, B, progress
            )
        if progress:
            for k in range(n_windows):
                progress("start", k)
        pos, h, prom = _match_episode_resident(
            episode_dev,
            np.int32(n),
            self._sample_f,
            inv_ac,
            chunk=self.chunk,
            window=self.window,
            m=self.snippet.m,
            fft_len=self.fft_len,
            valid_max=self.valid,
            distance=self.distance_samples,
            n_peaks=self.n_peaks,
            block=cfg.block,
            slab=B,
            n_slabs=n_windows_pad // B,
            fft_impl=self.fft_impl,
            peaks_impl=cfg.peaks_impl,
        )
        # one pytree fetch: device_get starts every copy async before
        # blocking, so the readback round trip is paid once, not three times
        pos, h, prom = jax.device_get((pos, h, prom))
        return self._extract_peaks(pos, h, prom, n_windows, progress)

    def _match_staged_live(
        self, episode_dev, n: int, inv_ac, n_windows: int, n_slabs: int,
        B: int, progress: Callable[[str, int], None],
    ) -> list[Peak]:
        """Groupwise dispatch driving HONEST two-phase progress: each
        group of ``progress_slabs_per_dispatch`` slabs is one device
        program; its windows' "start" fires at dispatch and "finish" at
        readback, so the bar tracks real device completion.
        Identical results to the single-dispatch path (same compiled body,
        offset by a traced ``base0``; equality test in test_matcher)."""
        cfg = self.config
        g = cfg.progress_slabs_per_dispatch
        k_rows = window_rows(self.window, self.chunk)
        # pre-pad once so every group's in-program slicing stays in range
        episode_dev = pad_wire_on_device(
            episode_dev, (n_slabs * B + k_rows) * self.chunk
        )
        # the program dequantizes its input — doing it once here keeps
        # each per-group dispatch from re-expanding the WHOLE episode to
        # f32 (ceil(n_slabs/g) redundant passes)
        episode_dev = dequantize_on_device(episode_dev)
        common = dict(
            chunk=self.chunk, window=self.window, m=self.snippet.m,
            fft_len=self.fft_len, valid_max=self.valid,
            distance=self.distance_samples, n_peaks=self.n_peaks,
            block=cfg.block, slab=B, fft_impl=self.fft_impl,
            peaks_impl=cfg.peaks_impl,
        )
        parts = []
        for a in range(0, n_slabs, g):
            gg = min(g, n_slabs - a)
            w_lo, w_hi = a * B, min((a + gg) * B, n_windows)
            for k in range(w_lo, w_hi):
                progress("start", k)
            out = _match_episode_resident(
                episode_dev, np.int32(n), self._sample_f, inv_ac,
                n_slabs=gg, base0=np.int32(a * B), **common,
            )
            parts.append(tuple(jax.device_get(out)))  # one async readback
            for k in range(w_lo, w_hi):
                progress("finish", k)
        pos = np.concatenate([p[0] for p in parts])
        h = np.concatenate([p[1] for p in parts])
        prom = np.concatenate([p[2] for p in parts])
        return self._extract_peaks(pos, h, prom, n_windows)

    def match_staged_batch(
        self,
        staged: tuple[jax.Array, np.ndarray],
        scale: bool = True,
    ) -> list[list[Peak]]:
        """Scan a :meth:`stage_batch` upload: ONE device program for the
        whole episode batch (one dispatch, one readback)."""
        episodes_dev, ns = _joined(staged[0], rows=len(staged[1])), staged[1]
        cfg = self.config
        n_windows_pad = (episodes_dev.shape[1] - self.overlap) // self.chunk
        n_max = int(ns.max()) if len(ns) else 0
        B = self._effective_slab(max(-(-n_max // self.chunk), 1))
        if n_windows_pad % B:  # buffer staged under a different policy
            B = _divisor_slab(n_windows_pad, cfg.slab)
        inv_ac = np.float32(self.snippet.inv_autocorr if scale else 1.0)
        pos, h, prom = _match_batch_resident(
            episodes_dev,
            jnp.asarray(ns, jnp.int32),
            self._sample_f,
            inv_ac,
            chunk=self.chunk,
            window=self.window,
            m=self.snippet.m,
            fft_len=self.fft_len,
            valid_max=self.valid,
            distance=self.distance_samples,
            n_peaks=self.n_peaks,
            block=cfg.block,
            slab=B,
            n_slabs=n_windows_pad // B,
            fft_impl=self.fft_impl,
            peaks_impl=cfg.peaks_impl,
        )
        pos, h, prom = jax.device_get((pos, h, prom))
        out = []
        for e in range(len(ns)):
            n_windows = max(-(-int(ns[e]) // self.chunk), 1)
            out.append(
                self._extract_peaks(pos[e], h[e], prom[e], n_windows)
            )
        return out


def calc_chunks(
    sr: int,
    samples: np.ndarray,
    snippet: np.ndarray,
    scale: bool = True,
    config: MatchConfig | None = None,
    n_samples: int | None = None,
    progress: Callable[[str, int], None] | None = None,
) -> list[Peak]:
    """Functional entry point mirroring ``calc_chunks``
    (audio_matcher.rs:88-141)."""
    return SnippetMatcher(snippet, sr, config).match(
        samples, scale=scale, n_samples=n_samples, progress=progress
    )
