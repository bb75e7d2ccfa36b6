"""Host decode frontend: media files → f32 mono PCM numpy arrays.

Parity: reference src/matcher/mp3_reader.rs ``read_mp3`` (mono downmix
``(l+r)*0.5*PCM_FACTOR``, ``PCM_FACTOR = 1/(2^16-1)``, constant-sample-rate
assertion) — here backed by the C++ runtime ``_am_native.so`` (mpg123/opus
via dlopen, see native/am_native.cpp) with a pure-Python WAV path so the
framework degrades gracefully without the native lib. Opus decoding is a
capability the reference *lacks* (it only tags opus) — SURVEY.md §2.18.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading
import wave
from pathlib import Path

import numpy as np

log = logging.getLogger("audio_matcher.decode")

PCM_FACTOR = np.float32(1.0 / ((1 << 16) - 1))  # parity: mp3_reader.rs:12

_NATIVE_PATH = Path(__file__).parent / "_am_native.so"
_SRC_PATH = Path(__file__).parent.parent.parent / "native" / "am_native.cpp"


class DecodeError(RuntimeError):
    pass


def _build_native() -> bool:
    if not _SRC_PATH.exists():
        return False
    # build to a temp name + atomic rename: concurrent processes (the
    # prefetch pool spans threads, sweeps span processes) must never
    # CDLL a half-written .so
    tmp = _NATIVE_PATH.with_suffix(f".tmp{os.getpid()}.so")
    try:
        subprocess.run(
            [
                "g++", "-O2", "-std=c++17", "-shared", "-fPIC",
                "-o", str(tmp), str(_SRC_PATH), "-ldl",
            ],
            check=True, capture_output=True, timeout=120,
        )
        os.replace(tmp, _NATIVE_PATH)
        return True
    except Exception as exc:  # pragma: no cover - depends on toolchain
        log.warning("couldn't build native decoder: %s", exc)
        try:
            tmp.unlink()
        except OSError:
            pass
        return False


_lib = None
_lib_lock = threading.Lock()


def _native():
    """Load (building on first use) the C++ host-IO runtime, or None.
    Thread-safe: the prefetch pool's workers race here on first use."""
    global _lib
    if _lib is not None:
        return _lib or None
    with _lib_lock:
        if _lib is not None:
            return _lib or None
        return _native_locked()


def _native_locked():
    global _lib
    if not _NATIVE_PATH.exists() and not _build_native():
        _lib = False
        return None
    try:
        lib = ctypes.CDLL(str(_NATIVE_PATH))
    except OSError as exc:  # pragma: no cover
        log.warning("couldn't load native decoder: %s", exc)
        _lib = False
        return None
    lib.am_last_error.restype = ctypes.c_char_p
    for fn in ("am_decode_mp3", "am_decode_opus"):
        getattr(lib, fn).argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32),
        ]
    for fn in ("am_encode_mp3", "am_encode_opus"):
        getattr(lib, fn).argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64,
            ctypes.c_int32,
        ]
    lib.am_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
    if hasattr(lib, "am_decode_mp3_i16"):
        lib.am_decode_mp3_i16.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int16)),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.am_free_i16.argtypes = [ctypes.POINTER(ctypes.c_int16)]
    if hasattr(lib, "am_mp3_duration"):
        lib.am_mp3_duration.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32),
        ]
    _lib = lib
    return lib


def native_available(what: str = "mp3") -> bool:
    lib = _native()
    if lib is None:
        return False
    probe = {
        "mp3": lib.am_has_mp3_decode,
        "opus": lib.am_has_opus,
        "mp3_encode": lib.am_has_mp3_encode,
        "mp3_duration": getattr(lib, "am_has_mp3_duration", None),
    }[what]
    if probe is None:
        return False
    return bool(probe())


def mp3_duration_probe(path: str | Path) -> float:
    """mp3 duration from a frame-header scan (native, NO decode) — the
    reference's ``mp3-duration`` crate stage (mp3_reader.rs:76) between
    the tag cache and the full-decode fallback. Raises DecodeError when
    the native runtime or the scan symbols are unavailable."""
    lib = _native()
    if lib is None or not hasattr(lib, "am_mp3_duration"):
        raise DecodeError("native mp3 duration probe unavailable")
    n = ctypes.c_int64()
    sr = ctypes.c_int32()
    rc = lib.am_mp3_duration(
        str(path).encode(), ctypes.byref(n), ctypes.byref(sr)
    )
    if rc != 0:
        raise DecodeError(lib.am_last_error().decode(errors="replace"))
    if sr.value <= 0:
        raise DecodeError(f"bad sample rate from duration probe: {sr.value}")
    return n.value / sr.value


def _native_decode(fn_name: str, path: Path) -> tuple[int, np.ndarray]:
    lib = _native()
    if lib is None:
        raise DecodeError(
            f"native decoder unavailable; can't decode {path} "
            "(build native/am_native.cpp or use .wav)"
        )
    out = ctypes.POINTER(ctypes.c_float)()
    n = ctypes.c_int64()
    sr = ctypes.c_int32()
    rc = getattr(lib, fn_name)(
        str(path).encode(), ctypes.byref(out), ctypes.byref(n), ctypes.byref(sr)
    )
    if rc != 0:
        raise DecodeError(lib.am_last_error().decode(errors="replace"))
    try:
        arr = np.ctypeslib.as_array(out, shape=(n.value,)).copy()
    finally:
        lib.am_free(out)
    return int(sr.value), arr


def read_wav(path: Path) -> tuple[int, np.ndarray]:
    """16-bit PCM WAV → mono f32 with the reference's downmix scaling."""
    with wave.open(str(path), "rb") as w:
        sr = w.getframerate()
        ch = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(w.getnframes())
    if width != 2:
        raise DecodeError(f"only 16-bit WAV supported, got {8 * width}-bit")
    data = np.frombuffer(raw, dtype="<i2").astype(np.float32)
    if ch == 2:
        mono = (data[0::2] + data[1::2]) * np.float32(0.5) * PCM_FACTOR
    elif ch == 1:
        mono = data * PCM_FACTOR
    else:
        raise DecodeError(f"unsupported channel count {ch}")
    return sr, mono


def write_wav(path: Path, sr: int, mono: np.ndarray) -> None:
    """Inverse of read_wav, duplicating mono to stereo (fixture helper)."""
    i16 = np.clip(
        np.asarray(mono, np.float32) / PCM_FACTOR, -32768, 32767
    ).astype("<i2")
    inter = np.repeat(i16, 2)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(inter.tobytes())


def read_audio(path: str | Path) -> tuple[int, np.ndarray]:
    """Decode any supported file → (sample_rate, f32 mono samples).

    Role parity with ``read_mp3`` (mp3_reader.rs:13-41), widened to opus and
    wav. The whole stream is materialized — the matcher windows it on the
    way to the device (the reference's lazy iterator exists to bound RAM in
    a streaming Rust pipeline; here the array feeds batched device slabs).
    """
    path = Path(path)
    ext = path.suffix.lower()
    if not path.exists():
        raise FileNotFoundError(f"couldn't open file at path {path}")
    if ext == ".wav":
        return read_wav(path)
    if ext == ".mp3":
        return _native_decode("am_decode_mp3", path)
    if ext in (".opus", ".ogg"):
        return _native_decode("am_decode_opus", path)
    raise DecodeError(f"unsupported audio format {ext!r} for {path}")


def encode_audio(path: str | Path, sr: int, mono: np.ndarray) -> None:
    """Encode mono f32 (reference scale) to wav/mp3/opus — fixture + test
    generator (the reference's res/local assets are private and must be
    regenerated; SURVEY.md §6)."""
    path = Path(path)
    ext = path.suffix.lower()
    if ext == ".wav":
        write_wav(path, sr, mono)
        return
    lib = _native()
    if lib is None:
        raise DecodeError("native encoder unavailable")
    data = np.ascontiguousarray(mono, np.float32)
    ptr = data.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    if ext == ".mp3":
        rc = lib.am_encode_mp3(str(path).encode(), ptr, len(data), sr)
    elif ext in (".opus", ".ogg"):
        rc = lib.am_encode_opus(str(path).encode(), ptr, len(data), sr)
    else:
        raise DecodeError(f"unsupported encode format {ext!r}")
    if rc != 0:
        raise DecodeError(lib.am_last_error().decode(errors="replace"))


def read_audio_int16(path: str | Path) -> tuple[int, np.ndarray]:
    """Decode to the mono int16 wire format ((l+r)/2 grid) for device
    staging (``MatchConfig.transfer_dtype="int16"``): the f32 reference
    scaling ×1/65535 is applied on device, so no float conversion happens
    on the host hot path."""
    path = Path(path)
    ext = path.suffix.lower()
    if ext == ".mp3":
        lib = _native()
        if lib is not None and hasattr(lib, "am_decode_mp3_i16"):
            out = ctypes.POINTER(ctypes.c_int16)()
            n = ctypes.c_int64()
            sr = ctypes.c_int32()
            rc = lib.am_decode_mp3_i16(
                str(path).encode(), ctypes.byref(out), ctypes.byref(n),
                ctypes.byref(sr),
            )
            if rc != 0:
                raise DecodeError(lib.am_last_error().decode(errors="replace"))
            try:
                arr = np.ctypeslib.as_array(out, shape=(n.value,)).copy()
            finally:
                lib.am_free_i16(out)
            return int(sr.value), arr
    if ext == ".wav":
        with wave.open(str(path), "rb") as w:
            srate = w.getframerate()
            ch = w.getnchannels()
            if w.getsampwidth() != 2:
                raise DecodeError("only 16-bit WAV supported")
            raw = w.readframes(w.getnframes())
        data = np.frombuffer(raw, dtype="<i2").astype(np.int32)
        if ch == 2:
            v = data[0::2] + data[1::2]
            # round-half-away of v/2 (matches the native decoder's grid)
            mono = (np.sign(v) * ((np.abs(v) + 1) // 2)).astype(np.int16)
        else:
            mono = data.astype(np.int16)
        return srate, mono
    # fallback: f32 decode + quantize to the grid (ONE definition of the
    # wire grid: models.matcher.quantize_wire, shared with staging)
    from ..models.matcher import quantize_wire

    srate, samples = read_audio(path)
    return srate, quantize_wire(samples, "int16")


def device_resample_available() -> bool:
    """True on a GPU (``ops.impls`` decides): the device polyphase path
    only pays off when the conv doesn't run on the host's CPU cores."""
    from ..ops.impls import platform

    return platform() == "gpu"


def resample(
    samples: np.ndarray,
    sr_from: int,
    sr_to: int,
    impl: str = "scipy",
    wire_int16: bool = False,
) -> np.ndarray:
    """Polyphase resampling (capability the reference lacks — its matcher
    errors on sample-rate mismatch, matcher/errors.rs:8-11).

    ``impl``: ``"scipy"`` (host), ``"device"`` (ops.resample — ONE dilated
    convolution on the device, scipy-equivalent filter), or ``"auto"``
    (device when an accelerator backend is attached, scipy otherwise).
    ``wire_int16``: return int16 staging-wire values instead of f32 — on
    the device path the quantization happens on-chip, halving the
    readback; downstream staging accepts int16 wire directly
    (quantize_wire / dequantize_on_device handle it for every transfer
    format).
    """
    from ..models.matcher import quantize_wire

    if impl == "auto":
        impl = "device" if device_resample_available() else "scipy"
    # int16 wire grid → reference PCM scale (one definition of the grid:
    # models.matcher.quantize_wire, shared with staging)
    samples = quantize_wire(samples, "float32")
    if impl == "device":
        # bucketed variant: one compiled conv per O(log n) length bucket
        # instead of per exact episode length (each would be a fresh
        # compile); the trim to the true output
        # length happens here after the readback
        from ..ops.resample import resample_poly_device_padded

        y, n_out = resample_poly_device_padded(
            samples, sr_from, sr_to, wire_int16
        )
        return np.asarray(y)[..., :n_out]
    if sr_from == sr_to:
        out = samples.astype(np.float32)
    else:
        import math

        import scipy.signal

        g = math.gcd(sr_from, sr_to)
        out = scipy.signal.resample_poly(
            samples.astype(np.float64), sr_to // g, sr_from // g
        ).astype(np.float32)
    if wire_int16:
        return quantize_wire(out, "int16")
    return out


def audio_duration(
    path: str | Path,
    use_parallel: bool = False,
    fallback: float | None = None,
) -> float:
    """Duration probe with tag cache (seconds).

    Parity: mp3_reader.rs:68-108 ``mp3_duration``: try the tag ``Length``
    field first, else decode and *write the result back into the file's
    tag* as a cache. ``use_parallel`` is accepted for API parity (decode
    here is native and already fast).

    ``fallback``: duration the caller already knows (e.g. derived from
    samples it just decoded) — used instead of a second decode when the
    tag cache is cold, but still written back into the tag. The reference
    decodes twice here (SURVEY §3.1 "slow pass #1"); on a 1-vCPU host we
    don't copy that wart.
    """
    del use_parallel
    path = Path(path)
    from ..meta.tagger import Length, TaggedFile

    try:
        tag = TaggedFile.from_path(path, default_empty=False)
        cached = tag.get(Length)
        if cached is not None:
            return float(cached)
    except Exception:
        tag = None
    if fallback is not None:
        duration = float(fallback)
    else:
        duration = None
        if path.suffix.lower() == ".mp3":
            # stage 2 (reference mp3_reader.rs:76, the mp3-duration crate):
            # frame-header scan, no decode
            try:
                duration = mp3_duration_probe(path)
            except DecodeError:
                duration = None
        if duration is None:
            sr, samples = read_audio(path)
            duration = len(samples) / sr
    try:
        tag = TaggedFile.from_path(path, default_empty=True)
        tag.set(Length, duration)
        tag.save_changes()
    except Exception as exc:
        log.debug("couldn't cache duration into %s: %s", path, exc)
    return duration
