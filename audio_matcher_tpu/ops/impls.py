"""Which implementation runs on which platform — decided here and only here.

The program runs compiled on NVIDIA GPUs and, as the reference and test
platform, on the CPU. Every choice that depends on the machine reads
:func:`platform`:

  * ``gpu`` — Pallas kernels compile through the Triton route;
    ``auto`` picks the fastest measured implementations (PERF.md).
  * ``cpu`` — Pallas kernels run in interpret mode (tests only: ``auto``
    never picks a Pallas kernel here).
  * anything else — an error. Nothing falls back silently.
"""

from __future__ import annotations

FFT_IMPLS = ("xla", "xla_packed", "mxu")
PEAKS_IMPLS = ("jnp", "pallas")
SUPPORTED_PLATFORMS = ("gpu", "cpu")


def platform() -> str:
    """The JAX default backend, refused unless this program supports it."""
    import jax

    p = jax.default_backend()
    if p not in SUPPORTED_PLATFORMS:
        raise RuntimeError(
            f"unsupported JAX platform {p!r}: audio_matcher_tpu runs on "
            "NVIDIA GPUs (compiled) and on the CPU (reference and tests)"
        )
    return p


def pallas_interpret() -> bool:
    """Whether a Pallas call must run in interpret mode (the CPU only)."""
    return platform() == "cpu"


def resolve_fft_impl(choice: str = "auto") -> str:
    """``auto`` → ``xla_packed`` (cuFFT with pair packing on the GPU)."""
    if choice == "auto":
        platform()
        return "xla_packed"
    if choice not in FFT_IMPLS:
        raise ValueError(f"unknown fft_impl {choice!r} (one of {FFT_IMPLS})")
    return choice


def resolve_peaks_impl(choice: str = "auto") -> str:
    """``auto`` → the Triton peak kernel on the GPU, ``jnp`` on the CPU
    (the interpreter is orders of magnitude slower than XLA's CPU code)."""
    if choice == "auto":
        return "pallas" if platform() == "gpu" else "jnp"
    if choice not in PEAKS_IMPLS:
        raise ValueError(
            f"unknown peaks_impl {choice!r} (one of {PEAKS_IMPLS})"
        )
    return choice
