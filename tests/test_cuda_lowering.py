"""Cross-platform AOT lowering of the scan programs for CUDA, from the CPU.

Lowering runs client-side: ``jax.jit(f).trace(...).lower(
lowering_platforms=("cuda",))`` turns each program into the HLO the GPU
compiler receives, and lowers every Pallas call through the Triton route
to Triton IR on the way. A primitive that the Triton lowering cannot
express (``slice`` inside a kernel, for one) fails here, before any chip
time, exactly as it would on the card. What only the GPU compiler can
refuse (registers, shared memory) still needs a chip run (chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from audio_matcher_tpu.models.matcher import MatchConfig, SnippetMatcher
from audio_matcher_tpu.ops import impls
from audio_matcher_tpu.parallel.mesh import make_mesh
from audio_matcher_tpu.parallel.sweep import (
    ShardedScanner,
    ShardedSpectrogramScanner,
    resident_match_step,
    resident_sharded_step,
)

SR = 1000
N_SLABS = 2
WIRES = ["float32", "int16", "mulaw8"]
WIRE_DTYPES = {"float32": jnp.float32, "int16": jnp.int16, "mulaw8": jnp.uint8}


def _cfg(wire, peaks):
    return MatchConfig(
        fft_impl="xla_packed", peaks_impl=peaks, transfer_dtype=wire,
        chunk_secs=8.0, distance_secs=2.0, slab=2, block=256,
    )


def _snippets():
    s0 = np.zeros(SR // 2, np.float32)
    s0[10] = 0.3  # nonzero autocorrelation
    s1 = np.zeros(SR // 4, np.float32)
    s1[5] = 0.3
    return [s0, s1]


def _lower_cuda(traced):
    text = traced.lower(lowering_platforms=("cuda",)).as_text()
    assert text  # a module came out
    return text


def _check_kernel(text, peaks):
    # the Triton-route kernel is in the module iff the pallas picker runs
    assert ("peaks_block_reduce" in text) == (peaks == "pallas")


@pytest.fixture
def on_gpu(monkeypatch):
    """Resolve platform-dependent choices as on the card, so Pallas calls
    lower compiled (interpret=False) rather than interpreted."""
    monkeypatch.setattr(impls, "platform", lambda: "gpu")


@pytest.mark.parametrize("peaks", ["jnp", "pallas"])
@pytest.mark.parametrize("wire", WIRES)
def test_episode_resident_lowers_for_cuda(wire, peaks, on_gpu):
    """SnippetMatcher's whole-episode program (the matcher CLI's path)."""
    from audio_matcher_tpu.models import matcher as M

    m = SnippetMatcher(_snippets()[0], SR, _cfg(wire, peaks))
    n_pad = N_SLABS * m.config.slab * m.chunk + m.overlap
    text = _lower_cuda(
        M._match_episode_resident.trace(
            jax.ShapeDtypeStruct((n_pad,), WIRE_DTYPES[wire]),
            np.int32(n_pad - m.overlap), m._sample_f, np.float32(1.0),
            chunk=m.chunk, window=m.window, m=m.snippet.m,
            fft_len=m.fft_len, valid_max=m.valid,
            distance=m.distance_samples, n_peaks=m.n_peaks,
            block=m.config.block, slab=m.config.slab, n_slabs=N_SLABS,
            fft_impl="xla_packed", peaks_impl=peaks,
        )
    )
    _check_kernel(text, peaks)


@pytest.mark.parametrize("peaks", ["jnp", "pallas"])
@pytest.mark.parametrize("wire", WIRES)
def test_batch_resident_lowers_for_cuda(wire, peaks, on_gpu):
    """The multi-query resident batch program (sweep CLI, one card)."""
    cfg = _cfg(wire, peaks)
    sc = ShardedScanner(_snippets(), SR, cfg, mesh=make_mesh(1))
    n_pad = N_SLABS * cfg.slab * sc.chunk + sc.overlap
    step = resident_match_step(
        sc.chunk, sc.window, sc.fft_len, sc.valid, sc.distance_samples,
        sc.n_peaks, cfg.block, cfg.slab, N_SLABS, "xla_packed", peaks,
    )[0]
    E, Q = 2, 2
    text = _lower_cuda(
        step.trace(
            jax.ShapeDtypeStruct((E, n_pad), WIRE_DTYPES[wire]),
            jax.ShapeDtypeStruct((E,), jnp.int32),
            sc._sample_f_resident,
            jax.ShapeDtypeStruct((Q,), jnp.float32),
            jax.ShapeDtypeStruct((Q,), jnp.int32),
        )
    )
    _check_kernel(text, peaks)


@pytest.mark.parametrize("peaks", ["jnp", "pallas"])
@pytest.mark.parametrize("wire", WIRES)
def test_sharded_resident_lowers_for_cuda(wire, peaks, on_gpu):
    """The shard_map resident program over a 4-device mesh (the sweep CLI's
    ``--devices 4`` path on one four-card host)."""
    cfg = _cfg(wire, peaks)
    mesh = make_mesh(4)
    sc = ShardedScanner(_snippets(), SR, cfg, mesh=mesh)
    n_pad = N_SLABS * cfg.slab * sc.chunk + sc.overlap
    step = resident_sharded_step(
        mesh, sc.chunk, sc.window, sc.fft_len, sc.valid,
        sc.distance_samples, sc.n_peaks, cfg.block, cfg.slab, N_SLABS,
        "xla_packed", peaks,
    )
    text = _lower_cuda(
        step.trace(
            jax.ShapeDtypeStruct((4, n_pad), WIRE_DTYPES[wire]),
            jax.ShapeDtypeStruct((4,), jnp.int32),
            sc._sample_f_resident,
            jax.ShapeDtypeStruct((2,), jnp.float32),
            jax.ShapeDtypeStruct((2,), jnp.int32),
        )
    )
    _check_kernel(text, peaks)


@pytest.mark.parametrize("wire", WIRES)
def test_sharded_spectrogram_lowers_for_cuda(wire, on_gpu):
    """The spectrogram scanner's shard_map program (log-mel + ZNCC +
    peaks; its picker is always the XLA one)."""
    from audio_matcher_tpu.models.spectrogram import SpectrogramConfig

    mesh = make_mesh(4)
    sc = ShardedSpectrogramScanner(
        [np.ones(SR, np.float32) * 0.1], SR,
        SpectrogramConfig(n_fft=128, hop=32, n_mels=16, transfer_dtype=wire),
        mesh=mesh,
    )
    n_pad = 1 << 18
    step = sc._step(n_pad)
    text = _lower_cuda(
        step.trace(
            jax.ShapeDtypeStruct((4, n_pad), WIRE_DTYPES[wire]),
            jax.ShapeDtypeStruct((4,), jnp.int32),
            jnp.asarray(sc._fb),
            jax.ShapeDtypeStruct(sc._snip_fps.shape, jnp.float32),
        )
    )
    _check_kernel(text, "jnp")
