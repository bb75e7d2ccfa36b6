"""``audio-sweep`` — batched archive scanning over a device mesh.

A capability surface beyond the reference (BASELINE.json configs #3/#5):
scan many recordings against one or more query snippets in mesh-sharded
batches with pipelined host decode and resumable progress, writing one
Audacity label file per (recording, query).
"""

from __future__ import annotations

import argparse
import glob as globmod
import logging
import sys
from pathlib import Path

from .. import __version__
from ..hostio.decode import read_audio
from ..hostio.labels import timelabel_from_peaks, write_labels
from ..models.matcher import (
    DEFAULT_CHUNK_SECS,
    DEFAULT_DISTANCE_SECS,
    DEFAULT_PROMINENCE,
    MatchConfig,
)
from ..ops import impls
from ..parallel.mesh import init_distributed, make_mesh
from ..parallel.sweep import sweep_archive
from ..utils.durations import parse_duration
from ..utils.runtime import enable_compile_cache
from . import common

log = logging.getLogger("audio_matcher.sweep")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="audio-sweep",
        description="scan a whole archive for query snippets on a GPU mesh",
    )
    p.add_argument(
        "--version", action="version", version=f"%(prog)s {__version__}"
    )
    p.add_argument(
        "within", nargs="*", metavar="FILE_OR_GLOB",
        help="recordings (files or globs) to scan",
    )
    p.add_argument(
        "--snippet", type=Path, action="append", required=True,
        metavar="FILE", help="query snippet (repeatable)",
    )
    p.add_argument(
        "-p", "--prominence", type=float, default=DEFAULT_PROMINENCE
    )
    p.add_argument(
        "--distance", type=parse_duration, default=DEFAULT_DISTANCE_SECS,
        metavar="SECONDS",
    )
    p.add_argument(
        "--chunk-size", type=parse_duration, default=DEFAULT_CHUNK_SECS,
        metavar="SECONDS",
    )
    p.add_argument(
        "--progress-file", type=Path, metavar="FILE",
        help="resume state (reference .done.txt line format)",
    )
    p.add_argument(
        "--devices", type=int, metavar="N",
        help="mesh size (default: all devices)",
    )
    p.add_argument(
        "--group-size", type=int, metavar="N",
        help="episodes per device dispatch (default: mesh size, raised "
        "to 8 on a single chip; rounded up to a mesh multiple). Host "
        "memory scales with group size x episode length — pass 1 for "
        "very long episodes on small hosts",
    )
    p.add_argument("--no-out", action="store_true")
    p.add_argument("--dry-run", action="store_true")
    p.add_argument(
        "--resample", action="store_true",
        help="resample recordings whose rate differs from the snippets",
    )
    p.add_argument(
        "--resample-impl", choices=("auto", "device", "scipy"),
        default="auto", metavar="IMPL",
        help="resampler: device = polyphase as one device convolution "
        "(ops/resample.py), scipy = host; auto picks device when an "
        "accelerator is attached",
    )
    p.add_argument(
        "--transfer", choices=("float32", "int16", "mulaw8"),
        default="int16", metavar="DTYPE",
        help="staging wire format (default int16: lossless vs 16-bit source)",
    )
    p.add_argument(
        "--fft-impl", choices=("auto", *impls.FFT_IMPLS), default="auto",
        metavar="IMPL",
        help="correlation FFT implementation (auto = xla_packed: pair-packed "
        "cuFFT transforms; xla: one transform per correlation, the test "
        "oracle; mxu: matmul four-step FFT)",
    )
    p.add_argument(
        "--peaks-impl", choices=("auto", *impls.PEAKS_IMPLS), default="auto",
        metavar="IMPL",
        help="peak-pick implementation (pallas: the single-pass Triton "
        "kernel; auto = pallas on a GPU, jnp on the CPU)",
    )
    p.add_argument(
        "--mode", choices=("pcm", "spectrogram"), default="pcm",
        help="matching domain (spectrogram = noise-robust log-mel NCC)",
    )
    common.add_output_level_args(p)
    return p


def run(args: argparse.Namespace) -> int:
    paths: list[Path] = []
    for pattern in args.within:
        hits = sorted(globmod.glob(pattern, recursive=True))
        if hits:
            paths.extend(Path(h) for h in hits)
        else:
            paths.append(Path(pattern))
    if not paths:
        log.error("no input files")
        return 1

    snippets = []
    sr = None
    for snip_path in args.snippet:
        s_sr, s = read_audio(snip_path)
        if sr is None:
            sr = s_sr
        elif s_sr != sr:
            log.error(
                "query snippets have different samplerates (%s, %s)", sr, s_sr
            )
            return 1
        snippets.append(s)

    # join a configured multi-process cluster (env-driven; no-op
    # otherwise) BEFORE anything touches the backend. On multi-process,
    # leave mesh=None so sweep_archive builds each process's LOCAL mesh
    # (whole episodes per process, zero cross-process device traffic) —
    # a process-spanning mesh here would stage local groups onto other
    # processes' non-addressable devices.
    init_distributed()
    enable_compile_cache()
    config = MatchConfig(
        chunk_secs=float(args.chunk_size),
        distance_secs=float(args.distance),
        prominence=args.prominence,
        transfer_dtype=args.transfer,
        fft_impl=impls.resolve_fft_impl(args.fft_impl),
        peaks_impl=impls.resolve_peaks_impl(args.peaks_impl),
        resample_impl=args.resample_impl,
    )
    import jax

    if jax.process_count() > 1 and args.devices is None:
        mesh = None
    else:
        mesh = make_mesh(args.devices)

    def write_result(path: Path, q: int, peaks) -> None:
        if args.no_out:
            return
        suffix = f".q{q}.txt" if len(snippets) > 1 else ".txt"
        out = path.with_suffix(suffix)
        write_labels(
            timelabel_from_peaks(peaks, sr, 7.0, "Segment #"),
            out, dry_run=args.dry_run,
        )
        log.info("%s → %d peaks → %s", path.name, len(peaks), out.name)

    spectrogram_config = None
    if args.mode == "spectrogram":
        from ..models.spectrogram import SpectrogramConfig

        spectrogram_config = SpectrogramConfig(
            distance_secs=float(args.distance),
            transfer_dtype=args.transfer,
            resample_impl=args.resample_impl,
        )
    results = sweep_archive(
        paths,
        snippets,
        sr,
        config,
        mesh=mesh,
        progress_path=args.progress_file,
        write_labels_for=write_result,
        resample_mismatched=args.resample,
        mode=args.mode,
        spectrogram_config=spectrogram_config,
        group_size=args.group_size,
    )
    log.info("scanned %d file(s) on a %s mesh", len(results), mesh.devices.shape)
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    common.init_logger(args)
    try:
        return run(args)
    except Exception as exc:  # noqa: BLE001 — CLI boundary
        log.error("Program error :'%s'", exc)
        return 1


if __name__ == "__main__":
    sys.exit(main())
