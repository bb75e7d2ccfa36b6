"""``audio-matcher`` — batch snippet-matching CLI (L3/L7).

Parity: reference src/matcher/mod.rs (``run``) + src/matcher/args.rs
(flag surface): scan ``within`` files for a ``--snippet``, log offsets as
``Offset i: hh:mm:ss with prominence p`` and write an Audacity label track
(`Segment #i`, +7 s start delay) next to each input.
"""

from __future__ import annotations

import argparse
import logging
import sys
from pathlib import Path

from ..hostio.decode import audio_duration, read_audio
from ..hostio.labels import timelabel_from_peaks, write_labels
from ..models.matcher import (
    DEFAULT_CHUNK_SECS,
    DEFAULT_DISTANCE_SECS,
    DEFAULT_PROMINENCE,
    MatchConfig,
    SnippetMatcher,
)
from ..ops import impls
from ..utils.durations import fmt_hms, parse_duration
from ..utils.progressbar import Progress
from ..utils.runtime import enable_compile_cache
from . import common
from .. import __version__

log = logging.getLogger("audio_matcher.cli")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="audio-matcher",
        description="find snippets (intros/outros/jingles) inside recordings "
        "via GPU-accelerated FFT cross-correlation",
    )
    p.add_argument(
        "--version", action="version",
        version=f"%(prog)s {__version__}",
    )
    p.add_argument(
        "within", nargs="*", type=Path, metavar="FILE",
        help="file in which samples are searched",
    )
    p.add_argument(
        "--snippet", type=Path, required=True, metavar="FILE",
        help="snippet to be found in file",
    )
    p.add_argument(
        "-p", "--prominence", type=float, default=DEFAULT_PROMINENCE,
        help="minimum prominence of the peaks (scored /100)",
    )
    p.add_argument(
        "--distance", type=parse_duration, default=DEFAULT_DISTANCE_SECS,
        metavar="SECONDS", help="minimum distance between matches in seconds",
    )
    p.add_argument(
        "--chunk-size", type=parse_duration, default=DEFAULT_CHUNK_SECS,
        metavar="SECONDS", help="length in seconds of chunks to be processed",
    )
    p.add_argument("--fancy-bar", action="store_true", help="use fancy bar")
    p.add_argument("--dry-run", action="store_true")
    p.add_argument("--skip-existing", action="store_true")
    out = p.add_mutually_exclusive_group()
    out.add_argument(
        "--no-out", action="store_true", help="generates no file with times"
    )
    out.add_argument(
        "-o", "--out", type=Path, metavar="FILE",
        help="file to save a text track",
    )
    p.add_argument(
        "--xprof", type=Path, metavar="DIR",
        help="write a jax.profiler trace of the scan to DIR",
    )
    p.add_argument(
        "--resample", action="store_true",
        help="resample the snippet when sample rates differ "
        "(the reference errors instead)",
    )
    p.add_argument(
        "--resample-impl", choices=("auto", "device", "scipy"),
        default="auto", metavar="IMPL",
        help="resampler: device = polyphase as one device convolution, "
        "scipy = host; auto picks device when an accelerator is attached",
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
        help="matching domain: raw-PCM correlation (reference semantics) or "
        "log-mel fingerprint NCC (noise-robust, frame-accurate)",
    )
    p.add_argument(
        "--transfer", choices=("float32", "int16", "mulaw8"),
        default="float32", metavar="DTYPE",
        help="episode staging wire format (int16 = lossless vs the 16-bit "
        "source, mulaw8 = lossy 8-bit; both cut host->device bytes)",
    )
    common.add_inputs_args(p)
    common.add_output_level_args(p)
    return p


def print_offsets(peaks, sr: int) -> None:
    # parity: matcher/mod.rs:110-125
    if not peaks:
        log.info("no offsets found")
    for i, peak in enumerate(peaks, start=1):
        log.info(
            "Offset %d: %s with prominence %s",
            i, fmt_hms(peak.start_secs(sr)), peak.prominence,
        )


def run(args: argparse.Namespace) -> int:
    inputs = common.Inputs.from_args(args)
    if args.out is not None and len(args.within) != 1:
        log.error("provided outfile only compatible with one main file")
        return 1

    log.debug("collecting snippet data")
    sr, s_samples = read_audio(args.snippet)
    # one decode per file: the probe falls back to the decoded length when
    # the tag cache is cold instead of decoding again
    s_duration = audio_duration(args.snippet, fallback=len(s_samples) / sr)
    enable_compile_cache()
    config = MatchConfig(
        chunk_secs=float(args.chunk_size),
        distance_secs=float(args.distance),
        prominence=args.prominence,
        # overlap = snippet duration (audio_matcher.rs:99-105) — but never
        # below the DECODED length: the tag cache stores whole seconds
        # (tagger.rs:193 interop), and an overlap shorter than the real
        # snippet degrades matches that straddle a chunk boundary (the
        # reference inherits that wart from its own warm tag cache; we
        # hold the decoded samples anyway, so clamp)
        overlap_secs=max(s_duration, len(s_samples) / sr),
        transfer_dtype=args.transfer,
        fft_impl=impls.resolve_fft_impl(args.fft_impl),
        peaks_impl=impls.resolve_peaks_impl(args.peaks_impl),
        resample_impl=args.resample_impl,
    )
    def build_matcher(snip, rate):
        if args.mode == "spectrogram":
            from ..models.spectrogram import (
                SpectrogramConfig,
                SpectrogramMatcher,
            )

            return SpectrogramMatcher(
                snip, rate,
                SpectrogramConfig(
                    distance_secs=float(args.distance),
                    transfer_dtype=args.transfer,
                    resample_impl=args.resample_impl,
                ),
            )
        return SnippetMatcher(snip, rate, config)

    matchers: dict[int, object] = {sr: build_matcher(s_samples, sr)}

    def matcher_for(rate: int):
        if rate not in matchers:
            from ..hostio.decode import resample

            matchers[rate] = build_matcher(
                resample(s_samples, sr, rate, impl=args.resample_impl),
                rate,
            )
        return matchers[rate]

    level = logging.DEBUG if len(args.within) == 1 else logging.INFO

    for main_file in args.within:
        out_path = args.out
        if out_path is None and not args.no_out:
            out_path = main_file.with_suffix(".txt")
        if out_path is not None and out_path.exists():
            if args.skip_existing or inputs.ask_consent(
                f"output file {out_path.name!r} already exists, skip this file?"
            ):
                continue
            if not inputs.ask_consent("overwrite the existing file?"):
                out_path = None

        log.log(level, "preparing data of '%s'", main_file)
        if args.mode == "pcm" and args.transfer != "float32":
            # decode straight to the int16 wire grid (no host float pass)
            from ..hostio.decode import read_audio_int16

            m_sr, m_samples = read_audio_int16(main_file)
        else:
            m_sr, m_samples = read_audio(main_file)
        if sr != m_sr and not args.resample:
            log.error(
                "files have different samplerates (%s, %s); "
                "pass --resample to match across rates",
                sr, m_sr,
            )
            return 1
        matcher = matcher_for(m_sr)

        m_duration = audio_duration(
            main_file, fallback=len(m_samples) / m_sr
        )
        est_samples = int(m_duration * m_sr)
        log.debug(
            "duration is %ss with sr %s implying #%s samples",
            m_duration, m_sr, est_samples,
        )

        if args.xprof:
            # aux tracing (SURVEY.md §5): jax profiler trace around the scan
            import contextlib

            import jax

            trace_cm = jax.profiler.trace(str(args.xprof))
        else:
            import contextlib

            trace_cm = contextlib.nullcontext()
        with trace_cm:
            if args.mode == "spectrogram":
                peaks = matcher.match(m_samples)
            else:
                n_windows = max(-(-est_samples // matcher.chunk), 1)
                bar = Progress(n_windows, fancy=args.fancy_bar)

                def progress(phase: str, _k: int) -> None:
                    (bar.start if phase == "start" else bar.finish)()

                peaks = matcher.match(
                    m_samples, scale=True, n_samples=est_samples,
                    progress=progress,
                )
                bar.close()  # n_windows is duration-estimated
        print_offsets(peaks, m_sr)
        log.debug("found peaks %s", peaks)

        if out_path is not None:
            log.debug("writing result to '%s'", out_path)
            write_labels(
                timelabel_from_peaks(peaks, m_sr, 7.0, "Segment #"),
                out_path,
                dry_run=args.dry_run,
            )
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
