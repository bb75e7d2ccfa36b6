"""Microbenchmarks mirroring the reference's criterion suite.

Parity: reference benches/my_benchmark.rs —
  * correlate: our device path vs the scipy library path
    (``correlate_vs_bib``: 50-pt snippet × 4000-pt signal)
  * conjugate-multiply vs reverse-multiply correlation
    (``correlate_vs_conj``)
  * full match of a synthetic episode vs --distance ∈ {8, 20, 60, 120} s
    (``compare_chunk_sizes``)
  * duration probe: tag-cached vs full decode
    (``get_duration_vs_parallel``)
  * decode throughput (``read_mp3``)

Run: ``python benches/microbench.py`` — prints one table; pass ``--quick``
to shrink the match benchmark.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).parent.parent))


_HISTORY: list[dict] = []


def timeit(fn, repeat=5, warmup=1):
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(repeat):
        t = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t)
    return min(times), float(np.median(times))


def row(name, best, med, note=""):
    print(f"{name:<44} {best * 1e3:>10.3f} ms {med * 1e3:>10.3f} ms  {note}")
    _HISTORY.append(
        {"name": name, "best_ms": round(best * 1e3, 3),
         "median_ms": round(med * 1e3, 3), "note": note}
    )


def bench_correlate_vs_lib():
    import scipy.signal

    from audio_matcher_tpu.ops import correlate

    data1 = np.arange(100, 150, dtype=np.float32)
    data2 = np.arange(-2000, 2000, dtype=np.float32)
    out = np.asarray(correlate(data2, data1, mode="valid"))  # compile
    del out
    best, med = timeit(
        lambda: np.asarray(correlate(data2, data1, mode="valid"))
    )
    row("correlate device (50 x 4000, valid)", best, med)
    best, med = timeit(
        lambda: scipy.signal.correlate(data2, data1, mode="valid")
    )
    row("correlate scipy   (50 x 4000, valid)", best, med)


def bench_conj_vs_reverse():
    from audio_matcher_tpu.ops import correlate

    data1 = np.arange(100, 150, dtype=np.float32)
    data2 = np.arange(-2000, 2000, dtype=np.float32)
    for conj in (True, False):
        np.asarray(correlate(data2, data1, use_conjugation=conj))
        best, med = timeit(
            lambda c=conj: np.asarray(
                correlate(data2, data1, use_conjugation=c)
            )
        )
        row(f"correlate {'conjugate-mult' if conj else 'reverse-mult '}", best, med)


def bench_match_vs_distance(quick: bool):
    from audio_matcher_tpu.models import MatchConfig, SnippetMatcher

    sr = 44100 if not quick else 8000
    secs = 600 if not quick else 60
    rng = np.random.default_rng(0)
    snippet = (rng.standard_normal(7 * sr) * 0.2).astype(np.float32)
    episode = (rng.standard_normal(secs * sr) * 0.05).astype(np.float32)
    episode[21 * sr : 21 * sr + len(snippet)] = snippet
    for distance in (8, 20, 60, 120):
        cfg = MatchConfig(distance_secs=float(distance))
        matcher = SnippetMatcher(snippet, sr, cfg)
        matcher.match(episode)  # compile
        best, med = timeit(lambda: matcher.match(episode), repeat=3)
        row(
            f"full match, distance={distance:>3}s ({secs}s ep)", best, med,
            f"{secs / 3600 / med:.2f} audio-h/s",
        )


def bench_impl_matrix(quick: bool):
    """Full match across every (fft_impl, peaks_impl) pair."""
    from audio_matcher_tpu.models import MatchConfig, SnippetMatcher

    sr = 44100 if not quick else 8000
    secs = 300 if not quick else 30
    rng = np.random.default_rng(3)
    snippet = (rng.standard_normal(7 * sr) * 0.2).astype(np.float32)
    episode = (rng.standard_normal(secs * sr) * 0.05).astype(np.float32)
    episode[11 * sr : 11 * sr + len(snippet)] = snippet
    from audio_matcher_tpu.ops.impls import FFT_IMPLS, platform

    # the Pallas peak kernel runs in interpret mode on the CPU — minutes
    # per match there, so the matrix times it only where it compiles
    peak_impls = ("jnp", "pallas") if platform() == "gpu" else ("jnp",)
    fft_impls = FFT_IMPLS
    for fft_impl in fft_impls:
        for peaks_impl in peak_impls:
            cfg = MatchConfig(
                distance_secs=60.0, fft_impl=fft_impl, peaks_impl=peaks_impl
            )
            matcher = SnippetMatcher(snippet, sr, cfg)
            matcher.match(episode)  # compile
            best, med = timeit(lambda: matcher.match(episode), repeat=3)
            row(
                f"match {fft_impl}+{peaks_impl} ({secs}s ep)", best, med,
                f"{secs / 3600 / med:.2f} audio-h/s",
            )


def bench_duration_probe(tmpdir: Path):
    from audio_matcher_tpu.hostio.decode import (
        audio_duration,
        encode_audio,
        native_available,
    )

    if not native_available("mp3_encode"):
        print("duration probe: skipped (no native mp3 encoder)")
        return
    rng = np.random.default_rng(1)
    path = tmpdir / "bench_dur.mp3"
    encode_audio(path, 44100, (rng.standard_normal(44100 * 60) * 0.05).astype(np.float32))
    t = time.perf_counter()
    audio_duration(path)  # decodes + writes cache
    cold = time.perf_counter() - t
    best, med = timeit(lambda: audio_duration(path), repeat=5)
    row("duration probe (tag-cached)", best, med, f"cold decode {cold * 1e3:.1f} ms")


def bench_decode(tmpdir: Path):
    from audio_matcher_tpu.hostio.decode import (
        encode_audio,
        native_available,
        read_audio,
    )

    if not native_available("mp3"):
        print("decode: skipped (no native mp3)")
        return
    rng = np.random.default_rng(2)
    secs = 120
    path = tmpdir / "bench_decode.mp3"
    encode_audio(
        path, 44100, (rng.standard_normal(44100 * secs) * 0.05).astype(np.float32)
    )
    best, med = timeit(lambda: read_audio(path), repeat=3)
    row(
        f"decode mp3 ({secs}s)", best, med,
        f"{secs / med:.0f}x realtime",
    )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument(
        "--history", type=Path, default=Path(__file__).parent / "history.jsonl",
        help="append results here for cross-round regression diffing "
        "(criterion-style tracked history); pass /dev/null to disable",
    )
    ap.add_argument("--tag", default="", help="label stored with the run")
    args = ap.parse_args()
    import tempfile

    print(f"{'benchmark':<44} {'best':>13} {'median':>13}")
    bench_correlate_vs_lib()
    bench_conj_vs_reverse()
    with tempfile.TemporaryDirectory() as d:
        bench_duration_probe(Path(d))
        bench_decode(Path(d))
    bench_match_vs_distance(args.quick)
    bench_impl_matrix(args.quick)

    if str(args.history) != "/dev/null":
        import datetime
        import json

        import jax

        record = {
            "tag": args.tag,
            "backend": jax.default_backend(),
            "when": datetime.datetime.now(datetime.timezone.utc).isoformat(
                timespec="seconds"
            ),
            "quick": args.quick,
            "rows": _HISTORY,
        }
        with open(args.history, "a") as f:
            f.write(json.dumps(record) + "\n")
        print(f"[history] appended {len(_HISTORY)} rows to {args.history}")


if __name__ == "__main__":
    main()
