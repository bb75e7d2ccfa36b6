"""Benchmark: (episode, snippet)-pair audio-hours scanned per second per card.

Config = BASELINE.json #3 (batch scan): 44.1 kHz episodes scanned for
10 s-class intro snippets via overlap-save chunked correlation with the
reference's defaults (chunk 60 s, min-distance 480 s, prominence 13),
staged once and scanned against every query. The baseline is the measured
single-core CPU throughput of the same per-pair pipeline semantics (scipy
rFFT + scipy find_peaks, single thread) — a stand-in for the Rust
reference's single-core realfft path, which publishes no numbers and can't
be built here (no cargo; BASELINE.md).

Runs in ONE process on the first GPU and prints ONE JSON line: {"metric",
"ok", "value", "unit", "vs_baseline", "device_resident_value",
"device_resident_vs_baseline", "device", ...}; "device" names the platform,
device kind, device count and the card's name and power limit. Exits
nonzero when the correctness check fails, and refuses to run (exit 3) when
JAX finds no GPU — unless the caller selected the CPU explicitly with
``JAX_PLATFORMS=cpu`` (the tests do), in which case the numbers are CPU
numbers and say so. Compiled programs persist in the compile cache
(utils/runtime.py). Knobs: BENCH_EPISODE_SECS, BENCH_EPISODES,
BENCH_QUERIES, BENCH_SLAB, BENCH_TRANSFER_DTYPE, BENCH_FFT_IMPL,
BENCH_PEAKS_IMPL (``auto`` by default, resolved by ops/impls.py),
BENCH_REPEATS (median-of-N scan phase; timing methodology, not part of the
history fingerprint).

BENCH_MODE=spectrogram benches the second model family instead
(BASELINE config #4: log-mel fingerprints + tiled multi-query ZNCC,
`ShardedSpectrogramScanner`) against a single-core scipy pipeline with
the same semantics; its history entries carry a distinct fingerprint
(``"mode": "spectrogram"``) so both modes inherit the >15% regression
gate independently.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time

import numpy as np

SR = 44100
EPISODE_SECS = int(os.environ.get("BENCH_EPISODE_SECS", "1800"))
SNIPPET_SECS = 10.0
BASELINE_WINDOWS = 3  # windows to time for the CPU extrapolation


def make_audio(rng, secs, snippet, offsets):
    x = (rng.standard_normal(int(secs * SR)) * 0.05).astype(np.float32)
    for off in offsets:
        i = int(off * SR)
        x[i : i + len(snippet)] = snippet
    return x


def stage_and_scan(stage, scan, repeats: int) -> dict:
    """Time ``staged = stage()`` (fenced on every transfer piece), the
    first ``scan(staged)`` (compile + run) and the median of ``repeats``
    more scans. Staging comes before the first program execution (scanner
    construction and staging are execution-free by contract), so the
    staging time holds no compile. Each scan ends in the device→host peak
    readback, so each is a fenced sample. Shared with chip_smoke.py."""
    t0 = time.perf_counter()
    staged = stage()
    pieces = staged[0] if isinstance(staged[0], tuple) else (staged[0],)
    for p in pieces:
        p.block_until_ready()
    stage_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    scan(staged)
    first_s = time.perf_counter() - t0
    times = []
    for _ in range(max(repeats, 1)):
        t0 = time.perf_counter()
        results = scan(staged)
        times.append(time.perf_counter() - t0)
    scan_s = statistics.median(times)  # true median for even N too
    return {
        "stage_s": stage_s,
        "staged_bytes": sum(p.nbytes for p in pieces),
        "n_pieces": len(pieces),
        "compile_s": max(first_s - scan_s, 0.0),
        "scan_s": scan_s,
        "times": times,
        "results": results,
    }


def _measure_staged_scan(scanner, episode, transfer_dtype, n_episodes,
                         n_queries, label):
    """Shared stage→warm→scan timing for BOTH bench modes. Staging time
    is included in the e2e number; returns seconds per (episode, snippet)
    pair (e2e, device-resident), the extras and the primary query's
    peaks."""
    import jax

    # untimed: backend and first-transfer initialisation
    jax.device_put(np.zeros(1024, np.int16)).block_until_ready()

    # untimed: the wire samples stand in for the native decoder's output
    # (mpg123 decodes to int16; the f32 PCM scaling is applied on device)
    # — quantization is decode work, not scan work
    if transfer_dtype != "float32":
        from audio_matcher_tpu.models.matcher import quantize_wire

        episode_wire = quantize_wire(episode, transfer_dtype)
    else:
        episode_wire = episode

    repeats = max(int(os.environ.get("BENCH_REPEATS", "3")), 1)
    t = stage_and_scan(
        lambda: scanner.stage_resident([episode_wire] * n_episodes),
        lambda staged: scanner.scan_staged(staged, scale=True),
        repeats,
    )
    t_stage, t_compute, times = t["stage_s"], t["scan_s"], t["times"]
    staged_bytes = t["staged_bytes"]
    if repeats > 1:
        print(
            f"[bench] {label}scan repeats: median of {repeats} = "
            f"{t_compute:.3f}s (min {min(times):.3f}, max {max(times):.3f})",
            file=sys.stderr,
        )
    # correctness: every episode must find the primary query's plants
    peaks = [per_query[0] for per_query in t["results"]]

    n_pairs = n_episodes * n_queries
    print(
        f"[bench] {label}stage {n_episodes} episodes "
        f"({staged_bytes / 1e6:.0f}MB in {t['n_pieces']} put(s), "
        f"{transfer_dtype}): "
        f"{t_stage:.2f}s; batch scan x{n_queries} queries: "
        f"{t_compute:.2f}s (amortized per-pair match latency "
        f"{t_compute / n_pairs * 1e3:.0f} ms)",
        file=sys.stderr,
    )
    extras = {
        "stage_secs": round(t_stage, 3),
        "staged_mb": round(staged_bytes / 1e6, 1),
        "stage_mb_s": round(staged_bytes / 1e6 / t_stage, 1)
        if t_stage > 0
        else None,
        "scan_secs": round(t_compute, 4),
        "compile_secs": round(t["compile_s"], 2),
    }
    return ((t_stage + t_compute) / n_pairs, t_compute / n_pairs), extras, peaks


def measure_scan(episode, snippets, config, n_episodes=None):
    """Batch-scan regime, BASELINE config #3 (see _measure_staged_scan)."""
    if n_episodes is None:
        n_episodes = int(os.environ.get("BENCH_EPISODES", "4"))
    from audio_matcher_tpu.parallel.mesh import make_mesh
    from audio_matcher_tpu.parallel.sweep import ShardedScanner

    scanner = ShardedScanner(snippets, SR, config, mesh=make_mesh(1))
    return _measure_staged_scan(
        scanner, episode, config.transfer_dtype, n_episodes,
        len(snippets), "",
    )


def measure_scan_spectrogram(episode, snippets, config, n_episodes=None):
    """Spectrogram family, BASELINE config #4: log-mel + tiled
    multi-query ZNCC + on-device peaks as the resident program (same
    phases/fences — see _measure_staged_scan)."""
    if n_episodes is None:
        n_episodes = int(os.environ.get("BENCH_EPISODES", "4"))
    from audio_matcher_tpu.parallel.mesh import make_mesh
    from audio_matcher_tpu.parallel.sweep import ShardedSpectrogramScanner

    scanner = ShardedSpectrogramScanner(
        snippets, SR, config, mesh=make_mesh(1)
    )
    return _measure_staged_scan(
        scanner, episode, config.transfer_dtype, n_episodes,
        len(snippets), "spectrogram ",
    )


def measure_cpu_baseline(episode, snippet, config):
    """Single-core scipy pipeline: per-window rfft→conj-mult→irfft→find_peaks."""
    import scipy.fft
    import scipy.signal

    m = len(snippet)
    chunk = int(config.chunk_secs * SR)
    window = chunk + m
    L = scipy.fft.next_fast_len(window + m - 1, real=True)
    sf = np.conj(scipy.fft.rfft(snippet, L, workers=1))
    inv_ac = 1.0 / float(np.sum(snippet.astype(np.float64) ** 2))
    distance = int(config.distance_secs) * SR

    # best-of-3: the host's other work can starve one timing; give the
    # CPU baseline its least-starved showing so vs_baseline is
    # conservative rather than inflated by host contention
    per_window = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for k in range(BASELINE_WINDOWS):
            win = episode[k * chunk : k * chunk + window]
            x = scipy.fft.rfft(win, L, workers=1)
            c = scipy.fft.irfft(x * sf, L, workers=1)[: len(win) - m + 1]
            c *= inv_ac
            scipy.signal.find_peaks(
                c, distance=min(distance, len(c) - 1), prominence=(0.13, None)
            )
        per_window = min(
            per_window, (time.perf_counter() - t0) / BASELINE_WINDOWS
        )
    windows_per_hour = 3600.0 / config.chunk_secs
    return 1.0 / (per_window * windows_per_hour)  # audio-hours/sec


def cpu_spectrogram_scores(episode, snippet, config, sr=None):
    """Single-core scipy/numpy ZNCC scores with the device path's exact
    semantics: hann STFT → mel matmul → log → FFT-based patch-flat ZNCC
    with cumsum window norms. Pinned against ops.stft.fingerprint_scores
    by tests/test_bench_history.py so vs_baseline can't silently measure
    a different algorithm."""
    import scipy.fft

    from audio_matcher_tpu.ops.stft import mel_filterbank

    cfg = config
    sr = SR if sr is None else sr
    fb_t = mel_filterbank(cfg.n_mels, cfg.n_fft, sr).T  # [bins, mels]
    win = np.hanning(cfg.n_fft).astype(np.float32)

    def logmel(x):
        n_frames = 1 + (len(x) - cfg.n_fft) // cfg.hop
        frames = np.lib.stride_tricks.sliding_window_view(x, cfg.n_fft)[
            :: cfg.hop
        ][:n_frames]
        z = scipy.fft.rfft(frames * win, axis=1, workers=1)
        return np.log((z.real**2 + z.imag**2) @ fb_t + 1e-8)

    snip_fp = logmel(snippet)
    t_s = snip_fp.shape[0]
    s0 = (snip_fp - snip_fp.mean()).astype(np.float32)
    snorm = float(np.sqrt((s0 * s0).sum()))
    patch = t_s * cfg.n_mels
    ep_fp = logmel(episode)
    n_valid = ep_fp.shape[0] - t_s + 1
    L = scipy.fft.next_fast_len(ep_fp.shape[0] + t_s - 1, real=True)
    S = scipy.fft.rfft(s0.T, n=L, axis=1, workers=1)  # [M, F]
    E = scipy.fft.rfft(ep_fp.T, n=L, axis=1, workers=1)
    corr = scipy.fft.irfft(
        (E * np.conj(S)).sum(axis=0), n=L, workers=1
    )[:n_valid]
    s1 = np.concatenate([[0.0], np.cumsum(ep_fp.sum(axis=1))])
    s2 = np.concatenate([[0.0], np.cumsum((ep_fp * ep_fp).sum(axis=1))])
    win_sum = s1[t_s:] - s1[:-t_s]
    win_norm2 = np.maximum(
        (s2[t_s:] - s2[:-t_s]) - win_sum * win_sum / patch, 0.0
    )
    return corr / (np.sqrt(win_norm2[:n_valid]) * snorm + 1e-8)


def measure_cpu_baseline_spectrogram(episode, snippet, config):
    """Single-core pipeline cost (see :func:`cpu_spectrogram_scores` for
    the semantics), timed on a 60 s slice and extrapolated — both stages
    are linear in episode length, and the full half-hour episode would
    take minutes on one core."""
    import scipy.signal

    cfg = config
    slice_secs = min(60.0, len(episode) / SR)
    x = episode[: int(slice_secs * SR)]

    elapsed = float("inf")
    for _ in range(3):  # best-of-3 (see measure_cpu_baseline)
        t0 = time.perf_counter()
        scores = cpu_spectrogram_scores(x, snippet, cfg)
        frame_distance = max(int(cfg.distance_secs * SR / cfg.hop), 1)
        scipy.signal.find_peaks(
            scores, distance=min(frame_distance, max(len(scores) - 1, 1))
        )
        elapsed = min(elapsed, time.perf_counter() - t0)
    return 1.0 / (elapsed * 3600.0 / slice_secs)  # audio-hours/sec


def _history_path() -> str:
    """benches/history.jsonl next to this file; BENCH_HISTORY_PATH
    overrides (tests point it at a scratch file)."""
    return os.environ.get("BENCH_HISTORY_PATH") or os.path.join(
        os.path.dirname(__file__), "benches", "history.jsonl"
    )


def record_history(result: dict, fingerprint: dict, path: str | None = None) -> None:
    """Append this run to benches/history.jsonl (criterion's tracked-
    history role) and compare against the latest prior entry with the
    SAME config fingerprint. Regressions >15% on the device-resident
    number (the repeatable one — e2e inherits the host's staging
    variance) fail loudly; BENCH_STRICT=1 makes that a hard exit."""
    import datetime

    if path is None:
        path = _history_path()
    prev = None
    same_cfg = []
    try:
        with open(path) as f:
            for line in f:
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if rec.get("tag") == "bench" and rec.get("fingerprint") == fingerprint:
                    same_cfg.append(rec)
                    prev = rec
    except FileNotFoundError:
        pass
    entry = {
        "tag": "bench",
        "when": datetime.datetime.now(datetime.timezone.utc).isoformat(
            timespec="seconds"
        ),
        "fingerprint": fingerprint,
        "result": result,
    }
    cur = result["device_resident_value"]
    if prev is not None:
        old = prev["result"]["device_resident_value"]
        delta = (cur - old) / old if old else 0.0
        print(
            f"[bench] history: device-resident {old:.3f} -> {cur:.3f} "
            f"pair-h/s ({delta:+.1%} vs {prev['when']})",
            file=sys.stderr,
        )
        # regression gate vs the rolling BEST of the last 5 non-regressed
        # entries, not just the previous run: a regressed run must not
        # become the new baseline, and successive sub-threshold drops must
        # not compound undetected
        candidates = [
            r["result"]["device_resident_value"]
            for r in same_cfg[-5:]
            if not r.get("regression")
        ]
        if not candidates:
            # window full of flagged runs: reach back to the newest
            # non-regressed entry anywhere in history so a sustained
            # regression can never re-baseline itself (falling back to
            # the degraded value only when NO clean run ever existed)
            candidates = [
                r["result"]["device_resident_value"]
                for r in reversed(same_cfg)
                if not r.get("regression")
            ][:1] or [old]
        best = max(candidates)
        best_delta = (cur - best) / best if best else 0.0
        if best_delta < -0.15:
            entry["regression"] = True
            print(
                f"[bench] REGRESSION: device-resident throughput dropped "
                f"{-best_delta:.1%} vs the rolling best of this config "
                f"({best:.3f} pair-h/s, >{15}% threshold)",
                file=sys.stderr,
            )
            if os.environ.get("BENCH_STRICT"):
                with open(path, "a") as f:
                    f.write(json.dumps(entry) + "\n")
                sys.exit(1)
    with open(path, "a") as f:
        f.write(json.dumps(entry) + "\n")


def historical_best_baseline(
    fingerprint: dict, path: str | None = None
) -> float | None:
    """Fastest CPU-baseline showing ever recorded for this fingerprint.
    A starved ``measure_cpu_baseline`` run (the bench host's cores are
    shared) inflates vs_baseline. Clamping the denominator to the least-starved
    baseline ever measured for the same fingerprint keeps the multiplier
    conservative and comparable across host weather; absolute pair-h/s
    values are never touched.

    Entries written since the clamp shipped carry the denominator
    verbatim (``cpu_baseline``) — read it directly. Older entries fall
    back to the device_resident value/vs ratio, whose round(,4)/round(,2)
    fields reconstruct the baseline to only ~2e-5 relative; preferring
    the exact field stops that rounding error from ratcheting upward
    through max() generation after generation."""
    if path is None:
        path = _history_path()
    best = None
    try:
        with open(path) as f:
            for line in f:
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if rec.get("tag") != "bench" or rec.get("fingerprint") != fingerprint:
                    continue
                res = rec.get("result", {})
                b = res.get("cpu_baseline")
                if not b or b <= 0:
                    val = res.get("device_resident_value")
                    vs = res.get("device_resident_vs_baseline")
                    if not (val and vs and val > 0 and vs > 0):
                        continue
                    b = val / vs
                if best is None or b > best:
                    best = b
    except FileNotFoundError:
        pass
    return best


def baseline_provenance(baseline: float, measured: float) -> dict:
    """History-entry fields recording vs_baseline's denominator:
    ``cpu_baseline`` is always written (at 6 decimals — the exact value
    ``historical_best_baseline`` reads back, so the clamp never has to
    reconstruct it from rounded value/vs ratios), plus
    ``cpu_baseline_measured`` when the clamp replaced a starved
    measurement (so forensics never need the stderr log)."""
    fields = {"cpu_baseline": round(baseline, 6)}
    if baseline != measured:
        fields["cpu_baseline_measured"] = round(measured, 6)
    return fields


def clamped_baseline(measured: float, fingerprint: dict) -> float:
    """max(measured, historical best) — see historical_best_baseline."""
    hist = historical_best_baseline(fingerprint)
    if hist is not None and hist > measured:
        print(
            f"[bench] cpu baseline measured {measured:.4f} pair-h/s is "
            f"below this fingerprint's least-starved showing "
            f"({hist:.4f}); using the historical best so vs_baseline "
            "stays conservative under host contention",
            file=sys.stderr,
        )
        return hist
    return measured


def make_config():
    """The bench's MatchConfig from env knobs."""
    from audio_matcher_tpu.models.matcher import MatchConfig
    from audio_matcher_tpu.ops.impls import (
        resolve_fft_impl,
        resolve_peaks_impl,
    )

    return MatchConfig(
        slab=int(os.environ.get("BENCH_SLAB", "8")),
        # an explicit BENCH_SLAB pins the slab for A/Bs; otherwise the
        # production adaptive pick (pick_slab) applies
        slab_auto="BENCH_SLAB" not in os.environ,
        # mulaw8 (lossy, positions sample-exact) stays the bench's wire
        # until a staging measurement on the card decides between it and
        # the lossless int16 the sweep CLI defaults to (ROADMAP queue 3)
        transfer_dtype=os.environ.get("BENCH_TRANSFER_DTYPE", "mulaw8"),
        # "auto" → the one platform resolver (ops/impls.py)
        fft_impl=resolve_fft_impl(os.environ.get("BENCH_FFT_IMPL", "auto")),
        peaks_impl=resolve_peaks_impl(
            os.environ.get("BENCH_PEAKS_IMPL", "auto")
        ),
    )


def make_spec_config():
    """The spectrogram bench's config from env knobs (BENCH_MODE=
    spectrogram): int16 wire, n_fft 1024 / hop 256 / 64 mels — hop
    divides n_fft so framing stays on the sliced path."""
    from audio_matcher_tpu.models.spectrogram import SpectrogramConfig

    return SpectrogramConfig(
        transfer_dtype=os.environ.get("BENCH_TRANSFER_DTYPE", "int16"),
    )


def spec_queries_default() -> int:
    """BENCH_QUERIES default for spectrogram mode: 8 (fingerprint NCC is
    per-query cheap; the pcm mode's 64 exists to amortize staging)."""
    return int(os.environ.get("BENCH_QUERIES", "8"))


def expected_fingerprint_spec(config, backend: str) -> dict:
    """Spectrogram-mode history fingerprint (the ``mode`` key keeps it
    disjoint from every pcm entry)."""
    return {
        "backend": backend,
        "mode": "spectrogram",
        "episode_secs": EPISODE_SECS,
        "episodes": int(os.environ.get("BENCH_EPISODES", "4")),
        "queries": spec_queries_default(),
        "n_fft": config.n_fft,
        "hop": config.hop,
        "n_mels": config.n_mels,
        "transfer_dtype": config.transfer_dtype,
        **(
            {"put_cap": os.environ["AUDIO_MATCHER_PUT_BYTES"]}
            if "AUDIO_MATCHER_PUT_BYTES" in os.environ
            else {}
        ),
    }


def expected_fingerprint(config, backend: str) -> dict:
    """The history fingerprint this configuration records; ``backend`` is
    the platform the run is on (``jax.default_backend()``)."""
    from audio_matcher_tpu.models.matcher import effective_slab as _eff

    # same chunk rounding as the scanners (int(round(...))) so the
    # fingerprint records the slab the run actually uses
    chunk = int(round(config.chunk_secs * SR))
    n_samples = int(EPISODE_SECS * SR)
    return {
        "backend": backend,
        "episode_secs": EPISODE_SECS,
        "episodes": int(os.environ.get("BENCH_EPISODES", "4")),
        "queries": int(os.environ.get("BENCH_QUERIES", "64")),
        # the EFFECTIVE slab (adaptive pick resolved for this episode
        # length), so history entries from explicit BENCH_SLAB A/Bs
        # and adaptive runs of the same shape share a fingerprint
        "slab": _eff(config, max(-(-n_samples // chunk), 1)),
        "transfer_dtype": config.transfer_dtype,
        "fft_impl": config.fft_impl,
        "peaks_impl": config.peaks_impl,
        # piece-cap A/Bs must not share a fingerprint with uncapped runs
        # — the cap is exactly what moves the e2e number. Only present
        # when explicitly set.
        **(
            {"put_cap": os.environ["AUDIO_MATCHER_PUT_BYTES"]}
            if "AUDIO_MATCHER_PUT_BYTES" in os.environ
            else {}
        ),
    }


def require_gpu() -> dict:
    """Refuse to measure anywhere but on a GPU; returns the device report.

    The CPU is accepted only when the caller chose it explicitly
    (``JAX_PLATFORMS=cpu``, as the tests do): a measurement that finds no
    card must fail, not quietly time XLA's CPU backend."""
    import jax

    from audio_matcher_tpu.utils.runtime import device_report

    platform = jax.devices()[0].platform
    explicit_cpu = os.environ.get("JAX_PLATFORMS", "") == "cpu"
    if platform != "gpu" and not (platform == "cpu" and explicit_cpu):
        print(
            f"bench: JAX found no GPU (platform {platform!r}); refusing to "
            "measure. Set JAX_PLATFORMS=cpu to time the CPU deliberately.",
            file=sys.stderr,
        )
        raise SystemExit(3)
    report = device_report()
    print(
        f"[bench] device: {report['platform']} {report['kind']} "
        f"x{report['count']}; card: {report['card'] or 'n/a'}",
        file=sys.stderr,
    )
    return report


def make_snippets(rng, n_queries, sr=SR):
    """Query snippets of 10–13.5 s (length cycles over 8 steps), noise at
    0.15 rms clipped inside the ±0.5 PCM grid. Shared with chip_smoke.py."""
    return [
        np.clip(
            rng.standard_normal(int((SNIPPET_SECS + 0.5 * (q % 8)) * sr))
            * 0.15,
            -0.45, 0.45,
        ).astype(np.float32)
        for q in range(n_queries)
    ]


def make_bench_inputs(n_queries):
    """Deterministic snippets/offsets/episode shared by BOTH bench modes.
    Query lengths 10–13.5 s: varied (exercises per-query valid masking)
    while keeping the pcm FFT bucket at 2^22 for any query count; plants
    stay inside shrunken BENCH_EPISODE_SECS runs."""
    rng = np.random.default_rng(42)
    snippets = make_snippets(rng, n_queries)
    offsets = [
        o for o in (21.0, EPISODE_SECS * 0.55)
        if (o + SNIPPET_SECS + 0.5) < EPISODE_SECS
    ] or [0.0]
    episode = make_audio(rng, EPISODE_SECS, snippets[0], offsets)
    return snippets, offsets, episode


def check_plants(peaks, offsets, distance_secs, tol, label="") -> bool:
    """Every episode must find the primary query's plants within ``tol``
    samples. When a shrunken BENCH_EPISODE_SECS puts the plants within
    the min-distance, suppression legitimately keeps only one (and exact
    height ties make WHICH one nondeterministic on threaded-CPU runs) —
    the check then relaxes to at-least-one-near-a-plant. The default
    config keeps them ≥ distance apart → strict zip-wise check."""
    want = sorted(int(o * SR) for o in offsets)
    gaps_ok = len(offsets) > 1 and (
        offsets[1] - offsets[0]
    ) >= distance_secs
    ok = True
    for e, ep_peaks in enumerate(peaks):
        got = sorted(p.position for p in ep_peaks if p.height > 0.5)
        if gaps_ok:
            good = len(got) == len(want) and all(
                abs(a - b) <= tol for a, b in zip(got, want)
            )
        else:
            good = len(got) >= 1 and all(
                any(abs(g - w) <= tol for w in want) for g in got
            )
        if not good:
            ok = False
            print(
                f"bench correctness check failed ({label}episode {e}): "
                f"got {got}, want {want} (±{tol})",
                file=sys.stderr,
            )
    return ok


def main_spectrogram(device: dict) -> int:
    """BENCH_MODE=spectrogram body."""
    n_episodes = int(os.environ.get("BENCH_EPISODES", "4"))
    n_queries = spec_queries_default()
    snippets, offsets, episode = make_bench_inputs(n_queries)
    config = make_spec_config()

    (per_pair, per_pair_scan), extras, peaks = measure_scan_spectrogram(
        episode, snippets, config, n_episodes
    )
    hours = EPISODE_SECS / 3600.0
    value = hours / per_pair
    value_scan = hours / per_pair_scan

    # offsets are frame-accurate → tolerance is one hop
    ok = check_plants(
        peaks, offsets, config.distance_secs, config.hop, "spectrogram, "
    )

    fingerprint = expected_fingerprint_spec(config, device["platform"])
    baseline_measured = measure_cpu_baseline_spectrogram(
        episode, snippets[0], config
    )
    baseline = clamped_baseline(baseline_measured, fingerprint)
    print(
        f"[bench] spectrogram: {hours:.2f} pair-hours per {per_pair:.2f}s "
        f"({value:.3f} pair-h/s end-to-end, {value_scan:.3f} "
        f"device-resident); cpu single-core baseline {baseline:.4f} "
        f"pair-h/s; matches {'OK' if ok else 'WRONG'}",
        file=sys.stderr,
    )
    result = {
        "metric": "(episode,snippet)-pair audio-hours scanned/sec/card "
        f"(spectrogram mode: {n_episodes} episodes x {n_queries} query "
        "fingerprints, 44.1kHz log-mel ZNCC; staging included)",
        "ok": ok,
        "value": round(value, 4),
        "unit": "pair_audio_hours/s",
        "vs_baseline": round(value / baseline, 2),
        "device_resident_value": round(value_scan, 4),
        "device_resident_vs_baseline": round(value_scan / baseline, 2),
        **baseline_provenance(baseline, baseline_measured),
        **extras,
        "device": device,
    }
    if not ok:
        print(json.dumps(result))
        return 2
    record_history(result, fingerprint)
    print(json.dumps(result))
    return 0


def main() -> int:
    device = require_gpu()
    from audio_matcher_tpu.utils.runtime import enable_compile_cache

    cache = enable_compile_cache()
    print(f"[bench] compile cache: {cache or 'off'}", file=sys.stderr)
    if os.environ.get("BENCH_MODE", "pcm") == "spectrogram":
        return main_spectrogram(device)
    n_episodes = int(os.environ.get("BENCH_EPISODES", "4"))
    n_queries = int(os.environ.get("BENCH_QUERIES", "64"))
    snippets, offsets, episode = make_bench_inputs(n_queries)

    config = make_config()

    (per_pair, per_pair_scan), extras, peaks = measure_scan(
        episode, snippets, config
    )
    hours = EPISODE_SECS / 3600.0
    value = hours / per_pair  # pair audio-hours per second
    value_scan = hours / per_pair_scan  # device-resident (staging excluded)

    # sample-exact matching → tolerance 1
    ok = check_plants(peaks, offsets, config.distance_secs, 1)

    fingerprint = expected_fingerprint(config, device["platform"])
    baseline_measured = measure_cpu_baseline(episode, snippets[0], config)
    baseline = clamped_baseline(baseline_measured, fingerprint)
    print(
        f"[bench] {hours:.2f} pair-hours per {per_pair:.2f}s "
        f"({value:.3f} pair-h/s end-to-end, {value_scan:.3f} pair-h/s "
        f"device-resident); cpu single-core baseline {baseline:.4f} "
        f"pair-h/s; matches {'OK' if ok else 'WRONG'}",
        file=sys.stderr,
    )
    result = {
        "metric": "(episode,snippet)-pair audio-hours scanned/sec/"
        f"card (batch scan: {n_episodes} episodes x "
        f"{n_queries} query snippets, 44.1kHz; staging included)",
        "ok": ok,
        "value": round(value, 4),
        "unit": "pair_audio_hours/s",
        "vs_baseline": round(value / baseline, 2),
        "device_resident_value": round(value_scan, 4),
        "device_resident_vs_baseline": round(value_scan / baseline, 2),
        **baseline_provenance(baseline, baseline_measured),
        **extras,
        "fft_impl": config.fft_impl,
        "peaks_impl": config.peaks_impl,
        "device": device,
    }
    if not ok:
        # a wrong-but-fast run must not become the rolling best the
        # regression gate compares against, and callers reading the JSON
        # or exit code must see the failure
        print(json.dumps(result))
        return 2

    record_history(result, fingerprint)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
