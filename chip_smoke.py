"""On-card smoke test: the snippet-matching scan, compiled for the GPU.

    python chip_smoke.py [--seed N]   # one GPU (the default)
    python chip_smoke.py --multi      # four GPUs of one host

One GPU: equality checks at production width (the pair-packed cuFFT scan
against a float64 numpy/scipy oracle on the int16 wire, the Triton peak
kernel against the XLA picker and scipy on one canonical slab, device
resampling and log-mel against scipy/numpy), then the main path through
the normal entry points, in-process through ``main([...])``, on data made
from ``--seed`` and written as WAV:

  * C3  ``sweep_cli``: 4 × 30 min episodes × 64 snippets of 10–13.5 s
  * C2  ``matcher_cli``: 1 × 1 h episode × 1 snippet
  * C4  ``sweep_cli --mode spectrogram``: 4 × 30 min × 8 snippets

``--multi``: only the sharded archive sweep (``sweep_cli --devices 4``,
8 × 30 min × 64 snippets) and the same files on ``--devices 1``, in one
process; the results must be identical.

Every result line names the card and its power limit. A failed phase
makes the script exit non-zero; only when every phase passed does it print
its last line, ``{"ok": true, "device": {...}}``. Without a GPU, or away
from the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import tempfile
import time
import traceback
import wave
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
SCORE_TOL = 1.2e-5  # the reference's tolerance on normalized scores
PROM_TOL = 1e-6  # kernel vs XLA picker: the same f32 extrema, any order
RESAMPLE_TOL = 1e-5  # max |Δ| vs scipy.resample_poly (signal ≈ ±0.5)
LOGMEL_TOL = 1e-4  # max |Δ| of log-mel vs float64 numpy
# 4 cards vs 1: the same per-episode program; scores may differ only by
# the float32 rounding of differently fused kernels
MULTI_TOL = 1e-6
# the same rows through different batch sizes: the plans may round
# differently, the failure this phase guards against is off by ~1e4
FFT_LIMIT_TOL = 1e-6
PLANT_FIRST_SECS = 21.0


@dataclasses.dataclass(frozen=True)
class Shape:
    """One run's data shape. ``production`` holds the archive deployment;
    tests pass smaller ones."""

    sr: int = 44100
    episode_secs: float = 1800.0
    n_episodes: int = 4
    n_queries: int = 64
    chunk_secs: float = 60.0
    distance_secs: float = 480.0
    snippet_secs: float | None = None  # None → bench's 10–13.5 s cycle

    @property
    def pair_hours(self) -> float:
        return self.n_episodes * self.n_queries * self.episode_secs / 3600


C3 = Shape()
C2 = Shape(episode_secs=3600.0, n_episodes=1, n_queries=1)
C4 = Shape(n_queries=8)
ORACLE = Shape(n_episodes=1, n_queries=4)
MULTI = Shape(n_episodes=8)


def canonical_width(shape: Shape) -> int:
    """Valid correlation columns of one overlap-save window at the
    shape's chunk with the bench's 10–13.5 s queries."""
    sr = shape.sr
    window = int(shape.chunk_secs * sr) + int(13.5 * sr) + 2
    return window - int(10.0 * sr) + 1


def log(msg: str) -> None:
    print(f"[smoke] {msg}", flush=True)


# ------------------------------------------------------------------ data
def make_snippets(shape: Shape, rng) -> list[np.ndarray]:
    """int16 wire snippets (the grid a WAV holds)."""
    from audio_matcher_tpu.models.matcher import quantize_wire

    if shape.snippet_secs is None:
        snips = _bench().make_snippets(rng, shape.n_queries, shape.sr)
    else:
        snips = [
            np.clip(
                rng.standard_normal(int(shape.snippet_secs * shape.sr))
                * 0.15, -0.45, 0.45,
            ).astype(np.float32)
            for _ in range(shape.n_queries)
        ]
    return [quantize_wire(s, "int16") for s in snips]


def plant_plan(shape: Shape, snippets) -> list[dict[int, list[int]]]:
    """Per episode: {query: [sample offsets]}. Every query is planted
    twice in one episode, half an episode apart (≥ the min distance, so
    suppression keeps both), queries spread evenly over the episodes."""
    half = shape.episode_secs / 2
    assert half >= shape.distance_secs, "plants must be ≥ distance apart"
    longest = max(len(s) for s in snippets) / shape.sr
    per_ep = -(-shape.n_queries // shape.n_episodes)
    gap = (half - PLANT_FIRST_SECS - longest) / per_ep
    assert gap > longest, "episode too short for its plants"
    plan = []
    for e in range(shape.n_episodes):
        qs = range(e, shape.n_queries, shape.n_episodes)
        plan.append({
            q: [int((PLANT_FIRST_SECS + j * gap + h) * shape.sr)
                for h in (0.0, half)]
            for j, q in enumerate(qs)
        })
    return plan


def make_episodes(shape: Shape, rng, snippets, plan) -> list[np.ndarray]:
    """int16 wire episodes: noise at 0.05 rms with the planned copies."""
    from audio_matcher_tpu.models.matcher import quantize_wire

    n = int(shape.episode_secs * shape.sr)
    episodes = []
    for plants in plan:
        ep = quantize_wire(
            rng.standard_normal(n, dtype=np.float32) * np.float32(0.05),
            "int16",
        )
        for q, offs in plants.items():
            for off in offs:
                ep[off : off + len(snippets[q])] = snippets[q]
        episodes.append(ep)
    return episodes


def write_wav_mono(path: Path, sr: int, wire: np.ndarray) -> None:
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(np.asarray(wire, "<i2").tobytes())


def write_dataset(root: Path, shape: Shape, seed: int):
    rng = np.random.default_rng(seed)
    snippets = make_snippets(shape, rng)
    plan = plant_plan(shape, snippets)
    episodes = make_episodes(shape, rng, snippets, plan)
    snip_paths, ep_paths = [], []
    for q, s in enumerate(snippets):
        snip_paths.append(root / f"snippet{q:03d}.wav")
        write_wav_mono(snip_paths[-1], shape.sr, s)
    for e, ep in enumerate(episodes):
        ep_paths.append(root / f"episode{e:03d}.wav")
        write_wav_mono(ep_paths[-1], shape.sr, ep)
    return snippets, episodes, plan, snip_paths, ep_paths


# --------------------------------------------------------------- helpers
class Card:
    """The card's identity, printed on every result line."""

    def __init__(self):
        from audio_matcher_tpu.utils.runtime import device_report

        self.report = device_report()
        self.tag = f"[{self.report['card'] or self.report['kind']}]"

    def peak_bytes(self, device=None) -> int | None:
        import jax

        stats = (device or jax.devices()[0]).memory_stats()
        return None if stats is None else stats.get("peak_bytes_in_use")


@contextlib.contextmanager
def captured_sweep_results():
    """Record what ``sweep_cli`` gets back from ``sweep_archive`` (the
    CLI itself only writes labels); the CLI path is otherwise untouched."""
    from audio_matcher_tpu.cli import sweep_cli

    got = []
    orig = sweep_cli.sweep_archive

    def recording(*a, **k):
        got.append(orig(*a, **k))
        return got[-1]

    sweep_cli.sweep_archive = recording
    try:
        yield got
    finally:
        sweep_cli.sweep_archive = orig


def label_positions(path: Path, sr: int) -> list[int]:
    """Peak positions (samples) recovered from a label file: n peaks make
    n-1 labels [p_i + 7 s, p_{i+1}) written with 6 decimals."""
    from audio_matcher_tpu.hostio.labels import read_labels

    labels = read_labels(path)
    if not labels:
        return []
    pos = [round((lb.start - 7.0) * sr) for lb in labels]
    return pos + [round(labels[-1].end * sr)]


def _bench():
    """bench.py (beside this script) holds the shared snippet generator
    and the stage → compile → scan timer."""
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    import bench

    return bench


def timed_scan(scanner, episodes, repeats: int = 3) -> dict:
    """A scanner's resident path through bench.stage_and_scan."""
    return _bench().stage_and_scan(
        lambda: scanner.stage_resident(episodes),
        scanner.scan_staged, repeats,
    )


def report_run(card, name, shape, t: dict, cli_s: float):
    stage_s, nbytes = t["stage_s"], t["staged_bytes"]
    compile_s, scan_s = t["compile_s"], t["scan_s"]
    mb_s = nbytes / 1e6 / stage_s if stage_s > 0 else float("inf")
    log(
        f"{name}: compile {compile_s:.1f} s | staging {nbytes / 1e6:.0f} MB "
        f"at {mb_s:.0f} MB/s | scan {scan_s:.4f} s | pair-audio-h/s "
        f"{shape.pair_hours / cli_s:.2f} end to end (CLI, decode incl.), "
        f"{shape.pair_hours / (stage_s + scan_s):.2f} staged+scan, "
        f"{shape.pair_hours / scan_s:.2f} device-resident | "
        f"peak_bytes_in_use {card.peak_bytes()} {card.tag}"
    )


def pcm_config(shape: Shape, transfer: str, overlap_secs=None):
    from audio_matcher_tpu.models.matcher import MatchConfig
    from audio_matcher_tpu.ops.impls import (
        resolve_fft_impl,
        resolve_peaks_impl,
    )

    return MatchConfig(
        chunk_secs=shape.chunk_secs, distance_secs=shape.distance_secs,
        transfer_dtype=transfer, overlap_secs=overlap_secs,
        fft_impl=resolve_fft_impl("auto"),
        peaks_impl=resolve_peaks_impl("auto"),
    )


def check_pcm_peaks(results, plan, label):
    """Sample-exact: each planted (episode, query) finds exactly its plant
    positions among peaks scoring > 0.5, and no other pair finds any."""
    bad = []
    for e, plants in enumerate(plan):
        for q, per_q in enumerate(results[e]):
            got = sorted(p.position for p in per_q if p.height > 0.5)
            want = sorted(plants.get(q, []))
            if got != want:
                bad.append((e, q, got, want))
    if bad:
        raise AssertionError(f"{label}: {len(bad)} wrong pairs, e.g. {bad[:3]}")


# ---------------------------------------------------------------- phases
def phase_oracle(card, shape: Shape, seed: int):
    """xla_packed scan (int16 wire) vs a float64 numpy/scipy oracle of
    the same overlap-save windows, peak rules and cross-window dedup."""
    import scipy.fft
    import scipy.signal

    from audio_matcher_tpu.parallel.mesh import make_mesh
    from audio_matcher_tpu.parallel.sweep import ShardedScanner

    rng = np.random.default_rng(seed)
    snippets = make_snippets(shape, rng)
    plan = plant_plan(shape, snippets)
    episodes = make_episodes(shape, rng, snippets, plan)
    cfg = pcm_config(shape, "int16")
    snips_f32 = [s.astype(np.float32) / np.float32(65535.0) for s in snippets]
    sc = ShardedScanner(snips_f32, shape.sr, cfg, mesh=make_mesh(1))
    got = sc.scan_resident(episodes)
    log(f"oracle: scanned {shape.n_episodes} x {shape.episode_secs:.0f} s x "
        f"{shape.n_queries} queries, fft {sc.fft_len}, "
        f"{cfg.fft_impl}+{cfg.peaks_impl} {card.tag}")

    chunk, window = sc.chunk, sc.window
    dist = int(shape.distance_secs) * shape.sr
    workers = os.cpu_count() or 1
    s64 = [s.astype(np.float64) for s in snips_f32]
    L = scipy.fft.next_fast_len(window + max(map(len, s64)) - 1, real=True)
    sfs = [np.conj(scipy.fft.rfft(s, L, workers=workers)) for s in s64]
    inv_acs = [1.0 / float(np.sum(s * s)) for s in s64]
    worst_h = worst_p = 0.0
    n_cmp = 0
    for e, ep in enumerate(episodes):
        x = ep.astype(np.float64) / 65535.0
        cands = [{} for _ in s64]  # per query: position → (score, prom)
        for k in range(-(-len(x) // chunk)):
            win = x[k * chunk : k * chunk + window]
            xf = scipy.fft.rfft(win, L, workers=workers)
            for q, s in enumerate(s64):
                valid = len(win) - len(s) + 1
                if valid < 3:
                    continue
                c = scipy.fft.irfft(xf * sfs[q], L, workers=workers)
                c = c[:valid] * inv_acs[q]
                idx, props = scipy.signal.find_peaks(
                    c, distance=max(dist, 1),
                    prominence=(cfg.min_prominence, None),
                )
                for i, pr in zip(idx, props["prominences"]):
                    pos = int(i) + k * chunk
                    if pos not in cands[q] or pr > cands[q][pos][1]:
                        cands[q][pos] = (float(c[i]), float(pr))
        for q, cq in enumerate(cands):
            order = sorted(cq)
            want = []
            for i, pos in enumerate(order):
                shadowed = any(
                    0 <= j < len(order)
                    and abs(order[j] - pos) / shape.sr < shape.distance_secs
                    and cq[order[j]][1] > cq[pos][1]
                    for j in (i - 1, i + 1)
                )
                if not shadowed:
                    want.append((pos, *cq[pos]))
            have = [(p.position, p.height, p.prominence) for p in got[e][q]]
            if [w[0] for w in want] != [h[0] for h in have]:
                raise AssertionError(
                    f"oracle: episode {e} query {q} positions "
                    f"{[h[0] for h in have]} != oracle {[w[0] for w in want]}"
                )
            if sorted(plan[e].get(q, [])) != [w[0] for w in want]:
                raise AssertionError(f"oracle: plants lost at e{e} q{q}")
            for (_, wh, wp), (_, hh, hp) in zip(want, have):
                worst_h = max(worst_h, abs(wh - hh))
                worst_p = max(worst_p, abs(wp - hp))
                n_cmp += 1
    log(f"oracle: {n_cmp} peaks, positions sample-exact, max |Δscore| "
        f"{worst_h:.2e}, max |Δprominence| {worst_p:.2e} "
        f"(tolerance {SCORE_TOL:g}) {card.tag}")
    if worst_h > SCORE_TOL or worst_p > SCORE_TOL:
        raise AssertionError("oracle: scores outside the tolerance")


def phase_peak_kernel(card, rows: int, width: int, block: int, seed: int,
                      scipy_rows: int = 4, repeats: int = 5):
    """The Triton peak kernel's picker vs the XLA picker (pick_peaks_core)
    and scipy on one [rows, width] slab; times both pickers."""
    import jax
    import jax.numpy as jnp
    import scipy.signal

    from audio_matcher_tpu.ops.impls import pallas_interpret
    from audio_matcher_tpu.ops.pallas_kernels import local_max_block_reduce
    from audio_matcher_tpu.ops.peaks import (
        peaks_crop_width,
        pick_peaks_core,
        pick_peaks_pallas,
    )

    V = peaks_crop_width(width, block, "pallas")
    distance = 480 * 44100
    n_peaks = 2
    interpret = pallas_interpret()
    key = jax.random.PRNGKey(seed)
    k1, k2, k3 = jax.random.split(key, 3)

    @jax.jit
    def make(k1, k2, k3):
        x = jax.random.normal(k1, (rows, V), jnp.float32) * 0.01
        pos = jax.random.randint(k2, (rows,), 1, width - 1)
        x = x.at[jnp.arange(rows), pos].add(1.0)
        valid = jax.random.randint(k3, (rows,), width // 2, width + 1)
        return x, valid.astype(jnp.int32)

    x, valid = make(k1, k2, k3)
    core = jax.jit(lambda x, v: pick_peaks_core(x, v, distance, n_peaks, block))
    kern = jax.jit(lambda x, v: pick_peaks_pallas(
        x, v, distance, n_peaks, block, interpret=interpret))
    reduce_only = jax.jit(lambda x, v: local_max_block_reduce(
        x, v, block=block, interpret=interpret))

    def timed(fn):
        out = jax.block_until_ready(fn(x, valid))  # compile + warm
        ts = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(x, valid))
            ts.append(time.perf_counter() - t0)
        return out, float(np.median(ts))

    want, t_core = timed(core)
    got, t_kern = timed(kern)
    _, t_reduce = timed(reduce_only)
    wpos, wh, wprom = (np.asarray(a) for a in want)
    gpos, gh, gprom = (np.asarray(a) for a in got)
    live = np.isfinite(wh)
    if not ((np.isfinite(gh) == live).all()
            and (gpos[live] == wpos[live]).all()
            and (gh[live] == wh[live]).all()):
        raise AssertionError("peak kernel: positions/heights differ from XLA")
    dprom = float(np.max(np.abs(gprom[live] - wprom[live]), initial=0.0))
    if dprom > PROM_TOL:
        raise AssertionError(f"peak kernel: |Δprominence| {dprom:.2e}")
    # scipy on a few rows: the greedy-by-height prefix of its
    # distance-filtered peaks, with scipy's own prominences
    xs = np.asarray(x[:scipy_rows]).astype(np.float64)
    vs = np.asarray(valid[:scipy_rows])
    worst = 0.0
    for r in range(scipy_rows):
        row = xs[r, : vs[r]]
        idx, _ = scipy.signal.find_peaks(row, distance=distance)
        top = sorted(idx, key=lambda i: -row[i])[:n_peaks]
        mine = [int(p) for p, h in zip(gpos[r], gh[r]) if np.isfinite(h)]
        if sorted(mine) != sorted(int(i) for i in top):
            raise AssertionError(f"peak kernel: row {r} {mine} vs scipy {top}")
        proms = scipy.signal.peak_prominences(row, mine)[0]
        for p, h, pr, spr in zip(mine, gh[r], gprom[r], proms):
            if h != np.float32(row[p]):
                raise AssertionError(f"peak kernel: height at {p}")
            worst = max(worst, abs(float(pr) - float(spr)))
    if worst > PROM_TOL:
        raise AssertionError(f"peak kernel: scipy |Δprominence| {worst:.2e}")
    log(f"peak kernel: [{rows} x {V}] f32 slab, block {block}: positions "
        f"and heights identical to pick_peaks_core and scipy ({scipy_rows} "
        f"rows), max |Δprominence| {max(dprom, worst):.1e} (tolerance "
        f"{PROM_TOL:g}) | picker ms: XLA {t_core * 1e3:.2f}, Triton-kernel "
        f"picker {t_kern * 1e3:.2f} (kernel pass alone {t_reduce * 1e3:.2f}) "
        f"| peak_bytes_in_use {card.peak_bytes()} {card.tag}")


def phase_fft_limit(card, rows: int, n: int, seed: int, chunk: int = 64):
    """A batched inverse FFT whose output reaches 2**31 elements (where
    cuFFT through XLA returns wrong values) must equal the same rows
    transformed ``chunk`` at a time: ``fft_rows`` splits such calls."""
    import jax
    import jax.numpy as jnp

    from audio_matcher_tpu.ops.correlate import FFT_MAX_ELEMENTS, fft_rows

    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    f = n // 2 + 1
    x = (jax.random.normal(k1, (rows, f))
         + 1j * jax.random.normal(k2, (rows, f))).astype(jnp.complex64)
    whole = jax.jit(lambda x: fft_rows("irfft", x, n))(x)
    part = jax.jit(lambda x: jnp.fft.irfft(x, n=n))
    worst = max(
        float(jnp.max(jnp.abs(whole[s : s + chunk] - part(x[s : s + chunk]))))
        for s in range(0, rows, chunk)
    )
    del whole, x
    log(f"fft limit: irfft [{rows} x {n}] ({rows * n} output elements, "
        f"limit {FFT_MAX_ELEMENTS}) via fft_rows vs {chunk}-row calls: "
        f"max |Δ| {worst:.1e} {card.tag}")
    if worst > FFT_LIMIT_TOL:
        raise AssertionError("fft limit: chunked transform differs")


def phase_resample_logmel(card, sr_in: int, sr_out: int, secs: float,
                          seed: int):
    """Device resample (polyphase convolution) vs scipy.resample_poly and
    device log-mel vs a float64 numpy log-mel — both at HIGHEST precision
    (a GPU would otherwise run f32 matmuls/convolutions in TF32)."""
    from math import gcd

    import scipy.signal

    from audio_matcher_tpu.hostio.decode import resample
    from audio_matcher_tpu.ops.stft import log_mel, mel_filterbank

    rng = np.random.default_rng(seed)
    t = np.arange(int(secs * sr_in)) / sr_in
    x = (0.2 * np.sin(2 * np.pi * 440.0 * t)
         + rng.standard_normal(len(t)) * 0.05).astype(np.float32)
    got = resample(x, sr_in, sr_out, impl="device")
    g = gcd(sr_in, sr_out)
    want = scipy.signal.resample_poly(
        x.astype(np.float64), sr_out // g, sr_in // g
    )
    d_res = float(np.max(np.abs(got - want[: len(got)])))
    if len(got) != len(want) or d_res > RESAMPLE_TOL:
        raise AssertionError(
            f"resample: len {len(got)}/{len(want)}, max |Δ| {d_res:.2e}"
        )
    n_fft, hop, n_mels = 1024, 256, 64
    y = np.asarray(want, np.float32)
    lm = np.asarray(log_mel(y, sr_out, n_fft, hop, n_mels))
    fb_t = np.asarray(mel_filterbank(n_mels, n_fft, sr_out), np.float64).T
    frames = np.lib.stride_tricks.sliding_window_view(
        y.astype(np.float64), n_fft
    )[::hop][: lm.shape[0]]
    z = np.fft.rfft(frames * np.hanning(n_fft), axis=1)
    ref = np.log((z.real ** 2 + z.imag ** 2) @ fb_t + 1e-8)
    d_lm = float(np.max(np.abs(lm - ref)))
    if lm.shape != ref.shape or d_lm > LOGMEL_TOL:
        raise AssertionError(f"log-mel: max |Δ| {d_lm:.2e}")
    log(f"resample {sr_in}->{sr_out} Hz, {secs:.0f} s: max |Δ| vs scipy "
        f"{d_res:.2e} (tolerance {RESAMPLE_TOL:g}); log-mel "
        f"[{lm.shape[0]} x {n_mels}]: max |Δ| vs float64 numpy {d_lm:.2e} "
        f"(tolerance {LOGMEL_TOL:g}) {card.tag}")


def phase_c3(card, shape: Shape, seed: int, tmp: Path):
    """C3: sweep_cli over the canonical archive batch (int16 wire)."""
    from audio_matcher_tpu.cli import sweep_cli
    from audio_matcher_tpu.meta.progress import Progress, State
    from audio_matcher_tpu.parallel.mesh import make_mesh
    from audio_matcher_tpu.parallel.sweep import ShardedScanner

    snippets, episodes, plan, snip_paths, ep_paths = write_dataset(
        tmp, shape, seed
    )
    snips_f32 = [s.astype(np.float32) / np.float32(65535.0) for s in snippets]
    cfg = pcm_config(shape, "int16")
    sc = ShardedScanner(snips_f32, shape.sr, cfg, mesh=make_mesh(1))
    timing = timed_scan(sc, episodes)
    nbytes = timing["staged_bytes"]
    check_pcm_peaks(timing["results"], plan, "C3 resident")
    rates = []
    for cap in (None, str(64 << 20), "0"):
        with _env("AUDIO_MATCHER_PUT_BYTES", cap):
            t0 = time.perf_counter()
            staged = sc.stage_resident(episodes)
            pieces = staged[0] if isinstance(staged[0], tuple) else (staged[0],)
            for p in pieces:
                p.block_until_ready()
            dt = time.perf_counter() - t0
            rates.append(f"{cap or 'default'}: {len(pieces)} put(s) "
                         f"{nbytes / 1e6 / dt:.0f} MB/s")
            del staged, pieces
    log(f"C3 staging by AUDIO_MATCHER_PUT_BYTES: {'; '.join(rates)} "
        f"{card.tag}")

    progress = tmp / "c3.done.txt"
    argv = [str(p) for p in ep_paths]
    for sp in snip_paths:
        argv += ["--snippet", str(sp)]
    argv += [
        "--chunk-size", f"{shape.chunk_secs:g}",
        "--distance", f"{shape.distance_secs:g}",
        "--progress-file", str(progress), "--transfer", "int16", "--silent",
    ]
    with captured_sweep_results() as got:
        t0 = time.perf_counter()
        rc = sweep_cli.main(argv)
        cli_s = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"C3: sweep_cli exited {rc}")
    (res,) = got
    check_pcm_peaks([res[str(p)] for p in ep_paths], plan, "C3 sweep_cli")
    done = Progress(progress)
    for e, p in enumerate(ep_paths):
        if done.get(str(p)) != State.DONE:
            raise AssertionError(f"C3: {p.name} not marked done")
        for q in range(shape.n_queries):
            lab = p.with_suffix(f".q{q}.txt") if shape.n_queries > 1 \
                else p.with_suffix(".txt")
            if label_positions(lab, shape.sr) != sorted(plan[e].get(q, [])):
                raise AssertionError(f"C3: label file {lab.name}")
    log(f"C3: {sum(len(p) for p in plan) * 2} plants sample-exact through "
        f"sweep_cli; {shape.n_episodes * shape.n_queries} label files and "
        f"the progress file written {card.tag}")
    report_run(card, "C3 sweep_cli", shape, timing, cli_s)


def phase_c2(card, shape: Shape, seed: int, tmp: Path):
    """C2: matcher_cli on one long episode and one snippet (the CLI's
    default float32 wire and live progress bar)."""
    from audio_matcher_tpu.cli import matcher_cli
    from audio_matcher_tpu.models.matcher import SnippetMatcher

    rng = np.random.default_rng(seed)
    snippets = make_snippets(shape, rng)
    m = len(snippets[0])
    # three plants (≥ distance apart) → two labels to check
    third = shape.episode_secs / 3
    assert third >= shape.distance_secs
    plan = [{0: [int((PLANT_FIRST_SECS + k * third) * shape.sr)
                 for k in range(3)]}]
    (episode,) = make_episodes(shape, rng, snippets, plan)
    snip_path, ep_path = tmp / "c2_snippet.wav", tmp / "c2_episode.wav"
    write_wav_mono(snip_path, shape.sr, snippets[0])
    write_wav_mono(ep_path, shape.sr, episode)

    snip = snippets[0].astype(np.float32) / np.float32(65535.0)
    cfg = pcm_config(shape, "float32", overlap_secs=m / shape.sr)
    matcher = SnippetMatcher(snip, shape.sr, cfg)
    samples = episode.astype(np.float32) / np.float32(65535.0)

    timing = _bench().stage_and_scan(
        lambda: matcher.stage(samples),
        lambda staged: matcher.match_staged(
            staged, progress=lambda *_: None
        ),
        3,
    )
    peaks = timing["results"]
    if sorted(p.position for p in peaks if p.height > 0.5) != plan[0][0]:
        raise AssertionError(f"C2: resident peaks {peaks}")

    out = tmp / "c2_labels.txt"
    t0 = time.perf_counter()
    rc = matcher_cli.main([
        str(ep_path), "--snippet", str(snip_path), "-o", str(out),
        "--chunk-size", f"{shape.chunk_secs:g}",
        "--distance", f"{shape.distance_secs:g}", "--silent",
    ])
    cli_s = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"C2: matcher_cli exited {rc}")
    if label_positions(out, shape.sr) != plan[0][0]:
        raise AssertionError(
            f"C2: labels {label_positions(out, shape.sr)} != {plan[0][0]}"
        )
    log(f"C2: 3 plants sample-exact in the matcher_cli label file {card.tag}")
    report_run(card, "C2 matcher_cli", shape, timing, cli_s)


def phase_c4(card, shape: Shape, seed: int, tmp: Path):
    """C4: sweep_cli --mode spectrogram (log-mel NCC; frame-accurate, so
    plants must land within one hop)."""
    from audio_matcher_tpu.cli import sweep_cli
    from audio_matcher_tpu.models.spectrogram import SpectrogramConfig
    from audio_matcher_tpu.parallel.mesh import make_mesh
    from audio_matcher_tpu.parallel.sweep import ShardedSpectrogramScanner

    snippets, episodes, plan, snip_paths, ep_paths = write_dataset(
        tmp, shape, seed
    )
    cfg = SpectrogramConfig(
        distance_secs=shape.distance_secs, transfer_dtype="int16"
    )
    hop = cfg.hop
    snips_f32 = [s.astype(np.float32) / np.float32(65535.0) for s in snippets]
    sc = ShardedSpectrogramScanner(snips_f32, shape.sr, cfg, mesh=make_mesh(1))
    timing = timed_scan(sc, episodes)

    def check(res, label):
        for e, plants in enumerate(plan):
            for q, per_q in enumerate(res[e]):
                got = sorted(p.position for p in per_q)
                want = sorted(plants.get(q, []))
                if len(got) != len(want) or any(
                    abs(a - b) > hop for a, b in zip(got, want)
                ):
                    raise AssertionError(f"{label}: e{e} q{q} {got} vs {want}")

    check(timing["results"], "C4 resident")
    argv = [str(p) for p in ep_paths]
    for sp in snip_paths:
        argv += ["--snippet", str(sp)]
    argv += ["--mode", "spectrogram", "--distance", f"{shape.distance_secs:g}",
             "--transfer", "int16", "--silent"]
    with captured_sweep_results() as got:
        t0 = time.perf_counter()
        rc = sweep_cli.main(argv)
        cli_s = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"C4: sweep_cli exited {rc}")
    check([got[0][str(p)] for p in ep_paths], "C4 sweep_cli")
    for e, p in enumerate(ep_paths):
        for q in range(shape.n_queries):
            pos = label_positions(p.with_suffix(f".q{q}.txt"), shape.sr)
            want = sorted(plan[e].get(q, []))
            if len(pos) != len(want) or any(
                abs(a - b) > hop for a, b in zip(pos, want)
            ):
                raise AssertionError(f"C4: labels e{e} q{q}")
    log(f"C4: {sum(len(p) for p in plan) * 2} plants within one hop "
        f"({hop} samples) through sweep_cli --mode spectrogram {card.tag}")
    report_run(card, "C4 sweep_cli spectrogram", shape, timing, cli_s)


def phase_multi(card, shape: Shape, seed: int, tmp: Path, n_devices: int):
    """The sharded archive sweep on ``n_devices`` cards vs one card."""
    import jax

    from audio_matcher_tpu.cli import sweep_cli

    snippets, episodes, plan, snip_paths, ep_paths = write_dataset(
        tmp, shape, seed
    )
    del episodes
    argv = [str(p) for p in ep_paths]
    for sp in snip_paths:
        argv += ["--snippet", str(sp)]
    argv += ["--chunk-size", f"{shape.chunk_secs:g}",
             "--distance", f"{shape.distance_secs:g}",
             "--transfer", "int16", "--no-out", "--silent"]
    runs = {}
    for n in (n_devices, 1):
        with captured_sweep_results() as got:
            t0 = time.perf_counter()
            rc = sweep_cli.main(argv + ["--devices", str(n)])
            dt = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"multi: sweep_cli --devices {n} exited {rc}")
        runs[n] = got[0]
        peaks = [card.peak_bytes(d) for d in jax.devices()]
        log(f"multi: --devices {n}: {dt:.1f} s (compile incl.), "
            f"{shape.pair_hours / dt:.2f} pair-audio-h/s; peak_bytes_in_use "
            f"per device {peaks} {card.tag}")
        # memory statistics exist on the GPU (not on the CPU): every card
        # of the mesh must have held arrays
        if n > 1 and peaks[0] is not None and not all(peaks[:n]):
            raise AssertionError("multi: a card of the mesh did no work")
    check_pcm_peaks([runs[1][str(p)] for p in ep_paths], plan, "multi 1-card")
    worst = 0.0
    for p in ep_paths:
        for a, b in zip(runs[n_devices][str(p)], runs[1][str(p)]):
            if [x.position for x in a] != [x.position for x in b]:
                raise AssertionError(f"multi: positions differ for {p.name}")
            for x, y in zip(a, b):
                worst = max(worst, abs(x.height - y.height),
                            abs(x.prominence - y.prominence))
    if worst > MULTI_TOL:
        raise AssertionError(f"multi: scores differ by up to {worst:.2e}")
    log(f"multi: {n_devices}-card sweep matches the 1-card sweep "
        f"({shape.n_episodes} x {shape.episode_secs:.0f} s x "
        f"{shape.n_queries} queries): same peaks, max |Δscore| "
        f"{worst:.2e} ({'bitwise identical' if worst == 0 else 'rounding'}"
        f", tolerance {MULTI_TOL:g}) {card.tag}")


@contextlib.contextmanager
def _env(name, value):
    old = os.environ.get(name)
    if value is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = old


# ------------------------------------------------------------------ main
def require_gpu():
    """The device check; exits non-zero (printing no result) without the
    repository beside this script or without a GPU."""
    if not (REPO / "audio_matcher_tpu" / "__init__.py").is_file():
        print("chip_smoke: the audio_matcher_tpu package is not beside this "
              "script", file=sys.stderr)
        raise SystemExit(2)
    sys.path.insert(0, str(REPO))
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: JAX found no GPU (platform {dev.platform!r})",
              file=sys.stderr)
        raise SystemExit(2)


def run_phases(phases) -> list[str]:
    """Run (name, fn) pairs; a failure is printed and recorded, never
    swallowed into a passing exit."""
    failed = []
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            fn()
            status = "ok"
        except Exception:  # noqa: BLE001 — reported, and fails the run
            traceback.print_exc()
            failed.append(name)
            status = "FAILED"
        log(f"phase {name}: {status} in {time.perf_counter() - t0:.1f} s")
    return failed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--multi", action="store_true",
                    help="run only the sharded sweep on four cards vs one")
    args = ap.parse_args(argv)
    require_gpu()
    import jax

    from audio_matcher_tpu.utils.runtime import enable_compile_cache

    card = Card()
    r = card.report
    log(f"device: {r['platform']} {r['kind']} x{r['count']}")
    log(f"card (nvidia-smi name, power.limit): {r['card']}")
    log(f"compile cache: {enable_compile_cache() or 'off'}")
    seed = args.seed
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as td:
        tmp = Path(td)
        if args.multi:
            n = 4
            if len(jax.devices()) < n:
                print(f"chip_smoke: --multi needs {n} GPUs, found "
                      f"{len(jax.devices())}", file=sys.stderr)
                return 2
            phases = [("multi", lambda: phase_multi(card, MULTI, seed, tmp, n))]
        else:
            def sub(name):
                d = tmp / name
                d.mkdir()
                return d

            phases = [
                ("oracle", lambda: phase_oracle(card, ORACLE, seed)),
                ("peak_kernel", lambda: phase_peak_kernel(
                    card, rows=8 * 64, width=canonical_width(C3),
                    block=2048, seed=seed)),
                ("fft_limit", lambda: phase_fft_limit(
                    card, rows=512, n=1 << 22, seed=seed)),
                ("resample_logmel", lambda: phase_resample_logmel(
                    card, 48000, 44100, 60.0, seed)),
                ("C3", lambda: phase_c3(card, C3, seed, sub("c3"))),
                ("C2", lambda: phase_c2(card, C2, seed, sub("c2"))),
                ("C4", lambda: phase_c4(card, C4, seed, sub("c4"))),
            ]
        failed = run_phases(phases)
    if failed:
        log(f"FAILED phases: {failed}")
        return 1
    dev = jax.devices()[0]
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": dev.platform,
            "kind": dev.device_kind,
            "count": len(jax.devices()),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
