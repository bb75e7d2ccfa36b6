"""Where the scan's device time goes: one traced C3 scan, reduced to shares.

Stages the canonical batch (4 × 30 min episodes × 64 snippets of
10–13.5 s, int16 wire — ``chip_smoke.C3``), warms the program, then runs
ONE scan under ``jax.profiler.trace`` and sums the device events of the
trace by kernel name into categories:

  * ``fft``   — cuFFT kernels (names containing "fft")
  * ``peaks`` — the Triton peak kernel (``peaks_block_reduce``)
  * ``other`` — everything else XLA launched: the spectrum product, the
    crop/stack of the packed inverse, dequantize, windowing and the jnp
    peak-picking rounds

Busy time is the union of event intervals on the device's kernel lines;
the idle share is 1 − busy / window. Prints the table and writes it to
``chiprun_out/profile_scan.json``. Run on the card:

    python benches/profile_scan.py [--peaks-impl auto|jnp|pallas]
"""

from __future__ import annotations

import argparse
import glob
import json
import sys
import tempfile
import time
from collections import defaultdict
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def category(name: str) -> str:
    low = name.lower()
    if "peaks_block_reduce" in low:
        return "peaks"
    if "fft" in low:
        return "fft"
    return "other"


def reduce_trace(path: str) -> dict:
    """Per-device kernel totals from an ``.xplane.pb`` trace."""
    from jax.profiler import ProfileData

    pd = ProfileData.from_file(path)
    out = {}
    for plane in pd.planes:
        if "gpu" not in plane.name.lower():
            continue
        by_name = defaultdict(float)
        spans = []
        lines = {}
        for line in plane.lines:
            evs = [(e.start_ns, e.duration_ns, e.name) for e in line.events]
            lines[line.name] = len(evs)
            # XLA op lines repeat the kernels' time one level up; keep the
            # stream lines, which hold the kernels themselves
            if "xla op" in line.name.lower() or "module" in line.name.lower():
                continue
            for start, dur, name in evs:
                by_name[name] += dur
                spans.append((start, start + dur))
        if not spans:
            continue
        spans.sort()
        busy, cur_s, cur_e = 0.0, *spans[0]
        for s, e in spans[1:]:
            if s > cur_e:
                busy += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        busy += cur_e - cur_s
        window = spans[-1][1] - spans[0][0]
        total = sum(by_name.values())
        cats = defaultdict(float)
        for name, ns in by_name.items():
            cats[category(name)] += ns
        out[plane.name] = {
            "lines": lines,
            "window_ms": window / 1e6,
            "busy_ms": busy / 1e6,
            "idle_share": 1 - busy / window if window else None,
            "kernel_ms": total / 1e6,
            "category_share": {k: v / total for k, v in cats.items()},
            "top": sorted(
                ((n, ns / 1e6) for n, ns in by_name.items()),
                key=lambda t: -t[1],
            )[:25],
        }
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--peaks-impl", default="auto")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import jax
    import numpy as np

    import chip_smoke
    from audio_matcher_tpu.models.matcher import MatchConfig
    from audio_matcher_tpu.ops.impls import (
        resolve_fft_impl,
        resolve_peaks_impl,
    )
    from audio_matcher_tpu.parallel.mesh import make_mesh
    from audio_matcher_tpu.parallel.sweep import ShardedScanner
    from audio_matcher_tpu.utils.runtime import (
        device_report,
        enable_compile_cache,
    )

    report = device_report()
    if report["platform"] != "gpu":
        print("profile_scan: no GPU", file=sys.stderr)
        return 2
    enable_compile_cache()
    shape = chip_smoke.C3
    rng = np.random.default_rng(args.seed)
    snippets = chip_smoke.make_snippets(shape, rng)
    plan = chip_smoke.plant_plan(shape, snippets)
    episodes = chip_smoke.make_episodes(shape, rng, snippets, plan)
    cfg = MatchConfig(
        transfer_dtype="int16", fft_impl=resolve_fft_impl("auto"),
        peaks_impl=resolve_peaks_impl(args.peaks_impl),
    )
    snips = [s.astype(np.float32) / np.float32(65535.0) for s in snippets]
    sc = ShardedScanner(snips, shape.sr, cfg, mesh=make_mesh(1))
    staged = sc.stage_resident(episodes)
    sc.scan_staged(staged)  # compile + warm
    t0 = time.perf_counter()
    sc.scan_staged(staged)
    untraced = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as td:
        t0 = time.perf_counter()
        with jax.profiler.trace(td):
            sc.scan_staged(staged)
        traced = time.perf_counter() - t0
        (path,) = glob.glob(f"{td}/**/*.xplane.pb", recursive=True)
        result = reduce_trace(path)
    summary = {
        "card": report["card"], "kind": report["kind"],
        "fft_impl": cfg.fft_impl, "peaks_impl": cfg.peaks_impl,
        "scan_s_untraced": untraced, "scan_s_traced": traced,
        "devices": result,
    }
    for dev, r in result.items():
        print(f"[profile] {dev}: window {r['window_ms']:.1f} ms, busy "
              f"{r['busy_ms']:.1f} ms, idle share {r['idle_share']:.3f}, "
              f"kernels {r['kernel_ms']:.1f} ms; shares "
              + ", ".join(f"{k} {v:.3f}"
                          for k, v in sorted(r["category_share"].items()))
              + f" [{report['card']}]")
        print(f"[profile]   lines: {r['lines']}")
        for name, ms in r["top"]:
            print(f"[profile]   {ms:9.2f} ms  {name[:110]}")
    print(f"[profile] scan {untraced:.4f} s untraced, {traced:.4f} s traced "
          f"({cfg.fft_impl}+{cfg.peaks_impl}) [{report['card']}]")
    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / f"profile_scan_{cfg.peaks_impl}.json").write_text(
        json.dumps(summary, indent=1)
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
