"""bench.py history tracking: the regression gate must compare against a
rolling best so successive sub-threshold drops can't compound undetected
and a regressed run never becomes the new baseline (criterion's tracked-
history role, reference benches/my_benchmark.rs)."""

import importlib.util
import json
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def _bench_module():
    spec = importlib.util.spec_from_file_location("bench", REPO / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _entries(path):
    return [json.loads(line) for line in Path(path).read_text().splitlines()]


def _run(mod, path, value):
    mod.record_history(
        {"device_resident_value": value}, {"cfg": 1}, path=str(path)
    )


def test_compounding_drops_are_flagged(tmp_path):
    mod = _bench_module()
    hist = tmp_path / "history.jsonl"
    _run(mod, hist, 10.0)
    _run(mod, hist, 8.6)  # -14% vs best: below threshold, no flag
    assert "regression" not in _entries(hist)[-1]
    _run(mod, hist, 7.4)  # -14% vs previous but -26% vs rolling best
    assert _entries(hist)[-1].get("regression") is True


def test_regressed_run_does_not_become_baseline(tmp_path):
    mod = _bench_module()
    hist = tmp_path / "history.jsonl"
    _run(mod, hist, 10.0)
    _run(mod, hist, 7.0)  # -30%: flagged
    assert _entries(hist)[-1].get("regression") is True
    # a "recovery" to 8.0 is still -20% vs the 10.0 baseline — flagged,
    # because the regressed 7.0 entry is skipped when picking the best
    _run(mod, hist, 8.0)
    assert _entries(hist)[-1].get("regression") is True
    _run(mod, hist, 9.8)  # genuine recovery within threshold
    assert "regression" not in _entries(hist)[-1]


def test_sustained_regression_never_rebaselines(tmp_path):
    """Even after the 5-entry window holds only flagged runs, the gate
    reaches back to the newest clean entry — a 33% sustained drop keeps
    flagging forever instead of quietly becoming the baseline."""
    mod = _bench_module()
    hist = tmp_path / "history.jsonl"
    _run(mod, hist, 30.0)
    for _ in range(7):
        _run(mod, hist, 20.0)
        assert _entries(hist)[-1].get("regression") is True
    _run(mod, hist, 29.0)  # genuine recovery vs the 30.0 baseline
    assert "regression" not in _entries(hist)[-1]


def test_distinct_fingerprints_do_not_interact(tmp_path):
    mod = _bench_module()
    hist = tmp_path / "history.jsonl"
    _run(mod, hist, 10.0)
    mod.record_history(
        {"device_resident_value": 1.0}, {"cfg": 2}, path=str(hist)
    )
    assert "regression" not in _entries(hist)[-1]


def test_spectrogram_fingerprint_is_disjoint_and_mode_dispatched(
    monkeypatch,
):
    """BENCH_MODE=spectrogram entries must never share a fingerprint with
    pcm entries (the regression gate compares same-fingerprint runs), and
    both carry the platform the run was on."""
    mod = _bench_module()
    pcm = mod.expected_fingerprint(mod.make_config(), "gpu")
    spec = mod.expected_fingerprint_spec(mod.make_spec_config(), "gpu")
    assert spec["mode"] == "spectrogram" and "mode" not in pcm
    assert spec != pcm
    assert pcm["backend"] == spec["backend"] == "gpu"
    assert mod.expected_fingerprint(mod.make_config(), "cpu") != pcm


def test_bench_spectrogram_mode_end_to_end(tmp_path, monkeypatch, capsys):
    """BENCH_MODE=spectrogram runs the full bench body (through main's
    mode dispatch) on the CPU backend at a tiny shape: plants found, JSON
    emitted naming the device, fingerprinted history entry appended."""
    monkeypatch.setenv("BENCH_MODE", "spectrogram")
    monkeypatch.setenv("BENCH_EPISODE_SECS", "60")
    monkeypatch.setenv("BENCH_EPISODES", "2")
    monkeypatch.setenv("BENCH_QUERIES", "2")
    hist = tmp_path / "history.jsonl"
    monkeypatch.setenv("BENCH_HISTORY_PATH", str(hist))
    mod = _bench_module()  # re-exec so EPISODE_SECS picks up the env
    assert mod.main() == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["ok"] is True and out["value"] > 0
    assert "spectrogram" in out["metric"]
    assert out["device"]["platform"] == "cpu"
    (entry,) = _entries(hist)
    assert entry["fingerprint"]["mode"] == "spectrogram"
    assert entry["fingerprint"]["backend"] == "cpu"
    assert entry["result"]["device_resident_value"] > 0


def test_bench_pcm_mode_end_to_end(tmp_path, monkeypatch, capsys):
    """The default (pcm) bench body runs end-to-end on the CPU backend at
    a tiny shape — guards the shared _measure_staged_scan/check_plants
    scaffold both gated modes now go through."""
    monkeypatch.setenv("BENCH_EPISODE_SECS", "60")
    monkeypatch.setenv("BENCH_EPISODES", "2")
    monkeypatch.setenv("BENCH_QUERIES", "2")
    # "auto" implementations come from the one resolver: on the CPU the
    # compiled XLA paths, never the Pallas interpreter
    monkeypatch.delenv("BENCH_FFT_IMPL", raising=False)
    monkeypatch.delenv("BENCH_PEAKS_IMPL", raising=False)
    hist = tmp_path / "history.jsonl"
    monkeypatch.setenv("BENCH_HISTORY_PATH", str(hist))
    mod = _bench_module()
    assert mod.main() == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["ok"] is True and out["value"] > 0
    assert (out["fft_impl"], out["peaks_impl"]) == ("xla_packed", "jnp")
    (entry,) = _entries(hist)
    assert entry["fingerprint"]["fft_impl"] == "xla_packed"
    assert entry["fingerprint"]["peaks_impl"] == "jnp"
    assert "mode" not in entry["fingerprint"]
    # every history entry can explain an e2e outlier by its staging rate
    res = entry["result"]
    assert res["stage_secs"] > 0 and res["staged_mb"] > 0
    assert res["stage_mb_s"] > 0 and res["scan_secs"] > 0
    # every entry (clamped or not) records its exact denominator so
    # future clamps read it back instead of reconstructing from rounded
    # value/vs ratios; unclamped entries omit the *_measured twin
    assert res["cpu_baseline"] > 0
    assert "cpu_baseline_measured" not in res


def test_bench_latency_ab_config_end_to_end(tmp_path, monkeypatch, capsys):
    """The single-pair latency configuration (BASELINE config #2):
    EPISODES=1 QUERIES=1, a mulaw8 wire, BENCH_REPEATS medians, and a
    put-byte cap that splits the upload — exercise that exact knob
    combination at a tiny shape so a chip run is never the first time it
    runs."""
    monkeypatch.setenv("BENCH_EPISODE_SECS", "60")
    monkeypatch.setenv("BENCH_EPISODES", "1")
    monkeypatch.setenv("BENCH_QUERIES", "1")
    monkeypatch.setenv("BENCH_TRANSFER_DTYPE", "mulaw8")
    monkeypatch.setenv("BENCH_REPEATS", "3")
    # tiny cap: the 60 s * 44.1 kHz uint8 wire (~2.6 MB) splits into
    # several pieces, covering the piece-split staging path too
    monkeypatch.setenv("AUDIO_MATCHER_PUT_BYTES", str(1 * 2**20))
    monkeypatch.setenv("BENCH_FFT_IMPL", "xla_packed")
    monkeypatch.setenv("BENCH_PEAKS_IMPL", "jnp")
    hist = tmp_path / "history.jsonl"
    monkeypatch.setenv("BENCH_HISTORY_PATH", str(hist))
    mod = _bench_module()
    assert mod.main() == 0
    captured = capsys.readouterr()
    out = json.loads(captured.out.strip().splitlines()[-1])
    assert out["ok"] is True and out["value"] > 0
    # the median-of-N methodology line must report, and repeats must not
    # leak into the history fingerprint
    assert "median of 3" in captured.err
    (entry,) = _entries(hist)
    assert entry["fingerprint"]["transfer_dtype"] == "mulaw8"
    assert "repeats" not in entry["fingerprint"]


def test_cpu_spectrogram_baseline_matches_device_semantics():
    """The scipy baseline pipeline must compute the SAME scores as the
    device path (ops.stft log_mel + fingerprint_scores) — otherwise
    vs_baseline compares against a different algorithm."""
    import numpy as np

    from audio_matcher_tpu.models.spectrogram import SpectrogramConfig
    from audio_matcher_tpu.ops.stft import fingerprint_scores, log_mel

    mod = _bench_module()
    sr = 8000
    rng = np.random.default_rng(11)
    t = np.arange(2 * sr) / sr
    snippet = (0.2 * np.sin(2 * np.pi * 330 * t)).astype(np.float32)
    episode = (rng.standard_normal(20 * sr) * 0.05).astype(np.float32)
    episode[5 * sr : 5 * sr + len(snippet)] += snippet

    cfg = SpectrogramConfig(n_fft=256, hop=64, n_mels=32)
    got = mod.cpu_spectrogram_scores(episode, snippet, cfg, sr=sr)
    want = np.asarray(
        fingerprint_scores(
            log_mel(episode, sr, cfg.n_fft, cfg.hop, cfg.n_mels),
            log_mel(snippet, sr, cfg.n_fft, cfg.hop, cfg.n_mels),
        )
    )
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    # and both see the plant where it was planted (additive sine over
    # noise: the score ridge is a couple of frames wide)
    assert abs(int(got.argmax()) * cfg.hop - 5 * sr) <= 2 * cfg.hop


def test_default_wire_contract(monkeypatch):
    """The bench defaults to the mulaw8 wire, while the user-facing
    surfaces keep the LOSSLESS contract: sweep CLI defaults int16,
    matcher CLI float32, MatchConfig float32. Guards an accidental flip
    of the lossy wire into a default that promises losslessness."""
    for var in ("BENCH_TRANSFER_DTYPE", "BENCH_SLAB"):
        monkeypatch.delenv(var, raising=False)
    mod = _bench_module()
    assert mod.make_config().transfer_dtype == "mulaw8"
    # spectrogram mode keeps int16 so its single-fingerprint history
    # (and the gate comparing against it) stays continuous
    assert mod.make_spec_config().transfer_dtype == "int16"

    from audio_matcher_tpu.cli import matcher_cli, sweep_cli
    from audio_matcher_tpu.models.matcher import MatchConfig

    assert MatchConfig().transfer_dtype == "float32"
    m = matcher_cli.build_parser().parse_args(["ep.mp3", "--snippet", "s.mp3"])
    assert m.transfer == "float32"
    s = sweep_cli.build_parser().parse_args(["*.mp3", "--snippet", "s.mp3"])
    assert s.transfer == "int16"


def test_baseline_clamp_uses_least_starved_history(tmp_path, capsys):
    """vs_baseline's denominator is a CPU measurement on a shared host: a
    starved run inflates the multiplier.
    historical_best_baseline must recover the fastest implied baseline
    for the SAME fingerprint only, and clamped_baseline must prefer it
    over a starved measurement while leaving a faster measurement
    untouched."""
    mod = _bench_module()
    hist = tmp_path / "history.jsonl"
    fp = {"backend": "gpu", "episodes": 4, "queries": 64}
    other = {"backend": "gpu", "episodes": 1, "queries": 1}
    rows = [
        # implied baselines: 32.5/302.07 ≈ 0.1076 and 32.22/722.29 ≈ 0.0446
        {"tag": "bench", "fingerprint": fp,
         "result": {"device_resident_value": 32.5036,
                    "device_resident_vs_baseline": 302.07}},
        {"tag": "bench", "fingerprint": fp,
         "result": {"device_resident_value": 32.2228,
                    "device_resident_vs_baseline": 722.29}},
        # different fingerprint implying a much faster baseline: ignored
        {"tag": "bench", "fingerprint": other,
         "result": {"device_resident_value": 10.0,
                    "device_resident_vs_baseline": 10.0}},
        # degenerate rows must not crash or contribute
        {"tag": "bench", "fingerprint": fp,
         "result": {"device_resident_value": 1.0,
                    "device_resident_vs_baseline": 0}},
        {"tag": "other", "fingerprint": fp},
    ]
    hist.write_text(
        "\n".join(json.dumps(r) for r in rows) + "\nnot json\n"
    )
    best = mod.historical_best_baseline(fp, path=str(hist))
    assert abs(best - 32.5036 / 302.07) < 1e-9

    # entries that carry the exact denominator (cpu_baseline, written by
    # baseline_provenance since r5) are read verbatim — the rounded
    # value/vs ratio would reconstruct it with ~2e-5 relative error that
    # max() only ever ratchets upward
    exact = {"tag": "bench", "fingerprint": fp,
             "result": {"cpu_baseline": 0.114919,
                        "device_resident_value": 32.2646,
                        "device_resident_vs_baseline": 280.76}}
    hist.write_text(
        hist.read_text() + json.dumps(exact) + "\n"
    )
    best = mod.historical_best_baseline(fp, path=str(hist))
    assert best == 0.114919

    import os

    os.environ["BENCH_HISTORY_PATH"] = str(hist)
    try:
        # starved measurement (0.05 < 0.1076): clamp engages and says so
        assert mod.clamped_baseline(0.05, fp) == best
        assert "least-starved" in capsys.readouterr().err
        # least-starved-yet measurement: kept verbatim (and would become
        # the new historical best once its entry lands)
        assert mod.clamped_baseline(0.2, fp) == 0.2
        # unseen fingerprint: no history, measurement kept
        assert mod.clamped_baseline(0.05, {"backend": "gpu"}) == 0.05
    finally:
        del os.environ["BENCH_HISTORY_PATH"]


def test_baseline_clamp_reaches_emitted_vs_baseline(tmp_path, monkeypatch, capsys):
    """End-to-end: seeding history with a faster implied baseline for the
    exact fingerprint of a tiny pcm run must lower the emitted
    vs_baseline (the clamp is wired into the result, not just defined)."""
    monkeypatch.setenv("BENCH_EPISODE_SECS", "60")
    monkeypatch.setenv("BENCH_EPISODES", "2")
    monkeypatch.setenv("BENCH_QUERIES", "2")
    monkeypatch.setenv("BENCH_FFT_IMPL", "xla_packed")
    monkeypatch.setenv("BENCH_PEAKS_IMPL", "jnp")
    hist = tmp_path / "history.jsonl"
    monkeypatch.setenv("BENCH_HISTORY_PATH", str(hist))
    mod = _bench_module()
    fp = mod.expected_fingerprint(mod.make_config(), backend="cpu")
    # implied baseline 1e6 pair-h/s — absurdly fast, so the clamp must
    # force vs_baseline ≈ value/1e6 ≈ 0 regardless of the measured CPU
    hist.write_text(json.dumps({
        "tag": "bench", "when": "2026-08-19T00:00:00+00:00",
        "fingerprint": fp,
        "result": {"device_resident_value": 1e6,
                   "device_resident_vs_baseline": 1.0},
    }) + "\n")
    assert mod.main() == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["ok"] is True
    assert out["vs_baseline"] < 0.01
    assert out["device_resident_vs_baseline"] < 0.01
    # clamp provenance self-documents in the result (and thus history):
    # the used denominator and the starved measurement it replaced
    assert out["cpu_baseline"] == 1e6
    assert 0 < out["cpu_baseline_measured"] < 1e6
    entry = _entries(hist)[-1]
    assert entry["result"]["cpu_baseline"] == 1e6


def test_bench_refuses_a_platform_without_gpu(monkeypatch, capsys):
    """A measurement that finds no card fails (exit 3) instead of timing
    the CPU — unless the caller chose the CPU with JAX_PLATFORMS=cpu."""
    import jax
    import pytest

    mod = _bench_module()

    class FakeDevice:
        platform = "cpu"
        device_kind = "cpu"

    monkeypatch.setattr(jax, "devices", lambda *a: [FakeDevice()])
    monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    with pytest.raises(SystemExit) as exc:
        mod.require_gpu()
    assert exc.value.code == 3
    assert "no GPU" in capsys.readouterr().err
    FakeDevice.platform = "rocm"
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    with pytest.raises(SystemExit):
        mod.require_gpu()  # JAX_PLATFORMS=cpu admits the CPU only


def test_bench_device_report_names_the_device(monkeypatch):
    """On an explicit CPU run the report names the platform, kind and
    count as JAX reports them; the card field is nvidia-smi's line."""
    import jax

    from audio_matcher_tpu.utils import runtime

    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    monkeypatch.setattr(
        runtime, "nvidia_smi_name_power", lambda: "NVIDIA H100, 700.00 W"
    )
    mod = _bench_module()
    report = mod.require_gpu()
    assert report == {
        "platform": jax.devices()[0].platform,
        "kind": jax.devices()[0].device_kind,
        "count": len(jax.devices()),
        "card": "NVIDIA H100, 700.00 W",
    }
