"""chip_smoke.py on the CPU: it refuses to run without a GPU or away from
the repository, and its phase functions pass at tiny sizes (the same
code the card runs at production width)."""

import importlib.util
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]

TINY = dict(sr=4000, episode_secs=120.0, chunk_secs=20.0, distance_secs=30.0,
            snippet_secs=2.0)


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", REPO / "chip_smoke.py"
    )
    mod = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = mod  # dataclasses resolve their module
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def card(smoke):
    return smoke.Card()


def test_main_refuses_without_gpu(smoke, capsys):
    """On the CPU the script exits non-zero and prints no result line."""
    with pytest.raises(SystemExit) as exc:
        smoke.main([])
    assert exc.value.code != 0
    out = capsys.readouterr()
    assert out.out == ""
    assert "no GPU" in out.err


def test_refuses_away_from_the_repository(tmp_path):
    """A directory holding chip_smoke.py and nothing else of the repo:
    non-zero exit, nothing on stdout."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path,
        capture_output=True, text=True, timeout=120,
    )
    assert r.returncode != 0
    assert r.stdout == ""


def test_plant_plan_spacing(smoke):
    """Each query is planted twice, half an episode apart; plants of one
    episode never overlap."""
    shape = smoke.Shape(n_episodes=4, n_queries=64)
    snippets = [np.zeros(int((10 + 0.5 * (q % 8)) * shape.sr), np.int16)
                for q in range(64)]
    plan = smoke.plant_plan(shape, snippets)
    assert sorted(q for p in plan for q in p) == list(range(64))
    for plants in plan:
        spans = sorted(
            (o, o + len(snippets[q])) for q, offs in plants.items()
            for o in offs
        )
        assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
        for offs in plants.values():
            assert offs[1] - offs[0] == int(shape.episode_secs / 2 * shape.sr)


def test_label_positions_recover_samples(smoke, tmp_path):
    from audio_matcher_tpu.hostio.labels import timelabel_from_peaks, \
        write_labels
    from audio_matcher_tpu.ops.peaks import Peak

    sr = 44100
    pos = [926_101, 40_617_353, 158_761_999]
    path = tmp_path / "l.txt"
    write_labels(timelabel_from_peaks([Peak(p, 1.0, 1.0) for p in pos], sr),
                 path)
    assert smoke.label_positions(path, sr) == pos
    path.write_text("")
    assert smoke.label_positions(path, sr) == []


def test_run_phases_records_failures(smoke, capsys):
    def boom():
        raise RuntimeError("phase broke")

    failed = smoke.run_phases([("good", lambda: None), ("bad", boom)])
    assert failed == ["bad"]
    assert "phase bad: FAILED" in capsys.readouterr().out


def test_phase_oracle_tiny(smoke, card):
    shape = smoke.Shape(n_episodes=1, n_queries=2, **TINY)
    smoke.phase_oracle(card, shape, seed=1)


def test_phase_peak_kernel_tiny(smoke, card, capsys):
    smoke.phase_peak_kernel(card, rows=4, width=5000, block=256, seed=2,
                            scipy_rows=2, repeats=1)
    assert "identical to pick_peaks_core and scipy" in capsys.readouterr().out


def test_phase_fft_limit_tiny(smoke, card, monkeypatch):
    """At a lowered element limit the phase exercises fft_rows' chunking
    and compares it with smaller calls."""
    import importlib

    C = importlib.import_module("audio_matcher_tpu.ops.correlate")
    monkeypatch.setattr(C, "FFT_MAX_ELEMENTS", 3 * 256)
    smoke.phase_fft_limit(card, rows=8, n=256, seed=1, chunk=2)


def test_phase_resample_logmel_tiny(smoke, card):
    smoke.phase_resample_logmel(card, 48000, 44100, 2.0, seed=3)


def test_phase_c3_tiny(smoke, card, tmp_path, capsys):
    shape = smoke.Shape(n_episodes=2, n_queries=3, **TINY)
    smoke.phase_c3(card, shape, seed=4, tmp=tmp_path)
    out = capsys.readouterr().out
    assert "C3 sweep_cli: compile" in out and "device-resident" in out


def test_phase_c2_tiny(smoke, card, tmp_path):
    shape = smoke.Shape(n_episodes=1, n_queries=1, **TINY)
    smoke.phase_c2(card, shape, seed=5, tmp=tmp_path)


def test_phase_c4_tiny(smoke, card, tmp_path):
    shape = smoke.Shape(n_episodes=2, n_queries=2,
                        **{**TINY, "sr": 8000, "snippet_secs": 4.0})
    smoke.phase_c4(card, shape, seed=6, tmp=tmp_path)


def test_phase_multi_tiny_on_four_virtual_devices(smoke, card, tmp_path):
    """The --multi comparison on four of the test suite's virtual CPU
    devices: the 4-device sweep equals the 1-device sweep."""
    shape = smoke.Shape(n_episodes=4, n_queries=2, **TINY)
    smoke.phase_multi(card, shape, seed=7, tmp=tmp_path, n_devices=4)


def test_main_multi_runs_only_the_sharded_sweep(smoke, monkeypatch, capsys):
    """``--multi`` runs the sharded sweep and its one-device comparison,
    nothing else, and its last line is the JSON result with the device
    count JAX reports (here the suite's virtual CPU devices)."""
    import json

    import jax

    monkeypatch.setattr(smoke, "require_gpu", lambda: None)
    monkeypatch.setattr(
        smoke, "MULTI", smoke.Shape(n_episodes=4, n_queries=2, **TINY)
    )
    assert smoke.main(["--multi", "--seed", "3"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    phases = [ln for ln in out if "] phase " in ln]
    assert len(phases) == 1 and "phase multi: ok" in phases[0]
    last = json.loads(out[-1])
    assert last == {"ok": True, "device": {
        "platform": jax.devices()[0].platform,
        "kind": jax.devices()[0].device_kind,
        "count": len(jax.devices()),
    }}
