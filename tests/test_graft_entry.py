"""Entry-point contract tests (``__graft_entry__.py``).

The dryrun's contract is a virtual CPU mesh: it must go straight to a
clean CPU interpreter and NEVER initialize the default backend of the
calling process (on a GPU host that would reserve most of the card's
memory, and device-count flags cannot be applied after backend init).
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import __graft_entry__ as graft  # noqa: E402


def test_dryrun_reexecs_without_touching_default_backend(monkeypatch):
    """Unless already re-exec'd, the dryrun must go straight to the CPU
    re-exec — no ``jax.devices()`` and no backend init of any kind."""
    import jax

    calls = []
    monkeypatch.delenv("_AM_DRYRUN_REEXEC", raising=False)
    monkeypatch.setattr(graft, "_reexec_dryrun", lambda n: calls.append(n))

    def poisoned_devices(*a, **k):  # pragma: no cover - failure path
        raise AssertionError(
            "dryrun_multichip touched jax.devices() before the CPU "
            "re-exec — it would initialize the caller's default backend"
        )

    monkeypatch.setattr(jax, "devices", poisoned_devices)
    graft.dryrun_multichip(8)
    assert calls == [8]


def test_reexec_env_selects_virtual_cpu_mesh(monkeypatch):
    """The re-exec child must get the CPU platform even when the caller
    selected a GPU, and a >=n device-count flag that REPLACES a smaller
    one."""
    captured = {}

    def fake_run(cmd, cwd=None, env=None):
        captured["env"] = env

        class R:
            returncode = 0

        return R()

    monkeypatch.setattr(subprocess, "run", fake_run)
    monkeypatch.setenv("JAX_PLATFORMS", "cuda")
    monkeypatch.setenv(
        "XLA_FLAGS", "--xla_force_host_platform_device_count=2"
    )
    graft._reexec_dryrun(8)
    env = captured["env"]
    assert env["JAX_PLATFORMS"] == "cpu"
    assert env["_AM_DRYRUN_REEXEC"] == "1"
    assert "--xla_force_host_platform_device_count=8" in env["XLA_FLAGS"]
    assert "device_count=2" not in env["XLA_FLAGS"]


@pytest.mark.slow
@pytest.mark.parametrize("n_devices", [4, 8])
def test_dryrun_completes_on_virtual_cpu_mesh(n_devices):
    """End-to-end: the dryrun completes from a process whose platform
    choice is NOT the CPU — the re-exec path never initializes it. 4 is
    the width of one four-card host: proves the (data × seq)
    factorization and the pad/divisibility logic at that mesh shape."""
    env = dict(os.environ)
    env.pop("_AM_DRYRUN_REEXEC", None)
    env["JAX_PLATFORMS"] = "cuda"
    r = subprocess.run(
        [
            sys.executable,
            "-c",
            f"import __graft_entry__ as g; g.dryrun_multichip({n_devices})",
        ],
        cwd=REPO,
        env=env,
        capture_output=True,
        text=True,
        timeout=600,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    assert "dryrun_multichip OK" in r.stdout
