"""The one platform → implementation decision (ops/impls.py) and the
process runtime set-up (utils/runtime.py): compile-cache placement and
the device report."""

import pytest

from audio_matcher_tpu.ops import impls
from audio_matcher_tpu.utils import runtime


@pytest.mark.parametrize("platform,choice,fft,peaks", [
    ("gpu", "auto", "xla_packed", "pallas"),
    ("cpu", "auto", "xla_packed", "jnp"),
    ("gpu", "xla", "xla", None),
    ("cpu", "mxu", "mxu", None),
    ("gpu", "jnp", None, "jnp"),
    ("cpu", "pallas", None, "pallas"),
])
def test_resolver_choices(monkeypatch, platform, choice, fft, peaks):
    import jax

    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    if fft is not None:
        assert impls.resolve_fft_impl(choice) == fft
    if peaks is not None:
        assert impls.resolve_peaks_impl(choice) == peaks


@pytest.mark.parametrize("platform,interpret", [("gpu", False),
                                                ("cpu", True)])
def test_pallas_interpret_only_on_cpu(monkeypatch, platform, interpret):
    import jax

    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    assert impls.pallas_interpret() is interpret


@pytest.mark.parametrize("call", [
    impls.pallas_interpret,
    impls.resolve_fft_impl,
    impls.resolve_peaks_impl,
    impls.platform,
])
def test_unsupported_platform_is_an_error(monkeypatch, call):
    """Any other platform is refused — never an interpreted fallback."""
    import jax

    monkeypatch.setattr(jax, "default_backend", lambda: "rocm")
    with pytest.raises(RuntimeError, match="unsupported JAX platform"):
        call()


@pytest.mark.parametrize("resolve,bad", [
    (impls.resolve_fft_impl, "vpu"),
    (impls.resolve_peaks_impl, "fused"),
])
def test_unknown_choice_is_an_error(resolve, bad):
    with pytest.raises(ValueError, match="unknown"):
        resolve(bad)


def test_compile_cache_env_wins(monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR set: it is used and nothing else is
    configured — even on a GPU."""
    import jax

    monkeypatch.setenv(runtime.CACHE_ENV, str(tmp_path))
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    updates = []
    monkeypatch.setattr(jax.config, "update", lambda *a: updates.append(a))
    assert runtime.enable_compile_cache() == str(tmp_path)
    assert updates == []


def test_compile_cache_gpu_default_is_fixed_in_checkout(monkeypatch):
    """Env unset on a GPU: the fixed in-checkout directory, the same on
    every call (a moving path would never hit)."""
    import jax

    monkeypatch.delenv(runtime.CACHE_ENV, raising=False)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    made = []
    monkeypatch.setattr(
        type(runtime.DEFAULT_CACHE_DIR), "mkdir",
        lambda self, **kw: made.append(self),
    )
    updates = []
    monkeypatch.setattr(jax.config, "update", lambda *a: updates.append(a))
    first = runtime.enable_compile_cache()
    assert first == runtime.enable_compile_cache()
    assert first == str(runtime.DEFAULT_CACHE_DIR)
    assert runtime.DEFAULT_CACHE_DIR.name == ".jax_cache"
    assert runtime.DEFAULT_CACHE_DIR.parent.joinpath("chip_smoke.py").exists()
    assert updates == [("jax_compilation_cache_dir", first)] * 2


def test_compile_cache_off_on_cpu(monkeypatch):
    import jax

    monkeypatch.delenv(runtime.CACHE_ENV, raising=False)
    updates = []
    monkeypatch.setattr(jax.config, "update", lambda *a: updates.append(a))
    assert jax.default_backend() == "cpu"
    assert runtime.enable_compile_cache() is None
    assert updates == []


def test_nvidia_smi_absent_is_none(monkeypatch):
    """No nvidia-smi (this CPU host): the card field is None, not an
    exception; a present one yields its first line."""
    import subprocess

    def missing(*a, **k):
        raise FileNotFoundError("nvidia-smi")

    monkeypatch.setattr(subprocess, "run", missing)
    assert runtime.nvidia_smi_name_power() is None

    class R:
        returncode = 0
        stdout = "NVIDIA H100 80GB HBM3, 700.00 W\n"

    monkeypatch.setattr(subprocess, "run", lambda *a, **k: R())
    assert runtime.nvidia_smi_name_power() == "NVIDIA H100 80GB HBM3, 700.00 W"
