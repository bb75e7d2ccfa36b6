"""Multi-host story (SURVEY §5 distributed backend; BASELINE config #5).

Launches a REAL 2-process jax.distributed cluster on CPU (coordinator +
worker over loopback), runs the archive sweep in both processes, and
checks the merged peaks equal a single-process sweep — the multi-process
layout where whole episodes are assigned per process and scanned on
local-device meshes (no cross-process device traffic).
"""

import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

SR = 1000

WORKER = textwrap.dedent(
    """
    import json, sys
    import jax

    coordinator, pid, outdir = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    from audio_matcher_tpu.parallel.mesh import init_distributed

    assert init_distributed(coordinator, 2, pid)
    assert jax.process_count() == 2

    import numpy as np
    from audio_matcher_tpu.models.matcher import MatchConfig
    from audio_matcher_tpu.parallel.sweep import sweep_archive

    fixtures = json.load(open(outdir + "/fixtures.json"))
    snippets = [np.asarray(s, np.float32) for s in fixtures["snippets"]]
    cfg = MatchConfig(chunk_secs=1.0, distance_secs=2.0, block=256)
    results = sweep_archive(fixtures["paths"], snippets, fixtures["sr"], cfg)
    out = {
        path: [[(p.position, round(p.height, 4)) for p in pk]
               for pk in per_query]
        for path, per_query in results.items()
    }
    json.dump(out, open(f"{outdir}/proc{pid}.json", "w"))
    """
)


@pytest.mark.slow
def test_two_process_sweep_matches_single_process(rng, tmp_path):
    from audio_matcher_tpu.hostio.decode import write_wav
    from audio_matcher_tpu.models.matcher import MatchConfig
    from audio_matcher_tpu.parallel.mesh import make_mesh
    from audio_matcher_tpu.parallel.sweep import sweep_archive

    snippets = [
        (rng.standard_normal(SR // 2) * 0.2).astype(np.float32),
        (rng.standard_normal(SR // 4) * 0.2).astype(np.float32),
    ]
    paths = []
    for e in range(4):
        ep = (rng.standard_normal(SR * 6) * 0.05).astype(np.float32)
        i = (e + 1) * SR
        ep[i : i + len(snippets[0])] = snippets[0]
        p = tmp_path / f"ep{e}.wav"
        write_wav(p, SR, ep)
        paths.append(str(p))

    (tmp_path / "fixtures.json").write_text(
        json.dumps(
            {
                "snippets": [s.tolist() for s in snippets],
                "paths": paths,
                "sr": SR,
            }
        )
    )
    script = tmp_path / "worker.py"
    script.write_text(WORKER)

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    coordinator = f"127.0.0.1:{port}"

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    repo = str(Path(__file__).resolve().parents[1])
    env["PYTHONPATH"] = repo
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), coordinator, str(pid), str(tmp_path)],
            env=env, cwd=repo,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for pid in (0, 1)
    ]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out}"

    merged = {}
    for pid in (0, 1):
        part = json.loads((tmp_path / f"proc{pid}.json").read_text())
        for k in part:
            assert k not in merged, "file scanned by both processes"
        merged.update(part)
    assert set(merged) == set(paths)

    single = sweep_archive(
        paths, snippets, SR,
        MatchConfig(chunk_secs=1.0, distance_secs=2.0, block=256),
        mesh=make_mesh(2),
    )
    for path in paths:
        want = [
            [(p.position, round(p.height, 4)) for p in pk]
            for pk in single[path]
        ]
        got = [[tuple(t) for t in pk] for pk in merged[path]]
        assert got == want, path


def test_no_coordinator_is_not_a_cluster(monkeypatch):
    """Without ``AM_COORDINATOR`` nothing joins a cluster — no
    environment is auto-detected, so a plain single-card run never
    calls ``jax.distributed.initialize``."""
    import jax

    from audio_matcher_tpu.parallel import mesh as mesh_mod

    monkeypatch.setattr(mesh_mod, "_DISTRIBUTED_INITIALIZED", False)
    monkeypatch.delenv("AM_COORDINATOR", raising=False)
    monkeypatch.setenv("AM_NUM_PROCESSES", "2")
    monkeypatch.setenv("AM_PROCESS_ID", "0")
    called = []
    monkeypatch.setattr(
        jax.distributed, "initialize", lambda **kw: called.append(kw)
    )
    assert mesh_mod.init_distributed() is False
    assert not called


def test_init_distributed_env_join_passes_explicit_arguments(monkeypatch):
    """The ``AM_*`` variables reach ``jax.distributed.initialize`` as
    explicit arguments (nothing on a GPU host tells JAX of a cluster),
    and an incomplete set is refused before any join is attempted."""
    import pytest

    import jax

    from audio_matcher_tpu.parallel import mesh as mesh_mod

    monkeypatch.setattr(mesh_mod, "_DISTRIBUTED_INITIALIZED", False)
    called = []
    monkeypatch.setattr(
        jax.distributed, "initialize", lambda **kw: called.append(kw)
    )
    monkeypatch.setenv("AM_COORDINATOR", "localhost:4242")
    monkeypatch.delenv("AM_PROCESS_ID", raising=False)
    monkeypatch.setenv("AM_NUM_PROCESSES", "2")
    with pytest.raises(ValueError, match="AM_PROCESS_ID"):
        mesh_mod.init_distributed()
    assert not called
    monkeypatch.setenv("AM_PROCESS_ID", "1")
    assert mesh_mod.init_distributed() is True
    assert called == [
        dict(
            coordinator_address="localhost:4242",
            num_processes=2,
            process_id=1,
        )
    ]
    # joined once: a second call is a no-op
    assert mesh_mod.init_distributed() is True
    assert len(called) == 1


def test_init_distributed_explicit_cluster_failure_stays_loud(monkeypatch):
    """An EXPLICITLY configured cluster member must not silently degrade
    to single-process (it would double-scan the archive while its peers
    hang at the initialize barrier) — any join failure raises, whether
    the cluster came from arguments or from the ``AM_*`` variables."""
    import pytest

    import jax

    from audio_matcher_tpu.parallel import mesh as mesh_mod

    monkeypatch.setattr(mesh_mod, "_DISTRIBUTED_INITIALIZED", False)

    def boom(**kw):
        raise RuntimeError("DEADLINE_EXCEEDED: coordinator unreachable")

    monkeypatch.setattr(jax.distributed, "initialize", boom)
    with pytest.raises(RuntimeError, match="DEADLINE_EXCEEDED"):
        mesh_mod.init_distributed("10.0.0.1:1234", 2, 1)
    monkeypatch.setenv("AM_COORDINATOR", "localhost:4242")
    monkeypatch.setenv("AM_NUM_PROCESSES", "2")
    monkeypatch.setenv("AM_PROCESS_ID", "0")
    with pytest.raises(RuntimeError, match="DEADLINE_EXCEEDED"):
        mesh_mod.init_distributed()
    assert mesh_mod._DISTRIBUTED_INITIALIZED is False
