"""Multi-chip sharding tests on the virtual 8-device CPU mesh."""

import numpy as np
import pytest

from audio_matcher_tpu.models.matcher import MatchConfig
from audio_matcher_tpu.parallel.mesh import make_mesh
from audio_matcher_tpu.parallel.sweep import ShardedScanner, sweep_archive

SR = 1000


@pytest.fixture
def snippets(rng):
    return [
        (rng.standard_normal(SR // 2) * 0.2).astype(np.float32),
        (rng.standard_normal(SR // 4) * 0.2).astype(np.float32),
    ]


def _episodes(rng, snippets, offsets_per_episode):
    episodes = []
    for offsets in offsets_per_episode:
        ep = (rng.standard_normal(SR * 6) * 0.05).astype(np.float32)
        for q, off in offsets:
            i = int(off * SR)
            ep[i : i + len(snippets[q])] = snippets[q]
        episodes.append(ep)
    return episodes


def test_mesh_shapes():
    mesh = make_mesh(8)
    assert mesh.devices.size == 8
    assert mesh.axis_names == ("data", "seq")
    mesh3 = make_mesh(3)
    assert mesh3.devices.size == 3


def test_sharded_scan_multi_query(rng, snippets):
    mesh = make_mesh(8)
    cfg = MatchConfig(chunk_secs=1.0, distance_secs=2.0, block=256)
    scanner = ShardedScanner(snippets, SR, cfg, mesh=mesh)
    offsets = [
        [(0, 1.0), (1, 4.0)],
        [(0, 2.5)],
        [(1, 0.5), (0, 3.5)],
        [],
        [(0, 4.2)],
    ]
    episodes = _episodes(rng, snippets, offsets)
    results = scanner.scan(episodes)
    assert len(results) == len(episodes)
    for e, wanted in enumerate(offsets):
        for q in range(len(snippets)):
            want = sorted(int(off * SR) for qq, off in wanted if qq == q)
            got = [p.position for p in results[e][q] if p.height > 0.5]
            assert got == want, (e, q, got, want)


def test_sweep_archive_with_resume(rng, snippets, tmp_path):
    from audio_matcher_tpu.hostio.decode import write_wav
    from audio_matcher_tpu.meta.progress import Progress, State

    mesh = make_mesh(4)
    cfg = MatchConfig(chunk_secs=1.0, distance_secs=2.0, block=256)
    paths = []
    for e in range(5):
        ep = (rng.standard_normal(SR * 6) * 0.05).astype(np.float32)
        i = (e + 1) * SR // 2
        ep[i : i + len(snippets[0])] = snippets[0]
        p = tmp_path / f"ep{e}.wav"
        write_wav(p, SR, ep)
        paths.append(p)

    progress_path = tmp_path / ".done.txt"
    results = sweep_archive(
        paths, snippets, SR, cfg, mesh=mesh, progress_path=progress_path
    )
    assert len(results) == 5
    for e, p in enumerate(paths):
        got = [pk.position for pk in results[str(p)][0] if pk.height > 0.5]
        assert got == [(e + 1) * SR // 2]
    prog = Progress(progress_path)
    assert all(prog.get(str(p)) == State.DONE for p in paths)

    # resume: nothing left to do
    results2 = sweep_archive(
        paths, snippets, SR, cfg, mesh=mesh, progress_path=progress_path
    )
    assert results2 == {}


def test_resident_multiquery_matches_windows_path(rng, snippets):
    """The single-chip resident batch path returns the same peaks as the
    mesh windows path (BASELINE config #3 layout)."""
    mesh1 = make_mesh(1)
    cfg = MatchConfig(chunk_secs=1.0, distance_secs=2.0, block=256)
    offsets = [[(0, 1.0), (1, 4.0)], [(0, 2.5)], []]
    episodes = _episodes(rng, snippets, offsets)
    scanner = ShardedScanner(snippets, SR, cfg, mesh=mesh1)
    windows_path = scanner.scan(episodes)
    resident_path = scanner.scan_resident(episodes)
    for e in range(len(episodes)):
        for q in range(len(snippets)):
            got = [p.position for p in resident_path[e][q] if p.height > 0.5]
            want = [p.position for p in windows_path[e][q] if p.height > 0.5]
            assert got == want, (e, q)


def test_resident_sharded_on_mesh(rng, snippets):
    """The shard_map resident path on an 8-device mesh matches the
    single-device resident results."""
    cfg = MatchConfig(chunk_secs=1.0, distance_secs=2.0, block=256)
    offsets = [[(0, 1.0), (1, 4.0)], [(0, 2.5)], [(1, 0.5)], [], [(0, 3.0)]]
    episodes = _episodes(rng, snippets, offsets)
    single = ShardedScanner(snippets, SR, cfg, mesh=make_mesh(1))
    multi = ShardedScanner(snippets, SR, cfg, mesh=make_mesh(8))
    want = single.scan_resident(episodes)
    got = multi.scan_resident(episodes)
    assert len(got) == len(episodes)
    for e in range(len(episodes)):
        for q in range(len(snippets)):
            g = [p.position for p in got[e][q] if p.height > 0.5]
            w = [p.position for p in want[e][q] if p.height > 0.5]
            assert g == w, (e, q)


def test_resident_multiquery_int16(rng, snippets):
    mesh1 = make_mesh(1)
    cfg = MatchConfig(
        chunk_secs=1.0, distance_secs=2.0, block=256, transfer_dtype="int16"
    )
    offsets = [[(0, 1.0)], [(1, 3.0)]]
    episodes = _episodes(rng, snippets, offsets)
    scanner = ShardedScanner(snippets, SR, cfg, mesh=mesh1)
    results = scanner.scan_resident(episodes)
    for e, wanted in enumerate(offsets):
        for q in range(len(snippets)):
            want = sorted(int(off * SR) for qq, off in wanted if qq == q)
            got = [p.position for p in results[e][q] if p.height > 0.5]
            assert got == want, (e, q)


def test_sweep_many_files(rng, snippets, tmp_path):
    """A mini archive sweep (scaled-down config #5): 60 files in mesh-width
    groups with resume bookkeeping."""
    from audio_matcher_tpu.hostio.decode import write_wav
    from audio_matcher_tpu.meta.progress import Progress, State

    mesh = make_mesh(4)
    cfg = MatchConfig(chunk_secs=1.0, distance_secs=2.0, block=256)
    paths = []
    expect = {}
    for e in range(60):
        ep = (rng.standard_normal(SR * 4) * 0.05).astype(np.float32)
        off = (e % 5) * SR // 2 + SR // 4
        ep[off : off + len(snippets[0])] = snippets[0]
        p = tmp_path / f"f{e:03}.wav"
        write_wav(p, SR, ep)
        paths.append(p)
        expect[str(p)] = off
    progress_path = tmp_path / ".done.txt"
    results = sweep_archive(
        paths, snippets, SR, cfg, mesh=mesh, progress_path=progress_path
    )
    assert len(results) == 60
    for p, off in expect.items():
        got = [pk.position for pk in results[p][0] if pk.height > 0.5]
        assert got == [off], p
    prog = Progress(progress_path)
    assert sum(1 for _, s in prog.content if s == State.DONE) == 60


def test_sweep_resample_mismatched(rng, snippets, tmp_path):
    from audio_matcher_tpu.hostio.decode import resample, write_wav

    mesh = make_mesh(2)
    cfg = MatchConfig(chunk_secs=1.0, distance_secs=2.0, block=256)
    ep = (rng.standard_normal(SR * 6) * 0.05).astype(np.float32)
    ep[SR : SR + len(snippets[0])] = snippets[0]
    hi = tmp_path / "hi.wav"
    write_wav(hi, SR * 2, resample(ep, SR, SR * 2))  # 2 kHz file
    results = sweep_archive(
        [hi], snippets, SR, cfg, mesh=mesh, resample_mismatched=True
    )
    got = [p.position for p in results[str(hi)][0] if p.height > 0.4]
    assert got and abs(got[0] - SR) <= 2  # back at snippet rate


def test_sweep_skips_bad_files(rng, snippets, tmp_path, caplog):
    import logging

    from audio_matcher_tpu.hostio.decode import write_wav

    mesh = make_mesh(2)
    cfg = MatchConfig(chunk_secs=1.0, distance_secs=2.0, block=256)
    good = tmp_path / "good.wav"
    ep = (rng.standard_normal(SR * 6) * 0.05).astype(np.float32)
    ep[SR : SR + len(snippets[0])] = snippets[0]
    write_wav(good, SR, ep)
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"not a wav")
    wrong_rate = tmp_path / "wrong_rate.wav"
    write_wav(wrong_rate, SR * 2, ep)

    with caplog.at_level(logging.ERROR, logger="audio_matcher.sweep"):
        results = sweep_archive(
            [bad, good, wrong_rate], snippets, SR, cfg, mesh=mesh
        )
    assert set(results) == {str(good)}
    assert [p.position for p in results[str(good)][0] if p.height > 0.5] == [SR]
    msgs = " ".join(r.message for r in caplog.records)
    assert "skipping" in msgs


def test_sweep_groups_fill_whole_mesh(rng, snippets, tmp_path, monkeypatch):
    """Regression (VERDICT r1 weak #6): groups must match the FLATTENED
    mesh size — an 8-file sweep on a (4,2) mesh runs as ONE group with no
    zero-padded episodes dispatched."""
    from audio_matcher_tpu.hostio.decode import write_wav
    from audio_matcher_tpu.parallel import sweep as sweep_mod

    mesh = make_mesh(8)
    assert mesh.devices.shape == (4, 2)
    cfg = MatchConfig(chunk_secs=1.0, distance_secs=2.0, block=256)
    paths = []
    for e in range(8):
        ep = (rng.standard_normal(SR * 6) * 0.05).astype(np.float32)
        ep[SR : SR + len(snippets[0])] = snippets[0]
        p = tmp_path / f"ep{e}.wav"
        write_wav(p, SR, ep)
        paths.append(p)

    batches = []
    orig = sweep_mod.ShardedScanner.stage_resident

    def spying(self, episodes, arena=None, pad_to=None, **kw):
        batches.append(len(episodes))
        return orig(self, episodes, arena, pad_to, **kw)

    monkeypatch.setattr(sweep_mod.ShardedScanner, "stage_resident", spying)
    results = sweep_archive(paths, snippets, SR, cfg, mesh=mesh)
    assert batches == [8]  # one full-mesh group, no padding episodes
    for p in paths:
        got = [pk.position for pk in results[str(p)][0] if pk.height > 0.5]
        assert got == [SR]


def test_resident_sharded_pallas_peaks_on_mesh(rng, snippets):
    """The GPU production path (pair-packed cuFFT correlation + the Triton
    peak kernel, interpreted here) under shard_map on the 8-device mesh
    matches the xla+jnp reference results on one device."""
    base = dict(chunk_secs=8.0, distance_secs=10.0, slab=2, block=256)
    episodes = []
    for offsets in ([(0, 1.0), (1, 12.0)], [(0, 2.5)], []):
        ep = (rng.standard_normal(SR * 20) * 0.05).astype(np.float32)
        for q, off in offsets:
            i = int(off * SR)
            ep[i : i + len(snippets[q])] = snippets[q]
        episodes.append(ep)

    ref = ShardedScanner(
        snippets, SR, MatchConfig(fft_impl="xla", peaks_impl="jnp", **base),
        mesh=make_mesh(1),
    )
    prod = ShardedScanner(
        snippets, SR,
        MatchConfig(fft_impl="xla_packed", peaks_impl="pallas", **base),
        mesh=make_mesh(8),
    )
    want = ref.scan_resident(episodes)
    got = prod.scan_resident(episodes)
    for e in range(len(episodes)):
        for q in range(len(snippets)):
            g = [(p.position, round(p.height, 5)) for p in got[e][q]
                 if p.height > 0.5]
            w = [(p.position, round(p.height, 5)) for p in want[e][q]
                 if p.height > 0.5]
            assert g == w, (e, q)


def test_resident_single_query_window_packed_paths(rng, snippets):
    """Q=1 through the resident batch scanner takes the WINDOW-pair-packed
    xla_packed branch instead of padding the query axis — with either
    peak picker and on the lossless wires it must match the xla+jnp
    reference exactly at the peak level (BASELINE config #2 runs this
    shape on the chip)."""
    base = dict(chunk_secs=8.0, distance_secs=10.0, slab=2, block=256)
    one = [snippets[0]]
    episodes = []
    for offsets in ([1.0, 12.0], [2.5], []):
        ep = (rng.standard_normal(SR * 20) * 0.05).astype(np.float32)
        for off in offsets:
            i = int(off * SR)
            ep[i : i + len(one[0])] = one[0]
        episodes.append(ep)

    ref = ShardedScanner(
        one, SR, MatchConfig(fft_impl="xla", peaks_impl="jnp", **base),
        mesh=make_mesh(1),
    )
    want = ref.scan_resident(episodes)
    for impl, peaks, wire in (
        ("xla_packed", "pallas", "float32"),
        ("xla_packed", "pallas", "int16"),
        ("xla_packed", "jnp", "float32"),
    ):
        got = ShardedScanner(
            one, SR,
            MatchConfig(
                fft_impl=impl, peaks_impl=peaks, transfer_dtype=wire,
                **base,
            ),
            mesh=make_mesh(1),
        ).scan_resident(episodes)
        for e in range(len(episodes)):
            g = [p for p in got[e][0] if p.height > 0.5]
            w = [p for p in want[e][0] if p.height > 0.5]
            assert [p.position for p in g] == [p.position for p in w], (
                impl, wire, e,
            )
            for a, b in zip(g, w):
                # exact-wire impls match to float noise; the int16 wire
                # shifts scores by its quantization grid (~1%)
                tol = 1e-4 if wire == "float32" else 0.02
                assert abs(a.height - b.height) <= tol * max(b.height, 1), (
                    impl, wire, e, a.height, b.height,
                )


@pytest.mark.heavy
def test_resident_cross_impl_fuzz_random_configs(rng):
    """Differential fuzz of the RESIDENT batch program across impl pairs
    and query counts (incl. Q=1's window-pair-packed branches and odd
    slabs): every impl must agree with the xla+jnp reference on peak
    positions for random shapes."""
    from audio_matcher_tpu.parallel.sweep import ShardedScanner

    sr = 1000
    for trial in range(3):
        n_q = int(rng.integers(1, 4))
        snippets_t = [
            (rng.standard_normal(int(rng.uniform(0.4, 0.9) * sr)) * 0.2)
            .astype(np.float32)
            for _ in range(n_q)
        ]
        episodes = []
        plant_offsets = []
        for _ in range(int(rng.integers(1, 4))):
            secs = int(rng.integers(16, 28))
            ep = (rng.standard_normal(sr * secs) * 0.05).astype(np.float32)
            # one plant per query, far enough apart that suppression
            # can't tie-break nondeterministically across impls
            offs = {}
            positions = rng.choice(
                np.arange(1, secs - 2, 4), size=min(n_q, 3), replace=False
            )
            for q, off in enumerate(positions.tolist()):
                i = int(off * sr)
                ep[i : i + len(snippets_t[q])] = snippets_t[q]
                offs[q] = i
            episodes.append(ep)
            plant_offsets.append(offs)
        base = dict(
            chunk_secs=float(rng.uniform(8.0, 11.0)),
            distance_secs=2.0,
            slab=int(rng.integers(2, 5)),  # odd slabs hit the pair pad
            block=256,
        )
        ref = ShardedScanner(
            snippets_t, sr,
            MatchConfig(fft_impl="xla", peaks_impl="jnp", **base),
            mesh=make_mesh(1),
        ).scan_resident(episodes)
        for impl, peaks in (("xla_packed", "pallas"), ("mxu", "jnp")):
            got = ShardedScanner(
                snippets_t, sr,
                MatchConfig(fft_impl=impl, peaks_impl=peaks, **base),
                mesh=make_mesh(1),
            ).scan_resident(episodes)
            for e in range(len(episodes)):
                for q in range(n_q):
                    g = [p.position for p in got[e][q] if p.height > 0.5]
                    w = [p.position for p in ref[e][q] if p.height > 0.5]
                    assert g == w, (trial, impl, e, q)
                    if q in plant_offsets[e]:
                        assert plant_offsets[e][q] in w, (trial, e, q)


def test_two_plants_within_distance_keep_one(rng, snippets):
    """Two equal-strength plants closer than the min-distance inside one
    window: suppression must keep exactly one (observed transiently
    violated on an oversubscribed CPU host — pin it)."""
    cfg = MatchConfig(chunk_secs=4.0, distance_secs=3.0, slab=2, block=256)
    ep = (rng.standard_normal(SR * 6) * 0.05).astype(np.float32)
    for off in (1.0, 2.0):  # 1 s apart < distance 3 s, same window
        i = int(off * SR)
        ep[i : i + len(snippets[0])] = snippets[0]
    sc = ShardedScanner(snippets, SR, cfg, mesh=make_mesh(1))
    for _ in range(3):
        res = sc.scan_resident([ep])
        got = [p.position for p in res[0][0] if p.height > 0.5]
        assert len(got) == 1 and got[0] in (SR, 2 * SR), got


def test_sweep_resample_device_impl(rng, snippets, tmp_path):
    """Cross-rate sweep with the DEVICE polyphase in the hot loop
    (VERDICT r2 #3): no scipy, int16 wire readback, same match."""
    from audio_matcher_tpu.hostio.decode import resample, write_wav

    mesh = make_mesh(2)
    cfg = MatchConfig(
        chunk_secs=1.0, distance_secs=2.0, block=256,
        resample_impl="device",
    )
    ep = (rng.standard_normal(SR * 6) * 0.05).astype(np.float32)
    ep[SR : SR + len(snippets[0])] = snippets[0]
    hi = tmp_path / "hi_dev.wav"
    write_wav(hi, SR * 2, resample(ep, SR, SR * 2))
    results = sweep_archive(
        [hi], snippets, SR, cfg, mesh=mesh, resample_mismatched=True
    )
    got = [p.position for p in results[str(hi)][0] if p.height > 0.4]
    assert got and abs(got[0] - SR) <= 2


def test_stage_resident_row_pad_on_device(rng, snippets):
    """Episode-count padding happens ON DEVICE: the host buffer holds only
    real rows, yet the staged array fills the mesh and scans identically
    (VERDICT r2 weak #3 — a short group no longer wires silence rows)."""
    mesh = make_mesh(4)
    cfg = MatchConfig(
        chunk_secs=1.0, distance_secs=2.0, block=256,
        transfer_dtype="int16",
    )
    scanner = ShardedScanner(snippets, SR, cfg, mesh=mesh)
    ep = (rng.standard_normal(SR * 6) * 0.05).astype(np.float32)
    ep[2 * SR : 2 * SR + len(snippets[0])] = snippets[0]
    staged = scanner.stage_resident([ep])  # 1 episode on a 4-chip mesh
    dev, ns, n_real = staged
    assert dev.shape[0] == 4 and n_real == 1
    assert dev.dtype == np.int16
    assert np.asarray(dev[1:] == 0).all()
    results = scanner.scan_staged(staged)
    got = [p.position for p in results[0][0] if p.height > 0.5]
    assert got == [2 * SR]


def test_staging_arena_resilences_stale_tails():
    """StagingArena reuses one buffer per shape across groups; a shorter
    episode landing on a row a longer one occupied must see silence past
    its end — including mu-law, whose silence code is 128 not 0."""
    from audio_matcher_tpu.models.matcher import StagingArena, quantize_wire

    for transfer, silence in (("int16", 0), ("mulaw8", 128)):
        arena = StagingArena(transfer)
        long = quantize_wire(
            np.full(64, 0.3, np.float32), transfer
        )
        short = quantize_wire(np.full(16, -0.2, np.float32), transfer)
        buf = arena.get(2, 64)
        arena.write_row(2, 64, 0, long)
        arena.write_row(2, 64, 1, long)
        buf2 = arena.get(2, 64)
        assert buf2 is buf  # same backing buffer, no realloc
        arena.write_row(2, 64, 0, short)
        np.testing.assert_array_equal(buf2[0, :16], short)
        assert (buf2[0, 16:] == silence).all()
        np.testing.assert_array_equal(buf2[1], long)  # untouched row


def test_sweep_two_groups_shrinking_lengths(rng, snippets, tmp_path):
    """Two sweep groups where the second group's episodes are shorter than
    the first's: the reused arena rows must not leak the first group's
    samples into the second group's scan (streaming decode→stage)."""
    from audio_matcher_tpu.hostio.decode import write_wav

    mesh = make_mesh(2)
    cfg = MatchConfig(
        chunk_secs=1.0, distance_secs=2.0, block=256, transfer_dtype="int16"
    )
    paths, want = [], {}
    # group 1: 6 s episodes with plants late; group 2: 3 s episodes whose
    # rows would otherwise retain group 1's late plants
    specs = [(6, 4.0), (6, 4.5), (3, 1.0), (3, 0.5)]
    for i, (secs, off) in enumerate(specs):
        ep = (rng.standard_normal(SR * secs) * 0.05).astype(np.float32)
        at = int(off * SR)
        ep[at : at + len(snippets[0])] = snippets[0]
        p = tmp_path / f"g{i}.wav"
        write_wav(p, SR, ep)
        paths.append(p)
        want[str(p)] = at
    results = sweep_archive(paths, [snippets[0]], SR, cfg, mesh=mesh)
    for p in paths:
        got = [pk.position for pk in results[str(p)][0] if pk.height > 0.5]
        assert got == [want[str(p)]], (p, got)


def test_sweep_group_size_single_chip(rng, snippets, tmp_path):
    """Single-chip sweeps group several episodes per dispatch (default 8,
    overridable); the tail group pads its episode count on device so the
    compiled shape is reused (pad_to)."""
    from audio_matcher_tpu.hostio.decode import write_wav
    from audio_matcher_tpu.parallel import sweep as sweep_mod

    mesh = make_mesh(1)
    cfg = MatchConfig(
        chunk_secs=1.0, distance_secs=2.0, block=256, transfer_dtype="int16"
    )
    paths, want = [], {}
    for e in range(5):
        ep = (rng.standard_normal(SR * 4) * 0.05).astype(np.float32)
        at = (1 + e % 3) * SR // 2
        ep[at : at + len(snippets[0])] = snippets[0]
        p = tmp_path / f"e{e}.wav"
        write_wav(p, SR, ep)
        paths.append(p)
        want[str(p)] = at

    staged_shapes = []
    orig = sweep_mod.ShardedScanner.stage_resident

    def spying(self, episodes, arena=None, pad_to=None, **kw):
        out = orig(self, episodes, arena, pad_to, **kw)
        staged_shapes.append((len(episodes), out[0].shape[0]))
        return out

    sweep_mod.ShardedScanner.stage_resident = spying
    try:
        results = sweep_archive(
            paths, [snippets[0]], SR, cfg, mesh=mesh, group_size=4
        )
    finally:
        sweep_mod.ShardedScanner.stage_resident = orig
    assert staged_shapes == [(4, 4), (1, 4)]  # tail keeps the group shape
    for p in paths:
        got = [pk.position for pk in results[str(p)][0] if pk.height > 0.5]
        assert got == [want[str(p)]], p


def test_sweep_dispatch_ahead_pipeline(rng, snippets, tmp_path):
    """The sweep stages + dispatches group N+1 BEFORE blocking on group
    N's readback (the upload/compute overlap mechanism), and drains the
    one-group-deep pipeline at the end."""
    from audio_matcher_tpu.hostio.decode import write_wav
    from audio_matcher_tpu.parallel import sweep as sweep_mod

    mesh = make_mesh(2)
    cfg = MatchConfig(
        chunk_secs=1.0, distance_secs=2.0, block=256, transfer_dtype="int16"
    )
    paths = []
    for e in range(6):  # 3 groups of 2
        ep = (rng.standard_normal(SR * 4) * 0.05).astype(np.float32)
        at = (1 + e % 3) * SR // 2
        ep[at : at + len(snippets[0])] = snippets[0]
        p = tmp_path / f"p{e}.wav"
        write_wav(p, SR, ep)
        paths.append(p)

    events = []
    orig_dispatch = sweep_mod.ShardedScanner.scan_dispatch
    orig_collect = sweep_mod.ShardedScanner.scan_collect

    def spy_dispatch(self, staged, scale=True):
        events.append("dispatch")
        return orig_dispatch(self, staged, scale)

    def spy_collect(self, dispatched):
        events.append("collect")
        return orig_collect(self, dispatched)

    sweep_mod.ShardedScanner.scan_dispatch = spy_dispatch
    sweep_mod.ShardedScanner.scan_collect = spy_collect
    try:
        results = sweep_archive(paths, [snippets[0]], SR, cfg, mesh=mesh)
    finally:
        sweep_mod.ShardedScanner.scan_dispatch = orig_dispatch
        sweep_mod.ShardedScanner.scan_collect = orig_collect
    # N+1 dispatches before N collects; final collect drains the pipeline
    assert events == [
        "dispatch", "dispatch", "collect", "dispatch", "collect", "collect",
    ]
    assert len(results) == 6


def test_sweep_group_byte_budget(rng, snippets, tmp_path, monkeypatch):
    """Long episodes flush before the nominal group size once the decoded
    wire bytes exceed AUDIO_MATCHER_GROUP_BYTES — and the byte-limited
    tail skips the episode-count pad."""
    from audio_matcher_tpu.hostio.decode import write_wav
    from audio_matcher_tpu.parallel import sweep as sweep_mod

    mesh = make_mesh(1)
    cfg = MatchConfig(
        chunk_secs=1.0, distance_secs=2.0, block=256, transfer_dtype="int16"
    )
    paths, want = [], {}
    for e in range(5):
        ep = (rng.standard_normal(SR * 4) * 0.05).astype(np.float32)
        at = (1 + e % 3) * SR // 2
        ep[at : at + len(snippets[0])] = snippets[0]
        p = tmp_path / f"b{e}.wav"
        write_wav(p, SR, ep)
        paths.append(p)
        want[str(p)] = at
    # each file is 4*SR*2 = 8 kB of int16 wire; budget of 20 kB → the
    # padded staging buffer holds at most 2 rows (3 × 8 kB would exceed
    # it), despite group_size=8
    monkeypatch.setenv("AUDIO_MATCHER_GROUP_BYTES", str(20_000))

    staged_shapes = []
    orig = sweep_mod.ShardedScanner.stage_resident

    def spying(self, episodes, arena=None, pad_to=None, **kw):
        out = orig(self, episodes, arena, pad_to, **kw)
        staged_shapes.append((len(episodes), out[0].shape[0]))
        return out

    sweep_mod.ShardedScanner.stage_resident = spying
    try:
        results = sweep_archive(
            paths, [snippets[0]], SR, cfg, mesh=mesh, group_size=8
        )
    finally:
        sweep_mod.ShardedScanner.stage_resident = orig
    # byte-flush keeps every staged buffer ≤ budget: two pairs, then the
    # tail single with no count pad (8 × 8 kB would blow the budget)
    assert staged_shapes == [(2, 2), (2, 2), (1, 1)]
    for p in paths:
        got = [pk.position for pk in results[str(p)][0] if pk.height > 0.5]
        assert got == [want[str(p)]], p


def test_stage_resident_host_pad_rows(rng, snippets):
    """pad_rows="host" stages mesh-filling silence rows on the host
    (strictly execution-free staging for stage-ahead callers) and scans
    identically to the default device-side pad — including stale arena
    rows from a previous, larger group."""
    from audio_matcher_tpu.models.matcher import StagingArena
    from audio_matcher_tpu.parallel.sweep import ShardedScanner

    mesh = make_mesh(4)
    cfg = MatchConfig(
        chunk_secs=1.0, distance_secs=2.0, block=256, transfer_dtype="int16"
    )
    sc = ShardedScanner([snippets[0]], SR, cfg, mesh)
    eps = []
    for e in range(2):  # 2 episodes on a 4-mesh → 2 pad rows
        ep = (rng.standard_normal(SR * 3) * 0.05).astype(np.float32)
        ep[SR : SR + len(snippets[0])] = snippets[0]
        eps.append(ep)
    arena = StagingArena("int16")
    # poison the arena with a FULL 4-row group first: the host-pad path
    # must silence rows 2-3's stale content, not ship it
    sc.stage_resident([eps[0]] * 4, arena=arena)
    staged_h = sc.stage_resident(eps, arena=arena, pad_rows="host")
    assert staged_h[0].shape[0] == 4
    pad_rows = np.asarray(staged_h[0][2:])
    assert np.all(pad_rows == 0)  # int16 wire silence
    staged_d = sc.stage_resident(eps, pad_rows="device")
    np.testing.assert_array_equal(
        np.asarray(staged_h[0]), np.asarray(staged_d[0])
    )
    got_h = sc.scan_collect(sc.scan_dispatch(staged_h))
    got_d = sc.scan_collect(sc.scan_dispatch(staged_d))
    for ph, pd in zip(got_h, got_d):
        assert [p.position for p in ph[0]] == [p.position for p in pd[0]]


def test_put_cap_validation(monkeypatch):
    """AUDIO_MATCHER_PUT_BYTES ≤ 0 disables splitting instead of
    crashing the splitters with a zero/negative divisor."""
    from audio_matcher_tpu.models.matcher import (
        _device_put_split, put_bytes_cap,
    )

    monkeypatch.setenv("AUDIO_MATCHER_PUT_BYTES", "0")
    assert put_bytes_cap() > 1 << 40
    buf = np.zeros((4, 1024), np.int16)
    assert not isinstance(_device_put_split(buf), tuple)
    monkeypatch.setenv("AUDIO_MATCHER_PUT_BYTES", "-5")
    assert not isinstance(_device_put_split(buf), tuple)


def test_stage_fence_policy(monkeypatch):
    """AUDIO_MATCHER_STAGE_FENCE selects the split pacing: 'serial'
    fences each piece (the round-4 A/B candidate), 'batch' (default)
    dispatches all and leaves fencing to the caller — identical pieces
    and bytes either way; junk values fail loudly."""
    import pytest

    from audio_matcher_tpu.models.matcher import (
        _device_put_split, stage_fence_policy,
    )

    assert stage_fence_policy() == "batch"
    buf = (np.arange(8 * 1024, dtype=np.int16) * 3).reshape(4, -1)
    monkeypatch.setenv("AUDIO_MATCHER_PUT_BYTES", str(buf.nbytes // 3))
    batch = _device_put_split(buf)
    monkeypatch.setenv("AUDIO_MATCHER_STAGE_FENCE", "serial")
    assert stage_fence_policy() == "serial"
    serial = _device_put_split(buf)
    assert isinstance(batch, tuple) and isinstance(serial, tuple)
    assert len(batch) == len(serial)
    for b, s in zip(batch, serial):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(s))
    monkeypatch.setenv("AUDIO_MATCHER_STAGE_FENCE", "sometimes")
    with pytest.raises(ValueError, match="STAGE_FENCE"):
        stage_fence_policy()


def test_chunked_staging_matches_monolithic(rng, snippets, monkeypatch):
    """Buffers over AUDIO_MATCHER_PUT_BYTES stage as equal ≤-cap flat
    pieces (element-granular so even a single over-cap row splits) —
    same peaks, same compiled shape per group, no extra pad rows."""
    from audio_matcher_tpu.parallel.sweep import ShardedScanner

    mesh = make_mesh(2)
    cfg = MatchConfig(
        chunk_secs=1.0, distance_secs=2.0, block=256, transfer_dtype="int16"
    )
    sc = ShardedScanner([snippets[0]], SR, cfg, mesh)
    eps = []
    for e in range(5):  # 5 episodes on a 2-mesh
        ep = (rng.standard_normal(SR * 3) * 0.05).astype(np.float32)
        ep[SR : SR + len(snippets[0])] = snippets[0]
        eps.append(ep)
    mono = sc.stage_resident(eps)
    assert not isinstance(mono[0], tuple)
    row_bytes = mono[0].shape[1] * 2  # int16
    cap = row_bytes * 3
    monkeypatch.setenv("AUDIO_MATCHER_PUT_BYTES", str(cap))
    chunked = sc.stage_resident(eps)
    assert isinstance(chunked[0], tuple)
    # every piece respects the cap (element-granular rounding aside)
    assert all(c.nbytes <= cap + 2 for c in chunked[0])
    # total elements reassemble the [6, Npad] buffer, no growth beyond
    # the mesh grid
    assert sum(int(c.size) for c in chunked[0]) == 6 * mono[0].shape[1]
    assert len(chunked[1]) == 6  # ns padded to the mesh grid only
    got_m = sc.scan_collect(sc.scan_dispatch(mono))
    got_c = sc.scan_collect(sc.scan_dispatch(chunked))
    assert len(got_c) == len(got_m) == 5
    for pm, pc in zip(got_m, got_c):
        assert [p.position for p in pc[0]] == [p.position for p in pm[0]]
        assert [p.position for p in pc[0]] == [SR]
    # the device-pad path (sweep_archive's) splits too when over-cap
    dev_staged = sc.stage_resident(eps, pad_rows="device")
    got_d = sc.scan_collect(sc.scan_dispatch(dev_staged))
    for pm, pd in zip(got_m, got_d):
        assert [p.position for p in pd[0]] == [p.position for p in pm[0]]


def test_single_overcap_row_splits_device_pad(rng, snippets, monkeypatch):
    """sweep_archive's one-huge-episode-per-group case: a [1, Npad]
    buffer over the cap still uploads as multiple ≤-cap puts through the
    device-pad path (the split is element-granular, not per-row)."""
    import jax as jax_mod

    from audio_matcher_tpu.parallel.sweep import ShardedScanner

    sc = ShardedScanner(
        [snippets[0]], SR,
        MatchConfig(
            chunk_secs=1.0, distance_secs=2.0, block=256,
            transfer_dtype="int16",
        ),
        make_mesh(1),
    )
    ep = (rng.standard_normal(SR * 3) * 0.05).astype(np.float32)
    ep[SR : SR + len(snippets[0])] = snippets[0]
    want = [
        p.position
        for p in sc.scan_collect(
            sc.scan_dispatch(sc.stage_resident([ep], pad_rows="device"))
        )[0][0]
    ]
    puts = []
    real_put = jax_mod.device_put

    def spy(x, *a, **k):
        puts.append(getattr(x, "nbytes", 0))
        return real_put(x, *a, **k)

    monkeypatch.setattr(jax_mod, "device_put", spy)
    mono = sc.stage_resident([ep], pad_rows="device")
    cap = (mono[0].shape[1] * 2) // 2  # half the single row's bytes
    monkeypatch.setenv("AUDIO_MATCHER_PUT_BYTES", str(cap))
    puts.clear()
    staged = sc.stage_resident([ep], pad_rows="device")
    assert len(puts) >= 2 and all(b <= cap + 2 for b in puts)
    got = [
        p.position
        for p in sc.scan_collect(sc.scan_dispatch(staged))[0][0]
    ]
    assert got == want == [SR]


def test_pad_to_rounds_up_to_mesh_rows(rng, snippets):
    """A pad_to that is not a multiple of the mesh size must still yield
    a shard_map-divisible row count (tail sweep groups on multi-chip
    meshes)."""
    from audio_matcher_tpu.parallel.sweep import ShardedScanner

    mesh = make_mesh(4)
    sc = ShardedScanner(
        [snippets[0]], SR,
        MatchConfig(
            chunk_secs=1.0, distance_secs=2.0, block=256,
            transfer_dtype="int16",
        ),
        mesh,
    )
    ep = (rng.standard_normal(SR * 2) * 0.05).astype(np.float32)
    ep[SR // 2 : SR // 2 + len(snippets[0])] = snippets[0]
    for pad_rows in ("host", "device"):
        staged = sc.stage_resident([ep, ep], pad_to=6, pad_rows=pad_rows)
        assert len(staged[1]) == 8, pad_rows  # 6 → 8 on a 4-mesh
        got = sc.scan_collect(sc.scan_dispatch(staged))
        assert [p.position for p in got[0][0]] == [SR // 2]


def test_chunked_staging_spectrogram(rng, snippets, monkeypatch):
    """Same put-cap splitting through the spectrogram scanner."""
    from audio_matcher_tpu.models.spectrogram import SpectrogramConfig
    from audio_matcher_tpu.parallel.sweep import ShardedSpectrogramScanner

    mesh = make_mesh(1)
    cfg = SpectrogramConfig(distance_secs=2.0, transfer_dtype="int16")
    sc = ShardedSpectrogramScanner([snippets[0]], SR, cfg, mesh)
    eps = []
    for e in range(3):
        ep = (rng.standard_normal(SR * 2) * 0.05).astype(np.float32)
        ep[SR // 2 : SR // 2 + len(snippets[0])] = snippets[0]
        eps.append(ep)
    mono = sc.stage_resident(eps)
    assert not isinstance(mono[0], tuple)
    got_m = sc.scan_collect(sc.scan_dispatch(mono))
    row_bytes = mono[0].shape[1] * 2
    monkeypatch.setenv("AUDIO_MATCHER_PUT_BYTES", str(row_bytes))
    chunked = sc.stage_resident(eps)
    assert isinstance(chunked[0], tuple)
    got_c = sc.scan_collect(sc.scan_dispatch(chunked))
    assert len(got_c) == len(got_m) == 3
    for pm, pc in zip(got_m, got_c):
        got_pos = [p.position for p in pc[0]]
        assert got_pos == [p.position for p in pm[0]]
        assert len(got_pos) == 1


@pytest.mark.heavy
def test_staging_policies_fuzz(rng, snippets):
    """Differential fuzz over the staging decision space: random episode
    counts/lengths × put caps × pad_rows × slab_auto all yield the SAME
    peaks as the monolithic pinned-slab oracle. Shapes share one
    (chunk, fft) bucket family to bound interpret-mode compiles."""
    from audio_matcher_tpu.parallel.sweep import ShardedScanner

    mesh = make_mesh(2)
    base = dict(
        chunk_secs=1.0, distance_secs=2.0, block=256,
        transfer_dtype="int16",
    )
    oracle_sc = ShardedScanner(
        [snippets[0]], SR, MatchConfig(**base, slab_auto=False), mesh
    )
    auto_sc = ShardedScanner(
        [snippets[0]], SR, MatchConfig(**base), mesh
    )
    for trial in range(6):
        n_eps = int(rng.integers(1, 6))
        eps, wants = [], []
        for _ in range(n_eps):
            secs = int(rng.integers(2, 5))
            ep = (rng.standard_normal(SR * secs) * 0.05).astype(np.float32)
            at = int(rng.integers(0, max(secs * SR - len(snippets[0]), 1)))
            ep[at : at + len(snippets[0])] = snippets[0]
            eps.append(ep)
            wants.append(at)
        want = [
            [p.position for p in per[0]]
            for per in oracle_sc.scan_staged(oracle_sc.stage_resident(eps))
        ]
        # planted offset must be among the oracle's peaks
        for got_pos, at in zip(want, wants):
            assert at in got_pos
        row_bytes = (
            oracle_sc.stage_resident(eps)[0].shape[-1] * 2
        )
        for cap_rows in (1, 2, 100):
            with pytest.MonkeyPatch.context() as mp:
                mp.setenv(
                    "AUDIO_MATCHER_PUT_BYTES", str(row_bytes * cap_rows)
                )
                for pad_rows in ("host", "device"):
                    got = auto_sc.scan_staged(
                        auto_sc.stage_resident(eps, pad_rows=pad_rows)
                    )
                    assert [
                        [p.position for p in per[0]] for per in got
                    ] == want, (trial, cap_rows, pad_rows)


def test_sweep_tail_pad_not_sticky_after_byte_flush(
    rng, snippets, tmp_path, monkeypatch
):
    """An early byte-limited flush must not disable the tail's pad_to
    shape reuse when the tail itself is small (its padded staging stays
    inside the budget) — the padded shape avoids one more compile."""
    from audio_matcher_tpu.hostio.decode import write_wav
    from audio_matcher_tpu.parallel import sweep as sweep_mod

    mesh = make_mesh(1)
    cfg = MatchConfig(
        chunk_secs=1.0, distance_secs=2.0, block=256, transfer_dtype="int16"
    )
    paths, want = [], {}
    lengths = [12, 12, 4, 4, 4, 4, 4, 4, 4]  # seconds: 2 big, then 7 small
    for e, secs in enumerate(lengths):
        ep = (rng.standard_normal(SR * secs) * 0.05).astype(np.float32)
        at = (1 + e % 2) * SR // 2
        ep[at : at + len(snippets[0])] = snippets[0]
        p = tmp_path / f"c{e}.wav"
        write_wav(p, SR, ep)
        paths.append(p)
        want[str(p)] = at
    # int16 wire: big = 24 kB, small = 8 kB; budget 33 kB → each big
    # file flushes ALONE (a 2-row buffer padded to the 24 kB row would
    # be 48 kB — the budget is judged on the padded staging buffer, so
    # mixing rows with a wide one can't blow host RAM), the four smalls
    # fill a group, and the 3-file tail pads back to group_size
    # (4 × 8 kB ≤ budget)
    monkeypatch.setenv("AUDIO_MATCHER_GROUP_BYTES", str(33_000))

    staged_shapes = []
    orig = sweep_mod.ShardedScanner.stage_resident

    def spying(self, episodes, arena=None, pad_to=None, **kw):
        out = orig(self, episodes, arena, pad_to, **kw)
        staged_shapes.append((len(episodes), out[0].shape[0]))
        return out

    sweep_mod.ShardedScanner.stage_resident = spying
    try:
        results = sweep_archive(
            paths, [snippets[0]], SR, cfg, mesh=mesh, group_size=4
        )
    finally:
        sweep_mod.ShardedScanner.stage_resident = orig
    # bigs byte-flush singly unpadded, 4 small full group, tail of 3
    # PADDED to 4
    assert staged_shapes == [(1, 1), (1, 1), (4, 4), (3, 4)]
    for p in paths:
        got = [pk.position for pk in results[str(p)][0] if pk.height > 0.5]
        assert got == [want[str(p)]], p
