"""Sharded batch scanning: many (episode, snippet) pairs over a chip mesh.

Device counterpart of the reference's rayon chunk fan-out
(audio_matcher.rs:114) scaled to a device mesh: overlap-save windows of a
group of episodes form a [E, C, W] tensor sharded (data, seq) over the
mesh; one jitted SPMD program runs batched rFFT → conj-multiply → irFFT →
on-device peak picking per shard, and the (tiny) candidate lists are
replicated back (XLA inserts the all-gather — the only collective; episode
assignment is static, SURVEY.md §5).

The forward FFT of each episode window is amortized across all query
snippets in the multi-query path — a batching win the streaming reference
cannot express.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models.matcher import (
    MatchConfig,
    _divisor_slab,
    _joined,
    effective_slab as _effective_slab,
    overshadow_filter,
)
from ..ops.correlate import fft_length, fft_rows, prepare_snippet
from ..ops.peaks import (
    Peak,
    peaks_crop_width,
    pick_peaks_core,
    pick_peaks_dispatch,
)

log = logging.getLogger("audio_matcher.sweep")


def sharded_match_step(
    mesh: Mesh,
    fft_len: int,
    valid_max: int,
    distance: int,
    n_peaks: int,
    block: int = 2048,
):
    """Compile a sharded multi-query match step.

    Returned fn: (windows [E,C,W], sample_f [Q,F], inv_ac [Q],
    valid [E,C], m [Q]) → (pos, height, prom) each [E, Q, C, S], replicated.
    """
    data_sh = NamedSharding(mesh, P("data", "seq", None))
    valid_sh = NamedSharding(mesh, P("data", "seq"))
    rep = NamedSharding(mesh, P())

    def step(windows, sample_f, inv_ac, valid, m):
        x = fft_rows("rfft", windows, fft_len)  # [E, C, F]
        spec = x[:, :, None, :] * jnp.conj(sample_f)[None, None, :, :]
        c = fft_rows("irfft", spec, fft_len)[..., :valid_max]  # [E, C, Q, V]
        c = c * inv_ac[None, None, :, None]
        c = jnp.swapaxes(c, 1, 2)  # [E, Q, C, V]
        # valid holds raw window lengths; each query's valid output length is
        # window_len - m_q + 1
        vq = jnp.maximum(valid[:, None, :] - m[None, :, None] + 1, 0)

        def per_pair(cc, vl):
            return pick_peaks_core(cc, vl, distance, n_peaks, block)

        pick = jax.vmap(jax.vmap(per_pair))
        return pick(c, vq)

    return jax.jit(
        step,
        in_shardings=(data_sh, rep, rep, valid_sh, rep),
        out_shardings=rep,
    )


def resident_match_step(
    chunk: int,
    window: int,
    fft_len: int,
    valid_max: int,
    distance: int,
    n_peaks: int,
    block: int,
    slab: int,
    n_slabs: int,
    fft_impl: str = "xla",
    peaks_impl: str = "jnp",
):
    """Compile the resident multi-query scan: episodes stay flat in HBM
    ([E, Npad], one upload), windows are gathered in-program, and every
    window's forward FFT is shared across all Q query snippets — the
    batch-scan regime of BASELINE config #3 on one chip. (The mesh-sharded
    multi-chip variant uses :func:`sharded_match_step`'s window layout.)

    Returned fn: (episodes [E,Npad] f32|i16, ns [E], sample_f [Q,F],
    inv_ac [Q], m [Q]) → (pos, h, prom) each [E, Q, n_slabs*slab, S];
    episodes and slabs run sequentially (lax.map) to bound HBM footprint.
    """

    crop = min(peaks_crop_width(valid_max, block, peaks_impl), fft_len)

    def per_episode(episode, n, sample_f, inv_ac, m):
        from ..models.matcher import (
            dequantize_on_device,
            pad_wire_on_device,
            window_rows,
        )

        # pad to whole chunk rows ON DEVICE (cheap device copy of the wire
        # array) so windows build from static row slices
        target = (n_slabs * slab + window_rows(window, chunk)) * chunk
        episode = dequantize_on_device(pad_wire_on_device(episode, target))

        def body(base):
            from ..models.matcher import windows_from_episode

            starts = (base + jnp.arange(slab, dtype=jnp.int32)) * chunk
            windows = windows_from_episode(
                episode, base, slab, chunk, window
            )
            win_len = jnp.clip(n - starts, 0, window)
            if fft_impl == "mxu":
                from ..ops.mxu_fft import corr_slab_mxu

                c = corr_slab_mxu(
                    windows, sample_f[0], sample_f[1], crop
                )  # [B, Q, V] — matmul FFT, window+corr pair packing
            elif fft_impl == "xla_packed":
                from ..ops.correlate import (
                    corr_single_query_packed,
                    corr_slab_xla_packed,
                )

                Q = inv_ac.shape[0]
                if Q == 1:
                    # single query: WINDOW pairs pack each inverse — the
                    # query-pair path would run one full complex inverse
                    # per window against T = conj(S0) + i·0 (double the
                    # work). packed_query_spectra's Q=1 row IS conj(S0).
                    c = corr_single_query_packed(
                        windows, sample_f[0], crop
                    )[:, None, :]
                else:
                    c = corr_slab_xla_packed(windows, sample_f, crop)[:, :Q]
            else:
                x = fft_rows("rfft", windows, fft_len)  # [B, F] — shared fwd
                spec = x[:, None, :] * jnp.conj(sample_f)[None, :, :]
                c = fft_rows("irfft", spec, fft_len)[..., :crop]
            c = c * inv_ac[None, :, None]
            # peaks run in [B, Q] order (no [B,Q,V]→[Q,B,V] copy of the
            # correlation volume); only the tiny [B,Q,S] outputs transpose
            vq = jnp.maximum(win_len[:, None] - m[None, :] + 1, 0).astype(
                jnp.int32
            )  # [B, Q]
            out = pick_peaks_dispatch(
                c, vq, distance, n_peaks, block, peaks_impl
            )
            return jax.tree.map(
                lambda a: jnp.swapaxes(a, 0, 1), out
            )  # [Q, B, S] triplets

        pos, h, prom = jax.lax.map(
            body, jnp.arange(n_slabs, dtype=jnp.int32) * slab
        )

        # [n_slabs, Q, B, S] → [Q, n_slabs*B, S]
        def flat(a):
            return jnp.swapaxes(a, 0, 1).reshape(a.shape[1], -1, a.shape[-1])

        return flat(pos), flat(h), flat(prom)

    @jax.jit
    def step(episodes, ns, sample_f, inv_ac, m):
        return jax.lax.map(
            lambda args: per_episode(args[0], args[1], sample_f, inv_ac, m),
            (episodes, ns),
        )

    return step, per_episode


def resident_sharded_step(
    mesh: Mesh,
    chunk: int,
    window: int,
    fft_len: int,
    valid_max: int,
    distance: int,
    n_peaks: int,
    block: int,
    slab: int,
    n_slabs: int,
    fft_impl: str = "xla",
    peaks_impl: str = "jnp",
):
    """Multi-chip variant of :func:`resident_match_step`: the episode batch
    shards over the FLATTENED mesh (data×seq) with ``shard_map``; each chip
    scans its local episodes (flat HBM windowing, forward FFT shared across
    queries), entirely collective-free — outputs stay episode-sharded and
    the host gather stitches them (SURVEY.md §5: episode assignment is
    static, peak lists are kilobytes)."""
    _, per_episode = resident_match_step(
        chunk, window, fft_len, valid_max, distance, n_peaks, block,
        slab, n_slabs, fft_impl, peaks_impl,
    )
    axes = tuple(mesh.axis_names)

    def local(episodes, ns, sample_f, inv_ac, m):
        return jax.lax.map(
            lambda args: per_episode(args[0], args[1], sample_f, inv_ac, m),
            (episodes, ns),
        )

    sharded = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(axes, None), P(axes), P(), P(), P()),
        out_specs=P(axes, None, None, None),
        # pallas_call doesn't annotate varying-mesh-axes metadata yet; the
        # step is collective-free so the vma check adds nothing
        check_vma=False,
    )
    return jax.jit(sharded)


@dataclasses.dataclass
class _Query:
    m: int
    inv_autocorr: float


def _fill_wire_rows(
    episodes, n_pad: int, transfer: str, arena=None, rows: int | None = None
):
    """Pack episodes into a [rows, n_pad] wire-dtype host buffer
    (``rows`` defaults to ``len(episodes)``; extra rows are silence).

    Rows already in the wire dtype (the prefetch workers decode straight to
    wire format) are a plain memcpy; others quantize here. With ``arena``
    (models.matcher.StagingArena) the buffer is reused across groups —
    single-flight, see the arena's docstring."""
    from ..models.matcher import _WIRE_DTYPES, quantize_wire, wire_buffer

    dtype = _WIRE_DTYPES[transfer]
    n_rows = len(episodes) if rows is None else max(int(rows), len(episodes))
    if arena is not None:
        buf = arena.get(n_rows, n_pad)
        empty = np.zeros(0, dtype)
        for i in range(n_rows):
            if i < len(episodes):
                ep = np.asarray(episodes[i])
                wire = (
                    ep if ep.dtype == dtype else quantize_wire(ep, transfer)
                )
            else:
                wire = empty  # an empty write silences the stale row
            arena.write_row(n_rows, n_pad, i, wire)
        return buf
    buf = wire_buffer((n_rows, n_pad), transfer)
    for i, ep in enumerate(episodes):
        ep = np.asarray(ep)
        if ep.dtype == dtype:
            buf[i, : len(ep)] = ep
        else:
            buf[i, : len(ep)] = quantize_wire(ep, transfer)
    return buf


def _stage_rows_host(episodes, ns, n_pad, transfer, arena, e_pad, n_dev):
    """Shared host-pad staging tail for both scanners: fill the wire
    buffer (silence rows to ``e_pad``), upload via the shared
    element-granular put splitter (models.matcher._device_put_split —
    buffers over ``AUDIO_MATCHER_PUT_BYTES`` stage as equal flat pieces;
    a single row can exceed the cap, so the split is by elements, not
    rows). Execution-free; the
    scan paths re-join with ONE on-device concat + reshape.
    Returns the (handle, ns_pad, n_real) staged triple."""
    from ..models.matcher import _device_put_split

    ns_pad = np.zeros(e_pad, np.int32)
    ns_pad[: len(ns)] = ns
    buf = _fill_wire_rows(episodes, n_pad, transfer, arena, e_pad)
    return _device_put_split(buf), ns_pad, len(episodes)


def spectrogram_pad_width(
    n_max: int, n_fft: int, max_waste: float = 0.25
) -> int:
    """Staged episode width for the spectrogram scanner.

    Compiled programs key on the padded width, so widths bucket to a
    quantum — but the old FIXED 4M-sample quantum staged up to 3× air
    for short episodes, and every padded sample is wire bytes AND STFT
    compute. Mirror of the pcm path's ``pick_slab``
    policy: keep the largest power-of-two quantum in [2^18, 2^22] whose
    padding stays under ``max_waste`` of the real samples; when none
    qualifies (tiny episodes) the 2^18 floor (≈6 s at 44.1 kHz) bounds
    the absolute waste while keeping every test/short-clip shape on ONE
    compiled program. Deterministic in (n_max, n_fft) alone, so staging
    and scanning recompute the same width."""
    n = max(int(n_max), int(n_fft))
    for b in (1 << 22, 1 << 21, 1 << 20, 1 << 19, 1 << 18):
        p = max(-(-n // b) * b, b)
        if p - n <= max_waste * n:
            return p
    # none met the waste bound (tiny episode): the last iteration's
    # 2^18-quantum width is the floor — bounded absolute waste, one
    # shared compiled shape for every short clip
    return p


def _pad_episode_rows_on_device(buf: np.ndarray, e_pad: int, transfer_dtype):
    """Upload only the real episode rows; grow to the mesh-filling row
    count ON DEVICE (cheap HBM memset vs staging full-width silence rows
    over the host→device link — a single short episode on an 8-chip mesh
    would otherwise wire 8× its bytes). Over-cap buffers upload as equal
    flat pieces (shared element-granular splitter; covers a single row
    above the cap too) joined by an immediate concat — this path executes
    a pad program at stage time anyway, so it is not execution-free."""
    from ..models.matcher import _device_put_split, wire_silence

    dev = _joined(_device_put_split(buf), rows=buf.shape[0])
    short = e_pad - buf.shape[0]
    if short <= 0:
        return dev
    return jnp.pad(
        dev, ((0, short), (0, 0)),
        constant_values=wire_silence(transfer_dtype),
    )


class ShardedSpectrogramScanner:
    """Mesh-sharded spectrogram-domain batch scanning (BASELINE config #4
    at archive scale): episodes shard over the flattened mesh; each chip
    computes block-fused log-mel fingerprints, overlap-save tiled ZNCC per
    query, and on-device peak picking. Same ``scan_resident`` interface as
    :class:`ShardedScanner`, so the sweep machinery (resume, prefetch,
    grouping, labels) is shared."""

    def __init__(self, snippets, sr, config=None, mesh=None):
        from ..models.spectrogram import SpectrogramConfig
        from ..ops.stft import mel_filterbank
        from .mesh import make_mesh

        self.sr = int(sr)
        self.config = config or SpectrogramConfig()
        self.mesh = mesh or make_mesh()
        cfg = self.config
        self._fb = np.asarray(mel_filterbank(cfg.n_mels, cfg.n_fft, self.sr))
        self._snippets = [np.asarray(s, np.float32) for s in snippets]
        # frame counts are closed-form (log_mel pads short inputs to
        # n_fft) — no device work needed to know the shapes
        self._t_ss = tuple(
            1 + (max(len(s), cfg.n_fft) - cfg.n_fft) // cfg.hop
            for s in self._snippets
        )
        self._snip_fps_cache: np.ndarray | None = None
        self.distance_frames = max(
            int(cfg.distance_secs * self.sr / cfg.hop), 1
        )
        self._step_cache: dict = {}

    @property
    def _snip_fps(self) -> np.ndarray:
        """Padded [Q, t_max, n_mels] query fingerprints, computed lazily:
        construction and :meth:`stage_resident` stay EXECUTION-FREE so a
        batch of episodes can be staged (and timed) before the first
        program runs; same rationale as ShardedScanner's lazy query
        spectra."""
        if self._snip_fps_cache is None:
            from ..ops.stft import log_mel

            cfg = self.config
            fps = [
                np.asarray(
                    log_mel(s, self.sr, cfg.n_fft, cfg.hop, cfg.n_mels)
                )
                for s in self._snippets
            ]
            assert tuple(fp.shape[0] for fp in fps) == self._t_ss
            padded = np.zeros(
                (len(fps), max(self._t_ss), cfg.n_mels), np.float32
            )
            for q, fp in enumerate(fps):
                padded[q, : fp.shape[0]] = fp
            self._snip_fps_cache = padded
        return self._snip_fps_cache

    def stage_resident(
        self,
        episodes: Sequence[np.ndarray],
        arena=None,
        pad_to=None,
        pad_rows: str = "host",
    ):
        """See :meth:`ShardedScanner.stage_resident` (same contract,
        including the ``pad_rows`` execution-free/wire-bytes trade)."""
        ns = np.array([len(e) for e in episodes], np.int32)
        n_max = int(ns.max()) if len(ns) else 0
        cfg = self.config
        transfer = getattr(cfg, "transfer_dtype", "float32")
        # bucket the staged width so compiled shapes are reused without
        # staging multiples of the episode in padding air
        n_pad = spectrogram_pad_width(n_max, cfg.n_fft)
        n_dev = int(self.mesh.devices.size)
        e_pad = -(-len(episodes) // n_dev) * n_dev if episodes else 0
        if pad_to:  # tail groups keep the full-group compiled shape
            # rounded up so the row count stays shard_map-divisible
            e_pad = max(e_pad, -(-int(pad_to) // n_dev) * n_dev)
        if pad_rows == "host":
            return _stage_rows_host(
                episodes, ns, n_pad, transfer, arena, e_pad, n_dev
            )
        ns_pad = np.zeros(e_pad, np.int32)
        ns_pad[: len(ns)] = ns
        buf = _fill_wire_rows(episodes, n_pad, transfer, arena)
        dev = _pad_episode_rows_on_device(buf, e_pad, transfer)
        return dev, ns_pad, len(episodes)

    def _step(self, n_pad: int):
        if n_pad in self._step_cache:
            return self._step_cache[n_pad]
        from ..ops.stft import ncc_frames_multi_core, stft_log_mel_core

        cfg = self.config
        n_frames_pad = 1 + (n_pad - cfg.n_fft) // cfg.hop
        t_ss = self._t_ss
        n_peaks = min(
            (n_frames_pad - min(t_ss) + 1) // self.distance_frames + 2, 64
        )
        dist = self.distance_frames

        def per_episode(ep, n, fb, snip_fps):
            from ..models.matcher import dequantize_on_device

            fp = stft_log_mel_core(
                dequantize_on_device(ep), fb, cfg.n_fft, cfg.hop, n_frames_pad
            )
            n_frames = jnp.maximum(
                1 + (n - cfg.n_fft) // cfg.hop, 0
            ).astype(jnp.int32)
            # episode tile spectra shared across queries (Q× fewer
            # forward FFTs — the dominant cost); peaks batched over Q
            scores = ncc_frames_multi_core(fp, snip_fps, t_ss)  # [Q, V]
            valid = jnp.maximum(
                n_frames - jnp.asarray(t_ss, jnp.int32) + 1, 0
            )
            return pick_peaks_core(
                scores, valid, dist, n_peaks, 2048
            )  # [Q, S] each

        def local(episodes, ns, fb, snip_fps):
            return jax.lax.map(
                lambda args: per_episode(args[0], args[1], fb, snip_fps),
                (episodes, ns),
            )

        if int(self.mesh.devices.size) > 1:
            axes = tuple(self.mesh.axis_names)
            step = jax.jit(
                jax.shard_map(
                    local,
                    mesh=self.mesh,
                    in_specs=(P(axes, None), P(axes), P(), P()),
                    out_specs=P(axes, None, None),
                )
            )
        else:
            step = jax.jit(local)
        self._step_cache[n_pad] = step
        return step

    def scan_dispatch(self, staged, scale: bool = True):
        """Launch the scan program without blocking on the readback: on
        async backends the returned device arrays are still in flight, so
        the caller can stage the NEXT group while this one executes
        (sweep_archive's dispatch-ahead pipeline)."""
        del scale  # NCC scores are scale-invariant by construction
        episodes_dev, ns, n_real = staged
        # chunked stage: ONE on-device concat + reshape back to [E, Npad]
        episodes_dev = _joined(episodes_dev, rows=len(ns))
        step = self._step(episodes_dev.shape[1])
        outs = step(
            episodes_dev, jnp.asarray(ns, jnp.int32),
            jnp.asarray(self._fb), jnp.asarray(self._snip_fps),
        )
        return outs, ns, n_real

    def scan_collect(self, dispatched):
        """Block on a :meth:`scan_dispatch` handle → peaks[episode][query]."""
        (pos, h, prom), ns, n_real = dispatched
        cfg = self.config
        pos, h, prom = jax.device_get((pos, h, prom))
        out = []
        for e in range(n_real):
            per_query = []
            for q in range(len(self._t_ss)):
                peaks = [
                    Peak(
                        int(pos[e, q, s]) * cfg.hop,
                        float(h[e, q, s]),
                        float(prom[e, q, s]),
                    )
                    for s in range(pos.shape[2])
                    if np.isfinite(h[e, q, s])
                    and h[e, q, s] >= cfg.min_score
                ]
                peaks.sort(key=lambda p: p.position)
                per_query.append(peaks)
            out.append(per_query)
        return out

    def scan_staged(self, staged, scale: bool = True):
        return self.scan_collect(self.scan_dispatch(staged, scale))

    def scan_resident(
        self, episodes: Sequence[np.ndarray], scale=True, arena=None,
        pad_to=None,
    ):
        return self.scan_staged(
            self.stage_resident(episodes, arena, pad_to, pad_rows="device"),
            scale
        )


def sweep_archive(
    paths,
    snippets: Sequence[np.ndarray],
    sr: int,
    config: MatchConfig | None = None,
    mesh: Mesh | None = None,
    progress_path=None,
    write_labels_for=None,
    prefetch_depth: int | None = None,
    resample_mismatched: bool = False,
    mode: str = "pcm",
    spectrogram_config=None,
    group_size: int | None = None,
):
    """Scan an archive of files against query snippets with resume.

    BASELINE.json config #5 (the 10k-file sweep): host decode is pipelined
    ahead of the device (hostio.prefetch), episode groups fill the mesh's
    ``data`` axis, and completion state persists in the reference's
    ``.done.txt`` line format so an interrupted sweep resumes
    (SURVEY.md §5 checkpoint/resume semantics).

    ``mode="spectrogram"`` scans log-mel fingerprints (noise-robust,
    BASELINE config #4) on the same mesh/resume machinery.
    ``write_labels_for``: optional ``fn(path, query_idx, peaks)`` sink.
    ``group_size``: episodes per device dispatch — default is the mesh
    size, raised to 8 on a single chip so per-dispatch overhead (launch,
    readback and per-group staging set-up) amortizes over several
    files; must be a multiple of the mesh size so no chip scans padding.
    Returns {path: [peaks_per_query]}.
    """
    from ..hostio.prefetch import decode_prefetched
    from ..meta.progress import Progress, State

    n_proc = jax.process_count()
    if mesh is None and n_proc > 1:
        # multi-host cluster (after mesh.init_distributed): whole episodes
        # are assigned per host and scanned on each host's local-chip mesh
        # — zero cross-host device traffic. Each
        # process returns/labels only its own share.
        from .mesh import make_local_mesh

        mesh = make_local_mesh()
    if mode == "spectrogram":
        scanner = ShardedSpectrogramScanner(
            snippets, sr, spectrogram_config, mesh
        )
    else:
        scanner = ShardedScanner(snippets, sr, config, mesh)
    progress = Progress(progress_path) if progress_path is not None else None
    todo = []
    for p in paths:
        name = str(p)
        if progress is not None and progress.get(name) == State.DONE:
            continue
        todo.append(p)
    if n_proc > 1:
        todo = todo[jax.process_index()::n_proc]

    # fill the whole flattened mesh: stage_resident pads the episode batch
    # to mesh.devices.size, so smaller groups would scan zero-padding on
    # the remaining chips (a (4,2) mesh would run groups of 4 padded to
    # 8, half the mesh scanning zeros). On a single chip, group
    # several episodes per dispatch (lax.map over the batch) so dispatch
    # overhead amortizes across files.
    n_dev = max(int(scanner.mesh.devices.size), 1)
    if group_size is None:
        group_size = n_dev if n_dev > 1 else 8
    else:
        group_size = max(-(-int(group_size) // n_dev) * n_dev, n_dev)
    if prefetch_depth is None:
        # decode the NEXT group fully while the current one scans on device
        prefetch_depth = max(group_size, 3)
    results = {}
    group: list = []
    # streaming decode→stage (ROADMAP #1): workers decode straight to the
    # staging wire format (int16 from the native decoder, μ-law companded
    # in the worker) so quantization overlaps the previous group's scan,
    # and reusable arenas replace a fresh zeroed buffer per group. TWO
    # arenas ping-pong because the pipeline below stages group N+1 while
    # group N's (possibly async) transfer+scan is still in flight; an
    # arena is only rewritten after the group it fed has been collected.
    transfer = getattr(scanner.config, "transfer_dtype", "float32")
    from ..models.matcher import StagingArena

    arenas = (StagingArena(transfer), StagingArena(transfer))
    # dispatch-ahead pipeline: group N's readback blocks only AFTER group
    # N+1 has been staged and dispatched, so on hosts with async transfer
    # (PCIe) the upload and host packing of the next group overlap the
    # device scan of the current one, so end to end approaches the
    # device-resident rate. One group deep:
    # results/progress land one flush late, still strictly after real
    # device completion (crash-resume semantics unchanged).
    pending: list = []  # at most one (dispatched, ok_items)
    group_idx = 0

    def emit(dispatched, ok_items):
        peaks = scanner.scan_collect(dispatched)
        for item, per_query in zip(ok_items, peaks):
            results[str(item.path)] = per_query
            if write_labels_for is not None:
                for q, pk in enumerate(per_query):
                    write_labels_for(item.path, q, pk)
            if progress is not None:
                progress.append(str(item.path), State.DONE)

    def flush(group, pad_to=None):
        episodes = []
        ok_items = []
        for item in group:
            if item.error is not None:
                log.error("skipping %s: %s", item.path, item.error)
                continue
            samples = item.samples
            if item.sr != scanner.sr:
                if resample_mismatched:
                    from ..hostio.decode import resample

                    # device polyphase when a chip is attached (scipy on
                    # the host stalls the whole pipeline for long
                    # cross-rate episodes);
                    # int16 wire halves the device readback, but only
                    # when the staging format quantizes anyway — a
                    # --transfer float32 sweep keeps f32 fidelity
                    # end-to-end
                    samples = resample(
                        samples, item.sr, scanner.sr,
                        impl=getattr(
                            scanner.config, "resample_impl", "auto"
                        ),
                        wire_int16=transfer != "float32",
                    )
                else:
                    log.error(
                        "skipping %s: sample rate %s != %s "
                        "(pass --resample to convert)",
                        item.path, item.sr, scanner.sr,
                    )
                    continue
            ok_items.append(item)
            episodes.append(samples)
        if not episodes:
            return
        nonlocal group_idx
        # resident path: one flat upload, windows gathered in HBM, forward
        # FFTs shared across queries; shard_map over the mesh when >1 chip
        staged = scanner.stage_resident(
            episodes, arena=arenas[group_idx % 2], pad_to=pad_to,
            pad_rows="device",  # scans execute between stages anyway
        )
        dispatched = scanner.scan_dispatch(staged)
        group_idx += 1
        if pending:
            emit(*pending.pop())
        pending.append((dispatched, ok_items))

    # grouping several small files per dispatch must not blow host RAM on
    # long episodes: the budget is judged on the PADDED staging buffer
    # (rows × the group's widest episode — every row is padded to the
    # longest, so decoded-bytes undercounts a mixed short+long group by
    # the row count), so 2-hour episodes still go one per dispatch and a
    # long episode landing after short ones flushes the shorts first;
    # the same budget bounds the prefetch queue (depth defaults to
    # group_size — without a byte cap that would hold group_size decoded
    # episodes of host RAM on top of the group being assembled)
    max_group_bytes = int(
        os.environ.get("AUDIO_MATCHER_GROUP_BYTES", str(1 << 30))
    )
    row_max = 0  # widest episode in the current group, wire bytes
    for decoded in decode_prefetched(
        todo, depth=prefetch_depth, wire_dtype=transfer,
        expect_sr=scanner.sr, max_bytes=max_group_bytes,
    ):
        new_max = max(row_max, decoded.samples.nbytes)
        if group and (len(group) + 1) * new_max > max_group_bytes:
            flush(group)  # keep the padded buffer inside the budget
            group, new_max = [], decoded.samples.nbytes
        group.append(decoded)
        row_max = new_max
        if len(group) == group_size:
            flush(group, pad_to=group_size)
            group, row_max = [], 0
        elif len(group) * row_max >= max_group_bytes:
            flush(group)
            group, row_max = [], 0
    if group:
        # tail reuses the full-group compiled shape (avoiding one more
        # compile) — but only when the padded staging buffer
        # (group_size rows at this group's widest episode) stays inside
        # the byte budget; a tail of few-but-huge episodes stages unpadded
        # rather than allocating the memory the budget exists to avoid
        max_item = max(
            (item.samples.nbytes for item in group if item.error is None),
            default=0,
        )
        pad_ok = group_size * max_item <= max_group_bytes
        flush(group, pad_to=group_size if pad_ok else None)
    if pending:  # drain the one-group-deep pipeline
        emit(*pending.pop())
    return results


class ShardedScanner:
    """Scan groups of episodes against one or more query snippets.

    Batch layout parity with BASELINE.json config #3 (64 episodes × 4 query
    snippets on one chip) and #5 (archive sweep over a mesh).
    Snippets are zero-padded to a common length; per-query valid ranges are
    masked on device.
    """

    def __init__(
        self,
        snippets: Sequence[np.ndarray],
        sr: int,
        config: MatchConfig | None = None,
        mesh: Mesh | None = None,
    ):
        from .mesh import make_mesh

        self.sr = int(sr)
        self.config = config or MatchConfig()
        self.mesh = mesh or make_mesh()
        preps = [prepare_snippet(s) for s in snippets]
        self.queries = [_Query(p.m, p.inv_autocorr) for p in preps]
        self.m_max = max(q.m for q in self.queries)
        self.m_min = min(q.m for q in self.queries)
        cfg = self.config
        self.chunk = int(round(cfg.chunk_secs * self.sr))
        self.overlap = self.m_max + 2  # see SnippetMatcher edge note
        self.window = self.chunk + self.overlap
        self.valid = self.window - self.m_min + 1
        self.fft_len = fft_length(self.window + self.m_max - 1)
        self.fft_impl = cfg.fft_impl
        self.distance_samples = int(cfg.distance_secs) * self.sr
        self.n_peaks = min(
            self.valid // max(self.distance_samples, 1) + 2,
            cfg.max_peaks_per_chunk,
        )
        padded = np.zeros((len(preps), self.m_max), np.float32)
        for i, p in enumerate(preps):
            padded[i, : p.m] = p.data
        # lazy: keeps construction execution-free so episode staging can
        # ride the pre-execution fast upload path
        self._sample_padded = padded
        self._sample_f_cache = None
        self._sample_f_full_cache = None
        self._inv_ac = jnp.asarray(
            [q.inv_autocorr for q in self.queries], jnp.float32
        )
        self._m = jnp.asarray([q.m for q in self.queries], jnp.int32)
        # one jitted step; XLA retraces per concrete [E, C] shape
        self._step_fn = sharded_match_step(
            self.mesh,
            self.fft_len,
            self.valid,
            self.distance_samples,
            self.n_peaks,
            self.config.block,
        )

    def _step(self):
        return self._step_fn

    @property
    def _sample_f(self):
        if self._sample_f_cache is None:
            self._sample_f_cache = fft_rows(
                "rfft", jnp.asarray(self._sample_padded), self.fft_len
            )
        return self._sample_f_cache

    @property
    def _sample_f_resident(self):
        """Spectra in the form the resident step expects: rfft spectra for
        "xla", packed pair spectra for "xla_packed", scrambled split
        spectra for "mxu"."""
        impl = self.fft_impl
        if impl == "xla":
            return self._sample_f
        if self._sample_f_full_cache is None:
            if impl == "mxu":
                from ..ops.mxu_fft import scrambled_spectra_parts

                self._sample_f_full_cache = jax.jit(
                    scrambled_spectra_parts, static_argnames=("n",)
                )(self._sample_padded, self.fft_len)
            else:  # xla_packed
                from ..ops.correlate import packed_query_spectra

                self._sample_f_full_cache = jax.jit(
                    packed_query_spectra, static_argnames=("fft_len",)
                )(self._sample_padded, self.fft_len)
        return self._sample_f_full_cache

    # -- resident single-chip batch path (BASELINE config #3) -----------
    def stage_resident(
        self,
        episodes: Sequence[np.ndarray],
        arena=None,
        pad_to=None,
        pad_rows: str = "host",
    ):
        """Pack + upload a batch as one flat [E, Npad] array (int16 when
        config.transfer_dtype says so).
        ``arena``: reuse a StagingArena buffer (sweep groups).
        ``pad_to``: minimum episode-count pad — tail sweep groups keep the
        full group's compiled shape instead of retracing.
        ``pad_rows``: how mesh-filling silence rows are grown when the
        episode count falls short. ``"host"`` (default) keeps staging
        strictly execution-free like SnippetMatcher.stage_batch — silence
        rows ride the wire, and the staging time contains no compile or
        program. ``"device"`` uploads only the real rows and pads on
        device — fewest wire bytes, but the pad IS a device program; the
        scan paths (scan_resident, sweep_archive) opt into it because
        they execute between stages anyway."""
        ns = np.array([len(e) for e in episodes], np.int32)
        n_max = int(ns.max()) if len(ns) else 0
        n_windows = max(-(-n_max // self.chunk), 1)
        slab = _effective_slab(self.config, n_windows)
        n_windows_pad = -(-n_windows // slab) * slab
        n_pad = n_windows_pad * self.chunk + self.overlap
        n_dev = int(self.mesh.devices.size)
        e_pad = -(-len(episodes) // n_dev) * n_dev if episodes else 0
        if pad_to:  # rounded up so the row count stays shard_map-divisible
            e_pad = max(e_pad, -(-int(pad_to) // n_dev) * n_dev)
        transfer = self.config.transfer_dtype
        if pad_rows == "host":
            # huge buffers stage as equal ≤-cap puts (_device_put_split)
            return _stage_rows_host(
                episodes, ns, n_pad, transfer, arena, e_pad, n_dev
            )
        ns_pad = np.zeros(e_pad, np.int32)
        ns_pad[: len(ns)] = ns
        buf = _fill_wire_rows(episodes, n_pad, transfer, arena)
        dev = _pad_episode_rows_on_device(buf, e_pad, transfer)
        return dev, ns_pad, len(episodes)

    def scan_dispatch(self, staged, scale: bool = True):
        """Launch the resident scan without blocking on the readback —
        see ShardedSpectrogramScanner.scan_dispatch."""
        episodes_dev, ns, n_real = staged
        # chunked stage: ONE on-device concat + reshape (a device copy)
        # back to the monolithic [E, Npad] layout, then the single scan
        # program (one dispatch, not one per piece). The concat is a
        # device program, but scan time IS execution time; the
        # execution-free discipline only binds stage_resident.
        episodes_dev = _joined(episodes_dev, rows=len(ns))
        cfg = self.config
        n_windows_pad = (episodes_dev.shape[1] - self.overlap) // self.chunk
        n_max = int(ns.max()) if len(ns) else 0
        slab = _effective_slab(cfg, max(-(-n_max // self.chunk), 1))
        if n_windows_pad % slab:  # buffer staged under a different policy
            slab = _divisor_slab(n_windows_pad, cfg.slab)
        n_slabs = n_windows_pad // slab
        if not hasattr(self, "_resident_cache"):
            self._resident_cache = {}
        multi = int(self.mesh.devices.size) > 1
        key = (episodes_dev.shape[1], n_slabs, multi)
        if key not in self._resident_cache:
            args = (
                self.chunk, self.window, self.fft_len, self.valid,
                self.distance_samples, self.n_peaks, cfg.block, slab,
                n_slabs, self.fft_impl, cfg.peaks_impl,
            )
            if multi:
                self._resident_cache[key] = resident_sharded_step(
                    self.mesh, *args
                )
            else:
                self._resident_cache[key] = resident_match_step(*args)[0]
        step = self._resident_cache[key]
        inv_ac = self._inv_ac if scale else jnp.ones_like(self._inv_ac)
        outs = step(
            episodes_dev, jnp.asarray(ns, jnp.int32),
            self._sample_f_resident, inv_ac, self._m,
        )
        return outs, ns, n_real

    def scan_collect(self, dispatched) -> list[list[list[Peak]]]:
        """Block on a :meth:`scan_dispatch` handle → peaks[episode][query]."""
        (pos, h, prom), ns, n_real = dispatched
        cfg = self.config
        pos, h, prom = jax.device_get((pos, h, prom))
        out = []
        for e in range(n_real):
            n_windows = max(-(-int(ns[e]) // self.chunk), 1)
            per_query = []
            for q in range(len(self.queries)):
                cands = []
                for k in range(min(n_windows, pos.shape[2])):
                    for s in range(pos.shape[3]):
                        if (
                            np.isfinite(h[e, q, k, s])
                            and prom[e, q, k, s] >= cfg.min_prominence
                        ):
                            cands.append(
                                Peak(
                                    int(pos[e, q, k, s]) + self.chunk * k,
                                    float(h[e, q, k, s]),
                                    float(prom[e, q, k, s]),
                                )
                            )
                per_query.append(
                    overshadow_filter(cands, self.sr, cfg.distance_secs)
                )
            out.append(per_query)
        return out

    def scan_staged(
        self, staged, scale: bool = True
    ) -> list[list[list[Peak]]]:
        """Scan a :meth:`stage_resident` upload → peaks[episode][query]."""
        return self.scan_collect(self.scan_dispatch(staged, scale))

    def scan_resident(
        self, episodes: Sequence[np.ndarray], scale: bool = True, arena=None,
        pad_to=None,
    ) -> list[list[list[Peak]]]:
        return self.scan_staged(
            self.stage_resident(episodes, arena, pad_to, pad_rows="device"),
            scale
        )

    def _windows(self, episodes: Sequence[np.ndarray], c_windows: int):
        E = len(episodes)
        buf = np.zeros((E, c_windows, self.window), np.float32)
        valid = np.zeros((E, c_windows), np.int32)
        for e, ep in enumerate(episodes):
            ep = np.asarray(ep, np.float32)
            for k in range(c_windows):
                win = ep[k * self.chunk : k * self.chunk + self.window]
                if len(win) == 0:
                    break
                buf[e, k, : len(win)] = win
                valid[e, k] = len(win)  # raw length; per-query crop on device
        return buf, valid

    def scan(
        self, episodes: Sequence[np.ndarray], scale: bool = True
    ) -> list[list[list[Peak]]]:
        """→ peaks[episode][query], deduped & sorted (reference semantics).

        NOTE: this legacy windows path materializes the full [E, C, W] f32
        window tensor ON HOST (kept as the dryrun/equivalence reference);
        at archive scale use :meth:`scan_resident`, which stages the flat
        wire episodes and windows them in HBM."""
        cfg = self.config
        n_max = max(len(e) for e in episodes)
        C = max(-(-n_max // self.chunk), 1)
        host_bytes = len(episodes) * C * self.window * 4
        if host_bytes > 1 << 30:
            log.warning(
                "ShardedScanner.scan() materializes %.1f GB of host windows"
                " — use scan_resident() for batches this size",
                host_bytes / 2**30,
            )
        # pad episode count to a multiple of the data×seq mesh extent so the
        # (data, seq) sharding divides evenly
        mesh_rows = self.mesh.devices.shape[0]
        E = len(episodes)
        E_pad = -(-E // mesh_rows) * mesh_rows
        eps = list(episodes) + [np.zeros(1, np.float32)] * (E_pad - E)
        seq = self.mesh.devices.shape[1]
        C_pad = -(-C // seq) * seq
        windows, valid = self._windows(eps, C_pad)

        step = self._step()
        inv_ac = self._inv_ac if scale else jnp.ones_like(self._inv_ac)
        pos, h, prom = step(
            jnp.asarray(windows), self._sample_f, inv_ac,
            jnp.asarray(valid), self._m,
        )
        pos, h, prom = jax.device_get((pos, h, prom))

        out: list[list[list[Peak]]] = []
        for e in range(E):
            per_query = []
            for q in range(len(self.queries)):
                cands = []
                for k in range(C_pad):
                    for s in range(pos.shape[-1]):
                        if (
                            np.isfinite(h[e, q, k, s])
                            and prom[e, q, k, s] >= cfg.min_prominence
                        ):
                            cands.append(
                                Peak(
                                    int(pos[e, q, k, s]) + self.chunk * k,
                                    float(h[e, q, k, s]),
                                    float(prom[e, q, k, s]),
                                )
                            )
                per_query.append(
                    overshadow_filter(cands, self.sr, cfg.distance_secs)
                )
            out.append(per_query)
        return out
