"""Pipelined host decode: prefetch audio files ahead of device compute.

The reference's hot loop decodes mp3 lazily on the scanning thread
(SURVEY.md §3.1 — the serial decode feeds the chunker); here the decode
must instead run AHEAD of the device so host I/O and accelerator compute
overlap. A small thread pool decodes up to ``depth`` files in advance into
a bounded queue (double/triple buffering).

With ``wire_dtype`` set, workers emit samples already in the device staging
wire format (int16 straight from the native decoder, μ-law companding in
the worker): the whole decode→wire conversion overlaps the previous
group's device scan, and the sweep's critical path shrinks to a row memcpy
plus the upload (ROADMAP #1 streaming decode→stage).
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import logging
from pathlib import Path
from typing import Iterable, Iterator

import numpy as np

from .decode import read_audio, read_audio_int16

log = logging.getLogger("audio_matcher.prefetch")


@dataclasses.dataclass
class DecodedFile:
    path: Path
    sr: int
    samples: np.ndarray
    error: Exception | None = None


def _decode_wire(
    path: Path, wire_dtype: str, expect_sr: int | None
) -> DecodedFile:
    """Decode to the staging wire format. A sample-rate mismatch leaves the
    samples on the int16 grid (not companded): the caller's resample path
    consumes int16/f32, and staging re-encodes to the wire dtype."""
    if wire_dtype == "float32":
        sr, samples = read_audio(path)
        return DecodedFile(path, sr, samples)
    sr, wire = read_audio_int16(path)
    if wire_dtype == "mulaw8" and (expect_sr is None or sr == expect_sr):
        from ..models.matcher import quantize_wire

        wire = quantize_wire(wire, "mulaw8")
    return DecodedFile(path, sr, wire)


def decode_prefetched(
    paths: Iterable[str | Path],
    depth: int = 2,
    workers: int = 2,
    wire_dtype: str | None = None,
    expect_sr: int | None = None,
    max_bytes: int | None = None,
) -> Iterator[DecodedFile]:
    """Yield decoded files in order while decoding ``depth`` ahead.

    ``wire_dtype``: emit samples in this staging wire format
    (float32/int16/mulaw8) instead of f32 PCM — the conversion happens in
    the worker thread. ``expect_sr``: the scanner's rate; mismatched files
    stay int16 so the resample path gets raw samples.
    ``max_bytes``: stop queueing NEW decodes once the completed-but-
    unconsumed results exceed this budget, so a deep ``depth`` (the sweep
    uses group_size) cannot hold several long episodes of host RAM at
    once; up to ``workers`` in-flight decodes are always allowed so the
    pipeline keeps moving (their sizes are unknown until done).
    """
    paths = [Path(p) for p in paths]

    def job(path: Path) -> DecodedFile:
        try:
            if wire_dtype is not None:
                return _decode_wire(path, wire_dtype, expect_sr)
            sr, samples = read_audio(path)
            return DecodedFile(path, sr, samples)
        except Exception as exc:  # noqa: BLE001 — surfaced to the consumer
            return DecodedFile(path, 0, np.zeros(0, np.float32), exc)

    with cf.ThreadPoolExecutor(max_workers=workers) as pool:
        pending: list[cf.Future] = []
        it = iter(paths)

        def queued_bytes() -> int:
            return sum(
                f.result().samples.nbytes for f in pending if f.done()
            )

        def refill() -> None:
            while len(pending) < depth:
                if max_bytes is not None:
                    # in-flight sizes are unknown until done, so cap the
                    # UNDONE submissions at the worker count — otherwise
                    # the first refill fills to ``depth`` while
                    # queued_bytes() is still 0 and a stalled consumer
                    # later accumulates depth× episodes of host RAM
                    undone = sum(1 for f in pending if not f.done())
                    if (
                        undone >= max(workers, 1)
                        or queued_bytes() >= max_bytes
                    ):
                        return
                nxt = next(it, None)
                if nxt is None:
                    return
                pending.append(pool.submit(job, nxt))

        refill()
        while pending:
            fut = pending.pop(0)
            refill()
            yield fut.result()
            refill()
