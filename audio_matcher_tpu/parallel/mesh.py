"""Device-mesh helpers for multi-chip sharding.

The reference's only compute parallelism is a rayon thread pool over chunks
(SURVEY.md §2.17); the device counterpart is SPMD over a
``jax.sharding.Mesh``: episodes shard over the ``data`` axis and each
episode's overlap-save windows shard over the ``seq`` axis (window
materialization makes the halo explicit, so the "sequence parallelism" is
embarrassingly parallel — SURVEY.md §5 long-context note).
"""

from __future__ import annotations

import logging
import os

import jax
import numpy as np
from jax.sharding import Mesh

log = logging.getLogger("audio_matcher.mesh")

_DISTRIBUTED_INITIALIZED = False


def init_distributed(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> bool:
    """Join a multi-process JAX cluster (SURVEY §5 distributed
    communication backend).

    Arguments default from the environment (``AM_COORDINATOR`` as
    ``host:port``, ``AM_NUM_PROCESSES``, ``AM_PROCESS_ID``); nothing is
    auto-detected. Safe to call unconditionally: returns False (no-op)
    when no coordinator is configured, True once the process group is up.
    After it returns True, ``jax.devices()`` spans every process and
    :func:`make_mesh` builds a process-spanning mesh. A failed join
    raises: silently dropping to single-process would make EVERY process
    scan the whole archive (duplicate work plus racing label/progress
    writes) while any peer that did join hangs at the barrier.
    """
    global _DISTRIBUTED_INITIALIZED
    if _DISTRIBUTED_INITIALIZED:
        return True
    coordinator = coordinator or os.environ.get("AM_COORDINATOR")
    if not coordinator:
        return False
    num_processes = num_processes or int(
        os.environ.get("AM_NUM_PROCESSES", "0")
    )
    process_id_env = os.environ.get("AM_PROCESS_ID")
    if process_id is None and process_id_env is not None:
        process_id = int(process_id_env)
    if num_processes < 1 or process_id is None:
        raise ValueError(
            "AM_COORDINATOR is set but AM_NUM_PROCESSES/AM_PROCESS_ID "
            "are missing — every process in the cluster needs all three"
        )
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )
    _DISTRIBUTED_INITIALIZED = True
    log.info(
        "joined distributed cluster: process %d/%d, %d global devices",
        jax.process_index(), jax.process_count(), len(jax.devices()),
    )
    return True


def make_local_mesh(
    axis_names: tuple[str, str] = ("data", "seq"),
) -> Mesh:
    """A mesh over THIS process's chips only.

    The archive sweep is embarrassingly parallel over episodes, so the
    multi-host layout that never touches DCN is: whole episodes assigned
    per host, each host scanning on its local-chip mesh (sweep_archive
    partitions the file list by ``jax.process_index()``).
    """
    return _grid_mesh(jax.local_devices(), axis_names)


def make_mesh(
    n_devices: int | None = None,
    axis_names: tuple[str, str] = ("data", "seq"),
) -> Mesh:
    """Create a 2D (data × seq) mesh over available devices.

    Prefers a wide ``data`` axis (episode parallelism dominates the archive
    sweep) with ``seq`` = 1 or 2. In a multi-process cluster (after
    :func:`init_distributed`) the mesh spans every process's devices; each
    process's local devices stay contiguous on the ``data`` axis. The grid
    follows the algorithm only: the cards of one host all reach each other
    at the same rate, so no physical topology is encoded.
    """
    devices = jax.devices()  # global across processes once distributed
    if n_devices is not None:
        if n_devices <= 0:
            raise ValueError(f"n_devices must be positive, got {n_devices}")
        if n_devices > len(devices):
            log.warning(
                "requested %d devices but only %d available — using %d",
                n_devices, len(devices), len(devices),
            )
        devices = devices[:n_devices]
    return _grid_mesh(devices, axis_names)


def _grid_mesh(devices, axis_names) -> Mesh:
    """Shared (data × seq) grid shaping: wide ``data`` axis (episode
    parallelism dominates), ``seq`` ∈ {1, 2}."""
    n = len(devices)
    seq = 2 if n % 2 == 0 and n >= 4 else 1
    data = n // seq
    dev_grid = np.array(devices[: data * seq]).reshape(data, seq)
    return Mesh(dev_grid, axis_names)
