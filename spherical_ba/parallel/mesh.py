"""Device mesh helpers for the distributed solvers.

The reference has no distributed layer (SURVEY.md §2: OpenMP only); the
communication backend here is JAX collectives over a `jax.sharding.Mesh`
— `psum` for camera-system reduction, sharded landmark/pair axes for data
parallelism. On one host the GPUs are joined all to all by NVLink, so
every device pair is equally close and a plain mesh over `jax.devices()`
is the whole layout; XLA lowers the collectives to NCCL.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

_DISTRIBUTED_INITIALIZED = False


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> int:
    """Multi-process (multi-host) entry point: initialize the JAX
    distributed runtime so `jax.devices()` spans every process's devices.

    With no arguments, relies on JAX's cluster autodetection (a managed
    cluster environment); where there is none, pass coordinator_address
    ("host:port"), num_processes and process_id explicitly. Single-process
    callers can skip this entirely — every solver works on the local
    mesh. Returns the process index (0 in single-process mode).
    Idempotent.
    """
    global _DISTRIBUTED_INITIALIZED
    if _DISTRIBUTED_INITIALIZED:
        return jax.process_index()
    if coordinator_address is None and num_processes is None:
        try:
            jax.distributed.initialize()
        except Exception:
            # no cluster env: stay single-process (local devices only)
            return 0
    else:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    _DISTRIBUTED_INITIALIZED = True
    return jax.process_index()


def make_mesh(n_devices: int | None = None, axis_name: str = "data") -> Mesh:
    """1-D mesh over the first n_devices (all by default)."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis_name,))


def make_mesh_2d(
    n_pairs: int,
    n_landmarks: int | None = None,
    axis_names: tuple[str, str] = ("pairs", "data"),
) -> Mesh:
    """2-D mesh (pairs x landmarks): the outer axis shards independent
    problems/pairs (pure data parallelism, zero collectives), the inner
    axis shards each problem's landmark table (psum-reduced camera
    aggregates). Devices are taken in `jax.devices()` order; across hosts,
    keep each inner-axis group on one host so the landmark psums stay on
    its NVLink domain.
    """
    devs = jax.devices()
    if n_landmarks is None:
        n_landmarks = len(devs) // n_pairs
    assert n_pairs * n_landmarks <= len(devs), (
        f"mesh {n_pairs}x{n_landmarks} needs {n_pairs * n_landmarks} devices, "
        f"have {len(devs)}"
    )
    grid = np.asarray(devs[: n_pairs * n_landmarks]).reshape(n_pairs, n_landmarks)
    return Mesh(grid, axis_names)


def shard_leading(mesh: Mesh, axis_name: str = "data"):
    """NamedSharding that splits the leading array axis over the mesh."""
    return NamedSharding(mesh, P(axis_name))


def replicated(mesh: Mesh):
    return NamedSharding(mesh, P())
