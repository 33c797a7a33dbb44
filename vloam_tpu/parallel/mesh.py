"""Device-mesh helpers for the distributed mapping / BA backend."""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Multi-host bring-up: join the jax.distributed coordination service so
    ``jax.devices()`` spans every host's devices and meshes built from it
    carry cross-host collectives.

    Pass all three arguments: nothing in the environment supplies them
    (tools/launch_multihost.py runs N local processes x 4 virtual CPU
    devices this way).  Idempotent: safe to call when the backend is
    already initialized.
    """
    if jax.distributed.is_initialized():
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def map_mesh(n_devices: int | None = None, axis: str = "map") -> Mesh:
    """1-D mesh over the map-shard axis.

    Uses the GLOBAL device list, so after ``init_distributed`` on a
    multi-host job it spans hosts.  The mesh follows the algorithm alone:
    the sharded step's collectives assume no topology."""
    devs = jax.devices()
    n = len(devs) if n_devices is None else n_devices
    if n < 1 or len(devs) < n:
        platform = devs[0].platform if devs else "none"
        raise RuntimeError(
            f"map_mesh({n}) needs {n} >= 1 devices but jax.devices() has "
            f"{len(devs)} ({platform}); for a virtual CPU mesh set "
            "JAX_PLATFORMS=cpu and XLA_FLAGS=--xla_force_host_platform_"
            "device_count=N before importing jax (see tests/conftest.py)"
        )
    return Mesh(np.array(devs[:n]), (axis,))


def shard_map_state(state, mesh: Mesh, axis: str = "map"):
    """Place a MapState with cube-slot arrays AND the per-shard submap-cache
    arrays sharded along the mesh axis; poses/flags replicated.  Expects a
    state built with ``init_map_state(cfg, n_shards=S)`` (cache arrays sized
    S x per-shard capacity)."""
    from vloam_tpu.parallel.mapping_shard import MAP_SHARDED_FIELDS

    cube = NamedSharding(mesh, P(axis))
    rep = NamedSharding(mesh, P())
    leaves = []
    for name, leaf in zip(state._fields, state):
        leaves.append(jax.device_put(leaf, cube if name in MAP_SHARDED_FIELDS else rep))
    return type(state)(*leaves)
