"""Device-mesh utilities for stream-parallel codec execution.

Parallelism model (SURVEY.md §2.7): LC3plus frames are tiny and frame-serial
per stream, so ALL parallelism rides the stream axis. A 1-D ('streams',)
mesh spans every device (and every host under jax.distributed); state lives
device-local as [n_streams, ...] shards, frames advance in lock-step, and
the only collectives are metric reductions (psum) and stream migration
(ppermute / all_to_all) when rebalancing. The mesh follows the algorithm
alone: on GPUs joined all to all by NVLink every device reaches every other
at the same rate, so no torus shape is imposed.
"""
from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def stream_mesh(devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), axis_names=("streams",))


def shard_streams(mesh: Mesh) -> NamedSharding:
    """Sharding for [n_streams, ...] arrays: leading axis over the mesh."""
    return NamedSharding(mesh, P("streams"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_state(mesh: Mesh, tree):
    """Place a [B, ...] state pytree with the stream axis sharded.

    Works on single-host meshes (plain device_put) and multi-host meshes
    (each process contributes its local slice; jax.make_array assembles the
    global array across hosts — the SURVEY §2.7 'hosts' axis)."""
    sh = shard_streams(mesh)
    if _single_host(mesh):
        return jax.tree_util.tree_map(lambda x: jax.device_put(x, sh), tree)
    return jax.tree_util.tree_map(lambda x: global_streams(mesh, x), tree)


def _single_host(mesh: Mesh) -> bool:
    pi = jax.process_index()
    return all(d.process_index == pi for d in mesh.devices.flat)


def global_streams(mesh: Mesh, x, axis: int = 0):
    """Build a globally-sharded array from a full host-local [B, ...] array.

    Every process passes the SAME full array (deterministic state init /
    test inputs); each contributes only the shards its devices own, so no
    cross-host data transfer happens — the global view is assembled from
    metadata."""
    sh = shard_streams(mesh) if axis == 0 else NamedSharding(
        mesh, P(*([None] * axis + ["streams"])))
    x = np.asarray(x)
    return jax.make_array_from_callback(x.shape, sh, lambda idx: x[idx])


def distributed_init(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> None:
    """Multi-host entry point (jax.distributed, SURVEY.md §2.7): call once
    per process before any backend use; jax.devices() then spans all hosts
    and stream_mesh() returns the global mesh. Pass the arguments explicitly
    (or via JAX_COORDINATOR_ADDRESS/NUM_PROCESSES/PROCESS_ID): nothing in a
    plain GPU or CPU cluster lets JAX detect them."""
    import os
    kw = {}
    if coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS"):
        kw["coordinator_address"] = (coordinator_address
                                     or os.environ["JAX_COORDINATOR_ADDRESS"])
    if num_processes is not None or os.environ.get("JAX_NUM_PROCESSES"):
        kw["num_processes"] = int(num_processes
                                  if num_processes is not None
                                  else os.environ["JAX_NUM_PROCESSES"])
    if process_id is not None or os.environ.get("JAX_PROCESS_ID"):
        kw["process_id"] = int(process_id if process_id is not None
                               else os.environ["JAX_PROCESS_ID"])
    jax.distributed.initialize(**kw)
