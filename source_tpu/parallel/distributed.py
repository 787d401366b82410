"""Multi-process orchestration + per-host data feeding.

The reference names clusters as the intended RenderEngine extension
(core/workflow.py:42-48 "single cores, multi-cores (SMP) and clusters");
its actual backend is single-host multiprocessing. The equivalent here
(SURVEY.md §5.8): ``jax.distributed`` initialises the process group, a
GLOBAL mesh spans every card of every process, scene tables replicate,
pixel tiles shard over the mesh's ray axis, and XLA reduces frame
statistics / scene-parameter gradients across the mesh automatically from
the sharding contract.

Usage: one python process per host, which uses every card of its host; or
one process per card, when the launcher names each process's rank on its
host (``JAX_LOCAL_PROCESS_ID``, ``SLURM_LOCALID`` or
``OMPI_COMM_WORLD_LOCAL_RANK``):

    from source_tpu.parallel import distributed
    distributed.initialise()            # env-driven; no-op single-process
    engine = distributed.DistributedEngine()
    camera.render_engine = engine       # observers shard over ALL hosts
"""

from __future__ import annotations

import os

import numpy as np

from .engine import ShardedEngine

__all__ = [
    "initialise",
    "is_initialised",
    "process_index",
    "process_count",
    "DistributedEngine",
    "host_local_shard",
    "make_global_array",
]

_INITIALISED = False


def initialise(coordinator_address=None, num_processes=None, process_id=None,
               local_device_ids=None):
    """Initialise the JAX process group (jax.distributed.initialize).

    All arguments fall back to the standard environment variables
    (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID /
    JAX_LOCAL_DEVICE_IDS). Calling with no configuration in a
    single-process run is a safe no-op, so user scripts can call this
    unconditionally.

    With several processes, no device list and a host-local rank named by
    the launcher (see ``_LOCAL_RANK_VARS``), each process sees ONE card,
    the one numbered by that rank: a JAX process reserves most of every
    card it sees, so two processes on one host sharing all its cards would
    run the second out of memory. Without such a rank each process is
    taken to be alone on its host and uses all of its cards.
    """
    global _INITIALISED
    import jax

    if _INITIALISED:
        return
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    )
    if num_processes is None and "JAX_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and "JAX_PROCESS_ID" in os.environ:
        process_id = int(os.environ["JAX_PROCESS_ID"])
    if coordinator_address is None and num_processes is None:
        return  # single-process run
    local_device_ids = _local_device_ids(local_device_ids, num_processes,
                                         os.environ)
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
    )
    _INITIALISED = True


# launchers' names for a process's rank among the processes on its host
# (SLURM and Open MPI are the ones jax.distributed detects on its own)
_LOCAL_RANK_VARS = ("JAX_LOCAL_PROCESS_ID", "SLURM_LOCALID",
                    "OMPI_COMM_WORLD_LOCAL_RANK")


def _local_device_ids(local_device_ids, num_processes, environ):
    """The cards this process may use (None: all it can see)."""
    if local_device_ids is not None or environ.get("JAX_LOCAL_DEVICE_IDS"):
        return local_device_ids
    if not num_processes or num_processes < 2:
        return None
    for var in _LOCAL_RANK_VARS:
        if environ.get(var):
            return [int(environ[var])]
    return None


def is_initialised():
    return _INITIALISED


def process_index():
    import jax

    return jax.process_index()


def process_count():
    import jax

    return jax.process_count()


def host_local_shard(n_total, axis_devices=None):
    """(start, stop) slice of a length-``n_total`` global axis owned by this
    process, assuming even sharding over the global device order."""
    import jax

    n_proc = jax.process_count()
    pid = jax.process_index()
    per = n_total // n_proc
    if n_total % n_proc:
        raise ValueError(
            f"global axis length {n_total} does not divide over {n_proc} hosts"
        )
    return pid * per, (pid + 1) * per


def make_global_array(mesh, axis_name, host_array):
    """Assemble a globally-sharded jax.Array from per-host numpy shards.

    ``host_array`` is THIS process's slice of the global leading axis (use
    :func:`host_local_shard` to compute it). Single-process: returns the
    device-sharded array directly.
    """
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    sharding = NamedSharding(mesh, P(axis_name))
    if jax.process_count() == 1:
        return jax.device_put(host_array, sharding)
    n_local = host_array.shape[0]
    global_shape = (n_local * jax.process_count(),) + host_array.shape[1:]
    offset = jax.process_index() * n_local

    def cb(index):
        # index is a global slice owned by one local device; translate to
        # this host's local coordinates
        sl = index[0]
        start = (sl.start or 0) - offset
        stop = (sl.stop if sl.stop is not None else global_shape[0]) - offset
        return host_array[(slice(start, stop),) + index[1:]]

    return jax.make_array_from_callback(global_shape, sharding, cb)


class DistributedEngine(ShardedEngine):
    """ShardedEngine over the GLOBAL device set (every card of every process).

    In one process this degenerates to ShardedEngine over local devices.
    Observers handed this engine shard their pixel-tile axis over all
    cards; each process's observe() call must pass the same task list (the
    scenegraph is replicated by construction — same user script runs on
    every host).
    """

    def __init__(self, axis_name="rays"):
        import jax

        from .engine import default_mesh

        super().__init__(default_mesh(jax.devices()), axis_name)

    @property
    def n_hosts(self):
        import jax

        return jax.process_count()
