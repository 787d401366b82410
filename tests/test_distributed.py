"""Multi-host scaffolding (parallel/distributed.py) — single-process paths.

Real multi-process runs need N processes; these tests cover the
process-group wrapper's no-op path, the global-array assembly on a local
mesh, and the DistributedEngine sharding contract on the virtual 8-device
CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from source_tpu.parallel import distributed
from source_tpu.parallel.engine import default_mesh


def test_initialise_single_process_noop():
    distributed.initialise()  # no coordinator configured -> safe no-op
    assert not distributed.is_initialised()
    assert distributed.process_count() == 1
    assert distributed.process_index() == 0


@pytest.mark.parametrize("given,n_proc,environ,expected", [
    (None, 4, {}, None),  # one process per host: every card of its host
    (None, 4, {"JAX_LOCAL_PROCESS_ID": "1"}, [1]),  # host-local rank
    (None, 4, {"SLURM_LOCALID": "3"}, [3]),
    (None, 4, {"OMPI_COMM_WORLD_LOCAL_RANK": "2"}, [2]),
    ([0, 1], 4, {"SLURM_LOCALID": "3"}, [0, 1]),  # an explicit list wins
    (None, 4, {"JAX_LOCAL_DEVICE_IDS": "2"}, None),  # left to JAX
    (None, 1, {"JAX_LOCAL_PROCESS_ID": "0"}, None),  # one process: all cards
])
def test_one_card_per_process(given, n_proc, environ, expected):
    assert distributed._local_device_ids(given, n_proc, environ) == expected


def test_host_local_shard():
    start, stop = distributed.host_local_shard(64)
    assert (start, stop) == (0, 64)


def test_make_global_array_single_process():
    mesh = default_mesh()
    arr = np.arange(32 * 3, dtype=np.float32).reshape(32, 3)
    out = distributed.make_global_array(mesh, "rays", arr)
    np.testing.assert_allclose(np.asarray(out), arr)
    # sharded over the mesh axis
    assert len(out.sharding.device_set) == mesh.devices.size


def test_distributed_engine_observe():
    from source_tpu.core import Point3D, translate
    from source_tpu.core.scenegraph import World
    from source_tpu.optical import ConstantSF
    from source_tpu.optical.material import UniformSurfaceEmitter
    from source_tpu.optical.observer import PinholeCamera, PowerPipeline2D
    from source_tpu.primitive import Box

    world = World()
    Box(Point3D(-5, -5, 2), Point3D(5, 5, 2.2), parent=world,
        material=UniformSurfaceEmitter(ConstantSF(1.0)))
    engine = distributed.DistributedEngine()
    assert engine.n_devices == len(jax.devices())
    assert engine.n_hosts == 1
    power = PowerPipeline2D()
    cam = PinholeCamera((8, 8), parent=world, pipelines=[power],
                        transform=translate(0, 0, -1),
                        render_engine=engine)
    cam.pixel_samples = 16
    cam.spectral_bins = 2
    cam.quiet = True
    cam.observe(seed=2)
    assert power.frame.mean.max() > 0.0
