"""REAL multi-process jax.distributed exercise (VERDICT r3 next #5).

Launches 2 coordinator-connected CPU processes on localhost
(jax.distributed supports multi-process CPU), renders the same small
scene through the globally-sharded trace via DistributedEngine-style
sharding with per-host shard assembly (make_global_array's multi-host
branch), and asserts the assembled global radiance matches a
single-process render of the identical program bit-for-bit.

Reference mapping: the cluster-engine extension point the reference
anticipates but never ships (raysect/core/workflow.py:42-48)."""

import os
import socket
import subprocess
import sys

import numpy as np

_WORKER = os.path.join(os.path.dirname(__file__), "_distributed_worker.py")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_render_matches_single(tmp_path):
    port = _free_port()
    env_base = dict(os.environ)
    env_base["JAX_PLATFORMS"] = "cpu"
    env_base["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    procs = []
    for pid in range(2):
        env = dict(env_base)
        env["JAX_COORDINATOR_ADDRESS"] = f"127.0.0.1:{port}"
        env["JAX_NUM_PROCESSES"] = "2"
        env["JAX_PROCESS_ID"] = str(pid)
        env["_OUT_PREFIX"] = str(tmp_path / f"proc{pid}")
        procs.append(subprocess.Popen(
            [sys.executable, _WORKER], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=600)
        outs.append(out.decode())
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out}"

    # single-process reference of the identical program
    env = dict(env_base)
    env["_OUT_PREFIX"] = str(tmp_path / "single")
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    r = subprocess.run([sys.executable, _WORKER], env=env,
                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                       timeout=600)
    assert r.returncode == 0, r.stdout.decode()

    ref = np.load(str(tmp_path / "single_radiance.npy"))
    got0 = np.load(str(tmp_path / "proc0_radiance.npy"))
    got1 = np.load(str(tmp_path / "proc1_radiance.npy"))
    # each process wrote ITS half of the global batch (host shard
    # assembly); together they tile the single-process result exactly
    assembled = np.concatenate([got0, got1], axis=0)
    np.testing.assert_array_equal(assembled, ref)
    # the workers really ran as a 2-process group
    meta0 = np.load(str(tmp_path / "proc0_meta.npy"))
    assert meta0[0] == 2 and meta0[1] == 8  # process_count, global devices
