"""Multi-host (2-process) jax.distributed smoke test on CPU:
``init_distributed`` via the runner flags' code path, a global mesh
spanning both processes, and a cross-process collective (global sum
over a process-sharded array)."""
import os
import socket
import subprocess
import sys

import pytest

pytestmark = pytest.mark.slow

WORKER = r"""
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from sgp.parallel import init_distributed

port, pid = sys.argv[1], int(sys.argv[2])
n = init_distributed(f"127.0.0.1:{port}", 2, pid)
assert n == 2, n
assert len(jax.devices()) == 8 and len(jax.local_devices()) == 4
mesh = Mesh(np.array(jax.devices()), ("data",))
sharding = NamedSharding(mesh, P("data"))
local = np.full((4,), float(pid + 1), np.float32)
arr = jax.make_array_from_process_local_data(sharding, local,
                                             global_shape=(8,))
total = float(jax.jit(jnp.sum, out_shardings=NamedSharding(mesh, P()))(arr))
assert total == 12.0, total  # 4*1 + 4*2 across processes
print(f"OK {pid} {total}")
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.skipif(os.environ.get("SGP_SKIP_DIST") == "1",
                    reason="distributed smoke disabled")
def test_two_process_distributed_cpu(tmp_path):
    worker = tmp_path / "worker.py"
    worker.write_text(WORKER)
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = (os.path.dirname(os.path.dirname(__file__))
                         + os.pathsep + env.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, str(worker), str(port),
                               str(pid)], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for pid in range(2)]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=180)
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out}"
        assert f"OK {pid} 12.0" in out, out
