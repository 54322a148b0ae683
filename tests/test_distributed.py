"""Multi-process (2-host emulation) exercise of parallel/distributed.py.

SURVEY.md section 4 names single-host multi-device CPU emulation as the
fake backend; this goes one rung further and spawns TWO OS processes
coordinated by jax.distributed — the same initialize / local_shard /
host_local_batch path a real 2-host launch uses, minus the
DCN.  Each process decodes its local shard of the batch, assembles the
global sharded array, runs the jitted back-end over the global mesh, and
verifies its addressable output shards against the single-process decode.
"""

import os
import socket
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = r"""
import os, sys
pid = int(sys.argv[1]); nproc = int(sys.argv[2]); port = sys.argv[3]
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=4"
).strip()
sys.path.insert(0, os.environ["ZPIX_REPO"])
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")

from zpix.parallel import distributed
from zpix.parallel.batch import parse_coefficients, _ycbcr_graph

ok = distributed.initialize(
    coordinator_address=f"localhost:{port}", num_processes=nproc, process_id=pid
)
assert ok, "initialize() returned False for a multi-process launch"
assert jax.process_count() == nproc, jax.process_count()
assert len(jax.devices()) == 4 * nproc, jax.devices()

mesh = distributed.global_mesh()
assert mesh.shape["batch"] * mesh.shape["stripe"] == 4 * nproc

# Global work list: 8 copies of a real 4:2:0 image; each host parses
# only its contiguous shard (no cross-host pixel traffic).
path = "/root/reference/src/testdata/video-001.q50.420.jpeg"
data = open(path, "rb").read()
work = [data] * 8
local = distributed.local_shard(work)
assert len(local) == 4

fe = parse_coefficients(local[0])
stack = lambda a: np.stack([a] * len(local))
args = [stack(fe.coeffs[0]), stack(fe.coeffs[1]), stack(fe.coeffs[2]),
        stack(fe.quants[0]), stack(fe.quants[1]), stack(fe.quants[2])]
garrs = [distributed.host_local_batch(mesh, a) for a in args]
assert garrs[0].shape[0] == len(work), garrs[0].shape

from functools import partial
from jax.sharding import NamedSharding, PartitionSpec as P

fn = jax.jit(
    partial(_ycbcr_graph, height=fe.height, width=fe.width, ratio=fe.ratio),
    out_shardings=NamedSharding(mesh, P("batch")),
)
out = fn(*garrs)
out.block_until_ready()
assert out.shape == (8, fe.height, fe.width, 3), out.shape

# Reference: single-process decode of one image through the same graph.
ref = np.asarray(
    jax.jit(partial(_ycbcr_graph, height=fe.height, width=fe.width,
                    ratio=fe.ratio))(*[a[:1] for a in args])
)[0]
for shard in out.addressable_shards:
    got = np.asarray(shard.data)
    for i in range(got.shape[0]):
        assert np.array_equal(got[i], ref), f"shard {shard.index} differs"
print(f"WORKER_{pid}_OK")
"""


def test_two_process_distributed_decode(tmp_path):
    port = _free_port()
    env = dict(os.environ)
    env["ZPIX_REPO"] = REPO
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(i), "2", str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
            text=True,
        )
        for i in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=420)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} rc={p.returncode}:\n{out[-3000:]}"
        assert f"WORKER_{i}_OK" in out, out[-3000:]


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port
