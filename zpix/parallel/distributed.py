"""Multi-host orchestration.

The reference is a single-call, single-thread library; scaling across
hosts is greenfield (SURVEY.md sec.2.7).  Model:

* every host runs the same program, calls :func:`initialize` (a thin
  jax.distributed wrapper), and builds a global ('batch', 'stripe') mesh
  spanning all hosts.
* work is data-parallel per host: each host entropy-decodes (native
  runtime) its local shard of the image list and feeds local device
  buffers via :func:`host_local_batch`; jax's global arrays assemble the
  logically-global batch without any cross-host pixel traffic.
* outputs stay sharded; only consumers that need a global view gather.

Single-host processes (the common dev case) can use all of this with
jax.distributed uninitialized — the mesh simply spans local devices.
"""

from __future__ import annotations


def initialize(coordinator_address=None, num_processes=None, process_id=None):
    """Initialize jax.distributed when running multi-process.

    No-op (returns False) when single-process or already initialized.
    """
    import jax

    if num_processes is None or num_processes <= 1:
        return False
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
        return True
    except RuntimeError:
        return False  # already initialized


def global_mesh(stripe: int = 1):
    """('batch', 'stripe') mesh over every device in every process."""
    from .mesh import make_mesh

    import jax

    return make_mesh(jax.devices(), stripe=stripe)


def local_shard(items: list, process_id: int | None = None, num_processes: int | None = None):
    """The contiguous slice of a global work list owned by this host."""
    import jax

    pid = jax.process_index() if process_id is None else process_id
    n = jax.process_count() if num_processes is None else num_processes
    per = (len(items) + n - 1) // n
    return items[pid * per : (pid + 1) * per]


def host_local_batch(mesh, local_arrays):
    """Assemble per-host numpy arrays into one global sharded array.

    local_arrays: this host's [local_B, ...] batch; returns a jax global
    array sharded over the mesh 'batch' axis (batch dim = global).
    """
    import jax
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    sharding = NamedSharding(mesh, P("batch"))
    local = np.asarray(local_arrays)
    global_shape = (local.shape[0] * jax.process_count(),) + local.shape[1:]
    return jax.make_array_from_process_local_data(sharding, local, global_shape)
