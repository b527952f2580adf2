"""Multi-host execution: N processes x M devices as ONE global jobs mesh.

The reference is a single process with shared-memory threads only
(SURVEY §2.5; node.cpp:196-345) — multi-host is our own capability:
each host runs the same program, `jax.distributed` wires the
processes into one runtime over the network, and the executor's `jobs`
mesh axis simply spans every device of every host. Host-side work
(prep, backtrack, ancestral builds) is replicated — each process
feeds identical per-job numpy arrays to `jax.device_put`, which
slices out the local shards; results are gathered back with
`process_allgather` so every host finishes with the full alignment.

Wire-up is three CLI flags (our extension; the reference has no
analogue):

    python -m pagan2_tpu ... \
        --jax-coordinator host0:1234 --jax-num-processes 2 \
        --jax-process-id $RANK [--jax-local-device $LOCAL_RANK]

`tests/test_multihost.py` proves the path end to end with two real
processes on CPU devices: a jobs-axis-sharded generation fill across
the process boundary is bit-identical to the single-process fill.
"""
from __future__ import annotations

import numpy as np


def init_multihost(coordinator: str, num_processes: int,
                   process_id: int, local_device: int | None = None) -> None:
    """jax.distributed.initialize with the CLI's settings. Call before
    any other jax API touches the backend.  local_device pins this
    process to one local card when several processes share a host
    (one process per card: a JAX process reserves most of a card's
    memory when it first uses it)."""
    import jax
    jax.distributed.initialize(
        coordinator_address=coordinator, num_processes=num_processes,
        process_id=process_id,
        local_device_ids=None if local_device is None else [local_device])


def global_jobs_mesh():
    """A `jobs` mesh over EVERY device of every connected process
    (executor.make_jobs_mesh spans only locally-addressable ones)."""
    import jax
    from jax.sharding import Mesh
    return Mesh(np.array(jax.devices()), ("jobs",))


def gather_to_host(x) -> np.ndarray:
    """Full value of a globally-sharded array on every process (one
    allgather over the network; the executor's host-side finish needs whole
    planes)."""
    import jax
    arr = x if isinstance(x, jax.Array) else None
    if arr is not None and arr.is_fully_addressable:
        return np.asarray(arr)
    from jax.experimental import multihost_utils
    return np.asarray(multihost_utils.process_allgather(x, tiled=True))
