"""Device mesh construction.

The multi-chip layer the reference never had (SURVEY.md §2.7): a 2-D
``(data, model)`` mesh — ``data`` shards the sampled decoder batch
(DP over IID (time, node) pairs), ``model`` shards the node dimension of
the graph operators and the wide decoder projections (the graph analog
of tensor parallelism). Collectives are inserted by XLA from sharding
annotations and ride the device interconnect.
"""
from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(data: int = 1, model: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    devices = list(devices if devices is not None else jax.devices())
    need = data * model
    assert len(devices) >= need, \
        f"need {need} devices, have {len(devices)}"
    arr = np.array(devices[:need]).reshape(data, model)
    return Mesh(arr, ("data", "model"))


def local_mesh(model_axis: int = 1) -> Mesh:
    """All local devices, model axis of the given size, rest data."""
    n = len(jax.devices())
    assert n % model_axis == 0
    return make_mesh(n // model_axis, model_axis)


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> int:
    """Multi-host initialization (SURVEY.md §5.8): call once per host
    before any mesh construction on a multi-host cluster. No-op when running
    single-process (the only mode available in this environment).
    Returns the process count."""
    if num_processes is None or num_processes <= 1:
        return 1
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes, process_id=process_id)
    return jax.process_count()
