"""Device mesh construction and multi-host initialization.

The reference is single-threaded C++ with no distribution (SURVEY.md §2
"Parallelism"); its two inherent parallel axes become mesh axes here:

- ``"c"`` — channel parallelism: the embarrassingly parallel per-channel
  loop of ``brutefir::run`` (brutefir.cpp:252).
- ``"p"`` — partition parallelism: the frequency-domain MAC over filter
  partitions (brutefir.cpp:292-299) becomes a reduce axis: each device MACs
  its partitions, partial sums meet in a psum over ``"p"``.

Multi-host: ``jax.distributed.initialize`` + a mesh over all devices;
within-host shards talk over NVLink (every GPU of a host reaches every
other at the same rate, so the mesh follows the algorithm, not a torus),
and the ``"c"`` axis is placed outermost so cross-host traffic only carries
the small per-channel boundaries.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> None:
    """Multi-host bring-up (no-op for single-process)."""
    if num_processes and num_processes > 1:
        jax.distributed.initialize(
            coordinator_address=coordinator,
            num_processes=num_processes,
            process_id=process_id,
        )


def make_mesh(channel_shards: Optional[int] = None,
              partition_shards: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a ("c", "p") mesh over the available devices.

    Defaults: all devices on the partition axis (the reduce axis benefits
    most from scale: filter length per chip shrinks linearly).
    """
    devs = list(devices if devices is not None else jax.devices())
    n = len(devs)
    if channel_shards is None and partition_shards is None:
        channel_shards, partition_shards = 1, n
    elif channel_shards is None:
        channel_shards = n // partition_shards
    elif partition_shards is None:
        partition_shards = n // channel_shards
    if channel_shards * partition_shards != n:
        raise ValueError(
            f"mesh {channel_shards}x{partition_shards} != {n} devices")
    arr = np.array(devs).reshape(channel_shards, partition_shards)
    return Mesh(arr, ("c", "p"))


def state_shardings(mesh: Mesh):
    """NamedShardings for ConvolverState in rolled representation:
    ring [P, C, F] sharded (p, c, -), prev_block [C, N] sharded (c, -)."""
    return dict(
        spectra_ring=NamedSharding(mesh, P("p", "c", None)),
        prev_block=NamedSharding(mesh, P("c", None)),
        blockcounter=NamedSharding(mesh, P()),
    )


def coeff_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P("p", "c", None))


def block_sharding(mesh: Mesh) -> NamedSharding:
    """Input block [C, N]: sharded over channels, replicated over p."""
    return NamedSharding(mesh, P("c", None))
