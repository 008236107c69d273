"""Device-mesh helpers — the codec's communication layer.

The reference has no communication layer at all (SURVEY.md §5 "distributed
communication backend: none"); everything here is net-new design: XLA
collectives (NCCL on GPUs) selected by mesh axis.  The cards of one host are
joined all to all by NVLink, so every pair of devices is equally close and
the mesh follows the algorithm alone.  Axis convention (SURVEY.md §2.3):

  'data'  — block/stream data parallelism (P1)
  'model' — dictionary-atom sharding for very large K (P2)
  'seq'   — time-axis context parallelism for single huge blocks (P4)
"""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh


def make_mesh(axes: dict[str, int] | None = None, devices=None) -> Mesh:
    """Build a Mesh; default = all local devices on the 'data' axis.

    Axis order follows dict order.  Devices are placed in `jax.devices()`
    order: with all-to-all links no placement is faster than another.
    """
    devices = np.asarray(devices if devices is not None else jax.devices())
    if axes is None:
        axes = {"data": devices.size}
    shape = tuple(axes.values())
    if int(np.prod(shape)) != devices.size:
        raise ValueError(f"mesh {axes} needs {np.prod(shape)} devices, have {devices.size}")
    return Mesh(devices.reshape(shape), tuple(axes.keys()))


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Multi-host SPMD bring-up (SURVEY.md §2.3 P9).

    Wraps `jax.distributed.initialize`; on single-process runs it is a no-op
    so the same driver script works from one chip to a pod slice.
    """
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
