"""Multi-process (multi-host) scale-out for the lane/hypothesis axis.

The reference is single-GPU, single-host (SURVEY.md section 2.3); its only
inter-process fabric is ROS DDS between controller and sim.  Scaling the
sampled-MPC ensemble past one device is a first-class goal
(BASELINE.json: "multi-host 32k-scenario MPC sweep ... with cross-host
cost reduction"): the lane axis shards over every device of every host, the
SQP solves stay embarrassingly parallel, and the consensus
``argmin_i |x_pred_i - x_obs|`` (gato_controller.py:109-118) becomes one
global reduction that XLA lowers onto ICI within a host and DCN across
hosts.

Usage (one controller process per host, standard JAX multi-controller):

    from indy7_mpc.parallel import distributed as dist
    dist.initialize(coordinator, num_processes, process_id)
    mesh = dist.global_lane_mesh()
    f_global = dist.global_lanes(mesh, f_batch_full)   # (B, 6) -> sharded
    tick = make_sharded_sampled_tick(..., mesh)        # same code path
    out = tick(...)                                    # global consensus

Every process traces the same program; arrays with a lane axis are global
``jax.Array``s assembled from process-local shards.  On CPU test rigs the
same code runs under gloo collectives (tests/test_multihost.py).
"""
from __future__ import annotations

import os
from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .sharding import LANE_AXIS


def initialize(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    cpu_devices_per_process: Optional[int] = None,
) -> None:
    """Join the JAX distributed runtime (idempotent per process).

    ``cpu_devices_per_process``: when set, forces that many virtual CPU
    devices and the gloo CPU collective backend — the hardware-free rig
    for exercising the real cross-host code path.  On accelerator hosts
    leave it None; the runtime discovers its local devices.
    """
    if cpu_devices_per_process is not None:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={cpu_devices_per_process}"
        )
        os.environ["JAX_PLATFORMS"] = "cpu"
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
        # NOTE: the CPU-rig worker entry points (examples/
        # multihost_bench.py, tests/test_multihost.py) additionally
        # enable jax_enable_x64 so the readable Riccati sweep runs its
        # f64 stabilization path at N=64/f32 (ops/riccati.py solve).
        # That flag is deliberately NOT flipped here: library init must
        # not change dtype-promotion semantics process-wide (ADVICE r4).
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def global_lane_mesh() -> Mesh:
    """1-D lane mesh over every device of every process."""
    return Mesh(np.asarray(jax.devices()).reshape(-1), (LANE_AXIS,))


def process_lane_slice(mesh: Mesh, B: int) -> slice:
    """This process's contiguous slice of the global lane axis.

    Lane sharding is contiguous block-cyclic with one block per device in
    mesh order; with devices enumerated process-major (the jax.devices()
    order), each process owns a contiguous [start, stop) of lanes.
    """
    n_dev = mesh.devices.size
    if B % n_dev:
        raise ValueError(f"B={B} must divide over {n_dev} devices")
    per_dev = B // n_dev
    local_ids = [
        i for i, d in enumerate(mesh.devices.flat)
        if d.process_index == jax.process_index()
    ]
    start, stop = min(local_ids), max(local_ids) + 1
    if local_ids != list(range(start, stop)):
        raise ValueError("non-contiguous local device block in mesh")
    return slice(start * per_dev, stop * per_dev)


def global_lanes(mesh: Mesh, full_batch: np.ndarray) -> jax.Array:
    """Assemble a lane-sharded global array from the FULL batch.

    Every process passes the same full (B, ...) host array (cheap — lane
    state is kilobytes); each contributes only its local slice.  Keeping
    the full batch host-side everywhere makes resampling/bookkeeping
    process-symmetric.
    """
    sh = NamedSharding(mesh, P(LANE_AXIS))
    full_batch = np.asarray(full_batch)
    local = full_batch[process_lane_slice(mesh, full_batch.shape[0])]
    return jax.make_array_from_process_local_data(sh, local, full_batch.shape)


def replicated_global(mesh: Mesh, value) -> jax.Array:
    """Replicate a host value across every device of every process."""
    sh = NamedSharding(mesh, P())
    value = np.asarray(value)
    return jax.make_array_from_process_local_data(sh, value, value.shape)


def fetch_replicated(arr: jax.Array) -> np.ndarray:
    """Host copy of a replicated (or fully-addressable) global array."""
    shards = arr.addressable_shards
    return np.asarray(shards[0].data)
