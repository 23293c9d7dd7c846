"""Runtime end-to-end tests: controller loop against real transports.

The process-parallel test drives the actual native C++ plant_node over
UDP — the framework's equivalent of the reference's controller<->MuJoCo
DDS loop (README.md:17, tools/sim.sh) — with the watchdog, disturbance
publishing, and stats recording active.
"""
import os
import subprocess
import time

import jax.numpy as jnp
import numpy as np
import pytest

from indy7_mpc.config import CostConfig, MPCConfig, SampleConfig, SQPConfig
from indy7_mpc.models import indy7
from indy7_mpc.mpc import reference
from indy7_mpc.runtime import (
    InProcessPlant,
    RunRecorder,
    SampledController,
    UdpTransport,
    run_control_loop,
)

PLANT_BIN = os.path.join(
    os.path.dirname(__file__), "..", "native", "plant", "plant_node"
)

# Small problem so the CPU jit compiles quickly.
COST = CostConfig()
SQP = SQPConfig(max_iters=1)
MPC = MPCConfig(N=6, dt=0.01)
SAMPLE = SampleConfig(batch_size=4, f_ext_std=5.0, f_ext_resample_std=0.5)


def _controller(model, ref):
    return SampledController(
        model, COST, SQP, MPC, SAMPLE, ref, f_ext_actual=[3.0, 0.0, -5.0]
    )


def _hold_ref(model, q0, ticks):
    from indy7_mpc.dynamics import ee_pos

    ee = np.asarray(ee_pos(model, jnp.asarray(q0, jnp.float32)))
    return np.tile(ee, (ticks, 1)).astype(np.float32)


def test_in_process_loop(model32, tmp_path):
    model = model32
    x0 = np.zeros(12)
    ref = _hold_ref(model, x0[:6], 400)
    plant = InProcessPlant(model, x0, MPC.dt)
    ctl = _controller(model, ref)
    rec = RunRecorder(out_dir=str(tmp_path), save_interval=1e9)
    rec = run_control_loop(
        ctl, plant, duration=600, rate_hz=100, recorder=rec,
        walk_disturbance=True, realtime=False, max_ticks=25,
    )
    s = rec.summary()
    assert s["tracking_error_mean"] < 0.5
    stem = rec.save()
    assert os.path.exists(f"{stem}_tracking_errors.npy")
    # Reference-schema arrays all present and aligned.
    lens = {
        name: len(np.load(f"{stem}_{name}.npy"))
        for name in RunRecorder.ARRAYS
    }
    assert len(set(lens.values())) == 1 and min(lens.values()) > 5


def test_udp_loop_against_native_plant(model32, tmp_path, native_build):
    model = model32
    proc = subprocess.Popen(
        [PLANT_BIN, "0.002", "5"],  # 500 Hz physics, 100 Hz state
        stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL,
    )
    try:
        time.sleep(0.3)
        transport = UdpTransport()
        # Native plant starts at the reference's fixed pose
        # (sim_node.cpp:196); hold station there.
        q0 = np.array([1.5799, 0.0631, -1.1807, 1.0927, -0.6255, -0.0190])
        ref = _hold_ref(model, q0, 1000)
        ctl = _controller(model, ref)
        rec = RunRecorder(out_dir=str(tmp_path), save_interval=1e9)
        rec = run_control_loop(
            ctl, transport, duration=600, rate_hz=50, recorder=rec,
            walk_disturbance=True, max_ticks=40,
        )
        transport.close()
        s = rec.summary()
        assert s.get("tracking_error_mean", 1e9) < 0.6, s
        te = np.asarray(rec._data["tracking_errors"])
        assert len(te) >= 10  # states actually flowed over UDP
        assert np.all(np.isfinite(te))
    finally:
        proc.kill()
        proc.wait()


def test_checkpoint_resume_bit_identical(model32, tmp_path):
    """Stop/resume via save_checkpoint must reproduce the uninterrupted
    run exactly: same controls, same states (deterministic resume)."""
    model = model32
    x0 = np.zeros(12)
    ref = _hold_ref(model, x0[:6], 400)

    def fresh():
        return InProcessPlant(model, x0, MPC.dt), _controller(model, ref)

    # Uninterrupted: 8 ticks.
    plant_a, ctl_a = fresh()
    ua = []
    for _ in range(8):
        st = plant_a.recv_state()
        u, _ = ctl_a.on_state(st.x, MPC.dt)
        plant_a.send_command(u)
        ua.append(u.copy())

    # Interrupted: 4 ticks, checkpoint, fresh controller, restore, 4 more.
    plant_b, ctl_b = fresh()
    ub = []
    for _ in range(4):
        st = plant_b.recv_state()
        u, _ = ctl_b.on_state(st.x, MPC.dt)
        plant_b.send_command(u)
        ub.append(u.copy())
    ckpt = ctl_b.save_checkpoint(str(tmp_path / "ctl.npz"))

    ctl_c = _controller(model, ref)
    ctl_c.load_checkpoint(ckpt)
    for _ in range(4):
        st = plant_b.recv_state()
        u, _ = ctl_c.on_state(st.x, MPC.dt)
        plant_b.send_command(u)
        ub.append(u.copy())

    np.testing.assert_array_equal(np.asarray(ua), np.asarray(ub))
