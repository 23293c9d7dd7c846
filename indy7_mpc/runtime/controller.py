"""Real-time sampled-MPC controller runtime (external-plant mode).

The host-side equivalent of the reference's ROS 2 node
(gato_controller.py:144-351) without the ROS dependency: a 100 Hz loop
over a Transport, per-tick sampled solve (device), watchdog, disturbance
random walk, and reference-schema stats recording.

Tick semantics mirror ``GATO_Controller.joint_callback``
(gato_controller.py:201-256):
  * the reference window advances by elapsed/dt per tick (:214-216);
  * all lanes warm-start from the previous best trajectory with the
    measured state pinned (:217-218, 249);
  * consensus lane selection + hypothesis resampling per tick (:225-226);
  * the true disturbance random-walks every 200 reference steps, clipped
    to +-20 N, and is published to the plant (:236-239);
  * watchdog exit after 10 s without a plant state (:297-303).
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import CostConfig, MPCConfig, SampleConfig, SQPConfig
from ..models.robot import RobotModel
from ..mpc.sampled import init_wrench_batch, sampled_tick
from .stats import RunRecorder

JOINT_STATE_TIMEOUT = 10.0  # gato_controller.py:16-17


class SampledController:
    """Host-side controller state machine around the jitted device tick."""

    def __init__(
        self,
        model: RobotModel,
        cost_cfg: CostConfig,
        sqp_cfg: SQPConfig,
        mpc_cfg: MPCConfig,
        sample_cfg: SampleConfig,
        ref_traj: np.ndarray,
        seed: int = 42,
        batch_solve_fn: Optional[Callable] = None,
        f_ext_actual=None,
        warmup: bool = True,
    ):
        self.model = model
        self.mpc_cfg = mpc_cfg
        self.sample_cfg = sample_cfg
        self.ref_traj = jnp.asarray(ref_traj, jnp.float32)
        self.key = jax.random.PRNGKey(seed)
        self.key, k0 = jax.random.split(self.key)

        N, dt = mpc_cfg.N, mpc_cfg.dt
        self.ref_offset = 0.0
        self.f_batch = init_wrench_batch(k0, sample_cfg, jnp.float32)
        self.f_ext_actual = np.zeros(3) if f_ext_actual is None else np.asarray(
            f_ext_actual, float
        )
        self.X_best = jnp.zeros((N, model.nx), jnp.float32)
        self.U_best = jnp.zeros((N - 1, model.nu), jnp.float32)
        self.x_last = None
        self.u_last = jnp.zeros(model.nu, jnp.float32)

        # The WHOLE control tick is one jitted program (one device
        # dispatch per tick): split the RNG, slice the goal window at a
        # traced offset, solve/score/resample.  Keeping the key split and
        # goal slice inside matters on real deployments where every
        # host->device call has dispatch latency (the reference pays one
        # pybind call per tick for the same reason, gato_controller.py:224).
        max_off = self.ref_traj.shape[0] - N

        def _tick_fn(key, off, x, x_last, u_last, X, U, f):
            from ..dynamics.kinematics import ee_pos

            k_next, k_tick = jax.random.split(key)
            goals = jax.lax.dynamic_slice_in_dim(
                self.ref_traj, jnp.minimum(off, max_off), N, 0
            )
            out = sampled_tick(
                model, cost_cfg, sqp_cfg, sample_cfg, dt,
                k_tick, x, x_last, u_last, goals, X, U, f,
                batch_solve_fn=batch_solve_fn,
            )
            # EE position + tracking error computed on device so the host
            # loop needs no extra FK dispatch or transfer per tick.
            eep = ee_pos(model, x[: model.nq])
            terr = jnp.linalg.norm(eep - goals[0])
            return out, goals[0], eep, terr, k_next

        self._tick = jax.jit(_tick_fn)
        if warmup:
            # Cold-start throwaway solve from zeros (the reference's
            # init-time warm-up, gato_controller.py:180-184): pays the jit
            # compile + device cache fill at construction so the first real
            # control tick is within ~2x steady state instead of a
            # watchdog-scale hiccup.  Uses a fixed dummy key and discards
            # every output — controller state is untouched, so resumed
            # runs stay bit-identical.
            z = jnp.zeros(model.nx, jnp.float32)
            out = self._tick(
                jax.random.PRNGKey(0), jnp.int32(0), z, z, self.u_last,
                self.X_best, self.U_best, self.f_batch,
            )
            jax.block_until_ready(out)

    def goal_window(self) -> jnp.ndarray:
        off = int(self.ref_offset)
        off = min(off, self.ref_traj.shape[0] - self.mpc_cfg.N)
        return jax.lax.dynamic_slice_in_dim(
            self.ref_traj, off, self.mpc_cfg.N, 0
        )

    def on_state(self, x_obs: np.ndarray, elapsed: float):
        """One control tick; returns (u, info dict).

        One device dispatch + one blocking device->host fetch of the
        small outputs (u, best lane, wrench estimate, current reference);
        the warm-start trajectory and hypothesis batch stay on device.
        """
        x = jnp.asarray(x_obs, jnp.float32)
        if self.x_last is None:
            self.x_last = x
        self.ref_offset += elapsed / self.mpc_cfg.dt

        t0 = time.perf_counter()
        out, ee_ref, eep, terr, self.key = self._tick(
            self.key, jnp.int32(int(self.ref_offset)), x,
            self.x_last, self.u_last,
            self.X_best, self.U_best, self.f_batch,
        )
        # The tick's ONLY synchronizing transfer: everything the host
        # needs, fetched in one transfer (each synchronizing fetch pays a
        # fixed host<->device latency, so one beats several).
        u, best_idx, f_est, ee_ref, eep, terr = jax.device_get(
            (out.u, out.best_idx, out.f_est, ee_ref, eep, terr)
        )
        solve_time_us = (time.perf_counter() - t0) * 1e6

        self.X_best = out.X_best
        self.U_best = out.U_best
        self.f_batch = out.f_batch
        self.x_last = x
        self.u_last = out.u
        info = {
            "best_idx": int(best_idx),
            "f_est": np.asarray(f_est),
            "solve_time_us": solve_time_us,
            "ee_ref": np.asarray(ee_ref),
            "ee_pos": np.asarray(eep),
            "tracking_error": float(terr),
        }
        return np.asarray(u), info

    def reset_warm_start(self) -> None:
        """Controller-side companion to a plant reset (transport
        ``send_reset``): drop the warm-start trajectory and last
        state/control so the next tick cold-starts from the fresh plant
        pose instead of chasing the pre-reset trajectory.  Hypotheses,
        RNG, and the reference offset are kept (the reference's 'R'
        reset likewise leaves the controller process running,
        sim_node.cpp:107-130)."""
        N = self.mpc_cfg.N
        self.X_best = jnp.zeros((N, self.model.nx), jnp.float32)
        self.U_best = jnp.zeros((N - 1, self.model.nu), jnp.float32)
        self.x_last = None
        self.u_last = jnp.zeros(self.model.nu, jnp.float32)

    def save_checkpoint(self, path: str) -> str:
        """Persist the controller's full warm-start/estimator state.

        The reference's only "resume" is in-memory warm starting
        (SURVEY.md section 5.4); here the same state — RNG key, reference
        window offset, wrench hypotheses, best trajectory, last
        state/control — round-trips through one .npz so a run can stop
        and resume bit-identically (tests/test_runtime.py).
        """
        np.savez(
            path,
            key=np.asarray(self.key),
            ref_offset=np.asarray(self.ref_offset),
            f_batch=np.asarray(self.f_batch),
            f_ext_actual=self.f_ext_actual,
            X_best=np.asarray(self.X_best),
            U_best=np.asarray(self.U_best),
            x_last=(
                np.asarray(self.x_last)
                if self.x_last is not None
                else np.full(self.model.nx, np.nan)
            ),
            u_last=np.asarray(self.u_last),
        )
        return path

    def load_checkpoint(self, path: str) -> None:
        """Restore state saved by :meth:`save_checkpoint`."""
        z = np.load(path)
        self.key = jnp.asarray(z["key"])
        self.ref_offset = float(z["ref_offset"])
        self.f_batch = jnp.asarray(z["f_batch"])
        self.f_ext_actual = np.asarray(z["f_ext_actual"])
        self.X_best = jnp.asarray(z["X_best"])
        self.U_best = jnp.asarray(z["U_best"])
        x_last = z["x_last"]
        self.x_last = None if np.any(np.isnan(x_last)) else jnp.asarray(x_last)
        self.u_last = jnp.asarray(z["u_last"])

    def maybe_walk_disturbance(self, rng: np.random.Generator):
        """Random-walk the true wrench every 200 ref steps
        (gato_controller.py:236-239); returns it when it changed."""
        if int(self.ref_offset) % 200 == 0:
            noise = rng.normal(0, 1.0, size=3)
            self.f_ext_actual = np.clip(self.f_ext_actual + noise, -20, 20)
            return self.f_ext_actual
        return None


def run_control_loop(
    controller: SampledController,
    transport,
    duration: float,
    rate_hz: float = 100.0,
    recorder: Optional[RunRecorder] = None,
    walk_disturbance: bool = True,
    seed: int = 42,
    realtime: bool = True,
    max_ticks: Optional[int] = None,
):
    """Closed loop against an external (or in-process) plant.

    Stops after ``duration`` seconds of wall clock or ``max_ticks`` control
    ticks, whichever comes first.  Returns the recorder (created if none
    was given).
    """
    recorder = recorder or RunRecorder()
    rng = np.random.default_rng(seed)
    period = 1.0 / rate_hz
    transport.send_wrench(controller.f_ext_actual)

    ticks = 0
    deadline = time.time() + duration
    last_state_time = time.time()
    last_tick = time.time()
    last_sim_time = None
    while time.time() < deadline and (max_ticks is None or ticks < max_ticks):
        state = transport.recv_state()
        now = time.time()
        if state is None:
            if now - last_state_time > JOINT_STATE_TIMEOUT:
                raise TimeoutError(
                    f"no plant state for {JOINT_STATE_TIMEOUT}s (watchdog)"
                )
            continue
        last_state_time = now
        # Advance the reference window by PLANT time when the plant
        # reports its own sim clock (native plant_node protocol v2):
        # exact under --realtime-scale and immune to transport jitter.
        # Wall-clock deltas otherwise (the reference's behavior,
        # gato_controller.py:208-211).
        if state.sim_time is not None:
            elapsed = (
                state.sim_time - last_sim_time
                if last_sim_time is not None else period
            )
            last_sim_time = state.sim_time
        else:
            elapsed = now - last_tick
        last_tick = now

        u, info = controller.on_state(state.x, elapsed if realtime else period)
        transport.send_command(u)

        if walk_disturbance:
            w = controller.maybe_walk_disturbance(rng)
            if w is not None:
                transport.send_wrench(w)

        # Tracking error against the plant-reported EE when the transport
        # provides one (external plants report their own FK, like the
        # reference's effort[0:3] side channel); the in-process plant
        # shares the controller's nominal kinematics, so the tick's
        # device-computed value is identical and costs no extra transfer.
        if state.ee_pos is not None:
            tracking_error = float(
                np.linalg.norm(state.ee_pos - info["ee_ref"])
            )
            ee_rec = state.ee_pos
        else:
            tracking_error = info["tracking_error"]
            ee_rec = info["ee_pos"]
        recorder.record(
            elapsed, tracking_error, ee_rec, info["ee_ref"],
            state.x, info["solve_time_us"],
            # Estimator-accuracy sidecars (RunRecorder.EXTRA_ARRAYS):
            # winning hypothesis vs the wrench actually applied.
            f_est=info["f_est"],
            f_true=np.concatenate(
                [controller.f_ext_actual, np.zeros(3)]
            ),
        )
        recorder.maybe_save()
        ticks += 1

        if realtime:
            sleep = period - (time.time() - now)
            if sleep > 0:
                time.sleep(sleep)
    return recorder
