"""UDP transport under genuine loss/reorder/delay, and the plant reset.

The reference rides DDS depth-1 QoS (latest-wins, lossy by contract —
gato_controller.py:163-167); this framework's UDP transport makes the
same promise.  These tests exercise it under real packet mangling via a
socket-level chaos proxy (drop + delay + reorder between the controller
and the native plant_node process), and the reset protocol message (the
reference sim's 'R' key, sim_node.cpp:44-46, 107-130, 288-291).
"""
import heapq
import os
import random
import socket
import subprocess
import threading
import time

import numpy as np
import pytest

PLANT_BIN = os.path.join(
    os.path.dirname(__file__), "..", "native", "plant", "plant_node"
)
INIT_Q = [1.5799, 0.0631, -1.1807, 1.0927, -0.6255, -0.0190]


class ChaosProxy:
    """UDP man-in-the-middle: forwards datagrams both ways with seeded
    drop probability and a random delay (which reorders packets whose
    delays cross).  Controller talks to ``proxy_plant_port``; the proxy
    relays to the real plant and back."""

    def __init__(self, plant_port, ctrl_port, proxy_plant_port,
                 proxy_ctrl_port, drop=0.3, max_delay=0.015, seed=7):
        self.rng = random.Random(seed)
        self.drop = drop
        self.max_delay = max_delay
        self.stats = {"fwd": 0, "dropped": 0}
        self._stop = threading.Event()
        self._heap = []
        self._lock = threading.Condition()
        # Controller-facing socket (pretends to be the plant).
        self.to_plant = (("127.0.0.1", plant_port))
        self.to_ctrl = (("127.0.0.1", ctrl_port))
        self.sock_ctrl_side = socket.socket(socket.AF_INET,
                                            socket.SOCK_DGRAM)
        self.sock_ctrl_side.bind(("127.0.0.1", proxy_plant_port))
        self.sock_ctrl_side.settimeout(0.05)
        # Plant-facing socket (pretends to be the controller).
        self.sock_plant_side = socket.socket(socket.AF_INET,
                                             socket.SOCK_DGRAM)
        self.sock_plant_side.bind(("127.0.0.1", proxy_ctrl_port))
        self.sock_plant_side.settimeout(0.05)
        self.threads = [
            threading.Thread(target=self._pump, daemon=True,
                             args=(self.sock_ctrl_side, self.to_plant)),
            threading.Thread(target=self._pump, daemon=True,
                             args=(self.sock_plant_side, self.to_ctrl)),
            threading.Thread(target=self._deliver, daemon=True),
        ]
        for t in self.threads:
            t.start()

    def _pump(self, sock, dst):
        send = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        while not self._stop.is_set():
            try:
                pkt, _ = sock.recvfrom(512)
            except socket.timeout:
                continue
            except OSError:
                break
            if self.rng.random() < self.drop:
                self.stats["dropped"] += 1
                continue
            due = time.monotonic() + self.rng.uniform(0, self.max_delay)
            with self._lock:
                heapq.heappush(
                    self._heap, (due, self.stats["fwd"], pkt, dst, send)
                )
                self.stats["fwd"] += 1
                self._lock.notify()

    def _deliver(self):
        while not self._stop.is_set():
            with self._lock:
                if not self._heap:
                    self._lock.wait(timeout=0.05)
                    continue
                due, _, pkt, dst, send = self._heap[0]
                now = time.monotonic()
                if due > now:
                    self._lock.wait(timeout=min(due - now, 0.05))
                    continue
                heapq.heappop(self._heap)
            try:
                send.sendto(pkt, dst)
            except OSError:
                break

    def close(self):
        self._stop.set()
        for t in self.threads:
            t.join(timeout=1.0)
        self.sock_ctrl_side.close()
        self.sock_plant_side.close()


def _recv_latest_state(tr, timeout=2.0):
    t0 = time.time()
    while time.time() - t0 < timeout:
        st = tr.recv_state()
        if st is not None:
            return st
    return None


def test_reset_roundtrip_native_plant(native_build):
    """kTagReset: drive the plant away from the initial pose, reset, and
    verify it returns there with zero velocity and HOLDS (command state
    cleared — 'R' semantics, sim_node.cpp:107-130, 288-291)."""
    from indy7_mpc.runtime import UdpTransport

    proc = subprocess.Popen(
        [PLANT_BIN, "0.002", "5", "--ports", "7481", "7480"],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
    )
    tr = UdpTransport(plant_addr=("127.0.0.1", 7481),
                      listen_addr=("127.0.0.1", 7480))
    try:
        assert _recv_latest_state(tr) is not None
        # Push joint 2 hard for 0.5 s of plant time.
        for _ in range(25):
            tr.send_command([0, 0, 50.0, 0, 0, 0])
            time.sleep(0.02)
        moved = _recv_latest_state(tr)
        assert moved is not None
        assert abs(moved.x[2] - INIT_Q[2]) > 1e-3  # actually moved

        tr.send_reset()
        time.sleep(0.1)
        # Drain anything pre-reset, then check the fresh state.
        st = _recv_latest_state(tr)
        assert st is not None
        np.testing.assert_allclose(st.x[:6], INIT_Q, atol=1e-9)
        np.testing.assert_allclose(st.x[6:], 0.0, atol=1e-9)
        # Holds without a fresh command (command_received cleared).
        time.sleep(0.3)
        st2 = _recv_latest_state(tr)
        np.testing.assert_allclose(st2.x[:6], INIT_Q, atol=1e-9)
        np.testing.assert_allclose(st2.x[6:], 0.0, atol=1e-9)
    finally:
        tr.close()
        proc.kill()
        proc.wait()


@pytest.mark.slow
def test_loop_survives_loss_reorder_delay(model32, native_build, tmp_path):
    """Closed loop through a 30%-drop, 0-15 ms-jitter proxy: latest-wins
    must keep the loop alive and controlled — stale states tolerated, no
    deadlock, recorded run finite."""
    import jax.numpy as jnp

    from indy7_mpc.config import (
        CostConfig, MPCConfig, SampleConfig, SQPConfig,
    )
    from indy7_mpc.dynamics import ee_pos
    from indy7_mpc.runtime import (
        RunRecorder, SampledController, UdpTransport, run_control_loop,
    )

    model = model32
    proc = subprocess.Popen(
        [PLANT_BIN, "0.002", "5", "--ports", "7483", "7484"],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
    )
    # plant listens :7483 and replies toward :7484 (the proxy's
    # plant-side socket); controller listens :7486 and sends toward
    # :7485 (the proxy's controller-side socket).
    proxy = ChaosProxy(
        plant_port=7483, ctrl_port=7486,
        proxy_plant_port=7485, proxy_ctrl_port=7484,
        drop=0.3, max_delay=0.015, seed=7,
    )
    try:
        q0 = np.asarray(INIT_Q)
        ee = np.asarray(ee_pos(model, jnp.asarray(q0, jnp.float32)))
        ref = np.tile(ee, (1000, 1)).astype(np.float32)
        ctl = SampledController(
            model, CostConfig(), SQPConfig(max_iters=1),
            MPCConfig(N=6, dt=0.01),
            SampleConfig(batch_size=4, f_ext_std=5.0,
                         f_ext_resample_std=0.5),
            ref, f_ext_actual=[3.0, 0.0, -5.0],
        )
        tr = UdpTransport(plant_addr=("127.0.0.1", 7485),
                          listen_addr=("127.0.0.1", 7486))
        rec = RunRecorder(out_dir=str(tmp_path), save_interval=1e9)
        rec = run_control_loop(
            ctl, tr, duration=600, rate_hz=50, recorder=rec,
            walk_disturbance=True, max_ticks=60,
        )
        tr.close()
        te = np.asarray(rec._data["tracking_errors"])
        # States flowed despite 30% loss; the loop stayed finite and
        # station-keeping degraded gracefully (bounded error).
        assert len(te) >= 20, len(te)
        assert np.all(np.isfinite(te))
        assert te[-10:].mean() < 0.8, te[-10:]
        assert proxy.stats["dropped"] > 10  # chaos actually happened
    finally:
        proxy.close()
        proc.kill()
        proc.wait()


def test_watchdog_fires_on_blackout(model32):
    """Total blackout (nothing bound on the state port): the controller
    watchdog must raise within ~JOINT_STATE_TIMEOUT, not deadlock."""
    from indy7_mpc.runtime import UdpTransport, run_control_loop
    from indy7_mpc.runtime import controller as ctl_mod

    class _NoPlant(UdpTransport):
        pass

    tr = UdpTransport(plant_addr=("127.0.0.1", 7497),
                      listen_addr=("127.0.0.1", 7498),
                      recv_timeout=0.05)
    old = ctl_mod.JOINT_STATE_TIMEOUT
    ctl_mod.JOINT_STATE_TIMEOUT = 1.0
    try:
        class _Ctl:
            f_ext_actual = np.zeros(3)

            def on_state(self, x, elapsed):  # pragma: no cover
                raise AssertionError("no state should ever arrive")

        with pytest.raises(TimeoutError):
            run_control_loop(
                _Ctl(), tr, duration=30, rate_hz=100,
                walk_disturbance=False,
            )
    finally:
        ctl_mod.JOINT_STATE_TIMEOUT = old
        tr.close()
