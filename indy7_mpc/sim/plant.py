"""Device-resident plant: the JAX replacement for the MuJoCo sim node.

The reference runs a separate C++ MuJoCo process wired over ROS 2 DDS
(/root/reference/src/sim/sim/sim_node.cpp:284-347) and, offline, a
Pinocchio RK4 stepper (src/gato_mpc_batch_sample.py:166-189).  Here the
plant is a jitted, vmappable rollout co-resident with the solver, so the
controller<->plant transport disappears entirely (SURVEY.md section 5.8).

External world-frame forces at the EE replicate ``mj_applyFT``/
``oMi[6].actInv`` behavior: the wrench is expressed about the world origin
and re-mapped to the EE joint frame at the state where the step begins
(gato_mpc_batch_sample.py:151-161).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import PlantConfig
from ..dynamics.integrators import rk4_step
from ..dynamics.rnea import world_wrench_to_ee_joint
from ..models.robot import RobotModel

_U64 = (1 << 64) - 1


def _splitmix64(z: int) -> int:
    """splitmix64 output mix for state ``z`` (bit-identical to the C++
    implementation in native/plant/rbd.cpp perturb_model; the caller
    advances the state by the golden constant per draw)."""
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _U64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _U64
    return (z ^ (z >> 31)) & _U64


def perturbation_scales(seed: int, n: int) -> np.ndarray:
    """``n`` deterministic uniform draws in [-1, 1] from splitmix64.

    Shared PRNG with the native plant so a (seed, pct) pair names the
    same perturbed robot in both engines.
    """
    out = np.empty(n)
    state = seed & _U64
    for i in range(n):
        state = (state + 0x9E3779B97F4A7C15) & _U64
        u = _splitmix64(state) >> 11  # 53 bits
        out[i] = 2.0 * (u * (2.0 ** -53)) - 1.0
    return out


def perturb_model(model: RobotModel, cfg: PlantConfig) -> RobotModel:
    """Seeded inertial-parameter error: per-link mass and inertia scaled
    by independent factors in [1-pct, 1+pct].

    This is the plant-model mismatch the reference gets for free by
    simulating in a different engine (MuJoCo MJCF inertials vs Pinocchio
    URDF, sim_node.cpp:184-201); here it is explicit and seeded.
    """
    if cfg.param_scale_pct == 0.0:
        return model
    nj = model.nj
    draws = perturbation_scales(cfg.seed, 2 * nj)
    mass_s = 1.0 + cfg.param_scale_pct * draws[:nj]
    inertia_s = 1.0 + cfg.param_scale_pct * draws[nj:]
    return dataclasses.replace(
        model,
        mass=model.mass * jnp.asarray(mass_s, model.mass.dtype),
        I_com=model.I_com
        * jnp.asarray(inertia_s, model.I_com.dtype)[:, None, None],
    )


def apply_joint_limits(model: RobotModel, x, velocity_saturation=False):
    """Hard joint stops (and optional servo velocity saturation), applied
    after every plant integrator substep.

    The reference's ground-truth plant is MuJoCo, which enforces the MJCF
    joint ``range`` as constraints inside ``mj_step``
    (/root/reference/description/indy7.xml:18-38, sim_node.cpp:293-299)
    but does NOT enforce the URDF's per-joint velocity limits — its
    recorded runs exceed them freely (stats/single joint4 peaks
    ~25 rad/s).  Default semantics therefore match MuJoCo: position range
    only.  Semantics, bit-identical to the C++ plant
    (native/plant/rbd.cpp apply_joint_limits):

      1. with ``velocity_saturation`` (opt-in; a servo-side actuator
         model using the URDF ``<limit velocity=...>`` values):
         ``v <- clip(v, -velocity_limit, +velocity_limit)``;
      2. ``q <- clip(q, q_lower, q_upper)``; where the clamp engages, the
         outward velocity component is zeroed — a perfectly inelastic
         joint stop (the same outcome class as MuJoCo's constraint
         impulses, without the solver).

    Broadcasts over leading batch dims.
    """
    nq = model.nq
    q, v = x[..., :nq], x[..., nq:]
    if velocity_saturation:
        v = jnp.clip(v, -model.velocity_limit, model.velocity_limit)
    v = jnp.where(q > model.q_upper, jnp.minimum(v, 0.0), v)
    v = jnp.where(q < model.q_lower, jnp.maximum(v, 0.0), v)
    q = jnp.clip(q, model.q_lower, model.q_upper)
    return jnp.concatenate([q, v], axis=-1)


def plant_step(
    model: RobotModel,
    x,
    u,
    dt: float,
    wrench_world: Optional[jnp.ndarray] = None,
    substeps: int = 1,
    clamp_torque: bool = True,
    friction=None,
    torque_noise_std: float = 0.0,
    key=None,
    enforce_limits: bool = True,
    velocity_saturation: bool = False,
):
    """Advance the plant by ``dt`` under constant torque ``u``.

    RK4 with ``substeps`` sub-intervals; the external wrench is re-mapped
    to the EE joint frame at the start of each substep (the reference maps
    once per control interval; substeps=1 reproduces that exactly).
    Torques are clamped to the actuator effort limits, matching the MuJoCo
    plant's ``ctrlrange`` (description/indy7.xml:52-59); with
    ``enforce_limits`` (the default — this is the ground-truth plant) the
    joint position/velocity limits are applied after every substep
    (:func:`apply_joint_limits`, the mj_step joint-``range`` analog).
    Broadcasts over leading batch dims.

    Model-mismatch knobs (config.PlantConfig):
      * ``friction=(kv, kc)`` — unmodeled joint friction inside every
        integrator stage;
      * ``torque_noise_std`` with ``key`` — zero-mean gaussian actuation
        noise re-drawn per substep (the MJCF actuator-noise analog,
        indy7.xml:62-75).
    """
    # Ground-truth physics must not run at reduced matmul precision (on a
    # GPU the default lets float32 products run in TF32, ~3 decimal
    # digits): the small 3x3/6x6 chains in RNEA/FK amplify that noise into
    # large velocity errors through RK4, and exact-f32 multiplies cost
    # nothing at these shapes.  Trace-time context, so this pins
    # every matmul traced below without touching global config.
    with jax.default_matmul_precision("highest"):
        return _plant_step_impl(
            model, x, u, dt, wrench_world, substeps, clamp_torque,
            friction, torque_noise_std, key, enforce_limits,
            velocity_saturation,
        )


def _plant_step_impl(
    model, x, u, dt, wrench_world, substeps, clamp_torque, friction,
    torque_noise_std, key, enforce_limits, velocity_saturation,
):
    if clamp_torque:
        u = jnp.clip(u, -model.effort_limit, model.effort_limit)
    h = dt / substeps
    noisy = torque_noise_std > 0.0 and key is not None

    def sub(carry, _):
        x, k = carry
        us = u
        if noisy:
            k, ks = jax.random.split(k)
            us = u + torque_noise_std * jax.random.normal(
                ks, u.shape, x.dtype
            )
        f_l = None
        if wrench_world is not None:
            f_l = world_wrench_to_ee_joint(
                model, x[..., : model.nq], wrench_world
            )
        x_next = rk4_step(model, x, us, h, f_ext_ee=f_l, friction=friction)
        if enforce_limits:
            x_next = apply_joint_limits(
                model, x_next, velocity_saturation=velocity_saturation
            )
        return (x_next, k), None

    k0 = key if key is not None else jax.random.PRNGKey(0)
    if substeps == 1:
        return sub((x, k0), None)[0][0]
    return jax.lax.scan(sub, (x, k0), None, length=substeps)[0][0]


def make_plant_step(model: RobotModel, cfg: Optional[PlantConfig]):
    """(plant_model, step_fn) for a PlantConfig.

    ``step_fn(x, u, wrench_world, key)`` advances one control tick under
    the perturbed model with friction/actuation noise; with ``cfg=None``
    it is the nominal single-RK4 plant.
    """
    if cfg is None:
        cfg = PlantConfig()
    pm = perturb_model(model, cfg)
    friction = None
    if cfg.viscous_friction or cfg.coulomb_friction:
        friction = (cfg.viscous_friction, cfg.coulomb_friction)

    def step_fn(x, u, wrench_world, key, dt):
        return plant_step(
            pm, x, u, dt,
            wrench_world=wrench_world,
            substeps=cfg.substeps,
            friction=friction,
            torque_noise_std=cfg.torque_noise_std,
            key=key,
            velocity_saturation=cfg.velocity_saturation,
        )

    return pm, step_fn


def predict_next_states(model: RobotModel, x, u, dt: float, wrench_batch):
    """Batched one-step prediction under each wrench hypothesis.

    The analog of the CUDA solver's ``sim_forward`` used for consensus
    scoring (gato_controller.py:105-118): same (x, u) in every lane, one
    wrench per lane.  Unlike the reference's ``sim_forward`` (which is
    blind to MuJoCo's joint-range constraints), the predictor here shares
    the plant's joint-stop physics: without it, the prediction error a
    clamp causes gets misattributed to the wrench hypotheses and the
    estimator locks onto wrenches that push the arm INTO the stop
    (measured: B>=16 fig-8 runs rode joints 0/3/4 at their stops for
    ~1000 ticks with 3-5x tracking degradation).  Returns (B, nx).
    """

    def one(w):
        return plant_step(model, x, u, dt, wrench_world=w)

    with jax.default_matmul_precision("highest"):
        return jax.vmap(one)(wrench_batch)
