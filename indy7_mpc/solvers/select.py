"""Production-solver selection.

The reference picks its solver by compile-time template class
(gato_controller.py:53-63); here the choice is one device predicate: on a
GPU the lane-major solver (solvers/sqp_lane.py) is the production path —
on the H100 it measured 12.7 ms per B=64/N=64 solve against the vmap
solver's 33.0 ms, and compiled faster (PERF.md, PR 1); on the CPU (tests,
iterative QP backends, the "reference" cost formulation) the readable
vmap solver (solvers/sqp.py) serves.

Every consumer of a batched solve — ``mpc.sampled.sampled_tick``, the
runtime controller, the sharded tick, the benchmarks — resolves its
default here, so forgetting to inject the fast path cannot silently cost
the slow one.
"""
from __future__ import annotations

import logging

import jax

from ..config import CostConfig, SQPConfig
from ..models.robot import RobotModel

logger = logging.getLogger(__name__)


def is_gpu_device(device=None) -> bool:
    """True when ``device`` (default: the default device) is a GPU."""
    d = device if device is not None else jax.devices()[0]
    return d.platform == "gpu"


def lane_supports(cost_cfg: CostConfig, sqp_cfg: SQPConfig) -> bool:
    """The lane-major solver implements the GN formulation with the direct
    Riccati backend only; other configs use the vmap solver."""
    return cost_cfg.formulation == "gn" and sqp_cfg.qp_backend == "riccati"


def use_lane(cost_cfg: CostConfig, sqp_cfg: SQPConfig, device=None) -> bool:
    """Whether the lane-major solver serves this config on ``device``.  A
    GPU config outside its coverage falls back to the vmap solver — loudly,
    so nobody ships the slow path by accident."""
    if not is_gpu_device(device):
        return False
    if lane_supports(cost_cfg, sqp_cfg):
        return True
    logger.warning(
        "GPU device but config (formulation=%r, qp_backend=%r) is outside "
        "the lane-major solver's coverage (gn + riccati); falling back to "
        "the readable vmap solver.",
        cost_cfg.formulation, sqp_cfg.qp_backend,
    )
    return False


def default_batch_solve_fn(
    model: RobotModel,
    cost_cfg: CostConfig,
    sqp_cfg: SQPConfig,
    dt: float,
    device=None,
):
    """``(xs_b, goals_b, X_b, U_b, wrench_b) -> SQPResult`` on the
    production solver for the target device."""
    if use_lane(cost_cfg, sqp_cfg, device):
        from . import sqp_lane as mod
    else:
        from . import sqp as mod

    return lambda xs, g, X, U, w: mod.batch_solve(
        model, cost_cfg, sqp_cfg, dt, xs, g, X, U,
        wrench_world_batch=w,
    )


def default_single_solve_fn(
    model: RobotModel,
    cost_cfg: CostConfig,
    sqp_cfg: SQPConfig,
    dt: float,
    device=None,
):
    """Single-lane ``(xs, goals, X, U, state) -> SQPResult`` counterpart
    (for run_mpc / run_tracking_mpc); on a GPU it is a batch of one."""
    if use_lane(cost_cfg, sqp_cfg, device):
        from . import sqp_lane

        def fn(xs, goals, X, U, state=None):
            st = None if state is None else state._replace(
                rho=jax.numpy.reshape(state.rho, (1,))
            )
            res = sqp_lane.batch_solve(
                model, cost_cfg, sqp_cfg, dt,
                xs[None], goals[None], X[None], U[None], state=st,
            )
            return jax.tree.map(lambda a: a[0], res)

        return fn
    from . import sqp as sqp_mod

    return lambda xs, goals, X, U, state=None: sqp_mod.solve(
        model, cost_cfg, sqp_cfg, dt, xs, goals, X, U, state=state
    )
