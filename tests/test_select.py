"""Production-solver selection (solvers/select.py).

On a GPU the lane-major solver serves every config it covers; a config
outside its coverage falls back to the readable vmap solver, and that
must never happen silently.  On the CPU the vmap solver is the path.
"""
import logging

import numpy as np
import pytest

from indy7_mpc.config import CostConfig, SQPConfig
from indy7_mpc.solvers import select, sqp, sqp_lane


class _FakeGpu:
    platform = "gpu"
    device_kind = "NVIDIA H100 80GB HBM3"


class _FakeCpu:
    platform = "cpu"
    device_kind = "cpu"


_LOGGER = "indy7_mpc.solvers.select"


def test_lane_supports_predicate():
    assert select.lane_supports(CostConfig(), SQPConfig())
    assert not select.lane_supports(
        CostConfig(formulation="reference"), SQPConfig()
    )
    assert not select.lane_supports(
        CostConfig(), SQPConfig(qp_backend="pcg")
    )


@pytest.mark.parametrize("device,module", [(_FakeGpu(), sqp_lane),
                                           (_FakeCpu(), sqp)])
def test_solver_chosen_by_device(device, module, model32, monkeypatch):
    calls = []
    monkeypatch.setattr(module, "batch_solve",
                        lambda *a, **k: calls.append(a))
    fn = select.default_batch_solve_fn(
        model32, CostConfig(), SQPConfig(), 0.01, device=device
    )
    fn("xs", "g", "X", "U", "w")
    assert len(calls) == 1 and calls[0][4:] == ("xs", "g", "X", "U")
    assert select.is_gpu_device(device) is (module is sqp_lane)


def test_gpu_slow_path_fallback_warns(model32, caplog):
    """A GPU device landing on the vmap solver must emit a warning."""
    with caplog.at_level(logging.WARNING, logger=_LOGGER):
        select.default_batch_solve_fn(
            model32, CostConfig(), SQPConfig(qp_backend="pcg"), 0.01,
            device=_FakeGpu(),
        )
    assert any("readable vmap solver" in r.message for r in caplog.records)

    caplog.clear()
    with caplog.at_level(logging.WARNING, logger=_LOGGER):
        select.default_single_solve_fn(
            model32, CostConfig(formulation="reference"), SQPConfig(), 0.01,
            device=_FakeGpu(),
        )
    assert any("readable vmap solver" in r.message for r in caplog.records)


def test_cpu_fallback_is_silent(model32, caplog):
    """The vmap solver IS the production path on the CPU: no warning."""
    with caplog.at_level(logging.WARNING, logger=_LOGGER):
        select.default_batch_solve_fn(
            model32, CostConfig(), SQPConfig(qp_backend="pcg"), 0.01,
            device=_FakeCpu(),
        )
        select.default_batch_solve_fn(
            model32, CostConfig(), SQPConfig(), 0.01, device=_FakeCpu(),
        )
    assert not caplog.records


def test_gpu_single_solve_is_a_batch_of_one(model32, monkeypatch):
    """On a GPU the single-lane solve runs the lane solver on B=1 and
    unbatches every result leaf."""
    import jax.numpy as jnp

    seen = []

    def fake_batch(model, cost_cfg, sqp_cfg, dt, xs, g, X, U, state=None):
        seen.append((xs.shape, None if state is None else state.rho.shape))
        return sqp.SQPResult(
            X=X, U=U, state=sqp.SolverState(rho=jnp.ones(1)),
            stats=sqp.SQPStats(iterations=jnp.ones(1, jnp.int32),
                               step_sizes=jnp.ones((1, 2)),
                               alphas=jnp.ones((1, 2))),
        )

    monkeypatch.setattr(sqp_lane, "batch_solve", fake_batch)
    fn = select.default_single_solve_fn(
        model32, CostConfig(), SQPConfig(), 0.01, device=_FakeGpu()
    )
    res = fn(jnp.zeros(12), jnp.zeros((4, 3)), jnp.zeros((4, 12)),
             jnp.zeros((3, 6)), state=sqp.SolverState(rho=jnp.asarray(2.0)))
    assert seen == [((1, 12), (1,))]
    assert res.X.shape == (4, 12) and res.state.rho.shape == ()
    assert res.stats.alphas.shape == (2,)


def test_sharded_auto_backend_warns_on_unsupported_config(
    model32, caplog, monkeypatch
):
    """A GPU mesh shard_maps the lane solver for a covered config and
    falls back to vmap WITH the warning for an uncovered one; the CPU
    mesh partitions the vmap solver (parallel/sharding.py _mesh_solve)."""
    from unittest import mock

    from indy7_mpc.parallel import sharding

    gpu_mesh = mock.Mock()
    gpu_mesh.devices = np.asarray([_FakeGpu()])
    shard_mapped = []
    monkeypatch.setattr(sharding.jax, "shard_map",
                        lambda f, **kw: shard_mapped.append(kw) or f)
    sharding._mesh_solve(model32, CostConfig(), SQPConfig(), 0.01, gpu_mesh)
    assert len(shard_mapped) == 1
    with caplog.at_level(logging.WARNING, logger=_LOGGER):
        sharding._mesh_solve(model32, CostConfig(),
                             SQPConfig(qp_backend="admm"), 0.01, gpu_mesh)
    assert len(shard_mapped) == 1
    assert any("readable vmap solver" in r.message for r in caplog.records)
    cpu_mesh = mock.Mock()
    cpu_mesh.devices = np.asarray([_FakeCpu()])
    sharding._mesh_solve(model32, CostConfig(), SQPConfig(), 0.01, cpu_mesh)
    assert len(shard_mapped) == 1
