from .sqp import SolverState, SQPResult, SQPStats, solve, batch_solve
from .select import (
    default_batch_solve_fn,
    default_single_solve_fn,
    is_gpu_device,
)

__all__ = [
    "SolverState",
    "SQPResult",
    "SQPStats",
    "solve",
    "batch_solve",
    "default_batch_solve_fn",
    "default_single_solve_fn",
    "is_gpu_device",
]
