"""indy7_mpc: batched SQP-MPC framework for the Indy7 arm (JAX, GPU).

A from-scratch JAX/XLA re-design of the capabilities of
A2R-Lab/indy7-mpc: batched rigid-body dynamics, block-tridiagonal KKT
(Riccati) QP solves, SQP trajectory optimization, sampled
wrench-hypothesis MPC, and lane-axis sharding across device meshes.
"""

__version__ = "0.1.0"
