"""Robot model pytree: a fixed-topology serial kinematic chain.

The model is the JAX replacement for the reference's Pinocchio
``pin.Model`` (built from description/indy7.urdf via
/root/reference/src/utils.py:20-21).  All numeric fields are JAX arrays so
the model threads through ``jit``/``vmap``/``pjit`` as a pytree; topology
(number of joints) is static.

The Indy7 parameters below are physical robot data transcribed from the
reference URDF (/root/reference/description/indy7.urdf:50-245): link masses,
COMs, rotational inertias, joint origins (xyz/rpy), joint axes, and
effort/position/velocity limits.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from . import spatial


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class RobotModel:
    """Serial-chain rigid-body model (fixed base, revolute joints).

    Shapes use ``nj`` = number of actuated joints (6 for Indy7).
    Link ``i`` is the child body of joint ``i``; its inertial parameters are
    expressed in joint ``i``'s frame.
    """

    # Placement of joint i's frame in its parent joint's frame at q = 0.
    tree_R: jax.Array  # (nj, 3, 3)
    tree_p: jax.Array  # (nj, 3)
    axis: jax.Array    # (nj, 3) joint rotation axis in the joint frame
    # Link inertial parameters in the joint frame.
    mass: jax.Array    # (nj,)
    com: jax.Array     # (nj, 3)
    I_com: jax.Array   # (nj, 3, 3) rotational inertia about the COM
    # Fixed end-effector (tool) offset from the last joint frame.
    tcp_offset: jax.Array  # (3,)
    gravity: jax.Array     # (3,) linear gravity in world frame
    # Limits (from the URDF <limit> tags).
    effort_limit: jax.Array  # (nj,)
    velocity_limit: jax.Array  # (nj,)
    q_lower: jax.Array  # (nj,)
    q_upper: jax.Array  # (nj,)

    @property
    def nj(self) -> int:
        return self.tree_p.shape[0]

    @property
    def nq(self) -> int:
        return self.nj

    @property
    def nv(self) -> int:
        return self.nj

    @property
    def nx(self) -> int:
        return 2 * self.nj

    @property
    def nu(self) -> int:
        return self.nj

    def astype(self, dtype) -> "RobotModel":
        return jax.tree.map(lambda x: x.astype(dtype), self)


def _make_model(params: dict, dtype=jnp.float32) -> RobotModel:
    nj = len(params["joints"])
    tree_R = np.zeros((nj, 3, 3))
    tree_p = np.zeros((nj, 3))
    axis = np.zeros((nj, 3))
    mass = np.zeros((nj,))
    com = np.zeros((nj, 3))
    I_com = np.zeros((nj, 3, 3))
    eff = np.zeros((nj,))
    vel = np.zeros((nj,))
    qlo = np.zeros((nj,))
    qhi = np.zeros((nj,))
    for i, j in enumerate(params["joints"]):
        r, p, y = j["rpy"]
        tree_R[i] = np.asarray(spatial.rpy_matrix(r, p, y))
        tree_p[i] = j["xyz"]
        axis[i] = j["axis"]
        mass[i] = j["mass"]
        com[i] = j["com"]
        ixx, ixy, ixz, iyy, iyz, izz = j["inertia"]
        I_com[i] = [[ixx, ixy, ixz], [ixy, iyy, iyz], [ixz, iyz, izz]]
        eff[i] = j["effort"]
        vel[i] = j["velocity"]
        qlo[i] = j["lower"]
        qhi[i] = j["upper"]
    arr = lambda x: jnp.asarray(x, dtype=dtype)
    return RobotModel(
        tree_R=arr(tree_R),
        tree_p=arr(tree_p),
        axis=arr(axis),
        mass=arr(mass),
        com=arr(com),
        I_com=arr(I_com),
        tcp_offset=arr(params["tcp_offset"]),
        gravity=arr(params.get("gravity", [0.0, 0.0, -9.81])),
        effort_limit=arr(eff),
        velocity_limit=arr(vel),
        q_lower=arr(qlo),
        q_upper=arr(qhi),
    )


_PI_2 = 1.570796327  # as written in the reference URDF
_LIM = 3.0543261909900767
_VEL_A = 2.6179938779914944
_VEL_B = 3.141592653589793

# Transcribed from /root/reference/description/indy7.urdf (joints 198-245,
# link inertials 64-188).  Link k's inertial is attached to joint k-1 here
# because the URDF's link0 is the fixed base (its inertia never moves).
INDY7_PARAMS = {
    "tcp_offset": [0.0, 0.0, 0.06],
    "gravity": [0.0, 0.0, -9.81],
    "joints": [
        dict(  # joint0: link0 -> link1
            xyz=[0.0, 0.0, 0.0775], rpy=[0.0, 0.0, 0.0], axis=[0.0, 0.0, 1.0],
            effort=431.97, lower=-_LIM, upper=_LIM, velocity=_VEL_A,
            mass=11.44444535,
            com=[-0.00023749, -0.04310313, 0.13245396],
            inertia=[0.35065005, 0.00011931, -0.00037553,
                     0.304798, -0.10984447, 0.06003147],
        ),
        dict(  # joint1: link1 -> link2
            xyz=[0.0, -0.109, 0.222], rpy=[_PI_2, _PI_2, 0.0],
            axis=[0.0, 0.0, 1.0],
            effort=431.97, lower=-_LIM, upper=_LIM, velocity=_VEL_A,
            mass=5.84766553,
            com=[-0.29616699, 2.254e-05, 0.04483069],
            inertia=[0.03599743, -4.693e-05, -0.05240346,
                     0.72293306, 1.76e-06, 0.70024119],
        ),
        dict(  # joint2: link2 -> link3
            xyz=[-0.45, 0.0, -0.0305], rpy=[0.0, 0.0, 0.0],
            axis=[0.0, 0.0, 1.0],
            effort=197.23, lower=-_LIM, upper=_LIM, velocity=_VEL_A,
            mass=2.68206064,
            com=[-0.16804016, 0.00021421, -0.07000383],
            inertia=[0.0161721, -0.00011817, 0.03341882,
                     0.11364055, -4.371e-05, 0.10022522],
        ),
        dict(  # joint3: link3 -> link4
            xyz=[-0.267, 0.0, -0.075], rpy=[-_PI_2, 0.0, _PI_2],
            axis=[0.0, 0.0, 1.0],
            effort=79.79, lower=-_LIM, upper=_LIM, velocity=_VEL_B,
            mass=2.12987371,
            com=[-0.00026847, -0.0709844, 0.07649128],
            inertia=[0.02798891, 3.893e-05, -4.768e-05,
                     0.01443076, -0.01266296, 0.01496211],
        ),
        dict(  # joint4: link4 -> link5
            xyz=[0.0, -0.114, 0.083], rpy=[_PI_2, _PI_2, 0.0],
            axis=[0.0, 0.0, 1.0],
            effort=79.79, lower=-_LIM, upper=_LIM, velocity=_VEL_B,
            mass=2.22412271,
            com=[-0.09796232, -0.00023114, 0.06445892],
            inertia=[0.01105297, 5.517e-05, -0.01481977,
                     0.03698291, -3.74e-05, 0.02754795],
        ),
        dict(  # joint5: link5 -> link6
            xyz=[-0.168, 0.0, 0.069], rpy=[-_PI_2, 0.0, _PI_2],
            axis=[0.0, 0.0, 1.0],
            effort=79.79, lower=-3.7524578917878086, upper=3.7524578917878086,
            velocity=_VEL_B,
            mass=0.38254932,
            com=[8.147e-05, -0.00046556, 0.03079097],
            inertia=[0.00078982, -3.4e-07, 8.3e-07,
                     0.00079764, -5.08e-06, 0.00058319],
        ),
    ],
}


def indy7(dtype=jnp.float32) -> RobotModel:
    """The Neuromeka Indy7 6-DOF manipulator (embedded parameters)."""
    return _make_model(INDY7_PARAMS, dtype=dtype)
