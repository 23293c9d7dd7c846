// Rigid-body dynamics for a 6-DOF serial revolute chain (fixed base).
//
// Native ground-truth plant physics for the framework's external-plant
// mode — the first-class equivalent of the reference's MuJoCo C++ sim
// node (/root/reference/src/sim/sim/sim_node.cpp).  Same algorithms as
// the JAX layer (indy7_mpc/dynamics, ops/lane_rbd.py): local-frame
// RNEA, CRBA, LDL^T solve, RK4 with the reference's averaged-velocity
// position update (src/utils.py:3-18), and the world-wrench-about-origin
// EE force semantics (src/gato_mpc_batch_sample.py:151-161).
//
// Conventions: linear-first spatial vectors (v, w) / (f, n); placements
// X = (R, p) map local to parent coordinates.
#pragma once

#include <array>
#include <cmath>

namespace indy7 {

constexpr int NJ = 6;

using Vec3 = std::array<double, 3>;
using Mat3 = std::array<std::array<double, 3>, 3>;
using VecJ = std::array<double, NJ>;
using MatJ = std::array<std::array<double, NJ>, NJ>;
using Vec6 = std::array<double, 6>;
using State = std::array<double, 2 * NJ>;

struct Model {
  Mat3 tree_R[NJ];   // parent->joint placement rotation at q = 0
  Vec3 tree_p[NJ];   // parent->joint placement translation
  Vec3 axis[NJ];     // joint axis in the joint frame
  double mass[NJ];
  Vec3 com[NJ];      // link COM in the joint frame
  Mat3 I_com[NJ];    // rotational inertia about the COM
  Vec3 gravity;      // world-frame linear gravity
  Vec3 tcp_offset;   // fixed tool offset from the last joint frame
  VecJ q_lower;      // joint position limits (URDF <limit lower/upper>,
  VecJ q_upper;      //   the MJCF joint range MuJoCo enforces in mj_step)
  VecJ velocity_limit;  // URDF <limit velocity>
};

// World placements of every joint frame (R includes the joint rotation).
void forward_kinematics(const Model& m, const VecJ& q, Mat3 R_w[NJ],
                        Vec3 p_w[NJ]);

// Position of the last joint frame origin (the reference's eepos,
// osqp_solver.py:146-148).
Vec3 ee_position(const Model& m, const VecJ& q);

// Map a world wrench (force f, moment n about the WORLD ORIGIN) to the
// last joint's local spatial force — oMi[6].actInv semantics.
Vec6 world_wrench_to_ee(const Model& m, const VecJ& q, const Vec6& w_world);

// Inverse dynamics: tau for acceleration a under optional local EE force.
VecJ rnea(const Model& m, const VecJ& q, const VecJ& v, const VecJ& a,
          const Vec6* f_ext_ee, bool gravity);

// Joint-space mass matrix (composite rigid body algorithm).
MatJ crba(const Model& m, const VecJ& q);

// Forward dynamics a = M^-1 (tau - bias) via LDL^T.
VecJ forward_dynamics(const Model& m, const VecJ& q, const VecJ& v,
                      const VecJ& tau, const Vec6* f_ext_ee);

// Unmodeled joint friction applied inside every integrator stage:
// tau_f = -kv v - kc tanh(v / 0.01).  Matches the JAX plant's
// dynamics/integrators.py _friction_torque (model-mismatch validation).
struct Friction {
  double kv = 0.0;  // viscous (N m s / rad)
  double kc = 0.0;  // Coulomb (N m), tanh-smoothed
};

// RK4 step matching src/utils.py:3-18 (wrench mapped at the start state).
State rk4_step(const Model& m, const State& x, const VecJ& u, double dt,
               const Vec6* wrench_world, const Friction* friction = nullptr);

// Hard joint stops (and optional servo velocity saturation), applied
// after every plant integrator substep.  Bit-identical semantics to the
// JAX plant's sim/plant.py apply_joint_limits (the mj_step joint-range
// analog; MuJoCo does NOT enforce velocity limits, so saturation is an
// opt-in actuator model):
//   1. if saturate_velocity: v = clip(v, -velocity_limit, velocity_limit);
//   2. q = clip(q, q_lower, q_upper), zeroing the outward velocity
//      component where the clamp engages (perfectly inelastic stop).
void apply_joint_limits(const Model& m, State& x,
                        bool saturate_velocity = false);

// Seeded inertial-parameter error: per-link mass and inertia scaled by
// independent uniform factors in [1-pct, 1+pct].  splitmix64-based and
// bit-identical to indy7_mpc/sim/plant.py perturbation_scales, so a
// (seed, pct) pair names the same perturbed robot in both engines.
void perturb_model(Model& m, double pct, unsigned long long seed);

// The Indy7 model (embedded parameters, description/indy7.urdf).
Model indy7_model();

}  // namespace indy7
