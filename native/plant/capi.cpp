// C API for ctypes bindings (indy7_mpc/sim/native.py).
//
// pybind11 is not available on this image (see repo docs); the framework
// binds the native plant through a minimal extern-C surface instead.
#include "rbd.hpp"

extern "C" {

// All buffers are float64. x: [q(6), v(6)]; wrench: world (f, n) about the
// world origin (pass nullptr for none).

void indy7_ee_position(const double* q, double* ee_out) {
  static const indy7::Model m = indy7::indy7_model();
  indy7::VecJ qq;
  for (int i = 0; i < 6; ++i) qq[i] = q[i];
  const indy7::Vec3 p = indy7::ee_position(m, qq);
  for (int i = 0; i < 3; ++i) ee_out[i] = p[i];
}

void indy7_forward_dynamics(const double* x, const double* tau,
                            const double* wrench_or_null, double* a_out) {
  static const indy7::Model m = indy7::indy7_model();
  indy7::VecJ q, v, t;
  for (int i = 0; i < 6; ++i) {
    q[i] = x[i];
    v[i] = x[6 + i];
    t[i] = tau[i];
  }
  const indy7::Vec6* fp = nullptr;
  indy7::Vec6 fl{};
  if (wrench_or_null) {
    indy7::Vec6 w;
    for (int i = 0; i < 6; ++i) w[i] = wrench_or_null[i];
    fl = indy7::world_wrench_to_ee(m, q, w);
    fp = &fl;
  }
  const indy7::VecJ a = indy7::forward_dynamics(m, q, v, t, fp);
  for (int i = 0; i < 6; ++i) a_out[i] = a[i];
}

void indy7_rnea(const double* q, const double* v, const double* a,
                int gravity, double* tau_out) {
  static const indy7::Model m = indy7::indy7_model();
  indy7::VecJ qq, vv, aa;
  for (int i = 0; i < 6; ++i) {
    qq[i] = q[i];
    vv[i] = v[i];
    aa[i] = a[i];
  }
  const indy7::VecJ tau =
      indy7::rnea(m, qq, vv, aa, nullptr, gravity != 0);
  for (int i = 0; i < 6; ++i) tau_out[i] = tau[i];
}

void indy7_rk4_step(const double* x, const double* u, double dt,
                    const double* wrench_or_null, double* x_out) {
  static const indy7::Model m = indy7::indy7_model();
  indy7::State xx;
  indy7::VecJ uu;
  for (int i = 0; i < 12; ++i) xx[i] = x[i];
  for (int i = 0; i < 6; ++i) uu[i] = u[i];
  const indy7::Vec6* fp = nullptr;
  indy7::Vec6 w{};
  if (wrench_or_null) {
    for (int i = 0; i < 6; ++i) w[i] = wrench_or_null[i];
    fp = &w;
  }
  const indy7::State out = indy7::rk4_step(m, xx, uu, dt, fp);
  for (int i = 0; i < 12; ++i) x_out[i] = out[i];
}

// Joint position/velocity limit enforcement (the plant applies this after
// every integrator substep; exposed separately so the Python side can
// parity-test raw integration and limit semantics independently).
void indy7_apply_joint_limits(double* x, int saturate_velocity) {
  static const indy7::Model m = indy7::indy7_model();
  indy7::State xx;
  for (int i = 0; i < 12; ++i) xx[i] = x[i];
  indy7::apply_joint_limits(m, xx, saturate_velocity != 0);
  for (int i = 0; i < 12; ++i) x[i] = xx[i];
}

// Perturbed-plant step (model-mismatch validation): inertials scaled by
// the seeded splitmix64 draws (must match sim/plant.py perturb_model
// exactly) plus joint friction inside every RK4 stage.
void indy7_perturbed_rk4_step(const double* x, const double* u, double dt,
                              const double* wrench_or_null, double pct,
                              unsigned long long seed, double kv, double kc,
                              double* x_out) {
  indy7::Model m = indy7::indy7_model();
  indy7::perturb_model(m, pct, seed);
  indy7::State xx;
  indy7::VecJ uu;
  for (int i = 0; i < 12; ++i) xx[i] = x[i];
  for (int i = 0; i < 6; ++i) uu[i] = u[i];
  const indy7::Vec6* fp = nullptr;
  indy7::Vec6 w{};
  if (wrench_or_null) {
    for (int i = 0; i < 6; ++i) w[i] = wrench_or_null[i];
    fp = &w;
  }
  indy7::Friction fric{kv, kc};
  const indy7::Friction* fq = (kv != 0.0 || kc != 0.0) ? &fric : nullptr;
  const indy7::State out = indy7::rk4_step(m, xx, uu, dt, fp, fq);
  for (int i = 0; i < 12; ++i) x_out[i] = out[i];
}

}  // extern "C"
