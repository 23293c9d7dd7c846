// Standalone native plant process (the sim_node.cpp equivalent).
//
// Fixed-rate RK4 physics of the Indy7 under torque commands and an
// external world wrench, publishing state over latest-wins UDP — the
// framework's replacement for the reference's MuJoCo + ROS 2 node
// (/root/reference/src/sim/sim/sim_node.cpp):
//   * fixed initial pose {1.5799, 0.0631, -1.1807, 1.0927, -0.6255,
//     -0.0190} (sim_node.cpp:196);
//   * physics holds until the first command arrives (sim_node.cpp:293-299:
//     mj_forward until command_received);
//   * per-tick state message carries q, v, and the world EE position (the
//     reference smuggles the latter through effort[0:3],
//     sim_node.cpp:343-345 — here it is an explicit field);
//   * external force applied at the EE with world-origin moment semantics
//     (mj_applyFT analog, sim_node.cpp:309-325).
//
// Usage: plant_node [timestep=0.001] [publish_every=10] [--ports <plant> <ctrl>]
//                   [--perturb <pct> <seed>] [--friction <kv> <kc>]
//                   [--noise <std_Nm>] [--realtime-scale <s>]
//   (timestep 1 ms with publish every 10 steps = 100 Hz state topic).
// --realtime-scale s > 1 runs plant time s-times slower than wall clock
// (sleep dt*s per physics dt).  The state packet carries the plant's own
// sim time, so a controller advancing its reference by sim-time deltas
// stays rate-consistent — the standard HIL trick when the compute rig
// adds latency the target deployment does not have.
// The optional flags build a deliberately mismatched ground-truth plant —
// seeded inertial error, unmodeled joint friction, gaussian actuation
// noise per physics step — the role MuJoCo's distinct engine plays for
// the reference (sim_node.cpp:184-201; indy7.xml:62-75 sensor noise).
// Wire format: see indy7_mpc/runtime/transport.py.
#include <arpa/inet.h>
#include <netinet/in.h>
#include <sys/socket.h>
#include <unistd.h>

#include <chrono>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <random>
#include <thread>

#include "rbd.hpp"

namespace {

constexpr unsigned char kTagState = 1;
constexpr unsigned char kTagCommand = 2;
constexpr unsigned char kTagWrench = 3;
// Reset to the fixed initial pose and hold until a fresh command — the
// reference sim's 'R' key (sim_node.cpp:44-46, 107-130, 288-291), as a
// protocol message so a crashed/diverged run recovers without a process
// restart.  Sim time keeps running (the controller's reference clock
// stays monotone).
constexpr unsigned char kTagReset = 4;

}  // namespace

int main(int argc, char** argv) {
  double dt = 0.001;
  int publish_every = 10;
  double perturb_pct = 0.0, noise_std = 0.0, realtime_scale = 1.0;
  bool vel_limit = false;  // --vel-limit: opt-in servo velocity saturation
  int listen_port = 7461, ctrl_port = 7460;  // --ports <plant> <controller>
  int mirror_port = 0;  // --mirror <port>: live-telemetry tap (GLFW role)
  unsigned long long perturb_seed = 0;
  indy7::Friction friction{};
  int pos = 0;
  for (int i = 1; i < argc; ++i) {
    if (std::strcmp(argv[i], "--perturb") == 0 && i + 2 < argc) {
      perturb_pct = std::atof(argv[++i]);
      perturb_seed = std::strtoull(argv[++i], nullptr, 10);
    } else if (std::strcmp(argv[i], "--friction") == 0 && i + 2 < argc) {
      friction.kv = std::atof(argv[++i]);
      friction.kc = std::atof(argv[++i]);
    } else if (std::strcmp(argv[i], "--noise") == 0 && i + 1 < argc) {
      noise_std = std::atof(argv[++i]);
    } else if (std::strcmp(argv[i], "--realtime-scale") == 0 &&
               i + 1 < argc) {
      realtime_scale = std::atof(argv[++i]);
    } else if (std::strcmp(argv[i], "--vel-limit") == 0) {
      vel_limit = true;
    } else if (std::strcmp(argv[i], "--ports") == 0 && i + 2 < argc) {
      listen_port = std::atoi(argv[++i]);   // plant listens here
      ctrl_port = std::atoi(argv[++i]);     // controller listens here
    } else if (std::strcmp(argv[i], "--mirror") == 0 && i + 1 < argc) {
      mirror_port = std::atoi(argv[++i]);   // duplicate state packets here
    } else if (pos == 0) {
      dt = std::atof(argv[i]);
      ++pos;
    } else if (pos == 1) {
      publish_every = std::atoi(argv[i]);
      ++pos;
    }
  }
  const bool use_friction = friction.kv != 0.0 || friction.kc != 0.0;
  std::mt19937_64 noise_rng(perturb_seed * 1315423911ULL + 12345ULL);
  std::normal_distribution<double> gauss(0.0, 1.0);

  indy7::Model model = indy7::indy7_model();
  indy7::perturb_model(model, perturb_pct, perturb_seed);
  indy7::State x{};
  const double init_q[6] = {1.5799, 0.0631, -1.1807, 1.0927, -0.6255, -0.0190};
  for (int i = 0; i < 6; ++i) x[i] = init_q[i];

  indy7::VecJ u{};
  indy7::Vec6 wrench{};
  bool command_received = false;
  bool have_wrench = false;

  int sock = socket(AF_INET, SOCK_DGRAM, 0);
  sockaddr_in listen_addr{};
  listen_addr.sin_family = AF_INET;
  listen_addr.sin_addr.s_addr = inet_addr("127.0.0.1");
  listen_addr.sin_port = htons(listen_port);
  if (bind(sock, (sockaddr*)&listen_addr, sizeof(listen_addr)) != 0) {
    std::perror("bind");
    return 1;
  }
  sockaddr_in ctrl_addr{};
  ctrl_addr.sin_family = AF_INET;
  ctrl_addr.sin_addr.s_addr = inet_addr("127.0.0.1");
  ctrl_addr.sin_port = htons(ctrl_port);
  sockaddr_in mirror_addr{};
  mirror_addr.sin_family = AF_INET;
  mirror_addr.sin_addr.s_addr = inet_addr("127.0.0.1");
  mirror_addr.sin_port = htons(mirror_port);

  std::printf(
      "plant_node: dt=%g publish_every=%d (state at %g Hz) "
      "perturb=%g%%/seed=%llu friction=(%g,%g) noise=%g\n",
      dt, publish_every, 1.0 / (dt * publish_every), 100.0 * perturb_pct,
      perturb_seed, friction.kv, friction.kc, noise_std);

  using clock = std::chrono::steady_clock;
  auto next = clock::now();
  long step = 0;
  unsigned char buf[512];

  while (true) {
    // Drain incoming datagrams (latest-wins).
    while (true) {
      ssize_t n = recvfrom(sock, buf, sizeof(buf), MSG_DONTWAIT, nullptr,
                           nullptr);
      if (n <= 0) break;
      if (buf[0] == kTagCommand && n >= 1 + 6 * 8) {
        std::memcpy(u.data(), buf + 1, 6 * 8);
        // Actuator effort limits (MuJoCo ctrlrange, indy7.xml:52-59).
        static const double kEffort[6] = {431.97, 431.97, 197.23,
                                          79.79,  79.79,  79.79};
        for (int i = 0; i < 6; ++i) {
          if (u[i] > kEffort[i]) u[i] = kEffort[i];
          if (u[i] < -kEffort[i]) u[i] = -kEffort[i];
        }
        command_received = true;
      } else if (buf[0] == kTagWrench && n >= 1 + 3 * 8) {
        std::memcpy(wrench.data(), buf + 1, 3 * 8);
        wrench[3] = wrench[4] = wrench[5] = 0.0;
        have_wrench = true;
      } else if (buf[0] == kTagReset) {
        // 'R'-key semantics: back to the initial pose, zero velocity,
        // wait for a fresh command (sim_node.cpp:107-130, 288-291).
        x = indy7::State{};
        for (int i = 0; i < 6; ++i) x[i] = init_q[i];
        u = indy7::VecJ{};
        command_received = false;
      }
    }

    // Physics step (held at the initial pose until the first command).
    if (command_received) {
      indy7::VecJ us = u;
      if (noise_std > 0.0) {
        for (int i = 0; i < 6; ++i) us[i] += noise_std * gauss(noise_rng);
      }
      x = indy7::rk4_step(model, x, us, dt, have_wrench ? &wrench : nullptr,
                          use_friction ? &friction : nullptr);
      // Joint range limits, the mj_step constraint analog
      // (sim_node.cpp:293-299, indy7.xml:18-38); velocity saturation
      // only with --vel-limit (MuJoCo does not enforce it).
      indy7::apply_joint_limits(model, x, vel_limit);
    }

    if (step % publish_every == 0) {
      indy7::VecJ q;
      for (int i = 0; i < 6; ++i) q[i] = x[i];
      const indy7::Vec3 ee = indy7::ee_position(model, q);
      // 16th double: the plant's own sim time (seconds) so the
      // controller can advance its reference window by PLANT time —
      // immune to --realtime-scale and wall-clock jitter.
      const double sim_time = static_cast<double>(step) * dt;
      unsigned char out[1 + 16 * 8];
      out[0] = kTagState;
      std::memcpy(out + 1, x.data(), 12 * 8);
      std::memcpy(out + 1 + 12 * 8, ee.data(), 3 * 8);
      std::memcpy(out + 1 + 15 * 8, &sim_time, 8);
      sendto(sock, out, sizeof(out), 0, (sockaddr*)&ctrl_addr,
             sizeof(ctrl_addr));
      if (mirror_port) {
        // Live-telemetry tap: the interactive-viewer role the reference
        // fills with GLFW (sim_node.cpp:33-76); see tools/live_view.py.
        sendto(sock, out, sizeof(out), 0, (sockaddr*)&mirror_addr,
               sizeof(mirror_addr));
      }
    }
    ++step;

    next += std::chrono::duration_cast<clock::duration>(
        std::chrono::duration<double>(dt * realtime_scale));
    std::this_thread::sleep_until(next);
  }
  close(sock);
  return 0;
}
