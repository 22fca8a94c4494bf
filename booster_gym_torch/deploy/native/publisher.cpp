// Native real-time command publisher for the T1 deploy stack.
//
// The reference runs its 500 Hz publish loop as a Python thread
// (reference: deploy/deploy.py:336-382), which suffers GIL jitter at the
// 2 ms period.  This C++ core implements the same pipeline with
// deterministic timing:
//
//   * a seqlock-protected target buffer written by the (Python) inference
//     thread and read wait-free by the publisher loop;
//   * EMA target filtering (0.8/0.2; teleop joints 0.9/0.1);
//   * series-parallel ankle conversion: position command -> clipped torque
//     command for the parallel_mech joints (deploy/deploy.py:365-376);
//   * a clock_nanosleep(TIMER_ABSTIME) paced loop invoking a user callback
//     with the finished 23-joint command (on-robot: the DDS write).
//
// Exposed as a plain C ABI consumed via ctypes (booster_gym_torch/deploy/
// native/__init__.py); no pybind11 dependency.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <ctime>

namespace {

constexpr int kMaxJoints = 64;

struct Config {
  int num_joints = 23;
  double dt = 0.002;
  float ema_default = 0.8f;   // weight on previous filtered value
  float ema_teleop = 0.9f;
  int num_parallel = 0;
  int parallel_idx[kMaxJoints] = {0};
  int teleop_joint[kMaxJoints] = {0};  // 1 = use teleop EMA weight
  float stiffness[kMaxJoints] = {0};
  float torque_limit[kMaxJoints] = {0};
};

struct TargetBuffer {
  std::atomic<uint64_t> seq{0};
  float targets[kMaxJoints] = {0};
  float measured_q[kMaxJoints] = {0};
};

struct Publisher {
  Config cfg;
  TargetBuffer buf;
  float filtered[kMaxJoints] = {0};
  std::atomic<bool> running{false};
};

inline float clipf(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

}  // namespace

extern "C" {

// Command output layout per joint: [q, tau, kp_mask] where kp_mask = 0 for
// torque-mode (parallel-ankle) joints and 1 for position-servo joints.
struct JointOut {
  float q;
  float tau;
  float kp_mask;
};

typedef void (*publish_cb)(const JointOut* cmd, int num_joints, void* user);

Publisher* publisher_create(int num_joints, double dt, const float* stiffness,
                            const float* torque_limit, const int* parallel_idx,
                            int num_parallel, const int* teleop_joint) {
  auto* p = new Publisher();
  p->cfg.num_joints = num_joints;
  p->cfg.dt = dt;
  p->cfg.num_parallel = num_parallel;
  std::memcpy(p->cfg.stiffness, stiffness, sizeof(float) * num_joints);
  std::memcpy(p->cfg.torque_limit, torque_limit, sizeof(float) * num_joints);
  std::memcpy(p->cfg.parallel_idx, parallel_idx, sizeof(int) * num_parallel);
  if (teleop_joint != nullptr) {
    std::memcpy(p->cfg.teleop_joint, teleop_joint, sizeof(int) * num_joints);
  }
  return p;
}

void publisher_destroy(Publisher* p) { delete p; }

// Inference thread: publish new targets + latest measured joint positions.
// Seqlock write: odd seq while writing.
void publisher_set_targets(Publisher* p, const float* targets,
                           const float* measured_q) {
  uint64_t s = p->buf.seq.load(std::memory_order_relaxed);
  p->buf.seq.store(s + 1, std::memory_order_release);
  std::memcpy(p->buf.targets, targets, sizeof(float) * p->cfg.num_joints);
  std::memcpy(p->buf.measured_q, measured_q, sizeof(float) * p->cfg.num_joints);
  p->buf.seq.store(s + 2, std::memory_order_release);
}

void publisher_init_filtered(Publisher* p, const float* q) {
  std::memcpy(p->filtered, q, sizeof(float) * p->cfg.num_joints);
}

// One publish step: EMA + parallel-ankle conversion into `out`.
void publisher_step(Publisher* p, JointOut* out) {
  const Config& c = p->cfg;
  float targets[kMaxJoints];
  float measured[kMaxJoints];
  // seqlock read
  uint64_t s0, s1;
  do {
    s0 = p->buf.seq.load(std::memory_order_acquire);
    std::memcpy(targets, p->buf.targets, sizeof(float) * c.num_joints);
    std::memcpy(measured, p->buf.measured_q, sizeof(float) * c.num_joints);
    s1 = p->buf.seq.load(std::memory_order_acquire);
  } while (s0 != s1 || (s0 & 1));

  for (int i = 0; i < c.num_joints; ++i) {
    const float w = c.teleop_joint[i] ? c.ema_teleop : c.ema_default;
    p->filtered[i] = p->filtered[i] * w + targets[i] * (1.0f - w);
    out[i].q = p->filtered[i];
    out[i].tau = 0.0f;
    out[i].kp_mask = 1.0f;
  }
  for (int k = 0; k < c.num_parallel; ++k) {
    const int i = c.parallel_idx[k];
    out[i].q = measured[i];
    out[i].tau = clipf((p->filtered[i] - measured[i]) * c.stiffness[i],
                       -c.torque_limit[i], c.torque_limit[i]);
    out[i].kp_mask = 0.0f;
  }
}

// Absolute-deadline paced loop at 1/dt Hz; calls cb each period.
// Returns the number of periods that overran their deadline.
long publisher_run_loop(Publisher* p, publish_cb cb, void* user, long num_steps) {
  p->running.store(true);
  JointOut out[kMaxJoints];
  struct timespec next;
  clock_gettime(CLOCK_MONOTONIC, &next);
  const long period_ns = static_cast<long>(p->cfg.dt * 1e9);
  long overruns = 0;
  for (long step = 0; (num_steps < 0 || step < num_steps) && p->running.load();
       ++step) {
    next.tv_nsec += period_ns;
    while (next.tv_nsec >= 1000000000L) {
      next.tv_nsec -= 1000000000L;
      next.tv_sec += 1;
    }
    publisher_step(p, out);
    cb(out, p->cfg.num_joints, user);
    struct timespec now;
    clock_gettime(CLOCK_MONOTONIC, &now);
    if (now.tv_sec > next.tv_sec ||
        (now.tv_sec == next.tv_sec && now.tv_nsec > next.tv_nsec)) {
      ++overruns;
      next = now;  // resync after an overrun
      continue;
    }
    clock_nanosleep(CLOCK_MONOTONIC, TIMER_ABSTIME, &next, nullptr);
  }
  return overruns;
}

void publisher_stop(Publisher* p) { p->running.store(false); }

}  // extern "C"
