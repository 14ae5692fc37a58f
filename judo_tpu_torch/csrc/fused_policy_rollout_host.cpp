// CPU build of the fused policy rollout: the same jt::policy_rollout body as
// fused_policy_rollout.cu, compiled by g++, with the warp played in one thread
// (see fused_rollout_host.cpp) and each rollout's scratch on the heap. Same
// plain C interface. Build with g++ (see _build.py).
#include <vector>

#include "jt_policy.cuh"

template <typename T>
static int run(const JtSizes* s, const int* mi, const T* mf, const int* pi, const T* pf, const T* qpos0,
               const T* qvel0, const T* pout0, const T* cmds, T* oq, T* ov, T* os, T* op, T* jslab, int maxw) {
  std::vector<T> work(jt::make_policy_scratch(*s, maxw).total);
  return jt::host_guard([&] {
    for (int b = 0; b < s->B; ++b) {
      if (s->jglobal)
        jt::policy_rollout<T, true>(*s, mi, mf, pi, pf, qpos0, qvel0, pout0, cmds, oq, ov, os, op, jslab, work.data(),
                                    b);
      else
        jt::policy_rollout<T, false>(*s, mi, mf, pi, pf, qpos0, qvel0, pout0, cmds, oq, ov, os, op, jslab, work.data(),
                                     b);
    }
  });
}

extern "C" {

long long jt_policy_scratch_per_lane(const JtSizes* s, int maxw) {
  return (long long)jt::make_policy_scratch(*s, maxw).total;
}

int jt_fused_policy_rollout_f32(const JtSizes* s, const int* mi, const float* mf, const int* pi, const float* pf,
                                const float* qpos0, const float* qvel0, const float* pout0, const float* cmds,
                                float* oq, float* ov, float* os, float* op, float* jslab, int maxw, void*) {
  return run<float>(s, mi, mf, pi, pf, qpos0, qvel0, pout0, cmds, oq, ov, os, op, jslab, maxw);
}

int jt_fused_policy_rollout_f64(const JtSizes* s, const int* mi, const double* mf, const int* pi, const double* pf,
                                const double* qpos0, const double* qvel0, const double* pout0, const double* cmds,
                                double* oq, double* ov, double* os, double* op, double* jslab, int maxw, void*) {
  return run<double>(s, mi, mf, pi, pf, qpos0, qvel0, pout0, cmds, oq, ov, os, op, jslab, maxw);
}
}
