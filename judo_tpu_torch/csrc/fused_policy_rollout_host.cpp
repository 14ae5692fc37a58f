// CPU build of the fused policy rollout's arithmetic: the same
// jt::policy_rollout_lane body as fused_policy_rollout.cu, run for each
// rollout in turn, with the same plain C interface. Build with g++ (see
// _build.py).
#include "jt_policy.cuh"

extern "C" {

long long jt_policy_scratch_per_lane(const JtSizes* s, int maxw) {
  return (long long)jt::make_policy_scratch(*s, maxw).total;
}

int jt_fused_policy_rollout_f32(const JtSizes* s, const int* mi, const float* mf, const int* pi, const float* pf,
                                const float* qpos0, const float* qvel0, const float* pout0, const float* cmds,
                                float* oq, float* ov, float* os, float* op, float* scratch, void*) {
  for (int b = 0; b < s->B; ++b)
    jt::policy_rollout_lane<float>(*s, mi, mf, pi, pf, qpos0, qvel0, pout0, cmds, oq, ov, os, op, scratch, b);
  return 0;
}

int jt_fused_policy_rollout_f64(const JtSizes* s, const int* mi, const double* mf, const int* pi, const double* pf,
                                const double* qpos0, const double* qvel0, const double* pout0, const double* cmds,
                                double* oq, double* ov, double* os, double* op, double* scratch, void*) {
  for (int b = 0; b < s->B; ++b)
    jt::policy_rollout_lane<double>(*s, mi, mf, pi, pf, qpos0, qvel0, pout0, cmds, oq, ov, os, op, scratch, b);
  return 0;
}
}
