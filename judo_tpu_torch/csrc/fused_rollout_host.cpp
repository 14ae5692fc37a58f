// CPU build of the fused rollout's arithmetic: the same jt::rollout_lane body
// as fused_rollout.cu, run for each rollout in turn. It has the same plain C
// interface, so the CPU tests hold the kernel's own arithmetic against the
// plain PyTorch version without a GPU. Build with g++ (see _build.py).
#include "jt_step.cuh"

extern "C" {

long long jt_scratch_per_lane(const JtSizes* s) { return (long long)jt::make_scratch(*s).total; }

void jt_model_sizes(const JtSizes* s, int* nint, int* nflt) {
  const jt::Layout L = jt::make_layout(*s);
  *nint = L.nint;
  *nflt = L.nflt;
}

int jt_fused_rollout_f32(const JtSizes* s, const int* mi, const float* mf, const float* qpos0, const float* qvel0,
                         const float* ctrl, const float* f0, float* oq, float* ov, float* os, float* of0,
                         float* scratch, void*) {
  for (int b = 0; b < s->B; ++b) jt::rollout_lane<float>(*s, mi, mf, qpos0, qvel0, ctrl, f0, oq, ov, os, of0, scratch, b);
  return 0;
}

int jt_fused_rollout_f64(const JtSizes* s, const int* mi, const double* mf, const double* qpos0,
                         const double* qvel0, const double* ctrl, const double* f0, double* oq, double* ov,
                         double* os, double* of0, double* scratch, void*) {
  for (int b = 0; b < s->B; ++b) jt::rollout_lane<double>(*s, mi, mf, qpos0, qvel0, ctrl, f0, oq, ov, os, of0, scratch, b);
  return 0;
}

const char* jt_error_string(int) { return "no error"; }
}
