// CPU build of the fused rollout: the same jt::rollout body as
// fused_rollout.cu, compiled by g++. Warp (jt_common.cuh) plays the 32 lanes
// of the card's warp in one thread, in the card's partition and reduction
// order, and each rollout's scratch is a heap buffer in place of shared
// memory. It has the same plain C interface, so the CPU tests hold the
// kernel's own arithmetic against the plain PyTorch version without a GPU.
// Build with g++ (see _build.py).
#include <vector>

#include "jt_step.cuh"

template <typename T>
static int run(const JtSizes* s, const int* mi, const T* mf, const T* qpos0, const T* qvel0, const T* ctrl,
               const T* f0, T* oq, T* ov, T* os, T* of0, T* jslab) {
  std::vector<T> work(jt::make_scratch(*s).total);
  return jt::host_guard([&] {
    for (int b = 0; b < s->B; ++b) {
      if (s->jglobal)
        jt::rollout<T, true>(*s, mi, mf, qpos0, qvel0, ctrl, f0, oq, ov, os, of0, jslab, work.data(), b);
      else
        jt::rollout<T, false>(*s, mi, mf, qpos0, qvel0, ctrl, f0, oq, ov, os, of0, jslab, work.data(), b);
    }
  });
}

extern "C" {

long long jt_scratch_per_lane(const JtSizes* s) { return (long long)jt::make_scratch(*s).total; }

long long jt_jslab_per_lane(const JtSizes* s) { return (long long)jt::make_scratch(*s).jsize; }

void jt_model_sizes(const JtSizes* s, int* nint, int* nflt) {
  const jt::Layout L = jt::make_layout(*s);
  *nint = L.nint;
  *nflt = L.nflt;
}

int jt_fused_rollout_f32(const JtSizes* s, const int* mi, const float* mf, const float* qpos0, const float* qvel0,
                         const float* ctrl, const float* f0, float* oq, float* ov, float* os, float* of0,
                         float* jslab, void*) {
  return run<float>(s, mi, mf, qpos0, qvel0, ctrl, f0, oq, ov, os, of0, jslab);
}

int jt_fused_rollout_f64(const JtSizes* s, const int* mi, const double* mf, const double* qpos0,
                         const double* qvel0, const double* ctrl, const double* f0, double* oq, double* ov,
                         double* os, double* of0, double* jslab, void*) {
  return run<double>(s, mi, mf, qpos0, qvel0, ctrl, f0, oq, ov, os, of0, jslab);
}

// The contact slots of one geom pair (x, row-major m, sizes s) of pair kind
// `kind`, at most 4 (d, pos, nrm); -1 for an unknown kind. For tests.
int jt_pair_contacts_f64(int kind, const double* x1, const double* m1, const double* s1, const double* x2,
                         const double* m2, const double* s2, double* d, double* pos, double* nrm) {
  return jt::host_guard([&] { jt::pair_contacts(kind, x1, m1, s1, x2, m2, s2, d, pos, nrm); });
}

const char* jt_error_string(int code) { return code == 0 ? "no error" : jt::host_error().c_str(); }
}
