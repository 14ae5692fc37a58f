// CPU build of the fused rollout: the same jt::rollout body as
// fused_rollout.cu, compiled by g++. Group (jt_common.cuh) plays the W x 32
// threads of the card's block in one thread, in the card's partition and
// reduction order, and each rollout's scratch is a heap buffer in place of
// shared memory. It has the same plain C interface, so the CPU tests hold the
// kernel's own arithmetic against the plain PyTorch version without a GPU.
// One warp is built here, W = 4 in fused_rollout_multiwarp_host.cpp,
// which g++ compiles beside this file. Build with g++ (see _build.py).
#include "jt_step.cuh"

// The rollout at W = 4 (fused_rollout_multiwarp_host.cpp).
template <typename T>
int multiwarp_rollouts(const JtSizes* s, int warps, const int* mi, const T* mf, const T* qpos0, const T* qvel0,
                       const T* ctrl, const T* f0, T* oq, T* ov, T* os, T* of0, T* jslab);

template <typename T>
static int run(const JtSizes* s, int warps, const int* mi, const T* mf, const T* qpos0, const T* qvel0,
               const T* ctrl, const T* f0, T* oq, T* ov, T* os, T* of0, T* jslab) {
  if (warps == 1) return jt::host_rollouts<T, jt::Warp>(*s, mi, mf, qpos0, qvel0, ctrl, f0, oq, ov, os, of0, jslab);
  return multiwarp_rollouts<T>(s, warps, mi, mf, qpos0, qvel0, ctrl, f0, oq, ov, os, of0, jslab);
}

extern "C" {

long long jt_scratch_per_lane(const JtSizes* s) { return (long long)jt::make_scratch(*s).total; }

long long jt_jslab_per_lane(const JtSizes* s) { return (long long)jt::make_scratch(*s).jsize; }

void jt_model_sizes(const JtSizes* s, int* nint, int* nflt) {
  const jt::Layout L = jt::make_layout(*s);
  *nint = L.nint;
  *nflt = L.nflt;
}

int jt_fused_rollout_f32(const JtSizes* s, int warps, const int* mi, const float* mf, const float* qpos0,
                         const float* qvel0, const float* ctrl, const float* f0, float* oq, float* ov, float* os,
                         float* of0, float* jslab, void*) {
  return run<float>(s, warps, mi, mf, qpos0, qvel0, ctrl, f0, oq, ov, os, of0, jslab);
}

int jt_fused_rollout_f64(const JtSizes* s, int warps, const int* mi, const double* mf, const double* qpos0,
                         const double* qvel0, const double* ctrl, const double* f0, double* oq, double* ov,
                         double* os, double* of0, double* jslab, void*) {
  return run<double>(s, warps, mi, mf, qpos0, qvel0, ctrl, f0, oq, ov, os, of0, jslab);
}

// The contact slots of one geom pair (x, row-major m, sizes s) of pair kind
// `kind`, at most 4 (d, pos, nrm); -1 for an unknown kind. For tests.
int jt_pair_contacts_f64(int kind, const double* x1, const double* m1, const double* s1, const double* x2,
                         const double* m2, const double* s2, double* d, double* pos, double* nrm) {
  return jt::host_guard([&] { jt::pair_contacts(kind, x1, m1, s1, x2, m2, s2, d, pos, nrm); });
}

const char* jt_error_string(int code) { return code == 0 ? "no error" : jt::host_error().c_str(); }
}
