// CPU build of the fused rollout at W = 4 warps per rollout, the
// Group<W> of jt_common.cuh played in one thread (see fused_rollout_host.cpp,
// whose run() calls multiwarp_rollouts). A file of its own so that g++
// compiles it beside the one-warp build. Build with g++ (see _build.py).
#include "jt_step.cuh"

template <typename T>
int multiwarp_rollouts(const JtSizes* s, int warps, const int* mi, const T* mf, const T* qpos0, const T* qvel0,
                       const T* ctrl, const T* f0, T* oq, T* ov, T* os, T* of0, T* jslab) {
  switch (warps) {
    case 4:
      return jt::host_rollouts<T, jt::Group<4>>(*s, mi, mf, qpos0, qvel0, ctrl, f0, oq, ov, os, of0, jslab);
    default:
      jt::host_error() = "fused_rollout: no build at " + std::to_string(warps) + " warps per rollout";
      return -1;
  }
}

template int multiwarp_rollouts<float>(const JtSizes*, int, const int*, const float*, const float*, const float*,
                                       const float*, const float*, float*, float*, float*, float*, float*);
template int multiwarp_rollouts<double>(const JtSizes*, int, const int*, const double*, const double*, const double*,
                                        const double*, const double*, double*, double*, double*, double*, double*);
