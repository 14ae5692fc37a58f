// The rollout kernel K1 (fused_rollout.cu) as a template over the scalar, the
// place of J and W, the warps per rollout, for the files that build it: W = 1
// in fused_rollout.cu, W = 4 in fused_rollout_w4.cu, which nvcc compiles
// beside it (one W a file, so that the build of one W does not wait on the
// other's).
#pragma once

#include <cuda_runtime.h>

#include "jt_step.cuh"

// Each kernel has two builds, by where J lives (JG: a slab of global memory,
// for a model whose whole scratch exceeds the card's per-block limit; the
// wrapper picks the layout from the sizes, and launch() the build), and the
// rollout kernel one for each W the wrapper picks (1, 4).
template <typename T, bool JG, int W>
__global__ void __launch_bounds__(W * 32) fused_rollout_kernel(JtSizes s, const int* mi, const T* mf,
                                                                const T* qpos0, const T* qvel0, const T* ctrl,
                                                                const T* f0, T* oq, T* ov, T* os, T* of0,
                                                                T* jslab) {
  jt::rollout<T, JG, jt::Group<W>>(s, mi, mf, qpos0, qvel0, ctrl, f0, oq, ov, os, of0, jslab,
                                   jt::rollout_smem<T>(), blockIdx.x);
}

template <typename T>
using Kernel = void (*)(JtSizes, const int*, const T*, const T*, const T*, const T*, const T*, T*, T*, T*, T*, T*);

// fused_rollout_kernel<T, JG, W>, built in the file of W > 1 that defines it.
template <typename T, bool JG, int W>
Kernel<T> rollout_kernel_at();
