// Fused policy-in-the-loop rollout (Spot) on an NVIDIA Hopper GPU.
//
// Replaces: judo_tpu/physics/pallas_step.py::_build_fused_policy_rollout (the
// TPU Pallas kernel whose grid (tiles, T) ran, per 128-lane tile and policy
// tick, the observation, the locomotion MLP as four MXU matmuls, the ctrl
// mapping and two physics steps, carrying state and policy output in VMEM).
//
// Design: as the fused rollout (fused_rollout.cu), one warp per rollout and
// one warp per block, grid (R,), with the T loop inside the warp and the
// rollout's whole scratch (the step body's, plus the policy's carried output,
// ctrl and two activation buffers; 72.2 KB f32 on Spot) in dynamic shared
// memory. The MLP runs lanes over output neurons on an input-major pack of the
// weights (policy_rollout.py:pack_policy): at each input the 32 lanes read 32
// consecutive weights, one coalesced line from L2, and the activation is a
// shared-memory broadcast. No cuBLAS, no tensor cores.
//
// What bounds it on this card: latency, as for the fused rollout. Per tick the
// warp walks 0.21 M weights (837 KB f32, more than an SM's L1, so they stream
// from L2) and runs two physics steps over a dense 282 x 25 constraint
// Jacobian. With R = 24 only 24 of the 132 SMs hold a rollout.
#include <cuda_runtime.h>

#include "jt_policy.cuh"

// Two builds, by where J lives (JG: a slab of global memory), as the fused
// rollout's.
template <typename T, bool JG>
__global__ void __launch_bounds__(32) fused_policy_rollout_kernel(JtSizes s, const int* mi, const T* mf,
                                                                   const int* pi, const T* pf, const T* qpos0,
                                                                   const T* qvel0, const T* pout0, const T* cmds,
                                                                   T* oq, T* ov, T* os, T* op, T* jslab) {
  jt::policy_rollout<T, JG>(s, mi, mf, pi, pf, qpos0, qvel0, pout0, cmds, oq, ov, os, op, jslab,
                            jt::rollout_smem<T>(), blockIdx.x);
}

template <typename T>
using PolicyKernel = void (*)(JtSizes, const int*, const T*, const int*, const T*, const T*, const T*, const T*,
                              const T*, T*, T*, T*, T*, T*);

template <typename T>
static PolicyKernel<T> kernel_for(int jglobal) {
  return jglobal ? fused_policy_rollout_kernel<T, true> : fused_policy_rollout_kernel<T, false>;
}

template <typename T>
static int launch(const JtSizes* s, const int* mi, const T* mf, const int* pi, const T* pf, const T* qpos0,
                  const T* qvel0, const T* pout0, const T* cmds, T* oq, T* ov, T* os, T* op, T* jslab, int maxw,
                  void* stream) {
  const PolicyKernel<T> k = kernel_for<T>(s->jglobal);
  const int bytes = (int)(jt::make_policy_scratch(*s, maxw).total * (int64_t)sizeof(T));
  const cudaError_t e = jt::allow_smem(k, bytes);
  if (e != cudaSuccess) return (int)e;
  k<<<s->B, jt::Warp::kLanes, bytes, (cudaStream_t)stream>>>(
      *s, mi, mf, pi, pf, qpos0, qvel0, pout0, cmds, oq, ov, os, op, jslab);
  return (int)cudaGetLastError();
}

template <typename T>
static int blocks_per_sm(int jglobal, int bytes, int* blocks) {
  const PolicyKernel<T> k = kernel_for<T>(jglobal);
  const cudaError_t e = jt::allow_smem(k, bytes);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, k, jt::Warp::kLanes, bytes);
}

extern "C" {

long long jt_policy_scratch_per_lane(const JtSizes* s, int maxw) {
  return (long long)jt::make_policy_scratch(*s, maxw).total;
}

int jt_fused_policy_rollout_f32(const JtSizes* s, const int* mi, const float* mf, const int* pi, const float* pf,
                                const float* qpos0, const float* qvel0, const float* pout0, const float* cmds,
                                float* oq, float* ov, float* os, float* op, float* jslab, int maxw, void* stream) {
  return launch<float>(s, mi, mf, pi, pf, qpos0, qvel0, pout0, cmds, oq, ov, os, op, jslab, maxw, stream);
}

int jt_fused_policy_rollout_f64(const JtSizes* s, const int* mi, const double* mf, const int* pi, const double* pf,
                                const double* qpos0, const double* qvel0, const double* pout0, const double* cmds,
                                double* oq, double* ov, double* os, double* op, double* jslab, int maxw,
                                void* stream) {
  return launch<double>(s, mi, mf, pi, pf, qpos0, qvel0, pout0, cmds, oq, ov, os, op, jslab, maxw, stream);
}

// Resident blocks per SM of the policy rollout kernel (jglobal: the build with
// J in global memory) at `bytes` of dynamic shared memory per block.
int jt_policy_blocks_per_sm(int jglobal, int f64, int bytes, int* blocks) {
  return f64 ? blocks_per_sm<double>(jglobal, bytes, blocks) : blocks_per_sm<float>(jglobal, bytes, blocks);
}
}
