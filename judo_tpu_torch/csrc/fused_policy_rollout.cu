// Fused policy-in-the-loop rollout (Spot) on an NVIDIA Hopper GPU.
//
// Replaces: judo_tpu/physics/pallas_step.py::_build_fused_policy_rollout (the
// TPU Pallas kernel whose grid (tiles, T) ran, per 128-lane tile and policy
// tick, the observation, the locomotion MLP as four MXU matmuls, the ctrl
// mapping and two physics steps, carrying state and policy output in VMEM).
//
// Design: as the fused rollout (fused_rollout.cu), one thread per rollout
// with the T loop inside the thread and every carry in the rollout's slice of
// a batch-last scratch buffer. The MLP runs in the thread too: each output is
// a dot product over the layer's inputs, with the weights read from one
// packed global array. All 32 threads of a warp read the same weight at the
// same time, so each load is one broadcast from L1/L2; no cuBLAS, no tensor
// cores. A ragged last warp (R = 24 leaves 8 idle lanes) is masked.
//
// What bounds it on this card: latency, as for the fused rollout. Per tick a
// thread does ~0.2 M dependent-load multiply-adds of the MLP against two
// physics steps that each walk a dense 282 x 25 constraint Jacobian through
// nine operator applies, one dependent chain per rollout with one warp per
// SM. The MLP is a few percent of a tick; the physics step is the rest.
#include <cuda_runtime.h>

#include "jt_policy.cuh"

template <typename T>
__global__ void __launch_bounds__(32) fused_policy_rollout_kernel(JtSizes s, const int* mi, const T* mf,
                                                                   const int* pi, const T* pf, const T* qpos0,
                                                                   const T* qvel0, const T* pout0, const T* cmds,
                                                                   T* oq, T* ov, T* os, T* op, T* scratch) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= s.B) return;
  jt::policy_rollout_lane<T>(s, mi, mf, pi, pf, qpos0, qvel0, pout0, cmds, oq, ov, os, op, scratch, b);
}

template <typename T>
static int launch(const JtSizes* s, const int* mi, const T* mf, const int* pi, const T* pf, const T* qpos0,
                  const T* qvel0, const T* pout0, const T* cmds, T* oq, T* ov, T* os, T* op, T* scratch,
                  void* stream) {
  const int threads = 32;
  const int blocks = (s->B + threads - 1) / threads;
  fused_policy_rollout_kernel<T><<<blocks, threads, 0, (cudaStream_t)stream>>>(*s, mi, mf, pi, pf, qpos0, qvel0,
                                                                              pout0, cmds, oq, ov, os, op, scratch);
  return (int)cudaGetLastError();
}

extern "C" {

long long jt_policy_scratch_per_lane(const JtSizes* s, int maxw) {
  return (long long)jt::make_policy_scratch(*s, maxw).total;
}

int jt_fused_policy_rollout_f32(const JtSizes* s, const int* mi, const float* mf, const int* pi, const float* pf,
                                const float* qpos0, const float* qvel0, const float* pout0, const float* cmds,
                                float* oq, float* ov, float* os, float* op, float* scratch, void* stream) {
  return launch<float>(s, mi, mf, pi, pf, qpos0, qvel0, pout0, cmds, oq, ov, os, op, scratch, stream);
}

int jt_fused_policy_rollout_f64(const JtSizes* s, const int* mi, const double* mf, const int* pi, const double* pf,
                                const double* qpos0, const double* qvel0, const double* pout0, const double* cmds,
                                double* oq, double* ov, double* os, double* op, double* scratch, void* stream) {
  return launch<double>(s, mi, mf, pi, pf, qpos0, qvel0, pout0, cmds, oq, ov, os, op, scratch, stream);
}
}
