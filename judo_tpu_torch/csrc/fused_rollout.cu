// Fused T-step rollout of the lanes physics step on an NVIDIA Hopper GPU.
//
// Replaces: judo_tpu/physics/pallas_step.py::_build_fused_rollout (the TPU
// Pallas kernel whose grid (T,) advanced every 128-lane tile one step per grid
// step, carrying qpos, qvel, warm-start forces and the Collatz-Wielandt probe
// in VMEM scratch).
//
// Design: one block per rollout, grid (B,), of W warps (W x 32 threads; W =
// 1 unless the rollouts leave schedulers idle, below). The sequential TPU grid
// over T becomes a loop inside the block. The rollout's whole scratch
// (make_scratch: state, carries, kinematics, M and its inverse, J and the
// solver's vectors; 56.4 KB f32 on leap) lives in dynamic shared memory for
// the launch, so no access of the chain waits on L2. The stages that walk the
// dense J (assembly, Jacobi scaling, the operator applies of the CW bound and
// the APGD loop, the final J^T f) and the island inverses spread their rows,
// dofs, contacts or pairs over the block's threads (jt_step.cuh, Group in
// jt_common.cuh); kinematics, dynamics, sensors and the position update run on
// thread 0. Inputs and outputs stay batch-last in global memory ((T, n, B)).
//
// What bounds it on this card: latency, not bytes. Each rollout is still one
// dependent chain (kinematics -> dynamics -> collision -> assembly -> 8 APGD
// iterations -> integration, times T), W x 32 threads wide in its J passes
// and with shared-memory latency; at f32 three leap rollouts fit an SM (the
// SM's 228 KB less 1 KB reserved per block), so 320 rollouts run in one wave
// over the 132 SMs. A warp is run by one of an SM's four schedulers, so
// where the rollouts are few (fr3_pick's 64: one block an SM on 64 of the 132)
// a block of one warp leaves three of them idle. The wrapper
// (fused_rollout.py:rollout_warps) then gives each block W warps, so that
// ceil(B / SMs) blocks of W warps fill the four; the physics step kernel (K3)
// always runs one warp.
#include "fused_rollout.cuh"

// One physics step with a cold probe (replaces pallas_step.py::
// _build_pallas_step): the same body at T = 1, sizes.cold = 1, one warp. Kept
// as its own kernel so that its launches are counted apart from the rollout's.
template <typename T, bool JG>
__global__ void __launch_bounds__(32) physics_step_kernel(JtSizes s, const int* mi, const T* mf, const T* qpos,
                                                          const T* qvel, const T* ctrl, const T* f, T* oq, T* ov,
                                                          T* os, T* of, T* jslab) {
  jt::rollout<T, JG, jt::Warp>(s, mi, mf, qpos, qvel, ctrl, f, oq, ov, os, of, jslab, jt::rollout_smem<T>(),
                               blockIdx.x);
}

template <typename T, bool JG>
static Kernel<T> rollout_kernel(int warps) {
  switch (warps) {
    case 1: return fused_rollout_kernel<T, JG, 1>;
    case 4: return rollout_kernel_at<T, JG, 4>();
    default: return nullptr;
  }
}

// The kernel of a launch, or null for a W with no build (or W > 1 with cold).
template <typename T>
static Kernel<T> kernel_for(int cold, int jglobal, int warps) {
  if (cold) {
    if (warps != 1) return nullptr;
    return jglobal ? physics_step_kernel<T, true> : physics_step_kernel<T, false>;
  }
  return jglobal ? rollout_kernel<T, true>(warps) : rollout_kernel<T, false>(warps);
}

template <typename T>
static int launch(const JtSizes* s, int warps, const int* mi, const T* mf, const T* qpos0, const T* qvel0,
                  const T* ctrl, const T* f0, T* oq, T* ov, T* os, T* of0, T* jslab, void* stream) {
  const Kernel<T> k = kernel_for<T>(s->cold, s->jglobal, warps);
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  const int bytes = (int)(jt::make_scratch(*s).total * (int64_t)sizeof(T));
  const cudaError_t e = jt::allow_smem(k, bytes);
  if (e != cudaSuccess) return (int)e;
  k<<<s->B, warps * jt::Warp::kLanes, bytes, (cudaStream_t)stream>>>(*s, mi, mf, qpos0, qvel0, ctrl, f0, oq, ov,
                                                                        os, of0, jslab);
  return (int)cudaGetLastError();
}

template <typename T>
static int blocks_per_sm(int cold, int jglobal, int warps, int bytes, int* blocks) {
  const Kernel<T> k = kernel_for<T>(cold, jglobal, warps);
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  const cudaError_t e = jt::allow_smem(k, bytes);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, k, warps * jt::Warp::kLanes, bytes);
}

extern "C" {

long long jt_scratch_per_lane(const JtSizes* s) { return (long long)jt::make_scratch(*s).total; }

long long jt_jslab_per_lane(const JtSizes* s) { return (long long)jt::make_scratch(*s).jsize; }

void jt_model_sizes(const JtSizes* s, int* nint, int* nflt) {
  const jt::Layout L = jt::make_layout(*s);
  *nint = L.nint;
  *nflt = L.nflt;
}

// The rollout in blocks of `warps` warps (the physics step kernel: 1). W is an
// argument beside the sizes, not a field of JtSizes: the step body copies the
// sizes into each rollout's context, and one field more there changed nvcc's
// code for K2 and K2's float32 result (chip_profile.py bitwise).
int jt_fused_rollout_f32(const JtSizes* s, int warps, const int* mi, const float* mf, const float* qpos0,
                         const float* qvel0, const float* ctrl, const float* f0, float* oq, float* ov, float* os,
                         float* of0, float* jslab, void* stream) {
  return launch<float>(s, warps, mi, mf, qpos0, qvel0, ctrl, f0, oq, ov, os, of0, jslab, stream);
}

int jt_fused_rollout_f64(const JtSizes* s, int warps, const int* mi, const double* mf, const double* qpos0,
                         const double* qvel0, const double* ctrl, const double* f0, double* oq, double* ov,
                         double* os, double* of0, double* jslab, void* stream) {
  return launch<double>(s, warps, mi, mf, qpos0, qvel0, ctrl, f0, oq, ov, os, of0, jslab, stream);
}

// Resident blocks per SM of the rollout kernel (cold: the single-step one;
// jglobal: the build with J in global memory) in blocks of `warps` warps at
// `bytes` of dynamic shared memory per block.
int jt_rollout_blocks_per_sm(int cold, int jglobal, int f64, int warps, int bytes, int* blocks) {
  return f64 ? blocks_per_sm<double>(cold, jglobal, warps, bytes, blocks)
             : blocks_per_sm<float>(cold, jglobal, warps, bytes, blocks);
}

// The current device's opt-in limit of shared memory per block, in bytes.
int jt_smem_optin(int* bytes) {
  int dev = 0;
  const cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}

const char* jt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }
}
