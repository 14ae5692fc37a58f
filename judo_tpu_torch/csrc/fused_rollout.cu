// Fused T-step rollout of the lanes physics step on an NVIDIA Hopper GPU.
//
// Replaces: judo_tpu/physics/pallas_step.py::_build_fused_rollout (the TPU
// Pallas kernel whose grid (T,) advanced every 128-lane tile one step per grid
// step, carrying qpos, qvel, warm-start forces and the Collatz-Wielandt probe
// in VMEM scratch).
//
// Design: one thread per rollout. The sequential TPU grid over T becomes a
// loop inside the thread; the carried state (qpos, qvel, forces, probe) stays
// in this rollout's slice of the scratch buffer across steps. Global arrays
// are batch-last (element k of rollout b at k * B + b), so the 32 threads of
// a warp read and write 32 neighbouring addresses: the analogue of the
// 128-lane tile. Blocks are one warp, so 320 rollouts occupy 10 SMs.
//
// What bounds it on this card: latency, not bytes. Each rollout is one long
// dependent chain (kinematics -> dynamics -> collision -> assembly -> 8 APGD
// iterations -> integration, times T), and one warp per SM issues roughly one
// instruction per latency period. Measured on leap at 320 rollouts: ~10.8 ms
// per physics step whether the rollouts sit 32, 8 or 1 to an SM, so neither
// cache capacity nor SM count is the limit. The design answers what it can
// without more parallelism: one launch per plan (no launch or host round trip
// inside the horizon), coalesced batch-last scratch, and sums over constraint
// rows kept in registers. Spreading one rollout over a warp (rows of J across
// lanes) is the next step and is listed in ROADMAP.md.
#include <cuda_runtime.h>

#include "jt_step.cuh"

template <typename T>
__global__ void __launch_bounds__(32) fused_rollout_kernel(JtSizes s, const int* mi, const T* mf,
                                                            const T* qpos0, const T* qvel0, const T* ctrl,
                                                            const T* f0, T* oq, T* ov, T* os, T* of0,
                                                            T* scratch) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= s.B) return;
  jt::rollout_lane<T>(s, mi, mf, qpos0, qvel0, ctrl, f0, oq, ov, os, of0, scratch, b);
}

// One physics step with a cold probe (replaces pallas_step.py::
// _build_pallas_step): the same body at T = 1, sizes.cold = 1. Kept as its
// own kernel so that its launches are counted apart from the rollout's.
template <typename T>
__global__ void __launch_bounds__(32) physics_step_kernel(JtSizes s, const int* mi, const T* mf, const T* qpos,
                                                          const T* qvel, const T* ctrl, const T* f, T* oq, T* ov,
                                                          T* os, T* of, T* scratch) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= s.B) return;
  jt::rollout_lane<T>(s, mi, mf, qpos, qvel, ctrl, f, oq, ov, os, of, scratch, b);
}

template <typename T>
static int launch(const JtSizes* s, const int* mi, const T* mf, const T* qpos0, const T* qvel0, const T* ctrl,
                  const T* f0, T* oq, T* ov, T* os, T* of0, T* scratch, void* stream) {
  const int threads = 32;
  const int blocks = (s->B + threads - 1) / threads;
  if (s->cold) {
    physics_step_kernel<T><<<blocks, threads, 0, (cudaStream_t)stream>>>(*s, mi, mf, qpos0, qvel0, ctrl, f0, oq,
                                                                        ov, os, of0, scratch);
  } else {
    fused_rollout_kernel<T><<<blocks, threads, 0, (cudaStream_t)stream>>>(*s, mi, mf, qpos0, qvel0, ctrl, f0, oq,
                                                                         ov, os, of0, scratch);
  }
  return (int)cudaGetLastError();
}

extern "C" {

long long jt_scratch_per_lane(const JtSizes* s) { return (long long)jt::make_scratch(*s).total; }

void jt_model_sizes(const JtSizes* s, int* nint, int* nflt) {
  const jt::Layout L = jt::make_layout(*s);
  *nint = L.nint;
  *nflt = L.nflt;
}

int jt_fused_rollout_f32(const JtSizes* s, const int* mi, const float* mf, const float* qpos0, const float* qvel0,
                         const float* ctrl, const float* f0, float* oq, float* ov, float* os, float* of0,
                         float* scratch, void* stream) {
  return launch<float>(s, mi, mf, qpos0, qvel0, ctrl, f0, oq, ov, os, of0, scratch, stream);
}

int jt_fused_rollout_f64(const JtSizes* s, const int* mi, const double* mf, const double* qpos0,
                         const double* qvel0, const double* ctrl, const double* f0, double* oq, double* ov,
                         double* os, double* of0, double* scratch, void* stream) {
  return launch<double>(s, mi, mf, qpos0, qvel0, ctrl, f0, oq, ov, os, of0, scratch, stream);
}

const char* jt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }
}
