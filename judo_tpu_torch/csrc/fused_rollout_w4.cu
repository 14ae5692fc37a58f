// The rollout kernel K1 at 4 warps per rollout (fused_rollout.cuh), built
// apart from fused_rollout.cu so that nvcc compiles the two side by side.
#include "fused_rollout.cuh"

template <typename T, bool JG, int W>
Kernel<T> rollout_kernel_at() {
  return fused_rollout_kernel<T, JG, W>;
}

template Kernel<float> rollout_kernel_at<float, false, 4>();
template Kernel<float> rollout_kernel_at<float, true, 4>();
template Kernel<double> rollout_kernel_at<double, false, 4>();
template Kernel<double> rollout_kernel_at<double, true, 4>();
