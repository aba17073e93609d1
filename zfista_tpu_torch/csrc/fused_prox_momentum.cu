// Fused FISTA prox-momentum step, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel zfista_tpu/ops/fused.py::_prox_momentum_kernel
// (launched by fused_prox_momentum there).  One pass over n elements:
//
//   z  = y - lr * grad
//   x+ = sign(z) * max(|z| - thresh, 0)          (soft-threshold)
//   y+ = x+ + gamma * (x+ - x)                   (momentum extrapolation)
//
// Bound: HBM bandwidth.  3 reads (y, grad, x) + 2 writes (x+, y+) per
// element = 20 B/elem in float32 (40 B in float64), the roofline minimum
// for this chain; eager PyTorch runs it as ~7 separate elementwise
// launches that re-read and re-write the intermediates.
//
// Design against that bound, and what differs from the TPU kernel:
//  * A grid-stride loop over the flat vector with a bounds check for the
//    ragged tail.  The TPU kernel padded to (8, 128) tiles and cut 512-row
//    VMEM blocks; neither shape means anything here, so nothing is padded
//    or copied.  Neighbouring threads touch neighbouring addresses, so
//    every load and store is coalesced.
//  * lr, thresh and gamma are read from a 3-element DEVICE array, as the
//    TPU kernel read them from SMEM.  They depend on the momentum scalar t,
//    which lives on the device: passing them by value would need a host
//    read (a stream sync) every iteration.
//  * The library is compiled with -fmad=false, so `y - lr*grad` and
//    `x+ + gamma*(x+ - x)` round after each operation, exactly like the
//    plain PyTorch version (zfista_tpu_torch/ops/fused.py); with nvcc's
//    default FMA contraction the two would differ by an ulp.  The chain
//    is bandwidth-bound, so the lost FMAs cost nothing measurable.
//  * sign() is written as torch.sign computes it, (0 < z) - (z < 0), and
//    the max keeps a NaN, as torch.clamp_min does.
//
// The launchers take raw pointers, the element count, the device index and
// the stream (a plain C interface, loaded with ctypes), and return the
// cudaError_t of cudaGetLastError() right after the launch.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// Grid-stride cap: enough resident blocks to saturate HBM on 132 SMs;
// beyond it each thread walks more elements instead.
constexpr int64_t kMaxBlocks = 132 * 16;

__device__ __forceinline__ float abs_(float v) { return fabsf(v); }
__device__ __forceinline__ double abs_(double v) { return fabs(v); }

template <typename T>
__device__ __forceinline__ T soft_threshold(T z, T thresh) {
  const T sgn = T(T(0) < z) - T(z < T(0));
  T r = abs_(z) - thresh;
  r = r < T(0) ? T(0) : r;  // max(r, 0); a NaN fails the test and stays
  return sgn * r;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    prox_momentum_kernel(const T* __restrict__ y, const T* __restrict__ grad,
                         const T* __restrict__ x, const T* __restrict__ scal,
                         T* __restrict__ x_out, T* __restrict__ y_out,
                         int64_t n) {
  const T lr = scal[0];
  const T thresh = scal[1];
  const T gamma = scal[2];
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const T z = y[i] - lr * grad[i];
    const T xn = soft_threshold(z, thresh);
    x_out[i] = xn;
    y_out[i] = xn + gamma * (xn - x[i]);
  }
}

template <typename T>
int launch(const void* y, const void* grad, const void* x, const void* scal,
           void* x_out, void* y_out, int64_t n, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  prox_momentum_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(y), static_cast<const T*>(grad),
      static_cast<const T*>(x), static_cast<const T*>(scal),
      static_cast<T*>(x_out), static_cast<T*>(y_out), n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int zt_prox_momentum_f32(const void* y, const void* grad, const void* x,
                         const void* scal, void* x_out, void* y_out,
                         int64_t n, int device, void* stream) {
  return launch<float>(y, grad, x, scal, x_out, y_out, n, device, stream);
}

int zt_prox_momentum_f64(const void* y, const void* grad, const void* x,
                         const void* scal, void* x_out, void* y_out,
                         int64_t n, int device, void* stream) {
  return launch<double>(y, grad, x, scal, x_out, y_out, n, device, stream);
}

const char* zt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
