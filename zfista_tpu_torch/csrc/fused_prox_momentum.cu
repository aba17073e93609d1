// The elementwise and scalar tail of a fixed-step FISTA iteration on LASSO,
// hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel zfista_tpu/ops/fused.py::_prox_momentum_kernel
// (launched by fused_prox_momentum there, and through it by
// fista_step_dense_pallas).  Per element:
//
//   z  = y - lr * grad
//   x+ = sign(z) * max(|z| - thresh, 0)          (soft-threshold)
//   y+ = x+ + gamma * (x+ - x)                   (momentum extrapolation)
//
// Bound: HBM bandwidth.  3 reads (y, grad, x) + 2 writes (x+, y+) per
// element = 20 B/elem in float32 (40 B in float64): 0.06 us at the LASSO
// slice's n = 10^4 on an H100's 3.35 TB/s.  At that size nothing the
// kernel does inside a launch matters; what the card loses is LAUNCHES.
// On the TPU, XLA fused the scalars around this chain (the momentum
// recursion, the convergence test, the counters, the chunk loop's masks)
// into the step's one program.  Eager PyTorch runs each as a launch of
// its own on a 0-d tensor: over thirty of them around this kernel in the
// solver's step, eight in the raw dense step, and the card idles while
// the host launches them.  So the design for this card takes the whole
// tail into the one launch.  Three entries share the elementwise body:
//
//  * zt_prox_momentum_*: the TPU kernel's own signature, (lr, thresh,
//    gamma) given.  Each scalar is read through its own device pointer, as
//    the TPU kernel read them from SMEM: they depend on the momentum
//    scalar t, which lives on the device, and passing them by value would
//    be a host read (a stream sync) per iteration; stacking them into one
//    array was a launch per iteration.
//  * zt_fista_tail_*: the raw dense step's tail.  Reads t, lr, lam and
//    computes t+ = sqrt(t*t + 1/4) + 1/2, gamma = (t - 1) / t+ and
//    thresh = lr * lam itself; writes x+, y+, t+.
//  * zt_lasso_step_tail_*: the solver's step tail.  Computes
//    t+ = sqrt(t*t - a*t + b) + 1/2, the grid-wide err = max|x+ - y|,
//    converged = err < tol, the freeze (y and t keep their old values on
//    the converging step), the counters, and the chunk loop's mask: on a state
//    that is not active (converged, failed or at max_iter) every output is
//    a copy of its input.
//
// The grid-wide max without a second launch or a grid barrier: y+ is
// written speculatively; every block folds its max into one device word
// with atomicMax on the value's bits (non-negative floats order like
// unsigned integers; a NaN is carried as all-ones, above +inf, because
// torch.amax propagates NaN and an integer max would drop it), then takes
// a ticket from a counter.  The block that draws the last ticket has seen
// every block's max: it writes the scalars and, on the converging step
// only (once per solve), overwrites y+ with y.  It also resets the word
// and the counter, so the scratch needs no launch to clear it.  The usual
// step stays at 20 B per element.
//
// Bitwise equal to the plain PyTorch versions
// (zfista_tpu_torch/ops/fused.py) on the card: the library is compiled
// with -fmad=false, so every expression rounds after each operation in
// the plain version's order; sqrt and / are the correctly rounded
// defaults; a, b and tol arrive rounded to the tensor's dtype, as
// PyTorch rounds a Python scalar operand; sign() is written as torch.sign
// computes it, (0 < z) - (z < 0), and the max keeps a NaN, as
// torch.clamp_min does.  max is order-free, so the atomics cost no
// reproducibility.
//
// The launchers take raw pointers, sizes, the device index and the stream
// (a plain C interface, loaded with ctypes), and return the cudaError_t of
// cudaGetLastError() right after the launch.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// Grid-stride cap: enough resident blocks to saturate HBM on 132 SMs;
// beyond it each thread walks more elements instead.
constexpr int64_t kMaxBlocks = 132 * 16;
// The bits that carry "some |x+ - y| was NaN" through the integer max.
constexpr unsigned long long kNanBits = ~0ull;

__device__ __forceinline__ float abs_(float v) { return fabsf(v); }
__device__ __forceinline__ double abs_(double v) { return fabs(v); }
__device__ __forceinline__ float sqrt_(float v) { return sqrtf(v); }
__device__ __forceinline__ double sqrt_(double v) { return sqrt(v); }

// A non-negative value's bits, zero-extended: ordered like the value.
__device__ __forceinline__ unsigned long long bits_of(float v) {
  return __float_as_uint(v);
}
__device__ __forceinline__ unsigned long long bits_of(double v) {
  return static_cast<unsigned long long>(__double_as_longlong(v));
}
__device__ __forceinline__ void value_of(unsigned long long b, float& v) {
  v = b == kNanBits ? __uint_as_float(0x7fc00000u)
                    : __uint_as_float(static_cast<unsigned>(b));
}
__device__ __forceinline__ void value_of(unsigned long long b, double& v) {
  v = __longlong_as_double(
      b == kNanBits ? 0x7ff8000000000000ll : static_cast<long long>(b));
}

template <typename T>
__device__ __forceinline__ T soft_threshold(T z, T thresh) {
  const T sgn = T(T(0) < z) - T(z < T(0));
  T r = abs_(z) - thresh;
  r = r < T(0) ? T(0) : r;  // max(r, 0); a NaN fails the test and stays
  return sgn * r;
}

// The body every entry shares: one element's x+ and y+.
template <typename T>
__device__ __forceinline__ void prox_momentum_at(
    int64_t i, const T* __restrict__ y, const T* __restrict__ grad,
    const T* __restrict__ x, T lr, T thresh, T gamma, T* __restrict__ x_out,
    T* __restrict__ y_out, T& xn, T& yi) {
  yi = y[i];
  const T z = yi - lr * grad[i];
  xn = soft_threshold(z, thresh);
  x_out[i] = xn;
  y_out[i] = xn + gamma * (xn - x[i]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    prox_momentum_kernel(const T* __restrict__ y, const T* __restrict__ grad,
                         const T* __restrict__ x, const T* __restrict__ lr_p,
                         const T* __restrict__ thresh_p,
                         const T* __restrict__ gamma_p, T* __restrict__ x_out,
                         T* __restrict__ y_out, int64_t n) {
  const T lr = *lr_p, thresh = *thresh_p, gamma = *gamma_p;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    T xn, yi;
    prox_momentum_at(i, y, grad, x, lr, thresh, gamma, x_out, y_out, xn, yi);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    fista_tail_kernel(const T* __restrict__ y, const T* __restrict__ grad,
                      const T* __restrict__ x, const T* __restrict__ t_p,
                      const T* __restrict__ lr_p, const T* __restrict__ lam_p,
                      T* __restrict__ x_out, T* __restrict__ y_out,
                      T* __restrict__ t_out, int64_t n) {
  const T t = *t_p, lr = *lr_p;
  const T t_new = sqrt_(t * t + T(0.25)) + T(0.5);
  const T gamma = (t - T(1)) / t_new;
  const T thresh = lr * *lam_p;
  if (blockIdx.x == 0 && threadIdx.x == 0) *t_out = t_new;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    T xn, yi;
    prox_momentum_at(i, y, grad, x, lr, thresh, gamma, x_out, y_out, xn, yi);
  }
}

// The solver's state around the step: what the tail reads and writes.
template <typename T>
struct StepTail {
  const T* y;
  const T* grad;
  const T* x;
  const T* t;
  const T* lr;
  const T* lam;
  const T* err;
  const int32_t* nit;
  const int32_t* nit_internal;
  const uint8_t* converged;  // torch.bool
  const uint8_t* failed;
  T* x_out;
  T* y_out;
  T* t_out;
  T* err_out;
  int32_t* nit_out;
  int32_t* nit_internal_out;
  uint8_t* converged_out;
  // [0]: the max's bits, [1]: blocks arrived.  Zero between launches.
  unsigned long long* scratch;
  T a, b, tol;
  int64_t max_iter;
  int64_t n;
};

template <typename T>
__global__ void __launch_bounds__(kThreads) lasso_step_tail_kernel(StepTail<T> s) {
  __shared__ unsigned long long warp_bits[kWarps];
  __shared__ int overwrite_y;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool lead = blockIdx.x == 0 && threadIdx.x == 0;
  const bool active = !(*s.converged | *s.failed) &&
                      static_cast<int64_t>(*s.nit) < s.max_iter;
  const T t = *s.t;
  if (!active) {
    // The chunk loop's mask: a stopped state passes through, bit for bit.
    for (int64_t i = first; i < s.n; i += stride) {
      s.x_out[i] = s.x[i];
      s.y_out[i] = s.y[i];
    }
    if (lead) {
      *s.t_out = t;
      *s.err_out = *s.err;
      *s.nit_out = *s.nit;
      *s.nit_internal_out = *s.nit_internal;
      *s.converged_out = *s.converged;
    }
    return;
  }
  const T lr = *s.lr;
  const T t_new = sqrt_(t * t - s.a * t + s.b) + T(0.5);
  const T gamma = (t - T(1)) / t_new;
  const T thresh = lr * *s.lam;
  T m = T(0);
  bool nan = false;
  for (int64_t i = first; i < s.n; i += stride) {
    T xn, yi;
    prox_momentum_at(i, s.y, s.grad, s.x, lr, thresh, gamma, s.x_out, s.y_out,
                     xn, yi);
    const T d = abs_(xn - yi);
    nan = nan || d != d;
    m = d > m ? d : m;
  }
  unsigned long long bits = nan ? kNanBits : bits_of(m);
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_xor_sync(0xffffffffu, bits, off);
    bits = o > bits ? o : bits;
  }
  if ((threadIdx.x & 31) == 0) warp_bits[threadIdx.x >> 5] = bits;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) bits = warp_bits[w] > bits ? warp_bits[w] : bits;
    atomicMax(&s.scratch[0], bits);
    // The block's y+ (ordered before this thread by the barrier) and its
    // max must be visible to the block that draws the last ticket, which
    // may overwrite y+: the fence is cumulative, as in a grid barrier.
    __threadfence();
    const unsigned long long ticket = atomicAdd(&s.scratch[1], 1ull);
    int last = ticket == gridDim.x - 1;
    if (last) {
      __threadfence();
      const unsigned long long all = atomicExch(&s.scratch[0], 0ull);
      s.scratch[1] = 0ull;
      T err;
      value_of(all, err);
      const bool conv = err < s.tol;  // a NaN err is not converged
      *s.err_out = err;
      *s.nit_out = *s.nit + 1;
      *s.nit_internal_out = *s.nit_internal + 1;
      *s.converged_out = conv;
      *s.t_out = conv ? t : t_new;  // the converging step keeps y and t
      last = conv;
    }
    overwrite_y = last;
  }
  __syncthreads();
  if (overwrite_y) {
    for (int64_t i = threadIdx.x; i < s.n; i += blockDim.x) s.y_out[i] = s.y[i];
  }
}

unsigned blocks_for(int64_t n) {
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;  // n == 0: one block that finds nothing to do
  return static_cast<unsigned>(blocks);
}

template <typename T>
int launch_prox_momentum(const void* y, const void* grad, const void* x,
                         const void* lr, const void* thresh, const void* gamma,
                         void* x_out, void* y_out, int64_t n, int device,
                         void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  prox_momentum_kernel<T><<<blocks_for(n), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(y), static_cast<const T*>(grad),
      static_cast<const T*>(x), static_cast<const T*>(lr),
      static_cast<const T*>(thresh), static_cast<const T*>(gamma),
      static_cast<T*>(x_out), static_cast<T*>(y_out), n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_fista_tail(const void* y, const void* grad, const void* x,
                      const void* t, const void* lr, const void* lam,
                      void* x_out, void* y_out, void* t_out, int64_t n,
                      int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  fista_tail_kernel<T><<<blocks_for(n), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(y), static_cast<const T*>(grad),
      static_cast<const T*>(x), static_cast<const T*>(t),
      static_cast<const T*>(lr), static_cast<const T*>(lam),
      static_cast<T*>(x_out), static_cast<T*>(y_out), static_cast<T*>(t_out),
      n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_lasso_step_tail(const void* y, const void* grad, const void* x,
                           const void* t, const void* lr, const void* lam,
                           const void* err_in, const void* nit,
                           const void* nit_internal, const void* converged,
                           const void* failed, void* x_out, void* y_out,
                           void* t_out, void* err_out, void* nit_out,
                           void* nit_internal_out, void* converged_out,
                           void* scratch, double a, double b, double tol,
                           int64_t max_iter, int64_t n, int device,
                           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  StepTail<T> s;
  s.y = static_cast<const T*>(y);
  s.grad = static_cast<const T*>(grad);
  s.x = static_cast<const T*>(x);
  s.t = static_cast<const T*>(t);
  s.lr = static_cast<const T*>(lr);
  s.lam = static_cast<const T*>(lam);
  s.err = static_cast<const T*>(err_in);
  s.nit = static_cast<const int32_t*>(nit);
  s.nit_internal = static_cast<const int32_t*>(nit_internal);
  s.converged = static_cast<const uint8_t*>(converged);
  s.failed = static_cast<const uint8_t*>(failed);
  s.x_out = static_cast<T*>(x_out);
  s.y_out = static_cast<T*>(y_out);
  s.t_out = static_cast<T*>(t_out);
  s.err_out = static_cast<T*>(err_out);
  s.nit_out = static_cast<int32_t*>(nit_out);
  s.nit_internal_out = static_cast<int32_t*>(nit_internal_out);
  s.converged_out = static_cast<uint8_t*>(converged_out);
  s.scratch = static_cast<unsigned long long*>(scratch);
  // Rounded to T as PyTorch rounds a Python scalar next to a tensor of T.
  s.a = static_cast<T>(a);
  s.b = static_cast<T>(b);
  s.tol = static_cast<T>(tol);
  s.max_iter = max_iter;
  s.n = n;
  lasso_step_tail_kernel<T><<<blocks_for(n), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

#define ZT_PROX_MOMENTUM(NAME, T)                                           \
  int NAME(const void* y, const void* grad, const void* x, const void* lr,  \
           const void* thresh, const void* gamma, void* x_out, void* y_out, \
           int64_t n, int device, void* stream) {                           \
    return launch_prox_momentum<T>(y, grad, x, lr, thresh, gamma, x_out,    \
                                   y_out, n, device, stream);               \
  }

ZT_PROX_MOMENTUM(zt_prox_momentum_f32, float)
ZT_PROX_MOMENTUM(zt_prox_momentum_f64, double)

#undef ZT_PROX_MOMENTUM

#define ZT_FISTA_TAIL(NAME, T)                                             \
  int NAME(const void* y, const void* grad, const void* x, const void* t,  \
           const void* lr, const void* lam, void* x_out, void* y_out,      \
           void* t_out, int64_t n, int device, void* stream) {             \
    return launch_fista_tail<T>(y, grad, x, t, lr, lam, x_out, y_out,      \
                                t_out, n, device, stream);                 \
  }

ZT_FISTA_TAIL(zt_fista_tail_f32, float)
ZT_FISTA_TAIL(zt_fista_tail_f64, double)

#undef ZT_FISTA_TAIL

#define ZT_LASSO_STEP_TAIL(NAME, T)                                          \
  int NAME(const void* y, const void* grad, const void* x, const void* t,    \
           const void* lr, const void* lam, const void* err,                 \
           const void* nit, const void* nit_internal, const void* converged, \
           const void* failed, void* x_out, void* y_out, void* t_out,        \
           void* err_out, void* nit_out, void* nit_internal_out,             \
           void* converged_out, void* scratch, double a, double b,           \
           double tol, int64_t max_iter, int64_t n, int device,              \
           void* stream) {                                                   \
    return launch_lasso_step_tail<T>(                                        \
        y, grad, x, t, lr, lam, err, nit, nit_internal, converged, failed,   \
        x_out, y_out, t_out, err_out, nit_out, nit_internal_out,             \
        converged_out, scratch, a, b, tol, max_iter, n, device, stream);     \
  }

ZT_LASSO_STEP_TAIL(zt_lasso_step_tail_f32, float)
ZT_LASSO_STEP_TAIL(zt_lasso_step_tail_f64, double)

#undef ZT_LASSO_STEP_TAIL

const char* zt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
