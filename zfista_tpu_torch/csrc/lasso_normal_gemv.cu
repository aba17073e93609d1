// The dense LASSO gradient 2 * A^T (A y - b) in one read of A, hand-written
// for Hopper (sm_90a).
//
// No TPU kernel to replace: the JAX package leaves both matrix-vector
// products of the step to XLA, outside any Pallas kernel
// (zfista_tpu/ops/fused.py:144, fista_step_dense_pallas), and the port ran
// them as two cuBLAS GEMVs with two elementwise launches (- b, * 2) between
// and after them.  Added because those two GEMVs are the fixed-step LASSO
// solve's device time.
//
// Bound: HBM bandwidth, A's bytes once.  A is m x n float32 (80 MB at the
// headline's 2000 x 10^4, 23.9 us at an H100's 3.35 TB/s); y, b and the
// gradient add under 0.1 MB.  Two GEMVs read A twice: it exceeds the 50 MB
// L2, so the second product reads it from HBM again.  But the residual
// r_i = A_i . y - b_i needs row i alone, so a block that holds row i on
// chip can reduce its dot product and, from the same registers, add
// r_i * A_i to a partial gradient.  The design:
//
//  * One persistent block per SM (the wrapper launches 132, an H100 SXM's
//    SMs; fewer when m is smaller).  Block p takes rows p, p + 132,
//    p + 264, ...: the blocks sweep A together, a window of consecutive
//    rows at a time, the same way every launch (no work stealing).
//  * Each thread loads its columns of a row straight into registers, four
//    floats a load (one where rows do not start on 16-byte boundaries),
//    streamed (evict first); a row's loads are issued a whole row ahead of
//    their use (two register buffers), so they are in flight while the
//    block reduces the row before, and the row after that is prefetched
//    into the L2 by one bulk prefetch.  On an H100 at 2000 x 10^4 the pass
//    took 26-27 us (3.0-3.1 TB/s) so, 30-32 us without the prefetch, and
//    ~36 us as a ring of TMA bulk copies into shared memory (one a row, 4-8
//    rows in flight), which streamed A at ~2.2 TB/s.
//  * y sits in shared memory; each thread's partial gradient, in registers
//    (kFloats columns, so n <= kMaxN).  A warp butterfly and one
//    __syncthreads a row give every thread r_i; the same registers then
//    take r_i * A_ij.
//  * Each block writes one partial gradient of n floats; a second kernel
//    sums the partials column by column in a fixed order and doubles the
//    sum (exact): 2.5-2.7 us on the H100, ~1.4 of it whatever the count of
//    partials (66 took 2.1 us, 33 took 1.7).  No floating-point atomics
//    anywhere, so a launch is bitwise the next one, eager or replayed in a
//    CUDA graph.
//
// Precision: float32 operands and float32 accumulation, with fused
// multiply-adds written out (__fmaf_rn; the library is built with
// -fmad=false, which keeps the compiler from contracting anything else).
// The sums run in another order than cuBLAS's, so the gradient is not
// cuBLAS's bit for bit; the tests hold it to a float64 gradient.
//
// Both kernel names contain "gemv": they are the step's matrix-vector
// products.
//
// The launcher takes raw pointers, sizes, the device index and the stream
// (a plain C interface, loaded with ctypes), and returns the cudaError_t of
// cudaGetLastError() right after the launches.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
// Floats of a row a thread holds: the widest row is kThreads * kFloats.
constexpr int kFloats = 24;
constexpr int64_t kMaxN = static_cast<int64_t>(kThreads) * kFloats;
// The reduction over partials: a block sums kReduceCols columns, its warps
// each a slice of the partials, then one warp sums the slices in order.
constexpr int kReduceCols = 32;
constexpr int kReduceSlices = 8;

// What a thread loads at once: four floats where every row starts on a
// 16-byte boundary (A aligned, n a multiple of 4), else one.
template <bool kVec>
struct Lane;

template <>
struct Lane<true> {
  using T = float4;
  static constexpr int W = 4;
  static __device__ __forceinline__ float4 zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  static __device__ __forceinline__ float dot(float4 a, float4 y, float acc) {
    acc = __fmaf_rn(a.x, y.x, acc);
    acc = __fmaf_rn(a.y, y.y, acc);
    acc = __fmaf_rn(a.z, y.z, acc);
    return __fmaf_rn(a.w, y.w, acc);
  }
  static __device__ __forceinline__ void axpy(float r, float4 a, float4& g) {
    g.x = __fmaf_rn(r, a.x, g.x);
    g.y = __fmaf_rn(r, a.y, g.y);
    g.z = __fmaf_rn(r, a.z, g.z);
    g.w = __fmaf_rn(r, a.w, g.w);
  }
};

template <>
struct Lane<false> {
  using T = float;
  static constexpr int W = 1;
  static __device__ __forceinline__ float zero() { return 0.f; }
  static __device__ __forceinline__ float dot(float a, float y, float acc) {
    return __fmaf_rn(a, y, acc);
  }
  static __device__ __forceinline__ void axpy(float r, float a, float& g) {
    g = __fmaf_rn(r, a, g);
  }
};

// Thread t's slot k holds the W floats from column (t + k * kThreads) * W.
template <bool kVec>
__device__ __forceinline__ void load_row(const float* __restrict__ row, int n,
                                         typename Lane<kVec>::T (&a)[kFloats / Lane<kVec>::W]) {
  using L = Lane<kVec>;
  const auto* v = reinterpret_cast<const typename L::T*>(row);
#pragma unroll
  for (int k = 0; k < kFloats / L::W; ++k) {
    const int q = threadIdx.x + k * kThreads;
    // Streamed (evict first): A is read once a call and exceeds the L2.
    a[k] = q * L::W < n ? __ldcs(v + q) : L::zero();
  }
}

// Thread 0: have the L2 fetch the row's 16-byte aligned body (the whole
// row where rows start on 16-byte boundaries) ahead of its loads, one bulk
// prefetch (no registers, no completion to wait for).
__device__ __forceinline__ void prefetch_row(const float* row, int n) {
  if (threadIdx.x != 0) return;
  const uintptr_t start = (reinterpret_cast<uintptr_t>(row) + 15) & ~uintptr_t{15};
  const uintptr_t end = reinterpret_cast<uintptr_t>(row + n) & ~uintptr_t{15};
  if (end > start) {
    asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n"
                 :
                 : "l"(start), "r"(static_cast<uint32_t>(end - start))
                 : "memory");
  }
}

// One row: r = A_i . y - b_i over the block (one barrier), then g += r A_i.
// `half` picks the half of warp_dot this row writes: consecutive rows
// alternate, so a row's writes never land where slower threads may still
// be summing the previous row's.
template <bool kVec>
__device__ __forceinline__ void row_step(
    const typename Lane<kVec>::T (&a)[kFloats / Lane<kVec>::W],
    typename Lane<kVec>::T (&g)[kFloats / Lane<kVec>::W], const float* ys,
    float bi, float (*warp_dot)[kWarps], int half) {
  using L = Lane<kVec>;
  const auto* yv = reinterpret_cast<const typename L::T*>(ys);
  float dot = 0.f;
#pragma unroll
  for (int k = 0; k < kFloats / L::W; ++k) {
    // Past n both a and the padded y are zero: the sum is unchanged.
    dot = L::dot(a[k], yv[threadIdx.x + k * kThreads], dot);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    dot += __shfl_xor_sync(0xffffffffu, dot, off);  // every lane: the same sum
  }
  if ((threadIdx.x & 31) == 0) warp_dot[half][threadIdx.x >> 5] = dot;
  __syncthreads();
  float r = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) r += warp_dot[half][w];
  r -= bi;
#pragma unroll
  for (int k = 0; k < kFloats / L::W; ++k) L::axpy(r, a[k], g[k]);
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
    lasso_normal_gemv_kernel(const float* __restrict__ A,
                             const float* __restrict__ b,
                             const float* __restrict__ y,
                             float* __restrict__ partial, int64_t m, int n) {
  using L = Lane<kVec>;
  using T = typename L::T;
  constexpr int kSlots = kFloats / L::W;
  extern __shared__ __align__(16) float ys[];
  __shared__ float warp_dot[2][kWarps];
  // Rows blockIdx.x, + gridDim.x, + 2 gridDim.x, ...: the blocks sweep A
  // together, a window of consecutive rows at a time.
  const int64_t rows = (m - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const float* row0 = A + static_cast<int64_t>(blockIdx.x) * n;
  const int64_t step = static_cast<int64_t>(gridDim.x) * n;
  T g[kSlots], a0[kSlots], a1[kSlots];
  // Two row buffers: each row's loads are issued a whole row ahead of its
  // use, so they are in flight while the block reduces the row before; and
  // the row after that is prefetched into the L2.  The first row's loads
  // go out before y is staged.
  load_row<kVec>(row0, n, a0);
  if (rows > 1) prefetch_row(row0 + step, n);
  float b0 = b[blockIdx.x], b1 = 0.f;
#pragma unroll
  for (int k = 0; k < kSlots; ++k) g[k] = L::zero();
  // y, zero-padded to the threads' last slot.
  for (int c = threadIdx.x; c < kMaxN; c += kThreads) ys[c] = c < n ? y[c] : 0.f;
  __syncthreads();
  for (int64_t j = 0; j < rows; j += 2) {
    if (j + 1 < rows) {
      load_row<kVec>(row0 + (j + 1) * step, n, a1);
      if (j + 2 < rows) prefetch_row(row0 + (j + 2) * step, n);
      b1 = b[blockIdx.x + (j + 1) * gridDim.x];
    }
    row_step<kVec>(a0, g, ys, b0, warp_dot, 0);
    if (j + 1 >= rows) break;
    if (j + 2 < rows) {
      load_row<kVec>(row0 + (j + 2) * step, n, a0);
      if (j + 3 < rows) prefetch_row(row0 + (j + 3) * step, n);
      b0 = b[blockIdx.x + (j + 2) * gridDim.x];
    }
    row_step<kVec>(a1, g, ys, b1, warp_dot, 1);
  }

  T* out = reinterpret_cast<T*>(partial + static_cast<int64_t>(blockIdx.x) * n);
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const int q = threadIdx.x + k * kThreads;
    if (q * L::W < n) out[q] = g[k];
  }
}

// grad_c = 2 * sum over p of partial[p][c], p in order: each warp sums a
// fixed slice of the partials, then the first warp sums the slices in order.
__global__ void __launch_bounds__(kReduceCols * kReduceSlices)
    lasso_normal_gemv_reduce(const float* __restrict__ partial, int parts,
                             int64_t n, float* __restrict__ grad) {
  __shared__ float slice_sum[kReduceSlices][kReduceCols];
  const int tx = threadIdx.x % kReduceCols;
  const int ty = threadIdx.x / kReduceCols;
  const int64_t c = static_cast<int64_t>(blockIdx.x) * kReduceCols + tx;
  const int p0 = ty * parts / kReduceSlices;
  const int p1 = (ty + 1) * parts / kReduceSlices;
  float s = 0.f;
  if (c < n) {
#pragma unroll 4
    for (int p = p0; p < p1; ++p) s += partial[static_cast<int64_t>(p) * n + c];
  }
  slice_sum[ty][tx] = s;
  __syncthreads();
  if (ty == 0 && c < n) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kReduceSlices; ++w) t += slice_sum[w][tx];
    grad[c] = 2.f * t;
  }
}

template <bool kVec>
cudaError_t launch_pass(const void* A, const void* b, const void* y,
                        void* partial, int64_t m, int n, int parts,
                        int device, cudaStream_t s) {
  // y's copy takes 48 KB at the widest row: past the default, so the
  // limit is raised once per device (before any capture: the first launch
  // runs eagerly).
  static bool allowed[64] = {};
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  constexpr int kSmem = static_cast<int>(kMaxN * sizeof(float));
  if (!allowed[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        lasso_normal_gemv_kernel<kVec>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return err;
    allowed[device] = true;
  }
  lasso_normal_gemv_kernel<kVec><<<parts, kThreads, kSmem, s>>>(
      static_cast<const float*>(A), static_cast<const float*>(b),
      static_cast<const float*>(y), static_cast<float*>(partial), m, n);
  return cudaGetLastError();
}

int launch_lasso_normal_gemv(const void* A, const void* b, const void* y,
                             void* partial, void* grad, int64_t m, int64_t n,
                             int parts, int device, void* stream) {
  if (m < 1 || n < 1 || n > kMaxN || parts < 1 || parts > m) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // Four floats a load where every row, and so every partial, starts on a
  // 16-byte boundary.
  const bool vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(A) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(partial) % 16 == 0;
  err = vec ? launch_pass<true>(A, b, y, partial, m, static_cast<int>(n), parts, device, s)
            : launch_pass<false>(A, b, y, partial, m, static_cast<int>(n), parts, device, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>((n + kReduceCols - 1) / kReduceCols);
  lasso_normal_gemv_reduce<<<blocks, kReduceCols * kReduceSlices, 0, s>>>(
      static_cast<const float*>(partial), parts, n, static_cast<float*>(grad));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int zt_lasso_normal_gemv_f32(const void* A, const void* b, const void* y,
                             void* partial, void* grad, int64_t m, int64_t n,
                             int parts, int device, void* stream) {
  return launch_lasso_normal_gemv(A, b, y, partial, grad, m, n, parts, device,
                                  stream);
}

const char* zt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
