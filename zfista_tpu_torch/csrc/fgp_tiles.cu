// FGP dual iterations of the TV prox, temporally blocked over 2-D tiles,
// hand-written for Hopper (sm_90a).
//
// Replaces two TPU kernels of zfista_tpu/ops/tv_pallas.py, both launched by
// fgp_pallas_strips there:
//   * _fgp_strip_kernel            (pipelined=False): zt_fgp_tiles_serial_*
//   * _fgp_strip_kernel_pipelined  (pipelined=True):  zt_fgp_tiles_pipelined_*
// and the XLA pass that recovers u after the sweeps: zt_fgp_recover_u_*.
//
// One FGP iteration, per pixel, with Neumann masks on the IMAGE index:
//   w  = v - lam * div(r, s)        div: backward differences
//   g  = grad(w)                    grad: forward differences
//   p+ = proj(r - step*gx), q+ = proj(s - step*gy)   (L2 ball or box)
//   r+ = p+ + gamma*(p+ - p),  s+ = q+ + gamma*(q+ - q)
// Its dependency radius is one cell in each direction, so a window with an
// 8-cell halo on all four sides, advanced k <= 8 iterations on its own,
// holds the whole-image iterate exactly in its interior (temporal
// blocking).  A sweep advances every tile k iterations and writes only the
// interiors.
//
// Bound: on-chip bandwidth and latency, not HBM.  The plain loop reads and
// writes ~9 full fields per iteration through HBM; a sweep reads 5 windowed
// fields and writes 4 interiors once per 8 iterations.  The 8 iterations
// then run from shared memory, two barriers each.
//
// Design, and what differs from the TPU kernels:
//  * 2-D tiles, not row strips.  A full-width strip of 5-6 fields does not
//    fit the 227 KB a CTA may use at W=1024, and a strip's row halo costs
//    nothing on a TPU's sequential grid but idles SMs here.  The window is
//    64x64 (float32) or 64x32 (float64): six fields of it (v, p, q, r, s
//    and the stencil's w) are 96 KB.  Interior 48x48 or 48x16.
//  * Windows are not clamped inside the image (the TPU kernel slid edge
//    strips inward to keep one static shape): cells outside the image are
//    zero-filled and never read by a cell inside it, so any image shape
//    works, including images smaller than one window.
//  * Trap: boundary masks compare the pixel's image row/column with H and
//    W, never its window index; and they SELECT (a conditional), never
//    multiply, so a value in a cell outside the image cannot leak (0*NaN is
//    NaN).  The window's own edge is masked separately; cells there are in
//    the halo and discarded.
//  * Trap: outputs never alias inputs.  A sweep reads one buffer set and
//    writes the other (the wrapper alternates them), or a later tile's halo
//    would read an earlier tile's new values (Gauss-Seidel contamination).
//  * lam is read from device memory, as the TPU kernel read it from SMEM:
//    in the solver it is a device value, and passing it by value would be a
//    host sync per prox call.  t (data-independent, restarts at 1 on every
//    prox call) arrives by value per sweep, replayed once by the wrapper
//    with the plain loop's own operations, in the field's dtype, on the
//    card (the CPU's float64 sqrt is not correctly rounded; the card's is).
//  * The serial kernel is one CTA per tile: plain loads, compute, store;
//    two CTAs share an SM, so one's loads overlap the other's compute once
//    there is more than one wave of tiles.  The pipelined kernel is
//    persistent (one CTA per SM): it walks tiles and prefetches the next
//    tile's window into a second shared-memory slot with cp.async
//    (zero-fill for cells outside the image) while the current one
//    computes, which pays while the serial kernel's tiles fit one wave
//    (ops/tv_cuda.py choose).  Both call advance_window and
//    store_interior, so they are bitwise equal by construction.
//  * Bitwise equal to the plain loop (zfista_tpu_torch/ops/tv_cuda.py
//    fgp_plain): the library is built with -fmad=false, every expression
//    keeps the plain version's operation order, and sqrt and / are the
//    correctly rounded defaults (no fast math).  max and clip are written
//    as conditionals that keep a NaN, as torch.clamp_min/torch.clamp do.
//
// The launchers take raw pointers, sizes, the device index and the stream
// (a plain C interface, loaded with ctypes), and return the cudaError_t of
// the launch, checked with cudaGetLastError() right after it.

#include <cfloat>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kHalo = 8;  // the most iterations one sweep may advance
// Threads per CTA, measured on an NVIDIA H100 80GB HBM3 at 700 W, 768^2 to
// 4096^2 float32:
// the serial kernel at 512 (two 96 KB CTAs per SM) beat 256 by 1.3x; the
// pipelined kernel at 1024 (one 176 KB CTA per SM) beat 512 by 1.15-1.27x.
// Both fill the SM with 32 warps, which hide the two barriers per
// iteration.
constexpr int kThreads = 512;
constexpr int kPipeThreads = 1024;
constexpr int kRecoverThreads = 256;

template <typename T>
struct Window;
template <>
struct Window<float> {
  static constexpr int kRows = 64, kCols = 64;
};
template <>
struct Window<double> {
  static constexpr int kRows = 64, kCols = 32;
};

__device__ __forceinline__ float sqrt_(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_(double x) { return sqrt(x); }
// torch.finfo(dtype).tiny
__device__ __forceinline__ float tiny_of(float) { return FLT_MIN; }
__device__ __forceinline__ double tiny_of(double) { return DBL_MIN; }

// t_new = 0.5 * (1 + sqrt(1 + 4*t*t)), in the order of zfista_tpu/ops/tv.py.
template <typename T>
__device__ __forceinline__ T t_next(T t) {
  return T(0.5) * (T(1) + sqrt_(T(1) + T(4) * t * t));
}

template <typename T>
__device__ __forceinline__ void project(T& p, T& q, bool iso) {
  if (iso) {
    const T nrm = sqrt_(p * p + q * q);
    const T denom = nrm < T(1) ? T(1) : nrm;  // max(1, nrm); NaN stays
    p = p / denom;
    q = q / denom;
  } else {
    p = p < T(-1) ? T(-1) : (p > T(1) ? T(1) : p);
    q = q < T(-1) ? T(-1) : (q > T(1) ? T(1) : q);
  }
}

// The five carried fields of one window in shared memory.
template <typename T>
struct Fields {
  T* v;
  T* p;
  T* q;
  T* r;
  T* s;
};

template <typename T>
__device__ __forceinline__ Fields<T> fields_at(T* base) {
  constexpr int N = Window<T>::kRows * Window<T>::kCols;
  return Fields<T>{base, base + N, base + 2 * N, base + 3 * N, base + 4 * N};
}

// k FGP iterations on one window whose cell (0, 0) is image pixel
// (gr0, gc0).  w is the stencil's scratch field.  Ends with a barrier.
template <typename T>
__device__ void advance_window(Fields<T> f, T* w, int gr0, int gc0, int H,
                               int W, T lam, T step, T t, int k, bool iso) {
  constexpr int R = Window<T>::kRows, C = Window<T>::kCols, N = R * C;
  for (int it = 0; it < k; ++it) {
    // w = v - lam * div(r, s).  (gi > 0) is the image's Neumann boundary;
    // (li > 0) the window's top edge, where the neighbour is missing.
    for (int c = threadIdx.x; c < N; c += blockDim.x) {
      const int li = c / C, lj = c % C;
      const int gi = gr0 + li, gj = gc0 + lj;
      const T rc = f.r[c], sc = f.s[c];
      const bool up = gi > 0 && li > 0, left = gj > 0 && lj > 0;
      const T dx = up ? rc - f.r[up ? c - C : c] : rc;
      const T dy = left ? sc - f.s[left ? c - 1 : c] : sc;
      w[c] = f.v[c] - lam * (dx + dy);
    }
    __syncthreads();
    const T t_new = t_next(t);
    const T gamma = (t - T(1)) / t_new;
    for (int c = threadIdx.x; c < N; c += blockDim.x) {
      const int li = c / C, lj = c % C;
      const int gi = gr0 + li, gj = gc0 + lj;
      const T wc = w[c];
      const bool down = gi < H - 1 && li < R - 1;
      const bool right = gj < W - 1 && lj < C - 1;
      const T gx = down ? w[down ? c + C : c] - wc : T(0);
      const T gy = right ? w[right ? c + 1 : c] - wc : T(0);
      T pn = f.r[c] - step * gx;
      T qn = f.s[c] - step * gy;
      project(pn, qn, iso);
      const T po = f.p[c], qo = f.q[c];
      f.p[c] = pn;
      f.q[c] = qn;
      f.r[c] = pn + gamma * (pn - po);
      f.s[c] = qn + gamma * (qn - qo);
    }
    __syncthreads();
    t = t_new;
  }
}

// Write the window's interior (the cells a halo of kHalo keeps exact) that
// lies inside the image.
template <typename T>
__device__ void store_interior(Fields<T> f, T* po, T* qo, T* ro, T* so,
                               int gr0, int gc0, int H, int W) {
  constexpr int C = Window<T>::kCols;
  constexpr int IR = Window<T>::kRows - 2 * kHalo, IC = C - 2 * kHalo;
  for (int c = threadIdx.x; c < IR * IC; c += blockDim.x) {
    const int li = kHalo + c / IC, lj = kHalo + c % IC;
    const int gi = gr0 + li, gj = gc0 + lj;
    if (gi < H && gj < W) {
      const int s = li * C + lj;
      const int64_t g = static_cast<int64_t>(gi) * W + gj;
      po[g] = f.p[s];
      qo[g] = f.q[s];
      ro[g] = f.r[s];
      so[g] = f.s[s];
    }
  }
}

template <typename T>
__device__ __forceinline__ void tile_origin(int tile, int tiles_c, int& gr0,
                                            int& gc0) {
  constexpr int IR = Window<T>::kRows - 2 * kHalo;
  constexpr int IC = Window<T>::kCols - 2 * kHalo;
  gr0 = (tile / tiles_c) * IR - kHalo;
  gc0 = (tile % tiles_c) * IC - kHalo;
}

template <typename T>
__device__ __forceinline__ T step_of(T lam) {
  const T tiny = tiny_of(lam);
  const T safe = lam < tiny ? tiny : lam;  // max(lam, tiny); NaN stays
  return T(1) / (T(8) * safe);
}

template <typename T>
struct Src {
  const T* v;
  const T* p;
  const T* q;
  const T* r;
  const T* s;
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    fgp_tiles_serial_kernel(Src<T> src, const T* __restrict__ lam_ptr, T* po,
                            T* qo, T* ro, T* so, T t0, int H, int W, int k,
                            int iso, int tiles_c) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int C = Window<T>::kCols, N = Window<T>::kRows * C;
  T* sm = reinterpret_cast<T*>(smem_raw);
  const Fields<T> f = fields_at(sm);
  T* w = sm + 5 * N;
  int gr0, gc0;
  tile_origin<T>(blockIdx.x, tiles_c, gr0, gc0);
  for (int c = threadIdx.x; c < N; c += blockDim.x) {
    const int gi = gr0 + c / C, gj = gc0 + c % C;
    const bool in = gi >= 0 && gi < H && gj >= 0 && gj < W;
    const int64_t g = in ? static_cast<int64_t>(gi) * W + gj : 0;
    f.v[c] = in ? src.v[g] : T(0);
    f.p[c] = in ? src.p[g] : T(0);
    f.q[c] = in ? src.q[g] : T(0);
    f.r[c] = in ? src.r[g] : T(0);
    f.s[c] = in ? src.s[g] : T(0);
  }
  __syncthreads();
  const T lam = *lam_ptr;
  advance_window(f, w, gr0, gc0, H, W, lam, step_of(lam), t0, k, iso != 0);
  store_interior(f, po, qo, ro, so, gr0, gc0, H, W);
}

// cp.async of one element into shared memory; src_size 0 zero-fills.
template <typename T>
__device__ __forceinline__ void cp_async_elem(T* dst, const T* src, bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = in ? static_cast<int>(sizeof(T)) : 0;
  if constexpr (sizeof(T) == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(n)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
                 "l"(src), "r"(n)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
}

template <typename T>
__device__ void prefetch_window(const Src<T>& src, Fields<T> f, int gr0,
                                int gc0, int H, int W) {
  constexpr int C = Window<T>::kCols, N = Window<T>::kRows * C;
  for (int c = threadIdx.x; c < N; c += blockDim.x) {
    const int gi = gr0 + c / C, gj = gc0 + c % C;
    const bool in = gi >= 0 && gi < H && gj >= 0 && gj < W;
    // Outside the image the source is a valid address that is not read.
    const int64_t g = in ? static_cast<int64_t>(gi) * W + gj : 0;
    cp_async_elem(f.v + c, src.v + g, in);
    cp_async_elem(f.p + c, src.p + g, in);
    cp_async_elem(f.q + c, src.q + g, in);
    cp_async_elem(f.r + c, src.r + g, in);
    cp_async_elem(f.s + c, src.s + g, in);
  }
}

template <typename T>
__global__ void __launch_bounds__(kPipeThreads, 1)
    fgp_tiles_pipelined_kernel(Src<T> src, const T* __restrict__ lam_ptr,
                               T* po, T* qo, T* ro, T* so, T t0, int H, int W,
                               int k, int iso, int tiles_c, int n_tiles) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int N = Window<T>::kRows * Window<T>::kCols;
  T* sm = reinterpret_cast<T*>(smem_raw);
  T* w = sm + 10 * N;
  const T lam = *lam_ptr;
  const T step = step_of(lam);
  int tile = blockIdx.x;
  int cur = 0;
  int gr0, gc0;
  if (tile < n_tiles) {
    tile_origin<T>(tile, tiles_c, gr0, gc0);
    prefetch_window(src, fields_at(sm), gr0, gc0, H, W);
  }
  cp_async_commit();
  for (; tile < n_tiles; tile += gridDim.x) {
    const int next = tile + gridDim.x;
    if (next < n_tiles) {
      int nr0, nc0;
      tile_origin<T>(next, tiles_c, nr0, nc0);
      prefetch_window(src, fields_at(sm + (cur ^ 1) * 5 * N), nr0, nc0, H, W);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this thread's copies into the current slot landed
    __syncthreads();     // ... and every other thread's
    tile_origin<T>(tile, tiles_c, gr0, gc0);
    const Fields<T> f = fields_at(sm + cur * 5 * N);
    advance_window(f, w, gr0, gc0, H, W, lam, step, t0, k, iso != 0);
    store_interior(f, po, qo, ro, so, gr0, gc0, H, W);
    __syncthreads();  // the slot is read out before the next prefetch reuses it
    cur ^= 1;
  }
  cp_async_wait<0>();
}

// u = v - lam * div(p, q), from the final dual (one elementwise pass).
template <typename T>
__global__ void __launch_bounds__(kRecoverThreads)
    fgp_recover_u_kernel(const T* __restrict__ v, const T* __restrict__ p,
                         const T* __restrict__ q,
                         const T* __restrict__ lam_ptr, T* __restrict__ u,
                         int H, int W) {
  const T lam = *lam_ptr;
  const int n = H * W;
  for (int c = blockIdx.x * blockDim.x + threadIdx.x; c < n;
       c += gridDim.x * blockDim.x) {
    const int i = c / W, j = c % W;
    const T pc = p[c], qc = q[c];
    const T dx = i > 0 ? pc - p[i > 0 ? c - W : c] : pc;
    const T dy = j > 0 ? qc - q[j > 0 ? c - 1 : c] : qc;
    u[c] = v[c] - lam * (dx + dy);
  }
}

template <typename T>
int launch_sweep(bool pipelined, const void* v, const void* p, const void* q,
                 const void* r, const void* s, const void* lam, void* po,
                 void* qo, void* ro, void* so, double t0, int H, int W, int k,
                 int iso, int wh, int ww, int device, void* stream) {
  constexpr int R = Window<T>::kRows, C = Window<T>::kCols;
  // The wrapper's tile plan (ops/tv_cuda.py TILE_WINDOW) must be this one.
  if (wh != R || ww != C || k < 1 || k > kHalo || H < 1 || W < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_c = (W + C - 2 * kHalo - 1) / (C - 2 * kHalo);
  const int tiles_r = (H + R - 2 * kHalo - 1) / (R - 2 * kHalo);
  const int n_tiles = tiles_r * tiles_c;
  const Src<T> src{static_cast<const T*>(v), static_cast<const T*>(p),
                   static_cast<const T*>(q), static_cast<const T*>(r),
                   static_cast<const T*>(s)};
  const T* lam_t = static_cast<const T*>(lam);
  auto st = static_cast<cudaStream_t>(stream);
  if (!pipelined) {
    const size_t smem = 6 * sizeof(T) * R * C;
    err = cudaFuncSetAttribute(fgp_tiles_serial_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    fgp_tiles_serial_kernel<T><<<n_tiles, kThreads, smem, st>>>(
        src, lam_t, static_cast<T*>(po), static_cast<T*>(qo),
        static_cast<T*>(ro), static_cast<T*>(so), static_cast<T>(t0), H, W, k,
        iso, tiles_c);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = 11 * sizeof(T) * R * C;
  err = cudaFuncSetAttribute(fgp_tiles_pipelined_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, fgp_tiles_pipelined_kernel<T>, kPipeThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int grid = per_sm * sms;
  if (grid > n_tiles) grid = n_tiles;
  if (grid < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  fgp_tiles_pipelined_kernel<T><<<grid, kPipeThreads, smem, st>>>(
      src, lam_t, static_cast<T*>(po), static_cast<T*>(qo),
      static_cast<T*>(ro), static_cast<T*>(so), static_cast<T>(t0), H, W, k,
      iso, tiles_c, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_recover_u(const void* v, const void* p, const void* q,
                     const void* lam, void* u, int H, int W, int device,
                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = H * W;
  // One thread per cell: the wrapper caps n below 2**30, so the grid stays
  // far under its 2**31 - 1 limit.
  const int blocks = (n + kRecoverThreads - 1) / kRecoverThreads;
  if (blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  fgp_recover_u_kernel<T><<<blocks, kRecoverThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(v), static_cast<const T*>(p),
      static_cast<const T*>(q), static_cast<const T*>(lam),
      static_cast<T*>(u), H, W);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

#define ZT_SWEEP(NAME, T, PIPE)                                              \
  int NAME(const void* v, const void* p, const void* q, const void* r,       \
           const void* s, const void* lam, void* po, void* qo, void* ro,     \
           void* so, double t0, int H, int W, int k, int iso, int wh,        \
           int ww, int device, void* stream) {                               \
    return launch_sweep<T>(PIPE, v, p, q, r, s, lam, po, qo, ro, so, t0, H, \
                           W, k, iso, wh, ww, device, stream);               \
  }

ZT_SWEEP(zt_fgp_tiles_serial_f32, float, false)
ZT_SWEEP(zt_fgp_tiles_serial_f64, double, false)
ZT_SWEEP(zt_fgp_tiles_pipelined_f32, float, true)
ZT_SWEEP(zt_fgp_tiles_pipelined_f64, double, true)

#undef ZT_SWEEP

int zt_fgp_recover_u_f32(const void* v, const void* p, const void* q,
                         const void* lam, void* u, int H, int W, int device,
                         void* stream) {
  return launch_recover_u<float>(v, p, q, lam, u, H, W, device, stream);
}

int zt_fgp_recover_u_f64(const void* v, const void* p, const void* q,
                         const void* lam, void* u, int H, int W, int device,
                         void* stream) {
  return launch_recover_u<double>(v, p, q, lam, u, H, W, device, stream);
}

const char* zt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
