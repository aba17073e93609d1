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
// Bound: a prox call must read v, p0, q0 and write u, p, q once (6 fields:
// 100.7 MB at 2048^2 float32, 30 us at 3.35 TB/s) and do 24 operations per
// cell-iteration (3.0 GFLOP at 2048^2 and 30 iterations, 45 us at
// 67 TFLOP/s).  A sweep touches HBM once per 8 iterations, so the kernel is
// bound on the SM: instructions issued per cell-iteration, shared-memory
// accesses and barriers, times the halo's redundant cells.
//
// Design, and what it does about that:
//  * Column walk.  Each lane owns one column of the window and walks down
//    a band of rows.  w of the next row and r, s of the current one stay
//    in registers; the horizontal neighbours (s of the left column, w of
//    the right one) come by warp shuffles.  Per cell-iteration a lane
//    loads v, p, q, r, s and stores p, q, r, s: 9 shared-memory accesses,
//    no integer division, one barrier per iteration.
//  * r and s are double-buffered (the window holds v, p, q and two copies
//    of r, s): an iteration reads one copy and writes the other, so a lane
//    at the edge of a band or warp reads its neighbour's OLD values
//    straight from shared memory, and the single __syncthreads() at the
//    end of the iteration is the only synchronization.  p and q are read
//    and written only by their own lane, in place.
//  * Warps overlap by two columns: warp g's lanes 0..31 sit on window
//    columns 30g-1 .. 30g+30 and lanes 1..30 own (store) their columns.
//    Lane 0 only supplies s to lane 1, lane 31 only w to lane 30, so no
//    lane needs a value from another warp within an iteration.  The window
//    is 30*G columns wide.
//  * Windows are 64 x 120 (float32) and 64 x 60 (float64), one CTA per SM:
//    the interior 48 x 104 makes 1.48x the useful cells (the 64 x 64
//    window of the previous design, commit fe08dd6, made 1.78x).
//  * 16-byte loads and stores of the window where every pointer is 16-byte
//    aligned and W is a multiple of 16 bytes (interior origins 104k and
//    window origins 104k - 8 are then aligned too); else one element per
//    thread.
//  * The projection skips the division where nrm < 1: p / max(1, nrm) is
//    p / 1 == p exactly there (also for +-0, +-inf and NaN), and a NaN nrm
//    still divides.
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
//  * The serial kernel is one CTA per tile: load, compute, store.  The
//    pipelined kernel is persistent (one CTA per SM): it walks tiles and
//    prefetches the next tile's window into a second shared-memory slot
//    with cp.async (16 bytes per copy where aligned, as the loads above;
//    zero-fill for cells outside the image) while the current one
//    computes.  Both call advance_window and store_interior, so they are
//    bitwise equal by construction.
//  * What bounds the pipelined kernel on this card is shared memory, not
//    its copies.  Two slots of five fields and one shared second copy of
//    r, s are 12 window fields, so a window has at most 232,448 / 12 bytes
//    per field (a CTA's opt-in limit on an H100): 4,842 float32 cells
//    against the serial kernel's 7,680.  Measured on an H100 (PERF.md,
//    section 6), the walk is 88-92% of a round of tiles, the store 4%, and
//    the prefetch already hides all but 8% of the load; so the design
//    spends the budget on the window's shape.  80 x 60 (float32; 80 x 30
//    float64) is 230,400 bytes: the interior 64 x 44 makes 1.70x the useful
//    cells where 64 x 60 made 1.82x, and it cuts 768^2 into 216 tiles, two
//    rounds of 132 persistent CTAs, where 64 x 60 made 288, three.  Bands
//    of 5 rows keep 32 (16) warps busy: the walk is latency-bound, and a
//    warp's time per iteration grows with its band.
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

#include "fgp_walk.cuh"

namespace {

constexpr int kHalo = 8;  // the most iterations one sweep may advance
constexpr int kRecoverThreads = 256;

// A window: kRows rows, kGroups warp columns of kLanes columns each, bands
// of kBand rows (one warp per band and warp column).
template <typename T, bool kPipelined>
struct Window;
template <>
struct Window<float, false> {
  static constexpr int kRows = 64, kGroups = 4, kBand = 8;
};
template <>
struct Window<double, false> {
  static constexpr int kRows = 64, kGroups = 2, kBand = 8;
};
template <>
struct Window<float, true> {
  static constexpr int kRows = 80, kGroups = 2, kBand = 5;
};
template <>
struct Window<double, true> {
  static constexpr int kRows = 80, kGroups = 1, kBand = 5;
};

template <class Win>
__host__ __device__ constexpr int cols_of() {
  return fgp::kLanes * Win::kGroups;
}
template <class Win>
__host__ __device__ constexpr int cells_of() {
  return Win::kRows * cols_of<Win>();
}
template <class Win>
__host__ __device__ constexpr int threads_of() {
  return 32 * Win::kGroups * (Win::kRows / Win::kBand);
}

// 16 bytes of T.
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  using type = float4;
};
template <>
struct Vec<double> {
  using type = double2;
};
template <typename T>
constexpr int kVec = 16 / static_cast<int>(sizeof(T));

// The carried fields of one window in shared memory: v, p, q, and two
// copies of r and s (iteration it reads copy it & 1 and writes the other).
template <typename T>
struct Fields {
  T* v;
  T* p;
  T* q;
  T* r0;
  T* s0;
  T* r1;
  T* s1;
};

// k FGP iterations on one window whose cell (0, 0) is image pixel
// (gr0, gc0), from copy 0 of r, s; they end in copy k & 1.  Ends with a
// barrier.
template <typename T, class Win, bool kIso>
__device__ void advance_window(Fields<T> f, int gr0, int gc0, int H, int W,
                               T lam, T step, T t, int k) {
  constexpr int R = Win::kRows, C = cols_of<Win>(), B = Win::kBand;
  const int warp = threadIdx.x >> 5;
  const int lj = fgp::kLanes * (warp % Win::kGroups) +
                 static_cast<int>(threadIdx.x & 31) - 1;
  const fgp::Lane l = fgp::lane_at(lj, C, gc0, W);
  const int a = (warp / Win::kGroups) * B;
  // Rows of the band; the window's own top and bottom rows mask too.
  const fgp::Rows rows{a, a + B, gr0, H, 0, R - 1};
  const int above = (a > 0 ? a - 1 : 0) * C;
  const int below = (a + B < R ? a + B : R - 1) * C;
  for (int it = 0; it < k; ++it) {
    const bool odd = it & 1;
    const T* r = odd ? f.r1 : f.r0;
    const T* s = odd ? f.s1 : f.s0;
    T* rn = odd ? f.r0 : f.r1;
    T* sn = odd ? f.s0 : f.s1;
    const T t_new = fgp::t_next(t);
    const fgp::Scalars<T> sc{lam, step, (t - T(1)) / t_new};
    fgp::walk_band<T, kIso, B>(f.v, f.p, f.q, r, s, rn, sn, r + above,
                               r + below, s + below, f.v + below, C, rows, l,
                               sc);
    __syncthreads();
    t = t_new;
  }
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
struct Dst {
  T* p;
  T* q;
  T* r;
  T* s;
};

// Write the window's interior (the cells a halo of kHalo keeps exact) that
// lies inside the image, from copy k & 1 of r, s.  vec: 16-byte stores
// (the caller checked the alignment).
template <typename T, class Win>
__device__ void store_interior(Fields<T> f, Dst<T> d, int k, int gr0, int gc0,
                               int H, int W, bool vec) {
  constexpr int C = cols_of<Win>();
  constexpr int IR = Win::kRows - 2 * kHalo, IC = C - 2 * kHalo;
  const T* fr = (k & 1) ? f.r1 : f.r0;
  const T* fs = (k & 1) ? f.s1 : f.s0;
  if (vec) {
    using V = typename Vec<T>::type;
    constexpr int VC = IC / kVec<T>;
    for (int c = threadIdx.x; c < IR * VC; c += blockDim.x) {
      const int li = kHalo + c / VC, lj = kHalo + (c % VC) * kVec<T>;
      const int gi = gr0 + li, gj = gc0 + lj;
      if (gi < H && gj < W) {
        const int s = li * C + lj;
        const int64_t g = static_cast<int64_t>(gi) * W + gj;
        *reinterpret_cast<V*>(d.p + g) = *reinterpret_cast<const V*>(f.p + s);
        *reinterpret_cast<V*>(d.q + g) = *reinterpret_cast<const V*>(f.q + s);
        *reinterpret_cast<V*>(d.r + g) = *reinterpret_cast<const V*>(fr + s);
        *reinterpret_cast<V*>(d.s + g) = *reinterpret_cast<const V*>(fs + s);
      }
    }
    return;
  }
  for (int c = threadIdx.x; c < IR * IC; c += blockDim.x) {
    const int li = kHalo + c / IC, lj = kHalo + c % IC;
    const int gi = gr0 + li, gj = gc0 + lj;
    if (gi < H && gj < W) {
      const int s = li * C + lj;
      const int64_t g = static_cast<int64_t>(gi) * W + gj;
      d.p[g] = f.p[s];
      d.q[g] = f.q[s];
      d.r[g] = fr[s];
      d.s[g] = fs[s];
    }
  }
}

// Load the window (zero outside the image) into v, p, q and copy 0 of
// r, s.  vec: 16-byte loads (the caller checked the alignment; with
// W and gc0 multiples of kVec, a group of kVec cells lies wholly inside or
// wholly outside the image).
template <typename T, class Win>
__device__ void load_window(const Src<T>& src, Fields<T> f, int gr0, int gc0,
                            int H, int W, bool vec) {
  constexpr int C = cols_of<Win>(), N = cells_of<Win>();
  if (vec) {
    using V = typename Vec<T>::type;
    constexpr int VC = C / kVec<T>;
    const V zero{};
    for (int c = threadIdx.x; c < N / kVec<T>; c += blockDim.x) {
      const int li = c / VC, lj = (c % VC) * kVec<T>;
      const int gi = gr0 + li, gj = gc0 + lj;
      const bool in = gi >= 0 && gi < H && gj >= 0 && gj < W;
      const int64_t g = in ? static_cast<int64_t>(gi) * W + gj : 0;
      const int s = li * C + lj;
      *reinterpret_cast<V*>(f.v + s) = in ? *reinterpret_cast<const V*>(src.v + g) : zero;
      *reinterpret_cast<V*>(f.p + s) = in ? *reinterpret_cast<const V*>(src.p + g) : zero;
      *reinterpret_cast<V*>(f.q + s) = in ? *reinterpret_cast<const V*>(src.q + g) : zero;
      *reinterpret_cast<V*>(f.r0 + s) = in ? *reinterpret_cast<const V*>(src.r + g) : zero;
      *reinterpret_cast<V*>(f.s0 + s) = in ? *reinterpret_cast<const V*>(src.s + g) : zero;
    }
    return;
  }
  for (int c = threadIdx.x; c < N; c += blockDim.x) {
    const int gi = gr0 + c / C, gj = gc0 + c % C;
    const bool in = gi >= 0 && gi < H && gj >= 0 && gj < W;
    const int64_t g = in ? static_cast<int64_t>(gi) * W + gj : 0;
    f.v[c] = in ? src.v[g] : T(0);
    f.p[c] = in ? src.p[g] : T(0);
    f.q[c] = in ? src.q[g] : T(0);
    f.r0[c] = in ? src.r[g] : T(0);
    f.s0[c] = in ? src.s[g] : T(0);
  }
}

template <class Win>
__device__ __forceinline__ void tile_origin(int tile, int tiles_c, int& gr0,
                                            int& gc0) {
  constexpr int IR = Win::kRows - 2 * kHalo;
  constexpr int IC = cols_of<Win>() - 2 * kHalo;
  gr0 = (tile / tiles_c) * IR - kHalo;
  gc0 = (tile % tiles_c) * IC - kHalo;
}

template <typename T, bool kIso>
__global__ void __launch_bounds__(threads_of<Window<T, false>>(), 1)
    fgp_tiles_serial_kernel(Src<T> src, const T* __restrict__ lam_ptr,
                            Dst<T> dst, T t0, int H, int W, int k,
                            int tiles_c, int vec) {
  using Win = Window<T, false>;
  constexpr int N = cells_of<Win>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const Fields<T> f{sm,         sm + N,     sm + 2 * N, sm + 3 * N,
                    sm + 4 * N, sm + 5 * N, sm + 6 * N};
  int gr0, gc0;
  tile_origin<Win>(blockIdx.x, tiles_c, gr0, gc0);
  load_window<T, Win>(src, f, gr0, gc0, H, W, vec != 0);
  __syncthreads();
  const T lam = *lam_ptr;
  advance_window<T, Win, kIso>(f, gr0, gc0, H, W, lam, fgp::step_of(lam), t0, k);
  store_interior<T, Win>(f, dst, k, gr0, gc0, H, W, vec != 0);
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

// Slot `slot` of the pipelined kernel: five fields of its own (v, p, q and
// copy 0 of r, s) and the second copy of r, s shared by both slots.
template <typename T, class Win>
__device__ __forceinline__ Fields<T> slot_fields(T* sm, int slot) {
  constexpr int N = cells_of<Win>();
  T* b = sm + slot * 5 * N;
  return Fields<T>{b,          b + N,       b + 2 * N,  b + 3 * N,
                   b + 4 * N, sm + 10 * N, sm + 11 * N};
}

// cp.async of 16 bytes into shared memory; src_size 0 zero-fills.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

// Prefetch the window (zero outside the image) into v, p, q and copy 0 of
// r, s.  vec: 16-byte copies, as load_window.
template <typename T, class Win>
__device__ void prefetch_window(const Src<T>& src, Fields<T> f, int gr0,
                                int gc0, int H, int W, bool vec) {
  constexpr int C = cols_of<Win>(), N = cells_of<Win>();
  if (vec) {
    constexpr int VC = C / kVec<T>;
    for (int c = threadIdx.x; c < N / kVec<T>; c += blockDim.x) {
      const int li = c / VC, lj = (c % VC) * kVec<T>;
      const int gi = gr0 + li, gj = gc0 + lj;
      const bool in = gi >= 0 && gi < H && gj >= 0 && gj < W;
      // Outside the image the source is a valid address that is not read.
      const int64_t g = in ? static_cast<int64_t>(gi) * W + gj : 0;
      const int s = li * C + lj;
      cp_async_16(f.v + s, src.v + g, in);
      cp_async_16(f.p + s, src.p + g, in);
      cp_async_16(f.q + s, src.q + g, in);
      cp_async_16(f.r0 + s, src.r + g, in);
      cp_async_16(f.s0 + s, src.s + g, in);
    }
    return;
  }
  for (int c = threadIdx.x; c < N; c += blockDim.x) {
    const int gi = gr0 + c / C, gj = gc0 + c % C;
    const bool in = gi >= 0 && gi < H && gj >= 0 && gj < W;
    // Outside the image the source is a valid address that is not read.
    const int64_t g = in ? static_cast<int64_t>(gi) * W + gj : 0;
    cp_async_elem(f.v + c, src.v + g, in);
    cp_async_elem(f.p + c, src.p + g, in);
    cp_async_elem(f.q + c, src.q + g, in);
    cp_async_elem(f.r0 + c, src.r + g, in);
    cp_async_elem(f.s0 + c, src.s + g, in);
  }
}

template <typename T, bool kIso>
__global__ void __launch_bounds__(threads_of<Window<T, true>>(), 1)
    fgp_tiles_pipelined_kernel(Src<T> src, const T* __restrict__ lam_ptr,
                               Dst<T> dst, T t0, int H, int W, int k,
                               int tiles_c, int n_tiles, int vec) {
  using Win = Window<T, true>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const T lam = *lam_ptr;
  const T step = fgp::step_of(lam);
  int tile = blockIdx.x;
  int cur = 0;
  int gr0, gc0;
  if (tile < n_tiles) {
    tile_origin<Win>(tile, tiles_c, gr0, gc0);
    prefetch_window<T, Win>(src, slot_fields<T, Win>(sm, 0), gr0, gc0, H, W,
                            vec != 0);
  }
  cp_async_commit();
  for (; tile < n_tiles; tile += gridDim.x) {
    const int next = tile + gridDim.x;
    if (next < n_tiles) {
      int nr0, nc0;
      tile_origin<Win>(next, tiles_c, nr0, nc0);
      prefetch_window<T, Win>(src, slot_fields<T, Win>(sm, cur ^ 1), nr0, nc0,
                              H, W, vec != 0);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this thread's copies into the current slot landed
    __syncthreads();     // ... and every other thread's
    tile_origin<Win>(tile, tiles_c, gr0, gc0);
    const Fields<T> f = slot_fields<T, Win>(sm, cur);
    advance_window<T, Win, kIso>(f, gr0, gc0, H, W, lam, step, t0, k);
    store_interior<T, Win>(f, dst, k, gr0, gc0, H, W, vec != 0);
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

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename T, bool kPipelined, bool kIso>
int launch_sweep(const Src<T>& src, const T* lam, const Dst<T>& dst, T t0,
                 int H, int W, int k, int tiles_c, int n_tiles, int vec,
                 int device, cudaStream_t st) {
  using Win = Window<T, kPipelined>;
  constexpr int N = cells_of<Win>(), threads = threads_of<Win>();
  if (!kPipelined) {
    const size_t smem = 7 * sizeof(T) * N;
    cudaError_t err = cudaFuncSetAttribute(
        fgp_tiles_serial_kernel<T, kIso>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    fgp_tiles_serial_kernel<T, kIso><<<n_tiles, threads, smem, st>>>(
        src, lam, dst, t0, H, W, k, tiles_c, vec);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = 12 * sizeof(T) * N;
  cudaError_t err = cudaFuncSetAttribute(
      fgp_tiles_pipelined_kernel<T, kIso>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, fgp_tiles_pipelined_kernel<T, kIso>, threads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int grid = per_sm * sms;
  if (grid > n_tiles) grid = n_tiles;
  if (grid < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  fgp_tiles_pipelined_kernel<T, kIso><<<grid, threads, smem, st>>>(
      src, lam, dst, t0, H, W, k, tiles_c, n_tiles, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(bool pipelined, const void* v, const void* p, const void* q,
           const void* r, const void* s, const void* lam, void* po, void* qo,
           void* ro, void* so, double t0, int H, int W, int k, int iso, int wh,
           int ww, int device, void* stream) {
  // The wrapper's tile plan (ops/tv_cuda.py TILE_WINDOW, PIPELINED_WINDOW)
  // must be this one.
  const int R = pipelined ? Window<T, true>::kRows : Window<T, false>::kRows;
  const int C = pipelined ? cols_of<Window<T, true>>()
                          : cols_of<Window<T, false>>();
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
  const Dst<T> dst{static_cast<T*>(po), static_cast<T*>(qo),
                   static_cast<T*>(ro), static_cast<T*>(so)};
  const int vec = W % kVec<T> == 0 && aligned16(v) && aligned16(p) &&
                  aligned16(q) && aligned16(r) && aligned16(s) &&
                  aligned16(po) && aligned16(qo) && aligned16(ro) &&
                  aligned16(so);
  const T* lam_t = static_cast<const T*>(lam);
  const T t = static_cast<T>(t0);
  auto st = static_cast<cudaStream_t>(stream);
  if (pipelined) {
    return iso ? launch_sweep<T, true, true>(src, lam_t, dst, t, H, W, k,
                                             tiles_c, n_tiles, vec, device, st)
               : launch_sweep<T, true, false>(src, lam_t, dst, t, H, W, k,
                                              tiles_c, n_tiles, vec, device,
                                              st);
  }
  return iso ? launch_sweep<T, false, true>(src, lam_t, dst, t, H, W, k,
                                            tiles_c, n_tiles, vec, device, st)
             : launch_sweep<T, false, false>(src, lam_t, dst, t, H, W, k,
                                             tiles_c, n_tiles, vec, device,
                                             st);
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
    return launch<T>(PIPE, v, p, q, r, s, lam, po, qo, ro, so, t0, H, W, k, \
                     iso, wh, ww, device, stream);                           \
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
