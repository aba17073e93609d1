// FGP dual loop of the TV prox in ONE launch, the image resident in the
// SMs' shared memory, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel zfista_tpu/ops/tv_pallas.py::_fgp_kernel
// (launched by fgp_pallas there): all n_iter iterations of
//   w  = v - lam * div(r, s)        div: backward differences
//   g  = grad(w)                    grad: forward differences
//   p+ = proj(r - step*gx), q+ = proj(s - step*gy)   (L2 ball or box)
//   r+ = p+ + gamma*(p+ - p),  s+ = q+ + gamma*(q+ - q)
// then u = v - lam * div(p, q).
//
// Bound: a call must read v, p0, q0 and write u, p, q once (6 fields,
// 1.57 MB at 256^2 float32: 0.47 us at 3.35 TB/s) and do 24 operations per
// cell-iteration (47.2 MFLOP at 256^2 and 30 iterations: 0.70 us at
// 67 TFLOP/s).  The TPU kernel's point is that the fields never leave the
// chip between iterations.  What bounds this kernel is the latency of one
// iteration: the grid-wide barrier, the exchange of the bands' edge rows
// and the walk down a band.
//
// Design, and what it does about that:
//  * Row bands over every SM: CTA b holds image rows [b*rows, (b+1)*rows)
//    (rows = ceil(H / SMs): 2 rows of 256 on an H100) of v, p, q and two
//    copies of r, s in shared memory, plus one halo row above and below
//    for v, r and s.  HBM is touched on entry and exit and for the edge
//    rows only; the previous design (commit fe08dd6) kept every field in
//    L2 and read ~13 values per cell-iteration from it.
//  * The body is the column walk of csrc/fgp_walk.cuh (shared with the tile
//    kernels), entirely out of the CTA's own shared memory: a lane owns a
//    column, w and r, s ride down the band in registers, horizontal
//    neighbours come by warp shuffles.
//  * Per iteration: walk, export the band's new first and last rows of r
//    and s to a ping-pong exchange buffer in global memory, one grid.sync()
//    (1.27 us at 256 CTAs on an NVIDIA H100 80GB HBM3 at 700 W, the same
//    barrier the previous design paid; PERF.md), import the neighbours'
//    rows into the halo rows (__ldcg: L2, never a stale L1 line).  The FGP
//    body reaches one row up and one down, so nothing else crosses CTAs.  A cluster of 16 CTAs exchanging by
//    DSMEM syncs faster (0.68 us) but computes on 16 SMs only, and came out
//    slower end to end.
//  * r and s are double-buffered (iteration it reads copy it & 1 and
//    writes the other); p and q are updated in place by their own lane.
//  * The projection skips the division where nrm < 1 (x / 1 == x exactly;
//    a NaN nrm still divides).
//  * Trap: boundary masks are conditionals on the image row/column, never
//    multiplications.
//  * lam is read from device memory (it is a device value in the solver;
//    passing it by value would be a host sync per prox call).  t restarts
//    at 1 on every call and is advanced in registers, in the field's dtype
//    with the plain loop's operations.
//  * Bitwise equal to the plain loop (zfista_tpu_torch/ops/tv_cuda.py
//    fgp_plain): built with -fmad=false, every expression in the plain
//    version's order, correctly rounded sqrt and / (no fast math), max and
//    clip as NaN-keeping conditionals.
//  * The plan is the wrapper's (ops/tv_cuda.py resident_plan), passed in
//    and checked here.  Images whose band does not fit the shared memory of
//    the card being used are refused (cudaErrorInvalidValue);
//    ops/tv_cuda.py fits_resident is the same test, with that card's limit,
//    and choose() sends them to the tile kernels.
//
// Exchange buffer (the wrapper's scratch): [2 copies][CTAs][4 rows][W]:
// the band's first row of r, of s, its last row of r, of s.

#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "fgp_walk.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kFields = 7;    // v, p, q, two copies of r and s
constexpr int kBandMax = 16;  // rows one warp walks, at most
constexpr int kMaxWarps = 32;

template <typename T, bool kIso>
__global__ void __launch_bounds__(32 * kMaxWarps, 1)
    fgp_bands_kernel(const T* __restrict__ v_g, const T* __restrict__ p0,
                     const T* __restrict__ q0, const T* __restrict__ lam_ptr,
                     T* __restrict__ p_out, T* __restrict__ q_out,
                     T* __restrict__ u, T* __restrict__ xchg, int H, int W,
                     int rows, int band, int n_iter) {
  cg::grid_group grid = cg::this_grid();
  const int b = blockIdx.x, nb = gridDim.x;
  const int row0 = b * rows;
  const int here = H - row0 < rows ? H - row0 : rows;
  // Local rows: 0 is the halo row above, 1..here the band, here + 1 the
  // halo row below; N cells per field.
  const int N = (rows + 2) * W;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  T* v = sm;
  T* p = sm + N;
  T* q = sm + 2 * N;
  T* r0 = sm + 3 * N;
  T* s0 = sm + 4 * N;
  T* r1 = sm + 5 * N;
  T* s1 = sm + 6 * N;
  const bool has_up = b > 0, has_dn = b + 1 < nb;
  // Load rows row0 - 1 .. row0 + here of v, and of p0, q0 as r, s (copy 0);
  // p, q for the band's rows.
  {
    const int lo = has_up ? -1 : 0, hi = has_dn ? here + 1 : here;
    for (int c = threadIdx.x; c < (hi - lo) * W; c += blockDim.x) {
      const int li = lo + c / W + 1, j = c % W;
      const int64_t g = static_cast<int64_t>(row0 + li - 1) * W + j;
      const int l = li * W + j;
      v[l] = v_g[g];
      r0[l] = p0[g];
      s0[l] = q0[g];
      if (li >= 1 && li <= here) {
        p[l] = p0[g];
        q[l] = q0[g];
      }
    }
  }
  __syncthreads();

  const T lam = *lam_ptr;
  const T step = fgp::step_of(lam);
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int groups = (W + fgp::kLanes - 1) / fgp::kLanes;
  const int tasks = groups * ((here + band - 1) / band);
  const int64_t xrow = static_cast<int64_t>(W);
  T t = T(1);
  for (int it = 0; it < n_iter; ++it) {
    const int cur = it & 1;
    const T* r = cur ? r1 : r0;
    const T* s = cur ? s1 : s0;
    T* rn = cur ? r0 : r1;
    T* sn = cur ? s0 : s1;
    const T t_new = fgp::t_next(t);
    const fgp::Scalars<T> k{lam, step, (t - T(1)) / t_new};
    for (int task = warp; task < tasks; task += warps) {
      const int lj = fgp::kLanes * (task % groups) +
                     static_cast<int>(threadIdx.x & 31) - 1;
      const fgp::Lane l = fgp::lane_at(lj, W, 0, W);
      const int a = 1 + (task / groups) * band;
      const int end = a + band < here + 1 ? a + band : here + 1;
      // Image row of local row i is row0 - 1 + i; the halo rows hold the
      // neighbours' rows, so only the image's edges mask.
      const fgp::Rows rws{a, end, row0 - 1, H, 0, rows + 2};
      fgp::walk_band<T, kIso, kBandMax>(v, p, q, r, s, rn, sn,
                                        r + (a - 1) * W, r + end * W,
                                        s + end * W, v + end * W, W, rws, l, k);
    }
    __syncthreads();
    // Export the band's new first and last rows; import the neighbours'.
    T* out = xchg + (static_cast<int64_t>(cur ^ 1) * nb + b) * 4 * xrow;
    for (int j = threadIdx.x; j < W; j += blockDim.x) {
      out[j] = rn[W + j];
      out[xrow + j] = sn[W + j];
      out[2 * xrow + j] = rn[here * W + j];
      out[3 * xrow + j] = sn[here * W + j];
    }
    grid.sync();
    const T* in = xchg + static_cast<int64_t>(cur ^ 1) * nb * 4 * xrow;
    for (int j = threadIdx.x; j < W; j += blockDim.x) {
      if (has_up) {
        const T* above = in + static_cast<int64_t>(b - 1) * 4 * xrow;
        rn[j] = __ldcg(above + 2 * xrow + j);
        sn[j] = __ldcg(above + 3 * xrow + j);
      }
      if (has_dn) {
        const T* below = in + static_cast<int64_t>(b + 1) * 4 * xrow;
        rn[(here + 1) * W + j] = __ldcg(below + j);
        sn[(here + 1) * W + j] = __ldcg(below + xrow + j);
      }
    }
    __syncthreads();
    t = t_new;
  }

  // The final dual out, then u = v - lam * div(p, q): the p of the row
  // above the band is the neighbour's, read back from p_out.
  const int64_t base = static_cast<int64_t>(row0) * W;
  for (int c = threadIdx.x; c < here * W; c += blockDim.x) {
    p_out[base + c] = p[W + c];
    q_out[base + c] = q[W + c];
  }
  grid.sync();
  for (int c = threadIdx.x; c < here * W; c += blockDim.x) {
    const int i = c / W, j = c - (c / W) * W;
    const T pc = p[W + c], qc = q[W + c];
    const T p_up = i > 0 ? p[c] : (has_up ? __ldcg(p_out + base + c - W) : pc);
    const T dx = row0 + i > 0 ? pc - p_up : pc;
    const T dy = j > 0 ? qc - q[j > 0 ? W + c - 1 : W + c] : qc;
    u[base + c] = v[W + c] - lam * (dx + dy);
  }
}

// The plan (rows per CTA, CTAs, rows per warp, warps per CTA) is the
// wrapper's, ops/tv_cuda.py resident_plan; here it is only checked: the
// CTAs cover the image, the exchange buffer was sized for `ctas`, and a
// band fits the shared memory of the card being used.
template <typename T, bool kIso>
int launch_iso(const T* v, const T* p0, const T* q0, const T* lam, T* p_out,
               T* q_out, T* u, T* xchg, int H, int W, int n_iter, int rows,
               int ctas, int band, int warps, int device, cudaStream_t st) {
  if (rows < 1 || ctas < 1 || static_cast<int64_t>(rows) * ctas < H ||
      static_cast<int64_t>(rows) * (ctas - 1) >= H || band < 1 ||
      band > kBandMax || warps < 1 || warps > kMaxWarps) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = kFields * sizeof(T) * static_cast<size_t>(rows + 2) * W;
  if (smem > static_cast<size_t>(optin)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = fgp_bands_kernel<T, kIso>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&v,    &p0, &q0, &lam,  &p_out, &q_out, &u,
                  &xchg, &H,  &W,  &rows, &band,  &n_iter};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                    dim3(ctas), dim3(32 * warps), args, smem,
                                    st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* v, const void* p0, const void* q0, const void* lam,
           void* p_out, void* q_out, void* u, void* xchg, int H, int W,
           int n_iter, int iso, int rows, int ctas, int band, int warps,
           int device, void* stream) {
  if (H < 1 || W < 1 || n_iter < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const T* v_ = static_cast<const T*>(v);
  const T* p0_ = static_cast<const T*>(p0);
  const T* q0_ = static_cast<const T*>(q0);
  const T* lam_ = static_cast<const T*>(lam);
  T* p_ = static_cast<T*>(p_out);
  T* q_ = static_cast<T*>(q_out);
  T* u_ = static_cast<T*>(u);
  T* x_ = static_cast<T*>(xchg);
  auto st = static_cast<cudaStream_t>(stream);
  return iso ? launch_iso<T, true>(v_, p0_, q0_, lam_, p_, q_, u_, x_, H, W,
                                   n_iter, rows, ctas, band, warps, device, st)
             : launch_iso<T, false>(v_, p0_, q0_, lam_, p_, q_, u_, x_, H, W,
                                    n_iter, rows, ctas, band, warps, device,
                                    st);
}

}  // namespace

extern "C" {

int zt_fgp_resident_f32(const void* v, const void* p0, const void* q0,
                        const void* lam, void* p_out, void* q_out, void* u,
                        void* xchg, int H, int W, int n_iter, int iso,
                        int rows, int ctas, int band, int warps, int device,
                        void* stream) {
  return launch<float>(v, p0, q0, lam, p_out, q_out, u, xchg, H, W, n_iter,
                       iso, rows, ctas, band, warps, device, stream);
}

int zt_fgp_resident_f64(const void* v, const void* p0, const void* q0,
                        const void* lam, void* p_out, void* q_out, void* u,
                        void* xchg, int H, int W, int n_iter, int iso,
                        int rows, int ctas, int band, int warps, int device,
                        void* stream) {
  return launch<double>(v, p0, q0, lam, p_out, q_out, u, xchg, H, W, n_iter,
                        iso, rows, ctas, band, warps, device, stream);
}

const char* zt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
