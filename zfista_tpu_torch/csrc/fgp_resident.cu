// FGP dual loop of the TV prox in ONE launch, fields resident in L2,
// hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel zfista_tpu/ops/tv_pallas.py::_fgp_kernel
// (launched by fgp_pallas there): all n_iter iterations of
//   w  = v - lam * div(r, s)        div: backward differences
//   g  = grad(w)                    grad: forward differences
//   p+ = proj(r - step*gx), q+ = proj(s - step*gy)   (L2 ball or box)
//   r+ = p+ + gamma*(p+ - p),  s+ = q+ + gamma*(q+ - q)
// then u = v - lam * div(p, q).
//
// Bound: the TPU kernel's point is that the fields never leave the chip
// between iterations (the XLA loop round-trips ~9 fields through HBM per
// iteration).  A CTA's 227 KB of shared memory cannot hold an image, so
// the H100 counterpart keeps the fields in the 50 MB L2: 12 fields of a
// 256x256 float32 image are 3.1 MB.  The wrapper takes this kernel while
// they fit half the L2 (ops/tv_cuda.py fits_l2).  Per iteration a pixel
// reads ~13 values, all L2 hits; the cost is L2 latency and one grid-wide
// barrier per iteration.
//
// Design:
//  * One cooperative launch (cudaLaunchCooperativeKernel; the grid is at
//    most the co-resident CTAs: occupancy x SM count, and no more CTAs
//    than the image needs).  Each iteration reads the old fields and
//    writes new ones into the other buffer set (ping-pong); grid.sync()
//    separates iterations.  A loop of one launch per iteration would be
//    the plain loop's shape with fewer launches: the residency is what the
//    TPU kernel adds, and what this one keeps.
//  * w at (i,j), (i+1,j) and (i,j+1) is recomputed in registers from
//    r, s and v instead of being stored, which saves a second barrier per
//    iteration.  These are the same operations on the same values, so the
//    result is unchanged.
//  * Fields written inside the kernel are read with __ldcg (L2, not L1):
//    an SM's L1 is not coherent with other SMs' writes, so a line cached
//    two iterations ago must never be read back.
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
//
// Buffers: iteration `it` writes set (n_iter-1-it) & 1, so the last one
// writes set 0 = (p_out, q_out, scratch[0], scratch[1]); set 1 is
// scratch[2..5].  The inputs p0, q0 are never written.

#include <cfloat>
#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float sqrt_(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_(double x) { return sqrt(x); }
// torch.finfo(dtype).tiny
__device__ __forceinline__ float tiny_of(float) { return FLT_MIN; }
__device__ __forceinline__ double tiny_of(double) { return DBL_MIN; }

template <typename T>
__device__ __forceinline__ T ld(const T* a, int i) {
  return __ldcg(a + i);
}

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

// w = v - lam * div(r, s) at pixel c = (i, j); Neumann boundary on i, j.
template <typename T>
__device__ __forceinline__ T w_at(const T* v, const T* r, const T* s, T lam,
                                  int c, int i, int j, int W) {
  const T rc = ld(r, c), sc = ld(s, c);
  const T dx = i > 0 ? rc - ld(r, i > 0 ? c - W : c) : rc;
  const T dy = j > 0 ? sc - ld(s, j > 0 ? c - 1 : c) : sc;
  return v[c] - lam * (dx + dy);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    fgp_resident_kernel(const T* __restrict__ v, const T* p0, const T* q0,
                        const T* __restrict__ lam_ptr, T* p_out, T* q_out,
                        T* scratch, T* __restrict__ u, int H, int W,
                        int n_iter, int iso) {
  cg::grid_group grid = cg::this_grid();
  const int n = H * W;
  const int stride = gridDim.x * blockDim.x;
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  const T lam = *lam_ptr;
  const T tiny = tiny_of(lam);
  const T safe = lam < tiny ? tiny : lam;  // max(lam, tiny); NaN stays
  const T step = T(1) / (T(8) * safe);
  T* const sets[2][4] = {
      {p_out, q_out, scratch, scratch + n},
      {scratch + 2 * n, scratch + 3 * n, scratch + 4 * n, scratch + 5 * n}};
  const T* p = p0;
  const T* q = q0;
  const T* r = p0;
  const T* s = q0;
  T t = T(1);
  for (int it = 0; it < n_iter; ++it) {
    T* const* dst = sets[(n_iter - 1 - it) & 1];
    const T t_new = t_next(t);
    const T gamma = (t - T(1)) / t_new;
    for (int c = first; c < n; c += stride) {
      const int i = c / W, j = c % W;
      const T wc = w_at(v, r, s, lam, c, i, j, W);
      const T gx =
          i < H - 1 ? w_at(v, r, s, lam, i < H - 1 ? c + W : c, i + 1, j, W) - wc
                    : T(0);
      const T gy =
          j < W - 1 ? w_at(v, r, s, lam, j < W - 1 ? c + 1 : c, i, j + 1, W) - wc
                    : T(0);
      T pn = ld(r, c) - step * gx;
      T qn = ld(s, c) - step * gy;
      project(pn, qn, iso != 0);
      dst[0][c] = pn;
      dst[1][c] = qn;
      dst[2][c] = pn + gamma * (pn - ld(p, c));
      dst[3][c] = qn + gamma * (qn - ld(q, c));
    }
    grid.sync();
    p = dst[0];
    q = dst[1];
    r = dst[2];
    s = dst[3];
    t = t_new;
  }
  // u = v - lam * div(p, q), from the final dual.
  for (int c = first; c < n; c += stride) {
    const int i = c / W, j = c % W;
    const T pc = ld(p, c), qc = ld(q, c);
    const T dx = i > 0 ? pc - ld(p, i > 0 ? c - W : c) : pc;
    const T dy = j > 0 ? qc - ld(q, j > 0 ? c - 1 : c) : qc;
    u[c] = v[c] - lam * (dx + dy);
    if (n_iter == 0) {  // no iteration ran: the dual is the input's
      p_out[c] = pc;
      q_out[c] = qc;
    }
  }
}

template <typename T>
int launch(const void* v, const void* p0, const void* q0, const void* lam,
           void* p_out, void* q_out, void* scratch, void* u, int H, int W,
           int n_iter, int iso, int device, void* stream) {
  if (H < 1 || W < 1 || n_iter < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, fgp_resident_kernel<T>, kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = H * W;
  int grid = per_sm * sms;
  const int needed = (n + kThreads - 1) / kThreads;
  if (grid > needed) grid = needed;
  if (grid < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const T* v_ = static_cast<const T*>(v);
  const T* p0_ = static_cast<const T*>(p0);
  const T* q0_ = static_cast<const T*>(q0);
  const T* lam_ = static_cast<const T*>(lam);
  T* p_out_ = static_cast<T*>(p_out);
  T* q_out_ = static_cast<T*>(q_out);
  T* scratch_ = static_cast<T*>(scratch);
  T* u_ = static_cast<T*>(u);
  void* args[] = {&v_,     &p0_,       &q0_, &lam_, &p_out_, &q_out_,
                  &scratch_, &u_,      &H,   &W,    &n_iter, &iso};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(fgp_resident_kernel<T>), dim3(grid),
      dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int zt_fgp_resident_f32(const void* v, const void* p0, const void* q0,
                        const void* lam, void* p_out, void* q_out,
                        void* scratch, void* u, int H, int W, int n_iter,
                        int iso, int device, void* stream) {
  return launch<float>(v, p0, q0, lam, p_out, q_out, scratch, u, H, W,
                       n_iter, iso, device, stream);
}

int zt_fgp_resident_f64(const void* v, const void* p0, const void* q0,
                        const void* lam, void* p_out, void* q_out,
                        void* scratch, void* u, int H, int W, int n_iter,
                        int iso, int device, void* stream) {
  return launch<double>(v, p0, q0, lam, p_out, q_out, scratch, u, H, W,
                        n_iter, iso, device, stream);
}

const char* zt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
