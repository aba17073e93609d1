// The FGP body shared by csrc/fgp_tiles.cu and csrc/fgp_resident.cu: one
// iteration of one warp's band of rows, walked down column by column.
//
//   w  = v - lam * div(r, s)        div: backward differences
//   g  = grad(w)                    grad: forward differences
//   p+ = proj(r - step*gx), q+ = proj(s - step*gy)   (L2 ball or box)
//   r+ = p+ + gamma*(p+ - p),  s+ = q+ + gamma*(q+ - q)
//
// Each lane owns one column and walks down rows [a, end): w of the next
// row and r, s of the current one stay in registers; s of the left column
// and w of the right one come by warp shuffles.  A warp's lanes 0..31 sit
// on columns 30g-1 .. 30g+30 and lanes 1..30 own theirs, so lane 0 only
// supplies s to lane 1 and lane 31 only w to lane 30: no lane needs a value
// of another warp within an iteration.  r and s are read from one copy and
// written to the other, p and q in place by their own lane.  The caller
// passes the row above the band and the row below it (in a neighbour's
// shared memory for the whole-image kernel), so every other access is a
// plain shared-memory one, and the restrict-qualified fields let the
// compiler load later rows before it stores earlier ones.
//
// Bitwise the plain loop (ops/tv_cuda.py fgp_plain) when built with
// -fmad=false: every expression keeps its operation order, sqrt and / are
// correctly rounded, max and clip are NaN-keeping conditionals, and masks
// select, never multiply.

#pragma once

#include <cfloat>

namespace fgp {

constexpr int kLanes = 30;  // columns a warp owns (lanes 1..30)

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

// 1 / (8 * max(lam, tiny)); a NaN lam stays NaN.
template <typename T>
__device__ __forceinline__ T step_of(T lam) {
  const T tiny = tiny_of(lam);
  const T safe = lam < tiny ? tiny : lam;
  return T(1) / (T(8) * safe);
}

// p / max(1, nrm), the division skipped where it is by 1: x / 1 == x
// exactly (also +-0, +-inf, NaN), and a NaN nrm fails nrm < 1 and divides,
// as max(1, NaN) = NaN does.
template <bool kIso, typename T>
__device__ __forceinline__ void project(T& p, T& q) {
  if constexpr (kIso) {
    const T nrm = sqrt_(p * p + q * q);
    if (!(nrm < T(1))) {
      p = p / nrm;
      q = q / nrm;
    }
  } else {
    p = p < T(-1) ? T(-1) : (p > T(1) ? T(1) : p);
    q = q < T(-1) ? T(-1) : (q > T(1) ? T(1) : q);
  }
}

// w = v - lam * div(r, s) at one cell, from its r, s, the r above and the
// s on the left; up/left are its masks.
template <typename T>
__device__ __forceinline__ T w_of(T v, T rc, T r_up, T sc, T s_left, bool up,
                                  bool left, T lam) {
  const T dx = up ? rc - r_up : rc;
  const T dy = left ? sc - s_left : sc;
  return v - lam * (dx + dy);
}

// Where a lane sits: its column, the column it loads (clamped into the
// array for the two edge lanes), whether it stores, and its column masks.
struct Lane {
  int cj;
  bool own, left, right;
};

// The lane at column lj of an array `cols` wide whose column 0 is image
// column gc0 (window edges and the image's Neumann boundary both mask).
__device__ __forceinline__ Lane lane_at(int lj, int cols, int gc0, int W) {
  const int lane = static_cast<int>(threadIdx.x & 31);
  const int gj = gc0 + lj;
  Lane l;
  l.cj = lj < 0 ? 0 : (lj >= cols ? cols - 1 : lj);
  l.own = lane >= 1 && lane <= kLanes && lj < cols;
  l.left = gj > 0 && lj > 0;
  l.right = gj < W - 1 && lj < cols - 1;
  return l;
}

// Rows of the band and their masks: row i's image row is gr0 + i; it has a
// neighbour above where gr0 + i > 0 and i > top, below where
// gr0 + i < H - 1 and i < bottom.
struct Rows {
  int a, end, gr0, H, top, bottom;
  __device__ __forceinline__ bool up(int i) const { return gr0 + i > 0 && i > top; }
  __device__ __forceinline__ bool down(int i) const {
    return gr0 + i < H - 1 && i < bottom;
  }
};

template <typename T>
struct Scalars {
  T lam, step, gamma;
};

// Row i's update, given row i + 1's r, s, v; carries r, s, w down a row.
template <typename T, bool kIso>
__device__ __forceinline__ void row_step(
    T& r_i, T& s_i, T& w_i, T r_n, T s_n, T v_n, T po, T qo, bool up_n,
    bool down_i, const Lane& l, const Scalars<T>& k, int c,
    T* __restrict__ p, T* __restrict__ q, T* __restrict__ rn,
    T* __restrict__ sn) {
  const T s_nl = __shfl_up_sync(0xffffffffu, s_n, 1);
  const T w_n = w_of(v_n, r_n, r_i, s_n, s_nl, up_n, l.left, k.lam);
  const T w_r = __shfl_down_sync(0xffffffffu, w_i, 1);
  const T gx = down_i ? w_n - w_i : T(0);
  const T gy = l.right ? w_r - w_i : T(0);
  T pn = r_i - k.step * gx;
  T qn = s_i - k.step * gy;
  project<kIso>(pn, qn);
  if (l.own) {
    p[c] = pn;
    q[c] = qn;
    rn[c] = pn + k.gamma * (pn - po);
    sn[c] = qn + k.gamma * (qn - qo);
  }
  r_i = r_n;
  s_i = s_n;
  w_i = w_n;
}

// One iteration of rows [a, end) (kBandMax >= end - a >= 1) of fields `C`
// cells wide.  r_above: the row above row a (read where row a has a
// neighbour above); r_below, s_below, v_below: the row below row end - 1
// (read where it has one below).
template <typename T, bool kIso, int kBandMax>
__device__ __forceinline__ void walk_band(
    const T* __restrict__ v, T* __restrict__ p, T* __restrict__ q,
    const T* __restrict__ r, const T* __restrict__ s, T* __restrict__ rn,
    T* __restrict__ sn, const T* r_above, const T* r_below, const T* s_below,
    const T* v_below, int C, const Rows& rows, const Lane& l,
    const Scalars<T>& k) {
  const int a = rows.a, cj = l.cj;
  T r_i = r[a * C + cj], s_i = s[a * C + cj];
  T w_i;
  {
    const T s_l = __shfl_up_sync(0xffffffffu, s_i, 1);
    w_i = w_of(v[a * C + cj], r_i, r_above[cj], s_i, s_l, rows.up(a), l.left,
               k.lam);
  }
#pragma unroll
  for (int b = 0; b < kBandMax - 1; ++b) {
    const int i = a + b;
    if (i + 1 >= rows.end) break;
    const int c = i * C + cj, cn = c + C;
    const T po = p[c], qo = q[c];
    row_step<T, kIso>(r_i, s_i, w_i, r[cn], s[cn], v[cn], po, qo,
                      rows.up(i + 1), rows.down(i), l, k, c, p, q, rn, sn);
  }
  const int i = rows.end - 1;
  const int c = i * C + cj;
  const T po = p[c], qo = q[c];
  row_step<T, kIso>(r_i, s_i, w_i, r_below[cj], s_below[cj], v_below[cj], po,
                    qo, rows.up(i + 1), rows.down(i), l, k, c, p, q, rn, sn);
}

}  // namespace fgp
