// Native host-side metrics kernels: Pareto non-dominated filtering and
// WFG hypervolume.  The PyTorch port's copy of zfista_tpu/native/metrics.cpp
// (host code: the port never loads the JAX package's object).
//
// The reference delegates these to pymoo (zfista/metrics.py:4-5,42,144);
// the Python rebuild in zfista_tpu_torch/metrics.py is exact but materializes an
// O(N^2) domination matrix — fine for the reference's 100-point fronts,
// hopeless for the framework's 10k-instance multiobjective batches.  These
// kernels are O(N log N) for the bi-objective case (sort + skyline sweep)
// and cache-blocked O(N^2 m) without any N^2 memory otherwise, plus a WFG
// exclusive-hypervolume recursion with a sweep base case for m == 2.
//
// Exposed as a tiny extern "C" ABI loaded via ctypes (this image has no
// pybind11); zfista_tpu_torch/metrics.py falls back to pure numpy when the
// shared object is unavailable.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// Non-dominated mask
// ---------------------------------------------------------------------------

// Bi-objective fast path: sort by (f1 asc, f2 asc); sweep keeping the
// running min of f2.  A point is dominated iff some earlier point in the
// order has f2 strictly lower, or ties on f1 are handled by the strict-
// domination definition (<= everywhere and < somewhere).
void nd_mask_2d(const double* F, int64_t n, uint8_t* out) {
  // NaN rows first: numpy comparisons with NaN are all false, so a NaN
  // row can neither dominate nor be dominated — keep it and exclude it
  // from the sweep.  (Leaving NaN in the sort comparator would violate
  // strict weak ordering: UB.)
  std::vector<int64_t> idx;
  idx.reserve(n);
  for (int64_t a = 0; a < n; ++a) {
    if (std::isnan(F[2 * a]) || std::isnan(F[2 * a + 1])) {
      out[a] = 1;
    } else {
      idx.push_back(a);
    }
  }
  n = static_cast<int64_t>(idx.size());
  std::sort(idx.begin(), idx.end(), [&](int64_t a, int64_t b) {
    if (F[2 * a] != F[2 * b]) return F[2 * a] < F[2 * b];
    return F[2 * a + 1] < F[2 * b + 1];
  });
  double best_f2 = HUGE_VAL;  // min f2 among strictly-smaller-f1 groups
  bool has_prev = false;      // any previous group at all?  (Without this
                              // a first-group point with f2 == +inf would
                              // compare inf >= HUGE_VAL and be dropped
                              // even though nothing dominates it; +inf
                              // objectives are reachable via indicator g.)
  // Points with equal (f1, f2) tie (kept); a point is dominated iff a
  // point with f1 <= its f1 has f2 < its f2, or f1 < its f1 and f2 <= its
  // f2.  Process groups of equal f1 together.
  int64_t i = 0;
  while (i < n) {
    int64_t j = i;
    const double f1 = F[2 * idx[i]];
    // min f2 among strictly-smaller f1 is best_f2 (from previous groups).
    while (j < n && F[2 * idx[j]] == f1) {
      const double f2 = F[2 * idx[j] + 1];
      // dominated if a previous group (f1' < f1) had f2' <= f2, or this
      // group has a member with smaller f2 (strict, since f1 ties).
      bool dom = has_prev && (f2 >= best_f2);
      if (!dom && j > i) {
        // within-group: sorted by f2 asc, so any earlier member has
        // f2 <= ours; strict domination needs f2 < ours.
        dom = F[2 * idx[i] + 1] < f2;
      }
      out[idx[j]] = dom ? 0 : 1;
      ++j;
    }
    // update best_f2 with this group's minimum (its first member).
    const double group_min = F[2 * idx[i] + 1];
    if (!has_prev || group_min < best_f2) best_f2 = group_min;
    has_prev = true;
    i = j;
  }
}

// General m: cache-blocked pairwise without N^2 memory.  For each point i,
// scan candidates; early-exit on first dominator.
void nd_mask_general(const double* F, int64_t n, int64_t m, uint8_t* out) {
  // Pre-sort by sum of objectives: a dominator has sum <= ours, so only
  // points at-or-before OUR TIE BLOCK in this order can dominate — halves
  // work and gives an early-exit order that finds dominators fast.
  // Ties on the sum are real (any +inf coordinate makes both sums +inf;
  // float rounding can also equate a dominating pair's sums), so the
  // scan must include the whole equal-sum block, not just the strict
  // prefix — a dominated point sorted before its dominator within a tie
  // block was previously reported non-dominated.
  //
  // NaN handling (numpy semantics: NaN comparisons are all false, so a
  // NaN row neither dominates nor is dominated): any NaN coordinate
  // makes the row's sum NaN (inf - inf too) — keep those rows, exclude
  // them from the sort (a NaN in the comparator is UB).
  std::vector<double> sums(n, 0.0);
  std::vector<int64_t> idx;
  idx.reserve(n);
  for (int64_t i = 0; i < n; ++i) {
    sums[i] = std::accumulate(F + i * m, F + (i + 1) * m, 0.0);
    if (std::isnan(sums[i])) {
      out[i] = 1;
    } else {
      idx.push_back(i);
    }
  }
  const int64_t nn = static_cast<int64_t>(idx.size());
  std::sort(idx.begin(), idx.end(),
            [&](int64_t a, int64_t b) { return sums[a] < sums[b]; });

  int64_t block_end = 0;  // end (exclusive) of the current equal-sum run
  for (int64_t oi = 0; oi < nn; ++oi) {
    if (oi >= block_end) {
      block_end = oi + 1;
      while (block_end < nn && sums[idx[block_end]] == sums[idx[oi]])
        ++block_end;
    }
    const int64_t i = idx[oi];
    const double* fi = F + i * m;
    bool dominated = false;
    for (int64_t oj = 0; oj < block_end && !dominated; ++oj) {
      if (oj == oi) continue;
      const int64_t j = idx[oj];
      const double* fj = F + j * m;
      bool le = true, lt = false;
      for (int64_t k = 0; k < m; ++k) {
        // !(fj <= fi) rather than (fj > fi): false for NaN coordinates
        // either side, matching numpy's all(fj <= fi) semantics.
        if (!(fj[k] <= fi[k])) {
          le = false;
          break;
        }
        if (fj[k] < fi[k]) lt = true;
      }
      dominated = le && lt;
    }
    out[i] = dominated ? 0 : 1;
  }
}

// ---------------------------------------------------------------------------
// Hypervolume (WFG)
// ---------------------------------------------------------------------------

double hv_2d(std::vector<const double*>& pts, const double* ref) {
  std::sort(pts.begin(), pts.end(),
            [](const double* a, const double* b) { return a[0] < b[0]; });
  double hv = 0.0, prev_f2 = ref[1];
  for (const double* p : pts) {
    if (p[1] < prev_f2) {
      hv += (ref[0] - p[0]) * (prev_f2 - p[1]);
      prev_f2 = p[1];
    }
  }
  return hv;
}

double wfg(std::vector<std::vector<double>>& pts, int64_t m,
           const double* ref);

double exclusive(const std::vector<double>& p,
                 std::vector<std::vector<double>>& rest, int64_t m,
                 const double* ref) {
  double inc = 1.0;
  for (int64_t k = 0; k < m; ++k) inc *= ref[k] - p[k];
  if (rest.empty()) return inc;
  // limit rest by p, prune dominated
  std::vector<std::vector<double>> limited;
  limited.reserve(rest.size());
  for (auto& q : rest) {
    std::vector<double> l(m);
    for (int64_t k = 0; k < m; ++k) l[k] = std::max(q[k], p[k]);
    limited.push_back(std::move(l));
  }
  // prune dominated within limited (small sets; O(n^2 m))
  std::vector<std::vector<double>> pruned;
  for (size_t a = 0; a < limited.size(); ++a) {
    bool dom = false;
    for (size_t b = 0; b < limited.size() && !dom; ++b) {
      if (a == b) continue;
      bool le = true, lt = false;
      for (int64_t k = 0; k < m; ++k) {
        if (limited[b][k] > limited[a][k]) {
          le = false;
          break;
        }
        if (limited[b][k] < limited[a][k]) lt = true;
      }
      // tie-break equal points: keep the first occurrence only
      if (le && !lt && b < a) dom = true;
      if (le && lt) dom = true;
    }
    if (!dom) pruned.push_back(limited[a]);
  }
  return inc - wfg(pruned, m, ref);
}

double wfg(std::vector<std::vector<double>>& pts, int64_t m,
           const double* ref) {
  if (pts.empty()) return 0.0;
  if (m == 2) {
    std::vector<const double*> ps;
    ps.reserve(pts.size());
    for (auto& p : pts) ps.push_back(p.data());
    return hv_2d(ps, ref);
  }
  // sort worst-first on the last objective for better pruning
  std::sort(pts.begin(), pts.end(),
            [m](const std::vector<double>& a, const std::vector<double>& b) {
              return a[m - 1] > b[m - 1];
            });
  double hv = 0.0;
  for (size_t i = 0; i < pts.size(); ++i) {
    std::vector<std::vector<double>> rest(pts.begin() + i + 1, pts.end());
    hv += exclusive(pts[i], rest, m, ref);
  }
  return hv;
}

}  // namespace

extern "C" {

// out[i] = 1 iff row i of F (n x m, row-major, minimization) is on the
// first non-dominated front.  Duplicates all kept (they tie).
void zt_nd_mask(const double* F, int64_t n, int64_t m, uint8_t* out) {
  if (n <= 0) return;
  if (m == 2) {
    nd_mask_2d(F, n, out);
  } else {
    nd_mask_general(F, n, m, out);
  }
}

// Hypervolume of the set of points strictly dominating `ref` (points at or
// beyond ref contribute nothing).  Caller normalizes; no filtering of
// dominated points required (they add zero exclusive volume but cost time,
// so callers should pre-filter with zt_nd_mask).
double zt_hypervolume(const double* P, int64_t n, int64_t m,
                      const double* ref) {
  std::vector<std::vector<double>> pts;
  pts.reserve(n);
  for (int64_t i = 0; i < n; ++i) {
    bool inside = true;
    for (int64_t k = 0; k < m; ++k)
      if (P[i * m + k] >= ref[k]) {
        inside = false;
        break;
      }
    if (inside) pts.emplace_back(P + i * m, P + (i + 1) * m);
  }
  return wfg(pts, m, ref);
}

}  // extern "C"
