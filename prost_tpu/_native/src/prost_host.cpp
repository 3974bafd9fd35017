// prost_tpu native host runtime.
//
// C++ counterpart of the reference's host-side runtime pieces: sparse
// format conversion (csr2csc, /root/reference/src/common.cu:54-82), the
// problem graph-builder validators (CheckDomainProx problem.cu:48-89,
// AddZeroProx problem.cu:93-158, block overlap linearoperator.cu:84-125),
// and multithreaded CSR matvec / row-col sums used for host-side problem
// assembly and preconditioner setup on large sparse operators.
//
// Exposed as a plain C ABI, loaded from Python via ctypes (host.py);
// everything here runs on the host CPU at problem-construction time — the
// device compute path is JAX/XLA.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <numeric>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// COO sorting: fills perm with the permutation that sorts (key1, key2)
// lexicographically.  Used to build the row-sorted (forward) and col-sorted
// (adjoint) copies the sparse blocks keep (analog of the CSR+CSC pair,
// block_sparse.cu:34-67).
// ---------------------------------------------------------------------------
void ph_coo_sort_perm(int64_t nnz, const int32_t* key1, const int32_t* key2,
                      int64_t* perm) {
  std::iota(perm, perm + nnz, int64_t{0});
  std::sort(perm, perm + nnz, [&](int64_t a, int64_t b) {
    if (key1[a] != key1[b]) return key1[a] < key1[b];
    return key2[a] < key2[b];
  });
}

// ---------------------------------------------------------------------------
// CSR from sorted COO rows (counting pass), and CSR -> CSC conversion
// (common.cu:54-82 analog, host-side, counting sort: O(nnz + n)).
// ---------------------------------------------------------------------------
void ph_csr_from_sorted_rows(int64_t nnz, int64_t nrows, const int32_t* rows,
                             int64_t* indptr) {
  std::fill(indptr, indptr + nrows + 1, int64_t{0});
  for (int64_t i = 0; i < nnz; ++i) indptr[rows[i] + 1]++;
  for (int64_t r = 0; r < nrows; ++r) indptr[r + 1] += indptr[r];
}

void ph_csr_to_csc(int64_t nrows, int64_t ncols, int64_t nnz,
                   const int64_t* row_ptr, const int32_t* col_ind,
                   const double* val, int64_t* col_ptr, int32_t* row_ind,
                   double* val_t) {
  std::fill(col_ptr, col_ptr + ncols + 1, int64_t{0});
  for (int64_t i = 0; i < nnz; ++i) col_ptr[col_ind[i] + 1]++;
  for (int64_t c = 0; c < ncols; ++c) col_ptr[c + 1] += col_ptr[c];
  std::vector<int64_t> next(col_ptr, col_ptr + ncols);
  for (int64_t r = 0; r < nrows; ++r) {
    for (int64_t i = row_ptr[r]; i < row_ptr[r + 1]; ++i) {
      int64_t dst = next[col_ind[i]]++;
      row_ind[dst] = static_cast<int32_t>(r);
      val_t[dst] = val[i];
    }
  }
}

// ---------------------------------------------------------------------------
// Prox domain validation (CheckDomainProx): proxs own [index, index+size);
// they must tile [0, total) without overlap.  Returns 0 on success; on
// failure returns 1 (overlap/gap) with the offending pair in err_a/err_b.
// Inputs need not be sorted; sorts a copy internally.
// ---------------------------------------------------------------------------
int32_t ph_check_prox_domain(int64_t n, const int64_t* index,
                             const int64_t* size, int64_t total,
                             int64_t* err_a, int64_t* err_b) {
  if (n == 0) return 0;
  std::vector<int64_t> order(n);
  std::iota(order.begin(), order.end(), int64_t{0});
  std::sort(order.begin(), order.end(),
            [&](int64_t a, int64_t b) { return index[a] < index[b]; });
  if (index[order[0]] != 0) {
    *err_a = order[0];
    *err_b = -1;
    return 1;
  }
  for (int64_t i = 0; i + 1 < n; ++i) {
    int64_t a = order[i], b = order[i + 1];
    if (index[a] + size[a] != index[b]) {
      *err_a = a;
      *err_b = b;
      return 1;
    }
  }
  int64_t last = order[n - 1];
  if (index[last] + size[last] != total) {
    *err_a = last;
    *err_b = -1;
    return 1;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Gap computation (AddZeroProx): given possibly partial coverage, emit the
// uncovered [start, size) ranges.  Returns the number of gaps (<= n + 1);
// gap_start/gap_size must have room for n + 1 entries.  Returns -1 if any
// two ranges overlap.
// ---------------------------------------------------------------------------
int64_t ph_prox_gaps(int64_t n, const int64_t* index, const int64_t* size,
                     int64_t total, int64_t* gap_start, int64_t* gap_size) {
  std::vector<int64_t> order(n);
  std::iota(order.begin(), order.end(), int64_t{0});
  std::sort(order.begin(), order.end(),
            [&](int64_t a, int64_t b) { return index[a] < index[b]; });
  int64_t ngaps = 0, pos = 0;
  for (int64_t i = 0; i < n; ++i) {
    int64_t a = order[i];
    if (index[a] < pos) return -1;  // overlap
    if (index[a] > pos) {
      gap_start[ngaps] = pos;
      gap_size[ngaps] = index[a] - pos;
      ngaps++;
    }
    pos = index[a] + size[a];
  }
  if (pos < total) {
    gap_start[ngaps] = pos;
    gap_size[ngaps] = total - pos;
    ngaps++;
  }
  return ngaps;
}

// ---------------------------------------------------------------------------
// Block overlap validation (linearoperator.cu:31-39, 106-116): rectangles
// (row, col, nrows, ncols) must be pairwise disjoint.  Sweep over sorted
// row intervals: O(n log n + k) instead of the reference's O(n^2) loop.
// Returns 0 if disjoint, else 1 with the offending pair indices.
// ---------------------------------------------------------------------------
int32_t ph_check_block_overlap(int64_t n, const int64_t* row,
                               const int64_t* col, const int64_t* nrows,
                               const int64_t* ncols, int64_t* err_a,
                               int64_t* err_b) {
  std::vector<int64_t> order(n);
  std::iota(order.begin(), order.end(), int64_t{0});
  std::sort(order.begin(), order.end(),
            [&](int64_t a, int64_t b) { return row[a] < row[b]; });
  // active set of blocks whose row interval may still intersect
  std::vector<int64_t> active;
  for (int64_t ii = 0; ii < n; ++ii) {
    int64_t b = order[ii];
    active.erase(std::remove_if(active.begin(), active.end(),
                                [&](int64_t a) {
                                  return row[a] + nrows[a] <= row[b];
                                }),
                 active.end());
    for (int64_t a : active) {
      bool col_hit = col[a] < col[b] + ncols[b] && col[b] < col[a] + ncols[a];
      if (col_hit) {
        *err_a = a;
        *err_b = b;
        return 1;
      }
    }
    active.push_back(b);
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Multithreaded CSR matvec y = A x and row/col alpha-sums
// (sum_j |A_ij|^alpha), for host-side preconditioner assembly and oracle
// checks on large operators.
// ---------------------------------------------------------------------------
static void parallel_for(int64_t n, const std::function<void(int64_t, int64_t)>& fn) {
  unsigned hw = std::thread::hardware_concurrency();
  int64_t nthreads = std::max<int64_t>(1, std::min<int64_t>(hw, n / 4096));
  if (nthreads <= 1) {
    fn(0, n);
    return;
  }
  std::vector<std::thread> threads;
  int64_t chunk = (n + nthreads - 1) / nthreads;
  for (int64_t t = 0; t < nthreads; ++t) {
    int64_t lo = t * chunk, hi = std::min(n, lo + chunk);
    if (lo >= hi) break;
    threads.emplace_back([=, &fn] { fn(lo, hi); });
  }
  for (auto& th : threads) th.join();
}

void ph_csr_matvec(int64_t nrows, const int64_t* indptr, const int32_t* ind,
                   const double* val, const double* x, double* y) {
  parallel_for(nrows, [&](int64_t lo, int64_t hi) {
    for (int64_t r = lo; r < hi; ++r) {
      double acc = 0.0;
      for (int64_t i = indptr[r]; i < indptr[r + 1]; ++i)
        acc += val[i] * x[ind[i]];
      y[r] = acc;
    }
  });
}

void ph_csr_row_alpha_sum(int64_t nrows, const int64_t* indptr,
                          const double* val, double alpha, double* out) {
  parallel_for(nrows, [&](int64_t lo, int64_t hi) {
    for (int64_t r = lo; r < hi; ++r) {
      double acc = 0.0;
      for (int64_t i = indptr[r]; i < indptr[r + 1]; ++i) {
        double a = std::abs(val[i]);
        acc += (alpha == 1.0) ? a : std::pow(a, alpha);
      }
      out[r] = acc;
    }
  });
}

const char* ph_version() { return "prost-host 0.1.0"; }

}  // extern "C"
