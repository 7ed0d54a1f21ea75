// Fused BOCD screening tick over fixed-slot (K, B) state, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/bocd_step.py, bocd_step (the pallas_call at
// line 206; math in _fused_step, prologue in _prep). One call advances B
// independent run-length posteriors by one observation: Student-t
// predictive per slot, the change-point row under the prior, the column
// logsumexp, mass truncation, the shared frontier victim (the slot with the
// lowest max over ALL columns, ties to the smallest run length, then the
// smallest slot), the Normal-Gamma update, the renormalize and p0.
//
// What bounds it on the H100: memory. Per tick the state (log_r, mu, beta:
// three (K, B) arrays) is read once and written once; at K = 32 and
// B = 16384 in float32 that is 12.6 MB, about 3.8 us at 3.35 TB/s. The
// arithmetic (two logs, a log1p and two exps per element) is far below the
// card's rate.
//
// The design: one cooperative launch (all blocks co-resident, striding over
// the columns) with one grid-wide barrier, because the victim pick reduces
// across every column (the Pallas kernel held the whole state in one VMEM
// block).
// * Eight threads share a column at K = 32 (4 to 32 as K grows), each with
//   a contiguous share of at most 4 of its K rows in registers: 8 B
//   threads at K = 32, two 512-thread blocks an SM at B = 16,384.
// * Before the barrier: predictive, cp row, logsumexp, truncation and the
//   block's row maxima (NaN read as +inf). When the blocks hold every
//   column (the fleet screen's case), a thread's rows stay in its
//   registers for the second half; else they go through the log_r output.
//   The column's sums run in row order (k = 0 .. K-1, then the cp row),
//   the threads handing the running sum on by shuffles, so that float32
//   sums round as one sequential loop over the rows does.
// * Above 128 slots (FleetDetect's adaptive cap grows K to 256) four
//   threads take a column 16 rows at a time, its rows going through the
//   log_r output between the steps. K is bounded only by the shared memory
//   that holds the per-slot terms (10 values a slot).
// * After it: every block reduces the row maxima and picks the same victim
//   (lowest strength, then smallest run length, then smallest slot); block
//   0 writes kappa, alpha and the run lengths; every block applies the
//   Normal-Gamma update and renormalizes its columns, writing log_r, mu,
//   beta and p0 once.
// The gammaln terms the Pallas prologue computed on the host (Mosaic has no
// lgamma) are computed per block from alpha. Built with --fmad=false so
// every multiply and add rounds as in the reference.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

namespace {

template <typename T> struct Num;
template <> struct Num<float> {
  static __device__ __forceinline__ float log(float v) { return logf(v); }
  static __device__ __forceinline__ float log1p(float v) { return log1pf(v); }
  static __device__ __forceinline__ float exp(float v) { return expf(v); }
  static __device__ __forceinline__ float lgamma(float v) { return lgammaf(v); }
  static __device__ __forceinline__ float abs(float v) { return fabsf(v); }
  static __device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }
  static constexpr float max_finite = FLT_MAX;
};
template <> struct Num<double> {
  static __device__ __forceinline__ double log(double v) { return ::log(v); }
  static __device__ __forceinline__ double log1p(double v) { return ::log1p(v); }
  static __device__ __forceinline__ double exp(double v) { return ::exp(v); }
  static __device__ __forceinline__ double lgamma(double v) { return ::lgamma(v); }
  static __device__ __forceinline__ double abs(double v) { return fabs(v); }
  static __device__ __forceinline__ double inf() { return __longlong_as_double(0x7ff0000000000000LL); }
  static constexpr double max_finite = DBL_MAX;
};

template <typename T> __device__ __forceinline__ bool is_nan(T v) { return v != v; }
template <typename T> __device__ __forceinline__ bool is_finite(T v) {
  return Num<T>::abs(v) <= Num<T>::max_finite;
}
// jnp.maximum / jnp.max semantics: NaN in either operand propagates.
template <typename T> __device__ __forceinline__ T max_nan(T a, T b) {
  return (is_nan(a) || a > b) ? a : b;
}

// Row maxima merged by shared-memory atomics: an integer whose order is
// the value's (keys are never NaN).
template <typename T> struct Ord;
template <> struct Ord<float> {
  using I = int;
  static __device__ __forceinline__ I enc(float v) {
    const int i = __float_as_int(v);
    return i >= 0 ? i : i ^ 0x7fffffff;
  }
  static __device__ __forceinline__ float dec(I i) {
    return __int_as_float(i >= 0 ? i : i ^ 0x7fffffff);
  }
};
template <> struct Ord<double> {
  using I = long long;
  static __device__ __forceinline__ I enc(double v) {
    const long long i = __double_as_longlong(v);
    return i >= 0 ? i : i ^ 0x7fffffffffffffffLL;
  }
  static __device__ __forceinline__ double dec(I i) {
    return __longlong_as_double(i >= 0 ? i : i ^ 0x7fffffffffffffffLL);
  }
};

// 512 threads a block: the row maxima that every block reads after the
// barrier stay small (256 blocks of them at B = 16,384 and K = 32, where
// 256-thread blocks made that read the kernel's longest phase), and two
// float32 blocks fit an SM at 64 registers a thread (one float64 block).
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
template <typename T>
__host__ __device__ constexpr int min_blocks() { return sizeof(T) == 4 ? 2 : 1; }
constexpr int kMaxRows = 4;                // rows of a column one thread holds at a time
constexpr int kSegment = 32 * kMaxRows;    // slots a column's threads hold at once
constexpr int kStaticSmem = 256;           // bytes kept for the kernel's __shared__ scalars

// Threads per column. Up to kSegment slots: the power of two from 4 to 32
// that leaves each at most kMaxRows rows, so that all rows stay in
// registers. Above: 4, so that a warp's load of a row covers 8 whole
// columns (one 32-byte sector in float32).
__host__ __device__ inline int lanes_for(int K) {
  if (K > kSegment) return 4;
  int lanes = 4;
  while (lanes * kMaxRows < K && lanes < 32) lanes *= 2;
  return lanes;
}

// A thread's rows k0 .. k0 + nr of segment s. Up to kSegment slots there
// is one segment; above, the segments take lanes * kMaxRows rows each in
// order. The column's lanes split a segment into contiguous shares in
// lane order.
struct Rows {
  int k0, nr;
};
__device__ __forceinline__ Rows rows_of(int s, int K, int lanes, int r) {
  const int base = s * lanes * kMaxRows;
  const int ks = min(K - base, lanes * kMaxRows);
  const int per = (ks + lanes - 1) / lanes;
  const int lo = min(ks, r * per);
  return {base + lo, min(ks, lo + per) - lo};
}

// The scalar prologue of _prep, in the state's type.
template <typename T> struct Params {
  T log_h, log_1mh, log_trunc, kappa0, alpha0, beta0, cp_const;
};

template <typename T>
__device__ __forceinline__ Params<T> make_params(double hazard, double kappa0, double alpha0,
                                                 double beta0, double truncation) {
  using N = Num<T>;
  Params<T> p;
  const T hz = (T)hazard;
  p.log_h = N::log(hz);
  p.log_1mh = N::log1p(-hz);
  p.log_trunc = N::log((T)truncation);
  p.kappa0 = (T)kappa0;
  p.alpha0 = (T)alpha0;
  p.beta0 = (T)beta0;
  p.cp_const = N::lgamma((T(2) * p.alpha0 + T(1)) / T(2)) - N::lgamma(p.alpha0);
  return p;
}

// acc + Σ_i exp(v[i] - shift) over a column's segment in row order: every
// lane takes the exps of its nr rows at once, then lane r of the column's
// `lanes` threads adds its terms after lanes 0 .. r - 1. Every lane of the
// warp calls it; all of the column's lanes return the sum.
template <typename T>
__device__ __forceinline__ T row_order_sum(const T (&v)[kMaxRows], int nr, T shift, int r,
                                           int lanes, bool live, T acc) {
  T e[kMaxRows];
#pragma unroll
  for (int i = 0; i < kMaxRows; ++i) e[i] = (live && i < nr) ? Num<T>::exp(v[i] - shift) : T(0);
  for (int step = 0; step < lanes; ++step) {
    const T from = __shfl_up_sync(0xffffffffu, acc, 1, lanes);
    if (r == step) {
      if (step > 0) acc = from;
#pragma unroll
      for (int i = 0; i < kMaxRows; ++i)
        if (i < nr) acc += e[i];
    }
  }
  return __shfl_sync(0xffffffffu, acc, lanes - 1, lanes);
}

template <typename V>
__device__ __forceinline__ V min_warp(V v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const V o = __shfl_xor_sync(0xffffffffu, v, off);
    v = o < v ? o : v;
  }
  return v;
}

template <typename T>
__device__ __forceinline__ T max_lanes(T v, int lanes) {   // max_nan over the column
  for (int off = 1; off < lanes; off <<= 1)
    v = max_nan(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// SPILL (K above kSegment): a column's rows no longer fit its threads'
// registers. They are taken a segment at a time and go through memory
// (log_r_out holds the growth rows, cp_norm the cp row), and the warps'
// row maxima are merged into the block's by shared-memory atomics.
template <typename T, bool SPILL>
__global__ void __launch_bounds__(kThreads, min_blocks<T>())
bocd_kernel(const T* __restrict__ x, const T* __restrict__ log_r, const T* __restrict__ mu,
            const T* __restrict__ beta, const T* __restrict__ kappa, const T* __restrict__ alpha,
            const int* __restrict__ rl, const T* __restrict__ mu0, int K, int B, double hazard,
            double kappa0, double alpha0, double beta0, double truncation,
            T* __restrict__ log_r_out, T* __restrict__ mu_out, T* __restrict__ beta_out,
            T* __restrict__ kappa_out, T* __restrict__ alpha_out, int* __restrict__ rl_out,
            T* __restrict__ p0, T* __restrict__ partial, T* __restrict__ cp_norm) {
  using N = Num<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // Per-slot terms, each computed as the reference orders its operations.
  T* tconst = reinterpret_cast<T*>(smem_raw);   // lgamma((df + 1) / 2) - lgamma(df / 2)
  T* kap_s = tconst + K;                        // kappa
  T* alp_s = kap_s + K;                         // alpha
  T* df_s = alp_s + K;                          // df = 2 alpha
  T* sc_s = df_s + K;                           // (kappa + 1) / (alpha kappa)
  T* pdf_s = sc_s + K;                          // pi df
  T* hdf_s = pdf_s + K;                         // 0.5 (df + 1)
  T* hk_s = hdf_s + K;                          // 0.5 kappa
  T* den_s = hk_s + K;                          // kappa + 1
  T* bmax = den_s + K;                          // the block's row maxima, then the keys
  T* wmax = bmax + K;                           // (kWarps, K), without SPILL
  auto* bmax_i = reinterpret_cast<typename Ord<T>::I*>(bmax);   // with SPILL
  T* red = SPILL ? wmax : wmax + kWarps * K;    // (kThreads,)
  __shared__ int vic;
  __shared__ Params<T> ps;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int lanes = lanes_for(K);
  const int cols = kThreads / lanes;             // columns of a block per pass
  const int r = threadIdx.x % lanes;             // the thread's share of the rows
  const int cl = threadIdx.x / lanes;
  const int nseg = SPILL ? (K + lanes * kMaxRows - 1) / (lanes * kMaxRows) : 1;
  const Rows own = rows_of(0, K, lanes, r);      // the one segment without SPILL
  // One pass when the blocks hold every column (the fleet screen's case):
  // then a thread's rows stay in registers across the grid barrier.
  const bool one_pass = !SPILL && (long long)gridDim.x * cols >= B;
  // The column's inputs, loaded (for the first pass) while the per-slot
  // terms are computed.
  T xb = T(0), m0 = T(0), mu_r[kMaxRows], beta_r[kMaxRows], lr_r[kMaxRows];
  auto load_rows = [&](int b, Rows q) {
#pragma unroll
    for (int i = 0; i < kMaxRows; ++i) {
      if (i < q.nr) {
        const size_t idx = (size_t)(q.k0 + i) * B + b;
        mu_r[i] = mu[idx];
        beta_r[i] = beta[idx];
        lr_r[i] = log_r[idx];
      }
    }
  };
  auto load_column = [&](int b) {
    xb = x[b];
    m0 = mu0[b];
    if (!SPILL) load_rows(b, own);
  };
  // A segment's rows of column b, back from log_r_out.
  auto reload = [&](T(&v)[kMaxRows], int b, Rows q) {
#pragma unroll
    for (int i = 0; i < kMaxRows; ++i)
      if (i < q.nr) v[i] = log_r_out[(size_t)(q.k0 + i) * B + b];
  };
  if (blockIdx.x * cols + cl < B) load_column(blockIdx.x * cols + cl);

  if (threadIdx.x == kThreads - 1)   // beside the threads of tconst
    ps = make_params<T>(hazard, kappa0, alpha0, beta0, truncation);
  const T pi = (T)3.14159265358979323846;
  const T neg_inf = -N::inf();
  for (int k = threadIdx.x; k < K; k += kThreads) {
    const T a = alpha[k];
    const T kp = kappa[k];
    const T df = T(2) * a;
    tconst[k] = N::lgamma((df + T(1)) / T(2)) - N::lgamma(df / T(2));
    kap_s[k] = kp;
    alp_s[k] = a;
    df_s[k] = df;
    sc_s[k] = (kp + T(1)) / (a * kp);
    pdf_s[k] = pi * df;
    hdf_s[k] = T(0.5) * (df + T(1));
    hk_s[k] = T(0.5) * kp;
    den_s[k] = kp + T(1);
    if (SPILL)
      bmax_i[k] = Ord<T>::enc(neg_inf);
    else
      bmax[k] = neg_inf;
  }
  __syncthreads();
  const Params<T> p = ps;

  // ---- growth, cp row, logsumexp, truncation, row maxima -----------------
  T g[kMaxRows], c = T(0);   // the truncated growth rows, the normalized cp
  for (int base = blockIdx.x * cols; base < B; base += gridDim.x * cols) {
    const int b = base + cl;
    const bool live = b < B;
    if (live && base != (int)blockIdx.x * cols) load_column(b);
    T cp = T(0), lse = T(0), gmax = neg_inf;
    if (live) {
      // Change-point row: x scored under the fresh-segment prior.
      const T df0 = T(2) * p.alpha0;
      const T s20 = p.beta0 * (p.kappa0 + T(1)) / (p.alpha0 * p.kappa0);
      const T d0 = xb - m0;
      const T z20 = d0 * d0 / s20 / df0;
      cp = p.cp_const - T(0.5) * N::log(pi * df0 * s20);
      cp -= T(0.5) * (df0 + T(1)) * N::log1p(z20);
      cp = cp + p.log_h;
    }
    for (int s = 0; s < nseg; ++s) {
      const Rows q = SPILL ? rows_of(s, K, lanes, r) : own;
      if (!live) continue;
      if (SPILL) load_rows(b, q);
      // Growth rows: Student-t posterior predictive per slot.
#pragma unroll
      for (int i = 0; i < kMaxRows; ++i) {
        if (i < q.nr) {
          const int k = q.k0 + i;
          const T scale2 = beta_r[i] * sc_s[k];
          const T d = xb - mu_r[i];
          const T z2 = d * d / scale2 / df_s[k];
          T logpred = tconst[k] - T(0.5) * N::log(pdf_s[k] * scale2);
          logpred -= hdf_s[k] * N::log1p(z2);
          g[i] = logpred + lr_r[i] + p.log_1mh;
          gmax = max_nan(gmax, g[i]);
          if (SPILL) log_r_out[(size_t)k * B + b] = g[i];
        }
      }
    }
    // Normalize over the K grown slots plus the cp row.
    const T m = max_nan(max_lanes(gmax, lanes), cp);
    const T shift = is_finite(m) ? m : T(0);
    T tot = T(0);
    for (int s = 0; s < nseg; ++s) {
      const Rows q = SPILL ? rows_of(s, K, lanes, r) : own;
      if (SPILL && live) reload(g, b, q);
      tot = row_order_sum(g, q.nr, shift, r, lanes, live, tot);
    }
    if (live) {
      tot += N::exp(cp - shift);
      lse = N::log(tot) + shift;
      c = cp - lse;
      if (r == 0 && !one_pass) cp_norm[b] = c;
    }
    // Truncate, write the rows; reduce the row strengths over the block's
    // columns (every lane runs the loop so the shuffles see full warps).
    for (int s = 0; s < nseg; ++s) {
      const Rows q = SPILL ? rows_of(s, K, lanes, r) : own;
      if (SPILL && live) reload(g, b, q);
#pragma unroll
      for (int i = 0; i < kMaxRows; ++i) {
        T key = neg_inf;
        if (live && i < q.nr) {
          T gi = g[i] - lse;
          gi = (gi <= p.log_trunc) ? neg_inf : gi;
          g[i] = gi;
          if (!one_pass) log_r_out[(size_t)(q.k0 + i) * B + b] = gi;
          key = is_nan(gi) ? N::inf() : gi;   // a poisoned column never hijacks the frontier
        }
        for (int off = lanes; off < 32; off <<= 1) {
          const T o = __shfl_xor_sync(0xffffffffu, key, off);
          key = o > key ? o : key;
        }
        if (lane < lanes && i < q.nr) {
          if (SPILL)
            atomicMax(&bmax_i[q.k0 + i], Ord<T>::enc(key));
          else
            wmax[warp * K + q.k0 + i] = key;
        }
      }
    }
    if (!SPILL) {
      __syncthreads();
      for (int k = warp; k < K; k += kWarps) {   // a warp per row, a lane per warp
        T v = lane < kWarps ? wmax[lane * K + k] : neg_inf;
        for (int off = 16; off > 0; off >>= 1) {
          const T o = __shfl_xor_sync(0xffffffffu, v, off);
          v = o > v ? o : v;
        }
        if (lane == 0) bmax[k] = v > bmax[k] ? v : bmax[k];
      }
      __syncthreads();
    }
  }
  if (SPILL) {
    __syncthreads();
    for (int k = threadIdx.x; k < K; k += kThreads)
      partial[(size_t)blockIdx.x * K + k] = Ord<T>::dec(bmax_i[k]);
  } else {
    for (int k = threadIdx.x; k < K; k += kThreads) partial[(size_t)blockIdx.x * K + k] = bmax[k];
  }

  cooperative_groups::this_grid().sync();

  // ---- victim slot, identical in every block ----------------------------
  if (K > kThreads) {   // a thread per row over all blocks' maxima
    for (int k = threadIdx.x; k < K; k += kThreads) {
      T m = neg_inf;
      for (int j = 0; j < (int)gridDim.x; ++j) {
        const T o = partial[(size_t)j * K + k];
        m = o > m ? o : m;
      }
      bmax[k] = m;
    }
  } else {
    // `group` threads per row, reading whole rows of blocks at once, then
    // one warp per row.
    const int group = kThreads / K;
    T m = neg_inf;
    if ((int)threadIdx.x < group * K) {
      const int k = threadIdx.x % K;
#pragma unroll 16
      for (int j = threadIdx.x / K; j < (int)gridDim.x; j += group) {
        const T o = partial[(size_t)j * K + k];
        m = o > m ? o : m;
      }
    }
    red[threadIdx.x] = m;
    __syncthreads();
    for (int k = warp; k < K; k += kWarps) {
      T v = neg_inf;
      for (int j = lane; j < group; j += 32) v = red[j * K + k] > v ? red[j * K + k] : v;
      for (int off = 16; off > 0; off >>= 1) {
        const T o = __shfl_xor_sync(0xffffffffu, v, off);
        v = o > v ? o : v;
      }
      if (lane == 0) bmax[k] = v;
    }
  }
  __syncthreads();
  if (warp == 0) {
    // Lowest strength, ties to the smallest run length, then smallest slot:
    // three minima over the K slots, lane l taking slots l, l + 32, ...
    T smin = N::inf();
    for (int k = lane; k < K; k += 32) smin = bmax[k] < smin ? bmax[k] : smin;
    smin = min_warp(smin);
    T rmin = N::inf();
    for (int k = lane; k < K; k += 32)
      if (bmax[k] == smin && (T)rl[k] < rmin) rmin = (T)rl[k];
    rmin = min_warp(rmin);
    int first = K;
    for (int k = lane; k < K; k += 32)
      if (bmax[k] == smin && (T)rl[k] == rmin && k < first) first = k;
    first = min_warp(first);
    if (lane == 0) vic = first;
  }
  __syncthreads();
  const int v = vic;
  if (blockIdx.x == 0) {
    for (int k = threadIdx.x; k < K; k += kThreads) {
      const bool is_v = k == v;
      kappa_out[k] = (is_v ? p.kappa0 : kap_s[k]) + T(1);
      alpha_out[k] = (is_v ? p.alpha0 : alp_s[k]) + T(0.5);
      rl_out[k] = is_v ? 0 : rl[k] + 1;
    }
  }

  // ---- Normal-Gamma update, victim overwrite, renormalize, p0 ------------
  for (int base = blockIdx.x * cols; base < B; base += gridDim.x * cols) {
    const int b = base + cl;
    const bool live = b < B;
    T lr[kMaxRows];
    T m2 = neg_inf;
    if (live && !one_pass) {   // the pass's column again, from memory
      load_column(b);
      c = cp_norm[b];
    }
    for (int s = 0; s < nseg; ++s) {
      const Rows q = SPILL ? rows_of(s, K, lanes, r) : own;
      if (!live) continue;
      if (SPILL) load_rows(b, q);
      if (!one_pass) reload(g, b, q);
#pragma unroll
      for (int i = 0; i < kMaxRows; ++i) {
        if (i < q.nr) {
          const int k = q.k0 + i;
          const size_t idx = (size_t)k * B + b;
          const bool is_v = k == v;
          lr[i] = is_v ? c : g[i];
          m2 = max_nan(m2, lr[i]);
          const T kap = is_v ? p.kappa0 : kap_s[k];
          const T mu_b = is_v ? m0 : mu_r[i];
          const T beta_b = is_v ? p.beta0 : beta_r[i];
          const T denom = is_v ? p.kappa0 + T(1) : den_s[k];
          const T hk = is_v ? T(0.5) * p.kappa0 : hk_s[k];
          const T d = xb - mu_b;
          beta_out[idx] = beta_b + hk * (d * d) / denom;
          mu_out[idx] = (kap * mu_b + xb) / denom;
        }
      }
    }
    m2 = max_lanes(m2, lanes);
    const T shift = is_finite(m2) ? m2 : T(0);
    // A segment's rows after the victim overwrite, back from log_r_out.
    auto reload_lr = [&](Rows q) {
      reload(lr, b, q);
#pragma unroll
      for (int i = 0; i < kMaxRows; ++i)
        if (i < q.nr && q.k0 + i == v) lr[i] = c;
    };
    T tot = T(0);
    for (int s = 0; s < nseg; ++s) {
      const Rows q = SPILL ? rows_of(s, K, lanes, r) : own;
      if (SPILL && live) reload_lr(q);
      tot = row_order_sum(lr, q.nr, shift, r, lanes, live, tot);
    }
    if (!live) continue;
    const T lse = N::log(tot) + shift;
    for (int s = 0; s < nseg; ++s) {
      const Rows q = SPILL ? rows_of(s, K, lanes, r) : own;
      if (SPILL) reload_lr(q);
#pragma unroll
      for (int i = 0; i < kMaxRows; ++i) {
        if (i < q.nr) {
          const int k = q.k0 + i;
          const T out = lr[i] - lse;
          log_r_out[(size_t)k * B + b] = out;
          if (k == v) p0[b] = N::exp(out);
        }
      }
    }
  }
}

template <typename T>
size_t smem_bytes(int K) {
  return (size_t)(10 * K + (K > kSegment ? 0 : kWarps * K) + kThreads) * sizeof(T);
}

// A kernel's co-resident blocks on a device, with its shared-memory opt-in
// there, found once per (device, kernel, bytes) and kept per host thread.
struct Fit {
  int dev = -1;
  const void* fn = nullptr;
  size_t smem = 0;
  int blocks = 0;
};

template <typename T>
int launch(const T* x, const T* log_r, const T* mu, const T* beta, const T* kappa,
           const T* alpha, const int* rl, const T* mu0, int K, int B, double hazard,
           double kappa0, double alpha0, double beta0, double truncation, T* log_r_out,
           T* mu_out, T* beta_out, T* kappa_out, T* alpha_out, int* rl_out, T* p0,
           T* partial, long long partial_len, T* cp_norm, cudaStream_t stream) {
  if (K < 1 || B < 1) return (int)cudaErrorInvalidValue;
  const void* fn = K > kSegment ? (const void*)bocd_kernel<T, true>
                                : (const void*)bocd_kernel<T, false>;
  const size_t smem = smem_bytes<T>(K);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  thread_local Fit fit;
  if (fit.dev != dev || fit.fn != fn || fit.smem != smem) {
    int sms = 0, optin = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return (int)err;
    if (smem + kStaticSmem > (size_t)optin) return (int)cudaErrorInvalidValue;
    // Above the default 48 KB a kernel needs the opt-in, which each device
    // keeps for itself.
    if (smem > 48 * 1024)
      err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads, smem);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    fit = {dev, fn, smem, per_sm * sms};
  }
  // As many blocks as the columns need, at most as many as are co-resident.
  const int cols = kThreads / lanes_for(K);
  const int need = (B + cols - 1) / cols;
  const int nblk = need < fit.blocks ? need : fit.blocks;
  if ((long long)nblk * K > partial_len) return (int)cudaErrorInvalidValue;
  void* args[] = {&x, &log_r, &mu, &beta, &kappa, &alpha, &rl, &mu0, &K, &B,
                  &hazard, &kappa0, &alpha0, &beta0, &truncation, &log_r_out, &mu_out,
                  &beta_out, &kappa_out, &alpha_out, &rl_out, &p0, &partial, &cp_norm};
  err = cudaLaunchCooperativeKernel(fn, dim3(nblk), dim3(kThreads), args, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Columns a block takes per pass for K slots.
int bocd_step_columns_per_block(int K) { return kThreads / lanes_for(K); }

// The most slots the kernel takes on the current device for elements of
// elem_bytes bytes: its shared memory holds ten values per slot.
int bocd_step_max_slots(int elem_bytes) {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return 0;
  const int k = ((optin - kStaticSmem) / elem_bytes - kThreads) / 10;
  return k > kSegment ? k : kSegment;
}

const char* bocd_step_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// partial: scratch of at least ceil(B / bocd_step_columns_per_block(K)) * K
// values; cp_norm: scratch of B values.
int bocd_step_f32(const float* x, const float* log_r, const float* mu, const float* beta,
                  const float* kappa, const float* alpha, const int* rl, const float* mu0, int K,
                  int B, double hazard, double kappa0, double alpha0, double beta0,
                  double truncation, float* log_r_out, float* mu_out, float* beta_out,
                  float* kappa_out, float* alpha_out, int* rl_out, float* p0, float* partial,
                  long long partial_len, float* cp_norm, void* stream) {
  return launch<float>(x, log_r, mu, beta, kappa, alpha, rl, mu0, K, B, hazard, kappa0, alpha0,
                       beta0, truncation, log_r_out, mu_out, beta_out, kappa_out, alpha_out,
                       rl_out, p0, partial, partial_len, cp_norm,
                       static_cast<cudaStream_t>(stream));
}

int bocd_step_f64(const double* x, const double* log_r, const double* mu, const double* beta,
                  const double* kappa, const double* alpha, const int* rl, const double* mu0,
                  int K, int B, double hazard, double kappa0, double alpha0, double beta0,
                  double truncation, double* log_r_out, double* mu_out, double* beta_out,
                  double* kappa_out, double* alpha_out, int* rl_out, double* p0,
                  double* partial, long long partial_len, double* cp_norm, void* stream) {
  return launch<double>(x, log_r, mu, beta, kappa, alpha, rl, mu0, K, B, hazard, kappa0, alpha0,
                        beta0, truncation, log_r_out, mu_out, beta_out, kappa_out, alpha_out,
                        rl_out, p0, partial, partial_len, cp_norm,
                        static_cast<cudaStream_t>(stream));
}

}  // extern "C"
