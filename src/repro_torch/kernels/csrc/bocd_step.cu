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
// The design: the victim pick reduces across every column, which one CTA
// cannot do at fleet widths (the Pallas kernel held the whole state in one
// VMEM block). So the tick is three launches on one stream:
//   1. bocd_grow    column-tiled, one thread per column: predictive, cp row,
//                   logsumexp, truncation. Writes the truncated growth rows
//                   into the log_r output, the normalized cp value per
//                   column, and per-block row maxima (NaN read as +inf).
//   2. bocd_victim  one block: reduces the block maxima to the victim slot
//                   with the reference's tie rules and updates the (K, 1)
//                   kappa / alpha / run-length vectors.
//   3. bocd_apply   column-tiled: Normal-Gamma update, victim overwrite,
//                   renormalize and p0, in place over the growth rows.
// The gammaln terms the Pallas prologue computed on the host (Mosaic has no
// lgamma) are computed per block from alpha. The growth rows make one extra
// round trip through memory (written by pass 1, read and rewritten by pass
// 3): simple first, fused later. Built with --fmad=false so every multiply
// and add rounds as in the reference.
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

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

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

// Pass 1: growth rows, cp row, logsumexp, truncation, per-block row maxima.
template <typename T>
__global__ void __launch_bounds__(kThreads)
bocd_grow(const T* __restrict__ x, const T* __restrict__ log_r, const T* __restrict__ mu,
          const T* __restrict__ beta, const T* __restrict__ kappa, const T* __restrict__ alpha,
          const T* __restrict__ mu0, int K, int B, double hazard, double kappa0, double alpha0,
          double beta0, double truncation, T* __restrict__ growth, T* __restrict__ cp_out,
          T* __restrict__ partial) {
  using N = Num<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tconst = reinterpret_cast<T*>(smem_raw);  // (K,)
  T* wmax = tconst + K;                        // (kWarps, K)
  const Params<T> p = make_params<T>(hazard, kappa0, alpha0, beta0, truncation);
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    const T df = T(2) * alpha[k];
    tconst[k] = N::lgamma((df + T(1)) / T(2)) - N::lgamma(df / T(2));
  }
  __syncthreads();

  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = b < B;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const T pi = (T)3.14159265358979323846;
  const T neg_inf = -N::inf();

  T lse = T(0);
  if (live) {
    const T xb = x[b];
    // Change-point row: x scored under the fresh-segment prior.
    const T df0 = T(2) * p.alpha0;
    const T s20 = p.beta0 * (p.kappa0 + T(1)) / (p.alpha0 * p.kappa0);
    const T d0 = xb - mu0[b];
    const T z20 = d0 * d0 / s20 / df0;
    T cp = p.cp_const - T(0.5) * N::log(pi * df0 * s20);
    cp -= T(0.5) * (df0 + T(1)) * N::log1p(z20);
    cp = cp + p.log_h;
    // Growth rows: Student-t posterior predictive per slot.
    T gmax = neg_inf;
    for (int k = 0; k < K; ++k) {
      const size_t i = (size_t)k * B + b;
      const T a = alpha[k];
      const T kp = kappa[k];
      const T df = T(2) * a;
      const T scale2 = beta[i] * ((kp + T(1)) / (a * kp));
      const T d = xb - mu[i];
      const T z2 = d * d / scale2 / df;
      T logpred = tconst[k] - T(0.5) * N::log(pi * df * scale2);
      logpred -= T(0.5) * (df + T(1)) * N::log1p(z2);
      const T g = logpred + log_r[i] + p.log_1mh;
      growth[i] = g;
      gmax = max_nan(gmax, g);
    }
    // Normalize over the K grown slots plus the cp row.
    const T m = max_nan(gmax, cp);
    const T shift = is_finite(m) ? m : T(0);
    T tot = T(0);
    for (int k = 0; k < K; ++k) tot += N::exp(growth[(size_t)k * B + b] - shift);
    tot += N::exp(cp - shift);
    lse = N::log(tot) + shift;
    cp_out[b] = cp - lse;
  }
  // Truncate and reduce the row strengths over this block's columns; every
  // thread runs the loop so the warp shuffles see full warps.
  for (int k = 0; k < K; ++k) {
    T key = neg_inf;
    if (live) {
      const size_t i = (size_t)k * B + b;
      T g = growth[i] - lse;
      g = (g <= p.log_trunc) ? neg_inf : g;
      growth[i] = g;
      key = is_nan(g) ? N::inf() : g;  // a poisoned column never hijacks the frontier
    }
    for (int off = 16; off > 0; off >>= 1) {
      const T o = __shfl_xor_sync(0xffffffffu, key, off);
      key = o > key ? o : key;
    }
    if (lane == 0) wmax[warp * K + k] = key;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    T r = wmax[k];
    for (int w = 1; w < kWarps; ++w) r = wmax[w * K + k] > r ? wmax[w * K + k] : r;
    partial[(size_t)blockIdx.x * K + k] = r;
  }
}

// Pass 2 (one block): victim slot and the (K, 1) vector updates.
template <typename T>
__global__ void bocd_victim(const T* __restrict__ partial, int nblk, const T* __restrict__ kappa,
                            const T* __restrict__ alpha, const int* __restrict__ rl, int K,
                            double kappa0, double alpha0, T* __restrict__ kappa_out,
                            T* __restrict__ alpha_out, int* __restrict__ rl_out,
                            int* __restrict__ victim) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* key = reinterpret_cast<T*>(smem_raw);  // (K,)
  __shared__ int vic;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    T r = partial[k];
    for (int j = 1; j < nblk; ++j) {
      const T v = partial[(size_t)j * K + k];
      r = v > r ? v : r;
    }
    key[k] = r;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    // Lowest strength, ties to the smallest run length, then smallest slot.
    T smin = key[0];
    for (int k = 1; k < K; ++k) smin = key[k] < smin ? key[k] : smin;
    T rmin = Num<T>::inf();
    for (int k = 0; k < K; ++k) {
      const T r = (T)rl[k];
      if (key[k] == smin && r < rmin) rmin = r;
    }
    int first = K;
    for (int k = 0; k < K; ++k) {
      if (key[k] == smin && (T)rl[k] == rmin) {
        first = k;
        break;
      }
    }
    vic = first;
    *victim = first;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    const bool v = k == vic;
    const T kap = v ? (T)kappa0 : kappa[k];
    const T alp = v ? (T)alpha0 : alpha[k];
    kappa_out[k] = kap + T(1);
    alpha_out[k] = alp + T(0.5);
    rl_out[k] = v ? 0 : rl[k] + 1;
  }
}

// Pass 3: Normal-Gamma update, victim overwrite, renormalize, p0.
template <typename T>
__global__ void __launch_bounds__(kThreads)
bocd_apply(const T* __restrict__ x, const T* __restrict__ mu, const T* __restrict__ beta,
           const T* __restrict__ kappa, const T* __restrict__ mu0, const T* __restrict__ cp_norm,
           const int* __restrict__ victim, int K, int B, double kappa0, double beta0,
           T* __restrict__ log_r_io, T* __restrict__ mu_out, T* __restrict__ beta_out,
           T* __restrict__ p0) {
  using N = Num<T>;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int v = *victim;
  const T xb = x[b];
  const T m0 = mu0[b];
  const T c = cp_norm[b];
  const T k0 = (T)kappa0;
  const T b0 = (T)beta0;
  T m2 = -N::inf();
  for (int k = 0; k < K; ++k) {
    const size_t i = (size_t)k * B + b;
    const bool is_v = k == v;
    const T lr = is_v ? c : log_r_io[i];
    m2 = max_nan(m2, lr);
    const T kap = is_v ? k0 : kappa[k];
    const T mu_b = is_v ? m0 : mu[i];
    const T beta_b = is_v ? b0 : beta[i];
    const T denom = kap + T(1);
    const T d = xb - mu_b;
    beta_out[i] = beta_b + T(0.5) * kap * (d * d) / denom;
    mu_out[i] = (kap * mu_b + xb) / denom;
  }
  const T shift = is_finite(m2) ? m2 : T(0);
  T tot = T(0);
  for (int k = 0; k < K; ++k) {
    const T lr = k == v ? c : log_r_io[(size_t)k * B + b];
    tot += N::exp(lr - shift);
  }
  const T lse = N::log(tot) + shift;
  for (int k = 0; k < K; ++k) {
    const size_t i = (size_t)k * B + b;
    const T out = (k == v ? c : log_r_io[i]) - lse;
    log_r_io[i] = out;
    if (k == v) p0[b] = N::exp(out);
  }
}

template <typename T>
int launch(const T* x, const T* log_r, const T* mu, const T* beta, const T* kappa,
           const T* alpha, const int* rl, const T* mu0, int K, int B, double hazard,
           double kappa0, double alpha0, double beta0, double truncation, T* log_r_out,
           T* mu_out, T* beta_out, T* kappa_out, T* alpha_out, int* rl_out, T* p0,
           T* partial, long long partial_len, T* cp_norm, int* victim, cudaStream_t stream) {
  if (K < 1 || B < 1) return (int)cudaErrorInvalidValue;
  const int nblk = (B + kThreads - 1) / kThreads;
  if ((long long)nblk * K > partial_len) return (int)cudaErrorInvalidValue;
  const size_t smem1 = (size_t)(K + kWarps * K) * sizeof(T);
  bocd_grow<T><<<nblk, kThreads, smem1, stream>>>(x, log_r, mu, beta, kappa, alpha, mu0, K, B,
                                                  hazard, kappa0, alpha0, beta0, truncation,
                                                  log_r_out, cp_norm, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bocd_victim<T><<<1, kThreads, (size_t)K * sizeof(T), stream>>>(
      partial, nblk, kappa, alpha, rl, K, kappa0, alpha0, kappa_out, alpha_out, rl_out, victim);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bocd_apply<T><<<nblk, kThreads, 0, stream>>>(x, mu, beta, kappa, mu0, cp_norm, victim, K, B,
                                               kappa0, beta0, log_r_out, mu_out, beta_out, p0);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int bocd_step_threads() { return kThreads; }

const char* bocd_step_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

int bocd_step_f32(const float* x, const float* log_r, const float* mu, const float* beta,
                  const float* kappa, const float* alpha, const int* rl, const float* mu0, int K,
                  int B, double hazard, double kappa0, double alpha0, double beta0,
                  double truncation, float* log_r_out, float* mu_out, float* beta_out,
                  float* kappa_out, float* alpha_out, int* rl_out, float* p0, float* partial,
                  long long partial_len, float* cp_norm, int* victim, void* stream) {
  return launch<float>(x, log_r, mu, beta, kappa, alpha, rl, mu0, K, B, hazard, kappa0, alpha0,
                       beta0, truncation, log_r_out, mu_out, beta_out, kappa_out, alpha_out,
                       rl_out, p0, partial, partial_len, cp_norm, victim,
                       static_cast<cudaStream_t>(stream));
}

int bocd_step_f64(const double* x, const double* log_r, const double* mu, const double* beta,
                  const double* kappa, const double* alpha, const int* rl, const double* mu0,
                  int K, int B, double hazard, double kappa0, double alpha0, double beta0,
                  double truncation, double* log_r_out, double* mu_out, double* beta_out,
                  double* kappa_out, double* alpha_out, int* rl_out, double* p0,
                  double* partial, long long partial_len, double* cp_norm, int* victim,
                  void* stream) {
  return launch<double>(x, log_r, mu, beta, kappa, alpha, rl, mu0, K, B, hazard, kappa0, alpha0,
                        beta0, truncation, log_r_out, mu_out, beta_out, kappa_out, alpha_out,
                        rl_out, p0, partial, partial_len, cp_norm, victim,
                        static_cast<cudaStream_t>(stream));
}

}  // extern "C"
