// Mamba2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/ssd_scan.py, ssd_scan (the pallas_call at line
// 334; math in _kernel). x (B, S, H, P), dt (B, S, H) and a (H,) in float32,
// B and C (B, S, G, N) shared by rep = H / G heads; returns y (B, S, H, P)
// and the final state (B, H, P, N), both in x's type. Per chunk of Q steps:
//   cum = cumsum(dt * a)
//   y   = ((C Bᵀ) ⊙ L ⊙ dt_k) x + diag(exp(cum)) C S_prevᵀ,
//         L[i, j] = exp(cum_i - cum_j) for i >= j, else 0
//   S   = S_prev * exp(cum_last) + Σ_q exp(cum_last - cum_q) dt_q x_q b_qᵀ
// with the state carried in float32 from chunk to chunk.
//
// What bounds it on the H100: bytes and operations are close. At the forward
// shape of mamba2-2.7b (B = 1, S = 4,096, H = 80, P = 64, G = 1, N = 128,
// Q = 128, bf16) the kernel moves ~88 MB (~26 us at 3.35 TB/s) and does
// ~27 GFLOP (~27 us at the bf16 tensor-core peak).
//
// The design (a first kernel, right before fast: float32 on the CUDA cores,
// no tensor cores yet):
// * One block of 256 threads per (32 columns of P, head, batch). Row p of
//   the state depends only on column p of x, so P splits across blocks
//   with no communication: at B = 1, H = 80, P = 64 that is 160 blocks for
//   132 SMs where a (batch, head) grid gives 80. Each block recomputes the
//   chunk's cum and C Bᵀ, which are cheap next to the rest.
// * The chunk loop runs inside the block (the TPU's sequential grid axis);
//   the 32 x N state lives in shared memory for the whole sequence.
// * Per chunk, C and B (Q x N) and the block's x columns (Q x 32) are staged
//   in shared memory as float32, B's rows padded by one float so that a
//   warp reading one column of B hits 32 banks. The decay-masked score
//   matrix is built 32 rows at a time (32 x Q floats), and each 32-row tile
//   gives its rows of y at once; ~178 KB of shared memory at Q = N = 128,
//   above the default 48 KB, so the entry point opts in once.
// * Two variants measured slower on an H100 (PERF.md): staging in bf16 so
//   that two blocks share an SM, and skipping the score columns right of
//   each tile's diagonal; both cut the registers from 125 to 60-96. The
//   SMs look bound by issuing shared-memory loads and FMAs, not by
//   latency; tensor cores are the next step.
// * exp(cum_i - cum_j) is evaluated only where i >= j: above the diagonal
//   the exponent is positive and could overflow, and 0 * inf is NaN.
// * Products use explicit fmaf: the library is built with --fmad=false.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPB = 32;    // columns of P (rows of the state) per block
constexpr int kRT = 32;    // rows of the score matrix per tile
constexpr int kMaxQ = 128;
constexpr int kMaxN = 128;

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__host__ __device__ constexpr size_t smem_floats(int q, int n) {
  return (size_t)q * n           // C       [q][n]
         + (size_t)q * (n + 1)   // B       [q][n + 1]
         + (size_t)kRT * q       // scores  [kRT][q]
         + (size_t)q * kPB       // x       [q][kPB]
         + (size_t)kPB * (n + 1) // state   [kPB][n + 1]
         + 3 * (size_t)q;        // cum, dt, w
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ a,
           const T* __restrict__ bm, const T* __restrict__ cm, T* __restrict__ y,
           T* __restrict__ fstate, int s, int h, int p, int g, int n, int q, long long xsb,
           long long xss, long long xsh, long long bsb, long long bss, long long bsg,
           long long csb, long long css, long long csg) {
  extern __shared__ __align__(16) float smem[];
  const int np1 = n + 1;
  float* cs = smem;               // C of the chunk
  float* bs = cs + q * n;         // B of the chunk, rows padded
  float* ms = bs + q * np1;       // 32 rows of the decay-masked scores
  float* xs = ms + kRT * q;       // the block's 32 columns of x
  float* ss = xs + q * kPB;       // the block's 32 rows of the state
  float* cum = ss + kPB * np1;
  float* dts = cum + q;
  float* ws = dts + q;            // exp(cum_last - cum_q) * dt_q

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int p0 = blockIdx.x * kPB;
  const int hh = blockIdx.y;
  const int b = blockIdx.z;
  const int gg = hh / (h / g);
  const int pc = min(kPB, p - p0);   // valid columns of this block
  const float ah = a[hh];

  const T* xb = x + (size_t)b * xsb + (size_t)hh * xsh + p0;
  const float* dtb = dt + (size_t)b * s * h + hh;
  const T* bb = bm + (size_t)b * bsb + (size_t)gg * bsg;
  const T* cb = cm + (size_t)b * csb + (size_t)gg * csg;
  T* yb = y + ((size_t)b * s * h + hh) * p + p0;
  const size_t ys = (size_t)h * p;   // y's stride along S

  for (int e = tid; e < kPB * np1; e += kThreads) ss[e] = 0.f;

  const int nc = s / q;
  const int ntile = (q + kRT - 1) / kRT;
  for (int c = 0; c < nc; ++c) {
    const int t0 = c * q;
    __syncthreads();   // the previous chunk's tiles and state update are done
    for (int e = tid; e < q * n; e += kThreads) {
      const int r = e / n, k = e - r * n;
      cs[e] = to_f(cb[(size_t)(t0 + r) * css + k]);
      bs[r * np1 + k] = to_f(bb[(size_t)(t0 + r) * bss + k]);
    }
    for (int e = tid; e < q * kPB; e += kThreads) {
      const int r = e / kPB, col = e - r * kPB;
      xs[e] = col < pc ? to_f(xb[(size_t)(t0 + r) * xss + col]) : 0.f;
    }
    if (tid < q) dts[tid] = dtb[(size_t)(t0 + tid) * h];
    __syncthreads();
    if (tid == 0) {   // the reference's cumsum, in order
      float run = 0.f;
      for (int r = 0; r < q; ++r) {
        run += dts[r] * ah;
        cum[r] = run;
      }
    }
    __syncthreads();
    if (tid < q) ws[tid] = expf(cum[q - 1] - cum[tid]) * dts[tid];

    for (int rt = 0; rt < ntile; ++rt) {
      const int i0 = rt * kRT;
      const int jmax = min(q, i0 + kRT);   // columns any row of the tile can see
      // Scores of rows i0 + warp + 8m, columns lane + 32k.
      float acc[4][4];
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) acc[m][kk] = 0.f;
      for (int k = 0; k < n; ++k) {
        float cv[4], bv[4];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int i = i0 + warp + 8 * m;
          cv[m] = i < q ? cs[i * n + k] : 0.f;
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int j = lane + 32 * kk;
          bv[kk] = j < jmax ? bs[j * np1 + k] : 0.f;
        }
#pragma unroll
        for (int m = 0; m < 4; ++m)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) acc[m][kk] = fmaf(cv[m], bv[kk], acc[m][kk]);
      }
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int r = warp + 8 * m;
        const int i = i0 + r;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int j = lane + 32 * kk;
          if (j < q) {
            float v = 0.f;
            if (i < q && j <= i) v = acc[m][kk] * expf(cum[i] - cum[j]) * dts[j];
            ms[r * q + j] = v;
          }
        }
      }
      __syncthreads();
      // y of rows i0 + warp + 8m, column lane: the intra-chunk product and
      // the state entering the chunk.
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int r = warp + 8 * m;
        const int i = i0 + r;
        if (i >= q) continue;
        float intra = 0.f;
        for (int j = 0; j <= i; ++j) intra = fmaf(ms[r * q + j], xs[j * kPB + lane], intra);
        float inter = 0.f;
        for (int k = 0; k < n; ++k) inter = fmaf(cs[i * n + k], ss[lane * np1 + k], inter);
        const float yv = intra + expf(cum[i]) * inter;
        if (lane < pc) yb[(size_t)(t0 + i) * ys + lane] = from_f<T>(yv);
      }
      __syncthreads();   // the tile's scores are consumed; the state was read
    }

    // State update: rows warp + 8m, columns lane + 32k.
    {
      const float dlast = expf(cum[q - 1]);
      float acc[4][4];
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) acc[m][kk] = 0.f;
      for (int r = 0; r < q; ++r) {
        const float w = ws[r];
        float xw[4], bv[4];
#pragma unroll
        for (int m = 0; m < 4; ++m) xw[m] = xs[r * kPB + warp + 8 * m] * w;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int k = lane + 32 * kk;
          bv[kk] = k < n ? bs[r * np1 + k] : 0.f;
        }
#pragma unroll
        for (int m = 0; m < 4; ++m)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) acc[m][kk] = fmaf(xw[m], bv[kk], acc[m][kk]);
      }
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int pr = warp + 8 * m;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int k = lane + 32 * kk;
          if (k < n) ss[pr * np1 + k] = ss[pr * np1 + k] * dlast + acc[m][kk];
        }
      }
    }
  }
  __syncthreads();
  T* fb = fstate + (((size_t)b * h + hh) * p + p0) * n;
  for (int e = tid; e < pc * n; e += kThreads) {
    const int r = e / n, k = e - r * n;
    fb[(size_t)r * n + k] = from_f<T>(ss[r * np1 + k]);
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* a, const void* bm, const void* cm,
           void* y, void* fstate, int b, int s, int h, int p, int g, int n, int q,
           const long long* st, cudaStream_t stream) {
  if (b < 1 || h < 1 || p < 1 || g < 1 || h % g != 0 || n < 1 || n > kMaxN || q < 1 ||
      q > kMaxQ || s % q != 0)
    return (int)cudaErrorInvalidValue;
  // Opt in to the largest shared-memory size any (Q, N) can ask for, once.
  static bool opted = false;
  constexpr size_t max_bytes = sizeof(float) * smem_floats(kMaxQ, kMaxN);
  if (!opted) {
    cudaError_t err = cudaFuncSetAttribute(
        ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)max_bytes);
    if (err != cudaSuccess) return (int)err;
    opted = true;
  }
  const size_t bytes = sizeof(float) * smem_floats(q, n);
  const dim3 grid((p + kPB - 1) / kPB, h, b);
  ssd_kernel<T><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(a),
      static_cast<const T*>(bm), static_cast<const T*>(cm), static_cast<T*>(y),
      static_cast<T*>(fstate), s, h, p, g, n, q, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8]);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* ssd_scan_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// strides: (x: b, s, h), (B: b, s, g), (C: b, s, g) in elements; the last
// dimension of each is contiguous. dt is a contiguous float32 (B, S, H), a a
// float32 (H,); y is a contiguous (B, S, H, P), the final state a contiguous
// (B, H, P, N), both in x's type.
int ssd_scan_f32(const void* x, const void* dt, const void* a, const void* bm, const void* cm,
                 void* y, void* fstate, int b, int s, int h, int p, int g, int n, int q,
                 const long long* strides, void* stream) {
  return launch<float>(x, dt, a, bm, cm, y, fstate, b, s, h, p, g, n, q, strides,
                       static_cast<cudaStream_t>(stream));
}

int ssd_scan_bf16(const void* x, const void* dt, const void* a, const void* bm, const void* cm,
                  void* y, void* fstate, int b, int s, int h, int p, int g, int n, int q,
                  const long long* strides, void* stream) {
  return launch<__nv_bfloat16>(x, dt, a, bm, cm, y, fstate, b, s, h, p, g, n, q, strides,
                               static_cast<cudaStream_t>(stream));
}

}  // extern "C"
