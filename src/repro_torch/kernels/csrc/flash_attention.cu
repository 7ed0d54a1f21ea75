// Flash attention for Hopper (sm_90a): blocked online-softmax attention
// with GQA, causal and sliding-window masks.
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention (the
// pallas_call at line 136; math in _kernel). q (B, Sq, H, hd), k/v
// (B, Skv, KVH, hd), float32 accumulation, output in q's type; the finite
// mask value -1e30 of the reference, whose rows correct themselves through
// alpha = exp(-1e30 - m) = 0 once a real score arrives.
//
// What bounds it on the H100: operations. At the forward shape (B = 1,
// S = 4,096, H = 32, KVH = 8, hd = 128, causal) the two products take
// ~137 GFLOP, ~0.139 ms at the 989 TFLOP/s of the bf16 tensor cores,
// against ~67 MB of q, k, v and output (~20 us at 3.35 TB/s).
//
// The design (a first kernel, right before fast: no tensor cores yet):
// * One block of 256 threads per (q tile of 64 rows, head, batch); GQA by
//   reading K/V head h / rep. Q tiles are scheduled longest first (the
//   causal diagonal makes late tiles the long ones).
// * The block loops over 64-key tiles only between the window's first and
//   the causal limit's last key; K and V tiles are staged in shared memory
//   as float32 (Q and K transposed, so that each thread's 4 x 4 block of
//   scores reads two float4s per step of the dot product).
// * Each thread holds 4 rows x 4 columns of scores and 4 rows x hd / 16
//   columns of the accumulator in registers; row maxima and sums reduce
//   over the 16 threads of a row with shuffles. P goes through shared
//   memory to the P.V product.
// * The ragged Sq / Skv edges are masked in the kernel (keys past Skv are
//   staged as zeros and masked with -1e30; rows past Sq are not stored):
//   no padded copies.
// * Products use explicit fmaf: the library is built with --fmad=false.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBQ = 64;   // query rows per block
constexpr int kBK = 64;   // keys per tile
constexpr int kThreads = 256;
constexpr int kPad = 4;   // row padding of the transposed tiles (keeps float4 alignment)
constexpr float kNegInf = -1e30f;

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

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         ((size_t)HD * (kBQ + kPad) + (size_t)HD * (kBK + kPad) + (size_t)kBK * HD +
          (size_t)kBK * (kBQ + kPad));
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
attention_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ out, int sq, int skv, int h, int kvh, long long qsb,
                 long long qss, long long qsh, long long ksb, long long kss, long long ksh,
                 long long vsb, long long vss, long long vsh, float scale, int causal,
                 int window) {
  constexpr int QP = kBQ + kPad;
  constexpr int KP = kBK + kPad;
  constexpr int OC = HD / 16;  // accumulator columns per thread
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                 // [HD][QP]  q * scale, transposed
  float* ks = qs + HD * QP;         // [HD][KP]  k, transposed
  float* vs = ks + HD * KP;         // [kBK][HD]
  float* ps = vs + kBK * HD;        // [kBK][QP] p, transposed

  const int tid = threadIdx.x;
  const int tx = tid & 15;   // score columns tx*4.., accumulator columns
  const int ty = tid >> 4;   // rows ty*4 .. ty*4+3
  const int qt = gridDim.x - 1 - blockIdx.x;  // longest tiles first
  const int hh = blockIdx.y;
  const int b = blockIdx.z;
  const int g = hh / (h / kvh);
  const int q0 = qt * kBQ;

  const T* qb = q + (size_t)b * qsb + (size_t)hh * qsh;
  const T* kb = k + (size_t)b * ksb + (size_t)g * ksh;
  const T* vb = v + (size_t)b * vsb + (size_t)g * vsh;

  for (int e = tid; e < kBQ * HD; e += kThreads) {
    const int r = e / HD, d = e % HD;
    const int row = q0 + r;
    qs[d * QP + r] = row < sq ? to_f(qb[(size_t)row * qss + d]) * scale : 0.f;
  }

  float m[4], l[4], acc[4][OC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < OC; ++c) acc[i][c] = 0.f;
  }

  // Keys any row of this tile can see: from the window's first key of the
  // first row to the causal limit of the last row.
  const int last_row = min(q0 + kBQ, sq) - 1;
  const int k_end = causal ? min(skv, last_row + 1) : skv;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile's k, v and p are consumed
    for (int e = tid; e < kBK * HD; e += kThreads) {
      const int c = e / HD, d = e % HD;
      const int col = k0 + c;
      const bool ok = col < skv;
      ks[d * KP + c] = ok ? to_f(kb[(size_t)col * kss + d]) : 0.f;
      vs[c * HD + d] = ok ? to_f(vb[(size_t)col * vss + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(qs + d * QP + ty * 4);
      const float4 ka = *reinterpret_cast<const float4*>(ks + d * KP + tx * 4);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kv[4] = {ka.x, ka.y, ka.z, ka.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx * 4 + j;
        bool ok = col < skv;
        if (causal) ok = ok && row >= col;
        if (window > 0) ok = ok && row - col < window;
        if (!ok) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mn = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - mn);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[i][j] = expf(s[i][j] - mn);
        rs += p[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = mn;
#pragma unroll
      for (int c = 0; c < OC; ++c) acc[i][c] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(ps + (tx * 4 + j) * QP + ty * 4) =
          make_float4(p[0][j], p[1][j], p[2][j], p[3][j]);
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      const float4 pa = *reinterpret_cast<const float4*>(ps + c * QP + ty * 4);
      const float pv[4] = {pa.x, pa.y, pa.z, pa.w};
#pragma unroll
      for (int g4 = 0; g4 < OC / 4; ++g4) {
        const float4 va = *reinterpret_cast<const float4*>(vs + c * HD + g4 * 64 + tx * 4);
        const float vv[4] = {va.x, va.y, va.z, va.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[i][g4 * 4 + e] = fmaf(pv[i], vv[e], acc[i][g4 * 4 + e]);
      }
    }
  }

  T* ob = out + (size_t)b * sq * h * HD + (size_t)hh * HD;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= sq) continue;
    const float lm = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int g4 = 0; g4 < OC / 4; ++g4)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ob[(size_t)row * h * HD + g4 * 64 + tx * 4 + e] = from_f<T>(acc[i][g4 * 4 + e] / lm);
  }
}

template <typename T, int HD>
int launch_hd(const void* q, const void* k, const void* v, void* out, int b, int sq, int skv,
              int h, int kvh, const long long* st, float scale, int causal, int window,
              cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(attention_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((sq + kBQ - 1) / kBQ, h, b);
  attention_kernel<T, HD><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), sq, skv, h, kvh, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], scale, causal, window);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int b, int sq, int skv,
           int h, int kvh, int hd, const long long* st, float scale, int causal, int window,
           cudaStream_t stream) {
  if (b < 1 || sq < 1 || skv < 1 || kvh < 1 || h % kvh != 0) return (int)cudaErrorInvalidValue;
  switch (hd) {
    case 64:
      return launch_hd<T, 64>(q, k, v, out, b, sq, skv, h, kvh, st, scale, causal, window, stream);
    case 128:
      return launch_hd<T, 128>(q, k, v, out, b, sq, skv, h, kvh, st, scale, causal, window, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// strides: (q: b, s, h), (k: b, s, h), (v: b, s, h) in elements; the last
// dimension of each is contiguous. out is a contiguous (B, Sq, H, hd).
int flash_attention_f32(const void* q, const void* k, const void* v, void* out, int b, int sq,
                        int skv, int h, int kvh, int hd, const long long* strides, float scale,
                        int causal, int window, void* stream) {
  return launch<float>(q, k, v, out, b, sq, skv, h, kvh, hd, strides, scale, causal, window,
                       static_cast<cudaStream_t>(stream));
}

int flash_attention_bf16(const void* q, const void* k, const void* v, void* out, int b, int sq,
                         int skv, int h, int kvh, int hd, const long long* strides, float scale,
                         int causal, int window, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, out, b, sq, skv, h, kvh, hd, strides, scale, causal,
                               window, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
