// Flash decode for Hopper (sm_90a): one query token per sequence against a
// (B, Skv, KVH, hd) KV cache, split-K over the cache with a log-sum-exp
// combine.
//
// Replaces: src/repro/kernels/flash_decode.py, flash_decode (the
// pallas_call at line 110; math in _kernel). Online softmax over the
// cache under a per-sequence valid_len, all rep = H/KVH query heads of one
// KV head together, float32 accumulation, zeros at valid_len = 0.
//
// What bounds it on the H100: bytes. Each call must read the valid prefix
// of K and V once: at the serve shape (B = 8, KVH = 8, hd = 128, ~1,088
// valid positions, bf16) that is ~35.7 MB, ~10.7 us at 3.35 TB/s, against
// ~0.14 GFLOP of arithmetic.
//
// The design:
// * Pass 1, grid (splits, KVH * head groups, B), 4 warps a block. Each
//   block takes one contiguous split of [0, valid_len) of one sequence and
//   one KV head, and the RB query heads of a head group (RB = 8, 4, 2 or 1,
//   the largest that divides rep). A warp streams 4 keys at a time: lane
//   `l` holds elements d = i * 32 + l of q, K and V, so every load of a row
//   is 32 consecutive elements (coalesced); the q.k dots finish with warp
//   shuffles. Each warp keeps its own (m, l, acc) online softmax in
//   registers; the 4 warps merge in shared memory and write one partial
//   (m, l, acc[hd]) per (b, head, split).
// * Pass 2, one block of hd threads per (b, head): log-sum-exp over the
//   splits, acc / max(l, 1e-30) in the output's type.
// * The cache is read through its strides (no transposed or padded copy),
//   and each split's loop ends at valid_len, so positions past it are
//   never read. The split count comes from the wrapper (about one split
//   per 128 positions, at most 64) so that B * KVH blocks become enough to
//   fill 132 SMs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 4;
constexpr int kKeys = 4;  // keys per warp per iteration
constexpr float kNegInf = -1e30f;  // the reference's finite mask value

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

template <typename T, int HD, int RB>
__global__ void __launch_bounds__(kWarps * 32)
split_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             const int* __restrict__ lens, int len_scalar, int skv, int h, int kvh,
             int n_split, long long ksb, long long kss, long long ksh, long long vsb,
             long long vss, long long vsh, float scale, float* __restrict__ part_m,
             float* __restrict__ part_l, float* __restrict__ part_acc) {
  constexpr int EPL = HD / 32;  // elements of a row per lane
  __shared__ float sm_m[kWarps][RB];
  __shared__ float sm_l[kWarps][RB];
  __shared__ float sm_acc[kWarps][RB][HD];

  const int split = blockIdx.x;
  const int rep = h / kvh;
  const int groups = rep / RB;
  const int g = blockIdx.y / groups;                      // KV head
  const int h0 = g * rep + (blockIdx.y % groups) * RB;    // first query head
  const int b = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  int len = lens != nullptr ? lens[b] : len_scalar;
  len = max(0, min(len, skv));
  const int chunk = (len + n_split - 1) / n_split;
  const int start = split * chunk;
  const int end = min(start + chunk, len);

  float qr[RB][EPL];
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int i = 0; i < EPL; ++i)
      qr[r][i] = to_f(q[((size_t)b * h + h0 + r) * HD + i * 32 + lane]) * scale;

  float m[RB], l[RB], acc[RB][EPL];
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < EPL; ++i) acc[r][i] = 0.f;
  }

  const T* kb = k + (size_t)b * ksb + (size_t)g * ksh;
  const T* vb = v + (size_t)b * vsb + (size_t)g * vsh;
  for (int base = start + warp * kKeys; base < end; base += kWarps * kKeys) {
    float kx[kKeys][EPL], vx[kKeys][EPL];
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      const bool ok = base + j < end;
      const T* kr = kb + (size_t)(base + j) * kss;
      const T* vr = vb + (size_t)(base + j) * vss;
#pragma unroll
      for (int i = 0; i < EPL; ++i) {
        kx[j][i] = ok ? to_f(kr[i * 32 + lane]) : 0.f;
        vx[j][i] = ok ? to_f(vr[i * 32 + lane]) : 0.f;
      }
    }
    float sc[RB][kKeys];
#pragma unroll
    for (int r = 0; r < RB; ++r)
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        float a = 0.f;
#pragma unroll
        for (int i = 0; i < EPL; ++i) a = fmaf(qr[r][i], kx[j][i], a);
        sc[r][j] = a;
      }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int r = 0; r < RB; ++r)
#pragma unroll
        for (int j = 0; j < kKeys; ++j)
          sc[r][j] += __shfl_xor_sync(0xffffffffu, sc[r][j], off);
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kKeys; ++j)
        if (base + j < end) mx = fmaxf(mx, sc[r][j]);
      const float mn = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - mn);
      float p[kKeys];
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        p[j] = base + j < end ? expf(sc[r][j] - mn) : 0.f;
        ps += p[j];
      }
      l[r] = l[r] * alpha + ps;
      m[r] = mn;
#pragma unroll
      for (int i = 0; i < EPL; ++i) {
        float a = acc[r][i] * alpha;
#pragma unroll
        for (int j = 0; j < kKeys; ++j) a = fmaf(p[j], vx[j][i], a);
        acc[r][i] = a;
      }
    }
  }

  // Merge the warps' partial softmaxes, write one partial per head.
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    if (lane == 0) {
      sm_m[warp][r] = m[r];
      sm_l[warp][r] = l[r];
    }
#pragma unroll
    for (int i = 0; i < EPL; ++i) sm_acc[warp][r][i * 32 + lane] = acc[r][i];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < RB * HD; e += kWarps * 32) {
    const int r = e / HD;
    const int d = e % HD;
    float mm = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, sm_m[w][r]);
    float ll = 0.f, aa = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(sm_m[w][r] - mm);
      ll += sm_l[w][r] * f;
      aa += sm_acc[w][r][d] * f;
    }
    const size_t idx = ((size_t)b * h + h0 + r) * n_split + split;
    part_acc[idx * HD + d] = aa;
    if (d == 0) {
      part_m[idx] = mm;
      part_l[idx] = ll;
    }
  }
}

template <typename T>
__global__ void combine_kernel(const float* __restrict__ part_m, const float* __restrict__ part_l,
                               const float* __restrict__ part_acc, T* __restrict__ out,
                               int n_split, int hd) {
  const size_t bh = blockIdx.x;
  const int d = threadIdx.x;
  const float* pm = part_m + bh * n_split;
  const float* pl = part_l + bh * n_split;
  const float* pa = part_acc + bh * n_split * hd;
  float mm = kNegInf;
  for (int s = 0; s < n_split; ++s) mm = fmaxf(mm, pm[s]);
  float ll = 0.f, aa = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const float f = expf(pm[s] - mm);
    ll += pl[s] * f;
    aa += pa[(size_t)s * hd + d] * f;
  }
  out[bh * hd + d] = from_f<T>(aa / fmaxf(ll, 1e-30f));
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* lens;
  int len_scalar, b, h, kvh, hd, skv, n_split;
  long long ksb, kss, ksh, vsb, vss, vsh;
  float scale;
  float* part_m;
  float* part_l;
  float* part_acc;
  void* out;
  cudaStream_t stream;
};

template <typename T, int HD, int RB>
void launch_split(const Args& a) {
  const dim3 grid(a.n_split, a.kvh * ((a.h / a.kvh) / RB), a.b);
  split_kernel<T, HD, RB><<<grid, kWarps * 32, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      a.lens, a.len_scalar, a.skv, a.h, a.kvh, a.n_split, a.ksb, a.kss, a.ksh, a.vsb, a.vss,
      a.vsh, a.scale, a.part_m, a.part_l, a.part_acc);
}

template <typename T, int HD>
int launch_hd(const Args& a) {
  const int rep = a.h / a.kvh;
  if (rep % 8 == 0) launch_split<T, HD, 8>(a);
  else if (rep % 4 == 0) launch_split<T, HD, 4>(a);
  else if (rep % 2 == 0) launch_split<T, HD, 2>(a);
  else launch_split<T, HD, 1>(a);
  return 0;
}

template <typename T>
int launch(const Args& a) {
  if (a.b < 1 || a.kvh < 1 || a.h % a.kvh != 0 || a.n_split < 1 || a.skv < 1)
    return (int)cudaErrorInvalidValue;
  switch (a.hd) {
    case 32: launch_hd<T, 32>(a); break;
    case 64: launch_hd<T, 64>(a); break;
    case 128: launch_hd<T, 128>(a); break;
    default: return (int)cudaErrorInvalidValue;
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  combine_kernel<T><<<a.b * a.h, a.hd, 0, a.stream>>>(a.part_m, a.part_l, a.part_acc,
                                                      static_cast<T*>(a.out), a.n_split, a.hd);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* flash_decode_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

#define FLASH_DECODE_ENTRY(NAME, T)                                                          \
  int NAME(const void* q, const void* k, const void* v, const int* lens, int len_scalar,    \
           int b, int h, int kvh, int hd, int skv, int n_split, long long ksb, long long kss, \
           long long ksh, long long vsb, long long vss, long long vsh, float scale,           \
           float* part_m, float* part_l, float* part_acc, void* out, void* stream) {         \
    Args a{q,     k,     v,     lens, len_scalar, b,      h,      kvh,      hd,              \
           skv,   n_split, ksb, kss,  ksh,        vsb,    vss,    vsh,      scale,           \
           part_m, part_l, part_acc, out, static_cast<cudaStream_t>(stream)};                \
    return launch<T>(a);                                                                     \
  }

FLASH_DECODE_ENTRY(flash_decode_f32, float)
FLASH_DECODE_ENTRY(flash_decode_bf16, __nv_bfloat16)

}  // extern "C"
