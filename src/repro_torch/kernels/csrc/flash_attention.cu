// Flash attention for Hopper (sm_90a): blocked online-softmax attention
// with GQA, causal and sliding-window masks.
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention (the
// pallas_call at line 129; math in _kernel). q (B, Sq, H, hd), k/v
// (B, Skv, KVH, hd), read through their strides (last dimension
// contiguous); float32 m, l and accumulator; output acc / max(l, 1e-30) in
// q's type; the finite mask value -1e30 of the reference, whose rows
// correct themselves through alpha = exp(-1e30 - m) = 0 once a real score
// arrives. Head dims 64 and 128.
//
// What bounds it on the H100: operations. At the forward shape (B = 1,
// S = 4,096, H = 32, KVH = 8, hd = 128, causal) the two products take
// ~137.5 GFLOP, ~0.139 ms at the 989 TFLOP/s of the bf16 tensor cores,
// against ~67 MB of q, k, v and output (~20 us at 3.35 TB/s).
//
// bfloat16 (flash_attention_bf16): the Hopper design, wgmma and TMA.
// * One block of three warpgroups per (128 query rows, head, batch). Blocks
//   run longest q tile first (the causal diagonal makes late tiles the long
//   ones), every head's before the next tile; GQA reads K/V head h / rep.
// * A producer warp issues TMA loads (4-d tensor maps over the strided
//   inputs, 128-byte swizzle, rows past Sq/Skv read as zeros) of the Q tile
//   once and of 128-key K and V tiles into a 3-stage ring guarded by
//   mbarriers (full: the bytes landed; empty: every consumer warp is done).
//   setmaxnreg moves registers from the producer warpgroup (40 a thread)
//   to the two consumers (232).
// * Each consumer warpgroup owns 64 query rows: S = Q K^T with
//   wgmma.m64n128k16 (Q and K from shared memory, K-major), the online
//   softmax in registers, then O += P V with wgmma.m64n{hd}k16 taking P
//   from registers (S's accumulator fragments, rounded to bf16) and V from
//   shared memory through an MN-major descriptor, so V is never transposed.
// * What bounds a consumer is the softmax beside the products (its
//   exponentials take the multi-function unit about as long as the tensor
//   cores take for both products), so the two overlap: S_j and
//   P_{j-1} V_{j-1} are issued together, the softmax of tile j runs while
//   P V is in flight, and O is rescaled by alpha_j just before P_j V_j.
//   The 3-stage ring keeps the next tiles loading while a stage waits for
//   its P V.
// * The scale (times log2(e), so that ex2.approx does the exponentials)
//   multiplies the float32 scores, never a bf16 Q: 128^-0.5 is no power of
//   two and would round once more. ex2.approx.ftz's rounding (~2 ulp) is
//   well inside the bf16 tolerance (2e-2).
// * P is rounded to bf16 before P V (2^-9 relative per element): that and
//   the summation order are the only roundings besides the output's.
// * Tiles strictly inside the causal/window band and the Skv edge take a
//   path without masks; only diagonal and edge tiles are masked. No padded
//   copies are made.
// * The library is built with --fmad=false: the softmax's multiply-adds
//   are explicit __fmaf_rn.
// * A mma.sync design (FlashAttention-2's shape: 16 query rows a warp, K/V
//   through a cp.async ring, P kept in registers) was timed against this
//   one on identical inputs at the forward shape and was slower (PERF.md,
//   Findings); it was removed.
//
// float32 (flash_attention_f32): the CUDA-core kernel, unchanged. The
// model's float32 logits are held to 1e-3 against the plain route through
// 40 layers, so the float32 path must stay full float32: TF32 tensor cores
// would keep ~3 digits. One block of 256 threads per (64 rows, head,
// batch); K and V staged as float32 (Q and K transposed), each thread
// holds a 4 x 4 block of scores and 4 rows of the accumulator; row maxima
// and sums reduce over 16 threads with shuffles; P goes through shared
// memory to the P V product; products use explicit fmaf.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;   // query rows per block
constexpr int kBK = 64;   // keys per tile
constexpr int kThreads = 256;
constexpr int kPad = 4;   // row padding of the transposed tiles (keeps float4 alignment)
constexpr float kNegInf = -1e30f;

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }

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

// ---------------------------------------------------------------------------
// bf16, the Hopper design: a producer warp issues TMA loads of K/V tiles
// into an mbarrier-guarded ring; two consumer warpgroups of 64 query rows
// each run wgmma (S = Q K^T from shared memory, O += P V with P in
// registers and V read MN-major, so no transposed copy of V).
namespace {

constexpr int kWgBQ = 128;        // query rows per block: two consumer warpgroups of 64
constexpr int kWgBK = 128;        // keys per tile
constexpr int kWgStages = 3;      // K/V tiles in flight
constexpr int kWgThreads = 384;   // producer warpgroup + two consumer warpgroups

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d (64 x 128, float32) = (scale_d ? d : 0) + A (64 x 16, K-major, shared) *
// B (16 x 128, K-major, shared)
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64, float32) += A (64 x 16, bf16 in registers) * B (16 x 64,
// MN-major, shared)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128, float32) += A (64 x 16, bf16 in registers) * B (16 x 128,
// MN-major, shared)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// 2^x on the multi-function unit (ex2.approx.ftz: ~2 ulp, results below
// 2^-126 flushed to zero, far below what the bf16 P keeps of a row).
__device__ __forceinline__ float wg_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (in 16-byte units).
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred P1;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
// A (64 columns x rows) box of a 4-d tensor map into shared memory; the
// barrier counts its bytes.
__device__ __forceinline__ void tma_load4(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                          int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

template <int HD>
__device__ __forceinline__ void wgmma_pv(float (&o)[HD / 2], const uint32_t (&a)[4], uint64_t db);
template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&o)[32], const uint32_t (&a)[4], uint64_t db) {
  wgmma_rs_n64(o, a, db);
}
template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&o)[64], const uint32_t (&a)[4],
                                              uint64_t db) {
  wgmma_rs_n128(o, a, db);
}

template <int HD>
constexpr int wg_smem_bytes() {
  // alignment slack + Q tile + the K/V ring + barriers
  return 1024 + 2 * HD * (kWgBQ + 2 * kWgStages * kWgBK) + 8 * (1 + 3 * kWgStages);
}

template <int HD>
__global__ void __launch_bounds__(kWgThreads, 1)
attention_wg_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ out,
                    int sq, int skv, int h, int kvh, float sl2, int causal, int window) {
  constexpr int NCB = HD / 64;               // 128-byte column blocks of a row
  constexpr uint32_t QB = kWgBQ * HD * 2;    // bytes of the Q tile
  constexpr uint32_t KB = kWgBK * HD * 2;    // bytes of one K (or V) tile
  extern __shared__ __align__(1024) unsigned char smem_wg[];
  // Tiles on 1,024-byte boundaries: the 128-byte swizzle repeats every 8 rows.
  const uint32_t qs = (smem_addr(smem_wg) + 1023u) & ~1023u;
  const uint32_t ring = qs + QB;             // stage s: K at ring + 2 s KB, V after it
  const uint32_t bars = ring + 2 * kWgStages * KB;
  const uint32_t q_full = bars;
  const uint32_t full_k = bars + 8;                    // + 8 s
  const uint32_t full_v = bars + 8 * (1 + kWgStages);  // + 8 s
  const uint32_t empty = bars + 8 * (1 + 2 * kWgStages);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int hh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;   // longest tiles first
  const int b = blockIdx.z;
  const int g = hh / (h / kvh);
  const int q0 = qt * kWgBQ;
  const int last_row = min(q0 + kWgBQ, sq) - 1;
  const int k_end = causal ? min(skv, last_row + 1) : skv;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + kWgBK - 1) / kWgBK : 0;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);   // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp < 4) {
    // Producer: one thread keeps the ring full; the warpgroup gives its
    // registers to the consumers.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 0) {
      mbar_expect_tx(q_full, QB);
      for (int c = 0; c < NCB; ++c) tma_load4(qs + c * kWgBQ * 128, &tq, q_full, c * 64, q0, hh, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kWgStages;
        mbar_wait(empty + 8 * s, ((j / kWgStages) & 1) ^ 1);
        const int k0 = k_begin + j * kWgBK;
        const uint32_t kt = ring + 2 * s * KB;
        mbar_expect_tx(full_k + 8 * s, KB);
        for (int c = 0; c < NCB; ++c)
          tma_load4(kt + c * kWgBK * 128, &tk, full_k + 8 * s, c * 64, k0, g, b);
        mbar_expect_tx(full_v + 8 * s, KB);
        for (int c = 0; c < NCB; ++c)
          tma_load4(kt + KB + c * kWgBK * 128, &tv, full_v + 8 * s, c * 64, k0, g, b);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int wg = warp / 4 - 1;            // consumer warpgroup: rows [64 wg, 64 wg + 64)
    const int wiw = warp & 3;               // warp in the warpgroup: 16 of those rows
    const int gq = lane >> 2, t = lane & 3;
    const int wr0 = q0 + wg * 64;
    const int wr_last = min(wr0 + 63, sq - 1);
    const int row_a = wr0 + wiw * 16 + gq;   // this thread's rows: row_a and row_a + 8
    float o[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
    float sc[kWgBK / 2];          // S of a tile, then its p
    uint32_t pf[kWgBK / 16][4];   // P of a tile as the A operand of P V, bf16
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, alpha[2] = {1.f, 1.f};

    // S = Q K^T of the tile in stage s, issued (not waited for).
    auto issue_s = [&](int s) {
      const uint32_t kt = ring + 2 * s * KB;
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint64_t da =
            gmma_desc(qs + (kk >> 2) * kWgBQ * 128 + wg * 64 * 128 + (kk & 3) * 32, 16, 1024);
        const uint64_t db = gmma_desc(kt + (kk >> 2) * kWgBK * 128 + (kk & 3) * 32, 16, 1024);
        wgmma_ss_n128(sc, da, db, kk > 0);
      }
      wg_commit();
    };
    // O += P V of the tile in stage s, issued (not waited for).
    auto issue_pv = [&](int s) {
      const uint32_t vt = ring + 2 * s * KB + KB;
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < kWgBK / 16; ++ks)
        wgmma_pv<HD>(o, pf[ks], gmma_desc(vt + ks * 16 * 128, kWgBK * 128, 1024));
      wg_commit();
    };
    // The online softmax of the scores in sc (keys from k0): new m, l and
    // alpha (applied to O later), p left in sc.
    auto softmax = [&](int k0) {
      const int k_last = k0 + kWgBK - 1;
      const bool full = k_last < skv && (!causal || k_last <= wr0) &&
                        (window == 0 || wr_last - k0 < window);
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int n = 0; n < kWgBK / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[4 * n + e] * sl2;
          if (!full) {
            const int row = row_a + (e >> 1) * 8;
            const int col = k0 + n * 8 + 2 * t + (e & 1);
            bool ok = col < skv;
            if (causal) ok = ok && row >= col;
            if (window > 0) ok = ok && row - col < window;
            if (!ok) x = kNegInf;
          }
          sc[4 * n + e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float mn = fmaxf(m[i], mx[i]);
        alpha[i] = wg_exp2(m[i] - mn);
        m[i] = mn;
      }
#pragma unroll
      for (int n = 0; n < kWgBK / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[4 * n + e] = wg_exp2(sc[4 * n + e] - m[e >> 1]);
          rs[e >> 1] += sc[4 * n + e];
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) l[i] = __fmaf_rn(l[i], alpha[i], rs[i]);  // quad sum at the end
    };
    auto to_p = [&]() {
#pragma unroll
      for (int n = 0; n < kWgBK / 8; ++n) {
        pf[n >> 1][(n & 1) * 2 + 0] = pack_bf16(sc[4 * n], sc[4 * n + 1]);
        pf[n >> 1][(n & 1) * 2 + 1] = pack_bf16(sc[4 * n + 2], sc[4 * n + 3]);
      }
    };
    auto rescale_o = [&]() {
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        o[4 * n] *= alpha[0];
        o[4 * n + 1] *= alpha[0];
        o[4 * n + 2] *= alpha[1];
        o[4 * n + 3] *= alpha[1];
      }
    };

    // The tensor cores run tile j - 1's P V while the softmax of tile j
    // runs: S_j and P_{j-1} V_{j-1} are issued together, S_j is waited for,
    // its softmax computed, then P V is waited for, its stage released and
    // P_j formed. O is rescaled by alpha_j just before P_j V_j is issued.
    mbar_wait(q_full, 0);
    if (n_tiles > 0) {
      mbar_wait(full_k, 0);
      issue_s(0);
      wg_wait<0>();
      softmax(k_begin);
      to_p();
    }
    for (int j = 1; j < n_tiles; ++j) {
      const int s = j % kWgStages, ps = (j - 1) % kWgStages;
      mbar_wait(full_k + 8 * s, (j / kWgStages) & 1);
      issue_s(s);
      rescale_o();
      mbar_wait(full_v + 8 * ps, ((j - 1) / kWgStages) & 1);
      issue_pv(ps);
      wg_wait<1>();
      softmax(k_begin + j * kWgBK);
      wg_wait<0>();
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * ps);
      to_p();
    }
    if (n_tiles > 0) {
      const int ps = (n_tiles - 1) % kWgStages;
      rescale_o();
      mbar_wait(full_v + 8 * ps, ((n_tiles - 1) / kWgStages) & 1);
      issue_pv(ps);
      wg_wait<0>();
    }

    __nv_bfloat16* ob = out + (size_t)b * sq * h * HD + (size_t)hh * HD;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float li = l[i];
      li += __shfl_xor_sync(0xffffffffu, li, 1);
      li += __shfl_xor_sync(0xffffffffu, li, 2);
      const float lm = fmaxf(li, 1e-30f);
      const int row = row_a + i * 8;
      if (row >= sq) continue;
      __nv_bfloat16* orow = ob + (size_t)row * h * HD;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
        *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + 2 * t) =
            __floats2bfloat162_rn(o[4 * n + 2 * i] / lm, o[4 * n + 2 * i + 1] / lm);
    }
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, found through the runtime's entry-point lookup
// (no link to libcuda).
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &res) ==
            cudaSuccess &&
        res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A (hd, S, heads, B) bf16 tensor map with strides in elements, boxes of 64
// columns x `rows` rows, 128-byte swizzle; rows past S read as zeros.
int make_map(CUtensorMap* map, const void* ptr, int hd, int s, int heads, int b, long long ss,
             long long sh, long long sb, int rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)s, (cuuint64_t)heads, (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                        strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int HD>
int launch_wg_hd(const void* q, const void* k, const void* v, void* out, int b, int sq, int skv,
                 int h, int kvh, const long long* st, float scale, int causal, int window,
                 cudaStream_t stream) {
  constexpr int bytes = wg_smem_bytes<HD>();
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        attention_wg_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  CUtensorMap mq, mk, mv;
  int err = make_map(&mq, q, HD, sq, h, b, st[1], st[2], st[0], kWgBQ);
  if (err == 0) err = make_map(&mk, k, HD, skv, kvh, b, st[4], st[5], st[3], kWgBK);
  if (err == 0) err = make_map(&mv, v, HD, skv, kvh, b, st[7], st[8], st[6], kWgBK);
  if (err != 0) return err;
  const dim3 grid(h, (sq + kWgBQ - 1) / kWgBQ, b);
  attention_wg_kernel<HD><<<grid, kWgThreads, bytes, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(out), sq, skv, h, kvh, scale * kLog2e, causal,
      window);
  return (int)cudaGetLastError();
}

int launch_wg(const void* q, const void* k, const void* v, void* out, int b, int sq, int skv,
              int h, int kvh, int hd, const long long* st, float scale, int causal, int window,
              cudaStream_t stream) {
  if (b < 1 || sq < 1 || skv < 1 || kvh < 1 || h % kvh != 0 || sq > 65535 * kWgBQ)
    return (int)cudaErrorInvalidValue;
  switch (hd) {
    case 64:
      return launch_wg_hd<64>(q, k, v, out, b, sq, skv, h, kvh, st, scale, causal, window, stream);
    case 128:
      return launch_wg_hd<128>(q, k, v, out, b, sq, skv, h, kvh, st, scale, causal, window,
                               stream);
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
  return launch_wg(q, k, v, out, b, sq, skv, h, kvh, hd, strides, scale, causal, window,
                   static_cast<cudaStream_t>(stream));
}

}  // extern "C"
