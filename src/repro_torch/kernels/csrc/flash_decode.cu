// Flash decode for Hopper (sm_90a): one query token per sequence against a
// (B, Skv, KVH, hd) KV cache, in one launch: split-K over the cache, the
// splits of one (sequence, KV head, head group) forming a thread-block
// cluster that combines their partial softmaxes in distributed shared
// memory.
//
// Replaces: src/repro/kernels/flash_decode.py, flash_decode (the
// pallas_call at line 104; math in _kernel). Online softmax over the
// cache under a per-sequence valid_len (an int, or a (B,) int32 tensor
// read on the card), clamped to [0, Skv]; all rep = H/KVH query heads of
// one KV head together; float32 scores, softmax and accumulator; zeros at
// valid_len = 0 (acc / max(l, 1e-30) with nothing accumulated). Head dims
// 32, 64 and 128, float32 and bf16.
//
// What bounds it on the H100: bytes. Each call must read the valid prefix
// of K and V once: at the serve shape (B = 8, KVH = 8, hd = 128, ~1,088
// valid positions, bf16) that is ~35.8 MB, ~10.7 us at 3.35 TB/s, against
// ~0.14 GFLOP of arithmetic.
//
// The design:
// * Grid (splits, KVH * head groups, B), 4 warps a block, clusters of
//   (splits, 1, 1): about one split per 128 valid positions, at most 8
//   (the portable cluster size), so the serve shape runs 8 x 8 x 8 = 512
//   blocks of 136 keys. A block takes the RB query heads of one head group
//   (RB = 8, 4, 2 or 1, the largest that divides rep) and the split
//   [s * c, min((s + 1) * c, len)), c = ceil(len / splits) (split_chunk
//   in flash_decode.py, which the wrapper passes for an int valid_len;
//   the block computes it for a per-sequence one). Its loop ends at
//   valid_len: no position past it is read.
// * K and V tiles of 32 keys stream through a 2-stage cp.async ring of
//   16-byte copies (8 bf16 or 4 float32 a lane) into shared memory whose
//   16-byte chunks are XORed with the key, so the copy of the next tile
//   overlaps this tile's math and reads of a row by 8 lanes hit 8 bank
//   groups.
// * Scores: lane l owns key l of the tile; warp w dots a quarter of its K
//   row from shared memory against all RB query rows (q * scale, float32
//   in shared memory, read by all lanes at once), so each K element is
//   read and converted once; the quarters add up in shared memory. The
//   per-tile max and sum of a row (its owner warp) are the only shuffles.
//   P goes to shared memory; in P V each thread owns a pair of hd columns
//   for all RB rows over a group of the tile's keys, the groups added up
//   once after the loop.
// * Combine: each block leaves (m, l, acc[RB][hd]) in its shared memory;
//   after cluster.sync() every block gathers all splits' (m, l) through
//   map_shared_rank in one parallel step, then takes a share of the
//   outputs: it reads those entries of every split's acc, does the
//   log-sum-exp and writes them in q's type. No partials touch device
//   memory, and there is no second launch.
// * What holds it back at the serve shape is latency, not bandwidth: each
//   block walks its 136 keys in 5 dependent tiles with one tile in flight,
//   and the cluster launch and combine add a fixed cost; long splits
//   (32,768 positions) stream near the memory rate.
// * The cache is read through its strides (no transposed or padded copy).
//   Products use explicit fmaf: the library is built with --fmad=false.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTK = 32;            // keys per tile: one per lane
constexpr int kStages = 2;
constexpr int kMaxSplits = 8;      // the portable cluster size
constexpr float kNegInf = -1e30f;  // the reference's finite mask value

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// The EPC = 16 / sizeof(T) elements of one 16-byte chunk, as float32.
__device__ __forceinline__ void chunk_to_f(const float4& raw, float (&x)[4]) {
  x[0] = raw.x; x[1] = raw.y; x[2] = raw.z; x[3] = raw.w;
}
__device__ __forceinline__ void chunk_to_f(const float4& raw, float (&x)[8]) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(p[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ float2 pair_to_f(float2 v) { return v; }
__device__ __forceinline__ float2 pair_to_f(__nv_bfloat162 v) { return __bfloat1622float2(v); }

template <typename T> struct Pair;
template <> struct Pair<float> { using type = float2; };
template <> struct Pair<__nv_bfloat16> { using type = __nv_bfloat162; };

template <typename T, int HD>
struct Layout {
  static constexpr int EPC = 16 / (int)sizeof(T);         // elements per 16-byte chunk
  static constexpr int NCH = HD / EPC;                      // chunks per row
  static constexpr int SW = NCH < 8 ? NCH - 1 : 7;          // swizzle mask
  static constexpr int ROW = HD * (int)sizeof(T);           // bytes per row
  static constexpr int TILE = kTK * ROW;                    // bytes per K or V tile
};

template <typename T, int HD>
__device__ __forceinline__ int swz(int key, int ch) {
  using L = Layout<T, HD>;
  return key * L::ROW + ((ch ^ (key & L::SW)) << 4);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  const int n = ok ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage keys [k0, k0 + kTK) of the cache (K and V) into one ring stage;
// keys at or past `end` are zero-filled and not read.
template <typename T, int HD>
__device__ __forceinline__ void load_stage(unsigned char* stage, const T* kb, const T* vb,
                                           long long kss, long long vss, int k0, int end,
                                           int tid) {
  using L = Layout<T, HD>;
  const uint32_t ks = static_cast<uint32_t>(__cvta_generic_to_shared(stage));
  const uint32_t vs = ks + L::TILE;
  for (int e = tid; e < kTK * L::NCH; e += kThreads) {
    const int key = e / L::NCH, ch = e % L::NCH;
    const bool ok = k0 + key < end;
    const size_t off = (size_t)(ok ? k0 + key : 0);
    cp_async16(ks + swz<T, HD>(key, ch), kb + off * kss + ch * L::EPC, ok);
    cp_async16(vs + swz<T, HD>(key, ch), vb + off * vss + ch * L::EPC, ok);
  }
}

// The query rows of a head group, as float32 values of p[kk * RB + r].
template <int RB>
__device__ __forceinline__ void load_rows(const float* p, float (&v)[RB]) {
  if constexpr (RB % 4 == 0) {
#pragma unroll
    for (int r = 0; r < RB; r += 4) {
      const float4 x = *reinterpret_cast<const float4*>(p + r);
      v[r] = x.x; v[r + 1] = x.y; v[r + 2] = x.z; v[r + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int r = 0; r < RB; ++r) v[r] = p[r];
  }
}

template <typename T> __device__ __forceinline__ void store4(T* dst, float4 v);
template <> __device__ __forceinline__ void store4<float>(float* dst, float4 v) {
  *reinterpret_cast<float4*>(dst) = v;
}
template <> __device__ __forceinline__ void store4<__nv_bfloat16>(__nv_bfloat16* dst, float4 v) {
  __nv_bfloat162* d = reinterpret_cast<__nv_bfloat162*>(dst);
  d[0] = __floats2bfloat162_rn(v.x, v.y);
  d[1] = __floats2bfloat162_rn(v.z, v.w);
}

template <typename T, int HD, int RB>
struct Smem {
  using L = Layout<T, HD>;
  static constexpr int KG = kThreads / (HD / 2);   // key groups of P V
  static constexpr int RING = kStages * 2 * L::TILE;
  // floats after the ring: q, partial dots, p, every split's m (then the
  // combine factors) and l, alpha, m, l, combined l. The P V partials reuse the ring once the loop is done.
  static constexpr int FLOATS =
      RB * HD + kWarps * RB * kTK + kTK * RB + 2 * kMaxSplits * RB + 4 * RB;
  static_assert(4 * KG * RB * HD <= RING, "the P V partials must fit in the ring");
  static constexpr int BYTES = RING + 4 * FLOATS;
};

template <typename T, int HD, int RB>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const int* __restrict__ lens, int len_scalar, int chunk_scalar, int skv, int h,
              int kvh, int n_split, long long ksb, long long kss, long long ksh, long long vsb,
              long long vss, long long vsh, float scale, T* __restrict__ out) {
  using L = Layout<T, HD>;
  using P2 = typename Pair<T>::type;
  constexpr int CPW = L::NCH / kWarps;                // chunks of a K row per warp
  constexpr int RPW = RB > kWarps ? RB / kWarps : 1;  // softmax rows per warp
  constexpr int NCP = HD / 2;                         // column pairs of P V
  constexpr int KG = Smem<T, HD, RB>::KG;             // key groups of P V
  constexpr int KPG = kTK / KG;                       // keys per group
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ring = smem;                         // kStages x (K tile, V tile)
  float* sq = reinterpret_cast<float*>(ring + Smem<T, HD, RB>::RING);  // [RB][HD] q * scale
  float* sacc = reinterpret_cast<float*>(ring);   // after the loop: [KG][RB][HD] P V
                                                  // partials; [0] = this split's acc
  float* spart = sq + RB * HD;              // [kWarps][RB][kTK] partial dots
  float* sp = spart + kWarps * RB * kTK;    // [kTK][RB] p of the tile
  float* sfac = sp + kTK * RB;              // [kMaxSplits][RB] every split's m, then factors
  float* sall = sfac + kMaxSplits * RB;     // [kMaxSplits][RB] every split's l
  float* salpha = sall + kMaxSplits * RB;   // [RB] (16-byte aligned: all above are multiples of 4)
  float* sm = salpha + RB;                  // [RB] m of this split
  float* sl = sm + RB;                      // [RB] l of this split
  float* sltot = sl + RB;                   // [RB] combined l

  cg::cluster_group cluster = cg::this_cluster();
  const int split = blockIdx.x;
  const int rep = h / kvh;
  const int groups = rep / RB;
  const int g = blockIdx.y / groups;                        // KV head
  const int h0 = g * rep + (blockIdx.y % groups) * RB;      // first query head
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  int len = lens != nullptr ? lens[b] : len_scalar;
  len = max(0, min(len, skv));
  const int chunk = lens != nullptr ? (len + n_split - 1) / n_split : chunk_scalar;
  const int start = min(split * chunk, len);
  const int end = min(start + chunk, len);
  const int n_tiles = (end - start + kTK - 1) / kTK;

  const T* kb = k + (size_t)b * ksb + (size_t)g * ksh;
  const T* vb = v + (size_t)b * vsb + (size_t)g * vsh;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_tiles)
      load_stage<T, HD>(ring + st * 2 * L::TILE, kb, vb, kss, vss, start + st * kTK, end, tid);
    cp_commit();
  }

  const T* qb = q + ((size_t)b * h + h0) * HD;
  for (int e = tid; e < RB * HD; e += kThreads) sq[e] = to_f(qb[e]) * scale;

  float m[RPW], l[RPW];   // rows warp * RPW + i, where < RB
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }
  const int cp = tid % NCP, kg = tid / NCP;   // P V: column pair, key group
  float2 acc[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r) acc[r] = make_float2(0.f, 0.f);

  for (int j = 0; j < n_tiles; ++j) {
    cp_wait<kStages - 2>();
    __syncthreads();   // tile j landed; tile j - 1 and its p are consumed
    const int nj = j + kStages - 1;
    if (nj < n_tiles)
      load_stage<T, HD>(ring + (nj % kStages) * 2 * L::TILE, kb, vb, kss, vss,
                        start + nj * kTK, end, tid);
    cp_commit();
    const unsigned char* ks = ring + (j % kStages) * 2 * L::TILE;
    const unsigned char* vs = ks + L::TILE;
    const int k0 = start + j * kTK;

    // Partial dots: lane = key, warp = a quarter of hd, against all rows.
    {
      float part[RB];
#pragma unroll
      for (int r = 0; r < RB; ++r) part[r] = 0.f;
#pragma unroll
      for (int i = 0; i < CPW; ++i) {
        const int c = warp * CPW + i;
        const float4 raw = *reinterpret_cast<const float4*>(ks + swz<T, HD>(lane, c));
        float x[L::EPC];
        chunk_to_f(raw, x);
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          const float* qr = sq + r * HD + c * L::EPC;
#pragma unroll
          for (int e4 = 0; e4 < L::EPC; e4 += 4) {
            const float4 qv = *reinterpret_cast<const float4*>(qr + e4);
            part[r] = fmaf(qv.x, x[e4], part[r]);
            part[r] = fmaf(qv.y, x[e4 + 1], part[r]);
            part[r] = fmaf(qv.z, x[e4 + 2], part[r]);
            part[r] = fmaf(qv.w, x[e4 + 3], part[r]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < RB; ++r) spart[(warp * RB + r) * kTK + lane] = part[r];
    }
    __syncthreads();

    // Scores, the per-tile max and sum and p: the owner warp of each row.
    const bool live = k0 + lane < end;
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int r = warp * RPW + i;
      if (r >= RB) break;   // warp-uniform
      float s = spart[r * kTK + lane];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) s += spart[(w * RB + r) * kTK + lane];
      float mx = live ? s : kNegInf;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mn = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - mn);
      const float p = live ? expf(s - mn) : 0.f;
      float ps = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l[i] = fmaf(l[i], alpha, ps);
      m[i] = mn;
      sp[lane * RB + r] = p;
      if (lane == 0) salpha[r] = alpha;
    }
    __syncthreads();   // p and alpha of every row

    // P V: this thread's column pair over its group of keys, all rows.
    {
      float al[RB];
      load_rows<RB>(salpha, al);
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        acc[r].x *= al[r];
        acc[r].y *= al[r];
      }
      const int ch = (2 * cp) / L::EPC, within = ((2 * cp) % L::EPC) * (int)sizeof(T);
#pragma unroll 4
      for (int kk = kg * KPG; kk < (kg + 1) * KPG; ++kk) {
        const float2 vv =
            pair_to_f(*reinterpret_cast<const P2*>(vs + swz<T, HD>(kk, ch) + within));
        float pr[RB];
        load_rows<RB>(sp + kk * RB, pr);
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          acc[r].x = fmaf(pr[r], vv.x, acc[r].x);
          acc[r].y = fmaf(pr[r], vv.y, acc[r].y);
        }
      }
    }
  }
  cp_wait<0>();
  __syncthreads();   // the ring is free

  // This split's partial softmax into shared memory: the key groups' sums
  // of P V, m and l.
#pragma unroll
  for (int r = 0; r < RB; ++r)
    *reinterpret_cast<float2*>(sacc + (kg * RB + r) * HD + 2 * cp) = acc[r];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = warp * RPW + i;
    if (r < RB && lane == 0) {
      sm[r] = m[i];
      sl[r] = l[i];
    }
  }
  __syncthreads();
  if (KG > 1) {
    for (int e = tid; e < RB * HD; e += kThreads) {
      float a = sacc[e];
#pragma unroll
      for (int gg = 1; gg < KG; ++gg) a += sacc[gg * RB * HD + e];
      sacc[e] = a;
    }
  }

  // Combine: every block of the cluster takes a share of the outputs and
  // reads all splits' (m, l, acc) through distributed shared memory.
  cluster.sync();
  const int n = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  // Every split's (m, l) in one parallel gather, then the factors locally.
  if (tid < n * RB) {
    const int s = tid / RB, r = tid % RB;
    sfac[tid] = cluster.map_shared_rank(sm, s)[r];
    sall[tid] = cluster.map_shared_rank(sl, s)[r];
  }
  __syncthreads();
  if (tid < RB) {
    float mm = kNegInf;
    for (int s = 0; s < n; ++s) mm = fmaxf(mm, sfac[s * RB + tid]);
    float ll = 0.f;
    for (int s = 0; s < n; ++s) {
      const float f = expf(sfac[s * RB + tid] - mm);
      sfac[s * RB + tid] = f;
      ll = fmaf(sall[s * RB + tid], f, ll);
    }
    sltot[tid] = fmaxf(ll, 1e-30f);
  }
  __syncthreads();
  constexpr int NG = RB * HD / 4;   // float4 groups of the output
  const int per = (NG + n - 1) / n;
  const int g_end = min(NG, (rank + 1) * per);
  T* ob = out + ((size_t)b * h + h0) * HD;
  for (int e4 = rank * per + tid; e4 < g_end; e4 += kThreads) {
    const int r = (4 * e4) / HD;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s) {
      if (s < n) {
        const float4 x = reinterpret_cast<const float4*>(cluster.map_shared_rank(sacc, s))[e4];
        const float f = sfac[s * RB + r];
        a.x = fmaf(x.x, f, a.x);
        a.y = fmaf(x.y, f, a.y);
        a.z = fmaf(x.z, f, a.z);
        a.w = fmaf(x.w, f, a.w);
      }
    }
    const float lt = sltot[r];
    store4<T>(ob + 4 * e4, make_float4(a.x / lt, a.y / lt, a.z / lt, a.w / lt));
  }
  cluster.sync();   // peers' shared memory stays valid until every share is read
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* lens;
  int len_scalar, chunk_scalar, b, h, kvh, hd, skv, n_split;
  long long ksb, kss, ksh, vsb, vss, vsh;
  float scale;
  void* out;
  cudaStream_t stream;
};

template <typename T, int HD, int RB>
int launch_rb(const Args& a) {
  auto kernel = decode_kernel<T, HD, RB>;
  constexpr int bytes = Smem<T, HD, RB>::BYTES;
  static bool attr_set = false;   // one attribute call per instantiation
  if (!attr_set) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.n_split, a.kvh * ((a.h / a.kvh) / RB), a.b);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = a.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.lens, a.len_scalar, a.chunk_scalar, a.skv, a.h, a.kvh,
      a.n_split, a.ksb, a.kss, a.ksh, a.vsb, a.vss, a.vsh, a.scale, static_cast<T*>(a.out));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int launch_hd(const Args& a) {
  const int rep = a.h / a.kvh;
  if (rep % 8 == 0) return launch_rb<T, HD, 8>(a);
  if (rep % 4 == 0) return launch_rb<T, HD, 4>(a);
  if (rep % 2 == 0) return launch_rb<T, HD, 2>(a);
  return launch_rb<T, HD, 1>(a);
}

template <typename T>
int launch(const Args& a) {
  if (a.b < 1 || a.kvh < 1 || a.h % a.kvh != 0 || a.n_split < 1 || a.n_split > kMaxSplits ||
      a.skv < 1)
    return (int)cudaErrorInvalidValue;
  switch (a.hd) {
    case 32: return launch_hd<T, 32>(a);
    case 64: return launch_hd<T, 64>(a);
    case 128: return launch_hd<T, 128>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* flash_decode_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// lens: a (B,) int32 device pointer, or null to use len_scalar (whose split
// length chunk_scalar = ceil(len / n_split) the caller passes). Strides in
// elements; the last dimension of k and v is contiguous; q and out are
// contiguous (B, H, hd). Every pointer and row stride is 16-byte aligned.
#define FLASH_DECODE_ENTRY(NAME, T)                                                          \
  int NAME(const void* q, const void* k, const void* v, const int* lens, int len_scalar,    \
           int chunk_scalar, int b, int h, int kvh, int hd, int skv, int n_split,           \
           long long ksb, long long kss, long long ksh, long long vsb, long long vss,        \
           long long vsh, float scale, void* out, void* stream) {                            \
    Args a{q,   k,   v,   lens, len_scalar, chunk_scalar, b,     h,   kvh,                    \
           hd,  skv, n_split, ksb, kss,     ksh,          vsb,   vss, vsh,                    \
           scale, out, static_cast<cudaStream_t>(stream)};                                    \
    return launch<T>(a);                                                                     \
  }

FLASH_DECODE_ENTRY(flash_decode_f32, float)
FLASH_DECODE_ENTRY(flash_decode_bf16, __nv_bfloat16)

}  // extern "C"
