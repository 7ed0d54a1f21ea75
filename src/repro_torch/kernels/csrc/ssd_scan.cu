// Mamba2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/ssd_scan.py, ssd_scan (the pallas_call at line
// 105; math in _kernel). x (B, S, H, P), dt (B, S, H) and a (H,) in float32,
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
// Q = 128, bf16) the function moves ~88 MB (~26 us at 3.35 TB/s) and does
// ~27 GFLOP (~27 us at the bf16 tensor-core peak).
//
// bfloat16: three kernels in one call, the chunk-parallel decomposition of
// the plain chunked route (models/ssm.py), every product on the tensor
// cores (wgmma, float32 accumulators):
//   (a) ssd_chunk_state: per (chunk, head) cum by a warp scan (written with
//       dt to a float32 scratch for (b) and (c)) and the chunk's own state
//       Δ_c = (x ⊙ w)ᵀ B (P x N), w_q = exp(cum_last - cum_q) dt_q, stored
//       in float32.
//   (b) ssd_state_pass, one thread per 8 state entries of a (batch, head):
//       walks the chunks in order with the state in float32 registers,
//       S <- S exp(cum_last) + Δ_c, writing the state entering each chunk
//       as bf16 hi and lo planes, and the final state in x's type.
//   (c) ssd_chunk_output: C Bᵀ once per (chunk, B/C group), kept in
//       float32; per head the decay mask is applied in registers on and
//       below the diagonal (tiles right of it are zeros) and the result is
//       the A operand of M x straight away; C S_prevᵀ is scaled by exp(cum_i)
//       into the same accumulators.
// (a) and (c) take kHeads heads of one B/C group a block: a producer warp
// brings the tiles in by TMA (128-byte swizzle) into a ring of slots, two
// consumer warpgroups compute (setmaxnreg moves the registers to them).
// Three operands carry float32 precision as a bf16 hi + lo pair (two
// products): M, x ⊙ w and S_prev. Each rounded once to bf16 put outputs that
// cancel outside the bf16 tolerance against the float32 recurrence at the
// forward shape (measured on the card, and in a float64 emulation of each
// rounding alone); so does Δ_c stored in bf16, hence float32.
// The design's own floor is its bytes: x is read twice, Δ_c (84 MB at the
// forward shape) and the S_prev planes (84 MB) are each written and read
// once, y written once: ~466 MB, ~0.14 ms at 3.35 TB/s, against the
// function's 88 MB. TMA fills Q, N and the P tile past the tensors' ends
// with zeros; it copies 16-byte multiples, which is why P and N must be
// multiples of 8 and x, B and C 16-byte aligned (the wrapper checks).
//
// float32: one kernel on the CUDA cores, which the float32 parity checks
// need (TF32 tensor cores would miss their 2e-4):
// * One block of 256 threads per (32 columns of P, head, batch). Row p of
//   the state depends only on column p of x, so P splits across blocks
//   with no communication.
// * The chunk loop runs inside the block (the TPU's sequential grid axis);
//   the 32 x N state lives in shared memory for the whole sequence.
// * Per chunk, C and B (Q x N) and the block's x columns (Q x 32) are staged
//   in shared memory, B's rows padded by one float so that a warp reading
//   one column of B hits 32 banks. The decay-masked score matrix is built
//   32 rows at a time (32 x Q floats), and each 32-row tile gives its rows
//   of y at once; ~178 KB of shared memory at Q = N = 128.
// * exp(cum_i - cum_j) is evaluated only where i >= j: above the diagonal
//   the exponent is positive and could overflow, and 0 * inf is NaN.
// * Products use explicit fmaf: the library is built with --fmad=false.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxQ = 128;
constexpr int kMaxN = 128;

// ------------------------------------------------------------------ float32
constexpr int kThreads = 256;
constexpr int kPB = 32;    // columns of P (rows of the state) per block
constexpr int kRT = 32;    // rows of the score matrix per tile

__host__ __device__ constexpr size_t smem_floats(int q, int n) {
  return (size_t)q * n           // C       [q][n]
         + (size_t)q * (n + 1)   // B       [q][n + 1]
         + (size_t)kRT * q       // scores  [kRT][q]
         + (size_t)q * kPB       // x       [q][kPB]
         + (size_t)kPB * (n + 1) // state   [kPB][n + 1]
         + 3 * (size_t)q;        // cum, dt, w
}

__global__ void __launch_bounds__(kThreads)
ssd_kernel_f32(const float* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ a, const float* __restrict__ bm,
               const float* __restrict__ cm, float* __restrict__ y, float* __restrict__ fstate,
               int s, int h, int p, int g, int n, int q, long long xsb, long long xss,
               long long xsh, long long bsb, long long bss, long long bsg, long long csb,
               long long css, long long csg) {
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

  const float* xb = x + (size_t)b * xsb + (size_t)hh * xsh + p0;
  const float* dtb = dt + (size_t)b * s * h + hh;
  const float* bb = bm + (size_t)b * bsb + (size_t)gg * bsg;
  const float* cb = cm + (size_t)b * csb + (size_t)gg * csg;
  float* yb = y + ((size_t)b * s * h + hh) * p + p0;
  const size_t ys = (size_t)h * p;   // y's stride along S

  for (int e = tid; e < kPB * np1; e += kThreads) ss[e] = 0.f;

  const int nc = s / q;
  const int ntile = (q + kRT - 1) / kRT;
  for (int c = 0; c < nc; ++c) {
    const int t0 = c * q;
    __syncthreads();   // the previous chunk's tiles and state update are done
    for (int e = tid; e < q * n; e += kThreads) {
      const int r = e / n, k = e - r * n;
      cs[e] = cb[(size_t)(t0 + r) * css + k];
      bs[r * np1 + k] = bb[(size_t)(t0 + r) * bss + k];
    }
    for (int e = tid; e < q * kPB; e += kThreads) {
      const int r = e / kPB, col = e - r * kPB;
      xs[e] = col < pc ? xb[(size_t)(t0 + r) * xss + col] : 0.f;
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
        if (lane < pc) yb[(size_t)(t0 + i) * ys + lane] = yv;
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
  float* fb = fstate + (((size_t)b * h + hh) * p + p0) * n;
  for (int e = tid; e < pc * n; e += kThreads) {
    const int r = e / n, k = e - r * n;
    fb[(size_t)r * n + k] = ss[r * np1 + k];
  }
}

int launch_f32(const void* x, const void* dt, const void* a, const void* bm, const void* cm,
               void* y, void* fstate, int b, int s, int h, int p, int g, int n, int q,
               const long long* st, cudaStream_t stream) {
  // Opt in to the largest shared-memory size any (Q, N) can ask for, once a
  // device (each device keeps its own opt-in).
  thread_local int opted_dev = -1;
  constexpr size_t max_bytes = sizeof(float) * smem_floats(kMaxQ, kMaxN);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (opted_dev != dev) {
    err = cudaFuncSetAttribute(ssd_kernel_f32, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)max_bytes);
    if (err != cudaSuccess) return (int)err;
    opted_dev = dev;
  }
  const size_t bytes = sizeof(float) * smem_floats(q, n);
  const dim3 grid((p + kPB - 1) / kPB, h, b);
  ssd_kernel_f32<<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const float*>(bm),
      static_cast<const float*>(cm), static_cast<float*>(y), static_cast<float*>(fstate), s,
      h, p, g, n, q, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8]);
  return (int)cudaGetLastError();
}

// ----------------------------------------------------------------- bfloat16
using bf16 = __nv_bfloat16;

constexpr int kPT = 64;                // columns of P per block of (a) and (c)
constexpr int kPassThreads = 128;      // threads per block of (b)
constexpr int kPassDepth = 8;          // chunks whose loads (b) keeps in flight

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return (uint32_t)__cvta_generic_to_shared(ptr);
}
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
// (v0, v1) as bf16 pairs hi + lo: hi the rounded values, lo the rounding
// error (exact in float32), rounded again; together ~16 bits of mantissa.
__device__ __forceinline__ void pack_split(float v0, float v1, uint32_t& hi, uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 r = __bfloat1622float2(h);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = pack(v0 - r.x, v1 - r.y);
}

struct Shape {
  int s, h, p, g, n, q, nc, ptiles, dt_bf16;
  long long xsb, xss, xsh, bsb, bss, bsg, csb, css, csg;
};

__host__ __device__ __forceinline__ int round16(int v) { return (v + 15) & ~15; }

// The (batch, head, chunk) tile of Δ_c, P x N float32 values, in (a)'s
// scratch.
__device__ __forceinline__ size_t tile_offset(const Shape& sh, int b, int hh, int c) {
  return (((size_t)b * sh.h + hh) * sh.nc + c) * sh.p * sh.n;
}

// Blocks of (a) and (c): a producer warpgroup and two consumer warpgroups,
// kHeads heads of one B/C group; tiles in 64-column boxes of bf16.
constexpr int kOutThreads = 384;             // producer warpgroup, two consumers
constexpr int kConsumers = 256;
constexpr int kHeads = 20;                   // heads per block
constexpr uint32_t kBox = 128 * 128;         // a 64-column box of 128 rows
constexpr uint32_t kSBox = 64 * 128;         // a 64-column box of 64 rows
// (c)'s ring of head slots: x box, S_prev hi, lo, then cum, dt and w (and a
// spare row), float32.
constexpr int kSlots = 3;
constexpr uint32_t kSlotHi = kBox;
constexpr uint32_t kSlotLo = kBox + 2 * kSBox;
constexpr uint32_t kSlotVec = kBox + 4 * kSBox;
constexpr uint32_t kSlotBytes = kSlotVec + 4 * kMaxQ * sizeof(float);
constexpr uint32_t kRing = 2 * kBox + kSlots * kSlotBytes;   // C, then the ring
constexpr size_t kSmemOut = 1024 + kRing + 8 * (1 + 2 * kSlots);   // slack, tiles, barriers
static_assert(kSlotBytes % 1024 == 0, "slots on 1,024-byte boundaries");
static_assert(2 * kBox <= kSlotLo, "B must fit in the last slot before its S_lo");

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets.
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
// A box of a 4-d (or 3-d) tensor map into shared memory; the barrier counts
// its bytes.
__device__ __forceinline__ void tma_load4(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                          int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void tma_load3(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                          int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}
// d (64 x 128) = (acc ? d : 0) + A (64 x 16) B (16 x 128), both K-major in
// shared memory.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}
// d (64 x 64) = (acc ? d : 0) + A (64 x 16) B (16 x 64), both K-major in
// shared memory.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}
// d (64 x 64) += A (64 x 16, bf16 in registers) B (16 x 64, MN-major in
// shared memory).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128) += A (64 x 16, bf16 in registers) B (16 x 128, MN-major in
// shared memory).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// (a) Chunk states of one (chunk, P tile) for kHeads heads of one B/C
// group, on wgmma fed by TMA: per head Δ_c = (x ⊙ w)ᵀ B (P x N), with
// w_q = exp(cum_last - cum_q) dt_q. A producer warp stages the block's dt
// once, scans each head's cum (cum and dt go to the scratch for (b) and
// (c), w into the head's slot) and brings B in once and each head's x by
// TMA. Two consumer warpgroups take the heads in turns: each builds
// (x ⊙ w)ᵀ as hi + lo bf16 fragments in registers (x ⊙ w rounded once to
// bf16 reaches y through the state, measured outside the bf16 tolerance at
// the forward shape), releases the slot, and runs m64n128k16 products
// against B read MN-major; Δ_c goes out in float32 from the accumulators.
constexpr int kStateSlots = 4;
constexpr uint32_t kXSlot = kBox + 1024;                          // x box, then w
constexpr uint32_t kDtBytes = kMaxQ * kHeads * sizeof(float);     // the block's dt
constexpr uint32_t kStateTiles = 2 * kBox + kStateSlots * kXSlot + kDtBytes;
constexpr size_t kSmemState = 1024 + kStateTiles + 8 * (1 + 2 * kStateSlots);
static_assert(kDtBytes % 1024 == 0, "barriers after the tiles, 8-byte aligned");

__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
// A bf16 pair times (w.x, w.y), split into hi and lo pairs.
__device__ __forceinline__ void scale_split(uint32_t v, float2 w, uint32_t& hi, uint32_t& lo) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
  pack_split(f.x * w.x, f.y * w.y, hi, lo);
}

__global__ void __launch_bounds__(kOutThreads, 1)
ssd_chunk_state(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tb,
                const void* __restrict__ dt, const float* __restrict__ a,
                float* __restrict__ delta, float* __restrict__ cum_out, Shape sh) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // Tiles on 1,024-byte boundaries: the swizzle repeats every 8 rows.
  unsigned char* base = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  unsigned char* bs = base;
  auto slot = [&](int i) { return base + 2 * kBox + (i % kStateSlots) * kXSlot; };
  float* dts = reinterpret_cast<float*>(base + 2 * kBox + kStateSlots * kXSlot);   // [q][head]
  const uint32_t bars = smem_u32(base + kStateTiles);   // B, then full and empty per slot
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + kStateSlots + s); };
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rep = sh.h / sh.g;
  const int hpg = (rep + kHeads - 1) / kHeads;   // blocks per group
  const int gg = blockIdx.x / hpg;
  const int h0 = gg * rep + (blockIdx.x - gg * hpg) * kHeads;
  const int nh = min(kHeads, gg * rep + rep - h0);
  const int c = blockIdx.y / sh.ptiles, pt = blockIdx.y - c * sh.ptiles;
  const int b = blockIdx.z;
  const int q = sh.q, n = sh.n, p0 = pt * kPT;
  const int t0 = c * q;
  if (tid == 0) {
    mbar_init(bars, 1);
    for (int s = 0; s < kStateSlots; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumers / 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp < 4) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp != 0) return;
    // Producer warp: B once; the block's dt (its heads are contiguous in
    // each row of dt); then per head cum, w and x.
    if (lane == 0) {
      mbar_expect_tx(bars, 2 * kBox);
      for (int k = 0; k < 2; ++k)
        tma_load4(smem_u32(bs) + k * kBox, &tb, bars, 64 * k, t0, gg, b);
    }
    for (int e = lane; e < q * nh; e += 32) {
      const int r = e / nh, i = e - r * nh;
      const size_t di = ((size_t)b * sh.s + t0 + r) * sh.h + h0 + i;
      dts[r * kHeads + i] = sh.dt_bf16 ? __bfloat162float(static_cast<const bf16*>(dt)[di])
                                       : static_cast<const float*>(dt)[di];
    }
    __syncwarp();
    for (int i = 0; i < nh; ++i) {
      const int s = i % kStateSlots;
      mbar_wait(empty(s), ((i / kStateSlots) & 1) ^ 1);   // the slot's previous head is done
      const int hh = h0 + i;
      // cum by a warp scan: lane l holds steps 4l .. 4l + 3.
      const float ah = a[hh];
      float d[4], v[4], run = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = 4 * lane + j;
        d[j] = r < q ? dts[r * kHeads + i] : 0.f;
        run += d[j] * ah;
        v[j] = run;
      }
      float tot = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, tot, off);
        if (lane >= off) tot += o;
      }
      const float before = tot - run;
      float* cg = cum_out + (((size_t)b * sh.h + hh) * sh.nc + c) * 2 * q;   // cum, dt
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = 4 * lane + j;
        v[j] += before;
        if (pt == 0 && r < q) {
          cg[r] = v[j];
          cg[q + r] = d[j];
        }
      }
      float lastv = v[0];
#pragma unroll
      for (int j = 1; j < 4; ++j) lastv = ((q - 1) & 3) == j ? v[j] : lastv;
      const float last = __shfl_sync(0xffffffffu, lastv, (q - 1) >> 2);
      float* ws = reinterpret_cast<float*>(slot(i) + kBox);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = 4 * lane + j;
        ws[r] = r < q ? expf(last - v[j]) * d[j] : 0.f;
      }
      __syncwarp();
      if (lane == 0) {
        mbar_expect_tx(full(s), kBox);
        tma_load4(smem_u32(slot(i)), &tx, full(s), p0, t0, hh, b);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int cw = (warp - 4) >> 2, wl = warp & 3;
  const int gr = lane >> 2, tc2 = 2 * (lane & 3);
  const int nk = round16(q) / 16;   // k-steps over the chunk
  const int pr = p0 + 16 * wl + gr;  // this thread's state rows: pr and pr + 8
  mbar_wait(bars, 0);
  for (int i = cw; i < nh; i += 2) {
    const int s = i % kStateSlots;
    mbar_wait(full(s), (i / kStateSlots) & 1);
    const uint32_t xs = smem_u32(slot(i));
    const float* ws = reinterpret_cast<const float*>(slot(i) + kBox);
    // A = (x ⊙ w)ᵀ: rows p (16 a warp), k = q; x is stored [q][p], swizzled.
    uint32_t ah[8][4], al[8][4];
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      if (ks < nk) {
        const int qr = 16 * ks + (lane & 7) + ((lane >> 4) << 3);
        const int pch = 2 * wl + ((lane >> 3) & 1);
        uint32_t r[4];
        ldsm4_t(r, xs + qr * 128 + ((pch ^ (qr & 7)) << 4));
        const float2 w0 = *reinterpret_cast<const float2*>(ws + 16 * ks + tc2);
        const float2 w1 = *reinterpret_cast<const float2*>(ws + 16 * ks + 8 + tc2);
        scale_split(r[0], w0, ah[ks][0], al[ks][0]);
        scale_split(r[1], w0, ah[ks][1], al[ks][1]);
        scale_split(r[2], w1, ah[ks][2], al[ks][2]);
        scale_split(r[3], w1, ah[ks][3], al[ks][3]);
      }
    }
    mbar_arrive(empty(s));   // x and w are in registers
    float acc[64];
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[e] = 0.f;
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      if (ks < nk) {
        const uint64_t db = gmma_desc(smem_u32(bs) + ks * 16 * 128, kBox, 1024);
        wgmma_rs_n128(acc, ah[ks], db);
        wgmma_rs_n128(acc, al[ks], db);
      }
    }
    wg_commit();
    wg_wait0();
    float* dst = delta + tile_offset(sh, b, h0 + i, c);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = 8 * j + tc2;
      if (col < n) {
        if (pr < sh.p)
          *reinterpret_cast<float2*>(dst + (size_t)pr * n + col) =
              make_float2(acc[4 * j], acc[4 * j + 1]);
        if (pr + 8 < sh.p)
          *reinterpret_cast<float2*>(dst + (size_t)(pr + 8) * n + col) =
              make_float2(acc[4 * j + 2], acc[4 * j + 3]);
      }
    }
  }
}

// (b) State passing: 8 state entries of one (batch, head) a thread, in
// float32 registers across the chunks. The state entering each chunk goes
// to `planes` as its bf16 hi and lo parts, two (P, N) planes a chunk.
__global__ void __launch_bounds__(kPassThreads)
ssd_state_pass(const float* __restrict__ delta, const float* __restrict__ cum,
               bf16* __restrict__ planes, bf16* __restrict__ fstate, int bh_count, int p, int n,
               int q, int nc) {
  const int n8 = n / 8;
  const long long idx = (long long)blockIdx.x * kPassThreads + threadIdx.x;
  if (idx >= (long long)bh_count * p * n8) return;
  const int col = (int)(idx % n8) * 8;
  const long long row = idx / n8;   // (bh, p)
  const int bh = (int)(row / p);
  const size_t cstride = (size_t)p * n;
  const float* base = delta + (size_t)bh * nc * cstride + (size_t)(row % p) * n + col;
  bf16* pbase = planes + (size_t)bh * nc * 2 * cstride + (size_t)(row % p) * n + col;
  const float* last = cum + (size_t)bh * nc * 2 * q + (q - 1);
  float st[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) st[j] = 0.f;
  for (int c0 = 0; c0 < nc; c0 += kPassDepth) {
    float4 d[kPassDepth][2];
    float decay[kPassDepth];
#pragma unroll
    for (int i = 0; i < kPassDepth; ++i) {
      if (c0 + i < nc) {
        const float4* src = reinterpret_cast<const float4*>(base + (size_t)(c0 + i) * cstride);
        d[i][0] = src[0];
        d[i][1] = src[1];
        decay[i] = last[(size_t)(c0 + i) * 2 * q];
      }
    }
#pragma unroll
    for (int i = 0; i < kPassDepth; ++i) {
      if (c0 + i < nc) {
        // The state entering chunk c0 + i, hi and lo parts.
        uint4 hi, lo;
        pack_split(st[0], st[1], hi.x, lo.x);
        pack_split(st[2], st[3], hi.y, lo.y);
        pack_split(st[4], st[5], hi.z, lo.z);
        pack_split(st[6], st[7], hi.w, lo.w);
        bf16* dst = pbase + (size_t)(c0 + i) * 2 * cstride;
        *reinterpret_cast<uint4*>(dst) = hi;
        *reinterpret_cast<uint4*>(dst + cstride) = lo;
        const float e = expf(decay[i]);
        const float dv[8] = {d[i][0].x, d[i][0].y, d[i][0].z, d[i][0].w,
                             d[i][1].x, d[i][1].y, d[i][1].z, d[i][1].w};
#pragma unroll
        for (int j = 0; j < 8; ++j) st[j] = st[j] * e + dv[j];
      }
    }
  }
  uint4 out;
  out.x = pack(st[0], st[1]);
  out.y = pack(st[2], st[3]);
  out.z = pack(st[4], st[5]);
  out.w = pack(st[6], st[7]);
  *reinterpret_cast<uint4*>(fstate + (size_t)row * n + col) = out;
}

// (c) Outputs of one (chunk, P tile) for kHeads heads of one B/C group, on
// wgmma, warp-specialized. One producer thread brings the tiles in by TMA
// (C and B once; per head x, the hi and lo planes of S_prev) into a ring
// of kSlots head slots, in the 128-byte swizzle wgmma reads; its warp
// copies the head's cum and dt and computes its w (below). Two consumer
// warpgroups compute: warpgroup
// cw takes rows 64 cw .. 64 cw + 63 of the chunk (warp w of it 16 of those
// rows). C Bᵀ (64 x 128 a warpgroup) is computed once and kept in its
// float32 accumulators for all heads. Per head: C S_prevᵀ (A = C, B = the
// planes, both K-major), scaled by exp(cum_i), then M x (A = M's hi and lo
// parts from registers, B = x read MN-major), into the same accumulators.
// mbarriers hand the slots over. Staging by cp.async (some 3,000 16-byte
// copies a head) measured slower on an H100: issuing them took longer than
// the head's products, whether the compute warps or a producer warpgroup
// issued them.
__global__ void __launch_bounds__(kOutThreads, 1)
ssd_chunk_output(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tc,
                 const __grid_constant__ CUtensorMap tb, const __grid_constant__ CUtensorMap ts,
                 const float* __restrict__ cumg, bf16* __restrict__ y, Shape sh) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // Tiles on 1,024-byte boundaries: the swizzle repeats every 8 rows.
  unsigned char* base = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  unsigned char* cs = base;
  auto slot = [&](int i) { return base + 2 * kBox + (i % kSlots) * kSlotBytes; };
  const uint32_t bars = smem_u32(base + kRing);   // C and B, then full and empty per slot
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + kSlots + s); };
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rep = sh.h / sh.g;
  const int hpg = (rep + kHeads - 1) / kHeads;   // blocks per group
  const int gg = blockIdx.x / hpg;
  const int h0 = gg * rep + (blockIdx.x - gg * hpg) * kHeads;
  const int nh = min(kHeads, gg * rep + rep - h0);
  const int c = blockIdx.y / sh.ptiles, pt = blockIdx.y - c * sh.ptiles;
  const int b = blockIdx.z;
  const int q = sh.q, p0 = pt * kPT, pc = min(kPT, sh.p - p0);
  const int t0 = c * q;
  if (tid == 0) {
    mbar_init(bars, 1);
    for (int s = 0; s < kSlots; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp < 4) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp != 0) return;
    // Producer warp: C and B once (B in the last slot, its first fill), then
    // per head its cum and dt (copied by the warp) and its tiles (TMA).
    if (lane == 0) {
      mbar_expect_tx(bars, 4 * kBox);
      for (int k = 0; k < 2; ++k) {
        tma_load4(smem_u32(cs) + k * kBox, &tc, bars, 64 * k, t0, gg, b);
        tma_load4(smem_u32(slot(kSlots - 1)) + k * kBox, &tb, bars, 64 * k, t0, gg, b);
      }
    }
    for (int i = 0; i < nh; ++i) {
      const int s = i % kSlots;
      const int fill = i / kSlots + (s == kSlots - 1);
      mbar_wait(empty(s), (fill & 1) ^ 1);   // the slot's previous fill is consumed
      const int hh = h0 + i;
      unsigned char* sl = slot(i);
      float* cum = reinterpret_cast<float*>(sl + kSlotVec);
      const float* cd = cumg + (((size_t)b * sh.h + hh) * sh.nc + c) * 2 * q;   // cum, dt
      for (int r = lane; r < kMaxQ; r += 32) {
        const bool ok = r < q;
        const float cr = ok ? cd[r] : 0.f, dr = ok ? cd[q + r] : 0.f;
        const float ce = ok ? cd[min(r | 15, q - 1)] : 0.f;   // cum at the end of r's block
        cum[r] = cr;
        cum[kMaxQ + r] = dr;
        cum[2 * kMaxQ + r] = ok ? __expf(ce - cr) * dr : 0.f;   // w_r, exponent <= 0
      }
      __syncwarp();
      if (lane == 0) {
        mbar_expect_tx(full(s), kBox + 4 * kSBox);
        tma_load4(smem_u32(sl), &tx, full(s), p0, t0, hh, b);
        const int plane = (((b * sh.h + hh) * sh.nc + c) * 2);
        for (int k = 0; k < 2; ++k) {
          tma_load3(smem_u32(sl + kSlotHi) + k * kSBox, &ts, full(s), 64 * k, p0, plane);
          tma_load3(smem_u32(sl + kSlotLo) + k * kSBox, &ts, full(s), 64 * k, p0, plane + 1);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int cw = (warp - 4) >> 2, wl = warp & 3;
  const int qp = round16(q), nk = round16(sh.n) / 16;
  const int gr = lane >> 2, tc2 = 2 * (lane & 3);
  const int strip = 4 * cw + wl;                 // the warp's 16 rows of the chunk
  const int ia = 16 * strip + gr, ib = ia + 8;   // this thread's rows
  const bool rows_live = 64 * cw < qp;           // the warpgroup has rows of the chunk
  const int mk = min(4 * cw + 4, qp / 16);       // its k-steps of M x
  const uint32_t cs_a = smem_u32(cs) + cw * 64 * 128;

  // C Bᵀ of the warpgroup's 64 rows, once for all heads (columns of B past
  // the chunk are masked in M).
  mbar_wait(bars, 0);
  float cbt[64];
  wg_fence();
  for (int k = 0; k < nk; ++k) {
    const uint32_t off = (k >> 2) * kBox + (k & 3) * 32;
    wgmma_ss_n128(cbt, gmma_desc(cs_a + off, 16, 1024),
                  gmma_desc(smem_u32(slot(kSlots - 1)) + off, 16, 1024), k > 0);
  }
  wg_commit();
  wg_wait0();
  mbar_arrive(empty(kSlots - 1));   // B is consumed

  for (int i = 0; i < nh; ++i) {
    const int s = i % kSlots;
    mbar_wait(full(s), (i / kSlots) & 1);
    const int hh = h0 + i;
    unsigned char* sl = slot(i);
    const float* cum = reinterpret_cast<const float*>(sl + kSlotVec);
    const float* dts = cum + kMaxQ;
    const float* ws = cum + 2 * kMaxQ;
    if (rows_live) {
      float acc[32];
      // The state entering the chunk: C (S_hi + S_lo)ᵀ over N.
      const uint32_t s_hi = smem_u32(sl + kSlotHi), s_lo = smem_u32(sl + kSlotLo);
      wg_fence();
      for (int k = 0; k < nk; ++k) {
        const uint32_t off = (k >> 2) * kBox + (k & 3) * 32;
        const uint32_t soff = (k >> 2) * kSBox + (k & 3) * 32;
        wgmma_ss_n64(acc, gmma_desc(cs_a + off, 16, 1024), gmma_desc(s_hi + soff, 16, 1024),
                     k > 0);
      }
      for (int k = 0; k < nk; ++k) {
        const uint32_t off = (k >> 2) * kBox + (k & 3) * 32;
        const uint32_t soff = (k >> 2) * kSBox + (k & 3) * 32;
        wgmma_ss_n64(acc, gmma_desc(cs_a + off, 16, 1024), gmma_desc(s_lo + soff, 16, 1024), 1);
      }
      wg_commit();
      // M = (C Bᵀ) ⊙ L ⊙ dt_j on and below the diagonal, as hi + lo bf16
      // parts (M rounded once to bf16 puts outputs that cancel outside the
      // bf16 tolerance), built while C S_prevᵀ runs. Below the diagonal
      // tile, exp(cum_i - cum_j) = exp(cum_i - c_e) exp(c_e - cum_j) with c_e
      // the cum at the end of j's 16-step block: both exponents <= 0, and
      // w_j = exp(c_e - cum_j) dt_j comes with the slot. The diagonal tile
      // takes each exp and the mask j <= i (exp(+) may be inf: the select
      // drops it); tiles right of it are zeros.
      const float ca = cum[ia], cbv = cum[ib];
      uint32_t ah[8][4], al[8][4];
#pragma unroll
      for (int cb = 0; cb < 8; ++cb) {
        if (cb < strip) {
          const float ce = cum[min(16 * cb + 15, q - 1)];
          const float ra = __expf(ca - ce), rb = __expf(cbv - ce);
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const float2 wj = *reinterpret_cast<const float2*>(ws + 16 * cb + 8 * u + tc2);
            const float* v = &cbt[4 * (2 * cb + u)];
            pack_split(v[0] * ra * wj.x, v[1] * ra * wj.y, ah[cb][2 * u], al[cb][2 * u]);
            pack_split(v[2] * rb * wj.x, v[3] * rb * wj.y, ah[cb][2 * u + 1],
                       al[cb][2 * u + 1]);
          }
        } else if (cb == strip) {
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int j0 = 16 * cb + 8 * u + tc2, j1 = j0 + 1;
            const float2 cj = *reinterpret_cast<const float2*>(cum + j0);
            const float2 dj = *reinterpret_cast<const float2*>(dts + j0);
            const float* v = &cbt[4 * (2 * cb + u)];
            float m[4];
            m[0] = j0 <= ia ? v[0] * __expf(ca - cj.x) * dj.x : 0.f;
            m[1] = j1 <= ia ? v[1] * __expf(ca - cj.y) * dj.y : 0.f;
            m[2] = j0 <= ib ? v[2] * __expf(cbv - cj.x) * dj.x : 0.f;
            m[3] = j1 <= ib ? v[3] * __expf(cbv - cj.y) * dj.y : 0.f;
            pack_split(m[0], m[1], ah[cb][2 * u], al[cb][2 * u]);
            pack_split(m[2], m[3], ah[cb][2 * u + 1], al[cb][2 * u + 1]);
          }
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) ah[cb][e] = al[cb][e] = 0u;
        }
      }
      wg_wait0();
      const float ea = __expf(ca), eb = __expf(cbv);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[4 * j] *= ea;
        acc[4 * j + 1] *= ea;
        acc[4 * j + 2] *= eb;
        acc[4 * j + 3] *= eb;
      }
      // Within the chunk: + M x.
      const uint32_t xs = smem_u32(sl);
      wg_fence();
#pragma unroll
      for (int cb = 0; cb < 8; ++cb) {
        if (cb < mk) {
          const uint64_t dx = gmma_desc(xs + cb * 16 * 128, kBox, 1024);
          wgmma_rs_n64(acc, ah[cb], dx);
          wgmma_rs_n64(acc, al[cb], dx);
        }
      }
      wg_commit();
      wg_wait0();
      bf16* yb = y + ((size_t)b * sh.s + t0) * sh.h * sh.p + (size_t)hh * sh.p + p0;
      const size_t ys = (size_t)sh.h * sh.p;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 8 * j + tc2;
        if (col < pc) {
          if (ia < q)
            *reinterpret_cast<uint32_t*>(yb + ia * ys + col) = pack(acc[4 * j], acc[4 * j + 1]);
          if (ib < q)
            *reinterpret_cast<uint32_t*>(yb + ib * ys + col) =
                pack(acc[4 * j + 2], acc[4 * j + 3]);
        }
      }
    }
    mbar_arrive(empty(s));   // the slot is consumed
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

// A bf16 tensor map of `rank` dimensions (innermost first; strides of the
// outer ones in elements), boxes of 64 columns x `rows` rows, 128-byte
// swizzle; elements out of bounds read as zeros.
int make_map(CUtensorMap* map, const void* ptr, int rank, const long long* dims,
             const long long* strides, int rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  cuuint64_t d[4], st[3];
  cuuint32_t box[4], estr[4];
  for (int i = 0; i < rank; ++i) {
    d[i] = (cuuint64_t)dims[i];
    box[i] = i == 0 ? 64 : i == 1 ? (cuuint32_t)rows : 1;
    estr[i] = 1;
    if (i > 0) st[i - 1] = (cuuint64_t)strides[i - 1] * sizeof(bf16);
  }
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr), d,
                        st, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

int launch_bf16(const void* x, const void* dt, int dt_bf16, const void* a, const void* bm,
                const void* cm, void* y, void* fstate, void* delta, void* planes, void* cum,
                int b, int s, int h, int p, int g, int n, int q, const long long* st,
                cudaStream_t stream) {
  // TMA copies 16-byte multiples: P and N in whole 8-value chunks, aligned
  // rows.
  if (p % 8 != 0 || n % 8 != 0) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 9; ++i)
    if (st[i] % 8 != 0) return (int)cudaErrorInvalidValue;
  const void* ptrs[] = {x, bm, cm, delta, planes, y, fstate};
  for (const void* ptr : ptrs)
    if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0) return (int)cudaErrorInvalidValue;
  // The shared-memory opt-in is kept per device: set it on a device the
  // host thread has not launched on last.
  thread_local int opted_dev = -1;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (opted_dev != dev) {
    err = cudaFuncSetAttribute(ssd_chunk_state, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kSmemState);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(ssd_chunk_output, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)kSmemOut);
    if (err != cudaSuccess) return (int)err;
    opted_dev = dev;
  }
  Shape sh;
  sh.s = s; sh.h = h; sh.p = p; sh.g = g; sh.n = n; sh.q = q;
  sh.nc = s / q;
  sh.ptiles = (p + kPT - 1) / kPT;
  sh.dt_bf16 = dt_bf16;
  sh.xsb = st[0]; sh.xss = st[1]; sh.xsh = st[2];
  sh.bsb = st[3]; sh.bss = st[4]; sh.bsg = st[5];
  sh.csb = st[6]; sh.css = st[7]; sh.csg = st[8];
  // Tensor maps of (a) and (c): x (P, S, H, B), C and B (N, S, G, B), the
  // planes (N, P, B H S/Q 2); boxes of 64 columns by a chunk's 128 rows (64
  // for the planes).
  CUtensorMap mx, mc, mb, ms;
  const long long xd[4] = {p, s, h, b}, xs[3] = {st[1], st[2], st[0]};
  const long long cd[4] = {n, s, g, b};
  const long long css[3] = {st[7], st[8], st[6]}, bss[3] = {st[4], st[5], st[3]};
  const long long sd[3] = {n, p, (long long)b * h * sh.nc * 2}, sst[2] = {n, (long long)p * n};
  int e = make_map(&mx, x, 4, xd, xs, kMaxQ);
  if (e == 0) e = make_map(&mc, cm, 4, cd, css, kMaxQ);
  if (e == 0) e = make_map(&mb, bm, 4, cd, bss, kMaxQ);
  if (e == 0) e = make_map(&ms, planes, 3, sd, sst, kPT);
  if (e != 0) return e;
  float* dl = static_cast<float*>(delta);
  float* cf = static_cast<float*>(cum);

  const int rep = h / g;
  const dim3 grid(g * ((rep + kHeads - 1) / kHeads), sh.nc * sh.ptiles, b);
  ssd_chunk_state<<<grid, kOutThreads, kSmemState, stream>>>(
      mx, mb, dt, static_cast<const float*>(a), dl, cf, sh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long threads = (long long)b * h * p * (n / 8);
  ssd_state_pass<<<(unsigned)((threads + kPassThreads - 1) / kPassThreads), kPassThreads, 0,
                   stream>>>(dl, cf, static_cast<bf16*>(planes), static_cast<bf16*>(fstate),
                             b * h, p, n, q, sh.nc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ssd_chunk_output<<<grid, kOutThreads, kSmemOut, stream>>>(mx, mc, mb, ms, cf,
                                                             static_cast<bf16*>(y), sh);
  return (int)cudaGetLastError();
}

bool bad_shape(int b, int s, int h, int p, int g, int n, int q) {
  return b < 1 || h < 1 || p < 1 || g < 1 || h % g != 0 || n < 1 || n > kMaxN || q < 1 ||
         q > kMaxQ || s % q != 0;
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
  if (bad_shape(b, s, h, p, g, n, q)) return (int)cudaErrorInvalidValue;
  return launch_f32(x, dt, a, bm, cm, y, fstate, b, s, h, p, g, n, q, strides,
                    static_cast<cudaStream_t>(stream));
}

// As ssd_scan_f32, but dt is a contiguous (B, S, H) in bf16 (dt_bf16 = 1)
// or float32, and the caller gives three contiguous scratch tensors: delta,
// float32 (B, H, S / Q, P, N) (each chunk's own state); planes, bf16 (B, H,
// S / Q, 2, P, N) (the state entering each chunk, hi and lo parts); cum,
// float32 (B, H, S / Q, 2, Q) (cum and dt per chunk). P and N are
// multiples of 8; x, B, C, y, the final state, delta and planes are 16-byte
// aligned, and the strides multiples of 8.
int ssd_scan_bf16(const void* x, const void* dt, int dt_bf16, const void* a, const void* bm,
                  const void* cm, void* y, void* fstate, void* delta, void* planes, void* cum,
                  int b, int s, int h, int p, int g, int n, int q, const long long* strides,
                  void* stream) {
  if (bad_shape(b, s, h, p, g, n, q)) return (int)cudaErrorInvalidValue;
  return launch_bf16(x, dt, dt_bf16, a, bm, cm, y, fstate, delta, planes, cum, b, s, h, p, g,
                     n, q, strides, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
