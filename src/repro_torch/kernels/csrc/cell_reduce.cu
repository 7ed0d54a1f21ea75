// Simulator reduction tree in one launch, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/cell_reduce.py, cell_reduce (the pallas_call
// at line 111; math in _fused_reduce). From the simulator's measured
// per-cell arrays it computes the TP ring minima, the per-cell stage time,
// the per-DP-group stage maximum, the DP ring minima, twice the activation
// hop sum over pp - 1 and the 1F1B critical path plus the DP all-reduce:
// (t, stage_max, tp_bw, dp_bw).
//
// What bounds it on the H100: launch latency. At the 10,240-device job
// (pp = 8, dp = 160, tp = 8) the inputs are 23,040 values, 184 KB in
// float64: the bytes take ~55 ns at 3.35 TB/s and the arithmetic less, far
// below the ~5 us that even an empty launch takes between two CUDA events
// on this card. After the launch the time is a chain of dependent steps:
// the first read of the parameters, one trip to L2 for the cells, a few
// shuffle rounds and IEEE divisions, one store into another SM and its
// barrier. The design keeps that chain short.
//
// The design:
// * One thread-block cluster of up to 8 blocks of 512 threads; block b
//   takes `span` dp columns. Each thread loads its cells from device memory
//   straight into registers, all of its loads at once and coalesced (a
//   warp's lanes read consecutive values), so every input value is read
//   once. Only the DP ring minima and the pipeline maximum cross blocks:
//   each block stores them into block 0's shared memory (distributed
//   shared memory) by st.async, whose bytes complete on an mbarrier there.
// * Why not stage the cells in shared memory by bulk copies (TMA): that
//   design was built and measured first, one block and then a cluster,
//   and stayed slower in every variant. Barrier set-up, the copy engine
//   taking one copy at a time and the copies' own latency land the cells
//   in shared memory well after plain loads land them in registers, and
//   every pass then reads them again. One block alone also pulls all 184
//   KB through one SM and runs every pass at one SM's instruction rate (the
//   first design of this kernel, one block, took 13.9 us).
// * The narrow kernel (pp <= G and tp <= G, G = 8 or 16 lanes a dp column)
//   needs no block barrier. Column warps: a warp takes 32 / G columns with
//   every stage; for each stage its lanes read the columns' TP edges (lane
//   q edge q), and a reduce-scatter by shuffles leaves stage q's TP minimum
//   on lane q, which computes the stage time; a shuffle tree gives the
//   column's stage maximum, and the hop quotients, gathered by shuffles
//   while the TP minima reduce, are summed in stage order from stage 0 up
//   (the reference's own order: a pairwise order would drift the result in
//   the last bits). DP warps: a warp takes a stage's DP edges, its lanes tp
//   rings of 32 / tp rows at a step, and a shuffle tree gives the rings'
//   minima. In block 0 the last warp reduces the rings across blocks (and
//   c_dp / dmin) as soon as they arrive, warp 0 the pipeline maxima, and a
//   named barrier joins them for t.
// * The general kernel (any other shape) works in passes of 512 / 2^lg dp
//   columns: row tasks (a warp a TP row, its TP minima by shuffle trees
//   into shared memory; a warp a DP row, its ring minima in registers, kept
//   as running values across passes), one block barrier, then the column
//   pass (2^lg lanes a column: stage times, the stage maximum by a shuffle
//   tree, the hop quotients summed from stage 0 through shared memory).
//   Block 0's warp 0 reduces everything.
// * Shared memory holds only what is combined, so any dp streams through.
//   The launch fails (the wrapper names the limit) only where block 0's
//   gather of every block's pp tp ring minima does not fit. Dynamic shared
//   memory is opted in once per device.
// * Precision: the input type Tin and the arithmetic type T. float64 cells
//   with float32 arithmetic (the simulator's packed route) are rounded on
//   load with __double2float_rn, the same round-to-nearest-even as
//   .to(torch.float32), so that route is bit-identical to the float32 one.
//   NaN propagates through every minimum and maximum (jnp.min / jnp.max;
//   min.NaN / max.NaN in float32). Built with --fmad=false so every
//   multiply and add rounds as in the reference.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <initializer_list>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocks = 8;   // the portable cluster size

template <typename T> __device__ __forceinline__ bool is_nan(T v) { return v != v; }
// jnp.min / jnp.max semantics: NaN in either operand propagates.
template <typename T> __device__ __forceinline__ T min_nan(T a, T b) {
  return (is_nan(a) || a < b) ? a : b;
}
template <typename T> __device__ __forceinline__ T max_nan(T a, T b) {
  return (is_nan(a) || a > b) ? a : b;
}
template <> __device__ __forceinline__ float min_nan<float>(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}
template <> __device__ __forceinline__ float max_nan<float>(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}
template <typename T> __device__ __forceinline__ T inf_of();
template <> __device__ __forceinline__ float inf_of<float>() { return __int_as_float(0x7f800000); }
template <> __device__ __forceinline__ double inf_of<double>() {
  return __longlong_as_double(0x7ff0000000000000LL);
}

// An input value, read once from device memory, in the arithmetic type.
template <typename Tin, typename T> struct Load {
  static __device__ __forceinline__ T cvt(Tin v) { return v; }
  static __device__ __forceinline__ T of(const Tin* p) { return cvt(__ldg(p)); }
};
template <> struct Load<double, float> {
  static __device__ __forceinline__ float cvt(double v) { return __double2float_rn(v); }
  static __device__ __forceinline__ float of(const double* p) { return cvt(__ldg(p)); }
};
// Rows a lane loads at once, before it reduces any: one trip to memory.
constexpr int kBatch = 8;

__host__ __device__ __forceinline__ long long round16(long long b) { return (b + 15) / 16 * 16; }

// The launch's parameters, 128 bytes: two lines of the constant cache,
// both touched as the kernel starts, so their first reads go out together.
template <typename Tin, typename T>
struct Args {
  const Tin* src[5];   // cell_speed, tp_edge, dp_edge, hop_bw, alloc_off, each in its own shape
  T* out[4];           // t, stage_max, tp_bw, dp_bw
  double k[5];         // c_flops, c_speed, c_tp, pp_vol, c_dp
  int pp, dp, tp;
  int span;            // dp columns a block (the last may take fewer)
};

// Shared memory: the gather barrier; block 0's gather of every block's ring
// minima ([block][ring]) and warp maxima ([block][warp]); a pass's TP
// minima ([stage][column]); the DP warps' partial ring minima
// ([unit][warp of the unit][lane]); the threads' hop quotients.
struct Smem {
  long long gather, tpmin, part, quot, total;
};

__host__ __device__ __forceinline__ Smem smem_of(int pp, int dp, int tp, int span,
                                                 int acc_bytes) {
  const long long blocks = (dp + span - 1) / span;
  const long long rings = (long long)pp * tp, units = (long long)pp * ((tp + 31) / 32);
  Smem m;
  long long o = 16;   // the barrier
  m.gather = o; o += round16((blocks * (rings + kWarps) + 1) * acc_bytes);
  m.tpmin = o;  o += round16((long long)pp * kThreads * acc_bytes);
  m.part = o;   o += (units > kWarps ? units : kWarps) * 32 * acc_bytes;
  m.quot = o;   o += (long long)kThreads * acc_bytes;
  m.total = o;
  return m;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// Waits for a phase that other blocks of the cluster complete.
__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred P1;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
// The address in block 0's shared memory of this block's shared address.
__device__ __forceinline__ uint32_t in_block0(uint32_t addr) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, 0;\n" : "=r"(remote) : "r"(addr));
  return remote;
}
// Store v at `addr` of block 0 (st.async); its bytes complete on block 0's
// barrier `bar`, so a wait there sees the value.
__device__ __forceinline__ void push(uint32_t addr, float v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n" ::"r"(addr),
      "r"(__float_as_uint(v)), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void push(uint32_t addr, double v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b64 [%0], %1, [%2];\n" ::"r"(addr),
      "l"(__double_as_longlong(v)), "r"(bar)
      : "memory");
}

template <typename Tin, typename T>
__global__ void __launch_bounds__(kThreads, 1)
cell_reduce_kernel(const __grid_constant__ Args<Tin, T> a) {
  extern __shared__ __align__(128) unsigned char smem[];
  using L = Load<Tin, T>;
  // Both lines of the parameters at once.
  const Tin* const src0 = a.src[0];
  const int span = a.span;
  asm volatile("" ::"l"(src0), "r"(span));
  const int rank = (int)cg::this_cluster().block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const uint32_t bar_g = smem_addr(smem);
  const int pp = a.pp, dp = a.dp, tp = a.tp, rings = pp * tp;
  const int blocks = (dp + span - 1) / span;
  const int lo = rank * span;
  const int n = dp - lo < span ? dp - lo : span;   // this block's columns
  // Block 0's gather barrier, set before the cluster barrier's phase 1,
  // which every block waits on before its first store into block 0.
  if (rank == 0 && tid == 0) {
    mbar_init(bar_g, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_arrive_expect_tx(bar_g, blocks * (rings + kWarps) * sizeof(T));
  }
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  const Smem off = smem_of(pp, dp, tp, span, sizeof(T));
  T* gather = reinterpret_cast<T*>(smem + off.gather);
  T* tpmin = reinterpret_cast<T*>(smem + off.tpmin);
  T* part = reinterpret_cast<T*>(smem + off.part);
  T* quot = reinterpret_cast<T*>(smem + off.quot);
  // This block's columns of each array (rows dp, or dp tp, values apart).
  const Tin* cs0 = src0 + lo;
  const Tin* tpe0 = a.src[1] + (long long)lo * tp;
  const Tin* dpe0 = a.src[2] + (long long)lo * tp;
  const Tin* hop0 = a.src[3] + lo;
  const Tin* alloc0 = a.src[4] + lo;
  T* const t_out = a.out[0];
  T* const stage_max = a.out[1];
  T* const tp_bw = a.out[2];
  T* const dp_bw = a.out[3];

  // Column pass: 2^lg lanes a dp column, a stage each (every 2^lg-th above
  // 32), in passes of per_pass columns.
  int lg = 0;
  while ((1 << lg) < pp && lg < 5) ++lg;
  const int g = 1 << lg, per_pass = kThreads >> lg;
  // Row tasks: the TP rows of the pp stages (units 0..pp-1), then the DP
  // rings by (stage, chunk of up to 32 rings) (units pp..); `wpu` warps a
  // unit. A warp's lanes take rpw rows (dp columns) of ccols values at a
  // step, consecutive in device memory.
  const int nkc = (tp + 31) / 32, dunits = pp * nkc, units = pp + dunits;
  const int wpu = units >= kWarps ? 1 : kWarps / units;
  const int ccols = tp < 32 ? tp : 32, rpw = 32 / ccols, span_l = ccols * rpw;
  const int cl = lane % ccols, rl = lane / ccols, wi = warp % wpu;
  const T c_flops = (T)a.k[0];
  const T c_speed = (T)a.k[1];
  const T c_tp = (T)a.k[2];
  const T pp_vol = (T)a.k[3];
  T pmax = -inf_of<T>();
#pragma unroll 1
  for (int c0 = 0; c0 < n; c0 += per_pass) {
    const int nc = n - c0 < per_pass ? n - c0 : per_pass;
    // This thread's cell of the column pass: its loads go out first.
    const int col = tid >> lg, q = tid & (g - 1);
    const bool on = col < nc;
    // Raw values, converted where they are used: a conversion here would
    // wait for its load before the row tasks' loads go out.
    Tin cs = Tin(1), hb = Tin(1), alloc = Tin(0);
    if (on && q < pp) {
      cs = __ldg(cs0 + (long long)q * dp + c0 + col);
      if (q < pp - 1) hb = __ldg(hop0 + (long long)q * dp + c0 + col);
      if (q == 0) alloc = __ldg(alloc0 + c0 + col);
    }
    // Row tasks.
#pragma unroll 1
    for (int u = warp / wpu; u < units; u += kWarps / wpu) {
      const int step = wpu * rpw;   // rows between a lane's rows
      if (u < pp) {
        // TP row of stage u: the minimum of each cell's tp edges (a lane's
        // share of kBatch rows loaded at once, then a shuffle tree a row).
        const Tin* e = tpe0 + (long long)u * dp * tp + (long long)c0 * tp + cl;
        const bool in = lane < span_l;
#pragma unroll 1
        for (int rb = wi * rpw; rb < nc; rb += kBatch * step) {
          // Every lane loads (rows past the end read row 0 and are masked),
          // so the kBatch loads go out back to back.
          Tin v[kBatch];
#pragma unroll
          for (int i = 0; i < kBatch; ++i) {
            const int r = rb + i * step + rl;
            v[i] = __ldg(e + (in && r < nc ? (long long)r * tp : 0));
          }
          T m[kBatch];
#pragma unroll
          for (int i = 0; i < kBatch; ++i)
            m[i] = in && rb + i * step + rl < nc ? L::cvt(v[i]) : inf_of<T>();
          if (tp > 32) {   // a cell's further chunks of 32 edges
#pragma unroll 1
            for (int i = 0; i < kBatch; ++i) {
              const int r = rb + i * step + rl;
              if (in && r < nc)
                for (int k = 32; cl + k < tp; k += 32)
                  m[i] = min_nan(m[i], L::of(e + (long long)r * tp + k));
            }
          }
          // The cells' trees, a round for all kBatch rows at a time.
#pragma unroll
          for (int sh = 1; sh < 32; sh <<= 1) {
            if (sh < ccols) {
#pragma unroll
              for (int i = 0; i < kBatch; ++i) {
                const T o = __shfl_down_sync(0xffffffffu, m[i], sh);
                if (cl + sh < ccols) m[i] = min_nan(m[i], o);
              }
            }
          }
#pragma unroll
          for (int i = 0; i < kBatch; ++i) {
            const int r = rb + i * step + rl;
            if (in && cl == 0 && r < nc) tpmin[u * per_pass + r] = m[i];
          }
        }
      } else {
        // DP rings (stage s, chunk kc) over this pass's columns: the warp's
        // rows in registers (kBatch loads at once), its lanes of one ring by
        // a shuffle tree, kept as the warp's running minima in `part`.
        const int du = u - pp, s = du / nkc, kc = du - s * nkc;
        const int cc = tp - kc * 32 < 32 ? tp - kc * 32 : 32;
        const Tin* e = dpe0 + (long long)s * dp * tp + (long long)c0 * tp + kc * 32 + cl;
        T m = inf_of<T>();
        const bool in = lane < span_l && cl < cc;
#pragma unroll 1
        for (int rb = wi * rpw + rl; rb < nc; rb += kBatch * step) {
          Tin v[kBatch];
#pragma unroll
          for (int i = 0; i < kBatch; ++i)
            v[i] = __ldg(e + (in && rb + i * step < nc ? (long long)(rb + i * step) * tp : 0));
#pragma unroll
          for (int i = 0; i < kBatch; ++i)
            if (in && rb + i * step < nc) m = min_nan(m, L::cvt(v[i]));
        }
        for (int sh = ccols; sh < span_l; sh <<= 1) {
          const T o = __shfl_down_sync(0xffffffffu, m, sh);
          if (lane + sh < span_l) m = min_nan(m, o);
        }
        if (lane < cc) {
          T* run = part + (du * wpu + wi) * 32 + lane;
          *run = c0 == 0 ? m : min_nan(*run, m);
        }
      }
    }
    __syncthreads();

    // Column pass: stage times, the column's stage maximum (shuffle tree),
    // the hop quotients summed from stage 0 on the column's first lane, the
    // 1F1B pipeline time.
    T sm = -inf_of<T>(), hop = T(0);
#pragma unroll 1
    for (int s0 = 0; s0 < pp; s0 += g) {
      const int s = s0 + q;
      T qv = T(0);
      if (on && s < pp) {
        if (s0 > 0) {
          cs = __ldg(cs0 + (long long)s * dp + c0 + col);
          hb = s < pp - 1 ? __ldg(hop0 + (long long)s * dp + c0 + col) : Tin(1);
        }
        const T m = tpmin[s * per_pass + col];
        tp_bw[(long long)s * dp + lo + c0 + col] = m;
        sm = max_nan(sm, c_flops / (c_speed * L::cvt(cs)) + c_tp / m);
        if (s < pp - 1) qv = pp_vol / L::cvt(hb);
      }
      quot[tid] = qv;
      __syncwarp();
      if (on && q == 0) {
        const int last = pp - 1 - s0 < g ? pp - 1 - s0 : g;
#pragma unroll 4
        for (int t = 0; t < last; ++t) hop += quot[tid + t];
      }
      __syncwarp();
    }
    for (int sh = g >> 1; sh > 0; sh >>= 1)
      sm = max_nan(sm, __shfl_xor_sync(0xffffffffu, sm, sh));
    if (on && q == 0) {
      stage_max[lo + c0 + col] = sm;
      pmax = max_nan(pmax, L::cvt(alloc) * sm + T(2) * hop);
    }
    if (c0 + per_pass < n) __syncthreads();   // tpmin is written next by the row tasks
  }

  // The warp's pipeline maximum: over its columns' first lanes (every g-th).
  for (int sh = 16; sh >= g; sh >>= 1)
    pmax = max_nan(pmax, __shfl_xor_sync(0xffffffffu, pmax, sh));
  __syncthreads();

  // Into block 0: this block's ring minima and each warp's maximum.
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  const uint32_t g0 = in_block0(smem_addr(gather)), gbar = in_block0(bar_g);
  for (int j = tid; j < rings; j += kThreads) {
    const int s = j / tp, k = j - s * tp;
    const int du = s * nkc + k / 32;
    T m = part[du * wpu * 32 + k % 32];
#pragma unroll 1
    for (int w = 1; w < wpu; ++w) m = min_nan(m, part[(du * wpu + w) * 32 + k % 32]);
    push(g0 + (uint32_t)((rank * rings + j) * sizeof(T)), m, gbar);
  }
  if (lane == 0)
    push(g0 + (uint32_t)((blocks * rings + rank * kWarps + warp) * sizeof(T)), pmax, gbar);
  if (rank != 0 || warp != 0) return;

  // Block 0, warp 0: the DP ring minima across blocks, the DP bottleneck, t.
  mbar_wait_cluster(bar_g, 0);
  T dmin = inf_of<T>();
#pragma unroll 2
  for (int j = lane; j < rings; j += 32) {
    T m = gather[j];
#pragma unroll
    for (int b = 1; b < kMaxBlocks; ++b)
      if (b < blocks) m = min_nan(m, gather[b * rings + j]);
    dp_bw[j] = m;
    dmin = min_nan(dmin, m);
  }
  const T* wmax = gather + blocks * rings;
  pmax = -inf_of<T>();
#pragma unroll 4
  for (int j = lane; j < blocks * kWarps; j += 32) pmax = max_nan(pmax, wmax[j]);
  const T c_dp = (T)a.k[4];
  for (int sh = 16; sh > 0; sh >>= 1) {
    pmax = max_nan(pmax, __shfl_xor_sync(0xffffffffu, pmax, sh));
    dmin = min_nan(dmin, __shfl_xor_sync(0xffffffffu, dmin, sh));
  }
  if (lane == 0) t_out[0] = pmax + c_dp / dmin;
}

// The narrow case, pp <= G and tp <= G (G = 8 or 16, the lanes of one dp
// column): no pass needs another warp's results, so no block barrier.
// Column warps: a warp takes 32 / G dp columns at a time with every stage.
// For each stage its lanes read the columns' tp edges, consecutive in
// device memory (lane q edge q), all of a lane's loads at once; a shuffle
// tree over the column's G lanes gives every stage's TP minimum; lane q
// then takes stage q: its stage time and hop quotient; a shuffle tree
// gives the column's stage maximum, and its first lane gathers the
// quotients by shuffles in stage order and sums them from stage 0 up.
// DP warps: a warp takes a stage's rows of DP edges, its lanes tp rings of
// 32 / tp rows at a step, and stores the rings' minima into block 0.
template <typename Tin, typename T, int G>
__global__ void __launch_bounds__(kThreads, 1)
cell_reduce_narrow(const __grid_constant__ Args<Tin, T> a) {
  extern __shared__ __align__(128) unsigned char smem[];
  using L = Load<Tin, T>;
  constexpr unsigned kAll = 0xffffffffu;
  const Tin* const src0 = a.src[0];
  const int span = a.span;
  asm volatile("" ::"l"(src0), "r"(span));
  const int rank = (int)cg::this_cluster().block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // Block 0's gather barriers: the rings' minima, the pipeline maxima.
  const uint32_t bar_d = smem_addr(smem), bar_p = bar_d + 8;
  const int pp = a.pp, dp = a.dp, tp = a.tp, rings = pp * tp;
  const int blocks = (dp + span - 1) / span;
  const int lo = rank * span;
  const int n = dp - lo < span ? dp - lo : span;   // this block's columns
  const int dwarps = pp < kWarps / 2 ? pp : kWarps / 2, cwarps = kWarps - dwarps;
  // Block 0's gather barriers, set by the last warp (a DP warp, which has
  // time to spare) before the cluster barrier's phase 1, which every
  // block waits on before its first store into block 0. Every block
  // stores its ring minima and its column warps' maxima there.
  if (rank == 0 && tid == kThreads - 1) {
    mbar_init(bar_d, 1);
    mbar_init(bar_p, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_arrive_expect_tx(bar_d, blocks * rings * sizeof(T));
    mbar_arrive_expect_tx(bar_p, blocks * cwarps * sizeof(T));
  }
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  // [block][ring] minima, [block][column warp] maxima, then c_dp / dmin.
  T* gather = reinterpret_cast<T*>(smem + smem_of(pp, dp, tp, span, sizeof(T)).gather);
  const uint32_t g0 = in_block0(smem_addr(gather));
  const Tin* cs0 = src0 + lo;
  const Tin* tpe0 = a.src[1] + (long long)lo * tp;
  const Tin* dpe0 = a.src[2] + (long long)lo * tp;
  const Tin* hop0 = a.src[3] + lo;
  const Tin* alloc0 = a.src[4] + lo;

  T pmax = -inf_of<T>();
  if (warp < cwarps) {
    const T c_flops = (T)a.k[0];
    const T c_speed = (T)a.k[1];
    const T c_tp = (T)a.k[2];
    const T pp_vol = (T)a.k[3];
    const int q = lane & (G - 1);
#pragma unroll 1
    for (int c0 = warp * (32 / G); c0 < n; c0 += cwarps * (32 / G)) {
      const int col = c0 + lane / G;
      const bool on = col < n;
      const int cx = on ? col : 0;   // columns past the end read column 0
      // Edge q of the column in each stage (stages past pp read the last,
      // lanes past tp edge 0); offsets fit 32 bits on this path.
      const Tin* ce = tpe0 + cx * tp + (q < tp ? q : 0);
      const unsigned row = (unsigned)(dp * tp);
      Tin v[G];
#pragma unroll
      for (int s = 0; s < G; ++s) v[s] = __ldg(ce + (unsigned)(s < pp ? s : pp - 1) * row);
      const Tin csv = __ldg(cs0 + (unsigned)((q < pp ? q : 0) * dp + cx));
      const Tin hbv = q < pp - 1 ? __ldg(hop0 + (unsigned)(q * dp + cx)) : Tin(1);
      const Tin alv = __ldg(alloc0 + cx);
      // The divisions that need no TP minimum go first, and the hop
      // quotients are gathered (in stage order) under the TP trees.
      const T flops = c_flops / (c_speed * L::cvt(csv));
      const T qv = q < pp - 1 ? pp_vol / L::cvt(hbv) : T(0);
      T hq[G - 1];
#pragma unroll
      for (int t = 0; t < G - 1; ++t) hq[t] = __shfl_sync(kAll, qv, t, G);
      // TP minima by reduce-scatter over the column's G lanes: lane q ends
      // with stage q's (edges past tp hold inf).
      T m[G];
#pragma unroll
      for (int s = 0; s < G; ++s) m[s] = q < tp ? L::cvt(v[s]) : inf_of<T>();
#pragma unroll
      for (int h = G / 2; h >= 1; h >>= 1) {
        const bool up = q & h;
#pragma unroll
        for (int j = 0; j < h; ++j) {
          const T recv = __shfl_xor_sync(kAll, up ? m[j] : m[j + h], h);
          m[j] = min_nan(up ? m[j + h] : m[j], recv);
        }
      }
      T st = -inf_of<T>();
      if (on && q < pp) {
        a.out[2][(unsigned)(q * dp + lo + col)] = m[0];
        st = flops + c_tp / m[0];
      }
#pragma unroll
      for (int sh = 1; sh < G; sh <<= 1) st = max_nan(st, __shfl_xor_sync(kAll, st, sh));
      T hop = T(0);
#pragma unroll
      for (int t = 0; t < G - 1; ++t)
        if (t < pp - 1) hop += hq[t];
      if (on && q == 0) {
        a.out[1][lo + col] = st;
        pmax = max_nan(pmax, L::cvt(alv) * st + T(2) * hop);
      }
    }
    for (int sh = 16; sh >= G; sh >>= 1) pmax = max_nan(pmax, __shfl_xor_sync(kAll, pmax, sh));
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    if (lane == 0)
      push(g0 + (uint32_t)((blocks * rings + rank * cwarps + warp) * sizeof(T)), pmax,
           in_block0(bar_p));
  } else {
    // DP rows: lanes (rl, k) take ring k of rows rl, rl + rpw, ...
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    const int rpw = 32 / tp, span_l = tp * rpw, k = lane % tp, rl = lane / tp;
    const bool in = lane < span_l;
#pragma unroll 1
    for (int s = warp - cwarps; s < pp; s += dwarps) {
      const Tin* e = dpe0 + (long long)s * dp * tp + k;
      T m = inf_of<T>();
#pragma unroll 1
      for (int rb = rl; rb < n; rb += kBatch * rpw) {
        Tin v[kBatch];
#pragma unroll
        for (int i = 0; i < kBatch; ++i)
          v[i] = __ldg(e + (in && rb + i * rpw < n ? (long long)(rb + i * rpw) * tp : 0));
#pragma unroll
        for (int i = 0; i < kBatch; ++i)
          if (in && rb + i * rpw < n) m = min_nan(m, L::cvt(v[i]));
      }
      for (int sh = tp; sh < span_l; sh <<= 1) {
        const T o = __shfl_down_sync(kAll, m, sh);
        if (lane + sh < span_l) m = min_nan(m, o);
      }
      if (lane < tp)
        push(g0 + (uint32_t)((rank * rings + s * tp + lane) * sizeof(T)), m, in_block0(bar_d));
    }
  }
  if (rank != 0 || (warp != 0 && warp != kWarps - 1)) return;
  T* cdd = gather + blocks * (rings + cwarps);
  if (warp == kWarps - 1) {
    // Block 0's last warp: the DP ring minima across blocks, the DP
    // bottleneck and its all-reduce term c_dp / dmin, handed to warp 0.
    mbar_wait_cluster(bar_d, 0);
    T dmin = inf_of<T>();
#pragma unroll 2
    for (int j = lane; j < rings; j += 32) {
      T m = gather[j];
#pragma unroll
      for (int b = 1; b < kMaxBlocks; ++b)
        if (b < blocks) m = min_nan(m, gather[b * rings + j]);
      a.out[3][j] = m;
      dmin = min_nan(dmin, m);
    }
    for (int sh = 16; sh > 0; sh >>= 1) dmin = min_nan(dmin, __shfl_xor_sync(kAll, dmin, sh));
    if (lane == 0) *cdd = (T)a.k[4] / dmin;
    asm volatile("bar.arrive 1, 64;\n" ::: "memory");
    return;
  }
  // Block 0, warp 0: the pipeline maximum across blocks, then t.
  mbar_wait_cluster(bar_p, 0);
  const T* wmax = gather + blocks * rings;
  pmax = -inf_of<T>();
#pragma unroll 4
  for (int j = lane; j < blocks * cwarps; j += 32) pmax = max_nan(pmax, wmax[j]);
  for (int sh = 16; sh > 0; sh >>= 1) pmax = max_nan(pmax, __shfl_xor_sync(kAll, pmax, sh));
  asm volatile("bar.sync 1, 64;\n" ::: "memory");
  if (lane == 0) a.out[0][0] = pmax + *cdd;
}

__global__ void empty_kernel() {}

// The most dynamic shared memory a block may opt in to on the current device.
cudaError_t smem_limit(int* dev, int* limit) {
  cudaError_t err = cudaGetDevice(dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, *dev);
  return err;
}

// Blocks of `span` dp columns: at most kMaxBlocks.
bool valid(int pp, int dp, int tp, int span) {
  return pp >= 1 && dp >= 1 && tp >= 1 && span >= 1 && (dp + span - 1) / span <= kMaxBlocks;
}

template <typename Tin, typename T>
int launch(const Tin* const src[5], int pp, int dp, int tp, int span, double c_flops,
           double c_speed, double c_tp, double pp_vol, double c_dp, T* t_out, T* stage_max,
           T* tp_bw, T* dp_bw, cudaStream_t stream) {
  if (!valid(pp, dp, tp, span)) return (int)cudaErrorInvalidValue;
  int dev = 0, limit = 0;
  cudaError_t err = smem_limit(&dev, &limit);
  if (err != cudaSuccess) return (int)err;
  const long long smem = smem_of(pp, dp, tp, span, sizeof(T)).total;
  if (smem > limit) return (int)cudaErrorInvalidValue;
  // The narrow kernel where pp and tp fit the lanes of one column (and
  // its 32-bit offsets fit the edge arrays).
  const int wide = pp > tp ? pp : tp;
  const bool small = (long long)pp * dp * tp < (1LL << 31);
  void (*kernel)(Args<Tin, T>) = small && wide <= 8    ? cell_reduce_narrow<Tin, T, 8>
                                 : small && wide <= 16 ? cell_reduce_narrow<Tin, T, 16>
                                                       : cell_reduce_kernel<Tin, T>;
  // Above the default 48 KB a kernel needs the opt-in, which each device
  // keeps for itself: set it once per device, to the device's limit.
  static std::atomic<unsigned long long> opted{0};
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (smem > 48 * 1024 && !(opted.load() & bit)) {
    for (auto k : {cell_reduce_narrow<Tin, T, 8>, cell_reduce_narrow<Tin, T, 16>,
                   cell_reduce_kernel<Tin, T>}) {
      err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
      if (err != cudaSuccess) return (int)err;
    }
    opted.fetch_or(bit);
  }
  Args<Tin, T> a;
  for (int i = 0; i < 5; ++i) a.src[i] = src[i];
  a.out[0] = t_out;
  a.out[1] = stage_max;
  a.out[2] = tp_bw;
  a.out[3] = dp_bw;
  a.k[0] = c_flops;
  a.k[1] = c_speed;
  a.k[2] = c_tp;
  a.k[3] = pp_vol;
  a.k[4] = c_dp;
  a.pp = pp;
  a.dp = dp;
  a.tp = tp;
  a.span = span;
  const int blocks = (dp + span - 1) / span;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* cell_reduce_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Bytes of shared memory a block of the launch takes (arithmetic of
// acc_bytes a value): the launch fails where this is above
// cell_reduce_smem_limit(), the most the current device gives a block.
// -1 on invalid arguments or a CUDA error.
long long cell_reduce_smem_bytes(int pp, int dp, int tp, int span, int acc_bytes) {
  if (!valid(pp, dp, tp, span)) return -1;
  return smem_of(pp, dp, tp, span, acc_bytes).total;
}
int cell_reduce_smem_limit() {
  int dev = 0, limit = 0;
  return smem_limit(&dev, &limit) == cudaSuccess ? limit : -1;
}

// One empty block of the kernel's width: the launch floor a one-launch
// design cannot pass (timed beside the kernel, never on its path).
int cell_reduce_empty(void* stream) {
  empty_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

// The five arrays (cell_speed, tp_edge, dp_edge, hop_bw, alloc_off), each
// contiguous in its own shape, at src[0..4]; blocks of `span` dp columns.
// f32 and f64: arithmetic in the input type; f64_f32: float64 cells,
// float32 arithmetic and results, each input rounded on load.
int cell_reduce_f32(const float* const* src, int pp, int dp, int tp, int span, double c_flops,
                    double c_speed, double c_tp, double pp_vol, double c_dp, float* t_out,
                    float* stage_max, float* tp_bw, float* dp_bw, void* stream) {
  return launch<float, float>(src, pp, dp, tp, span, c_flops, c_speed, c_tp, pp_vol, c_dp, t_out,
                              stage_max, tp_bw, dp_bw, static_cast<cudaStream_t>(stream));
}

int cell_reduce_f64(const double* const* src, int pp, int dp, int tp, int span, double c_flops,
                    double c_speed, double c_tp, double pp_vol, double c_dp, double* t_out,
                    double* stage_max, double* tp_bw, double* dp_bw, void* stream) {
  return launch<double, double>(src, pp, dp, tp, span, c_flops, c_speed, c_tp, pp_vol, c_dp,
                                t_out, stage_max, tp_bw, dp_bw, static_cast<cudaStream_t>(stream));
}

int cell_reduce_f64_f32(const double* const* src, int pp, int dp, int tp, int span,
                        double c_flops, double c_speed, double c_tp, double pp_vol, double c_dp,
                        float* t_out, float* stage_max, float* tp_bw, float* dp_bw,
                        void* stream) {
  return launch<double, float>(src, pp, dp, tp, span, c_flops, c_speed, c_tp, pp_vol, c_dp,
                               t_out, stage_max, tp_bw, dp_bw, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
