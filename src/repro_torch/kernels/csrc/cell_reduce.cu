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
// (pp = 8, dp = 160, tp = 8) the inputs are 10,240 cells, about 90 KB in
// float32: the bytes take ~27 ns at 3.35 TB/s and the arithmetic less, far
// below the few microseconds any launch costs.
//
// The design: one block of 1,024 threads and no second launch. A
// grid-stride loop over cells computes the TP minima and stage times (kept
// in a scratch array the wrapper allocates), another the DP ring minima;
// after one barrier each thread takes DP groups for the stage maxima, the
// hop sums and the pipeline times, block reductions in shared memory give
// the pipeline maximum and the DP bottleneck, and thread 0 writes t. The
// hop sum runs sequentially from stage 0 up, the reference's own order (a
// pairwise order would drift the result in the last bits). Built with
// --fmad=false so every multiply and add rounds as in the reference.
#include <cuda_runtime.h>
#include <math.h>

namespace {

template <typename T> __device__ __forceinline__ bool is_nan(T v) { return v != v; }
// jnp.min / jnp.max semantics: NaN in either operand propagates.
template <typename T> __device__ __forceinline__ T min_nan(T a, T b) {
  return (is_nan(a) || a < b) ? a : b;
}
template <typename T> __device__ __forceinline__ T max_nan(T a, T b) {
  return (is_nan(a) || a > b) ? a : b;
}
template <typename T> __device__ __forceinline__ T inf_of();
template <> __device__ __forceinline__ float inf_of<float>() { return __int_as_float(0x7f800000); }
template <> __device__ __forceinline__ double inf_of<double>() {
  return __longlong_as_double(0x7ff0000000000000LL);
}

constexpr int kThreads = 1024;

template <typename T>
__global__ void __launch_bounds__(kThreads)
cell_reduce_kernel(const T* __restrict__ cell_speed, const T* __restrict__ tp_edge,
                   const T* __restrict__ dp_edge, const T* __restrict__ hop_bw,
                   const T* __restrict__ alloc_off, int pp, int dp, int tp, double c_flops_d,
                   double c_speed_d, double c_tp_d, double pp_vol_d, double c_dp_d,
                   T* __restrict__ t_out, T* __restrict__ stage_max, T* __restrict__ tp_bw,
                   T* __restrict__ dp_bw, T* __restrict__ stage) {
  __shared__ T red_max[kThreads / 32];
  __shared__ T red_min[kThreads / 32];
  const T c_flops = (T)c_flops_d;
  const T c_speed = (T)c_speed_d;
  const T c_tp = (T)c_tp_d;
  const T pp_vol = (T)pp_vol_d;
  const T c_dp = (T)c_dp_d;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int cells = pp * dp;

  // TP ring minima and the stage-time formula, one cell per iteration.
  for (int i = tid; i < cells; i += nt) {
    const T* e = tp_edge + (size_t)i * tp;
    T m = e[0];
    for (int k = 1; k < tp; ++k) m = min_nan(m, e[k]);
    tp_bw[i] = m;
    stage[i] = c_flops / (c_speed * cell_speed[i]) + c_tp / m;
  }
  // DP ring minima, one (stage, tp rank) ring per iteration.
  for (int j = tid; j < pp * tp; j += nt) {
    const int s = j / tp;
    const int k = j % tp;
    const T* e = dp_edge + (size_t)s * dp * tp + k;
    T m = e[0];
    for (int d = 1; d < dp; ++d) m = min_nan(m, e[(size_t)d * tp]);
    dp_bw[j] = m;
  }
  __syncthreads();

  // Per DP group: slowest stage, hop sum, 1F1B pipeline time.
  T pmax = -inf_of<T>();
  for (int d = tid; d < dp; d += nt) {
    T sm = stage[d];
    for (int s = 1; s < pp; ++s) sm = max_nan(sm, stage[(size_t)s * dp + d]);
    stage_max[d] = sm;
    T hop = T(0);
    for (int s = 0; s < pp - 1; ++s) hop += pp_vol / hop_bw[(size_t)s * dp + d];
    const T pipe = alloc_off[d] * sm + T(2) * hop;
    pmax = max_nan(pmax, pipe);
  }
  T dmin = inf_of<T>();
  for (int j = tid; j < pp * tp; j += nt) dmin = min_nan(dmin, dp_bw[j]);

  // Block reductions: warp shuffles, then one warp over the warp results.
  for (int off = 16; off > 0; off >>= 1) {
    pmax = max_nan(pmax, __shfl_xor_sync(0xffffffffu, pmax, off));
    dmin = min_nan(dmin, __shfl_xor_sync(0xffffffffu, dmin, off));
  }
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (lane == 0) {
    red_max[warp] = pmax;
    red_min[warp] = dmin;
  }
  __syncthreads();
  if (warp == 0) {
    const int nw = (nt + 31) / 32;
    pmax = lane < nw ? red_max[lane] : -inf_of<T>();
    dmin = lane < nw ? red_min[lane] : inf_of<T>();
    for (int off = 16; off > 0; off >>= 1) {
      pmax = max_nan(pmax, __shfl_xor_sync(0xffffffffu, pmax, off));
      dmin = min_nan(dmin, __shfl_xor_sync(0xffffffffu, dmin, off));
    }
    if (lane == 0) t_out[0] = pmax + c_dp / dmin;
  }
}

template <typename T>
int launch(const T* cell_speed, const T* tp_edge, const T* dp_edge, const T* hop_bw,
           const T* alloc_off, int pp, int dp, int tp, double c_flops, double c_speed,
           double c_tp, double pp_vol, double c_dp, T* t_out, T* stage_max, T* tp_bw, T* dp_bw,
           T* stage, cudaStream_t stream) {
  if (pp < 1 || dp < 1 || tp < 1) return (int)cudaErrorInvalidValue;
  cell_reduce_kernel<T><<<1, kThreads, 0, stream>>>(cell_speed, tp_edge, dp_edge, hop_bw,
                                                    alloc_off, pp, dp, tp, c_flops, c_speed,
                                                    c_tp, pp_vol, c_dp, t_out, stage_max, tp_bw,
                                                    dp_bw, stage);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* cell_reduce_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

int cell_reduce_f32(const float* cell_speed, const float* tp_edge, const float* dp_edge,
                    const float* hop_bw, const float* alloc_off, int pp, int dp, int tp,
                    double c_flops, double c_speed, double c_tp, double pp_vol, double c_dp,
                    float* t_out, float* stage_max, float* tp_bw, float* dp_bw, float* stage,
                    void* stream) {
  return launch<float>(cell_speed, tp_edge, dp_edge, hop_bw, alloc_off, pp, dp, tp, c_flops,
                       c_speed, c_tp, pp_vol, c_dp, t_out, stage_max, tp_bw, dp_bw, stage,
                       static_cast<cudaStream_t>(stream));
}

int cell_reduce_f64(const double* cell_speed, const double* tp_edge, const double* dp_edge,
                    const double* hop_bw, const double* alloc_off, int pp, int dp, int tp,
                    double c_flops, double c_speed, double c_tp, double pp_vol, double c_dp,
                    double* t_out, double* stage_max, double* tp_bw, double* dp_bw,
                    double* stage, void* stream) {
  return launch<double>(cell_speed, tp_edge, dp_edge, hop_bw, alloc_off, pp, dp, tp, c_flops,
                        c_speed, c_tp, pp_vol, c_dp, t_out, stage_max, tp_bw, dp_bw, stage,
                        static_cast<cudaStream_t>(stream));
}

}  // extern "C"
