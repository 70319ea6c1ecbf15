// Instance-norm statistics of a channels_last activation, for Hopper.
//
// Replaces p2p_tpu/ops/pallas/instance_norm_kernel.py:_stats_local (kernel
// body _stats_kernel) together with the mean/rstd arithmetic that
// norm_act.py:_fwd_impl does between the two Pallas passes:
//   mean = sum(x) / HW,  var = max(sum(x^2) / HW - mean^2, 0),
//   rstd = rsqrt(var + eps),  per (n, c), f32 accumulation.
//
// Bound on the card: bytes. The kernel reads x once (N*H*W*C elements) and
// writes 2*N*C floats; at 3.35 TB/s a 1024x512 pix2pixHD epilogue of 32 MB
// bf16 needs at least ~10 us. There are 3 flops per element, far below the
// card's rate.
//
// Design. The TPU kernel walks H in a sequential grid and accumulates into
// the same output tile; Hopper blocks run in parallel and in no order, so
// pass 1 writes per-chunk partials and pass 2 sums them in a fixed order
// (moments_partial.cuh, shared with the BatchNorm moments kernel): no float
// atomics, the same bits on every run. The host side
// (ops/cuda/instance_norm_kernel.py stats_geometry) picks the vector width,
// block shape and P so that both ends of the path's shapes fill the card:
// channel blocks at (16, 32, 1024), pixel chunks at (512, 1024, 32).
//
// The launches are one chain of programmatic dependent launches. Pass 1 is
// an ordinary launch: the launch before it is the conv that writes x, which
// never lets dependents start early, so pass 1 starts once x is complete.
// It lets dependents start at its top, and the finalize is launched as its
// dependent (p2p::launch_dependent): its blocks become resident while pass
// 1 runs and wait in griddepcontrol.wait, before any read of a partial, for
// pass 1's end. The finalize too lets dependents start at its top, so the
// epilogue launched after it (#2, #3 or #4, norm_act.cu) becomes resident
// in the same way. The partials are summed in the same fixed order as with
// two ordinary launches, so mean and rstd keep the same bits.
//
// The sharded form (a spatial mesh: x is one rank's block of rows) splits
// the chain at the collective. p2p_instance_norm_sums is pass 1 and a
// dependent launch that stops at the fixed-order (N, C) sums of x and x^2
// (the same order as the finalize above); the caller all-reduces them over
// the spatial group; p2p_instance_norm_finalize turns the global sums and
// the global count (the sum of the ranks' H*W, exact on uneven rows) into
// mean and rstd with the arithmetic above. The finalize follows a
// collective (an NCCL kernel, or gloo's copies through the host), which
// never lets dependents start early, so it is an ordinary launch and
// waits for nothing; it lets the epilogue launched after it (#2 or #3)
// start at its top as before.

#include "moments_partial.cuh"

namespace {

__global__ void __launch_bounds__(32 * p2p::kFinalizeRows)
    stats_finalize_kernel(const float* __restrict__ part_s1,
                          const float* __restrict__ part_s2,
                          float* __restrict__ mean, float* __restrict__ rstd,
                          int num_p, int c, float count, float eps) {
  // the epilogue launched after this one as a programmatic dependent (#2,
  // #3 or #4, norm_act.cu) may start now and wait for this grid's end
  p2p::allow_dependents();
  // every block waits for pass 1's end before it reads a partial
  p2p::grid_dependency_wait();
  float a, b;
  if (!p2p::sum_partials(part_s1, part_s2, num_p, c, &a, &b)) return;
  // separately rounded steps, no fused multiply-add: the variance of a
  // (nearly) constant channel is then the same rounding residual as in the
  // plain version instead of another one
  const float m = a / count;
  const float var = fmaxf(__fsub_rn(b / count, __fmul_rn(m, m)), 0.f);
  const int64_t o = static_cast<int64_t>(blockIdx.y) * c + blockIdx.x * 32 +
                    threadIdx.x;
  mean[o] = m;
  rstd[o] = rsqrtf(var + eps);
}

__global__ void __launch_bounds__(32 * p2p::kFinalizeRows)
    sums_finalize_kernel(const float* __restrict__ part_s1,
                         const float* __restrict__ part_s2,
                         float* __restrict__ s1, float* __restrict__ s2,
                         int num_p, int c) {
  p2p::grid_dependency_wait();
  float a, b;
  if (!p2p::sum_partials(part_s1, part_s2, num_p, c, &a, &b)) return;
  const int64_t o = static_cast<int64_t>(blockIdx.y) * c + blockIdx.x * 32 +
                    threadIdx.x;
  s1[o] = a;
  s2[o] = b;
}

constexpr int kStatsThreads = 256;

__global__ void __launch_bounds__(kStatsThreads)
    stats_from_sums_kernel(const float* __restrict__ s1,
                           const float* __restrict__ s2,
                           float* __restrict__ mean, float* __restrict__ rstd,
                           int64_t nc, float count, float eps) {
  // the epilogue launched after this one as a programmatic dependent may
  // start now and wait for this grid's end
  p2p::allow_dependents();
  const int64_t o = static_cast<int64_t>(blockIdx.x) * kStatsThreads +
                    threadIdx.x;
  if (o >= nc) return;
  // the arithmetic of stats_finalize_kernel
  const float m = s1[o] / count;
  const float var = fmaxf(__fsub_rn(s2[o] / count, __fmul_rn(m, m)), 0.f);
  mean[o] = m;
  rstd[o] = rsqrtf(var + eps);
}

}  // namespace

// x: (N, H*W, C) in memory (channels_last), dtype p2p::DType; vec is 16 bytes
// worth of elements (C % vec == 0 and x 16-byte aligned) or 1.
// part_s1/part_s2: (N, num_p, C) f32 scratch; mean/rstd: (N, C) f32.
// Pass 1 is an ordinary launch, the finalize its programmatic dependent.
// Returns the first CUDA error of the two launches (0 = success).
extern "C" int p2p_instance_norm_stats(
    const void* x, int dtype, int n, int64_t hw, int c, int vec, int tx,
    int ty, int cblocks, int num_p, int64_t chunk, float* part_s1,
    float* part_s2, float* mean, float* rstd, float eps, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const cudaError_t err = p2p::launch_moments_partial(
      x, dtype, vec, part_s1, part_s2, n, hw, c, tx, ty, cblocks, num_p, chunk,
      stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(p2p::launch_dependent(
      stats_finalize_kernel, dim3((c + 31) / 32, n),
      dim3(32, p2p::kFinalizeRows), stream, part_s1, part_s2, mean, rstd,
      num_p, c, static_cast<float>(hw), eps));
}

// The sums entry of the sharded form: pass 1, then its dependent sum of the
// partials into s1/s2, (N, C) f32 each. Arguments as above.
extern "C" int p2p_instance_norm_sums(const void* x, int dtype, int n,
                                      int64_t hw, int c, int vec, int tx,
                                      int ty, int cblocks, int num_p,
                                      int64_t chunk, float* part_s1,
                                      float* part_s2, float* s1, float* s2,
                                      void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const cudaError_t err = p2p::launch_moments_partial(
      x, dtype, vec, part_s1, part_s2, n, hw, c, tx, ty, cblocks, num_p, chunk,
      stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(p2p::launch_dependent(
      sums_finalize_kernel, dim3((c + 31) / 32, n),
      dim3(32, p2p::kFinalizeRows), stream, part_s1, part_s2, s1, s2, num_p,
      c));
}

// The finalize of the sharded form: mean/rstd (nc = N*C floats each) from
// the all-reduced sums and the global count; an ordinary launch.
extern "C" int p2p_instance_norm_finalize(const float* s1, const float* s2,
                                          float* mean, float* rstd,
                                          int64_t nc, float count, float eps,
                                          void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int64_t blocks = (nc + kStatsThreads - 1) / kStatsThreads;
  stats_from_sums_kernel<<<static_cast<unsigned>(blocks), kStatsThreads, 0,
                           stream>>>(s1, s2, mean, rstd, nc, count, eps);
  return static_cast<int>(cudaGetLastError());
}
