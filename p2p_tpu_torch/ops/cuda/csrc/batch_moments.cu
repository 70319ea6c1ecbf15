// BatchNorm's one-read channel moments, for Hopper.
//
// Replaces p2p_tpu/ops/pallas/batch_moments.py:76 pallas_dual_moments
// (kernel body _moments_kernel): on an (M, C) view of the shifted
// activation xc = x - running_mean, (sum xc, sum xc^2) per channel in f32,
// reading xc once.
//
// Bound on the card: bytes. The kernel reads M*C elements and writes 2*C
// floats; the reference preset's 50 launches per train step read ~80 MB of
// bf16, ~24 us at 3.35 TB/s. There are 2 flops per element. Most launches
// on the train steps read 4 KB to 1 MB, where a launch's round trips to
// memory, not the bytes, set its time.
//
// Design. The TPU kernel accumulates over a sequential M grid into one
// revisited (1, C) output block; Hopper blocks run in parallel and in no
// order, so this is the instance-norm statistics design with N = 1
// (moments_partial.cuh): chunks of M across blocks write f32 partials of
// shape (P, C), threads run along C in 16-byte vectors where C and the
// alignment allow (one element each otherwise: C = 3 after the k9 head),
// and a second launch sums the partials in a fixed order. No float atomics,
// so a train step gives the same bits on every run. The host side
// (ops/cuda/batch_moments.py) picks the launch shape with the statistics
// kernel's stats_geometry; that plan and sum_partials fix the order of the
// sums, so the launches below give the same sums whatever their shape.
// - Where one chunk covers M (P = 1: the U-Net's innermost levels), pass 1
//   writes the sums and there is no second launch.
// - The finalize gives each block 8 channels (each with the 32 thread rows
//   of sum_partials), so it spreads over C/8 SMs instead of C/32.
// - Programmatic dependent launch: the finalize is launched with
//   cudaLaunchAttributeProgrammaticStreamSerialization, and pass 1 allows
//   it to start as soon as every pass-1 block is running
//   (griddepcontrol.launch_dependents at its top). The finalize's blocks
//   wait in griddepcontrol.wait, which returns once pass 1 has ended and its
//   stores are visible, so the second launch's latency overlaps pass 1
//   instead of following it. Under stream capture the pair becomes a
//   programmatic edge of the graph.

#include "moments_partial.cuh"

namespace {

constexpr int kFinalizeWidth = 8;  // channels a finalize block

__global__ void __launch_bounds__(kFinalizeWidth * p2p::kFinalizeRows)
    sums_finalize_kernel(const float* __restrict__ part_s1,
                         const float* __restrict__ part_s2,
                         float* __restrict__ s1, float* __restrict__ s2,
                         int num_p, int c) {
  p2p::grid_dependency_wait();
  float a, b;
  if (!p2p::sum_partials<kFinalizeWidth>(part_s1, part_s2, num_p, c, &a,
                                         &b)) {
    return;
  }
  const int cc = blockIdx.x * kFinalizeWidth + threadIdx.x;
  s1[cc] = a;
  s2[cc] = b;
}

cudaError_t launch_finalize(const float* part_s1, const float* part_s2,
                            float* s1, float* s2, int num_p, int c,
                            cudaStream_t stream) {
  return p2p::launch_dependent(
      sums_finalize_kernel, dim3((c + kFinalizeWidth - 1) / kFinalizeWidth),
      dim3(kFinalizeWidth, p2p::kFinalizeRows), stream, part_s1, part_s2, s1,
      s2, num_p, c);
}

}  // namespace

// xc: (M, C) row-major, dtype p2p::DType; vec is 16 bytes worth of elements
// (C % vec == 0 and xc 16-byte aligned) or 1. part_s1/part_s2: (num_p, C)
// f32 scratch, or s1/s2 themselves when num_p == 1; s1/s2: (C,) f32.
// Returns the first CUDA error of the launches (0 = success).
extern "C" int p2p_batch_moments(const void* xc, int dtype, int64_t m, int c,
                                 int vec, int tx, int ty, int cblocks,
                                 int num_p, int64_t chunk, float* part_s1,
                                 float* part_s2, float* s1, float* s2,
                                 void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const cudaError_t err = p2p::launch_moments_partial(
      xc, dtype, vec, part_s1, part_s2, 1, m, c, tx, ty, cblocks, num_p, chunk,
      stream);
  if (err != cudaSuccess || num_p == 1) return static_cast<int>(err);
  return static_cast<int>(
      launch_finalize(part_s1, part_s2, s1, s2, num_p, c, stream));
}
