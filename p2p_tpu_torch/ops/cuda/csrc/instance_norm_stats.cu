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
// the same output tile; Hopper blocks run in parallel and in no order, so:
//   pass 1 (stats_partial): grid (channel blocks, pixel chunks P, N). Threads
//     run along C in 16-byte vectors (neighbouring threads read neighbouring
//     addresses of one pixel row; the rows a warp covers are contiguous in
//     channels_last), and along pixels inside the chunk, four loads in
//     flight per thread. Each block reduces its rows in shared memory in a
//     fixed order and writes one (n, p, c) partial.
//   pass 2 (stats_finalize): one thread column per (n, c) sums the P
//     partials in a fixed order and writes mean and rstd.
// No float atomics: the result is the same bits on every run. The host side
// (ops/cuda/instance_norm_kernel.py _stats_geometry) picks the vector width,
// block shape and P so that both ends of the path's shapes fill the card:
// channel blocks at (16, 32, 1024), pixel chunks at (512, 1024, 32).

#include "common.cuh"

namespace {

using p2p::Pack;

template <typename T, int VEC>
__device__ __forceinline__ void accumulate(const Pack<T, VEC>& v, float* s1,
                                           float* s2) {
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    const float f = p2p::to_f32(v.v[k]);
    s1[k] += f;
    s2[k] += f * f;
  }
}

template <typename T, int VEC>
__global__ void stats_partial_kernel(const T* __restrict__ x,
                                     float* __restrict__ part_s1,
                                     float* __restrict__ part_s2, int64_t hw,
                                     int c, int64_t chunk) {
  const int n = blockIdx.z;
  const int p = blockIdx.y;
  const int num_p = gridDim.y;
  const int c0 = (blockIdx.x * blockDim.x + threadIdx.x) * VEC;

  float s1[VEC], s2[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) s1[k] = s2[k] = 0.f;

  if (c0 < c) {
    const T* base = x + static_cast<int64_t>(n) * hw * c + c0;
    const int64_t end = static_cast<int64_t>(p + 1) * chunk;
    const int64_t pix1 = end < hw ? end : hw;
    const int64_t step = blockDim.y;
    int64_t q = static_cast<int64_t>(p) * chunk + threadIdx.y;
    for (; q + 3 * step < pix1; q += 4 * step) {
      const Pack<T, VEC> a = p2p::load_pack<T, VEC>(base + q * c);
      const Pack<T, VEC> b = p2p::load_pack<T, VEC>(base + (q + step) * c);
      const Pack<T, VEC> d = p2p::load_pack<T, VEC>(base + (q + 2 * step) * c);
      const Pack<T, VEC> e = p2p::load_pack<T, VEC>(base + (q + 3 * step) * c);
      accumulate(a, s1, s2);
      accumulate(b, s1, s2);
      accumulate(d, s1, s2);
      accumulate(e, s1, s2);
    }
    for (; q < pix1; q += step) {
      accumulate(p2p::load_pack<T, VEC>(base + q * c), s1, s2);
    }
  }

  // reduce the blockDim.y rows of the block in a fixed order
  extern __shared__ float smem[];
  const int width = blockDim.x * VEC;
  float* sh1 = smem;
  float* sh2 = smem + blockDim.y * width;
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    sh1[threadIdx.y * width + threadIdx.x * VEC + k] = s1[k];
    sh2[threadIdx.y * width + threadIdx.x * VEC + k] = s2[k];
  }
  __syncthreads();
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int col = tid; col < width;
       col += static_cast<int>(blockDim.x * blockDim.y)) {
    const int cc = blockIdx.x * width + col;
    if (cc >= c) continue;
    float a = 0.f, b = 0.f;
    for (int r = 0; r < static_cast<int>(blockDim.y); ++r) {
      a += sh1[r * width + col];
      b += sh2[r * width + col];
    }
    const int64_t o = (static_cast<int64_t>(n) * num_p + p) * c + cc;
    part_s1[o] = a;
    part_s2[o] = b;
  }
}

constexpr int kFinalizeRows = 32;

__global__ void stats_finalize_kernel(const float* __restrict__ part_s1,
                                      const float* __restrict__ part_s2,
                                      float* __restrict__ mean,
                                      float* __restrict__ rstd, int num_p,
                                      int c, float count, float eps) {
  __shared__ float sh1[kFinalizeRows][32];
  __shared__ float sh2[kFinalizeRows][32];
  const int n = blockIdx.y;
  const int cc = blockIdx.x * 32 + threadIdx.x;
  float a = 0.f, b = 0.f;
  if (cc < c) {
    for (int p = threadIdx.y; p < num_p; p += kFinalizeRows) {
      const int64_t o = (static_cast<int64_t>(n) * num_p + p) * c + cc;
      a += part_s1[o];
      b += part_s2[o];
    }
  }
  sh1[threadIdx.y][threadIdx.x] = a;
  sh2[threadIdx.y][threadIdx.x] = b;
  __syncthreads();
  if (threadIdx.y != 0 || cc >= c) return;
  a = 0.f;
  b = 0.f;
  for (int r = 0; r < kFinalizeRows; ++r) {
    a += sh1[r][threadIdx.x];
    b += sh2[r][threadIdx.x];
  }
  // separately rounded steps, no fused multiply-add: the variance of a
  // (nearly) constant channel is then the same rounding residual as in the
  // plain version instead of another one
  const float m = a / count;
  const float var = fmaxf(__fsub_rn(b / count, __fmul_rn(m, m)), 0.f);
  mean[static_cast<int64_t>(n) * c + cc] = m;
  rstd[static_cast<int64_t>(n) * c + cc] = rsqrtf(var + eps);
}

template <typename T, int VEC>
cudaError_t launch_partial(const void* x, float* part_s1, float* part_s2,
                           int n, int64_t hw, int c, int tx, int ty,
                           int cblocks, int num_p, int64_t chunk,
                           cudaStream_t stream) {
  const dim3 grid(cblocks, num_p, n);
  const dim3 block(tx, ty);
  const size_t smem = 2u * ty * tx * VEC * sizeof(float);
  stats_partial_kernel<T, VEC><<<grid, block, smem, stream>>>(
      static_cast<const T*>(x), part_s1, part_s2, hw, c, chunk);
  return cudaGetLastError();
}

}  // namespace

// x: (N, H*W, C) in memory (channels_last), dtype p2p::DType; vec is 16 bytes
// worth of elements (C % vec == 0 and x 16-byte aligned) or 1.
// part_s1/part_s2: (N, num_p, C) f32 scratch; mean/rstd: (N, C) f32.
// Returns the first CUDA error of the two launches (0 = success).
extern "C" int p2p_instance_norm_stats(
    const void* x, int dtype, int n, int64_t hw, int c, int vec, int tx,
    int ty, int cblocks, int num_p, int64_t chunk, float* part_s1,
    float* part_s2, float* mean, float* rstd, float eps, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == p2p::kF32 && vec == 4) {
    err = launch_partial<float, 4>(x, part_s1, part_s2, n, hw, c, tx, ty,
                                   cblocks, num_p, chunk, stream);
  } else if (dtype == p2p::kF32 && vec == 1) {
    err = launch_partial<float, 1>(x, part_s1, part_s2, n, hw, c, tx, ty,
                                   cblocks, num_p, chunk, stream);
  } else if (dtype == p2p::kBF16 && vec == 8) {
    err = launch_partial<__nv_bfloat16, 8>(x, part_s1, part_s2, n, hw, c, tx,
                                           ty, cblocks, num_p, chunk, stream);
  } else if (dtype == p2p::kBF16 && vec == 1) {
    err = launch_partial<__nv_bfloat16, 1>(x, part_s1, part_s2, n, hw, c, tx,
                                           ty, cblocks, num_p, chunk, stream);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((c + 31) / 32, n);
  const dim3 block(32, kFinalizeRows);
  stats_finalize_kernel<<<grid, block, 0, stream>>>(
      part_s1, part_s2, mean, rstd, num_p, c, static_cast<float>(hw), eps);
  return static_cast<int>(cudaGetLastError());
}
