// The two-pass channel moments shared by the instance-norm statistics
// kernel (instance_norm_stats.cu) and the BatchNorm dual-moments kernel
// (batch_moments.cu): per-chunk f32 partial sums of x and x^2 over the
// pixels of a channels_last (N, P*chunk, C) activation, then a fixed-order
// column sum of the partials. No float atomics: the same bits on every run.
//
// Pass 1 (moments_partial_kernel): grid (channel blocks, pixel chunks P, N).
// Threads run along C in 16-byte vectors (neighbouring threads read
// neighbouring addresses of one pixel row; the rows a warp covers are
// contiguous in channels_last), and along pixels inside the chunk, four
// loads in flight per thread. Each block reduces its rows in shared memory
// in a fixed order and writes one (n, p, c) partial.
// Pass 2 helper (sum_partials): one thread column per (n, c) sums the P
// partials in a fixed order; each library's finalize kernel turns the two
// column sums into its own outputs.
#pragma once

#include "common.cuh"

namespace p2p {

template <typename T, int VEC>
__device__ __forceinline__ void accumulate(const Pack<T, VEC>& v, float* s1,
                                           float* s2) {
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    const float f = to_f32(v.v[k]);
    s1[k] += f;
    s2[k] += f * f;
  }
}

template <typename T, int VEC>
__global__ void moments_partial_kernel(const T* __restrict__ x,
                                       float* __restrict__ part_s1,
                                       float* __restrict__ part_s2,
                                       int64_t hw, int c, int64_t chunk) {
  // a launch made as a programmatic dependent (the finalize of the
  // BatchNorm moments or of the instance-norm statistics) may start now and
  // wait for this grid's end; with an ordinary next launch this does nothing
  allow_dependents();
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
      const Pack<T, VEC> a = load_pack<T, VEC>(base + q * c);
      const Pack<T, VEC> b = load_pack<T, VEC>(base + (q + step) * c);
      const Pack<T, VEC> d = load_pack<T, VEC>(base + (q + 2 * step) * c);
      const Pack<T, VEC> e = load_pack<T, VEC>(base + (q + 3 * step) * c);
      accumulate(a, s1, s2);
      accumulate(b, s1, s2);
      accumulate(d, s1, s2);
      accumulate(e, s1, s2);
    }
    for (; q < pix1; q += step) {
      accumulate(load_pack<T, VEC>(base + q * c), s1, s2);
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

template <typename T, int VEC>
cudaError_t launch_partial(const void* x, float* part_s1, float* part_s2,
                           int n, int64_t hw, int c, int tx, int ty,
                           int cblocks, int num_p, int64_t chunk,
                           cudaStream_t stream) {
  const dim3 grid(cblocks, num_p, n);
  const dim3 block(tx, ty);
  const size_t smem = 2u * ty * tx * VEC * sizeof(float);
  moments_partial_kernel<T, VEC><<<grid, block, smem, stream>>>(
      static_cast<const T*>(x), part_s1, part_s2, hw, c, chunk);
  return cudaGetLastError();
}

// Pass 1 for dtype (p2p::DType) and vec (16 bytes worth of elements, or 1);
// cudaErrorInvalidValue for a pair no instantiation covers.
inline cudaError_t launch_moments_partial(const void* x, int dtype, int vec,
                                          float* part_s1, float* part_s2,
                                          int n, int64_t hw, int c, int tx,
                                          int ty, int cblocks, int num_p,
                                          int64_t chunk, cudaStream_t stream) {
  if (dtype == kF32 && vec == 4) {
    return launch_partial<float, 4>(x, part_s1, part_s2, n, hw, c, tx, ty,
                                    cblocks, num_p, chunk, stream);
  }
  if (dtype == kF32 && vec == 1) {
    return launch_partial<float, 1>(x, part_s1, part_s2, n, hw, c, tx, ty,
                                    cblocks, num_p, chunk, stream);
  }
  if (dtype == kBF16 && vec == 8) {
    return launch_partial<__nv_bfloat16, 8>(x, part_s1, part_s2, n, hw, c,
                                            tx, ty, cblocks, num_p, chunk,
                                            stream);
  }
  if (dtype == kBF16 && vec == 1) {
    return launch_partial<__nv_bfloat16, 1>(x, part_s1, part_s2, n, hw, c,
                                            tx, ty, cblocks, num_p, chunk,
                                            stream);
  }
  return cudaErrorInvalidValue;
}

constexpr int kFinalizeRows = 32;

// Pass 2 for a block of (WIDTH, kFinalizeRows) threads over channels
// blockIdx.x*WIDTH .. +WIDTH-1 of sample blockIdx.y: sums the P partials of
// each (n, c) in a fixed order, which does not depend on WIDTH. Every
// thread of the block must call it; it returns true on the one thread
// (threadIdx.y == 0) of each valid channel, which then holds the two
// column sums in *a and *b.
template <int WIDTH = 32>
__device__ __forceinline__ bool sum_partials(const float* __restrict__ part_s1,
                                             const float* __restrict__ part_s2,
                                             int num_p, int c, float* a,
                                             float* b) {
  __shared__ float sh1[kFinalizeRows][WIDTH];
  __shared__ float sh2[kFinalizeRows][WIDTH];
  const int n = blockIdx.y;
  const int cc = blockIdx.x * WIDTH + threadIdx.x;
  float s1 = 0.f, s2 = 0.f;
  if (cc < c) {
    for (int p = threadIdx.y; p < num_p; p += kFinalizeRows) {
      const int64_t o = (static_cast<int64_t>(n) * num_p + p) * c + cc;
      s1 += part_s1[o];
      s2 += part_s2[o];
    }
  }
  sh1[threadIdx.y][threadIdx.x] = s1;
  sh2[threadIdx.y][threadIdx.x] = s2;
  __syncthreads();
  if (threadIdx.y != 0 || cc >= c) return false;
  s1 = 0.f;
  s2 = 0.f;
  for (int r = 0; r < kFinalizeRows; ++r) {
    s1 += sh1[r][threadIdx.x];
    s2 += sh2[r][threadIdx.x];
  }
  *a = s1;
  *b = s2;
  return true;
}

}  // namespace p2p
