// Fused instance-norm apply + activation (+ residual) for Hopper:
//   y = act((x - mean) * rstd * gamma + beta [+ r])
// computed in f32 and stored in x's dtype; the residual is added before the
// activation; act is none, relu or leaky(slope).
//
// Three entry points, one templated body:
// - p2p_norm_act replaces p2p_tpu/ops/pallas/norm_act.py:_norm_act_local
//   (kernel bodies _norm_act_kernel and _norm_act_res_kernel);
// - p2p_instance_norm_apply replaces
//   p2p_tpu/ops/pallas/instance_norm_kernel.py:_norm_local (kernel body
//   _norm_kernel), the act-free normalize pass: the body instantiated with
//   no activation and no residual;
// - p2p_norm_act_quant replaces norm_act.py:_norm_act_quant_local (kernel
//   body _norm_act_quant_kernel), the quantize-fused epilogue of the
//   delayed-int8 discriminator: after the activation, y is rounded through
//   x's dtype (yc), q = clip(rint(yc / sx), -127, 127) is stored in x's
//   dtype, and max|yc| is reduced to one f32 scalar in the same launch.
//
// Bound on the card: bytes. Each element of x (and of r) is read once and
// each element of y written once; the (N, C) mean/rstd and the C-long
// affine are tiny and stay in L1/L2. On the 1024x512 pix2pixHD path the
// largest epilogue (32 MB bf16 in, 32 MB out) needs at least ~20 us at
// 3.35 TB/s; #2's largest launch on the instance-norm ExpandNetwork
// (1x32x256x256 bf16, 4 MB in and out) at least 2.5 us. C = 3 (that
// network's head) takes the one-element path. #4 on the facades_int8
// discriminator moves 2.2 MB (1x128x65x65 bf16) and 1.1 MB (1x256x33x33).
//
// Design. A flat grid-stride pass over (N*H*W*C) in 16-byte vectors: in
// channels_last every vector holds VEC neighbouring channels of one pixel,
// so loads and stores are fully coalesced and one vector needs VEC
// consecutive mean/rstd entries. The activation and the residual are
// template parameters, so the inner loop carries no branch on them; the
// affine is a runtime null check (it is absent everywhere on the serving
// path, and uniform across the grid). The arithmetic uses the _rn
// intrinsics, which nvcc never contracts, and __fmaf_rn for the affine, so
// the result is bitwise the plain PyTorch version's; the quantize divides by
// sx (IEEE division, no --use_fast_math) and rounds half to even (rintf),
// as jnp.round and torch.round do.
//
// #4's amax: each block reduces its max|yc| (NaN-propagating, as jnp.max),
// writes it to a partial slot, and the last block to arrive (counted by an
// atomicAdd on a zeroed counter) reduces the partials in a fixed order into
// the scalar and sets the counter back to 0 for the next launch on the
// stream. Max is order-free, so every run gives the same bits; no float
// atomics.

#include "common.cuh"

namespace {

using p2p::Pack;

enum Act : int { kNone = 0, kRelu = 1, kLeaky = 2 };

// One element of the epilogue: (x - mu) * rs [* gamma + beta] [+ r], then
// the activation, in f32. The affine is one fused multiply-add, as XLA
// compiles the JAX expression; every other step rounds on its own.
template <int ACT>
__device__ __forceinline__ float apply_one(float xv, float mu, float rs,
                                           const float* gamma,
                                           const float* beta, float slope,
                                           float r, bool has_res) {
  float f = __fmul_rn(__fsub_rn(xv, mu), rs);
  if (gamma != nullptr) f = __fmaf_rn(f, *gamma, *beta);
  if (has_res) f = __fadd_rn(f, r);
  if (ACT == kRelu) {
    f = f < 0.f ? 0.f : f;  // keeps NaN, as jnp.maximum does
  } else if (ACT == kLeaky) {
    f = f < 0.f ? __fmul_rn(slope, f) : f;
  }
  return f;
}

template <typename T, int VEC, int ACT, bool RES>
__global__ void norm_act_kernel(const T* __restrict__ x,
                                const T* __restrict__ res,
                                const float* __restrict__ mean,
                                const float* __restrict__ rstd,
                                const float* __restrict__ gamma,
                                const float* __restrict__ beta,
                                T* __restrict__ y, int64_t total_vecs,
                                int64_t hwc, int c, float slope) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t v = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       v < total_vecs; v += stride) {
    const int64_t e = v * VEC;
    const int64_t n = e / hwc;
    const int cc = static_cast<int>(e % c);
    const Pack<T, VEC> xv = p2p::load_pack<T, VEC>(x + e);
    Pack<T, VEC> rv;
    if (RES) rv = p2p::load_pack<T, VEC>(res + e);
    const float* mu = mean + n * c + cc;
    const float* rs = rstd + n * c + cc;
    Pack<T, VEC> out;
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      float f = apply_one<ACT>(p2p::to_f32(xv.v[k]), mu[k], rs[k],
                               gamma == nullptr ? nullptr : gamma + cc + k,
                               beta == nullptr ? nullptr : beta + cc + k,
                               slope, RES ? p2p::to_f32(rv.v[k]) : 0.f, RES);
      out.v[k] = p2p::from_f32<T>(f);
    }
    p2p::store_pack<T, VEC>(y + e, out);
  }
}

// max that keeps a NaN from either side, as jnp.max does
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// the block's nan_max of v, valid in thread 0 (blockDim.x <= 1024)
__device__ float block_max(float v) {
  __shared__ float warp_max[32];
  for (int off = 16; off > 0; off >>= 1) {
    v = nan_max(v, __shfl_down_sync(0xffffffffu, v, off));
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_max[warp] = v;
  __syncthreads();
  const int warps = (blockDim.x + 31) >> 5;
  v = threadIdx.x < warps ? warp_max[threadIdx.x] : 0.f;
  if (warp == 0) {
    for (int off = 16; off > 0; off >>= 1) {
      v = nan_max(v, __shfl_down_sync(0xffffffffu, v, off));
    }
  }
  __syncthreads();  // warp_max is reused by a second call
  return v;
}

template <typename T, int VEC, int ACT>
__global__ void norm_act_quant_kernel(
    const T* __restrict__ x, const float* __restrict__ mean,
    const float* __restrict__ rstd, const float* __restrict__ gamma,
    const float* __restrict__ beta, const float* __restrict__ sx,
    T* __restrict__ y, float* __restrict__ partial,
    unsigned int* __restrict__ counter, float* __restrict__ amax,
    int64_t total_vecs, int64_t hwc, int c, float slope) {
  const float s = *sx;
  float m = 0.f;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t v = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       v < total_vecs; v += stride) {
    const int64_t e = v * VEC;
    const int64_t n = e / hwc;
    const int cc = static_cast<int>(e % c);
    const Pack<T, VEC> xv = p2p::load_pack<T, VEC>(x + e);
    const float* mu = mean + n * c + cc;
    const float* rs = rstd + n * c + cc;
    Pack<T, VEC> out;
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const float f = apply_one<ACT>(
          p2p::to_f32(xv.v[k]), mu[k], rs[k],
          gamma == nullptr ? nullptr : gamma + cc + k,
          beta == nullptr ? nullptr : beta + cc + k, slope, 0.f, false);
      // round through the activation dtype first, as y.astype(x.dtype)
      const float yc = p2p::to_f32(p2p::from_f32<T>(f));
      float q = rintf(__fdiv_rn(yc, s));
      q = q < -127.f ? -127.f : (q > 127.f ? 127.f : q);  // keeps NaN
      out.v[k] = p2p::from_f32<T>(q);
      m = nan_max(m, fabsf(yc));
    }
    p2p::store_pack<T, VEC>(y + e, out);
  }
  m = block_max(m);
  __shared__ bool last;
  if (threadIdx.x == 0) {
    partial[blockIdx.x] = m;
    __threadfence();
    last = atomicAdd(counter, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  float r = 0.f;
  for (int b = threadIdx.x; b < static_cast<int>(gridDim.x); b += blockDim.x) {
    r = nan_max(r, __ldcg(partial + b));
  }
  r = block_max(r);
  if (threadIdx.x == 0) {
    *amax = r;
    *counter = 0u;  // every block has arrived: ready for the next launch
  }
}

template <typename T, int VEC, int ACT, bool RES>
cudaError_t launch(const void* x, const void* res, const float* mean,
                   const float* rstd, const float* gamma, const float* beta,
                   void* y, int64_t numel, int64_t hwc, int c, float slope,
                   int blocks, int threads, cudaStream_t stream) {
  norm_act_kernel<T, VEC, ACT, RES><<<blocks, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(res), mean, rstd, gamma,
      beta, static_cast<T*>(y), numel / VEC, hwc, c, slope);
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t dispatch_act(int act, bool has_res, const void* x,
                         const void* res, const float* mean, const float* rstd,
                         const float* gamma, const float* beta, void* y,
                         int64_t numel, int64_t hwc, int c, float slope,
                         int blocks, int threads, cudaStream_t stream) {
#define P2P_LAUNCH(A, R)                                                     \
  return launch<T, VEC, A, R>(x, res, mean, rstd, gamma, beta, y, numel, hwc, \
                              c, slope, blocks, threads, stream)
  if (has_res) {
    if (act == kNone) P2P_LAUNCH(kNone, true);
    if (act == kRelu) P2P_LAUNCH(kRelu, true);
    if (act == kLeaky) P2P_LAUNCH(kLeaky, true);
  } else {
    if (act == kNone) P2P_LAUNCH(kNone, false);
    if (act == kRelu) P2P_LAUNCH(kRelu, false);
    if (act == kLeaky) P2P_LAUNCH(kLeaky, false);
  }
#undef P2P_LAUNCH
  return cudaErrorInvalidValue;
}

}  // namespace

// x, res, y: (N, H*W, C) in memory (channels_last), dtype p2p::DType; res may
// be null. mean/rstd: (N, C) f32; gamma/beta: (C,) f32 or both null.
// vec is 16 bytes worth of elements (C % vec == 0, all tensors 16-byte
// aligned) or 1. Returns the launch's CUDA error (0 = success).
extern "C" int p2p_norm_act(const void* x, const void* res, const float* mean,
                            const float* rstd, const float* gamma,
                            const float* beta, void* y, int dtype, int64_t numel,
                            int64_t hwc, int c, int vec, int act, float slope,
                            int blocks, int threads, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const bool has_res = res != nullptr;
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == p2p::kF32 && vec == 4) {
    err = dispatch_act<float, 4>(act, has_res, x, res, mean, rstd, gamma, beta,
                                 y, numel, hwc, c, slope, blocks, threads,
                                 stream);
  } else if (dtype == p2p::kF32 && vec == 1) {
    err = dispatch_act<float, 1>(act, has_res, x, res, mean, rstd, gamma, beta,
                                 y, numel, hwc, c, slope, blocks, threads,
                                 stream);
  } else if (dtype == p2p::kBF16 && vec == 8) {
    err = dispatch_act<__nv_bfloat16, 8>(act, has_res, x, res, mean, rstd,
                                         gamma, beta, y, numel, hwc, c, slope,
                                         blocks, threads, stream);
  } else if (dtype == p2p::kBF16 && vec == 1) {
    err = dispatch_act<__nv_bfloat16, 1>(act, has_res, x, res, mean, rstd,
                                         gamma, beta, y, numel, hwc, c, slope,
                                         blocks, threads, stream);
  }
  return static_cast<int>(err);
}

// The act-free normalize pass y = (x - mean) * rstd * gamma + beta: the same
// arguments as p2p_norm_act without the residual and the activation.
extern "C" int p2p_instance_norm_apply(const void* x, const float* mean,
                                       const float* rstd, const float* gamma,
                                       const float* beta, void* y, int dtype,
                                       int64_t numel, int64_t hwc, int c,
                                       int vec, int blocks, int threads,
                                       void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err = cudaErrorInvalidValue;
#define P2P_APPLY(T, V)                                                     \
  err = launch<T, V, kNone, false>(x, nullptr, mean, rstd, gamma, beta, y,  \
                                   numel, hwc, c, 0.f, blocks, threads,     \
                                   stream)
  if (dtype == p2p::kF32 && vec == 4) {
    P2P_APPLY(float, 4);
  } else if (dtype == p2p::kF32 && vec == 1) {
    P2P_APPLY(float, 1);
  } else if (dtype == p2p::kBF16 && vec == 8) {
    P2P_APPLY(__nv_bfloat16, 8);
  } else if (dtype == p2p::kBF16 && vec == 1) {
    P2P_APPLY(__nv_bfloat16, 1);
  }
#undef P2P_APPLY
  return static_cast<int>(err);
}

namespace {

template <typename T, int VEC, int ACT>
cudaError_t launch_quant(const void* x, const float* mean, const float* rstd,
                         const float* gamma, const float* beta,
                         const float* sx, void* y, float* partial,
                         unsigned int* counter, float* amax, int64_t numel,
                         int64_t hwc, int c, float slope, int blocks,
                         int threads, cudaStream_t stream) {
  norm_act_quant_kernel<T, VEC, ACT><<<blocks, threads, 0, stream>>>(
      static_cast<const T*>(x), mean, rstd, gamma, beta, sx,
      static_cast<T*>(y), partial, counter, amax, numel / VEC, hwc, c, slope);
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t dispatch_quant(int act, const void* x, const float* mean,
                           const float* rstd, const float* gamma,
                           const float* beta, const float* sx, void* y,
                           float* partial, unsigned int* counter, float* amax,
                           int64_t numel, int64_t hwc, int c, float slope,
                           int blocks, int threads, cudaStream_t stream) {
#define P2P_QUANT(A)                                                          \
  return launch_quant<T, VEC, A>(x, mean, rstd, gamma, beta, sx, y, partial, \
                                 counter, amax, numel, hwc, c, slope, blocks, \
                                 threads, stream)
  if (act == kNone) P2P_QUANT(kNone);
  if (act == kRelu) P2P_QUANT(kRelu);
  if (act == kLeaky) P2P_QUANT(kLeaky);
#undef P2P_QUANT
  return cudaErrorInvalidValue;
}

}  // namespace

// The quantize-fused epilogue: the arguments of p2p_norm_act without the
// residual, plus sx (one f32 on the device, > 0), partial (blocks f32
// scratch), counter (one unsigned int on the device, 0 before the launch
// and left 0 after it) and amax (one f32 out). y holds q in x's dtype. threads must be
// a multiple of 32.
extern "C" int p2p_norm_act_quant(const void* x, const float* mean,
                                  const float* rstd, const float* gamma,
                                  const float* beta, const float* sx, void* y,
                                  float* partial, unsigned int* counter,
                                  float* amax, int dtype, int64_t numel,
                                  int64_t hwc, int c, int vec, int act,
                                  float slope, int blocks, int threads,
                                  void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err = cudaErrorInvalidValue;
#define P2P_DQ(T, V)                                                        \
  err = dispatch_quant<T, V>(act, x, mean, rstd, gamma, beta, sx, y, partial, \
                             counter, amax, numel, hwc, c, slope, blocks,   \
                             threads, stream)
  if (dtype == p2p::kF32 && vec == 4) {
    P2P_DQ(float, 4);
  } else if (dtype == p2p::kF32 && vec == 1) {
    P2P_DQ(float, 1);
  } else if (dtype == p2p::kBF16 && vec == 8) {
    P2P_DQ(__nv_bfloat16, 8);
  } else if (dtype == p2p::kBF16 && vec == 1) {
    P2P_DQ(__nv_bfloat16, 1);
  }
#undef P2P_DQ
  return static_cast<int>(err);
}
