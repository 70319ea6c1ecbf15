// Fused instance-norm apply + activation (+ residual) for Hopper:
//   y = act((x - mean) * rstd * gamma + beta [+ r])
// computed in f32 and stored in x's dtype; the residual is added before the
// activation; act is none, relu or leaky(slope).
//
// Two entry points, one templated body:
// - p2p_norm_act replaces p2p_tpu/ops/pallas/norm_act.py:_norm_act_local
//   (kernel bodies _norm_act_kernel and _norm_act_res_kernel);
// - p2p_instance_norm_apply replaces
//   p2p_tpu/ops/pallas/instance_norm_kernel.py:_norm_local (kernel body
//   _norm_kernel), the act-free normalize pass: the body instantiated with
//   no activation and no residual.
//
// Bound on the card: bytes. Each element of x (and of r) is read once and
// each element of y written once; the (N, C) mean/rstd and the C-long
// affine are tiny and stay in L1/L2. On the 1024x512 pix2pixHD path the
// largest epilogue (32 MB bf16 in, 32 MB out) needs at least ~20 us at
// 3.35 TB/s; #2's largest launch on the instance-norm ExpandNetwork
// (1x32x256x256 bf16, 4 MB in and out) at least 2.5 us. C = 3 (that
// network's head) takes the one-element path.
//
// Design. A flat grid-stride pass over (N*H*W*C) in 16-byte vectors: in
// channels_last every vector holds VEC neighbouring channels of one pixel,
// so loads and stores are fully coalesced and one vector needs VEC
// consecutive mean/rstd entries. The activation and the residual are
// template parameters, so the inner loop carries no branch on them; the
// affine is a runtime null check (it is absent everywhere on the serving
// path, and uniform across the grid).

#include "common.cuh"

namespace {

using p2p::Pack;

enum Act : int { kNone = 0, kRelu = 1, kLeaky = 2 };

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
      float f = (p2p::to_f32(xv.v[k]) - mu[k]) * rs[k];
      if (gamma != nullptr) f = f * gamma[cc + k] + beta[cc + k];
      if (RES) f += p2p::to_f32(rv.v[k]);
      if (ACT == kRelu) {
        f = f < 0.f ? 0.f : f;  // keeps NaN, as jnp.maximum does
      } else if (ACT == kLeaky) {
        f = f < 0.f ? slope * f : f;
      }
      out.v[k] = p2p::from_f32<T>(f);
    }
    p2p::store_pack<T, VEC>(y + e, out);
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
