// Fused instance-norm apply + activation (+ residual) for Hopper:
//   y = act((x - mean) * rstd * gamma + beta [+ r])
// computed in f32 and stored in x's dtype; the residual is added before the
// activation; act is none, relu or leaky(slope).
//
// Three entry points:
// - p2p_norm_act replaces p2p_tpu/ops/pallas/norm_act.py:_norm_act_local
//   (kernel bodies _norm_act_kernel and _norm_act_res_kernel);
// - p2p_instance_norm_apply replaces
//   p2p_tpu/ops/pallas/instance_norm_kernel.py:_norm_local (kernel body
//   _norm_kernel), the act-free normalize pass;
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
// (1x32x256x256 bf16, 4 MB in and out) at least 2.5 us. #4 on the
// facades_int8 discriminator moves 2.2 MB (1x128x65x65 bf16) and 1.1 MB
// (1x256x33x33).
//
// #2, #3 and #4 (apply_kernel for #2 and #3, quant_kernel for #4). Their
// launches follow #1's finalize on the main path, and most are small
// (876 of #3's 1,064 launches move at most 4.2 MB; #2's 1-4 MB), so their
// time is the launch and the first round trip to memory, not the bytes.
// Each is launched as a programmatic dependent of whatever precedes it on
// the stream (cudaLaunchAttributeProgrammaticStreamSerialization): its
// blocks become resident while that launch still runs and wait in
// griddepcontrol.wait for its end. With EARLY (the wrapper's
// x_ready=True), a block issues its loads of x, and of the residual where
// #3 has one, before the wait, so they overlap the launches before it. The
// host plan (ops/cuda/norm_act.py apply_plan) makes the grid one wave up
// to a wave's worth of vectors: thread t of block b takes the vectors
// (b*K + k)*256 + t, k < K, all loaded before the wait; beyond that the
// blocks past the first wave run after it. #2 and #4 take K in {1, 2, 4},
// the fewest that fit one wave, else 4. #3 takes K = 1: at K = 4 it held
// 71-95 registers, so no more of its vectors fit one wave, and its 16-134
// MB launches (160 of 1,064), which stream at the bytes' rate, ran 5-8%
// slower than the grid-stride pass it replaces. Where a warp's vectors
// span 32 groups of channels (C >= 32*VEC) #3 also reads the statistics as
// 16-byte words (normalize_channels' WIDE, chosen on the host). In
// channels_last every 16-byte vector holds VEC neighbouring channels of
// one pixel, so loads and stores are fully coalesced and one vector needs
// VEC consecutive mean/rstd entries. The activation and the residual are
// template parameters, so the inner loop carries no branch on them; the
// affine is a runtime null check (absent everywhere on the serving path,
// and uniform across the grid). Element indices are 32-bit (numel < 2^31),
// with no 64-bit division. Three paths:
// - 16-byte vectors along C (C % VEC == 0; x, y and r 16-byte aligned);
// - #2 at C = 3 (the ExpandNetwork's head): 16-byte vectors of consecutive
//   elements across pixels, where H*W*C % VEC == 0 and x and y are 16-byte
//   aligned (no vector spans two samples); a vector's first channel is its
//   flat index mod 3, and the three statistics (and affine) of its sample
//   sit in registers, rotated once to that phase;
// - one element at a time otherwise.
// #4's amax: every |yc| is non-negative or a NaN with its sign cleared, and
// such floats order as their unsigned bits, a NaN above +inf; so each warp
// takes the max of the bits (__reduce_max_sync), each block folds its warps
// in shared memory and then into one 32-bit word with atomicMax, and takes
// a ticket on the arrival counter beside it. The last block to arrive moves
// the word to amax (a canonical NaN if it holds one) and sets the word and
// the counter back to 0 for the next launch on the stream. Max is
// order-free, so every run gives the same bits; no float atomics.
//
// Every kernel computes with the _rn intrinsics, which nvcc never
// contracts, and __fmaf_rn for the affine, so the result is bitwise the
// plain PyTorch version's; the quantize divides by sx (IEEE division, no
// --use_fast_math) and rounds half to even (rintf), as jnp.round and
// torch.round do.

#include <string.h>

#include <type_traits>

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

constexpr int kApplyThreads = 256;   // threads of a #2, #3 or #4 block
constexpr int kResidentBlocks = 8;   // blocks an SM holds at K = 1 (2,048
                                     // threads: one wave, the host plan)

// paths of #2, #3 and #4 (ops/cuda/norm_act.py APPLY_PATHS; kFlat3 is
// #2's alone)
enum ApplyPath : int { kChannels = 0, kFlat3 = 1, kElement = 2 };

// What every #2, #3 and #4 launch reads besides x (and #3's residual),
// and its extent.
struct Epilogue {
  const float* mean;  // (N, C)
  const float* rstd;  // (N, C)
  const float* gamma; // (C,) or null, with beta
  const float* beta;
  uint32_t total_vecs;
  uint32_t hwc;       // H*W*C
  uint32_t c;
  float slope;
};

// Thread t of block b takes the vectors (b*K + k)*kApplyThreads + t, k < K.
//
// The rule of the dependent launches of #2, #3 and #4: before
// griddepcontrol.wait a block reads only x and #3's residual r, and writes
// nothing. Every write (y, amax, the arrival counter and the max word) and
// every read of the statistics, the affine and sx come after it. The wait
// returns once the launch before this one on the stream has ended and its
// stores are visible. Reading x and r before the wait needs both complete
// before that launch began, that is, no launch that may still run writes
// them; the caller says so with EARLY (ops/cuda/norm_act.py x_ready=True;
// ops/instance_norm.py launches #1 of the same x right before). The chain
// on the main path is #1's pass 1, then #1's finalize, then the epilogue:
// - pass 1 is an ordinary launch, so it begins only once the launch
//   before it, the conv that writes x, has ended and its stores are
//   visible; r (the ResidualBlock's input, models/expand.py and
//   models/resnet_gen.py) was written before the block's convs, so before
//   that. Pass 1 lets dependents start at its top and writes only its
//   partials;
// - the finalize is pass 1's programmatic dependent: it may begin while
//   pass 1 runs, lets dependents start at its top, waits before it reads a
//   partial, and writes only mean and rstd;
// - the epilogue is the finalize's dependent: it may begin while pass 1
//   still runs. x and r were complete and visible before pass 1 began, and
//   no launch of the chain writes them, so they may be read at once; mean
//   and rstd are read after the wait, which returns once the finalize has
//   ended, and the finalize ends only after pass 1 has.
// After #5's single-launch pass 1 (moments_partial.cuh, an ordinary launch
// that lets dependents start at its top and writes only its sums) the same
// holds. After any PyTorch kernel, which never lets dependents start
// early, these blocks start only once all of its blocks have ended, and x
// written by the kernels before it is visible; its own stores are made
// visible only by the wait, so EARLY is off unless the launch before is
// known not to write x or r. No kernel of the port that writes an
// activation lets dependents start early, and #2, #3 and #4 do not at all,
// so a launch after them starts only once they have ended.
//
// With EARLY, each thread's K vectors of x (and of r) are loaded before the
// wait as raw 16-byte words (an index past the end reloads the last
// vector, so there is no branch), and unpacked after it: the loads stay in
// flight across the wait and the statistics' loads are issued right after
// it. Without EARLY, x and r are loaded after the wait beside the
// statistics, in one round trip.
template <typename T, int VEC>
using Raw = std::conditional_t<sizeof(T) * VEC == 16, uint4, Pack<T, VEC>>;

// x's loads, and with RES the residual's, of one thread
template <typename T, int VEC, int K, bool RES, bool EARLY>
struct XLoads {
  const T* __restrict__ x;
  const T* __restrict__ res;  // read only with RES
  Raw<T, VEC> xr[K];
  Raw<T, VEC> rr[RES ? K : 1];

  __device__ __forceinline__ static Raw<T, VEC> load(const T* p) {
    return *reinterpret_cast<const Raw<T, VEC>*>(p);
  }

  __device__ __forceinline__ static Pack<T, VEC> unpack(const Raw<T, VEC>& w) {
    Pack<T, VEC> p;
    memcpy(&p, &w, sizeof(p));
    return p;
  }

  // issues the loads of x and r (EARLY), then waits for the launch before
  __device__ __forceinline__ void load_then_wait(uint32_t first,
                                                 uint32_t total_vecs) {
    if constexpr (EARLY) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const size_t o =
            size_t{min(first + k * kApplyThreads, total_vecs - 1)} * VEC;
        xr[k] = load(x + o);
        if constexpr (RES) rr[k] = load(res + o);
      }
    }
    p2p::grid_dependency_wait();
  }

  // vector v of x, the k-th of this thread
  __device__ __forceinline__ Pack<T, VEC> at(int k, uint32_t v) const {
    if constexpr (EARLY) {
      return unpack(xr[k]);
    } else {
      return unpack(load(x + size_t{v} * VEC));
    }
  }

  // the same vector of r (RES)
  __device__ __forceinline__ Pack<T, VEC> res_at(int k, uint32_t v) const {
    if constexpr (EARLY) {
      return unpack(rr[RES ? k : 0]);
    } else {
      return unpack(load(res + size_t{v} * VEC));
    }
  }
};

// out = p[0..VEC) as 16-byte words (p 16-byte aligned)
template <int VEC>
__device__ __forceinline__ void load_words(const float* p, float (&out)[VEC]) {
  static_assert(VEC % 4 == 0, "whole 16-byte words");
#pragma unroll
  for (int j = 0; j < VEC; j += 4) {
    const float4 w = *reinterpret_cast<const float4*>(p + j);
    out[j] = w.x;
    out[j + 1] = w.y;
    out[j + 2] = w.z;
    out[j + 3] = w.w;
  }
}

// f[k] = act((x - mu) * rs [* gamma + beta] [+ r]) of the elements of
// vector v: VEC consecutive channels of one pixel (VEC = 1: one element);
// rv is read only with RES. With WIDE (#3, where mean and rstd are 16-byte
// aligned and a warp's 32 vectors lie in 32 groups of channels, C >=
// 32*VEC, so that one load of a float of each touches 8 cache lines) the
// statistics are read as 16-byte words
template <typename T, int VEC, int ACT, bool RES, bool WIDE = false>
__device__ __forceinline__ void normalize_channels(const Pack<T, VEC>& xv,
                                                   const Pack<T, VEC>& rv,
                                                   uint32_t v,
                                                   const Epilogue& e,
                                                   float (&f)[VEC]) {
  const uint32_t i = v * VEC;
  const uint32_t cc = i % e.c;
  const uint32_t o = i / e.hwc * e.c + cc;
  float mu[VEC], rs[VEC];
  if constexpr (WIDE) {
    load_words<VEC>(e.mean + o, mu);
    load_words<VEC>(e.rstd + o, rs);
  }
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    f[k] = apply_one<ACT>(p2p::to_f32(xv.v[k]), WIDE ? mu[k] : e.mean[o + k],
                          WIDE ? rs[k] : e.rstd[o + k],
                          e.gamma == nullptr ? nullptr : e.gamma + cc + k,
                          e.beta == nullptr ? nullptr : e.beta + cc + k,
                          e.slope, RES ? p2p::to_f32(rv.v[k]) : 0.f, RES);
  }
}

// the same at C = 3 over the flat array: element k of vector v has channel
// (v*VEC + k) % 3, and all VEC elements lie in one sample (H*W*3 % VEC == 0)
template <typename T, int VEC, int ACT>
__device__ __forceinline__ void normalize_flat3(const Pack<T, VEC>& xv,
                                                uint32_t v, const Epilogue& e,
                                                float (&f)[VEC]) {
  const uint32_t i = v * VEC;
  const uint32_t o = i / e.hwc * 3;
  const uint32_t phase = i % 3;
  float mu[3], rs[3], g[3], b[3];  // rotated so that [k % 3] is element k's
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const uint32_t ch = phase + j < 3 ? phase + j : phase + j - 3;
    mu[j] = e.mean[o + ch];
    rs[j] = e.rstd[o + ch];
    if (e.gamma != nullptr) {
      g[j] = e.gamma[ch];
      b[j] = e.beta[ch];
    }
  }
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    f[k] = apply_one<ACT>(p2p::to_f32(xv.v[k]), mu[k % 3], rs[k % 3],
                          e.gamma == nullptr ? nullptr : g + k % 3,
                          e.beta == nullptr ? nullptr : b + k % 3, e.slope,
                          0.f, false);
  }
}

// #2 (ACT kNone, no RES, not WIDE) and #3 (K = 1). With RES and WIDE a
// thread holds x's and r's words across the wait beside 16-byte words of
// the statistics, which spills at 32 registers (8 blocks an SM), so it asks
// for 4 blocks an SM
template <typename T, int VEC, int K, bool FLAT3, int ACT, bool RES,
          bool EARLY, bool WIDE>
__global__ void __launch_bounds__(kApplyThreads,
                                  kResidentBlocks / K /
                                      (RES && WIDE ? 2 : 1))
    apply_kernel(const T* __restrict__ x, const T* __restrict__ res,
                 T* __restrict__ y, Epilogue e) {
  static_assert(!FLAT3 || (ACT == kNone && !RES), "C = 3 is #2's path");
  const uint32_t first = blockIdx.x * (K * kApplyThreads) + threadIdx.x;
  XLoads<T, VEC, K, RES, EARLY> xs{x, res};
  xs.load_then_wait(first, e.total_vecs);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const uint32_t v = first + k * kApplyThreads;
    if (v >= e.total_vecs) break;
    float f[VEC];
    if constexpr (FLAT3) {
      normalize_flat3<T, VEC, kNone>(xs.at(k, v), v, e, f);
    } else if constexpr (RES) {
      normalize_channels<T, VEC, ACT, true, WIDE>(xs.at(k, v),
                                                  xs.res_at(k, v), v, e, f);
    } else {
      const Pack<T, VEC> xv = xs.at(k, v);
      normalize_channels<T, VEC, ACT, false, WIDE>(xv, xv, v, e, f);
    }
    Pack<T, VEC> out;
#pragma unroll
    for (int j = 0; j < VEC; ++j) out.v[j] = p2p::from_f32<T>(f[j]);
    p2p::store_pack<T, VEC>(y + size_t{v} * VEC, out);
  }
}

// sync[0] counts the blocks that have arrived, sync[1] holds the max of the
// bits of |yc| over the blocks that have; both are 0 before the launch and
// after it
template <typename T, int VEC, int K, int ACT, bool EARLY>
__global__ void __launch_bounds__(kApplyThreads, kResidentBlocks / K)
    quant_kernel(const T* __restrict__ x, const float* __restrict__ sx,
                 T* __restrict__ y, unsigned int* __restrict__ sync,
                 float* __restrict__ amax, Epilogue e) {
  const uint32_t first = blockIdx.x * (K * kApplyThreads) + threadIdx.x;
  XLoads<T, VEC, K, false, EARLY> xs{x, nullptr};
  xs.load_then_wait(first, e.total_vecs);
  __shared__ unsigned int block_bits;
  if (threadIdx.x == 0) block_bits = 0u;
  const float s = *sx;
  unsigned int bits = 0u;  // |yc| is >= 0 or a NaN with its sign cleared
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const uint32_t v = first + k * kApplyThreads;
    if (v >= e.total_vecs) break;
    float f[VEC];
    const Pack<T, VEC> xv = xs.at(k, v);
    normalize_channels<T, VEC, ACT, false>(xv, xv, v, e, f);
    Pack<T, VEC> out;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      // round through the activation dtype first, as y.astype(x.dtype)
      const float yc = p2p::to_f32(p2p::from_f32<T>(f[j]));
      float q = rintf(__fdiv_rn(yc, s));
      q = q < -127.f ? -127.f : (q > 127.f ? 127.f : q);  // keeps NaN
      out.v[j] = p2p::from_f32<T>(q);
      bits = max(bits, __float_as_uint(fabsf(yc)));
    }
    p2p::store_pack<T, VEC>(y + size_t{v} * VEC, out);
  }
  bits = __reduce_max_sync(0xffffffffu, bits);
  __syncthreads();  // block_bits is 0
  if ((threadIdx.x & 31) == 0) atomicMax(&block_bits, bits);
  __syncthreads();
  if (threadIdx.x != 0) return;
  atomicMax(sync + 1, block_bits);
  __threadfence();
  if (atomicAdd(sync, 1u) != gridDim.x - 1) return;
  // every block has folded its max into the word: move it out, leave 0s
  __threadfence();
  const unsigned int m = atomicExch(sync + 1, 0u);
  *amax = __uint_as_float(m > 0x7f800000u ? 0x7fffffffu : m);
  sync[0] = 0u;
}

// checks what p2p_instance_norm_apply, p2p_norm_act and p2p_norm_act_quant
// take (the grid must cover every vector), and fills in the launch's
// extent; the vector width follows path and dtype
cudaError_t make_epilogue(const float* mean, const float* rstd,
                          const float* gamma, const float* beta, int dtype,
                          int64_t numel, int64_t hwc, int c, int path,
                          int per_thread, int blocks, int threads,
                          float slope, int* vec, Epilogue* e) {
  if (threads != kApplyThreads || numel <= 0 || numel >= (int64_t{1} << 31) ||
      hwc <= 0 || c <= 0 || numel % hwc || hwc % c ||
      (dtype != p2p::kF32 && dtype != p2p::kBF16) || path < kChannels ||
      path > kElement || (gamma == nullptr) != (beta == nullptr)) {
    return cudaErrorInvalidValue;
  }
  *vec = path == kElement ? 1 : (dtype == p2p::kF32 ? 4 : 8);
  if ((path == kChannels && c % *vec) ||
      (path == kFlat3 && (c != 3 || hwc % *vec)) ||
      int64_t{blocks} * per_thread * kApplyThreads < numel / *vec) {
    return cudaErrorInvalidValue;
  }
  *e = Epilogue{mean, rstd, gamma, beta, static_cast<uint32_t>(numel / *vec),
                static_cast<uint32_t>(hwc), static_cast<uint32_t>(c), slope};
  return cudaSuccess;
}

template <typename T, int VEC, bool FLAT3, bool EARLY>
cudaError_t launch_apply(int per_thread, int blocks, cudaStream_t stream,
                         const void* x, void* y, const Epilogue& e) {
#define P2P_APPLY(K)                                                        \
  return p2p::launch_dependent(                                             \
      apply_kernel<T, VEC, K, FLAT3, kNone, false, EARLY, false>,           \
      dim3(blocks), dim3(kApplyThreads), stream, static_cast<const T*>(x),  \
      static_cast<const T*>(nullptr), static_cast<T*>(y), e)
  if (per_thread == 1) P2P_APPLY(1);
  if (per_thread == 2) P2P_APPLY(2);
  if (per_thread == 4) P2P_APPLY(4);
#undef P2P_APPLY
  return cudaErrorInvalidValue;
}

template <typename T, int VEC, int ACT, bool RES>
cudaError_t launch_norm_act(int early, bool wide, int blocks,
                            cudaStream_t stream, const void* x,
                            const void* res, void* y, const Epilogue& e) {
#define P2P_NORM_ACT(E, W)                                                  \
  return p2p::launch_dependent(                                             \
      apply_kernel<T, VEC, 1, false, ACT, RES, E, W>, dim3(blocks),         \
      dim3(kApplyThreads), stream, static_cast<const T*>(x),                \
      static_cast<const T*>(res), static_cast<T*>(y), e)
  if constexpr (VEC % 4 == 0) {
    if (wide && early) P2P_NORM_ACT(true, true);
    if (wide) P2P_NORM_ACT(false, true);
  }
  if (early) P2P_NORM_ACT(true, false);
  P2P_NORM_ACT(false, false);
#undef P2P_NORM_ACT
}

template <typename T, int VEC>
cudaError_t dispatch_norm_act(int act, int early, bool wide, int blocks,
                              cudaStream_t stream, const void* x,
                              const void* res, void* y, const Epilogue& e) {
#define P2P_NORM_ACT(A)                                                     \
  return res != nullptr                                                     \
             ? launch_norm_act<T, VEC, A, true>(early, wide, blocks, stream, \
                                                x, res, y, e)               \
             : launch_norm_act<T, VEC, A, false>(early, wide, blocks,       \
                                                 stream, x, res, y, e)
  if (act == kNone) P2P_NORM_ACT(kNone);
  if (act == kRelu) P2P_NORM_ACT(kRelu);
  if (act == kLeaky) P2P_NORM_ACT(kLeaky);
#undef P2P_NORM_ACT
  return cudaErrorInvalidValue;
}

template <typename T, int VEC, int ACT, bool EARLY>
cudaError_t launch_quant(int per_thread, int blocks, cudaStream_t stream,
                         const void* x, const float* sx, void* y,
                         unsigned int* sync, float* amax, const Epilogue& e) {
#define P2P_QUANT(K)                                                    \
  return p2p::launch_dependent(quant_kernel<T, VEC, K, ACT, EARLY>,     \
                               dim3(blocks), dim3(kApplyThreads), stream, \
                               static_cast<const T*>(x), sx,            \
                               static_cast<T*>(y), sync, amax, e)
  if (per_thread == 1) P2P_QUANT(1);
  if (per_thread == 2) P2P_QUANT(2);
  if (per_thread == 4) P2P_QUANT(4);
#undef P2P_QUANT
  return cudaErrorInvalidValue;
}

template <typename T, int VEC>
cudaError_t dispatch_quant(int act, int early, int per_thread, int blocks,
                           cudaStream_t stream, const void* x,
                           const float* sx, void* y, unsigned int* sync,
                           float* amax, const Epilogue& e) {
#define P2P_QUANT(A)                                                       \
  return early ? launch_quant<T, VEC, A, true>(per_thread, blocks, stream, \
                                               x, sx, y, sync, amax, e)    \
               : launch_quant<T, VEC, A, false>(per_thread, blocks, stream, \
                                                x, sx, y, sync, amax, e)
  if (act == kNone) P2P_QUANT(kNone);
  if (act == kRelu) P2P_QUANT(kRelu);
  if (act == kLeaky) P2P_QUANT(kLeaky);
#undef P2P_QUANT
  return cudaErrorInvalidValue;
}

}  // namespace

// The act-free normalize pass y = (x - mean) * rstd * gamma + beta (#2),
// launched as a programmatic dependent. x, y: (N, H*W, C) in memory
// (channels_last), dtype p2p::DType, numel < 2^31; mean/rstd: (N, C) f32;
// gamma/beta: (C,) f32 or both null. path: kChannels (C % vec == 0, x and y
// 16-byte aligned), kFlat3 (C = 3, H*W*C % vec == 0, x and y 16-byte
// aligned) or kElement; per_thread in {1, 2, 4}; threads 256; early: read x
// before the grid-dependency wait (the rule above). Returns the launch's
// CUDA error (0 = success).
extern "C" int p2p_instance_norm_apply(const void* x, const float* mean,
                                       const float* rstd, const float* gamma,
                                       const float* beta, void* y, int dtype,
                                       int64_t numel, int64_t hwc, int c,
                                       int path, int per_thread, int blocks,
                                       int threads, int early,
                                       void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  Epilogue e;
  int vec;
  cudaError_t err = make_epilogue(mean, rstd, gamma, beta, dtype, numel, hwc,
                                  c, path, per_thread, blocks, threads, 0.f,
                                  &vec, &e);
  if (err != cudaSuccess) return static_cast<int>(err);
#define P2P_APPLY(T, V, F)                                                  \
  err = early ? launch_apply<T, V, F, true>(per_thread, blocks, stream, x, \
                                            y, e)                         \
              : launch_apply<T, V, F, false>(per_thread, blocks, stream, x, \
                                             y, e)
  if (dtype == p2p::kF32) {
    if (path == kChannels) P2P_APPLY(float, 4, false);
    if (path == kFlat3) P2P_APPLY(float, 4, true);
    if (path == kElement) P2P_APPLY(float, 1, false);
  } else {
    if (path == kChannels) P2P_APPLY(__nv_bfloat16, 8, false);
    if (path == kFlat3) P2P_APPLY(__nv_bfloat16, 8, true);
    if (path == kElement) P2P_APPLY(__nv_bfloat16, 1, false);
  }
#undef P2P_APPLY
  return static_cast<int>(err);
}

// The fused epilogue y = act((x - mean) * rstd * gamma + beta [+ res]) (#3),
// launched as a programmatic dependent: the arguments of
// p2p_instance_norm_apply (path kChannels or kElement, with kChannels res
// too 16-byte aligned; per_thread 1) plus res ((N, H*W, C) in x's dtype, or
// null), act (Act) and slope; early: read x and res before the wait.
extern "C" int p2p_norm_act(const void* x, const void* res, const float* mean,
                            const float* rstd, const float* gamma,
                            const float* beta, void* y, int dtype,
                            int64_t numel, int64_t hwc, int c, int path,
                            int per_thread, int act, float slope, int blocks,
                            int threads, int early, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  Epilogue e;
  int vec;
  cudaError_t err = make_epilogue(mean, rstd, gamma, beta, dtype, numel, hwc,
                                  c, path, per_thread, blocks, threads,
                                  slope, &vec, &e);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (path == kFlat3 || per_thread != 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the statistics as 16-byte words (normalize_channels' WIDE)
  const bool wide = path == kChannels && c >= 32 * vec &&
                    ((reinterpret_cast<uintptr_t>(mean) |
                      reinterpret_cast<uintptr_t>(rstd)) & 15) == 0;
  if (dtype == p2p::kF32 && vec == 4) {
    err = dispatch_norm_act<float, 4>(act, early, wide, blocks, stream, x,
                                      res, y, e);
  } else if (dtype == p2p::kF32) {
    err = dispatch_norm_act<float, 1>(act, early, wide, blocks, stream, x,
                                      res, y, e);
  } else if (vec == 8) {
    err = dispatch_norm_act<__nv_bfloat16, 8>(act, early, wide, blocks,
                                              stream, x, res, y, e);
  } else {
    err = dispatch_norm_act<__nv_bfloat16, 1>(act, early, wide, blocks,
                                              stream, x, res, y, e);
  }
  return static_cast<int>(err);
}

// The quantize-fused epilogue (#4), launched as a programmatic dependent:
// the arguments of p2p_instance_norm_apply (path kChannels or kElement)
// plus sx (one f32 on the device, > 0), sync (two unsigned ints on the
// device, 0 before the launch and left 0 after it: the arrival counter and
// the max word of the stream), amax (one f32 out), act and slope. y holds
// q in x's dtype.
extern "C" int p2p_norm_act_quant(const void* x, const float* mean,
                                  const float* rstd, const float* gamma,
                                  const float* beta, const float* sx, void* y,
                                  unsigned int* sync, float* amax, int dtype,
                                  int64_t numel, int64_t hwc, int c, int path,
                                  int per_thread, int act, float slope,
                                  int blocks, int threads, int early,
                                  void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  Epilogue e;
  int vec;
  cudaError_t err = make_epilogue(mean, rstd, gamma, beta, dtype, numel, hwc,
                                  c, path, per_thread, blocks, threads,
                                  slope, &vec, &e);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (path == kFlat3) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == p2p::kF32 && vec == 4) {
    err = dispatch_quant<float, 4>(act, early, per_thread, blocks, stream, x,
                                   sx, y, sync, amax, e);
  } else if (dtype == p2p::kF32) {
    err = dispatch_quant<float, 1>(act, early, per_thread, blocks, stream, x,
                                   sx, y, sync, amax, e);
  } else if (vec == 8) {
    err = dispatch_quant<__nv_bfloat16, 8>(act, early, per_thread, blocks,
                                           stream, x, sx, y, sync, amax, e);
  } else {
    err = dispatch_quant<__nv_bfloat16, 1>(act, early, per_thread, blocks,
                                           stream, x, sx, y, sync, amax, e);
  }
  return static_cast<int>(err);
}
