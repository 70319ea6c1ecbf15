// The U-Net subpixel image head's k2-s1 pad-1 conv for Hopper: the forward
// (kernel #6) and the input gradient (kernel #7).
//
// Replaces p2p_tpu/ops/pallas/subpixel_head.py:165 _fwd (kernel body
// _fwd_kernel) and :200 _bwd (its dx pallas_call, _bwd_dx_kernel):
//
//   #6  z[n,h,w,f]  = sum_{dh,dw,c} xpad[n,h+dh,w+dw,c] * w[dh,dw,c,f]
//       xpad = x with one zero ring; x (N,H,W,C) and w (2,2,C,F4) HWIO in
//       the compute dtype, z (N,H+1,W+1,F4) in f32;
//   #7  dx[n,r,s,c] = sum_{dh,dw,f} dz[n,r+1-dh,s+1-dw,f] * w[dh,dw,c,f]
//       dz (N,H+1,W+1,F4) f32 (zero outside), w upcast to f32, dx in x's
//       dtype.
//
// All tensors are NHWC in memory (the port's channels_last). F4 = 4 * the
// head's output channels (12 for RGB) is a template parameter.
//
// Bound on the card. At the facades head (N=1, x 128x128x128 bf16, F4=12)
// each kernel moves ~5.0 MB (x or dx 4.19 MB, z or dz 0.80 MB), 1.5 us at
// 3.35 TB/s, and does ~0.2 GFLOP: the tensor cores would make it bytes
// bound, but these kernels run their products on the CUDA cores in f32
// (~67 TFLOP/s), where the FLOPs take ~3 us. A simple correct kernel
// first; tensor cores (wgmma) are later work.
//
// Design.
// #6: a block computes 32 output positions of one output row with all F4
//     channels. It stages the two input rows it reads (with the zero ring
//     and the halo column, bounds-checked instead of padded in memory) in
//     shared memory as f32, transposed to [row][c][col] so a warp reads 32
//     consecutive columns of one channel, and the whole weight as f32
//     [tap][c][F4], read as float4 broadcasts. The C reduction is split
//     over 8 thread rows (one warp each, all lanes on one channel), each
//     accumulating F4 sums in registers; the 8 partials are added in a
//     fixed order and stored as one contiguous run of the output row.
// #7: a block computes 32 dx positions of one row for up to 128 channels,
//     one channel per thread. Each thread holds its 4*F4 weights in
//     registers; the two dz rows the strip reads (33 columns x F4, f32)
//     sit in shared memory and every lane reads the same dz value
//     (broadcast), so each output is 4*F4 register FMAs.
// Neither kernel uses atomics: two runs give the same bits.

#include "common.cuh"

namespace {

constexpr int kFwdCols = 32;   // output positions per #6 block (a warp)
constexpr int kFwdSplit = 8;   // channel slices per position (#6 warps)
constexpr int kDxCols = 32;    // dx positions per #7 block
constexpr int kDxThreads = 128;  // channels per #7 block (at most)

__host__ __device__ inline int round4(int v) { return (v + 3) & ~3; }

template <int F4>
__host__ __device__ inline int fwd_smem_floats(int c) {
  return round4(2 * c * (kFwdCols + 1)) + 4 * c * F4 +
         kFwdSplit * kFwdCols * F4;
}

template <typename T, int F4>
__global__ void __launch_bounds__(kFwdCols * kFwdSplit)
    subpixel_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                        float* __restrict__ z, int h, int wd, int c) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                                   // [2][c][kFwdCols+1]
  float* ws = smem + round4(2 * c * (kFwdCols + 1));  // [4][c][F4]
  float* part = ws + 4 * c * F4;                      // [split][cols][F4]
  const int n = blockIdx.z;
  const int row = blockIdx.y;                 // output row, 0..h
  const int col0 = blockIdx.x * kFwdCols;     // first output column
  const int tid = threadIdx.y * kFwdCols + threadIdx.x;
  constexpr int kThreads = kFwdCols * kFwdSplit;
  constexpr int kSpan = kFwdCols + 1;

  // input rows row-1 and row, columns col0-1 .. col0+kFwdCols-1; c fastest
  // so a warp reads consecutive global addresses
  for (int i = tid; i < 2 * kSpan * c; i += kThreads) {
    const int cc = i % c;
    const int j = (i / c) % kSpan;
    const int dh = i / (c * kSpan);
    const int xr = row - 1 + dh;
    const int xc = col0 - 1 + j;
    float v = 0.f;
    if (xr >= 0 && xr < h && xc >= 0 && xc < wd)
      v = p2p::to_f32(x[((static_cast<int64_t>(n) * h + xr) * wd + xc) * c +
                        cc]);
    xs[(dh * c + cc) * kSpan + j] = v;
  }
  for (int i = tid; i < 4 * c * F4; i += kThreads) ws[i] = p2p::to_f32(w[i]);
  __syncthreads();

  float acc[F4];
#pragma unroll
  for (int f = 0; f < F4; ++f) acc[f] = 0.f;
  const int p = threadIdx.x;
  for (int cc = threadIdx.y; cc < c; cc += kFwdSplit) {
#pragma unroll
    for (int tap = 0; tap < 4; ++tap) {
      const int dh = tap >> 1, dw = tap & 1;
      const float xv = xs[(dh * c + cc) * kSpan + p + dw];
      const float4* wr =
          reinterpret_cast<const float4*>(ws + (tap * c + cc) * F4);
#pragma unroll
      for (int q = 0; q < F4 / 4; ++q) {
        const float4 wv = wr[q];
        acc[4 * q + 0] = fmaf(xv, wv.x, acc[4 * q + 0]);
        acc[4 * q + 1] = fmaf(xv, wv.y, acc[4 * q + 1]);
        acc[4 * q + 2] = fmaf(xv, wv.z, acc[4 * q + 2]);
        acc[4 * q + 3] = fmaf(xv, wv.w, acc[4 * q + 3]);
      }
    }
  }
#pragma unroll
  for (int f = 0; f < F4; ++f)
    part[(threadIdx.y * kFwdCols + p) * F4 + f] = acc[f];
  __syncthreads();

  // the strip's outputs are one contiguous run of z: sum the slices in a
  // fixed order and store it coalesced
  const int wo = wd + 1;
  const int valid = min(kFwdCols, wo - col0);
  float* zrow = z + ((static_cast<int64_t>(n) * (h + 1) + row) * wo + col0) *
                        F4;
  for (int e = tid; e < valid * F4; e += kThreads) {
    float s = part[e];
#pragma unroll
    for (int k = 1; k < kFwdSplit; ++k) s += part[k * kFwdCols * F4 + e];
    zrow[e] = s;
  }
}

template <typename T, int F4>
__global__ void __launch_bounds__(kDxThreads)
    subpixel_dx_kernel(const float* __restrict__ dz, const T* __restrict__ w,
                       T* __restrict__ dx, int h, int wd, int c,
                       int cblocks) {
  __shared__ __align__(16) float dzs[2][kDxCols + 1][F4];
  const int n = blockIdx.z / cblocks;
  const int cc = (blockIdx.z % cblocks) * blockDim.x + threadIdx.x;
  const int r = blockIdx.y;                   // dx row, 0..h-1
  const int s0 = blockIdx.x * kDxCols;        // first dx column
  const int ho = h + 1, wo = wd + 1;

  // dz rows r (tap row dh=1) and r+1 (dh=0), columns s0 .. s0+kDxCols
  for (int i = threadIdx.x; i < 2 * (kDxCols + 1) * F4; i += blockDim.x) {
    const int f = i % F4;
    const int j = (i / F4) % (kDxCols + 1);
    const int a = i / (F4 * (kDxCols + 1));
    const int zr = r + a, zc = s0 + j;
    dzs[a][j][f] = (zr < ho && zc < wo)
                       ? dz[((static_cast<int64_t>(n) * ho + zr) * wo + zc) *
                                F4 + f]
                       : 0.f;
  }
  float wreg[4][F4];
  if (cc < c) {
#pragma unroll
    for (int tap = 0; tap < 4; ++tap)
#pragma unroll
      for (int f = 0; f < F4; ++f)
        wreg[tap][f] = p2p::to_f32(w[(tap * c + cc) * F4 + f]);
  }
  __syncthreads();
  if (cc >= c) return;

  const int valid = min(kDxCols, wd - s0);
  T* out = dx + ((static_cast<int64_t>(n) * h + r) * wd + s0) * c + cc;
  for (int t = 0; t < valid; ++t) {
    float acc = 0.f;
#pragma unroll
    for (int tap = 0; tap < 4; ++tap) {
      const int dh = tap >> 1, dw = tap & 1;
      const float* dv = dzs[1 - dh][t + 1 - dw];
#pragma unroll
      for (int f = 0; f < F4; ++f) acc = fmaf(dv[f], wreg[tap][f], acc);
    }
    out[static_cast<int64_t>(t) * c] = p2p::from_f32<T>(acc);
  }
}

template <typename T, int F4>
int launch_fwd(const void* x, const void* w, float* z, int n, int h, int wd,
               int c, cudaStream_t stream) {
  const size_t smem = sizeof(float) * fwd_smem_floats<F4>(c);
  auto kernel = subpixel_fwd_kernel<T, F4>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((wd + 1 + kFwdCols - 1) / kFwdCols, h + 1, n);
  const dim3 block(kFwdCols, kFwdSplit);
  kernel<<<grid, block, smem, stream>>>(static_cast<const T*>(x),
                                        static_cast<const T*>(w), z, h, wd, c);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int F4>
int launch_dx(const float* dz, const void* w, void* dx, int n, int h, int wd,
              int c, cudaStream_t stream) {
  const int threads = c < kDxThreads ? (c + 31) / 32 * 32 : kDxThreads;
  const int cblocks = (c + threads - 1) / threads;
  const dim3 grid((wd + kDxCols - 1) / kDxCols, h, n * cblocks);
  subpixel_dx_kernel<T, F4><<<grid, threads, 0, stream>>>(
      dz, static_cast<const T*>(w), static_cast<T*>(dx), h, wd, c, cblocks);
  return static_cast<int>(cudaGetLastError());
}

// dtype x F4 dispatch: F4 in {4, 8, 12, 16} (1-4 output channels)
template <template <typename, int> class Launch, typename... Args>
int dispatch(int dtype, int f4, Args... args) {
  const bool bf16 = dtype == p2p::kBF16;
  if (dtype != p2p::kF32 && !bf16) return cudaErrorInvalidValue;
  switch (f4) {
    case 4: return bf16 ? Launch<__nv_bfloat16, 4>::run(args...)
                        : Launch<float, 4>::run(args...);
    case 8: return bf16 ? Launch<__nv_bfloat16, 8>::run(args...)
                        : Launch<float, 8>::run(args...);
    case 12: return bf16 ? Launch<__nv_bfloat16, 12>::run(args...)
                         : Launch<float, 12>::run(args...);
    case 16: return bf16 ? Launch<__nv_bfloat16, 16>::run(args...)
                         : Launch<float, 16>::run(args...);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, int F4>
struct Fwd {
  static int run(const void* x, const void* w, float* z, int n, int h, int wd,
                 int c, cudaStream_t s) {
    return launch_fwd<T, F4>(x, w, z, n, h, wd, c, s);
  }
};

template <typename T, int F4>
struct Dx {
  static int run(const float* dz, const void* w, void* dx, int n, int h,
                 int wd, int c, cudaStream_t s) {
    return launch_dx<T, F4>(dz, w, dx, n, h, wd, c, s);
  }
};

}  // namespace

// #6. x: (N,H,W,C) and w: (2,2,C,F4) in dtype (p2p::DType); z: (N,H+1,W+1,
// F4) f32. Returns the CUDA error of the launch (0 = success).
extern "C" int p2p_subpixel_head_fwd(const void* x, const void* w, float* z,
                                     int dtype, int n, int h, int wd, int c,
                                     int f4, void* stream_ptr) {
  return dispatch<Fwd>(dtype, f4, x, w, z, n, h, wd, c,
                       static_cast<cudaStream_t>(stream_ptr));
}

// #7. dz: (N,H+1,W+1,F4) f32; w: (2,2,C,F4) and dx: (N,H,W,C) in dtype.
extern "C" int p2p_subpixel_head_dx(const float* dz, const void* w, void* dx,
                                    int dtype, int n, int h, int wd, int c,
                                    int f4, void* stream_ptr) {
  return dispatch<Dx>(dtype, f4, dz, w, dx, n, h, wd, c,
                      static_cast<cudaStream_t>(stream_ptr));
}

// The dynamic shared memory #6 needs at channel count c (the wrapper checks
// it against the card's limit before launching).
extern "C" int p2p_subpixel_head_fwd_smem(int c, int f4) {
  switch (f4) {
    case 4: return sizeof(float) * fwd_smem_floats<4>(c);
    case 8: return sizeof(float) * fwd_smem_floats<8>(c);
    case 12: return sizeof(float) * fwd_smem_floats<12>(c);
    case 16: return sizeof(float) * fwd_smem_floats<16>(c);
    default: return -1;
  }
}
