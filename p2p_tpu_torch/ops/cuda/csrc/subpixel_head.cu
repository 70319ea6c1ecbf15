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
// Bound on the card: bytes. At the facades head (N=1, x 128x128x128 bf16,
// F4=12) each kernel moves ~5.0 MB (x or dx 4.19 MB, z or dz 0.80 MB),
// 1.49 us at 3.35 TB/s, and does ~0.2 GFLOP, 0.2 us on the bf16 tensor
// cores (989 TFLOP/s) but ~3 us on the CUDA cores in f32 (67 TFLOP/s).
// #7 in bf16 does three times #6's tensor-core work (dz in three pieces,
// below): 0.6 GFLOP, 0.6 us, still under the bytes bound.
//
// #6 in bf16: an implicit GEMM on the tensor cores. Each output row is a
// (positions x 4C) . (4C x F4) product, so a block takes a column tile of
// TW output positions over a band of output rows of one sample, and runs
// mma.sync.m16n8k16 (bf16 x bf16 -> f32; two n8 tiles when F4 > 8). Two
// warps share each m16 tile, one per input row (taps (0, *) and (1, *)),
// each with one accumulator chain per tap, so that a warp's chain of
// dependent MMAs is a quarter of the K depth; the four tap sums are added
// in a fixed order. The grid is one wave (tc_plan: the widest tile of at
// most kMaxTile positions whose shared memory fits a block, then bands of
// output rows so that the blocks that fit an SM, one or two, fill the
// card once), so:
//   - the weight, zero-padded to C_p = C rounded up to 16 and to 8 or 16
//     columns, is loaded once per block into shared memory as [k][24]
//     (k = tap*C_p + c; 48-byte rows, so ldmatrix.trans reads the B
//     operand without bank conflicts);
//   - the input rows of the band sit in a ring of 3 row slots, each
//     (TW+1) x C_p bf16 with a 16-byte pad per position (ldmatrix reads
//     the A operand without bank conflicts): output row r reads padded
//     rows r and r+1, and the load of row r+2 (cp.async, 16 bytes a copy,
//     zero-filled outside x: the zero ring costs nothing) is in flight
//     while row r computes. Each x row is loaded once per band, plus one
//     halo row;
//   - the f32 tile is staged in shared memory and stored as one
//     contiguous run of z in 16-byte stores (only the valid positions and
//     the F4 valid columns).
// C % 8 != 0 or a misaligned x or w take element loads into the same
// slots. The products of two bf16 values are exact in f32; only the
// order of the f32 sums differs from the plain version.
// #6 in f32: the CUDA cores, which keep full f32 products (TF32 would
// keep about three decimal digits, and the f32 checks run with TF32 off).
// A block computes 32 output positions of one output row with all F4
//     channels. It stages the two input rows it reads (with the zero ring
//     and the halo column, bounds-checked instead of padded in memory) in
//     shared memory, transposed to [row][c][col] so a warp reads 32
//     consecutive columns of one channel, and the whole weight as
//     [tap][c][F4], read as float4 broadcasts. The C reduction is split
//     over 8 thread rows (one warp each, all lanes on one channel), each
//     accumulating F4 sums in registers; the 8 partials are added in a
//     fixed order and stored as one contiguous run of the output row.
// #7 in bf16: an implicit GEMM on the tensor cores with M = dx positions,
// N = channels and K = the four taps x F4, k = tap*F4 + f (K = 16, 32, 48
// or 64: no k16 step is padded): A[s][k] = dz[r+1-dh][s+1-dw][f] and
// B[k][c] = w[dh][dw][c][f]. w is bf16 but dz f32, so each dz value is cut
// into three bf16 pieces, v = hi + mid + lo exactly: hi is v with its low
// 16 bits cleared (v rounded toward zero to bf16), mid the same of the
// remainder v - hi (exact in f32), and lo = v - hi - mid, which has at
// most 8 significant bits and so is a bf16 as it is (for |v| above about
// 2^-110; below, lo is an f32 subnormal and its bf16 is off by less than
// 2^-133). A piece times a bf16 weight is exact in f32, so
// mma.sync.m16n8k16 (bf16 x bf16 -> f32) forms the plain f32 version's
// products; per k16 step the lo, mid and hi
// products go into the same accumulators in that order, the steps in
// order of k, so only the order of the f32 sums differs, and two runs
// give the same bits. Cutting toward zero keeps hi finite for every
// finite v; a dz of +-inf or NaN gives a NaN remainder, so dx is NaN where
// the plain version gives +-inf or NaN: non-finite exactly where it is.
// A block takes a band of dx rows of one sample over a tile of TW
// positions and all C channels; the grid is one wave (dx_plan, planned as
// tc_plan), so:
//   - w is loaded once per block into shared memory as B, rows [c][k] of
//     K + 8 bf16 (the 16-byte pad lets ldmatrix read them without bank
//     conflicts);
//   - the band's dz rows sit as f32 in a ring of 3 row slots of TW + 1
//     positions (cp.async, 16 bytes a copy, zero-filled past dz's last
//     column): dx row r reads dz rows r and r+1, and dz row r+2 loads
//     while row r computes;
//   - a block's tile is at most 64 positions; a warp takes an m16 tile of
//     positions over 64 channels (8 n8 accumulator tiles, 32 f32
//     registers), so the facades head at N = 1 runs 256 one-row blocks,
//     two an SM; it builds its A fragments from the f32 slots, two floats
//     a register, cutting them into the three pieces as it loads them, and
//     its B fragments with ldmatrix;
//   - the f32 tile is rounded once to bf16 into shared memory and stored
//     as one contiguous run of the dx row in 16-byte stores (only the
//     valid positions and channels).
// C % 8 != 0 or a misaligned dz or w take element loads and stores
// through the same shared memory.
// #7 in f32: the CUDA cores. A block computes 32 dx positions of one row
//     for up to 128 channels, one channel per thread. Each thread holds its
//     4*F4 weights in registers; the two dz rows the strip reads (33
//     columns x F4, f32) sit in shared memory and every lane reads the same
//     dz value (broadcast), so each output is 4*F4 register FMAs.
// No kernel uses atomics, and every output sums its terms in a fixed
// order: two runs give the same bits.

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

// ---- #6 in bf16 on the tensor cores -------------------------------------

constexpr int kRing = 3;      // input row slots: rows r, r+1 and r+2 loading
constexpr int kRowPad = 8;    // bf16 pad per slot position (16 bytes)
constexpr int kWStride = 24;  // bf16 per weight row: 16 columns + 16 bytes
constexpr int kMaxTile = 192; // output positions per block (24 warps)
// an H100's shared memory per block (the opt-in maximum) and per SM (less
// the 1 KB the card reserves for each resident block)
constexpr int kMaxSmem = 232448;
constexpr int kSmSmem = 233472;

// Dynamic shared memory of the tensor-core #6: the f32 output tile, the
// ring of input row slots, the weight.
__host__ __device__ inline int tc_smem_bytes(int tw, int cp, int f4) {
  return 4 * tw * f4 + 2 * kRing * (tw + 1) * (cp + kRowPad) +
         2 * 4 * cp * kWStride;
}

struct TcPlan {
  int cp;         // channels padded to the MMA depth (16)
  int tw;         // output positions per block (16 per two warps)
  int col_tiles;  // blocks along W + 1
  int smem;       // dynamic shared memory per block, bytes
  int band = 1;   // output rows per block
  int bands = 1;  // blocks along H + 1
};

// The widest column tile (a multiple of 16, at most max_tile) over cols
// output columns whose shared memory smem(tw) fits a block (where not even
// 16 positions fit, the 16-position plan, whose smem the caller refuses);
// then, for a launch on sms SMs, bands of the rows output rows so that the
// grid is one wave of the blocks that fit an SM (one or two).
template <typename Smem>
inline TcPlan plan_wave(int cols, int rows, int max_tile, Smem smem, int n,
                        int sms) {
  TcPlan p{0, 0, (cols + max_tile - 1) / max_tile, 0};
  for (;; ++p.col_tiles) {
    p.tw = (cols + 16 * p.col_tiles - 1) / (16 * p.col_tiles) * 16;
    p.smem = smem(p.tw);
    if (p.smem <= kMaxSmem || p.tw == 16) break;
  }
  p.col_tiles = (cols + p.tw - 1) / p.tw;
  const int per_sm = kSmSmem / (p.smem + 1024) >= 2 ? 2 : 1;
  const int64_t tiles = static_cast<int64_t>(n) * p.col_tiles;
  int64_t bands = (static_cast<int64_t>(sms) * per_sm + tiles - 1) / tiles;
  bands = bands > rows ? rows : (bands < 1 ? 1 : bands);
  p.band = static_cast<int>((rows + bands - 1) / bands);
  p.bands = (rows + p.band - 1) / p.band;
  return p;
}

// #6's plan: W + 1 output columns, H + 1 output rows
inline TcPlan tc_plan(int wd, int c, int f4, int n = 1, int h = 0,
                      int sms = 0) {
  const int cp = (c + 15) / 16 * 16;
  TcPlan p = plan_wave(
      wd + 1, h + 1, kMaxTile,
      [&](int tw) { return tc_smem_bytes(tw, cp, f4); }, n, sms);
  p.cp = cp;
  return p;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16- and 8-byte asynchronous copies; src_bytes 0 writes zeros (the
// source is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 8 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most one committed group is still in flight
__device__ __forceinline__ void cp_async_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t* r,
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_u32(p)));
}

// d += a (16x16, row) . b (16x8, col), bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// grid (bands, column tiles, N), TW/8 warps. Block (b, t, n) computes
// output rows b*band .. +band-1 (clipped to H+1) at output columns
// t*TW .. +TW-1 (clipped to W+1) of sample n. VEC: 16-byte copies of x
// (C % 8 == 0, x 16-byte aligned) and 8-byte copies of w (w 8-byte
// aligned); else element loads.
template <int F4, bool VEC>
__global__ void __launch_bounds__(kMaxTile * 4)
    subpixel_fwd_tc_kernel(const __nv_bfloat16* __restrict__ x,
                           const __nv_bfloat16* __restrict__ w,
                           float* __restrict__ z, int h, int wd, int c,
                           int cp, int tw, int band) {
  constexpr int NT = F4 > 8 ? 2 : 1;  // n8 tiles
  extern __shared__ __align__(16) unsigned char smem_tc[];
  float* stage = reinterpret_cast<float*>(smem_tc);  // [tw][F4]
  __nv_bfloat16* ring =
      reinterpret_cast<__nv_bfloat16*>(smem_tc + 4 * tw * F4);
  const int rs = cp + kRowPad;           // slot stride per position
  const int slot = (tw + 1) * rs;        // elements per slot
  __nv_bfloat16* ws = ring + kRing * slot;  // [4*cp][kWStride]

  const int n = blockIdx.z;
  const int s0 = blockIdx.y * tw;        // first output column
  const int r0 = blockIdx.x * band;      // first output row
  const int ho = h + 1, wo = wd + 1;
  const int r1 = min(r0 + band, ho);     // reads padded rows r0 .. r1
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);

  // padded row P (x row P-1), padded columns s0 .. s0+tw (x columns
  // s0-1 .. s0+tw-1), channels 0 .. cp-1, zeros outside x
  auto load_row = [&](int P) {
    __nv_bfloat16* dst = ring + (P % kRing) * slot;
    const int xr = P - 1;
    const bool row_ok = xr >= 0 && xr < h;
    const __nv_bfloat16* xrow =
        x + (static_cast<int64_t>(n) * h + (row_ok ? xr : 0)) * wd * c;
    if (VEC) {
      const int chunks = cp / 8;
      for (int i = tid; i < (tw + 1) * chunks; i += nthreads) {
        const int j = i / chunks, q = i - j * chunks;
        const int xc = s0 + j - 1;
        const bool ok = row_ok && xc >= 0 && xc < wd && q * 8 < c;
        cp_async16(dst + j * rs + q * 8,
                   ok ? xrow + static_cast<int64_t>(xc) * c + q * 8 : x, ok);
      }
    } else {
      for (int i = tid; i < (tw + 1) * cp; i += nthreads) {
        const int j = i / cp, cc = i - j * cp;
        const int xc = s0 + j - 1;
        const bool ok = row_ok && xc >= 0 && xc < wd && cc < c;
        dst[j * rs + cc] = ok ? xrow[static_cast<int64_t>(xc) * c + cc] : zero;
      }
    }
    cp_async_commit();
  };

  load_row(r0);
  load_row(r0 + 1);
  // the weight as the B operand: ws[tap*cp + cc][f], zero for cc >= c and
  // f >= F4 (columns NT*8 .. kWStride-1 are never read)
  if (VEC) {
    constexpr int kChunks = NT * 2;  // 8-byte copies per row
    for (int i = tid; i < 4 * cp * kChunks; i += nthreads) {
      const int k = i / kChunks, q = i - k * kChunks;
      const int tap = k / cp, cc = k - tap * cp;
      const bool ok = cc < c && q * 4 < F4;
      cp_async8(ws + k * kWStride + q * 4,
                ok ? w + (static_cast<int64_t>(tap) * c + cc) * F4 + q * 4
                   : w,
                ok);
    }
    cp_async_commit();
  } else {
    for (int i = tid; i < 4 * cp * NT * 8; i += nthreads) {
      const int k = i / (NT * 8), f = i - k * (NT * 8);
      const int tap = k / cp, cc = k - tap * cp;
      ws[k * kWStride + f] =
          (cc < c && f < F4)
              ? w[(static_cast<int64_t>(tap) * c + cc) * F4 + f]
              : zero;
    }
  }

  // warp w takes the 16 positions m0 .. m0+15 and the input row dh of
  // the taps (dh, 0) and (dh, 1): the first tw/16 warps row r (dh = 0),
  // the others row r + 1 (dh = 1), each with one accumulator chain per tap
  const int mtiles = tw >> 4;
  const int warp = tid >> 5, lane = tid & 31;
  const int dh = warp >= mtiles ? 1 : 0;
  const int m0 = (warp - dh * mtiles) * 16;
  const int g = lane >> 2, t = lane & 3;
  // ldmatrix row addresses: A (x4) positions m0 + lane%16 (+1 for dw = 1)
  // at k offset (lane/16)*8; B (x4 trans) k rows (lane/8 % 2)*8 + lane%8
  // at column (lane/16)*8
  const int a_pos = m0 + (lane & 15);
  const int a_k = (lane >> 4) * 8;
  const int b_k = ((lane >> 3) & 1) * 8 + (lane & 7);
  const int b_n = (lane >> 4) * 8;
  const __nv_bfloat16* b0 = ws + ((2 * dh) * cp + b_k) * kWStride + b_n;
  const __nv_bfloat16* b1 = b0 + cp * kWStride;

  for (int r = r0; r < r1; ++r) {
    // slot (r+2) % 3 held row r-1, last read before the barrier that
    // ended iteration r-1
    if (r + 2 <= r1) {
      load_row(r + 2);
    } else {
      cp_async_commit();
    }
    cp_async_wait_all_but_one();   // rows r, r+1 (and the weight) are in
    __syncthreads();

    float acc[2][NT][4];
#pragma unroll
    for (int d = 0; d < 2; ++d)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[d][j][e] = 0.f;
    const __nv_bfloat16* a0 =
        ring + ((r + dh) % kRing) * slot + a_pos * rs + a_k;
    const __nv_bfloat16* a1 = a0 + rs;   // dw = 1: the next position
#pragma unroll 2
    for (int kc = 0; kc < cp; kc += 16) {
      uint32_t fa0[4], fa1[4];
      ldmatrix_x4(fa0, a0 + kc);
      ldmatrix_x4(fa1, a1 + kc);
      if (NT == 2) {
        uint32_t fb0[4], fb1[4];
        ldmatrix_x4_trans(fb0, b0 + kc * kWStride);
        ldmatrix_x4_trans(fb1, b1 + kc * kWStride);
        mma_bf16(acc[0][0], fa0, fb0[0], fb0[1]);
        mma_bf16(acc[0][NT - 1], fa0, fb0[2], fb0[3]);
        mma_bf16(acc[1][0], fa1, fb1[0], fb1[1]);
        mma_bf16(acc[1][NT - 1], fa1, fb1[2], fb1[3]);
      } else {
        uint32_t fb0[2], fb1[2];
        ldmatrix_x2_trans(fb0, b0 + kc * kWStride);
        ldmatrix_x2_trans(fb1, b1 + kc * kWStride);
        mma_bf16(acc[0][0], fa0, fb0[0], fb0[1]);
        mma_bf16(acc[1][0], fa1, fb1[0], fb1[1]);
      }
    }
    // z = (taps (0,0) + (0,1)) + (taps (1,0) + (1,1)), in this order:
    // accumulator (j, e) is position m0 + g (+8 for e >= 2), column
    // 8j + 2t (+1 for odd e); F4 is even, so a column pair is all valid
    // or all padding
#pragma unroll
    for (int pass = 0; pass < 2; ++pass) {
      if (dh == pass) {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int col = 8 * j + 2 * t;
          if (col < F4) {
            float2* s_lo =
                reinterpret_cast<float2*>(stage + (m0 + g) * F4 + col);
            float2* s_hi =
                reinterpret_cast<float2*>(stage + (m0 + g + 8) * F4 + col);
            float2 lo = make_float2(acc[0][j][0] + acc[1][j][0],
                                    acc[0][j][1] + acc[1][j][1]);
            float2 hi = make_float2(acc[0][j][2] + acc[1][j][2],
                                    acc[0][j][3] + acc[1][j][3]);
            if (pass == 1) {
              const float2 plo = *s_lo, phi = *s_hi;
              lo = make_float2(plo.x + lo.x, plo.y + lo.y);
              hi = make_float2(phi.x + hi.x, phi.y + hi.y);
            }
            *s_lo = lo;
            *s_hi = hi;
          }
        }
      }
      __syncthreads();
    }
    // the tile's valid positions are one contiguous run of z
    const int valid = min(tw, wo - s0);
    float4* zrow = reinterpret_cast<float4*>(
        z + ((static_cast<int64_t>(n) * ho + r) * wo + s0) * F4);
    const float4* srow = reinterpret_cast<const float4*>(stage);
    for (int e = tid; e < valid * (F4 / 4); e += nthreads) zrow[e] = srow[e];
  }
}

template <int F4>
int launch_fwd_tc(const void* x, const void* w, float* z, int n, int h,
                  int wd, int c, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const TcPlan p = tc_plan(wd, c, F4, n, h, sms);
  if (p.smem > kMaxSmem) return cudaErrorInvalidValue;
  const bool vec = c % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 8 == 0;
  auto kernel = vec ? subpixel_fwd_tc_kernel<F4, true>
                    : subpixel_fwd_tc_kernel<F4, false>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(p.bands, p.col_tiles, n);
  kernel<<<grid, p.tw * 4, p.smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w), z, h, wd, c, p.cp, p.tw, p.band);
  return static_cast<int>(cudaGetLastError());
}

// ---- #7 in bf16 on the tensor cores ------------------------------------

constexpr int kDxMaxTile = 64;  // dx positions per block (4 m16 tiles)
constexpr int kDxSlice = 64;    // channels per warp (8 n8 tiles)
constexpr int kDxWarps = 8;     // warps per block (at most)

// f32 per position in a dz row slot: F4, or 24 at F4 = 16 (the A loads of
// a half-warp then hit every bank once)
__host__ __device__ constexpr int dx_pos_stride(int f4) {
  return f4 == 16 ? 24 : f4;
}

// Dynamic shared memory of the tensor-core #7: the ring of dz row slots
// (f32), the weight as B ([c][4*F4 + 8] bf16, C rounded up to 16) and the
// bf16 dx tile ([tw][C16 + 8]).
inline int dx_smem_bytes(int tw, int c, int f4) {
  const int c16 = (c + 15) / 16 * 16;
  return 4 * kRing * (tw + 1) * dx_pos_stride(f4) + 2 * c16 * (4 * f4 + 8) +
         2 * tw * (c16 + 8);
}

// #7's plan: W dx columns, H dx rows (h >= 1)
inline TcPlan dx_plan(int wd, int c, int f4, int n = 1, int h = 1,
                      int sms = 0) {
  TcPlan p = plan_wave(
      wd, h, kDxMaxTile, [&](int tw) { return dx_smem_bytes(tw, c, f4); }, n,
      sms);
  p.cp = (c + 15) / 16 * 16;
  return p;
}

// A pair of f32 values as three bf16x2 pieces, v = hi + mid + lo exactly
// (lower k in the low half): hi is v cut toward zero to bf16 (its high 16
// bits), mid the same of the remainder v - hi, which is exact in f32, and
// lo = v - hi - mid, whose low 16 bits are zero.
__device__ __forceinline__ void split3(float2 v, uint32_t& lo, uint32_t& mid,
                                       uint32_t& hi) {
  const uint32_t ux = __float_as_uint(v.x), uy = __float_as_uint(v.y);
  hi = __byte_perm(ux, uy, 0x7632);
  const float rx = v.x - __uint_as_float(ux & 0xffff0000u);
  const float ry = v.y - __uint_as_float(uy & 0xffff0000u);
  const uint32_t urx = __float_as_uint(rx), ury = __float_as_uint(ry);
  mid = __byte_perm(urx, ury, 0x7632);
  const float sx = rx - __uint_as_float(urx & 0xffff0000u);
  const float sy = ry - __uint_as_float(ury & 0xffff0000u);
  lo = __byte_perm(__float_as_uint(sx), __float_as_uint(sy), 0x7632);
}

// grid (bands, column tiles, N), 32 * min(items, kDxWarps) threads, where
// an item is one m16 tile of the block's positions over one slice of
// kDxSlice channels. Block (b, t, n) computes dx rows b*band .. +band-1
// (clipped to H) at columns t*TW .. +TW-1 (clipped to W) of sample n, all
// C channels. VEC: 16-byte copies of dz, 8-byte copies of w and 16-byte
// stores of dx (C % 8 == 0, dz and dx 16-byte and w 8-byte aligned); else
// element loads and stores.
template <int F4, bool VEC>
__global__ void __launch_bounds__(kDxWarps * 32, 2)
    subpixel_dx_tc_kernel(const float* __restrict__ dz,
                          const __nv_bfloat16* __restrict__ w,
                          __nv_bfloat16* __restrict__ dx, int h, int wd,
                          int c, int tw, int band) {
  constexpr int K = 4 * F4;              // GEMM depth: k = tap*F4 + f
  constexpr int PS = dx_pos_stride(F4);  // f32 per slot position
  constexpr int BS = K + 8;              // bf16 per B row
  extern __shared__ __align__(16) unsigned char smem_dx[];
  float* ring = reinterpret_cast<float*>(smem_dx);
  const int slot = (tw + 1) * PS;        // f32 per dz row slot
  const int c16 = (c + 15) & ~15;
  __nv_bfloat16* bs = reinterpret_cast<__nv_bfloat16*>(ring + kRing * slot);
  __nv_bfloat16* stage = bs + c16 * BS;  // [tw][ss]
  const int ss = c16 + 8;

  const int n = blockIdx.z;
  const int s0 = blockIdx.y * tw;        // first dx column
  const int r0 = blockIdx.x * band;      // first dx row
  const int r1 = min(r0 + band, h);      // reads dz rows r0 .. r1
  const int ho = h + 1, wo = wd + 1;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);

  // the weight as the B operand: bs[cc][tap*F4 + f] = w[tap][cc][f], zero
  // for cc >= c; read in w's order
  if (VEC) {
    constexpr int kQuads = F4 / 4;       // 8-byte copies per (tap, cc)
    for (int i = tid; i < 4 * c16 * kQuads; i += nthreads) {
      const int row = i / kQuads, q = i - row * kQuads;
      const int tap = row / c16, cc = row - tap * c16;
      const bool ok = cc < c;
      cp_async8(bs + cc * BS + tap * F4 + 4 * q,
                ok ? w + (static_cast<int64_t>(tap) * c + cc) * F4 + 4 * q
                   : w,
                ok);
    }
  } else {
    for (int i = tid; i < 4 * c16 * F4; i += nthreads) {
      const int row = i / F4, f = i - row * F4;
      const int tap = row / c16, cc = row - tap * c16;
      bs[cc * BS + tap * F4 + f] =
          cc < c ? w[(static_cast<int64_t>(tap) * c + cc) * F4 + f] : zero;
    }
  }
  cp_async_commit();

  // dz row zr, columns s0 .. s0+tw, zeros past dz's last column
  auto load_row = [&](int zr) {
    float* dst = ring + (zr % kRing) * slot;
    const float* zrow = dz + (static_cast<int64_t>(n) * ho + zr) * wo * F4;
    if (VEC) {
      constexpr int kChunks = F4 / 4;
      for (int i = tid; i < (tw + 1) * kChunks; i += nthreads) {
        const int j = i / kChunks, q = i - j * kChunks;
        const bool ok = s0 + j < wo;
        cp_async16(dst + j * PS + 4 * q,
                   ok ? zrow + (s0 + j) * F4 + 4 * q : dz, ok);
      }
    } else {
      for (int i = tid; i < (tw + 1) * F4; i += nthreads) {
        const int j = i / F4, f = i - j * F4;
        dst[j * PS + f] = s0 + j < wo ? zrow[(s0 + j) * F4 + f] : 0.f;
      }
    }
    cp_async_commit();
  };
  load_row(r0);
  load_row(r0 + 1);

  const int warp = tid >> 5, lane = tid & 31;
  const int nwarps = nthreads >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int mtiles = tw >> 4;
  const int items = mtiles * ((c16 + kDxSlice - 1) / kDxSlice);
  // A: this lane's k = 8q + 2t, 8q + 2t + 1 of chunk q lie in one tap (F4
  // is even): its f32 offset in the slot at position g (column g + 1 - dw);
  // the chunk's dz row is r + 1 - dh, dh = 8q >= 2*F4 (2*F4 is a multiple
  // of 8, so a chunk never spans two dz rows)
  int aoff[K / 8];
#pragma unroll
  for (int q = 0; q < K / 8; ++q) {
    const int k = 8 * q + 2 * t;
    const int tap = k / F4;
    aoff[q] = (g + 1 - (tap & 1)) * PS + k - tap * F4;
  }
  // B (ldmatrix x4 of [n][k] rows): n8 tiles 2jp and 2jp + 1, k halves
  const int b_row = (lane & 7) + ((lane >> 4) << 3);
  const int b_k = ((lane >> 3) & 1) * 8;
  const int valid = min(tw, wd - s0);

  for (int r = r0; r < r1; ++r) {
    // slot (r+2) % 3 held dz row r-1, last read before the barrier that
    // ended iteration r-1's products
    if (r + 2 <= r1) {
      load_row(r + 2);
    } else {
      cp_async_commit();
    }
    cp_async_wait_all_but_one();   // the weight and dz rows r, r+1 are in
    __syncthreads();

    const float* z0 = ring + ((r + 1) % kRing) * slot;  // dh = 0
    const float* z1 = ring + (r % kRing) * slot;        // dh = 1
    for (int item = warp; item < items; item += nwarps) {
      const int mt = item % mtiles;
      const int nb = (item / mtiles) * kDxSlice;         // first channel
      const int pairs = min(kDxSlice, c16 - nb) >> 4;    // n8 tile pairs
      float acc[kDxSlice / 8][4];
#pragma unroll
      for (int j = 0; j < kDxSlice / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < K / 16; ++ks) {
        // A fragments of this k16 step: [piece: lo, mid, hi][register]
        uint32_t a[3][4];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int q = 2 * ks + half;
          const float* za =
              (8 * q >= 2 * F4 ? z1 : z0) + mt * 16 * PS + aoff[q];
          split3(*reinterpret_cast<const float2*>(za), a[0][2 * half],
                 a[1][2 * half], a[2][2 * half]);
          split3(*reinterpret_cast<const float2*>(za + 8 * PS),
                 a[0][2 * half + 1], a[1][2 * half + 1], a[2][2 * half + 1]);
        }
#pragma unroll
        for (int jp = 0; jp < kDxSlice / 16; ++jp) {
          if (jp < pairs) {
            uint32_t b[4];
            ldmatrix_x4(b, bs + (nb + 16 * jp + b_row) * BS + 16 * ks + b_k);
#pragma unroll
            for (int piece = 0; piece < 3; ++piece) {
              mma_bf16(acc[2 * jp], a[piece], b[0], b[1]);
              mma_bf16(acc[2 * jp + 1], a[piece], b[2], b[3]);
            }
          }
        }
      }
      // round once to bf16 into the tile: accumulator (j, e) is position
      // mt*16 + g (+8 for e >= 2), channel nb + 8j + 2t (+1 for odd e)
      __nv_bfloat16* st = stage + (mt * 16 + g) * ss + nb + 2 * t;
#pragma unroll
      for (int j = 0; j < kDxSlice / 8; ++j) {
        if (j < 2 * pairs) {
          *reinterpret_cast<__nv_bfloat162*>(st + 8 * j) =
              __floats2bfloat162_rn(acc[j][0], acc[j][1]);
          *reinterpret_cast<__nv_bfloat162*>(st + 8 * ss + 8 * j) =
              __floats2bfloat162_rn(acc[j][2], acc[j][3]);
        }
      }
    }
    __syncthreads();

    // the tile's valid positions are one contiguous run of the dx row;
    // (j, q) walks the tile with the run's index i
    __nv_bfloat16* out =
        dx + ((static_cast<int64_t>(n) * h + r) * wd + s0) * c;
    const int per = VEC ? c >> 3 : c;    // stores per position
    const int dj = nthreads / per, dq = nthreads - dj * per;
    int j = tid / per, q = tid - j * per;
    for (int i = tid; i < valid * per; i += nthreads) {
      if (VEC) {
        *reinterpret_cast<uint4*>(out + 8 * i) =
            *reinterpret_cast<const uint4*>(stage + j * ss + 8 * q);
      } else {
        out[i] = stage[j * ss + q];
      }
      j += dj;
      q += dq;
      if (q >= per) {
        q -= per;
        ++j;
      }
    }
  }
}

template <int F4>
int launch_dx_tc(const float* dz, const void* w, void* dx, int n, int h,
                 int wd, int c, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const TcPlan p = dx_plan(wd, c, F4, n, h, sms);
  if (p.smem > kMaxSmem) return cudaErrorInvalidValue;
  const bool vec = c % 8 == 0 && reinterpret_cast<uintptr_t>(dz) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dx) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 8 == 0;
  auto kernel = vec ? subpixel_dx_tc_kernel<F4, true>
                    : subpixel_dx_tc_kernel<F4, false>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             p.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int items = (p.tw / 16) * ((p.cp + kDxSlice - 1) / kDxSlice);
  const dim3 grid(p.bands, p.col_tiles, n);
  kernel<<<grid, 32 * (items < kDxWarps ? items : kDxWarps), p.smem,
           stream>>>(dz, static_cast<const __nv_bfloat16*>(w),
                     static_cast<__nv_bfloat16*>(dx), h, wd, c, p.tw,
                     p.band);
  return static_cast<int>(cudaGetLastError());
}

// ---- #7 in f32 -------------------------------------------------------------

template <int F4>
__global__ void __launch_bounds__(kDxThreads)
    subpixel_dx_kernel(const float* __restrict__ dz,
                       const float* __restrict__ w, float* __restrict__ dx,
                       int h, int wd, int c, int cblocks) {
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
        wreg[tap][f] = w[(tap * c + cc) * F4 + f];
  }
  __syncthreads();
  if (cc >= c) return;

  const int valid = min(kDxCols, wd - s0);
  float* out = dx + ((static_cast<int64_t>(n) * h + r) * wd + s0) * c + cc;
  for (int t = 0; t < valid; ++t) {
    float acc = 0.f;
#pragma unroll
    for (int tap = 0; tap < 4; ++tap) {
      const int dh = tap >> 1, dw = tap & 1;
      const float* dv = dzs[1 - dh][t + 1 - dw];
#pragma unroll
      for (int f = 0; f < F4; ++f) acc = fmaf(dv[f], wreg[tap][f], acc);
    }
    out[static_cast<int64_t>(t) * c] = acc;
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

template <int F4>
int launch_dx(const float* dz, const void* w, void* dx, int n, int h, int wd,
              int c, cudaStream_t stream) {
  const int threads = c < kDxThreads ? (c + 31) / 32 * 32 : kDxThreads;
  const int cblocks = (c + threads - 1) / threads;
  const dim3 grid((wd + kDxCols - 1) / kDxCols, h, n * cblocks);
  subpixel_dx_kernel<F4><<<grid, threads, 0, stream>>>(
      dz, static_cast<const float*>(w), static_cast<float*>(dx), h, wd, c,
      cblocks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// #6. x: (N,H,W,C) and w: (2,2,C,F4) in dtype (p2p::DType): bf16 on the
// tensor cores, f32 on the CUDA cores; z: (N,H+1,W+1,F4) f32. Returns the
// CUDA error of the launch (0 = success).
extern "C" int p2p_subpixel_head_fwd(const void* x, const void* w, float* z,
                                     int dtype, int n, int h, int wd, int c,
                                     int f4, void* stream_ptr) {
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  if (dtype == p2p::kBF16) {
    switch (f4) {
      case 4: return launch_fwd_tc<4>(x, w, z, n, h, wd, c, s);
      case 8: return launch_fwd_tc<8>(x, w, z, n, h, wd, c, s);
      case 12: return launch_fwd_tc<12>(x, w, z, n, h, wd, c, s);
      case 16: return launch_fwd_tc<16>(x, w, z, n, h, wd, c, s);
      default: return cudaErrorInvalidValue;
    }
  }
  if (dtype != p2p::kF32) return cudaErrorInvalidValue;
  switch (f4) {
    case 4: return launch_fwd<float, 4>(x, w, z, n, h, wd, c, s);
    case 8: return launch_fwd<float, 8>(x, w, z, n, h, wd, c, s);
    case 12: return launch_fwd<float, 12>(x, w, z, n, h, wd, c, s);
    case 16: return launch_fwd<float, 16>(x, w, z, n, h, wd, c, s);
    default: return cudaErrorInvalidValue;
  }
}

// #7. dz: (N,H+1,W+1,F4) f32; w: (2,2,C,F4) and dx: (N,H,W,C) in dtype:
// bf16 on the tensor cores, f32 on the CUDA cores.
extern "C" int p2p_subpixel_head_dx(const float* dz, const void* w, void* dx,
                                    int dtype, int n, int h, int wd, int c,
                                    int f4, void* stream_ptr) {
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  if ((dtype != p2p::kBF16 && dtype != p2p::kF32) ||
      (f4 != 4 && f4 != 8 && f4 != 12 && f4 != 16))
    return cudaErrorInvalidValue;
  if (n == 0 || h == 0 || wd == 0 || c == 0) return cudaSuccess;
  if (dtype == p2p::kBF16) {
    switch (f4) {
      case 4: return launch_dx_tc<4>(dz, w, dx, n, h, wd, c, s);
      case 8: return launch_dx_tc<8>(dz, w, dx, n, h, wd, c, s);
      case 12: return launch_dx_tc<12>(dz, w, dx, n, h, wd, c, s);
      default: return launch_dx_tc<16>(dz, w, dx, n, h, wd, c, s);
    }
  }
  switch (f4) {
    case 4: return launch_dx<4>(dz, w, dx, n, h, wd, c, s);
    case 8: return launch_dx<8>(dz, w, dx, n, h, wd, c, s);
    case 12: return launch_dx<12>(dz, w, dx, n, h, wd, c, s);
    default: return launch_dx<16>(dz, w, dx, n, h, wd, c, s);
  }
}

// The dynamic shared memory per block of #6's launch in dtype at row
// width wd and channel count c (the wrapper checks it against the card's
// limit before launching); -1 for a dtype or F4 it does not take.
extern "C" int p2p_subpixel_head_fwd_smem(int dtype, int wd, int c, int f4) {
  if (f4 != 4 && f4 != 8 && f4 != 12 && f4 != 16) return -1;
  if (dtype == p2p::kBF16) return tc_plan(wd, c, f4).smem;
  if (dtype != p2p::kF32) return -1;
  switch (f4) {
    case 4: return sizeof(float) * fwd_smem_floats<4>(c);
    case 8: return sizeof(float) * fwd_smem_floats<8>(c);
    case 12: return sizeof(float) * fwd_smem_floats<12>(c);
    default: return sizeof(float) * fwd_smem_floats<16>(c);
  }
}

// The same for #7's launch (0 in f32: its shared memory is static).
extern "C" int p2p_subpixel_head_dx_smem(int dtype, int wd, int c, int f4) {
  if (f4 != 4 && f4 != 8 && f4 != 12 && f4 != 16) return -1;
  if (dtype == p2p::kBF16) return dx_plan(wd, c, f4).smem;
  return dtype == p2p::kF32 ? 0 : -1;
}
