// Helpers shared by the port's hand-written kernels: 16-byte vector packs,
// float conversion for the two activation types, programmatic dependent
// launch, and the error-string export every library carries for its ctypes
// wrapper.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace p2p {

// dtype codes shared with the Python wrappers (ops/cuda/build.py DTYPE_CODES)
enum DType : int { kF32 = 0, kBF16 = 1 };

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's cast
}

template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> load_pack(const T* p) {
  return *reinterpret_cast<const Pack<T, VEC>*>(p);
}

template <typename T, int VEC>
__device__ __forceinline__ void store_pack(T* p, const Pack<T, VEC>& v) {
  *reinterpret_cast<Pack<T, VEC>*>(p) = v;
}

// Programmatic dependent launch. A kernel launched with launch_dependent
// may start while the launch before it on the stream still runs, once
// every block of that launch has called allow_dependents (or ended); it
// must call grid_dependency_wait, which returns once that launch has ended
// and its stores are visible, before it reads what that launch wrote or
// writes anything. With an ordinary next launch allow_dependents does
// nothing. Under stream capture the pair becomes a programmatic edge of the
// graph.
__device__ __forceinline__ void allow_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

template <typename... Params, typename... Args>
cudaError_t launch_dependent(void (*kernel)(Params...), dim3 grid, dim3 block,
                             cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

}  // namespace p2p

extern "C" const char* p2p_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
