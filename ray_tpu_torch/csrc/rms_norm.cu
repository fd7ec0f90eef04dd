// RMSNorm forward for Hopper (sm_90a):
//   out = x * rsqrt(mean(x^2) + eps) * w, in f32, written in x's dtype.
//
// Replaces ray_tpu/ops/norms.py:_rms_kernel (driven by rms_norm_pallas),
// which computes the same function over blocks of 512 rows.
//
// What bounds it on the H100: memory bytes. A row is read, reduced and
// written, a handful of operations per byte, far below the
// ~295 bf16 operations per byte at which the card stops waiting on
// memory. So the design only tries to move bytes well: one block per row
// (2048 rows of a prefill fill all 132 SMs many times over), 16-byte
// vector loads and stores with neighbouring threads on neighbouring
// addresses, the row held in registers (one vector a thread) from the
// read to the write so it crosses device memory once each way, and a
// warp-shuffle reduction with one shared-memory hop for the row's sum of
// squares.
//
// Plain C interface, bound from Python with ctypes
// (ray_tpu_torch/ops/norms.py). The launch goes on the caller's stream and
// allocates nothing; the function returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T> struct Vec16;  // 16 bytes of T
template <> struct Vec16<float> { static constexpr int N = 4; };
template <> struct Vec16<__nv_bfloat16> { static constexpr int N = 8; };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__global__ void rms_norm_kernel(const T* __restrict__ x,
                                const T* __restrict__ w,
                                T* __restrict__ out, int64_t d, float eps) {
  constexpr int N = Vec16<T>::N;
  const int64_t row = blockIdx.x;
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * d);
  const uint4* wv = reinterpret_cast<const uint4*>(w);
  uint4* outr = reinterpret_cast<uint4*>(out + row * d);
  const int64_t nvec = d / N;

  // The launch gives every thread at most one vector of a row of up to
  // 1024 vectors, which stays in registers between the two passes;
  // wider rows loop and reread the rest.
  const bool mine = threadIdx.x < nvec;
  const uint4 own = mine ? xr[threadIdx.x] : make_uint4(0, 0, 0, 0);
  float ss = 0.f;
  for (int64_t i = threadIdx.x; i < nvec; i += blockDim.x) {
    const uint4 packed = i == threadIdx.x ? own : xr[i];
    const T* e = reinterpret_cast<const T*>(&packed);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float f = to_f32(e[j]);
      ss += f * f;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);

  __shared__ float warp_sums[32];
  __shared__ float inv_rms;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    const int nwarps = (blockDim.x + 31) >> 5;
    float s = lane < nwarps ? warp_sums[lane] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) inv_rms = rsqrtf(s / static_cast<float>(d) + eps);
  }
  __syncthreads();

  const float r = inv_rms;
  for (int64_t i = threadIdx.x; i < nvec; i += blockDim.x) {
    const uint4 packed = i == threadIdx.x ? own : xr[i];
    const uint4 wpacked = wv[i];
    uint4 o;
    const T* e = reinterpret_cast<const T*>(&packed);
    const T* we = reinterpret_cast<const T*>(&wpacked);
    T* oe = reinterpret_cast<T*>(&o);
#pragma unroll
    for (int j = 0; j < N; ++j)
      oe[j] = from_f32<T>(to_f32(e[j]) * r * to_f32(we[j]));
    outr[i] = o;
  }
}

template <typename T>
int launch(const void* x, const void* w, void* out, int64_t rows, int64_t d,
           float eps, cudaStream_t stream) {
  const int64_t nvec = d / Vec16<T>::N;
  int64_t threads = ((nvec + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  rms_norm_kernel<T><<<static_cast<unsigned>(rows),
                       static_cast<unsigned>(threads), 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<T*>(out), d, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out: [rows, d] contiguous; w: [d]; all 16-byte aligned, d % 8 == 0
// (the Python wrapper checks). dtype: 0 = float32, 1 = bfloat16.
extern "C" int rms_norm_fwd(const void* x, const void* w, void* out,
                            int64_t rows, int64_t d, float eps, int dtype,
                            void* stream) {
  if (rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(x, w, out, rows, d, eps, s);
    case 1: return launch<__nv_bfloat16>(x, w, out, rows, d, eps, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
