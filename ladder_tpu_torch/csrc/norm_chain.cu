// Fused instance-norm -> style modulation -> leaky_relu, forward, for Hopper.
//
// Replaces the Pallas TPU kernel ladder_tpu/ops/pallas_kernels.py:_fwd_kernel
// (driven by fused_instnorm_style_lrelu). For every (b, c) plane of a
// contiguous NCHW tensor x:
//
//   mean = sum(x) / HW                     (fp32)
//   var  = sum((x - mean)^2) / HW          (fp32, centred second pass)
//   y    = ((x - mean) * rsqrt(var + eps)) * (scale[b,c] + 1) + shift[b,c]
//   out  = leaky(y, alpha), rounded once to x's dtype
//
// Bound: bytes. Each element is read once and written once from device
// memory; the arithmetic is a handful of flops per element, far below the
// card's rate. Design: one warp per plane, 8 warps per block, warp-shuffle
// reductions. The plane is read three times (sum, centred sum, output);
// a plane is at most 16 KB here, so the second and third reads hit L1/L2
// and device memory sees roughly one read and one write. The decoder's
// 2x2 stages have 4-element planes and leave 28 of 32 lanes idle.
//
// Built with nvcc into a shared library with a plain C interface and
// loaded with ctypes (ladder_tpu_torch/ops/norm_chain.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ float load_f32(const float* p, long long i) {
  return p[i];
}
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store(float* p, long long i, float v) {
  p[i] = v;
}
__device__ __forceinline__ void store(__nv_bfloat16* p, long long i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, offset);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
norm_chain_fwd_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                      const T* __restrict__ shift, T* __restrict__ out,
                      long long planes, int hw, float eps, float alpha) {
  const long long plane =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (plane >= planes) return;  // whole warps exit together
  const long long base = plane * hw;
  const float inv_n = 1.0f / (float)hw;

  float s = 0.0f;
  for (int i = lane; i < hw; i += 32) s += load_f32(x, base + i);
  const float mean = warp_sum(s) * inv_n;

  float q = 0.0f;
  for (int i = lane; i < hw; i += 32) {
    const float d = load_f32(x, base + i) - mean;
    q += d * d;
  }
  const float inv = rsqrtf(warp_sum(q) * inv_n + eps);

  // plane = b * C + c, and scale/shift are contiguous [B, C]
  const float sc = load_f32(scale, plane) + 1.0f;
  const float sh = load_f32(shift, plane);
  for (int i = lane; i < hw; i += 32) {
    const float xhat = (load_f32(x, base + i) - mean) * inv;
    const float y = xhat * sc + sh;
    store(out, base + i, y > 0.0f ? y : alpha * y);
  }
}

template <typename T>
int launch(const void* x, const void* scale, const void* shift, void* out,
           long long planes, int hw, float eps, float alpha,
           cudaStream_t stream) {
  const long long blocks = (planes + kWarpsPerBlock - 1) / kWarpsPerBlock;
  norm_chain_fwd_kernel<T><<<(unsigned)blocks, kWarpsPerBlock * 32, 0,
                             stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(scale),
      static_cast<const T*>(shift), static_cast<T*>(out), planes, hw, eps,
      alpha);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (0 on success); the caller raises on anything else.
extern "C" int norm_chain_fwd(const void* x, const void* scale,
                              const void* shift, void* out, long long planes,
                              int hw, int dtype, float eps, float alpha,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, scale, shift, out, planes, hw, eps, alpha, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, scale, shift, out, planes, hw, eps, alpha,
                                 s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* norm_chain_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
