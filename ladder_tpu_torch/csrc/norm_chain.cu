// Fused instance-norm -> style modulation -> leaky_relu for Hopper, forward
// and backward.
//
// Forward: replaces the Pallas TPU kernel
// ladder_tpu/ops/pallas_kernels.py:_fwd_kernel (driven by
// fused_instnorm_style_lrelu). For every (b, c) plane of a contiguous NCHW
// tensor x:
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
// Backward: replaces ladder_tpu/ops/pallas_kernels.py:_bwd_kernel. It keeps
// no residual but x, scale and shift and recomputes the statistics:
//
//   mean, inv, xhat, y as in the forward (fp32)
//   dy     = g * (y > 0 ? 1 : alpha)       (the sign of the unrounded y)
//   dscale = sum(dy * xhat), dshift = sum(dy)           (fp32, per plane)
//   dxhat  = dy * (scale + 1)
//   dx     = (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat)) * inv
//
// Bound: bytes (read g and x, write dx). Three reductions depend on each
// other (mean; variance; the two dy sums) before the writing pass, so a
// plane is read four times; only the first read comes from device memory
// when the plane fits the caches. Design: a group of 4, 32 or 256 threads
// per plane, chosen by the plane's size, so that the decoder's 4-element
// planes do not idle 28 lanes of a warp and its 4096-element planes get a
// whole block; sums go through warp shuffles and, for the block-sized
// group, one round through shared memory.
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

constexpr int kBwdThreads = 256;

// Sum over the kGroup threads that share a plane. kGroup <= 32: the group
// is an aligned part of one warp and xor-shuffles stay inside it. kGroup ==
// kBwdThreads: the whole block, through shared memory. Every thread of the
// block must call this (no early exit before it).
template <int kGroup>
__device__ __forceinline__ float group_sum(float v, float* smem) {
  if constexpr (kGroup <= 32) {
#pragma unroll
    for (int offset = kGroup / 2; offset > 0; offset >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, offset);
    return v;
  } else {
    v = warp_sum(v);
    const int warp = threadIdx.x >> 5;
    __syncthreads();  // the previous round's reads are done
    if ((threadIdx.x & 31) == 0) smem[warp] = v;
    __syncthreads();
    float total = 0.0f;
#pragma unroll
    for (int i = 0; i < kBwdThreads / 32; ++i) total += smem[i];
    return total;
  }
}

template <typename T, int kGroup>
__global__ void __launch_bounds__(kBwdThreads)
norm_chain_bwd_kernel(const T* __restrict__ g, const T* __restrict__ x,
                      const T* __restrict__ scale, const T* __restrict__ shift,
                      T* __restrict__ dx, float* __restrict__ dscale,
                      float* __restrict__ dshift, long long planes, int hw,
                      float eps, float alpha) {
  __shared__ float smem[kBwdThreads / 32];
  constexpr int kPlanesPerBlock = kBwdThreads / kGroup;
  const long long plane =
      (long long)blockIdx.x * kPlanesPerBlock + threadIdx.x / kGroup;
  const int lane = threadIdx.x % kGroup;
  // threads past the last plane keep taking part in the sums, over nothing
  const int n = plane < planes ? hw : 0;
  const long long base = plane * hw;
  const float inv_n = 1.0f / (float)hw;

  float s = 0.0f;
  for (int i = lane; i < n; i += kGroup) s += load_f32(x, base + i);
  const float mean = group_sum<kGroup>(s, smem) * inv_n;

  float q = 0.0f;
  for (int i = lane; i < n; i += kGroup) {
    const float d = load_f32(x, base + i) - mean;
    q += d * d;
  }
  const float inv = rsqrtf(group_sum<kGroup>(q, smem) * inv_n + eps);

  const float sc = n ? load_f32(scale, plane) + 1.0f : 0.0f;
  const float sh = n ? load_f32(shift, plane) : 0.0f;
  float sum_dy = 0.0f, sum_dy_xhat = 0.0f;
  for (int i = lane; i < n; i += kGroup) {
    const float xhat = (load_f32(x, base + i) - mean) * inv;
    const float y = xhat * sc + sh;
    const float dy = load_f32(g, base + i) * (y > 0.0f ? 1.0f : alpha);
    sum_dy += dy;
    sum_dy_xhat += dy * xhat;
  }
  sum_dy = group_sum<kGroup>(sum_dy, smem);
  sum_dy_xhat = group_sum<kGroup>(sum_dy_xhat, smem);
  if (n && lane == 0) {
    dscale[plane] = sum_dy_xhat;
    dshift[plane] = sum_dy;
  }

  const float m1 = sc * sum_dy * inv_n;       // mean(dxhat)
  const float m2 = sc * sum_dy_xhat * inv_n;  // mean(dxhat * xhat)
  for (int i = lane; i < n; i += kGroup) {
    const float xhat = (load_f32(x, base + i) - mean) * inv;
    const float y = xhat * sc + sh;
    const float dy = load_f32(g, base + i) * (y > 0.0f ? 1.0f : alpha);
    store(dx, base + i, (dy * sc - m1 - xhat * m2) * inv);
  }
}

template <typename T, int kGroup>
int launch_bwd_group(const void* g, const void* x, const void* scale,
                     const void* shift, void* dx, float* dscale, float* dshift,
                     long long planes, int hw, float eps, float alpha,
                     cudaStream_t stream) {
  constexpr int kPlanesPerBlock = kBwdThreads / kGroup;
  const long long blocks = (planes + kPlanesPerBlock - 1) / kPlanesPerBlock;
  norm_chain_bwd_kernel<T, kGroup><<<(unsigned)blocks, kBwdThreads, 0,
                                     stream>>>(
      static_cast<const T*>(g), static_cast<const T*>(x),
      static_cast<const T*>(scale), static_cast<const T*>(shift),
      static_cast<T*>(dx), dscale, dshift, planes, hw, eps, alpha);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* g, const void* x, const void* scale,
               const void* shift, void* dx, float* dscale, float* dshift,
               long long planes, int hw, float eps, float alpha,
               cudaStream_t stream) {
  if (hw <= 16)
    return launch_bwd_group<T, 4>(g, x, scale, shift, dx, dscale, dshift,
                                  planes, hw, eps, alpha, stream);
  if (hw <= 1024)
    return launch_bwd_group<T, 32>(g, x, scale, shift, dx, dscale, dshift,
                                   planes, hw, eps, alpha, stream);
  return launch_bwd_group<T, kBwdThreads>(g, x, scale, shift, dx, dscale,
                                          dshift, planes, hw, eps, alpha,
                                          stream);
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

// g, x, dx in x's dtype; scale, shift in x's dtype; dscale, dshift float32
// [planes]. Returns cudaGetLastError() after the launch.
extern "C" int norm_chain_bwd(const void* g, const void* x, const void* scale,
                              const void* shift, void* dx, void* dscale,
                              void* dshift, long long planes, int hw,
                              int dtype, float eps, float alpha,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* ds = static_cast<float*>(dscale);
  float* dh = static_cast<float*>(dshift);
  if (dtype == 0)
    return launch_bwd<float>(g, x, scale, shift, dx, ds, dh, planes, hw, eps,
                             alpha, s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(g, x, scale, shift, dx, ds, dh, planes,
                                     hw, eps, alpha, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* norm_chain_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
