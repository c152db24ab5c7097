// Fused decoder output stage for Hopper: leaky_relu -> 1x1 conv to 3
// channels -> reconstruction sums, forward and backward.
//
// Replaces the Pallas TPU kernels ladder_tpu/ops/pallas_output.py:_fwd_kernel
// and :_bwd_kernel (driven there by fused_output_recon and its custom VJP).
// u is the decoder trunk's output [B,C,H,W] (NCHW, contiguous, float32 or
// bfloat16, "the activation dtype" T); W8 [3,C] and b8 [3] are float32; the
// target and dec are [B,3,H,W] float32.
//
// Forward:
//   x7  = u > 0 ? u : round_T(alpha_T * u)              alpha_T = round_T(0.2)
//   dec = round_T(sum_c round_T(W8[o,c]) * x7[c] + b8[o])   fp32 sum, kept fp32
//   l1  = sum |target - dec|,  l2 = sum (target - dec)^2    over all elements
// Backward, one pass over u (a1, a2 are the gradients of l1, l2):
//   dout  = -a1 * sign(target - dec) - 2 * a2 * (target - dec) (+ ddec)
//   dW8[o,c] = sum_pixels round_T(dout[o]) * x7[c],  db8[o] = sum_pixels dout[o]
//   du[c] = (u > 0 ? 1 : alpha_T) * round_T(sum_o round_T(dout[o]) * round_T(W8[o,c]))
// The roundings to T are the TPU kernel's (operands of the two products in
// the activation dtype, fp32 accumulation); in float32 they do nothing.
//
// Bound: bytes. The forward reads u once (537 MB in float32 at
// [64,128,128,128]) and 25 MB each of target and dec; the backward reads u
// and writes du. The 128-by-3 product is far too thin for tensor cores.
// Design: one thread per kPix pixels of one sample, strided by the block so
// that neighbouring threads read neighbouring addresses of every channel
// plane; the weights sit in shared memory; each pixel's three sums stay in
// registers. Sums across pixels go warp shuffle -> shared memory -> one
// partial per block in device memory -> a second small kernel that adds the
// partials in a fixed order, so the results are the same from run to run
// (no atomics).
//
// Built with nvcc into a shared library with a plain C interface and loaded
// with ctypes (ladder_tpu_torch/ops/output_stage.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kCo = 3;         // output channels of the stage
constexpr int kThreads = 256;  // per block
constexpr int kWarps = kThreads / 32;
constexpr int kPix = 4;        // pixels per thread
constexpr int kPixPerBlock = kThreads * kPix;

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

// round a float32 value to T and back
template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, offset);
  return v;
}

__device__ __forceinline__ float sign_of(float v) {
  return (float)((v > 0.0f) - (v < 0.0f));
}

// grid: (ceil(HW / kPixPerBlock), B). partials: [blocks, 2] (l1, l2).
template <typename T>
__global__ void __launch_bounds__(kThreads)
output_stage_fwd_kernel(const T* __restrict__ u, const float* __restrict__ w8,
                        const float* __restrict__ b8,
                        const float* __restrict__ target,
                        float* __restrict__ dec, float* __restrict__ partials,
                        int channels, int hw, float alpha) {
  extern __shared__ float smem[];  // [kCo * channels] weights, then 2 * kWarps
  float* w_s = smem;
  float* red = smem + kCo * channels;
  for (int i = threadIdx.x; i < kCo * channels; i += kThreads)
    w_s[i] = round_to<T>(w8[i]);
  __syncthreads();

  const float alpha_t = round_to<T>(alpha);
  const long long sample = blockIdx.y;
  const int pix0 = blockIdx.x * kPixPerBlock + threadIdx.x;
  const T* u_b = u + sample * channels * hw;

  float acc[kPix][kCo];
#pragma unroll
  for (int k = 0; k < kPix; ++k)
#pragma unroll
    for (int o = 0; o < kCo; ++o) acc[k][o] = 0.0f;

#pragma unroll 4
  for (int c = 0; c < channels; ++c) {
    const long long plane = (long long)c * hw;
    float x7[kPix];
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
      const int pix = pix0 + k * kThreads;
      const float uu = pix < hw ? load_f32(u_b, plane + pix) : 0.0f;
      x7[k] = uu > 0.0f ? uu : round_to<T>(alpha_t * uu);
    }
#pragma unroll
    for (int o = 0; o < kCo; ++o) {
      const float w = w_s[o * channels + c];
#pragma unroll
      for (int k = 0; k < kPix; ++k) acc[k][o] = fmaf(w, x7[k], acc[k][o]);
    }
  }

  float l1 = 0.0f, l2 = 0.0f;
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const int pix = pix0 + k * kThreads;
    if (pix < hw) {
#pragma unroll
      for (int o = 0; o < kCo; ++o) {
        const long long i = (sample * kCo + o) * hw + pix;
        const float d = round_to<T>(acc[k][o] + b8[o]);
        dec[i] = d;
        const float diff = target[i] - d;
        l1 += fabsf(diff);
        l2 += diff * diff;
      }
    }
  }
  l1 = warp_sum(l1);
  l2 = warp_sum(l2);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    red[warp] = l1;
    red[kWarps + warp] = l2;
  }
  __syncthreads();
  if (threadIdx.x < 2) {
    float total = 0.0f;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) total += red[threadIdx.x * kWarps + i];
    const long long block = (long long)blockIdx.y * gridDim.x + blockIdx.x;
    partials[block * 2 + threadIdx.x] = total;
  }
}

// out[j] = sum over blocks of partials[block, j], in block order. One thread
// per output column; consecutive threads read consecutive addresses.
__global__ void sum_partials_kernel(const float* __restrict__ partials,
                                    float* __restrict__ out, int blocks,
                                    int columns) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= columns) return;
  float total = 0.0f;
  for (int b = 0; b < blocks; ++b) total += partials[(long long)b * columns + j];
  out[j] = total;
}

// l1 and l2 have only two columns: one block adds the partials, each thread
// a strided share in a fixed order, then a tree through shared memory.
__global__ void __launch_bounds__(kThreads)
sum_loss_partials_kernel(const float* __restrict__ partials,
                         float* __restrict__ out, int blocks) {
  __shared__ float red[2 * kWarps];
  float l1 = 0.0f, l2 = 0.0f;
  for (int b = threadIdx.x; b < blocks; b += kThreads) {
    l1 += partials[2 * b];
    l2 += partials[2 * b + 1];
  }
  l1 = warp_sum(l1);
  l2 = warp_sum(l2);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    red[warp] = l1;
    red[kWarps + warp] = l2;
  }
  __syncthreads();
  if (threadIdx.x < 2) {
    float total = 0.0f;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) total += red[threadIdx.x * kWarps + i];
    out[threadIdx.x] = total;
  }
}

// grid as the forward. partials: [blocks, kCo * channels + kCo]: dW8 in
// [o, c] order, then db8. a12: two floats in device memory (a1, a2).
template <typename T, bool kHasDdec>
__global__ void __launch_bounds__(kThreads)
output_stage_bwd_kernel(const T* __restrict__ u, const float* __restrict__ w8,
                        const float* __restrict__ dec,
                        const float* __restrict__ target,
                        const float* __restrict__ a12,
                        const float* __restrict__ ddec, T* __restrict__ du,
                        float* __restrict__ partials, int channels, int hw,
                        float alpha) {
  // [kCo * channels] weights, [kWarps, kCo * channels] per-warp dW8 sums,
  // [kWarps, kCo] per-warp db8 sums
  extern __shared__ float smem[];
  float* w_s = smem;
  float* dw_s = smem + kCo * channels;
  float* db_s = dw_s + kWarps * kCo * channels;
  for (int i = threadIdx.x; i < kCo * channels; i += kThreads)
    w_s[i] = round_to<T>(w8[i]);
  __syncthreads();

  const float alpha_t = round_to<T>(alpha);
  const float a1 = a12[0], a2 = a12[1];
  const long long sample = blockIdx.y;
  const int pix0 = blockIdx.x * kPixPerBlock + threadIdx.x;
  const T* u_b = u + sample * channels * hw;
  T* du_b = du + sample * channels * hw;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  float dout_a[kPix][kCo];  // rounded to T: the operand of both products
  float db[kCo] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const int pix = pix0 + k * kThreads;
#pragma unroll
    for (int o = 0; o < kCo; ++o) {
      float dout = 0.0f;
      if (pix < hw) {
        const long long i = (sample * kCo + o) * hw + pix;
        const float diff = target[i] - dec[i];
        dout = -a1 * sign_of(diff) - 2.0f * a2 * diff;
        if (kHasDdec) dout += ddec[i];
      }
      db[o] += dout;
      dout_a[k][o] = round_to<T>(dout);
    }
  }
#pragma unroll
  for (int o = 0; o < kCo; ++o) {
    const float total = warp_sum(db[o]);
    if (lane == 0) db_s[warp * kCo + o] = total;
  }

#pragma unroll 2
  for (int c = 0; c < channels; ++c) {
    const long long plane = (long long)c * hw;
    float w[kCo], dw[kCo];
#pragma unroll
    for (int o = 0; o < kCo; ++o) {
      w[o] = w_s[o * channels + c];
      dw[o] = 0.0f;
    }
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
      const int pix = pix0 + k * kThreads;
      if (pix < hw) {
        const float uu = load_f32(u_b, plane + pix);
        const float x7 = uu > 0.0f ? uu : round_to<T>(alpha_t * uu);
        float dx7 = 0.0f;
#pragma unroll
        for (int o = 0; o < kCo; ++o) {
          dx7 = fmaf(dout_a[k][o], w[o], dx7);
          dw[o] = fmaf(dout_a[k][o], x7, dw[o]);
        }
        dx7 = round_to<T>(dx7);
        store(du_b, plane + pix, uu > 0.0f ? dx7 : alpha_t * dx7);
      }
    }
#pragma unroll
    for (int o = 0; o < kCo; ++o) {
      const float total = warp_sum(dw[o]);
      if (lane == 0) dw_s[(warp * kCo + o) * channels + c] = total;
    }
  }
  __syncthreads();

  const int columns = kCo * channels + kCo;
  const long long block = (long long)blockIdx.y * gridDim.x + blockIdx.x;
  for (int j = threadIdx.x; j < columns; j += kThreads) {
    float total = 0.0f;
    if (j < kCo * channels) {
#pragma unroll
      for (int wi = 0; wi < kWarps; ++wi)
        total += dw_s[wi * kCo * channels + j];
    } else {
#pragma unroll
      for (int wi = 0; wi < kWarps; ++wi)
        total += db_s[wi * kCo + (j - kCo * channels)];
    }
    partials[block * columns + j] = total;
  }
}

size_t fwd_smem_bytes(int channels) {
  return sizeof(float) * (size_t)(kCo * channels + 2 * kWarps);
}

size_t bwd_smem_bytes(int channels) {
  return sizeof(float) *
         (size_t)(kCo * channels + kWarps * kCo * channels + kWarps * kCo);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T>
int launch_fwd(const void* u, const float* w8, const float* b8,
               const float* target, float* dec, float* partials, float* sums,
               int batch, int channels, int hw, float alpha,
               cudaStream_t stream) {
  const dim3 grid((hw + kPixPerBlock - 1) / kPixPerBlock, batch);
  const size_t smem = fwd_smem_bytes(channels);
  cudaError_t err = allow_smem(output_stage_fwd_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  output_stage_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(u), w8, b8, target, dec, partials, channels, hw,
      alpha);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_loss_partials_kernel<<<1, kThreads, 0, stream>>>(
      partials, sums, (int)(grid.x * grid.y));
  return (int)cudaGetLastError();
}

template <typename T, bool kHasDdec>
int launch_bwd(const void* u, const float* w8, const float* dec,
               const float* target, const float* a12, const float* ddec,
               void* du, float* partials, float* dw_db, int batch,
               int channels, int hw, float alpha, cudaStream_t stream) {
  const dim3 grid((hw + kPixPerBlock - 1) / kPixPerBlock, batch);
  const size_t smem = bwd_smem_bytes(channels);
  cudaError_t err = allow_smem(output_stage_bwd_kernel<T, kHasDdec>, smem);
  if (err != cudaSuccess) return (int)err;
  output_stage_bwd_kernel<T, kHasDdec><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(u), w8, dec, target, a12, ddec,
      static_cast<T*>(du), partials, channels, hw, alpha);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int columns = kCo * channels + kCo;
  sum_partials_kernel<<<(columns + 127) / 128, 128, 0, stream>>>(
      partials, dw_db, (int)(grid.x * grid.y), columns);
  return (int)cudaGetLastError();
}

// Both big kernels run batch * ceil(hw / 1024) blocks (1024 = kPixPerBlock
// pixels of one sample each); the caller allocates partials with that many
// rows, [rows, 2] for the forward and [rows, 3 * channels + 3] for the
// backward, and passes the count, which is checked here.
bool rows_match(int partial_rows, int batch, int hw) {
  return partial_rows == batch * ((hw + kPixPerBlock - 1) / kPixPerBlock);
}

}  // namespace

// dtype of u: 0 = float32, 1 = bfloat16. sums: [2] float32 (l1, l2).
// Returns cudaGetLastError() after the launches (0 on success).
extern "C" int output_stage_fwd(const void* u, const void* w8, const void* b8,
                                const void* target, void* dec, void* partials,
                                int partial_rows, void* sums, int batch,
                                int channels, int hw, int dtype, float alpha,
                                void* stream) {
  if (!rows_match(partial_rows, batch, hw)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* w = static_cast<const float*>(w8);
  const float* b = static_cast<const float*>(b8);
  const float* t = static_cast<const float*>(target);
  float* d = static_cast<float*>(dec);
  float* p = static_cast<float*>(partials);
  float* out = static_cast<float*>(sums);
  if (dtype == 0)
    return launch_fwd<float>(u, w, b, t, d, p, out, batch, channels, hw,
                             alpha, s);
  if (dtype == 1)
    return launch_fwd<__nv_bfloat16>(u, w, b, t, d, p, out, batch, channels,
                                     hw, alpha, s);
  return (int)cudaErrorInvalidValue;
}

// ddec may be null (no gradient arrives for dec). dw_db: [3 * channels + 3]
// float32: dW8 in [o, c] order, then db8.
extern "C" int output_stage_bwd(const void* u, const void* w8, const void* dec,
                                const void* target, const void* a12,
                                const void* ddec, void* du, void* partials,
                                int partial_rows, void* dw_db, int batch,
                                int channels, int hw, int dtype, float alpha,
                                void* stream) {
  if (!rows_match(partial_rows, batch, hw)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* w = static_cast<const float*>(w8);
  const float* d = static_cast<const float*>(dec);
  const float* t = static_cast<const float*>(target);
  const float* a = static_cast<const float*>(a12);
  const float* dd = static_cast<const float*>(ddec);
  float* p = static_cast<float*>(partials);
  float* out = static_cast<float*>(dw_db);
  if (dtype == 0) {
    if (dd)
      return launch_bwd<float, true>(u, w, d, t, a, dd, du, p, out, batch,
                                     channels, hw, alpha, s);
    return launch_bwd<float, false>(u, w, d, t, a, dd, du, p, out, batch,
                                    channels, hw, alpha, s);
  }
  if (dtype == 1) {
    if (dd)
      return launch_bwd<__nv_bfloat16, true>(u, w, d, t, a, dd, du, p, out,
                                             batch, channels, hw, alpha, s);
    return launch_bwd<__nv_bfloat16, false>(u, w, d, t, a, dd, du, p, out,
                                            batch, channels, hw, alpha, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* output_stage_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
