// Fused instance-norm -> style modulation -> leaky_relu for Hopper, forward
// and backward.
//
// Forward: replaces the Pallas TPU kernel
// ladder_tpu/ops/pallas_kernels.py:_fwd_kernel (driven by
// fused_instnorm_style_lrelu). For every (b, c) plane of a contiguous NCHW
// tensor x:
//
//   mean = sum(x) / HW                     (fp32)
//   var  = sum((x - mean)^2) / HW          (fp32, centred, over held values)
//   y    = ((x - mean) * rsqrt(var + eps)) * (scale[b,c] + 1) + shift[b,c]
//   out  = leaky(y, alpha), decided on the fp32 y, rounded once to x's dtype
//
// Bound: bytes. Each element must be read once and written once; the
// arithmetic is a handful of flops per element, far below the card's rate.
// The forward reads every plane from device memory exactly once, holds it
// on chip for both passes of the statistics and the output, and moves it
// with 16-byte accesses. norm_chain_fwd picks one of four variants from hw,
// the dtype and the alignment of x and out (norm_chain_fwd_path):
//
//  - one thread per plane (hw == 4: the decoder's 2x2 stages): one 16-byte
//    load (float32) or 8-byte load (bf16) and one store per plane, no
//    shuffle;
//  - a group of 16 threads per plane (hw <= 256: the 16x16 stage), the
//    plane in registers, each thread's 16-byte loads issued before any is
//    used, sums by sub-warp xor shuffles;
//  - a ring (hw >= 1024, planes of up to 16 KB: the 64x64 stage): a
//    persistent grid of a few blocks per SM, each streaming its planes
//    through kRingStages plane buffers in shared memory. One thread fills
//    a buffer with a 1-D bulk asynchronous copy (cp.async.bulk, completion
//    on an mbarrier), so the next planes are in flight while this one is
//    reduced (each thread copies its part into registers, then warp
//    shuffles and one round through shared memory; the buffer is refilled
//    right after the first sum) and written out with 16-byte stores;
//  - the generic path for everything else (hw not a multiple of the
//    16-byte vector, x or out not 16-byte aligned, hw between 257 and 1023,
//    which no model of the repository gives this kernel, a plane larger
//    than a ring buffer): one warp per plane with scalar loads, the plane
//    read three times and re-read from L1/L2.
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

// The generic forward: one warp per plane, scalar loads, the plane read
// three times.
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
int launch_generic(const void* x, const void* scale, const void* shift,
                   void* out, long long planes, int hw, float eps,
                   float alpha, cudaStream_t stream) {
  const long long blocks = (planes + kWarpsPerBlock - 1) / kWarpsPerBlock;
  norm_chain_fwd_kernel<T><<<(unsigned)blocks, kWarpsPerBlock * 32, 0,
                             stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(scale),
      static_cast<const T*>(shift), static_cast<T*>(out), planes, hw, eps,
      alpha);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Vector accesses: E elements of T in one 8- or 16-byte load or store,
// unpacked to float32.

template <typename T, int E>
struct VecOf;
template <>
struct VecOf<float, 4> { using type = float4; };
template <>
struct VecOf<__nv_bfloat16, 4> { using type = uint2; };
template <>
struct VecOf<__nv_bfloat16, 8> { using type = uint4; };

__device__ __forceinline__ void unpack(float4 q, float* v) {
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
// bf16 -> float is exact: the bf16 bits are the float's upper half
__device__ __forceinline__ void unpack_bf16x2(unsigned int w, float* v) {
  v[0] = __uint_as_float(w << 16);
  v[1] = __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ void unpack(uint2 q, float* v) {
  unpack_bf16x2(q.x, v);
  unpack_bf16x2(q.y, v + 2);
}
__device__ __forceinline__ void unpack(uint4 q, float* v) {
  unpack_bf16x2(q.x, v);
  unpack_bf16x2(q.y, v + 2);
  unpack_bf16x2(q.z, v + 4);
  unpack_bf16x2(q.w, v + 6);
}
__device__ __forceinline__ float4 pack(const float* v, float4*) {
  return make_float4(v[0], v[1], v[2], v[3]);
}
// round to nearest even, as __float2bfloat16_rn
__device__ __forceinline__ unsigned int pack_bf16x2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const unsigned int*>(&h);
}
__device__ __forceinline__ uint2 pack(const float* v, uint2*) {
  return make_uint2(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]));
}
__device__ __forceinline__ uint4 pack(const float* v, uint4*) {
  return make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]),
                    pack_bf16x2(v[4], v[5]), pack_bf16x2(v[6], v[7]));
}

template <typename T, int E>
__device__ __forceinline__ void load_vec(const T* p, float* v) {
  using V = typename VecOf<T, E>::type;
  unpack(*reinterpret_cast<const V*>(p), v);
}

// out = leaky(((v - mean) * inv) * sc + sh), E elements, one rounding
template <typename T, int E>
__device__ __forceinline__ void store_chain(T* p, const float* v, float mean,
                                            float inv, float sc, float sh,
                                            float alpha) {
  using V = typename VecOf<T, E>::type;
  float o[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const float xhat = (v[e] - mean) * inv;
    const float y = xhat * sc + sh;
    o[e] = y > 0.0f ? y : alpha * y;
  }
  *reinterpret_cast<V*>(p) = pack(o, static_cast<V*>(nullptr));
}

// Sum over an aligned group of G <= 32 lanes of one warp. Every lane of the
// warp must call it.
template <int G>
__device__ __forceinline__ float lanes_sum(float v) {
#pragma unroll
  for (int offset = G / 2; offset > 0; offset >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, offset);
  return v;
}

// ---------------------------------------------------------------------------
// Small planes in registers: a group of G threads per plane, each holding up
// to K vectors of E elements (vector j of the plane goes to lane j % G).
// hw must be a multiple of E with hw / E <= G * K, and x, out aligned to
// E * sizeof(T).

constexpr int kRegThreads = 128;

template <typename T, int E, int G, int K>
__global__ void __launch_bounds__(kRegThreads)
norm_chain_fwd_regs(const T* __restrict__ x, const T* __restrict__ scale,
                    const T* __restrict__ shift, T* __restrict__ out,
                    long long planes, int hw, float eps, float alpha) {
  constexpr int kPlanesPerBlock = kRegThreads / G;
  const long long plane =
      (long long)blockIdx.x * kPlanesPerBlock + threadIdx.x / G;
  const int lane = threadIdx.x % G;
  // threads past the last plane take part in the shuffles, over nothing
  const int nvec = plane < planes ? hw / E : 0;
  const long long base = plane * hw;

  // plane = b * C + c, and scale/shift are contiguous [B, C]; loaded with
  // the plane, ahead of the sums
  const float sc = nvec ? load_f32(scale, plane) + 1.0f : 0.0f;
  const float sh = nvec ? load_f32(shift, plane) : 0.0f;
  float v[K][E];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = lane + k * G;
    if (j < nvec) {
      load_vec<T, E>(x + base + (long long)j * E, v[k]);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) v[k][e] = 0.0f;
    }
  }
  const float inv_n = 1.0f / (float)hw;
  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int e = 0; e < E; ++e) s += v[k][e];
  const float mean = lanes_sum<G>(s) * inv_n;

  float q = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (lane + k * G < nvec) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float d = v[k][e] - mean;
        q += d * d;
      }
    }
  }
  const float inv = rsqrtf(lanes_sum<G>(q) * inv_n + eps);
  if (nvec == 0) return;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = lane + k * G;
    if (j < nvec)
      store_chain<T, E>(out + base + (long long)j * E, v[k], mean, inv, sc,
                        sh, alpha);
  }
}

template <typename T, int E, int G, int K>
int launch_regs(const void* x, const void* scale, const void* shift,
                void* out, long long planes, int hw, float eps, float alpha,
                cudaStream_t stream) {
  constexpr int kPlanesPerBlock = kRegThreads / G;
  const long long blocks = (planes + kPlanesPerBlock - 1) / kPlanesPerBlock;
  norm_chain_fwd_regs<T, E, G, K><<<(unsigned)blocks, kRegThreads, 0,
                                    stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(scale),
      static_cast<const T*>(shift), static_cast<T*>(out), planes, hw, eps,
      alpha);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Large planes through a ring of shared-memory buffers filled by bulk
// asynchronous copies.

constexpr int kRingThreads = 256;
constexpr int kRingStages = 3;
constexpr int kMaxRingPlaneBytes = 16 * 1024;
// 16-byte vectors of a plane a thread holds
constexpr int kRingVectors = kMaxRingPlaneBytes / 16 / kRingThreads;
// mbarriers and the block-sum scratch, ahead of the plane buffers
constexpr int kRingHeaderBytes = 128;

__device__ __forceinline__ unsigned int smem_addr(const void* p) {
  return static_cast<unsigned int>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar,
                                          unsigned int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// One arrival that also expects `bytes` of asynchronous copies on bar, then
// the copy of `bytes` from global src to shared dst, completing on bar.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned int bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Wait until the phase of bar with the given parity has completed.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned int parity) {
  unsigned int done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// Sum over the block. Every thread must call it; red holds one float per
// warp.
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  __syncthreads();  // the previous round's reads of red are done
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float total = 0.0f;
#pragma unroll
  for (int i = 0; i < kRingThreads / 32; ++i) total += red[i];
  return total;
}

// hw must be a multiple of E = 16 / sizeof(T), hw * sizeof(T) at most
// kMaxRingPlaneBytes, and x, out 16-byte aligned. Each thread copies its
// vectors of the plane from the buffer into registers for the sums and the
// output, so the buffer is refilled as soon as the first sum is taken.
template <typename T>
__global__ void __launch_bounds__(kRingThreads)
norm_chain_fwd_ring(const T* __restrict__ x, const T* __restrict__ scale,
                    const T* __restrict__ shift, T* __restrict__ out,
                    long long planes, int hw, float eps, float alpha) {
  constexpr int E = 16 / sizeof(T);
  constexpr int K = kRingVectors;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned long long* full = reinterpret_cast<unsigned long long*>(smem);
  float* red = reinterpret_cast<float*>(smem + 64);
  unsigned char* ring = smem + kRingHeaderBytes;
  const unsigned int plane_bytes = (unsigned int)hw * sizeof(T);
  const int nvec = hw / E;
  const float inv_n = 1.0f / (float)hw;
  const long long stride = gridDim.x;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kRingStages; ++s) mbar_init(&full[s], 1);
    // make the initialised barriers visible to the asynchronous proxy
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int s = 0; s < kRingStages; ++s) {
      const long long plane = blockIdx.x + s * stride;
      if (plane < planes)
        bulk_load(ring + s * plane_bytes, x + plane * hw, plane_bytes,
                  &full[s]);
    }
  }

  int s = 0;
  unsigned int parity = 0;
  for (long long plane = blockIdx.x; plane < planes; plane += stride) {
    // the plane's scale and shift are in flight while its buffer fills
    const float sc = load_f32(scale, plane) + 1.0f;
    const float sh = load_f32(shift, plane);
    mbar_wait(&full[s], parity);
    const T* buf = reinterpret_cast<const T*>(ring + s * plane_bytes);

    float v[K][E];
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = threadIdx.x + k * kRingThreads;
      if (j < nvec) {
        load_vec<T, E>(buf + j * E, v[k]);
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) v[k][e] = 0.0f;
      }
#pragma unroll
      for (int e = 0; e < E; ++e) acc += v[k][e];
    }
    const float mean = block_sum(acc, red) * inv_n;
    // past block_sum's barrier every thread holds its part of the plane:
    // buffer s takes the plane kRingStages ahead
    if (threadIdx.x == 0) {
      const long long next = plane + kRingStages * stride;
      if (next < planes)
        bulk_load(ring + s * plane_bytes, x + next * hw, plane_bytes,
                  &full[s]);
    }

    float q = 0.0f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (threadIdx.x + k * kRingThreads < nvec) {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float d = v[k][e] - mean;
          q += d * d;
        }
      }
    }
    const float inv = rsqrtf(block_sum(q, red) * inv_n + eps);

    T* dst = out + plane * hw;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = threadIdx.x + k * kRingThreads;
      if (j < nvec)
        store_chain<T, E>(dst + j * E, v[k], mean, inv, sc, sh, alpha);
    }
    if (++s == kRingStages) {
      s = 0;
      parity ^= 1u;
    }
  }
}

template <typename T>
int launch_ring(const void* x, const void* scale, const void* shift,
                void* out, long long planes, int hw, float eps, float alpha,
                cudaStream_t stream) {
  const auto kernel = norm_chain_fwd_ring<T>;
  const int smem = kRingHeaderBytes + kRingStages * hw * (int)sizeof(T);
  // all of the SM's unified L1/shared memory as shared memory, so that the
  // occupancy computed below is the occupancy the launch gets
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  if (err != cudaSuccess) return (int)err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kRingThreads, smem)) != cudaSuccess)
    return (int)err;
  long long blocks = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (blocks > planes) blocks = planes;
  kernel<<<(unsigned)blocks, kRingThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(scale),
      static_cast<const T*>(shift), static_cast<T*>(out), planes, hw, eps,
      alpha);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The forward's variants, as norm_chain_fwd_path reports them.
enum FwdPath { kGeneric = 0, kThreadPerPlane = 1, kGroupOf16 = 2, kRing = 3 };

template <typename T>
FwdPath fwd_path(const void* x, const void* out, int hw) {
  constexpr int E = 16 / sizeof(T);
  const unsigned long long addr =
      reinterpret_cast<unsigned long long>(x) |
      reinterpret_cast<unsigned long long>(out);
  if (hw == 4 && addr % (4 * sizeof(T)) == 0) return kThreadPerPlane;
  if (addr % 16 != 0 || hw % E != 0) return kGeneric;
  if (hw <= 256) return kGroupOf16;
  if (hw >= 1024 && (long long)hw * sizeof(T) <= kMaxRingPlaneBytes)
    return kRing;
  return kGeneric;
}

template <typename T>
int launch(const void* x, const void* scale, const void* shift, void* out,
           long long planes, int hw, float eps, float alpha,
           cudaStream_t stream) {
  // vectors per thread: G * K * E covers the largest hw of the variant
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr int E = 16 / sizeof(T);
  switch (fwd_path<T>(x, out, hw)) {
    case kThreadPerPlane:
      return launch_regs<T, 4, 1, 1>(x, scale, shift, out, planes, hw, eps,
                                     alpha, stream);
    case kGroupOf16:
      return launch_regs<T, E, 16, kF32 ? 4 : 2>(x, scale, shift, out,
                                                 planes, hw, eps, alpha,
                                                 stream);
    case kRing:
      return launch_ring<T>(x, scale, shift, out, planes, hw, eps, alpha,
                            stream);
    default:
      return launch_generic<T>(x, scale, shift, out, planes, hw, eps, alpha,
                               stream);
  }
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

// The variant norm_chain_fwd takes for these arguments (enum FwdPath), or -1
// for an unknown dtype.
extern "C" int norm_chain_fwd_path(const void* x, const void* out, int hw,
                                   int dtype) {
  if (dtype == 0) return fwd_path<float>(x, out, hw);
  if (dtype == 1) return fwd_path<__nv_bfloat16>(x, out, hw);
  return -1;
}

extern "C" const char* norm_chain_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
