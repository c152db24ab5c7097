// Clipped TF1-style Adam for Hopper: one launch over all tensors of an
// optimiser group, in place.
//
// Replaces the Pallas TPU kernel ladder_tpu/ops/pallas_adam.py:_adam_kernel
// (driven there by adam_update_fused, one pallas_call per parameter leaf).
// Per element, in float32 and in this order of operations:
//
//   g = clip(g, -1, 1)
//   m = b1 * m + (1 - b1) * g
//   v = b2 * v + (1 - b2) * g * g
//   p = p - lr_t * m / (sqrt(v) + eps)
//
// lr_t = lr * sqrt(1 - b2^t) / (1 - b1^t) comes from the host (TF1 folds the
// bias correction into the step size and adds eps to the uncorrected
// sqrt(v)), and so do 1 - b1 and 1 - b2, taken in double and rounded once.
//
// Bound: bytes, 28 per element (read g, p, m, v; write p, m, v). A group has
// some seventy tensors from one element to millions. Design: the host
// builds a plan once per group (ops/adam.py:adam_plan) and keeps it in
// device memory: the tensors' p, m and v addresses and sizes, and a list of
// chunks (tensor, start, length) that never cross a tensor, each
// ADAM_CHUNK = 2048 elements long but a tensor's last. The grid has one
// block a chunk (measured faster on an H100 than a persistent grid of a few
// blocks per SM walking the chunks: PERF.md). Only the gradients' addresses
// change from step to step; they travel by value in the kernel's arguments,
// up to kMaxTensors per launch, so a call copies nothing to the device. Each
// thread issues the 16-byte loads of g, p, m and v for both of its vectors
// of a chunk before it uses any of them; a tensor's last elements (fewer
// than 4) and a tensor whose arrays do not all start 16-byte aligned take
// scalar accesses.
//
// adam_nonfinite_flag raises a flag in device memory if any clipped gradient
// element is not finite, for the caller's skip_nonfinite guard, walking the
// same plan. The guard sees the gradients after the clip, as it does in
// ladder_tpu's train step: an infinite element clips to +-1 and passes, a
// NaN raises the flag.
//
// Built with nvcc into a shared library with a plain C interface and loaded
// with ctypes (ladder_tpu_torch/ops/adam.py).

#include <cuda_runtime.h>

namespace {

// a grid's blocks at most: one a chunk
constexpr long long kMaxChunks = 0x7fffffffLL;
// gradient addresses per launch, by value: 2 KB of kernel arguments
// (ops/adam.py:ADAM_MAX_TENSORS)
constexpr int kMaxTensors = 256;
// a chunk of ops/adam.py:ADAM_CHUNK = 2048 elements is two float4 a thread
constexpr int kThreads = 256;

// clip to [-1, 1]; a NaN stays a NaN (fminf and fmaxf would drop it)
__device__ __forceinline__ float clip_unit(float g) {
  return g > 1.0f ? 1.0f : (g < -1.0f ? -1.0f : g);
}

struct GradTable {
  const float* g[kMaxTensors];
};

// The plan in device memory, int64 words (ops/adam.py:AdamPlan): per tensor
// {p, m, v, n}; per chunk {start, tensor | length << 32}.
struct TensorRecord {
  float* p;
  float* m;
  float* v;
  long long n;
};
struct ChunkRecord {
  long long start;
  int tensor;
  int length;
};

struct Hyper {
  float lr_t, b1, one_minus_b1, b2, one_minus_b2, eps;
};

__device__ __forceinline__ void adam_one(float& p, float& m, float& v,
                                         float g, const Hyper& h) {
  const float gi = clip_unit(g);
  m = h.b1 * m + h.one_minus_b1 * gi;
  v = h.b2 * v + h.one_minus_b2 * gi * gi;
  p = p - h.lr_t * m / (sqrtf(v) + h.eps);
}

__device__ __forceinline__ void adam_four(float4& p, float4& m, float4& v,
                                          const float4& g, const Hyper& h) {
  adam_one(p.x, m.x, v.x, g.x, h);
  adam_one(p.y, m.y, v.y, g.y, h);
  adam_one(p.z, m.z, v.z, g.z, h);
  adam_one(p.w, m.w, v.w, g.w, h);
}

__device__ __forceinline__ bool aligned16(const void* a, const void* b,
                                          const void* c, const void* d) {
  return ((reinterpret_cast<unsigned long long>(a) |
           reinterpret_cast<unsigned long long>(b) |
           reinterpret_cast<unsigned long long>(c) |
           reinterpret_cast<unsigned long long>(d)) &
          15) == 0;
}

__global__ void __launch_bounds__(kThreads)
adam_kernel(const __grid_constant__ GradTable grads,
            const TensorRecord* __restrict__ tensors,
            const ChunkRecord* __restrict__ chunks, Hyper h) {
  const ChunkRecord ch = chunks[blockIdx.x];
  const TensorRecord t = tensors[ch.tensor];
  float* __restrict__ p = t.p + ch.start;
  float* __restrict__ m = t.m + ch.start;
  float* __restrict__ v = t.v + ch.start;
  const float* __restrict__ g = grads.g[ch.tensor] + ch.start;
  int scalar_from = 0;
  if (aligned16(p, m, v, g)) {
    const int nvec = ch.length / 4;
    float4* p4 = reinterpret_cast<float4*>(p);
    float4* m4 = reinterpret_cast<float4*>(m);
    float4* v4 = reinterpret_cast<float4*>(v);
    const float4* g4 = reinterpret_cast<const float4*>(g);
    for (int j = threadIdx.x; j < nvec; j += 2 * kThreads) {
      const int k = j + kThreads;
      const bool second = k < nvec;
      // every load of both vectors before any arithmetic
      float4 ga = __ldg(g4 + j), pa = p4[j], ma = m4[j], va = v4[j];
      float4 gb, pb, mb, vb;
      if (second) {
        gb = __ldg(g4 + k);
        pb = p4[k];
        mb = m4[k];
        vb = v4[k];
      }
      adam_four(pa, ma, va, ga, h);
      p4[j] = pa;
      m4[j] = ma;
      v4[j] = va;
      if (second) {
        adam_four(pb, mb, vb, gb, h);
        p4[k] = pb;
        m4[k] = mb;
        v4[k] = vb;
      }
    }
    scalar_from = nvec * 4;
  }
  for (int i = scalar_from + threadIdx.x; i < ch.length; i += kThreads) {
    float pi = p[i], mi = m[i], vi = v[i];
    adam_one(pi, mi, vi, g[i], h);
    p[i] = pi;
    m[i] = mi;
    v[i] = vi;
  }
}

__global__ void __launch_bounds__(kThreads)
nonfinite_kernel(const __grid_constant__ GradTable grads,
                 const ChunkRecord* __restrict__ chunks, int* flag) {
  const ChunkRecord ch = chunks[blockIdx.x];
  const float* __restrict__ g = grads.g[ch.tensor] + ch.start;
  bool bad = false;
  int scalar_from = 0;
  if ((reinterpret_cast<unsigned long long>(g) & 15) == 0) {
    const int nvec = ch.length / 4;
    const float4* g4 = reinterpret_cast<const float4*>(g);
    for (int j = threadIdx.x; j < nvec; j += kThreads) {
      const float4 q = __ldg(g4 + j);
      bad |= !isfinite(clip_unit(q.x)) || !isfinite(clip_unit(q.y)) ||
             !isfinite(clip_unit(q.z)) || !isfinite(clip_unit(q.w));
    }
    scalar_from = nvec * 4;
  }
  for (int i = scalar_from + threadIdx.x; i < ch.length; i += kThreads)
    bad |= !isfinite(clip_unit(g[i]));
  if (bad) *flag = 1;  // every writer writes the same value
}

GradTable pack(const void* const* g, int num_tensors) {
  GradTable table;
  for (int i = 0; i < num_tensors; ++i)
    table.g[i] = static_cast<const float*>(g[i]);
  return table;
}

}  // namespace

// One launch of a group's plan. g: host array of num_tensors (at most
// kMaxTensors) device addresses of contiguous float32 gradients, in the
// plan's order; tensors, chunks: the launch's part of the plan in device
// memory (TensorRecord, ChunkRecord), num_chunks of them, one block each.
// Updates p, m and v in place. Returns cudaGetLastError() after the launch
// (0 on success).
extern "C" int adam_update(const void* const* g, int num_tensors,
                           const void* tensors, const void* chunks,
                           long long num_chunks, float lr_t, float b1,
                           float one_minus_b1, float b2, float one_minus_b2,
                           float eps, void* stream) {
  if (num_tensors < 1 || num_tensors > kMaxTensors || num_chunks < 1 ||
      num_chunks > kMaxChunks)
    return (int)cudaErrorInvalidValue;
  const Hyper h{lr_t, b1, one_minus_b1, b2, one_minus_b2, eps};
  adam_kernel<<<(unsigned)num_chunks, kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      pack(g, num_tensors), static_cast<const TensorRecord*>(tensors),
      static_cast<const ChunkRecord*>(chunks), h);
  return (int)cudaGetLastError();
}

// Sets *flag (an int32 in device memory) to 1 if any element of any g,
// clipped to [-1, 1], is not finite (a NaN), walking one launch's part of
// the plan; with reset, zeroes the flag first on the same stream.
extern "C" int adam_nonfinite_flag(const void* const* g, int num_tensors,
                                   const void* chunks, long long num_chunks,
                                   void* flag, int reset, void* stream) {
  if (num_tensors < 1 || num_tensors > kMaxTensors || num_chunks < 1 ||
      num_chunks > kMaxChunks)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (reset) {
    const cudaError_t err = cudaMemsetAsync(flag, 0, sizeof(int), s);
    if (err != cudaSuccess) return (int)err;
  }
  nonfinite_kernel<<<(unsigned)num_chunks, kThreads, 0, s>>>(
      pack(g, num_tensors), static_cast<const ChunkRecord*>(chunks),
      static_cast<int*>(flag));
  return (int)cudaGetLastError();
}

extern "C" const char* adam_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
