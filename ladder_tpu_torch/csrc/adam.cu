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
// some seventy tensors from one element to millions; a launch per tensor would
// be bound by launch latency instead. Design: the host passes the tensors'
// addresses and sizes, and the entry point packs them by value into the
// kernel's arguments, up to kMaxTensors per launch, so no table has to be
// copied to the device. blockIdx.y picks the tensor and the blocks along x
// walk it with a grid stride; small tensors leave most of their blocks with
// nothing to do.
//
// adam_nonfinite_flag raises a flag in device memory if any clipped gradient
// element is not finite, for the caller's skip_nonfinite guard. The guard
// sees the gradients after the clip, as it does in ladder_tpu's train step:
// an infinite element clips to +-1 and passes, a NaN raises the flag.
//
// Built with nvcc into a shared library with a plain C interface and loaded
// with ctypes (ladder_tpu_torch/ops/adam.py).

#include <cuda_runtime.h>

namespace {

constexpr int kMaxTensors = 96;  // per launch: 96 * 40 bytes of arguments
constexpr int kThreads = 256;
constexpr int kMaxBlocksX = 128;
constexpr int kElemsPerBlock = 4 * kThreads;

// clip to [-1, 1]; a NaN stays a NaN (fminf and fmaxf would drop it)
__device__ __forceinline__ float clip_unit(float g) {
  return g > 1.0f ? 1.0f : (g < -1.0f ? -1.0f : g);
}

struct TensorTable {
  float* p[kMaxTensors];
  const float* g[kMaxTensors];
  float* m[kMaxTensors];
  float* v[kMaxTensors];
  long long n[kMaxTensors];
};

__global__ void __launch_bounds__(kThreads)
adam_kernel(const __grid_constant__ TensorTable table, float lr_t, float b1,
            float one_minus_b1, float b2, float one_minus_b2, float eps) {
  const int t = blockIdx.y;
  const long long n = table.n[t];
  float* __restrict__ p = table.p[t];
  const float* __restrict__ g = table.g[t];
  float* __restrict__ m = table.m[t];
  float* __restrict__ v = table.v[t];
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride) {
    const float gi = clip_unit(g[i]);
    const float mi = b1 * m[i] + one_minus_b1 * gi;
    const float vi = b2 * v[i] + one_minus_b2 * gi * gi;
    p[i] = p[i] - lr_t * mi / (sqrtf(vi) + eps);
    m[i] = mi;
    v[i] = vi;
  }
}

__global__ void __launch_bounds__(kThreads)
nonfinite_kernel(const __grid_constant__ TensorTable table, int* flag) {
  const int t = blockIdx.y;
  const long long n = table.n[t];
  const float* __restrict__ g = table.g[t];
  const long long stride = (long long)gridDim.x * kThreads;
  bool bad = false;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride)
    bad |= !isfinite(clip_unit(g[i]));
  if (bad) *flag = 1;  // every writer writes the same value
}

// Packs tensors [first, first + count) into a table; returns the blocks
// along x that the largest of them needs.
int pack(TensorTable* table, void* const* p, const void* const* g,
         void* const* m, void* const* v, const long long* n, int first,
         int count) {
  long long largest = 1;
  for (int i = 0; i < count; ++i) {
    const int j = first + i;
    table->p[i] = p ? static_cast<float*>(p[j]) : nullptr;
    table->g[i] = static_cast<const float*>(g[j]);
    table->m[i] = m ? static_cast<float*>(m[j]) : nullptr;
    table->v[i] = v ? static_cast<float*>(v[j]) : nullptr;
    table->n[i] = n[j];
    if (n[j] > largest) largest = n[j];
  }
  const long long blocks = (largest + kElemsPerBlock - 1) / kElemsPerBlock;
  return (int)(blocks < kMaxBlocksX ? blocks : kMaxBlocksX);
}

}  // namespace

// p, g, m, v: host arrays of num_tensors device addresses of contiguous
// float32 tensors; n: their element counts. Updates p, m and v in place.
// Returns cudaGetLastError() after the launches (0 on success).
extern "C" int adam_update(void* const* p, const void* const* g,
                           void* const* m, void* const* v, const long long* n,
                           int num_tensors, float lr_t, float b1,
                           float one_minus_b1, float b2, float one_minus_b2,
                           float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int first = 0; first < num_tensors; first += kMaxTensors) {
    const int count =
        num_tensors - first < kMaxTensors ? num_tensors - first : kMaxTensors;
    TensorTable table;
    const int blocks_x = pack(&table, p, g, m, v, n, first, count);
    adam_kernel<<<dim3(blocks_x, count), kThreads, 0, s>>>(
        table, lr_t, b1, one_minus_b1, b2, one_minus_b2, eps);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// Sets *flag (an int32 in device memory, zeroed here on the same stream) to
// 1 if any element of any g, clipped to [-1, 1], is not finite (a NaN).
extern "C" int adam_nonfinite_flag(const void* const* g, const long long* n,
                                   int num_tensors, void* flag, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(flag, 0, sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  for (int first = 0; first < num_tensors; first += kMaxTensors) {
    const int count =
        num_tensors - first < kMaxTensors ? num_tensors - first : kMaxTensors;
    TensorTable table;
    const int blocks_x =
        pack(&table, nullptr, g, nullptr, nullptr, n, first, count);
    nonfinite_kernel<<<dim3(blocks_x, count), kThreads, 0, s>>>(
        table, static_cast<int*>(flag));
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

extern "C" const char* adam_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
