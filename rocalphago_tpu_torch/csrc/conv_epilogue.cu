// The epilogue of a trunk convolution: its bias and ReLU, in place over
// the convolution's output, and their backward in one pass with the
// bias gradient.
//
// Replaces no TPU kernel: on the TPU, XLA folds the bias add and the
// ReLU into the convolution and their gradients into its backward, so
// the JAX package has no kernel for them. The port leaves the
// convolutions to cuDNN, which takes no bias on PyTorch's path: the bias
// add, the ReLU, the ReLU's gradient and the bias gradient's sum each
// ran as a separate at::native pass over the activation, four passes
// and 27 GB a step of the SL benchmark cell (12 convolutions of
// 2,048 x 192 x 19 x 19 bfloat16, 284 MB an activation).
//
// What bounds it on an H100: bytes. Forward, read z and write y: 568 MB
// a layer at that shape, 0.17 ms at 3.35 TB/s. Backward, read gy and y
// and write gz: 852 MB a layer, 0.25 ms. What the design does about it:
//
// - One pass each way. The forward rewrites the convolution's output in
//   place; the backward writes gz once and sums the bias gradient from
//   the values it has in registers, so the gradient costs no second
//   read of gz.
// - The layout the trunk's activations have on the card, channels_last
//   (cuDNN's output for the NHWC planes the nets take): rows of C
//   values, one a point of a position. Contiguous NCHW is refused by the
//   wrapper; no caller reaches it.
// - 16-byte loads and stores (8 bfloat16 or 4 float32 values a thread)
//   where the channel count is a multiple of the vector and the pointers
//   are 16-byte aligned; one value a thread otherwise.
// - The channels of a value never come from a division per value: a
//   block is a whole number of rows wide, so each thread keeps the same
//   channels in every row it visits.
// - The bias gradient is deterministic, with no atomics: each thread
//   sums its channels in float32 in a fixed order, the block combines
//   its threads' sums through shared memory in a fixed order into one
//   row of partials [blocks, C], and a second launch sums the rows in a
//   fixed order. The grid is a function of the shape alone, so the same
//   shape gives the same bits on every run (the SL trainer's bitwise
//   resume depends on it).
//
// Rounding is PyTorch's: the bias (float32, which holds every working
// type's bias exactly) is rounded to the working type, the
// sum z + b taken in float32 and rounded once, the ReLU is clamp_min's
// (NaN kept, fmaxf otherwise) and its gradient threshold_backward's
// (y <= 0 gives 0), so y and gz are bit for bit those of
// relu(z + b.to(dtype)) and its autograd. The bias gradient is summed
// and returned in float32 (PyTorch's reduction rounds it to the working
// type first).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;      // a block's target width
constexpr int kMaxThreads = 1024;  // a block's widest (channels innermost)
constexpr int kMaxBlocks = 4096;   // grid cap
constexpr int kSumChannels = 8;    // channels of a finishing block
constexpr int kSumLanes = 128;     // row lanes of a finishing block

enum DType { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

// The bias of channel c as the working type holds it, widened.
template <typename T>
__device__ __forceinline__ float bias_at(const float* bias, int c) {
  return to_f(from_f<T>(bias[c]));
}

// max(z + b, 0): the sum rounded to T, then clamp_min's rule.
template <typename T>
__device__ __forceinline__ T bias_relu(T z, float b) {
  const T r = from_f<T>(to_f(z) + b);
  const float s = to_f(r);
  return isnan(s) ? r : from_f<T>(fmaxf(s, 0.0f));
}

// threshold_backward(gy, y, 0)
template <typename T>
__device__ __forceinline__ T relu_grad(T gy, T y) {
  return to_f(y) <= 0.0f ? from_f<T>(0.0f) : gy;
}

// ------------------------------------------------------------- the pass
//
// The tensor is rows of C values (a row is one point of one position).
// A block of nt threads covers nt * V values, a whole number of rows, at
// a time ("a tile"); thread t holds channels (t * V) % C .. + V - 1 of
// every tile. Block b takes tiles b, b + G, b + 2G, ..., two at a time
// so that two loads are in flight.

template <typename T, int V>
__global__ void __launch_bounds__(kMaxThreads)
forward_rows(T* __restrict__ z, const float* __restrict__ bias, long long nvec,
             int channels, long long tiles) {
  using P = Pack<T, V>;
  const int t = threadIdx.x;
  const long long nt = blockDim.x;
  const int c0 = (t * V) % channels;
  float b[V];
#pragma unroll
  for (int k = 0; k < V; ++k) b[k] = bias_at<T>(bias, c0 + k);
  P* zp = reinterpret_cast<P*>(z);
  for (long long j = blockIdx.x; j < tiles; j += 2LL * gridDim.x) {
    const long long v0 = j * nt + t;
    const long long v1 = (j + gridDim.x) * nt + t;
    P p0, p1;
    if (v0 < nvec) p0 = zp[v0];
    if (v1 < nvec) p1 = zp[v1];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      p0.v[k] = bias_relu(p0.v[k], b[k]);
      p1.v[k] = bias_relu(p1.v[k], b[k]);
    }
    if (v0 < nvec) zp[v0] = p0;
    if (v1 < nvec) zp[v1] = p1;
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kMaxThreads)
backward_rows(const T* __restrict__ gy, const T* __restrict__ y,
              T* __restrict__ gz, float* __restrict__ partials,
              long long nvec, int channels, long long tiles) {
  using P = Pack<T, V>;
  extern __shared__ float tile_sums[];  // [nt * V]: one tile's values
  const int t = threadIdx.x;
  const long long nt = blockDim.x;
  const P* gyp = reinterpret_cast<const P*>(gy);
  const P* yp = reinterpret_cast<const P*>(y);
  P* gzp = reinterpret_cast<P*>(gz);
  float acc[V];
#pragma unroll
  for (int k = 0; k < V; ++k) acc[k] = 0.0f;
  for (long long j = blockIdx.x; j < tiles; j += 2LL * gridDim.x) {
    const long long v0 = j * nt + t;
    const long long v1 = (j + gridDim.x) * nt + t;
    const bool in0 = v0 < nvec, in1 = v1 < nvec;
    P g0, y0, g1, y1;
    if (in0) { g0 = gyp[v0]; y0 = yp[v0]; }
    if (in1) { g1 = gyp[v1]; y1 = yp[v1]; }
    if (in0) {
#pragma unroll
      for (int k = 0; k < V; ++k) {
        g0.v[k] = relu_grad(g0.v[k], y0.v[k]);
        acc[k] += to_f(g0.v[k]);
      }
      gzp[v0] = g0;
    }
    if (in1) {
#pragma unroll
      for (int k = 0; k < V; ++k) {
        g1.v[k] = relu_grad(g1.v[k], y1.v[k]);
        acc[k] += to_f(g1.v[k]);
      }
      gzp[v1] = g1;
    }
  }
#pragma unroll
  for (int k = 0; k < V; ++k) tile_sums[t * V + k] = acc[k];
  __syncthreads();
  const int rows = static_cast<int>(nt) * V / channels;
  for (int c = t; c < channels; c += static_cast<int>(nt)) {
    float s = 0.0f;
    for (int r = 0; r < rows; ++r) s += tile_sums[r * channels + c];
    partials[static_cast<long long>(blockIdx.x) * channels + c] = s;
  }
}

// ----------------------------------------------------- the second sum
//
// A block takes kSumChannels channels: lane ty of channel cx sums rows
// ty, ty + kSumLanes, ... of the partials, then the block halves its
// lanes' sums in a fixed tree. Many blocks, few rows a thread: the
// partials were just written and are read from L2.

__global__ void __launch_bounds__(kSumChannels * kSumLanes)
sum_partials(const float* __restrict__ partials, int rows, int channels,
             float* __restrict__ grad_bias) {
  __shared__ float sums[kSumLanes][kSumChannels];
  const int cx = threadIdx.x % kSumChannels, ty = threadIdx.x / kSumChannels;
  const int c = blockIdx.x * kSumChannels + cx;
  float s = 0.0f;
  if (c < channels) {
#pragma unroll 4
    for (int r = ty; r < rows; r += kSumLanes)
      s += partials[static_cast<long long>(r) * channels + c];
  }
  sums[ty][cx] = s;
  __syncthreads();
  for (int half = kSumLanes / 2; half > 0; half >>= 1) {
    if (ty < half) sums[ty][cx] += sums[ty + half][cx];
    __syncthreads();
  }
  if (ty == 0 && c < channels) grad_bias[c] = sums[0][cx];
}

// ------------------------------------------------------------ launches

// How a channels-innermost launch covers the tensor.
struct RowPlan {
  int threads;      // nt, a whole number of rows of vectors
  long long nvec;   // vectors in the tensor
  long long tiles;  // tiles of nt vectors
  int blocks;       // G
};

bool row_plan(long long n, int channels, int vec, RowPlan* plan) {
  const int per_row = channels / vec;
  if (per_row > kMaxThreads) return false;
  const int rows = per_row >= kThreads ? 1 : kThreads / per_row;
  plan->threads = per_row * rows;
  plan->nvec = n / vec;
  plan->tiles = (plan->nvec + plan->threads - 1) / plan->threads;
  plan->blocks = static_cast<int>(
      plan->tiles < kMaxBlocks ? plan->tiles : kMaxBlocks);
  return true;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename T>
int forward(void* z, const float* bias, long long rows, int channels,
            cudaStream_t st) {
  T* zt = static_cast<T*>(z);
  constexpr int kV = 16 / sizeof(T);
  const bool vec = channels % kV == 0 && aligned16(z);
  RowPlan plan;
  if (!row_plan(rows * channels, channels, vec ? kV : 1, &plan))
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec)
    forward_rows<T, kV><<<plan.blocks, plan.threads, 0, st>>>(
        zt, bias, plan.nvec, channels, plan.tiles);
  else
    forward_rows<T, 1><<<plan.blocks, plan.threads, 0, st>>>(
        zt, bias, plan.nvec, channels, plan.tiles);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int backward(const void* gy, const void* y, void* gz, void* partials,
             int partial_rows, void* grad_bias, long long rows, int channels,
             cudaStream_t st) {
  const T* gyt = static_cast<const T*>(gy);
  const T* yt = static_cast<const T*>(y);
  T* gzt = static_cast<T*>(gz);
  float* part = static_cast<float*>(partials);
  constexpr int kV = 16 / sizeof(T);
  const bool vec = channels % kV == 0 && aligned16(gy) && aligned16(y) &&
                   aligned16(gz);
  RowPlan plan;
  if (!row_plan(rows * channels, channels, vec ? kV : 1, &plan) ||
      plan.blocks > partial_rows)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * plan.threads * (vec ? kV : 1);
  if (vec)
    backward_rows<T, kV><<<plan.blocks, plan.threads, smem, st>>>(
        gyt, yt, gzt, part, plan.nvec, channels, plan.tiles);
  else
    backward_rows<T, 1><<<plan.blocks, plan.threads, smem, st>>>(
        gyt, yt, gzt, part, plan.nvec, channels, plan.tiles);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_partials<<<(channels + kSumChannels - 1) / kSumChannels,
                 kSumChannels * kSumLanes, 0, st>>>(
      part, plan.blocks, channels, static_cast<float*>(grad_bias));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The most partial rows a backward launch writes.
extern "C" int rocalphago_conv_epilogue_partial_rows() { return kMaxBlocks; }

// z: rows x channels values of the working type (dtype 0 float32, 1
// bfloat16), channels innermost (a channels_last [N, C, H, W] tensor has
// N * H * W rows); bias: float32 [channels]. z <- max(z + bias, 0) in
// place. Returns the CUDA error of the launch.
extern "C" int rocalphago_bias_relu(void* z, const float* bias, int dtype,
                                    long long rows, int channels,
                                    void* stream) {
  if (rows <= 0 || channels <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return forward<float>(z, bias, rows, channels, st);
  if (dtype == kBFloat16)
    return forward<__nv_bfloat16>(z, bias, rows, channels, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// gy, y, gz: rows x channels of the working type, channels innermost;
// partials: float32 scratch of partial_rows x channels; grad_bias:
// float32 [channels]. gz <- gy where y > 0, else 0; grad_bias <- the sum
// of gz over the rows, in float32. Two launches. Returns the CUDA error
// of the launches.
extern "C" int rocalphago_bias_relu_backward(
    const void* gy, const void* y, void* gz, void* partials,
    int partial_rows, void* grad_bias, int dtype, long long rows,
    int channels, void* stream) {
  if (rows <= 0 || channels <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return backward<float>(gy, y, gz, partials, partial_rows, grad_bias,
                           rows, channels, st);
  if (dtype == kBFloat16)
    return backward<__nv_bfloat16>(gy, y, gz, partials, partial_rows,
                                   grad_bias, rows, channels, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
