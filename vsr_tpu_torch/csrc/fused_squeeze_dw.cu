// Weight and bias gradient of the fused concat + 1x1 conv ("squeeze") for
// NVIDIA Hopper (sm_90a): the dW / db half of the backward of
// fused_squeeze.cu's kernel.
//
// The JAX package computes these two in plain XLA (vsr_tpu/ops/
// fused_squeeze.py, _bwd at :104: dW_i = x_i^T g, db = sum g), outside its
// Pallas kernel; there is no TPU kernel that this file replaces. It exists
// because of what a trace of the training step on an H100 showed: as
// PyTorch calls the two gradients cost about 35 calls per squeeze
// (channel-major copies of g and of every x_i, one cuBLAS product and one
// split-K reduction per input), which is most of the host time of the
// squeeze's backward and 11 % of the step's device time.
//
// What it computes, for NCHW inputs x_0..x_{k-1} and the output gradient g:
//   dW[f, off_i + c] = sum_n sum_p g[n, f, p] * x_i[n, c, p]
//   db[f]            = sum_n sum_p g[n, f, p]
// without a concatenated or transposed copy of anything. Sums are kept in
// f32 whatever the inputs' type.
//
// What bounds it: a GEMM with a tiny output (F x sum C_i, e.g. 64 x 384) and
// a very long summed dimension (n * hw, e.g. 65 536): 2 * F * sum C_i flops
// per pixel against (F + sum C_i) elements read, about 27 flop per byte in
// f32, on the CUDA cores' side of the ridge (67 TFLOP/s / 3.35 TB/s = 20):
// the f32 rate is the bound. The long sum is the problem: one block per
// output tile would leave the card empty.
//
// Design (split K, two passes, deterministic):
// - The summed dimension is cut into units of one image x one chunk of
//   pixels. Block (x, y, z) owns the 64 x 64 output tile (channels tile x of
//   the concatenation, which never straddles two inputs; rows tile z of F)
//   and sums over the units y, y + gridDim.y, ...; it writes its partial tile
//   to partial[y], and the caller adds the partials (one sum over the first
//   axis): no atomics, so two runs give the same bits.
// - A step loads 32 pixels of 64 rows of g and of 64 channels of x_i,
//   coalesced along the pixels, into shared memory transposed (pixel-major),
//   so that a thread reads its 4 rows and its 4 channels as one 16-byte
//   value each; 256 threads hold 4 x 4 outputs each in registers.
// - db rides along: the blocks of channel tile 0 also sum their g tile over
//   the pixels and write it to an extra last column of the partial buffer,
//   so the caller's one sum yields dW and db together.
// - Any F, C_i, hw and n: edges are zero-filled on load and masked on store.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kMaxInputs = 8;
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int kTile = 64;      // rows of g (F) and channels of x per block
constexpr int kStepP = 32;     // pixels per step
constexpr int kStride = kTile + 4;  // floats per shared row: 16-byte aligned

struct Params {
  const void* x[kMaxInputs];
  int channels[kMaxInputs];
  const void* g;
  float* partial;  // (gridDim.y, f_out, k_total + 1)
  int count, hw, f_out, k_total;
  int chunk;             // pixels per unit, a multiple of kStepP
  int chunks_per_image;  // ceil(hw / chunk)
  int units;             // n * chunks_per_image
};

__device__ __forceinline__ float as_float(float v) { return v; }
__device__ __forceinline__ float as_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) concat_dw_kernel(const Params p) {
  __shared__ __align__(16) float g_s[kStepP][kStride];
  __shared__ __align__(16) float x_s[kStepP][kStride];

  // Which input this channel tile lies in, and where.
  int tile = blockIdx.x, part = 0, col0 = 0;
  for (; part < p.count - 1; ++part) {
    const int tiles = (p.channels[part] + kTile - 1) / kTile;
    if (tile < tiles) break;
    tile -= tiles;
    col0 += p.channels[part];
  }
  const int c0 = tile * kTile;
  const int cn = p.channels[part];
  const int f0 = blockIdx.z * kTile;
  const bool sums_bias = blockIdx.x == 0;

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int load_p = threadIdx.x % kStepP;  // this thread's pixel of a step
  const int load_r = threadIdx.x / kStepP;  // and its first row (of 8)
  float acc[4][4] = {};
  float bias = 0.f;

  for (int unit = blockIdx.y; unit < p.units; unit += gridDim.y) {
    const int image = unit / p.chunks_per_image;
    const int p_begin = (unit % p.chunks_per_image) * p.chunk;
    const int p_end = min(p.hw, p_begin + p.chunk);
    const T* g = static_cast<const T*>(p.g) +
                 static_cast<size_t>(image) * p.f_out * p.hw;
    const T* x = static_cast<const T*>(p.x[part]) +
                 static_cast<size_t>(image) * cn * p.hw;
    for (int pb = p_begin; pb < p_end; pb += kStepP) {
      const int pixel = pb + load_p;
      const bool inside = pixel < p_end;
      for (int r = load_r; r < kTile; r += kThreads / kStepP) {
        const int f = f0 + r, c = c0 + r;
        g_s[load_p][r] = inside && f < p.f_out
            ? as_float(g[static_cast<size_t>(f) * p.hw + pixel]) : 0.f;
        x_s[load_p][r] = inside && c < cn
            ? as_float(x[static_cast<size_t>(c) * p.hw + pixel]) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int q = 0; q < kStepP; ++q) {
        const float4 a = *reinterpret_cast<const float4*>(&g_s[q][ty * 4]);
        const float4 b = *reinterpret_cast<const float4*>(&x_s[q][tx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      if (sums_bias && threadIdx.x < kTile) {
#pragma unroll
        for (int q = 0; q < kStepP; ++q) bias += g_s[q][threadIdx.x];
      }
      __syncthreads();
    }
  }

  const int row_len = p.k_total + 1;
  float* out = p.partial + static_cast<size_t>(blockIdx.y) * p.f_out * row_len;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int f = f0 + ty * 4 + i;
    if (f >= p.f_out) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + tx * 4 + j;
      if (c < cn) out[static_cast<size_t>(f) * row_len + col0 + c] = acc[i][j];
    }
  }
  if (sums_bias && threadIdx.x < kTile && f0 + threadIdx.x < p.f_out)
    out[static_cast<size_t>(f0 + threadIdx.x) * row_len + p.k_total] = bias;
}

}  // namespace

// C entry point (bound with ctypes). dtype: 0 = float32, 1 = bfloat16.
// xs[i] is (n, channels[i], hw) contiguous, g is (n, f_out, hw) contiguous,
// all of the one dtype; partial is float32 (splits, f_out, sum channels + 1)
// and is written in full: partial.sum(0)[:, :-1] is dW, [:, -1] is db.
// chunk is the number of pixels of one image that one unit of work sums
// over (a multiple of 32); splits <= n * ceil(hw / chunk). Launches on
// `stream` and returns the first cudaError_t (0 on success); it does not
// synchronise.
extern "C" int vsr_concat_dw(const void* const* xs, const int* channels,
                             int count, const void* g, void* partial, int n,
                             int hw, int f_out, int chunk, int splits,
                             int dtype, void* stream) {
  if (count < 1 || count > kMaxInputs || n < 1 || hw < 1 || f_out < 1 ||
      chunk < kStepP || chunk % kStepP != 0 || splits < 1 || splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  long long k_total = 0, tiles = 0;
  for (int i = 0; i < count; ++i) {
    if (channels[i] < 1) return static_cast<int>(cudaErrorInvalidValue);
    p.x[i] = xs[i];
    p.channels[i] = channels[i];
    k_total += channels[i];
    tiles += (channels[i] + kTile - 1) / kTile;
  }
  const long long chunks_per_image = (hw + chunk - 1) / chunk;
  const long long units = n * chunks_per_image;
  const long long f_tiles = (f_out + kTile - 1) / kTile;
  if (k_total > 2147483646LL || tiles > 2147483647LL || units > 2147483647LL ||
      splits > units || f_tiles > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  p.count = count;
  p.g = g;
  p.partial = static_cast<float*>(partial);
  p.hw = hw;
  p.f_out = f_out;
  p.k_total = static_cast<int>(k_total);
  p.chunk = chunk;
  p.chunks_per_image = static_cast<int>(chunks_per_image);
  p.units = static_cast<int>(units);
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(splits),
                  static_cast<unsigned>(f_tiles));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    concat_dw_kernel<float><<<grid, kThreads, 0, s>>>(p);
  else if (dtype == 1)
    concat_dw_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(p);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
