// Fused concat + 1x1 conv ("squeeze") for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel K1 of the JAX package:
// vsr_tpu/ops/fused_squeeze.py, concat_matmul -> _concat_matmul_fwd_impl
// (pl.pallas_call at :81, kernel body _kernel at :40).
//
// What it computes, per image n and pixel p of NCHW inputs x_0..x_{k-1}:
//   out[n, f, p] = b[f] + sum_i sum_{c < C_i} W[f, off_i + c] * x_i[n, c, p]
// i.e. concat(xs, channel) followed by a 1x1 conv, without ever writing the
// concat to device memory. W is (F, sum C_i) row-major, b is (F,).
//
// What bounds it: at the DRFNet ladder shapes (k <= 6 inputs of 64
// channels, F = 64) a pixel costs 2*384*64 FLOP against 2*(384+64) bytes in
// bf16, about 55 FLOP/B, below the H100's ~295 FLOP/B ridge: the kernel is
// bandwidth-bound, so the win over the plain version is the concat's write
// and re-read that it never does.
//
// Design (the simple, correct first version): one block computes a tile of
// 64 output channels x 256 pixels of one image. Its K loop walks the inputs
// in order and switches the source pointer at each C_i boundary; each step
// stages 16 input channels x 256 pixels and the matching 64 x 16 weight
// slice in shared memory (as f32) and accumulates in f32 registers, 8x8
// outputs per thread: 8 channels x two runs of 4 adjacent pixels, each read
// from shared memory as one 16-byte load. The bias is added in the epilogue
// and the result is rounded once to the input type. The input pointers and
// channel counts (at most 8) travel by value in a struct. CUDA cores only:
// tensor cores (wgmma), TMA and a fused PReLU epilogue are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kMaxInputs = 8;
constexpr int kBlockF = 64;    // output channels per block
constexpr int kBlockP = 256;   // pixels per block
constexpr int kBlockK = 16;    // input channels staged per K step
constexpr int kThreads = 256;  // 8 warps
constexpr int kThreadF = 8;    // output channels per thread (one group per warp)
constexpr int kThreadP = 8;    // pixels per thread: lane*4 + {0..3}, +128

static_assert(kThreads == kBlockP, "one staged pixel per thread per row");
static_assert((kThreads / 32) * kThreadF == kBlockF, "warps cover the F tile");
static_assert(32 * kThreadP == kBlockP, "lanes cover the P tile");

struct Inputs {
  const void* ptr[kMaxInputs];
  int channels[kMaxInputs];
  int count;
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T>
struct alignas(4 * sizeof(T)) Vec4 {
  T v[4];
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    concat_conv1x1_kernel(Inputs in, const T* __restrict__ w,
                          const T* __restrict__ b, T* __restrict__ out,
                          int hw, int f_out, int k_total) {
  __shared__ __align__(16) float xs[kBlockK][kBlockP];
  __shared__ __align__(16) float ws[kBlockK][kBlockF];

  const int tid = threadIdx.x;
  const int lane = tid % 32;  // pixels 4*lane .. 4*lane+3 and +128
  const int warp = tid / 32;  // output channels 8*warp .. 8*warp+7
  const int p0 = blockIdx.x * kBlockP;
  const int f0 = blockIdx.y * kBlockF;
  const int n = blockIdx.z;

  float acc[kThreadF][kThreadP];
#pragma unroll
  for (int i = 0; i < kThreadF; ++i)
#pragma unroll
    for (int j = 0; j < kThreadP; ++j) acc[i][j] = 0.f;

  int k_off = 0;  // column of W where input i starts
  for (int i = 0; i < in.count; ++i) {
    const int c_i = in.channels[i];
    const T* x = static_cast<const T*>(in.ptr[i]) +
                 static_cast<size_t>(n) * c_i * hw;
    for (int c0 = 0; c0 < c_i; c0 += kBlockK) {
      // Stage kBlockK channel rows of kBlockP pixels: thread tid loads pixel
      // p0 + tid of every row (coalesced along the row).
      const int p = p0 + tid;
#pragma unroll
      for (int r = 0; r < kBlockK; ++r) {
        const int c = c0 + r;
        xs[r][tid] = (c < c_i && p < hw)
                         ? to_float(x[static_cast<size_t>(c) * hw + p])
                         : 0.f;
      }
      // Stage the (kBlockF x kBlockK) weight slice transposed, channel
      // fastest: conflict-free shared stores (W itself is L2-resident).
#pragma unroll
      for (int e = tid; e < kBlockF * kBlockK; e += kThreads) {
        const int f = e % kBlockF;
        const int kk = e / kBlockF;
        const int c = c0 + kk;
        ws[kk][f] = (f0 + f < f_out && c < c_i)
                        ? to_float(w[static_cast<size_t>(f0 + f) * k_total +
                                     k_off + c])
                        : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kBlockK; ++kk) {
        // One warp shares its 8 weights (a broadcast); each lane reads its
        // two runs of 4 pixels.
        const float4 a0 = *reinterpret_cast<const float4*>(&ws[kk][warp * kThreadF]);
        const float4 a1 = *reinterpret_cast<const float4*>(&ws[kk][warp * kThreadF + 4]);
        const float4 v0 = *reinterpret_cast<const float4*>(&xs[kk][4 * lane]);
        const float4 v1 = *reinterpret_cast<const float4*>(&xs[kk][128 + 4 * lane]);
        const float a[kThreadF] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float v[kThreadP] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
        for (int fi = 0; fi < kThreadF; ++fi)
#pragma unroll
          for (int pj = 0; pj < kThreadP; ++pj)
            acc[fi][pj] = fmaf(a[fi], v[pj], acc[fi][pj]);
      }
      __syncthreads();
    }
    k_off += c_i;
  }

  // Rows are 16-byte (f32) / 8-byte (bf16) aligned when hw % 4 == 0 (the
  // wrapper allocates `out` fresh): store each run of 4 pixels at once.
  const bool vec4 = hw % 4 == 0;
#pragma unroll
  for (int fi = 0; fi < kThreadF; ++fi) {
    const int f = f0 + warp * kThreadF + fi;
    if (f >= f_out) continue;
    const float bias = to_float(b[f]);
    T* o = out + (static_cast<size_t>(n) * f_out + f) * hw;
#pragma unroll
    for (int g = 0; g < kThreadP / 4; ++g) {
      const int p = p0 + g * 128 + 4 * lane;
      if (vec4 && p < hw) {
        Vec4<T> q;
#pragma unroll
        for (int j = 0; j < 4; ++j) q.v[j] = from_float<T>(acc[fi][4 * g + j] + bias);
        *reinterpret_cast<Vec4<T>*>(o + p) = q;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (p + j < hw) o[p + j] = from_float<T>(acc[fi][4 * g + j] + bias);
      }
    }
  }
}

}  // namespace

// C entry point (bound with ctypes). dtype: 0 = float32, 1 = bfloat16.
// xs[i] is (n, channels[i], hw) contiguous; w is (f_out, sum channels);
// b is (f_out,); out is (n, f_out, hw). Launches on `stream` and returns
// the launch's cudaError_t (0 on success); it does not synchronise.
extern "C" int vsr_concat_conv1x1(const void* const* xs, const int* channels,
                                  int count, const void* w, const void* b,
                                  void* out, int n, int hw, int f_out,
                                  int dtype, void* stream) {
  if (count < 1 || count > kMaxInputs || n < 1 || n > 65535 || hw < 1 ||
      f_out < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Inputs in{};
  int k_total = 0;
  for (int i = 0; i < count; ++i) {
    if (channels[i] < 1) return static_cast<int>(cudaErrorInvalidValue);
    in.ptr[i] = xs[i];
    in.channels[i] = channels[i];
    k_total += channels[i];
  }
  in.count = count;
  const dim3 grid((hw + kBlockP - 1) / kBlockP, (f_out + kBlockF - 1) / kBlockF,
                  n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    concat_conv1x1_kernel<float><<<grid, kThreads, 0, s>>>(
        in, static_cast<const float*>(w), static_cast<const float*>(b),
        static_cast<float*>(out), hw, f_out, k_total);
  } else if (dtype == 1) {
    concat_conv1x1_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        in, static_cast<const __nv_bfloat16*>(w),
        static_cast<const __nv_bfloat16*>(b),
        static_cast<__nv_bfloat16*>(out), hw, f_out, k_total);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
