// Fused DUF dynamic-filter application for NVIDIA Hopper (sm_90a): softmax
// over the filter taps, the per-pixel k x k contraction with the LR
// neighbourhood, and the pixel shuffle, in one pass.
//
// Replaces the Pallas TPU kernel K2 of the JAX package:
// vsr_tpu/ops/pallas_duf.py, duf_dynamic_filter_pallas (pl.pallas_call at
// :72, kernel body _duf_kernel at :32).
//
// What it computes, for x (N, H, W) and channel-first pre-softmax logits
// (N, k^2 * r^2, H, W) with channel = tap * r^2 + s, tap = ky * k + kx,
// s = dy * r + dx, p = k / 2:
//   out[n, y*r + dy, x*r + dx] =
//       sum_tap softmax_tap(logits[n, :, s, y, x])[tap] * x[n, y+ky-p, x+kx-p]
// with x read as zero outside the frame. out is (N, H*r, W*r), float32.
//
// What bounds it: a pixel reads k^2 r^2 + 1 floats and writes r^2 (at k = 5,
// r = 2: 420 bytes) for about 6 operations per logit: it is bound by the
// bytes of the logits, which are read exactly once. The plain version
// writes and re-reads the softmax, the im2col patches and the pre-shuffle
// result; here none of them reaches device memory.
//
// Design (the simple, correct first version): a block takes a tile of
// 32 x 8 LR pixels of one image and stages the tile of x with its halo of
// p pixels (zeros outside the frame) in shared memory. Each thread owns one
// LR pixel: the 32 lanes of a warp are 32 neighbours along W, so every
// logit load is one coalesced 128-byte row segment (the channel-first
// layout makes W the contiguous axis). For each sub-pixel s the thread
// walks the taps once with an online softmax (running max m, running sum l
// and running weighted sum acc, rescaled when the max grows), all in f32
// registers, and writes acc / l straight to the shuffled position.

#include <cuda_runtime.h>

#include <cfloat>
#include <cstddef>

namespace {

constexpr int kTileW = 32;
constexpr int kTileH = 8;
constexpr int kMaxSize = 15;  // largest filter side (odd)

__global__ void __launch_bounds__(kTileW* kTileH)
    duf_filter_kernel(const float* __restrict__ x,
                      const float* __restrict__ logits,
                      float* __restrict__ out, int h, int w, int size, int r) {
  extern __shared__ float tile[];  // (kTileH + 2p) x (kTileW + 2p)
  const int p = size / 2;
  const int tw = kTileW + 2 * p;
  const int th = kTileH + 2 * p;
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kTileH;
  const int n = blockIdx.z;
  const size_t hw = static_cast<size_t>(h) * w;
  const float* xn = x + n * hw;

  const int tid = threadIdx.y * kTileW + threadIdx.x;
  for (int e = tid; e < tw * th; e += kTileW * kTileH) {
    const int yy = y0 + e / tw - p;
    const int xx = x0 + e % tw - p;
    tile[e] = (yy >= 0 && yy < h && xx >= 0 && xx < w)
                  ? xn[static_cast<size_t>(yy) * w + xx]
                  : 0.f;
  }
  __syncthreads();

  const int px = x0 + threadIdx.x;
  const int py = y0 + threadIdx.y;
  if (px >= w || py >= h) return;

  const int k2 = size * size;
  const int r2 = r * r;
  const float* lg = logits + static_cast<size_t>(n) * k2 * r2 * hw +
                    static_cast<size_t>(py) * w + px;
  float* on = out + static_cast<size_t>(n) * hw * r2;
  const float* corner = tile + threadIdx.y * tw + threadIdx.x;
  for (int s = 0; s < r2; ++s) {
    // -FLT_MAX, not -inf: a logit of -inf then gives exp(-inf) = 0, not NaN.
    float m = -FLT_MAX, l = 0.f, acc = 0.f;
    int tap = 0;
    for (int ky = 0; ky < size; ++ky) {
#pragma unroll 5
      for (int kx = 0; kx < size; ++kx, ++tap) {
        const float v = lg[static_cast<size_t>(tap * r2 + s) * hw];
        const float xv = corner[ky * tw + kx];
        if (v > m) {  // rescale what was summed under the old max
          const float scale = expf(m - v);
          l *= scale;
          acc *= scale;
          m = v;
        }
        const float e = expf(v - m);
        l += e;
        acc = fmaf(e, xv, acc);
      }
    }
    const int oy = py * r + s / r;
    const int ox = px * r + s % r;
    on[static_cast<size_t>(oy) * (w * r) + ox] = acc / l;
  }
}

}  // namespace

// C entry point (bound with ctypes). x is (n, h, w), logits
// (n, size^2 * r^2, h, w), out (n, h*r, w*r), all contiguous float32.
// Launches on `stream` and returns the launch's cudaError_t (0 on success);
// it does not synchronise.
extern "C" int vsr_duf_filter(const void* x, const void* logits, void* out,
                              int n, int h, int w, int size, int r,
                              void* stream) {
  if (n < 1 || n > 65535 || h < 1 || w < 1 || size < 1 || size > kMaxSize ||
      size % 2 == 0 || r < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int p = size / 2;
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH, n);
  const dim3 block(kTileW, kTileH);
  const size_t shared =
      static_cast<size_t>(kTileW + 2 * p) * (kTileH + 2 * p) * sizeof(float);
  duf_filter_kernel<<<grid, block, shared,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(logits),
      static_cast<float*>(out), h, w, size, r);
  return static_cast<int>(cudaGetLastError());
}
