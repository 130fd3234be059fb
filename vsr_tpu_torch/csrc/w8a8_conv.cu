// W8A8 convolution on the int8 tensor cores: the body of
// vsr_tpu/quantize.py:_w8a8_conv (quantize the activations, s8 x s8 -> s32
// convolution, float dequantization + bias + cast) in one launch.
//
// It replaces no Pallas kernel: the JAX package leaves this convolution to
// XLA (vsr_tpu/quantize.py:241-322, preferred_element_type=int32), and
// PyTorch on CUDA reaches no int8 convolution. The wrapper
// (vsr_tpu_torch/ops/w8a8_conv.py) quantizes the dense weights per output
// channel at each call and hands over the activation scale as a device
// pointer (static or computed on the card), so there is no host sync.
//
// Design: an implicit GEMM. Rows are output pixels (N * Do * Ho * Wo), columns
// output channels of one group, the reduction runs over (c, kz, ky, kx) in the
// weights' own order. A block of 4 warps computes a 64 x 64 tile; each warp a
// 32 x 32 quarter as 2 x 4 mma.sync.m16n8k32 s8 products per K step of 32.
// The activations are quantized while they are gathered into shared memory,
// with IEEE division (__fdiv_rn) and round-half-even (__float2int_rn), so
// the int8 values equal the plain twin's and the s32 sums equal its exact
// float64 ones. The epilogue takes float(acc) * (ws[c] * xs) + bias[c] with
// explicit _rn intrinsics (no fused multiply-add), in the twin's order.
//
// What bounds it on an H100: at the zoo's widths (64 channels, 3x3) an int8
// convolution does ~2 x 576 operations per output element against ~8 bytes
// of float activations in and out, so it is bound by memory like the bf16
// convolution (1,979 TOPS vs 3.35 TB/s). This first kernel is simple: no
// TMA, no wgmma, no pipelining of the gather; it reads each activation once
// per tap from L1/L2 and writes the output in NC(D)HW order from registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;        // output pixels per block
constexpr int kBN = 64;        // output channels per block
constexpr int kBK = 32;        // reduction step (one mma k32)
constexpr int kLds = 48;       // bytes per row of a shared tile: 16-byte
                               // aligned, and conflict-free fragment loads
constexpr int kThreads = 128;  // 4 warps, 2 x 2 over the tile

struct Geometry {
  int n, c, d, h, w;      // input
  int f, groups, cg, fg;  // output channels, groups, per-group channels
  int kd, kh, kw;         // kernel
  int sd, sh, sw;         // strides
  int pd, ph, pw;         // paddings
  int od, oh, ow;         // output
  int k, k_pad;           // reduction length (cg * kd * kh * kw), padded
  long long m;            // output pixels
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ int quantize(float v, float xs) {
  const int q = __float2int_rn(__fdiv_rn(v, xs));
  return min(max(q, -127), 127);
}

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// out_kind: 0 float32, 1 bfloat16, 2 the int32 accumulators.
template <typename T, int kOut>
__global__ void __launch_bounds__(kThreads)
    w8a8_conv_kernel(const T* __restrict__ x, const int8_t* __restrict__ wq,
                     const float* __restrict__ ws,
                     const float* __restrict__ bias,
                     const float* __restrict__ xs_ptr, void* __restrict__ out,
                     Geometry g) {
  __shared__ __align__(16) int8_t a_tile[kBM * kLds];
  __shared__ __align__(16) int8_t b_tile[kBN * kLds];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int group = blockIdx.z;
  const long long m0 = (long long)blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;  // output channel within the group
  const float xs = *xs_ptr;

  // The gather: thread tid quantizes 16 consecutive k of pixel row am.
  const int am = tid % kBM;
  const int ak0 = (tid / kBM) * 16;
  const long long mrow = m0 + am;
  const bool m_ok = mrow < g.m;
  int iz0 = 0, iy0 = 0, ix0 = 0;
  const T* xb = x;
  if (m_ok) {
    long long r = mrow;
    const int px = (int)(r % g.ow);
    r /= g.ow;
    const int py = (int)(r % g.oh);
    r /= g.oh;
    const int pz = (int)(r % g.od);
    const long long pn = r / g.od;
    iz0 = pz * g.sd - g.pd;
    iy0 = py * g.sh - g.ph;
    ix0 = px * g.sw - g.pw;
    xb = x + (pn * g.c + (long long)group * g.cg) * g.d * g.h * g.w;
  }
  const int khw = g.kh * g.kw, kvol = g.kd * khw;

  // The weights: thread tid copies 16 bytes of channel row tid / 2.
  const int bn = tid >> 1, bk = (tid & 1) * 16;
  const int8_t* wrow =
      wq + (long long)(group * g.fg + n0 + bn) * g.k_pad + bk;
  const bool n_ok = n0 + bn < g.fg;

  const int wm = warp & 1, wn = warp >> 1;
  const int gid = lane >> 2, tig = lane & 3;
  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  for (int k0 = 0; k0 < g.k_pad; k0 += kBK) {
    // Decompose the first k of this thread's run once, then step.
    int k = k0 + ak0;
    int ci = k / kvol, rem = k - ci * kvol;
    int kz = rem / khw;
    rem -= kz * khw;
    int ky = rem / g.kw, kx = rem - ky * g.kw;
    uint32_t packed[4];
#pragma unroll
    for (int word = 0; word < 4; ++word) {
      uint32_t bits = 0;
#pragma unroll
      for (int byte = 0; byte < 4; ++byte) {
        int q = 0;
        if (m_ok && k < g.k) {
          const int iz = iz0 + kz, iy = iy0 + ky, ix = ix0 + kx;
          if (iz >= 0 && iz < g.d && iy >= 0 && iy < g.h && ix >= 0 &&
              ix < g.w) {
            const long long off =
                (((long long)ci * g.d + iz) * g.h + iy) * g.w + ix;
            q = quantize(to_float(xb[off]), xs);
          }
        }
        bits |= (uint32_t)(q & 0xff) << (8 * byte);
        ++k;
        if (++kx == g.kw) {
          kx = 0;
          if (++ky == g.kh) {
            ky = 0;
            if (++kz == g.kd) {
              kz = 0;
              ++ci;
            }
          }
        }
      }
      packed[word] = bits;
    }
    *reinterpret_cast<uint4*>(a_tile + am * kLds + ak0) =
        make_uint4(packed[0], packed[1], packed[2], packed[3]);
    const uint4 wv = n_ok ? *reinterpret_cast<const uint4*>(wrow + k0)
                          : make_uint4(0, 0, 0, 0);
    *reinterpret_cast<uint4*>(b_tile + bn * kLds + bk) = wv;
    __syncthreads();

    uint32_t a[2][4], b[4][2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int8_t* row = a_tile + (wm * 32 + i * 16 + gid) * kLds + tig * 4;
      a[i][0] = *reinterpret_cast<const uint32_t*>(row);
      a[i][1] = *reinterpret_cast<const uint32_t*>(row + 8 * kLds);
      a[i][2] = *reinterpret_cast<const uint32_t*>(row + 16);
      a[i][3] = *reinterpret_cast<const uint32_t*>(row + 8 * kLds + 16);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int8_t* col = b_tile + (wn * 32 + j * 8 + gid) * kLds + tig * 4;
      b[j][0] = *reinterpret_cast<const uint32_t*>(col);
      b[j][1] = *reinterpret_cast<const uint32_t*>(col + 16);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], a[i], b[j]);
    __syncthreads();
  }

  const long long pixels = (long long)g.od * g.oh * g.ow;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long mm = m0 + wm * 32 + i * 16 + gid + half * 8;
      if (mm >= g.m) continue;
      const long long nb = mm / pixels, pix = mm - nb * pixels;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int fo = n0 + wn * 32 + j * 8 + tig * 2 + e;
          if (fo >= g.fg) continue;
          const int fc = group * g.fg + fo;
          const long long o = (nb * g.f + fc) * pixels + pix;
          const int v = acc[i][j][half * 2 + e];
          if (kOut == 2) {
            static_cast<int*>(out)[o] = v;
          } else {
            float y = __fmul_rn(__int2float_rn(v), __fmul_rn(ws[fc], xs));
            if (bias != nullptr) y = __fadd_rn(y, bias[fc]);
            if (kOut == 0) {
              static_cast<float*>(out)[o] = y;
            } else {
              static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(y);
            }
          }
        }
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const int8_t* wq, const float* ws,
                   const float* bias, const float* xs, void* out,
                   int out_kind, const Geometry& g, cudaStream_t stream) {
  const dim3 grid((unsigned)((g.m + kBM - 1) / kBM),
                  (unsigned)((g.fg + kBN - 1) / kBN), (unsigned)g.groups);
  const T* xt = static_cast<const T*>(x);
  if (out_kind == 0) {
    w8a8_conv_kernel<T, 0><<<grid, kThreads, 0, stream>>>(xt, wq, ws, bias,
                                                           xs, out, g);
  } else if (out_kind == 1) {
    w8a8_conv_kernel<T, 1><<<grid, kThreads, 0, stream>>>(xt, wq, ws, bias,
                                                           xs, out, g);
  } else {
    w8a8_conv_kernel<T, 2><<<grid, kThreads, 0, stream>>>(xt, wq, ws, bias,
                                                           xs, out, g);
  }
  return cudaGetLastError();
}

}  // namespace

// x: (N, C, D, H, W) float32 (x_kind 0) or bfloat16 (1), contiguous;
// wq: (F, k_pad) int8, each row the channel's (C/g, kd, kh, kw) weights
// padded with zeros; ws: (F,) float32; bias: (F,) float32 or null; xs: one
// float32 on the card; out: (N, F, Do, Ho, Wo) of out_kind (0 float32,
// 1 bfloat16, 2 int32 accumulators). dims: n, c, d, h, w, f, groups, kd,
// kh, kw, sd, sh, sw, pd, ph, pw, od, oh, ow, k_pad.
extern "C" int vsr_w8a8_conv(const void* x, int x_kind, const void* wq,
                             const void* ws, const void* bias, const void* xs,
                             void* out, int out_kind, const int* dims,
                             void* stream) {
  Geometry g;
  g.n = dims[0];
  g.c = dims[1];
  g.d = dims[2];
  g.h = dims[3];
  g.w = dims[4];
  g.f = dims[5];
  g.groups = dims[6];
  g.kd = dims[7];
  g.kh = dims[8];
  g.kw = dims[9];
  g.sd = dims[10];
  g.sh = dims[11];
  g.sw = dims[12];
  g.pd = dims[13];
  g.ph = dims[14];
  g.pw = dims[15];
  g.od = dims[16];
  g.oh = dims[17];
  g.ow = dims[18];
  g.k_pad = dims[19];
  if (g.groups < 1 || g.c % g.groups || g.f % g.groups || x_kind < 0 ||
      x_kind > 1 || out_kind < 0 || out_kind > 2 || g.k_pad % kBK) {
    return (int)cudaErrorInvalidValue;
  }
  g.cg = g.c / g.groups;
  g.fg = g.f / g.groups;
  g.k = g.cg * g.kd * g.kh * g.kw;
  g.m = (long long)g.n * g.od * g.oh * g.ow;
  if (g.k > g.k_pad || g.m <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* w8 = static_cast<const int8_t*>(wq);
  const float* wsf = static_cast<const float*>(ws);
  const float* bf = static_cast<const float*>(bias);
  const float* xsf = static_cast<const float*>(xs);
  if (x_kind == 0) {
    return (int)launch<float>(x, w8, wsf, bf, xsf, out, out_kind, g, s);
  }
  return (int)launch<__nv_bfloat16>(x, w8, wsf, bf, xsf, out, out_kind, g, s);
}
