// Fused concat + 1x1 conv ("squeeze"), optionally with the PReLU that
// follows it, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel K1 of the JAX package:
// vsr_tpu/ops/fused_squeeze.py, concat_matmul -> _concat_matmul_fwd_impl
// (pl.pallas_call at :81, kernel body _kernel at :40).
//
// What it computes, per image n and pixel p of NCHW inputs x_0..x_{k-1}:
//   out[n, f, p] = b[f] + sum_i sum_{c < C_i} W[f, off_i + c] * x_i[n, c, p]
// i.e. concat(xs, channel) followed by a 1x1 conv, without ever writing the
// concat to device memory. W is (F, sum C_i) row-major, b is (F,). Sums are
// kept in f32 and rounded once to the inputs' type T. With `alpha` (one
// value of type T) the rounded result r becomes r > 0 ? r : alpha * r,
// rounded again: bit for bit what a separate PReLU pass over the stored
// output computes, without its read and write.
//
// What bounds it: per image this is the GEMM out(F x P) = W(F x K) X(K x P)
// with the pixel axis contiguous in X and out. At the DRFNet ladder shapes
// (F = 64, K = 128..384) a pixel costs 2*K*64 FLOP against (K + 64) elements
// moved: about 55 FLOP/B in bf16, far below the H100's ~295 FLOP/B ridge.
// The kernel is bound by device-memory bytes, as long as the products run on
// the tensor cores (on the CUDA cores the f32 rate, not memory, is the limit).
//
// Design (a streaming GEMM):
// - Persistent blocks. A block of 8 warps owns 64 output channels and walks
//   tiles of 128 pixels (tile = blockIdx.x, + gridDim.x, ...); the grid is
//   as many blocks as the card holds at once.
// - The weights once. The block's (64 x K) slice of W is loaded into shared
//   memory once, before the first tile, with 16-byte copies, each input's
//   columns padded to a multiple of the K tile with zeros and rows padded
//   against bank conflicts. Where it does not fit beside the ring (a large
//   K), the (64 x 32) weight tile of each K step travels through the ring
//   with its X tile instead: same code, another pointer and stride.
// - A ring of X tiles. Four stages of (32 channels x 128 pixels) in dynamic
//   shared memory are filled with 16-byte cp.async.cg copies
//   (commit_group / wait_group), three K steps ahead of the math and across
//   tile boundaries, so the next tile's loads fly during an epilogue.
//   cp.async was taken over TMA: the copies are plain row segments, the
//   src-size form zero-fills ragged edges, and no tensor map has to be
//   encoded on the host for every input of every call. The K loop switches
//   the source at each C_i boundary; a K tile never straddles two inputs
//   (the tail rows are zero-filled, the matching weight columns are zero).
// - Tensor cores. bf16: mma.sync.m16n8k16 with f32 accumulators; W
//   fragments by ldmatrix.x4, X fragments (pixel-contiguous, i.e. stored
//   [k][n]) by ldmatrix.x4.trans. f32: error-compensated TF32,
//   mma.sync.m16n8k8.tf32 three times per product: every operand is split
//   into a head (the top 19 bits) and a tail (the exact remainder, cut to
//   19 bits again), and a*b ~ a_lo*b_hi + a_hi*b_lo + a_hi*b_hi; what is
//   dropped is below 2^-19 |a||b| per product, so the result stays within
//   f32 summation noise of a full-f32 product. A single TF32 product is
//   never used. A warp computes 32 channels x 32 pixels.
// - Stores. Accumulator fragments are finished (bias, rounding, PReLU) and
//   staged in shared memory, then written as whole pixel rows in 16-byte
//   stores.
// - Ragged cases stay here: 16-byte copies need hw * sizeof(T) % 16 == 0
//   and 16-byte-aligned pointers (for W: every C_i a multiple of the
//   vector); otherwise the same tiles are staged by guarded element-wise
//   loads, and stored element-wise.
// The input pointers and channel counts (at most 8) travel by value.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kMaxInputs = 8;
constexpr int kThreads = 256;  // 8 warps: 2 over channels x 4 over pixels
constexpr int kBlockF = 64;    // output channels per block
constexpr int kBlockP = 128;   // pixels per tile
constexpr int kBlockK = 32;    // input channels per K step
constexpr int kStages = 4;     // ring depth
constexpr int kPadP = 8;       // row pad of X and output tiles (elements)
constexpr int kStrideX = kBlockP + kPadP;
constexpr int kMaxSmem = 232448;  // dynamic shared memory a block may use

template <typename T>
struct Cfg;
template <>
struct Cfg<__nv_bfloat16> {
  static constexpr int kVec = 8;        // elements per 16 bytes
  static constexpr int kPadW = 8;       // ldmatrix rows 16 bytes apart mod 128
  static constexpr int kMinBlocks = 2;  // blocks per SM to aim at
};
template <>
struct Cfg<float> {
  static constexpr int kVec = 4;
  static constexpr int kPadW = 4;  // row stride = 4 mod 32 banks
  static constexpr int kMinBlocks = 1;
};

// Shared memory layout, in elements of T: [the resident weights, 64 rows
// of k_pad + kPadW] [kStages stages: an X tile, and a weight tile when the
// weights are streamed] [the output tile].
template <typename T>
constexpr int kStrideWTile = kBlockK + Cfg<T>::kPadW;
template <typename T, bool kResident>
constexpr int kStageElems =
    kBlockK * kStrideX + (kResident ? 0 : kBlockF * kStrideWTile<T>);
template <typename T, bool kResident>
constexpr size_t smem_bytes(int k_pad) {
  return (static_cast<size_t>(kResident ? kBlockF : 0) *
              (k_pad + Cfg<T>::kPadW) +
          kStages * kStageElems<T, kResident> + kBlockF * kStrideX) *
         sizeof(T);
}

struct Params {
  const void* x[kMaxInputs];
  int channels[kMaxInputs];
  int count;
  const void* w;
  const void* b;
  const void* alpha;  // null: no PReLU
  void* out;
  int hw, f_out, k_total;
  int k_pad;            // sum of the C_i, each rounded up to kBlockK
  int tiles_per_image;  // ceil(hw / kBlockP)
  int total_tiles;      // n * tiles_per_image
  int x_vec, w_vec, o_vec;  // 16-byte copies allowed for X / W / out
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
struct alignas(2 * sizeof(T)) Vec2 {
  T v[2];
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; bytes past `src_bytes` are
// written as zeros (src_bytes = 0 reads nothing).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// One 16-byte chunk of a tile: `valid` leading elements from `src`, zeros
// after. `vec`: by cp.async (src 16-byte aligned); else element by element.
template <typename T>
__device__ __forceinline__ void copy_chunk(T* dst, const T* src, int valid,
                                           bool vec) {
  if (vec) {
    cp_async16(dst, src, valid * static_cast<int>(sizeof(T)));
  } else {
#pragma unroll
    for (int j = 0; j < Cfg<T>::kVec; ++j)
      dst[j] = j < valid ? src[j] : from_float<T>(0.f);
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// f32 -> TF32 head (top 19 bits) and TF32 tail (the exact rest, cut again).
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(v) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi)) & 0xffffe000u;
}

// One K step of a warp's 32 channels x 32 pixels: acc[mi][ni] is the
// m16 x n8 fragment of channels 16*mi.. and pixels 8*ni.. of the warp's
// tile. `w` points at (warp's channel 0, this step's column 0) of the
// weights, `x` at (row 0, warp's pixel 0) of the X tile.
__device__ __forceinline__ void mma_step(float (&acc)[2][4][4],
                                         const __nv_bfloat16* w, int stride_w,
                                         const __nv_bfloat16* x, int lane) {
  // ldmatrix.x4: lane l addresses row l % 16, column 8 * (l / 16).
  const __nv_bfloat16* a_ptr = w + (lane % 16) * stride_w + (lane / 16) * 8;
  const __nv_bfloat16* b_ptr = x + (lane % 16) * kStrideX + (lane / 16) * 8;
#pragma unroll
  for (int ks = 0; ks < kBlockK / 16; ++ks) {
    uint32_t a[2][4], b[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
      ldmatrix_x4(a[mi], a_ptr + mi * 16 * stride_w + ks * 16);
    // X is stored [k][pixel]: the transposing load yields the col-major B
    // fragments of two n8 tiles, {b0, b1} of pixels 0..7 then of 8..15.
#pragma unroll
    for (int nj = 0; nj < 2; ++nj)
      ldmatrix_x4_trans(b[nj], b_ptr + ks * 16 * kStrideX + nj * 16);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
        mma_bf16(acc[mi][ni], a[mi], b[ni / 2][(ni % 2) * 2],
                 b[ni / 2][(ni % 2) * 2 + 1]);
  }
}

__device__ __forceinline__ void mma_step(float (&acc)[2][4][4], const float* w,
                                         int stride_w, const float* x,
                                         int lane) {
  const int g = lane / 4, t = lane % 4;
  const float* a_ptr = w + g * stride_w + t;
  const float* b_ptr = x + t * kStrideX + g;
#pragma unroll
  for (int ks = 0; ks < kBlockK / 8; ++ks) {
    uint32_t a_hi[2][4], a_lo[2][4], b_hi[4][2], b_lo[4][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      // A fragment of m16n8k8: (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4).
      const float* p = a_ptr + mi * 16 * stride_w + ks * 8;
      split_tf32(p[0], a_hi[mi][0], a_lo[mi][0]);
      split_tf32(p[8 * stride_w], a_hi[mi][1], a_lo[mi][1]);
      split_tf32(p[4], a_hi[mi][2], a_lo[mi][2]);
      split_tf32(p[8 * stride_w + 4], a_hi[mi][3], a_lo[mi][3]);
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      // B fragment: (k = t, n = g), (k = t + 4, n = g).
      const float* p = b_ptr + ks * 8 * kStrideX + ni * 8;
      split_tf32(p[0], b_hi[ni][0], b_lo[ni][0]);
      split_tf32(p[4 * kStrideX], b_hi[ni][1], b_lo[ni][1]);
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        // The small terms first.
        mma_tf32(acc[mi][ni], a_lo[mi], b_hi[ni][0], b_hi[ni][1]);
        mma_tf32(acc[mi][ni], a_hi[mi], b_lo[ni][0], b_lo[ni][1]);
        mma_tf32(acc[mi][ni], a_hi[mi], b_hi[ni][0], b_hi[ni][1]);
      }
  }
}

// Stage rows c0 .. c0 + kBlockK of input `x` (c_i channels), pixels
// p0 .. p0 + kBlockP of image n, as tile[row][pixel]; zeros past the edges.
template <typename T>
__device__ __forceinline__ void load_x_tile(T* tile, const T* x, int c_i,
                                            int c0, int n, int p0, int hw,
                                            bool vec) {
  constexpr int kVec = Cfg<T>::kVec;
  constexpr int kChunks = kBlockP / kVec;  // per row
  static_assert(kBlockK * kChunks % kThreads == 0, "whole rounds of chunks");
#pragma unroll
  for (int it = 0; it < kBlockK * kChunks / kThreads; ++it) {
    const int e = it * kThreads + threadIdx.x;
    const int r = e / kChunks, p = p0 + (e % kChunks) * kVec;
    const int c = c0 + r;
    int valid = c < c_i ? hw - p : 0;
    valid = valid < 0 ? 0 : (valid > kVec ? kVec : valid);
    const T* src =
        valid ? x + (static_cast<size_t>(n) * c_i + c) * hw + p : x;
    copy_chunk(tile + r * kStrideX + (e % kChunks) * kVec, src, valid, vec);
  }
}

// Stage W[f0 .. f0 + 64, off + c0 .. off + c0 + kBlockK) of an input whose
// columns start at `off` and number c_i, as tile[f * stride + column];
// zeros past the input's last column and past the last output channel.
template <typename T>
__device__ __forceinline__ void load_w_tile(T* tile, int stride, const T* w,
                                            int k_total, int off, int c_i,
                                            int c0, int f0, int f_out,
                                            bool vec) {
  constexpr int kVec = Cfg<T>::kVec;
  constexpr int kChunks = kBlockK / kVec;  // per row
  static_assert(kBlockF * kChunks % kThreads == 0, "whole rounds of chunks");
#pragma unroll
  for (int it = 0; it < kBlockF * kChunks / kThreads; ++it) {
    const int e = it * kThreads + threadIdx.x;
    const int f = e / kChunks, c = c0 + (e % kChunks) * kVec;
    int valid = f0 + f < f_out ? c_i - c : 0;
    valid = valid < 0 ? 0 : (valid > kVec ? kVec : valid);
    const T* src =
        valid ? w + static_cast<size_t>(f0 + f) * k_total + off + c : w;
    copy_chunk(tile + f * stride + (e % kChunks) * kVec, src, valid, vec);
  }
}

// kResident: the block's whole weight slice sits in shared memory; else a
// weight tile travels with every X tile through the ring.
template <typename T, bool kResident>
__global__ void __launch_bounds__(kThreads, Cfg<T>::kMinBlocks)
    concat_conv1x1_kernel(const Params p) {
  constexpr int kVec = Cfg<T>::kVec;
  constexpr int kStrideWT = kStrideWTile<T>;
  constexpr int kStage = kStageElems<T, kResident>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int stride_w = kResident ? p.k_pad + Cfg<T>::kPadW : kStrideWT;
  T* const w_res = reinterpret_cast<T*>(smem_raw);
  T* const ring = w_res + (kResident ? kBlockF * stride_w : 0);
  T* const out_s = ring + kStages * kStage;  // [kBlockF][kStrideX]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int warp_f = (warp / 4) * 32, warp_p = (warp % 4) * 32;
  const int g = lane / 4, t = lane % 4;
  const int f0 = blockIdx.y * kBlockF;
  const T* const w = static_cast<const T*>(p.w);

  // The producer's position: tile, input, first channel, W column of input.
  int pr_tile = blockIdx.x, pr_i = 0, pr_c0 = 0, pr_off = 0;
  auto produce = [&](int slot) {
    if (pr_tile < p.total_tiles) {
      T* stage = ring + slot * kStage;
      const int c_i = p.channels[pr_i];
      load_x_tile(stage, static_cast<const T*>(p.x[pr_i]), c_i, pr_c0,
                  pr_tile / p.tiles_per_image,
                  (pr_tile % p.tiles_per_image) * kBlockP, p.hw,
                  p.x_vec != 0);
      if (!kResident)
        load_w_tile(stage + kBlockK * kStrideX, kStrideWT, w, p.k_total,
                    pr_off, c_i, pr_c0, f0, p.f_out, p.w_vec != 0);
      pr_c0 += kBlockK;
      if (pr_c0 >= c_i) {
        pr_c0 = 0;
        pr_off += c_i;
        if (++pr_i == p.count) {
          pr_i = 0;
          pr_off = 0;
          pr_tile += gridDim.x;
        }
      }
    }
    cp_async_commit();
  };

  if (kResident) {  // joins the first group of the ring
    int off = 0, col = 0;
    for (int i = 0; i < p.count; ++i) {
      const int c_i = p.channels[i];
      for (int c0 = 0; c0 < c_i; c0 += kBlockK, col += kBlockK)
        load_w_tile(w_res + col, stride_w, w, p.k_total, off, c_i, c0, f0,
                    p.f_out, p.w_vec != 0);
      off += c_i;
    }
  }
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) produce(s);

  // This thread's output channels: warp_f + 16 * mi + g (+ 8).
  float bias[2][2];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int f = f0 + warp_f + mi * 16 + h * 8 + g;
      bias[mi][h] = f < p.f_out ? to_float(static_cast<const T*>(p.b)[f]) : 0.f;
    }
  const bool prelu = p.alpha != nullptr;
  const float alpha = prelu ? to_float(*static_cast<const T*>(p.alpha)) : 0.f;
  auto finish = [&](float v, float b) {
    T r = from_float<T>(v + b);
    if (prelu) {
      const float x = to_float(r);
      r = from_float<T>(x > 0.f ? x : alpha * x);
    }
    return r;
  };

  float acc[2][4][4];
  const int num_kt = p.k_pad / kBlockK;
  int slot = 0, fill = kStages - 1;  // ring slots: to compute, to fill
  for (int tile = blockIdx.x; tile < p.total_tiles; tile += gridDim.x) {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0.f;

    for (int kt = 0; kt < num_kt; ++kt) {
      cp_async_wait<kStages - 2>();  // this thread's copies of `slot` landed
      __syncthreads();  // everyone's did, and everyone left slot `fill`
      produce(fill);
      const T* stage = ring + slot * kStage;
      const T* w_tile = kResident ? w_res + kt * kBlockK
                                  : stage + kBlockK * kStrideX;
      mma_step(acc, w_tile + warp_f * stride_w, stride_w, stage + warp_p,
               lane);
      slot = slot + 1 == kStages ? 0 : slot + 1;
      fill = fill + 1 == kStages ? 0 : fill + 1;
    }

    // Epilogue: finish the fragments into the staging tile ...
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          Vec2<T> q;
          q.v[0] = finish(acc[mi][ni][2 * h], bias[mi][h]);
          q.v[1] = finish(acc[mi][ni][2 * h + 1], bias[mi][h]);
          *reinterpret_cast<Vec2<T>*>(
              out_s + (warp_f + mi * 16 + h * 8 + g) * kStrideX + warp_p +
              ni * 8 + 2 * t) = q;
        }
    __syncthreads();
    // ... and write whole pixel rows. The next write to the staging tile
    // comes after the barrier of a later K step.
    const int n = tile / p.tiles_per_image;
    const int p0 = (tile % p.tiles_per_image) * kBlockP;
    constexpr int kChunks = kBlockP / kVec;
#pragma unroll
    for (int it = 0; it < kBlockF * kChunks / kThreads; ++it) {
      const int e = it * kThreads + tid;
      const int f = e / kChunks, px = p0 + (e % kChunks) * kVec;
      if (f0 + f >= p.f_out || px >= p.hw) continue;
      const T* src = out_s + f * kStrideX + (e % kChunks) * kVec;
      T* dst = static_cast<T*>(p.out) +
               (static_cast<size_t>(n) * p.f_out + f0 + f) * p.hw + px;
      if (p.o_vec) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
#pragma unroll
        for (int j = 0; j < kVec; ++j)
          if (px + j < p.hw) dst[j] = src[j];
      }
    }
  }
  cp_async_wait<0>();
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

template <typename T, bool kResident>
cudaError_t launch(const Params& p, int n_f_tiles, int smem, int device,
                   int sm_count, cudaStream_t stream) {
  auto kernel = concat_conv1x1_kernel<T, kResident>;
  // Dynamic shared memory above 48 KB has to be asked for, once per device
  // and size (a race between host threads only repeats the call).
  constexpr int kDevices = 64;
  static int allowed[kDevices] = {};
  if (device < 0 || device >= kDevices || smem > allowed[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    if (device >= 0 && device < kDevices) allowed[device] = smem;
  }
  int per_sm = kMaxSmem / (smem + 1024);  // 1 KB per block is the system's
  per_sm = per_sm < 1 ? 1 : per_sm;
  per_sm = per_sm > Cfg<T>::kMinBlocks ? Cfg<T>::kMinBlocks : per_sm;
  // Blocks that share a weight slice (one blockIdx.y) share the tiles.
  int blocks = (sm_count * per_sm + n_f_tiles - 1) / n_f_tiles;
  blocks = blocks > p.total_tiles ? p.total_tiles : blocks;
  kernel<<<dim3(blocks, n_f_tiles), kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(Params& p, cudaStream_t stream) {
  constexpr int kVec = Cfg<T>::kVec;
  const bool rows_aligned = p.hw % kVec == 0;  // rows of 16-byte multiples
  p.x_vec = rows_aligned;
  p.w_vec = p.k_total % kVec == 0 && aligned16(p.w);
  for (int i = 0; i < p.count; ++i) {
    p.x_vec = p.x_vec && aligned16(p.x[i]);
    p.w_vec = p.w_vec && p.channels[i] % kVec == 0;
  }
  p.o_vec = rows_aligned && aligned16(p.out);

  int device = 0, sm_count = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sm_count, cudaDevAttrMultiProcessorCount,
                               device);
  if (err != cudaSuccess) return err;

  const int n_f_tiles = (p.f_out + kBlockF - 1) / kBlockF;
  // The weights stay resident where they fit beside the ring.
  const size_t resident = smem_bytes<T, true>(p.k_pad);
  if (resident <= kMaxSmem)
    return launch<T, true>(p, n_f_tiles, static_cast<int>(resident), device,
                           sm_count, stream);
  return launch<T, false>(p, n_f_tiles,
                          static_cast<int>(smem_bytes<T, false>(p.k_pad)),
                          device, sm_count, stream);
}

}  // namespace

// C entry point (bound with ctypes). dtype: 0 = float32, 1 = bfloat16.
// xs[i] is (n, channels[i], hw) contiguous; w is (f_out, sum channels);
// b is (f_out,); alpha is one element or null (no PReLU); out is
// (n, f_out, hw); all of the one dtype, on the current device. Launches on
// `stream` and returns the first cudaError_t of the set-up or the launch
// (0 on success); it does not synchronise.
extern "C" int vsr_concat_conv1x1(const void* const* xs, const int* channels,
                                  int count, const void* w, const void* b,
                                  const void* alpha, void* out, int n, int hw,
                                  int f_out, int dtype, void* stream) {
  if (count < 1 || count > kMaxInputs || n < 1 || n > 65535 || hw < 1 ||
      f_out < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  long long k_total = 0, k_pad = 0;
  for (int i = 0; i < count; ++i) {
    if (channels[i] < 1) return static_cast<int>(cudaErrorInvalidValue);
    p.x[i] = xs[i];
    p.channels[i] = channels[i];
    k_total += channels[i];
    k_pad += (channels[i] + kBlockK - 1) / kBlockK * kBlockK;
  }
  const long long tiles_per_image = (hw + kBlockP - 1) / kBlockP;
  if (k_pad > 2147483647LL || n * tiles_per_image > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  p.count = count;
  p.w = w;
  p.b = b;
  p.alpha = alpha;
  p.out = out;
  p.hw = hw;
  p.f_out = f_out;
  p.k_total = static_cast<int>(k_total);
  p.k_pad = static_cast<int>(k_pad);
  p.tiles_per_image = static_cast<int>(tiles_per_image);
  p.total_tiles = static_cast<int>(n * tiles_per_image);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(dispatch<float>(p, s));
  if (dtype == 1) return static_cast<int>(dispatch<__nv_bfloat16>(p, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
