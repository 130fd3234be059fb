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
// f32. On the CUDA cores that is the f32 rate's side of the ridge
// (67 TFLOP/s / 3.35 TB/s = 20); with the products on the tensor cores, as
// here, it is the bytes of g and of the x_i, each read once (bf16), or the
// tensor cores' rate for the three TF32 products that an f32 product costs
// through mma.sync. The long sum is the problem: one block per output tile
// would leave the card empty.
//
// Design (split K on the tensor cores, two passes, deterministic):
// - No transpose. Both operands lie in memory with the summed dimension
//   (pixels) contiguous: g[n] is (F, hw), x_i[n] is (C_i, hw). That is the
//   row.col operand form of mma.sync (A = rows of g, B column-major = rows
//   of x_i, K = pixels), so tiles go to shared memory as they lie in device
//   memory (row = channel, 128 bytes of pixels) in 16-byte cp.async copies.
//   Rows are padded to 144 bytes = 36 words: a fragment load (8 rows x 4
//   words) then touches 32 different banks, in both types.
// - A ring of 4 stages (64 rows of g + 64 rows of x_i each), filled three
//   steps ahead of the products and across the units of work.
// - f32 through m16n8k8 TF32 as three products of split operands (a head of
//   the top 19 bits and a tail of the exact rest, cut again: a*b ~ a_lo*b_hi
//   + a_hi*b_lo + a_hi*b_hi, as in fused_squeeze.cu), which keeps the
//   accuracy of a plain f32 product; a single TF32 product is never used.
//   bf16 through m16n8k16 directly. A warp holds 32 x 32 outputs, a block
//   of 4 warps a 64 x 64 tile.
// - The summed dimension is cut into units of one image x one chunk of
//   pixels. Block (x, y, z) owns the 64 x 64 output tile (channels tile x of
//   the concatenation, which never straddles two inputs; rows tile z of F)
//   and sums over the units y, y + gridDim.y, ...; it writes its partial tile
//   to partial[y]. A second small kernel adds the partials in the order of
//   y: no atomics, so two runs give the same bits.
// - db rides along: the warps of channel tile 0 that hold channel columns
//   0..31 add up the g values they load as A fragments, and the block
//   writes the 64 row sums behind its partial tile.
// - Any F, C_i, hw and n: edges are zero-filled on load and masked on store;
//   where a row of pixels or a pointer is not a multiple of 16 bytes the
//   same tiles are staged by guarded element-wise loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kMaxInputs = 8;
constexpr int kTile = 64;        // rows of g (F) and channels of x per block
constexpr int kStepBytes = 128;  // bytes of pixels per row and step
constexpr int kSubSteps = 4;     // tensor-core products along a step's pixels
constexpr int kThreads = 128;    // 4 warps: 2 over rows of g x 2 over channels
constexpr int kMi = 2;           // m16 fragments of a warp: 32 rows of g
constexpr int kNi = 4;           // n8 fragments of a warp: 32 channels of x
constexpr int kRowBytes = kStepBytes + 16;  // padded row: 36 words
constexpr int kStages = 4;                  // ring depth
constexpr int kStageBytes = 2 * kTile * kRowBytes;
constexpr int kSmemBytes = kStages * kStageBytes;  // 73 728
constexpr int kMinBlocks = 3;                      // per SM
constexpr int kReduceThreads = 256;
constexpr int kReduceGroups = 8;  // threads per output of the second pass

struct Params {
  const void* x[kMaxInputs];
  int channels[kMaxInputs];
  const void* g;
  float* partial;  // splits x split_stride
  int count, hw, f_out, k_total;
  int k_even;             // k_total rounded up to even: a partial row
  long long split_stride;  // floats of one split: f_out * k_even + f_out, even
  int chunk;             // pixels per unit, a multiple of a step's pixels
  int chunks_per_image;  // ceil(hw / chunk)
  int units;             // n * chunks_per_image
  int vec;               // 16-byte copies allowed
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

__device__ __forceinline__ float zero_of(const float*) { return 0.f; }
__device__ __forceinline__ __nv_bfloat16 zero_of(const __nv_bfloat16*) {
  return __float2bfloat16(0.f);
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

// The two bf16 values of one register, added in f32.
__device__ __forceinline__ float pair_sum(uint32_t r) {
  return __uint_as_float(r << 16) + __uint_as_float(r & 0xffff0000u);
}

// One step (128 bytes of pixels) of a warp's kMi * 16 rows of g x kNi * 8
// channels of x: acc[mi][ni] is the m16 x n8 fragment of rows 16*mi.. and
// channels 8*ni.. of the warp's tile. `gs` points at the warp's first row of
// the g tile, `xs` at its first row of the x tile; both are [row][pixel]
// with rows of kRowBytes. With `sums_bias`, bias[mi][h] gathers this lane's
// share of the row sums of g (rows 16*mi + 8*h + lane / 4).
__device__ __forceinline__ void mma_step(float (&acc)[kMi][kNi][4],
                                         float (&bias)[kMi][2],
                                         const float* gs, const float* xs,
                                         int lane, bool sums_bias) {
  constexpr int kS = kRowBytes / 4;
  const int q = lane / 4, t = lane % 4;
  const float* a_ptr = gs + q * kS + t;
  const float* b_ptr = xs + q * kS + t;
#pragma unroll
  for (int ks = 0; ks < kSubSteps; ++ks) {
    uint32_t a_hi[kMi][4], a_lo[kMi][4];
#pragma unroll
    for (int mi = 0; mi < kMi; ++mi) {
      // A fragment of m16n8k8: (q, t), (q + 8, t), (q, t + 4), (q + 8, t + 4).
      const float* p = a_ptr + mi * 16 * kS + ks * 8;
      const float v0 = p[0], v1 = p[8 * kS], v2 = p[4], v3 = p[8 * kS + 4];
      if (sums_bias) {
        bias[mi][0] += v0 + v2;
        bias[mi][1] += v1 + v3;
      }
      split_tf32(v0, a_hi[mi][0], a_lo[mi][0]);
      split_tf32(v1, a_hi[mi][1], a_lo[mi][1]);
      split_tf32(v2, a_hi[mi][2], a_lo[mi][2]);
      split_tf32(v3, a_hi[mi][3], a_lo[mi][3]);
    }
    uint32_t b_hi[kNi][2], b_lo[kNi][2];
#pragma unroll
    for (int ni = 0; ni < kNi; ++ni) {
      // B fragment (col-major): (k = t, n = q), (k = t + 4, n = q), where n
      // is a channel of x (a row of the tile) and k a pixel.
      const float* p = b_ptr + ni * 8 * kS + ks * 8;
      split_tf32(p[0], b_hi[ni][0], b_lo[ni][0]);
      split_tf32(p[4], b_hi[ni][1], b_lo[ni][1]);
    }
    // The three products of every fragment, the small terms first. One
    // term goes to all fragments before the next, so that back-to-back
    // products never wait for each other's accumulator.
#pragma unroll
    for (int term = 0; term < 3; ++term)
#pragma unroll
      for (int mi = 0; mi < kMi; ++mi)
#pragma unroll
        for (int ni = 0; ni < kNi; ++ni) {
          const uint32_t(&a)[4] = term == 0 ? a_lo[mi] : a_hi[mi];
          const uint32_t(&b)[2] = term == 1 ? b_lo[ni] : b_hi[ni];
          mma_tf32(acc[mi][ni], a, b[0], b[1]);
        }
  }
}

__device__ __forceinline__ void mma_step(float (&acc)[kMi][kNi][4],
                                         float (&bias)[kMi][2],
                                         const __nv_bfloat16* gs,
                                         const __nv_bfloat16* xs, int lane,
                                         bool sums_bias) {
  constexpr int kS = kRowBytes / 2;
  const int q = lane / 4, t = lane % 4;
  const __nv_bfloat16* a_ptr = gs + q * kS + 2 * t;
  const __nv_bfloat16* b_ptr = xs + q * kS + 2 * t;
  auto pair = [](const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint32_t*>(p);
  };
#pragma unroll
  for (int ks = 0; ks < kSubSteps; ++ks) {
    uint32_t a[kMi][4];
#pragma unroll
    for (int mi = 0; mi < kMi; ++mi) {
      // A fragment of m16n8k16: rows q, q + 8; pixels 2t, 2t + 1 then + 8.
      const __nv_bfloat16* p = a_ptr + mi * 16 * kS + ks * 16;
      a[mi][0] = pair(p);
      a[mi][1] = pair(p + 8 * kS);
      a[mi][2] = pair(p + 8);
      a[mi][3] = pair(p + 8 * kS + 8);
      if (sums_bias) {
        bias[mi][0] += pair_sum(a[mi][0]) + pair_sum(a[mi][2]);
        bias[mi][1] += pair_sum(a[mi][1]) + pair_sum(a[mi][3]);
      }
    }
#pragma unroll
    for (int ni = 0; ni < kNi; ++ni) {
      const __nv_bfloat16* p = b_ptr + ni * 8 * kS + ks * 16;
      const uint32_t b0 = pair(p), b1 = pair(p + 8);
#pragma unroll
      for (int mi = 0; mi < kMi; ++mi) mma_bf16(acc[mi][ni], a[mi], b0, b1);
    }
  }
}

// What a thread copies in every step: the 16-byte chunk `ch` of the rows
// row0, row0 + kRowsPerRound, ... of the stage (the g rows first, then the x
// rows). Fixed for the block's life; per image only the base pointers move.
constexpr int kChunks = kStepBytes / 16;            // per row
constexpr int kRowsPerRound = kThreads / kChunks;   // rows one round covers
constexpr int kRounds = kTile / kRowsPerRound;      // per operand
static_assert(kTile % kRowsPerRound == 0, "whole rounds per operand");

// Stage one step: rows f0.. of g and rows c0.. of x (both of one image,
// `hw` pixels a row), pixels pb .. pb + a step's, as stage[row][pixel] with
// the g rows first; zeros past f_out, past cn and past p_end. `g_row` and
// `x_row` point at this thread's first row of each operand, pixel 0 of the
// image; `g_rows` / `x_rows` count its rows that exist.
template <typename T>
__device__ __forceinline__ void load_stage(unsigned char* stage,
                                           const T* g_row, const T* x_row,
                                           int g_rows, int x_rows, int hw,
                                           int pb, int p_end, bool vec) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  const int ch = threadIdx.x % kChunks, row0 = threadIdx.x / kChunks;
  const int px = pb + ch * kVec;
  int in_row = p_end - px;  // elements of this chunk inside the unit
  in_row = in_row < 0 ? 0 : (in_row > kVec ? kVec : in_row);
  unsigned char* dst0 = stage + row0 * kRowBytes + ch * 16;
  const size_t round_stride = static_cast<size_t>(kRowsPerRound) * hw;
#pragma unroll
  for (int it = 0; it < 2 * kRounds; ++it) {
    const bool is_x = it >= kRounds;
    const int round = is_x ? it - kRounds : it;
    const int valid = round < (is_x ? x_rows : g_rows) ? in_row : 0;
    const T* base = is_x ? x_row : g_row;
    const T* src = valid ? base + round * round_stride + px : base;
    T* dst = reinterpret_cast<T*>(dst0 + it * kRowsPerRound * kRowBytes);
    if (vec) {
      cp_async16(dst, src, valid * static_cast<int>(sizeof(T)));
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) dst[j] = j < valid ? src[j] : zero_of(src);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    concat_dw_kernel(const Params p) {
  constexpr int kStepP = kStepBytes / static_cast<int>(sizeof(T));
  extern __shared__ __align__(16) unsigned char smem[];

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

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int warp_f = (warp / 2) * (kMi * 16), warp_c = (warp % 2) * (kNi * 8);
  const int q = lane / 4, t = lane % 4;
  const bool sums_bias = blockIdx.x == 0 && warp_c == 0;
  const T* const g_all = static_cast<const T*>(p.g);
  const T* const x_all = static_cast<const T*>(p.x[part]);
  const bool vec = p.vec != 0;

  // The producer's position: unit, next pixel, end of the unit.
  int pr_unit = blockIdx.y, pr_pb = 0, pr_end = 0;
  auto open_unit = [&](int unit, int& pb, int& end) {
    pb = (unit % p.chunks_per_image) * p.chunk;
    end = min(p.hw, pb + p.chunk);
  };
  if (pr_unit < p.units) open_unit(pr_unit, pr_pb, pr_end);
  // This thread's rows of a stage: row0, row0 + kRowsPerRound, ... of each
  // operand; how many of them exist, and where the first one starts.
  const int row0 = threadIdx.x / kChunks;
  auto rounds_inside = [&](int rows_left) {  // rows row0 + i * kRowsPerRound
    return rows_left <= row0 ? 0
                             : (rows_left - row0 + kRowsPerRound - 1) /
                                   kRowsPerRound;
  };
  const int g_rows = rounds_inside(p.f_out - f0);
  const int x_rows = rounds_inside(cn - c0);
  const size_t g_first = static_cast<size_t>(g_rows ? f0 + row0 : 0) * p.hw;
  const size_t x_first = static_cast<size_t>(x_rows ? c0 + row0 : 0) * p.hw;
  auto produce = [&](int slot) {
    if (pr_unit < p.units) {
      const size_t image = pr_unit / p.chunks_per_image;
      load_stage<T>(smem + slot * kStageBytes,
                    g_all + image * p.f_out * p.hw + g_first,
                    x_all + image * cn * p.hw + x_first, g_rows, x_rows, p.hw,
                    pr_pb, pr_end, vec);
      pr_pb += kStepP;
      if (pr_pb >= pr_end) {
        pr_unit += gridDim.y;
        if (pr_unit < p.units) open_unit(pr_unit, pr_pb, pr_end);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) produce(s);

  float acc[kMi][kNi][4] = {};
  float bias[kMi][2] = {};
  int slot = 0, fill = kStages - 1;  // ring slots: to compute, to fill
  for (int unit = blockIdx.y; unit < p.units; unit += gridDim.y) {
    int pb, p_end;
    open_unit(unit, pb, p_end);
    for (; pb < p_end; pb += kStepP) {
      cp_async_wait<kStages - 2>();  // this thread's copies of `slot` landed
      __syncthreads();  // everyone's did, and everyone left slot `fill`
      produce(fill);
      const unsigned char* stage = smem + slot * kStageBytes;
      mma_step(acc, bias,
               reinterpret_cast<const T*>(stage + warp_f * kRowBytes),
               reinterpret_cast<const T*>(stage +
                                          (kTile + warp_c) * kRowBytes),
               lane, sums_bias);
      slot = slot + 1 == kStages ? 0 : slot + 1;
      fill = fill + 1 == kStages ? 0 : fill + 1;
    }
  }
  cp_async_wait<0>();

  // The partial tile: fragment (mi, ni) holds rows q, q + 8 and the channel
  // pair 2t, 2t + 1. A pair goes out as one 8-byte store where it is aligned
  // (every offset but col0 is even).
  float* out = p.partial + static_cast<size_t>(blockIdx.y) * p.split_stride;
  const bool pairs = col0 % 2 == 0;
#pragma unroll
  for (int mi = 0; mi < kMi; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int f = f0 + warp_f + mi * 16 + h * 8 + q;
      if (f >= p.f_out) continue;
      float* row = out + static_cast<size_t>(f) * p.k_even + col0;
#pragma unroll
      for (int ni = 0; ni < kNi; ++ni) {
        const int c = c0 + warp_c + ni * 8 + 2 * t;
        const float v0 = acc[mi][ni][2 * h], v1 = acc[mi][ni][2 * h + 1];
        if (pairs && c + 1 < cn) {
          *reinterpret_cast<float2*>(row + c) = make_float2(v0, v1);
        } else {
          if (c < cn) row[c] = v0;
          if (c + 1 < cn) row[c + 1] = v1;
        }
      }
    }
  if (sums_bias) {
#pragma unroll
    for (int mi = 0; mi < kMi; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v = bias[mi][h];  // this lane's pixels: add the four lanes'
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        const int f = f0 + warp_f + mi * 16 + h * 8 + q;
        if (t == 0 && f < p.f_out)
          out[static_cast<size_t>(p.f_out) * p.k_even + f] = v;
      }
  }
}

// The second pass: element j of dW (then of db) is the sum of the splits'
// partials, in a fixed order: kReduceGroups threads take the splits group,
// group + kReduceGroups, ... of one element each, and the groups' sums are
// added in the order of the groups.
__global__ void __launch_bounds__(kReduceThreads)
    concat_dw_reduce_kernel(const float* __restrict__ partial,
                            float* __restrict__ dw, float* __restrict__ db,
                            int splits, int f_out, int k_total, int k_even,
                            long long split_stride) {
  constexpr int kPerBlock = kReduceThreads / kReduceGroups;
  __shared__ float sums[kReduceGroups][kPerBlock];
  const int lane = threadIdx.x % kPerBlock, group = threadIdx.x / kPerBlock;
  const int j = blockIdx.x * kPerBlock + lane;
  const int n_dw = f_out * k_total;
  const bool inside = j < n_dw + f_out;
  float sum = 0.f;
  if (inside) {
    const float* src =
        j < n_dw ? partial + static_cast<size_t>(j / k_total) * k_even +
                       j % k_total
                 : partial + static_cast<size_t>(f_out) * k_even + (j - n_dw);
#pragma unroll 8
    for (int s = group; s < splits; s += kReduceGroups)
      sum += src[s * split_stride];
  }
  sums[group][lane] = sum;
  __syncthreads();
  if (group != 0 || !inside) return;
#pragma unroll
  for (int other = 1; other < kReduceGroups; ++other) sum += sums[other][lane];
  if (j < n_dw)
    dw[j] = sum;
  else
    db[j - n_dw] = sum;
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

template <typename T>
cudaError_t launch(Params& p, const dim3& grid, float* dw, float* db,
                   cudaStream_t stream) {
  p.vec = p.hw * sizeof(T) % 16 == 0 && aligned16(p.g);
  for (int i = 0; i < p.count; ++i) p.vec = p.vec && aligned16(p.x[i]);
  auto kernel = concat_dw_kernel<T>;
  // Dynamic shared memory above 48 KB has to be asked for, once per device
  // (a race between host threads only repeats the call).
  constexpr int kDevices = 64;
  static bool allowed[kDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= kDevices || !allowed[device]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return err;
    if (device >= 0 && device < kDevices) allowed[device] = true;
  }
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int outputs = p.f_out * p.k_total + p.f_out;
  constexpr int kPerBlock = kReduceThreads / kReduceGroups;
  concat_dw_reduce_kernel<<<(outputs + kPerBlock - 1) / kPerBlock,
                            kReduceThreads, 0, stream>>>(
      p.partial, dw, db, static_cast<int>(grid.y), p.f_out, p.k_total,
      p.k_even, p.split_stride);
  return cudaGetLastError();
}

}  // namespace

// C entry point (bound with ctypes). dtype: 0 = float32, 1 = bfloat16.
// xs[i] is (n, channels[i], hw) contiguous, g is (n, f_out, hw) contiguous,
// all of the one dtype; dw is float32 (f_out, sum channels), db float32
// (f_out,), both written in full; partial is float32 scratch of splits *
// split_stride elements, split_stride even and at least f_out * (sum
// channels rounded up to even + 1). chunk is the
// number of pixels of one image that one unit of work sums over (a multiple
// of 64); splits <= n * ceil(hw / chunk). Launches two kernels on `stream`
// and returns the first cudaError_t (0 on success); it does not synchronise.
extern "C" int vsr_concat_dw(const void* const* xs, const int* channels,
                             int count, const void* g, void* partial, void* dw,
                             void* db, int n, int hw, int f_out, int chunk,
                             int splits, long long split_stride, int dtype,
                             void* stream) {
  if (count < 1 || count > kMaxInputs || n < 1 || hw < 1 || f_out < 1 ||
      chunk < 64 || chunk % 64 != 0 || splits < 1 || splits > 65535)
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
      splits > units || f_tiles > 65535 ||
      f_out * (k_total + 2) > 2147483647LL || split_stride % 2 != 0 ||
      split_stride < f_out * ((k_total + 1) / 2 * 2 + 1))
    return static_cast<int>(cudaErrorInvalidValue);
  p.count = count;
  p.g = g;
  p.partial = static_cast<float*>(partial);
  p.hw = hw;
  p.f_out = f_out;
  p.k_total = static_cast<int>(k_total);
  p.k_even = (p.k_total + 1) / 2 * 2;
  p.split_stride = split_stride;
  p.chunk = chunk;
  p.chunks_per_image = static_cast<int>(chunks_per_image);
  p.units = static_cast<int>(units);
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(splits),
                  static_cast<unsigned>(f_tiles));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* const dw_f = static_cast<float*>(dw);
  float* const db_f = static_cast<float*>(db);
  if (dtype == 0) return static_cast<int>(launch<float>(p, grid, dw_f, db_f, s));
  if (dtype == 1)
    return static_cast<int>(launch<__nv_bfloat16>(p, grid, dw_f, db_f, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
