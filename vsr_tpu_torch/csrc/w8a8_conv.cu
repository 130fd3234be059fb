// W8A8 convolution on the int8 tensor cores: the body of
// vsr_tpu/quantize.py:_w8a8_conv (quantize the activations, s8 x s8 -> s32
// convolution, float dequantization + bias + cast) in one launch.
//
// It replaces no Pallas kernel: the JAX package leaves this convolution to
// XLA (vsr_tpu/quantize.py:241-322, preferred_element_type=int32), and
// PyTorch on CUDA reaches no int8 convolution. The wrapper
// (vsr_tpu_torch/ops/w8a8_conv.py) quantizes the dense weights per output
// channel at each call, repacks them tap-major, (F, kd, kh, kw, C/g) with
// the channels padded to a multiple of 32, chooses the plan (kernel, tiles,
// stages) from the geometry, and hands over the activation scale as a
// device pointer (static or computed on the card), so there is no host
// sync.
//
// What bounds it on an H100: at the zoo's widths (64-256 channels, 3x3 or
// 3x3x3) a conv does 2 x 576-6912 int8 operations per output element
// against ~8 bytes of float activations in and out, so it is bound by
// memory (EDSR's 64 -> 64 3x3 over 300 frames of 96 x 96: 1.42 GB, 0.42 ms
// at 3.35 TB/s, against 0.10 ms of int8 operations at 1,979 TOPS). The
// design moves each activation once from memory, quantizes it once, and
// keeps loads, quantization, products and stores running at the same time.
//
// The patch kernel (every geometry whose stages fit in shared memory; the
// zoo's all do):
// - The M tile is a box of 128 output pixels (tz x ty x tx, chosen by the
//   wrapper from the output's shape), the N tile 32, 64 or 128 output
//   channels (a template parameter chosen from F / groups: DUF's growth
//   convs take 32, EDSR and DRF 64). One block an SM walks over tiles
//   persistently (blockIdx.x + i * gridDim.x, neighbours in flight
//   together so halos come from L2); blockIdx.y picks the N tile and group.
// - Warp roles. 8 producer warps, in two groups of 4 that take every other
//   chunk, fill a ring of 2-4 stages; 8 consumer warps (4 along M x 2 along
//   N) take the stages in order for the products and write the outputs.
//   A stage's full and empty mbarriers hand it over, so one tile's stores,
//   the next chunks' loads and quantization, and the products overlap.
// - A stage is one chunk of 32 input channels of a tile: its input patch
//   with the halo, ((tz-1) sd + kd) x ((ty-1) sh + kh) x ((tx-1) sw + kw)
//   pixels, zero outside the input (the zero padding: quantize(0) = 0),
//   each element loaded once, quantized once (round half to even of the
//   IEEE quotient, as the twin, mostly without a division: quantize16) and
//   stored as int8 [z][y][x][c32]: 32 bytes a pixel, the two 16-byte halves
//   swapped on pixels 4-7 of every 8 so that ldmatrix over 8 neighbouring
//   pixels hits every bank once. Where input rows are a multiple of 4
//   elements (the zoo's), one 16-byte (float32) or 8-byte (bfloat16) load
//   brings 4 neighbouring columns of a channel; elsewhere plain 4- or 2-byte
//   loads do, coalesced along x, so any width, alignment and type is taken
//   (TMA would want 16-byte row strides and one box a chunk).
// - The reduction runs tap by tap, channels innermost: K = (kz, ky, kx, c).
//   A K step of 32 is 32 channels of one tap, and the A rows of tap (kz,
//   ky, kx) are the patch shifted by it (row of output pixel (z, y, x):
//   patch pixel (z sd + kz, y sh + ky, x sw + kx)). ldmatrix takes one row
//   address per lane, so shifts and strides cost an add.
// - Weights: in the same swizzled 32-byte rows, staged by cp.async once per
//   block for all its tiles where the N tile's (taps x C/g x N) fit
//   ("resident": EDSR's 64 x 576 is 36 KB), else with each stage, the
//   chunk's taps ("streamed").
// - Products: mma.sync.m16n8k32 s8 x s8 -> s32, the next tap's fragments
//   loaded before this tap's products. wgmma is not used: its A operand
//   from registers would still come through the same per-lane ldmatrix
//   (shifted rows are no shared-memory descriptor), with a fence and a
//   wait per tap, and the products are not what bounds the kernel: the
//   int8 operations of EDSR's main conv take 0.10 ms at the tensor cores'
//   full rate, against the 1.16 ms the kernel takes there on an H100
//   (chip_smoke.py, phase 13a), whose rest is loads, quantization and
//   stores.
// - Epilogue: float(acc) * (ws[c] * xs), then + bias[c], each with an _rn
//   intrinsic (no fused multiply-add), in the twin's order; then the cast.
//   The accumulators go through shared memory 64 channels at a time, and
//   each channel's rows of the tile are written along x by neighbouring
//   threads, four outputs (16 or 8 bytes) a store where rows are a
//   multiple of 4 long.
//
// The gather kernel is the general path for the geometries whose stages do
// not fit in shared memory (a large stride times a large kernel, or wide
// N tiles of many taps): an implicit GEMM over 64 x 64 tiles that quantizes
// while it gathers, one K step of 32 channels of one tap at a time, on the
// same repacked weights. The zoo never takes it; the wrapper chooses it by
// geometry.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kConsumers = 256;  // 8 warps: products and stores
constexpr int kGroup = 128;      // a producer group: 4 warps
constexpr int kBlock = kConsumers + 2 * kGroup;
constexpr int kTileM = 128;      // output pixels per tile
constexpr int kStageLd = 132;    // int32s per staged channel row: 128 + 4,
                                 // conflict-free fragment stores
constexpr int kBarBytes = 128;   // the stages' mbarriers (at most 4 + 4)
constexpr int kStageCh = 64;     // channels staged a pass
constexpr int kStageBytes = kStageCh * kStageLd * 4;
constexpr int kChannelBytes = 2 * 128 * 4;  // ws * xs and bias of N tile
constexpr int kItems = 4;        // patch items (16 channels of one pixel) a
                                 // producer thread holds per round

struct Geometry {
  int n, c, d, h, w;      // input
  int f, groups, cg, fg;  // output channels, groups, per-group channels
  int kd, kh, kw;         // kernel
  int sd, sh, sw;         // strides
  int pd, ph, pw;         // paddings
  int od, oh, ow;         // output
  int taps, cpad;         // kd * kh * kw; cg padded to a multiple of 32
};

struct Plan {
  int tz, ty, tx;        // output tile, tz * ty * tx = 128, powers of two
  int ltx, ltxy;         // log2(tx), log2(tx * ty)
  int pz, py, px, p;     // the tile's input patch, p = pz * py * px
  int ntz, nty, ntx;     // tiles along each output axis
  int tiles;             // n * ntz * nty * ntx
  int nq;                // chunks of 32 channels
  int resident;          // 1: the N tile's weights stay for all tiles
  int stages;            // ring stages (2-4)
  int stage_bytes;       // patch (+ the chunk's weights when streamed)
  int rounds;            // rounds of kItems * kGroup patch items
  int vec;               // 1: the vector path of the patch loads
  int xo, nv4;           // its column offset, 4-column groups a patch row
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ int quantize(float v, float xs) {
  const int q = __float2int_rn(__fdiv_rn(v, xs));
  return min(max(q, -127), 127);
}

// The IEEE quotient, out of line: the rare case of quantize16.
__device__ __noinline__ float quotient_exact(float v, float xs) {
  return __fdiv_rn(v, xs);
}

// Sixteen elements as float32 bits, quantized as quantize() does, packed
// into 16 bytes, with no conversion instruction and no branch on the
// common path:
// - The quotient is taken as v * (1 / xs), with 1 / xs correctly rounded:
//   within 1.5 * 2^-23 of v / xs relative, 2.3e-5 below 128 in magnitude,
//   so it rounds to the same integer as the IEEE quotient unless it lies
//   within 1e-4 of a half-integer; only there (about 2e-4 of the values)
//   is the division done, out of line. Beyond 128 both clamp to +-127.
// - x + 1.5 * 2^23 rounds x (|x| < 2^22) to an integer, half to even, in
//   the low mantissa bits: subtracting it back gives rint(x) for the test,
//   and for x clamped to [-127, 127] the low byte of its bits is the int8.
//   (For |x| >= 2^22 the test may go either way: the clamp decides.)
__device__ __forceinline__ uint4 quantize16(const uint32_t (&bits)[16],
                                            float xs, float inv) {
  constexpr float kRound = 12582912.f;  // 1.5 * 2^23
  float q[16];
  bool near = false;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    q[j] = __fmul_rn(__uint_as_float(bits[j]), inv);
    const float r = __fsub_rn(__fadd_rn(q[j], kRound), kRound);
    near |= fabsf(fabsf(__fsub_rn(q[j], r)) - 0.5f) < 1e-4f;
  }
  if (near) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float r = __fsub_rn(__fadd_rn(q[j], kRound), kRound);
      if (fabsf(fabsf(__fsub_rn(q[j], r)) - 0.5f) < 1e-4f) {
        q[j] = quotient_exact(__uint_as_float(bits[j]), xs);
      }
    }
  }
  uint32_t b[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    b[j] = __float_as_uint(
        __fadd_rn(fminf(fmaxf(q[j], -127.f), 127.f), kRound));
  }
  uint32_t w[4];
#pragma unroll
  for (int wd = 0; wd < 4; ++wd) {
    w[wd] = __byte_perm(__byte_perm(b[4 * wd], b[4 * wd + 1], 0x0040),
                        __byte_perm(b[4 * wd + 2], b[4 * wd + 3], 0x0040),
                        0x5410);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The raw bits of one element: float32's 32 bits, bfloat16's 16 (widened
// to a float32 at use, in quantize16, so that nothing waits on the load
// here). volatile keeps a round's loads together, ahead of their use.
__device__ __forceinline__ uint32_t load_raw(const float* p) {
  uint32_t v;
  asm volatile("ld.global.nc.b32 %0, [%1];\n" : "=r"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ uint32_t load_raw(const __nv_bfloat16* p) {
  uint32_t v;
  asm volatile("ld.global.nc.u16 %0, [%1];\n" : "=r"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :
               : "r"(smem_u32(bar)), "r"(count)
               : "memory");
}
// Arrive with release semantics: this thread's shared-memory writes before
// it are seen by a thread whose wait sees the phase complete.
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :
               : "r"(smem_u32(bar))
               : "memory");
}
// Wait until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n"
      :
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
}
// The consumer warps' own barrier (the producers run on).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// Byte offset of half h (16 bytes) of 32-byte row r in a swizzled tile.
__device__ __forceinline__ int row_half(int r, int h) {
  return r * 32 + ((h ^ ((r >> 2) & 1)) << 4);
}

// float(acc) * (ws * xs) + bias, with the twin's roundings; then the cast.
__device__ __forceinline__ void store_out(void* out, long long o, int v,
                                          int out_kind, float scale,
                                          bool has_bias, float bias) {
  if (out_kind == 2) {
    static_cast<int*>(out)[o] = v;
    return;
  }
  float y = __fmul_rn(__int2float_rn(v), scale);
  if (has_bias) y = __fadd_rn(y, bias);
  if (out_kind == 0) {
    static_cast<float*>(out)[o] = y;
  } else {
    static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(y);
  }
}

struct Origin {
  int n, z, y, x;  // image and first output pixel of a tile
};

__device__ __forceinline__ Origin tile_origin(int t, const Plan& pl) {
  Origin o;
  o.x = t % pl.ntx * pl.tx;
  t /= pl.ntx;
  o.y = t % pl.nty * pl.ty;
  t /= pl.nty;
  o.z = t % pl.ntz * pl.tz;
  o.n = t / pl.ntz;
  return o;
}

// One round of a chunk's patch, by thread lt of a producer group: item i =
// 16 channels (half h) of patch pixel pix. fetch_patch loads the raw
// elements, commit_patch quantizes and stores them.
template <typename T>
__device__ __forceinline__ void fetch_patch(uint32_t (&raw)[kItems][16],
                                            const T* __restrict__ x,
                                            const Geometry& g, const Plan& pl,
                                            const Origin& o, int group, int q,
                                            int round, int lt) {
  const long long plane = (long long)g.d * g.h * g.w;
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
#pragma unroll
    for (int j = 0; j < 16; ++j) raw[it][j] = 0;
    const int i = (round * kItems + it) * kGroup + lt;
    if (i >= 2 * pl.p) continue;
    const int h = i >= pl.p;
    const int pix = i - h * pl.p;
    const int pyx = pl.py * pl.px;
    const int pz = pix / pyx, r = pix - pz * pyx;
    const int py = r / pl.px, px = r - py * pl.px;
    const int iz = o.z * g.sd - g.pd + pz;
    const int iy = o.y * g.sh - g.ph + py;
    const int ix = o.x * g.sw - g.pw + px;
    if (iz < 0 || iz >= g.d || iy < 0 || iy >= g.h || ix < 0 || ix >= g.w) {
      continue;
    }
    const int cb = q * 32 + h * 16;
    const int nv = min(16, g.cg - cb);
    const T* src = x + ((long long)o.n * g.c + (long long)group * g.cg + cb) *
                           plane +
                   ((long long)iz * g.h + iy) * g.w + ix;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if (j < nv) raw[it][j] = load_raw(src + j * plane);
    }
  }
}

template <typename T>
__device__ __forceinline__ void commit_patch(
    const uint32_t (&raw)[kItems][16], uint8_t* abuf, const Plan& pl,
    float xs, float inv, int round, int lt) {
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const int i = (round * kItems + it) * kGroup + lt;
    if (i >= 2 * pl.p) continue;
    const int h = i >= pl.p;
    const int pix = i - h * pl.p;
    uint32_t bits[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      bits[j] = raw[it][j] << (sizeof(T) == 2 ? 16 : 0);
    }
    *reinterpret_cast<uint4*>(abuf + row_half(pix, h)) =
        quantize16(bits, xs, inv);
  }
}

// The vector path (rows of a multiple of 4 elements, 16- or 8-byte aligned;
// the patch's first column then sits xo = (-pw) mod 4 columns past a
// multiple of 4 in every tile): item i = 16 channels (half h) of 4
// neighbouring input columns, one 16-byte (float32) or 8-byte (bfloat16)
// load a channel. The patch in shared memory is as on the scalar path; the
// loaded columns outside it are dropped.
template <typename T>
__device__ __forceinline__ void load_raw4(uint32_t (&r)[4], const T* p) {
  if (sizeof(T) == 4) {
    asm volatile("ld.global.nc.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "l"(p));
  } else {
    asm volatile("ld.global.nc.v2.b32 {%0, %1}, [%2];\n"
                 : "=r"(r[0]), "=r"(r[1])
                 : "l"(p));
  }
}

template <typename T>
__device__ __forceinline__ void fetch_patch4(uint32_t (&raw)[16][4],
                                             const T* __restrict__ x,
                                             const Geometry& g,
                                             const Plan& pl, const Origin& o,
                                             int group, int q, int i) {
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) raw[j][e] = 0;
  const int per_h = pl.pz * pl.py * pl.nv4;
  if (i >= 2 * per_h) return;
  const int h = i >= per_h;
  const int r = i - h * per_h;
  const int row = r / pl.nv4, k = r - row * pl.nv4;
  const int pz = row / pl.py, py = row - pz * pl.py;
  const int iz = o.z * g.sd - g.pd + pz;
  const int iy = o.y * g.sh - g.ph + py;
  const int ix = o.x * g.sw - g.pw - pl.xo + 4 * k;
  if (iz < 0 || iz >= g.d || iy < 0 || iy >= g.h || ix < 0 || ix >= g.w) {
    return;
  }
  const long long plane = (long long)g.d * g.h * g.w;
  const int cb = q * 32 + h * 16;
  const int nv = min(16, g.cg - cb);
  const T* src = x + ((long long)o.n * g.c + (long long)group * g.cg + cb) *
                         plane +
                 ((long long)iz * g.h + iy) * g.w + ix;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    if (j < nv) load_raw4<T>(raw[j], src + j * plane);
  }
}

template <typename T>
__device__ __forceinline__ void commit_patch4(const uint32_t (&raw)[16][4],
                                              uint8_t* abuf, const Plan& pl,
                                              float xs, float inv, int i) {
  const int per_h = pl.pz * pl.py * pl.nv4;
  if (i >= 2 * per_h) return;
  const int h = i >= per_h;
  const int r = i - h * per_h;
  const int row = r / pl.nv4, k = r - row * pl.nv4;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int col = 4 * k + e - pl.xo;
    if (col < 0 || col >= pl.px) continue;
    uint32_t bits[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      bits[j] = sizeof(T) == 4 ? raw[j][e]
                               : (e & 1 ? raw[j][e >> 1] & 0xffff0000u
                                        : raw[j][e >> 1] << 16);
    }
    *reinterpret_cast<uint4*>(abuf + row_half(row * pl.px + col, h)) =
        quantize16(bits, xs, inv);
  }
}

// cp.async of the weight slabs (chunk q, taps [0, taps)) of the block's N
// tile into consecutive slabs at wbuf, by `count` threads from lt: slab =
// kBN rows x 32 bytes.
template <int kBN>
__device__ __forceinline__ void load_weights(uint8_t* wbuf,
                                             const int8_t* __restrict__ wq,
                                             const Geometry& g, int group,
                                             int n0, int q, int lt,
                                             int count) {
  const int pieces = g.taps * kBN * 2;
  for (int i = lt; i < pieces; i += count) {
    const int slab = i / (kBN * 2), rem = i - slab * (kBN * 2);
    const int n = rem >> 1, h = rem & 1;
    const bool ok = n0 + n < g.fg;
    const int8_t* src =
        ok ? wq + ((long long)(group * g.fg + n0 + n) * g.taps + slab) *
                      g.cpad +
                 q * 32 + h * 16
           : wq;
    cp_async16(wbuf + slab * kBN * 32 + row_half(n, h), src, ok);
  }
}

// A consumer warp's fragments of tap t, whose patch shift is `shift`: its
// two m16 tiles of the patch shifted by the tap, and its kBN / 2 columns of
// the tap's weight slab.
template <int kBN>
__device__ __forceinline__ void load_fragments(
    uint32_t (&a)[2][4], uint32_t (&b)[kBN / 32][4], const uint8_t* a_tile,
    const uint8_t* w_tile, const int (&a_pix)[2], int a_half,
    const int (&b_off)[kBN / 32], int t, int shift) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    ldmatrix_x4(a[i], a_tile + row_half(a_pix[i] + shift, a_half));
  }
  const uint8_t* slab = w_tile + t * kBN * 32;
#pragma unroll
  for (int j = 0; j < kBN / 32; ++j) ldmatrix_x4(b[j], slab + b_off[j]);
}

// Four neighbouring outputs along x of one channel, as one 16-byte (float32,
// int32) or 8-byte (bfloat16) store; o is a multiple of 4.
__device__ __forceinline__ void store_out4(void* out, long long o, int4 v,
                                           int out_kind, float scale,
                                           bool has_bias, float bias) {
  if (out_kind == 2) {
    *reinterpret_cast<int4*>(static_cast<int*>(out) + o) = v;
    return;
  }
  float y[4] = {__fmul_rn(__int2float_rn(v.x), scale),
                __fmul_rn(__int2float_rn(v.y), scale),
                __fmul_rn(__int2float_rn(v.z), scale),
                __fmul_rn(__int2float_rn(v.w), scale)};
  if (has_bias) {
#pragma unroll
    for (int k = 0; k < 4; ++k) y[k] = __fadd_rn(y[k], bias);
  }
  if (out_kind == 0) {
    *reinterpret_cast<float4*>(static_cast<float*>(out) + o) =
        make_float4(y[0], y[1], y[2], y[3]);
  } else {
    uint2 pk;
    pk.x = (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(y[0])) |
           ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(y[1])) << 16);
    pk.y = (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(y[2])) |
           ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(y[3])) << 16);
    *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(out) + o) = pk;
  }
}

template <typename T, int kBN>
__global__ void __launch_bounds__(kBlock, 1)
    w8a8_patch_kernel(const T* __restrict__ x, const int8_t* __restrict__ wq,
                      const float* __restrict__ ws,
                      const float* __restrict__ bias,
                      const float* __restrict__ xs_ptr, void* __restrict__ out,
                      int out_kind, Geometry g, Plan pl) {
  constexpr int kNT = kBN / 16;  // n8 tiles of a warp (kBN / 2 columns)
  extern __shared__ __align__(128) uint8_t smem[];
  uint64_t* const full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* const empty = full + pl.stages;
  int* const stage = reinterpret_cast<int*>(smem + kBarBytes);
  float* const e_scale =
      reinterpret_cast<float*>(smem + kBarBytes + kStageBytes);
  float* const e_bias = e_scale + 128;
  uint8_t* const ring = smem + kBarBytes + kStageBytes + kChannelBytes;
  uint8_t* const wres = ring + pl.stages * pl.stage_bytes;

  const int tid = threadIdx.x;
  const int group = blockIdx.y % g.groups;
  const int n0 = (blockIdx.y / g.groups) * kBN;
  const float xs = *xs_ptr;

  if (tid == 0) {
    for (int s = 0; s < pl.stages; ++s) {
      mbar_init(&full[s], kGroup);
      mbar_init(&empty[s], kConsumers);
    }
  }
  for (int n = tid; n < kBN; n += kBlock) {
    const bool ok = n0 + n < g.fg;
    const int fc = group * g.fg + (ok ? n0 + n : 0);
    e_scale[n] = __fmul_rn(ws[fc], xs);
    e_bias[n] = bias != nullptr ? bias[fc] : 0.f;
  }
  if (pl.resident) {
    for (int q = 0; q < pl.nq; ++q) {
      load_weights<kBN>(wres + q * g.taps * kBN * 32, wq, g, group, n0, q, tid,
                        kBlock);
    }
    cp_async_wait_all();
  }
  __syncthreads();

  // The block's chunks, tile-major: step k is chunk k % nq of its tile
  // k / nq; it goes through ring stage k % stages.
  const int mine = blockIdx.x < pl.tiles
                       ? (pl.tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1
                       : 0;
  const int steps = mine * pl.nq;

  if (tid >= kConsumers) {
    // Producers: group pg fills the steps k = pg, pg + 2, ...
    const int pt = tid - kConsumers, pg = pt / kGroup, lt = pt % kGroup;
    const float inv = __frcp_rn(xs);
    for (int k = pg; k < steps; k += 2) {
      const int s = k % pl.stages;
      mbar_wait(&empty[s], ((k / pl.stages) & 1) ^ 1);
      const int q = k % pl.nq;
      const Origin o = tile_origin(blockIdx.x + k / pl.nq * gridDim.x, pl);
      uint8_t* dst = ring + s * pl.stage_bytes;
      if (!pl.resident) {
        load_weights<kBN>(dst + pl.p * 32, wq, g, group, n0, q, lt, kGroup);
      }
      if (pl.vec) {
#pragma unroll 1
        for (int r = 0; r < pl.rounds; ++r) {
          uint32_t raw[16][4];
          fetch_patch4<T>(raw, x, g, pl, o, group, q, r * kGroup + lt);
          commit_patch4<T>(raw, dst, pl, xs, inv, r * kGroup + lt);
        }
      } else {
#pragma unroll 1
        for (int r = 0; r < pl.rounds; ++r) {
          uint32_t raw[kItems][16];
          fetch_patch<T>(raw, x, g, pl, o, group, q, r, lt);
          commit_patch<T>(raw, dst, pl, xs, inv, r, lt);
        }
      }
      if (!pl.resident) cp_async_wait_all();
      mbar_arrive(&full[s]);
    }
    return;
  }

  // Consumers: the products of each stage, the epilogue after a tile's last.
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;
  const int gid = lane >> 2, tig = lane & 3;
  // Patch pixel of each lane's ldmatrix row (tap (0, 0, 0)) in its two m16
  // tiles, and each lane's byte offset of its B rows in a weight slab.
  int a_pix[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = wm * 32 + i * 16 + (lane & 15);
    const int mz = m >> pl.ltxy, my = (m >> pl.ltx) & (pl.ty - 1),
              mx = m & (pl.tx - 1);
    a_pix[i] = (mz * g.sd * pl.py + my * g.sh) * pl.px + mx * g.sw;
  }
  const int a_half = lane >> 4;
  int b_off[kNT / 2];
#pragma unroll
  for (int j = 0; j < kNT / 2; ++j) {
    const int n = wn * (kBN / 2) + j * 16 + (lane & 7) + ((lane >> 4) << 3);
    b_off[j] = row_half(n, (lane >> 3) & 1);
  }
  const long long out_plane = (long long)g.od * g.oh * g.ow;
  // This thread's output pixels in the epilogue: with rows of a multiple of
  // 4, the four from 4 (tid % 32) on (channels tid / 32 + 8 k), else pixel
  // tid % 128 (channels tid / 128 + 2 k).
  const bool vec = g.ow % 4 == 0;
  const int em = vec ? (tid & 31) * 4 : tid & (kTileM - 1);
  const int ec = vec ? tid >> 5 : tid >> 7;
  const int estep = vec ? kConsumers / 32 : kConsumers / kTileM;

  int acc[2][kNT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  for (int k = 0; k < steps; ++k) {
    const int s = k % pl.stages, q = k % pl.nq;
    mbar_wait(&full[s], (k / pl.stages) & 1);
    const uint8_t* a_tile = ring + s * pl.stage_bytes;
    const uint8_t* w_tile =
        pl.resident ? wres + q * g.taps * kBN * 32 : a_tile + pl.p * 32;
    // The fragments of tap t + 1 are loaded before the products of tap t.
    // The patch shift of tap t + 1, (kz * py + ky) * px + kx, stepped.
    uint32_t a[2][4], b[kNT / 2][4];
    load_fragments<kBN>(a, b, a_tile, w_tile, a_pix, a_half, b_off, 0, 0);
    int kx = 0, ky = 0, shift = 0;
    for (int t = 0; t < g.taps; ++t) {
      if (t + 1 < g.taps) {
        ++shift;
        if (++kx == g.kw) {
          kx = 0;
          shift += pl.px - g.kw;
          if (++ky == g.kh) {
            ky = 0;
            shift += (pl.py - g.kh) * pl.px;
          }
        }
      }
      uint32_t an[2][4], bn[kNT / 2][4];
      load_fragments<kBN>(an, bn, a_tile, w_tile, a_pix, a_half, b_off,
                          min(t + 1, g.taps - 1), shift);
#pragma unroll
      for (int j = 0; j < kNT / 2; ++j) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_s8(acc[i][2 * j], a[i], b[j][0], b[j][1]);
          mma_s8(acc[i][2 * j + 1], a[i], b[j][2], b[j][3]);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) a[i][e] = an[i][e];
#pragma unroll
      for (int j = 0; j < kNT / 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) b[j][e] = bn[j][e];
    }
    mbar_arrive(&empty[s]);
    if (q + 1 < pl.nq) continue;

    // Epilogue, 64 channels a pass: fragments -> stage -> rows along x.
    const Origin o = tile_origin(blockIdx.x + k / pl.nq * gridDim.x, pl);
    const int ez = o.z + (em >> pl.ltxy);
    const int ey = o.y + ((em >> pl.ltx) & (pl.ty - 1));
    const int ex = o.x + (em & (pl.tx - 1));
    const bool e_ok = ez < g.od && ey < g.oh && ex < g.ow;
    const long long e_pix = ((long long)ez * g.oh + ey) * g.ow + ex;
    constexpr int kPasses = kBN > kStageCh ? kBN / kStageCh : 1;
#pragma unroll
    for (int pass = 0; pass < kPasses; ++pass) {
      consumers_sync();  // the stage's last readers are done
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int col = wn * (kBN / 2) + j * 8;
        if (col / kStageCh != pass) continue;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int m = wm * 32 + i * 16 + gid + (e >> 1) * 8;
            const int c = col % kStageCh + tig * 2 + (e & 1);
            stage[c * kStageLd + m] = acc[i][j][e];
          }
        }
      }
      consumers_sync();
      if (e_ok) {
        for (int c = ec; c < min(kBN, kStageCh); c += estep) {
          const int fo_local = n0 + pass * kStageCh + c;
          if (fo_local >= g.fg) break;
          const int fc = group * g.fg + fo_local;
          const long long off =
              ((long long)o.n * g.f + fc) * out_plane + e_pix;
          if (vec) {
            store_out4(out, off,
                       *reinterpret_cast<const int4*>(stage + c * kStageLd +
                                                      em),
                       out_kind, e_scale[pass * kStageCh + c],
                       bias != nullptr, e_bias[pass * kStageCh + c]);
          } else {
            store_out(out, off, stage[c * kStageLd + em], out_kind,
                      e_scale[pass * kStageCh + c], bias != nullptr,
                      e_bias[pass * kStageCh + c]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
  }
}

// ---------------------------------------------------------------- gather

constexpr int kGM = 64, kGN = 64, kGK = 32;  // tile and K step
constexpr int kGLds = 48;  // bytes per shared row: 16-byte aligned, and
                           // conflict-free fragment loads
constexpr int kGThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kGThreads)
    w8a8_gather_kernel(const T* __restrict__ x, const int8_t* __restrict__ wq,
                       const float* __restrict__ ws,
                       const float* __restrict__ bias,
                       const float* __restrict__ xs_ptr,
                       void* __restrict__ out, int out_kind, Geometry g) {
  __shared__ __align__(16) int8_t a_tile[kGM * kGLds];
  __shared__ __align__(16) int8_t b_tile[kGN * kGLds];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int group = blockIdx.z;
  const long long m_total = (long long)g.n * g.od * g.oh * g.ow;
  const long long m0 = (long long)blockIdx.x * kGM;
  const int n0 = blockIdx.y * kGN;
  const float xs = *xs_ptr;
  const long long plane = (long long)g.d * g.h * g.w;

  // The gather: thread tid quantizes 16 channels of one tap for pixel am.
  const int am = tid % kGM;
  const int ak0 = (tid / kGM) * 16;
  const long long mrow = m0 + am;
  const bool m_ok = mrow < m_total;
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
    xb = x + (pn * g.c + (long long)group * g.cg) * plane;
  }
  const int khw = g.kh * g.kw;
  const int k_total = g.taps * g.cpad;

  // The weights: thread tid copies 16 bytes of channel row tid / 2.
  const int bn = tid >> 1, bk = (tid & 1) * 16;
  const bool n_ok = n0 + bn < g.fg;
  const int8_t* wrow = wq + (long long)(group * g.fg + n0 + bn) * k_total + bk;

  const int wm = warp & 1, wn = warp >> 1;
  const int gid = lane >> 2, tig = lane & 3;
  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  for (int k0 = 0; k0 < k_total; k0 += kGK) {
    const int t = k0 / g.cpad, c0 = k0 - t * g.cpad + ak0;
    const int kz = t / khw, rem = t - kz * khw;
    const int ky = rem / g.kw, kx = rem - ky * g.kw;
    const int iz = iz0 + kz, iy = iy0 + ky, ix = ix0 + kx;
    const bool in = m_ok && iz >= 0 && iz < g.d && iy >= 0 && iy < g.h &&
                    ix >= 0 && ix < g.w;
    const T* src = xb + ((long long)c0 * g.d + iz) * g.h * g.w +
                   (long long)iy * g.w + ix;
    uint32_t packed[4];
#pragma unroll
    for (int word = 0; word < 4; ++word) {
      uint32_t bits = 0;
#pragma unroll
      for (int byte = 0; byte < 4; ++byte) {
        const int j = word * 4 + byte;
        int q = 0;
        if (in && c0 + j < g.cg) q = quantize(to_float(src[j * plane]), xs);
        bits |= (uint32_t)(q & 0xff) << (8 * byte);
      }
      packed[word] = bits;
    }
    *reinterpret_cast<uint4*>(a_tile + am * kGLds + ak0) =
        make_uint4(packed[0], packed[1], packed[2], packed[3]);
    const uint4 wv = n_ok ? *reinterpret_cast<const uint4*>(wrow + k0)
                          : make_uint4(0, 0, 0, 0);
    *reinterpret_cast<uint4*>(b_tile + bn * kGLds + bk) = wv;
    __syncthreads();

    uint32_t a[2][4], b[4][2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int8_t* row = a_tile + (wm * 32 + i * 16 + gid) * kGLds + tig * 4;
      a[i][0] = *reinterpret_cast<const uint32_t*>(row);
      a[i][1] = *reinterpret_cast<const uint32_t*>(row + 8 * kGLds);
      a[i][2] = *reinterpret_cast<const uint32_t*>(row + 16);
      a[i][3] = *reinterpret_cast<const uint32_t*>(row + 8 * kGLds + 16);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int8_t* col = b_tile + (wn * 32 + j * 8 + gid) * kGLds + tig * 4;
      b[j][0] = *reinterpret_cast<const uint32_t*>(col);
      b[j][1] = *reinterpret_cast<const uint32_t*>(col + 16);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], a[i], b[j][0], b[j][1]);
    __syncthreads();
  }

  const long long pixels = (long long)g.od * g.oh * g.ow;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long mm = m0 + wm * 32 + i * 16 + gid + half * 8;
      if (mm >= m_total) continue;
      const long long nb = mm / pixels, pix = mm - nb * pixels;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int fo = n0 + wn * 32 + j * 8 + tig * 2 + e;
          if (fo >= g.fg) continue;
          const int fc = group * g.fg + fo;
          store_out(out, (nb * g.f + fc) * pixels + pix,
                    acc[i][j][half * 2 + e], out_kind, __fmul_rn(ws[fc], xs),
                    bias != nullptr, bias != nullptr ? bias[fc] : 0.f);
        }
      }
    }
  }
}

// ------------------------------------------------------------------ host

int ilog2(int v) {
  int l = 0;
  while ((1 << l) < v) ++l;
  return l;
}

bool pow2(int v) { return v > 0 && (v & (v - 1)) == 0; }

template <typename T, int kBN>
cudaError_t launch_patch(const void* x, const int8_t* wq, const float* ws,
                         const float* bias, const float* xs, void* out,
                         int out_kind, const Geometry& g, const Plan& pl,
                         int smem, cudaStream_t stream) {
  auto kernel = w8a8_patch_kernel<T, kBN>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess) {
    return err;
  }
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kBlock, smem)) != cudaSuccess) {
    return err;
  }
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int n_tiles = (g.fg + kBN - 1) / kBN;
  const long long lanes = (long long)n_tiles * g.groups;
  if (lanes > 65535) return cudaErrorInvalidConfiguration;
  long long gx = (long long)per_sm * sms / lanes;
  if (gx < 1) gx = 1;
  if (gx > pl.tiles) gx = pl.tiles;
  const dim3 grid((unsigned)gx, (unsigned)lanes);
  kernel<<<grid, kBlock, smem, stream>>>(static_cast<const T*>(x), wq, ws,
                                         bias, xs, out, out_kind, g, pl);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_gather(const void* x, const int8_t* wq, const float* ws,
                          const float* bias, const float* xs, void* out,
                          int out_kind, const Geometry& g,
                          cudaStream_t stream) {
  const long long m = (long long)g.n * g.od * g.oh * g.ow;
  const long long gx = (m + kGM - 1) / kGM, gy = (g.fg + kGN - 1) / kGN;
  if (gx > 2147483647LL || gy > 65535 || g.groups > 65535) {
    return cudaErrorInvalidConfiguration;
  }
  const dim3 grid((unsigned)gx, (unsigned)gy, (unsigned)g.groups);
  w8a8_gather_kernel<T><<<grid, kGThreads, 0, stream>>>(
      static_cast<const T*>(x), wq, ws, bias, xs, out, out_kind, g);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const int8_t* wq, const float* ws,
                   const float* bias, const float* xs, void* out,
                   int out_kind, const Geometry& g, const int* plan,
                   cudaStream_t stream) {
  if (plan[0] == 1) {
    return launch_gather<T>(x, wq, ws, bias, xs, out, out_kind, g, stream);
  }
  Plan pl;
  const int bn = plan[1];
  pl.tz = plan[2];
  pl.ty = plan[3];
  pl.tx = plan[4];
  pl.resident = plan[5];
  pl.stages = plan[6];
  if (!pow2(pl.tz) || !pow2(pl.ty) || !pow2(pl.tx) ||
      pl.tz * pl.ty * pl.tx != kTileM || pl.stages < 2 || pl.stages > 4) {
    return cudaErrorInvalidValue;
  }
  pl.ltx = ilog2(pl.tx);
  pl.ltxy = ilog2(pl.tx * pl.ty);
  pl.pz = (pl.tz - 1) * g.sd + g.kd;
  pl.py = (pl.ty - 1) * g.sh + g.kh;
  pl.px = (pl.tx - 1) * g.sw + g.kw;
  const long long p = (long long)pl.pz * pl.py * pl.px;
  pl.ntz = (g.od + pl.tz - 1) / pl.tz;
  pl.nty = (g.oh + pl.ty - 1) / pl.ty;
  pl.ntx = (g.ow + pl.tx - 1) / pl.tx;
  const long long tiles = (long long)g.n * pl.ntz * pl.nty * pl.ntx;
  const long long chunk_w = (long long)g.taps * bn * 32;
  const long long stage_bytes =
      (p * 32 + (pl.resident ? 0 : chunk_w) + 127) / 128 * 128;
  pl.nq = g.cpad / 32;
  const long long smem = kBarBytes + kStageBytes + kChannelBytes +
                         pl.stages * stage_bytes +
                         (pl.resident ? pl.nq * chunk_w : 0);
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(
           &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
      cudaSuccess) {
    return err;
  }
  if (smem > limit || tiles > 2147483647LL) return cudaErrorInvalidValue;
  pl.p = (int)p;
  pl.tiles = (int)tiles;
  pl.stage_bytes = (int)stage_bytes;
  pl.xo = ((-g.pw) % 4 + 4) % 4;
  pl.nv4 = (pl.xo + pl.px + 3) / 4;
  pl.vec = g.w % 4 == 0 && pl.tx * g.sw % 4 == 0 &&
           reinterpret_cast<uintptr_t>(x) % (4 * sizeof(T)) == 0;
  pl.rounds =
      pl.vec ? (int)((2LL * pl.pz * pl.py * pl.nv4 + kGroup - 1) / kGroup)
             : (int)((2 * p + kItems * kGroup - 1) / (kItems * kGroup));
  switch (bn) {
    case 32:
      return launch_patch<T, 32>(x, wq, ws, bias, xs, out, out_kind, g, pl,
                                 (int)smem, stream);
    case 64:
      return launch_patch<T, 64>(x, wq, ws, bias, xs, out, out_kind, g, pl,
                                 (int)smem, stream);
    case 128:
      return launch_patch<T, 128>(x, wq, ws, bias, xs, out, out_kind, g, pl,
                                  (int)smem, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// x: (N, C, D, H, W) float32 (x_kind 0) or bfloat16 (1), contiguous;
// wq: (F, kd, kh, kw, cpad) int8, each channel's weights tap-major with the
// per-group channels padded with zeros to cpad (a multiple of 32); ws: (F,)
// float32; bias: (F,) float32 or null; xs: one float32 on the card; out:
// (N, F, Do, Ho, Wo) of out_kind (0 float32, 1 bfloat16, 2 int32
// accumulators). dims: n, c, d, h, w, f, groups, kd, kh, kw, sd, sh, sw,
// pd, ph, pw, od, oh, ow, cpad. plan: kernel (0 patch, 1 gather), N tile,
// tz, ty, tx, resident, ring stages (the wrapper's kernel_plan).
extern "C" int vsr_w8a8_conv(const void* x, int x_kind, const void* wq,
                             const void* ws, const void* bias, const void* xs,
                             void* out, int out_kind, const int* dims,
                             const int* plan, void* stream) {
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
  g.cpad = dims[19];
  if (g.groups < 1 || g.c % g.groups || g.f % g.groups || x_kind < 0 ||
      x_kind > 1 || out_kind < 0 || out_kind > 2 || g.cpad % 32 ||
      plan[0] < 0 || plan[0] > 1) {
    return (int)cudaErrorInvalidValue;
  }
  g.cg = g.c / g.groups;
  g.fg = g.f / g.groups;
  g.taps = g.kd * g.kh * g.kw;
  if (g.cg > g.cpad || g.n < 1 || g.od < 1 || g.oh < 1 || g.ow < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* w8 = static_cast<const int8_t*>(wq);
  const float* wsf = static_cast<const float*>(ws);
  const float* bf = static_cast<const float*>(bias);
  const float* xsf = static_cast<const float*>(xs);
  if (x_kind == 0) {
    return (int)launch<float>(x, w8, wsf, bf, xsf, out, out_kind, g, plan, s);
  }
  return (int)launch<__nv_bfloat16>(x, w8, wsf, bf, xsf, out, out_kind, g,
                                    plan, s);
}
