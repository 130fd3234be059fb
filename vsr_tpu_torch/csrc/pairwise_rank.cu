// Stable descending rank of every element within its row, for NVIDIA
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel K3 of the JAX package:
// vsr_tpu/ops/rank.py, pairwise_rank (pl.pallas_call at :68, kernel body
// _rank_kernel at :37).
//
// What it computes, per row a[0..gs) of float32 scores:
//   rank[i] = #{ j : a[j] > a[i]  or  (a[j] == a[i] and j < i) }
// the position of element i in the row sorted in descending order with
// stable ties (the earlier index wins). The comparison is the float `>` and
// `==` of the Pallas body: -0.0 ties with +0.0, and a NaN compares false
// with everything (a NaN element gets rank 0, and no other element counts
// it).
//
// What bounds it: a row moves 2 * gs * 4 bytes and costs gs^2 compares, so
// at gs = 256 there are 32 compares per byte: the kernel is bound by the
// SMs' instruction rate, not by memory. The (rows, gs, gs) intermediate of
// the plain version never exists. The design therefore cuts the
// instructions per (i, j) pair:
// - One compare per pair. For j < i the pair counts iff a[j] >= a[i], for
//   j > i iff a[j] > a[i]: for every float, NaN included, that is the
//   two-compare form above. The split is kept uniform across a warp: a
//   warp's lanes hold 32 consecutive i (one "i block"), j is walked in
//   blocks of 32, and a j block wholly below the i block takes `>=`, one
//   wholly above takes `>`; only the diagonal block keeps the full form.
//   Each pair is one compare into a predicate and one predicated add:
//   two instructions, written as PTX so that the compiler does not turn
//   the predicate into a select plus an add.
// - Few shared loads per pair. A j block is read as eight 16-byte
//   broadcast loads into registers and serves four i blocks per lane (a
//   lane ranks i = 32 * (b + m) + lane, m = 0..3): one load per 16 pairs.
// - Several rows per block. A warp takes one unit = (row, four i blocks);
//   a block of 8 warps stages as many rows as give it 8 units (4 rows at
//   gs = 256, 8 at gs <= 128), each padded to a multiple of 32 with NaN,
//   which no compare counts, so ragged gs needs no mask on j. Rows longer
//   than 1024 take one block each, whose warps loop over the row's units.
//   Rows past the end are masked. Any gs up to kMaxGs works; there is no
//   128-lane or scratch-memory constraint to carry over from the TPU kernel.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kMaxGs = 4096;  // floats staged in shared memory per block
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerUnit = 4;  // i blocks (of 32) a warp ranks at once

enum class Side { kBelow, kAbove, kDiagonal };

// count += a >= b (resp. a > b): a compare and a predicated add.
__device__ __forceinline__ void count_ge(uint32_t& count, float a, float b) {
  asm("{\n .reg .pred p;\n setp.ge.f32 p, %1, %2;\n"
      " @p add.u32 %0, %0, 1;\n}\n"
      : "+r"(count)
      : "f"(a), "f"(b));
}
__device__ __forceinline__ void count_gt(uint32_t& count, float a, float b) {
  asm("{\n .reg .pred p;\n setp.gt.f32 p, %1, %2;\n"
      " @p add.u32 %0, %0, 1;\n}\n"
      : "+r"(count)
      : "f"(a), "f"(b));
}

// How many of the 32 values a_j of a j block count against a_i, for a j
// block that lies below, above or on the lane's i block (there j = t,
// i = lane within the block).
template <Side kSide>
__device__ __forceinline__ uint32_t count_block(const float (&a_j)[32],
                                                float a_i, int lane) {
  uint32_t count = 0;
#pragma unroll
  for (int t = 0; t < 32; ++t) {
    if (kSide == Side::kBelow)
      count_ge(count, a_j[t], a_i);
    else if (kSide == Side::kAbove)
      count_gt(count, a_j[t], a_i);
    else
      count += (a_j[t] > a_i) || (a_j[t] == a_i && t < lane);
  }
  return count;
}

__global__ void __launch_bounds__(kThreads)
    pairwise_rank_kernel(const float* __restrict__ af, int* __restrict__ out,
                         long long rows, int gs, int n_blocks, int units,
                         int rows_per_block) {
  __shared__ __align__(16) float staged[kMaxGs];
  const int gs_pad = n_blocks * 32;
  const long long row0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const float nan = __int_as_float(0x7fc00000);
  for (int e = threadIdx.x; e < rows_per_block * gs_pad; e += kThreads) {
    const long long row = row0 + e / gs_pad;
    const int j = e % gs_pad;
    staged[e] = (row < rows && j < gs) ? af[row * gs + j] : nan;
  }
  __syncthreads();

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int u = warp; u < rows_per_block * units; u += kWarps) {
    const long long row = row0 + u / units;
    if (row >= rows) continue;  // uniform across the warp
    const float* a = staged + (u / units) * gs_pad;
    const int ib0 = (u % units) * kBlocksPerUnit;
    float a_i[kBlocksPerUnit];
    uint32_t count[kBlocksPerUnit];
#pragma unroll
    for (int m = 0; m < kBlocksPerUnit; ++m) {
      a_i[m] = ib0 + m < n_blocks ? a[(ib0 + m) * 32 + lane] : nan;
      count[m] = 0;
    }
    for (int jb = 0; jb < n_blocks; ++jb) {
      float a_j[32];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(a + jb * 32 + 4 * q);
        a_j[4 * q] = v.x;
        a_j[4 * q + 1] = v.y;
        a_j[4 * q + 2] = v.z;
        a_j[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int m = 0; m < kBlocksPerUnit; ++m) {
        const int ib = ib0 + m;
        if (ib >= n_blocks) continue;
        if (jb < ib)
          count[m] += count_block<Side::kBelow>(a_j, a_i[m], lane);
        else if (jb > ib)
          count[m] += count_block<Side::kAbove>(a_j, a_i[m], lane);
        else
          count[m] += count_block<Side::kDiagonal>(a_j, a_i[m], lane);
      }
    }
#pragma unroll
    for (int m = 0; m < kBlocksPerUnit; ++m) {
      const int i = (ib0 + m) * 32 + lane;
      if (i < gs) out[row * gs + i] = static_cast<int>(count[m]);
    }
  }
}

}  // namespace

// C entry point (bound with ctypes). af and out are (rows, gs) contiguous,
// float32 and int32. Launches on `stream` and returns the launch's
// cudaError_t (0 on success); it does not synchronise.
extern "C" int vsr_pairwise_rank(const void* af, void* out, long long rows,
                                 int gs, void* stream) {
  if (rows < 1 || rows > 2147483647LL || gs < 1 || gs > kMaxGs)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_blocks = (gs + 31) / 32;
  const int units = (n_blocks + kBlocksPerUnit - 1) / kBlocksPerUnit;
  const int rows_per_block = units >= kWarps ? 1 : kWarps / units;
  static_assert(kWarps * kBlocksPerUnit * 32 <= kMaxGs,
                "the rows of a block fit its shared memory");
  const long long grid = (rows + rows_per_block - 1) / rows_per_block;
  pairwise_rank_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(af), static_cast<int*>(out), rows, gs,
      n_blocks, units, rows_per_block);
  return static_cast<int>(cudaGetLastError());
}
