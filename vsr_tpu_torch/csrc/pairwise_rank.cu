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
// CUDA cores' compare rate, not by memory. The (rows, gs, gs) intermediate
// of the plain version never exists.
//
// Design (the simple, correct first version): one block per row. The row is
// staged once in shared memory; thread i keeps a[i] in a register and walks
// j = 0..gs-1 over the shared row (every lane of a warp reads the same
// address: a broadcast, no bank conflict), counting in a register. A thread
// takes i = tid, tid + blockDim, ... so any gs up to kMaxGs works, ragged
// or not; there is no 128-lane or scratch-memory constraint to carry over
// from the TPU kernel.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kMaxGs = 4096;    // floats of one row staged in shared memory
constexpr int kMaxThreads = 256;

__global__ void __launch_bounds__(kMaxThreads)
    pairwise_rank_kernel(const float* __restrict__ af, int* __restrict__ out,
                         int gs) {
  extern __shared__ float row[];
  const size_t base = static_cast<size_t>(blockIdx.x) * gs;
  for (int i = threadIdx.x; i < gs; i += blockDim.x) row[i] = af[base + i];
  __syncthreads();
  for (int i = threadIdx.x; i < gs; i += blockDim.x) {
    const float a_i = row[i];
    int count = 0;
#pragma unroll 8
    for (int j = 0; j < gs; ++j) {
      const float a_j = row[j];
      count += (a_j > a_i) || (a_j == a_i && j < i);
    }
    out[base + i] = count;
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
  int threads = ((gs + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  pairwise_rank_kernel<<<static_cast<unsigned>(rows), threads,
                         gs * sizeof(float),
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(af), static_cast<int*>(out), gs);
  return static_cast<int>(cudaGetLastError());
}
