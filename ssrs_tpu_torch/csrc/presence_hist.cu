// Presence histograms of (row, col) points on the (nrow, ncol) grid, for
// Hopper (sm_90a). Two entry points:
//
// - weighted (replaces ssrs_tpu/agents/pallas_hist.py::_hist_kernel, the
//   Pallas kernel behind presence_histogram): per cell, the sum of the
//   weights of the points that land there. As on the TPU, each weight is
//   rounded to bf16 (the one-hot operand), the sum is taken in float32,
//   and the result is truncated to int32. The flush of the delayed
//   presence count (agents/simulate.py::flush_pending) runs it with the
//   0/1 alive flags as weights.
// - count (replaces pallas_hist.py::_hist_kernel_nw, behind
//   presence_histogram_batch): the number of points per cell, from int16
//   or int32 index planes. Row -1 marks a dead point. The recount of
//   recorded trajectories (agents/presence.py::compute_presence_counts)
//   runs it.
//
// In both, a point outside [0, nrow) x [0, ncol) counts nothing: C's -1
// rows, any other negative index, and the TPU kernels' padding band.
//
// What bounds it: the scatter. A point reads 8-12 bytes and issues one
// atomic on a 4-byte cell; the 500x600 map (1.2 MB) stays in the 50 MB L2,
// where the atomics resolve, so the kernel is bound by L2 atomic
// throughput and by contention on hot cells (every track starts in the
// same band of rows), not by HBM bandwidth.
//
// Design, rethought for this card rather than carried over block by block:
// the TPU kernels built row and column one-hot tiles and summed them on the
// MXU, with the grid padded to (8, 128) tiles, because the TPU had no fast
// scatter. Here one thread takes one point in a grid-stride loop, checks
// both bounds, and adds with a global atomic. The count uses int32
// atomics, exact in any order. The weighted sum uses float32 atomics into
// a scratch map and a second pass that truncates to int32: the sum is
// exact in any order while the partial sums fit the 24-bit significand,
// the bound ssrs_tpu/agents/pallas_hist.py states; for the flush's 0/1
// weights it equals integer counting. A privatized shared-memory
// histogram is later work (ROADMAP.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
// grid-stride loops: enough blocks to fill 132 SMs several times over
constexpr int64_t kMaxBlocks = 4096;

int blocks_for(int64_t n) {
  const int64_t b = (n + kThreads - 1) / kThreads;
  return static_cast<int>(b < kMaxBlocks ? (b > 0 ? b : 1) : kMaxBlocks);
}

__global__ void __launch_bounds__(kThreads)
weighted_scatter_kernel(const int32_t* __restrict__ rows,
                        const int32_t* __restrict__ cols,
                        const float* __restrict__ weights,
                        float* __restrict__ acc,  // (nrow, ncol), zeroed
                        int64_t n, int nrow, int ncol) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    const int r = rows[i];
    const int c = cols[i];
    if (r < 0 || r >= nrow || c < 0 || c >= ncol) continue;
    // the TPU kernel's one-hot operand is bf16 (round to nearest even)
    const float w = __bfloat162float(__float2bfloat16_rn(weights[i]));
    if (w != 0.f) {
      atomicAdd(acc + static_cast<int64_t>(r) * ncol + c, w);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
truncate_kernel(const float* __restrict__ acc, int32_t* __restrict__ out,
                int64_t m) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < m; i += stride) {
    out[i] = __float2int_rz(acc[i]);  // as float32 -> int32 in XLA
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
count_kernel(const T* __restrict__ rows, const T* __restrict__ cols,
             int32_t* __restrict__ out,  // (nrow, ncol), zeroed
             int64_t n, int nrow, int ncol) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    const int r = rows[i];
    const int c = cols[i];
    if (r < 0 || r >= nrow || c < 0 || c >= ncol) continue;
    atomicAdd(out + static_cast<int64_t>(r) * ncol + c, 1);
  }
}

template <typename T>
int launch_count(const void* rows, const void* cols, void* out, int64_t n,
                 int nrow, int ncol, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const int64_t m = static_cast<int64_t>(nrow) * ncol;
  cudaError_t err = cudaMemsetAsync(out, 0, m * sizeof(int32_t), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    count_kernel<T><<<blocks_for(n), kThreads, 0, s>>>(
        static_cast<const T*>(rows), static_cast<const T*>(cols),
        static_cast<int32_t*>(out), n, nrow, ncol);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes. Each enqueues its work on `stream`
// (zeroing the output first) and returns cudaGetLastError() (0 =
// cudaSuccess).

// rows, cols int32 (n,); weights float32 (n,); acc float32 (nrow*ncol,)
// scratch; out int32 (nrow, ncol).
extern "C" int ssrs_presence_hist_weighted(const void* rows,
                                           const void* cols,
                                           const void* weights, void* acc,
                                           void* out, int64_t n, int nrow,
                                           int ncol, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const int64_t m = static_cast<int64_t>(nrow) * ncol;
  cudaError_t err = cudaMemsetAsync(acc, 0, m * sizeof(float), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    weighted_scatter_kernel<<<blocks_for(n), kThreads, 0, s>>>(
        static_cast<const int32_t*>(rows), static_cast<const int32_t*>(cols),
        static_cast<const float*>(weights), static_cast<float*>(acc), n, nrow,
        ncol);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  truncate_kernel<<<blocks_for(m), kThreads, 0, s>>>(
      static_cast<const float*>(acc), static_cast<int32_t*>(out), m);
  return static_cast<int>(cudaGetLastError());
}

// rows, cols int16 (n,); out int32 (nrow, ncol).
extern "C" int ssrs_presence_hist_count_i16(const void* rows,
                                            const void* cols, void* out,
                                            int64_t n, int nrow, int ncol,
                                            void* stream) {
  return launch_count<int16_t>(rows, cols, out, n, nrow, ncol, stream);
}

// rows, cols int32 (n,); out int32 (nrow, ncol).
extern "C" int ssrs_presence_hist_count_i32(const void* rows,
                                            const void* cols, void* out,
                                            int64_t n, int nrow, int ncol,
                                            void* stream) {
  return launch_count<int32_t>(rows, cols, out, n, nrow, ncol, stream);
}
