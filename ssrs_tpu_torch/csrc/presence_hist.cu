// Presence histograms of (row, col) points on the (nrow, ncol) grid, for
// Hopper (sm_90a). A point outside [0, nrow) x [0, ncol) counts nothing
// in any of them: C's -1 rows, any other negative index, and the TPU
// kernels' padding band.
//
// - flush (replaces ssrs_tpu/agents/pallas_hist.py::_hist_kernel where the
//   engine ran it, ssrs_tpu/agents/simulate.py::flush_pending): adds one
//   into the caller's int32 presence map, in place, for every agent whose
//   pending flag (palive) is set, and writes the cleared flags into a new
//   array. The flush's weights are the 0/1 flags, which bf16 rounds
//   exactly, and one flush adds at most N < 2^24 to a cell, so int32
//   atomics give the weighted kernel's map bit for bit, with no float
//   scratch, no memset and no pass over the map.
// - weighted (replaces _hist_kernel, behind presence_histogram): per cell,
//   the sum of the weights of the points that land there. As on the TPU,
//   each weight is rounded to bf16 (the one-hot operand), the sum is taken
//   in float32, and the result is truncated to int32. No path of the port
//   runs it since the flush has its own kernel (in ssrs_tpu, too, it has
//   no production caller).
// - count (replaces pallas_hist.py::_hist_kernel_nw, behind
//   presence_histogram_batch): the number of points per cell, from int16
//   or int32 index planes. Row -1 marks a dead point. The recount of
//   recorded trajectories (agents/presence.py::compute_presence_counts)
//   runs it. Two kernels, chosen by a plan from the shapes
//   (agents/presence_hist.py::_count_plan):
//   * privatized, where points are many per cell: the grid's cells are
//     cut into bands of at most ~51k cells, one block's shared memory
//     each. For every band, `shares` blocks each read their share of the
//     points (16 bytes at a time), keep those of the band and count them
//     with shared-memory atomics; a second launch sums the `shares` copies
//     of the map per cell into the output. With one block an SM, bands x
//     shares blocks fill the card, and every point is read once per band,
//     from L2 after the first.
//   * direct, where points are few per cell, or the grid has many bands
//     (a sparse recount of a large grid, where every band would read the
//     points again): one thread per point and one global int32 atomic,
//     resolved in L2, after a memset of the map.
//
// What bounds them. The flush: its launch and one L2 atomic a pending
// agent; it moves ~10 bytes an agent, ~0.4 us at the engine's 100k
// agents against the ~7 us it takes on this card (chip_smoke.py), most
// of it the launch and one dependent load-and-atomic per thread. The
// count: a point reads 4 (int16) or 8 bytes, so 7.5M points are 30 MB,
// ~9 us at 3.35 TB/s. The direct kernel instead spends one L2 atomic a
// point: ~7e10 a second on this card, so ~100 us for the recorded run's
// 7.5M points. The privatized kernel's atomics are in shared memory; it
// pays instead for reading the points once a band (six bands at 500x600:
// 180 MB of L2 reads) and a fixed ~20 us to zero, store and sum the
// copies of the map (22 x 1.2 MB at 500x600): ~72 us on those points. A
// cluster of blocks that holds the whole map in distributed shared
// memory, every point added by a remote atomic, was measured slower than
// the direct kernel (scripts/torch_count_probe.py): remote atomics run at
// ~1e11 a second, little above L2's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
// grid-stride loops: enough blocks to fill 132 SMs several times over
constexpr int64_t kMaxBlocks = 4096;
// threads of a block of the privatized count (one block an SM: its band
// takes most of the SM's shared memory)
constexpr int kHistThreads = 1024;

int blocks_for(int64_t n) {
  const int64_t b = (n + kThreads - 1) / kThreads;
  return static_cast<int>(b < kMaxBlocks ? (b > 0 ? b : 1) : kMaxBlocks);
}

__global__ void __launch_bounds__(kThreads)
flush_kernel(const int32_t* __restrict__ rows,
             const int32_t* __restrict__ cols,
             const uint8_t* __restrict__ palive,  // torch.bool, 0 or 1
             int32_t* __restrict__ presence,      // (nrow, ncol), added to
             uint8_t* __restrict__ cleared,       // (n,), written 0
             int64_t n, int nrow, int ncol) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    if (palive[i]) {
      const int r = rows[i];
      const int c = cols[i];
      if (r >= 0 && r < nrow && c >= 0 && c < ncol) {
        atomicAdd(presence + static_cast<int64_t>(r) * ncol + c, 1);
      }
    }
    cleared[i] = 0;
  }
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

// The privatized count: block (k, s) = blockIdx.x = s * bands + k keeps
// the counts of band k (cells [k * band, (k + 1) * band)) in its shared
// memory, reads share s of the points (16 bytes at a time where both planes
// are aligned) and adds the points of its band with shared-memory atomics;
// then it stores its band into copy s of `scratch` (shares, nrow * ncol).
// The `bands` blocks of a share read the same points, from L2 after the
// first.
template <typename T>
__global__ void __launch_bounds__(kHistThreads, 1)
band_count_kernel(const T* __restrict__ rows, const T* __restrict__ cols,
                  int32_t* __restrict__ scratch, int64_t m, int nrow,
                  int ncol, int bands, int band) {
  extern __shared__ int32_t smap[];
  for (int i = threadIdx.x; i < band; i += blockDim.x) smap[i] = 0;
  __syncthreads();
  const int k = blockIdx.x % bands;
  const int share = blockIdx.x / bands;
  const int64_t lo = static_cast<int64_t>(k) * band;
  const int64_t nthreads = static_cast<int64_t>(gridDim.x / bands) *
                           blockDim.x;
  const int64_t first = static_cast<int64_t>(share) * blockDim.x +
                        threadIdx.x;
  auto add = [&](int r, int c) {
    if (r < 0 || r >= nrow || c < 0 || c >= ncol) return;
    const int64_t cell = static_cast<int64_t>(r) * ncol + c - lo;
    if (cell >= 0 && cell < band) atomicAdd(smap + cell, 1);
  };
  constexpr int kVec = 16 / sizeof(T);
  union Vec {
    int4 v;
    T e[kVec];
  };
  const bool aligned = ((reinterpret_cast<uintptr_t>(rows) |
                         reinterpret_cast<uintptr_t>(cols)) & 15) == 0;
  const int64_t nvec = aligned ? m / kVec : 0;
  for (int64_t v = first; v < nvec; v += nthreads) {
    Vec vr, vc;
    vr.v = __ldg(reinterpret_cast<const int4*>(rows) + v);
    vc.v = __ldg(reinterpret_cast<const int4*>(cols) + v);
#pragma unroll
    for (int j = 0; j < kVec; ++j) add(vr.e[j], vc.e[j]);
  }
  // the points past the last whole vector, or all of them if unaligned
  for (int64_t i = nvec * kVec + first; i < m; i += nthreads) {
    add(rows[i], cols[i]);
  }
  __syncthreads();
  const int64_t cells = static_cast<int64_t>(nrow) * ncol;
  const int n = static_cast<int>(cells - lo < band ? cells - lo : band);
  int32_t* dst = scratch + share * cells + lo;
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = smap[i];
}

// out[j] = the sum of the `copies` rows of scratch (copies, n) at j.
__global__ void __launch_bounds__(kThreads)
sum_copies_kernel(const int32_t* __restrict__ scratch,
                  int32_t* __restrict__ out, int copies, int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       j < n; j += stride) {
    int32_t s = 0;
    for (int k = 0; k < copies; ++k) s += __ldcs(scratch + k * n + j);
    out[j] = s;
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

template <typename T>
int launch_band_count(const void* rows, const void* cols, void* scratch,
                      void* out, int64_t n, int nrow, int ncol, int bands,
                      int shares, int band, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const int smem_bytes = band * static_cast<int>(sizeof(int32_t));
  // a band larger than a block's shared memory fails here, and is returned
  cudaError_t err = cudaFuncSetAttribute(
      band_count_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  band_count_kernel<T><<<bands * shares, kHistThreads, smem_bytes, s>>>(
      static_cast<const T*>(rows), static_cast<const T*>(cols),
      static_cast<int32_t*>(scratch), n, nrow, ncol, bands, band);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t cells = static_cast<int64_t>(nrow) * ncol;
  sum_copies_kernel<<<blocks_for(cells), kThreads, 0, s>>>(
      static_cast<const int32_t*>(scratch), static_cast<int32_t*>(out),
      shares, cells);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes. Each enqueues its work on `stream` and
// returns a CUDA error code (0 = cudaSuccess).

// rows, cols int32 (n,); palive bool (n,); presence int32 (nrow, ncol),
// added to in place; cleared bool (n,), written 0.
extern "C" int ssrs_presence_flush(const void* rows, const void* cols,
                                   const void* palive, void* presence,
                                   void* cleared, int64_t n, int nrow,
                                   int ncol, void* stream) {
  flush_kernel<<<blocks_for(n), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(rows), static_cast<const int32_t*>(cols),
      static_cast<const uint8_t*>(palive), static_cast<int32_t*>(presence),
      static_cast<uint8_t*>(cleared), n, nrow, ncol);
  return static_cast<int>(cudaGetLastError());
}

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

// The direct count. rows, cols int16 (n,); out int32 (nrow, ncol), zeroed
// here.
extern "C" int ssrs_presence_hist_count_i16(const void* rows,
                                            const void* cols, void* out,
                                            int64_t n, int nrow, int ncol,
                                            void* stream) {
  return launch_count<int16_t>(rows, cols, out, n, nrow, ncol, stream);
}

// The direct count. rows, cols int32 (n,); out int32 (nrow, ncol).
extern "C" int ssrs_presence_hist_count_i32(const void* rows,
                                            const void* cols, void* out,
                                            int64_t n, int nrow, int ncol,
                                            void* stream) {
  return launch_count<int32_t>(rows, cols, out, n, nrow, ncol, stream);
}

// The privatized count: bands * shares blocks of `band` cells of shared
// memory each, into scratch int32 (shares, nrow * ncol), then one launch
// that sums the copies into out int32 (nrow, ncol). rows, cols int16 (n,)
// when elem_bytes is 2, else int32.
extern "C" int ssrs_presence_count_bands(const void* rows, const void* cols,
                                         void* scratch, void* out, int64_t n,
                                         int nrow, int ncol, int elem_bytes,
                                         int bands, int shares, int band,
                                         void* stream) {
  if (elem_bytes == 2) {
    return launch_band_count<int16_t>(rows, cols, scratch, out, n, nrow, ncol,
                                      bands, shares, band, stream);
  }
  return launch_band_count<int32_t>(rows, cols, scratch, out, n, nrow, ncol,
                                    bands, shares, band, stream);
}
