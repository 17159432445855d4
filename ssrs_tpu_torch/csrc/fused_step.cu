// One agent step of the lockstep movement model, for Hopper (sm_90a).
//
// Replaces ssrs_tpu/agents/fused_step.py::_fused_kernel, the Pallas TPU
// kernel behind every step of simulate_presence_compacting. It computes,
// per agent: the table gather, the direction-memory mask, the fallback
// cascade, nu sharpening, the inverse-CDF draw, the move, the ring-buffer
// shift, and the delayed presence count of the carried position.
//
// What bounds it: latency, not bandwidth. At 100k agents a step moves
// about 6 MB (nine weights, six int32 and one float per agent, plus the
// outputs); the bf16 table of a 500x600 grid is 5.4 MB and stays in the
// 50 MB L2. One launch per step is therefore bound by launch latency and
// by the random 18-36 byte gathers, not by HBM bandwidth.
//
// Design, rethought for this card rather than carried over block by block:
// - one thread per agent; the ragged edge is masked, so N needs no padding;
// - the nine weights are gathered here from the flat (nrow*ncol, 9) table
//   (on the TPU the gather stayed in XLA because Mosaic cannot express it);
// - the memory mask is a row lookup in the 9x9 restriction table, staged
//   in shared memory (the TPU kernel used one-hot MXU dots);
// - presence is an int32 atomicAdd into the (nrow, ncol) map, which
//   replaces the one-hot MXU histogram and its VMEM-fit regimes.
// - a null table is the directed random walk (ssrs_tpu's step without a
//   table, ssrs_tpu/agents/simulate.py:510-515): the weights of every cell
//   are the prior with its center zeroed, and no table byte is read.
// The arithmetic keeps the TPU kernel's order (sequential running sum,
// total as a sequential sum, nu != 1 as p/pmax then exp(nu*log(p))); the
// build passes -fmad=false so nvcc cannot contract a product into a sum,
// which keeps every draw equal to the plain PyTorch version.
//
// A simple kernel is enough for now. A multi-step kernel or a CUDA graph,
// in-kernel Philox, and folding the alive/boundary-push pass in are later
// work (ROADMAP.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float load_weight(const float* table, int64_t i) {
  return table[i];
}

__device__ __forceinline__ float load_weight(const __nv_bfloat16* table,
                                             int64_t i) {
  return __bfloat162float(table[i]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_step_kernel(const T* __restrict__ table,      // (nrow*ncol, 9) or null
                  const float* __restrict__ restr,  // (9, 9) row m: allowed after move m
                  const float* __restrict__ dirp,   // (9,) directional prior
                  const int32_t* __restrict__ pr,   // (n,) row after the burn-in push
                  const int32_t* __restrict__ pc,   // (n,) col after the burn-in push
                  const int32_t* __restrict__ r,    // (n,) carried row
                  const int32_t* __restrict__ c,    // (n,) carried col
                  const bool* __restrict__ alive,   // (n,)
                  const bool* __restrict__ palive,  // (n,) previous step's alive
                  const int32_t* __restrict__ mem,  // (max(k,1), n) oldest first
                  const float* __restrict__ u,      // (n,) uniforms in [0, 1)
                  int32_t* __restrict__ new_r, int32_t* __restrict__ new_c,
                  int32_t* __restrict__ new_mem,    // (max(k,1), n)
                  int32_t* __restrict__ presence,   // (nrow, ncol), added into
                  int n, int nrow, int ncol, int memory_k, float nu) {
  __shared__ float s_restr[81];
  __shared__ float s_dirp[9];
  for (int t = threadIdx.x; t < 90; t += blockDim.x) {
    if (t < 81) {
      s_restr[t] = restr[t];
    } else {
      s_dirp[t - 81] = dirp[t - 81];
    }
  }
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int k_rows = memory_k > 0 ? memory_k : 1;

  // delayed presence: the CARRIED position, weighted by the previous
  // step's alive flag (out-of-range cells count nothing, as in the TPU
  // kernel's one-hot histogram)
  const int ri = r[i];
  const int ci = c[i];
  if (palive[i] && ri >= 0 && ri < nrow && ci >= 0 && ci < ncol) {
    atomicAdd(presence + static_cast<int64_t>(ri) * ncol + ci, 1);
  }

  if (!alive[i]) {
    // a dead agent keeps its position and memory
    new_r[i] = ri;
    new_c[i] = ci;
    for (int k = 0; k < k_rows; ++k) {
      new_mem[static_cast<int64_t>(k) * n + i] =
          mem[static_cast<int64_t>(k) * n + i];
    }
    return;
  }

  const int pri = pr[i];
  const int pci = pc[i];
  float p[9];
  if (table != nullptr) {
    const int64_t row = (static_cast<int64_t>(pri) * ncol + pci) * 9;
#pragma unroll
    for (int j = 0; j < 9; ++j) p[j] = load_weight(table, row + j);
  } else {
    // no table (the directed random walk): every cell's weights are the
    // directional prior with the center zeroed, in float32
#pragma unroll
    for (int j = 0; j < 9; ++j) p[j] = j == 4 ? 0.f : s_dirp[j];
  }

  // fallback cascade (ssrs/movmodel.py:233-241); the NaN/clip/center
  // prologue is already folded into the table
  if (memory_k > 0) {
    float mask[9];
#pragma unroll
    for (int j = 0; j < 9; ++j) mask[j] = 1.f;
    for (int k = 0; k < memory_k; ++k) {
      const float* mrow = s_restr + 9 * mem[static_cast<int64_t>(k) * n + i];
#pragma unroll
      for (int j = 0; j < 9; ++j) mask[j] *= mrow[j];
    }
    mask[4] = 0.f;
    bool any = false;
#pragma unroll
    for (int j = 0; j < 9; ++j) {
      p[j] *= mask[j];
      any |= p[j] != 0.f;
    }
    if (!any) {
#pragma unroll
      for (int j = 0; j < 9; ++j) p[j] = (j == 4 ? 0.f : s_dirp[j]) * mask[j];
    }
  }
  bool any = false;
#pragma unroll
  for (int j = 0; j < 9; ++j) any |= p[j] != 0.f;
  if (!any) {
#pragma unroll
    for (int j = 0; j < 9; ++j) p[j] = s_dirp[j];
  }
  if (nu == 0.f) {
    // NumPy 0**0 == 1: a uniform walk over all nine cells
#pragma unroll
    for (int j = 0; j < 9; ++j) p[j] = 1.f;
  } else if (nu != 1.f) {
    float pmax = p[0];
#pragma unroll
    for (int j = 1; j < 9; ++j) pmax = fmaxf(pmax, p[j]);
#pragma unroll
    for (int j = 0; j < 9; ++j) {
      const float q = p[j] / pmax;
      p[j] = q > 0.f ? expf(nu * logf(fmaxf(q, 1e-30f))) : 0.f;
    }
  }

  // inverse-CDF draw: mi = #{j : cum_j < max(u, tiny) * total}, capped at 8
  float total = 0.f;
#pragma unroll
  for (int j = 0; j < 9; ++j) total += p[j];
  const float thresh = fmaxf(u[i], FLT_MIN) * total;
  float cum = 0.f;
  int cnt = 0;
#pragma unroll
  for (int j = 0; j < 9; ++j) {
    cum += p[j];
    cnt += cum < thresh ? 1 : 0;
  }
  const int mi = cnt < 8 ? cnt : 8;

  new_r[i] = pri + mi / 3 - 1;
  new_c[i] = pci + mi % 3 - 1;
  if (memory_k > 0) {
    for (int k = 0; k + 1 < memory_k; ++k) {
      new_mem[static_cast<int64_t>(k) * n + i] =
          mem[static_cast<int64_t>(k + 1) * n + i];
    }
    new_mem[static_cast<int64_t>(memory_k - 1) * n + i] = mi;
  } else {
    new_mem[i] = mem[i];
  }
}

template <typename T>
int launch(const void* table, const void* restr, const void* dirp,
           const void* pr, const void* pc, const void* r, const void* c,
           const void* alive, const void* palive, const void* mem,
           const void* u, void* new_r, void* new_c, void* new_mem,
           void* presence, int n, int nrow, int ncol, int memory_k, float nu,
           void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const int blocks = (n + kThreads - 1) / kThreads;
  fused_step_kernel<T><<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(table), static_cast<const float*>(restr),
      static_cast<const float*>(dirp), static_cast<const int32_t*>(pr),
      static_cast<const int32_t*>(pc), static_cast<const int32_t*>(r),
      static_cast<const int32_t*>(c), static_cast<const bool*>(alive),
      static_cast<const bool*>(palive), static_cast<const int32_t*>(mem),
      static_cast<const float*>(u), static_cast<int32_t*>(new_r),
      static_cast<int32_t*>(new_c), static_cast<int32_t*>(new_mem),
      static_cast<int32_t*>(presence), n, nrow, ncol, memory_k, nu);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes. Each enqueues one launch on `stream`
// and returns cudaGetLastError() (0 = cudaSuccess).
extern "C" int ssrs_fused_step_f32(
    const void* table, const void* restr, const void* dirp, const void* pr,
    const void* pc, const void* r, const void* c, const void* alive,
    const void* palive, const void* mem, const void* u, void* new_r,
    void* new_c, void* new_mem, void* presence, int n, int nrow, int ncol,
    int memory_k, float nu, void* stream) {
  return launch<float>(table, restr, dirp, pr, pc, r, c, alive, palive, mem,
                       u, new_r, new_c, new_mem, presence, n, nrow, ncol,
                       memory_k, nu, stream);
}

extern "C" int ssrs_fused_step_bf16(
    const void* table, const void* restr, const void* dirp, const void* pr,
    const void* pc, const void* r, const void* c, const void* alive,
    const void* palive, const void* mem, const void* u, void* new_r,
    void* new_c, void* new_mem, void* presence, int n, int nrow, int ncol,
    int memory_k, float nu, void* stream) {
  return launch<__nv_bfloat16>(table, restr, dirp, pr, pc, r, c, alive,
                               palive, mem, u, new_r, new_c, new_mem,
                               presence, n, nrow, ncol, memory_k, nu, stream);
}
