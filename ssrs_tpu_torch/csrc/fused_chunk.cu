// T consecutive steps of the lockstep movement model, for every agent, in
// one launch, for Hopper (sm_90a).
//
// Replaces ssrs_tpu/agents/fused_step.py:52 (_fused_kernel, the Pallas
// TPU kernel of one agent step) together with the chunk scans that drove
// it once per step: _run_chunk and _run_chunk_recording
// (ssrs_tpu/agents/simulate.py:758-769, 914-925). On the TPU a chunk is
// one jitted lax.scan, so it dispatches once; a one-step kernel driven
// from Python launches about ten times a step (the alive/push pass, the
// uniform draw, the step, the emission copies). This kernel runs the
// whole chunk: per agent and step, the alive rule and the burn-in
// boundary push, the delayed presence count of the carried position, and
// for a live agent the step of fused_step.cu (table gather, memory mask,
// fallback cascade, nu, inverse-CDF draw, move, ring shift), then
// palive = alive. A dead agent keeps its position and memory.
//
// What bounds it. Bytes: the state is read and written once per chunk
// (~14 B an agent at k=1), and each live agent-step reads one 4-byte
// uniform and one 18-36 byte table row; the table (5.4 MB bf16, 10.8 MB
// f32 at 500x600) and the presence map stay in the 50 MB L2. At 100k
// agents and 512 steps the uniforms alone are ~205 MB, ~61 us at
// 3.35 TB/s. Latency: a step's gather address depends on the previous
// step's move, so each agent is a chain of T dependent L2 round trips,
// and 100k agents are few threads to hide it with (~760 a SM).
// Measured by chip_smoke.py on an H100 SXM at 700 W (bf16 table, k=1):
// neither bound is reached. At 10k agents 512 steps take 0.48 ms, ~0.9
// us a step: the dependent chain. At 100k they take 1.24-1.27 ms, ~26 ps
// of device time per live agent-step in every 64-step window, the
// crowded burn-in included, so the atomics' crowding is not the cost;
// and with a null table (no row loads at all) 100k agents cost ~30 ps
// per live agent-step too, so the row gather is not the cost either.
// What is left is a step's dependent arithmetic, its uniform load and
// its atomic, with 24 warps an SM to hide them.
//
// What the design does about it:
// - one thread per agent, T steps in a loop inside the thread: agents
//   interact only through integer atomics, which commute, so no grid-wide
//   synchronisation is needed, and r, c, alive, palive and the memory
//   ring stay in registers for the whole chunk;
// - the ring has a compile-time maximum of kMaxMemory entries, indexed
//   only under full unroll with predication, so it never spills to local
//   memory (the wrapper refuses memory_k > kMaxMemory);
// - the uniforms come in as a (T, n) block drawn by torch.Generator and
//   are read coalesced (u[t*n + i]) with a streaming cache hint, so the
//   block does not evict the table from L2; step t+1's uniform is loaded
//   before step t's gather;
// - the table is read through the read-only path;
// - an agent that is dead with palive false can change nothing more: its
//   thread stops reading the table and the uniforms and only fills its
//   remaining emission rows, so the work follows the live agent-steps;
// - presence is an int32 atomicAdd into the (nrow, ncol) map, which stays
//   in L2 (the result is unused, so it compiles to a reduction that does
//   not wait);
// - for the recording driver, each step's new position is one packed
//   32-bit (int16 row, int16 col) store and its alive flag one byte, into
//   the chunk's emission buffer; both pointers are null on the counts-only
//   path.
// - a null table is the directed random walk (ssrs_tpu's step without a
//   table, ssrs_tpu/agents/simulate.py:510-515): the weights of every cell
//   are the prior with its center zeroed, taken from shared memory, and no
//   table byte is read; the branch is uniform over the launch.
// The arithmetic is fused_step.cu's, in the same order, and the build
// passes -fmad=false, so the moves equal the plain PyTorch version's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxMemory = 8;

__device__ __forceinline__ float load_weight(const float* table, int64_t i) {
  return __ldg(table + i);
}

__device__ __forceinline__ float load_weight(const __nv_bfloat16* table,
                                             int64_t i) {
  return __bfloat162float(__ldg(table + i));
}

__device__ __forceinline__ uint32_t pack_rc(int r, int c) {
  return static_cast<uint32_t>(static_cast<uint16_t>(r)) |
         (static_cast<uint32_t>(static_cast<uint16_t>(c)) << 16);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_chunk_kernel(const T* __restrict__ table,      // (nrow*ncol, 9) or null
                   const float* __restrict__ restr,  // (9, 9) row m: allowed after move m
                   const float* __restrict__ dirp,   // (9,) directional prior
                   int32_t* __restrict__ r,          // (n,) carried row, updated
                   int32_t* __restrict__ c,          // (n,) carried col, updated
                   int32_t* __restrict__ mem,        // (max(k,1), n) oldest first, updated
                   bool* __restrict__ alive,         // (n,) updated
                   bool* __restrict__ palive,        // (n,) updated
                   const float* __restrict__ u,      // (steps, n) uniforms in [0, 1)
                   int32_t* __restrict__ presence,   // (nrow, ncol), added into
                   uint32_t* __restrict__ emit_pos,  // (steps, n) packed (r, c) or null
                   bool* __restrict__ emit_alive,    // (steps, n) or null
                   int n, int nrow, int ncol, int memory_k, float nu,
                   int s0, int steps, int burnin, int nsteps) {
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

  int ri = r[i];
  int ci = c[i];
  bool al = alive[i];
  bool pal = palive[i];
  int ring[kMaxMemory];
#pragma unroll
  for (int k = 0; k < kMaxMemory; ++k) {
    ring[k] = k < memory_k ? mem[static_cast<int64_t>(k) * n + i] : 4;
  }

  float u_next = al ? __ldcs(u + i) : 0.f;
  int t = 0;
  for (; t < steps; ++t) {
    // dead and nothing pending: the state is final
    if (!al && !pal) break;
    const int s = s0 + t;
    // this step's alive flag and the cell the move starts from
    int pri = ri;
    int pci = ci;
    bool a;
    if (s >= nsteps) {
      a = false;
    } else if (s > burnin) {
      a = al && ri > 0 && ri < nrow - 1 && ci > 0 && ci < ncol - 1;
    } else {
      // burn-in boundary push; rows pushed when <= 1, cols when <= 0
      a = al;
      pri = ri <= 1 ? ri + 2 : (ri >= nrow - 2 ? ri - 2 : ri);
      pci = ci <= 0 ? ci + 2 : (ci >= ncol - 2 ? ci - 2 : ci);
    }

    // delayed presence: the carried position, weighted by the previous
    // step's alive flag (cells off the grid count nothing)
    if (pal && ri >= 0 && ri < nrow && ci >= 0 && ci < ncol) {
      atomicAdd(presence + static_cast<int64_t>(ri) * ncol + ci, 1);
    }

    if (a) {
      const float u_t = u_next;
      if (t + 1 < steps) {
        u_next = __ldcs(u + static_cast<int64_t>(t + 1) * n + i);
      }
      float p[9];
      if (table != nullptr) {
        const int64_t row = (static_cast<int64_t>(pri) * ncol + pci) * 9;
#pragma unroll
        for (int j = 0; j < 9; ++j) p[j] = load_weight(table, row + j);
      } else {
        // no table (the directed random walk): every cell's weights are
        // the directional prior with the center zeroed, in float32
#pragma unroll
        for (int j = 0; j < 9; ++j) p[j] = j == 4 ? 0.f : s_dirp[j];
      }

      // fallback cascade (ssrs/movmodel.py:233-241); the NaN/clip/center
      // prologue is already folded into the table
      if (memory_k > 0) {
        float mask[9];
#pragma unroll
        for (int j = 0; j < 9; ++j) mask[j] = 1.f;
#pragma unroll
        for (int k = 0; k < kMaxMemory; ++k) {
          if (k < memory_k) {
            const float* mrow = s_restr + 9 * ring[k];
#pragma unroll
            for (int j = 0; j < 9; ++j) mask[j] *= mrow[j];
          }
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
          for (int j = 0; j < 9; ++j) {
            p[j] = (j == 4 ? 0.f : s_dirp[j]) * mask[j];
          }
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

      // inverse-CDF draw: mi = #{j : cum_j < max(u, tiny) * total}, capped
      // at 8
      float total = 0.f;
#pragma unroll
      for (int j = 0; j < 9; ++j) total += p[j];
      const float thresh = fmaxf(u_t, FLT_MIN) * total;
      float cum = 0.f;
      int cnt = 0;
#pragma unroll
      for (int j = 0; j < 9; ++j) {
        cum += p[j];
        cnt += cum < thresh ? 1 : 0;
      }
      const int mi = cnt < 8 ? cnt : 8;

      ri = pri + mi / 3 - 1;
      ci = pci + mi % 3 - 1;
      // ring shift: oldest out, this move in at row memory_k - 1
#pragma unroll
      for (int k = 0; k < kMaxMemory; ++k) {
        if (k + 1 < memory_k) {
          ring[k] = ring[k + 1];
        } else if (k + 1 == memory_k) {
          ring[k] = mi;
        }
      }
    }
    al = a;
    pal = a;
    if (emit_pos != nullptr) {
      const int64_t o = static_cast<int64_t>(t) * n + i;
      emit_pos[o] = pack_rc(ri, ci);
      emit_alive[o] = a;
    }
  }
  // the rows after an early exit: the final cell, not alive
  if (emit_pos != nullptr) {
    const uint32_t last = pack_rc(ri, ci);
    for (; t < steps; ++t) {
      const int64_t o = static_cast<int64_t>(t) * n + i;
      emit_pos[o] = last;
      emit_alive[o] = false;
    }
  }

  r[i] = ri;
  c[i] = ci;
  alive[i] = al;
  palive[i] = pal;
#pragma unroll
  for (int k = 0; k < kMaxMemory; ++k) {
    if (k < memory_k) mem[static_cast<int64_t>(k) * n + i] = ring[k];
  }
}

template <typename T>
int launch(const void* table, const void* restr, const void* dirp, void* r,
           void* c, void* mem, void* alive, void* palive, const void* u,
           void* presence, void* emit_pos, void* emit_alive, int n, int nrow,
           int ncol, int memory_k, float nu, int s0, int steps, int burnin,
           int nsteps, void* stream) {
  if (memory_k < 0 || memory_k > kMaxMemory) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 0 || steps <= 0) return static_cast<int>(cudaGetLastError());
  const int blocks = (n + kThreads - 1) / kThreads;
  fused_chunk_kernel<T><<<blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(table), static_cast<const float*>(restr),
      static_cast<const float*>(dirp), static_cast<int32_t*>(r),
      static_cast<int32_t*>(c), static_cast<int32_t*>(mem),
      static_cast<bool*>(alive), static_cast<bool*>(palive),
      static_cast<const float*>(u), static_cast<int32_t*>(presence),
      static_cast<uint32_t*>(emit_pos), static_cast<bool*>(emit_alive), n,
      nrow, ncol, memory_k, nu, s0, steps, burnin, nsteps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes. Each enqueues one launch on `stream`
// and returns cudaGetLastError() (0 = cudaSuccess).
extern "C" int ssrs_fused_chunk_f32(
    const void* table, const void* restr, const void* dirp, void* r, void* c,
    void* mem, void* alive, void* palive, const void* u, void* presence,
    void* emit_pos, void* emit_alive, int n, int nrow, int ncol, int memory_k,
    float nu, int s0, int steps, int burnin, int nsteps, void* stream) {
  return launch<float>(table, restr, dirp, r, c, mem, alive, palive, u,
                       presence, emit_pos, emit_alive, n, nrow, ncol,
                       memory_k, nu, s0, steps, burnin, nsteps, stream);
}

extern "C" int ssrs_fused_chunk_bf16(
    const void* table, const void* restr, const void* dirp, void* r, void* c,
    void* mem, void* alive, void* palive, const void* u, void* presence,
    void* emit_pos, void* emit_alive, int n, int nrow, int ncol, int memory_k,
    float nu, int s0, int steps, int burnin, int nsteps, void* stream) {
  return launch<__nv_bfloat16>(table, restr, dirp, r, c, mem, alive, palive,
                               u, presence, emit_pos, emit_alive, n, nrow,
                               ncol, memory_k, nu, s0, steps, burnin, nsteps,
                               stream);
}
