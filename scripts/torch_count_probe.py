#!/usr/bin/env python3
"""Probe of designs for the port's count kernel (kernel C) on one CUDA GPU.

Run from the root of a checkout:

    python3 scripts/torch_count_probe.py

It times in turns, beside the port's two count kernels (the direct count
and the band count of ``ssrs_tpu_torch/csrc/presence_hist.cu``, the latter
also cut into eight bands instead of the plan's six), a design the port
does not ship, built here from the source below: a cluster of eight blocks
that holds the whole 500x600 map in its distributed shared memory, each
block one share of the cells in granules of 32 dealt round robin, every
point added into the owning block by a remote atomic; then one launch sums
the clusters' copies. Three forms of the remote add:

- ``cluster``: ``atomicAdd`` on the pointer ``map_shared_rank`` gives;
- ``cluster_red``: ``red.shared::cluster`` (no value returned) on a
  ``mapa`` address;
- ``cluster_agg``: ``atomicAdd`` once for the lanes of a warp that hit one
  cell (``__match_any_sync``).

The inputs: the points of a recorded run of the README region (10,000
tracks, 500x600, made here through ``ssrs_tpu_torch.Simulator``), uniform
points with 30% dead, 1.2M uniform points, one hot cell, and no points
(the fixed cost). Every variant is held exactly against the plain
version. It prints one line a case and, last, one JSON object with the
times.
"""

from __future__ import annotations

import ctypes
import json
import os
import pickle
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SOURCE = r'''
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cstdint>
namespace cg = cooperative_groups;

constexpr int kCluster = 8;
constexpr int kGranule = 32;
constexpr int kThreads = 1024;

// MODE 0: atomicAdd on the generic DSMEM pointer; 1: red.shared::cluster
// on a mapa address; 2: as 0, once for the lanes of a warp on one cell.
// Called by all 32 lanes of a warp together.
template <int MODE>
__device__ __forceinline__ void add(const cg::cluster_group& cluster,
                                    int32_t* smap, int r, int c, int nrow,
                                    int ncol) {
  int local = -1;
  if (r >= 0 && r < nrow && c >= 0 && c < ncol) local = r * ncol + c;
  int inc = 1;
  if (MODE == 2) {
    const unsigned peers = __match_any_sync(0xffffffffu, local);
    if (static_cast<int>(threadIdx.x & 31) != __ffs(peers) - 1) return;
    inc = __popc(peers);
  }
  if (local < 0) return;
  const int g = local / kGranule;
  const int rank = g % kCluster;
  const int idx = (g / kCluster) * kGranule + local % kGranule;
  if (MODE == 1) {
    const uint32_t here = static_cast<uint32_t>(
        __cvta_generic_to_shared(smap + idx));
    uint32_t there;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                 : "=r"(there) : "r"(here), "r"(rank));
    asm volatile("red.shared::cluster.add.u32 [%0], %1;"
                 :: "r"(there), "r"(inc) : "memory");
  } else {
    atomicAdd(cluster.map_shared_rank(smap, rank) + idx, inc);
  }
}

template <int MODE>
__global__ void __launch_bounds__(kThreads, 1)
cluster_kernel(const int16_t* __restrict__ rows,
               const int16_t* __restrict__ cols,
               int32_t* __restrict__ scratch, int64_t m, int nrow, int ncol,
               int cells_per_block) {
  extern __shared__ int32_t smap[];
  const cg::cluster_group cluster = cg::this_cluster();
  for (int i = threadIdx.x; i < cells_per_block; i += blockDim.x) smap[i] = 0;
  cluster.sync();
  const int lane = threadIdx.x & 31;
  const int64_t nthreads = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t warp0 =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x - lane;
  const int64_t nvec = m / 8;
  for (int64_t base = warp0; base < nvec; base += nthreads) {
    const int64_t v = base + lane;
    union { int4 v; int16_t e[8]; } vr, vc;
    if (v < nvec) {
      vr.v = __ldcs(reinterpret_cast<const int4*>(rows) + v);
      vc.v = __ldcs(reinterpret_cast<const int4*>(cols) + v);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) vr.e[j] = vc.e[j] = -1;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      add<MODE>(cluster, smap, vr.e[j], vc.e[j], nrow, ncol);
    }
  }
  for (int64_t base = nvec * 8 + warp0; base < m; base += nthreads) {
    const int64_t i = base + lane;
    add<MODE>(cluster, smap, i < m ? rows[i] : -1, i < m ? cols[i] : -1,
              nrow, ncol);
  }
  cluster.sync();
  int32_t* dst = scratch + static_cast<int64_t>(blockIdx.x / kCluster) *
                               kCluster * cells_per_block;
  const int rank = static_cast<int>(cluster.block_rank());
  for (int i = threadIdx.x; i < cells_per_block; i += blockDim.x) {
    const int g = (i / kGranule) * kCluster + rank;
    dst[static_cast<int64_t>(g) * kGranule + i % kGranule] = smap[i];
  }
}

__global__ void sum_kernel(const int32_t* __restrict__ scratch,
                           int32_t* __restrict__ out, int copies,
                           int64_t row, int64_t n) {
  for (int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x; j < n;
       j += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    int32_t s = 0;
    for (int k = 0; k < copies; ++k) s += __ldcs(scratch + k * row + j);
    out[j] = s;
  }
}

template <int MODE>
cudaError_t setup(int smem, cudaLaunchAttribute* attr,
                  cudaLaunchConfig_t* config, int n_clusters,
                  cudaStream_t s) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kCluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *config = {};
  config->gridDim = dim3(n_clusters * kCluster);
  config->blockDim = dim3(kThreads);
  config->dynamicSmemBytes = smem;
  config->stream = s;
  config->attrs = attr;
  config->numAttrs = 1;
  return cudaFuncSetAttribute(
      cluster_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <int MODE>
int run(const void* rows, const void* cols, void* scratch, void* out,
        int64_t m, int nrow, int ncol, int n_clusters, int cells_per_block,
        void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t config;
  cudaError_t err = setup<MODE>(cells_per_block * 4, &attr, &config,
                                n_clusters, s);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&config, cluster_kernel<MODE>,
                           static_cast<const int16_t*>(rows),
                           static_cast<const int16_t*>(cols),
                           static_cast<int32_t*>(scratch), m, nrow, ncol,
                           cells_per_block);
  if (err != cudaSuccess) return err;
  const int64_t cells = static_cast<int64_t>(nrow) * ncol;
  const int64_t b = (cells + 255) / 256;
  sum_kernel<<<static_cast<int>(b < 4096 ? b : 4096), 256, 0, s>>>(
      static_cast<const int32_t*>(scratch), static_cast<int32_t*>(out),
      n_clusters, static_cast<int64_t>(kCluster) * cells_per_block, cells);
  return cudaGetLastError();
}

// Clusters resident at once, into *n (for MODE 0).
extern "C" int probe_clusters(int cells_per_block, int* n) {
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t config;
  cudaError_t err = setup<0>(cells_per_block * 4, &attr, &config, 1, nullptr);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveClusters(n, cluster_kernel<0>, &config);
  if (err != cudaSuccess) return err;
  return *n > 0 ? 0 : cudaErrorInvalidConfiguration;
}

extern "C" int probe_cluster(int mode, const void* rows, const void* cols,
                             void* scratch, void* out, int64_t m, int nrow,
                             int ncol, int n_clusters, int cells_per_block,
                             void* stream) {
  if (mode == 1) return run<1>(rows, cols, scratch, out, m, nrow, ncol,
                               n_clusters, cells_per_block, stream);
  if (mode == 2) return run<2>(rows, cols, scratch, out, m, nrow, ncol,
                               n_clusters, cells_per_block, stream);
  return run<0>(rows, cols, scratch, out, m, nrow, ncol, n_clusters,
                cells_per_block, stream);
}
'''

NROW, NCOL = 500, 600


def _build():
    from ssrs_tpu_torch import _build as b
    out_dir = os.path.join(REPO, 'build', 'count_probe')
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(out_dir, 'probe.cu')
    with open(src, 'w', encoding='utf-8') as fobj:
        fobj.write(SOURCE)
    lib = os.path.join(out_dir, 'libprobe.so')
    proc = subprocess.run([b._nvcc(), *b.NVCC_FLAGS, '-o', lib, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        sys.exit(f'nvcc failed:\n{proc.stderr}{proc.stdout}')
    print('ptxas: ' + ' | '.join(ln.strip() for ln in proc.stderr.splitlines()
                                 if 'registers' in ln or 'spill' in ln),
          flush=True)
    cdll = ctypes.CDLL(lib)
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    cdll.probe_clusters.argtypes = [i32, ptr]
    cdll.probe_cluster.argtypes = [i32] + [ptr] * 4 + [i64] + [i32] * 4 + \
        [ptr]
    cdll.probe_clusters.restype = cdll.probe_cluster.restype = i32
    return cdll


def _device_ms(torch, fn, steps=40):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(steps):
        torch.cuda._sleep(4_000_000)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        times.append((e0, e1))
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in times]))


def _recorded_points(torch):
    """The (rows, cols) planes of a recorded run of the README region."""
    from ssrs_tpu_torch import Config, Simulator
    from ssrs_tpu_torch.agents.presence import track_points
    with tempfile.TemporaryDirectory(dir=REPO, prefix='.smoke_') as out:
        sim = Simulator(Config(
            out_dir=out, run_name='wy', southwest_lonlat=(-106.21, 42.78),
            region_width_km=(60., 50.), resolution=100., sim_mode='uniform',
            uniform_winddirn=270., uniform_windspeed=10., track_count=10_000,
            track_max_steps=10_000, sim_seed=7))
        sim.simulate_tracks()
        ident = sim._get_id_string(sim.case_ids[0], 0)
        with open(os.path.join(sim.mode_data_dir, f'{ident}_tracks.pkl'),
                  'rb') as fobj:
            tracks = pickle.load(fobj)
    return track_points(tracks, 'cuda')


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        sys.exit('no CUDA device')
    sys.path.insert(0, REPO)
    from ssrs_tpu_torch.agents import presence_hist as ph
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    lib = _build()
    dev = torch.device('cuda')
    rng = np.random.default_rng(5)
    cases = {'recorded': _recorded_points(torch)}
    for name, m in (('uniform_6.4M_30pct_dead', 6_400_000),
                    ('uniform_1.2M', 1_200_000), ('hot_cell_1M', 1_000_000),
                    ('none', 0)):
        r, c = rng.integers(0, NROW, m), rng.integers(0, NCOL, m)
        if name.endswith('dead'):
            r[rng.random(m) < 0.3] = -1
        if name.startswith('hot'):
            r[:], c[:] = 321, 77
        planes = torch.from_numpy(np.stack([r, c]).astype(np.int16)).to(dev)
        cases[name] = (planes[0], planes[1])
    # the cluster design's shares: the whole map in 8 blocks, whole
    # granules of 32 cells each
    per_block = -(-NROW * NCOL // (8 * 32)) * 32
    n = ctypes.c_int(0)
    err = lib.probe_clusters(per_block, ctypes.byref(n))
    if err:
        sys.exit(f'no cluster fits: CUDA error {err}')
    n_clusters = n.value
    plan = ph._count_plan(NROW, NCOL, 10 ** 9, ph._sms(0))
    eight = -(-NROW * NCOL // 8)
    plan8 = plan._replace(bands=8, band=eight, shares=ph._sms(0) // 8,
                          smem_bytes=eight * 4)
    out = {'n_clusters': n_clusters, 'plan': plan._asdict()}
    stream = torch.cuda.current_stream().cuda_stream
    for name, (rows, cols) in cases.items():
        if (rows.data_ptr() | cols.data_ptr()) % 16:
            sys.exit(f'{name}: the planes are not 16-byte aligned')
        m = rows.shape[0]
        want = ph.presence_histogram_batch_plain(rows, cols, NROW, NCOL)
        scratch = torch.empty((n_clusters, 8 * per_block), dtype=torch.int32,
                              device=dev)

        def cluster(mode, rows=rows, cols=cols, m=m, scratch=scratch):
            o = torch.empty((NROW, NCOL), dtype=torch.int32, device=dev)
            err = lib.probe_cluster(mode, rows.data_ptr(), cols.data_ptr(),
                                    scratch.data_ptr(), o.data_ptr(), m,
                                    NROW, NCOL, n_clusters, per_block,
                                    stream)
            if err:
                sys.exit(f'cluster mode {mode}: CUDA error {err}')
            return o

        def port(p, rows=rows, cols=cols):
            return ph.presence_histogram_batch(rows, cols, NROW, NCOL,
                                               plan=p)

        variants = {
            'direct': lambda: port(plan._replace(kernel='direct')),
            f'band{plan.bands}x{plan.shares}': lambda: port(
                plan._replace(kernel='privatized')),
            f'band8x{plan8.shares}': lambda: port(
                plan8._replace(kernel='privatized')),
            'cluster': lambda: cluster(0), 'cluster_red': lambda: cluster(1),
            'cluster_agg': lambda: cluster(2)}
        for vname, fn in variants.items():
            got = fn()
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                sys.exit(f'{name}: {vname} differs from plain')
        times = {v: [] for v in variants}
        for vname in list(variants) + list(reversed(variants)):
            times[vname].append(_device_ms(torch, variants[vname]))
        out[name] = {'points': m, 'in_grid': int(want.sum()),
                     'cells_hit': int((want > 0).sum()), 'ms': times}
        print(f'{name}: {m} points, {int(want.sum())} in the grid, '
              f'{int((want > 0).sum())} cells hit; us device in turns: '
              + ', '.join(f'{v} {t[0] * 1e3:.1f} / {t[1] * 1e3:.1f}'
                          for v, t in times.items()), flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == '__main__':
    t0 = time.perf_counter()
    rc = main()
    print(f'probe: {time.perf_counter() - t0:.1f} s', flush=True)
    sys.exit(rc)
