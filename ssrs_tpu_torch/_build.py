"""Build and load the port's CUDA kernels.

At first use, every source in ``ssrs_tpu_torch/csrc/`` is compiled by
``nvcc`` for Hopper (``sm_90a``) into one shared library with a plain C
interface, which is loaded with ``ctypes``. The library goes to
``build/ssrs_tpu_torch/`` beside the package (git ignores ``build/``)
and is named by a hash of the sources and the flags, so an edited source
is rebuilt and an unchanged one is loaded as it is. A failed build
raises with nvcc's output: nothing runs without its kernel.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(PKG_DIR, 'csrc')
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), 'build', 'ssrs_tpu_torch')

NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-fmad=false', '-Xptxas', '-v', '-shared',
              '-Xcompiler', '-fPIC')

# what the last call to load_library did: seconds spent building (0 when
# the library was already built) and nvcc's output (ptxas register,
# shared-memory, stack-frame and spill report), which is kept beside the
# library as ``<library>.log``
build_info = {'seconds': 0.0, 'log': '', 'path': ''}


def _sources():
    names = sorted(f for f in os.listdir(CSRC_DIR)
                   if f.endswith(('.cu', '.cuh')))
    return [os.path.join(CSRC_DIR, f) for f in names]


def _nvcc() -> str:
    found = shutil.which('nvcc')
    if found:
        return found
    for root in (os.environ.get('CUDA_HOME'), '/usr/local/cuda'):
        if root and os.path.isfile(os.path.join(root, 'bin', 'nvcc')):
            return os.path.join(root, 'bin', 'nvcc')
    raise RuntimeError('nvcc not found: the CUDA kernels of ssrs_tpu_torch '
                       'need the CUDA toolkit to build')


def library_path() -> str:
    digest = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for path in _sources():
        digest.update(os.path.basename(path).encode())
        with open(path, 'rb') as fobj:
            digest.update(fobj.read())
    return os.path.join(BUILD_DIR,
                        f'libssrs_kernels_{digest.hexdigest()[:16]}.so')


def _compile(out_path: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    units = [p for p in _sources() if p.endswith('.cu')]
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, '-o', tmp, *units]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f'nvcc failed ({proc.returncode}): '
                           f'{" ".join(cmd)}\n{proc.stderr}{proc.stdout}')
    with open(out_path + '.log', 'w', encoding='utf-8') as fobj:
        fobj.write(proc.stderr + proc.stdout)
    os.replace(tmp, out_path)  # atomic: a concurrent process never sees half
    build_info['seconds'] = time.perf_counter() - t0


def _declare(lib: ctypes.CDLL) -> None:
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for name in ('ssrs_fused_step_f32', 'ssrs_fused_step_bf16'):
        fn = getattr(lib, name)
        # table restr dirp pr pc r c alive palive mem u new_r new_c
        # new_mem presence, n nrow ncol memory_k, nu, stream
        fn.argtypes = [ptr] * 15 + [i32] * 4 + [f32, ptr]
        fn.restype = i32
    for name in ('ssrs_fused_chunk_f32', 'ssrs_fused_chunk_bf16'):
        fn = getattr(lib, name)
        # table restr dirp r c mem alive palive u presence emit_pos
        # emit_alive, n nrow ncol memory_k, nu, s0 steps burnin nsteps,
        # stream
        fn.argtypes = [ptr] * 12 + [i32] * 4 + [f32] + [i32] * 4 + [ptr]
        fn.restype = i32
    i64 = ctypes.c_int64
    # rows cols weights acc out, n nrow ncol, stream
    lib.ssrs_presence_hist_weighted.argtypes = [ptr] * 5 + [i64, i32, i32,
                                                           ptr]
    lib.ssrs_presence_hist_weighted.restype = i32
    for name in ('ssrs_presence_hist_count_i16',
                 'ssrs_presence_hist_count_i32'):
        fn = getattr(lib, name)
        # rows cols out, n nrow ncol, stream
        fn.argtypes = [ptr] * 3 + [i64, i32, i32, ptr]
        fn.restype = i32
    # rows cols palive presence cleared, n nrow ncol, stream
    lib.ssrs_presence_flush.argtypes = [ptr] * 5 + [i64, i32, i32, ptr]
    lib.ssrs_presence_flush.restype = i32
    # rows cols scratch out, n nrow ncol elem_bytes bands shares band,
    # stream
    lib.ssrs_presence_count_bands.argtypes = [ptr] * 4 + [i64] + \
        [i32] * 6 + [ptr]
    lib.ssrs_presence_count_bands.restype = i32


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library."""
    path = library_path()
    if not os.path.isfile(path):
        _compile(path)
    build_info['path'] = path
    if os.path.isfile(path + '.log'):
        with open(path + '.log', encoding='utf-8') as fobj:
            build_info['log'] = fobj.read()
    lib = ctypes.CDLL(path)
    _declare(lib)
    return lib
