"""Build and load the port's CUDA kernels, and count their launches.

The kernels live in `evo_tpu_torch/csrc/*.cu` with a plain C interface.
At first use, each source is compiled by its own `nvcc` process (all
started together) for `sm_90a`, the objects are linked into one shared
library, and the library is loaded with ctypes. The attention kernels'
TMA tensor maps are encoded by `cuTensorMapEncodeTiled`, which they look
up in libcuda at run time (`cudaGetDriverEntryPoint`), so nothing links
`-lcuda`. The library's file name carries a hash of the sources and
flags, so a changed source rebuilds. Output goes to
`evo_tpu_torch/build/`, which `.gitignore` lists. A failed build raises;
nothing falls back.

Every wrapper adds one to `LAUNCHES[name]` where it launches its kernel
and nowhere else, so a run can show that its path went through the
kernels.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / 'csrc'
BUILD_DIR = _PKG / 'build'
SOURCES = ('rmsnorm.cu', 'fir_gate.cu', 'flash_attention.cu',
           'flash_attention_buffer.cu', 'int4_matmul.cu', 'int4_dots8.cu',
           'hyena_mixer.cu', 'modal_prefix.cu', 'mlp_gate.cu')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

LAUNCHES: collections.Counter = collections.Counter()

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_SIGNATURES = {
    # (x, w, y, rows, cols, eps, stream)
    'evo_rmsnorm_bf16': (_P, _P, _P, _I, _I, _F, _P),
    'evo_rmsnorm_bf16_wf32': (_P, _P, _P, _I, _I, _F, _P),
    # (zl, w, fir_b, b_in, tail, x2, u, B, C, L, K, stream)
    'evo_fir_gate_bf16': (*(_P,) * 7, _I, _I, _I, _I, _P),
    'evo_fir_gate_bf16_wf32': (*(_P,) * 7, _I, _I, _I, _I, _P),
    # (q, k, v, o, B, L, H, q/k/v batch, seq and head strides, scale, stream)
    'evo_flash_attention_bf16': (_P, _P, _P, _P, _I, _I, _I, *(_L,) * 9, _F,
                                 _P),
    # (q, k, v, offsets, o, B, Lq, T, H, q/k/v batch, position and head
    # strides, scale, stream)
    'evo_flash_attention_buffer_bf16': (_P, _P, _P, _P, _P, _I, _I, _I, _I,
                                        *(_L,) * 9, _F, _P),
    # (q, k, v, ks, vs, offsets, o, B, Lq, T, H, strides, scale, stream)
    'evo_flash_attention_buffer_q8': (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                      _I, *(_L,) * 9, _F, _P),
    # (q, k, v, offsets or null, offset0, m, l, acc, B, Lq, T, H, strides,
    # S, scale, stream)
    'evo_flash_attention_buffer_bf16_split': (*(_P,) * 4, _I, *(_P,) * 3,
                                              _I, _I, _I, _I, *(_L,) * 9, _I,
                                              _F, _P),
    # (q, k, v, ks, vs, offsets or null, offset0, m, l, acc, B, Lq, T, H,
    # strides, S, scale, stream)
    'evo_flash_attention_buffer_q8_split': (*(_P,) * 6, _I, *(_P,) * 3, _I,
                                            _I, _I, _I, *(_L,) * 9, _I, _F,
                                            _P),
    # (m, l, acc, o, B, H, Lq, S, stream)
    'evo_combine_partials': (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    # (x, packed, scales, y, partials, tickets, M, K, Kp, N, bf16 output,
    # streaming design, 'block' mode, blocks of the wgmma design, stream)
    'evo_int4_matmul_bf16': (*(_P,) * 6, *(_I,) * 8, _P),
    # (x, packed, scales, y, xq, xs, partials, tickets, M, K, Kp, N, steps
    # a block of the streaming design, blocks of the wgmma design, bf16
    # output, stream)
    'evo_int4_dots8_bf16': (*(_P,) * 8, *(_I,) * 7, _P),
    # (zl, fir_w, fir_b, b_in, poles, residues, d_skip, fir0, st0, y, iir,
    # B, C, L, Ct, S, KF, stream)
    'evo_hyena_mixer_bf16': (*(_P,) * 11, _I, _I, _L, _I, _I, _I, _P),
    'evo_hyena_mixer_bf16_wf32': (*(_P,) * 11, _I, _I, _L, _I, _I, _I, _P),
    # (inj_r, inj_i, logmag, theta, s0, ent_r, ent_i, fin_r, fin_i, B, D,
    # K, S, batch and channel strides, chunk, stream)
    'evo_modal_prefix_f32': (*(_P,) * 9, _I, _I, _I, _I, _L, _L, _F, _P),
    # (x, w1, w2, out, M, D, I, act, stream)
    'evo_mlp_gate_bf16': (_P, _P, _P, _P, _I, _I, _I, _I, _P),
}

# an entry point returns this plus the CUresult of cuTensorMapEncodeTiled
# when cuTensorMapEncodeTiled refuses a tensor map (`csrc/sm90.cuh`)
_ENCODE_ERROR = 1000

_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    found = shutil.which('nvcc')
    if found:
        return found
    cand = Path(os.environ.get('CUDA_HOME', '/usr/local/cuda')) / 'bin' / 'nvcc'
    if cand.exists():
        return str(cand)
    raise RuntimeError('nvcc not found: the CUDA kernels of evo_tpu_torch '
                       'are built from source at first use on the GPU')


def source_digest() -> str:
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob('*.cu')) + sorted(CSRC.glob('*.cuh')):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f'libevo_kernels_{source_digest()}.so'


def build() -> Path:
    """Compile the sources in parallel and link them into one library;
    returns its path. Writes the compilers' output (`-Xptxas -v`: registers,
    shared memory, spills per kernel) beside it as `.log`."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in SOURCES:
            obj = Path(tmp) / (src + '.o')
            cmd = [nvcc, *NVCC_FLAGS, '-c', str(CSRC / src), '-o', str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log, failed = [], []
        for src, _obj, proc in procs:
            out, _ = proc.communicate()
            log.append(f'== {src} (rc {proc.returncode})\n{out}')
            if proc.returncode:
                failed.append(src)
        if failed:
            raise RuntimeError(f'nvcc failed on {failed}:\n' + '\n'.join(log))
        tmp_so = Path(tmp) / so.name
        link = subprocess.run(
            [nvcc, '-shared', '-o', str(tmp_so)]
            + [str(obj) for _s, obj, _p in procs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log.append(f'== link (rc {link.returncode})\n{link.stdout}')
        if link.returncode:
            raise RuntimeError('nvcc link failed:\n' + '\n'.join(log))
        so.with_suffix('.log').write_text('\n'.join(log))
        os.replace(tmp_so, so)
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def launch(name: str, counter: str, *args) -> None:
    """Call kernel entry `name` with `args` on the current CUDA stream,
    raise on a non-zero cudaError_t, and count the launch. The stream's
    handle comes from `torch._C._cuda_getCurrentRawStream` where the build
    has it, which makes no Stream object: the host's time around a short
    kernel is part of its callers' time."""
    import torch
    fn = getattr(library(), name)
    raw = getattr(torch._C, '_cuda_getCurrentRawStream', None)
    stream = (raw(torch.cuda.current_device()) if raw is not None
              else torch.cuda.current_stream().cuda_stream)
    err = fn(*args, ctypes.c_void_p(stream))
    if err >= _ENCODE_ERROR:
        raise RuntimeError(f'{name}: cuTensorMapEncodeTiled refused a TMA '
                           f'tensor map: CUresult {err - _ENCODE_ERROR}')
    if err:
        raise RuntimeError(f'{name} failed to launch: cudaError_t {err}')
    LAUNCHES[counter] += 1


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The SMs of CUDA card `index`, for kernels whose grids follow it."""
    import torch
    return torch.cuda.get_device_properties(index).multi_processor_count


def check_device(t, what: str) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (take the plain version); anything else raises."""
    if t.device.type == 'cuda':
        return True
    if t.device.type == 'cpu':
        return False
    raise ValueError(f'{what}: unsupported device {t.device}')
