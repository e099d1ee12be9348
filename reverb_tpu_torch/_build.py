"""Build and load the package's hand-written CUDA kernels.

Every `csrc/*.cu` file is compiled by its own `nvcc` process, all started
together, and the objects are linked into ONE shared library with a plain C
interface (`sm_90a`, no PyTorch headers, so the build takes seconds) that
is loaded with `ctypes`.  The library lives in `_build/` beside this file,
keyed by a hash of the sources and flags: a changed source rebuilds it, an
unchanged one is loaded as it is.  Nothing here runs at import time — the
first kernel launch builds — and a failed build or load raises.

No `--use_fast_math`: the beam kernel's parity with its plain PyTorch version
needs IEEE `expf`/`log1pf`, and its rank count compares against the next f32
below a value, which may be a denormal (no flush-to-zero).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / 'csrc'
_OUT = Path(__file__).resolve().parent / '_build'
_NAME = 'libreverb_kernels'
_ARCH = ['-gencode', 'arch=compute_90a,code=sm_90a']
_FLAGS = _ARCH + ['-std=c++17', '-O3', '-Xcompiler', '-fPIC', '-lineinfo',
                  '-Xptxas', '-v']

_lock = threading.Lock()
_lib = None
# wall seconds the last `build` call took (None: loaded as built)
build_seconds = None
# nvcc's messages of the last library `build` returned (ptxas registers,
# shared memory, spills), kept beside it so a process that loads it as
# built reads them too
build_log = ''

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_F = ctypes.c_float
_SIGNATURES = {
    # dtype, q k v p u vb kv_lens mask out lse, B H Tq Tk, strides (host
    # int64[23]), scale, keep_scale, stream
    'reverb_rel_pos_attention_fwd': [_I] + [_P] * 10 + [_I] * 4
                                    + [_P, _F, _F, _P],
    # dtype, q k v p u vb kv_lens mask out g lse D dq dk dv dp_rows du_part
    # dvb_part, B H Tq Tk, strides, scale, keep_scale, stream
    'reverb_rel_pos_attention_bwd': [_I] + [_P] * 18 + [_I] * 4
                                    + [_P, _F, _F, _P],
    # C → rows per block of the LayerNorm kernels
    'reverb_layer_norm_rows_per_block': [_I],
    # dtype, x w b y, N C, eps, stream
    'reverb_layer_norm_fwd': [_I] + [_P] * 4 + [_I] * 2 + [_F, _P],
    # dtype, x w g dx part_w part_b dw db, N C blocks iters, eps, stream
    'reverb_layer_norm_bwd': [_I] + [_P] * 8 + [_I] * 4 + [_F, _P],
    # chunk → dynamic shared-memory bytes of the beam scan
    'reverb_beam_scan_smem_bytes': [_I],
    # chunk, K, L, out_on_chip → the same of the backtrace
    'reverb_beam_backtrace_smem_bytes': [_I] * 4,
    # logp idx ts valid bacc hskip, state_in (NULL or the 8 state arrays),
    # next_tab score_tab (NULL, or K2b's (S, V) context tables), records (8
    # emit arrays then wval), finals (the 8 state arrays; K2b: then ctx and
    # cum), B T K K2 blank_id chunk S V, stream
    'reverb_beam_scan_forward': [_P] * 11 + [_I] * 8 + [_P],
    # 8 emit arrays, wval, order, sel_ns, prefixes, times, B T K L, chunk
    # smem_bytes out_on_chip, stream
    'reverb_beam_backtrace': [_P] * 13 + [_I] * 7 + [_P],
}


def _nvcc() -> str:
    home = os.environ.get('CUDA_HOME') or os.environ.get('CUDA_PATH')
    if home and (Path(home) / 'bin' / 'nvcc').exists():
        return str(Path(home) / 'bin' / 'nvcc')
    found = shutil.which('nvcc')
    if found:
        return found
    default = Path('/usr/local/cuda/bin/nvcc')
    if default.exists():
        return str(default)
    raise RuntimeError('nvcc not found (set CUDA_HOME); the CUDA kernels '
                       'cannot be built')


def _digest(csrc: Path) -> str:
    h = hashlib.sha256(' '.join(_FLAGS).encode())
    for p in sorted(csrc.glob('*.cu')) + sorted(csrc.glob('*.cuh')):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def commands(csrc: Path, out: Path, nvcc: str = 'nvcc', tag: str = 'tmp'):
    """The build's nvcc command lines, from the directory listing alone: one
    compile of each `csrc/*.cu` (its `.cuh` headers beside it) into an
    object under `out`, then one link of the objects into
    `out/libreverb_kernels.<tag>.so`.  Returns ([argv of each compile],
    argv of the link)."""
    csrc, out = Path(csrc), Path(out)
    srcs = sorted(csrc.glob('*.cu'))
    objs = [out / f'{src.stem}.{tag}.o' for src in srcs]
    compiles = [[nvcc, *_FLAGS, '-c', '-o', str(obj), str(src)]
                for src, obj in zip(srcs, objs)]
    link = [nvcc, *_ARCH, '-shared', '-o', str(out / f'{_NAME}.{tag}.so'),
            *map(str, objs)]
    return compiles, link


def build(csrc: Path = _CSRC, out: Path = _OUT) -> Path:
    """Compile the kernels of `csrc` into `out` unless a library for these
    sources exists there.  Returns the library path."""
    global build_seconds, build_log
    csrc, out = Path(csrc), Path(out)
    digest = _digest(csrc)
    lib = out / f'{_NAME}.so'
    stamp = out / f'{_NAME}.hash'
    log = out / f'{_NAME}.log'
    if lib.exists() and stamp.exists() and stamp.read_text() == digest:
        build_log = log.read_text() if log.exists() else ''
        build_seconds = None
        return lib
    out.mkdir(parents=True, exist_ok=True)
    tag = f'{os.getpid()}.tmp'
    t0 = time.perf_counter()
    compiles, link = commands(csrc, out, _nvcc(), tag)
    if not compiles:
        raise RuntimeError(f'no CUDA sources in {csrc}')
    procs = [subprocess.Popen(argv, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for argv in compiles]
    logs, failed = [], []
    for argv, proc in zip(compiles, procs):
        name = Path(argv[-1]).name
        res_out, err = proc.communicate()
        logs.append(f'== {name}\n{res_out}{err}')
        if proc.returncode != 0:
            failed.append(f'{name} ({proc.returncode}):\n{err}')
    build_log = ''.join(logs)
    tmp = Path(link[link.index('-o') + 1])
    try:
        if failed:
            raise RuntimeError('nvcc failed: ' + '\n'.join(failed))
        res = subprocess.run(link, capture_output=True, text=True,
                             check=False)
        if res.returncode != 0:
            raise RuntimeError(f'nvcc link failed ({res.returncode}):\n'
                               f'{res.stderr}')
    finally:
        for argv in compiles:
            Path(argv[-2]).unlink(missing_ok=True)
    # atomic: concurrent loaders see either the old or the new file
    os.replace(tmp, lib)
    log.write_text(build_log)
    stamp.write_text(digest)
    build_seconds = time.perf_counter() - t0
    return lib


def load_from(csrc: Path, out: Path, signatures=None):
    """The kernel library built from `csrc` into `out`, loaded as a handle
    of its own with the C signatures: the package's (`load`), or another
    checkout's for an A/B, which leaves the package's as it is.  Another
    checkout whose entry points differ passes its own `signatures`."""
    lib = ctypes.CDLL(str(build(csrc, out)))
    for name, argtypes in (signatures or _SIGNATURES).items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def load():
    """The package's kernel library (built on first use).  Once it is
    loaded this is a read of a global: no lock on the launch path."""
    global _lib
    lib = _lib
    if lib is None:
        with _lock:
            if _lib is None:
                _lib = load_from(_CSRC, _OUT)
            lib = _lib
    return lib


def check(rc: int, name: str):
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if rc != 0:
        raise RuntimeError(f'{name}: CUDA error {rc} at launch')
