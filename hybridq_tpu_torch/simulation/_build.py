"""Build the CUDA kernels of ``hybridq_tpu_torch/csrc`` at first use.

Each ``csrc/<name>.cu`` has a plain C interface; ``nvcc`` compiles it into
``hybridq_tpu_torch/_build/lib<name>-<hash>.so`` (the hash covers the
source, the shared ``csrc/*.cuh`` headers and the flags, so an edited
source or header is rebuilt) and ``ctypes`` loads
it.  All sources are compiled at once, one ``nvcc`` process each.  A build
failure raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ['load', 'build_all', 'nvcc_path']

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / 'csrc'
BUILD_DIR = _PKG / '_build'
FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
         '-shared', '-Xcompiler', '-fPIC', '-Xptxas=-v']

_LIBS: dict = {}
LOGS: dict = {}          # source name -> compiler output of the last build
_LOCK = threading.Lock()


def nvcc_path() -> str:
    for cand in (os.environ.get('NVCC'), shutil.which('nvcc'),
                 '/usr/local/cuda/bin/nvcc'):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of "
                       "hybridq_tpu_torch are built at first use and need "
                       "the CUDA toolkit")


def _target(src: Path) -> Path:
    headers = b''.join(p.read_bytes() for p in sorted(CSRC.glob('*.cuh')))
    h = hashlib.sha256(src.read_bytes() + headers + ' '.join(FLAGS).encode())
    return BUILD_DIR / f'lib{src.stem}-{h.hexdigest()[:16]}.so'


def build_all() -> dict:
    """Compile every ``csrc/*.cu`` not yet built, all in parallel, and
    load them; returns ``{name: ctypes.CDLL}``."""
    with _LOCK:
        srcs = sorted(CSRC.glob('*.cu'))
        todo = [s for s in srcs if s.stem not in _LIBS]
        BUILD_DIR.mkdir(exist_ok=True)
        procs = []
        for src in todo:
            out = _target(src)
            if out.exists():
                continue
            tmp = out.with_suffix(f'.{os.getpid()}.tmp')
            cmd = [nvcc_path(), *FLAGS, '-o', str(tmp), str(src)]
            procs.append((src, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for src, out, tmp, p in procs:
            log, _ = p.communicate()
            LOGS[src.stem] = log
            if p.returncode != 0:
                failed.append(f"{src.name}:\n{log}")
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        for src in todo:
            _LIBS[src.stem] = ctypes.CDLL(str(_target(src)))
        return dict(_LIBS)


def load(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu``."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = build_all().get(name)
    if lib is None:
        raise RuntimeError(f"no CUDA source {CSRC / (name + '.cu')}: the "
                           "package was installed without its csrc/*.cu "
                           "and csrc/*.cuh")
    return lib
