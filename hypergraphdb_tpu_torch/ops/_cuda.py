"""Build and bind the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface and loaded with ``ctypes``. Kernels are
built at first use in a process (never at import), all sources at once, one
``nvcc`` each, into ``build/cuda_kernels/`` at the repository root. A
library's file name carries a hash of its sources and flags, so a stale build
is never loaded. Every C entry point launches on the stream it is given and
returns ``cudaGetLastError()``; :func:`check` turns a non-zero code into an
exception.
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

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "cuda_kernels"
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: C signature of each library's entry point: (symbol, argtypes)
_ENTRIES = {
    "gather_or": ("hg_gather_or",
                  [_P, _P, _P, _LL, _I, _I, _P, _P, _LL, _I, _I, _P]),
    "fused_hop": ("hg_fused_hop",
                  [_P, _P, _P, _P, _P, _LL, _I, _I, _P, _P, _I, _I, _P]),
    "membership": ("hg_membership", [_P, _P, _P, _P, _LL, _I, _P]),
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
#: wall seconds the last build_all() spent, nvcc included
last_build_seconds: float = 0.0


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(cand):
            return cand
    found = shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _lib_path(src: Path) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for dep in sorted(CSRC.glob("*.cuh")) + [src]:
        h.update(dep.read_bytes())
    return BUILD_DIR / f"lib{src.stem}_{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, Path]:
    """Compile every ``csrc/*.cu`` that has no current build, in parallel.
    Returns kernel name → library path; raises with nvcc's output if a
    source fails to compile. The ptxas report of each build is kept beside
    its library as ``.log``."""
    global last_build_seconds
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out: dict[str, Path] = {}
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        lib = _lib_path(src)
        out[src.stem] = lib
        if lib.exists():
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((src, lib, tmp, proc))
    failures = []
    for src, lib, tmp, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed on {src.name}:\n{log}")
            continue
        lib.with_suffix(".log").write_text(log)
        os.replace(tmp, lib)
    last_build_seconds = time.perf_counter() - t0
    if failures:
        raise RuntimeError("\n".join(failures))
    return out


def kernel(name: str):
    """The bound C entry point of kernel ``name`` (building on first use)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            paths = build_all()
            for stem, path in paths.items():
                if stem not in _libs:
                    _libs[stem] = ctypes.CDLL(str(path))
            lib = _libs[name]
    symbol, argtypes = _ENTRIES[name]
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def stream_of(t) -> int:
    """The raw CUDA stream handle PyTorch is using for ``t``'s device."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def ptr(t) -> int | None:
    """``t.data_ptr()``, or None (a null pointer) for no tensor."""
    return None if t is None else t.data_ptr()


def check_rows(idx, n_rows: int, what: str) -> None:
    """Raise unless every entry of ``idx`` is a row id in ``[0, n_rows)``:
    a kernel would read out of bounds. One reduction and one sync."""
    if idx.numel():
        lo, hi = (int(v) for v in idx.aminmax())
        if lo < 0 or hi >= n_rows:
            raise ValueError(f"{what}: row ids span [{lo}, {hi}], outside "
                             f"[0, {n_rows})")


def check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error {code}")
