"""Build and bind the durable storage engine (``hgstore.cpp``).

:func:`lib` returns the loaded engine, compiling it with ``g++`` at first
use in a process (never at import) into ``build/native/`` at the
repository root. The library's file name carries a hash of its source and
flags, so a stale build is never loaded and no file time is trusted.
Concurrent builders (test workers, child processes) each compile to a name
of their own and publish with ``os.replace``. A failed build raises
:class:`NativeBuildError` with the compiler's output: nothing opens in
memory instead.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from hypergraphdb_tpu_torch.core.errors import HGException

SRC = Path(__file__).resolve().parent / "hgstore.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-std=c++17", "-O2", "-fPIC", "-shared")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
#: wall seconds this process spent compiling (0.0 where a build existed)
last_build_seconds: float = 0.0


class NativeBuildError(HGException):
    pass


def lib_path() -> Path:
    """Where the build of the current source lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"libhgstore_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``hgstore.cpp`` unless its build exists; returns the path."""
    global last_build_seconds
    import time

    out = lib_path()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise NativeBuildError("g++ not found on PATH: the native storage "
                               "engine cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SRC)],
                              capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise NativeBuildError(f"g++ invocation failed: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NativeBuildError(
            f"native build failed:\n{proc.stdout[-2000:]}{proc.stderr[-4000:]}")
    os.replace(tmp, out)
    last_build_seconds = time.perf_counter() - t0
    return out


def lib() -> ctypes.CDLL:
    """The bound engine, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _bind(ctypes.CDLL(str(build())))
        return _lib


def _bind(L: ctypes.CDLL) -> ctypes.CDLL:
    i64 = ctypes.c_int64
    u32 = ctypes.c_uint32
    u64 = ctypes.c_uint64
    p = ctypes.POINTER
    vp = ctypes.c_void_p
    cp = ctypes.c_char_p

    L.hgs_open.argtypes = [cp]
    L.hgs_open.restype = vp
    L.hgs_close.argtypes = [vp]
    L.hgs_checkpoint.argtypes = [vp]
    L.hgs_checkpoint.restype = ctypes.c_int
    L.hgs_wal_ok.argtypes = [vp]
    L.hgs_wal_ok.restype = ctypes.c_int
    L.hgs_batch_begin.argtypes = [vp]
    L.hgs_batch_commit.argtypes = [vp]
    L.hgs_batch_abort.argtypes = [vp]
    L.hgs_free.argtypes = [vp]
    L.hgs_max_handle.argtypes = [vp]
    L.hgs_max_handle.restype = i64

    L.hgs_store_link.argtypes = [vp, i64, p(i64), u32]
    L.hgs_get_link.argtypes = [vp, i64, p(p(i64)), p(u32)]
    L.hgs_get_link.restype = ctypes.c_int
    L.hgs_remove_link.argtypes = [vp, i64]
    L.hgs_contains_link.argtypes = [vp, i64]
    L.hgs_contains_link.restype = ctypes.c_int
    L.hgs_link_count.argtypes = [vp]
    L.hgs_link_count.restype = u32
    L.hgs_bulk_links.argtypes = [vp, p(p(i64)), p(p(i64)), p(p(i64)),
                                 p(u64), p(u64)]

    L.hgs_store_data.argtypes = [vp, i64, cp, u32]
    L.hgs_get_data.argtypes = [vp, i64, p(cp), p(u32)]
    L.hgs_get_data.restype = ctypes.c_int
    L.hgs_remove_data.argtypes = [vp, i64]

    L.hgs_inc_add.argtypes = [vp, i64, i64]
    L.hgs_inc_remove.argtypes = [vp, i64, i64]
    L.hgs_inc_clear.argtypes = [vp, i64]
    L.hgs_inc_get.argtypes = [vp, i64, p(p(i64)), p(u32)]
    L.hgs_inc_count.argtypes = [vp, i64]
    L.hgs_inc_count.restype = u32

    L.hgs_idx_add.argtypes = [vp, cp, cp, u32, i64]
    L.hgs_idx_remove.argtypes = [vp, cp, cp, u32, i64]
    L.hgs_idx_remove_all.argtypes = [vp, cp, cp, u32]
    L.hgs_idx_drop.argtypes = [vp, cp]
    L.hgs_idx_touch.argtypes = [vp, cp]
    L.hgs_idx_exists.argtypes = [vp, cp]
    L.hgs_idx_exists.restype = ctypes.c_int
    L.hgs_idx_find.argtypes = [vp, cp, cp, u32, p(p(i64)), p(u32)]
    L.hgs_idx_range.argtypes = [
        vp, cp, cp, u32, ctypes.c_int, ctypes.c_int,
        cp, u32, ctypes.c_int, ctypes.c_int, p(p(i64)), p(u32),
    ]
    L.hgs_idx_key_count.argtypes = [vp, cp]
    L.hgs_idx_key_count.restype = u32
    L.hgs_idx_scan_keys.argtypes = [vp, cp, p(cp), p(u32), p(u32)]
    L.hgs_idx_find_by_value.argtypes = [vp, cp, i64, p(cp), p(u32), p(u32)]
    L.hgs_idx_names.argtypes = [vp, p(cp), p(u32), p(u32)]
    return L
