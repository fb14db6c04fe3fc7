"""Persistent plan cache: build a snapshot's host plans once, across
processes.

The port of ``hypergraphdb_tpu/ops/aot_cache.py``. The reference caches
compiled XLA executables, one per (entry, shape bucket, statics). The port
compiles no per-bucket executables: its CUDA libraries are built once per
source hash and shared across processes already (``ops/_cuda.py``). What
a fresh port process does rebuild is each snapshot's host plans, the pull
plans (``ellbfs.build_pull_plans``) and the fused plan
(``fused_bfs.build_fused_plan``): seconds of host work at benchmark
scale, inside the first request's deadline unless something stores them.
This module stores them, with the reference's container:

- the cache **directory** is fingerprinted by environment,
  ``<root>/<env_fingerprint()>/``: the torch version, the CUDA version,
  the card's name and a hash of ``csrc/``;
- the **entry file** is ``<entry>__<sha256 of (entry, argument
  signatures, statics, content_key)>.aot``. An entry name carries its
  plan's format version; ``content_key`` is the snapshot's
  ``ellbfs.snapshot_fingerprint``, so a restart over the same graph hits
  and one over another graph rebuilds;
- each file is a magic line, a JSON header (format, environment, entry,
  content key, build seconds) and the plan's arrays as an ``np.savez``
  payload, read back with ``allow_pickle=False``.

Invalidation, mirroring ``ellbfs.StalePlans``: a well-formed entry whose
header disagrees (format, environment, content key) is stale, a quiet
miss counted in ``stats.stale``; a damaged one is logged, counted in
``stats.corrupt`` and rebuilt. Only a damaged file's errors are caught:
an unwritable directory raises, at construction or at the store. Stores
are write-then-rename; the open-time sweep deletes superseded content
generations by age and by size, as the reference's does.
"""

from __future__ import annotations

import hashlib
import io
import json
import logging
import os
import threading
import time
import zipfile
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np

log = logging.getLogger("hypergraphdb_tpu_torch.aot")

#: bumped when the on-disk layout changes; mismatched entries are stale
FORMAT = 1

_MAGIC = b"HGAOT1\n"

#: env var naming the default cache root (the ``HG_PLAN_CACHE`` twin)
CACHE_ENV = "HG_AOT_CACHE"

#: what reading a damaged entry raises: a foreign or truncated file, a bad
#: header, a payload that is no npz or lacks a field, an unreadable path
CORRUPT_ERRORS = (OSError, ValueError, KeyError, EOFError,
                  zipfile.BadZipFile)


class StaleEntry(ValueError):
    """Well-formed cache entry for a different environment or content:
    the quiet-rebuild case, deliberately distinct from a corrupt file."""


@dataclass
class AOTStats:
    """Counters of one cache instance. ``hits``/``misses`` count build
    avoidance (a memory hit after a disk hit is still a hit: the point is
    whether the plan was built); the rest classify why a miss happened."""

    hits: int = 0
    misses: int = 0
    disk_hits: int = 0      # hits served by reading the disk entry
    mem_hits: int = 0       # hits served by the in-process memo
    stale: int = 0
    corrupt: int = 0
    puts: int = 0
    gc_removed: int = 0     # superseded entries deleted by the open sweep
    compile_s: float = 0.0  # wall seconds spent actually building

    def as_dict(self) -> dict:
        return {
            "hits": self.hits, "misses": self.misses,
            "disk_hits": self.disk_hits, "mem_hits": self.mem_hits,
            "stale": self.stale, "corrupt": self.corrupt,
            "puts": self.puts, "gc_removed": self.gc_removed,
            "compile_s": round(self.compile_s, 3),
        }


def csrc_hash() -> str:
    """sha256 of the kernel sources (``csrc/*.cu`` and ``*.cuh``)."""
    from hypergraphdb_tpu_torch.ops._cuda import CSRC

    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()


def env_fingerprint(device="cuda") -> str:
    """The environment half of the key: the torch and CUDA versions, the
    card's name (``cpu`` for the CPU) and the kernel sources' hash. Any of
    them changing moves the cache to another directory."""
    import torch

    from hypergraphdb_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    raw = (f"torch{torch.__version__}_cuda{torch.version.cuda}_{name}_"
           f"{csrc_hash()[:12]}")
    return "".join(c if c.isalnum() or c in "._-" else "_" for c in raw)


def _arg_sig(x: Any) -> str:
    """Shape and dtype of every leaf of ``x`` (tuples, lists and dicts are
    walked; a leaf without a shape is its type's name)."""
    if isinstance(x, (tuple, list)):
        return ";".join(_arg_sig(v) for v in x)
    if isinstance(x, dict):
        return ";".join(_arg_sig(x[k]) for k in sorted(x))
    shape = getattr(x, "shape", None)
    dtype = getattr(x, "dtype", type(x).__name__)
    return f"{tuple(shape) if shape is not None else ()}:{dtype}"


def _arrays(obj) -> dict:
    """The default codec's encoder: the plan is already a mapping of
    numpy arrays."""
    return dict(obj)


#: a plan's codec: (to a dict of numpy arrays, from one)
IDENTITY = (_arrays, _arrays)


@dataclass
class AOTCache:
    """One fingerprinted cache directory plus an in-process memo.

    Lookups and stores are idempotent (one key, one plan) and writes are
    atomic renames, so runtimes sharing a directory at worst build a plan
    twice."""

    root: str
    content_key: str = ""
    device: Any = "cuda"
    stats: AOTStats = field(default_factory=AOTStats)
    #: open-time sweep bounds: superseded content generations' files older
    #: than ``gc_max_age_s`` are deleted, and oldest-first beyond
    #: ``gc_max_bytes`` of directory total. ``gc_max_age_s=None`` disables
    #: the sweep.
    gc_max_age_s: Optional[float] = 7 * 86400.0
    gc_max_bytes: int = 256 * 1024 * 1024

    def __post_init__(self):
        self.dir = os.path.join(self.root, env_fingerprint(self.device))
        os.makedirs(self.dir, exist_ok=True)
        self._mem: dict[str, Any] = {}
        if self.gc_max_age_s is not None:
            self.gc()

    # -- open-time GC ---------------------------------------------------------
    def _entry_content_key(self, path: str) -> Optional[str]:
        """The entry's header content_key, reading only the magic and the
        header line; None for a damaged file (it would be rebuilt on load
        anyway, so the sweep treats it as superseded)."""
        try:
            with open(path, "rb") as f:
                if f.read(len(_MAGIC)) != _MAGIC:
                    return None
                header = json.loads(f.readline().decode("utf-8"))
        except (OSError, ValueError):
            return None
        if not isinstance(header, dict):
            return None
        return str(header.get("content_key", ""))

    def gc(self, now: Optional[float] = None) -> int:
        """Sweep the cache directory (called at open): delete entries of
        SUPERSEDED content generations, files whose header content_key
        differs from this cache's, once older than ``gc_max_age_s``, then
        oldest superseded first while the directory's total exceeds
        ``gc_max_bytes``. Current-generation entries are never touched,
        and abandoned ``*.tmp.*`` writer leftovers past the age bound go
        too. Returns how many files were removed (also counted in
        ``stats.gc_removed``)."""
        if self.gc_max_age_s is None:
            return 0  # the off switch holds for a manual call too
        if now is None:
            now = time.time()
        removed = 0
        superseded: list[tuple[float, int, str]] = []  # (mtime, size, path)
        total = 0
        for name in os.listdir(self.dir):
            path = os.path.join(self.dir, name)
            try:
                st = os.stat(path)
            except FileNotFoundError:
                continue  # removed by a concurrent sweep
            if ".tmp." in name:  # a crashed writer's leftover
                if now - st.st_mtime > self.gc_max_age_s:
                    try:
                        os.unlink(path)
                        removed += 1
                    except FileNotFoundError:
                        pass
                continue
            if not name.endswith(".aot"):
                continue
            total += st.st_size
            ck = self._entry_content_key(path)
            if ck != self.content_key:
                superseded.append((st.st_mtime, st.st_size, path))
        superseded.sort()  # oldest first
        for mtime, size, path in superseded:
            if (now - mtime <= self.gc_max_age_s
                    and total <= self.gc_max_bytes):
                continue  # young AND within budget: keep for now
            try:
                os.unlink(path)
            except FileNotFoundError:
                continue
            removed += 1
            total -= size
        self.stats.gc_removed += removed
        if removed:
            log.info("aot cache gc: removed %d superseded entries from %s",
                     removed, self.dir)
        return removed

    # -- keys -----------------------------------------------------------------
    def key_for(self, entry: str, args: tuple, statics: dict) -> str:
        h = hashlib.sha256()
        h.update(entry.encode())
        h.update(_arg_sig(args).encode())
        h.update(repr(sorted(statics.items())).encode())
        h.update(self.content_key.encode())
        safe = "".join(c if c.isalnum() or c in "._-" else "_"
                       for c in entry)[:80]
        return f"{safe}__{h.hexdigest()[:24]}"

    def _path(self, key: str) -> str:
        return os.path.join(self.dir, f"{key}.aot")

    # -- the one entry point --------------------------------------------------
    def get_or_compile(self, entry: str, build: Callable, args: tuple = (),
                       statics: Optional[dict] = None, persist: bool = True,
                       codec: tuple = IDENTITY):
        """The plan ``build(*args, **statics)`` returns: from the memory
        memo, then the disk, then a real build, stored for next time
        unless ``persist`` is False. ``codec`` is ``(encode, decode)``
        between the plan and a dict of numpy arrays (by default the plan
        is that dict)."""
        statics = statics or {}
        key = self.key_for(entry, args, statics)
        plan = self._mem.get(key)
        if plan is not None:
            self.stats.hits += 1
            self.stats.mem_hits += 1
            return plan
        plan = self._load(key, codec[1])
        if plan is not None:
            self.stats.hits += 1
            self.stats.disk_hits += 1
            self._mem[key] = plan
            return plan
        self.stats.misses += 1
        t0 = time.perf_counter()
        plan = build(*args, **statics)
        dt = time.perf_counter() - t0
        self.stats.compile_s += dt
        self._mem[key] = plan
        if persist:
            self._store(key, entry, codec[0](plan), compile_s=dt)
        return plan

    def warm(self, entry: str, build: Callable, args: tuple = (),
             statics: Optional[dict] = None, codec: tuple = IDENTITY) -> bool:
        """Build or load one plan ahead of use; True when it was already
        cached."""
        before = self.stats.hits
        self.get_or_compile(entry, build, args, statics, codec=codec)
        return self.stats.hits > before

    # -- disk -----------------------------------------------------------------
    def _load(self, key: str, decode: Callable):
        path = self._path(key)
        if not os.path.exists(path):
            return None
        try:
            with open(path, "rb") as f:
                magic = f.read(len(_MAGIC))
                if magic != _MAGIC:
                    raise ValueError(f"bad magic {magic!r}")
                header = json.loads(f.readline().decode("utf-8"))
                if not isinstance(header, dict):
                    raise ValueError("the header is not a JSON object")
                self._check_header(header, path)
                payload = f.read()
            with np.load(io.BytesIO(payload), allow_pickle=False) as z:
                return decode({k: z[k] for k in z.files})
        except StaleEntry as e:
            # another environment or content wrote this: quiet rebuild,
            # the ellbfs.StalePlans discipline
            log.debug("aot cache stale: %s", e)
            self.stats.stale += 1
            return None
        except CORRUPT_ERRORS as e:
            log.warning("aot cache entry %s unreadable (%s: %s); "
                        "rebuilding", path, type(e).__name__, e)
            self.stats.corrupt += 1
            return None

    def _check_header(self, header: dict, path: str) -> None:
        if header.get("format") != FORMAT:
            raise StaleEntry(f"{path}: format {header.get('format')} != "
                             f"{FORMAT}")
        env = env_fingerprint(self.device)
        if header.get("env") != env:
            raise StaleEntry(f"{path}: env {header.get('env')!r} != "
                             f"{env!r}")
        if header.get("content_key", "") != self.content_key:
            raise StaleEntry(
                f"{path}: content_key {header.get('content_key')!r} does "
                f"not match ({self.content_key!r}): stale cache entry"
            )

    def _store(self, key: str, entry: str, arrays: dict,
               compile_s: float = 0.0) -> None:
        """Persist one plan, write-then-rename; raises when the directory
        cannot be written."""
        header = {
            "format": FORMAT,
            "env": env_fingerprint(self.device),
            "entry": entry,
            "content_key": self.content_key,
            "compile_s": round(compile_s, 3),
            "created_unix": int(time.time()),
        }
        buf = io.BytesIO()
        np.savez(buf, **arrays)
        path = self._path(key)
        # pid + thread id + a monotonic counter: two runtimes in one
        # process storing one key never share a tmp file
        tmp = (f"{path}.tmp.{os.getpid()}."
               f"{threading.get_ident()}.{time.monotonic_ns()}")
        with open(tmp, "wb") as f:
            f.write(_MAGIC)
            f.write((json.dumps(header) + "\n").encode("utf-8"))
            f.write(buf.getbuffer())
        os.replace(tmp, path)
        self.stats.puts += 1


def default_cache(content_key: str = "", device="cuda") -> Optional[AOTCache]:
    """Cache rooted at ``$HG_AOT_CACHE``, or None when unset."""
    root = os.environ.get(CACHE_ENV)
    if not root:
        return None
    return AOTCache(root=root, content_key=content_key, device=device)
