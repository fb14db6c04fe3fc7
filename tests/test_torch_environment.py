"""The port's environment, configuration and memory watcher against the
reference's.

- ``environment.get`` on a directory opens the durable engine in both
  packages, leaves the caller's configuration alone (the case of
  ``tests/test_tx_regressions.py``), returns the open graph again and
  closes it; where the engine cannot be built the port raises, and the
  reference opens the location in memory (a fault the port does not
  copy).
- Configuration files written by either package load in the other: the
  reference's in the port field for field, its ``peer`` section among
  them, its ``snapshot`` section (which nothing in the port reads)
  dropped; the port's in the
  reference when written ``portable``, since ``query.device`` is the
  port's alone. An unknown top-level field, such as a misspelled
  ``store_backend``, raises in the port (the reference drops it and opens
  memory).
- The memory watcher (the two cases of ``tests/test_conc_fixes.py``): its
  thread survives a raising sweep and ``stop`` joins it; a raising
  listener is counted (``cache.memwatch_listener_errors`` in the graph's
  metrics) where the reference logs and drops it; the graph starts the
  watcher at open and stops it at close, and on a refused open.
Tolerance: exact equality.
"""

import dataclasses
import json
import threading
import time

import pytest

from test_torch_storage import PKGS, mod


def env(pkg):
    return mod(pkg, "core.environment")


# ---------------------------------------------------------------- environment


def test_environment_does_not_mutate_caller_config(tmp_path):
    got = []
    for pkg in PKGS:
        cfg = mod(pkg, "core.config").HGConfiguration()
        loc = str(tmp_path / pkg / "db")
        g = env(pkg).get(loc, cfg)
        got.append((cfg.location, cfg.store_backend,
                    type(g.backend).__name__, g.config.store_backend))
        env(pkg).close(loc)
    assert got[1] == got[0] == (None, "memory", "NativeStorage", "native")


def test_environment_get_is_idempotent_and_reopens(tmp_path):
    got = []
    for pkg in PKGS:
        E = env(pkg).HGEnvironment
        loc = str(tmp_path / pkg / "db")
        g = E.get(loc)
        same = E.get(loc) is g
        h = int(g.add("kept"))
        opened = E.is_open(loc)
        E.close(loc)
        closed = not E.is_open(loc)
        g2 = E.get(loc)
        back = g2.get(h)
        E.close_all()
        got.append((same, opened, closed, h, back, E.is_open(loc)))
    assert got[1] == got[0] == (True, True, True, got[0][3], "kept", False)


def test_environment_keys_a_directory_by_its_real_path(tmp_path,
                                                      monkeypatch):
    """``db``, ``./db`` and the absolute path are one database: one graph,
    open or closed under any of the three spellings."""
    E = env(PKGS[1]).HGEnvironment
    monkeypatch.chdir(tmp_path)
    spellings = ["db", "./db", str(tmp_path / "db")]
    g = E.get(spellings[0])
    try:
        h = int(g.add("one writer"))
        assert all(E.get(s) is g and E.is_open(s) for s in spellings)
    finally:
        E.close(spellings[2])
    assert not any(E.is_open(s) for s in spellings)
    g2 = E.get(spellings[1])
    try:
        assert g2.get(h) == "one writer"
    finally:
        E.close_all()


def test_second_writer_on_one_directory_is_refused(tmp_path):
    """The engine is single-writer: a graph opened beside the registry, or
    a second backend on the directory, raises while the first is open, and
    opens once it has closed."""
    C = mod(PKGS[1], "core.config")
    G = mod(PKGS[1], "core.graph").HyperGraph
    NativeStorage = mod(PKGS[1], "storage.native").NativeStorage
    errors = mod(PKGS[1], "core.errors")
    E = env(PKGS[1]).HGEnvironment
    loc = tmp_path / "db"
    g = E.get(str(loc))
    try:
        h = int(g.add("first"))
        with pytest.raises(errors.HGException, match="already open"):
            G(C.HGConfiguration(store_backend="native",
                                location=str(loc / ".." / "db")))
        with pytest.raises(errors.HGException, match="already open"):
            NativeStorage(str(loc)).startup()
        assert g.get(h) == "first"     # the first writer is untouched
    finally:
        E.close(str(loc))
    g2 = G(C.HGConfiguration(store_backend="native", location=str(loc)))
    try:
        assert g2.get(h) == "first"
    finally:
        g2.close()


def test_environment_raises_without_the_engine(tmp_path, monkeypatch):
    """A location whose engine cannot be built is refused, not opened in
    memory: the JAX package's ``get`` opens it in memory with a warning."""
    native = mod(PKGS[1], "native")
    errors = mod(PKGS[1], "core.errors")

    def no_engine():
        raise native.NativeBuildError("native build failed: no compiler")

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "build", no_engine)
    loc = str(tmp_path / "db")
    with pytest.raises(errors.HGException, match="native build failed"):
        env(PKGS[1]).get(loc)
    assert not env(PKGS[1]).is_open(loc)
    # the reference's fault: the same failure opens the location in memory
    monkeypatch.setattr(env(PKGS[0]), "_native_available", lambda: False)
    g = env(PKGS[0]).get(str(tmp_path / "ref"))
    assert type(g.backend).__name__ == "MemStorage"
    env(PKGS[0]).close(str(tmp_path / "ref"))


def test_native_graph_raises_when_the_build_fails(tmp_path, monkeypatch):
    native = mod(PKGS[1], "native")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "SRC", tmp_path / "missing.cpp")
    (tmp_path / "missing.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    cfg = mod(PKGS[1], "core.config").HGConfiguration(
        store_backend="native", location=str(tmp_path / "db"))
    with pytest.raises(native.NativeBuildError, match="native build failed"):
        mod(PKGS[1], "core.graph").HyperGraph(cfg)
    assert not list((tmp_path / "build").glob("*.so"))


def test_engine_builds_once_into_build_native():
    native = mod(PKGS[1], "native")
    path = native.build()
    assert path.parent == native.BUILD_DIR
    assert native.BUILD_DIR.parts[-2:] == ("build", "native")
    assert path.name.startswith("libhgstore_") and path.exists()
    assert native.build() == path == native.lib_path()


# ---------------------------------------------------------------- configuration


def configured(pkg):
    C = mod(pkg, "core.config")
    return C.HGConfiguration(
        transactional=False, store_backend="partitioned", location="/data/g",
        n_partitions=6, handle_factory="uuid",
        query=C.QueryConfig(parallel_or=True, device_min_batch=1024),
        cache=C.CacheConfig(memory_warning_bytes=1 << 30,
                            memory_warning_interval_s=2.5),
        peer=C.PeerConfig(name="p1", bootstrap=["a", "b"], replicate=True,
                          listen_address="10.0.0.7:7001"))


def shared_fields(raw: dict) -> dict:
    """``raw`` without the reference's sections that the port drops."""
    C = mod(PKGS[1], "core.config")
    return {k: v for k, v in raw.items() if k not in C.DROPPED_SECTIONS}


def test_reference_config_file_loads_in_the_port():
    RC = mod(PKGS[0], "core.config")
    ref = configured(PKGS[0])
    ref.snapshot = RC.SnapshotConfig(auto_refresh=True, pad_multiple=256)
    port = mod(PKGS[1], "core.config").HGConfiguration.from_json(ref.to_json())
    assert port.query.device == "cuda"          # the port's default
    assert port.to_dict(portable=True) == shared_fields(
        dataclasses.asdict(ref))
    # the peer section, field for field
    assert dataclasses.asdict(port.peer) == dataclasses.asdict(ref.peer)
    assert port.peer.bootstrap == ["a", "b"] and port.peer.replicate
    assert not hasattr(port, "snapshot")


def test_port_config_file_loads_in_the_reference():
    port = configured(PKGS[1])
    port.query.device = "cpu"
    RefCfg = mod(PKGS[0], "core.config").HGConfiguration
    # query.device is the port's alone: the reference refuses a full file
    with pytest.raises(TypeError, match="device"):
        RefCfg.from_json(port.to_json())
    ref = RefCfg.from_json(port.to_json(portable=True))
    want = port.to_dict(portable=True)
    assert shared_fields(dataclasses.asdict(ref)) == want
    # the peer section, field for field
    assert dataclasses.asdict(ref.peer) == dataclasses.asdict(port.peer)
    assert ref.peer.listen_address == "10.0.0.7:7001"
    # the section the port does not carry takes the reference's default
    assert ref.snapshot == RefCfg().snapshot
    # and the port reads its own full file back unchanged
    again = type(port).from_json(port.to_json())
    assert again == port
    assert json.loads(port.to_json())["query"]["device"] == "cpu"


@pytest.mark.parametrize("raw", [
    {"store_backed": "native", "location": "/data/g"},
    {"store_backend": "native", "location": "/data/g", "peers": {}},
    {"cache": {"memory_warning_byte": 1}},
])
def test_unknown_config_field_raises(raw):
    """A misspelled field is refused, at the top as in a section: the
    reference drops an unknown top-level key, so its first case opens an
    in-memory graph and loses every write at exit."""
    C = mod(PKGS[1], "core.config")
    with pytest.raises(TypeError):
        C.HGConfiguration.from_dict(raw)
    with pytest.raises(TypeError):
        C.HGConfiguration.from_json(json.dumps(raw))
    if "store_backed" in raw:
        ref = mod(PKGS[0], "core.config").HGConfiguration.from_dict(raw)
        assert ref.store_backend == "memory"


# ---------------------------------------------------------------- memory watcher


def watcher(pkg, *a, **kw):
    return mod(pkg, "utils.cache").MemoryWarningSystem(*a, **kw)


def test_memwatch_thread_survives_a_raising_sweep():
    for pkg in PKGS:
        ws = watcher(pkg, threshold_bytes=1, interval_s=0.01)
        sweeps = []
        twice = threading.Event()

        def boom():
            sweeps.append(1)
            if len(sweeps) >= 2:
                twice.set()
            raise RuntimeError("sweep bug")

        ws.check_now = boom
        ws.start()
        try:
            assert twice.wait(5.0), f"{pkg}: the watch thread died"
            assert ws._thread.is_alive()
        finally:
            ws.stop()
        assert len(sweeps) >= 2
        if pkg == PKGS[1]:
            assert ws.sweep_errors >= 2
            assert isinstance(ws.last_error, RuntimeError)


def test_memwatch_stop_joins_the_thread():
    for pkg in PKGS:
        ws = watcher(pkg, threshold_bytes=0, interval_s=0.01)
        ws.start()
        t = ws._thread
        time.sleep(0.03)
        ws.stop()
        assert ws._thread is None and not t.is_alive()


def test_memwatch_listener_failures_are_counted():
    """Every listener runs past one that raises, in both packages; the
    port counts the failure, the reference only logs it."""
    got = []
    for pkg in PKGS:
        metrics = mod(PKGS[1], "utils.metrics").Metrics()
        kw = {"metrics": metrics} if pkg == PKGS[1] else {}
        ws = watcher(pkg, threshold_bytes=1, interval_s=60, **kw)
        ran = []
        ws.add_listener(lambda: ran.append("first"))
        ws.add_listener(lambda: 1 / 0)
        ws.add_listener(lambda: ran.append("last"))
        fired = [ws.check_now(), ws.check_now()]
        got.append((fired, ran, ws.triggered))
        if pkg == PKGS[1]:
            assert ws.listener_errors == 2
            assert isinstance(ws.last_error, ZeroDivisionError)
            assert metrics.counters == {"cache.memwatch_listener_errors": 2}
    assert got[1] == got[0]
    assert got[1] == ([True, True], ["first", "last"] * 2, 2)


def test_graph_starts_and_stops_the_watcher(tmp_path):
    C = mod(PKGS[1], "core.config")
    cfg = C.HGConfiguration(cache=C.CacheConfig(
        memory_warning_bytes=1, memory_warning_interval_s=0.01))
    g = mod(PKGS[1], "core.graph").HyperGraph(cfg)
    ws = g._memwatch
    assert ws is not None and ws._thread.is_alive()
    assert ws.metrics is g.metrics
    h = g.add("cached")
    g.get(h)
    ws.add_listener(lambda: 1 / 0)
    t0 = time.monotonic()
    while (g.metrics.counters.get("cache.memwatch_listener_errors", 0) < 1
           and time.monotonic() - t0 < 5):
        time.sleep(0.01)
    assert g.metrics.counters["cache.memwatch_listener_errors"] >= 1
    assert len(g._atom_cache) == 0            # cleared by the watcher
    t = ws._thread
    g.close()
    assert g._memwatch is None and not t.is_alive()


def test_refused_open_stops_the_watcher(tmp_path):
    mig = mod(PKGS[1], "maintenance.migration")
    C = mod(PKGS[1], "core.config")
    G = mod(PKGS[1], "core.graph").HyperGraph
    loc = str(tmp_path / "db")
    g = G(C.HGConfiguration(store_backend="native", location=loc))
    mig.stamp_format_version(g, mig.FORMAT_VERSION + 1)
    g.close()
    before = {t.ident for t in threading.enumerate()}
    with pytest.raises(mig.MigrationError, match="newer"):
        G(C.HGConfiguration(store_backend="native", location=loc,
                            cache=C.CacheConfig(memory_warning_bytes=1,
                                                memory_warning_interval_s=0.01)))
    time.sleep(0.05)
    left = [t for t in threading.enumerate()
            if t.name == "hgdb-memwatch" and t.ident not in before]
    assert not left
