"""Durability of the port's native engine against the reference's.

The reference's ``tests/test_native_durability.py`` cases, each run on
both packages' ``NativeStorage`` (or graph) with the same operations:
what a reopen reads back must be equal, and so must the write-ahead logs
the two write (byte for byte where the same calls made them). The
process-kill cases run a child that imports only the port, and both
packages then read what it left. Then the port's repair of the engine's
bulk export: its counts are 64-bit and never wrap. Tolerance: exact
equality.
"""

import ctypes
import os
import subprocess
import sys
import textwrap
from dataclasses import dataclass

import pytest

from test_torch_storage import PKGS, mod

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def Native(pkg, loc):
    s = mod(pkg, "storage.native").NativeStorage(str(loc))
    s.startup()
    return s


def graph(pkg, loc):
    cfg = mod(pkg, "core.config").HGConfiguration(store_backend="native",
                                                  location=str(loc))
    return mod(pkg, "core.graph").HyperGraph(cfg)


def wal(loc) -> bytes:
    with open(os.path.join(str(loc), "wal.log"), "rb") as f:
        return f.read()


def parse_wal_v2(raw):
    """v2 WAL frames as (offset, seq, op, payload)."""
    pos = 4  # the magic
    while pos + 13 <= len(raw):
        ln = int.from_bytes(raw[pos:pos + 4], "little")
        seq = int.from_bytes(raw[pos + 8:pos + 12], "little")
        yield pos, seq, raw[pos + 12], raw[pos + 13:pos + 12 + ln]
        pos += 12 + ln


def on_both(tmp_path, fn):
    """``fn(pkg, loc)`` for each package in a directory of its own; the
    port's result must equal the reference's. Returns the port's."""
    out = [fn(pkg, tmp_path / pkg) for pkg in PKGS]
    assert out[1] == out[0]
    return out[1]


def run_port_child(body: str) -> int:
    """Run ``body`` in a child that imports only the port; its exit code."""
    code = (f"import os, sys\nsys.path.insert(0, {ROOT!r})\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['hypergraphdb_tpu'] = None\n"
            + textwrap.dedent(body))
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          timeout=240).returncode


def read_all(pkg, loc, links, datas=(), incs=(), idx=()):
    s = Native(pkg, loc)
    try:
        return ([s.get_link(h) for h in links], [s.get_data(h) for h in datas],
                [s.get_incidence_set(a).array().tolist() for a in incs],
                [s.get_index(n).find(k).array().tolist() for n, k in idx],
                s.max_handle())
    finally:
        s.shutdown()


def test_reopen_sees_committed_state(tmp_path):
    def run(pkg, loc):
        s = Native(pkg, loc)
        s.store_link(1, (10, 20))
        s.store_data(2, b"payload")
        s.add_incidence_link(10, 1)
        s.get_index("by-name").add_entry(b"k", 7)
        s.shutdown()
        got = read_all(pkg, loc, [1], [2], [10], [("by-name", b"k")])
        assert got[:4] == ([(10, 20)], [b"payload"], [[1]], [[7]])
        assert got[4] >= 21
        return got, wal(loc)

    on_both(tmp_path, run)


def test_abrupt_exit_recovery(tmp_path):
    """A port child writes and dies by ``os._exit``; both packages read
    back everything it wrote."""
    loc = str(tmp_path / "db")
    rc = run_port_child(f"""
        from hypergraphdb_tpu_torch.storage.native import NativeStorage
        s = NativeStorage({loc!r})
        s.startup()
        for i in range(500):
            s.store_link(i, (i + 1000, i + 2000))
            s.add_incidence_link(i + 1000, i)
        s.get_index("idx").add_entry(b"key", 42)
        os._exit(9)
    """)
    assert rc == 9
    got = [read_all(pkg, loc, [0, 499], [], [1000, 1499], [("idx", b"key")])
           for pkg in PKGS]
    assert got[1] == got[0]
    links, _, incs, idx, _ = got[1]
    assert links == [(1000, 2000), (1499, 2499)]
    assert incs == [[0], [499]] and idx == [[42]]


def test_checkpoint_compacts_and_survives(tmp_path):
    def run(pkg, loc):
        s = Native(pkg, loc)
        for i in range(100):
            s.store_link(i, (i + 100,))
        s.checkpoint()
        assert os.path.getsize(os.path.join(str(loc), "wal.log")) == 4
        s.store_link(777, (1, 2, 3))
        s.shutdown()
        got = read_all(pkg, loc, [50, 777])
        assert got[0] == [(150,), (1, 2, 3)]
        return got, wal(loc)

    on_both(tmp_path, run)


def test_torn_wal_tail_truncated(tmp_path):
    def run(pkg, loc):
        s = Native(pkg, loc)
        s.store_link(1, (2, 3))
        s.shutdown()
        with open(os.path.join(str(loc), "wal.log"), "ab") as f:
            f.write(b"\xff\xff\xff\x7f\x01partial")
        s2 = Native(pkg, loc)
        first = s2.get_link(1)
        s2.store_link(9, (8,))
        s2.shutdown()
        got = read_all(pkg, loc, [1, 9])
        assert first == (2, 3) and got[0] == [(2, 3), (8,)]
        return got, wal(loc)

    on_both(tmp_path, run)


def test_graph_over_native_backend(tmp_path):
    def run(pkg, loc):
        g = graph(pkg, loc)
        a = g.add("alpha")
        b = g.add("beta")
        link = g.add_link((a, b), value="rel")
        g.close()
        g2 = graph(pkg, loc)
        q = mod(pkg, "query.dsl")
        got = (int(a), int(b), int(link), g2.get(a), g2.get(link).targets,
               g2.get_incidence_set(a).array().tolist(),
               q.find_all(g2, q.value("beta")), g2.handles.peek)
        assert got[3] == "alpha" and got[4] == (a, b)
        assert got[5] == [int(link)] and got[6] == [int(b)]
        g2.close()
        return got

    on_both(tmp_path, run)


def test_mid_commit_crash_is_atomic(tmp_path):
    loc = str(tmp_path / "db")
    rc = run_port_child(f"""
        from hypergraphdb_tpu_torch.storage.native import NativeStorage
        s = NativeStorage({loc!r})
        s.startup()
        s.commit_batch_begin()
        s.store_link(1, (10,))
        s.add_incidence_link(10, 1)
        s.commit_batch_end()
        s.commit_batch_begin()
        s.store_link(2, (20,))
        os._exit(9)
    """)
    assert rc == 9
    got = [read_all(pkg, loc, [1, 2], [], [10]) for pkg in PKGS]
    assert got[1] == got[0]
    assert got[1][0] == [(10,), None] and got[1][2] == [[1]]


def test_graph_commit_is_batched(tmp_path):
    def run(pkg, loc):
        g = graph(pkg, loc)
        g.add("x")
        raw = wal(loc)
        g.close()
        assert raw[:4] == b"HGW2"
        ops = [op for _, _, op, _ in parse_wal_v2(raw)]
        assert 13 in ops and 14 in ops
        return ops

    on_both(tmp_path, run)


@dataclass(frozen=True)
class Marker:
    tag: str = ""


def test_type_atom_protected_across_sessions(tmp_path):
    def run(pkg, loc):
        g = graph(pkg, loc)
        g.add(Marker("m1"))
        th = int(g.typesystem.handle_of(g.typesystem.infer(Marker("m1")).name))
        g.close()
        g2 = graph(pkg, loc)
        try:
            with pytest.raises(mod(pkg, "core.errors").HGException):
                g2.remove(th)
            return th, g2.contains(th)
        finally:
            g2.close()

    assert on_both(tmp_path, run)[1] is True


def test_aborted_batch_discarded_on_replay(tmp_path):
    def run(pkg, loc):
        s = Native(pkg, loc)
        s.commit_batch_begin()
        s.store_link(1, (10,))
        s.commit_batch_abort()
        s.store_link(2, (20,))
        s.shutdown()
        got = read_all(pkg, loc, [1, 2])
        assert got[0] == [None, (20,)]
        return got, wal(loc)

    on_both(tmp_path, run)


def test_wal_crc_detects_bitrot(tmp_path):
    def run(pkg, loc):
        s = Native(pkg, loc)
        s.store_link(1, (2, 3))
        s.store_link(4, (5, 6))
        s.shutdown()
        path = os.path.join(str(loc), "wal.log")
        raw = bytearray(wal(loc))
        frames = list(parse_wal_v2(bytes(raw)))
        assert len(frames) == 2
        raw[frames[1][0] + 14] ^= 0xFF
        with open(path, "wb") as f:
            f.write(bytes(raw))
        s2 = Native(pkg, loc)
        first = [s2.get_link(1), s2.get_link(4)]
        s2.store_link(9, (8,))
        s2.shutdown()
        got = read_all(pkg, loc, [4, 9])
        assert first == [(2, 3), None] and got[0] == [None, (8,)]
        return first, got, wal(loc)

    on_both(tmp_path, run)


def test_wal_sequence_gap_truncates(tmp_path):
    def run(pkg, loc):
        s = Native(pkg, loc)
        s.store_link(1, (2,))
        s.store_link(3, (4,))
        s.shutdown()
        raw = bytearray(wal(loc))
        frames = list(parse_wal_v2(bytes(raw)))
        fixed = raw[:frames[0][0]] + raw[frames[1][0]:]
        with open(os.path.join(str(loc), "wal.log"), "wb") as f:
            f.write(bytes(fixed))
        got = read_all(pkg, loc, [1, 3])
        assert got[0] == [None, None]
        return got

    on_both(tmp_path, run)


def test_wal_seq_continues_after_reopen(tmp_path):
    def run(pkg, loc):
        s = Native(pkg, loc)
        s.store_link(1, (2,))
        s.shutdown()
        s = Native(pkg, loc)
        s.store_link(3, (4,))
        s.shutdown()
        seqs = [seq for _, seq, _, _ in parse_wal_v2(wal(loc))]
        assert seqs == list(range(len(seqs)))
        got = read_all(pkg, loc, [1, 3])
        assert got[0] == [(2,), (4,)]
        return seqs, got, wal(loc)

    on_both(tmp_path, run)


# ------------------------------------------- the bulk export's counts


def test_bulk_links_counts_are_64_bit(tmp_path):
    """The engine writes both counts as full 64-bit words (the JAX
    package's engine casts them to u32 and would wrap past 2^32 - 1): out
    parameters filled with all-ones come back holding exactly the counts,
    their high halves cleared."""
    from hypergraphdb_tpu_torch import native

    s = Native(PKGS[1], tmp_path / "db")
    try:
        for h in range(5):
            s.store_link(h, tuple(range(h)))
        L = native.lib()
        p = ctypes.POINTER(ctypes.c_int64)
        ids, offs, flat = p(), p(), p()
        n_links = ctypes.c_uint64(2**64 - 1)
        n_flat = ctypes.c_uint64(2**64 - 1)
        L.hgs_bulk_links(s._h, ctypes.byref(ids), ctypes.byref(offs),
                         ctypes.byref(flat), ctypes.byref(n_links),
                         ctypes.byref(n_flat))
        for buf in (ids, offs, flat):
            L.hgs_free(buf)
        assert (n_links.value, n_flat.value) == (5, 10)
        got = s.bulk_links()
        assert [a.tolist() for a in got] == [
            [0, 1, 2, 3, 4], [0, 0, 1, 3, 6, 10],
            [0, 0, 1, 0, 1, 2, 0, 1, 2, 3]]
    finally:
        s.shutdown()
    src = native.SRC.read_text()
    body = src[src.index("void hgs_bulk_links"):]
    body = body[:body.index("\n}\n")]
    assert "static_cast<u32>" not in body and "u32*" not in body
