"""The reference's multithreaded stress (``tests/test_concurrency_stress.py``)
on the port's MVCC and storage stack: conserved totals under contended
read-modify-write transactions, no torn link structure seen by readers
mid-churn, bounded history. Every thread is joined with a timeout and a
live thread fails the case, as the reference does.

Tolerance: exact equality."""

import threading

import numpy as np
import pytest

from hypergraphdb_tpu_torch.core.graph import HyperGraph


@pytest.fixture()
def g():
    graph = HyperGraph()
    yield graph
    graph.close()


def test_many_writers_counters_converge(g):
    a, b = g.add(1000), g.add(1000)
    errors = []

    def mover():
        try:
            for _ in range(40):
                def step():
                    va, vb = g.get(a), g.get(b)
                    g.replace(a, va - 1)
                    g.replace(b, vb + 1)
                g.txman.transact(step, retries=64)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    ts = [threading.Thread(target=mover) for _ in range(6)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in ts), "writers deadlocked"
    assert not errors, errors
    assert g.get(a) + g.get(b) == 2000
    assert g.get(a) == 1000 - 6 * 40


def test_readers_see_consistent_link_structure(g):
    nodes = [g.add(f"n{i}") for i in range(12)]
    stop = threading.Event()
    errors = []

    def writer(seed):
        rng = np.random.default_rng(seed)
        try:
            while not stop.is_set():
                i, j = rng.choice(12, size=2, replace=False)
                lk = g.add_link((nodes[i], nodes[j]),
                                value=int(rng.integers(1e6)))
                if rng.random() < 0.5:
                    g.remove(lk)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    def reader():
        try:
            for _ in range(200):
                def check():
                    inc = g.get_incidence_set(nodes[0]).array()
                    for lk in inc.tolist():
                        atom = g.get(int(lk))
                        assert int(nodes[0]) in [int(t) for t in
                                                 atom.targets], (
                            "incidence entry without a matching target")
                g.txman.transact(check, readonly=True)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    ws = [threading.Thread(target=writer, args=(s,)) for s in range(3)]
    rs = [threading.Thread(target=reader) for _ in range(3)]
    for t in ws + rs:
        t.start()
    for t in rs:
        t.join(timeout=120)
    stop.set()
    for t in ws:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in ws + rs), "stress threads hung"
    assert not errors, errors


def test_history_bounded_under_churn(g):
    a = g.add("cell")
    done = threading.Event()
    errors = []

    def churn():
        try:
            for i in range(300):
                g.replace(a, i)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)
        finally:
            done.set()

    def read_loop():
        while not done.is_set():
            g.txman.transact(lambda: g.get(a), readonly=True)

    w = threading.Thread(target=churn)
    r = threading.Thread(target=read_loop)
    w.start()
    r.start()
    w.join(timeout=120)
    r.join(timeout=120)
    assert not (w.is_alive() or r.is_alive()), "churn threads hung"
    assert not errors, errors
    g.add("tick")  # one commit collects everything below the empty floor
    assert len(g.txman._history) <= 2
