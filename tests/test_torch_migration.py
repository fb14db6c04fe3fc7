"""The port's format stamp and migration chain against the reference's.

The reference's ``tests/test_migration.py`` cases on both packages: a
fresh database is stamped at the current format; an older one runs the
registered steps in order and stamps each; a newer one refuses to open; a
missing step raises; a step that fails leaves the earlier steps' stamp,
so the next open runs only what is left. Tolerance: exact equality.
"""

import pytest

from test_torch_native_durability import graph
from test_torch_storage import PKGS, mod


def mig(pkg):
    return mod(pkg, "maintenance.migration")


@pytest.fixture(autouse=True)
def _clean_registries():
    saved = {pkg: dict(mig(pkg)._MIGRATIONS) for pkg in PKGS}
    yield
    for pkg in PKGS:
        mig(pkg)._MIGRATIONS.clear()
        mig(pkg)._MIGRATIONS.update(saved[pkg])


def test_fresh_db_stamped_current():
    got = []
    for pkg in PKGS:
        g = mod(pkg, "core.graph").HyperGraph()
        got.append((mig(pkg).stored_format_version(g), g.txman.committed,
                    g.metrics.counters.get("tx.commits")))
        g.close()
    assert got[1] == got[0]
    assert got[1][0] == mig(PKGS[1]).FORMAT_VERSION == 1


def test_migration_chain_runs_and_stamps(tmp_path, monkeypatch):
    got = []
    for pkg in PKGS:
        m = mig(pkg)
        loc = tmp_path / pkg
        g = graph(pkg, loc)
        g.add("survivor")
        assert m.stored_format_version(g) == m.FORMAT_VERSION
        g.close()
        ran = []
        m.register_migration(m.FORMAT_VERSION, lambda graph: ran.append(1))
        m.register_migration(m.FORMAT_VERSION + 1,
                             lambda graph: ran.append(2))
        monkeypatch.setattr(m, "FORMAT_VERSION", m.FORMAT_VERSION + 2)
        g2 = graph(pkg, loc)
        got.append((ran, m.stored_format_version(g2),
                    [g2.get(h) for h in g2.atoms()
                     if g2.get(h) == "survivor"]))
        g2.close()
    assert got[1] == got[0]
    assert got[1] == ([1, 2], 3, ["survivor"])


def test_newer_db_refuses_to_open(tmp_path):
    got = []
    for pkg in PKGS:
        m = mig(pkg)
        loc = tmp_path / pkg
        g = graph(pkg, loc)
        m.stamp_format_version(g, m.FORMAT_VERSION + 5)
        g.close()
        with pytest.raises(m.MigrationError, match="newer") as e:
            graph(pkg, loc)
        got.append(str(e.value))
    assert got[1] == got[0]


def test_missing_migration_step_raises(monkeypatch):
    got = []
    for pkg in PKGS:
        m = mig(pkg)
        g = mod(pkg, "core.graph").HyperGraph()
        monkeypatch.setattr(m, "FORMAT_VERSION", m.FORMAT_VERSION + 1)
        m.stamp_format_version(g, m.FORMAT_VERSION - 1)
        with pytest.raises(m.MigrationError, match="no migration") as e:
            m.migrate(g)
        got.append(str(e.value))
        g.close()
    assert got[1] == got[0]


def test_crash_mid_chain_resumes(tmp_path, monkeypatch):
    got = []
    for pkg in PKGS:
        m = mig(pkg)
        loc = tmp_path / pkg
        graph(pkg, loc).close()
        ran = []

        def boom(graph_):
            ran.append("step2-fail")
            raise RuntimeError("mid-chain crash")

        m.register_migration(m.FORMAT_VERSION, lambda graph_: ran.append(1))
        m.register_migration(m.FORMAT_VERSION + 1, boom)
        monkeypatch.setattr(m, "FORMAT_VERSION", m.FORMAT_VERSION + 2)
        with pytest.raises(RuntimeError):
            graph(pkg, loc)
        m.register_migration(m.FORMAT_VERSION - 1,
                             lambda graph_: ran.append(2))
        g3 = graph(pkg, loc)
        got.append((ran, m.stored_format_version(g3)))
        g3.close()
    assert got[1] == got[0]
    assert got[1][0] == [1, "step2-fail", 2]
