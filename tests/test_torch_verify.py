"""The port's verification registry and its four checks
(``hypergraphdb_tpu_torch/verify.py``), after ``tests/test_hgverify.py``:
the registry holds exactly the reference's 30 entry names, each at the port
function its map names; every entry runs at its CPU exemplar; the sync,
collective, aliasing and op-budget checks pass on the registry, and each
family fires on a private registry of fixture entries built to trip it.

Tolerance: exact, but for the op budgets (±15 %, the reference's)."""

from __future__ import annotations

import importlib
import json

import pytest
import torch

from hypergraphdb_tpu_torch import verify
from hypergraphdb_tpu_torch.parallel import sharded

REG = verify.load_entries()
NAMES = REG.names()


def _reference_entries() -> dict:
    from hypergraphdb_tpu import verify as ref

    for m in ("ops.frontier", "ops.incremental", "ops.ellbfs",
              "ops.pallas_gather", "ops.serving", "ops.setops",
              "ops.bitfrontier", "ops.pallas_bfs", "ops.join",
              "ops.value_index", "parallel.sharded", "ops.sharded_serving"):
        importlib.import_module("hypergraphdb_tpu." + m)
    return {e.name: e for e in ref.REGISTRY}


def test_registry_holds_the_reference_entries_at_their_port_functions():
    ref = _reference_entries()
    assert len(REG) == 30 and sorted(NAMES) == sorted(ref)
    assert sorted(verify.PORT_OF) == sorted(ref)
    for e in REG:
        assert verify._default_name(e.fn) == verify.PORT_OF[e.name], e.name
        mod, _, qual = verify.PORT_OF[e.name].rpartition(".")
        module = importlib.import_module(f"{verify.PKG}.{mod}")
        assert getattr(module, qual) is e.fn  # registered unchanged
        # declared flags: the reference's mesh axis, and donation where the
        # reference donates
        assert (e.mesh is None) == (ref[e.name].mesh is None), e.name
        if e.mesh is not None:
            assert e.mesh == (sharded.AXIS,) == ref[e.name].mesh
        assert bool(e.donate) == (
            ref[e.name].donate or e.name == "ops.ellbfs._stage"), e.name
    assert REG.get("ops.ellbfs._visited_update").donate[0] == 0


def test_default_name_strips_the_package_prefix():
    from hypergraphdb_tpu_torch.ops import frontier

    assert (verify._default_name(frontier.bfs_levels)
            == "ops.frontier.bfs_levels")
    assert REG.get("ops.frontier.bfs_levels").fn is frontier.bfs_levels
    reg = verify.Registry()
    reg.entry(shapes=lambda d, s: ())(frontier.bfs_levels)
    with pytest.raises(ValueError, match="registered twice"):
        reg.entry(shapes=lambda d, s: ())(frontier.bfs_levels)


@pytest.mark.parametrize("name", NAMES)
def test_entry_runs_at_its_cpu_exemplar(name):
    """Each entry runs on its CPU exemplar, its result lies on the CPU and
    is the same for the same seed (exemplars are made from the seed)."""
    e = REG.get(name)
    a = verify.tensors_of(verify.run(e, "cpu", 0))
    b = verify.tensors_of(verify.run(e, "cpu", 0))
    assert a and all(t.device.type == "cpu" for t in a)
    assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def test_registry_has_no_sync_off_the_allowlist():
    assert [f.render() for f in verify.check_syncs()] == []
    for site in ("ops.fused_bfs._check_items", "ops._cuda.check_rows"):
        assert verify.SYNC_ALLOWLIST[site]  # named, with its reason
    assert all(len(r) > 30 for r in verify.SYNC_ALLOWLIST.values())


def test_registry_collectives_use_the_declared_axis():
    assert [f.render() for f in verify.check_collectives()] == []
    for e in REG:
        calls = verify.collectives(e)
        if e.mesh is None:
            assert calls == [], e.name
        else:
            assert calls and {a for _, a in calls} == {(sharded.AXIS,)}


def test_registry_aliasing():
    assert [f.render() for f in verify.check_aliasing()] == []


def test_registry_op_budgets():
    assert [f.render() for f in verify.check_costs()] == []


def test_costs_json_covers_every_entry():
    with open(verify.COSTS_PATH, encoding="utf-8") as f:
        doc = json.load(f)
    assert sorted(doc["entries"]) == sorted(NAMES)
    assert doc["tolerance"] == verify.COST_TOLERANCE == 0.15
    for name, c in doc["entries"].items():
        assert c["ops"] == sum(c["op_counts"].values()) > 0, name
        assert c["bytes"] > 0, name
    # the degree sums multiply; the other entries do no floating product
    assert doc["entries"]["ops.ellbfs._deg_sum"]["flops"] > 0


def test_write_costs_needs_update(tmp_path):
    path = tmp_path / "costs.json"
    reg = verify.Registry()
    reg.entry("fixture.ones", shapes=lambda d, s: (torch.ones(4),))(
        torch.neg)
    with pytest.raises(ValueError, match="update=True"):
        verify.write_costs(reg, str(path))
    assert not path.exists()
    verify.write_costs(reg, str(path), update=True)
    assert verify.check_costs(reg, str(path)) == []


# ---------------------------------------------------------- fixture entries


def _bad_registry():
    """One fixture entry (or more) per finding code."""
    reg = verify.Registry()
    words = lambda d, s: (verify.words(d, s, (8, 1)),)  # noqa: E731
    mesh = verify.exemplar_mesh("cpu")

    @reg.entry("bad.host_sync", shapes=words)
    def host_sync(x):
        return x * int(x.sum())                     # HV101

    @reg.entry("bad.mask_index", shapes=words)
    def mask_index(x):
        return x[x != 0]                            # HV101

    @reg.entry("bad.undeclared_collective", shapes=words)
    def undeclared(x):
        return sharded.psum(mesh, [x, x])           # HV203

    @reg.entry("bad.wrong_axis", shapes=words, mesh=("rows",))
    def wrong_axis(x):
        return sharded.all_gather(mesh, [x] * 4)[0]  # HV201

    @reg.entry("bad.data_dependent", mesh=(sharded.AXIS,),
               shapes=lambda d, s: (torch.full((1,), s, device=d),))
    def data_dependent(x):
        out = x
        for _ in range(1 + int(x[0])):              # HV202 (and HV101)
            out = sharded.psum(mesh, [out])
        return out

    @reg.entry("bad.mutates_input", shapes=words)
    def mutates(x):
        x += 1                                      # HV303
        return x.clone()

    @reg.entry("bad.donates_nothing", shapes=words, donate=True)
    def donates_nothing(x):
        return x + 1                                # HV301

    @reg.entry("bad.shared_outputs", shapes=words)
    def shared(x):
        y = x + 1
        return y, y[:4]                             # HV302

    @reg.entry("good.donates", shapes=words, donate=True)
    def donates(x):
        x |= 1
        return x

    return reg


def test_bad_registry_fires_every_family(tmp_path):
    reg = _bad_registry()
    codes: dict = {}
    for f in (verify.check_syncs(reg) + verify.check_collectives(reg)
              + verify.check_aliasing(reg)):
        codes.setdefault(f.code, set()).add(f.entry)
    assert codes["HV101"] == {"bad.host_sync", "bad.mask_index",
                              "bad.data_dependent"}
    assert codes["HV201"] == {"bad.wrong_axis"}
    assert codes["HV202"] == {"bad.data_dependent"}
    assert codes["HV203"] == {"bad.undeclared_collective"}
    assert codes["HV301"] == {"bad.donates_nothing"}
    assert codes["HV302"] == {"bad.shared_outputs"}
    assert codes["HV303"] == {"bad.mutates_input"}
    sync = next(f for f in verify.check_syncs(reg)
                if f.entry == "bad.host_sync")
    assert "aten::_local_scalar_dense" in sync.message
    # op budgets: one entry off by 2x, one without a budget, one stale
    path = tmp_path / "costs.json"
    measured = verify.measure_costs(reg)
    budgets = {k: dict(v) for k, v in measured.items()}
    budgets["bad.host_sync"]["bytes"] *= 2
    budgets.pop("bad.mask_index")
    budgets["gone.entry"] = dict(budgets["good.donates"])
    path.write_text(json.dumps({"entries": budgets}))
    found = verify.check_costs(reg, str(path), measured)
    assert {(f.code, f.entry) for f in found} == {
        ("HV401", "bad.host_sync"), ("HV402", "bad.mask_index"),
        ("HV403", "gone.entry")}


def test_sync_sites_name_the_port_function_and_the_allowlist_holds():
    """A sync made inside the package is charged to the function it is
    made in, and passes when that function is on the allowlist."""
    from hypergraphdb_tpu_torch.ops import linemask

    reg = verify.Registry()
    reg.entry("fixture.points", shapes=lambda d, s: (
        verify.ints(d, s, (16,), 8), verify.ints(d, s + 1, (16,), 1),
        8, 1))(linemask.mask_of_points)
    found = verify.check_syncs(reg, allow={})
    assert found and {verify.site_function(f.site) for f in found} == {
        "ops.linemask.mask_of_points"}
    assert verify.check_syncs(reg) == []
