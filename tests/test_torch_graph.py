"""The port's graph layer against the reference's: the same operations, from
the same numpy seed, give the same handles, values, targets, incidence
sets, atom scans and store tables (records, payloads, incidence, every
index) in both packages. Vetoes, use after close and removing a type atom
raise in both. ``bulk_import`` fills the store as the buffered bulk path
does. Tolerance: exact equality."""

import dataclasses
import datetime
import importlib

import numpy as np
import pytest

PKGS = ("hypergraphdb_tpu", "hypergraphdb_tpu_torch")


def mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def new_graph(pkg, **cfg):
    g = mod(pkg, "core.graph")
    config = mod(pkg, "core.config").HGConfiguration(**cfg)
    return g.HyperGraph(config)


def dump(g) -> dict:
    """Every committed table of a memory-backed graph, as plain Python
    (the format stamp ``hg.sys.format`` included)."""
    b = g.backend
    return {
        "links": dict(b._links),
        "data": dict(b._data),
        "inc": {a: s.snapshot().tolist() for a, s in b._incidence.items()},
        "idx": {name: [(k, v.tolist())
                       for k, v in b.get_index(name).bulk_items()]
                for name in b.index_names()},
        "next": g.handles.peek,
        "mutations": g._mutations,
        "types": dict(g.typesystem._handle_by_name),
    }


def views(g, handles) -> dict:
    """What the graph's read API says about ``handles``."""
    out = {}
    for h in handles:
        h = int(h)
        if not g.contains(h):
            out[h] = None
            continue
        v = g.get(h)
        out[h] = (
            (tuple(v.targets), v.value) if hasattr(v, "targets") else v,
            g.get_targets(h), g.get_type_handle_of(h), g.arity(h),
            g.is_link(h), g.get_incidence_set(h).array().tolist(),
        )
    out["atoms"] = list(g.atoms())
    out["count"] = g.atom_count()
    return out


VALUES = [
    7, -3, 2**40, 1.5, -0.25, "alpha", "a much longer string than sixteen",
    "nul\x00inside", b"\x00\x01raw", True, False,
    datetime.datetime(2024, 5, 17, 12, 30, tzinfo=datetime.timezone.utc),
    datetime.date(1999, 12, 31), [1, "two", 3.0, None, True, b"b"],
    (4, 5), {"k": 1, "a": [1, 2], "z": {"n": None}}, None,
]


def scenario(pkg, seed=5):
    """Adds of every primitive kind, links, links to links, a typed add, an
    HGLink value, a 0-arity link, replaces, and removals with and without
    keep_incident_links; returns the handles and the graph after each
    stage."""
    gmod = mod(pkg, "core.graph")
    r = np.random.default_rng(seed)
    g = new_graph(pkg)
    stages = []
    nodes = [g.add(v) for v in VALUES]
    nodes += list(g.add_nodes_bulk([f"n{i}" for i in range(12)]))
    links = []
    for i in range(30):
        ts = r.choice(nodes, size=int(r.integers(1, 4)), replace=False)
        links.append(g.add_link([int(t) for t in ts], value=int(i)))
    l2l = [g.add_link((links[0], links[1]), value="link-of-links"),
           g.add_link((links[2], nodes[0], links[0])),
           g.add(gmod.HGLink(targets=(nodes[3], nodes[4]), value=9.5)),
           g.add(12, type="int"), g.add_link(())]
    links += l2l
    links += list(g.add_links_bulk([[nodes[1], nodes[2]], [links[5]]],
                                   values=["b0", None]))
    stages.append(("add", dump(g), views(g, nodes + links)))
    g.replace(nodes[0], "seven")          # new type
    g.replace(links[3], None)             # to the null type
    g.replace(links[4], [1, 2, 3])
    g.replace(nodes[-1], gmod.HGLink(targets=(), value=3))
    stages.append(("replace", dump(g), views(g, nodes + links)))
    assert g.remove(links[0]) is True     # cascades to link-of-links
    assert g.remove(nodes[5]) is True
    assert g.remove(nodes[6], keep_incident_links=True) is True
    assert g.remove(links[0]) is False    # already gone
    stages.append(("remove", dump(g), views(g, nodes + links)))
    g.close()
    return [int(h) for h in nodes + links], stages


def test_same_operations_give_the_same_graph():
    ref_h, ref = scenario(PKGS[0])
    port_h, port = scenario(PKGS[1])
    assert port_h == ref_h
    for (name, dump_r, view_r), (_, dump_p, view_p) in zip(ref, port):
        assert dump_p == dump_r, name
        assert view_p == view_r, name


def test_bootstrap_handles_and_type_atoms():
    for pkg in PKGS:
        g = new_graph(pkg)
        names = ["top", "null", "bool", "int", "float", "string", "bytes",
                 "timestamp", "list", "dict"]
        assert [g.typesystem.handle_of(n) for n in names] == list(
            range(0, 20, 2))
        assert g.add("first") == 20 and g.handles.peek == 22
        g.close()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_mutation_sequences(seed):
    """Random interleavings of adds, links, replaces and removals (cascade
    and keep) give equal stores and reads."""

    def run(pkg):
        r = np.random.default_rng(seed)
        g = new_graph(pkg)
        live = [g.add(int(i)) for i in range(10)]
        for step in range(120):
            op = int(r.integers(0, 10))
            if op < 4 or len(live) < 4:
                live.append(g.add(float(r.random()) if op == 0
                                  else f"s{step}"))
            elif op < 7:
                ts = r.choice(live, size=int(r.integers(1, 4)),
                              replace=False)
                live.append(g.add_link([int(t) for t in ts], value=step))
            elif op == 7:
                g.replace(live[int(r.integers(0, len(live)))],
                          [step, "x"] if step % 2 else {"s": step})
            else:
                h = live.pop(int(r.integers(0, len(live))))
                g.remove(h, keep_incident_links=bool(op == 9))
                live = [x for x in live if g.contains(x)]
        out = dump(g), views(g, range(g.handles.peek))
        g.close()
        return out

    assert run(PKGS[1]) == run(PKGS[0])


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 - the class is the outcome
        return ("raise", type(e).__name__)


def test_veto_close_and_type_atom_removal_raise_in_both():
    got = {}
    for pkg in PKGS:
        ev = mod(pkg, "core.events")
        g = new_graph(pkg)
        a = g.add("a")
        link = g.add_link((a,), value=1)

        def veto(graph, event):
            return ev.HGListener.CANCEL

        g.events.add_listener(ev.HGAtomProposeEvent, veto)
        add_vetoed = _outcome(lambda: g.add("b"))
        g.events.remove_listener(ev.HGAtomProposeEvent, veto)
        g.events.add_listener(ev.HGAtomRemoveRequestEvent, veto)
        remove_vetoed = _outcome(lambda: g.remove(link))
        g.events.remove_listener(ev.HGAtomRemoveRequestEvent, veto)
        g.events.add_listener(ev.HGAtomReplaceRequestEvent, veto)
        replace_vetoed = _outcome(lambda: g.replace(a, "c"))
        g.events.remove_listener(ev.HGAtomReplaceRequestEvent, veto)
        type_atom = _outcome(lambda: g.remove(g.typesystem.handle_of("int")))
        missing = _outcome(lambda: g.get(10_000))
        no_type = _outcome(lambda: g.add(object()))
        g.close()
        closed = (_outcome(lambda: g.add("late")),
                  _outcome(lambda: g.remove(a)))
        got[pkg] = (add_vetoed, remove_vetoed, replace_vetoed, type_atom,
                    missing, no_type, closed, dump(g))
    assert got[PKGS[1]] == got[PKGS[0]]
    add_vetoed, remove_vetoed, replace_vetoed, type_atom, missing, no_type, \
        closed, _ = got[PKGS[1]]
    assert add_vetoed == ("raise", "HGException")
    assert remove_vetoed == ("ok", False)
    assert replace_vetoed == ("raise", "HGException")
    assert type_atom == ("raise", "HGException")
    assert missing == ("raise", "NotFoundError")
    assert no_type == ("raise", "TypeError_")
    assert closed == (("raise", "HGException"), ("raise", "HGException"))


def test_other_backends_raise_in_the_port():
    """A backend name the port does not know raises (the reference opens
    it in memory), and so does the native engine without a location (the
    reference writes ``./.hgdb``); "memory" and "partitioned" open."""
    errors = mod(PKGS[1], "core.errors")
    with pytest.raises(errors.HGException, match="unknown storage backend"):
        new_graph(PKGS[1], store_backend="bdb-je")
    with pytest.raises(errors.HGException, match="needs a location"):
        new_graph(PKGS[1], store_backend="native")
    for kind in ("memory", "partitioned"):
        new_graph(PKGS[1], store_backend=kind).close()


def c5_batch(r, n_entities, m):
    """One batch of bench c5's links: random entity pairs."""
    subj = r.integers(0, n_entities, size=m)
    obj = r.integers(0, n_entities, size=m)
    return [[int(a), int(b)] for a, b in zip(subj, obj)]


def bulk_build(pkg, loader, listen=False):
    """c5's build at a small size through ``loader`` ("bulk_import" or the
    buffered "add_*_bulk" path), then one streamed batch."""
    ev = mod(pkg, "core.events")
    g = new_graph(pkg)
    seen = []
    if listen:
        g.events.add_listener(
            ev.HGAtomAddedEvent,
            lambda graph, e: seen.append((int(e.handle), e.atom)))
    r = np.random.default_rng(11)
    ents = (g.bulk_import(values=list(range(300))) if loader == "bulk_import"
            else g.add_nodes_bulk(list(range(300))))
    e0 = int(ents[0])
    for s in (0, 250):
        tl = [[e0 + a, e0 + b] for a, b in c5_batch(r, 300, 250)]
        vals = list(range(s, s + 250))
        if loader == "bulk_import":
            g.bulk_import(values=vals, target_lists=tl)
        else:
            g.add_links_bulk(tl, values=vals)
    out = dump(g), views(g, range(0, g.handles.peek, 7)), seen
    g.close()
    return out


@pytest.mark.parametrize("listen", [False, True])
def test_bulk_import_matches_the_buffered_path_and_the_reference(listen):
    port_bulk = bulk_build(PKGS[1], "bulk_import", listen)
    assert port_bulk == bulk_build(PKGS[1], "add_bulk", listen)
    assert port_bulk == bulk_build(PKGS[0], "bulk_import", listen)
    assert bool(port_bulk[2]) == listen


def test_bulk_import_inside_a_transaction_and_beside_a_reader():
    def run(pkg):
        g = new_graph(pkg)
        a = g.add("a")
        tx = g.txman.begin()
        inner = g.bulk_import(values=[1, 2, 3])  # the buffered fallback
        g.txman.commit(tx)
        reader = g.txman.begin(readonly=True)
        before = g.get_incidence_set(a).array().tolist()
        import threading

        t = threading.Thread(target=lambda: g.bulk_import(
            values=["x", "y"], target_lists=[[a], [a, int(inner[0])]]))
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
        during = g.get_incidence_set(a).array().tolist()
        g.txman.commit(reader)
        after = g.get_incidence_set(a).array().tolist()
        out = list(inner), before, during, after, dump(g)
        g.close()
        return out

    got = run(PKGS[1])
    assert got == run(PKGS[0])
    _, before, during, after, _ = got
    assert before == during == [] and len(after) == 2


# ------------------------------------------------------------- records


@dataclasses.dataclass
class Person:
    name: str
    age: int


@dataclasses.dataclass
class Employee(Person):
    company: str = ""


@dataclasses.dataclass(frozen=True)
class Address:
    city: str
    zip: int


@dataclasses.dataclass
class Customer:
    name: str
    home: Address
    past: list
    tags: dict


def record_values():
    return [
        Person("ada", 36), Employee("bob", 25, "acme"),
        Customer("cy", Address("Oslo", 150), [Address("Rome", 1), 7, None],
                 {"k": Address("Lima", 2), "n": [1.5, b"b", True]}),
        Customer("di", Address("", -3), [], {}),
    ]


def records_scenario(pkg):
    """Record values added, linked, replaced and removed; the store
    tables, the values read back, the types and their hierarchy."""
    g = new_graph(pkg)
    hs = [g.add(v) for v in record_values()]
    link = g.add_link((hs[0], hs[2]), value=Employee("link", 1, "l"))
    g.replace(hs[1], Person("bob", 26))
    g.replace(hs[3], Customer("di", Address("Bern", 3000), [1], {"a": 2}))
    g.remove(hs[0], keep_incident_links=True)
    ts = g.typesystem
    pname = ts.infer(Person("", 0)).name
    out = (dump(g), views(g, hs + [link]),
           [ts.infer(v).dimensions() for v in record_values()],
           sorted(ts.subtypes_closure(pname)),
           sorted(ts.supertypes_of(ts.infer(Employee("", 0)).name)),
           ts.hierarchy_version,
           ts.infer(record_values()[2]).project(record_values()[2],
                                                "home.city"))
    g.close()
    return out


def test_records_match_the_reference():
    port = records_scenario(PKGS[1])
    assert port == records_scenario(PKGS[0])
    dims, closure, supers, _, city = port[2:]
    assert dims[0] == ["name", "age"] and city == "Oslo"
    assert len(closure) == 2 and len(supers) == 1


def test_record_bytes_equal_the_reference():
    """``RecordType.store`` and ``to_key`` bytes, nested dataclasses
    included, and the values ``make`` reads back."""
    rt = {pkg: mod(pkg, "types.record").RecordType for pkg in PKGS}
    for v in record_values():
        ref = rt[PKGS[0]].for_dataclass(type(v))
        port = rt[PKGS[1]].for_dataclass(type(v))
        assert port.store(v) == ref.store(v)
        assert port.to_key(v) == ref.to_key(v)
        assert port.make(port.store(v)) == ref.make(ref.store(v))
        as_dict = dataclasses.asdict(v)
        assert port.store(as_dict) == ref.store(as_dict)


def test_msgpack_lite_default_hook_is_byte_equal_to_msgpack():
    """The port's MessagePack subset with a ``default`` hook against the
    ``msgpack`` package on nested dataclasses; no hook raises as
    ``msgpack`` does."""
    import msgpack

    from hypergraphdb_tpu_torch.utils import msgpack_lite

    def hook(obj):
        if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
            return {"__dc__": type(obj).__qualname__,
                    "f": {f.name: getattr(obj, f.name)
                          for f in dataclasses.fields(obj)}}
        raise TypeError(f"unpackable: {type(obj)}")

    for v in record_values() + [[Address("x", 2**40)] * 20,
                                {"deep": [[Address("y", -2**31)]]}]:
        want = msgpack.packb(v, use_bin_type=True, default=hook)
        assert msgpack_lite.packb(v, default=hook) == want
        assert msgpack_lite.unpackb(want) == msgpack.unpackb(want,
                                                             raw=False)
    with pytest.raises(TypeError):
        msgpack_lite.packb(Address("z", 1))
    with pytest.raises(TypeError):
        msgpack_lite.packb({1, 2}, default=hook)
