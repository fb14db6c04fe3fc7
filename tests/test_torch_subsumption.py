"""The port's subsumption against the reference's (``tests/
test_subsumption.py``): declared ``HGSubsumes`` links, same-type value
subsumption, a type's own ``subsumes``, and the graph-resident type
hierarchy behind ``TypePlus``, with the same operations in both packages;
handles and answers compared exactly."""

from test_torch_query import PKGS, mod, new_graph


def on_both(build):
    out = []
    for pkg in PKGS:
        g = new_graph(pkg)
        out.append(build(pkg, g, mod(pkg, "query.dsl"),
                         mod(pkg, "atom.utilities")))
        g.close()
    assert out[1] == out[0]
    return out[1]


def test_declared_subsumption_link():
    def build(pkg, g, q, u):
        gen, spec = g.add("general-concept"), g.add("specific-concept")
        g.add_link((gen, spec), value=u.SubsumesValue())
        return (u.subsumes_declared(g, int(gen), int(spec)),
                u.subsumes_declared(g, int(spec), int(gen)),
                u.declared_specifics(g, int(gen)),
                q.find_all(g, q.and_(q.is_(gen), q.subsumes(spec))),
                q.find_all(g, q.and_(q.is_(spec), q.subsumed(gen))),
                q.find_all(g, q.and_(q.is_(spec), q.subsumes(gen))),
                int(gen), int(spec))

    fwd, back, specifics, sub, subd, none, gen, spec = on_both(build)
    assert fwd and not back and specifics == frozenset({spec})
    assert sub == [gen] and subd == [spec] and none == []


def test_value_level_subsumption_same_type():
    def build(pkg, g, q, u):
        a1, a2, b = g.add("same"), g.add("same"), g.add("different")
        return q.find_all(g, q.subsumes(a2)), (int(a1), int(a2), int(b))

    res, (a1, a2, b) = on_both(build)
    assert a1 in res and a2 in res and b not in res


def test_subsumption_rejects_cross_type():
    def build(pkg, g, q, u):
        n_int, n_str = g.add(42), g.add("42")
        return q.find_all(g, q.and_(q.is_(n_int), q.subsumes(n_str)))

    assert on_both(build) == []


def test_custom_type_subsumption():
    def build(pkg, g, q, u):
        class PrefixType(mod(pkg, "types.primitive").StringType):
            name = "prefix-str"

            def subsumes(self, general, specific):
                return (specific is not None and general is not None
                        and str(specific).startswith(str(general)))

        g.typesystem.register(PrefixType())
        a = g.add_node("ab", type="prefix-str")
        abc = g.add_node("abcde", type="prefix-str")
        return (q.find_all(g, q.and_(q.is_(a), q.subsumes(abc))),
                q.find_all(g, q.and_(q.is_(abc), q.subsumes(a))), int(a))

    yes, no, a = on_both(build)
    assert yes == [a] and no == []


def test_type_hierarchy_via_links_feeds_typeplus():
    def build(pkg, g, q, u):
        string_type = mod(pkg, "types.primitive").StringType
        for name in ("vehicle", "car"):
            t = string_type()
            t.name = name
            g.typesystem.register(t)
        link = u.declare_subsumes(g, "vehicle", "car")
        c1 = g.add_node("beetle", type="car")
        v1 = g.add_node("boat", type="vehicle")
        ts = g.typesystem
        th, sh = ts.handle_of("vehicle"), ts.handle_of("car")
        return (q.find_all(g, q.type_plus("vehicle")),
                u.subsumes_declared(g, int(th), int(sh)),
                sorted(ts.subtypes_closure("vehicle")),
                sorted(ts.supertypes_of("car")), ts.hierarchy_version,
                int(link), int(c1), int(v1))

    res, declared, closure, supers, version, link, c1, v1 = on_both(build)
    assert c1 in res and v1 in res and declared
    assert closure == ["car", "vehicle"] and supers == ["vehicle"]


def test_load_subsumptions_restores_the_hierarchy():
    """``load_subsumptions`` (run when a graph opens) registers every
    persisted subsumption link again: the same count and closure in both
    packages after the type system forgets the edge."""
    def build(pkg, g, q, u):
        string_type = mod(pkg, "types.primitive").StringType
        for name in ("animal", "dog"):
            t = string_type()
            t.name = name
            g.typesystem.register(t)
        u.declare_subsumes(g, "animal", "dog")
        g.typesystem._supertypes.clear()
        before = sorted(g.typesystem.subtypes_closure("animal"))
        n = u.load_subsumptions(g)
        return before, n, sorted(g.typesystem.subtypes_closure("animal"))

    before, n, after = on_both(build)
    assert before == ["animal"] and n == 1 and after == ["animal", "dog"]
