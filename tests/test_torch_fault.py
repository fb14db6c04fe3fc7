"""The port's ``fault/`` against the reference's: every case of
``tests/test_fault.py`` (registry schedules, seeded determinism,
classification, the breaker's state machine) runs as one scenario on both
packages' modules, and the two records must be equal, draw for draw (the
per-point ``random.Random`` streams are the same). Then the port's own
wiring: the transaction manager's two commit crash points fire in both
graphs alike, and ``utils.metrics.global_metrics`` counts the fires.
Single-threaded, clock-injected; tolerance: exact equality."""

from __future__ import annotations

import importlib

import pytest

PKGS = ("hypergraphdb_tpu", "hypergraphdb_tpu_torch")


def fault(pkg):
    return importlib.import_module(f"{pkg}.fault")


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def outcome(fn):
    try:
        return ("ok", fn())
    except BaseException as e:  # noqa: BLE001 - the class is the outcome
        return ("raise", type(e).__name__)


def checks(F, reg, name, n, **ctx):
    return [outcome(lambda: reg.check(name, **ctx)) for _ in range(n)]


# ------------------------------------------------------------- registry


def disabled_registry(F):
    f = F.FaultRegistry()
    f.arm("p", times=100)
    f.check("p")
    return f.hits("p"), f.fired("p"), f.enabled


def times_schedule(F):
    f = F.FaultRegistry().enable(seed=0)
    f.arm("p", times=2)
    return checks(F, f, "p", 4), f.hits("p"), f.fired("p"), f.journal


def at_schedule(F):
    f = F.FaultRegistry().enable(seed=0)
    f.arm("p", at={2, 4}, error=F.PermanentFault)
    return checks(F, f, "p", 5)


def prob_schedule(F):
    def pattern(seed):
        f = F.FaultRegistry().enable(seed=seed)
        f.arm("p", prob=0.5)
        return [o[0] for o in checks(F, f, "p", 64)]

    return pattern(7), pattern(7), pattern(8)


def interleaving(F):
    def run(order):
        f = F.FaultRegistry().enable(seed=3)
        f.arm("p1", prob=0.4)
        f.arm("p2", prob=0.4)
        fired = {"p1": [], "p2": []}
        for name in order:
            try:
                f.check(name)
            except F.TransientFault:
                fired[name].append(f.hits(name))
        return fired

    return run(["p1", "p2"] * 32), run(["p1"] * 32 + ["p2"] * 32)


def when_predicate(F):
    f = F.FaultRegistry().enable(seed=0)
    f.arm("p", times=10, when=lambda ctx: ctx.get("target") == "b")
    return (checks(F, f, "p", 1, target="a"),
            checks(F, f, "p", 1, target="b"), f.fired("p"), f.hits("p"))


def unarmed_point(F):
    f = F.FaultRegistry().enable(seed=0)
    f.check("never.armed", extra="ctx")
    return f.hits("never.armed"), f.fired("never.armed")


def injected_crash(F):
    f = F.FaultRegistry().enable(seed=0)
    f.arm("kill", at={1}, error=F.InjectedCrash)
    try:
        f.check("kill")
        return "passed"
    except Exception:  # noqa: BLE001 - the point of the case
        return "caught as Exception"
    except F.InjectedCrash:
        return "BaseException only"


def arm_validation(F):
    f = F.FaultRegistry().enable(seed=0)
    out = [outcome(lambda: f.arm("p")), outcome(lambda: f.arm("p", prob=1.5))]
    f.arm("p", times=5)
    out.append(f.armed())
    f.disarm("p")
    out.append(checks(F, f, "p", 1))
    f.reset()
    out.append((f.hits("p"), f.journal))
    return out


def injected_counter(F):
    pkg = F.__name__.rsplit(".", 1)[0]
    gm = importlib.import_module(f"{pkg}.utils.metrics").global_metrics

    def count():
        return gm.counters.get("fault.injected", 0)

    before = count()
    f = F.FaultRegistry().enable(seed=0)
    f.arm("p", times=1)
    out = checks(F, f, "p", 2)
    return out, count() - before


# ------------------------------------------------------------- classification


def classification(F):
    class MarkedTransient(Exception):
        transient = True

    class MarkedPermanent(TimeoutError):
        transient = False

    cases = [F.TransientFault("x"), TimeoutError("x"), ConnectionError("x"),
             F.PermanentFault("x"), RuntimeError("x"), MarkedTransient(),
             MarkedPermanent()]
    return ([F.is_transient(e) for e in cases],
            F.is_transient(RuntimeError("x"), extra=(RuntimeError,)),
            isinstance(F.TransientFault("x"), F.FaultError),
            F.DEFAULT_TRANSIENT[1:])


# ------------------------------------------------------------- breaker


def make_breaker(F, threshold=3, cooldown=1.0):
    clock = FakeClock()
    log = {"states": [], "trips": [], "key_states": [], "key_trips": []}
    b = F.CircuitBreaker(
        threshold=threshold, cooldown_s=cooldown, clock=clock,
        on_state=log["states"].append,
        on_trip=lambda: log["trips"].append(1),
        on_key_state=lambda k, c: log["key_states"].append((k, c)),
        on_key_trip=log["key_trips"].append)
    return b, clock, log


def breaker_trips(F):
    b, clock, log = make_breaker(F, threshold=3)
    key = ("bfs", 2)
    out = [b.allow(key)]
    b.record_failure(key)
    b.record_failure(key)
    out += [b.state_of(key), b.allow(key)]
    b.record_failure(key)
    out += [b.state_of(key), b.allow(key), b.trips, b.worst_code()]
    return out, log


def breaker_success_resets(F):
    b, clock, log = make_breaker(F, threshold=2)
    b.record_failure("k")
    b.record_success("k")
    b.record_failure("k")
    return b.state_of("k"), b.trips, log


def breaker_probe_success(F):
    b, clock, log = make_breaker(F, threshold=1, cooldown=1.0)
    b.record_failure("k")
    out = [b.allow("k")]
    clock.advance(1.5)
    out += [b.allow("k"), b.state_of("k"), b.allow("k")]
    b.record_success("k")
    out += [b.state_of("k"), b.allow("k")]
    return out, log


def breaker_probe_failure(F):
    b, clock, log = make_breaker(F, threshold=1, cooldown=1.0)
    b.record_failure("k")
    clock.advance(1.5)
    out = [b.allow("k")]
    b.record_failure("k")
    out += [b.state_of("k"), b.allow("k"), b.trips]
    return out, log


def breaker_lost_probe(F):
    b, clock, log = make_breaker(F, threshold=1, cooldown=1.0)
    b.record_failure("k")
    clock.advance(1.5)
    out = [b.allow("k"), b.peek("k")]
    clock.advance(1.5)
    out += [b.peek("k"), b.allow("k"), b.states()]
    return out, log


def breaker_per_key(F):
    b, clock, log = make_breaker(F, threshold=1)
    b.record_failure("bad")
    out = [b.allow("bad"), b.allow("good"), b.worst_code()]
    b.reset("bad")
    out += [b.allow("bad"), b.states(), b.worst_code()]
    return out, log


SCENARIOS = {
    "disabled_registry": (disabled_registry, (0, 0, False)),
    "times_schedule": (times_schedule, (
        [("raise", "TransientFault")] * 2 + [("ok", None)] * 2, 4, 2,
        [("p", 1), ("p", 2)])),
    "at_schedule": (at_schedule, [("ok", None), ("raise", "PermanentFault"),
                                  ("ok", None), ("raise", "PermanentFault"),
                                  ("ok", None)]),
    "prob_schedule": (prob_schedule, None),
    "interleaving": (interleaving, None),
    "when_predicate": (when_predicate, (
        [("ok", None)], [("raise", "TransientFault")], 1, 2)),
    "unarmed_point": (unarmed_point, (1, 0)),
    "injected_crash": (injected_crash, "BaseException only"),
    "arm_validation": (arm_validation, [
        ("raise", "ValueError"), ("raise", "ValueError"), ["p"],
        [("ok", None)], (0, [])]),
    "injected_counter": (injected_counter, (
        [("raise", "TransientFault"), ("ok", None)], 1)),
    "classification": (classification, (
        [True, True, True, False, False, True, False], True, True,
        (TimeoutError, ConnectionError))),
    "breaker_trips": (breaker_trips, None),
    "breaker_success_resets": (breaker_success_resets, None),
    "breaker_probe_success": (breaker_probe_success, None),
    "breaker_probe_failure": (breaker_probe_failure, None),
    "breaker_lost_probe": (breaker_lost_probe, None),
    "breaker_per_key": (breaker_per_key, None),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_fault_scenario_matches_reference(name):
    fn, want = SCENARIOS[name]
    ref, port = (fn(fault(pkg)) for pkg in PKGS)
    assert port == ref
    if want is not None:
        assert port == want


def test_scenarios_see_real_mixes():
    """The cases compared without a literal still show what they test:
    a seeded mix that depends on the seed, interleaving-independence, and
    the breaker's transitions."""
    F = fault(PKGS[1])
    a, a2, b = prob_schedule(F)
    assert a == a2 and a != b and 0 < a.count("raise") < 64
    inter, seq = interleaving(F)
    assert inter == seq and inter["p1"]
    out, log = breaker_trips(F)
    assert out == [True, "closed", True, "open", False, 1, 2]
    assert log["trips"] == [1] and log["key_trips"] == [("bfs", 2)]
    out, log = breaker_probe_success(F)
    assert out == [False, True, "half_open", False, "closed", True]
    assert log["states"][-1] == 0


def test_wired_points_are_the_ports_sites():
    """The port lists the six points it wires, each a reference point."""
    ref, port = fault(PKGS[0]), fault(PKGS[1])
    assert set(port.WIRED_POINTS) == {"serve.launch", "serve.collect",
                                      "tx.commit.pre", "tx.commit.apply",
                                      "ckpt.save_npz", "ckpt.save_plans"}
    assert set(port.WIRED_POINTS) <= set(ref.WIRED_POINTS)
    assert port.global_faults() is port.global_faults()
    assert port.global_faults() is not ref.global_faults()


@pytest.mark.parametrize("point", ["tx.commit.pre", "tx.commit.apply"])
def test_tx_commit_fault_points_match_reference(point):
    """An armed commit point fails the k-th write commit in both graphs
    alike: the failing add leaves nothing behind, the next one commits.
    (The reference's graph also commits a format stamp at open, so the
    commit counters are compared from after the open.)"""
    from tests.test_torch_graph import mod, new_graph

    got = {}
    for pkg in PKGS:
        F = fault(pkg)
        reg = F.global_faults()
        g = new_graph(pkg)
        committed = g.txman.committed
        try:
            reg.reset().enable(seed=0)
            reg.arm(point, at={2}, error=F.TransientFault)
            first = outcome(lambda: int(g.add("a")))
            second = outcome(lambda: int(g.add("b")))
            third = outcome(lambda: int(g.add("c")))
            fired = (reg.hits(point), reg.fired(point))
            commits = g.txman.committed - committed
        finally:
            reg.reset().disable()
        values = sorted(str(g.get(h)) for h in
                        g.find_all(mod(pkg, "query.conditions").AtomType(
                            g.typesystem.handle_of("string"))))
        got[pkg] = (first, second, third, fired, values, commits)
        g.close()
    assert got[PKGS[1]] == got[PKGS[0]]
    first, second, third, fired, values, commits = got[PKGS[1]]
    assert second == ("raise", "TransientFault") and fired == (3, 1)
    assert commits == 2
    assert first[0] == third[0] == "ok" and "b" not in values
