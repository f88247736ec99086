"""The port's copies of the simulator's remaining layers (transport, faults,
telemetry, fleet, the experiment drivers, the switch-memory model and
multicast) against the JAX package's originals.

The layers are jax-free, so both packages run in this process on the same
cases: every ``SimResult`` field must be equal, ``fault_events`` and
``drop_causes`` included, and so must the telemetry exports, the
``FleetResult`` and ``compare_algorithms``' output. Each copied module must
differ from its reference only in its imports and the listed exceptions.
"""
import ast
import dataclasses
import difflib
import enum
import math
import random
from pathlib import Path

import pytest

from repro.core import canary as ref_canary
from repro.core import fleet as ref_fleet
from repro.core import telemetry as ref_telemetry
from repro.core.canary import memory_model as ref_memory
from repro.core.canary import multicast as ref_multicast

from repro_torch.core import canary as port_canary
from repro_torch.core import fleet as port_fleet
from repro_torch.core import telemetry as port_telemetry
from repro_torch.core.canary import memory_model as port_memory
from repro_torch.core.canary import multicast as port_multicast

SRC = Path(__file__).resolve().parents[1] / "src"
PKG = {"ref": (ref_canary, ref_fleet, ref_telemetry),
       "port": (port_canary, port_fleet, port_telemetry)}

# every module copied from repro/core, and where the copy may differ
# beyond its imports: the named top-level definitions ("<doc>" is the
# module docstring)
COPIED = {
    "canary/algorithms.py": (), "canary/backends.py": ("<doc>", "_flow_backend"),
    "canary/memory_model.py": (), "canary/multicast.py": (),
    "canary/simulator.py": (),
    "faults/__init__.py": (),
    "fleet/__init__.py": (), "fleet/arrivals.py": (), "fleet/driver.py": (),
    "fleet/metrics.py": (), "fleet/quota.py": (),
    "telemetry/__init__.py": (), "telemetry/analysis.py": (),
    "telemetry/attribution.py": (), "telemetry/export.py": (),
    "telemetry/hub.py": (), "telemetry/metrics.py": (),
    "transport/__init__.py": (), "transport/base.py": (),
    "transport/dcqcn.py": (), "transport/gbn.py": (),
    "flow/__init__.py": ("<doc>",), "flow/backend.py": ("<doc>", "FlowBackend"),
    "flow/calibrate.py": (), "flow/model.py": (),
    "flow/validate.py": ("<doc>", "validation_items", "run_validation",
                         "main"),
}
# imports a copy adds for its exception (the device the flow solve runs on)
ADDED_IMPORTS = {"flow/backend.py": ("from ...kernels.ops import "
                                     "resolve_device",)}


def _module_of(rel: str, root: str) -> str:
    parts = [root, "core"] + rel[:-3].split("/")
    return ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


def _resolve_import(line: str, module: str, is_pkg: bool):
    """``(absolute module, names)`` of a ``from X import Y`` line, with
    ``repro_torch`` read as ``repro``; ``None`` for any other line."""
    s = line.strip()
    if not s.startswith("from ") or " import " not in s:
        return None
    src, names = s[5:].split(" import ", 1)
    if src.startswith("."):
        dots = len(src) - len(src.lstrip("."))
        base = module.split(".")
        base = base if is_pkg else base[:-1]
        base = base[:len(base) - (dots - 1)]
        src = ".".join(base + ([src[dots:]] if src[dots:] else []))
    if src.split(".")[0] == "repro_torch":
        src = "repro" + src[len("repro_torch"):]
    return src, names.split("#")[0].strip()


def _regions(text: str, names) -> set:
    """1-based line numbers of the named top-level definitions."""
    tree = ast.parse(text)
    lines = set()
    for node in tree.body:
        if isinstance(node, ast.Expr) and node is tree.body[0] and \
                "<doc>" in names:
            lines |= set(range(node.lineno, node.end_lineno + 1))
        if getattr(node, "name", None) in names:
            first = min([node.lineno] + [d.lineno for d in
                                         getattr(node, "decorator_list", [])])
            lines |= set(range(first, node.end_lineno + 1))
    return lines


@pytest.mark.parametrize("rel", sorted(COPIED))
def test_copied_module_differs_only_in_imports(rel):
    ref_text = (SRC / "repro" / "core" / rel).read_text()
    port_text = (SRC / "repro_torch" / "core" / rel).read_text()
    is_pkg = rel.endswith("__init__.py")
    ref_mod, port_mod = _module_of(rel, "repro"), _module_of(rel, "repro_torch")
    ref_lines, port_lines = ref_text.splitlines(), port_text.splitlines()
    ref_free = _regions(ref_text, COPIED[rel])
    port_free = _regions(port_text, COPIED[rel])
    sm = difflib.SequenceMatcher(a=ref_lines, b=port_lines, autojunk=False)
    for tag, i1, i2, j1, j2 in sm.get_opcodes():
        if tag == "equal":
            continue
        old = [i for i in range(i1, i2) if i + 1 not in ref_free]
        new = [j for j in range(j1, j2) if j + 1 not in port_free and
               port_lines[j] not in ADDED_IMPORTS.get(rel, ())]
        old_imp = [_resolve_import(ref_lines[i], ref_mod, is_pkg) for i in old]
        new_imp = [_resolve_import(port_lines[j], port_mod, is_pkg)
                   for j in new]
        assert None not in old_imp + new_imp and old_imp == new_imp, (
            f"{rel}: lines {i1 + 1}-{i2} of the reference differ beyond "
            f"imports:\n" + "\n".join(difflib.unified_diff(
                ref_lines[i1:i2], port_lines[j1:j2], lineterm="")))


def _plain(x):
    """A comparable form of a result: dataclasses and objects by class name
    and fields, NaN as a string (NaN != NaN)."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__, [(f.name, _plain(getattr(x, f.name)))
                                   for f in dataclasses.fields(x)])
    if isinstance(x, enum.Enum):
        return (type(x).__name__, x.value)
    if isinstance(x, dict):
        return [(_plain(k), _plain(v)) for k, v in x.items()]
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, (set, frozenset)):
        return sorted(_plain(v) for v in x)
    if isinstance(x, float) and math.isnan(x):
        return "nan"
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    return (type(x).__name__, _plain(vars(x)))


def _run(pkg, cfg_kw, n=8, data_bytes=16384, algo="canary", noise=None,
         scale=4):
    canary = PKG[pkg][0]
    cfg = canary.scaled_config(scale, **cfg_kw)
    jobs = [canary.AllreduceJob(app=0, participants=list(range(n)),
                                data_bytes=data_bytes)]
    sim = canary.Simulator(cfg, jobs, algo=canary.Algo(algo),
                           noise_hosts=noise)
    return sim, sim.run()


def _same_run(**kw):
    (_, ref), (_, port) = _run("ref", **kw), _run("port", **kw)
    assert ref.correct
    assert _plain(port) == _plain(ref)
    return ref


# tests/core/test_transport.py's cases, at 16-32 KiB
TRANSPORT_CASES = {
    "gbn_loss_canary": dict(cfg_kw=dict(transport="gbn", drop_prob=0.01,
                                        retx_timeout_ns=5e4, seed=5),
                            data_bytes=32768),
    "gbn_loss_static": dict(cfg_kw=dict(transport="gbn", drop_prob=0.01,
                                        retx_timeout_ns=5e4, seed=5),
                            data_bytes=32768, algo="static_tree"),
    "gbn_loss_ring": dict(cfg_kw=dict(transport="gbn", drop_prob=0.01,
                                      retx_timeout_ns=5e4, seed=5),
                          data_bytes=32768, algo="ring"),
    "dcqcn_congested": dict(cfg_kw=dict(transport="dcqcn", seed=13,
                                        noise_prob=0.9, noise_delay_ns=100.0),
                            data_bytes=32768, noise=list(range(8, 16))),
}


@pytest.mark.parametrize("case", sorted(TRANSPORT_CASES))
def test_transport_matches_reference(case):
    res = _same_run(**TRANSPORT_CASES[case])
    if case.startswith("gbn"):
        assert res.dropped_packets > 0
    else:
        assert res.transport_stats["ecn_marks"] > 0


# tests/core/test_faults.py's SCHEDULES
SCHEDULES = {
    "spine_crash": [
        {"kind": "switch_crash", "target": 5, "at_ns": 3000.0,
         "heal_ns": 40000.0}],
    "link_down": [
        {"kind": "link_down", "target": "leaf1->spine0", "at_ns": 2000.0,
         "heal_ns": 30000.0}],
    "flap_plus_straggler": [
        {"kind": "link_flap", "target": "leaf0->spine2", "at_ns": 2000.0,
         "down_ns": 3000.0, "period_ns": 12000.0, "cycles": 2},
        {"kind": "host_slow", "target": 3, "at_ns": 1000.0,
         "heal_ns": 20000.0}],
}


@pytest.mark.parametrize("sched", sorted(SCHEDULES))
def test_faults_match_reference_under_gbn(sched):
    res = _same_run(cfg_kw=dict(seed=7, transport="gbn", retx_timeout_ns=5e4,
                                max_events=20_000_000,
                                faults=SCHEDULES[sched]))
    assert res.fault_events and res.survived == {0: True}


def test_generation_cap_escalation_matches_reference():
    res = _same_run(cfg_kw=dict(seed=3, retx_timeout_ns=5e4,
                                max_events=20_000_000, max_generations=1,
                                transport="gbn",
                                faults=[{"kind": "switch_crash", "target": 5,
                                         "at_ns": 2000.0}]),
                    n=10, data_bytes=32768)
    assert any(e["phase"] == "escalate" for e in res.fault_events)


def test_telemetry_matches_reference():
    sims = {}
    for pkg in ("ref", "port"):
        tel = PKG[pkg][2]
        sims[pkg] = tel.run_headline_cell(scale=4, data_bytes=32768)
    ref, port = sims["ref"], sims["port"]
    assert ref.telemetry_result.correct
    assert _plain(port.telemetry_result) == _plain(ref.telemetry_result)
    assert port.telemetry_result.summary() == ref.telemetry_result.summary()
    assert _plain(port_telemetry.to_dump(port.telemetry)) == \
        _plain(ref_telemetry.to_dump(ref.telemetry))
    doc = port_telemetry.to_perfetto(port.telemetry)
    assert _plain(doc) == _plain(ref_telemetry.to_perfetto(ref.telemetry))
    port_telemetry.validate_perfetto(doc)
    diag = {pkg: PKG[pkg][2].diagnose(PKG[pkg][2].view_of(s.telemetry))
            for pkg, s in sims.items()}
    assert _plain(diag["port"]) == _plain(diag["ref"])


def _fleet(pkg, overflow):
    canary, fleet, _ = PKG[pkg]
    cfg = canary.SimConfig(num_leaves=4, hosts_per_leaf=4, num_spines=4,
                           table_size=4096, seed=11, max_events=20_000_000)
    tenants = [canary.TenantSpec(0, weight=4.0, name="priority"),
               canary.TenantSpec(1, weight=1.0),
               canary.TenantSpec(2, weight=0.02, name="constrained")]
    rng = random.Random(5)
    jobs = []
    for t in tenants:
        arr = fleet.poisson_arrivals(2, 15_000.0, rng=rng)
        jobs += fleet.make_jobs(t, arr, range(cfg.num_hosts), 4, 16384,
                                rng=rng, app_base=t.tenant * 10)
    scenario = fleet.FleetScenario(cfg=cfg, tenants=tenants, jobs=jobs,
                                   quota_policy="weighted", overflow=overflow)
    adm = fleet.AdmissionController(tenants, policy="weighted",
                                    overflow=overflow)
    direct = canary.Simulator(cfg, jobs, admission=adm).run()
    return fleet.run_fleet(scenario), direct, adm


@pytest.mark.parametrize("overflow", ["degrade", "defer"])
def test_fleet_matches_reference(overflow):
    ref, ref_direct, ref_adm = _fleet("ref", overflow)
    port, port_direct, port_adm = _fleet("port", overflow)
    assert ref.correct and ref_direct.correct
    assert _plain(port) == _plain(ref)
    assert port.summary() == ref.summary()
    assert _plain(port_direct) == _plain(ref_direct)
    assert _plain(port_adm) == _plain(ref_adm)


def test_compare_algorithms_matches_reference():
    out = {}
    for pkg in ("ref", "port"):
        canary = PKG[pkg][0]
        out[pkg] = canary.compare_algorithms(
            canary.scaled_config(4, seed=3), 8, 16384, congestion=True,
            static_trees=(1, 2), reps=2)
    assert list(out["port"]) == list(out["ref"]) == \
        ["ring", "static_1", "static_2", "canary"]
    assert all(r.correct for r in out["ref"].values())
    assert _plain(out["port"]) == _plain(out["ref"])


def test_packet_backend_matches_reference():
    item = dict(label="canary/cong=1", algo="canary", n_trees=1,
                congestion=True, num_hosts=8, data_bytes=16384, rep=1,
                topology="fat_tree",
                cfg=dataclasses.asdict(ref_canary.scaled_config(4)))
    assert sorted(port_canary.BACKENDS) == sorted(ref_canary.BACKENDS)
    ref = ref_canary.run_cells([item], "packet")[0]
    port = port_canary.run_cells([item], "packet")[0]
    ref.pop("wall_s"), port.pop("wall_s")
    assert port == ref and ref["correct"]


def test_canary_exports_the_reference_surface():
    assert sorted(port_canary.__all__) == sorted(ref_canary.__all__)
    for name in ref_canary.__all__:
        assert hasattr(port_canary, name), name


def test_memory_model_and_multicast_match_reference():
    assert _plain(port_memory.paper_example()) == \
        _plain(ref_memory.paper_example())
    for scale in (4, 16):
        for diameter in (2, 4):
            got = port_memory.model_for(port_canary.scaled_config(scale),
                                        diameter)
            want = ref_memory.model_for(ref_canary.scaled_config(scale),
                                        diameter)
            assert _plain(got) == _plain(want)
            assert got.occupancy_kib == want.occupancy_kib
    rng = random.Random(0)
    for num_ports, shards in ((8, 1), (8, 2), (16, 4), (64, 8)):
        assert port_multicast.build_rule_table(num_ports, shards) == \
            ref_multicast.build_rule_table(num_ports, shards)
        assert port_multicast.num_rules(num_ports, shards) == \
            ref_multicast.num_rules(num_ports, shards)
        for _ in range(20):
            ports = sorted(rng.sample(range(num_ports),
                                      rng.randint(1, num_ports)))
            bm = port_multicast.ports_to_bitmap(ports, num_ports)
            assert bm == ref_multicast.ports_to_bitmap(ports, num_ports)
            assert port_multicast.multicast_ports(bm, num_ports, shards) == \
                ref_multicast.multicast_ports(bm, num_ports, shards) == ports
