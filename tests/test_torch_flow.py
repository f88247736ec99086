"""The port's flow backend (``repro_torch.core.flow``) against the JAX
package's.

The lowering, calibration and validation are copies of the reference's;
``batch.py`` is the one ported module: the reference's ``jit(vmap)``-ed
cell solve becomes one batched PyTorch solve over ``[cells, links]``. On
the CPU, the lowered cells must equal the reference's field for field, the
batched solve must agree with JAX's ``run_batch`` within a relative 1e-6
(float32 on both sides) and with the pure-Python ``solve_cell`` within
1e-4 (the reference test's own bound), a whole matrix must be one batched
solve, and the backend's cells must carry the reference's keys. The
``cuda``-marked case holds the card's solve to the CPU's.
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch

try:  # the card's machine has no JAX: only the ``cuda`` test runs there
    import jax  # noqa: F401

    from repro.core import canary as ref_canary
    from repro.core.flow import batch as ref_batch
    from repro.core.flow import model as ref_model
except ImportError:
    ref_canary = None

from repro_torch.core import canary as port_canary
from repro_torch.core.flow import batch, suites
from repro_torch.core.flow import model as port_model
from repro_torch.core.flow.backend import FlowBackend

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KiB = 1024
CPU = "cpu"
needs_jax = pytest.mark.skipif(ref_canary is None, reason="needs JAX")


def _item(canary, topology="fat_tree", algo="canary", n_trees=1,
          congestion=False, data_bytes=128 * KiB, rep=0):
    """``tests/flow/test_flow_backend.py``'s hand-built work item."""
    if topology == "fat_tree":
        cfg = canary.scaled_config(4)
    else:
        cfg = canary.three_tier_config(num_pods=4, leaves_per_pod=2,
                                       hosts_per_leaf=4, aggs_per_pod=2,
                                       num_cores=4)
    n = max(2, cfg.num_hosts // 2)
    return dict(label=f"{algo}{n_trees}/cong={int(congestion)}", algo=algo,
                n_trees=n_trees, congestion=congestion, num_hosts=n,
                data_bytes=data_bytes, rep=rep, topology=topology,
                cfg=dataclasses.asdict(cfg))


def _grid(canary):
    """``tests/flow/test_flow_backend.py``'s ``_grid`` at two message
    sizes: 24 cells, so that JAX never compiles that test's 12-cell shape
    here (it counts its own compilations of that shape, and a worker may
    run both files)."""
    return [_item(canary, topo, algo, nt, cong, data_bytes)
            for data_bytes in (128 * KiB, 512 * KiB)
            for topo in ("fat_tree", "three_tier") for cong in (False, True)
            for algo, nt in (("canary", 1), ("static_tree", 1),
                             ("static_tree", 4))]


def _paper_matrix(topology, reps=2):
    """fig7 + fig8 + lb at a paper-scale fabric (``chip_smoke.py``'s phase
    4f runs 8 repetitions)."""
    return [it for s in suites.SUITES
            for it in suites.expand_suite(s, topology, reps)]


MATRICES = {"grid": lambda: _grid(port_canary),
            "fat_tree_4096": lambda: _paper_matrix("fat_tree_4096"),
            "three_tier_4096": lambda: _paper_matrix("three_tier_4096")}


@needs_jax
def test_lowering_matches_reference():
    for ref_it, port_it in zip(_grid(ref_canary), _grid(port_canary)):
        assert port_it == ref_it
        want = ref_model.lower_item(ref_it)
        got = port_model.lower_item(port_it)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert port_model.solve_cell(got) == ref_model.solve_cell(want)


@needs_jax
@pytest.mark.parametrize("matrix", sorted(MATRICES))
def test_batched_solve_matches_jax_and_python(matrix):
    items = MATRICES[matrix]()
    cells = [port_model.lower_item(it) for it in items]
    ref_cells = [ref_model.lower_item(it) for it in items]
    before = batch.trace_count()
    t, gp = batch.run_batch(cells, device=CPU)
    assert batch.trace_count() - before == 1, "one batched solve a matrix"
    t_jax, gp_jax = ref_batch.run_batch(ref_cells)
    assert len(t) == len(gp) == len(items)
    assert all(isinstance(v, float) for v in t + gp)
    assert t == pytest.approx(t_jax, rel=1e-6)
    assert gp == pytest.approx(gp_jax, rel=1e-6)
    for cell, ti, gi in zip(cells, t, gp):
        t_py, gp_py = port_model.solve_cell(cell)
        assert ti == pytest.approx(t_py, rel=1e-4)
        assert gi == pytest.approx(gp_py, rel=1e-4)


@needs_jax
def test_backend_cells_match_reference():
    items = _grid(port_canary)
    bk = FlowBackend(device=CPU)
    before = batch.trace_count()
    cells = bk.run_cells(items)
    assert bk.jit_calls == 1 and batch.trace_count() - before == 1
    want = ref_canary.get_backend("flow").run_cells(_grid(ref_canary))
    for c, w, item in zip(cells, want, items):
        assert list(c) == list(w), "the cell schema is the reference's"
        assert c["jit_traces"] == 1
        for k in ("label", "rep", "correct", "backend", "bound", "g_mix",
                  "t_send_us"):
            assert c[k] == w[k], k
        assert c["runtime_us"] == pytest.approx(w["runtime_us"], rel=1e-6)
        assert c["goodput_gbps"] == pytest.approx(w["goodput_gbps"],
                                                  rel=1e-6)
        assert c["label"] == item["label"] and c["wall_s"] > 0


def test_registry_resolves_flow_to_the_port_backend(monkeypatch):
    assert set(port_canary.BACKENDS) == {"packet", "flow"}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_canary.get_backend("flow")       # the card, or nothing
    with pytest.raises(RuntimeError, match="CUDA"):
        batch.run_batch([port_model.lower_item(_item(port_canary))])
    assert isinstance(FlowBackend(device=CPU), FlowBackend)
    assert batch.run_batch([]) == ([], [])


@pytest.mark.parametrize("refusal", ["gbn", "dcqcn", "telemetry", "faults"])
def test_flow_backend_refuses_what_it_cannot_model(refusal):
    item = _item(port_canary)
    if refusal in ("gbn", "dcqcn"):
        item["cfg"]["transport"], match = refusal, "transport"
    elif refusal == "telemetry":
        item["cfg"]["telemetry"], match = True, "telemetry"
    else:
        item["cfg"]["faults"], match = [
            {"kind": "switch_crash", "target": 1, "at_ns": 1000.0,
             "heal_ns": 5000.0}], "fault"
    with pytest.raises(ValueError, match=match):
        FlowBackend(device=CPU).run_cells([item])


@needs_jax
@pytest.mark.parametrize("suite", ["fig7", "fig8", "lb"])
@pytest.mark.parametrize("topology", ["fat_tree", "three_tier",
                                      "fat_tree_4096", "three_tier_4096"])
def test_suite_expansion_matches_benchmarks(suite, topology):
    from benchmarks.sweep import expand_suite
    assert suites.expand_suite(suite, topology, 2) == \
        expand_suite(suite, topology, 2)


def test_suite_expansion_rejects_unknown_names():
    with pytest.raises(ValueError, match="suite"):
        suites.expand_suite("fig99", "fat_tree", 1)
    with pytest.raises(ValueError, match="topology"):
        suites.expand_suite("fig7", "torus", 1)


def _env(**extra):
    env = dict(os.environ, **extra)
    env["PYTHONPATH"] = os.path.join(ROOT, "src") + os.pathsep + \
        env.get("PYTHONPATH", "")
    return env


def test_canary_and_flow_import_neither_torch_jax_nor_reference():
    script = (
        "import sys\n"
        "import repro_torch.core.canary as c, repro_torch.core.flow as f\n"
        "import repro_torch.core.transport, repro_torch.core.telemetry\n"
        "import repro_torch.core.fleet, repro_torch.core.faults\n"
        "from repro_torch.core.flow import suites, validate\n"
        "assert set(c.BACKENDS) == {'packet', 'flow'}\n"
        "c.get_backend('packet')\n"
        "f.lower_item(suites.expand_suite('fig7', 'fat_tree', 1)[0])\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('torch', 'jax', 'jaxlib', 'repro', 'benchmarks'))\n"
        "assert not bad, bad\n"
        "print('TORCHFREE_OK')\n")
    proc = subprocess.run([sys.executable, "-c", script], env=_env(),
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert "TORCHFREE_OK" in proc.stdout, proc.stdout + proc.stderr


def test_flow_validation_fast_grid(tmp_path):
    """``python -m repro_torch.core.flow.validate`` on its own, as
    ``tests/flow/test_flow_backend.py`` runs the reference's."""
    out = tmp_path / "flow_validation.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.core.flow.validate", "--out",
         str(out), "--device", CPU], env=_env(BENCH_FAST="1"), cwd=tmp_path,
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + "\n" + proc.stderr
    report = json.loads(out.read_text())
    assert report["ok"] and report["fast"]
    assert report["tolerance"] == pytest.approx(0.60)
    assert {g["topology"] for g in report["grids"]} == \
        {"fat_tree", "three_tier"}


@pytest.mark.cuda
def test_card_solve_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for name, make in sorted(MATRICES.items()):
        items = make()
        cpu = FlowBackend(device=CPU).run_cells(items)
        card = FlowBackend().run_cells(items)
        assert FlowBackend().device.type == "cuda"
        for c, g in zip(cpu, card):
            assert g["runtime_us"] == pytest.approx(c["runtime_us"],
                                                    rel=1e-6), name
            assert g["goodput_gbps"] == pytest.approx(c["goodput_gbps"],
                                                      rel=1e-6), name
            assert g["bound"] == c["bound"]
