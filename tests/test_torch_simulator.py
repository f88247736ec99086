"""The port's copy of the simulator (``repro_torch.core.canary``) and of the
trace recorder / schedule compiler against the JAX package's originals.

The copies must behave identically: every golden case reproduces the
committed goldens field for field, every ``SimResult`` field equals the
reference simulator's on the same case, and the recorded and compiled
schedules of the replay variants equal the reference's.
"""
import dataclasses
import functools
import operator
import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "core"))
from golden_cases import CASES, _cfg, load_goldens, result_to_jsonable  # noqa: E402

from repro.core import canary as ref_canary  # noqa: E402
from repro.core import trace as ref_trace  # noqa: E402

from repro_torch.core import canary as port_canary  # noqa: E402
from repro_torch.core import trace as port_trace  # noqa: E402

# the replay variants of tests/trace/test_replay.py (P = 10, 4 blocks)
P = 10
N_BLOCKS = 4
VARIANTS = [
    dict(seed=3, timeout_ns=50.0, noise_prob=0.2),
    dict(seed=11, timeout_ns=1e6, retx_timeout_ns=2e5),
    dict(seed=29, timeout_ns=500.0, noise_prob=0.05),
]


def _port_cfg(ref_cfg):
    return port_canary.SimConfig(**{f.name: getattr(ref_cfg, f.name)
                                    for f in dataclasses.fields(ref_cfg)
                                    if f.init})


def _port_case(name):
    cfg_kw, jobs_spec, algo, n_trees, noise = CASES[name]
    return port_canary.Simulator(
        _port_cfg(_cfg(**cfg_kw)),
        [port_canary.AllreduceJob(**s) for s in jobs_spec],
        algo=port_canary.Algo(algo.value), n_trees=n_trees, noise_hosts=noise)


def _ref_case(name):
    cfg_kw, jobs_spec, algo, n_trees, noise = CASES[name]
    return ref_canary.Simulator(
        _cfg(**cfg_kw), [ref_canary.AllreduceJob(**s) for s in jobs_spec],
        algo=algo, n_trees=n_trees, noise_hosts=noise)


@pytest.fixture(scope="module")
def goldens():
    return load_goldens()


@pytest.mark.parametrize("name", sorted(CASES))
def test_simulator_copy_reproduces_goldens(name, goldens):
    """Field for field against the committed goldens and the reference.

    ``avg_utilization`` is ``sum(link_utilization) / len``: Python 3.12's
    ``sum`` of floats is compensated, the goldens' interpreter summed left
    to right, so that one field is held to the reference simulator on this
    interpreter and the golden to its own left-to-right mean.
    """
    port = _port_case(name).run()
    ref = _ref_case(name).run()
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    got, want = result_to_jsonable(port), goldens[name]
    for field in sorted(want):
        if field != "avg_utilization":
            assert got[field] == want[field], f"{name}: {field!r} diverged"
    utils = want["link_utilization"]
    assert want["avg_utilization"] == \
        functools.reduce(operator.add, utils, 0.0) / len(utils)
    assert got["avg_utilization"] == sum(utils) / len(utils)


def _record(canary, trace, kw):
    cfg = canary.scaled_config(4, trace=True, **kw)
    jobs = [canary.AllreduceJob(app=0, participants=list(range(P)),
                                data_bytes=N_BLOCKS * 1024)]
    sim = canary.Simulator(cfg, jobs, algo=canary.Algo.CANARY,
                           noise_hosts=list(range(P, 16)))
    assert sim.run().correct
    return trace.compile_app(sim.trace, 0)


@pytest.mark.parametrize("variant", range(len(VARIANTS)))
def test_recorded_schedules_match_reference(variant):
    kw = dict(dict(seed=3, timeout_ns=200.0), **VARIANTS[variant])
    ref = _record(ref_canary, ref_trace, kw)
    port = _record(port_canary, port_trace, kw)
    assert len(port) == len(ref) == N_BLOCKS
    for p, r in zip(port, ref):
        assert dataclasses.asdict(p) == dataclasses.asdict(r)
        assert (p.depth, p.max_fanin, p.message_count()) == \
            (r.depth, r.max_fanin, r.message_count())
    assert port_trace.schedule_report(port, 1024) == \
        ref_trace.schedule_report(ref, 1024)
