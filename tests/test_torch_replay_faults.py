"""Trees recorded under loss, a switch crash and DCQCN, replayed in fixed
point: the port against the JAX package.

Three worlds of ``chip_smoke.py``'s phase 4e, cut to ``scaled_config(4)``
(16 hosts: participants 0-9, hosts 10-15 sending noise; seed 3, timeout
50 ns, noise 0.2) and 16 KiB a participant: go-back-N under random loss
(1 % here: at 16 KiB, 0.1 % drops no packet), go-back-N with spine 1 (switch
5) crashed from 2 us to 12 us, and DCQCN. Both packages record each world;
the schedules must be equal field for field, and so must every
``SimResult`` field. The port's int32 replay of its own schedules on the
CPU must equal the JAX package's ``fixed_point_replay`` of the reference's
schedules bit for bit (the quantize and dequantize kernels in interpret
mode, the segment-sum through its plain reference, as
``tests/test_torch_replay.py`` runs it), and the int32 sum must be the
same in all three worlds: the trees differ, the integer sum does not.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import canary as ref_canary
from repro.core import trace as ref_trace
from repro.core.trace import executor as jexec
from repro.kernels.ref import packet_accumulate_ref as jax_accumulate_ref

from repro_torch.core import canary as port_canary
from repro_torch.core import trace as port_trace
from repro_torch.kernels import fixed_point_scale
from repro_torch.kernels.ref import quantize_ref

P, HOSTS, MSG, BLOCK, D, BITS = 10, 16, 16 * 1024, 1024, 32, 24
BASE = dict(seed=3, timeout_ns=50.0, noise_prob=0.2)
WORLDS = {
    "gbn_loss": dict(transport="gbn", drop_prob=1e-2, retx_timeout_ns=5e4),
    "gbn_crash": dict(transport="gbn", faults=[
        {"kind": "switch_crash", "target": 5, "at_ns": 2000.0,
         "heal_ns": 12000.0}]),
    "dcqcn": dict(transport="dcqcn"),
}


def _record(canary, trace, world):
    cfg = canary.scaled_config(4, trace=True, **BASE, **WORLDS[world])
    jobs = [canary.AllreduceJob(app=0, participants=list(range(P)),
                                data_bytes=MSG)]
    sim = canary.Simulator(cfg, jobs, algo=canary.Algo.CANARY,
                           noise_hosts=list(range(P, HOSTS)))
    res = sim.run()
    return res, trace.compile_app(sim.trace, 0)


@pytest.fixture(scope="module")
def recorded():
    return {w: dict(ref=_record(ref_canary, ref_trace, w),
                    port=_record(port_canary, port_trace, w))
            for w in WORLDS}


@pytest.fixture(scope="module")
def inputs():
    return (np.random.default_rng(18).normal(size=(P, MSG // BLOCK, D))
            * 3.0).astype(np.float32)


@pytest.fixture(scope="module")
def port_replays(recorded, inputs):
    return {w: port_trace.fixed_point_replay(r["port"][1], inputs, bits=BITS,
                                             device="cpu")
            for w, r in recorded.items()}


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_recorded_schedules_match_reference(world, recorded):
    (ref_res, ref_s), (port_res, port_s) = recorded[world]["ref"], \
        recorded[world]["port"]
    assert ref_res.correct and port_res.correct
    assert dataclasses.asdict(port_res) == dataclasses.asdict(ref_res)
    assert len(port_s) == len(ref_s) == MSG // BLOCK
    for p, r in zip(port_s, ref_s):
        assert dataclasses.asdict(p) == dataclasses.asdict(r)
    assert port_trace.schedule_report(port_s, BLOCK) == \
        ref_trace.schedule_report(ref_s, BLOCK)
    # the world did what it is named for
    if world == "gbn_loss":
        assert ref_res.drop_causes["wire"] > 0
        assert max(s.gen for s in ref_s) >= 1
    elif world == "gbn_crash":
        assert [e["phase"] for e in ref_res.fault_events] == ["fault", "heal"]
        assert ref_res.drop_causes["switch_fail"] > 0
        assert max(s.gen for s in ref_s) >= 1
    else:
        assert ref_res.transport_stats is not None


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_fixed_point_replay_matches_jax(world, recorded, inputs,
                                        port_replays, monkeypatch):
    monkeypatch.setattr(jexec, "packet_accumulate",
                        lambda ids, pay, n, interpret=True:
                        jax_accumulate_ref(ids, pay, n))
    want_out, want_q = jexec.fixed_point_replay(recorded[world]["ref"][1],
                                                jnp.asarray(inputs),
                                                bits=BITS)
    got_out, got_q = port_replays[world]
    assert got_q.dtype == torch.int32 and tuple(got_q.shape) == inputs.shape
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_out.numpy(), np.asarray(want_out))


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_fixed_point_replay_is_the_exact_sum(world, inputs, port_replays):
    x = torch.from_numpy(inputs)
    scale = fixed_point_scale(x.abs().max(), bits=BITS, world=P)
    exact = quantize_ref(x, scale).to(torch.int64).sum(dim=0)
    out, q = port_replays[world]
    assert torch.equal(q, q[:1].expand_as(q))
    assert torch.equal(q[0].to(torch.int64), exact)
    err = float((out[0].double() - x.double().sum(dim=0)).abs().max())
    assert err <= (P + 1) * 0.5 / float(scale)


def test_int32_sum_identical_across_failure_worlds(recorded, port_replays):
    shapes = {w: tuple((s.depth, s.gen) for s in r["port"][1])
              for w, r in recorded.items()}
    assert len(set(shapes.values())) >= 2, "the worlds' trees were to differ"
    qs = [q for _, q in port_replays.values()]
    for q in qs[1:]:
        assert torch.equal(q, qs[0])
