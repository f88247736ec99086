"""The replay plan (``repro_torch.core.trace.plan``) and its gathered walk.

The plan merges the reduce rounds of every block into one segment-sum per
tree level. These tests hold its structure to the schedules it came from
(every leaf read once on its way to the root, rows read only after the
level that writes them, one segment per step that adds, fan-in-1 copies
aliased), and hold the plain gathered
walk to the JAX executor's per-round replay through its plain
``packet_accumulate_ref``: int32 bit for bit, float32 within the tolerance
of ``tests/test_torch_replay.py`` (``rtol=1e-5, atol=1e-4``: the tree
decides the association order). The cases are the three recorded variants
of ``tests/test_torch_replay.py`` and a synthetic app whose fan-in runs
from 1 to 128.
"""
from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.canary import Algo, AllreduceJob, Simulator, scaled_config
from repro.core.trace import compile_app
from repro.core.trace import executor as jexec
from repro.core.trace import schedule as jschedule
from repro.kernels.ref import packet_accumulate_ref as jax_accumulate_ref

from repro_torch.convert import schedules_from_reference
from repro_torch.core.trace import (ReduceStep, ReplayPlan, Schedule,
                                    fixed_point_replay, lower_schedules,
                                    replay_app, replay_block)
from repro_torch.core.trace.synthetic import random_schedules
from repro_torch.kernels import packet_accumulate_gather

P, N_BLOCKS, D = 10, 4, 32
VARIANTS = [
    dict(seed=3, timeout_ns=50.0, noise_prob=0.2),
    dict(seed=11, timeout_ns=1e6, retx_timeout_ns=2e5),
    dict(seed=29, timeout_ns=500.0, noise_prob=0.05),
]
SYNTH_HOSTS, SYNTH_BLOCKS = 128, 6
CASES = ["variant0", "variant1", "variant2", "synthetic"]
CPU = torch.device("cpu")


def _to_reference(sched: Schedule):
    """The reference package's Schedule with the same tree."""
    return jschedule.Schedule(
        app=sched.app, block=sched.block, gen=sched.gen, root=sched.root,
        hosts=list(sched.hosts), leaf_host=dict(sched.leaf_host),
        reduce_rounds=[[jschedule.ReduceStep(dst=s.dst, srcs=s.srcs)
                        for s in rnd] for rnd in sched.reduce_rounds])


@pytest.fixture(scope="module")
def cases():
    """``{case: (reference schedules, port schedules)}``."""
    out = {}
    for i, kw in enumerate(VARIANTS):
        cfg = scaled_config(4, trace=True, **dict(dict(seed=3, timeout_ns=200.0),
                                                  **kw))
        jobs = [AllreduceJob(app=0, participants=list(range(P)),
                             data_bytes=N_BLOCKS * 1024)]
        sim = Simulator(cfg, jobs, algo=Algo.CANARY,
                        noise_hosts=list(range(P, 16)))
        assert sim.run().correct
        ref = compile_app(sim.trace, 0)
        out[f"variant{i}"] = (ref, schedules_from_reference(ref))
    synth = random_schedules(SYNTH_HOSTS, SYNTH_BLOCKS, seed=1)
    out["synthetic"] = ([_to_reference(s) for s in synth], synth)
    return out


@pytest.fixture
def jax_plain(monkeypatch):
    """The JAX executor with its segment-sum routed through the kernel's
    plain reference (one ``packet_accumulate_ref`` per round)."""
    monkeypatch.setattr(jexec, "packet_accumulate",
                        lambda ids, pay, n, interpret=True:
                        jax_accumulate_ref(ids, pay, n))
    return jexec


def _writers(plan: ReplayPlan) -> dict:
    """``{scratch row: (level, segment)}``; each row is written once."""
    out = {}
    for lvl, level in enumerate(plan.levels):
        for s, d in enumerate(level.dst.tolist()):
            if d >= 0:
                assert d not in out, f"scratch row {d} written twice"
                out[d] = (lvl, s)
    assert sorted(out) == list(range(plan.scratch_rows))
    return out


def _segment_srcs(level, s):
    return level.src[level.seg_offsets[s]:level.seg_offsets[s + 1]].tolist()


def test_synthetic_fanin_spans_one_to_all_hosts(cases):
    fanins = {len(st.srcs) for s in cases["synthetic"][1]
              for rnd in s.reduce_rounds for st in rnd}
    assert min(fanins) == 1 and max(fanins) == SYNTH_HOSTS
    assert len(fanins) > 5


@pytest.mark.parametrize("case", CASES)
def test_every_leaf_row_is_read_once_on_its_way_to_the_root(case, cases):
    plan = lower_schedules(cases[case][1])
    writers = _writers(plan)
    roots = {}
    for lvl, level in enumerate(plan.levels):
        for s, d in enumerate(level.dst.tolist()):
            if d < 0:
                assert -1 - d not in roots, f"block {-1 - d} has two roots"
                roots[-1 - d] = (lvl, s)
    assert sorted(roots) == list(range(plan.blocks))
    reads = Counter()
    for b, (lvl, s) in roots.items():
        leaves, todo = [], [(lvl, s)]
        while todo:
            lv, sg = todo.pop()
            for r in _segment_srcs(plan.levels[lv], sg):
                reads[r] += 1
                if r >= 0:
                    leaves.append(r)
                else:
                    todo.append(writers[-1 - r])
        assert sorted(leaves) == [h * plan.blocks + b
                                  for h in range(plan.hosts)], b
    assert all(n == 1 for n in reads.values())
    assert sum(reads.values()) == plan.num_sources


@pytest.mark.parametrize("case", CASES)
def test_rows_are_read_only_at_later_levels(case, cases):
    plan = lower_schedules(cases[case][1])
    writers = _writers(plan)
    for lvl, level in enumerate(plan.levels):
        for r in level.src.tolist():
            assert r < plan.hosts * plan.blocks
            if r < 0:
                assert writers[-1 - r][0] < lvl


def _segment_steps(sched: Schedule, lvl: int):
    """The steps of ``sched``'s round ``lvl`` that get a segment: the root's
    and every step that adds two rows or more."""
    if lvl >= sched.depth:
        return []
    return [st for st in sched.reduce_rounds[lvl]
            if st.dst == sched.root or len(st.srcs) > 1]


@pytest.mark.parametrize("case", CASES)
def test_segments_per_level_equal_steps_per_height(case, cases):
    scheds = cases[case][1]
    plan = lower_schedules(scheds)
    depth = max(s.depth for s in scheds)
    assert len(plan.levels) == depth
    for lvl, level in enumerate(plan.levels):
        steps = [st for s in scheds for st in _segment_steps(s, lvl)]
        assert level.num_segments == len(steps)
        np.testing.assert_array_equal(np.diff(level.seg_offsets),
                                      [len(st.srcs) for st in steps])
    assert plan.num_segments == sum(len(_segment_steps(s, lvl))
                                    for s in scheds for lvl in range(depth))


@pytest.mark.parametrize("case", CASES)
def test_fanin_one_steps_alias_their_child(case, cases):
    """A fan-in-1 step below the root writes no scratch row: the parent
    reads the child's row. Only roots have segments of fan-in 1."""
    scheds = cases[case][1]
    plan = lower_schedules(scheds)
    copies = sum(1 for s in scheds for rnd in s.reduce_rounds for st in rnd
                 if len(st.srcs) == 1 and st.dst != s.root)
    adds = sum(1 for s in scheds for rnd in s.reduce_rounds for st in rnd
               if len(st.srcs) > 1 and st.dst != s.root)
    assert plan.scratch_rows == adds
    if case == "synthetic":
        assert copies > 0        # made with copies to alias
    for level in plan.levels:
        one = np.diff(level.seg_offsets) == 1
        assert (level.dst[one] < 0).all()


@pytest.mark.parametrize("case", CASES)
def test_plain_walk_int32_matches_jax_per_round(case, cases, jax_plain):
    ref, port = cases[case]
    q = np.random.default_rng(7).integers(
        -1_000_000, 1_000_000, (len(port[0].hosts), len(port), D)
    ).astype(np.int32)
    want = np.asarray(jax_plain.replay_app(ref, jnp.asarray(q)))
    got = replay_app(lower_schedules(port), q, device="cpu")
    assert got.dtype == torch.int32 and tuple(got.shape) == q.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("case", CASES)
def test_plain_walk_f32_matches_jax_per_round(case, cases, jax_plain):
    ref, port = cases[case]
    x = (np.random.default_rng(8).normal(size=(len(port[0].hosts), len(port),
                                               D)) * 3.0).astype(np.float32)
    want = np.asarray(jax_plain.replay_app(ref, jnp.asarray(x)))
    got = replay_app(lower_schedules(port), x, device="cpu")
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


def test_plan_is_reused_and_equals_schedules(cases):
    """A plan replays as its schedules do, and copies its index arrays to a
    device once."""
    scheds = cases["variant0"][1]
    plan = lower_schedules(scheds)
    x = (np.random.default_rng(9).normal(size=(P, N_BLOCKS, D))
         ).astype(np.float32)
    out_s, q_s = fixed_point_replay(scheds, x, bits=20, device="cpu")
    out_p, q_p = fixed_point_replay(plan, x, bits=20, device="cpu")
    assert torch.equal(q_s, q_p) and torch.equal(out_s, out_p)
    first = plan.on(CPU)
    replay_app(plan, x, device="cpu")
    assert plan.on(CPU) is first
    assert all(t.dtype == torch.int32 for lv in first for t in lv)


def test_single_leaf_tree_replays_as_the_reference(jax_plain):
    """A block of one participant has no reduce round: the plan gives it a
    fan-in-1 root segment, and the result is the reference's."""
    sched = Schedule(app=0, block=0, gen=0, root=5, hosts=[3],
                     leaf_host={5: 3})
    plan = lower_schedules([sched])
    assert len(plan.levels) == 1 and plan.levels[0].dst.tolist() == [-1]
    x = np.arange(12, dtype=np.int32).reshape(1, 12)
    want = np.asarray(jax_plain.replay_block(_to_reference(sched),
                                             jnp.asarray(x)))
    np.testing.assert_array_equal(replay_block(sched, x, device="cpu").numpy(),
                                  want)


def test_lowering_rejects_bad_schedules():
    good = random_schedules(4, 2, seed=0)
    with pytest.raises(ValueError):
        lower_schedules([])
    with pytest.raises(ValueError, match="participants"):
        lower_schedules(good + random_schedules(5, 1, seed=0))
    orphan = Schedule(app=0, block=0, gen=0, root=9, hosts=[0, 1],
                      leaf_host={0: 0, 1: 1},
                      reduce_rounds=[[ReduceStep(dst=9, srcs=(0, 7))]])
    with pytest.raises(ValueError, match="read before"):
        lower_schedules([orphan])
    stranger = Schedule(app=0, block=0, gen=0, root=9, hosts=[0, 1],
                        leaf_host={0: 0, 1: 4},
                        reduce_rounds=[[ReduceStep(dst=9, srcs=(0, 1))]])
    with pytest.raises(ValueError, match="participant"):
        lower_schedules([stranger])


def test_gather_wrapper_checks_shapes_and_types():
    plan = lower_schedules(random_schedules(4, 2, seed=0))
    level = plan.on(CPU)[0]
    leaf = torch.zeros((8, 16), dtype=torch.int32)
    scratch = torch.zeros((plan.scratch_rows, 16), dtype=torch.int32)
    out = torch.zeros((4, 2, 16), dtype=torch.int32)
    with pytest.raises(ValueError):
        packet_accumulate_gather(leaf[:7], scratch, out, *level)
    with pytest.raises(TypeError):
        packet_accumulate_gather(leaf, scratch.float(), out, *level)
    with pytest.raises(TypeError):
        packet_accumulate_gather(leaf.to(torch.int64), scratch.to(torch.int64),
                                 out.to(torch.int64), *level)
