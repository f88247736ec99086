"""The port's trace executor (``repro_torch.core.trace.executor``) against
the JAX package's, on the schedules of ``tests/trace/test_replay.py``.

Both executors replay the identical recorded trees: the reference
simulator records them once, and ``repro_torch.convert`` carries the
schedules across. Float replay must agree within the reference test's own
tolerance (``rtol=1e-5, atol=1e-4``: the tree decides the association
order); int32 and fixed-point replay must be bit-equal, to JAX and across
tree shapes. The fixed-point replay runs JAX's Pallas kernels in interpret
mode; the float and int32 replays route the JAX executor's segment-sum
through its plain ``jnp`` reference, which ``tests/kernels/test_kernels.py``
holds equal to the kernel, to keep the file fast.
"""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.canary import Algo, AllreduceJob, Simulator, scaled_config
from repro.core.trace import compile_app
from repro.core.trace import executor as jexec
from repro.kernels.ops import fixed_point_scale as jax_fixed_point_scale
from repro.kernels.ref import packet_accumulate_ref as jax_accumulate_ref

from repro_torch.convert import schedules_from_reference
from repro_torch.core.trace import (fixed_point_replay, reference_allreduce,
                                    replay_app, replay_block)
from repro_torch.kernels import fixed_point_scale

P = 10
N_BLOCKS = 4
D = 32
VARIANTS = [
    dict(seed=3, timeout_ns=50.0, noise_prob=0.2),
    dict(seed=11, timeout_ns=1e6, retx_timeout_ns=2e5),
    dict(seed=29, timeout_ns=500.0, noise_prob=0.05),
]
CPU = dict(device="cpu")


@pytest.fixture(scope="module")
def jax_schedules():
    out = []
    for kw in VARIANTS:
        cfg = scaled_config(4, trace=True, **dict(dict(seed=3, timeout_ns=200.0),
                                                  **kw))
        jobs = [AllreduceJob(app=0, participants=list(range(P)),
                             data_bytes=N_BLOCKS * 1024)]
        sim = Simulator(cfg, jobs, algo=Algo.CANARY,
                        noise_hosts=list(range(P, 16)))
        assert sim.run().correct
        out.append(compile_app(sim.trace, 0))
    return out


@pytest.fixture(scope="module")
def port_schedules(jax_schedules):
    return [schedules_from_reference(s) for s in jax_schedules]


@pytest.fixture(scope="module")
def inputs():
    return (np.random.default_rng(0).normal(size=(P, N_BLOCKS, D)) * 3.0
            ).astype(np.float32)


@pytest.fixture
def jax_plain(monkeypatch):
    """The JAX executor with its segment-sum kernel routed through the
    kernel's plain reference."""
    monkeypatch.setattr(jexec, "packet_accumulate",
                        lambda ids, pay, n, interpret=True:
                        jax_accumulate_ref(ids, pay, n))
    return jexec


@pytest.mark.parametrize("variant", range(len(VARIANTS)))
def test_float_replay_matches_jax(variant, jax_plain, jax_schedules,
                                  port_schedules, inputs):
    want = np.asarray(jax_plain.replay_app(jax_schedules[variant],
                                       jnp.asarray(inputs)))
    got = replay_app(port_schedules[variant], inputs, **CPU)
    assert got.dtype == torch.float32 and tuple(got.shape) == inputs.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    ref = reference_allreduce(inputs, **CPU)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("variant", range(len(VARIANTS)))
def test_int32_replay_bit_equal(variant, jax_plain, jax_schedules,
                                port_schedules):
    q = np.random.default_rng(7).integers(
        -1_000_000, 1_000_000, (P, N_BLOCKS, D)).astype(np.int32)
    want = np.asarray(jax_plain.replay_app(jax_schedules[variant],
                                       jnp.asarray(q)))
    got = replay_app(port_schedules[variant], q, **CPU)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), np.broadcast_to(q.sum(axis=0, dtype=np.int32), q.shape))


@pytest.fixture(scope="module")
def port_fixed_point(port_schedules, inputs):
    return [fixed_point_replay(s, inputs, bits=20, **CPU)
            for s in port_schedules]


@pytest.mark.parametrize("variant", range(len(VARIANTS)))
def test_fixed_point_replay_matches_jax(variant, jax_schedules,
                                        port_fixed_point, inputs):
    gmax = np.abs(inputs).max()
    want_scale = np.asarray(jax_fixed_point_scale(jnp.asarray(gmax), bits=20,
                                                  world=P))
    got_scale = fixed_point_scale(torch.tensor(gmax), bits=20, world=P)
    assert got_scale.numpy().view(np.int32) == want_scale.view(np.int32)

    want_out, want_q = jexec.fixed_point_replay(jax_schedules[variant],
                                                jnp.asarray(inputs), bits=20)
    got_out, got_q = port_fixed_point[variant]
    assert got_q.dtype == torch.int32 and got_out.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out),
                               rtol=0, atol=0)
    # each of P quantized summands carries <= 0.5/scale rounding error
    ref = inputs.astype(np.float64).sum(axis=0)
    err = np.abs(got_out.numpy() - ref).max()
    assert err <= (P + 1) * 0.5 / float(got_scale)


def test_fixed_point_q_identical_across_tree_shapes(port_schedules,
                                                    port_fixed_point):
    sigs = {tuple(s.depth for s in sch) for sch in port_schedules}
    assert len(sigs) >= 2, "the variants were supposed to differ in shape"
    q0 = port_fixed_point[0][1]
    for _, q in port_fixed_point[1:]:
        assert torch.equal(q, q0)


def test_replay_block_matches_jax(jax_plain, jax_schedules, port_schedules,
                                  inputs):
    want = np.asarray(jax_plain.replay_block(jax_schedules[0][0],
                                         jnp.asarray(inputs[:, 0])))
    got = replay_block(port_schedules[0][0], inputs[:, 0], **CPU)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


def test_replay_rejects_wrong_shapes(port_schedules, inputs):
    with pytest.raises(ValueError):
        replay_block(port_schedules[0][0], inputs[:P - 1, 0], **CPU)
    with pytest.raises(ValueError):
        replay_block(port_schedules[0][0], inputs[:, 0, 0], **CPU)
    with pytest.raises(ValueError):
        replay_app(port_schedules[0][:2], inputs, **CPU)


def test_entry_points_need_cuda_by_default(port_schedules, inputs,
                                           monkeypatch):
    """``device=None`` means CUDA; without a card that raises instead of
    falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        fixed_point_replay(port_schedules[0], inputs)
    with pytest.raises(RuntimeError, match="CUDA"):
        replay_app(port_schedules[0], inputs)


def test_port_imports_neither_jax_nor_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or\n"
        "             m.startswith(('jax.', 'jaxlib')) or m == 'repro' or\n"
        "             m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "for m in ('repro_torch.kernels.flash_attention',\n"
        "          'repro_torch.models.transformer',\n"
        "          'repro_torch.serving.engine', 'repro_torch.launch.serve'):\n"
        "    assert m in sys.modules, m\n"
        "print(len([m for m in sys.modules if m.startswith('repro_torch')]))\n")
    src = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")
    env = dict(os.environ, PYTHONPATH=src)
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout) >= 43      # every module of the package imported


def test_chip_smoke_imports_neither_jax_nor_reference():
    import ast
    root = os.path.dirname(os.path.dirname(__file__))
    with open(os.path.join(root, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module]
    assert "repro_torch.models" in names
    assert not [m for m in names if m.split(".")[0] in ("jax", "jaxlib",
                                                        "repro")]
