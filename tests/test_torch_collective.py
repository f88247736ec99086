"""The port's device collective (``repro_torch.core.collective``) against the
JAX package's, on 8 ranks.

The reference runs its collectives inside ``shard_map`` on 8 host devices,
in a subprocess with ``--xla_force_host_platform_device_count=8`` (as
``tests/collective/test_trees.py`` does); the port runs 8 gloo ranks, one
process each, started by one ``torch.multiprocessing.spawn`` with a
``file://`` rendezvous (no port to collide under xdist). Both read the same
seeded numpy inputs and run the same cases at the same time; each case's
per-rank results are stacked as ``shard_map`` stacks them.

Tolerances: float results within ``rtol = atol = 1e-5`` of JAX's (the
reference test's); bfloat16 ones within one bf16 rounding; fixed-point
results (the int32 sums and their dequantized values) bit for bit.

The exchange staged through host buffers (``trees._shift`` with
``host``: the path of gloo ranks whose tensors are on a card) is reached on
CPU tensors through ``trees._multi_root(..., staged=True)``, at n = 8 and
n = 3, and held to JAX's results and to the direct exchange bit for bit.

``test_one_rank_nccl_canary_fp_on_cuda`` runs the fixed-point sync in a
one-rank NCCL group on the card, ``test_two_gloo_ranks_canary_fp_on_cuda``
on two gloo ranks sharing it (staged); both skip where there is none.
"""
import datetime
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.core.collective import (CongestionOracle,
                                         canary_allreduce_tree,
                                         hierarchical_allreduce,
                                         multi_root_tree_allreduce,
                                         ring_allreduce, tree_link_load,
                                         tree_reduce_broadcast)
from repro_torch.core.collective import trees
from repro_torch.core.collective.api import fixed_point_scales
from repro_torch.kernels import (dequantize, fixed_point_scale, launch_counts,
                                 quantize, reset_launch_counts)
from repro_torch.kernels.ref import dequantize_ref, quantize_ref

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 8
MODES = ["canary", "ring", "hierarchical", "psum"]
MULTI_ROOTS = {"same": [0] * 4, "range": list(range(4)),
               "mixed": [3, 1, 4, 1, 5, 0, 2, 6]}
FP_ROOTS = {"fwd": list(range(N)), "rev": list(range(N))[::-1]}
N6_ROOTS = [3, 1, 4, 1, 5, 0, 2]
PAD_ROOTS = [0, 3, 5]
# (axis_size, num_blocks, links 0-1 loaded by another tenant)
ORACLE_CASES = [(8, 32, True), (4, 10, False), (6, 16, False), (16, 24, True)]
STEP_TIMES = [0.1, 0.1, 0.1, 0.5, 0.2, 0.05, 0.3]
CONSTANTS = dict(N=N, MODES=MODES, MULTI_ROOTS=MULTI_ROOTS, FP_ROOTS=FP_ROOTS,
                 N6_ROOTS=N6_ROOTS, PAD_ROOTS=PAD_ROOTS,
                 ORACLE_CASES=ORACLE_CASES, STEP_TIMES=STEP_TIMES)

JAX_SCRIPT = r"""
import json, sys
import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from repro.core.collective import (CongestionOracle, canary_allreduce_tree,
                                   hierarchical_allreduce,
                                   multi_root_tree_allreduce, ring_allreduce,
                                   tree_link_load, tree_reduce_broadcast)
from repro.kernels.fixedpoint import quantize
from repro.kernels.ops import fixed_point_scale

d, C = sys.argv[1], json.loads(sys.argv[2])
N = C["N"]
inp = dict(np.load(d + "/inputs.npz"))
devs = np.array(jax.devices()[:N])
m8, m6 = Mesh(devs, ("data",)), Mesh(devs[:6], ("data",))
m24 = Mesh(devs.reshape(2, 4), ("pod", "data"))
D1, D2 = P("data"), P(("pod", "data"))
bf16, f32 = jnp.bfloat16, jnp.float32
out = {}

def run(mesh, spec, fn, *args):
    f = jax.shard_map(fn, mesh=mesh, in_specs=(spec,) * len(args),
                      out_specs=spec, check_vma=False)
    return jax.tree.map(lambda a: np.asarray(a.astype(f32)
                                             if a.dtype == bf16 else a),
                        jax.jit(f)(*args))

def fp_int(v, n, roots):
    gmax = lax.pmax(jnp.max(jnp.abs(v.astype(f32))), "data")
    scale = fixed_point_scale(gmax, bits=24, world=n)
    return multi_root_tree_allreduce(quantize(v, scale), "data", n, roots)

x, x37, xx, x6, x6_37 = (inp[k] for k in ("x", "x37", "xx", "x6", "x6_37"))
for r in range(N):
    out[f"tree_root{r}"] = run(m8, D1, lambda v, r=r: tree_reduce_broadcast(
        v, "data", N, r), x)
for name, roots in C["MULTI_ROOTS"].items():
    out[f"multi_{name}"] = run(m8, D1, lambda v, rr=tuple(roots):
                               multi_root_tree_allreduce(v, "data", N, rr), x)
out["multi_pad"] = run(m8, D1, lambda v: multi_root_tree_allreduce(
    v, "data", N, tuple(C["PAD_ROOTS"])), x37)
out["ring"] = run(m8, D1, lambda v: ring_allreduce(v, "data"), x)
out["ring_pad"] = run(m8, D1, lambda v: ring_allreduce(v, "data"), x37)
out["ring_bf16"] = run(m8, D1, lambda v: ring_allreduce(v.astype(bf16),
                                                        "data"), x)
for mode in C["MODES"]:
    res = run(m8, D1, lambda a, b, mode=mode: canary_allreduce_tree(
        {"a": a, "b": b}, axis_name="data", axis_size=N, num_blocks=4,
        mode=mode), x, x37)
    out[f"api_{mode}_a"], out[f"api_{mode}_b"] = res["a"], res["b"]
for tag, roots in C["FP_ROOTS"].items():
    rr = tuple(roots)
    out[f"fp_{tag}"] = run(m8, D1, lambda v, rr=rr: canary_allreduce_tree(
        v, axis_name="data", axis_size=N, roots=rr, fixed_point=True), x)
    out[f"fp_int_{tag}"] = run(m8, D1, lambda v, rr=rr: fp_int(v, N, rr), x)
out["fp_bf16"] = run(m8, D1, lambda v: canary_allreduce_tree(
    v.astype(bf16), axis_name="data", axis_size=N, fixed_point=True), x)
out["fp_int_bf16"] = run(m8, D1, lambda v: fp_int(
    v.astype(bf16), N, tuple(range(N))), x)
out["hier"] = run(m24, D2, lambda v: hierarchical_allreduce(v, "data", "pod"),
                  xx)
for mode in C["MODES"]:
    res = run(m24, D2, lambda a, b, mode=mode: canary_allreduce_tree(
        {"a": a, "b": b}, axis_name="data", axis_size=4, num_blocks=4,
        mode=mode, outer_axis="pod"), xx, x37)
    out[f"mesh_{mode}_a"], out[f"mesh_{mode}_b"] = res["a"], res["b"]
out["mesh_fp"] = run(m24, D2, lambda v: canary_allreduce_tree(
    v, axis_name="data", axis_size=4, outer_axis="pod", fixed_point=True), xx)
for r in range(6):
    out[f"n6_tree_root{r}"] = run(m6, D1, lambda v, r=r:
                                  tree_reduce_broadcast(v, "data", 6, r), x6)
out["n6_multi"] = run(m6, D1, lambda v: multi_root_tree_allreduce(
    v, "data", 6, tuple(C["N6_ROOTS"])), x6)
out["n6_multi_pad"] = run(m6, D1, lambda v: multi_root_tree_allreduce(
    v, "data", 6, tuple(C["PAD_ROOTS"])), x6_37)
out["n6_ring"] = run(m6, D1, lambda v: ring_allreduce(v, "data"), x6_37)
out["n6_fp"] = run(m6, D1, lambda v: canary_allreduce_tree(
    v, axis_name="data", axis_size=6, fixed_point=True), x6)
out["n6_fp_int"] = run(m6, D1, lambda v: fp_int(v, 6, tuple(
    k % 6 for k in range(16))), x6)
m4 = Mesh(devs[:4], ("data",))
x4, x4_37 = inp["x4"], inp["x4_37"]
out["n4_multi_pad"] = run(m4, D1, lambda v: multi_root_tree_allreduce(
    v, "data", 4, tuple(C["PAD_ROOTS"])), x4_37)
out["n4_fp_int_pad"] = run(m4, D1, lambda v: fp_int(v, 4, tuple(
    k % 4 for k in range(16))), x4_37)
res = run(m4, D1, lambda a, b: canary_allreduce_tree(
    {"a": a, "b": b.astype(bf16)}, axis_name="data", axis_size=4,
    fixed_point=True), x4, x4_37)
out["n4_fp_a"], out["n4_fp_b"] = res["a"], res["b"]
m3 = Mesh(devs[:3], ("data",))
out["n3_fp"] = run(m3, D1, lambda v: canary_allreduce_tree(
    v, axis_name="data", axis_size=3, fixed_point=True), inp["x3"])
out["n3_fp_int"] = run(m3, D1, lambda v: fp_int(v, 3, tuple(
    k % 3 for k in range(16))), inp["x3"])
for i, (n, k, hot) in enumerate(C["ORACLE_CASES"]):
    for policy in ("round_robin", "balanced"):
        ext = np.where(np.arange(n) < 2, 1000.0, 0.0) if hot else None
        o = CongestionOracle(axis_size=n, num_blocks=k, policy=policy,
                             external_load=ext)
        plans = [o.plan()]
        for t in C["STEP_TIMES"]:
            o.feedback(t)
            plans.append(o.plan())
        out[f"oracle_{i}_{policy}"] = np.array(plans)
for n in (4, 6, 8, 16):
    out[f"link_load_{n}"] = np.stack([tree_link_load(r, n) for r in range(n)])
np.savez(d + "/jax.npz", **out)
print("JAX_OK")
"""

# case -> (ranks, comparison): "float" within 1e-5, "bf16" within one bf16
# rounding, "exact" bit for bit
CASES = {
    **{f"tree_root{r}": (N, "float") for r in range(N)},
    **{f"multi_{k}": (N, "float") for k in MULTI_ROOTS},
    "multi_pad": (N, "float"), "ring": (N, "float"),
    "ring_pad": (N, "float"), "ring_bf16": (N, "bf16"),
    **{f"api_{m}_{t}": (N, "float") for m in MODES for t in "ab"},
    **{f"fp_{t}": (N, "exact") for t in FP_ROOTS},
    **{f"fp_int_{t}": (N, "exact") for t in FP_ROOTS},
    "fp_bf16": (N, "exact"), "fp_int_bf16": (N, "exact"),
    "hier": (N, "float"),
    **{f"mesh_{m}_{t}": (N, "float") for m in MODES for t in "ab"},
    "mesh_fp": (N, "exact"),
    **{f"n6_tree_root{r}": (6, "float") for r in range(6)},
    "n6_multi": (6, "float"), "n6_multi_pad": (6, "float"),
    "n6_ring": (6, "float"), "n6_fp": (6, "exact"), "n6_fp_int": (6, "exact"),
    # 4 ranks, 37 values a rank (16 blocks of 3, padded): the trees'
    # in-place rounds, and canary_fp taking its gradients out of a dict
    "n4_multi_pad": (4, "float"), "n4_fp_int_pad": (4, "exact"),
    "n4_fp_a": (4, "exact"), "n4_fp_b": (4, "exact"),
    # the exchange staged through host buffers (the path of gloo ranks
    # sharing a card), reached on CPU tensors through trees._multi_root:
    # the direct exchange's bits, at n = 8 and 3 (not a power of two)
    "staged_fp_int_fwd": (N, "exact"), "staged_fp_fwd": (N, "exact"),
    "n3_fp": (3, "exact"), "n3_fp_int": (3, "exact"),
    "n3_staged_fp": (3, "exact"), "n3_staged_fp_int": (3, "exact"),
}
# each staged case and the JAX case it is held to, as its direct twin is
STAGED = {"staged_fp_int_fwd": "fp_int_fwd", "staged_fp_fwd": "fp_fwd",
          "n3_staged_fp_int": "n3_fp_int", "n3_staged_fp": "n3_fp"}


def _inputs() -> dict:
    rng = np.random.default_rng(0)
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in (("x", (N, 64)), ("x37", (N, 37)), ("xx", (N, 32)),
                         ("x6", (6, 64)), ("x6_37", (6, 37)),
                         ("x4", (4, 64)), ("x4_37", (4, 37)),
                         ("x3", (3, 64)))}


def _fp_int(v, group, n, roots, staged=False):
    """The int32 sum of ``v``'s fixed-point blocks over ``group``, each
    exchange through host buffers when ``staged``; and the scale."""
    scale, = fixed_point_scales(v, [group], bits=24, world=n)
    q = trees._multi_root(quantize(v, scale), group, n, roots,
                          staged=staged)
    return q, scale


def _port_rank(rank: int, init_file: str, in_path: str, out_dir: str):
    """One gloo rank of the port: every case, its results to an npz."""
    from repro_torch.train import make_mesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=N, rank=rank,
                            timeout=datetime.timedelta(seconds=120))
    try:
        mesh24 = make_mesh(outer_size=2)           # every rank, same order
        g6 = dist.new_group(list(range(6)))
        g4 = dist.new_group(list(range(4)))
        g3 = dist.new_group(list(range(3)))
        W = dist.group.WORLD
        inp = np.load(in_path)

        def row(k):
            return torch.from_numpy(inp[k][rank:rank + 1].copy())

        x, x37, xx = row("x"), row("x37"), row("xx")
        bf = x.to(torch.bfloat16)
        out = {}
        for r in range(N):
            out[f"tree_root{r}"] = tree_reduce_broadcast(x, W, N, r)
        for name, roots in MULTI_ROOTS.items():
            out[f"multi_{name}"] = multi_root_tree_allreduce(x, W, N, roots)
        out["multi_pad"] = multi_root_tree_allreduce(x37, W, N, PAD_ROOTS)
        out["ring"] = ring_allreduce(x, W)
        out["ring_pad"] = ring_allreduce(x37, W)
        out["ring_bf16"] = ring_allreduce(bf, W)
        for mode in MODES:
            res = canary_allreduce_tree({"a": x, "b": x37}, group=W,
                                        axis_size=N, num_blocks=4, mode=mode)
            out[f"api_{mode}_a"], out[f"api_{mode}_b"] = res["a"], res["b"]
        for tag, roots in FP_ROOTS.items():
            out[f"fp_{tag}"] = canary_allreduce_tree(
                x, group=W, axis_size=N, roots=roots, fixed_point=True)
            out[f"fp_int_{tag}"] = _fp_int(x, W, N, roots)[0]
        q, scale = _fp_int(x, W, N, FP_ROOTS["fwd"], staged=True)
        out["staged_fp_int_fwd"] = q
        out["staged_fp_fwd"] = dequantize(q, scale)
        out["fp_bf16"] = canary_allreduce_tree(bf, group=W, axis_size=N,
                                               fixed_point=True)
        out["fp_int_bf16"] = _fp_int(bf, W, N, list(range(N)))[0]
        out["hier"] = hierarchical_allreduce(xx, mesh24.inner, mesh24.outer)
        for mode in MODES:
            res = canary_allreduce_tree(
                {"a": xx, "b": x37}, group=mesh24.inner, axis_size=4,
                num_blocks=4, mode=mode, outer_group=mesh24.outer)
            out[f"mesh_{mode}_a"], out[f"mesh_{mode}_b"] = res["a"], res["b"]
        out["mesh_fp"] = canary_allreduce_tree(
            xx, group=mesh24.inner, axis_size=4, outer_group=mesh24.outer,
            fixed_point=True)
        if rank < 6:
            x6, x6_37 = row("x6"), row("x6_37")
            for r in range(6):
                out[f"n6_tree_root{r}"] = tree_reduce_broadcast(x6, g6, 6, r)
            out["n6_multi"] = multi_root_tree_allreduce(x6, g6, 6, N6_ROOTS)
            out["n6_multi_pad"] = multi_root_tree_allreduce(x6_37, g6, 6,
                                                            PAD_ROOTS)
            out["n6_ring"] = ring_allreduce(x6_37, g6)
            out["n6_fp"] = canary_allreduce_tree(x6, group=g6, axis_size=6,
                                                 fixed_point=True)
            out["n6_fp_int"] = _fp_int(x6, g6, 6,
                                       [k % 6 for k in range(16)])[0]
        if rank < 4:
            x4, x4_37 = row("x4"), row("x4_37")
            out["n4_multi_pad"] = multi_root_tree_allreduce(x4_37, g4, 4,
                                                            PAD_ROOTS)
            out["n4_fp_int_pad"] = _fp_int(x4_37, g4, 4,
                                           [k % 4 for k in range(16)])[0]
            given = {"a": x4.clone(), "b": x4_37.to(torch.bfloat16)}
            res = canary_allreduce_tree(given, group=g4, axis_size=4,
                                        fixed_point=True)
            assert not given and x4_37.equal(row("x4_37"))
            out["n4_fp_a"], out["n4_fp_b"] = res["a"], res["b"]
        if rank < 3:
            x3, roots3 = row("x3"), [k % 3 for k in range(16)]
            out["n3_fp"] = canary_allreduce_tree(x3, group=g3, axis_size=3,
                                                 fixed_point=True)
            out["n3_fp_int"] = _fp_int(x3, g3, 3, roots3)[0]
            q, scale = _fp_int(x3, g3, 3, roots3, staged=True)
            out["n3_staged_fp_int"] = q
            out["n3_staged_fp"] = dequantize(q, scale)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
                 **{k: v.float().numpy() if v.dtype == torch.bfloat16
                    else v.numpy() for k, v in out.items()})
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """``(jax, port)``: ``{case: stacked results}`` of both packages."""
    d = tmp_path_factory.mktemp("collective")
    np.savez(d / "inputs.npz", **_inputs())
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu",
               PYTHONPATH="src" + os.pathsep + os.environ.get("PYTHONPATH",
                                                              ""))
    proc = subprocess.Popen([sys.executable, "-c", JAX_SCRIPT, str(d),
                             json.dumps(CONSTANTS)], env=env, cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:              # the port's 8 ranks run while JAX compiles
        mp.spawn(_port_rank, args=(str(d / "rendezvous"),
                                   str(d / "inputs.npz"), str(d)),
                 nprocs=N, join=True)
        out, err = proc.communicate(timeout=600)
    finally:
        proc.kill()
    assert "JAX_OK" in out, out + "\n" + err
    ranks = [dict(np.load(d / f"rank{r}.npz")) for r in range(N)]
    port = {case: np.concatenate([ranks[r][case] for r in range(n)])
            for case, (n, _) in CASES.items()}
    return dict(np.load(d / "jax.npz")), port


@pytest.mark.parametrize("case", sorted(CASES))
def test_collective_matches_jax(results, case):
    jax_out, port = results
    want, got = jax_out[STAGED.get(case, case)], port[case]
    kind = CASES[case][1]
    assert got.shape == want.shape and got.dtype == want.dtype, \
        (got.shape, got.dtype, want.shape, want.dtype)
    if kind == "exact":
        np.testing.assert_array_equal(got, want)
    elif kind == "bf16":
        np.testing.assert_allclose(got, want, rtol=2 ** -8, atol=2 ** -8)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", ["tree_root3", "multi_mixed", "ring_pad",
                                  "api_canary_b", "mesh_hierarchical_a",
                                  "n6_multi_pad", "n6_fp"])
def test_collective_is_the_sum(results, case):
    """Every rank holds the sum over ranks (float64 oracle)."""
    _, port = results
    src = {"ring_pad": "x37", "api_canary_b": "x37", "n6_multi_pad": "x6_37",
           "n6_fp": "x6", "mesh_hierarchical_a": "xx"}.get(case, "x")
    x = _inputs()[src].astype(np.float64)
    tol = 1e-3 if case.endswith("fp") else 1e-5
    want = np.broadcast_to(x.sum(0, keepdims=True), x.shape)
    np.testing.assert_allclose(port[case], want, rtol=tol, atol=tol)


@pytest.mark.parametrize("case", sorted(STAGED))
def test_staged_exchange_is_the_direct_one(results, case):
    """The exchange staged through host buffers gives the direct
    exchange's bits (both also held to JAX above)."""
    _, port = results
    np.testing.assert_array_equal(port[case], port[STAGED[case]])


def test_fixed_point_equal_across_roots(results):
    """Integer sums make the result independent of the tree shapes."""
    _, port = results
    np.testing.assert_array_equal(port["fp_fwd"], port["fp_rev"])
    np.testing.assert_array_equal(port["fp_int_fwd"], port["fp_int_rev"])


@pytest.mark.parametrize("policy", ["round_robin", "balanced"])
@pytest.mark.parametrize("i", range(len(ORACLE_CASES)))
def test_oracle_plans_match_jax(results, i, policy):
    """``plan()`` before and after each of a run of step-time feedbacks."""
    jax_out, _ = results
    n, k, hot = ORACLE_CASES[i]
    ext = np.where(np.arange(n) < 2, 1000.0, 0.0) if hot else None
    o = CongestionOracle(axis_size=n, num_blocks=k, policy=policy,
                         external_load=ext)
    plans = [o.plan()]
    for t in STEP_TIMES:
        o.feedback(t)
        plans.append(o.plan())
    np.testing.assert_array_equal(np.array(plans),
                                  jax_out[f"oracle_{i}_{policy}"])


@pytest.mark.parametrize("n", [4, 6, 8, 16])
def test_tree_link_load_matches_jax(results, n):
    jax_out, _ = results
    np.testing.assert_array_equal(
        np.stack([tree_link_load(r, n) for r in range(n)]),
        jax_out[f"link_load_{n}"])


def test_canary_fp_sync_peak_on_4_ranks():
    """The dry run's count of what one rank holds during ``canary_fp``'s
    sync of one float32 gradient of n values on a (4, 1) fake mesh (a
    fake process group of 4; the trees take 2 rounds each way): at most
    the int32 quantized tensor and one int32 receive buffer, 8 n bytes,
    besides the gradient and a few small tensors (the scale, the
    blocks' masks) at once: the rounds accumulate in place, where each
    round's ``torch.where(mask, acc + shifted, acc)`` held two more."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch import dryrun as D
    n = 1 << 20
    with D.fake_process_group(4):
        # the blocks' masks are small real tensors, as in the dry run
        with FakeTensorMode(allow_non_fake_inputs=True):
            x = torch.empty(n)

        def sync(x):
            return canary_allreduce_tree({"g": x}, group=dist.group.WORLD,
                                         axis_size=4, fixed_point=True)
        got = D.account(sync, (x,))
    assert got["collective_counts"]["collective-permute"] == 4
    assert 8 * n <= got["memory"]["temp_bytes"] <= 8 * n + 4096, got["memory"]


@pytest.mark.cuda
def test_one_rank_nccl_canary_fp_on_cuda(tmp_path):
    """canary_fp in a one-rank NCCL group on a bf16 gradient dict: the
    all-reduce of the max runs, the trees take no rounds, and each tensor is
    quantized and dequantized by the kernels once — equal, bit for bit, to
    the plain versions with the scale recomputed from the tensor."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'rdv'}",
                            world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=120))
    try:
        gen = torch.Generator(device="cuda").manual_seed(0)
        shapes = {"tok": (4096, 2048), "w_down": (8192, 2048),
                  "scale": (2048,), "odd": (3, 5, 7)}
        grads = {k: (torch.randn(s, generator=gen, device="cuda") * 1e-3
                     ).to(torch.bfloat16) for k, s in shapes.items()}
        grads["f32"] = torch.randn((1000,), generator=gen, device="cuda")
        reset_launch_counts()
        synced = canary_allreduce_tree(dict(grads), group=dist.group.WORLD,
                                       axis_size=1, fixed_point=True)
        counts = launch_counts()
        assert counts["quantize"] == counts["dequantize"] == len(grads)
        for k, g in grads.items():
            s = fixed_point_scale(g.abs().max().float(), bits=24, world=1)
            want = dequantize_ref(quantize_ref(g, s), s).to(g.dtype)
            assert synced[k].dtype == g.dtype
            assert torch.equal(synced[k], want), k
    finally:
        dist.destroy_process_group()


CUDA_SHAPES = {"tok": ((4096, 2048), torch.bfloat16),
               "odd": ((3, 5, 7), torch.bfloat16),
               "f32": ((1000,), torch.float32)}


def _cuda_grads(rank):
    """Rank ``rank``'s gradients of :data:`CUDA_SHAPES`, drawn on the CPU."""
    gen = torch.Generator().manual_seed(rank)
    return {k: (torch.randn(s, generator=gen) * 1e-3).to(dtype)
            for k, (s, dtype) in CUDA_SHAPES.items()}


def _cuda_gloo_rank(rank, init_file, out_dir):
    """One of two gloo ranks sharing the card: ``canary_fp`` of its
    gradients on the card, the launches and exchanges counted."""
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=2, rank=rank,
                            timeout=datetime.timedelta(seconds=120))
    try:
        real, calls = dist.batch_isend_irecv, []

        def counting(ops):
            calls.append(len(ops))
            return real(ops)
        dist.batch_isend_irecv = counting
        grads = {k: v.cuda() for k, v in _cuda_grads(rank).items()}
        reset_launch_counts()
        synced = canary_allreduce_tree(grads, group=dist.group.WORLD,
                                       axis_size=2, fixed_point=True)
        torch.save(dict(synced={k: v.cpu() for k, v in synced.items()},
                        counts=launch_counts(), exchanges=len(calls)),
                   os.path.join(out_dir, f"cuda{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_two_gloo_ranks_canary_fp_on_cuda(tmp_path):
    """canary_fp over two gloo ranks that share the card (each exchange
    staged through host buffers): both ranks hold, bit for bit, the plain
    versions' fixed-point sum of the two ranks' gradients, with each
    tensor's scale from the max over both; quantize and dequantize once a
    tensor a rank, two exchanges a tensor."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    mp.spawn(_cuda_gloo_rank, args=(str(tmp_path / "rdv"), str(tmp_path)),
             nprocs=2, join=True)
    inputs = [_cuda_grads(r) for r in range(2)]
    for r in range(2):
        got = torch.load(tmp_path / f"cuda{r}.pt")
        assert got["counts"]["quantize"] == got["counts"]["dequantize"] \
            == len(CUDA_SHAPES)
        assert got["exchanges"] == 2 * len(CUDA_SHAPES)
        for k in CUDA_SHAPES:
            xs = [x[k] for x in inputs]
            s = fixed_point_scale(torch.stack([x.abs().max().float()
                                               for x in xs]).max(),
                                  bits=24, world=2)
            q = (quantize_ref(xs[0], s) + quantize_ref(xs[1], s))
            want = dequantize_ref(q, s).to(xs[0].dtype)
            assert torch.equal(got["synced"][k], want), (r, k)
