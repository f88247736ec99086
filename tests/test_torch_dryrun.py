"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX
package's (``repro.launch.dryrun``), and the flash kernels' custom ops.

* Argument bytes: each rank's ``argument_bytes`` (the local storages of the
  parameters, optimizer state, batch and cache) equals the reference's
  ``compiled.memory_analysis().argument_size_in_bytes`` for the same step
  on llama3.2-1b's smoke config at (2, 2) for the three shape kinds and at
  (2, 2, 2) for ``train_4k``. XLA pads nothing on the CPU here: the
  reference's size equals the sum of its arguments' shard bytes, which the
  JAX side checks too. The one difference is the decode cache's position:
  a 0-d int32 in the reference's cache, a host integer in the port's (4
  bytes). JAX runs in a subprocess: ``repro.launch.dryrun`` forces 512 host
  devices at import.
* Costs: one small step (8 sequences of 64 tokens) at (4, 1) (``auto``
  and ``canary_fp``), (2, 2) (train, prefill, decode) and (2, 2, 2) on
  llama smoke, and at (2, 2) on the MoE forms (deepseek-moe's ``ep`` and
  ``ep_a2a``, qwen2-moe's dense route, also at (4, 1)), mamba2 and jamba,
  llama and the dense route under remat, and qwen2-7b with heads the model
  axis does not divide, against the reference's compiled step, counted as
  its cost probes count
  (the layers unrolled, each remaining while body times its trip count):
  FLOPs (the HLO's dots) equal where both run the same products; the
  Canary trees' bytes equal the reference's ppermutes'; the rest
  (DTensor's layouts against GSPMD's, eager lifetimes against XLA's buffer
  assignment, eager unfused bytes against XLA's fused ones) within stated
  bounds. The reference's bytes are ``dryrun_reference.accessed``'s walk
  of the compiled HLO, which with each loop counted once lies within
  0.1 % of ``cost_analysis()["bytes accessed"]``.
* FLOPs: at a one-rank fake mesh the dry run's count equals
  ``FlopCounterMode`` over the real CPU step at the same shape, through
  remat and the flash ops; at (4, 1) rank 0 counts a quarter of world 1's
  at the same global batch.
* The custom ops: the fake's shapes and dtypes equal the real CPU route's
  for CPU and fake CUDA inputs (on CUDA, q's layout); the FLOP formula
  equals ``chip_smoke.flash_work``'s reckoning; the gradient through the
  ops equals the plain forward and backward's bit for bit, under
  ``torch.utils.checkpoint`` too.
* The constraints: ``_activation_constraint`` lays a DTensor out as the
  reference's ``with_sharding_constraint`` does (the compiled output's
  spec), with and without ``sequence_parallel``, and the logits as
  ``make_loss_fn``'s specs; a plain tensor comes back as it was.
* ``canary_fp`` at (4, 1): the point-to-point bytes equal the int32 bytes
  of ``trees.py``'s rounds, and one ``all_reduce(MAX)``.
* A row carries every key ``benchmarks/roofline.py`` reads, and no process
  group is left after ``run_one``, which refuses to run beside one.
* The layouts the dry run gives operations DTensor lays out badly or not
  at all compute those operations: on 4 gloo ranks at (2, 2), real
  tensors, each against the operation on the whole tensors (a matrix's
  gradient in the matrix's layout, the logits' constraint onto a dim the
  model axis does not divide among them); and the MoE forms (through the
  ``shard_map`` boundary; the dense route also with its capacity buffer
  split along d as the experts' weights split it) and the Mamba-2 layer
  by heads (also 3 heads, which split unevenly) on DTensors, forward and
  backward, against the layer on whole tensors.

The HLO parse and the JAX subprocess are ``dryrun_reference``'s, which
``test_torch_dryrun_production.py`` shares (one layer period of each arch
at full width on the production mesh).
"""
import contextlib
import json
import math
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils.checkpoint import checkpoint
from torch.utils.flop_counter import FlopCounterMode

os.environ.setdefault("JAX_PLATFORMS", "cpu")
from dryrun_reference import (cache_kv, held_bytes,  # noqa: E402
                              new_cache_bytes, run_jax)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_bwd_op, flash_attention_fwd_op,
    live_pairs)
from repro_torch.kernels.ref import (flash_attention_bwd_ref,  # noqa: E402
                                     flash_attention_ref)
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch.mesh import mesh_axes  # noqa: E402
from repro_torch.models import Transformer, get_config  # noqa: E402
from repro_torch.models.transformer import \
    _activation_constraint  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.parallel import (P, ParallelContext,  # noqa: E402
                                  param_placements, parallel_context)
from repro_torch.train.train_step import (TrainConfig,  # noqa: E402
                                          init_train_state, make_loss_fn,
                                          make_train_step)

ARCH = "llama3.2-1b"
MOE, DENSE_MOE, MAMBA, HYBRID = ("deepseek-moe-16b", "qwen2-moe-a2.7b",
                                 "mamba2-130m", "jamba-v0.1-52b")
ARG_CASES = [(ARCH, "train_4k", (2, 2)), (ARCH, "prefill_32k", (2, 2)),
             (ARCH, "decode_32k", (2, 2)), (ARCH, "train_4k", (2, 2, 2)),
             (MOE, "train_4k", (2, 2)), (MAMBA, "decode_32k", (2, 2))]
CACHE_POS_BYTES = 4        # the reference cache's 0-d int32 position
# the costs of one small step on both packages: llama3.2-1b's smoke config,
# SMALL_B sequences of SMALL_S tokens; the attention by the plain route on
# both sides (the same program), or by the flash route (the port's flash
# ops against the reference's chunked_attention, which issues every
# block's products where the kernel counts the live pairs). The flash route
# on (2, 2, 2): DTensor's einsum strategy search on a 3-d mesh (torch 2.13)
# takes minutes for the plain route's 5-d products.
SMALL_S, SMALL_B = 64, 8
# each route's changes to the smoke config, on both sides: "remat" the plain
# route under remat, whose recomputed forward runs inside the backward pass;
# "odd-heads" 3 query heads and 1 KV head, which a 2-way model axis does not
# split (as qwen2-7b's 28 and 4 on a 16-way one)
ROUTES = {"plain": {},
          "flash": dict(attn_chunk_threshold=SMALL_S, attn_chunk=SMALL_S),
          "remat": dict(remat=True),
          "odd-heads": dict(num_heads=3, num_kv_heads=1, head_dim=64)}
QWEN = "qwen2-7b"
# Each case (arch, kind, mesh, route, grad sync, moe_impl): the MoE forms at
# (2, 2), where the model axis splits the experts (deepseek-moe's ``ep`` and
# ``ep_a2a``, jamba's ``ep`` beside its Mamba-2 and attention layers), and
# the dense route (qwen2-moe with ``moe_impl="dense"``: the capacity buffer
# under the reference's ``_constrain``) at (4, 1) and (2, 2), also under
# remat (every full config trains under remat).
COST_CASES = [(ARCH, "train", (4, 1), "plain", "auto", ""),
              (ARCH, "train", (4, 1), "plain", "canary_fp", ""),
              (ARCH, "train", (2, 2), "plain", "auto", ""),
              (ARCH, "prefill", (2, 2), "plain", "auto", ""),
              (ARCH, "decode", (2, 2), "plain", "auto", ""),
              (ARCH, "train", (2, 2, 2), "flash", "auto", ""),
              (DENSE_MOE, "train", (4, 1), "plain", "auto", "dense"),
              (DENSE_MOE, "train", (2, 2), "plain", "auto", "dense"),
              (MOE, "train", (2, 2), "plain", "auto", ""),
              (MOE, "decode", (2, 2), "plain", "auto", ""),
              (MOE, "train", (2, 2), "plain", "auto", "ep_a2a"),
              (MAMBA, "train", (2, 2), "plain", "auto", ""),
              (MAMBA, "prefill", (2, 2), "plain", "auto", ""),
              (HYBRID, "train", (2, 2), "plain", "auto", ""),
              (ARCH, "train", (2, 2), "remat", "auto", ""),
              (DENSE_MOE, "train", (2, 2), "remat", "auto", "dense"),
              (QWEN, "train", (2, 2), "odd-heads", "auto", "")]

JAX_SCRIPT = r"""
import json, sys
import numpy as np
import repro.launch.dryrun as R
import jax
SMALL_S, SMALL_B = json.loads(sys.argv[3])
from jax.sharding import Mesh
from dryrun_reference import (accessed, bf16_dots, costs, link_bytes,
                              new_caches)
from repro.launch.mesh import mesh_axes
from repro.models import get_config
from repro.models.transformer import _activation_constraint
from repro.parallel.context import ParallelContext, parallel_context

def mesh_of(shape):
    names = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices()[:n]).reshape(shape), names)

out = {"args": {}, "constraint": {}, "costs": {}}
for arch, shape_name, mshape in json.loads(sys.argv[1]):
    mesh = mesh_of(mshape)
    dp, ma = mesh_axes(mesh)
    with parallel_context(ParallelContext(mesh=mesh, data_axes=dp,
                                          model_axis=ma)):
        fn, args, cfg = R.build_dryrun(arch, shape_name, mesh,
                                       cfg_override=get_config(arch, "smoke"))
        size = jax.jit(fn).lower(*args).compile().memory_analysis() \
            .argument_size_in_bytes
    shards = sum(int(np.prod(a.sharding.shard_shape(a.shape)))
                 * a.dtype.itemsize for a in jax.tree.leaves(args))
    out["args"][f"{arch}|{shape_name}|{mshape}"] = [size, shards]
mesh = mesh_of([2, 2])
for sp in (False, True):
    for S in (8, 7):
        ctx = ParallelContext(mesh=mesh, data_axes=("data",),
                              model_axis="model", sequence_parallel=sp)
        x = jax.ShapeDtypeStruct((4, S, 6), jax.numpy.float32)
        with parallel_context(ctx):   # a new function: no cached trace
            c = jax.jit(lambda t: _activation_constraint(t)).lower(x) \
                .compile()
        out["constraint"][f"{sp}|{S}"] = [
            a if a is None or isinstance(a, str) else list(a)
            for a in c.output_shardings.spec]
for arch, kind, mshape, route, over, sync, impl in json.loads(sys.argv[2]):
    R.INPUT_SHAPES["small"] = dict(kind=kind, seq_len=SMALL_S,
                                   global_batch=SMALL_B)
    # the layers unrolled, as the reference's cost probes lower them
    cfg = get_config(arch, "smoke").with_(scan_layers=False, **over)
    if impl:
        cfg = cfg.with_(moe_impl=impl)
    mesh = mesh_of(mshape)
    dp, ma = mesh_axes(mesh)
    with parallel_context(ParallelContext(mesh=mesh, data_axes=dp,
                                          model_axis=ma)):
        fn, args, _ = R.build_dryrun(arch, "small", mesh, grad_sync=sync,
                                     cfg_override=cfg)
        c = jax.jit(fn).lower(*args).compile()
    hlo, m = c.as_text(), c.memory_analysis()
    flops, moved, acc = costs(hlo)
    row = out["costs"][f"{arch}|{kind}|{mshape}|{route}|{sync}|{impl}"] = \
        dict(flops=flops, moved=moved, temp=m.temp_size_in_bytes,
             link=link_bytes(moved),
             total=m.argument_size_in_bytes + m.output_size_in_bytes
             + m.temp_size_in_bytes - m.alias_size_in_bytes,
             accessed=acc, bf16_dots=bf16_dots(hlo), loops=hlo.count(" while("),
             once=accessed(hlo, once=True)["all"],
             cost_analysis=c.cost_analysis()["bytes accessed"])
    if kind == "decode":
        row["new_caches"] = new_caches(hlo)
print("JAX_OUT " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference():
    cases = [[a, s, list(m)] for a, s, m in ARG_CASES]
    costs = [[a, k, list(m), r, ROUTES[r], g, i]
             for a, k, m, r, g, i in COST_CASES]
    return run_jax(JAX_SCRIPT, cases, costs, [SMALL_S, SMALL_B])


def _names(shape):
    return ("data", "model") if len(shape) == 2 else ("pod", "data", "model")


def _account(shape, spec, cfg, grad_sync="auto", seq_parallel=False,
             arch=ARCH):
    """:func:`D.account` of the step at ``spec`` on a fake CPU mesh."""
    with D.fake_process_group(D._world(shape)):
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=_names(shape))
        dp, model = mesh_axes(mesh)
        ctx = ParallelContext(mesh=mesh, data_axes=dp, model_axis=model,
                              sequence_parallel=seq_parallel)
        with parallel_context(ctx):
            fn, args, _ = D.build_dryrun(arch, spec, mesh, grad_sync=grad_sync,
                                         cfg_override=cfg, device="cpu")
            got = D.account(fn, args)
    if (D.INPUT_SHAPES[spec] if isinstance(spec, str) else spec)["kind"] \
            == "decode":
        got["cache_kv"] = cache_kv(args[1])
    return got


# ------------------------------------------------------------ argument bytes
def _case_id(arch, *rest):
    """``kind-mesh-route-sync``, ``shape-mesh``; led by the arch and ended
    by the MoE form where not llama's."""
    words = ["x".join(map(str, r)) if isinstance(r, tuple) else r
             for r in rest if r]
    return "-".join(words if arch == ARCH else [arch] + words)


@pytest.mark.parametrize("arch,shape_name,mesh", ARG_CASES,
                         ids=[_case_id(*c) for c in ARG_CASES])
def test_argument_bytes_match_reference(reference, arch, shape_name, mesh):
    size, shards = reference["args"][f"{arch}|{shape_name}|{list(mesh)}"]
    assert size == shards           # XLA pads no argument here
    got = _account(mesh, shape_name, get_config(arch, "smoke"), arch=arch)
    pos = CACHE_POS_BYTES if shape_name.startswith("decode") else 0
    assert got["memory"]["argument_bytes"] == size - pos
    assert got["memory"]["total_bytes"] >= got["memory"]["argument_bytes"]


# ------------------------------------------- costs against the reference's
# port / reference where the programs differ: DTensor's layouts against
# GSPMD's (a product's operands and the collectives around it), eager
# storage lifetimes against XLA's buffer assignment, the flash kernel's live
# pairs against chunked_attention's whole blocks, eager unfused bytes
# against XLA's fused ones (outside the attention: the flash calls against
# the scans). The readings (PERF.md §6)
# lie inside these bounds, the nearest a decode's temporaries (0.11, and
# 0.14 with the new_cache finding) and link bytes (0.55) and llama's
# prefill link bytes (0.51); a layout rule
# that stops applying moves a ratio by a multiple, as before the product
# rules (FLOPs 1.4-2.3x) and the Mamba-2 layouts (FLOPs 1.34x); the
# odd-heads case read 0.906 before the weights split with the data axes were
# gathered over the model axis too.
EXACT_FLOPS = {(ARCH, "train", (4, 1), "plain", ""),
               (ARCH, "train", (2, 2), "plain", ""),
               (ARCH, "prefill", (2, 2), "plain", ""),
               (ARCH, "decode", (2, 2), "plain", ""),
               (ARCH, "train", (2, 2), "remat", ""),
               (DENSE_MOE, "train", (4, 1), "plain", "dense"),
               (DENSE_MOE, "train", (2, 2), "plain", "dense"),
               (DENSE_MOE, "train", (2, 2), "remat", "dense"),
               (MOE, "train", (2, 2), "plain", ""),
               (MOE, "decode", (2, 2), "plain", ""),
               (MAMBA, "prefill", (2, 2), "plain", "")}
# the cases held by the new_cache finding on the reference's HLO
# (dryrun_reference.new_cache_bytes, as the production probes' ``hold``):
# its decode writes each layer's K and V anew in float32, inside its scan
# over the layers, where the port writes the step's slot in place; the
# port's local K and V count as temporaries, and as read and written anew
NEW_CACHE = {(ARCH, "decode", (2, 2), "plain", "")}
# the cases whose bytes are held by the float32 finding on the reference's
# HLO (dryrun_reference.held_bytes): its CPU compile runs the bf16 decode
# in float32, converting the layers' weights and caches (62.0 % of llama's
# bytes and 57.4 % of deepseek-moe's are such conversions)
FLOAT32 = {(ARCH, "decode", (2, 2), "plain", ""),
           (MOE, "decode", (2, 2), "plain", "")}
# the Canary trees' int32 sends: the same bytes as the reference's
# ppermutes (XLA sends a stacked leaf where the port sends a tensor, so
# the counts differ)
FLOPS_BOUND = (0.95, 1.05)
TEMP_BOUND = (0.1, 1.25)
LINK_BOUND = (0.5, 2.0)
BYTES_BOUND = (0.5, 2.0)


@pytest.mark.parametrize("arch,kind,mesh,route,sync,impl", COST_CASES,
                         ids=[_case_id(*c) for c in COST_CASES])
def test_costs_against_reference(reference, arch, kind, mesh, route, sync,
                                 impl):
    """Per-device FLOPs (the reference's dots, each while body times its
    trip count), peak bytes, collective link bytes and bytes accessed of
    one small step against the reference's compiled one: FLOPs exact where
    both run the same products (EXACT_FLOPS), the rest within the stated
    bounds (GSPMD runs some products in other layouts: the grouped-query
    and the Mamba-2 SSD's products, ``ep_a2a``'s shared expert; the cases
    of NEW_CACHE and FLOAT32 held by those findings). Bytes: the port's
    less its flash calls' against the reference's less the chunked
    attention's scans (``dryrun_reference.accessed``, each while body
    times its trip count), and the flash calls' at most the scans'. Where
    XLA unrolls a scan of one block (the flash route's 64-token chunk),
    only its instructions whose stack frames name the scan's body are
    counted as the scans': a lower bound of them."""
    want = reference["costs"][
        f"{arch}|{kind}|{list(mesh)}|{route}|{sync}|{impl}"]
    cfg = get_config(arch, "smoke").with_(**ROUTES[route])
    if impl:
        cfg = cfg.with_(moe_impl=impl)
    got = _account(mesh, dict(kind=kind, seq_len=SMALL_S,
                              global_batch=SMALL_B), cfg, grad_sync=sync,
                   arch=arch)
    key = (arch, kind, mesh, route, impl)
    temp, flash = got["memory"]["temp_bytes"], got["attention_bytes"]
    moved = got["bytes_accessed"] - flash
    if key in NEW_CACHE:
        kv = new_cache_bytes(got["cache_kv"], want["new_caches"])
        temp, moved = temp + kv, moved + 2 * kv
    scans = want["accessed"]["scans"]
    ratios = {"flops": got["flops"] / want["flops"],
              "temp": temp / want["temp"],
              "total": got["memory"]["total_bytes"] / want["total"],
              "link": got["collective_link_bytes"] / want["link"],
              "bytes": moved / held_bytes(
                  want, ("float32",) if key in FLOAT32 else ())}
    print(f"{arch} {kind} {mesh} {route} {sync} {impl}: port / reference "
          f"{ratios}; bytes port {got['bytes_accessed']} (flash calls "
          f"{flash}) / reference {want['accessed']}; link bytes port "
          f"{got['collective_link_bytes']}, temporaries port "
          f"{got['memory']['temp_bytes']}")
    assert not got["unknown_collectives"]
    if key in EXACT_FLOPS:
        assert got["flops"] == want["flops"]
    if sync == "canary_fp":
        assert got["collective_bytes"]["collective-permute"] == \
            want["moved"]["collective-permute"] > 0
    assert FLOPS_BOUND[0] <= ratios["flops"] <= FLOPS_BOUND[1], ratios
    assert TEMP_BOUND[0] <= ratios["temp"] <= TEMP_BOUND[1], ratios
    assert LINK_BOUND[0] <= ratios["link"] <= LINK_BOUND[1], ratios
    assert flash <= scans, (flash, scans)
    assert BYTES_BOUND[0] <= ratios["bytes"] <= BYTES_BOUND[1], ratios


@pytest.mark.parametrize("arch,kind,mesh,route,sync,impl", COST_CASES,
                         ids=[_case_id(*c) for c in COST_CASES])
def test_byte_walk_matches_cost_analysis(reference, arch, kind, mesh, route,
                                         sync, impl):
    """``dryrun_reference.accessed`` on the small step's compiled HLO,
    with each while body counted once as XLA counts it, lies within 0.1 %
    of ``cost_analysis()["bytes accessed"]``; on a step with no loop that
    is the walk itself, the figure the bytes are held by."""
    want = reference["costs"][
        f"{arch}|{kind}|{list(mesh)}|{route}|{sync}|{impl}"]
    print(f"{arch} {kind} {mesh} {route} {sync} {impl}: the walk "
          f"{want['accessed']['all']}, each loop once {want['once']}, "
          f"cost_analysis {want['cost_analysis']}, {want['loops']} loops")
    assert abs(want["once"] / want["cost_analysis"] - 1) <= 1e-3
    if not want["loops"]:
        assert want["accessed"]["all"] == want["once"]


# --------------------------------------------------------------------- FLOPs
def _small_cfg():
    """float32, remat, and the flash route from 64 tokens."""
    return get_config(ARCH, "smoke").with_(
        dtype="float32", remat=True, attn_chunk_threshold=64, attn_chunk=64)


def test_one_rank_flops_match_flop_counter():
    cfg, B, S = _small_cfg(), 2, 128
    got = _account((1, 1), dict(kind="train", seq_len=S, global_batch=B),
                   cfg)
    tc = TrainConfig(model=cfg, optimizer=AdamWConfig())
    params, opt = init_train_state(tc, torch.Generator().manual_seed(0),
                                   device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (B, S),
                           generator=torch.Generator().manual_seed(1),
                           dtype=torch.int32)
    with FlopCounterMode(display=False) as fc:
        make_train_step(tc)(params, opt, {"tokens": tokens,
                                          "labels": tokens})
    assert got["flops"] == fc.get_total_flops() > 0
    # remat: the forward twice a layer, the backward once
    assert got["attention"] == {"fwd": {"replicated": 2 * cfg.num_layers},
                                "bwd": {"replicated": cfg.num_layers}}


def test_argument_bytes_count_a_shared_storage_once():
    """Two argument leaves on one storage (a tensor and a view of it) count
    its bytes once; an argument the step never reads counts none."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        a, unread = torch.empty(8, 4), torch.empty(16)
    got = D.account(lambda a, b, u: a * 2 + b.sum(), (a, a[2:], unread))
    assert got["memory"]["argument_bytes"] == 8 * 4 * 4


def test_data_ranks_split_flops():
    cfg = _small_cfg()
    spec = dict(kind="train", seq_len=128, global_batch=8)
    one, four = _account((1, 1), spec, cfg), _account((4, 1), spec, cfg)
    assert four["flops"] * 4 == one["flops"]
    assert four["attention"]["fwd"] == {"batch": 2 * cfg.num_layers}


# ----------------------------------------------------------------- custom ops
def _qkv(B, H, KV, S, D, dtype=torch.float32, device="cpu", seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn((B, n, S, D), generator=g, dtype=torch.float32)
            .to(dtype).to(device) for n in (H, KV, KV)]


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_flash_fakes_match_real_route(device):
    from torch._subclasses.fake_tensor import FakeTensorMode
    B, H, KV, S, D = 1, 8, 2, 48, 64
    q, k, v = _qkv(B, H, KV, S, D, torch.bfloat16)
    out, lse = flash_attention_fwd_op(q, k, v, 0, True, True)
    grads = flash_attention_bwd_op(q, k, v, out, lse, out, 0, True)
    _, no_lse = flash_attention_fwd_op(q, k, v, 0, True, False)
    with FakeTensorMode():
        # a (B, S, H, D) activation read through its transpose
        fq = torch.empty((B, S, H, D), dtype=q.dtype,
                         device=device).transpose(1, 2)
        fk = torch.empty((B, S, KV, D), dtype=q.dtype,
                         device=device).transpose(1, 2)
        fo, fl = flash_attention_fwd_op(fq, fk, fk, 0, True, True)
        fg = flash_attention_bwd_op(fq, fk, fk, fo, fl, fo, 0, True)
        _, fno = flash_attention_fwd_op(fq, fk, fk, 0, True, False)
    for real, fake in zip((out, lse, no_lse) + grads, (fo, fl, fno) + fg):
        assert (fake.shape, fake.dtype) == (real.shape, real.dtype)
        assert fake.device.type == device
    if device == "cuda":            # the kernel's output: q's layout
        assert fo.stride() == fq.stride() and fg[1].stride() == fk.stride()


def _flash_work_pairs(S, causal, window):
    """``chip_smoke.flash_work``'s reckoning of live (query, key) pairs."""
    q = np.arange(S, dtype=np.int64)
    hi = q if causal else np.full(S, S - 1)
    lo = np.maximum(q - window + 1, 0) if window > 0 \
        else np.zeros(S, np.int64)
    return int((hi - lo + 1).sum())


@pytest.mark.parametrize("S,causal,window", [
    (4096, True, 0), (65, True, 0), (1000, False, 0), (1000, True, 300),
    (200, False, 64), (5, True, 9)])
def test_flash_flop_formula(S, causal, window):
    assert live_pairs(S, causal, window) == _flash_work_pairs(S, causal,
                                                             window)
    B, H, KV, D = 1, 4, 2, 64
    q, k, v = (t.requires_grad_(True) for t in _qkv(B, H, KV, S, D))
    with FlopCounterMode(display=False) as fc:
        flash_attention(q, k, v, causal=causal, window=window).sum() \
            .backward()
    pairs = B * H * D * live_pairs(S, causal, window)
    assert fc.get_total_flops() == 4 * pairs + 10 * pairs
    if (S, causal, window) == (4096, True, 0):    # 32 heads of llama3.2-1b
        assert round(4 * 32 * 64 * live_pairs(S, True, 0) / 1e9, 1) == 68.7


@pytest.mark.parametrize("remat", [False, True])
def test_flash_gradient_through_ops_is_the_plain_one(remat):
    q, k, v = _qkv(2, 4, 2, 40, 64, seed=3)
    dout = _qkv(2, 4, 2, 40, 64, seed=4)[0]
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]

    def attend(a, b, c):
        return flash_attention(a, b, c, causal=True, window=24)

    out = checkpoint(attend, *leaves, use_reentrant=False) if remat \
        else attend(*leaves)
    out.backward(dout)
    want, lse = flash_attention_ref(q, k, v, causal=True, window=24,
                                    return_lse=True)
    grads = flash_attention_bwd_ref(q, k, v, want, lse, dout, causal=True,
                                    window=24)
    assert torch.equal(out.detach(), want)
    for got, ref in zip(leaves, grads):
        assert torch.equal(got.grad, ref)


# ---------------------------------------------------------------- constraints
@pytest.mark.parametrize("sp", [False, True])
@pytest.mark.parametrize("S", [8, 7])
def test_activation_constraint_is_the_reference_layout(reference, sp, S):
    with D.fake_process_group(4):
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        ctx = ParallelContext(mesh=mesh, data_axes=("data",),
                              model_axis="model", sequence_parallel=sp)
        x = DTensor.from_local(torch.zeros(4, S, 3), mesh,
                               [Replicate(), Shard(2)], run_check=False)
        plain = torch.zeros(4, S, 6)
        with parallel_context(ctx):
            y = _activation_constraint(x)
            assert _activation_constraint(plain) is plain
        spec = P(*[tuple(a) if isinstance(a, list) else a
                   for a in reference["constraint"][f"{sp}|{S}"]])
        assert list(y.placements) == param_placements(spec, mesh)
        assert y.shape == x.shape


@pytest.mark.parametrize("constrain,spec", [
    ("full", P("data", None, "model")), ("model", P(None, None, "model"))])
def test_logits_constraint(constrain, spec):
    cfg = get_config(ARCH, "smoke")
    tc = TrainConfig(model=cfg)
    seen = []
    import repro_torch.train.train_step as ts
    real = ts.cross_entropy

    def spy(logits, labels, **kw):
        seen.append(logits)
        return real(logits, labels, **kw)

    ts.cross_entropy = spy
    try:
        with D.fake_process_group(4):
            mesh = init_device_mesh("cpu", (2, 2),
                                    mesh_dim_names=("data", "model"))
            ctx = ParallelContext(mesh=mesh, data_axes=("data",),
                                  model_axis="model")
            with parallel_context(ctx):
                fn, (params, _, batch), _ = D.build_dryrun(
                    ARCH, dict(kind="train", seq_len=16, global_batch=4),
                    mesh, cfg_override=cfg, device="cpu")
                D.account(make_loss_fn(tc, constrain), (params, batch))
                assert list(seen[-1].placements) == param_placements(spec,
                                                                     mesh)
            # a rank's own logits: untouched
            model, _ = init_train_state(tc, torch.Generator().manual_seed(0),
                                        device="cpu")
            tokens = torch.zeros((2, 16), dtype=torch.int32)
            with parallel_context(ctx):
                make_loss_fn(tc, constrain)(model, {"tokens": tokens,
                                                    "labels": tokens})
            assert not isinstance(seen[-1], DTensor)
    finally:
        ts.cross_entropy = real


# ------------------------------------------------------------------- canary_fp
def test_canary_fp_counts_the_trees():
    cfg = get_config(ARCH, "smoke")
    got = _account((4, 1), dict(kind="train", seq_len=64, global_batch=8),
                   cfg, grad_sync="canary_fp")
    blocks, n = TrainConfig(model=cfg).canary_blocks, 4
    rounds = 2 * max(1, math.ceil(math.log2(n)))   # reduce, then broadcast
    sizes = [p.numel() for p in Transformer(cfg, device="meta").parameters()]
    assert got["collective_bytes"]["collective-permute"] == sum(
        rounds * -(-m // blocks) * blocks * 4 for m in sizes)
    assert got["collective_counts"]["collective-permute"] == rounds \
        * len(sizes)
    assert got["reduce_ops"]["max"] == 1
    # parameters replicated over the data axis: each rank holds them whole
    assert got["memory"]["argument_bytes"] > 3 * sum(sizes) * 2


# --------------------------------------------------------------- the row, pg
def test_row_feeds_the_roofline_report(tmp_path, monkeypatch):
    monkeypatch.setattr(D, "get_config",
                        lambda arch: get_config(arch, "smoke"))
    row = D.run_one(ARCH, "decode_32k", False, out_dir=str(tmp_path),
                    device="cpu")
    assert not dist.is_initialized()
    files = os.listdir(tmp_path)
    assert files == [f"{ARCH}__decode_32k__16x16.json"]
    with open(tmp_path / files[0]) as f:
        assert json.load(f) == json.loads(json.dumps(row))
    from benchmarks import roofline
    emitted = []
    monkeypatch.setattr(roofline, "load_all", lambda: [row])
    monkeypatch.setattr(roofline, "emit",
                        lambda *a: emitted.append(a))
    roofline.main()
    assert len(emitted) == 1 and emitted[0][0] == \
        f"roofline/{ARCH}/decode_32k/16x16"
    assert row["chips"] == 256 and row["roofline"]["dominant"] in (
        "compute_s", "memory_s", "collective_s")


def test_check_torch_refuses_an_untried_release(tmp_path, monkeypatch):
    D.check_torch()
    monkeypatch.setattr(D, "TORCH_TESTED", ("0.0",))
    with pytest.raises(RuntimeError, match="tried on torch 0.0"):
        D.run_one(ARCH, "decode_32k", False, out_dir=str(tmp_path),
                  device="cpu")
    assert not dist.is_initialized() and not os.listdir(tmp_path)


def test_run_one_refuses_beside_a_process_group(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        with pytest.raises(RuntimeError, match="already up"):
            D.run_one(ARCH, "decode_32k", False, out_dir=str(tmp_path),
                      device="cpu")
        assert dist.get_backend() == "gloo"
    finally:
        dist.destroy_process_group()
    assert not os.path.exists(tmp_path / f"{ARCH}__decode_32k__16x16.json")


# ----------------------------------------------- the dry run's own layouts
def _layouts_rank(rank: int, init_file: str):
    """On 4 gloo ranks at (2, 2), real tensors: each layout the dry run
    gives an operation equals the operation on the whole tensors."""
    import torch.nn.functional  # noqa: F401
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=4, rank=rank)
    try:
        from torch.distributed.tensor import distribute_tensor
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        g = torch.Generator().manual_seed(0)
        table = torch.randn(8, 6, generator=g)
        idx = torch.randint(0, 8, (4, 3), generator=g)
        vals = torch.randn(4, 3, 6, generator=g)

        def dt(t, *placements):
            return distribute_tensor(t, mesh, list(placements))

        cases = [  # vocabulary on model (masked), features on data
            (dt(table, Shard(1), Shard(0)), dt(idx, Shard(0), Replicate())),
            # indices split on both mesh dims: the table gathered
            (dt(table, Replicate(), Shard(0)), dt(idx, Shard(0), Shard(1))),
            (dt(table, Shard(0), Shard(1)), dt(idx, Replicate(), Replicate()))]
        for tab, ids in cases:
            got = D._embedding_lookup(tab, [ids]).full_tensor()
            assert torch.equal(got, table[idx]), (tab.placements,
                                                  ids.placements)
        for ids, v in ((dt(idx, Shard(0), Replicate()),
                        dt(vals, Shard(0), Shard(2))),
                       (dt(idx, Replicate(), Replicate()),
                        dt(vals, Replicate(), Shard(2)))):
            dest = dt(torch.zeros(8, 6), Replicate(), Replicate())
            got = D._embedding_grad(dest, [ids], v, True).full_tensor()
            want = torch.zeros(8, 6).index_put([idx], vals, accumulate=True)
            assert torch.allclose(got, want, atol=1e-6), (ids.placements,
                                                         v.placements)
        from torch.distributed.tensor import Partial
        x2, w2 = torch.randn(4, 6, generator=g), torch.randn(6, 8, generator=g)
        with parallel_context(ParallelContext(mesh=mesh,
                                              data_axes=("data",),
                                              model_axis="model")):
            # tokens split over data against an FSDP x Megatron weight, plain
            # and batched: the weight gathered over data, the tokens kept split
            for a, b, want in ((dt(x2, Shard(0), Replicate()),
                                dt(w2, Shard(0), Shard(1)), x2 @ w2),
                               (dt(x2[None], Shard(1), Replicate()),
                                dt(w2[None], Shard(1), Shard(2)), (x2 @ w2)[None])):
                got = D._gather_weight(a, b)
                assert list(got.placements) == [Shard(a.ndim - 2),
                                                Shard(a.ndim - 1)]
                assert torch.allclose(got.full_tensor(), want, atol=1e-5)
            # a partial sum over model (each model rank half of x2's rows)
            # against a model-split weight: reduced, the weight kept split
            row, col = mesh.get_coordinate()
            mine = x2[2 * row:2 * row + 2] / 2
            part = DTensor.from_local(mine, mesh, [Shard(0), Partial()],
                                      run_check=False)
            got = D._gather_weight(part, dt(w2, Replicate(), Shard(1)))
            assert list(got.placements) == [Shard(0), Shard(1)]
            assert torch.allclose(got.full_tensor(), x2 @ w2, atol=1e-5)
            # features split over model against a weight whose output columns
            # model splits: the features gathered, the columns kept split
            got = D._gather_weight(dt(x2, Shard(0), Shard(1)),
                                   dt(w2, Replicate(), Shard(1)))
            assert list(got.placements) == [Shard(0), Shard(1)]
            assert torch.allclose(got.full_tensor(), x2 @ w2, atol=1e-5)
            # tokens split over model (a sequence split) against it: gathered
            got = D._gather_weight(dt(x2, Replicate(), Shard(0)),
                                   dt(w2, Replicate(), Shard(1)))
            assert list(got.placements) == [Replicate(), Shard(1)]
            assert torch.allclose(got.full_tensor(), x2 @ w2, atol=1e-5)
            assert D._gather_weight(dt(x2, Replicate(), Replicate()),
                                    dt(w2, Replicate(), Shard(1))) \
                is NotImplemented
            # a weight dim split over data and model together (FSDP over
            # the whole mesh) against tokens split over data: gathered over
            # both; against tokens whole over data (not FSDP-gathered), not
            x3, w3 = torch.randn(4, 8, generator=g), torch.randn(
                8, 6, generator=g)
            got = D._gather_weight(dt(x3, Shard(0), Replicate()),
                                   dt(w3, Shard(0), Shard(0)))
            assert list(got.placements) == [Shard(0), Replicate()]
            assert torch.allclose(got.full_tensor(), x3 @ w3, atol=1e-5)
            assert D._gather_weight(dt(x3, Replicate(), Replicate()),
                                    dt(w3, Shard(0), Shard(0))) \
                is NotImplemented
        src = dt(torch.randn(4, 3, 1, generator=g), Shard(0), Replicate())
        z = D._zeros_like_source(src, [4, 3, 6])
        assert list(z.placements) == [Shard(0), Replicate()]
        assert torch.equal(z.full_tensor(), torch.zeros(4, 3, 6))
        # gather's backward under a context: the zeros split over the
        # vocabulary on model, each rank adding its labels' entries
        labels = torch.randint(0, 6, (4, 3, 1), generator=g)
        with parallel_context(ParallelContext(mesh=mesh, data_axes=("data",),
                                              model_axis="model")):
            z = D._zeros_like_source(src, [4, 3, 6])
        assert list(z.placements) == [Shard(0), Shard(2)]
        got = D._scatter_into_split(z, -1, dt(labels, Shard(0), Replicate()),
                                    src)
        assert list(got.placements) == [Shard(0), Shard(2)]
        want = torch.zeros(4, 3, 6).scatter_add(-1, labels, src.full_tensor())
        assert torch.equal(got.full_tensor(), want)
        x = dt(torch.randn(4, 3, 6, generator=g), Shard(0), Shard(1))
        for keepdim in (False, True):
            got = D._argmax_layout(x, -1, keepdim).full_tensor()
            assert torch.equal(got, x.full_tensor().argmax(-1, keepdim))
        # along a split dim (the vocabulary over model), with ties across
        # the ranks' shares: the first of the largest, as on the whole
        whole = torch.randint(0, 3, (4, 3, 6), generator=g).float()
        for keepdim in (False, True):
            got = D._argmax_layout(dt(whole, Shard(0), Shard(2)), -1, keepdim)
            assert torch.equal(got.full_tensor(), whole.argmax(-1, keepdim))
        logits = dt(torch.randn(4, 3, 6, generator=g), Shard(0), Shard(2))
        for keepdim in (False, True):
            got = D._split_logsumexp(logits, [-1], keepdim).full_tensor()
            assert torch.allclose(got, logits.full_tensor().logsumexp(
                -1, keepdim), atol=1e-6)
        ctx = ParallelContext(mesh=mesh, data_axes=("data",),
                              model_axis="model")
        one = dt(torch.tensor(0.25), Replicate(), Replicate())
        with parallel_context(ctx):
            e = D._expand_over_batch(one, [4, 3])
        assert list(e.placements) == [Shard(0), Replicate()]
        assert torch.equal(e.full_tensor(), torch.full((4, 3), 0.25))
        # a matrix's gradient, a sum over the tokens data splits: split as
        # the matrix over model (its vocabulary gathered, d kept split),
        # the partial sum over data left for the gradient's reduction
        gt, xt = torch.randn(6, 4, generator=g), torch.randn(4, 8,
                                                             generator=g)
        got = D._as_weight_gradient(dt(gt, Shard(1), Shard(0)),
                                    dt(xt, Shard(0), Replicate()),
                                    [Replicate(), Shard(1)])
        assert list(got.placements) == [Partial(), Shard(1)]
        assert torch.allclose(got.full_tensor(), gt @ xt, atol=1e-5)
        # a partial sum over model constrained onto a dim the axis does not
        # divide (an uneven vocabulary): reduced whole in float32, each
        # rank then its share
        from repro_torch.parallel import sharding_constraint
        v = torch.randn(4, 3, 5, generator=g).to(torch.bfloat16)
        part = DTensor.from_local(v / 2, mesh, [Replicate(), Partial()],
                                  run_check=False)
        got = sharding_constraint(part, P(None, None, "model"), mesh)
        assert list(got.placements) == [Replicate(), Shard(2)]
        assert got.dtype == torch.float32
        assert torch.equal(got.full_tensor(), v.to(torch.float32))
    finally:
        dist.destroy_process_group()


def test_dry_run_layouts_compute_the_operations(tmp_path):
    import torch.multiprocessing as mp
    mp.spawn(_layouts_rank, args=(str(tmp_path / "rendezvous"),), nprocs=4,
             join=True)


# ------------------------------ the MoE and Mamba-2 layouts, on real tensors
@contextlib.contextmanager
def _dry_run_layouts(weights=()):
    """The dry run's layouts (and its view fallback) over real DTensors: an
    :class:`D.Accountant` whose factories make real tensors, training
    ``weights``."""
    acct = D.Accountant(contextlib.nullcontext(), weights)
    with implicit_replication(), D._views_reshard(), \
            D._shape_inference_uncounted(acct), acct:
        yield


def _distributed(module, mesh, rules_mesh):
    """A copy of ``module`` whose parameters are DTensors laid out by the
    port's sharding rules (FSDP over data, the model axis as the rules
    say)."""
    from torch.distributed.tensor import distribute_tensor
    from torch import nn
    from repro_torch.parallel import leaf_spec
    import copy
    out = copy.deepcopy(module)
    for name, p in list(out.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        spec = leaf_spec(leaf, tuple(p.shape), rules_mesh, "data", "model")
        setattr(out.get_submodule(owner) if owner else out, leaf,
                nn.Parameter(distribute_tensor(
                    p.detach(), mesh, param_placements(spec, mesh))))
    return out


def _grads(module):
    return {n: (p.grad.full_tensor() if isinstance(p.grad, DTensor)
                else p.grad) for n, p in module.named_parameters()}


def _region_layouts_rank(rank: int, init_file: str):
    """On 4 gloo ranks at (2, 2), real float32 tensors: the MoE forms (the
    dense route, ``ep``, ``ep_a2a``) and the Mamba-2 layer, run on DTensors
    laid out by the sharding rules through the ``shard_map`` boundary and
    the dry run's layouts, forward and backward, against the same layer on
    the whole tensors; and each new layout alone against its operation."""
    from torch.distributed.tensor import Partial, distribute_tensor
    from repro_torch.models.mamba2 import Mamba2, mamba2_forward
    from repro_torch.models.moe import MoE, _moe_dense, moe_forward
    from repro_torch.models.layers import mlp_forward
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=4, rank=rank)
    try:
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        ctx = ParallelContext(mesh=mesh, data_axes=("data",),
                              model_axis="model")
        sizes = {"data": 2, "model": 2}
        g = torch.Generator().manual_seed(0)

        def dt(t, *placements):
            return distribute_tensor(t, mesh, list(placements))

        def close(got, want, what, tol=1e-5):
            got = got.full_tensor() if isinstance(got, DTensor) else got
            err = (got - want).abs().max().item()
            assert err <= tol * max(1.0, want.abs().max().item()), \
                (what, err)

        # -- the layouts alone
        keys = torch.randint(0, 4, (16,), generator=g)
        seq = torch.sort(keys).values
        q = torch.randint(0, 5, (12,), generator=g)
        got = D._searchsorted_layout(dt(seq, Shard(0), Replicate()),
                                     dt(q, Replicate(), Shard(0)), side="left")
        assert list(got.placements) == [Replicate(), Shard(0)]
        assert torch.equal(got.full_tensor(),
                           torch.searchsorted(seq, q, side="left"))
        dest, src = torch.randn(10, 6, generator=g), torch.randn(
            4, 6, generator=g)
        idx = torch.tensor([7, 1, 4, 2])
        d = dt(dest, Replicate(), Shard(1))
        assert D._index_copy_layout(d, 0, dt(idx, Replicate(), Replicate()),
                                    dt(src, Shard(0), Replicate())) is d
        assert torch.equal(d.full_tensor(), dest.index_copy(0, idx, src))
        # a destination its copy dim splits: each rank its share
        d = dt(dest, Shard(0), Replicate())
        assert D._index_copy_layout(d, 0, dt(idx, Replicate(), Shard(0)),
                                    dt(src, Replicate(), Replicate())) is d
        assert list(d.placements) == [Shard(0), Replicate()]
        assert torch.equal(d.full_tensor(), dest.index_copy(0, idx, src))
        rows = torch.randn(8, 6, generator=g)
        at = torch.tensor([3, 0, 3, 9, 1, 1, 7, 2])
        for dest_pl, rows_pl in (((Replicate(), Shard(1)),
                                  (Shard(0), Shard(1))),
                                 ((Replicate(), Replicate()),
                                  (Shard(0), Replicate())),
                                 ((Shard(0), Replicate()),
                                  (Replicate(), Replicate()))):
            got = D._index_add_layout(dt(dest, *dest_pl), 0,
                                      dt(at, Replicate(), Replicate()),
                                      dt(rows, *rows_pl))
            close(got, dest.index_add(0, at, rows), "index_add")
        for pl in ((Shard(0), Replicate()), (Replicate(), Shard(1)),
                   (Shard(0), Shard(0))):
            got = D._index_fill_layout(dt(dest, *pl), 0,
                                       dt(idx, Replicate(), Shard(0)), 0.0)
            assert list(got.placements) == list(pl)
            assert torch.equal(got.full_tensor(), dest.index_fill(0, idx, 0))
        ids = torch.randint(0, 5, (12,), generator=g)
        ones = torch.ones(12)
        d = dt(torch.full((5,), 2.0), Replicate(), Replicate())
        assert D._scatter_add_layout(d, 0, dt(ids, Shard(0), Replicate()),
                                     dt(ones, Shard(0), Replicate())) is d
        assert torch.equal(d.full_tensor(), torch.full((5,), 2.0)
                           .scatter_add(0, ids, ones))
        whole = torch.randn(4, 3, 12, generator=g)
        pieces = D._split_keeping(dt(whole, Shard(0), Shard(2)), [4, 6, 2],
                                  -1)
        for got, want in zip(pieces, torch.split(whole, [4, 6, 2], -1)):
            assert list(got.placements) == [Shard(0), Shard(2)]
            assert torch.equal(got.full_tensor(), want)
        odd = D._split_keeping(dt(whole, Shard(0), Shard(2)), [5, 7], 2)
        assert [list(t.placements) for t in odd] == [[Shard(0),
                                                       Replicate()]] * 2
        with parallel_context(ctx):
            # a partial sum over model meeting a whole operand: reduced
            a = torch.randn(4, 6, generator=g)
            coord = mesh.get_coordinate()
            part = DTensor.from_local(a / 2, mesh, [Replicate(), Partial()],
                                      run_check=False)
            b = torch.randn(4, 6, generator=g)
            got = D._reduce_partials(torch.ops.aten.mul.Tensor)(
                part, dt(b, Replicate(), Shard(1)))
            close(got, a * b, "partial * split")
            # split along different (broadcast) dims: the smaller gathered
            c = torch.randn(4, 1, generator=g)
            got = D._reduce_partials(torch.ops.aten.mul.Tensor)(
                dt(b, Replicate(), Shard(1)), dt(c, Replicate(), Shard(0)))
            close(got, b * c, "conflicting splits")
            # a stacked weight split over data against a buffer whole over
            # data, through autograd, plain and under remat (the forward
            # recomputed inside the backward pass): the forward gathers the
            # weight; the backward computes the weight's gradient in its
            # layout, each data rank its share of the rows
            buf = torch.randn(4, 5, 6, generator=g)
            w = torch.randn(4, 6, 8, generator=g)
            gy = torch.randn(4, 5, 8, generator=g)
            for remat in (False, True):
                wd = dt(w, Shard(1), Shard(0)).requires_grad_(True)
                bd = dt(buf, Replicate(), Shard(0)).requires_grad_(True)
                with _dry_run_layouts([wd]):
                    out = checkpoint(torch.bmm, bd, wd, use_reentrant=False) \
                        if remat else torch.bmm(bd, wd)
                    assert list(out.placements) == [Replicate(), Shard(0)]
                    out.backward(dt(gy, Replicate(), Shard(0)))
                close(out, buf @ w, "stacked forward")
                assert list(wd.grad.placements) == [Shard(1), Shard(0)]
                close(wd.grad, buf.transpose(1, 2) @ gy,
                      "the weight's gradient")
                close(bd.grad, gy @ w.transpose(1, 2), "the input's gradient")

        # -- the MoE forms on DTensors, through the shard_map boundary (the
        # dense route also under remat, and with its capacity buffer laid
        # out by the experts' weights, split along d over data, as where
        # the model axis divides neither E nor C: qwen2-moe's at (16, 16),
        # forced here, where a 2-way axis divides any capacity)
        import repro_torch.models.moe as moe_module
        by_weights = moe_module._buffer_placements
        for arch, impl, remat, by_d in ((DENSE_MOE, "dense", False, False),
                                        (DENSE_MOE, "dense", True, False),
                                        (DENSE_MOE, "dense", False, True),
                                        (MOE, "ep", False, False),
                                        (MOE, "ep_a2a", False, False)):
            moe_module._buffer_placements = (
                lambda ctx, mesh, shape, w_up: by_weights(ctx, mesh, (3, 3),
                                                          w_up)) \
                if by_d else by_weights
            cfg = get_config(arch, "smoke").with_(
                dtype="float32", moe_impl=impl, moe_capacity_factor=4.0)
            p = MoE(cfg, torch.float32, gen=torch.Generator().manual_seed(1))
            p.requires_grad_(True)
            xs = torch.randn(4, 8, cfg.d_model, generator=g)
            x = xs.clone().requires_grad_(True)
            y2d, _ = _moe_dense(p, x.reshape(-1, cfg.d_model), cfg)
            y = y2d.view(x.shape) + mlp_forward(p.shared, x, "swiglu")
            (y ** 2).sum().backward()
            pd = _distributed(p, mesh, sizes)
            xd = dt(xs, Shard(0), Replicate()).requires_grad_(True)
            with parallel_context(ctx), _dry_run_layouts(pd.parameters()):
                yd, _ = checkpoint(moe_forward, pd, xd, cfg,
                                   use_reentrant=False) if remat \
                    else moe_forward(pd, xd, cfg)
                (yd ** 2).sum().backward()
            if impl == "dense":     # each data rank its share of each
                for n in ("w_up", "w_gate", "w_down"):  # expert's gradient
                    w = getattr(pd, n)
                    assert w.grad.placements == w.placements, (n, remat)
            close(yd, y.detach(), f"{impl} y")
            close(xd.grad, x.grad, f"{impl} dx", 1e-4)
            want = _grads(p)
            for n, gr in _grads(pd).items():
                close(gr, want[n], f"{impl} d{n}", 1e-4)
        moe_module._buffer_placements = by_weights

        # -- the Mamba-2 layer on DTensors, by heads: 8 heads, and 3 (a
        # d_model of 96), which split unevenly over the 2-way model axis,
        # as 24 over 16 ranks, with 451 projection columns and w_in
        # replicated, as mamba2-130m's 3352 columns at (16, 16)
        for d_model, w_in in ((256, [Shard(0), Shard(1)]),
                              (96, [Replicate(), Replicate()])):
            cfg = get_config(MAMBA, "smoke").with_(dtype="float32",
                                                   d_model=d_model)
            p = Mamba2(cfg, torch.float32,
                       gen=torch.Generator().manual_seed(2))
            p.requires_grad_(True)
            xs = torch.randn(4, 32, cfg.d_model, generator=g)
            x = xs.clone().requires_grad_(True)
            y = mamba2_forward(p, x, cfg)
            (y ** 2).sum().backward()
            pd = _distributed(p, mesh, sizes)
            assert list(pd.w_in.placements) == w_in
            xd = dt(xs, Shard(0), Replicate()).requires_grad_(True)
            with parallel_context(ctx), _dry_run_layouts():
                yd = mamba2_forward(pd, xd, cfg)
                (yd ** 2).sum().backward()
            close(yd, y.detach(), f"mamba2 {d_model} y")
            close(xd.grad, x.grad, f"mamba2 {d_model} dx", 1e-4)
            want = _grads(p)
            for n, gr in _grads(pd).items():
                close(gr, want[n], f"mamba2 {d_model} d{n}", 1e-4)
    finally:
        dist.destroy_process_group()


def test_moe_and_mamba2_layouts_compute_the_layers(tmp_path):
    import torch.multiprocessing as mp
    mp.spawn(_region_layouts_rank, args=(str(tmp_path / "rendezvous"),),
             nprocs=4, join=True)
