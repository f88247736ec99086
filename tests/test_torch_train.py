"""The port's training path (``repro_torch.optim``, ``train``, ``data``,
``checkpoint``, ``launch.train``) against the JAX package's.

The same seeded numpy inputs, and for the model the same weights (JAX's
``init_params`` carried over by ``convert.params_from_reference``), go
through both packages on the CPU. The reference's modules are imported
inside the ``ref`` fixture, so the port's spawned ranks, which import this
module, do not load JAX.

Tolerances: AdamW, the schedules and the loss within 1e-6 (float32, the
order of a few operations differs); bf16 moments within one bf16 rounding;
the float32 smoke model's loss within 1e-5 relative, each gradient within
1e-4 of its leaf's max |g|, the global norm within 1e-4 relative (sums
over the batch and sequence run in another order). ``canary_fp`` on 4
gloo ranks is held to JAX's ``shard_map`` step on 4 host devices, which
runs in a subprocess beside them; the checkpoint-resume and microbatching
tests use the reference tests' tolerances.
"""
import copy
import dataclasses
import datetime
import importlib
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

os.environ.setdefault("JAX_PLATFORMS", "cpu")
from repro_torch.checkpoint import (latest_step, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.convert import (opt_state_from_reference,
                                 params_from_reference, reference_leaves)
from repro_torch.core.collective import (canary_allreduce_tree,
                                         fixed_point_scales,
                                         multi_root_tree_allreduce,
                                         round_robin_roots)
from repro_torch.data import DataConfig, batch_at
from repro_torch.kernels import fixed_point_scale, quantize
from repro_torch.models import get_config
from repro_torch.optim import (AdamWConfig, AdamWState, cosine_with_warmup,
                               linear_warmup_constant)
from repro_torch.optim import init as adamw_init
from repro_torch.optim import update as adamw_update
from repro_torch.train import (TrainConfig, Trainer, TrainerConfig,
                               cross_entropy, make_loss_fn, make_mesh,
                               make_train_step, value_and_grad)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "llama3.2-1b"
DP, B, S, LR = 4, 8, 16, 1e-3


@pytest.fixture(scope="module")
def ref():
    """The reference's modules (JAX on the CPU)."""
    import jax
    import jax.numpy as jnp

    from repro import data, models, optim, train
    return SimpleNamespace(jax=jax, jnp=jnp, data=data, models=models,
                           optim=optim, train=train)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def _copies(synced: dict) -> dict:
    """What an ``on_sync`` keeps of the sums: the step divides them in
    place once it returns."""
    return {k: v.clone() for k, v in synced.items()}


def _f32cfg():
    return get_config(ARCH, "smoke").with_(dtype="float32")


# ------------------------------------------------------------------- AdamW
ADAMW_CASES = {
    "clipped": dict(grad_clip=1.0),
    "unclipped_cosine": dict(grad_clip=0.0, schedule="cosine"),
    "bf16_state": dict(state_dtype="bfloat16"),
}


@pytest.mark.parametrize("case", sorted(ADAMW_CASES))
def test_adamw_update_matches_jax(ref, case):
    jnp = ref.jnp
    kw = dict(ADAMW_CASES[case])
    sched = kw.pop("schedule", None)
    rng = np.random.default_rng(1)
    shapes = {"w": (16, 8), "b": (8,), "k": (3, 4, 5)}
    p = {k: rng.standard_normal(s).astype(np.float32)
         for k, s in shapes.items()}
    g = {k: (3 * rng.standard_normal(s)).astype(np.float32)
         for k, s in shapes.items()}
    m = {k: (0.1 * rng.standard_normal(s)).astype(np.float32)
         for k, s in shapes.items()}
    v = {k: (0.01 * rng.random(s)).astype(np.float32)
         for k, s in shapes.items()}
    step = 5
    jcfg = ref.optim.AdamWConfig(
        lr=LR, schedule=ref.optim.cosine_with_warmup(LR, 3, 20)
        if sched else None, **kw)
    tcfg = AdamWConfig(lr=LR, schedule=cosine_with_warmup(LR, 3, 20)
                       if sched else None, **kw)
    sdt = jnp.dtype(jcfg.state_dtype)
    jstate = ref.optim.AdamWState(
        step=jnp.int32(step), m={k: jnp.asarray(a, sdt) for k, a in m.items()},
        v={k: jnp.asarray(a, sdt) for k, a in v.items()})
    jp, js, jm = ref.optim.update({k: jnp.asarray(a) for k, a in g.items()},
                                  jstate, {k: jnp.asarray(a)
                                           for k, a in p.items()}, jcfg)
    tsd = getattr(torch, tcfg.state_dtype)
    tp = {k: _t(a) for k, a in p.items()}
    ts = AdamWState(step=torch.tensor(step, dtype=torch.int32),
                    m={k: _t(a).to(tsd) for k, a in m.items()},
                    v={k: _t(a).to(tsd) for k, a in v.items()})
    tp, ts, tm = adamw_update({k: _t(a) for k, a in g.items()}, ts, tp, tcfg)
    assert int(ts.step) == int(js.step) == step + 1
    for key in ("grad_norm", "lr"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                   rtol=1e-6, atol=1e-6)
    for k in shapes:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-6)
        for got, want in ((ts.m[k], js.m[k]), (ts.v[k], js.v[k])):
            tol = 2 ** -8 if case == "bf16_state" else 1e-6
            assert got.dtype == tsd
            np.testing.assert_allclose(got.float().numpy(),
                                       np.asarray(want, np.float32),
                                       rtol=tol, atol=1e-6)


# --------------------------------------------------------------- schedules
@pytest.mark.parametrize("name", ["cosine", "linear"])
def test_schedules_match_jax(ref, name):
    if name == "cosine":
        j = ref.optim.cosine_with_warmup(3e-3, 5, 30, min_ratio=0.2)
        t = cosine_with_warmup(3e-3, 5, 30, min_ratio=0.2)
    else:
        j = ref.optim.linear_warmup_constant(1e-3, 7)
        t = linear_warmup_constant(1e-3, 7)
    for s in range(0, 40):
        np.testing.assert_allclose(
            float(t(torch.tensor(s, dtype=torch.int32))),
            float(j(ref.jnp.int32(s))), rtol=1e-6, atol=1e-9)


# -------------------------------------------------------------------- loss
@pytest.mark.parametrize("z_loss", [0.0, 1e-3])
@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_jax(ref, masked, z_loss):
    from repro.train.losses import cross_entropy as j_ce
    rng = np.random.default_rng(2)
    logits = (3 * rng.standard_normal((3, 7, 33))).astype(np.float32)
    labels = rng.integers(0, 33, (3, 7)).astype(np.int32)
    labels[0, :4] = logits[0, :4].argmax(-1)      # some hits for accuracy
    mask = (rng.random((3, 7)) < 0.6).astype(np.float32) if masked else None
    jl, jm = j_ce(ref.jnp.asarray(logits), ref.jnp.asarray(labels),
                  None if mask is None else ref.jnp.asarray(mask),
                  z_loss=z_loss)
    tl, tm = cross_entropy(_t(logits), _t(labels),
                           None if mask is None else _t(mask), z_loss=z_loss)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(tm["accuracy"]), float(jm["accuracy"]),
                               rtol=1e-6, atol=1e-6)


# -------------------------------------------------------------------- data
@pytest.mark.parametrize("cfg,step,rows", [
    (dict(vocab_size=512, global_batch=4, seq_len=32), 0, None),
    (dict(vocab_size=128256, global_batch=8, seq_len=64, seed=3), 17, (2, 6)),
    (dict(vocab_size=1000, global_batch=2, seq_len=5, seed=9), 2 ** 40, None),
])
def test_batch_at_matches_jax_bit_for_bit(ref, cfg, step, rows):
    want = ref.data.batch_at(ref.data.DataConfig(**cfg), step, rows)
    got = batch_at(DataConfig(**cfg), step, rows)
    assert set(got) == set(want) == {"tokens", "labels"}
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


# --------------------------------------------------------- auto train step
@pytest.fixture(scope="module")
def smoke_f32(ref):
    """The reference's float32 smoke llama3.2 (seed 0), its params as numpy,
    and one batch."""
    jcfg = ref.models.get_config(ARCH, "smoke").with_(dtype="float32")
    jp = ref.models.init_params(jcfg, ref.jax.random.PRNGKey(0))
    np_params = ref.jax.tree.map(np.asarray, jp)
    batch = batch_at(DataConfig(vocab_size=jcfg.vocab_size, global_batch=B,
                                seq_len=S), 0)
    return jcfg, jp, np_params, batch


def _leaf_close(got: torch.Tensor, want: np.ndarray, rel: float, name: str):
    scale = float(np.abs(want).max())
    err = float(np.abs(got.detach().numpy() - want).max())
    assert err <= rel * scale, (name, err, scale)


def test_auto_step_matches_jax(ref, smoke_f32):
    """Loss, every gradient, the step's grad_norm and loss, and the AdamW
    moments after the step, on the same weights and batch."""
    jcfg, jp, np_params, batch = smoke_f32
    jax, jnp = ref.jax, ref.jnp
    jtc = ref.train.TrainConfig(model=jcfg, z_loss=1e-4,
                                optimizer=ref.optim.AdamWConfig(lr=LR))
    tc = TrainConfig(model=_f32cfg(), z_loss=1e-4,
                     optimizer=AdamWConfig(lr=LR))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: _t(v) for k, v in batch.items()}
    (jloss, _), jg = jax.value_and_grad(ref.train.make_loss_fn(jtc),
                                        has_aux=True)(jp, jb)
    params = params_from_reference(np_params, tc.model, device="cpu")
    (tloss, _), tg = value_and_grad(make_loss_fn(tc), params, tb)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    want = dict(params_from_reference(jax.tree.map(np.asarray, jg), tc.model,
                                      device="cpu").named_parameters())
    assert set(tg) == set(want)
    for name, g in tg.items():
        _leaf_close(g, want[name].detach().numpy(), 1e-4, name)

    jopt = ref.optim.init(jp, jtc.optimizer)
    _, jopt, jm = jax.jit(ref.train.make_train_step(jtc))(jp, jopt, jb)
    step = make_train_step(tc)
    _, topt, tm = step(params, adamw_init(params, tc.optimizer), tb)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-4)
    conv = opt_state_from_reference(jax.tree.map(np.asarray, jopt), tc.model,
                                    device="cpu")
    assert int(conv.step) == int(topt.step) == 1
    for name in tg:
        for got, want_m in ((topt.m[name], conv.m[name]),
                            (topt.v[name], conv.v[name])):
            _leaf_close(got, want_m.numpy(), 1e-4, name)


def test_chunked_route_step_matches_jax(ref, smoke_f32, monkeypatch):
    """The float32 smoke llama with ``attn_chunk_threshold`` and
    ``attn_chunk`` lowered so that its S = 16 sequence takes
    ``chunked_attention``: the port's loss and gradients, through the flash
    autograd Function and its plain backward on the CPU, against
    ``jax.grad`` of the reference's loss through its jnp recurrence, to the
    auto step's tolerances."""
    # the module, which the package's ``flash_attention`` function shadows
    tflash = importlib.import_module("repro_torch.kernels.flash_attention")
    jcfg, jp, np_params, batch = smoke_f32
    over = dict(attn_chunk_threshold=S, attn_chunk=S // 2)
    jtc = ref.train.TrainConfig(model=jcfg.with_(**over), z_loss=1e-4)
    tc = TrainConfig(model=_f32cfg().with_(**over), z_loss=1e-4)
    jb = {k: ref.jnp.asarray(v) for k, v in batch.items()}
    (jloss, _), jg = ref.jax.value_and_grad(ref.train.make_loss_fn(jtc),
                                            has_aux=True)(jp, jb)
    backward_calls = []
    plain = tflash.flash_attention_bwd_ref
    monkeypatch.setattr(tflash, "flash_attention_bwd_ref",
                        lambda *a, **k: backward_calls.append(1) or plain(
                            *a, **k))
    params = params_from_reference(np_params, tc.model, device="cpu")
    (tloss, _), tg = value_and_grad(make_loss_fn(tc), params,
                                    {k: _t(v) for k, v in batch.items()})
    assert len(backward_calls) == tc.model.num_layers
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    want = dict(params_from_reference(ref.jax.tree.map(np.asarray, jg),
                                      tc.model, device="cpu")
                .named_parameters())
    assert set(tg) == set(want)
    for name, g in tg.items():
        _leaf_close(g, want[name].detach().numpy(), 1e-4, name)


def test_microbatched_step_matches_full_batch(smoke_f32):
    """k microbatches must produce the same update as one full batch
    (``test_trainer_integration.py:59``, its tolerances)."""
    _, _, np_params, batch = smoke_f32
    cfg = _f32cfg()
    oc = AdamWConfig(lr=LR)
    p1 = params_from_reference(np_params, cfg, device="cpu")
    p4 = copy.deepcopy(p1)
    tb = {k: _t(v) for k, v in batch.items()}
    _, _, m1 = make_train_step(TrainConfig(model=cfg, optimizer=oc))(
        p1, adamw_init(p1, oc), tb)
    _, _, m4 = make_train_step(TrainConfig(model=cfg, optimizer=oc,
                                           microbatches=4))(
        p4, adamw_init(p4, oc), tb)
    np.testing.assert_allclose(float(m1["loss"]), float(m4["loss"]),
                               rtol=1e-5)
    for (n, a), b in zip(p1.named_parameters(), p4.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=1e-3, atol=1e-4, err_msg=n)


# ------------------------------------------------- canary_fp on 4 ranks
JAX_STEP_SCRIPT = r"""
import json, sys
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from repro.core.collective import canary_allreduce_tree
from repro.data import DataConfig, batch_at
from repro.models import get_config, init_params
from repro.optim import AdamWConfig, init as adamw_init
from repro.train import TrainConfig, make_loss_fn, make_train_step

d, C = sys.argv[1], json.loads(sys.argv[2])
cfg = get_config(C["arch"], "smoke").with_(dtype="float32")
tc = TrainConfig(model=cfg, optimizer=AdamWConfig(lr=C["lr"]),
                 grad_sync="canary_fp")
mesh = jax.make_mesh((C["dp"],), ("data",),
                     axis_types=(jax.sharding.AxisType.Auto,))
params = init_params(cfg, jax.random.PRNGKey(0))
batch = {k: jnp.asarray(v) for k, v in batch_at(
    DataConfig(cfg.vocab_size, C["B"], C["S"]), 0).items()}
loss_fn = make_loss_fn(tc, constrain="none")

def synced_fn(p, b):    # train_step.py:139-151 up to the division by dp
    (_, _), g = jax.value_and_grad(loss_fn, has_aux=True)(p, b)
    return canary_allreduce_tree(g, axis_name="data", axis_size=C["dp"],
                                 num_blocks=tc.canary_blocks,
                                 fixed_point=True)

synced = jax.jit(jax.shard_map(synced_fn, mesh=mesh,
                               in_specs=(P(), P("data")), out_specs=P(),
                               check_vma=False))(params, batch)
_, _, m = jax.jit(make_train_step(tc, mesh=mesh))(
    params, adamw_init(params, tc.optimizer), batch)
leaves = jax.tree_util.tree_leaves(synced)
np.savez(d + "/jax_step.npz", loss=np.asarray(m["loss"]),
         grad_norm=np.asarray(m["grad_norm"]),
         **{f"g{i}": np.asarray(a) for i, a in enumerate(leaves)})
print("JAX_OK")
"""


def _train_rank(rank: int, init_file: str, np_params, out_dir: str):
    """One gloo rank: a canary_fp step on this rank's slice, then a trainer
    whose oracle re-plans its roots under a modelled hot link."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=DP, rank=rank,
                            timeout=datetime.timedelta(seconds=120))
    try:
        mesh = make_mesh()
        tc = TrainConfig(model=_f32cfg(), optimizer=AdamWConfig(lr=LR),
                         grad_sync="canary_fp")
        params = params_from_reference(np_params, tc.model, device="cpu")
        rows = mesh.batch_slice(B)
        batch = {k: _t(v) for k, v in batch_at(
            DataConfig(tc.model.vocab_size, B, S), 0, rows).items()}
        seen = {}
        step = make_train_step(tc, mesh, on_sync=lambda raw, synced:
                               seen.update(_copies(synced)))
        _, _, m = step(params, adamw_init(params, tc.optimizer), batch)
        out = {f"grad.{k}": v.numpy() for k, v in seen.items()}
        out.update(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]))

        mesh22 = make_mesh(outer_size=2)        # every rank, same order
        for mode in ("auto", "canary", "ring", "hierarchical"):
            tcm = dataclasses.replace(tc, grad_sync=mode)
            p = params_from_reference(np_params, tc.model, device="cpu")
            synced = {}
            step = make_train_step(
                tcm, mesh22 if mode == "hierarchical" else mesh,
                on_sync=lambda raw, s: synced.update(_copies(s)))
            _, _, m = step(p, adamw_init(p, tc.optimizer), batch)
            out[f"{mode}.loss"] = float(m["loss"])
            out[f"{mode}.grad_norm"] = float(m["grad_norm"])
            out.update({f"{mode}.grad.{k}": v.numpy()
                        for k, v in synced.items()})

        cfg = get_config(ARCH, "smoke")
        t = Trainer(TrainerConfig(
            train=dataclasses.replace(tc, model=cfg, canary_blocks=8),
            data=DataConfig(cfg.vocab_size, B, S), steps=6, log_every=0,
            replan_every=3), mesh=mesh, device="cpu")
        before = t.tc.canary_roots
        t.oracle.external_load = np.where(np.arange(DP) < 2, 1000.0, 0.0)
        hist = t.run()
        roots = [None] * DP
        dist.all_gather_object(roots, t.tc.canary_roots)
        out.update(roots_before=np.array(before), roots_after=np.array(
            t.tc.canary_roots), roots_planned=np.array(t.oracle.plan()),
            roots_all=np.array(roots), oracle_steps=len(t.oracle._history),
            trainer_losses=np.array([h["loss"] for h in hist]))
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def canary_fp_step(smoke_f32, tmp_path_factory):
    """JAX's step on 4 host devices (subprocess) and the port's on 4 gloo
    ranks, run side by side: ``(jax results, [per-rank port results])``."""
    jcfg, jp, np_params, _ = smoke_f32
    d = tmp_path_factory.mktemp("canary_fp")
    env = dict(os.environ,
               XLA_FLAGS=f"--xla_force_host_platform_device_count={DP}",
               JAX_PLATFORMS="cpu",
               PYTHONPATH="src" + os.pathsep + os.environ.get("PYTHONPATH",
                                                              ""))
    proc = subprocess.Popen(
        [sys.executable, "-c", JAX_STEP_SCRIPT, str(d),
         json.dumps(dict(arch=ARCH, lr=LR, dp=DP, B=B, S=S))],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        mp.spawn(_train_rank, args=(str(d / "rendezvous"), np_params, str(d)),
                 nprocs=DP, join=True)
        out, err = proc.communicate(timeout=600)
    finally:
        proc.kill()
    assert "JAX_OK" in out, out + "\n" + err
    return (dict(np.load(d / "jax_step.npz")),
            [dict(np.load(d / f"rank{r}.npz")) for r in range(DP)])


def test_canary_fp_step_matches_jax_on_4_ranks(ref, smoke_f32,
                                               canary_fp_step):
    jcfg, jp, _, _ = smoke_f32
    jax_out, ranks = canary_fp_step
    np.testing.assert_allclose(ranks[0]["loss"], jax_out["loss"], rtol=1e-5)
    np.testing.assert_allclose(ranks[0]["grad_norm"], jax_out["grad_norm"],
                               rtol=1e-4)
    treedef = ref.jax.tree_util.tree_structure(jp)
    leaves = [jax_out[f"g{i}"] for i in range(treedef.num_leaves)]
    want = dict(params_from_reference(
        ref.jax.tree_util.tree_unflatten(treedef, leaves), _f32cfg(),
        device="cpu").named_parameters())
    got = {k[len("grad."):]: v for k, v in ranks[0].items()
           if k.startswith("grad.")}
    assert set(got) == set(want) and len(got) == 2 * 9 + 2
    for name, g in got.items():
        _leaf_close(torch.from_numpy(g), want[name].detach().numpy(), 1e-4,
                    name)


@pytest.mark.parametrize("mode", ["auto", "canary", "ring",
                                  "hierarchical"])
def test_grad_sync_modes_agree_on_4_ranks(canary_fp_step, mode):
    """Every mode averages the same gradients: the step's loss and norm
    agree with ``canary_fp``'s, and each explicit mode's synced gradients
    (hierarchical on a 2 x 2 mesh) within 1e-5 of each leaf's max."""
    _, ranks = canary_fp_step
    r0 = ranks[0]
    np.testing.assert_allclose(r0[f"{mode}.loss"], r0["loss"], rtol=1e-6)
    np.testing.assert_allclose(r0[f"{mode}.grad_norm"], r0["grad_norm"],
                               rtol=1e-5)
    if mode == "auto":
        return
    for k, want in r0.items():
        if k.startswith("grad."):
            _leaf_close(torch.from_numpy(r0[f"{mode}.{k}"]), want, 1e-5, k)


def test_canary_fp_ranks_agree_bit_for_bit(canary_fp_step):
    """Integer sums: every rank holds the same synced gradients."""
    _, ranks = canary_fp_step
    for r in ranks[1:]:
        for k, v in ranks[0].items():
            if k.startswith("grad."):
                np.testing.assert_array_equal(r[k], v, err_msg=k)


def test_trainer_replan_adopts_new_roots(canary_fp_step):
    """The oracle sees every step; at step 3 the trainer re-plans away from
    the hot links and every rank adopts the same new roots."""
    _, ranks = canary_fp_step
    r0 = ranks[0]
    assert int(r0["oracle_steps"]) == 6
    assert np.isfinite(r0["trainer_losses"]).all()
    assert not np.array_equal(r0["roots_before"], r0["roots_after"])
    np.testing.assert_array_equal(r0["roots_after"], r0["roots_planned"])
    for r in ranks:
        np.testing.assert_array_equal(r["roots_all"],
                                      np.stack([r0["roots_after"]] * DP))


# ---------------------------- canary_fp sync: one scale a reference leaf
FP_SYNC_SCRIPT = r"""
import json, sys
import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as P

from repro.core.collective import canary_allreduce_tree, round_robin_roots
from repro.core.collective.api import _leaf_allreduce
from repro.kernels.fixedpoint import quantize
from repro.kernels.ops import fixed_point_scale

d, C = sys.argv[1], json.loads(sys.argv[2])
dp, blocks = C["dp"], C["blocks"]
mesh = jax.make_mesh((dp,), ("data",),
                     axis_types=(jax.sharding.AxisType.Auto,))
roots = round_robin_roots(blocks, dp)
for dtype in C["dtypes"]:
    ranks = [np.load(f"{d}/grads_{dtype}_rank{r}.npz") for r in range(dp)]
    dtypes = [str(t) for t in ranks[0]["dtypes"]]
    stacked = [jnp.asarray(np.stack([r[f"g{i}"] for r in ranks]), t)
               for i, t in enumerate(dtypes)]
    n = len(stacked)

    def sums(x):    # api.py:74-86's fixed-point path up to the dequantize
        gmax = lax.pmax(jnp.max(jnp.abs(x.astype(jnp.float32))), "data")
        scale = fixed_point_scale(gmax, bits=24, world=dp)
        return _leaf_allreduce(quantize(x, scale), "data", dp, roots,
                               "canary", None)

    def both(*leaves):
        leaves = [x[0] for x in leaves]
        synced = canary_allreduce_tree(leaves, axis_name="data",
                                       axis_size=dp, num_blocks=blocks,
                                       fixed_point=True)
        return [sums(x) for x in leaves], synced

    specs = tuple(P("data") for _ in range(n))
    q, y = jax.jit(jax.shard_map(both, mesh=mesh, in_specs=specs,
                                 out_specs=P(), check_vma=False))(*stacked)
    np.savez(f"{d}/jax_{dtype}.npz",
             **{f"q{i}": np.asarray(a) for i, a in enumerate(q)},
             ydtypes=np.array([str(a.dtype) for a in y]),
             **{f"y{i}": np.asarray(a, np.float32) for i, a in enumerate(y)})
print("JAX_OK")
"""
FP_DTYPES = ("float32", "bfloat16")
FP_BLOCKS = 16


def _fp_sync_rank(rank: int, init_file: str, out_dir: str):
    """One gloo rank: this rank's (JAX) gradients through the port's
    ``canary_fp`` sync with the reference-leaf groups, counting every
    all-reduce; and the int32 sums from the same scales."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=DP, rank=rank,
                            timeout=datetime.timedelta(seconds=120))
    calls = []
    real = dist.all_reduce

    def counting(tensor, op=dist.ReduceOp.SUM, group=None, async_op=False):
        calls.append(str(op))
        return real(tensor, op=op, group=group, async_op=async_op)
    try:
        out = {}
        for dtype in FP_DTYPES:
            leaves = reference_leaves(_f32cfg())
            data = np.load(os.path.join(out_dir,
                                        f"grads_{dtype}_rank{rank}.npz"))
            grads = {}
            for i, leaf in enumerate(leaves):
                a = torch.from_numpy(data[f"g{i}"]).to(
                    getattr(torch, str(data["dtypes"][i])))
                parts = a.unbind() if leaf.stacked else [a]
                grads.update(zip(leaf.names, parts))
            groups = [leaf.names for leaf in leaves]
            W = dist.group.WORLD
            dist.all_reduce = counting
            calls.clear()
            try:
                synced = canary_allreduce_tree(  # a dict it empties
                    dict(grads), group=W, axis_size=DP, num_blocks=FP_BLOCKS,
                    fixed_point=True, groups=groups)
            finally:
                dist.all_reduce = real
            out[f"{dtype}.all_reduce_calls"] = np.array(calls)
            scales = fixed_point_scales(grads, [W], bits=24, world=DP,
                                        groups=groups)
            roots = round_robin_roots(FP_BLOCKS, DP)
            for (name, g), sc in zip(grads.items(), scales):
                out[f"{dtype}.q.{name}"] = multi_root_tree_allreduce(
                    quantize(g, sc), W, DP, roots).numpy()
                y = synced[name]
                out[f"{dtype}.y.{name}"] = y.float().numpy()
                out[f"{dtype}.ydtype.{name}"] = np.array(str(y.dtype))
        np.savez(os.path.join(out_dir, f"port_rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def fp_sync(ref, smoke_f32, tmp_path_factory):
    """Each rank's JAX gradients of the smoke llama (its slice of the batch;
    float32, and the bf16 model's), synced by JAX on 4 host devices
    (subprocess) and by the port on 4 gloo ranks side by side:
    ``(raw gradients by dtype, jax results, [port results by rank])``."""
    jcfg, jp, _, batch = smoke_f32
    d = tmp_path_factory.mktemp("fp_sync")
    raw = {}
    for dtype in FP_DTYPES:
        cfg = jcfg.with_(dtype=dtype)
        params = ref.models.init_params(cfg, ref.jax.random.PRNGKey(0))
        loss_fn = ref.train.make_loss_fn(ref.train.TrainConfig(model=cfg))
        grad = ref.jax.jit(ref.jax.grad(lambda p, b: loss_fn(p, b)[0]))
        per = B // DP
        raw[dtype] = []
        for r in range(DP):
            rows = {k: ref.jnp.asarray(v[r * per:(r + 1) * per])
                    for k, v in batch.items()}
            leaves = ref.jax.tree_util.tree_leaves(grad(params, rows))
            as_f32 = [np.asarray(a, np.float32) for a in leaves]  # exact
            raw[dtype].append(as_f32)
            np.savez(d / f"grads_{dtype}_rank{r}.npz",
                     dtypes=np.array([str(a.dtype) for a in leaves]),
                     **{f"g{i}": a for i, a in enumerate(as_f32)})
    env = dict(os.environ,
               XLA_FLAGS=f"--xla_force_host_platform_device_count={DP}",
               JAX_PLATFORMS="cpu",
               PYTHONPATH="src" + os.pathsep + os.environ.get("PYTHONPATH",
                                                              ""))
    proc = subprocess.Popen(
        [sys.executable, "-c", FP_SYNC_SCRIPT, str(d),
         json.dumps(dict(dp=DP, blocks=FP_BLOCKS, dtypes=FP_DTYPES))],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        mp.spawn(_fp_sync_rank, args=(str(d / "rendezvous"), str(d)),
                 nprocs=DP, join=True)
        out, err = proc.communicate(timeout=600)
    finally:
        proc.kill()
    assert "JAX_OK" in out, out + "\n" + err
    return (raw, {t: dict(np.load(d / f"jax_{t}.npz")) for t in FP_DTYPES},
            [dict(np.load(d / f"port_rank{r}.npz")) for r in range(DP)])


@pytest.mark.parametrize("dtype", FP_DTYPES)
@pytest.mark.parametrize("what", ["int32 sums", "synced"])
def test_canary_fp_sync_matches_jax_bit_for_bit(fp_sync, dtype, what):
    """The same (JAX) gradients through both syncs: every rank's int32 sums
    and synced gradients equal the reference's, bit for bit, leaf by
    reference leaf; the port's scale is one a stacked leaf, not one a
    layer (at least one stacked leaf has a layer whose own max is below
    the leaf's, so a scale a layer would differ)."""
    raw, jax_out, ranks = fp_sync
    leaves = reference_leaves(_f32cfg())
    key = "q" if what == "int32 sums" else "y"
    narrower = 0
    for i, leaf in enumerate(leaves):
        want = jax_out[dtype][f"{key}{i}"]
        if leaf.stacked:
            layer_max = np.abs(np.stack([r[i] for r in raw[dtype]])).max(
                axis=tuple(a for a in range(want.ndim + 1) if a != 1))
            narrower += bool((layer_max < layer_max.max()).any())
        for rank in ranks:
            parts = [rank[f"{dtype}.{key}.{n}"] for n in leaf.names]
            got = np.stack(parts) if leaf.stacked else parts[0]
            if key == "q":
                assert got.dtype == np.int32
            else:   # the values as float32 (exact), beside their dtype
                ydtype = str(jax_out[dtype]["ydtypes"][i])
                assert {str(rank[f"{dtype}.ydtype.{n}"])
                        for n in leaf.names} == {f"torch.{ydtype}"}
            np.testing.assert_array_equal(got, want, err_msg=str(leaf.path))
    assert narrower > 0


def test_fixed_point_scales_one_a_group():
    """One scale a group, from the max |x| over its tensors (each tensor
    its own group without groups), the same bits as ``fixed_point_scale``
    of that max; groups that do not partition the keys are refused."""
    g = {"a": torch.tensor([1.0, -4.0]), "b": torch.tensor([2.0]),
         "c": torch.tensor([-0.5], dtype=torch.bfloat16)}

    def want(m):
        return fixed_point_scale(torch.tensor(m), bits=24, world=4)
    got = fixed_point_scales(g, [], bits=24, world=4,
                             groups=[["a", "b"], ["c"]])
    for s, m in zip(got, (4.0, 4.0, 0.5)):
        assert s.dtype == torch.float32 and torch.equal(s, want(m))
    alone = fixed_point_scales(g, [], bits=24, world=4)
    for s, m in zip(alone, (4.0, 2.0, 0.5)):
        assert torch.equal(s, want(m))
    for bad in ([["a"], ["b"]], [["a", "b"], ["b", "c"]],
                [["a", "b", "c"], []]):
        with pytest.raises(ValueError, match="partition"):
            fixed_point_scales(g, [], bits=24, world=4, groups=bad)


def test_canary_fp_sync_makes_one_max_all_reduce(fp_sync):
    """One ``all_reduce(MAX)`` for the whole sync (the vector of the 11
    leaves' maxima), where a scale a tensor made one a tensor."""
    _, _, ranks = fp_sync
    for rank in ranks:
        for dtype in FP_DTYPES:
            assert list(rank[f"{dtype}.all_reduce_calls"]) == [
                str(dist.ReduceOp.MAX)]


# ------------------------------------------------- trainer and checkpoint
def _trainer(steps=6, ckpt=None, every=0):
    cfg = get_config(ARCH, "smoke")
    tc = TrainConfig(model=cfg, optimizer=AdamWConfig(lr=1e-3))
    data = DataConfig(vocab_size=cfg.vocab_size, global_batch=4, seq_len=32)
    return Trainer(TrainerConfig(train=tc, data=data, steps=steps,
                                 log_every=0, checkpoint_dir=ckpt,
                                 checkpoint_every=every), device="cpu")


def test_trainer_runs_8_steps():
    hist = _trainer(steps=8).run()
    assert [h["step"] for h in hist] == list(range(8))
    assert all(np.isfinite(h["loss"]) for h in hist)


def test_checkpoint_resume_exact(tmp_path):
    """Deterministic data + checkpointing => resumed run matches unbroken
    (``test_trainer_integration.py:34``, its tolerances)."""
    d = str(tmp_path / "ck")
    h1 = _trainer(steps=6, ckpt=d, every=3).run()
    assert latest_step(d) == 6
    t2 = _trainer(steps=6)
    _, _, step = restore_checkpoint(d, 3, t2.params, t2.opt_state)
    assert step == 3 and int(t2.opt_state.step) == 3
    losses = []
    for s in range(3, 6):
        t2.params, t2.opt_state, m = t2.step_fn(t2.params, t2.opt_state,
                                                t2.make_batch(s))
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, [h["loss"] for h in h1[3:6]],
                               rtol=1e-4, atol=1e-5)


def test_checkpoint_roundtrip_and_mismatch(tmp_path):
    """bf16 leaves come back bit for bit; a target of another shape or
    another set of leaves is refused."""
    t = _trainer(steps=1)
    t.run()
    save_checkpoint(str(tmp_path), 1, t.params, t.opt_state)
    u = _trainer(steps=1)
    restore_checkpoint(str(tmp_path), 1, u.params, u.opt_state)
    for a, b in zip(t.params.parameters(), u.params.parameters()):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for k in t.opt_state.m:
        assert torch.equal(t.opt_state.v[k], u.opt_state.v[k])
    other = Trainer(TrainerConfig(
        train=TrainConfig(model=get_config(ARCH, "smoke").with_(d_ff=256)),
        data=DataConfig(512, 4, 32), steps=1), device="cpu")
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(str(tmp_path), 1, other.params, other.opt_state)
    with pytest.raises(ValueError, match="leaves"):
        restore_checkpoint(str(tmp_path), 1, u.params)


def test_launch_train_canary_fp_on_2_cpu_ranks(tmp_path):
    out = tmp_path / "history.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
         "--device", "cpu", "--data-parallel", "2", "--grad-sync",
         "canary_fp", "--steps", "3", "--batch", "4", "--seq", "16",
         "--log-every", "1", "--history-out", str(out)],
        env=dict(os.environ, PYTHONPATH="src" + os.pathsep
                 + os.environ.get("PYTHONPATH", "")),
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "2 data-parallel ranks on cpu" in proc.stdout
    hist = json.loads(out.read_text())
    assert len(hist) == 3 and all(np.isfinite(h["loss"]) for h in hist)


@pytest.mark.parametrize("data,model,cards", [(2, 1, 1), (1, 4, 2)])
def test_launch_train_refuses_more_ranks_than_cards(data, model, cards,
                                                    monkeypatch):
    """``--device cuda`` with more ranks than the machine has cards raises,
    naming both numbers, before any rank is spawned (a rank would die in
    ``torch.cuda.set_device``); the count is patched, so no card is
    needed."""
    from repro_torch.launch import train as lt

    def spawned(*a, **k):
        raise AssertionError("a rank was spawned")
    monkeypatch.setattr(lt, "resolve_device", torch.device)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(lt.mp, "spawn", spawned)
    world = data * model
    with pytest.raises(ValueError, match=rf"^{world} ranks .* need {world} "
                                         rf"cards, this machine has {cards}$"):
        lt.main(["--arch", ARCH, "--device", "cuda", "--data-parallel",
                 str(data), "--model-parallel", str(model)])
