"""The port's encoder-decoder (whisper-smoke) against the JAX package's.

Weights come from JAX's ``init_params``, as numpy, through
``repro_torch.convert.params_from_reference``; tokens and frames are seeded
numpy arrays. The same inputs go through both packages on the CPU: the
encoder, the cross K/V cache, the forward with frames, decode steps against
the cross cache, ``Engine.generate``, an ``auto`` training step, and on 4
gloo ranks beside JAX on 4 host devices the ``canary_fp`` sync of
whisper-smoke gradients (int32 sums and synced values bit for bit) and one
step in every ``grad_sync`` mode.

Tolerances: logits and activations at float32 within 1e-4, at bfloat16
within 2e-2 of their largest magnitude (``tests/test_torch_models.py``'s
bounds); the training step at ``test_torch_train.py``'s (loss 1e-5
relative, each gradient and moment within 1e-4 of its leaf's max |x|). JAX
is imported inside the ``ref`` fixture, so the spawned ranks, which import
this module, do not load it.
"""
import datetime
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
from repro_torch.convert import (opt_state_from_reference,  # noqa: E402
                                 params_from_reference, reference_leaves)
from repro_torch.core.collective import (canary_allreduce_tree,  # noqa: E402
                                         fixed_point_scales,
                                         multi_root_tree_allreduce,
                                         round_robin_roots)
from repro_torch.kernels import quantize  # noqa: E402
from repro_torch.models import (decode_step, encode, forward,  # noqa: E402
                                get_config, init_cache, prepare_cross_cache)
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.optim import init as adamw_init  # noqa: E402
from repro_torch.serving import Engine, ServeConfig  # noqa: E402
from repro_torch.train import (TrainConfig, make_loss_fn,  # noqa: E402
                               make_mesh, make_train_step, value_and_grad)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "whisper-large-v3"
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
DTYPES = ("float32", "bfloat16")
DP, B, S, LR, BLOCKS = 4, 8, 12, 1e-3, 16
MODES = ("auto", "canary", "ring", "hierarchical", "canary_fp")


@pytest.fixture(scope="module")
def ref():
    """The reference's modules (JAX on the CPU)."""
    import jax
    import jax.numpy as jnp

    from repro import models, optim, serving, train
    from repro.models import transformer
    return SimpleNamespace(
        jax=jax, jnp=jnp, models=models, optim=optim, serving=serving,
        train=train, encode=transformer.encode,
        decode_step=jax.jit(models.decode_step, static_argnums=3))


def _cfg(dtype="float32"):
    return get_config(ARCH, "smoke").with_(dtype=dtype)


@pytest.fixture(scope="module")
def models(ref):
    """``{dtype: (reference cfg, JAX params, port cfg, port params)}``."""
    out = {}
    for dtype in DTYPES:
        jcfg = ref.models.get_config(ARCH, "smoke").with_(dtype=dtype)
        jp = ref.models.init_params(jcfg, ref.jax.random.PRNGKey(0))
        tcfg = _cfg(dtype)
        out[dtype] = (jcfg, jp, tcfg, params_from_reference(
            ref.jax.tree.map(np.asarray, jp), tcfg, device="cpu"))
    return out


def _frames(cfg, batch, seed=3):
    """(batch, encoder_seq, d_model) float32 stub frames, std 0.02."""
    return (np.random.default_rng(seed).normal(
        size=(batch, cfg.encoder_seq, cfg.d_model)) * 0.02).astype(np.float32)


def _tokens(cfg, batch, length, seed=7):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (batch, length)).astype(np.int32)


def _both(ref, a, dtype):
    """``a`` as a JAX array and a torch tensor of ``dtype``."""
    return (ref.jnp.asarray(a, ref.jnp.dtype(dtype)),
            torch.from_numpy(a).to(getattr(torch, dtype)))


def _close(got, want, dtype):
    """float32: elementwise within 1e-4; bfloat16: the largest difference
    within 2e-2 of the largest magnitude (``test_torch_models._close``)."""
    got = np.asarray(got.float())
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=TOL[dtype],
                                   atol=TOL[dtype])
        return
    assert np.isfinite(got).all()
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= TOL[dtype] * scale, (err, scale)


# ------------------------------------------------------------ the model
@pytest.mark.parametrize("dtype", DTYPES)
def test_encode_matches_jax(ref, models, dtype):
    jcfg, jp, tcfg, tp = models[dtype]
    jf, tf = _both(ref, _frames(tcfg, 2), dtype)
    with torch.inference_mode():
        got = encode(tp, tf, tcfg)
    assert got.dtype == tf.dtype
    _close(got, ref.encode(jp, jf, jcfg), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_prepare_cross_cache_matches_jax(ref, models, dtype):
    """Each decoder layer's cross K and V, (B, T, KV, hd), against the
    reference's stacked (n_per, B, T, KV, hd) entry."""
    jcfg, jp, tcfg, tp = models[dtype]
    jf, tf = _both(ref, _frames(tcfg, 2), dtype)
    want = ref.models.prepare_cross_cache(jp, jf, jcfg)
    with torch.inference_mode():
        got = prepare_cross_cache(tp, tf, tcfg)
    assert len(got) == tcfg.num_layers
    for i, layer in enumerate(got):
        for k in ("k", "v"):
            assert layer[k].dtype == tf.dtype
            _close(layer[k], want[k][i], dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_with_frames_matches_jax(ref, models, dtype):
    jcfg, jp, tcfg, tp = models[dtype]
    jf, tf = _both(ref, _frames(tcfg, 2), dtype)
    toks = _tokens(tcfg, 2, S)
    want, _ = ref.models.forward(jp, ref.jnp.asarray(toks), jcfg, frames=jf)
    with torch.inference_mode():
        got, aux = forward(tp, torch.from_numpy(toks), tcfg, frames=tf)
    assert tuple(got.shape) == (2, S, tcfg.vocab_size)
    assert float(aux) == 0.0
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_steps_with_cross_cache_match_jax(ref, models, dtype):
    """Eight greedy decode steps against the encoder's cross K/V, fed the
    reference's tokens: the same logits, and at float32 the same argmax."""
    jcfg, jp, tcfg, tp = models[dtype]
    jf, tf = _both(ref, _frames(tcfg, 2), dtype)
    jcache = ref.models.init_cache(jcfg, 2, max_len=16)
    jcache["cross"] = ref.models.prepare_cross_cache(jp, jf, jcfg)
    tcache = init_cache(tcfg, 2, max_len=16, device="cpu")
    with torch.inference_mode():
        tcache["cross"] = prepare_cross_cache(tp, tf, tcfg)
    jtok = ref.jnp.asarray(_tokens(tcfg, 2, 1))
    for _ in range(8):
        want, jcache = ref.decode_step(jp, jcache, jtok, jcfg)
        with torch.inference_mode():
            got, tcache = decode_step(tp, tcache,
                                      torch.from_numpy(np.array(jtok)), tcfg)
        _close(got, want, dtype)
        jtok = ref.jnp.argmax(want[:, -1:], axis=-1).astype(ref.jnp.int32)
        if dtype == "float32":
            np.testing.assert_array_equal(
                torch.argmax(got[:, -1:], dim=-1).numpy(), np.asarray(jtok))
    assert tcache["pos"] == int(jcache["pos"]) == 8


def test_init_cache_holds_the_cross_cache(ref):
    cfg, jcfg = _cfg(), ref.models.get_config(ARCH, "smoke")
    cache = init_cache(cfg, 3, max_len=8, device="cpu")
    want = ref.models.init_cache(jcfg, 3, max_len=8)["cross"]
    assert len(cache["cross"]) == cfg.num_layers
    for layer in cache["cross"]:
        for k in ("k", "v"):
            assert tuple(layer[k].shape) == want[k].shape[1:]
            assert not layer[k].any()


def test_engine_generate_matches_jax(ref, models):
    """float32 greedy generation for 2 requests: the same tokens."""
    jcfg, jp, tcfg, tp = models["float32"]
    frames = _frames(tcfg, 2)
    prompts = _tokens(tcfg, 2, 4)
    jeng = ref.serving.Engine(ref.serving.ServeConfig(jcfg, 2, 16), params=jp)
    want, _ = jeng.generate(ref.jnp.asarray(prompts), 6,
                            frames=ref.jnp.asarray(frames))
    teng = Engine(ServeConfig(tcfg, 2, 16), params=tp, device="cpu")
    got, _ = teng.generate(torch.from_numpy(prompts), 6,
                           frames=torch.from_numpy(frames))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert teng.cache["pos"] == int(jeng.cache["pos"]) == 4 + 5


def test_missing_frames_raise(models):
    _, _, tcfg, tp = models["float32"]
    toks = torch.from_numpy(_tokens(tcfg, 1, 4))
    with pytest.raises(ValueError, match="frames"):
        forward(tp, toks, tcfg)
    with pytest.raises(ValueError, match="frames"):
        Engine(ServeConfig(tcfg, 1, 8), params=tp,
               device="cpu").generate(toks, 2)


# --------------------------------------------------------- training
def _batch(cfg, rows=(0, B)):
    """Rows ``[lo, hi)`` of a seeded global batch of B sequences with
    frames, as numpy."""
    toks = _tokens(cfg, B, S + 1, seed=11)
    return {"tokens": toks[rows[0]:rows[1], :-1],
            "labels": toks[rows[0]:rows[1], 1:],
            "frames": _frames(cfg, B, seed=13)[rows[0]:rows[1]]}


def _leaf_close(got: torch.Tensor, want: np.ndarray, rel: float, name: str):
    scale = float(np.abs(want).max())
    err = float(np.abs(got.detach().float().numpy() - want).max())
    assert err <= rel * scale, (name, err, scale)


def test_auto_step_matches_jax(ref, models):
    """The float32 model's loss, every gradient (the encoder's among them),
    the step's grad_norm, the AdamW moments and the updated parameters
    after one ``auto`` step, on the same weights, tokens and frames."""
    jax, jnp = ref.jax, ref.jnp
    jcfg, jp, tcfg, _ = models["float32"]
    np_params = jax.tree.map(np.asarray, jp)
    jtc = ref.train.TrainConfig(model=jcfg, z_loss=1e-4,
                                optimizer=ref.optim.AdamWConfig(lr=LR))
    tc = TrainConfig(model=tcfg, z_loss=1e-4, optimizer=AdamWConfig(lr=LR))
    batch = _batch(tcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    (jloss, _), jg = jax.value_and_grad(ref.train.make_loss_fn(jtc),
                                        has_aux=True)(jp, jb)
    params = params_from_reference(np_params, tcfg, device="cpu")
    (tloss, _), tg = value_and_grad(make_loss_fn(tc), params, tb)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    want = dict(params_from_reference(jax.tree.map(np.asarray, jg), tcfg,
                                      device="cpu").named_parameters())
    assert set(tg) == set(want)
    assert any(n.startswith("encoder.") for n in tg)
    for name, g in tg.items():
        assert float(g.abs().max()) > 0, name
        _leaf_close(g, want[name].detach().numpy(), 1e-4, name)

    jopt = ref.optim.init(jp, jtc.optimizer)
    jnew, jopt, jm = jax.jit(ref.train.make_train_step(jtc))(jp, jopt, jb)
    tnew, topt, tm = make_train_step(tc)(
        params, adamw_init(params, tc.optimizer), tb)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-4)
    conv = opt_state_from_reference(jax.tree.map(np.asarray, jopt), tcfg,
                                    device="cpu")
    new = dict(params_from_reference(jax.tree.map(np.asarray, jnew), tcfg,
                                     device="cpu").named_parameters())
    assert int(conv.step) == int(topt.step) == 1
    old = dict(params_from_reference(np_params, tcfg,
                                     device="cpu").named_parameters())
    worst = 0.0
    for name, p in tnew.named_parameters():
        for got, want_m in ((topt.m[name], conv.m[name]),
                            (topt.v[name], conv.v[name])):
            _leaf_close(got, want_m.numpy(), 1e-4, name)
        # the first step moves each weight by lr * (g / (|g| + eps) + decay):
        # where the reference's |g| is above twice the gradients' bound the
        # sign is settled and the updates agree within 1e-2 lr (near that
        # floor, eps moves g / (|g| + eps) by eps |dg| / g^2 ~ 1e-3); where it
        # is not, they differ by at most the update's range, 2 lr
        g = want[name].detach().abs()
        settled = g > 2e-4 * g.max()
        diff = ((p - old[name]) - (new[name] - old[name])).detach().abs()
        assert float(diff.max()) <= 2 * LR * (1 + 1e-3), name
        if settled.any():
            worst = max(worst, float(diff[settled].max()) / LR)
    assert worst <= 1e-2, worst


# ------------------------------------------- 4 ranks: the syncs of a step
FP_SYNC_SCRIPT = r"""
import json, sys
import numpy as np
import jax
import jax.numpy as jnp
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

    def sums(x):    # api.py's fixed-point path up to the dequantize
        gmax = jax.lax.pmax(jnp.max(jnp.abs(x.astype(jnp.float32))), "data")
        scale = fixed_point_scale(gmax, bits=24, world=dp)
        return _leaf_allreduce(quantize(x, scale), "data", dp, roots,
                               "canary", None)

    def both(*leaves):
        leaves = [x[0] for x in leaves]
        synced = canary_allreduce_tree(leaves, axis_name="data",
                                       axis_size=dp, num_blocks=blocks,
                                       fixed_point=True)
        return [sums(x) for x in leaves], synced

    specs = tuple(P("data") for _ in stacked)
    q, y = jax.jit(jax.shard_map(both, mesh=mesh, in_specs=specs,
                                 out_specs=P(), check_vma=False))(*stacked)
    np.savez(f"{d}/jax_{dtype}.npz",
             **{f"q{i}": np.asarray(a) for i, a in enumerate(q)},
             **{f"y{i}": np.asarray(a, np.float32) for i, a in enumerate(y)})
print("JAX_OK")
"""


def _rank(rank: int, init_file: str, out_dir: str, np_params) -> None:
    """One gloo rank: the reference's gradients of this rank's slice
    through the port's ``canary_fp`` sync (with the int32 sums from the
    same scales, and every all-reduce counted), then one whisper step on
    the slice in every ``grad_sync`` mode."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=DP, rank=rank,
                            timeout=datetime.timedelta(seconds=120))
    real = dist.all_reduce
    calls = []

    def counting(tensor, op=dist.ReduceOp.SUM, group=None, async_op=False):
        calls.append(str(op))
        return real(tensor, op=op, group=group, async_op=async_op)
    try:
        W, out = dist.group.WORLD, {}
        for dtype in DTYPES:
            leaves = reference_leaves(_cfg(dtype))
            data = np.load(os.path.join(out_dir,
                                        f"grads_{dtype}_rank{rank}.npz"))
            grads = {}
            for i, leaf in enumerate(leaves):
                a = torch.from_numpy(data[f"g{i}"]).to(
                    getattr(torch, str(data["dtypes"][i])))
                grads.update(zip(leaf.names,
                                 a.unbind() if leaf.stacked else [a]))
            groups = [leaf.names for leaf in leaves]
            calls.clear()
            dist.all_reduce = counting
            try:
                synced = canary_allreduce_tree(  # a dict it empties
                    dict(grads), group=W, axis_size=DP, num_blocks=BLOCKS,
                    fixed_point=True, groups=groups)
            finally:
                dist.all_reduce = real
            out[f"{dtype}.all_reduce_calls"] = np.array(calls)
            scales = fixed_point_scales(grads, [W], bits=24, world=DP,
                                        groups=groups)
            roots = round_robin_roots(BLOCKS, DP)
            for (name, g), sc in zip(grads.items(), scales):
                out[f"{dtype}.q.{name}"] = multi_root_tree_allreduce(
                    quantize(g, sc), W, DP, roots).numpy()
                out[f"{dtype}.y.{name}"] = synced[name].float().numpy()

        cfg = _cfg()
        mesh, mesh22 = make_mesh(), make_mesh(outer_size=2)
        batch = {k: torch.from_numpy(v)
                 for k, v in _batch(cfg, mesh.batch_slice(B)).items()}
        for mode in MODES:
            tc = TrainConfig(model=cfg, optimizer=AdamWConfig(lr=LR),
                             grad_sync=mode)
            p = params_from_reference(np_params, cfg, device="cpu")
            before = p.encoder[0].mlp.w_up.detach().clone()
            seen = {}
            step = make_train_step(
                tc, mesh22 if mode == "hierarchical" else mesh,
                on_sync=lambda raw, s: seen.update(raw=raw, synced={
                    k: v.clone() for k, v in s.items()}))
            p, _, m = step(p, adamw_init(p, tc.optimizer), batch)
            out[f"{mode}.loss"] = float(m["loss"])
            out[f"{mode}.grad_norm"] = float(m["grad_norm"])
            out[f"{mode}.encoder_moved"] = bool(
                (p.encoder[0].mlp.w_up != before).any())
            if seen:
                out[f"{mode}.names"] = np.array(list(seen["raw"]))
                out.update({f"{mode}.grad.{k}": v.float().numpy()
                            for k, v in seen["synced"].items()})
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(ref, models, tmp_path_factory):
    """Each rank's JAX gradients of whisper-smoke (float32, and the bf16
    model's) synced by JAX on 4 host devices (subprocess) and by the port
    on 4 gloo ranks side by side, which also step in every mode:
    ``(jax results by dtype, [port results by rank])``."""
    jax, jnp = ref.jax, ref.jnp
    d = tmp_path_factory.mktemp("whisper_sync")
    per = B // DP
    for dtype in DTYPES:
        jcfg, jp, tcfg, _ = models[dtype]
        loss_fn = ref.train.make_loss_fn(ref.train.TrainConfig(model=jcfg))
        grad = jax.jit(jax.grad(lambda p, b: loss_fn(p, b)[0]))
        for r in range(DP):
            rows = {k: jnp.asarray(v, jnp.dtype(dtype)) if k == "frames"
                    else jnp.asarray(v)
                    for k, v in _batch(tcfg, (r * per, (r + 1) * per)).items()}
            leaves = jax.tree_util.tree_leaves(grad(jp, rows))
            np.savez(d / f"grads_{dtype}_rank{r}.npz",
                     dtypes=np.array([str(a.dtype) for a in leaves]),
                     **{f"g{i}": np.asarray(a, np.float32)     # exact
                        for i, a in enumerate(leaves)})
    env = dict(os.environ,
               XLA_FLAGS=f"--xla_force_host_platform_device_count={DP}",
               JAX_PLATFORMS="cpu",
               PYTHONPATH="src" + os.pathsep + os.environ.get("PYTHONPATH",
                                                              ""))
    proc = subprocess.Popen(
        [sys.executable, "-c", FP_SYNC_SCRIPT, str(d),
         json.dumps(dict(dp=DP, blocks=BLOCKS, dtypes=DTYPES))],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    np_params = jax.tree.map(np.asarray, models["float32"][1])
    try:
        mp.spawn(_rank, args=(str(d / "rendezvous"), str(d), np_params),
                 nprocs=DP, join=True)
        out, err = proc.communicate(timeout=600)
    finally:
        proc.kill()
    assert "JAX_OK" in out, out + "\n" + err
    return ({t: dict(np.load(d / f"jax_{t}.npz")) for t in DTYPES},
            [dict(np.load(d / f"rank{r}.npz")) for r in range(DP)])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("what", ["int32 sums", "synced"])
def test_canary_fp_sync_matches_jax_bit_for_bit(ranks, dtype, what):
    """whisper-smoke's gradients through both syncs, one scale a reference
    leaf (the stacked encoder's among them): every rank's int32 sums and
    synced values equal the reference's bit for bit, and the scales take
    one ``all_reduce(MAX)``."""
    jax_out, port = ranks
    leaves = reference_leaves(_cfg(dtype))
    assert len(leaves) == 25 and any(leaf.path[0] == "encoder" and
                                     leaf.stacked for leaf in leaves)
    key = "q" if what == "int32 sums" else "y"
    for i, leaf in enumerate(leaves):
        want = jax_out[dtype][f"{key}{i}"]
        for rank in port:
            parts = [rank[f"{dtype}.{key}.{n}"] for n in leaf.names]
            got = np.stack(parts) if leaf.stacked else parts[0]
            if key == "q":
                assert got.dtype == np.int32
            np.testing.assert_array_equal(got, want, err_msg=str(leaf.path))
    for rank in port:
        assert list(rank[f"{dtype}.all_reduce_calls"]) == [
            str(dist.ReduceOp.MAX)]


@pytest.mark.parametrize("mode", MODES)
def test_step_runs_in_every_grad_sync_mode(ranks, mode):
    """A whisper step in each mode on 4 ranks: the loss and grad_norm
    agree with ``canary_fp``'s, the encoder's weights move, and in an
    explicit mode every gradient (the encoder's among them) reaches the
    sync, whose result is within 1e-5 of each leaf's max of
    ``canary_fp``'s."""
    _, port = ranks
    for r in port:
        np.testing.assert_allclose(r[f"{mode}.loss"], r["canary_fp.loss"],
                                   rtol=1e-6)
        np.testing.assert_allclose(r[f"{mode}.grad_norm"],
                                   r["canary_fp.grad_norm"], rtol=1e-5)
        assert bool(r[f"{mode}.encoder_moved"])
        if mode == "auto":
            continue
        names = list(r[f"{mode}.names"])
        assert len(names) == len(list(r["canary_fp.names"])) == \
            2 * 13 + 2 * 8 + 4
        assert sum(n.startswith("encoder.") for n in names) == 2 * 8
        for n in names:
            assert np.abs(r[f"{mode}.grad.{n}"]).max() > 0, n
            _leaf_close(torch.from_numpy(r[f"{mode}.grad.{n}"]),
                        r[f"canary_fp.grad.{n}"], 1e-5, n)
