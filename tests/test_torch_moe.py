"""The port's MoE layer (``repro_torch.models.moe``) against the JAX
package's (``repro.models.moe``).

The same seeded numpy inputs, and the reference's weights, go through both
packages on the CPU. Integer parts are held exactly: ``_capacity`` over a
grid of token counts, ``_dispatch_indices`` on ids with heavy ties, and the
expert ids ``_route`` picks. Floats: ``_route``'s weights and aux loss
within 1e-6 (float32); ``_moe_dense`` and ``moe_forward`` within 1e-4 at
float32 and within 2e-2 of the output's scale at bfloat16 (the two
libraries round bf16 at different points; see ``test_torch_models._close``).
``_moe_dense`` is held on the reference's own routing too (its ``top_w`` and
``top_e`` handed to the port's dispatch), so a near-tie in the router cannot
hide a dispatch fault, and a dispatch test cannot pass on a flipped choice.
"""
import os

import numpy as np
import pytest
import torch

os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import get_config as j_get_config  # noqa: E402
from repro.models import moe as jm  # noqa: E402
from repro_torch.convert import tensor_from_numpy  # noqa: E402
from repro_torch.models import get_config  # noqa: E402
from repro_torch.models import moe as tm  # noqa: E402

ARCH = "qwen2-moe-a2.7b"


def _cfgs(arch=ARCH, **kw):
    return (j_get_config(arch, "smoke").with_(**kw),
            get_config(arch, "smoke").with_(**kw))


def _port_moe(jp: dict, cfg, dtype) -> tm.MoE:
    """The port's :class:`MoE` holding the reference's ``init_moe`` leaves,
    every bit kept."""
    mod = tm.MoE(cfg, dtype, device="cpu")
    for name, a in jp.items():
        owner, items = (mod.shared, a.items()) if name == "shared" \
            else (mod, [(name, a)])
        for leaf, v in items:
            getattr(owner, leaf).data = tensor_from_numpy(np.asarray(v))
    return mod


def _layer(cfg_kw=None, dtype="float32", seed=0):
    jcfg, tcfg = _cfgs(dtype=dtype, **(cfg_kw or {}))
    jp = jm.init_moe(jax.random.PRNGKey(seed), jcfg, jnp.dtype(dtype))
    return jcfg, tcfg, jp, _port_moe(jp, tcfg, getattr(torch, dtype))


def _x(shape, dtype="float32", seed=3):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return jnp.asarray(x).astype(dtype), \
        torch.from_numpy(x).to(getattr(torch, dtype))


def _close(got: torch.Tensor, want, dtype: str) -> None:
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
        return
    assert np.isfinite(got).all()
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= 2e-2 * scale, (err, scale)


# ----------------------------------------------------------------- capacity
CAPACITY_CASES = {              # (experts, top_k, capacity factor)
    "qwen2-moe": (60, 4, 1.25), "deepseek-moe": (64, 6, 1.25),
    "jamba": (16, 2, 1.25), "smoke": (4, 2, 1.25), "tight": (4, 2, 0.5),
    "dropless": (60, 4, 15.0)}


@pytest.mark.parametrize("case", sorted(CAPACITY_CASES))
def test_capacity_matches_jax(case):
    e, k, cf = CAPACITY_CASES[case]
    jcfg, tcfg = _cfgs(moe_experts=e, moe_top_k=k, moe_capacity_factor=cf)
    for n in list(range(1, 130)) + [1000, 2048, 4096, 4097, 8192, 32768]:
        assert tm._capacity(n, tcfg) == jm._capacity(n, jcfg), n


# ----------------------------------------------------------------- dispatch
def _dispatch_case(name: str) -> tuple:
    """(top_e (N, k) int32, k, experts)."""
    rng = np.random.default_rng(11)
    if name == "random":
        return rng.integers(0, 8, (50, 3)), 3, 8
    if name == "all_on_one_expert":
        return np.full((40, 2), 3), 2, 4
    if name == "two_experts_alternating":
        return np.tile([[1, 0], [0, 1]], (16, 1)), 2, 4
    if name == "skewed":
        return rng.choice(6, size=(64, 4), p=[.7, .1, .1, .05, .03, .02]), 4, 6
    if name == "top1":
        return rng.integers(0, 3, (33, 1)), 1, 3
    raise KeyError(name)


@pytest.mark.parametrize("case", ["random", "all_on_one_expert",
                                  "two_experts_alternating", "skewed",
                                  "top1"])
def test_dispatch_indices_match_jax(case):
    top_e, k, e = _dispatch_case(case)
    want = jm._dispatch_indices(jnp.asarray(top_e, jnp.int32), k, e)
    got = tm._dispatch_indices(torch.from_numpy(top_e.astype(np.int64)), k, e)
    for name, g, w in zip(("sorted_e", "pos_in_e", "order"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


# -------------------------------------------------------------------- route
ROUTE_CASES = {"smoke": ({}, 32), "qwen2-moe experts": (
    dict(moe_experts=60, moe_top_k=4), 100), "top2 of 16": (
    dict(moe_experts=16, moe_top_k=2), 7)}


@pytest.mark.parametrize("xdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(ROUTE_CASES))
def test_route_matches_jax(case, xdtype):
    kw, n = ROUTE_CASES[case]
    jcfg, tcfg, jp, tp = _layer(kw)
    jx, tx = _x((n, tcfg.d_model), xdtype)
    jw, je, jaux = jm._route(jp, jx, jcfg)
    tw, te, taux = tm._route(tp, tx, tcfg)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0, atol=1e-6)
    assert tw.dtype == taux.dtype == torch.float32
    assert abs(float(taux) - float(jaux)) <= 1e-6


# -------------------------------------------------------------------- dense
def _dropped(top_e: np.ndarray, k: int, e: int, cap: int, pkg) -> set:
    """The (token, choice) slots that ``pkg``'s dispatch drops at ``cap``."""
    if pkg is jm:
        _, pos, order = map(np.asarray, jm._dispatch_indices(
            jnp.asarray(top_e, jnp.int32), k, e))
    else:
        _, pos, order = (t.numpy() for t in tm._dispatch_indices(
            torch.from_numpy(top_e.astype(np.int64)), k, e))
    return {divmod(int(s), k) for s in order[pos >= cap]}


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_dense_on_the_reference_routing(dtype, capacity_factor,
                                            monkeypatch):
    """The port's dispatch, expert products and combine on the reference's
    ``top_w`` / ``top_e``: the same output, and the same slots dropped (at a
    capacity factor of 0.5, some are)."""
    jcfg, tcfg, jp, tp = _layer(dict(moe_capacity_factor=capacity_factor),
                                dtype)
    n = 48
    jx, tx = _x((n, tcfg.d_model), dtype)
    jw, je, jaux = jm._route(jp, jx, jcfg)
    want, _ = jm._moe_dense(jp, jx, jcfg, None)
    monkeypatch.setattr(tm, "_route", lambda p, x, cfg: (
        torch.from_numpy(np.array(jw)), torch.from_numpy(
            np.array(je).astype(np.int64)), torch.tensor(float(jaux))))
    got, aux = tm._moe_dense(tp, tx, tcfg)
    assert got.dtype == tx.dtype and tuple(got.shape) == (n, tcfg.d_model)
    _close(got, want, dtype)
    k, e, cap = tcfg.moe_top_k, tcfg.moe_experts, tm._capacity(n, tcfg)
    dropped = _dropped(np.asarray(je), k, e, cap, tm)
    assert dropped == _dropped(np.asarray(je), k, e, cap, jm)
    assert bool(dropped) == (capacity_factor < 1), dropped
    for tok, _ in dropped:      # a token none of whose slots was kept
        if all((tok, j) in dropped for j in range(k)):
            assert float(got[tok].abs().max()) == 0.0


@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_forward_matches_jax(dtype, capacity_factor, shared):
    """``moe_forward`` on its own routing, with and without the shared
    experts: the same expert ids, output and aux loss."""
    kw = dict(moe_capacity_factor=capacity_factor)
    if not shared:
        kw["d_ff"] = 0
    jcfg, tcfg, jp, tp = _layer(kw, dtype)
    assert hasattr(tp, "shared") == shared == ("shared" in jp)
    jx, tx = _x((2, 24, tcfg.d_model), dtype)
    _, je, _ = jm._route(jp, jx.reshape(48, -1), jcfg)
    _, te, _ = tm._route(tp, tx.reshape(48, -1), tcfg)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    want, jaux = jm.moe_forward(jp, jx, jcfg)
    got, taux = tm.moe_forward(tp, tx, tcfg)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    _close(got, want, dtype)
    assert abs(float(taux) - float(jaux)) <= 1e-6


def test_every_moe_impl_takes_the_dense_path():
    """No parallel context: ``ep`` and ``ep_a2a`` run the dense path, as
    the reference's do without one."""
    outs = []
    for impl in ("auto", "dense", "ep", "ep_a2a"):
        _, tcfg, _, tp = _layer(dict(moe_impl=impl))
        _, tx = _x((1, 16, tcfg.d_model))
        outs.append(tm.moe_forward(tp, tx, tcfg)[0])
    assert all(torch.equal(o, outs[0]) for o in outs)


def test_init_moe_draws_the_reference_scales():
    _, tcfg = _cfgs(moe_experts=8, moe_d_ff=256)
    mod = tm.MoE(tcfg, torch.bfloat16, "cpu", torch.Generator().manual_seed(0))
    d, e, f = tcfg.d_model, tcfg.moe_experts, tcfg.moe_d_ff
    assert mod.router.dtype == torch.float32 and mod.router.shape == (d, e)
    for name, shape, scale in (("w_up", (e, d, f), d ** -0.5),
                               ("w_gate", (e, d, f), d ** -0.5),
                               ("w_down", (e, f, d), f ** -0.5)):
        t = getattr(mod, name)
        assert t.dtype == torch.bfloat16 and tuple(t.shape) == shape
        assert abs(float(t.float().std()) / scale - 1) < 0.05
    assert abs(float(mod.router.std()) * d ** 0.5 - 1) < 0.05
    assert mod.shared.w_gate.shape == (d, tcfg.d_ff)
    assert not any(p.requires_grad for p in mod.parameters())


# ----------------------------------------------------------------- training
def test_qwen2_moe_train_step_matches_jax():
    """One ``auto`` step of the float32 qwen2-moe smoke model on the same
    weights and batch: the step-0 loss and ``aux_loss`` within 1e-5, and
    the gradient of the router of each MoE layer within 1e-4 of its scale
    (the aux loss reaches the router only through the probabilities)."""
    from repro import optim as j_optim
    from repro import train as j_train
    from repro.models import init_params as j_init_params
    from repro_torch.convert import params_from_reference
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim import init as adamw_init
    from repro_torch.train import TrainConfig, make_train_step, \
        value_and_grad, make_loss_fn
    jcfg, tcfg = _cfgs(dtype="float32")
    jp = j_init_params(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(2)
    toks = rng.integers(0, tcfg.vocab_size, (2, 17)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    jtc = j_train.TrainConfig(model=jcfg, optimizer=j_optim.AdamWConfig())
    tc = TrainConfig(model=tcfg, optimizer=AdamWConfig())
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    (_, jmet), jg = jax.value_and_grad(j_train.make_loss_fn(jtc),
                                       has_aux=True)(jp, jb)
    params = params_from_reference(jax.tree.map(np.asarray, jp), tcfg,
                                   device="cpu")
    (_, tmet), tg = value_and_grad(make_loss_fn(tc), params, tb)
    for i in range(tcfg.num_layers):
        want = np.asarray(jg["layers"][0]["moe"]["router"][i])
        err = np.abs(tg[f"layers.{i}.moe.router"].numpy() - want).max()
        assert err <= 1e-4 * np.abs(want).max(), (i, err)
    assert float(tmet["aux_loss"]) > 0
    np.testing.assert_allclose(float(tmet["aux_loss"]),
                               float(jmet["aux_loss"]), rtol=1e-5)
    jopt = j_optim.init(jp, jtc.optimizer)
    _, _, jm_ = jax.jit(j_train.make_train_step(jtc))(jp, jopt, jb)
    _, _, tm_ = make_train_step(tc)(params, adamw_init(params, tc.optimizer),
                                    tb)
    for key in ("loss", "aux_loss"):
        np.testing.assert_allclose(float(tm_[key]), float(jm_[key]),
                                   rtol=1e-5, err_msg=key)
