"""Checkpoints cross between the packages.

The JAX package saves a checkpoint on the CPU and the port restores it, and
the reverse, each bit for bit: bf16 parameters, AdamW moments in float32 or
bf16, and an AdamW step past 0, for the smoke llama and for the smoke jamba
(whose hybrid period holds different keys at its two positions: a Mamba-2
layer with an MLP, an attention layer with an MoE block and its
(n_per, E, d, f) expert leaves). The two packages also write the same
manifest for the same state. The reference's modules are imported inside
the ``ref`` fixture.
"""
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

os.environ.setdefault("JAX_PLATFORMS", "cpu")
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.convert import (opt_state_from_reference,
                                 params_from_reference)
from repro_torch.models import get_config, init_params
from repro_torch.optim import AdamWConfig
from repro_torch.optim import init as adamw_init
from repro_torch.optim import update as adamw_update

ARCH = "llama3.2-1b"
HYBRID = "jamba-v0.1-52b"
STATE_DTYPES = ["float32", "bfloat16"]


@pytest.fixture(scope="module")
def ref():
    import jax
    import jax.numpy as jnp

    from repro import checkpoint, models, optim
    return SimpleNamespace(jax=jax, jnp=jnp, checkpoint=checkpoint,
                           models=models, optim=optim)


def _jax_state(ref, state_dtype, arch=ARCH):
    """The reference's smoke model (bf16) after two AdamW steps on random
    gradients: parameters and an optimizer state at step 2."""
    jax = ref.jax
    cfg = ref.models.get_config(arch, "smoke")
    oc = ref.optim.AdamWConfig(lr=1e-2, state_dtype=state_dtype)
    params = ref.models.init_params(cfg, jax.random.PRNGKey(3))
    opt = ref.optim.init(params, oc)
    leaves, treedef = jax.tree_util.tree_flatten(params)
    rng = np.random.default_rng(5)
    for _ in range(2):
        grads = jax.tree_util.tree_unflatten(treedef, [
            ref.jnp.asarray(rng.standard_normal(a.shape), a.dtype)
            for a in leaves])
        params, opt, _ = ref.optim.update(grads, opt, params, oc)
    return params, opt


def _port_state(state_dtype, arch=ARCH):
    """The port's smoke model (bf16) after two AdamW steps on random
    gradients."""
    cfg = get_config(arch, "smoke")
    oc = AdamWConfig(lr=1e-2, state_dtype=state_dtype)
    params = init_params(cfg, torch.Generator().manual_seed(4), device="cpu")
    opt = adamw_init(params, oc)
    gen = torch.Generator().manual_seed(6)
    for _ in range(2):
        grads = {n: torch.randn(p.shape, generator=gen).to(p.dtype)
                 for n, p in params.named_parameters()}
        params, opt, _ = adamw_update(grads, opt, params, oc)
    return params, opt


def _blank(state_dtype, arch=ARCH):
    cfg = get_config(arch, "smoke")
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    return params, adamw_init(params, AdamWConfig(state_dtype=state_dtype))


def _assert_same(params, opt, want_params, want_opt):
    got = dict(params.named_parameters())
    want = dict(want_params.named_parameters())
    assert set(got) == set(want)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        assert torch.equal(got[name], want[name]), name
    assert opt.step.dtype == want_opt.step.dtype == torch.int32
    assert int(opt.step) == int(want_opt.step) == 2
    for field in ("m", "v"):
        a, b = getattr(opt, field), getattr(want_opt, field)
        assert set(a) == set(b)
        for name in b:
            assert a[name].dtype == b[name].dtype, (field, name)
            assert torch.equal(a[name], b[name]), (field, name)


@pytest.mark.parametrize("state_dtype", STATE_DTYPES)
def test_port_restores_a_jax_checkpoint_bit_for_bit(ref, tmp_path,
                                                    state_dtype):
    jparams, jopt = _jax_state(ref, state_dtype)
    ref.checkpoint.save_checkpoint(str(tmp_path / "jax"), 5, jparams, jopt)
    params, opt = _blank(state_dtype)
    _, _, step = restore_checkpoint(str(tmp_path / "jax"), 5, params, opt)
    assert step == 5
    cfg = get_config(ARCH, "smoke")
    as_np = ref.jax.tree.map(np.asarray, (jparams, jopt))
    _assert_same(params, opt, params_from_reference(as_np[0], cfg, "cpu"),
                 opt_state_from_reference(as_np[1], cfg, "cpu"))
    # the port writes the same manifest for the same state
    save_checkpoint(str(tmp_path / "port"), 5, params, opt)
    manifests = [json.loads((tmp_path / side / "step_5" /
                             "manifest.json").read_text())
                 for side in ("jax", "port")]
    assert manifests[0] == manifests[1]
    assert manifests[0]["num_leaves"] == 1 + 3 * 11


@pytest.mark.parametrize("state_dtype", STATE_DTYPES)
def test_jax_restores_a_port_checkpoint_bit_for_bit(ref, tmp_path,
                                                    state_dtype):
    params, opt = _port_state(state_dtype)
    save_checkpoint(str(tmp_path), 9, params, opt)
    jcfg = ref.models.get_config(ARCH, "smoke")
    like = ref.models.init_params(jcfg, ref.jax.random.PRNGKey(0))
    opt_like = ref.optim.init(like, ref.optim.AdamWConfig(
        state_dtype=state_dtype))
    jparams, jopt, step = ref.checkpoint.restore_checkpoint(
        str(tmp_path), 9, like, opt_like)
    assert step == 9
    cfg = get_config(ARCH, "smoke")
    as_np = ref.jax.tree.map(np.asarray, (jparams, jopt))
    _assert_same(params_from_reference(as_np[0], cfg, "cpu"),
                 opt_state_from_reference(as_np[1], cfg, "cpu"), params, opt)


def test_manifest_names_the_reference_tree(ref, tmp_path):
    """Without an optimizer state: the leaves and the treedef string are
    those of ``jax.tree_util`` for ``{"params": params}``."""
    params, _ = _blank("float32")
    save_checkpoint(str(tmp_path), 1, params)
    manifest = json.loads((tmp_path / "step_1" / "manifest.json").read_text())
    like = ref.models.init_params(ref.models.get_config(ARCH, "smoke"),
                                  ref.jax.random.PRNGKey(0))
    leaves, treedef = ref.jax.tree_util.tree_flatten({"params": like})
    assert manifest["treedef"] == str(treedef)
    assert manifest["shapes"] == [list(a.shape) for a in leaves]
    assert manifest["dtypes"] == [str(a.dtype) for a in leaves]


def test_port_restores_a_jax_hybrid_checkpoint_bit_for_bit(ref, tmp_path):
    jparams, jopt = _jax_state(ref, "float32", HYBRID)
    ref.checkpoint.save_checkpoint(str(tmp_path / "jax"), 3, jparams, jopt)
    params, opt = _blank("float32", HYBRID)
    _, _, step = restore_checkpoint(str(tmp_path / "jax"), 3, params, opt)
    assert step == 3
    cfg = get_config(HYBRID, "smoke")
    as_np = ref.jax.tree.map(np.asarray, (jparams, jopt))
    _assert_same(params, opt, params_from_reference(as_np[0], cfg, "cpu"),
                 opt_state_from_reference(as_np[1], cfg, "cpu"))
    save_checkpoint(str(tmp_path / "port"), 3, params, opt)
    manifests = [json.loads((tmp_path / side / "step_3" /
                             "manifest.json").read_text())
                 for side in ("jax", "port")]
    assert manifests[0] == manifests[1]
    n = len(ref.jax.tree_util.tree_leaves(jparams))
    assert manifests[0]["num_leaves"] == 1 + 3 * n
    assert [2, 4, 256, 512] in manifests[0]["shapes"]   # (n_per, E, d, f)


def test_jax_restores_a_port_hybrid_checkpoint_bit_for_bit(ref, tmp_path):
    params, opt = _port_state("float32", HYBRID)
    save_checkpoint(str(tmp_path), 7, params, opt)
    jcfg = ref.models.get_config(HYBRID, "smoke")
    like = ref.models.init_params(jcfg, ref.jax.random.PRNGKey(0))
    opt_like = ref.optim.init(like, ref.optim.AdamWConfig())
    jparams, jopt, step = ref.checkpoint.restore_checkpoint(
        str(tmp_path), 7, like, opt_like)
    assert step == 7
    cfg = get_config(HYBRID, "smoke")
    as_np = ref.jax.tree.map(np.asarray, (jparams, jopt))
    _assert_same(params_from_reference(as_np[0], cfg, "cpu"),
                 opt_state_from_reference(as_np[1], cfg, "cpu"), params, opt)
