"""The port's models (``repro_torch.models``) against the JAX package's.

Weights come from JAX's ``init_params``, as numpy, through
``repro_torch.convert.params_from_reference``; tokens and activations are
seeded numpy arrays. The same inputs go through both packages on the CPU,
where the port's ``chunked_attention`` runs the flash kernel's plain
version. Tolerances: 1e-4 at float32 (the order of sums differs), 2e-2 of
the logits' scale at bfloat16 (see ``_close``; the two libraries round at
different points, and the reference's chunked scan keeps its accumulator in
bfloat16 where the port's kernel keeps float32).
"""
import os
from typing import List

import numpy as np
import pytest
import torch

os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import decode_step as _j_decode_step  # noqa: E402
from repro.models import forward as j_forward  # noqa: E402
from repro.models import get_config as j_get_config  # noqa: E402
from repro.models import init_cache as j_init_cache  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import moe as jm  # noqa: E402
from repro_torch.convert import (params_from_reference,  # noqa: E402
                                 reference_leaves, tensor_from_numpy)
from repro_torch.models import (decode_step, forward, get_config,  # noqa: E402
                                init_cache, init_params, list_archs)
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import moe as tm  # noqa: E402

DENSE = ["llama3.2-1b", "qwen2-7b", "glm4-9b", "nemotron-4-340b"]
MOE_SSM = ["deepseek-moe-16b", "qwen2-moe-a2.7b", "mamba2-130m",
           "jamba-v0.1-52b"]
j_decode_step = jax.jit(_j_decode_step, static_argnums=3)  # one trace a cfg
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _cfgs(arch, dtype, **kw):
    """The reference's and the port's smoke config, with the same edits."""
    return (j_get_config(arch, "smoke").with_(dtype=dtype, **kw),
            get_config(arch, "smoke").with_(dtype=dtype, **kw))


def _params(jcfg, tcfg, seed=0):
    jp = j_init_params(jcfg, jax.random.PRNGKey(seed))
    return jp, params_from_reference(jax.tree.map(np.asarray, jp), tcfg,
                                     device="cpu")


def _tokens(cfg, B, S, seed=7):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _close(got, want, dtype):
    """float32: elementwise within 1e-4. bfloat16: the largest difference
    within 2e-2 of the largest logit. Elementwise 2e-2 is not a fair bar
    there: the two libraries round bf16 at different points (XLA fuses
    elementwise chains in float32), and each one's logits are ~0.045 from
    the float32 forward over the same weights at these sizes, so a few
    logits near zero differ by 3-5 bf16 ulps of a logit of 1."""
    got = np.asarray(got.float())
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=TOL[dtype],
                                   atol=TOL[dtype])
        return
    assert np.isfinite(got).all()
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= TOL[dtype] * scale, (err, scale)


# ------------------------------------------------------------- the registry
def test_registry_copies_every_config():
    from repro.models import list_archs as j_list_archs
    assert list_archs() == j_list_archs()
    for arch in list_archs():
        for variant in ("full", "smoke"):
            assert get_config(arch, variant).__dict__ == \
                j_get_config(arch, variant).__dict__


# -------------------------------------------------------------- the forward
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DENSE)
def test_forward_matches_jax(arch, dtype):
    jcfg, tcfg = _cfgs(arch, dtype)
    jp, tp = _params(jcfg, tcfg)
    toks = _tokens(tcfg, 2, 16)
    want, _ = j_forward(jp, jnp.asarray(toks), jcfg)
    with torch.inference_mode():
        got, aux = forward(tp, torch.from_numpy(toks), tcfg)
    assert got.dtype == getattr(torch, dtype)
    assert tuple(got.shape) == (2, 16, tcfg.vocab_size)
    assert float(aux) == 0.0
    _close(got, want, dtype)


@pytest.mark.parametrize("window", [0, 32])
@pytest.mark.parametrize("arch", DENSE)
def test_forward_chunked_route_matches_jax(arch, window):
    """S=256 with ``attn_chunk=64, attn_chunk_threshold=128``: both
    packages take ``chunked_attention`` (the port's flash wrapper)."""
    jcfg, tcfg = _cfgs(arch, "float32", attn_chunk=64,
                       attn_chunk_threshold=128, sliding_window=window)
    jp, tp = _params(jcfg, tcfg)
    toks = _tokens(tcfg, 1, 256)
    want, _ = j_forward(jp, jnp.asarray(toks), jcfg)
    with torch.inference_mode():
        got, _ = forward(tp, torch.from_numpy(toks), tcfg)
    _close(got, want, "float32")


def test_forward_chunked_route_bf16_matches_jax():
    jcfg, tcfg = _cfgs("llama3.2-1b", "bfloat16", attn_chunk=64,
                       attn_chunk_threshold=128)
    jp, tp = _params(jcfg, tcfg)
    toks = _tokens(tcfg, 1, 256)
    want, _ = j_forward(jp, jnp.asarray(toks), jcfg)
    with torch.inference_mode():
        got, _ = forward(tp, torch.from_numpy(toks), tcfg)
    _close(got, want, "bfloat16")


def test_forward_vlm_prefix_and_mrope_match_jax():
    """Qwen2-VL: M-RoPE and the stub patch prefix (``extra_embeds``)."""
    jcfg, tcfg = _cfgs("qwen2-vl-2b", "float32")
    jp, tp = _params(jcfg, tcfg)
    toks = _tokens(tcfg, 2, 12)
    patches = (np.random.default_rng(3).normal(
        size=(2, tcfg.num_patches, tcfg.d_model)) * 0.02).astype(np.float32)
    want, _ = j_forward(jp, jnp.asarray(toks), jcfg,
                        extra_embeds=jnp.asarray(patches))
    with torch.inference_mode():
        got, _ = forward(tp, torch.from_numpy(toks), tcfg,
                         extra_embeds=torch.from_numpy(patches))
    assert tuple(got.shape) == (2, 12 + tcfg.num_patches, tcfg.vocab_size)
    _close(got, want, "float32")


# ------------------------------------------------------------------- decode
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DENSE + ["qwen2-vl-2b"])
def test_decode_steps_match_jax(arch, dtype):
    """Four greedy decode steps fed the reference's tokens: the same
    logits, and at float32 the same argmax."""
    jcfg, tcfg = _cfgs(arch, dtype)
    jp, tp = _params(jcfg, tcfg)
    jcache = j_init_cache(jcfg, 2, max_len=32)
    tcache = init_cache(tcfg, 2, max_len=32, device="cpu")
    jtok = jnp.zeros((2, 1), jnp.int32)
    ttok = torch.zeros((2, 1), dtype=torch.int32)
    for _ in range(4):
        want, jcache = j_decode_step(jp, jcache, jtok, jcfg)
        with torch.inference_mode():
            got, tcache = decode_step(tp, tcache, ttok, tcfg)
        _close(got, want, dtype)
        jtok = jnp.argmax(want[:, -1:], axis=-1).astype(jnp.int32)
        if dtype == "float32":
            np.testing.assert_array_equal(
                torch.argmax(got[:, -1:], dim=-1).numpy(), np.asarray(jtok))
        ttok = torch.from_numpy(np.array(jtok))     # both take one token
    assert tcache["pos"] == int(jcache["pos"]) == 4


def test_sliding_window_ring_decode_matches_jax():
    """Window 8 over 12 steps: the ring buffer wraps."""
    jcfg, tcfg = _cfgs("llama3.2-1b", "float32", sliding_window=8)
    jp, tp = _params(jcfg, tcfg)
    toks = _tokens(tcfg, 1, 12)
    jcache = j_init_cache(jcfg, 1, max_len=12)
    tcache = init_cache(tcfg, 1, max_len=12, device="cpu")
    assert tcache["layers"][0]["k"].shape[1] == 8
    for t in range(12):
        want, jcache = j_decode_step(jp, jcache, jnp.asarray(toks[:, t:t + 1]),
                                     jcfg)
        with torch.inference_mode():
            got, tcache = decode_step(tp, tcache,
                                      torch.from_numpy(toks[:, t:t + 1]),
                                      tcfg)
        _close(got, want, "float32")


def test_decode_past_the_cache_raises():
    _, tcfg = _cfgs("llama3.2-1b", "float32")
    tp = init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    cache = init_cache(tcfg, 1, max_len=2, device="cpu")
    tok = torch.zeros((1, 1), dtype=torch.int32)
    with torch.inference_mode():
        decode_step(tp, cache, tok, tcfg)
        decode_step(tp, cache, tok, tcfg)
        with pytest.raises(ValueError, match="past the cache"):
            decode_step(tp, cache, tok, tcfg)


# ------------------------------------------------------ MoE and SSM models
def _record_jax_routes(monkeypatch) -> List[tuple]:
    """Every ``_route`` call of the reference from here on, in order, as
    numpy ``(top_w, top_e, aux, probs)`` (a debug callback, so jitted and
    scanned code records too)."""
    calls: List[tuple] = []
    orig = jm._route

    def route(p, x2d, cfg):
        out = orig(p, x2d, cfg)
        probs = jax.nn.softmax(x2d.astype(jnp.float32) @ p["router"], axis=-1)
        jax.debug.callback(lambda *a: calls.append(tuple(map(np.array, a))),
                           *out, probs, ordered=True)
        return out
    monkeypatch.setattr(jm, "_route", route)
    return calls


def _record_port_routes(monkeypatch) -> List[tuple]:
    calls: List[tuple] = []
    orig = tm._route

    def route(p, x2d, cfg):
        out = orig(p, x2d, cfg)
        probs = torch.softmax(x2d.to(torch.float32) @ p.router, dim=-1)
        calls.append(tuple(t.numpy().copy() for t in (*out, probs)))
        return out
    monkeypatch.setattr(tm, "_route", route)
    return calls


def _replay_routes(monkeypatch, calls: List[tuple]) -> None:
    """The port's ``_route`` hands back the recorded decisions in order."""
    it = iter(calls)

    def route(p, x2d, cfg):
        w, e, aux, _ = next(it)
        return (torch.from_numpy(w), torch.from_numpy(e.astype(np.int64)),
                torch.tensor(float(aux)))
    monkeypatch.setattr(tm, "_route", route)


def _flips(jcalls: List[tuple], tcalls: List[tuple]) -> int:
    """The number of tokens whose chosen experts differ between the two
    packages; each must be a near-tie in the reference's probabilities."""
    assert len(jcalls) == len(tcalls) > 0
    flips = 0
    for (_, je, _, jp), (_, te, _, tp) in zip(jcalls, tcalls):
        k = je.shape[1]
        top = -np.sort(-jp, axis=-1)
        margin = top[:, k - 1] - top[:, k]
        noise = np.abs(jp - tp).max(axis=-1)
        for i in range(je.shape[0]):
            if set(je[i]) != set(te[i]):
                flips += 1
                assert margin[i] <= 2 * noise[i], (i, margin[i], noise[i])
    return flips


def _aux_close(got, want) -> None:
    assert abs(float(got) - float(want)) <= 1e-6, (float(got), float(want))


def _close_to_reference_noise(got, want, truth) -> None:
    """bfloat16: the largest difference within 2e-2 of the largest logit,
    or within the reference's own distance from ``truth``, a float32
    forward over the same weights and routing, where that is larger. A
    Mamba-2 layer rounds more often in bf16 than a dense one (x, B and C
    leave the conv in bf16), and each package's logits lie 2-4 % of their
    scale from the float32 forward at these sizes."""
    got = np.asarray(got.float())
    want = np.asarray(want, np.float32)
    assert np.isfinite(got).all()
    err = np.abs(got - want).max()
    noise = np.abs(want - np.asarray(truth.float())).max()
    bound = max(TOL["bfloat16"] * np.abs(want).max(), noise)
    assert err <= bound, (err, bound, noise)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE_SSM)
def test_forward_matches_jax_moe_ssm(arch, dtype, monkeypatch):
    """The logits and the summed MoE aux loss (within 1e-6). At bfloat16
    an MoE model is held on the reference's routing (see the module's
    docstring), and on its own wherever no choice flipped; the bound is
    :func:`_close_to_reference_noise`."""
    jcfg, tcfg = _cfgs(arch, dtype)
    jp, tp = _params(jcfg, tcfg)
    toks = _tokens(tcfg, 2, 16)
    moe = tcfg.moe_experts > 0
    if dtype == "float32":
        want, jaux = j_forward(jp, jnp.asarray(toks), jcfg)
        with torch.inference_mode():
            got, aux = forward(tp, torch.from_numpy(toks), tcfg)
        assert got.dtype == torch.float32
        assert tuple(got.shape) == (2, 16, tcfg.vocab_size)
        assert aux.dtype == torch.float32 and (float(aux) > 0) == moe
        _aux_close(aux, jaux)
        _close(got, want, dtype)
        return
    jcalls = _record_jax_routes(monkeypatch) if moe else []
    want, jaux = j_forward(jp, jnp.asarray(toks), jcfg)
    jax.effects_barrier()
    own = None
    if moe:
        tcalls = _record_port_routes(monkeypatch)
        with torch.inference_mode():
            own, _ = forward(tp, torch.from_numpy(toks), tcfg)
        if _flips(jcalls, tcalls):
            own = None
        _replay_routes(monkeypatch, jcalls)
    with torch.inference_mode():
        got, aux = forward(tp, torch.from_numpy(toks), tcfg)
    assert got.dtype == torch.bfloat16
    _aux_close(aux, jaux)
    cfg32 = tcfg.with_(dtype="float32")
    tp32 = params_from_reference(jax.tree.map(
        lambda a: np.asarray(a, np.float32), jp), cfg32, device="cpu")
    if moe:
        _replay_routes(monkeypatch, jcalls)
    with torch.inference_mode():
        truth, _ = forward(tp32, torch.from_numpy(toks), cfg32)
    for out in (got, own) if own is not None else (got,):
        _close_to_reference_noise(out, want, truth)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE_SSM)
def test_decode_steps_match_jax_moe_ssm(arch, dtype, monkeypatch):
    """Four greedy decode steps fed the reference's tokens through K/V and
    SSM caches: the same logits (at bfloat16 with MoE, on the reference's
    routing; see the module's docstring), at float32 the same argmax."""
    jcfg, tcfg = _cfgs(arch, dtype)
    jp, tp = _params(jcfg, tcfg)
    replay = dtype == "bfloat16" and tcfg.moe_experts > 0
    n_moe = sum(map(tcfg.layer_is_moe, range(tcfg.num_layers)))
    step = jax.jit(_j_decode_step, static_argnums=3)    # traced here
    jcalls = _record_jax_routes(monkeypatch) if replay else None
    jcache = j_init_cache(jcfg, 2, max_len=32)
    tcache = init_cache(tcfg, 2, max_len=32, device="cpu")
    jtok = jnp.zeros((2, 1), jnp.int32)
    ttok = torch.zeros((2, 1), dtype=torch.int32)
    for _ in range(4):
        want, jcache = step(jp, jcache, jtok, jcfg)
        if replay:
            jax.effects_barrier()
            _replay_routes(monkeypatch, jcalls[-n_moe:])
        with torch.inference_mode():
            got, tcache = decode_step(tp, tcache, ttok, tcfg)
        _close(got, want, dtype)
        jtok = jnp.argmax(want[:, -1:], axis=-1).astype(jnp.int32)
        if dtype == "float32":
            np.testing.assert_array_equal(
                torch.argmax(got[:, -1:], dim=-1).numpy(), np.asarray(jtok))
        ttok = torch.from_numpy(np.array(jtok))
    assert tcache["pos"] == int(jcache["pos"]) == 4


@pytest.mark.parametrize("arch", MOE_SSM)
def test_reference_leaves_follow_the_jax_tree(arch):
    """``reference_leaves`` names the reference's leaves in
    ``jax.tree_util`` order with their stacked shapes (for jamba: a hybrid
    period whose two positions hold different keys)."""
    jcfg, tcfg = _cfgs(arch, "bfloat16")
    jp = j_init_params(jcfg, jax.random.PRNGKey(0))
    want = [(tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path),
             tuple(a.shape), str(a.dtype))
            for path, a in jax.tree_util.tree_flatten_with_path(jp)[0]]
    model = dict(init_params(tcfg, torch.Generator().manual_seed(0),
                             device="cpu").named_parameters())
    got = []
    for leaf in reference_leaves(tcfg):
        t = model[leaf.names[0]]
        shape = ((len(leaf.names),) if leaf.stacked else ()) + tuple(t.shape)
        got.append((leaf.path, shape, str(t.dtype).removeprefix("torch.")))
    assert got == want


# ----------------------------------------------------------------- functions
def _rand(seed, shape, std=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * std
            ).astype(np.float32)


def test_rmsnorm_matches_jax():
    x, scale = _rand(0, (2, 5, 64), 3.0), _rand(1, (64,))
    want = jl.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x), 1e-5)
    norm = tl.RMSNorm(64)
    norm.scale.copy_(torch.from_numpy(scale))
    for dtype in ("float32", "bfloat16"):
        got = tl.rmsnorm(norm, torch.from_numpy(x).to(getattr(torch, dtype)))
        assert got.dtype == getattr(torch, dtype)
        want_d = jl.rmsnorm({"scale": jnp.asarray(scale)},
                            jnp.asarray(x).astype(dtype), 1e-5)
        _close(got, want_d, dtype if dtype == "bfloat16" else "float32")
    np.testing.assert_allclose(
        tl.rmsnorm(norm, torch.from_numpy(x)).numpy(), np.asarray(want),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("theta", [10000.0, 500000.0])
def test_apply_rope_matches_jax(theta):
    x = _rand(2, (2, 9, 4, 64))
    pos = np.random.default_rng(3).integers(0, 4096, (2, 9)).astype(np.int32)
    want = jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_apply_mrope_matches_jax():
    x = _rand(4, (2, 7, 4, 128))
    pos3 = np.random.default_rng(5).integers(0, 512, (2, 7, 3)
                                             ).astype(np.int32)
    want = jl.apply_mrope(jnp.asarray(x), jnp.asarray(pos3), 1e6,
                          (16, 24, 24))
    got = tl.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos3), 1e6,
                         (16, 24, 24))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    # text: three equal streams make M-RoPE plain RoPE
    same = np.repeat(pos3[..., :1], 3, axis=-1)
    torch.testing.assert_close(
        tl.apply_mrope(torch.from_numpy(x), torch.from_numpy(same), 1e6,
                       (16, 24, 24)),
        tl.apply_rope(torch.from_numpy(x), torch.from_numpy(same[..., 0]),
                      1e6))


@pytest.mark.parametrize("activation", ["gelu", "swiglu", "squared_relu"])
def test_mlp_forward_matches_jax(activation):
    d, f = 32, 64
    jp = jl.init_mlp(jax.random.PRNGKey(1), d, f, activation, jnp.float32)
    mlp = tl.MLP(d, f, activation, torch.float32)
    for name, a in jp.items():
        getattr(mlp, name).copy_(torch.from_numpy(np.array(a)))
    x = _rand(6, (2, 3, d), 2.0)
    want = jl.mlp_forward(jp, jnp.asarray(x), activation)
    got = tl.mlp_forward(mlp, torch.from_numpy(x), activation)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_full_and_decode_attention_match_jax():
    q, k, v = _rand(7, (2, 10, 4, 64)), _rand(8, (2, 10, 2, 64)), \
        _rand(9, (2, 10, 2, 64))
    for causal, window in ((True, 0), (False, 0), (True, 3)):
        want = jl.full_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=causal,
                                 sliding_window=window)
        got = tl.full_attention(*map(torch.from_numpy, (q, k, v)),
                                causal=causal, sliding_window=window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    valid = np.array([3, 10], np.int32)
    want = jl.decode_attention(jnp.asarray(q[:, :1]), jnp.asarray(k),
                               jnp.asarray(v), jnp.asarray(valid))
    got = tl.decode_attention(torch.from_numpy(q[:, :1]), torch.from_numpy(k),
                              torch.from_numpy(v), torch.from_numpy(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    got_int = tl.decode_attention(torch.from_numpy(q[:, :1]),
                                  torch.from_numpy(k), torch.from_numpy(v), 4)
    want_int = jl.decode_attention(jnp.asarray(q[:, :1]), jnp.asarray(k),
                                   jnp.asarray(v), 4)
    np.testing.assert_allclose(got_int.numpy(), np.asarray(want_int),
                               rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------------ weights
def test_params_from_reference_keeps_every_bit():
    jcfg, tcfg = _cfgs("qwen2-7b", "bfloat16")
    jp, tp = _params(jcfg, tcfg)
    np_params = jax.tree.map(np.asarray, jp)
    wq = np_params["layers"][0]["attn"]["wq"]          # (n_per, d, h, hd)
    assert wq.dtype.name == "bfloat16"
    for i in range(tcfg.num_layers):
        got = tp.layers[i].attn.wq
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      wq[i].view(np.int16))
    assert tp.layers[0].norm1.scale.dtype == torch.float32
    assert tp.layers[0].attn.bq.dtype == torch.bfloat16
    t = tensor_from_numpy(np.asarray(jnp.array([1.0, -2.5, 3e-3],
                                               jnp.bfloat16)))
    assert t.dtype == torch.bfloat16
    assert t.tolist() == [1.0, -2.5, float(jnp.bfloat16(3e-3))]
    assert not any(p.requires_grad for p in tp.parameters())


def test_params_from_reference_rejects_a_mismatched_tree():
    jcfg, tcfg = _cfgs("llama3.2-1b", "float32")
    np_params = jax.tree.map(np.asarray,
                             j_init_params(jcfg, jax.random.PRNGKey(0)))
    del np_params["layers"][0]["mlp"]["w_gate"]
    with pytest.raises(KeyError, match="w_gate"):
        params_from_reference(np_params, tcfg, device="cpu")


def test_init_params_draws_the_reference_scales():
    _, tcfg = _cfgs("llama3.2-1b", "float32")
    tp = init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    d, f = tcfg.d_model, tcfg.d_ff
    for t, want in ((tp.embed.tok, d ** -0.5),
                    (tp.layers[0].attn.wq, d ** -0.5),
                    (tp.layers[0].attn.wo, (tcfg.num_heads *
                                            tcfg.resolved_head_dim) ** -0.5),
                    (tp.layers[1].mlp.w_down, f ** -0.5)):
        assert abs(float(t.std()) / want - 1) < 0.05
    assert torch.equal(tp.final_norm.scale, torch.ones(d))
    again = init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(tp.embed.tok, again.embed.tok)


# --------------------------------------------------------- what is not here
@pytest.mark.parametrize("arch", ["whisper-large-v3"])
def test_unported_models_raise(arch):
    cfg = get_config(arch, "smoke")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        init_cache(cfg, 1, 8, device="cpu")


def test_entry_points_need_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for arch in ("llama3.2-1b", "qwen2-moe-a2.7b", "mamba2-130m",
                 "jamba-v0.1-52b"):
        cfg = get_config(arch, "smoke")
        with pytest.raises(RuntimeError, match="CUDA"):
            init_params(cfg, torch.Generator().manual_seed(0))
        with pytest.raises(RuntimeError, match="CUDA"):
            init_cache(cfg, 1, 8)
