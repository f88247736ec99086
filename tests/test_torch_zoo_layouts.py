"""Five of the zoo's architectures at their published layouts, the port
against the JAX package on the CPU.

glm4-9b, qwen2-7b, qwen2-vl-2b, deepseek-moe-16b and nemotron-4-340b keep
their published attention and MoE layouts (heads, KV heads, head_dim,
``qkv_bias``, ``rope_mode`` and M-RoPE sections, activation, experts,
top-k and shared experts) at a test size: two layers, ``d_model`` 256,
``d_ff`` 512, a vocabulary of 512, float32 (deepseek's routed experts 64
wide, qwen2-vl's patch prefix 8 long). The smoke variants cut those
layouts away (glm4's 4 / 2 heads, nemotron's head_dim 64, qwen2-vl's
sections (8, 12, 12), deepseek's 4 experts top-2). Weights come from the
reference's ``init_params`` through ``params_from_reference``; tokens and
patches are seeded numpy arrays. Everything is held at 1e-4: the forward
on both attention routes, decode steps, qwen2-vl's patch prefix and its
M-RoPE sections on a patch grid's (t, h, w) positions, and
qwen2-7b's sliding-window variant decoding past its window (stepped, and
after the port's cache-filling prefill), and ``Engine.generate``'s greedy
tokens against the reference engine's. The full-width parameter counts
are held to the reference's ``jax.eval_shape(init_params)``, and to the
constants ``chip_smoke.py``'s phase 4l checks on the card.
"""
import ast
import functools
import math
import os

import numpy as np
import pytest
import torch

os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import decode_step as _j_decode_step  # noqa: E402
from repro.models import forward as _j_forward  # noqa: E402
from repro.models import get_config as j_get_config  # noqa: E402
from repro.models import init_cache as j_init_cache  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import ServeConfig as JServeConfig  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.models import (Transformer, decode_step,  # noqa: E402
                                forward, get_config, init_cache)
from repro_torch.models.transformer import fills_cache  # noqa: E402
from repro_torch.serving import Engine, ServeConfig  # noqa: E402

ARCHS = ["qwen2-7b", "glm4-9b", "qwen2-vl-2b", "deepseek-moe-16b",
         "nemotron-4-340b"]
TOL = 1e-4
SIZE = dict(num_layers=2, d_model=256, d_ff=512, vocab_size=512,
            dtype="float32", remat=False)
EXTRA = {"deepseek-moe-16b": dict(moe_d_ff=64),
         "qwen2-vl-2b": dict(num_patches=8)}
B, S = 2, 64
WINDOW = 16                      # qwen2-7b's long_context_variant, cut
j_forward = jax.jit(_j_forward, static_argnums=2)
j_decode_step = jax.jit(_j_decode_step, static_argnums=3)


def _chip_smoke_constants() -> dict:
    """``ZOO_MODELS`` and ``ZOO_PARAMS`` of ``chip_smoke.py``, read from its
    source (it is not imported: it drives the card)."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    out = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                getattr(node.targets[0], "id", None) in ("ZOO_MODELS",
                                                         "ZOO_PARAMS"):
            out[node.targets[0].id] = ast.literal_eval(node.value)
    return out


def _cfgs(arch, **kw):
    """The reference's and the port's published config at the test size,
    with the same edits."""
    edits = dict(SIZE, **EXTRA.get(arch, {}), **kw)
    return (j_get_config(arch, "full").with_(**edits),
            get_config(arch, "full").with_(**edits))


@functools.lru_cache(maxsize=None)
def _params(arch):
    jcfg, tcfg = _cfgs(arch)
    jp = j_init_params(jcfg, jax.random.PRNGKey(0))
    return jp, params_from_reference(jax.tree.map(np.asarray, jp), tcfg,
                                     device="cpu")


def _inputs(cfg, seed=7):
    """Tokens (B, S - num_patches) and, for the VLM, seeded patch
    embeddings (B, num_patches, d) in front: S positions either way."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size,
                        (B, S - cfg.num_patches)).astype(np.int32)
    patches = None
    if cfg.num_patches:
        patches = (0.02 * rng.standard_normal(
            (B, cfg.num_patches, cfg.d_model))).astype(np.float32)
    return toks, patches


def _close(got, want) -> None:
    np.testing.assert_allclose(np.asarray(got), np.asarray(want, np.float32),
                               rtol=TOL, atol=TOL)


def test_the_layouts_are_the_published_ones():
    """The test configs keep every layout field of the full configs."""
    for arch in ARCHS:
        full, (jcfg, tcfg) = get_config(arch, "full"), _cfgs(arch)
        assert tcfg.__dict__ == jcfg.__dict__
        for field in ("num_heads", "num_kv_heads", "head_dim", "qkv_bias",
                      "rope_mode", "mrope_sections", "rope_theta",
                      "activation", "moe_experts", "moe_top_k",
                      "moe_shared_experts", "moe_every", "frontend"):
            assert getattr(tcfg, field) == getattr(full, field), field


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_parameter_count(arch):
    """At every depth phase 4l runs (the published one or its cut, and the
    float32 checks' cut), the reference's ``init_params`` count from
    ``jax.eval_shape`` equals the port's ``Transformer`` built on the meta
    device and ``chip_smoke.ZOO_PARAMS``; nothing is allocated."""
    consts = _chip_smoke_constants()
    (layers, f32_layers), = [m[1:] for m in consts["ZOO_MODELS"]
                             if m[0] == arch]
    full = get_config(arch, "full")
    for depth in {layers or full.num_layers, f32_layers or layers
                  or full.num_layers}:
        jcfg = j_get_config(arch, "full").with_(num_layers=depth)
        shapes = jax.eval_shape(lambda: j_init_params(
            jcfg, jax.random.PRNGKey(0)))
        want = sum(math.prod(x.shape) for x in jax.tree.leaves(shapes))
        model = Transformer(full.with_(num_layers=depth), device="meta")
        assert sum(p.numel() for p in model.parameters()) == want
        assert consts["ZOO_PARAMS"][arch, depth] == want, (arch, depth)


@pytest.mark.parametrize("route", ["full", "chunked"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch, route):
    """Logits and the MoE aux loss over S positions (qwen2-vl: the patch
    prefix in front of the tokens). ``chunked`` lowers
    ``attn_chunk_threshold`` to S, so both packages take
    ``chunked_attention`` (the port's flash wrapper)."""
    kw = dict(attn_chunk=S, attn_chunk_threshold=S) \
        if route == "chunked" else {}
    jcfg, tcfg = _cfgs(arch, **kw)
    jp, tp = _params(arch)
    toks, patches = _inputs(tcfg)
    jkw = {} if patches is None else {"extra_embeds": jnp.asarray(patches)}
    tkw = {} if patches is None else {
        "extra_embeds": torch.from_numpy(patches)}
    want, jaux = j_forward(jp, jnp.asarray(toks), jcfg, **jkw)
    with torch.inference_mode():
        got, aux = forward(tp, torch.from_numpy(toks), tcfg, **tkw)
    assert tuple(got.shape) == (B, S, tcfg.vocab_size)
    assert abs(float(aux) - float(jaux)) <= 1e-6
    _close(got, want)


def _grid_positions(cfg) -> np.ndarray:
    """M-RoPE's (t, h, w) streams: the patch prefix as a 2 x 4 grid at
    t = 0, the text after it at t = h = w, counting on from the grid's
    largest index, as Qwen2-VL numbers an image and its caption. Streams
    that differ make the rotation depend on the sections' split."""
    rows, cols = 2, cfg.num_patches // 2
    grid = [(0, i // cols, i % cols) for i in range(cfg.num_patches)]
    start = max(rows, cols)
    text = [(start + j,) * 3 for j in range(S - cfg.num_patches)]
    return np.broadcast_to(np.array(grid + text, np.int32),
                           (B, S, 3)).copy()


@pytest.mark.parametrize("route", ["full", "chunked"])
def test_mrope_sections_on_a_patch_grid_match_jax(route):
    """qwen2-vl's sections (16, 24, 24) on positions whose three streams
    differ (:func:`_grid_positions`), on both attention routes."""
    kw = dict(attn_chunk=S, attn_chunk_threshold=S) \
        if route == "chunked" else {}
    jcfg, tcfg = _cfgs("qwen2-vl-2b", **kw)
    assert tcfg.mrope_sections == (16, 24, 24)
    jp, tp = _params("qwen2-vl-2b")
    toks, patches = _inputs(tcfg)
    pos = _grid_positions(tcfg)
    want, _ = j_forward(jp, jnp.asarray(toks), jcfg,
                        positions=jnp.asarray(pos),
                        extra_embeds=jnp.asarray(patches))
    with torch.inference_mode():
        got, _ = forward(tp, torch.from_numpy(toks), tcfg,
                         positions=torch.from_numpy(pos),
                         extra_embeds=torch.from_numpy(patches))
        text_only, _ = forward(tp, torch.from_numpy(toks), tcfg,
                               extra_embeds=torch.from_numpy(patches))
    _close(got, want)
    assert float((got - text_only).abs().max()) > 1e-3


def test_patch_prefix_moves_the_text_logits():
    """qwen2-vl's prefix reaches the text's logits through attention, in
    both packages alike: held to the reference above, and not the same as
    the forward of the tokens alone."""
    jcfg, tcfg = _cfgs("qwen2-vl-2b")
    _, tp = _params("qwen2-vl-2b")
    toks, patches = _inputs(tcfg)
    with torch.inference_mode():
        with_prefix, _ = forward(tp, torch.from_numpy(toks), tcfg,
                                 extra_embeds=torch.from_numpy(patches))
        alone, _ = forward(tp, torch.from_numpy(toks), tcfg)
    moved = (with_prefix[:, tcfg.num_patches:] - alone).abs().max()
    assert float(moved) > 1e-3


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_jax(arch):
    """Six greedy decode steps fed the reference's tokens: the same logits
    and argmax (qwen2-vl decodes text, as both engines serve it)."""
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(arch)
    jcache = j_init_cache(jcfg, B, max_len=16)
    tcache = init_cache(tcfg, B, max_len=16, device="cpu")
    jtok = jnp.asarray(_inputs(tcfg)[0][:, :1])
    for _ in range(6):
        want, jcache = j_decode_step(jp, jcache, jtok, jcfg)
        with torch.inference_mode():
            got, tcache = decode_step(tp, tcache,
                                      torch.from_numpy(np.array(jtok)), tcfg)
        _close(got, want)
        jtok = jnp.argmax(want[:, -1:], axis=-1).astype(jnp.int32)
        np.testing.assert_array_equal(
            torch.argmax(got[:, -1:], dim=-1).numpy(), np.asarray(jtok))
    assert tcache["pos"] == int(jcache["pos"]) == 6


def _window_cfgs():
    jcfg, tcfg = _cfgs("qwen2-7b")
    return (jcfg.long_context_variant(WINDOW),
            tcfg.long_context_variant(WINDOW))


def _reference_steps(jcfg, jp, toks, max_len):
    """The reference's logits of each decode step over ``toks``."""
    cache = j_init_cache(jcfg, toks.shape[0], max_len=max_len)
    out = []
    for t in range(toks.shape[1]):
        lg, cache = j_decode_step(jp, cache, jnp.asarray(toks[:, t:t + 1]),
                                  jcfg)
        out.append(np.asarray(lg[:, 0]))
    return np.stack(out, axis=1)


def test_window_ring_decode_matches_jax():
    """qwen2-7b's ``long_context_variant`` (the window cut to 16): 2.5
    windows of decode steps through a ring of 16 slots, which wraps twice,
    each step's logits the reference's."""
    jcfg, tcfg = _window_cfgs()
    jp, tp = _params("qwen2-7b")
    toks = _inputs(tcfg)[0][:, :40]
    want = _reference_steps(jcfg, jp, toks, max_len=64)
    cache = init_cache(tcfg, B, max_len=64, device="cpu")
    assert cache["layers"][0]["k"].shape[1] == WINDOW
    with torch.inference_mode():
        for t in range(toks.shape[1]):
            got, cache = decode_step(tp, cache,
                                     torch.from_numpy(toks[:, t:t + 1]),
                                     tcfg)
            _close(got[:, 0], want[:, t])


@pytest.mark.parametrize("prompt", [12, 40])
def test_window_prefill_into_the_ring_matches_jax(prompt):
    """The port's cache-filling prefill (``forward(..., cache=)``) of a
    prompt inside the window and of one 2.5 windows long (its last 16
    positions kept in the ring), then decode steps past the window: the
    prefill's last logits and every step's those of the reference's steps
    over the same tokens, and the ring the steps' ring."""
    jcfg, tcfg = _window_cfgs()
    jp, tp = _params("qwen2-7b")
    toks = _inputs(tcfg)[0][:, :prompt + 20]
    want = _reference_steps(jcfg, jp, toks, max_len=64)
    cache = init_cache(tcfg, B, max_len=64, device="cpu")
    stepped = init_cache(tcfg, B, max_len=64, device="cpu")
    with torch.inference_mode():
        lg, _ = forward(tp, torch.from_numpy(toks[:, :prompt]), tcfg,
                        cache=cache)
        for t in range(prompt):
            decode_step(tp, stepped, torch.from_numpy(toks[:, t:t + 1]),
                        tcfg)
        assert cache["pos"] == stepped["pos"] == prompt
        for got, ring in zip(cache["layers"], stepped["layers"]):
            for name in ("k", "v"):
                torch.testing.assert_close(got[name], ring[name], rtol=TOL,
                                           atol=TOL)
        _close(lg[:, -1], want[:, prompt - 1])
        for t in range(prompt, toks.shape[1]):
            got, cache = decode_step(tp, cache,
                                     torch.from_numpy(toks[:, t:t + 1]),
                                     tcfg)
            _close(got[:, 0], want[:, t])


def test_engine_bulk_prefill_generates_the_reference_tokens():
    """``Engine.generate`` at the window layout, a prompt past the window:
    the port's engine fills the ring in one forward, the reference's steps
    the prompt, and the greedy tokens are the same."""
    jcfg, tcfg = _window_cfgs()
    jp, tp = _params("qwen2-7b")
    prompts = _inputs(tcfg)[0][:, :24]
    want, _ = JEngine(JServeConfig(jcfg, B, 40), params=jp).generate(
        jnp.asarray(prompts), 10)
    engine = Engine(ServeConfig(tcfg, B, 40), params=tp, device="cpu")
    assert engine.prefills_in_one_forward
    tokens, _ = engine.generate(torch.from_numpy(prompts), 10)
    assert engine.cache["pos"] == 24 + 9
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_generates_the_reference_tokens(arch):
    """``Engine.generate`` at each published layout against the reference
    engine's greedy tokens: the dense decoders' prompts go through one
    forward that fills the cache, deepseek's (MoE blocks) are stepped as
    the reference steps them."""
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(arch)
    prompts = _inputs(tcfg)[0][:, :12]
    want, _ = JEngine(JServeConfig(jcfg, B, 32), params=jp).generate(
        jnp.asarray(prompts), 8)
    engine = Engine(ServeConfig(tcfg, B, 32), params=tp, device="cpu")
    assert engine.prefills_in_one_forward == (not tcfg.moe_experts)
    tokens, _ = engine.generate(torch.from_numpy(prompts), 8)
    assert engine.cache["pos"] == 12 + 7
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(want))


def test_bulk_prefill_refuses_what_it_cannot_fill():
    """No SSM state, cross K/V or MoE block is filled (an MoE prefill at
    its capacity drops slots that decode steps keep), a cache is filled
    from empty, and a cache without a window must hold the whole
    prompt."""
    _, tcfg = _cfgs("qwen2-7b")
    _, tp = _params("qwen2-7b")
    toks = torch.from_numpy(_inputs(tcfg)[0][:, :12])
    with torch.inference_mode():
        short = init_cache(tcfg, B, max_len=8, device="cpu")
        with pytest.raises(ValueError, match="past the cache"):
            forward(tp, toks, tcfg, cache=short)
        cache = init_cache(tcfg, B, max_len=16, device="cpu")
        forward(tp, toks, tcfg, cache=cache)
        with pytest.raises(ValueError, match="empty cache"):
            forward(tp, toks, tcfg, cache=cache)
    for arch in ("mamba2-130m", "jamba-v0.1-52b", "whisper-large-v3",
                 "qwen2-moe-a2.7b", "deepseek-moe-16b"):
        cfg = get_config(arch, "smoke")
        assert not fills_cache(cfg)
        with pytest.raises(ValueError, match="attention layers only"):
            forward(None, toks, cfg,
                    cache=init_cache(cfg, B, max_len=16, device="cpu"))
