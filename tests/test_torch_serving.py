"""The port's serving engine and launcher against the JAX package's.

``Engine.generate`` on the llama3.2-1b and jamba smoke configs in float32
(jamba: Mamba-2 and attention layers, MoE and MLP blocks, K/V and SSM
caches), with the reference's weights carried across by
``params_from_reference``, must give the reference engine's greedy tokens
exactly: at float32 the logits agree to 1e-4
(``tests/test_torch_models.py``), far inside the gaps between the top two
logits of these prompts.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.models import get_config as j_get_config
from repro.models import init_params as j_init_params
from repro.serving import Engine as JEngine
from repro.serving import ServeConfig as JServeConfig
from repro_torch.convert import params_from_reference
from repro_torch.launch import serve
from repro_torch.models import get_config
from repro_torch.serving import Engine, ServeConfig


def _generate_both(arch: str) -> None:
    jcfg = j_get_config(arch, "smoke").with_(dtype="float32")
    tcfg = get_config(arch, "smoke").with_(dtype="float32")
    jp = j_init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_reference(jax.tree.map(np.asarray, jp), tcfg,
                               device="cpu")
    prompts = np.random.default_rng(1).integers(
        0, tcfg.vocab_size, (2, 8)).astype(np.int32)
    want, _ = JEngine(JServeConfig(model=jcfg, batch=2, max_len=32),
                      params=jp).generate(jnp.asarray(prompts), 8)
    engine = Engine(ServeConfig(model=tcfg, batch=2, max_len=32), params=tp,
                    device="cpu")
    got, stats = engine.generate(torch.from_numpy(prompts), 8)
    assert got.dtype == torch.int32 and tuple(got.shape) == (2, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert engine.cache["pos"] == 8 + 7
    assert stats["decode_tok_per_s"] > 0


def test_generate_matches_jax_engine():
    _generate_both("llama3.2-1b")


def test_generate_matches_jax_engine_hybrid():
    _generate_both("jamba-v0.1-52b")


def test_prefill_fn_is_the_forward():
    tcfg = get_config("llama3.2-1b", "smoke").with_(dtype="float32")
    engine = Engine(ServeConfig(model=tcfg, batch=1, max_len=16), seed=3,
                    device="cpu")
    toks = torch.arange(10, dtype=torch.int32)[None]
    logits, aux = engine.prefill_fn(engine.params, toks, {})
    assert logits.shape == (1, 10, tcfg.vocab_size)
    assert not logits.requires_grad
    last = engine.prefill(toks)
    assert torch.equal(last[:, 0], logits[:, -1].argmax(-1).to(torch.int32))


def test_serve_launcher_runs_on_cpu(capsys):
    serve.main(["--arch", "llama3.2-1b", "--batch", "2", "--prompt-len", "4",
                "--new-tokens", "3", "--max-len", "16", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "generated (2, 3) tokens"
    assert out[1].startswith("prefill ") and out[1].endswith(" tok/s")


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "mamba2-130m",
                                  "jamba-v0.1-52b", "whisper-large-v3"])
def test_serve_launcher_runs_moe_and_ssm_on_cpu(arch, capsys):
    serve.main(["--arch", arch, "--batch", "2", "--prompt-len", "5",
                "--new-tokens", "3", "--max-len", "16", "--device", "cpu"])
    assert capsys.readouterr().out.startswith("generated (2, 3) tokens")


def test_serve_launcher_sliding_window_on_cpu(capsys):
    serve.main(["--arch", "qwen2-7b", "--batch", "1", "--prompt-len", "6",
                "--new-tokens", "4", "--max-len", "16", "--sliding-window",
                "4", "--device", "cpu"])
    assert capsys.readouterr().out.startswith("generated (1, 4) tokens")


def test_engine_needs_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("llama3.2-1b", "smoke")
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(ServeConfig(model=cfg, batch=1, max_len=8))
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "llama3.2-1b"])
