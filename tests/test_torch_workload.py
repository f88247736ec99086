"""The port's workload compiler (``repro_torch.core.workload``) and
``launch.analysis`` against the JAX package's.

Both are jax-free copies: each file must differ from its reference only in
its imports, apart from ``timeline.py``'s hardware defaults, which the port
takes from ``repro_torch.launch.mesh`` (the NVIDIA H100's constants) where
the reference wrote TPU v5e literals. Given the same explicit ``HostSpec``,
both packages must predict the same thing, field for field. The compiler's
gradient bytes are held against the port model's own gradients.
"""
import dataclasses
import difflib
import enum
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import workload as ref_workload
from repro.launch import analysis as ref_analysis
from repro.models import get_config as ref_get_config

from repro_torch.core import workload as port_workload
from repro_torch.data import DataConfig, batch_at
from repro_torch.launch import analysis as port_analysis
from repro_torch.launch import mesh
from repro_torch.models import Transformer, get_config, init_params
from repro_torch.train import TrainConfig, make_loss_fn, value_and_grad

SRC = Path(__file__).resolve().parents[1] / "src"
COPIED = ("core/workload/__init__.py", "core/workload/model_comm.py",
          "core/workload/predictor.py", "core/workload/scenarios.py",
          "core/workload/timeline.py", "launch/analysis.py")
# timeline.py's hardware defaults: from the docstring's last paragraph to
# HostSpec's mfu field, the reference's v5e literals and the port's import
# of the H100's
HOST_BLOCK = ("Hardware defaults are", "mfu: float = 0.4")
SCENARIOS = ("whisper/fat_tree", "llama3-dense/three_tier")


def _module(rel: str, root: str) -> str:
    parts = [root] + rel[:-3].split("/")
    return ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


def _resolve_import(line: str, module: str, is_pkg: bool):
    """``(absolute module, names)`` of a ``from X import Y`` line, with
    ``repro_torch`` read as ``repro``; ``None`` for any other line."""
    s = line.strip()
    if not s.startswith("from ") or " import " not in s:
        return None
    src, names = s[5:].split(" import ", 1)
    if src.startswith("."):
        dots = len(src) - len(src.lstrip("."))
        base = module.split(".")
        base = base if is_pkg else base[:-1]
        base = base[:len(base) - (dots - 1)]
        src = ".".join(base + ([src[dots:]] if src[dots:] else []))
    if src.split(".")[0] == "repro_torch":
        src = "repro" + src[len("repro_torch"):]
    return src, names.strip()


def _host_block(lines) -> set:
    """0-based indices of timeline.py's hardware-defaults block."""
    start = next(i for i, s in enumerate(lines) if HOST_BLOCK[0] in s)
    end = next(i for i, s in enumerate(lines) if HOST_BLOCK[1] in s)
    return set(range(start, end + 1))


@pytest.mark.parametrize("rel", COPIED)
def test_copied_module_differs_only_in_imports(rel):
    ref_lines = (SRC / "repro" / rel).read_text().splitlines()
    port_lines = (SRC / "repro_torch" / rel).read_text().splitlines()
    is_pkg = rel.endswith("__init__.py")
    ref_mod, port_mod = _module(rel, "repro"), _module(rel, "repro_torch")
    ref_free = port_free = set()
    if rel.endswith("timeline.py"):
        ref_free, port_free = _host_block(ref_lines), _host_block(port_lines)
        assert any("_V5E_" in ref_lines[i] for i in ref_free)
        assert not any("V5E" in s or "v5e" in s for s in port_lines)
    sm = difflib.SequenceMatcher(a=ref_lines, b=port_lines, autojunk=False)
    for tag, i1, i2, j1, j2 in sm.get_opcodes():
        if tag == "equal":
            continue
        old = [_resolve_import(ref_lines[i], ref_mod, is_pkg)
               for i in range(i1, i2) if i not in ref_free]
        new = [_resolve_import(port_lines[j], port_mod, is_pkg)
               for j in range(j1, j2) if j not in port_free]
        assert None not in old + new and old == new, (
            f"{rel}: lines {i1 + 1}-{i2} of the reference differ beyond "
            f"imports:\n" + "\n".join(difflib.unified_diff(
                ref_lines[i1:i2], port_lines[j1:j2], lineterm="")))


def test_import_pulls_in_neither_jax_nor_the_reference():
    """In a fresh interpreter: no ``jax``, no ``repro``, no ``triton``, and
    no kernel built or loaded."""
    code = (
        "import sys\n"
        "import repro_torch.core.workload, repro_torch.launch.analysis\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro', 'triton')]\n"
        "b = sys.modules.get('repro_torch.kernels._build')\n"
        "print(bad, b is None or b._build is None)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True,
                         env=dict(os.environ, PYTHONPATH=str(SRC)))
    assert out.stdout.strip() == "[] True", out.stdout + out.stderr


def test_host_spec_defaults_are_the_h100s():
    spec = port_workload.HostSpec()
    assert (spec.peak_flops, spec.hbm_bw) == (mesh.PEAK_FLOPS_BF16,
                                              mesh.HBM_BW) == (989e12, 3.35e12)
    assert spec.mfu == ref_workload.HostSpec().mfu == 0.4


def _plain(x):
    """A comparable form of a result: dataclasses and objects by class name
    and fields, NaN as a string (NaN != NaN)."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__, [(f.name, _plain(getattr(x, f.name)))
                                   for f in dataclasses.fields(x)])
    if isinstance(x, enum.Enum):
        return (type(x).__name__, x.value)
    if isinstance(x, dict):
        return [(_plain(k), _plain(v)) for k, v in x.items()]
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, float) and math.isnan(x):
        return "nan"
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    return (type(x).__name__, _plain(vars(x)))


def _hosts():
    """The port's default HostSpec, and the reference's with its values."""
    port = port_workload.HostSpec()
    return port, ref_workload.HostSpec(**dataclasses.asdict(port))


@pytest.mark.parametrize("name", SCENARIOS)
@pytest.mark.parametrize("variant", ["smoke", "full"])
def test_compiler_matches_the_reference(name, variant):
    """``grad_segments``, ``pack_buckets`` and ``build_timeline`` of the
    scenario's model (its smoke config and the published one) equal the
    reference's exactly under the same HostSpec."""
    s = port_workload.get_scenario(name)
    port_cfg, ref_cfg = get_config(s.arch, variant), ref_get_config(
        s.arch, variant)
    port_host, ref_host = _hosts()
    assert _plain(port_workload.grad_segments(port_cfg)) == _plain(
        ref_workload.grad_segments(ref_cfg))
    kw = dict(bucket_bytes=s.bucket_bytes, expert_sharding=s.expert_sharding)
    plans = (port_workload.pack_buckets(port_cfg, **kw),
             ref_workload.pack_buckets(ref_cfg, **kw))
    assert _plain(plans[0]) == _plain(plans[1])
    shape = dict(seq=s.seq, global_batch=s.global_batch, dp_hosts=s.dp_hosts)
    assert _plain(port_workload.build_timeline(
        port_cfg, plans[0], host=port_host, **shape)) == _plain(
        ref_workload.build_timeline(ref_cfg, plans[1], host=ref_host,
                                    **shape))
    for kind in ("train", "prefill", "decode"):
        assert port_analysis.model_flops_per_step(
            port_cfg, kind, s.seq, s.global_batch) == \
            ref_analysis.model_flops_per_step(ref_cfg, kind, s.seq,
                                              s.global_batch)


@pytest.mark.parametrize("name", SCENARIOS)
def test_predict_scenario_matches_the_reference(name):
    """One simulated iteration of the scenario: every field of the
    prediction (plan, timeline, buckets, the simulator's result) equal."""
    port_host, ref_host = _hosts()
    got = port_workload.predict_scenario(name, host=port_host)
    want = ref_workload.predict_scenario(name, host=ref_host)
    assert got.correct and got.summary() == want.summary()
    assert _plain(got) == _plain(want)


def test_parse_collective_bytes_matches_the_reference():
    hlo = ("%all-reduce.1 = bf16[1024,512]{1,0} all-reduce(%x)\n"
           "%ag = f32[8,4]{1,0} all-gather(%y)\n"
           "%cp = s32[16]{0} collective-permute(%z)\n")
    assert port_analysis.parse_collective_bytes(hlo) == \
        ref_analysis.parse_collective_bytes(hlo)


def _omitted(names):
    """The parameters ``ModelConfig.param_count()`` leaves out, by name: the
    final norm, the encoder's norm and each decoder layer's cross norm."""
    return [n for n in names if n in ("final_norm.scale", "enc_norm.scale")
            or n.endswith(".norm_cross.scale")]


@pytest.mark.parametrize("arch", ["llama3.2-1b", "whisper-large-v3"])
def test_grad_bytes_are_the_compilers_plus_the_omitted_norms(arch):
    """The smoke model's float32 gradients from one loss on the CPU, and
    the published model's parameters (on the meta device): their bytes are
    ``total_dp_grad_bytes(cfg, grad_dtype="float32")`` plus 4 bytes for
    each parameter of the named norms that the compiler leaves out."""
    cfg = get_config(arch, "smoke").with_(dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = batch_at(DataConfig(cfg.vocab_size, 2, 8), 0)
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    if cfg.is_encoder_decoder:
        batch["frames"] = torch.full((2, cfg.encoder_seq, cfg.d_model), 0.02)
    _, grads = value_and_grad(make_loss_fn(TrainConfig(model=cfg)), params,
                              batch)
    omitted = _omitted(grads)
    assert len(omitted) == (cfg.num_layers + 2 if cfg.is_encoder_decoder
                            else 1)
    extra = sum(grads[n].numel() for n in omitted)
    assert sum(4 * g.numel() for g in grads.values()) == \
        port_workload.total_dp_grad_bytes(cfg, grad_dtype="float32") \
        + 4 * extra
    full = get_config(arch, "full")
    named = dict(Transformer(full, device="meta").named_parameters())
    extra = sum(named[n].numel() for n in _omitted(named))
    assert extra == {"llama3.2-1b": 2048, "whisper-large-v3": 43520}[arch]
    assert sum(4 * p.numel() for p in named.values()) == \
        port_workload.total_dp_grad_bytes(full, grad_dtype="float32") \
        + 4 * extra
    assert np.isfinite([float(g.abs().max()) for g in grads.values()]).all()
