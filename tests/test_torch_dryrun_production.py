"""The dry run's production rows against the reference's own: one layer
period of each arch at full width on the production mesh (16, 16).

Each case builds, on both sides, what the reference's cost probes
(``repro.launch.dryrun._probe_costs``) lower: the full config cut to one
layer period (``layer_period``; an encoder-decoder also to one encoder
layer), ``scan_layers=False``, ``remat=False``, the step of ``train_4k``
(and the ``prefill_32k`` forward of the dense-route MoE and Mamba-2 archs).

* Reference: every case compiled in one JAX subprocess on the CPU (512
  host devices, which ``repro.launch.dryrun`` forces at import), counted by
  ``dryrun_reference.costs``: the dots' FLOPs, each while body times its
  trip count, and the collectives' link bytes; temporaries from
  ``memory_analysis()``.
* Port: :func:`D.account` as rank 0 of the fake process group, as the
  small steps of ``test_torch_dryrun.py`` are counted.

The bounds are that file's. FLOPs count the same attention on both sides:
where the port runs its flash kernel (every config from 4096 tokens), its
FLOPs are the kernel's live pairs and a backward that recomputes the
probabilities, while the reference's ``chunked_attention`` issues every
block's products, masked or not, and keeps the forward's probabilities; the
port's flash calls are therefore counted as the reference's issues them
(``attention_flops["all_pairs"]``), at the port's own layout of each call.

At this size the model axis divides few counts (qwen2-moe's 60 experts and
capacity 87384, mamba2-130m's 3352 projection columns and 24 heads, the
vocabularies of mamba2-130m and whisper-large-v3, the heads of qwen2-7b,
qwen2-vl-2b and whisper-large-v3), so the uneven layouts GSPMD gives these
products show only here. The reference compiles while the port traces:
each case waits only for its own compile, which the subprocess reports as
soon as it is done.
"""
import os

import pytest
from torch.distributed.device_mesh import init_device_mesh

os.environ.setdefault("JAX_PLATFORMS", "cpu")
from dryrun_reference import JaxRun  # noqa: E402
from test_torch_dryrun import (FLOPS_BOUND, LINK_BOUND,  # noqa: E402
                               TEMP_BOUND)
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch.mesh import mesh_axes  # noqa: E402
from repro_torch.models import get_config, list_archs  # noqa: E402
from repro_torch.models.transformer import layer_period  # noqa: E402
from repro_torch.parallel import ParallelContext, parallel_context  # noqa

MESH = (16, 16)
HYBRID = "jamba-v0.1-52b"        # the slowest on both sides: compiled last
CASES = [(arch, "train_4k") for arch in sorted(list_archs())
         if arch != HYBRID] + [("qwen2-moe-a2.7b", "prefill_32k"),
                               ("mamba2-130m", "prefill_32k"),
                               (HYBRID, "train_4k")]
# the reference lays whisper-large-v3's attention output projections out
# with d split over the model axis (wo's share of its (data, model) split),
# keeping the residual split into the cross-attention's query projection,
# which then contracts a split d; the port gathers wo over the model axis,
# as the reference does for qwen2-7b, so those products run whole: FLOPs
# 1.095 of the reference's (temporaries 0.502, link bytes 0.704)
OPEN = {("whisper-large-v3", "train_4k"):
        "the attention output projections whole on each model rank, where "
        "the reference splits their d over the model axis: FLOPs 1.095"}

JAX_SCRIPT = r"""
import json, sys
import repro.launch.dryrun as R
import jax
from dryrun_reference import costs, link_bytes
from repro.launch.mesh import make_production_mesh, mesh_axes
from repro.models import get_config
from repro.models.transformer import layer_period
from repro.parallel.context import ParallelContext, parallel_context

mesh = make_production_mesh(multi_pod=False)
dp, ma = mesh_axes(mesh)
for arch, shape in json.loads(sys.argv[1]):
    full = get_config(arch)
    over = dict(num_layers=layer_period(full), scan_layers=False,
                remat=False)
    if full.is_encoder_decoder:
        over["encoder_layers"] = 1
    with parallel_context(ParallelContext(mesh=mesh, data_axes=dp,
                                          model_axis=ma)):
        fn, args, _ = R.build_dryrun(arch, shape, mesh,
                                     cfg_override=full.with_(**over))
        c = jax.jit(fn).lower(*args).compile()
    flops, moved = costs(c.as_text())
    row = dict(flops=flops, link=link_bytes(moved),
               temp=c.memory_analysis().temp_size_in_bytes)
    print(f"JAX_CASE {arch}|{shape} " + json.dumps(row), flush=True)
    del fn, args, c
"""


@pytest.fixture(scope="module")
def reference():
    run = JaxRun(JAX_SCRIPT, [list(c) for c in CASES], timeout=900)
    yield run
    run.close()


def _probe_cfg(arch):
    """The reference's probe config: one layer period of the full config,
    unrolled, no remat."""
    full = get_config(arch)
    over = dict(num_layers=layer_period(full), scan_layers=False,
                remat=False)
    if full.is_encoder_decoder:
        over["encoder_layers"] = 1
    return full.with_(**over)


def _account(arch, shape):
    with D.fake_process_group(D._world(MESH)):
        mesh = init_device_mesh("cpu", MESH, mesh_dim_names=("data",
                                                             "model"))
        dp, model = mesh_axes(mesh)
        with parallel_context(ParallelContext(mesh=mesh, data_axes=dp,
                                              model_axis=model)):
            fn, args, _ = D.build_dryrun(arch, shape, mesh,
                                         cfg_override=_probe_cfg(arch),
                                         device="cpu")
            return D.account(fn, args)


@pytest.mark.parametrize("arch,shape", [
    pytest.param(*c, marks=pytest.mark.xfail(reason=OPEN[c], strict=True))
    if c in OPEN else c for c in CASES], ids=["-".join(c) for c in CASES])
def test_production_period_against_reference(reference, arch, shape):
    """One layer period's per-device FLOPs (the flash calls counted as the
    reference's attention issues them), temporaries and collective link
    bytes against the reference's compiled probe, within the small steps'
    bounds."""
    got = _account(arch, shape)
    want = reference.case(f"{arch}|{shape}")
    ratios = {"kernel_flops": got["flops"] / want["flops"],
              "temp": got["memory"]["temp_bytes"] / want["temp"],
              "link": got["collective_link_bytes"] / want["link"]}
    print(f"{arch} {shape}: port / reference {ratios}", flush=True)
    att = got["attention_flops"]
    ratios["flops"] = (got["flops"] - att["kernel"] + att["all_pairs"]) \
        / want["flops"]
    print(f"{arch} {shape}: FLOPs, the flash calls counted over every "
          f"pair: {ratios['flops']}")
    assert not got["unknown_collectives"]
    assert FLOPS_BOUND[0] <= ratios["flops"] <= FLOPS_BOUND[1], ratios
    assert TEMP_BOUND[0] <= ratios["temp"] <= TEMP_BOUND[1], ratios
    assert LINK_BOUND[0] <= ratios["link"] <= LINK_BOUND[1], ratios
