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

os.environ.setdefault("JAX_PLATFORMS", "cpu")
from dryrun_reference import JaxRun  # noqa: E402
from test_torch_dryrun import (FLOPS_BOUND, LINK_BOUND,  # noqa: E402
                               TEMP_BOUND)
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch.analysis import INPUT_SHAPES  # noqa: E402
from repro_torch.launch.mesh import (PRODUCTION_SHAPES,  # noqa: E402
                                     make_production_mesh, mesh_axes)
from repro_torch.models import get_config, list_archs  # noqa: E402
from repro_torch.models.transformer import layer_period  # noqa: E402
from repro_torch.parallel import ParallelContext, parallel_context  # noqa

HYBRID = "jamba-v0.1-52b"        # the slowest on both sides: compiled last


def case(arch, shape, mesh="single", grad_sync="auto", seq_parallel=False,
         moe_impl=""):
    """One probe: the arch, the shape, the production mesh (``"single"``,
    (16, 16), or ``"multi"``, (2, 16, 16)) and the CLI's modes."""
    return (arch, shape, mesh, grad_sync, seq_parallel, moe_impl)


def case_id(c):
    """``arch-shape``, then each mode that is not the default."""
    arch, shape, mesh, grad_sync, seq_parallel, moe_impl = c
    parts = [arch, shape] + (["2x16x16"] if mesh == "multi" else []) \
        + ([grad_sync] if grad_sync != "auto" else []) \
        + (["sp"] if seq_parallel else []) + ([moe_impl] if moe_impl else [])
    return "-".join(parts)


CASES = [case(arch, "train_4k") for arch in sorted(list_archs())
         if arch != HYBRID] + [case("qwen2-moe-a2.7b", "prefill_32k"),
                               case("mamba2-130m", "prefill_32k"),
                               case(HYBRID, "train_4k")]

JAX_SCRIPT = r"""
import json, sys
import repro.launch.dryrun as R
import jax
from dryrun_reference import costs, link_bytes
from repro.launch.mesh import make_production_mesh, mesh_axes
from repro.models import get_config
from repro.models.transformer import layer_period
from repro.parallel.context import ParallelContext, parallel_context

meshes = {m: make_production_mesh(multi_pod=m == "multi")
          for m in ("single", "multi")}
for key, (arch, shape, m, grad_sync, sp, moe_impl) in json.loads(sys.argv[1]):
    mesh = meshes[m]
    dp, ma = mesh_axes(mesh)
    full = get_config(arch)
    over = dict(num_layers=layer_period(full), scan_layers=False,
                remat=False)
    if full.is_encoder_decoder:
        over["encoder_layers"] = 1

    def probe(sp):
        with parallel_context(ParallelContext(mesh=mesh, data_axes=dp,
                                              model_axis=ma,
                                              sequence_parallel=sp)):
            fn, args, _ = R.build_dryrun(arch, shape, mesh,
                                         grad_sync=grad_sync,
                                         cfg_override=full.with_(**over),
                                         moe_impl=moe_impl)
            c = jax.jit(fn).lower(*args).compile()
        return c.as_text(), c.memory_analysis()

    hlo, ma_ = probe(sp)
    flops, moved = costs(hlo)
    row = dict(flops=flops, link=link_bytes(moved),
               temp=ma_.temp_size_in_bytes,
               args=ma_.argument_size_in_bytes)
    if sp:      # the attention's scans, and as compiled without sp
        for name, text in (("loop", hlo), ("plain_loop", probe(False)[0])):
            f, b = costs(text, loops=True)
            row[name + "_flops"], row[name + "_link"] = f, link_bytes(b)
    print(f"JAX_CASE {key} " + json.dumps(row), flush=True)
"""


def reference_run(cases, timeout=900):
    """The reference's compiled probe of every case, in one JAX subprocess
    that reports each as it is done (``JaxRun.case(case_id(c))``)."""
    return JaxRun(JAX_SCRIPT, [[case_id(c), list(c)] for c in cases],
                  timeout=timeout)


def _probe_cfg(arch):
    """The reference's probe config: one layer period of the full config,
    unrolled, no remat."""
    full = get_config(arch)
    over = dict(num_layers=layer_period(full), scan_layers=False,
                remat=False)
    if full.is_encoder_decoder:
        over["encoder_layers"] = 1
    return full.with_(**over)


def _account(arch, shape, mesh="single", grad_sync="auto",
             seq_parallel=False, moe_impl=""):
    shape_, _ = PRODUCTION_SHAPES[mesh == "multi"]
    with D.fake_process_group(D._world(shape_)):
        m = make_production_mesh(multi_pod=mesh == "multi",
                                 device_type="cpu")
        dp, model = mesh_axes(m)
        with parallel_context(ParallelContext(mesh=m, data_axes=dp,
                                              model_axis=model,
                                              sequence_parallel=seq_parallel)):
            fn, args, _ = D.build_dryrun(arch, shape, m, grad_sync=grad_sync,
                                         cfg_override=_probe_cfg(arch),
                                         moe_impl=moe_impl, device="cpu")
            return D.account(fn, args)


def hold(reference, c):
    """One period of case ``c`` against the reference's compiled probe:
    FLOPs (the flash calls counted as the reference's attention issues
    them), temporaries and collective link bytes within the small steps'
    bounds, no collective left uncounted, and each rank's argument bytes
    the reference's (a decode's less its cache's 4-byte position).

    Under ``--seq-parallel`` GSPMD lays the chunked attention's two scans
    (the only while bodies of a one-period probe) out along the sequence
    the model axis splits, which their 1024-token blocks cut across: the
    dots inside the scans issue exactly 3 times the FLOPs they issue
    without it, which this asserts on the HLO, and their collectives move
    88 (llama) and 128 (nemotron) times the bytes. The port lays its
    attention out as it does without sequence parallelism (whole
    sequences, split over the model axis with the batch), so there the
    reference's scans, FLOPs and link bytes, are those it compiles without
    ``--seq-parallel``; the rest of the step is held to the one with it."""
    shape, seq_parallel = c[1], c[4]
    got = _account(*c)
    want = dict(reference.case(case_id(c)))
    if seq_parallel:
        assert want["loop_flops"] == 3 * want["plain_loop_flops"], want
        for k in ("flops", "link"):
            want[k] += want[f"plain_loop_{k}"] - want[f"loop_{k}"]
    ratios = {"kernel_flops": got["flops"] / want["flops"],
              "temp": got["memory"]["temp_bytes"] / want["temp"],
              "link": got["collective_link_bytes"] / want["link"]}
    att = got["attention_flops"]
    ratios["flops"] = (got["flops"] - att["kernel"] + att["all_pairs"]) \
        / want["flops"]
    pos = 4 if INPUT_SHAPES[shape]["kind"] == "decode" else 0
    print(f"{case_id(c)}: port / reference {ratios}, reference "
          f"{want['flops'] / 1e12:.3f} TFLOP/dev, argument bytes port - "
          f"reference {got['memory']['argument_bytes'] - want['args']}",
          flush=True)
    assert not got["unknown_collectives"], got["unknown_collectives"]
    assert got["memory"]["argument_bytes"] == want["args"] - pos
    assert FLOPS_BOUND[0] <= ratios["flops"] <= FLOPS_BOUND[1], ratios
    assert TEMP_BOUND[0] <= ratios["temp"] <= TEMP_BOUND[1], ratios
    assert LINK_BOUND[0] <= ratios["link"] <= LINK_BOUND[1], ratios


def period_tests(cases, open_cases=None):
    """A module's fixture ``reference`` (the reference's probes of
    ``cases``, compiled in one subprocess) and its test of each case
    (:func:`hold`); a case of ``open_cases`` is a strict ``xfail`` whose
    reason is its entry. A module assigns both to its own names."""
    open_cases = open_cases or {}

    @pytest.fixture(scope="module")
    def reference():
        run = reference_run(cases)
        yield run
        run.close()

    @pytest.mark.parametrize("c", [
        pytest.param(c, marks=pytest.mark.xfail(reason=open_cases[c],
                                                strict=True))
        if c in open_cases else c for c in cases],
        ids=[case_id(c) for c in cases])
    def test_period(reference, c):
        """One layer period against the reference's compiled probe."""
        hold(reference, c)

    return reference, test_period


# each case's id is ``arch-shape`` (one mesh, no mode)
reference, test_production_period_against_reference = period_tests(CASES)


NESTED_HLO = """HloModule nested

%inner (ip: (s32[], f32[4,8])) -> (s32[], f32[4,8]) {
  %ip = (s32[], f32[4,8]{1,0}) parameter(0)
  %ia = f32[4,8]{1,0} get-tuple-element(%ip), index=1
  %iw = f32[8,8]{1,0} constant(0)
  %idot = f32[4,8]{1,0} dot(%ia, %iw), lhs_contracting_dims={1}, rhs_contracting_dims={0}
  %iar = f32[4,8]{1,0} all-reduce(%idot), replica_groups={{0,1}}, to_apply=%sum
  ROOT %it = (s32[], f32[4,8]{1,0}) tuple(%ia, %iar)
}

%outer (op: (s32[], f32[4,8])) -> (s32[], f32[4,8]) {
  %op = (s32[], f32[4,8]{1,0}) parameter(0)
  %oa = f32[4,8]{1,0} get-tuple-element(%op), index=1
  %ow = f32[8,8]{1,0} constant(0)
  %odot = f32[4,8]{1,0} dot(%oa, %ow), lhs_contracting_dims={1}, rhs_contracting_dims={0}
  %iwhile = (s32[], f32[4,8]{1,0}) while(%op), condition=%cond, body=%inner, backend_config={"known_trip_count":{"n":"5"}}
  ROOT %ot = (s32[], f32[4,8]{1,0}) tuple(%oa, %odot)
}

%fused (fp: f32[4,8]) -> f32[4,8] {
  %fp = f32[4,8]{1,0} parameter(0)
  %fw = f32[8,8]{1,0} constant(0)
  ROOT %fdot = f32[4,8]{1,0} dot(%fp, %fw), lhs_contracting_dims={1}, rhs_contracting_dims={0}
}

ENTRY %main (x: f32[4,8]) -> f32[4,8] {
  %x = f32[4,8]{1,0} parameter(0)
  %f = f32[4,8]{1,0} fusion(%x), kind=kOutput, calls=%fused
  %t = (s32[], f32[4,8]{1,0}) tuple(%x, %f)
  %owhile = (s32[], f32[4,8]{1,0}) while(%t), condition=%cond, body=%outer, backend_config={"known_trip_count":{"n":"3"}}
  ROOT %r = f32[4,8]{1,0} get-tuple-element(%owhile), index=1
}
"""


def test_costs_counts_nested_while_bodies():
    """``dryrun_reference.costs`` counts each computation as often as it
    runs: a fusion's dot once, the outer while body's dot 3 times, the
    inner body's dot and all-reduce 3 x 5 times (a 4 x 8 by 8 x 8 dot is
    512 FLOPs; the all-reduce moves 128 bytes); with ``loops``, all but the
    fusion's dot, which runs outside every while body."""
    from dryrun_reference import costs, link_bytes
    flops, moved = costs(NESTED_HLO)
    assert flops == 512 * (1 + 3 + 3 * 5)
    assert moved["all-reduce"] == 128 * 3 * 5
    assert link_bytes(moved) == 2 * 128 * 3 * 5
    assert sum(moved.values()) == moved["all-reduce"]
    flops, looped = costs(NESTED_HLO, loops=True)
    assert flops == 512 * (3 + 3 * 5)
    assert looped == moved
