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
  trip count, the collectives' link bytes and the bytes accessed;
  temporaries from ``memory_analysis()``.
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
import math
import os
from collections import Counter

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
from dryrun_reference import (JaxRun, cache_kv,  # noqa: E402
                              held_bytes, new_cache_bytes)
from test_torch_dryrun import (BYTES_BOUND, FLOPS_BOUND,  # noqa: E402
                               LINK_BOUND, TEMP_BOUND)
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch.analysis import INPUT_SHAPES  # noqa: E402
from repro_torch.launch.mesh import (PRODUCTION_SHAPES,  # noqa: E402
                                     make_production_mesh, mesh_axes)
from repro_torch.models import get_config, list_archs  # noqa: E402
from repro_torch.models import Transformer  # noqa: E402
from repro_torch.models.transformer import layer_period  # noqa: E402
from repro_torch.parallel import (ParallelContext, param_specs,  # noqa
                                  parallel_context)

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
from dryrun_reference import (accessed, bf16_dots, collectives, costs,
                              dense_combine, link_bytes, new_caches,
                              router_layout)
from repro.launch.analysis import INPUT_SHAPES
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
        return c.as_text(), c.memory_analysis(), c

    hlo, ma_, c = probe(sp)
    flops, moved, acc = costs(hlo)
    row = dict(flops=flops, link=link_bytes(moved),
               temp=ma_.temp_size_in_bytes,
               args=ma_.argument_size_in_bytes,
               accessed=acc, bf16_dots=bf16_dots(hlo),
               loops=hlo.count(" while("),
               once=accessed(hlo, once=True)["all"],
               cost_analysis=c.cost_analysis()["bytes accessed"],
               router=router_layout(hlo))
    if sp:      # the attention's scans, and as compiled without sp
        for name, text in (("loop", hlo), ("plain_loop", probe(False)[0])):
            f, b, a = costs(text, loops=True)
            row[name + "_flops"], row[name + "_link"] = f, link_bytes(b)
            row[name + "_scans"] = a["scans"]
    if grad_sync == "canary_fp":    # the quantizer's loops, the trees
        cs = collectives(hlo)
        row["quantizer"] = [c for c in cs
                            if c[5].endswith("repro/kernels/fixedpoint.py")]
        row["trees"] = [c for c in cs
                        if c[6].endswith("repro/core/collective/trees.py")]
    if INPUT_SHAPES[shape]["kind"] == "decode":
        row["new_caches"] = new_caches(hlo)
        row["dense_combine"] = dense_combine(hlo)
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
            got = D.account(fn, args)
    if INPUT_SHAPES[shape]["kind"] == "decode":
        got["cache_kv"] = cache_kv(args[1])
    return got


def _tree_tensors(arch, mesh="single"):
    """``(whole, share)`` of each of the probe's parameter tensors: its
    size and the size of model rank 0's share of it (the whole where the
    model axis does not split it; parameters replicated over the data
    axes, as the explicit gradient syncs hold them)."""
    shape, _ = PRODUCTION_SHAPES[mesh == "multi"]
    sizes = dict(zip(("pod", "data", "model")[-len(shape):], shape))
    meta = Transformer(_probe_cfg(arch), device="meta")
    specs = param_specs(meta, sizes, fsdp="data", model="model",
                        use_fsdp=False)
    out = []
    for n, p in meta.named_parameters():
        share = p.numel()
        if "model" in specs[n]:
            d = p.shape[list(specs[n]).index("model")]
            share = share // d * -(-d // sizes["model"])
        out.append((p.numel(), share))
    return out


def _trees_as_shares(trees, tensors, data, blocks=16):
    """The reference's Canary trees (``trees``: its collectives that
    ``repro/core/collective/trees.py`` issues) with each tensor's share
    in place of the whole one it carries: asserts that they are int32
    collective-permutes, ``2 ceil(log2 data)`` rounds a tensor, and that
    each tensor's rounds carry, padded to ``blocks``, either its whole
    (the quantizer gathered it) or its model share (``tensors``, from
    :func:`_tree_tensors`); returns ``(bytes, shares, gathered)``: the
    trees' bytes, those bytes with each tensor's share carried, and how
    many tensors went whole where the port sends a share."""
    rounds = 2 * math.ceil(math.log2(data))
    assert all(t[:1] + t[2:3] + t[4:6] == ["collective-permute", "s32", 1,
                                           ""] for t in trees), trees
    carried = Counter(t[3] for t in trees)
    assert all(v % rounds == 0 for v in carried.values()), (carried, rounds)
    slots = [e for e, v in sorted(carried.items()) for _ in range(v // rounds)]
    assert len(slots) == len(tensors), (carried, tensors)

    def pad(x):
        return -(-x // blocks) * blocks
    # each tensor to a slot of its whole or its share (augmenting paths)
    owner = [None] * len(slots)

    def place(i, seen):
        for j, e in enumerate(slots):
            if e in (pad(tensors[i][0]), pad(tensors[i][1])) \
                    and j not in seen:
                seen.add(j)
                if owner[j] is None or place(owner[j], seen):
                    owner[j] = i
                    return True
        return False
    assert all(place(i, set()) for i in range(len(tensors))), \
        (carried, tensors)
    gathered = sum(e != pad(tensors[i][1]) for e, i in zip(slots, owner))
    shares = sum(rounds * 4 * pad(share) for _, share in tensors)
    return sum(t[1] for t in trees), shares, gathered


def hold(reference, c, finding=None):
    """One period of case ``c`` against the reference's compiled probe:
    FLOPs (the flash calls counted as the reference's attention issues
    them), temporaries, collective link bytes and bytes accessed within
    the small steps' bounds, no collective left uncounted, and each rank's
    argument bytes the reference's (a decode's less its cache's 4-byte
    position). ``finding`` names what the reference's HLO shows of the
    case, which this asserts and holds the case by (below).

    Bytes accessed: the port's less its flash calls' against the
    reference's less the chunked attention's scans
    (``dryrun_reference.held_bytes``); inside them, the one-sided fact
    that the flash calls (q, k and v read, o and the lse written, once)
    move no more than the scans, which re-read each K/V block once a
    query block. Where the probe has no loop, the byte walk is held to
    ``cost_analysis()["bytes accessed"]`` within 0.1 % (with loops, its
    count with each body once, as XLA counts it, is printed).

    Under ``--seq-parallel`` GSPMD lays the chunked attention's two scans
    (the only while bodies of a one-period probe) out along the sequence
    the model axis splits, which their 1024-token blocks cut across: the
    dots inside the scans issue exactly 3 times the FLOPs they issue
    without it, which this asserts on the HLO, and their collectives move
    88 (llama) and 128 (nemotron) times the bytes. The port lays its
    attention out as it does without sequence parallelism (whole
    sequences, split over the model axis with the batch), so there the
    reference's scans, FLOPs, link bytes and the scans' bytes, are those
    it compiles without ``--seq-parallel``; the rest of the step is held
    to the one with it.

    ``finding["quantizer_gathers"]``, ``(count, bytes)`` (``--grad-sync
    canary_fp``): on the CPU the reference runs its Pallas quantizer and
    dequantizer as while loops over their grids, and in each iteration it
    all-gathers, in float32, the whole of the tensor it quantizes (the
    embedding table, (2052096, 128), once each of 8016 iterations, twice)
    where the model axis splits it. This asserts that every collective
    inside those loops is such an all-gather, of ``count`` iterations and
    ``bytes`` in all, and takes them out of the reference's link bytes.
    Its trees then carry most such tensors whole, where the port's carry
    each model rank's share: this asserts that too
    (:func:`_trees_as_shares`), holds the port's trees' bytes exactly to
    the reference's with each tensor's share in place of its whole, and
    counts those bytes on both sides. The loops' bytes (the all-gathers'
    results and what the interpreted kernels move) are set apart from the
    reference's bytes too; the port's quantize and dequantize calls stay
    in its own.

    ``finding["new_cache"]`` (a decode): the reference's step writes its
    cache anew, in float32, where the port writes the step's slot into
    its cache in place; this asserts those values on the HLO and holds
    the port's temporaries with its local K and V counted as written anew
    (``dryrun_reference.new_cache_bytes``, which the small steps of
    ``test_torch_dryrun.py`` share), and its bytes with them read and
    written anew.

    ``finding["dense_combine"]`` (the dense MoE route's decode): the
    collectives the reference's ``_moe_dense`` issues
    (``dryrun_reference.dense_combine``), asserted equal to the finding's:
    GSPMD reduces the routing weights over the data axis before their
    product (an all-reduce of one value a slot, combined with the tokens'
    gather), as the port's ``_reduce_partials`` does, and takes each
    slot's row of the experts' capacity-split output by a masked gather on
    each model rank and an all-reduce over the model axis, where the
    port's ``_flatten_gathered`` gathers the whole output first (its
    link bytes count those gathers). Asserted, not held: the port's count
    stands as it is.

    ``finding["router"]`` (the dense MoE route's training step): the
    reference's router as GSPMD lays it out
    (``dryrun_reference.router_layout``), asserted equal to the finding's:
    top-k's gradient scattered into zeros of one data rank's tokens, and
    every division of the routing weights' normalisation on one data
    rank's tokens, the gradient reduced before it is divided; the port's
    ``_TopkBackwardLikeInput``, ``_scatter_by_rows`` and ``_split_like``
    lay both out so (its forward gathers the probabilities whole for
    top-k, which the port does not). Asserted, not held.

    ``finding["float32"]``: the reference's CPU compile runs the bf16
    model's products, and the values around them, in float32, and
    converts between the two; this asserts that no dot of the probe reads
    a bf16 operand and that the conversions move bytes, and holds the
    port's bytes to the reference's as the same program moves them in
    bf16 (``dryrun_reference.held_bytes``)."""
    finding = finding or {}
    shape, seq_parallel = c[1], c[4]
    got = _account(*c)
    want = dict(reference.case(case_id(c)))
    if "dense_combine" in finding:
        print(f"{case_id(c)}: the reference's dense route combines by "
              f"{want['dense_combine']}", flush=True)
        assert want["dense_combine"] == finding["dense_combine"]
    if "router" in finding:
        print(f"{case_id(c)}: the reference's router lays out "
              f"{want['router']}", flush=True)
        assert want["router"] == finding["router"]
    got_temp, got_link = got["memory"]["temp_bytes"], \
        got["collective_link_bytes"]
    if seq_parallel:
        assert want["loop_flops"] == 3 * want["plain_loop_flops"], want
        for k in ("flops", "link"):
            want[k] += want[f"plain_loop_{k}"] - want[f"loop_{k}"]
    if "quantizer_gathers" in finding:
        tensors = _tree_tensors(c[0], c[2])
        split = {whole for whole, share in tensors if share < whole}
        gathers = want["quantizer"]
        assert gathers and all(
            g[0] == "all-gather" and g[2] == "f32" and g[3] in split
            for g in gathers), (gathers, split)
        moved = sum(g[1] for g in gathers)
        assert (sum(g[4] for g in gathers), moved) \
            == tuple(finding["quantizer_gathers"]), gathers
        whole, shares, gathered = _trees_as_shares(
            want["trees"], tensors, PRODUCTION_SHAPES[c[2] == "multi"][0][-2])
        trees = got["collective_bytes"]["collective-permute"]
        print(f"{case_id(c)}: the reference's quantizer gathers {moved} "
              f"bytes; its trees {whole} bytes, {gathered} of "
              f"{len(tensors)} tensors whole, {shares} with the shares; "
              f"the port's trees {trees}", flush=True)
        assert trees == shares, (trees, shares)
        want["link"] -= moved + whole - shares
    flash = got["attention_bytes"]
    got_bytes = got["bytes_accessed"] - flash
    if "new_cache" in finding:
        kv = new_cache_bytes(got["cache_kv"], want["new_caches"])
        got_temp, got_bytes = got_temp + kv, got_bytes + 2 * kv
    scans = want["plain_loop_scans"] if seq_parallel \
        else want["accessed"]["scans"]
    ratios = {"kernel_flops": got["flops"] / want["flops"],
              "temp": got_temp / want["temp"],
              "link": got_link / want["link"],
              "bytes": got_bytes / held_bytes(want, finding)}
    att = got["attention_flops"]
    ratios["flops"] = (got["flops"] - att["kernel"] + att["all_pairs"]) \
        / want["flops"]
    pos = 4 if INPUT_SHAPES[shape]["kind"] == "decode" else 0
    print(f"{case_id(c)}: port / reference {ratios}, reference "
          f"{want['flops'] / 1e12:.3f} TFLOP/dev, temporaries port "
          f"{got_temp} / reference {want['temp']} bytes, link bytes port "
          f"{got_link} / reference {want['link']}, argument bytes "
          f"port - reference {got['memory']['argument_bytes'] - want['args']}"
          f", bytes port {got['bytes_accessed']} (flash calls {flash}) / "
          f"reference {want['accessed']} (scans {scans}; the walk, each "
          f"loop once, / cost_analysis "
          f"{want['once'] / want['cost_analysis']}, {want['loops']} loops)",
          flush=True)
    assert not got["unknown_collectives"], got["unknown_collectives"]
    assert got["memory"]["argument_bytes"] == want["args"] - pos
    assert FLOPS_BOUND[0] <= ratios["flops"] <= FLOPS_BOUND[1], ratios
    assert TEMP_BOUND[0] <= ratios["temp"] <= TEMP_BOUND[1], ratios
    assert LINK_BOUND[0] <= ratios["link"] <= LINK_BOUND[1], ratios
    if not want["loops"]:
        assert abs(want["once"] / want["cost_analysis"] - 1) <= 1e-3, want
    assert flash <= scans, (flash, scans)
    assert BYTES_BOUND[0] <= ratios["bytes"] <= BYTES_BOUND[1], ratios


def period_tests(cases, findings=None):
    """A module's fixture ``reference`` (the reference's probes of
    ``cases``, compiled in one subprocess) and its test of each case
    (:func:`hold`, with the case's entry of ``findings``). A module
    assigns both to its own names."""
    findings = findings or {}

    @pytest.fixture(scope="module")
    def reference():
        run = reference_run(cases)
        yield run
        run.close()

    @pytest.mark.parametrize("c", cases, ids=[case_id(c) for c in cases])
    def test_period(reference, c):
        """One layer period against the reference's compiled probe."""
        hold(reference, c, findings.get(c))

    return reference, test_period


# each case's id is ``arch-shape`` (one mesh, no mode)
# the bytes held by the float32 finding (``hold``)
FINDINGS = {case(a, s): {"float32": True} for a, s in (
    ("glm4-9b", "train_4k"), ("jamba-v0.1-52b", "train_4k"),
    ("llama3.2-1b", "train_4k"), ("qwen2-7b", "train_4k"),
    ("qwen2-moe-a2.7b", "train_4k"), ("qwen2-moe-a2.7b", "prefill_32k"),
    ("mamba2-130m", "prefill_32k"))}
# the reference's router on (16, 16), one data rank's 65536 tokens of 60
# experts, top-4: the normalisation's divisions (forward, then the
# gradients of the denominators and of the weights), top-k's gradient, and
# the forward's gather of the probabilities for its top-k
FINDINGS[case("qwen2-moe-a2.7b", "train_4k")]["router"] = [
    ["divide", [65536, 4]], ["divide", [65536, 1]], ["divide", [65536, 1]],
    ["divide", [65536, 4]], ["scatter", [65536, 60]],
    ["all-gather", [1048576, 60]]]
reference, test_production_period_against_reference = period_tests(
    CASES, FINDINGS)


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

%cond (cp: (s32[], f32[4,8])) -> pred[] {
  %cp = (s32[], f32[4,8]{1,0}) parameter(0)
  %ci = s32[] get-tuple-element(%cp), index=0
  %cn = s32[] constant(5)
  ROOT %clt = pred[] compare(%ci, %cn), direction=LT
}

%fused (fp: f32[4,8]) -> f32[4,8] {
  %fp = f32[4,8]{1,0} parameter(0)
  %fw = f32[8,8]{1,0} constant(0)
  ROOT %fdot = f32[4,8]{1,0} dot(%fp, %fw), lhs_contracting_dims={1}, rhs_contracting_dims={0}
}

%row (sp: f32[4,8], si: s32[]) -> f32[1,8] {
  %sp = f32[4,8]{1,0} parameter(0)
  %si = s32[] parameter(1)
  %sz = s32[] constant(0)
  ROOT %ss = f32[1,8]{1,0} dynamic-slice(%sp, %si, %sz), dynamic_slice_sizes={1,8}
}

%put (dp: f32[4,8], du: f32[1,8], di: s32[]) -> f32[4,8] {
  %dp = f32[4,8]{1,0} parameter(0)
  %du = f32[1,8]{1,0} parameter(1)
  %di = s32[] parameter(2)
  %dz = s32[] constant(0)
  ROOT %dd = f32[4,8]{1,0} dynamic-update-slice(%dp, %du, %di, %dz)
}

ENTRY %main (x: f32[4,8]) -> f32[4,8] {
  %x = f32[4,8]{1,0} parameter(0)
  %f = f32[4,8]{1,0} fusion(%x), kind=kOutput, calls=%fused
  %i = s32[] constant(1)
  %one = f32[1,8]{1,0} fusion(%x, %i), kind=kLoop, calls=%row
  %back = f32[4,8]{1,0} fusion(%f, %one, %i), kind=kLoop, calls=%put
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
    flops, moved, _ = costs(NESTED_HLO)
    assert flops == 512 * (1 + 3 + 3 * 5)
    assert moved["all-reduce"] == 128 * 3 * 5
    assert link_bytes(moved) == 2 * 128 * 3 * 5
    assert sum(moved.values()) == moved["all-reduce"]
    flops, looped, _ = costs(NESTED_HLO, loops=True)
    assert flops == 512 * (3 + 3 * 5)
    assert looped == moved


def test_byte_walk_counts_nested_while_bodies():
    """``dryrun_reference.accessed`` on :data:`NESTED_HLO`, worked out by
    hand. A 4 x 8 float32 array is 128 bytes. The inner body: its dot
    reads 128 + 256 and writes 128, its all-reduce reads and writes 128:
    768 bytes an iteration; a condition's compare reads two s32 and writes
    a pred: 9. The outer body: its dot, 512, and the inner loop's 5
    iterations with their conditions: 4397 an iteration. The entry: the
    fusion of a dot reads its parameter and writes its result, 256; the
    dynamic-slice fusion reads only the row it slices, 32, and its index,
    4, and writes the row, 32; the dynamic-update-slice fusion writes the
    row in place, 32, reads the row and the index, 36, and nothing of its
    destination; the outer loop's 3 iterations with their conditions.
    Parameters, constants, tuples and their elements move nothing."""
    from dryrun_reference import accessed
    inner, cond = 512 + 256, 9
    outer = 512 + 5 * (inner + cond)
    entry = 256 + 68 + 68
    got = accessed(NESTED_HLO)
    assert got["all"] == entry + 3 * (outer + cond) == 13610
    assert got["scans"] == got["quantizer"] == 0       # no stack frames
    assert accessed(NESTED_HLO, loops=True)["all"] == 3 * (outer + cond)
    # each loop once, as cost_analysis counts it
    assert accessed(NESTED_HLO, once=True)["all"] \
        == entry + (512 + inner + cond) + cond
    # nothing converts between bf16 and float32: at bf16 width, each
    # float32 element 2 bytes, the s32 and pred as they are
    assert got["conversions"] == 0
    half = accessed(NESTED_HLO)["bf16_all"]
    ints = 3 * (5 * cond + cond) + 4 + 4
    assert half == ints + (got["all"] - ints) // 2
