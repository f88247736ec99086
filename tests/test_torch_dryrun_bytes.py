"""The dry run's count of bytes accessed
(:class:`repro_torch.launch.dryrun.Accountant`): every local operation
that moves tensor data adds its inputs' and outputs' bytes, and an
operation that moves none adds nothing, though torch does not mark it a
view: DTensor's device query of each local tensor (``prim.device``, which
returns a ``torch.device``) and the reshape that aliases its input
(``aten._unsafe_view``). At one rank the step on DTensors counts what the
same step on plain fake tensors counts, but for the ops that DTensor's
layouts run there and the plain step does not, named here with their
bytes.

The dense MoE route's two layouts of the dry run's own, on a (2, 2) fake
mesh: a pointwise op whose smaller operand is a partial sum over a data
axis reduces that operand first (``_reduce_partials``), and a view that
merges a dim the model axis splits behind another gathers that dim first
(``_flatten_gathered``); at one rank neither changes a count."""
import os
from collections import Counter

import pytest
import torch
from torch import nn
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

os.environ.setdefault("JAX_PLATFORMS", "cpu")
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.models import Transformer, get_config  # noqa: E402
from repro_torch.optim import AdamWConfig, AdamWState  # noqa: E402
from repro_torch.parallel import (ParallelContext,  # noqa: E402
                                  parallel_context)
from repro_torch.train.train_step import (TrainConfig,  # noqa: E402
                                          make_train_step)
from test_torch_dryrun import ARCH, _account  # noqa: E402

N = 1 << 16         # float32 values a rank: 256 KiB a tensor
B, S = 8, 64        # the small steps' sequences and tokens
# what the step on DTensors at one rank adds to the plain step's bytes,
# op by op: the dry run's vocabulary-split embedding lookup
# (``_embedding_lookup``), which masks the tokens outside a rank's share of
# the vocabulary even where the share is all of it (the table is Shard(0)
# over a mesh dim of 1): the (8, 64) int32 tokens less the share's first
# row, compared with its bounds, the two masks combined, the masked tokens
# and the looked-up (8, 64, 256) bf16 rows multiplied by the mask, cast
ONE_RANK_MASK = {"aten.sub.Tensor": 4096, "aten.ge.Scalar": 2560,
                 "aten.lt.Scalar": 2560, "aten.bitwise_and.Tensor": 1536,
                 "aten.mul.Tensor": 4608 + 525312,
                 "aten._to_copy.default": 1536}


@pytest.fixture
def per_op(monkeypatch):
    """``(accessed, calls)``: the bytes each op adds to ``bytes_accessed``
    and how often it is counted, by op, over the calls this test makes."""
    accessed, calls = Counter(), Counter()
    count = D.Accountant._count

    def spy(self, func, args, kwargs, out):
        before = self.bytes
        count(self, func, args, kwargs, out)
        accessed[str(func)] += self.bytes - before
        calls[str(func)] += 1
    monkeypatch.setattr(D.Accountant, "_count", spy)
    return accessed, calls


def test_dtensor_op_counts_its_local_bytes(per_op):
    """``x + y`` of two DTensors split alike over 2 fake ranks adds its
    local inputs' and output's bytes, 3 x 4 N, and no more: DTensor asks
    each local tensor its device, and that adds nothing."""
    accessed, calls = per_op
    with D.fake_process_group(2):
        mesh = init_device_mesh("cpu", (2,), mesh_dim_names=("data",))
        with FakeTensorMode():
            x, y = (DTensor.from_local(torch.empty(N), mesh, [Shard(0)],
                                       run_check=False) for _ in range(2))
        got = D.account(lambda x, y: x + y, (x, y))
    assert calls["aten.add.Tensor"] == 1
    assert accessed["aten.add.Tensor"] == got["bytes_accessed"] == 3 * 4 * N
    assert calls["prim.device.default"] > 0
    assert accessed["prim.device.default"] == 0


def test_unsafe_view_moves_nothing(per_op):
    """A reshape that aliases its input (``aten._unsafe_view``, which torch
    does not mark a view) adds no bytes, and its output is counted as the
    storage it aliases: the peak is the argument and the product's
    result."""
    accessed, calls = per_op
    with FakeTensorMode():
        x = torch.empty(N // 4, 4)
    got = D.account(lambda x: torch.ops.aten._unsafe_view(x * 2, [N]), (x,))
    assert calls["aten._unsafe_view.default"] == 1
    assert accessed["aten._unsafe_view.default"] == 0
    assert got["bytes_accessed"] == accessed["aten.mul.Tensor"] == 2 * 4 * N
    assert got["memory"]["total_bytes"] == 2 * 4 * N
    assert got["memory"]["output_bytes"] == 4 * N


def _plain_step(cfg):
    """The train step of ``cfg`` on plain fake tensors (no DTensor): bf16
    parameters, float32 moments, (B, S) int32 tokens and labels, as
    ``build_dryrun`` lays them out at one rank."""
    tc = TrainConfig(model=cfg, optimizer=AdamWConfig(state_dtype="float32"))
    with FakeTensorMode(allow_non_fake_inputs=True):
        model = Transformer(cfg, device="meta")
        for name, p in list(model.named_parameters()):
            owner, _, leaf = name.rpartition(".")
            setattr(model.get_submodule(owner), leaf, nn.Parameter(
                torch.empty(p.shape, dtype=p.dtype), requires_grad=True))

        def moments():
            return {n: torch.empty(p.shape, dtype=torch.float32)
                    for n, p in model.named_parameters()}
        opt = AdamWState(step=torch.zeros((), dtype=torch.int32),
                         m=moments(), v=moments())
        batch = {k: torch.empty((B, S), dtype=torch.int32)
                 for k in ("tokens", "labels")}
    return make_train_step(tc), (model, opt, batch)


def test_one_rank_bytes_match_plain_step(per_op):
    """The (1, 1) dry run of llama's small train step (smoke config, bf16,
    8 sequences of 64 tokens) counts the bytes the same step counts on
    plain fake tensors, but for :data:`ONE_RANK_MASK`, exactly; FLOPs and
    memory are the same, and neither run's device queries add a byte."""
    accessed, calls = per_op
    cfg = get_config(ARCH, "smoke")
    on_mesh = _account((1, 1), dict(kind="train", seq_len=S,
                                    global_batch=B), cfg)
    mesh_ops, mesh_calls = Counter(accessed), Counter(calls)
    accessed.clear()
    calls.clear()
    plain = D.account(*_plain_step(cfg))
    assert calls["prim.device.default"] > 0 < mesh_calls["prim.device.default"]
    assert accessed["prim.device.default"] == mesh_ops[
        "prim.device.default"] == 0
    diff = {op: mesh_ops[op] - accessed[op]
            for op in set(mesh_ops) | set(accessed)
            if mesh_ops[op] != accessed[op]}
    assert diff == ONE_RANK_MASK
    assert on_mesh["bytes_accessed"] - plain["bytes_accessed"] \
        == sum(ONE_RANK_MASK.values())
    assert on_mesh["flops"] == plain["flops"]
    assert on_mesh["memory"] == plain["memory"]


def _on_data_model(fn, *tensors, sequence_parallel=False, out=None):
    """``D.account(fn, ...)`` on a (2, 2) ``("data", "model")`` fake mesh;
    each of ``tensors`` is ``(local shape, placements)`` of a float32 fake
    local tensor. ``out``, a list, receives ``fn``'s result."""
    with D.fake_process_group(4):
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        with FakeTensorMode():
            args = tuple(DTensor.from_local(torch.empty(shape), mesh,
                                            placements, run_check=False)
                         for shape, placements in tensors)

        def keep(*a):
            r = fn(*a)
            if out is not None:
                out.append((tuple(r.shape), list(r.placements),
                            tuple(r.to_local().shape)))
            return r
        with parallel_context(ParallelContext(
                mesh=mesh, data_axes=("data",), model_axis="model",
                sequence_parallel=sequence_parallel)):
            got = D.account(keep, args)
    for k in ("collective_counts", "collective_bytes"):
        got[k] = {kind: n for kind, n in got[k].items() if n}
    return got


# the dense route's ``vals * w_sorted[:, None]`` at 512 slots of d 256:
# the experts' output whole, the routing weights a partial sum over data
VALS = ((512, 256), [Replicate(), Replicate()])
WEIGHTS = ((512, 1), [Partial(), Replicate()])


def test_partial_weights_reduced_before_the_product(per_op):
    """The routing weights, (512, 1) and a partial sum over the data axis,
    times the experts' (512, 256) output: one all-reduce of the weights'
    2 KiB, not of the product's 512 KiB, and the product whole."""
    accessed, calls = per_op
    out = []
    got = _on_data_model(lambda v, w: v * w, VALS, WEIGHTS, out=out)
    assert got["collective_counts"] == {"all-reduce": 1}
    assert got["collective_bytes"] == {"all-reduce": 512 * 4}
    assert got["collective_link_bytes"] == 2 * 512 * 4
    assert out == [((512, 256), [Replicate(), Replicate()], (512, 256))]
    assert accessed["aten.mul.Tensor"] == 4 * (2 * 512 * 256 + 512)


@pytest.mark.parametrize("case", ["as_large", "seq_parallel"])
def test_partial_operand_left_to_dtensor(case, monkeypatch):
    """A partial sum over the data axis as large as the product, or any
    under sequence parallelism, takes DTensor's own rule: the same counts
    as with the dry run's pointwise layout taken out."""
    if case == "as_large":
        args, sp = ((VALS[0], WEIGHTS[1]), ((512, 1), VALS[1])), False
    else:
        args, sp = (VALS, WEIGHTS), True

    def run():
        got = _on_data_model(lambda v, w: v * w, *args, sequence_parallel=sp)
        return {k: got[k] for k in ("bytes_accessed", "collective_bytes",
                                    "collective_link_bytes", "memory")}
    with_layout = run()
    monkeypatch.delitem(D._LAYOUTS, torch.ops.aten.mul.Tensor)
    assert run() == with_layout


def test_flatten_gathers_the_split_capacity(per_op):
    """The dense route's (E, C, d) -> (E C, d) with C split over the model
    axis (6 experts, 8 slots, d 32): one all-gather of the whole buffer
    (DTensor's gather of dim 1: an all-gather and a concatenation), then a
    view on each rank, with no ``index_select``; the result is whole."""
    accessed, calls = per_op
    out = []
    got = _on_data_model(lambda x: x.reshape(48, 32),
                         ((6, 4, 32), [Replicate(), Shard(1)]), out=out)
    assert got["collective_counts"] == {"all-gather": 1}
    assert got["collective_bytes"] == {"all-gather": 6 * 8 * 32 * 4}
    assert calls["aten.index_select.default"] == 0
    assert out == [((48, 32), [Replicate(), Replicate()], (48, 32))]


@pytest.mark.parametrize("shape,size", [((6, 4, 32), (6, 256)),
                                        ((1, 4, 32), (8, 32))])
def test_flatten_of_a_leading_split_is_dtensors(shape, size, monkeypatch):
    """A view that merges nothing behind the split dim (the split dim
    first of its group, or behind dims of one element only) takes
    DTensor's own rule: the same counts without the layout."""
    def run():
        got = _on_data_model(lambda x: x.reshape(size),
                             (shape, [Replicate(), Shard(1)]))
        return {k: got[k] for k in ("bytes_accessed", "collective_bytes",
                                    "memory")}
    with_layout = run()
    for op in (torch.ops.aten.view.default,
               torch.ops.aten._unsafe_view.default):
        monkeypatch.delitem(D._LAYOUTS, op)
    assert run() == with_layout


def test_one_rank_dense_moe_step_unchanged(monkeypatch):
    """At one rank the dense MoE route's small train step (qwen2-moe
    smoke, 8 sequences of 64 tokens) counts what it counts with the two
    layouts taken out: FLOPs, bytes, collectives and memory."""
    cfg = get_config("qwen2-moe-a2.7b", "smoke")

    def run():
        got = _account((1, 1), dict(kind="train", seq_len=S,
                                    global_batch=B), cfg)
        return {k: got[k] for k in ("flops", "bytes_accessed",
                                    "collective_bytes", "memory")}
    with_layouts = run()
    for op in (torch.ops.aten.view.default,
               torch.ops.aten._unsafe_view.default,
               torch.ops.aten.reshape.default):
        monkeypatch.delitem(D._LAYOUTS, op)
    for op in (torch.ops.aten.add.Tensor, torch.ops.aten.sub.Tensor,
               torch.ops.aten.mul.Tensor, torch.ops.aten.div.Tensor,
               torch.ops.aten.pow.Tensor_Scalar):
        monkeypatch.delitem(D._LAYOUTS, op)
    assert run() == with_layouts


def test_partial_divided_onto_the_divisor_split(per_op):
    """The router's normalisation in the backward: the routing weights'
    gradient, (512, 4) and a partial sum over the data axis, divided by
    the denominators, (512, 1) split as the tokens over it: one
    reduce-scatter of the gradient onto the tokens' split, then a
    division of each rank's 256 rows (torch 2.13 gathers the
    denominators and divides the whole partial sum)."""
    accessed, calls = per_op
    out = []
    got = _on_data_model(lambda g, b: g / b,
                         ((512, 4), [Partial(), Replicate()]),
                         ((256, 1), [Shard(0), Replicate()]), out=out)
    assert got["collective_counts"] == {"reduce-scatter": 1}
    assert got["collective_bytes"] == {"reduce-scatter": 256 * 4 * 4}
    assert out == [((512, 4), [Shard(0), Replicate()], (256, 4))]
    assert calls["aten.div.Tensor"] == 1
    assert accessed["aten.div.Tensor"] == 4 * (2 * 256 * 4 + 256)


def test_router_backward_by_rows(per_op, monkeypatch):
    """qwen2-moe smoke's small train step by the dense route (2 layers, 4
    experts, top-2; 8 sequences of 64 tokens) on the (2, 2) mesh, as the
    production row runs its 60 experts: top-k's gradient is
    scattered into zeros split as the tokens, 256 rows a data rank, once a
    layer, through the dry run's own top-k (no whole (512, 4) zeros
    receives the tokens' gradients), and every division of a routing
    weight's gradient runs on a data rank's 256 rows."""
    shapes = {op: [] for op in ("aten.scatter.src", "aten.zeros.default",
                                "aten.new_zeros.default", "aten.div.Tensor")}
    count = D.Accountant._count

    def spy(self, func, args, kwargs, out):
        if str(func) in shapes:
            shapes[str(func)].append(tuple(out.shape))
        count(self, func, args, kwargs, out)
    monkeypatch.setattr(D.Accountant, "_count", spy)
    backward = D._TopkGradientLikeInput.backward
    used = []

    def counted(ctx, *grads):
        used.append(ctx.shape)
        return backward(ctx, *grads)
    monkeypatch.setattr(D._TopkGradientLikeInput, "backward",
                        staticmethod(counted))
    cfg = get_config("qwen2-moe-a2.7b", "smoke").with_(moe_impl="dense")
    _account((2, 2), dict(kind="train", seq_len=S, global_batch=B), cfg,
             arch="qwen2-moe-a2.7b")
    tokens, e, k = B * S, cfg.moe_experts, cfg.moe_top_k
    assert used == [torch.Size((tokens, e))] * cfg.num_layers
    assert shapes["aten.scatter.src"] == [(tokens // 2, e)] * cfg.num_layers
    assert (tokens // 2, e) in shapes["aten.new_zeros.default"]
    assert (tokens, e) not in shapes["aten.zeros.default"]
    weights = [s for s in shapes["aten.div.Tensor"] if s[-1:] == (k,)]
    assert weights and all(s == (tokens // 2, k) for s in weights), weights
