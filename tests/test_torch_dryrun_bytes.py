"""The dry run's count of bytes accessed
(:class:`repro_torch.launch.dryrun.Accountant`): every local operation
that moves tensor data adds its inputs' and outputs' bytes, and an
operation that moves none adds nothing, though torch does not mark it a
view: DTensor's device query of each local tensor (``prim.device``, which
returns a ``torch.device``) and the reshape that aliases its input
(``aten._unsafe_view``). At one rank the step on DTensors counts what the
same step on plain fake tensors counts, but for the ops that DTensor's
layouts run there and the plain step does not, named here with their
bytes."""
import os
from collections import Counter

import pytest
import torch
from torch import nn
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Shard

os.environ.setdefault("JAX_PLATFORMS", "cpu")
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.models import Transformer, get_config  # noqa: E402
from repro_torch.optim import AdamWConfig, AdamWState  # noqa: E402
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
