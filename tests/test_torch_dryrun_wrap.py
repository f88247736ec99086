"""The dry run's count of funcol's wrap (``_c10d_functional.
_wrap_tensor_autograd``), which hands every functional collective's result
back as an ``AsyncCollectiveTensor`` holding the result's own storage. Its
fake allocates a new tensor, where the real op allocates and moves nothing:
the :class:`repro_torch.launch.dryrun.Accountant` counts the wrap as the
storage it wraps, live until the last of the two is freed, with no bytes
accessed and no link bytes."""
from collections import Counter

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Partial, Replicate

from repro_torch.launch import dryrun as D

N = 1 << 20         # float32 values: 4 MiB a tensor


def test_all_reduce_result_counted_once(monkeypatch):
    """One all-reduce of an (N,) float32 partial sum over 2 fake ranks,
    its input kept alive (an argument): the peak is the input and the
    result, 8 N bytes (the fake wrap counted as a storage of its own made
    it 12 N), the wrap accesses no bytes and the link bytes are the
    all-reduce's alone."""
    accessed, calls = Counter(), Counter()
    count = D.Accountant._count

    def spy(self, func, args, kwargs, out):
        before = self.bytes
        count(self, func, args, kwargs, out)
        accessed[func._overloadpacket.__name__] += self.bytes - before
        calls[func._overloadpacket.__name__] += 1
    monkeypatch.setattr(D.Accountant, "_count", spy)
    with D.fake_process_group(2):
        mesh = init_device_mesh("cpu", (2,), mesh_dim_names=("data",))
        with FakeTensorMode():
            x = DTensor.from_local(torch.empty(N), mesh, [Partial()],
                                   run_check=False)
        got = D.account(lambda x: x.redistribute(mesh, [Replicate()]), (x,))
    assert calls["all_reduce"] == calls["_wrap_tensor_autograd"] == 1, calls
    assert got["memory"]["argument_bytes"] == 4 * N
    assert got["memory"]["total_bytes"] == 8 * N, got["at_peak"]
    assert got["memory"]["output_bytes"] == 4 * N
    assert accessed["_wrap_tensor_autograd"] == 0
    assert accessed["all_reduce"] == 8 * N          # read N, written N
    assert got["collective_bytes"]["all-reduce"] == 4 * N
    assert got["collective_link_bytes"] == 8 * N    # an all-reduce's 2x
    assert not got["unknown_collectives"]


def test_wrapped_storage_live_until_both_are_freed():
    """A storage and its wrap hold one record: its bytes stay live while
    either lives, whichever is freed first, and count once at the peak."""
    for first in ("input", "wrap"):
        with FakeTensorMode() as mode:
            held = {"input": torch.empty(N), "wrap": torch.empty(N)}
        acct = D.Accountant(mode)
        assert acct.track(held["input"]) == 4 * N
        acct.alias(held["wrap"], held["input"])
        assert acct.track(held["wrap"]) == 0    # its storage counted once
        assert (acct.live, acct.peak) == (4 * N, 4 * N)
        held.pop(first)
        assert acct.live == 4 * N, first
        held.clear()
        assert acct.live == 0, first
        assert acct.live_at_peak() == [
            (4 * N, "argument", (N,), "torch.float32")]
