"""What gloo does with CUDA tensors: two gloo ranks that share one card,
each operation in a process group of its own (a failed operation leaves
its pair of ranks unusable).

Usage (on a machine with a card)::

    PYTHONPATH=src python scripts/gloo_cuda_probe.py

Prints a line an operation: point-to-point (``batch_isend_irecv``, the
Canary trees' exchange) on CUDA tensors directly, the same staged through
host buffers (``repro_torch.core.collective.trees._shift`` with
``_host_pair``), and ``all_reduce``, ``all_gather``,
``all_gather_into_tensor``, ``reduce_scatter_tensor`` and ``broadcast`` on
CUDA tensors, each "ok" with whether the peer's values arrived, or the
error it raised.
"""
import datetime
import os
import sys
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

N = 1 << 20


def _exchange(staged: bool):
    def run(rank: int) -> bool:
        from repro_torch.core.collective.trees import _host_pair, _shift
        x = torch.arange(N, device="cuda", dtype=torch.int32) + 1000 * rank
        host = _host_pair(x) if staged else None
        got = _shift(x, dist.group.WORLD, 2, 1, host=host)
        return torch.equal(got, torch.arange(N, device="cuda",
                                             dtype=torch.int32)
                           + 1000 * (1 - rank))
    return run


def _collective(name: str):
    def run(rank: int) -> bool:
        x = torch.full((8,), float(rank + 1), device="cuda")
        if name == "all_reduce":
            dist.all_reduce(x)
            return bool((x == 3).all())
        if name == "all_gather":
            out = [torch.empty_like(x) for _ in range(2)]
            dist.all_gather(out, x)
            return bool((out[1 - rank] == 2 - rank).all())
        if name == "all_gather_into_tensor":
            out = torch.empty(16, device="cuda")
            dist.all_gather_into_tensor(out, x)
            return bool((out[8 * (1 - rank):][:8] == 2 - rank).all())
        if name == "reduce_scatter_tensor":
            out = torch.empty(4, device="cuda")
            dist.reduce_scatter_tensor(out, x)
            return bool((out == 3).all())
        dist.broadcast(x, 0)
        return bool((x == 1).all())
    return run


OPS = {"batch_isend_irecv (direct)": _exchange(False),
       "batch_isend_irecv (staged through host buffers)": _exchange(True),
       **{name: _collective(name) for name in (
           "all_reduce", "all_gather", "all_gather_into_tensor",
           "reduce_scatter_tensor", "broadcast")}}


def _rank(rank: int, init_file: str, name: str) -> None:
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=2, rank=rank,
                            timeout=datetime.timedelta(seconds=60))
    try:
        same = OPS[name](rank)
        torch.cuda.synchronize()
        line = f"ok, the peer's values {'arrived' if same else 'DIFFER'}"
    except Exception as e:      # what gloo raised is the finding
        line = f"raised {type(e).__name__}: {str(e).splitlines()[0][:200]}"
    finally:
        dist.destroy_process_group()
    if rank == 0:
        print(f"{name} on CUDA tensors over gloo: {line}", flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("gloo_cuda_probe: needs a CUDA card")
    print(f"torch {torch.__version__}, {torch.cuda.get_device_name(0)}",
          flush=True)
    for name in OPS:
        with tempfile.TemporaryDirectory() as tmp:
            mp.spawn(_rank, args=(os.path.join(tmp, "rdv"), name), nprocs=2,
                     join=True)


if __name__ == "__main__":
    main()
