"""The layouts the dry run gives the serving, two-pod and encoder-decoder
rows compute the operations they lay out: on 4 gloo ranks at (2, 2), real
tensors, each against the operation on the whole tensors.

* :func:`repro_torch.parallel.layouts.kv_by_query_heads`: K and V repeated
  to the query's heads and split over the model axis, each rank projecting
  its groups' key heads, forward and backward (the gradients of x and of
  the weight, a partial sum over the model axis); ``None`` where a rank's
  query heads straddle a group or the batch splits over the model axis;
* :func:`repro_torch.parallel.layouts.write_slot`: a decode step's K/V
  written into a cache split along its slots, by the rank that holds the
  slot (also from K/V repeated to the query's heads);
* the dry run's softmax along a split dim (a decode step's logits over
  such a cache);
* the dry run's products: an FSDP x model contraction met by features
  split over the model axis (the partial sum reduced at once), the output
  columns kept split under ``keep_d_split``, a step's tokens moved
  where they hold fewer bytes than the weight, a stacked weight's gradient
  against a partial sum over the data axes, and an operand split in
  DTensor's strided way on a mesh of three dims (the backward's);
* :func:`repro_torch.parallel.layouts.redistribute_over_data`: rows split
  over ("pod", "data") moved to columns in one all-to-all over the
  flattened pair, forward and backward;
* :func:`repro_torch.parallel.layouts.split_as_batch`: the default
  positions split as the batch, RoPE on them equal to the whole one.
"""
import contextlib
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor.experimental import implicit_replication

os.environ.setdefault("JAX_PLATFORMS", "cpu")
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.parallel import ParallelContext, parallel_context  # noqa
from repro_torch.parallel.layouts import (  # noqa: E402
    keep_d_split, kv_by_query_heads, redistribute_over_data, split_as_batch,
    write_slot)
from repro_torch.models.layers import apply_rope  # noqa: E402


def _close(got, want, what, atol=1e-5):
    assert torch.allclose(got, want, atol=atol), \
        f"{what}: {(got - want).abs().max().item()}"


def _serving_layouts_rank(rank: int, init_file: str):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=4, rank=rank)
    try:
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        ctx = ParallelContext(mesh=mesh, data_axes=("data",),
                              model_axis="model")
        g = torch.Generator().manual_seed(0)

        def dt(t, *placements):
            return distribute_tensor(t, mesh, list(placements))

        # K/V by the query's heads: 4 query heads, 1 key head, 2 sequences
        # (one a data rank: the model axis cannot split the batch)
        B, S, d, H, hd = 2, 3, 4, 4, 2
        x = torch.randn(B, S, d, generator=g)
        wk, wv = (torch.randn(d, 1, hd, generator=g) for _ in range(2))
        r = torch.randn(B, S, H, hd, generator=g)
        xd = dt(x, Shard(0), Replicate()).detach().requires_grad_()
        wkd = dt(wk, Shard(0), Replicate()).detach().requires_grad_()
        wvd = dt(wv, Shard(0), Replicate())
        with parallel_context(ctx):
            k, v = kv_by_query_heads(xd, wkd, wvd, H)
            assert list(k.placements) == [Shard(0), Shard(2)]
            want_k = torch.einsum("bsd,dhx->bshx", x, wk) \
                .repeat_interleave(H, dim=2)
            _close(k.full_tensor(), want_k, "k by query heads")
            _close(v.full_tensor(), torch.einsum("bsd,dhx->bshx", x, wv)
                   .repeat_interleave(H, dim=2), "v by query heads")
            (k * dt(r, Shard(0), Shard(2))).sum().backward()
            xw = x.clone().requires_grad_()
            ww = wk.clone().requires_grad_()
            (torch.einsum("bsd,dhx->bshx", xw, ww)
             .repeat_interleave(H, dim=2) * r).sum().backward()
            _close(xd.grad.full_tensor(), xw.grad, "dx")
            _close(wkd.grad.full_tensor(), ww.grad, "dwk")
            # a rank's query heads straddling a group, and a batch the
            # model axis splits: not this layout
            assert kv_by_query_heads(xd, dt(torch.randn(d, 3, hd), Shard(0),
                                            Replicate()), wvd, 6) is None
            x4 = dt(torch.randn(4, S, d), Shard(0), Replicate())
            assert kv_by_query_heads(x4, wkd, wvd, H) is None

        # a step's K/V into a cache split along its 4 slots: slot 3 is
        # model rank 1's; K repeated to 2 query heads writes one copy
        cache = torch.randn(B, 4, 1, hd, generator=g)
        new = torch.randn(B, 1, 1, hd, generator=g)
        for slot in (0, 3):
            cd = dt(cache, Shard(0), Shard(1))
            write_slot(cd, slot, dt(new.repeat_interleave(2, dim=2),
                                    Shard(0), Shard(2)))
            want = cache.clone()
            want[:, slot] = new[:, 0]
            assert torch.equal(cd.full_tensor(), want), slot

        # softmax along a dim the model axis splits
        logits = torch.randn(B, 3, 8, generator=g)
        got = D._split_softmax(dt(logits, Shard(0), Shard(2)), -1)
        assert list(got.placements) == [Shard(0), Shard(2)]
        _close(got.full_tensor(), logits.softmax(-1), "split softmax")

        # the default positions laid out as the batch is: each rank's
        # rotary angles for its own rows only
        q = torch.randn(B, 3, 2, 4, generator=g)
        pos = torch.arange(3, dtype=torch.int32)[None].expand(B, 3)
        qd = dt(q, Shard(0), Shard(2))
        pd = split_as_batch(pos, qd)
        assert list(pd.placements) == [Shard(0), Replicate()]
        assert pd.to_local().shape == (1, 3)
        with implicit_replication():
            got = apply_rope(qd, pd, 1e4)
        _close(got.full_tensor(), apply_rope(q, pos, 1e4), "rope by batch")

        x2, w2 = torch.randn(4, 8, generator=g), torch.randn(8, 6,
                                                             generator=g)
        wo = torch.randn(8, 8, generator=g)
        with parallel_context(ctx):
            # features split over model against a contraction split over
            # data and model together: the partial sum reduced at once
            got = D._gather_weight(dt(x2, Shard(0), Shard(1)),
                                   dt(w2, Shard(0), Shard(0)))
            assert list(got.placements) == [Shard(0), Replicate()]
            _close(got.full_tensor(), x2 @ w2, "fsdp x model contraction")
            with keep_d_split():
                # the output columns the model axis splits with the data
                # axes: kept split over model, gathered over data
                got = D._gather_weight(dt(x2, Shard(0), Replicate()),
                                       dt(wo, Shard(1), Shard(1)))
                assert list(got.placements) == [Shard(0), Shard(1)]
                _close(got.full_tensor(), x2 @ wo, "output columns kept")
                # a step's few tokens against a larger weight: the tokens
                # move, the weight's split over data is kept (contraction
                # and output columns)
                for wd in (dt(wo, Shard(0), Replicate()),
                           dt(wo, Shard(1), Replicate())):
                    got = D._gather_weight(dt(x2[:2], Shard(0), Replicate()),
                                           wd)
                    assert got.placements[0] == Shard(0)
                    _close(got.full_tensor(), x2[:2] @ wo, "tokens moved")
            # a stacked weight's gradient: the buffer split along d over
            # data against a partial sum over data, reduced
            a = torch.randn(2, 4, 3, generator=g)
            b = torch.randn(2, 3, 6, generator=g)
            part = DTensor.from_local(  # each data rank half of b
                (b / 2).narrow(2, 3 * mesh.get_coordinate()[1], 3), mesh,
                [Partial(), Shard(2)], run_check=False)
            weight = dt(torch.zeros(2, 4, 6), Shard(1), Shard(2))
            with D.Accountant(contextlib.nullcontext(),
                              [weight.requires_grad_()]):
                got = D._gather_weight(dt(a, Shard(1), Replicate()), part)
            assert got.placements[0] == Shard(1)
            _close(got.full_tensor(), a @ b, "stacked weight's gradient")
        # an operand split in DTensor's strided way (heads merged into the
        # batch) on a mesh of three dims, as the backward pass meets it:
        # made whole over that mesh dim, the product equal
        pods = init_device_mesh("cpu", (2, 1, 2),
                                mesh_dim_names=("pod", "data", "model"))
        t = torch.randn(2, 2, 3, 5, generator=g)
        other = torch.randn(4, 5, 2, generator=g)
        with parallel_context(ParallelContext(
                mesh=pods, data_axes=("pod", "data"), model_axis="model")):
            merged = distribute_tensor(t, pods, [Shard(0), Replicate(),
                                                 Shard(1)]).reshape(4, 3, 5)
            assert D._strided(merged.placements[2]), merged.placements
            got = D._unstrided_product(merged, distribute_tensor(
                other, pods, [Shard(0), Replicate(), Replicate()]))
            _close(got.full_tensor(), t.reshape(4, 3, 5) @ other,
                   "strided product")
        # rows split over ("pod", "data") moved to columns split over
        # them, in one all-to-all over their flattened group: forward and
        # backward as DTensor's own redistribution
        pod_data = init_device_mesh("cpu", (2, 2, 1),
                                    mesh_dim_names=("pod", "data", "model"))
        rows = torch.randn(8, 4, generator=g)
        up = torch.randn(8, 4, generator=g)
        with parallel_context(ParallelContext(
                mesh=pod_data, data_axes=("pod", "data"),
                model_axis="model")):
            src = distribute_tensor(rows, pod_data, [
                Shard(0), Shard(0), Replicate()]).detach().requires_grad_()
            cols = redistribute_over_data(src, [Shard(1), Shard(1),
                                                Replicate()])
            assert list(cols.placements) == [Shard(1), Shard(1), Replicate()]
            assert torch.equal(cols.full_tensor(), rows)
            (cols * distribute_tensor(up, pod_data, list(cols.placements))
             ).sum().backward()
            assert list(src.grad.placements) == list(src.placements)
            assert torch.equal(src.grad.full_tensor(), up)
    finally:
        dist.destroy_process_group()


def test_serving_and_pod_layouts_compute_the_operations(tmp_path):
    import torch.multiprocessing as mp
    mp.spawn(_serving_layouts_rank, args=(str(tmp_path / "rendezvous"),),
             nprocs=4, join=True)
