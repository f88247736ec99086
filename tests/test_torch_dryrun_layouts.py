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
* the dense MoE route's weighting and flattening: routing weights that
  are a partial sum over the data axis reduced before their product with
  the experts' output, and the capacity buffer gathered along the
  capacity the model axis splits before it is flattened;
* :func:`repro_torch.parallel.layouts.redistribute_over_data`: rows split
  over ("pod", "data") moved to columns in one all-to-all over the
  flattened pair, forward and backward;
* :func:`repro_torch.parallel.layouts.split_as_batch`: the default
  positions split as the batch, RoPE on them equal to the whole one;
* decodes (``DECODES``), the serve step on DTensors laid out by the rules
  against the same step on the whole tensors, each through the hook it
  names: one sequence (``long_500k``'s batch, which leaves the data axes
  idle) with the query heads' product with the values spread over the
  data ranks (:func:`repro_torch.parallel.layouts.heads_over_idle_data`,
  one key head, and 2 or 8 of them), the projections contracting d split
  over the data axes and reduced at once, the argmax of logits that are a
  partial sum, and the Mamba-2 step by heads where the model axis splits
  its heads unevenly; two sequences split by batch and key heads, each
  rank attending on its own rows and heads
  (:func:`repro_torch.parallel.layouts.on_local_heads`).
"""
import contextlib
import os

import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor.experimental import implicit_replication

os.environ.setdefault("JAX_PLATFORMS", "cpu")
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.parallel import ParallelContext, parallel_context  # noqa
from repro_torch.parallel.sharding import P  # noqa: E402
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
            # the dense MoE route's weighting: routing weights that are a
            # partial sum over data, reduced before the product
            w = torch.randn(8, 1, generator=g)
            vals = torch.randn(8, 6, generator=g)
            got = D._reduce_partials(torch.ops.aten.mul.Tensor)(
                dt(vals, Replicate(), Replicate()), DTensor.from_local(
                    w / 2, mesh, [Partial(), Replicate()], run_check=False))
            assert list(got.placements) == [Replicate(), Replicate()]
            _close(got.full_tensor(), vals * w, "weights reduced first")
            # its capacity buffer flattened across the split capacity
            buf = torch.randn(3, 4, 5, generator=g)
            got = D._flatten_gathered(torch.ops.aten.view.default)(
                dt(buf, Replicate(), Shard(1)), [-1, 5])
            assert list(got.placements) == [Replicate(), Replicate()]
            assert torch.equal(got.full_tensor(), buf.reshape(12, 5))
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


# (mesh, arch, config overrides, batch, the hook the layout must take)
DECODES = {
    "batch1": [
        # one key head, the cache split along the slots over the model axis
        ((2, 2), "llama3.2-1b", dict(num_kv_heads=1), 1,
         "heads_over_idle_data"),
        # 2 key heads of 4 queries, 4 data ranks: 2 heads a rank, the
        # upper two ranks' of key head 1 (llama's and nemotron's case)
        ((4, 1), "llama3.2-1b", dict(num_heads=8, num_kv_heads=2), 1,
         "heads_over_idle_data"),
        # 8 key heads of 2 queries: 2 whole groups a rank
        ((4, 1), "llama3.2-1b", dict(num_heads=16, num_kv_heads=8), 1,
         "heads_over_idle_data"),
        # the model axis splits neither the 3 heads nor w_in's 451 columns
        # (as 24 heads and 3352 columns on 16 ranks)
        ((2, 2), "mamba2-130m", dict(d_model=96), 1, None)],
    # the batch (and the tokens) over the data axis, the 2 key heads over
    # the model axis
    "batch2": [((2, 2), "llama3.2-1b", {}, 2, "on_local_heads")]}


def _decode_rank(rank: int, init_file: str, which: str):
    """On 4 gloo ranks, float32: three serve steps of each case of
    ``DECODES[which]``, on DTensors laid out by the sharding rules through
    the dry run's layouts, against the same steps on the whole tensors
    (the tokens exactly; the logits and every cache tensor 1e-5), each
    through the layout hook it names."""
    import copy
    from repro_torch.models import get_config, init_cache, init_params
    from repro_torch.models import layers
    from repro_torch.parallel import cache_specs, param_placements
    from repro_torch.parallel import param_specs
    from repro_torch.serving import make_serve_step
    from test_torch_dryrun import _dry_run_layouts
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=4, rank=rank)
    taken = dict.fromkeys(("heads_over_idle_data", "on_local_heads"), 0)

    def counted(name):
        hook = getattr(layers, name)

        def run(*args):
            out = hook(*args)
            taken[name] += out is not None
            return out
        return run
    for name in taken:
        setattr(layers, name, counted(name))
    try:
        for shape, arch, over, batch, hook in DECODES[which]:
            mesh = init_device_mesh("cpu", shape,
                                    mesh_dim_names=("data", "model"))
            sizes = dict(zip(("data", "model"), shape))
            ctx = ParallelContext(mesh=mesh, data_axes=("data",),
                                  model_axis="model")

            def laid_out(t, spec):
                return distribute_tensor(t, mesh,
                                         param_placements(spec, mesh))

            cfg = get_config(arch, "smoke").with_(dtype="float32", **over)
            params = init_params(cfg, torch.Generator().manual_seed(1),
                                 device="cpu")
            specs = param_specs(params, sizes, fsdp="data", model="model")
            pd = copy.deepcopy(params)
            for name, p in list(pd.named_parameters()):
                owner, _, leaf = name.rpartition(".")
                setattr(pd.get_submodule(owner) if owner else pd, leaf,
                        torch.nn.Parameter(laid_out(p.detach(), specs[name]),
                                           requires_grad=False))
            cache = init_cache(cfg, batch, 16, device="cpu")
            c_specs = cache_specs(cache, sizes, dp_axes="data",
                                  model="model")
            cd = {"pos": 0, "layers": [
                {k: laid_out(t.clone(), c_specs["layers"][i][k])
                 for k, t in layer.items()}
                for i, layer in enumerate(cache["layers"])]}
            step = make_serve_step(cfg)
            tokens = torch.tensor([[7], [11]][:batch], dtype=torch.int32)
            before = dict(taken)
            for i in range(3):
                with torch.no_grad():
                    nxt, logits, cache = step(params, cache, tokens)
                    with parallel_context(ctx), _dry_run_layouts():
                        nd, ld, cd = step(pd, cd, laid_out(
                            tokens, P("data" if batch > 1 else None)))
                _close(ld.full_tensor(), logits, f"{arch} logits {i}")
                assert torch.equal(nd.full_tensor(), nxt), (arch, i)
                for j, layer in enumerate(cache["layers"]):
                    for k, t in layer.items():
                        _close(cd["layers"][j][k].full_tensor(), t,
                               f"{arch} cache {j} {k} {i}")
                tokens = nxt
            if hook is not None:    # once a layer a step
                assert taken[hook] - before[hook] == 3 * cfg.num_layers, \
                    (arch, over, taken, before)
            else:
                assert list(pd.layers[0].ssm.w_in.placements) \
                    == [Replicate()] * 2
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("which", sorted(DECODES))
def test_decode_layouts_compute_the_step(tmp_path, which):
    """``batch1``: one sequence, which leaves the data axes idle
    (``long_500k``'s batch); ``batch2``: two, split over the data axis."""
    import torch.multiprocessing as mp
    mp.spawn(_decode_rank, args=(str(tmp_path / "rendezvous"), which),
             nprocs=4, join=True)
