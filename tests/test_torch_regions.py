"""The ``shard_map`` boundary (``repro_torch.parallel.regions.shard_map``)
is the identity on plain tensors: the expert-parallel forms written as
its bodies give, on 4 gloo ranks, the same bits as the forms as they were
written before the boundary (each rank slicing its experts and, under
``ep_a2a``, its chunk of the sequence itself; kept here as the witness),
for the output, the aux loss and every gradient, in bfloat16 and float32,
with and without dropped slots. The witness slices the experts with its
own copy of the slicing the forms had (:class:`_Rows`), not with
``shard_of``, which the boundary now calls; it shares ``models.moe``'s
routing and expert helpers and the other collectives of
``parallel.regions`` with the forms.
"""
from types import SimpleNamespace

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.autograd import Function

from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import get_config
from repro_torch.models import moe as tm
from repro_torch.parallel import ParallelContext, parallel_context
from repro_torch.parallel.regions import (all_to_all, copy_to, exchange,
                                          gather_from, mean_over, reduce_from)

WORLD = 4
# (arch, form, (data, model), dtype, capacity factor); at 0.5 slots drop
CASES = [("deepseek-moe-16b", "ep", (2, 2), torch.bfloat16, 1.25),
         ("deepseek-moe-16b", "ep", (1, 4), torch.float32, 0.5),
         ("qwen2-moe-a2.7b", "ep", (1, 4), torch.bfloat16, 0.5),
         ("deepseek-moe-16b", "ep_a2a", (1, 4), torch.bfloat16, 1.25),
         ("qwen2-moe-a2.7b", "ep_a2a", (2, 2), torch.bfloat16, 0.5),
         ("qwen2-moe-a2.7b", "ep_a2a", (1, 4), torch.float32, 1.25)]


# ------------------------------------------- the forms before the boundary
class _Rows(Function):
    """Rows ``[r * rows, (r + 1) * rows)`` of ``w`` on group rank ``r``, the
    gradient gathered back to the whole weight: the experts' slicing as the
    forms did it before the boundary."""
    @staticmethod
    def forward(ctx, w, group, rows):
        ctx.group = group
        return w.narrow(0, dist.get_rank(group) * rows, rows)

    @staticmethod
    def backward(ctx, g):
        parts = [torch.empty_like(g)
                 for _ in range(dist.get_world_size(ctx.group))]
        dist.all_gather(parts, g.contiguous(), group=ctx.group)
        return torch.cat(parts), None, None


def _local_experts(p, ctx, e_loc):
    g = ctx.model_group
    return SimpleNamespace(**{w: _Rows.apply(getattr(p, w), g, e_loc)
                              for w in ("w_up", "w_gate", "w_down")})


def _before_ep_psum(p, x, cfg):
    ctx = tm.get_parallel_context()
    g, tp = ctx.model_group, ctx.tp_size
    e, k = cfg.moe_experts, cfg.moe_top_k
    e_loc = e // tp
    lo = ctx.model_rank * e_loc
    B, S, d = x.shape
    n = B * S
    x2d = copy_to(x.reshape(n, d), g)
    top_w, top_e, aux = tm._route(SimpleNamespace(router=copy_to(p.router,
                                                                 g)),
                                  x2d, cfg)
    sorted_e, pos_in_e, order = tm._dispatch_indices(top_e, k, e)
    cap = tm._capacity(n, cfg)
    local_ok = (sorted_e >= lo) & (sorted_e < lo + e_loc) & (pos_in_e < cap)
    y = tm._experts(_local_experts(p, ctx, e_loc), x2d, top_w, sorted_e,
                    pos_in_e, order, local_ok, lo, e_loc, cap, k)
    y = reduce_from(y, g)
    return y.view(B, S, d), mean_over(aux, g)


def _before_ep_a2a(p, x, cfg):
    ctx = tm.get_parallel_context()
    g, tp, m = ctx.model_group, ctx.tp_size, ctx.model_rank
    e, k, cf = cfg.moe_experts, cfg.moe_top_k, cfg.moe_capacity_factor
    e_loc = e // tp
    B, S, d = x.shape
    s_loc = S // tp
    n = B * s_loc
    x2d = copy_to(x, g)[:, m * s_loc:(m + 1) * s_loc].reshape(n, d)
    top_w, top_e, aux = tm._route(SimpleNamespace(router=copy_to(p.router,
                                                                 g)),
                                  x2d, cfg)
    flat_e = top_e.reshape(-1)
    order, sd, pos = tm._positions(flat_e // e_loc)
    cap = max(8, -(-int(n * k / tp * cf) // 8) * 8)
    ok = pos < cap
    slot = torch.where(ok, sd * cap + pos, tp * cap)
    send_x = tm._pack(x2d, slot, order, k, tp * cap + 1)
    send_e = torch.full((tp * cap + 1,), e, dtype=flat_e.dtype,
                        device=flat_e.device)
    send_e.index_copy_(0, slot, flat_e[order])
    recv_x = all_to_all(send_x[:tp * cap], g)
    recv_e = exchange(send_e[:tp * cap], g)
    le = recv_e - m * e_loc
    valid = (le >= 0) & (le < e_loc)
    order2, se2, pos2 = tm._positions(torch.where(valid, le, e_loc))
    cap2 = max(8, -(-int(tp * cap / e_loc * cf) // 8) * 8)
    ok2 = (pos2 < cap2) & (se2 < e_loc)
    vals2 = tm._experts(_local_experts(p, ctx, e_loc), recv_x,
                        torch.ones((tp * cap, 1), dtype=torch.float32,
                                   device=x2d.device), se2, pos2, order2, ok2,
                        0, e_loc, cap2, 1)
    back = all_to_all(vals2, g)
    got = back.index_select(0, torch.clamp(sd, max=tp - 1) * cap
                            + torch.clamp(pos, max=cap - 1))
    got = torch.where(ok[:, None], got, 0.0)
    w_sorted = top_w.reshape(-1)[order].to(got.dtype)
    slots = torch.empty_like(got).index_copy_(0, order,
                                              got * w_sorted[:, None])
    y = slots.view(B, s_loc, k, d).sum(dim=2)
    return gather_from(y, g, dim=1), mean_over(aux, g)


# ----------------------------------------------------------------- the ranks
def _step(form, mod, x, cfg):
    x = x.clone().requires_grad_(True)
    y, aux = form(mod, x, cfg)
    loss = (y.float() ** 2).sum() / y.numel() + cfg.moe_aux_coef * aux
    named = {n: w for n, w in mod.named_parameters()
             if not n.startswith("shared")}     # moe_forward adds it
    grads = torch.autograd.grad(loss, [x] + list(named.values()))
    return [y.detach(), aux.detach()] + list(grads)


def _rank(rank: int, init_file: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=WORLD, rank=rank)
    try:
        meshes = {s: make_host_mesh(*s, device_type="cpu")
                  for s in sorted({c[2] for c in CASES})}
        for i, (arch, impl, shape, dtype, factor) in enumerate(CASES):
            cfg = get_config(arch, "smoke").with_(moe_impl=impl,
                                                  moe_capacity_factor=factor)
            ctx = ParallelContext(mesh=meshes[shape], data_axes=("data",),
                                  model_axis="model")
            mod = tm.MoE(cfg, dtype, gen=torch.Generator().manual_seed(i))
            mod.requires_grad_(True)
            x = torch.randn((2, 16, cfg.d_model),
                            generator=torch.Generator().manual_seed(
                                100 * i + ctx.data_index)).to(dtype)
            now_form = tm._moe_ep_psum if impl == "ep" else tm._moe_ep_a2a
            before = _before_ep_psum if impl == "ep" else _before_ep_a2a
            with parallel_context(ctx):
                got = _step(now_form, mod, x, cfg)
                want = _step(before, mod, x, cfg)
            for j, (a, b) in enumerate(zip(got, want)):
                assert a.dtype == b.dtype and torch.equal(a, b), \
                    (arch, impl, shape, dtype, factor, j)
    finally:
        dist.destroy_process_group()


def test_boundary_is_the_identity_on_plain_tensors(tmp_path):
    mp.spawn(_rank, args=(str(tmp_path / "rendezvous"),), nprocs=WORLD,
             join=True)
