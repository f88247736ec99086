"""The port's expert-parallel MoE forms (``_moe_ep_psum``, ``_moe_ep_a2a``
in ``repro_torch.models.moe``) on 4 gloo ranks against the reference's
``moe_forward`` under ``shard_map`` on 4 JAX host devices.

The weights and tokens are seeded numpy arrays (float32) handed to both
packages. Each case takes the value and the gradient of
``sum(y**2) / y.size + moe_aux_coef * aux`` on a (data, model) mesh. JAX
runs it as one program over the global batch; each port rank takes its
data shard's part of the loss, and its gradients are averaged over the
data group, as the train step averages them. Held:

* the expert ids each rank routes and the slots it keeps, exactly (the
  reference's ids from ``_route`` on the same shard of tokens, its kept
  slots from ``_dispatch_indices`` and ``_capacity``; for ``ep_a2a`` from
  the reference's two capacities re-derived in numpy);
* ``y`` and every gradient (the weights and ``x``) within ``rtol = atol =
  1e-4``, ``tests/test_torch_moe.py``'s bound on the dense path;
* the aux loss as the reference reports it: data shard 0's under ``ep``,
  the mean over the sequence chunks under ``ep_a2a``;
* every model rank's gradients bit for bit the same.

The JAX side runs in a subprocess beside the spawned ranks; JAX is never
imported by the ranks.
"""
import contextlib
import datetime
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import get_config
from repro_torch.models import moe as tm
from repro_torch.parallel import ParallelContext, parallel_context

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
TOL = 1e-4
# name: (arch, moe_impl, (data, model), x shape (global batch, S; d is the
# config's), capacity factor); at 0.5 slots drop at both of ep_a2a's
# capacities
CASES = {
    "qwen2-moe ep (1, 4)": ("qwen2-moe-a2.7b", "ep", (1, 4), (2, 16), 1.25),
    "qwen2-moe ep (2, 2)": ("qwen2-moe-a2.7b", "ep", (2, 2), (4, 16), 1.25),
    "qwen2-moe ep_a2a (1, 4)": ("qwen2-moe-a2.7b", "ep_a2a", (1, 4), (2, 16),
                                1.25),
    "qwen2-moe ep_a2a S=1": ("qwen2-moe-a2.7b", "ep_a2a", (1, 4), (4, 1),
                             1.25),
    "deepseek-moe ep (1, 4)": ("deepseek-moe-16b", "ep", (1, 4), (2, 16),
                               1.25),
    "deepseek-moe ep (2, 2)": ("deepseek-moe-16b", "ep", (2, 2), (4, 16),
                               1.25),
    "deepseek-moe ep_a2a (1, 4)": ("deepseek-moe-16b", "ep_a2a", (1, 4),
                                   (2, 16), 1.25),
    "deepseek-moe ep_a2a S=1": ("deepseek-moe-16b", "ep_a2a", (1, 4), (4, 1),
                                1.25),
    "qwen2-moe ep (2, 2), factor 0.5": ("qwen2-moe-a2.7b", "ep", (2, 2),
                                        (4, 16), 0.5),
    "qwen2-moe ep_a2a (1, 4), factor 0.5": ("qwen2-moe-a2.7b", "ep_a2a",
                                            (1, 4), (2, 32), 0.5),
}
WEIGHTS = ("router", "w_up", "w_gate", "w_down", "shared.w_up",
           "shared.w_gate", "shared.w_down")


def _cfg(arch: str, impl: str, factor: float):
    return get_config(arch, "smoke").with_(dtype="float32", moe_impl=impl,
                                           moe_capacity_factor=factor)


def _inputs(case: str, seed: int) -> dict:
    """Seeded weights (the reference's init scales) and tokens."""
    arch, impl, _, (b, s), factor = CASES[case]
    cfg = _cfg(arch, impl, factor)
    d, e, f, fs = cfg.d_model, cfg.moe_experts, cfg.moe_d_ff, cfg.d_ff
    rng = np.random.default_rng(seed)
    shapes = {"router": (d, e), "w_up": (e, d, f), "w_gate": (e, d, f),
              "w_down": (e, f, d), "shared.w_up": (d, fs),
              "shared.w_gate": (d, fs), "shared.w_down": (fs, d)}
    out = {k: (rng.standard_normal(sh) * sh[-2] ** -0.5).astype(np.float32)
           for k, sh in shapes.items()}
    out["x"] = rng.standard_normal((b, s, d)).astype(np.float32)
    return out


JAX_SCRIPT = r"""
import json, sys
import numpy as np
import jax
import jax.numpy as jnp

from repro.models import get_config
from repro.models import moe as jm
from repro.parallel.context import ParallelContext, parallel_context

d, cases = sys.argv[1], json.loads(sys.argv[2])
for name, (arch, impl, mesh_shape, _, factor), key in cases:
    inp = dict(np.load(f"{d}/in_{key}.npz"))
    cfg = get_config(arch, "smoke").with_(dtype="float32", moe_impl=impl,
                                          moe_capacity_factor=factor)
    p = {k: jnp.asarray(v) for k, v in inp.items()
         if k != "x" and not k.startswith("shared.")}
    p["shared"] = {k[7:]: jnp.asarray(v) for k, v in inp.items()
                   if k.startswith("shared.")}
    x = jnp.asarray(inp["x"])
    dp, tp = mesh_shape
    mesh = jax.make_mesh((dp, tp), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    ctx = ParallelContext(mesh=mesh, data_axes=("data",), model_axis="model")

    def loss(p, x):
        y, aux = jm.moe_forward(p, x, cfg)
        return jnp.sum(y ** 2) / y.size + cfg.moe_aux_coef * aux, (y, aux)

    with parallel_context(ctx):
        (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(p, x)
    out = {"y": np.asarray(y), "aux": np.asarray(aux), "g.x": np.asarray(gx)}
    out.update({f"g.{k}": np.asarray(v) for k, v in gp.items()
                if k != "shared"})
    out.update({f"g.shared.{k}": np.asarray(v)
                for k, v in gp["shared"].items()})
    # the routing each (data, model) rank does: ids and kept slots
    B, S, dm = x.shape
    b, k, e = B // dp, cfg.moe_top_k, cfg.moe_experts
    a2a = impl == "ep_a2a" and S % tp == 0
    for di in range(dp):
        xs = x[di * b:(di + 1) * b]
        if not a2a:
            n = b * S
            _, te, _ = jm._route(p, xs.reshape(n, dm), cfg)
            _, pos, order = jm._dispatch_indices(te, k, e)
            kept = np.zeros(n * k, bool)
            kept[np.asarray(order)] = np.asarray(pos) < jm._capacity(n, cfg)
            for m in range(tp):
                out[f"top_e.{di}.{m}"] = np.asarray(te)
                out[f"kept.{di}.{m}"] = kept.reshape(n, k)
            continue
        # the two capacities of _moe_ep_a2a_shardmap, in numpy
        s_loc, e_loc = S // tp, e // tp
        n = b * s_loc
        cap = max(8, -(-int(n * k / tp * cfg.moe_capacity_factor) // 8) * 8)
        cap2 = max(8, -(-int(tp * cap / e_loc * cfg.moe_capacity_factor)
                        // 8) * 8)
        src = []
        for m in range(tp):
            xc = xs[:, m * s_loc:(m + 1) * s_loc].reshape(n, dm)
            te = np.asarray(jm._route(p, xc, cfg)[1])
            flat = te.reshape(-1)
            order = np.argsort(flat // e_loc, kind="stable")
            sd = (flat // e_loc)[order]
            pos = np.arange(sd.size) - np.searchsorted(sd, sd, side="left")
            send = np.full((tp, cap), e)
            ok = pos < cap
            send[sd[ok], pos[ok]] = flat[order][ok]
            src.append((te, order, sd, pos, ok, send))
        kept2 = []
        for r in range(tp):
            recv = np.concatenate([src[m][5][r] for m in range(tp)])
            le = recv - r * e_loc
            key2 = np.where((le >= 0) & (le < e_loc), le, e_loc)
            o2 = np.argsort(key2, kind="stable")
            se2 = key2[o2]
            pos2 = np.arange(se2.size) - np.searchsorted(se2, se2,
                                                         side="left")
            kk = np.zeros(se2.size, bool)
            kk[o2] = (pos2 < cap2) & (se2 < e_loc)
            kept2.append(kk)
        for m, (te, order, sd, pos, ok, _) in enumerate(src):
            kept = np.zeros(n * k, bool)
            kept[order] = ok & np.array(
                [bool(kept2[int(r)][m * cap + int(q)]) if o else False
                 for r, q, o in zip(sd, pos, ok)])
            out[f"top_e.{di}.{m}"] = te
            out[f"kept.{di}.{m}"] = kept.reshape(n, k)
    np.savez(f"{d}/jax_{key}.npz", **out)
print("JAX_OK")
"""


@contextlib.contextmanager
def _recorded_slots(group):
    """Stand in for ``tm._route``, ``tm._positions`` and ``tm._experts``
    meanwhile, and record each routed call's slots: a list that gets one
    ``{"top_e": (N, k), "kept": (N, k) bool}`` a call over the tokens this
    rank routed; ``kept`` is whether a slot reached its expert, wherever
    that expert runs. Under ``ep_a2a`` (two sorts before the owner's
    dispatch) the owner's kept slots come back to their source over
    ``group`` in one all-to-all."""
    calls, seen = [], {}
    route, positions, experts = tm._route, tm._positions, tm._experts

    def _route(p, x2d, cfg):
        out = route(p, x2d, cfg)
        seen.update(top_e=out[1], sorts=[])
        return out

    def _positions(keys):
        seen["sorts"].append(positions(keys))
        return seen["sorts"][-1]

    def _experts(ex, x2d, top_w, sorted_e, pos_in_e, order, ok, *rest):
        cap = rest[2]
        if len(seen["sorts"]) == 1:      # dense, ep: every slot's position
            src, kept = order, pos_in_e < cap
        else:                            # ep_a2a, at the owner
            src, sd, pos = seen["sorts"][0]
            tp = dist.get_world_size(group)
            cap1 = x2d.shape[0] // tp    # the send buffer's rows a rank
            owner = torch.empty_like(ok).index_copy_(0, order, ok)
            back = torch.empty(owner.shape, dtype=torch.int32)
            dist.all_to_all_single(back, owner.to(torch.int32), group=group)
            kept = (pos < cap1) & back.bool()[
                torch.clamp(sd, max=tp - 1) * cap1
                + torch.clamp(pos, max=cap1 - 1)]
        top_e = seen["top_e"]
        calls.append(dict(top_e=top_e, kept=torch.empty_like(kept).index_copy_(
            0, src, kept).view(top_e.shape)))
        return experts(ex, x2d, top_w, sorted_e, pos_in_e, order, ok, *rest)

    tm._route, tm._positions, tm._experts = _route, _positions, _experts
    try:
        yield calls
    finally:
        tm._route, tm._positions, tm._experts = route, positions, experts


def _load(mod: tm.MoE, inp: dict) -> None:
    for name in WEIGHTS:
        *owner, leaf = name.split(".")
        tgt = mod.get_submodule(".".join(owner)) if owner else mod
        setattr(tgt, leaf, torch.nn.Parameter(torch.from_numpy(inp[name])))


def _rank(rank: int, init_file: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=WORLD, rank=rank,
                            timeout=datetime.timedelta(seconds=300))
    try:
        meshes = {shape: make_host_mesh(*shape, device_type="cpu")
                  for shape in sorted({c[2] for c in CASES.values()})}
        for key, case in enumerate(CASES):
            arch, impl, shape, _, factor = CASES[case]
            inp = dict(np.load(os.path.join(out_dir, f"in_{key}.npz")))
            cfg = _cfg(arch, impl, factor)
            ctx = ParallelContext(mesh=meshes[shape], data_axes=("data",),
                                  model_axis="model")
            mod = tm.MoE(cfg, torch.float32, device="cpu")
            _load(mod, inp)
            b = inp["x"].shape[0] // ctx.dp_size
            lo = ctx.data_index * b
            x = torch.from_numpy(inp["x"][lo:lo + b]).requires_grad_(True)
            with parallel_context(ctx), _recorded_slots(
                    ctx.model_group) as slots:
                y, aux = tm.moe_forward(mod, x, cfg)
                loss = (y ** 2).sum() / y.numel() + cfg.moe_aux_coef * aux
                named = dict(mod.named_parameters())
                grads = torch.autograd.grad(loss, [x] + list(named.values()))
            out = {"y": y.detach().numpy(), "aux": aux.detach().numpy(),
                   "data_index": ctx.data_index, "model_rank": ctx.model_rank,
                   "g.x": grads[0].numpy() / ctx.dp_size}
            for name, g in zip(named, grads[1:]):
                g = g.clone()       # the train step's mean over data ranks
                for grp in ctx.data_groups:
                    dist.all_reduce(g, group=grp)
                out[f"g.{name}"] = (g / ctx.dp_size).numpy()
            (rec,) = slots
            out.update(top_e=rec["top_e"].numpy(), kept=rec["kept"].numpy())
            np.savez(os.path.join(out_dir, f"port_{key}_{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``{case: (JAX's results, [each rank's results])}``."""
    d = tmp_path_factory.mktemp("moe_ep")
    for key, case in enumerate(CASES):
        np.savez(d / f"in_{key}.npz", **_inputs(case, seed=key))
    env = dict(os.environ,
               XLA_FLAGS=f"--xla_force_host_platform_device_count={WORLD}",
               JAX_PLATFORMS="cpu",
               PYTHONPATH="src" + os.pathsep + os.environ.get("PYTHONPATH",
                                                              ""))
    spec = [(c, CASES[c], k) for k, c in enumerate(CASES)]
    proc = subprocess.Popen([sys.executable, "-c", JAX_SCRIPT, str(d),
                             json.dumps(spec)], env=env, cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        mp.spawn(_rank, args=(str(d / "rendezvous"), str(d)), nprocs=WORLD,
                 join=True)
        out, err = proc.communicate(timeout=600)
    finally:
        proc.kill()
    assert "JAX_OK" in out, out + "\n" + err
    return {c: (dict(np.load(d / f"jax_{k}.npz")),
                [dict(np.load(d / f"port_{k}_{r}.npz")) for r in range(WORLD)])
            for k, c in enumerate(CASES)}


@pytest.mark.parametrize("case", list(CASES))
def test_routing_and_kept_slots_match_jax(runs, case):
    want, ranks = runs[case]
    dropped = sum(int((~r["kept"]).sum()) for r in ranks)
    assert bool(dropped) == (CASES[case][4] < 1), dropped
    for r in ranks:
        key = f"{int(r['data_index'])}.{int(r['model_rank'])}"
        np.testing.assert_array_equal(r["top_e"], want[f"top_e.{key}"])
        np.testing.assert_array_equal(r["kept"], want[f"kept.{key}"])


@pytest.mark.parametrize("case", list(CASES))
def test_output_and_gradients_match_jax(runs, case):
    want, ranks = runs[case]
    b = want["y"].shape[0] // CASES[case][2][0]
    for r in ranks:
        lo = int(r["data_index"]) * b
        np.testing.assert_allclose(r["y"], want["y"][lo:lo + b], rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(r["g.x"], want["g.x"][lo:lo + b],
                                   rtol=TOL, atol=TOL)
        for name in WEIGHTS:
            np.testing.assert_allclose(r[f"g.{name}"], want[f"g.{name}"],
                                       rtol=TOL, atol=TOL, err_msg=name)


@pytest.mark.parametrize("case", list(CASES))
def test_aux_as_the_reference_reports_it(runs, case):
    """Data shard 0's aux (``ep``), the mean over the sequence chunks
    (``ep_a2a``): every data-rank-0 rank holds the reference's value."""
    want, ranks = runs[case]
    for r in ranks:
        if int(r["data_index"]) == 0:
            np.testing.assert_allclose(r["aux"], want["aux"], rtol=TOL)


@pytest.mark.parametrize("case", list(CASES))
def test_model_ranks_hold_the_same_gradients(runs, case):
    _, ranks = runs[case]
    by_data = {}
    for r in ranks:
        by_data.setdefault(int(r["data_index"]), []).append(r)
    for group in by_data.values():
        for r in group[1:]:
            for name in WEIGHTS:
                np.testing.assert_array_equal(r[f"g.{name}"],
                                              group[0][f"g.{name}"], name)
            np.testing.assert_array_equal(r["y"], group[0]["y"])

