"""The port's parallel context, sharding rules and meshes
(``repro_torch.parallel``, ``repro_torch.launch.mesh``) against the JAX
package's (``repro.parallel``, ``repro.launch.mesh``).

* Sharding rules, on shapes only: for every arch of the registry, full and
  smoke, at the production meshes (16, 16) and (2, 16, 16) and at (1, 1),
  (2, 4) and (8, 1) (``jax.sharding.AbstractMesh`` on the reference's
  side, which needs no devices; the axis sizes on the port's). Each of the
  port's per-layer tensors gets the reference's spec of the leaf that
  stacks it, less the leading ``None``; ``batch_spec`` and ``cache_specs``
  (on ``init_cache``'s shapes) likewise. The reference's own cases
  (``tests/substrate/test_substrate.py``) run on the port.
* Placements: on a (2, 2) mesh of 4 gloo ranks, the local shard that
  ``param_placements`` gives each rank equals the slice that
  ``NamedSharding.devices_indices_map`` gives the JAX host device at the
  same coordinate (JAX in a subprocess), and rank ``r`` sits at
  ``(r // 2, r % 2)`` on both sides.
* The context's sizes, groups and indices on that mesh, and the
  production mesh refusing a world of another size.
"""
import datetime
import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

os.environ.setdefault("JAX_PLATFORMS", "cpu")
from repro_torch.convert import reference_leaves  # noqa: E402
from repro_torch.launch.mesh import (make_host_mesh,  # noqa: E402
                                     make_production_mesh, mesh_axes)
from repro_torch.models import (Transformer, get_config,  # noqa: E402
                                init_cache)
from repro_torch.models.registry import list_archs  # noqa: E402
from repro_torch.models.transformer import layer_period  # noqa: E402
from repro_torch.parallel import (P, ParallelContext,  # noqa: E402
                                  batch_spec, cache_specs,
                                  get_parallel_context, leaf_spec,
                                  param_placements, param_specs,
                                  parallel_context)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"(16, 16)": {"data": 16, "model": 16},
          "(2, 16, 16)": {"pod": 2, "data": 16, "model": 16},
          "(1, 1)": {"data": 1, "model": 1},
          "(2, 4)": {"data": 2, "model": 4},
          "(8, 1)": {"data": 8, "model": 1}}
VARIANTS = [(a, v) for a in list_archs() for v in ("full", "smoke")]


def _norm(spec) -> tuple:
    """A spec as a tuple, one-axis tuples as the axis (JAX's ``P`` equates
    them)."""
    return tuple(a[0] if isinstance(a, tuple) and len(a) == 1 else a
                 for a in spec)


def _unstacked(spec) -> tuple:
    """The reference's spec of a stacked leaf, less its leading ``None``."""
    t = _norm(spec)
    assert not t or t[0] is None, t
    return t[1:]


@functools.lru_cache(maxsize=None)
def _ref():
    import jax
    from jax.sharding import AbstractMesh

    from repro.models import get_config as j_get_config
    from repro.models import init_cache as j_init_cache
    from repro.models import init_params
    from repro.parallel import sharding as js
    return jax, AbstractMesh, j_get_config, init_params, j_init_cache, js


def _abstract(mesh: dict):
    _, AbstractMesh, *_ = _ref()
    return AbstractMesh(tuple(mesh.values()), tuple(mesh))


def _path(keypath) -> tuple:
    return tuple(getattr(k, "key", getattr(k, "idx", None)) for k in keypath)


@functools.lru_cache(maxsize=None)
def _ref_param_shapes(arch: str, variant: str):
    jax, _, j_get_config, init_params, _, _ = _ref()
    cfg = j_get_config(arch, variant)
    return jax.eval_shape(lambda: init_params(cfg, jax.random.PRNGKey(0)))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch,variant", VARIANTS)
def test_param_specs_match_reference(arch, variant, mesh):
    jax, _, _, _, _, js = _ref()
    sizes = MESHES[mesh]
    data_axes, model = mesh_axes(sizes)
    fsdp = data_axes if len(data_axes) > 1 else data_axes[0]
    shapes = _ref_param_shapes(arch, variant)
    ref = {_path(k): s for k, s in jax.tree_util.tree_flatten_with_path(
        js.param_specs(shapes, _abstract(sizes), fsdp=fsdp, model=model),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]}
    cfg = get_config(arch, variant)
    got = param_specs(Transformer(cfg, device="meta"), sizes, fsdp=fsdp,
                      model=model)
    leaves = reference_leaves(cfg)
    assert sum(len(leaf.names) for leaf in leaves) == len(got)
    for leaf in leaves:
        want = _unstacked(ref[leaf.path]) if leaf.stacked \
            else _norm(ref[leaf.path])
        for name in leaf.names:
            assert _norm(got[name]) == want, (name, got[name], want)


@pytest.mark.parametrize("batch", [1, 2, 8, 256, 512])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_batch_spec_matches_reference(mesh, batch):
    *_, js = _ref()
    sizes = MESHES[mesh]
    data_axes, _ = mesh_axes(sizes)
    dp = data_axes if len(data_axes) > 1 else data_axes[0]
    want = js.batch_spec(_abstract(sizes), batch, dp)
    assert _norm(batch_spec(sizes, batch, dp)) == _norm(want)


@pytest.mark.parametrize("batch", [1, 16, 256])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", list_archs())
def test_cache_specs_match_reference(arch, mesh, batch):
    """Smoke variants (the cache is built on the CPU), a 32-entry cache:
    KV heads or the cache length over the model axis."""
    jax, _, j_get_config, _, j_init_cache, js = _ref()
    sizes = MESHES[mesh]
    data_axes, model = mesh_axes(sizes)
    dp = data_axes if len(data_axes) > 1 else data_axes[0]
    jcfg = j_get_config(arch, "smoke")
    shapes = jax.eval_shape(lambda: j_init_cache(jcfg, batch, 32))
    ref = js.cache_specs(shapes, _abstract(sizes), dp_axes=dp, model=model)
    cfg = get_config(arch, "smoke")
    cache = init_cache(cfg, batch, 32, device="cpu")
    got = cache_specs(cache, sizes, dp_axes=dp, model=model)
    assert _norm(got["pos"]) == _norm(ref["pos"]) == ()
    per = layer_period(cfg)
    for i, layer in enumerate(got["layers"]):
        for k, spec in layer.items():
            assert _norm(spec) == _unstacked(ref["layers"][i % per][k]), \
                (i, k, spec)
    for layer in got.get("cross", []):
        for k, spec in layer.items():
            assert _norm(spec) == _unstacked(ref["cross"][k]), (k, spec)
    assert ("cross" in got) == ("cross" in ref)


# the reference's own cases, tests/substrate/test_substrate.py:139, 158
LEAF_CASES = [("wq", (2048, 32, 64), P("data", "model", None)),
              ("scale", (256,), P())]


@pytest.mark.parametrize("name,shape,want", LEAF_CASES)
def test_param_specs_divisibility_guards(name, shape, want):
    mesh = {"data": 1, "model": 1}
    assert leaf_spec(name, shape, mesh, fsdp="data", model="model") == want


@pytest.mark.parametrize("batch", [8, 1])
def test_batch_spec_fallbacks(batch):
    assert batch_spec({"data": 1, "model": 1}, batch, "data") == P("data")


def test_mesh_axes_and_context_nesting():
    assert mesh_axes({"pod": 2, "data": 16, "model": 16}) == (
        ("pod", "data"), "model")
    assert mesh_axes({"data": 16, "model": 16}) == (("data",), "model")
    assert get_parallel_context() is None
    a = ParallelContext(mesh=None, data_axes=("data",), model_axis="model")
    b = ParallelContext(mesh=None, data_axes=("pod", "data"),
                        model_axis="model")
    assert a.data_spec == "data" and b.data_spec == ("pod", "data")
    with parallel_context(a):
        with parallel_context(b):
            assert get_parallel_context() is b
        assert get_parallel_context() is a
    assert get_parallel_context() is None


def test_context_is_seen_from_other_threads():
    """Autograd's device threads run remat's recomputation: they must see
    the context the forward ran under."""
    import threading
    ctx = ParallelContext(mesh=None, data_axes=("data",), model_axis="model")
    seen = []
    with parallel_context(ctx):
        t = threading.Thread(target=lambda: seen.append(
            get_parallel_context()))
        t.start()
        t.join()
    assert seen == [ctx]


# ------------------------------------------------------ placements on ranks
PLACE_ARCH = "qwen2-moe-a2.7b"
# shapes beyond the model's: two axes on one dim, data-major
EXTRA = {"two axes, dim 0": ((8, 6), (("data", "model"), None)),
         "two axes, dim 2": ((4, 6, 8), (None, None, ("data", "model"))),
         "model, dim 1": ((3, 4), (None, "model"))}


def _place_cases() -> dict:
    """``{name: (shape, spec as a tuple)}``: every parameter of the smoke
    model at (2, 2), and :data:`EXTRA`."""
    cfg = get_config(PLACE_ARCH, "smoke")
    mesh = {"data": 2, "model": 2}
    named = dict(Transformer(cfg, device="meta").named_parameters())
    out = {n: (tuple(named[n].shape), tuple(s))
           for n, s in param_specs(named, mesh).items()}
    out.update(EXTRA)
    return out


JAX_SCRIPT = r"""
import json, sys
import jax
from jax.sharding import NamedSharding, PartitionSpec as P

cases = json.loads(sys.argv[1])
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
coords = {int(mesh.devices[d, m].id): [d, m]
          for d in range(2) for m in range(2)}
out = {"coords": coords, "slices": {}}
for name, (shape, spec) in cases.items():
    spec = P(*[tuple(a) if isinstance(a, list) else a for a in spec])
    idx = NamedSharding(mesh, spec).devices_indices_map(tuple(shape))
    out["slices"][name] = {
        str(dev.id): [[s.start or 0, shape[i] if s.stop is None else s.stop]
                      for i, s in enumerate(sl)]
        for dev, sl in idx.items()}
print("JAX_OUT " + json.dumps(out))
"""


def _place_rank(rank: int, init_file: str, cases: dict, out_dir: str):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=4, rank=rank,
                            timeout=datetime.timedelta(seconds=120))
    try:
        from torch.distributed.tensor import distribute_tensor
        mesh = make_host_mesh(2, 2, device_type="cpu")
        ctx = ParallelContext(mesh=mesh, data_axes=("data",),
                              model_axis="model")
        out = {"coord": list(mesh.get_coordinate()),
               "dp": ctx.dp_size, "tp": ctx.tp_size,
               "data_index": ctx.data_index, "model_rank": ctx.model_rank,
               "data_ranks": dist.get_process_group_ranks(
                   ctx.data_groups[0]),
               "model_ranks": dist.get_process_group_ranks(ctx.model_group),
               "local": {}}
        for name, (shape, spec) in cases.items():
            full = torch.arange(int(np.prod(shape)),
                                dtype=torch.float32).reshape(shape)
            spec = P(*[tuple(a) if isinstance(a, list) else a for a in spec])
            local = distribute_tensor(full, mesh, param_placements(
                spec, mesh)).to_local()
            out["local"][name] = local.numpy().tolist()
        try:
            make_production_mesh(device_type="cpu")
            out["production"] = "built"
        except ValueError as e:
            out["production"] = str(e)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def placed(tmp_path_factory):
    d = tmp_path_factory.mktemp("placements")
    cases = _place_cases()
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu",
               PYTHONPATH="src" + os.pathsep + os.environ.get("PYTHONPATH",
                                                              ""))
    proc = subprocess.run([sys.executable, "-c", JAX_SCRIPT,
                           json.dumps(cases)], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("JAX_OUT ")]
    assert line, proc.stdout + proc.stderr
    mp.spawn(_place_rank, args=(str(d / "rendezvous"), cases, str(d)),
             nprocs=4, join=True)
    ranks = [json.loads((d / f"rank{r}.json").read_text()) for r in range(4)]
    return cases, json.loads(line[0][len("JAX_OUT "):]), ranks


def test_rank_order_matches_jax_devices(placed):
    _, jx, ranks = placed
    for r, out in enumerate(ranks):
        assert out["coord"] == jx["coords"][str(r)] == [r // 2, r % 2]


@pytest.mark.parametrize("name", list(_place_cases()))
def test_placements_give_jax_local_slices(placed, name):
    cases, jx, ranks = placed
    shape, _ = cases[name]
    full = np.arange(int(np.prod(shape)), dtype=np.float32).reshape(shape)
    for r, out in enumerate(ranks):
        sl = tuple(slice(a, b) for a, b in jx["slices"][name][str(r)])
        np.testing.assert_array_equal(np.array(out["local"][name]).reshape(
            full[sl].shape), full[sl], err_msg=f"rank {r}")
        assert np.array(out["local"][name]).size == full[sl].size


def test_context_on_a_2x2_mesh(placed):
    _, _, ranks = placed
    for r, out in enumerate(ranks):
        d, m = r // 2, r % 2
        assert (out["dp"], out["tp"]) == (2, 2)
        assert (out["data_index"], out["model_rank"]) == (d, m)
        assert out["data_ranks"] == [m, 2 + m]
        assert out["model_ranks"] == [2 * d, 2 * d + 1]
        assert "needs 256 ranks" in out["production"]
