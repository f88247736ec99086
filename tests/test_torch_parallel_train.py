"""One training step of the float32 qwen2-moe smoke model on a (data,
model) mesh: the port's gloo ranks under a ``ParallelContext`` against
JAX's ``make_train_step`` under the reference's context on as many host
devices.

* mesh (2, 1), ``auto``: the reference's MoE layers take the dense path,
  one GSPMD program over the global batch, so capacity, drops and the aux
  loss are global; the port's dense path gathers the data group's tokens.
* mesh (2, 2), ``auto``: ``ep`` over the model axis, per data shard; the
  reported aux loss is data shard 0's.
* mesh (2, 2), ``canary_fp``: per data shard, dense (no expert-parallel
  form inside the explicit modes), the fixed-point Canary sync over the
  data groups.

Held at ``tests/test_torch_moe.py``'s training bounds: the loss and
``aux_loss`` within 1e-5 relative; every gradient leaf (the port's
tensors grouped by ``convert._reference_leaves``) within 1e-5 of its
leaf's largest value; the AdamW update of every weight within 1.5e-5 of
its largest value, plus one rounding of the stored weight, where the sign
of the gradient is settled (|g| > 1e-3 of its leaf's max; in
``canary_fp``, of the port's synced gradient). Every model rank ends the
step with the same weights, bit for bit.

JAX runs in a subprocess beside the spawned ranks; the weights are JAX's
``init_params``, handed to the ranks as numpy.
"""
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

os.environ.setdefault("JAX_PLATFORMS", "cpu")
from repro_torch.convert import (_reference_leaves,  # noqa: E402
                                 params_from_reference)
from repro_torch.data import DataConfig, batch_at  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models import get_config  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.optim import init as adamw_init  # noqa: E402
from repro_torch.parallel import (ParallelContext,  # noqa: E402
                                  parallel_context)
from repro_torch.train import (Mesh, TrainConfig, make_loss_fn,  # noqa: E402
                               make_train_step, value_and_grad)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "qwen2-moe-a2.7b"
B, S, LR = 4, 16, 1e-3
# name: ((data, model), grad_sync)
CASES = {"auto (2, 1)": ((2, 1), "auto"), "auto (2, 2)": ((2, 2), "auto"),
         "canary_fp (2, 2)": ((2, 2), "canary_fp")}


def _cfg():
    return get_config(ARCH, "smoke").with_(dtype="float32")


JAX_SCRIPT = r"""
import json, sys
import numpy as np
import jax
import jax.numpy as jnp

from repro.data import DataConfig, batch_at
from repro.models import get_config, init_params
from repro.optim import AdamWConfig, init as adamw_init
from repro.parallel.context import ParallelContext, parallel_context
from repro.train import TrainConfig, make_loss_fn, make_train_step

d, C = sys.argv[1], json.loads(sys.argv[2])
cfg = get_config(C["arch"], "smoke").with_(dtype="float32")
params = init_params(cfg, jax.random.PRNGKey(0))
batch = {k: jnp.asarray(v) for k, v in batch_at(
    DataConfig(cfg.vocab_size, C["B"], C["S"]), 0).items()}
for key, ((dp, tp), mode) in enumerate(C["cases"]):
    tc = TrainConfig(model=cfg, optimizer=AdamWConfig(lr=C["lr"]),
                     grad_sync=mode)
    mesh = jax.make_mesh((dp, tp), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2,
                         devices=jax.devices()[:dp * tp])
    ctx = ParallelContext(mesh=mesh, data_axes=("data",), model_axis="model")
    with parallel_context(ctx):
        new, _, m = jax.jit(make_train_step(tc, mesh=mesh))(
            params, adamw_init(params, tc.optimizer), batch)
        out = {f"p{i}": np.asarray(a)
               for i, a in enumerate(jax.tree_util.tree_leaves(new))}
        if mode == "auto":
            (_, _), g = jax.jit(jax.value_and_grad(
                make_loss_fn(tc), has_aux=True))(params, batch)
            out.update({f"g{i}": np.asarray(a)
                        for i, a in enumerate(jax.tree_util.tree_leaves(g))})
    np.savez(f"{d}/jax_{key}.npz", loss=np.asarray(m["loss"]),
             aux=np.asarray(m["aux_loss"]), **out)
print("JAX_OK")
"""


def _rank(rank: int, world: int, init_file: str, out_dir: str, np_params,
          keys) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=300))
    try:
        for key in keys:
            (dp, tp), mode = CASES[list(CASES)[key]]
            ctx = ParallelContext(
                mesh=make_host_mesh(dp, tp, device_type="cpu"),
                data_axes=("data",), model_axis="model")
            mesh = Mesh.of(ctx)
            tc = TrainConfig(model=_cfg(), optimizer=AdamWConfig(lr=LR),
                             grad_sync=mode)
            batch = {k: torch.from_numpy(v) for k, v in batch_at(
                DataConfig(tc.model.vocab_size, B, S), 0,
                mesh.batch_slice(B)).items()}
            out = {}
            with parallel_context(ctx):
                if mode == "auto":   # the step's gradients: averaged
                    p = params_from_reference(np_params, tc.model, "cpu")
                    _, grads = value_and_grad(make_loss_fn(tc), p, batch)
                    for n, g in grads.items():
                        dist.all_reduce(g, group=mesh.inner)
                        out[f"g.{n}"] = (g / mesh.size).numpy()
                p = params_from_reference(np_params, tc.model, "cpu")
                synced = {}
                _, _, m = make_train_step(
                    tc, mesh, on_sync=lambda raw, s: synced.update(
                        {n: g.clone() for n, g in s.items()}))(
                    p, adamw_init(p, tc.optimizer), batch)
            out.update({f"s.{n}": (g / mesh.size).numpy()
                        for n, g in synced.items()})
            out.update({f"p.{n}": t.detach().numpy()
                        for n, t in p.named_parameters()})
            np.savez(os.path.join(out_dir, f"port_{key}_{rank}.npz"),
                     loss=float(m["loss"]), aux=float(m["aux_loss"]),
                     data_index=ctx.data_index, **out)
            dist.barrier()
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``{case: (JAX's results by port name, [each rank's results])}``."""
    import jax

    from repro.models import get_config as j_get_config
    from repro.models import init_params
    jcfg = j_get_config(ARCH, "smoke").with_(dtype="float32")
    jp = init_params(jcfg, jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, jp)
    treedef = jax.tree_util.tree_structure(jp)
    d = tmp_path_factory.mktemp("parallel_train")
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu",
               PYTHONPATH="src" + os.pathsep + os.environ.get("PYTHONPATH",
                                                              ""))
    proc = subprocess.Popen(
        [sys.executable, "-c", JAX_SCRIPT, str(d), json.dumps(dict(
            arch=ARCH, B=B, S=S, lr=LR, cases=list(CASES.values())))],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        for world in (2, 4):
            keys = [k for k, c in enumerate(CASES.values())
                    if c[0][0] * c[0][1] == world]
            mp.spawn(_rank, args=(world, str(d / f"rdv{world}"), str(d),
                                  np_params, keys), nprocs=world, join=True)
        out, err = proc.communicate(timeout=600)
    finally:
        proc.kill()
    assert "JAX_OK" in out, out + "\n" + err
    cfg = _cfg()
    res = {}
    for key, case in enumerate(CASES):
        j = dict(np.load(d / f"jax_{key}.npz"))
        want = {}
        for prefix in ("p", "g"):
            leaves = [j[f"{prefix}{i}"] for i in range(treedef.num_leaves)
                      if f"{prefix}{i}" in j]
            if leaves:
                tree = jax.tree_util.tree_unflatten(treedef, leaves)
                want.update({f"{prefix}.{n}": a for n, a in
                             _reference_leaves(tree, cfg).items()})
        want.update(loss=j["loss"], aux=j["aux"])
        (dp, tp), _ = CASES[case]
        ranks = [dict(np.load(d / f"port_{key}_{r}.npz"))
                 for r in range(dp * tp)]
        res[case] = (want, ranks)
    res["init"] = {n: a for n, a in _reference_leaves(np_params, cfg).items()}
    return res


@pytest.mark.parametrize("case", list(CASES))
def test_loss_and_aux_match_jax(runs, case):
    want, ranks = runs[case]
    for r in ranks:
        np.testing.assert_allclose(r["loss"], want["loss"], rtol=1e-5)
        np.testing.assert_allclose(r["aux"], want["aux"], rtol=1e-5)


@pytest.mark.parametrize("case", [c for c in CASES if CASES[c][1] == "auto"])
def test_gradients_match_jax(runs, case):
    want, ranks = runs[case]
    for r in ranks:
        names = [k for k in r if k.startswith("g.")]
        assert set(names) == {k for k in want if k.startswith("g.")}
        for n in names:
            err = np.abs(r[n] - want[n]).max()
            assert err <= 1e-5 * np.abs(want[n]).max(), (n, err)


@pytest.mark.parametrize("case", list(CASES))
def test_updated_weights_match_jax(runs, case):
    want, ranks = runs[case]
    init = runs["init"]
    for r in ranks:
        for n, w0 in init.items():
            got, ref = r[f"p.{n}"] - w0, want[f"p.{n}"] - w0
            assert np.isfinite(got).all()
            # the sign of g settled: JAX's g, or the port's synced one
            g = np.abs(want[f"g.{n}"] if f"g.{n}" in want else r[f"s.{n}"])
            settled = g > 1e-3 * g.max()
            # plus one rounding of the stored weight
            bound = 1.5e-5 * np.abs(ref).max() + np.spacing(
                np.abs(want[f"p.{n}"]))
            bad = (np.abs(got - ref) > bound) & settled
            assert not bad.any(), (n, np.abs(got - ref)[bad].max())


@pytest.mark.parametrize("case", list(CASES))
def test_model_ranks_end_with_the_same_weights(runs, case):
    _, ranks = runs[case]
    by_data = {}
    for r in ranks:
        by_data.setdefault(int(r["data_index"]), []).append(r)
    for group in by_data.values():
        for r in group[1:]:
            for k in r:
                if k.startswith("p."):
                    np.testing.assert_array_equal(r[k], group[0][k], k)


# ------------------------------------------------------------- the launcher
LAUNCH_ARGS = ["--arch", ARCH, "--variant", "smoke", "--data-parallel", "2",
               "--model-parallel", "2", "--steps", "2", "--log-every", "1"]
JAX_LAUNCH_SCRIPT = r"""
import json, sys
import jax

import repro.launch.train as lt
from repro.checkpoint import save_checkpoint
from repro.optim import AdamWConfig
from repro.train import TrainConfig, init_train_state

d, argv = sys.argv[1], json.loads(sys.argv[2])
config = lt.get_config
lt.get_config = lambda arch, variant: config(arch, variant).with_(
    dtype="float32")
# the trainer's initial state (seed 0), for the port to start from
params, opt = init_train_state(TrainConfig(model=lt.get_config(
    argv[1], "smoke"), optimizer=AdamWConfig()), jax.random.PRNGKey(0))
save_checkpoint(d + "/init", 0, params, opt)
lt.main(argv + ["--history-out", d + "/jax.json"])
print("JAX_OK")
"""


def _launcher_rank(rank: int, world: int, init_file: str, argv: list,
                   init_dir: str) -> None:
    """One rank of the port's launcher (``_rank_main``, which builds the
    trainer with ``make_trainer`` and runs it under the context), patched
    as the reference's side is: the config turned to float32, and the
    reference trainer's initial state restored before ``run()``. Each rank
    computes on one intra-op thread: with the launcher's share of the
    host's cores (two a rank on eight), the rounding of some sums follows
    how the host's load schedules a rank's threads, and AdamW turns such a
    difference in a gradient near 0 into a whole step of that weight (the
    second step's loss moved in 2 of 8 runs beside other processes, once
    by 2.1e-5 relative in a full test run)."""
    import repro_torch.launch.train as lt
    from repro_torch.checkpoint import restore_checkpoint
    config, make = lt.get_config, lt.make_trainer
    lt.get_config = lambda arch, variant: config(arch, variant).with_(
        dtype="float32")

    def from_init(*a, **k):
        torch.set_num_threads(1)        # after _rank_main's share
        trainer, ctx = make(*a, **k)
        restore_checkpoint(init_dir, 0, trainer.params, trainer.opt_state)
        return trainer, ctx
    lt.make_trainer = from_init
    lt._rank_main(rank, lt.parse_args(argv), world, init_file)


def test_launcher_model_parallel_matches_jax_launcher(tmp_path):
    """The port's launcher at ``--data-parallel 2 --model-parallel 2`` on
    4 gloo ranks, in float32 from the reference trainer's initial state,
    against ``repro.launch.train`` (its config turned to float32) on 4
    host devices: the losses and aux losses of both steps within 1e-5
    relative. Beside them, ``python -m repro_torch.launch.train`` with
    the same arguments (the config's bf16, its own initial state) runs to
    its end."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH="src" + os.pathsep + os.environ.get("PYTHONPATH",
                                                              ""))
    ref = subprocess.Popen([sys.executable, "-c", JAX_LAUNCH_SCRIPT,
                            str(tmp_path), json.dumps(LAUNCH_ARGS)], env=env,
                           cwd=ROOT, stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    cli = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", *LAUNCH_ARGS,
         "--device", "cpu"], env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        out, err = ref.communicate(timeout=600)
        assert "JAX_OK" in out, out + err
        mp.spawn(_launcher_rank, args=(
            4, str(tmp_path / "rendezvous"), LAUNCH_ARGS + [
                "--device", "cpu", "--history-out",
                str(tmp_path / "port.json")], str(tmp_path / "init")),
                 nprocs=4, join=True)
        out, err = cli.communicate(timeout=600)
    finally:
        ref.kill()
        cli.kill()
    assert cli.returncode == 0, out + err
    assert "2 data-parallel ranks on cpu, 2 model-parallel ranks each" in \
        out, out
    want = json.loads((tmp_path / "jax.json").read_text())
    got = json.loads((tmp_path / "port.json").read_text())
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for key in ("loss", "aux_loss"):
            np.testing.assert_allclose(g[key], w[key], rtol=1e-5,
                                       err_msg=key)


def test_moe_canary_example_runs_two_steps():
    """``examples/train_moe_canary_torch.py`` on 8 gloo CPU ranks, 2 steps:
    its own asserts (every mode's losses agree with ``auto``'s) pass."""
    proc = subprocess.run(
        [sys.executable, "examples/train_moe_canary_torch.py", "--device",
         "cpu", "--steps", "2"],
        env=dict(os.environ, PYTHONPATH="src" + os.pathsep
                 + os.environ.get("PYTHONPATH", "")),
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "converge identically — OK" in proc.stdout
