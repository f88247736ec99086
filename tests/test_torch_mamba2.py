"""The port's Mamba-2 layer (``repro_torch.models.mamba2``) against the JAX
package's (``repro.models.mamba2``).

The same seeded inputs, and the reference's ``init_mamba2`` weights, go
through both packages on the CPU. ``ssd_chunked`` runs the reference test's
grid (``tests/models/test_mamba2_ssd.py``: s in {16, 32, 24, 64} with their
chunks, seeds 0 and 1) and its ``init_state`` continuation, held to the
reference within that test's 2e-4; the layer's forward (also at a length
that is not a multiple of the chunk) and its decode steps within 1e-4 at
float32, and within 2e-2 of the output's scale at bfloat16.
"""
import os

import numpy as np
import pytest
import torch

os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import get_config as j_get_config  # noqa: E402
from repro.models import mamba2 as jm  # noqa: E402
from repro_torch.convert import tensor_from_numpy  # noqa: E402
from repro_torch.models import get_config  # noqa: E402
from repro_torch.models import mamba2 as tm  # noqa: E402

TOL = 2e-4                      # tests/models/test_mamba2_ssd.py
j_ssd_chunked = jax.jit(jm.ssd_chunked, static_argnums=5)


def _cfgs(arch="mamba2-130m", **kw):
    return (j_get_config(arch, "smoke").with_(**kw),
            get_config(arch, "smoke").with_(**kw))


def _layer(dtype="float32", arch="mamba2-130m", seed=0):
    jcfg, tcfg = _cfgs(arch, dtype=dtype)
    jp = jm.init_mamba2(jax.random.PRNGKey(seed), jcfg, jnp.dtype(dtype))
    tp = tm.Mamba2(tcfg, getattr(torch, dtype), device="cpu")
    for name, a in jp.items():
        getattr(tp, name).data = tensor_from_numpy(np.asarray(a))
    return jcfg, tcfg, jp, tp


def _ssd_inputs(seed: int, b: int, s: int, h: int, p: int, n: int):
    """The reference test's draws, as numpy."""
    ks = jax.random.split(jax.random.PRNGKey(seed), 4)
    x = jax.random.normal(ks[0], (b, s, h, p))
    dt = jax.nn.softplus(jax.random.normal(ks[1], (b, s, h)))
    A = -jnp.exp(jax.random.normal(ks[2], (h,)) * 0.5)
    Bm = jax.random.normal(ks[3], (b, s, n)) * 0.5
    Cm = jax.random.normal(jax.random.PRNGKey(seed + 10), (b, s, n)) * 0.5
    return [np.array(t) for t in (x, dt, A, Bm, Cm)]


def _close(got: torch.Tensor, want, dtype: str, tol: float = 1e-4) -> None:
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
        return
    assert np.isfinite(got).all()
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= 2e-2 * scale, (err, scale)


# ---------------------------------------------------------------------- SSD
def test_segsum_matches_jax():
    x = np.random.default_rng(0).normal(size=(2, 3, 9)).astype(np.float32)
    want = np.asarray(jm._segsum(jnp.asarray(x)))
    got = tm._segsum(torch.from_numpy(x)).numpy()
    upper = ~np.tril(np.ones((9, 9), bool))
    assert np.isneginf(got[..., upper]).all() and np.isneginf(
        want[..., upper]).all()
    np.testing.assert_allclose(got[..., ~upper], want[..., ~upper],
                               rtol=1e-6, atol=1e-6)
    assert (torch.exp(tm._segsum(torch.from_numpy(x))).numpy()[..., upper]
            == 0).all()


@pytest.mark.parametrize("s,chunk", [(16, 4), (32, 8), (24, 8), (64, 16)])
@pytest.mark.parametrize("seed", [0, 1])
def test_ssd_chunked_matches_jax(s, chunk, seed):
    x, dt, A, Bm, Cm = _ssd_inputs(seed, 2, s, 3, 4, 8)
    want_y, want_st = j_ssd_chunked(*map(jnp.asarray, (x, dt, A, Bm, Cm)),
                                     chunk)
    y, st = tm.ssd_chunked(*map(torch.from_numpy, (x, dt, A, Bm, Cm)), chunk)
    assert y.dtype == st.dtype == torch.float32
    assert tuple(st.shape) == (2, 3, 4, 8)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(want_st), rtol=TOL,
                               atol=TOL)


def test_ssd_initial_state_continuation_matches_jax():
    """The second half of a sequence from the first half's state: the
    reference's output and state, and the port's own full pass."""
    x, dt, A, Bm, Cm = _ssd_inputs(3, 1, 32, 2, 4, 8)
    half, chunk = 16, 8
    t = [torch.from_numpy(a) for a in (x, dt, A, Bm, Cm)]
    y_full, st_full = tm.ssd_chunked(*t, chunk)
    first = [a[:, :half] if a.ndim > 1 else a for a in t]
    second = [a[:, half:] if a.ndim > 1 else a for a in t]
    y1, st1 = tm.ssd_chunked(*first, chunk)
    y2, st2 = tm.ssd_chunked(*second, chunk, init_state=st1)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), y_full.numpy(),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(st2.numpy(), st_full.numpy(), rtol=TOL,
                               atol=TOL)
    j = [jnp.asarray(a) for a in (x, dt, A, Bm, Cm)]
    _, jst1 = jm.ssd_chunked(*[a[:, :half] if a.ndim > 1 else a for a in j],
                             chunk)
    jy2, jst2 = jm.ssd_chunked(*[a[:, half:] if a.ndim > 1 else a for a in j],
                               chunk, init_state=jst1)
    np.testing.assert_allclose(y2.numpy(), np.asarray(jy2), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(st2.numpy(), np.asarray(jst2), rtol=TOL,
                               atol=TOL)


def test_ssd_chunked_rejects_a_ragged_sequence():
    x, dt, A, Bm, Cm = (torch.from_numpy(a)
                        for a in _ssd_inputs(0, 1, 12, 2, 4, 8))
    with pytest.raises(ValueError, match="multiple of the chunk"):
        tm.ssd_chunked(x, dt, A, Bm, Cm, 8)


# -------------------------------------------------------------------- layer
@pytest.mark.parametrize("S", [32, 21, 5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_forward_matches_jax(dtype, S):
    """S = 21 and 5 are not multiples of the smoke chunk (16): both pad with
    dt = 0."""
    jcfg, tcfg, jp, tp = _layer(dtype)
    x = (np.random.default_rng(1).normal(size=(2, S, tcfg.d_model)) * 0.5
         ).astype(np.float32)
    want = jm.mamba2_forward(jp, jnp.asarray(x).astype(dtype), jcfg)
    got = tm.mamba2_forward(tp, torch.from_numpy(x).to(getattr(torch, dtype)),
                            tcfg)
    assert got.dtype == getattr(torch, dtype)
    assert tuple(got.shape) == (2, S, tcfg.d_model)
    _close(got, want, dtype)


@pytest.mark.parametrize("arch", ["mamba2-130m", "jamba-v0.1-52b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_decode_steps_match_jax(arch, dtype):
    """Twelve one-token steps from a zero cache, each fed the same input:
    the outputs, the state and the conv window after every step; the
    port's cache tensors are written in place."""
    jcfg, tcfg, jp, tp = _layer(dtype, arch)
    B = 2
    jcache = jm.mamba2_init_cache(jcfg, B)
    tcache = tm.mamba2_init_cache(tcfg, B, device="cpu")
    assert {k: tuple(v.shape) for k, v in tcache.items()} == \
        {k: tuple(v.shape) for k, v in jcache.items()}
    state = tcache["state"]
    xs = (np.random.default_rng(2).normal(size=(12, B, 1, tcfg.d_model))
          * 0.5).astype(np.float32)
    for x in xs:
        want, jcache = jm.mamba2_decode_step(
            jp, jnp.asarray(x).astype(dtype), jcache, jcfg)
        got, tcache = tm.mamba2_decode_step(
            tp, torch.from_numpy(x).to(getattr(torch, dtype)), tcache, tcfg)
        assert tcache["state"] is state
        _close(got, want, dtype)
        for key in ("state", "conv"):
            _close(tcache[key], jcache[key], "float32" if dtype == "float32"
                   else "bfloat16")


def test_mamba2_decode_matches_its_forward():
    """The port alone: stepping the recurrence over a sequence gives the
    chunked forward's output (the reference test's check, 5e-3)."""
    _, tcfg, _, tp = _layer("float32")
    x = torch.from_numpy((np.random.default_rng(4).normal(
        size=(2, 16, tcfg.d_model)) * 0.3).astype(np.float32))
    full = tm.mamba2_forward(tp, x, tcfg)
    cache = tm.mamba2_init_cache(tcfg, 2, device="cpu")
    steps = [tm.mamba2_decode_step(tp, x[:, t:t + 1], cache, tcfg)[0]
             for t in range(16)]
    np.testing.assert_allclose(torch.cat(steps, 1).numpy(), full.numpy(),
                               rtol=5e-3, atol=5e-3)


def test_init_mamba2_matches_the_reference():
    """Shapes and dtypes equal; the float32 constants equal to the
    reference's (``A_log`` within one float32 rounding: XLA's ``linspace``
    and ``log`` are not correctly rounded everywhere); the random weights at
    the reference's scales."""
    for arch in ("mamba2-130m", "jamba-v0.1-52b"):
        for variant in ("smoke", "full"):
            jcfg = j_get_config(arch, variant)
            tcfg = get_config(arch, variant)
            if variant == "full":
                jcfg, tcfg = (c.with_(d_model=256) for c in (jcfg, tcfg))
            jp = jm.init_mamba2(jax.random.PRNGKey(0), jcfg, jnp.bfloat16)
            tp = tm.Mamba2(tcfg, torch.bfloat16, "cpu",
                           torch.Generator().manual_seed(0))
            for name, a in jp.items():
                t = getattr(tp, name)
                assert tuple(t.shape) == a.shape, name
                assert str(t.dtype).removeprefix("torch.") == str(a.dtype)
            np.testing.assert_allclose(tp.A_log.numpy(), np.asarray(
                jp["A_log"]), rtol=2.4e-7, atol=0)
            for name in ("D", "dt_bias", "norm_scale", "conv_b"):
                np.testing.assert_array_equal(getattr(tp, name).float(),
                                              np.asarray(jp[name], np.float32))
            d, di, K = tcfg.d_model, tcfg.ssm_d_inner, tcfg.ssm_conv
            for name, scale in (("w_in", d ** -0.5), ("w_out", di ** -0.5),
                                ("conv_w", K ** -0.5)):
                std = float(getattr(tp, name).float().std())
                assert abs(std / scale - 1) < 0.05, (name, std, scale)
