"""The port's kernels (``repro_torch.kernels``) against the JAX package's.

The same seeded numpy inputs go through the JAX function (Pallas in
interpret mode, as ``tests/kernels/test_kernels.py`` runs it) and the
port's wrapper on the CPU, which runs the kernel's plain PyTorch version.
The cases mirror ``tests/kernels/test_kernels.py``. int32 results must be
bit-equal; float32 segment-sums may differ by re-association only
(``rtol=atol=1e-5``, the reference test's own tolerance).

``test_kernels_match_plain_versions_on_cuda`` holds each CUDA kernel against
its plain version on the card and skips where there is none.
"""
import numpy as np
import pytest
import torch

try:  # the card's machine has no JAX: only the ``cuda`` test runs there
    import jax.numpy as jnp

    from repro.kernels import fixedpoint as jfp
    from repro.kernels import ops as jops
    from repro.kernels import packet_accum as jpa
    from repro.kernels import ref as jref
except ImportError:
    jnp = None

from repro_torch.core.trace.executor import run_plan
from repro_torch.core.trace.plan import lower_schedules
from repro_torch.core.trace.synthetic import random_schedules
from repro_torch.kernels import (dequantize, fixed_point_allreduce_wrap,
                                 fixed_point_scale, flash_attention,
                                 launch_counts,
                                 packet_accumulate, packet_accumulate_gather,
                                 quantize, reset_launch_counts)
from repro_torch.kernels.ref import (dequantize_ref,
                                     packet_accumulate_gather_ref,
                                     packet_accumulate_ref, quantize_ref)

ACCUM_CASES = [(10, 8, 4), (128, 128, 16), (1000, 64, 32), (77, 200, 7)]


def _normal(seed, shape, std=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * std
            ).astype(np.float32)


def _ids(seed, n, slots):
    return np.random.default_rng(seed).integers(0, slots, n).astype(np.int32)


def _ints(seed, shape):
    return np.random.default_rng(seed).integers(
        -1_000_000, 1_000_000, shape).astype(np.int32)


# ------------------------------------------------------------- fixed point
@pytest.mark.parametrize("shape", [(16,), (100,), (257,), (8, 128), (3, 5, 7),
                                   (1024, 33)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_matches_jax(shape, dtype):
    x = _normal(0, shape, 5.0)
    scale = 2.0 ** 16
    want = np.asarray(jfp.quantize(jnp.asarray(x).astype(dtype), scale))
    got = quantize(torch.from_numpy(x).to(getattr(torch, dtype)), scale)
    assert got.dtype == torch.int32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", [(64,), (300,), (16, 16)])
def test_dequantize_roundtrip_matches_jax(shape):
    x = _normal(1, shape)
    scale = 2.0 ** 20
    want = np.asarray(jfp.dequantize(jfp.quantize(jnp.asarray(x), scale),
                                     scale))
    got = dequantize(quantize(torch.from_numpy(x), scale), scale)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=0)
    np.testing.assert_allclose(got.numpy(), x, atol=2 / scale)


def test_fixed_point_scale_matches_jax_bits():
    """The scale is float32 and bit-equal to JAX's over a seeded sweep: the
    int32 results are bit-identical only if the scale is."""
    rng = np.random.default_rng(5)
    gmax = (10.0 ** rng.uniform(-6, 4, 256)).astype(np.float32)
    naive_misses = 0
    for bits in (8, 16, 20, 24, 30):
        for world in (1, 2, 3, 7, 10, 128, 1000):
            want = np.asarray(jops.fixed_point_scale(jnp.asarray(gmax),
                                                     bits=bits, world=world))
            g = torch.from_numpy(gmax)
            got = fixed_point_scale(g, bits=bits, world=world)
            assert got.dtype == torch.float32
            np.testing.assert_array_equal(got.numpy().view(np.int32),
                                          want.view(np.int32))
            naive = (2.0 ** bits - 1.0) / (g * world + 1e-30)
            naive_misses += int((naive.numpy().view(np.int32)
                                 != want.view(np.int32)).sum())
    # the hazard the explicit division avoids: ``float / tensor`` is a
    # reciprocal product in PyTorch and misses JAX's bits for some inputs
    assert naive_misses > 0
    s = fixed_point_scale(np.float32(3.5), bits=24, world=128)
    assert s.dim() == 0 and s.dtype == torch.float32


def test_fixed_point_allreduce_wrap_matches_jax():
    x = _normal(6, (4, 300), 2.0)
    gmax = np.float32(np.abs(x).max())
    want = np.asarray(jops.fixed_point_allreduce_wrap(
        jnp.asarray(x), lambda q: q + q[::-1], jnp.asarray(gmax), 20, 4))
    got = fixed_point_allreduce_wrap(torch.from_numpy(x),
                                     lambda q: q + q.flip(0), gmax, 20, 4)
    np.testing.assert_array_equal(got.numpy(), want)


# --------------------------------------------------------- packet accumulate
@pytest.mark.parametrize("n,d,slots", ACCUM_CASES)
def test_packet_accumulate_f32_matches_jax(n, d, slots):
    ids, pay = _ids(2, n, slots), _normal(3, (n, d))
    want = np.asarray(jpa.packet_accumulate(jnp.asarray(ids), jnp.asarray(pay),
                                            slots))
    got = packet_accumulate(torch.from_numpy(ids), torch.from_numpy(pay), slots)
    assert got.dtype == torch.float32 and tuple(got.shape) == (slots, d)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,d,slots", ACCUM_CASES)
def test_packet_accumulate_int32_matches_jax(n, d, slots):
    ids, pay = _ids(8, n, slots), _ints(9, (n, d))
    want = np.asarray(jpa.packet_accumulate(jnp.asarray(ids), jnp.asarray(pay),
                                            slots))
    got = packet_accumulate(torch.from_numpy(ids), torch.from_numpy(pay), slots)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", [torch.uint32, torch.int64])
def test_packet_accumulate_rejects_wrapping_int_dtypes(dtype):
    """Non-int32 integer payloads would silently wrap if cast — reject."""
    ids = torch.zeros(4, dtype=torch.int32)
    pay = torch.ones((4, 8), dtype=dtype)
    with pytest.raises(TypeError):
        packet_accumulate(ids, pay, 2)
    with pytest.raises(TypeError):
        packet_accumulate_ref(ids, pay, 2)


def test_packet_accumulate_ignores_out_of_range_ids():
    """Ids equal to ``num_slots`` (the Pallas wrapper's padding id) hit
    nothing, as in ``jax.ops.segment_sum``."""
    slots = 5
    ids = _ids(11, 64, slots + 1)          # about one in six is == slots
    assert (ids == slots).any()
    pay = _ints(12, (64, 24))
    want = np.asarray(jpa.packet_accumulate(jnp.asarray(ids), jnp.asarray(pay),
                                            slots))
    np.testing.assert_array_equal(
        want, np.asarray(jref.packet_accumulate_ref(jnp.asarray(ids),
                                                    jnp.asarray(pay), slots)))
    got = packet_accumulate(torch.from_numpy(ids), torch.from_numpy(pay), slots)
    np.testing.assert_array_equal(got.numpy(), want)


def test_wrappers_take_plain_versions_on_cpu():
    """A CPU tensor runs the plain version: no kernel launch is counted."""
    reset_launch_counts()
    x = torch.from_numpy(_normal(13, (8, 16)))
    dequantize(quantize(x, 256.0), 256.0)
    packet_accumulate(torch.zeros(8, dtype=torch.int32), x, 1)
    qkv = x.reshape(1, 2, 4, 16)
    flash_attention(qkv, qkv, qkv)
    qkv = qkv.clone().requires_grad_(True)
    flash_attention(qkv, qkv, qkv).sum().backward()
    plan = lower_schedules(random_schedules(8, 1, seed=0))
    out = torch.empty((8, 1, 16))
    packet_accumulate_gather(x, torch.empty((plan.scratch_rows, 16)), out,
                             *plan.on(torch.device("cpu"))[0])
    assert launch_counts() == {"quantize": 0, "dequantize": 0,
                               "packet_accumulate": 0,
                               "packet_accumulate_gather": 0,
                               "flash_attention": 0,
                               "flash_attention_bwd": 0}


def test_wrappers_reject_devices_other_than_cpu_and_cuda():
    x = torch.ones((4, 8), device="meta")
    ids = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        quantize(x, 1.0)
    with pytest.raises(ValueError, match="CUDA"):
        dequantize(x.to(torch.int32), 1.0)
    with pytest.raises(ValueError, match="CUDA"):
        packet_accumulate(ids, x, 2)


def test_build_without_nvcc_raises(monkeypatch):
    """Where neither PATH nor the CUDA toolkit holds ``nvcc``, building the
    kernels fails with a clear error."""
    import torch.utils.cpp_extension as cpp_extension

    from repro_torch.kernels import _build
    monkeypatch.setenv("PATH", "")
    monkeypatch.setattr(cpp_extension, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


# ------------------------------------------------------------------ the card
@pytest.mark.cuda
def test_kernels_match_plain_versions_on_cuda():
    """Each CUDA kernel against its plain version on the card, at the
    shapes of the main path and at ragged ones: int32 exact, f32
    segment-sums within 1e-5 and the same bits from launch to launch. The
    standalone segment-sum is one launch a call (int32 and int64 ids); the
    gathered one runs synthetic plans of fan-in 1 to P level by level."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    reset_launch_counts()
    for shape in [(257,), (3, 5, 7), (128, 64, 256)]:
        x = torch.from_numpy(_normal(0, shape, 5.0)).to(dev)
        scale = fixed_point_scale(x.abs().max(), bits=24, world=shape[0])
        for xin in (x, x.to(torch.bfloat16), x.reshape(-1)[1:]):
            q = quantize(xin.contiguous(), scale)
            assert torch.equal(q, quantize_ref(xin, scale))
        assert torch.equal(dequantize(q, scale), dequantize_ref(q, scale))
    for n, d, slots in ACCUM_CASES + [(128, 256, 8), (4096, 32, 1024),
                                      (300, 30, 50)]:
        ids = torch.from_numpy(_ids(2, n, slots)).to(dev)
        ids[::7] = slots                               # these hit nothing
        ids[3::11] = -1
        qi = torch.from_numpy(_ints(9, (n, d))).to(dev)
        for id_t in (ids, ids.long()):
            before = launch_counts()["packet_accumulate"]
            got = packet_accumulate(id_t, qi, slots)
            assert launch_counts()["packet_accumulate"] == before + 1
            assert torch.equal(got, packet_accumulate_ref(id_t, qi, slots))
        pf = torch.from_numpy(_normal(3, (n, d))).to(dev)
        for pay in (pf, pf.to(torch.bfloat16), pf[:, 1:]):
            a = packet_accumulate(ids, pay.contiguous(), slots)
            b = packet_accumulate(ids, pay.contiguous(), slots)
            assert torch.equal(a, b)
            torch.testing.assert_close(a, packet_accumulate_ref(ids, pay,
                                                                slots),
                                       rtol=1e-5, atol=1e-5)
    for hosts, blocks, d in [(128, 256, 256), (10, 7, 32), (33, 5, 30)]:
        plan = lower_schedules(random_schedules(hosts, blocks, seed=hosts))
        qi = torch.from_numpy(_ints(4, (hosts, blocks, d))).to(dev)
        got = run_plan(plan, qi)
        assert torch.equal(got, run_plan(
            plan, qi, gather=packet_accumulate_gather_ref))
        assert torch.equal(got, qi.sum(0, dtype=torch.int32).expand_as(qi))
        pf = torch.from_numpy(_normal(5, (hosts, blocks, d))).to(dev)
        a, b = run_plan(plan, pf), run_plan(plan, pf)
        assert torch.equal(a, b)
        torch.testing.assert_close(
            a, run_plan(plan, pf, gather=packet_accumulate_gather_ref),
            rtol=1e-5, atol=1e-5)
    torch.cuda.synchronize()
    counts = launch_counts()
    assert all(counts[k] > 0 for k in ("quantize", "dequantize",
                                       "packet_accumulate",
                                       "packet_accumulate_gather"))
