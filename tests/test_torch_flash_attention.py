"""The port's flash attention against the JAX package's.

The same seeded numpy inputs go through JAX's ``flash_attention`` (Pallas in
interpret mode, as ``tests/kernels/test_kernels.py`` runs it) and the port's
wrapper on the CPU, which runs the kernel's plain PyTorch version. The
tolerances are the reference test's own: 2e-5 for float32, 2e-2 for
bfloat16. bfloat16 inputs are the same bits on both sides (numpy float32
rounded to nearest even by each library).

``test_flash_attention_kernel_matches_plain_on_cuda`` holds the CUDA kernel
against its plain version on the card and skips where there is none.
"""
import numpy as np
import pytest
import torch

try:  # the card's machine has no JAX: only the ``cuda`` test runs there
    import jax.numpy as jnp

    from repro.kernels import flash_attention as jfa
    from repro.kernels import ref as jref
    from repro.models import layers as jlayers
except ImportError:
    jnp = None

from repro_torch.kernels import (flash_attention, launch_counts,
                                 reset_launch_counts)
from repro_torch.kernels.ref import flash_attention_ref
from repro_torch.models import layers as tlayers

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# the reference test's inputs (q, k, v all at 0.5: logits spread by 0.25,
# a near-uniform softmax) and peaked ones (q, k at 2, v at 1: logits spread
# by 4, so every output row is O(|v|) and a fault in any tile moves it)
FLAT, PEAKED = (0.5, 0.5, 0.5), (2.0, 2.0, 1.0)
# the largest ||got - want|| / ||want|| of a row, on the card
ROW_REL_TOL = {"float32": 1e-4, "bfloat16": 1e-2}


def _qkv(seed, B, H, KV, S, D, layout="bhsd", scales=FLAT):
    rng = np.random.default_rng(seed)
    shapes = ((B, H, S, D), (B, KV, S, D), (B, KV, S, D))
    if layout == "bshd":
        shapes = ((B, S, H, D), (B, S, KV, D), (B, S, KV, D))
    return [(rng.normal(size=s) * c).astype(np.float32)
            for s, c in zip(shapes, scales)]


def _to_jax(arrays, dtype):
    return [jnp.asarray(a).astype(dtype) for a in arrays]


def _to_torch(arrays, dtype):
    return [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# ------------------------------------------------ against the Pallas kernel
@pytest.mark.parametrize("B,H,KV,S,D", [
    (1, 4, 4, 128, 64),      # MHA
    (2, 4, 2, 256, 64),      # GQA 2:1
    (1, 8, 2, 128, 128),     # GQA 4:1
    (1, 2, 1, 512, 64),      # MQA-ish
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_jax(B, H, KV, S, D, dtype):
    arrays = _qkv(4, B, H, KV, S, D)
    want = jfa.flash_attention(*_to_jax(arrays, dtype), causal=True, bq=128,
                               bk=128)
    got = flash_attention(*_to_torch(arrays, dtype), causal=True)
    assert got.dtype == getattr(torch, dtype)
    assert tuple(got.shape) == (B, H, S, D)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.parametrize("B,H,KV,S,D", [
    (1, 4, 4, 128, 64),
    (2, 4, 2, 256, 64),
    (1, 8, 2, 128, 128),
    (1, 2, 1, 512, 64),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_peaked_matches_jax(B, H, KV, S, D, dtype):
    """The same shapes with a peaked softmax, where outputs are O(1)."""
    arrays = _qkv(12, B, H, KV, S, D, scales=PEAKED)
    want = jfa.flash_attention(*_to_jax(arrays, dtype), causal=True, bq=128,
                               bk=128)
    got = flash_attention(*_to_torch(arrays, dtype), causal=True)
    assert float(np.abs(_f32(want)).mean()) > 0.2
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=TOL[dtype],
                               atol=TOL[dtype])


def test_flash_attention_noncausal_matches_jax():
    arrays = _qkv(5, 1, 2, 2, 128, 64)
    want = jfa.flash_attention(*_to_jax(arrays, "float32"), causal=False)
    got = flash_attention(*_to_torch(arrays, "float32"), causal=False)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("S", [1, 100, 1000])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_ragged_matches_jax_ref(S, dtype):
    """Sequence lengths that are no multiple of a tile, against JAX's
    materialised oracle (the Pallas wrapper asserts ``S % 128 == 0``)."""
    arrays = _qkv(6, 2, 4, 2, S, 64)
    want = jref.flash_attention_ref(*_to_jax(arrays, dtype), causal=True)
    got = flash_attention(*_to_torch(arrays, dtype), causal=True)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [1, 32, 77])
def test_flash_attention_window_matches_jax_full_attention(causal, window):
    """The sliding-window term against JAX's materialised
    ``full_attention`` (float32, ragged S)."""
    q, k, v = _qkv(7, 1, 4, 2, 150, 64, layout="bshd")
    want = jlayers.full_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=causal,
                                  sliding_window=window)
    tq, tk, tv = (torch.from_numpy(a).transpose(1, 2) for a in (q, k, v))
    got = flash_attention(tq, tk, tv, causal=causal, window=window)
    np.testing.assert_allclose(_f32(got.transpose(1, 2)), _f32(want),
                               rtol=2e-5, atol=2e-5)


# --------------------------------------- against the model's chunked path
@pytest.mark.parametrize("window", [0, 32])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_attention_matches_jax(window, dtype):
    """The port's ``chunked_attention`` (which calls ``flash_attention``)
    against JAX's jnp online-softmax scan, S=256 in chunks of 64."""
    arrays = _qkv(8, 1, 4, 2, 256, 64, layout="bshd")
    want = jlayers.chunked_attention(*_to_jax(arrays, dtype), causal=True,
                                     chunk=64, sliding_window=window)
    got = tlayers.chunked_attention(*_to_torch(arrays, dtype), causal=True,
                                    chunk=64, sliding_window=window)
    assert tuple(got.shape) == (1, 256, 4, 64)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=TOL[dtype],
                               atol=TOL[dtype])


def test_chunked_attention_keeps_the_chunk_assert():
    q, k, v = _to_torch(_qkv(9, 1, 2, 2, 100, 64, layout="bshd"), "float32")
    with pytest.raises(AssertionError):
        tlayers.chunked_attention(q, k, v, causal=True, chunk=64)


# ------------------------------------------------------------ the wrapper
def test_flash_attention_rejects_bad_shapes_and_devices():
    q = torch.zeros((1, 3, 16, 64))
    with pytest.raises(ValueError, match="multiple of KV"):
        flash_attention(q, torch.zeros((1, 2, 16, 64)),
                        torch.zeros((1, 2, 16, 64)))
    with pytest.raises(ValueError):
        flash_attention(q[0], q[0], q[0])
    m = torch.zeros((1, 2, 16, 64), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(m, m, m)


def test_flash_attention_on_cpu_launches_nothing():
    reset_launch_counts()
    q, k, v = _to_torch(_qkv(10, 1, 2, 1, 64, 64), "float32")
    torch.testing.assert_close(flash_attention(q, k, v),
                               flash_attention_ref(q, k, v))
    assert launch_counts()["flash_attention"] == 0


def _views():
    """(name, tensor, read in place?) for the TMA rules of ``_kernel_view``:
    a unit head_dim stride, the base on 16 bytes, and every other stride of
    an extent above 1 a positive multiple of 16 bytes."""
    bf = torch.zeros((2, 8, 4, 64), dtype=torch.bfloat16)   # (B, S, H, D)
    wide = torch.zeros((1, 4, 16, 72), dtype=torch.bfloat16)
    odd = torch.zeros((1, 4, 16, 68), dtype=torch.bfloat16)
    f32 = torch.zeros((1, 4, 16, 68), dtype=torch.float32)
    flat = torch.zeros(4 * 16 * 64 + 8, dtype=torch.bfloat16)
    return [
        ("contiguous", bf.transpose(1, 2).contiguous(), True),
        ("(B, S, H, D) transposed", bf.transpose(1, 2), True),
        ("rows of 144 bytes", wide[..., :64], True),
        ("float32 rows of 272 bytes", f32[..., :64], True),
        ("extent-1 batch, odd stride",
         flat[:4 * 16 * 64].as_strided((1, 4, 16, 64), (3, 1024, 64, 1)),
         True),
        ("rows of 136 bytes", odd[..., :64], False),
        ("base off 16 bytes", flat[1:1 + 4 * 16 * 64].view(1, 4, 16, 64),
         False),
        ("base on 16 bytes", flat[8:].view(1, 4, 16, 64), True),
        ("kv heads broadcast (stride 0)",
         bf[:, :, :1].expand(2, 8, 4, 64).transpose(1, 2), False),
        ("head_dim strided", bf.transpose(1, 2).transpose(2, 3), False),
    ]


@pytest.mark.parametrize("name,t,in_place", _views(),
                         ids=[v[0] for v in _views()])
def test_kernel_view_follows_tma_rules(name, t, in_place):
    """Which views the wrapper hands the kernel as they are, and which it
    copies (contiguous, same values)."""
    from repro_torch.kernels.flash_attention import _kernel_view
    got = _kernel_view(t)
    assert (got is t) == in_place, name
    assert torch.equal(got, t)
    if not in_place:
        assert got.is_contiguous() and got.data_ptr() % 16 == 0


# ------------------------------------------------------------------ the card
CUDA_CASES = [
    # (B, H, KV, S, D, dtype, causal, window)
    (1, 32, 8, 1024, 64, "bfloat16", True, 0),
    (1, 28, 4, 1024, 128, "bfloat16", True, 0),
    (2, 4, 2, 1000, 64, "bfloat16", True, 0),
    (1, 8, 2, 2048, 64, "bfloat16", True, 512),
    (1, 4, 4, 300, 128, "bfloat16", False, 0),
    (2, 4, 2, 1000, 64, "float32", True, 0),
    (1, 2, 2, 512, 64, "float32", False, 0),
    (1, 4, 1, 700, 128, "float32", True, 100),
    (1, 2, 2, 1, 64, "float32", True, 0),
    # the bf16 body's edges: shorter than one 128-row tile, a window that is
    # no multiple of the key tile, head_dim 192 (64-key tiles, three
    # 64-column boxes a row) in both bodies
    (1, 4, 2, 1, 64, "bfloat16", True, 0),
    (1, 4, 2, 65, 128, "bfloat16", True, 0),
    (1, 8, 2, 1500, 64, "bfloat16", True, 300),
    (1, 4, 2, 512, 192, "bfloat16", True, 0),
    (1, 4, 2, 300, 192, "bfloat16", False, 0),
    (1, 4, 2, 512, 192, "float32", True, 0),
]


@pytest.mark.cuda
def test_flash_attention_kernel_matches_plain_on_cuda():
    """The CUDA kernel against its plain version on the card: causal and
    full, GQA, windows, ragged S, head_dim 64, 128 and 192, both dtypes,
    flat and peaked softmax, inputs read through the strides of a
    (B, S, H, D) transpose; each element and each row within tolerance, the
    output in q's layout, the same bits from launch to launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    reset_launch_counts()
    n = 0
    for B, H, KV, S, D, dtype, causal, window in CUDA_CASES:
        for layout in ("bhsd", "bshd"):
            for scales in (FLAT, PEAKED):
                arrays = _qkv(11, B, H, KV, S, D, layout=layout,
                              scales=scales)
                q, k, v = (t.to(dev) for t in _to_torch(arrays, dtype))
                if layout == "bshd":
                    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
                got = flash_attention(q, k, v, causal=causal, window=window)
                again = flash_attention(q, k, v, causal=causal,
                                        window=window)
                n += 2
                want = flash_attention_ref(q, k, v, causal=causal,
                                           window=window)
                torch.cuda.synchronize()
                assert got.dtype == q.dtype and got.shape == q.shape
                assert got.stride() == q.stride()
                assert torch.equal(got, again)
                tol = TOL[dtype]
                torch.testing.assert_close(got.float(), want.float(),
                                           rtol=tol, atol=tol)
                g, w = got.double(), want.double()
                rel = (g - w).norm(dim=-1) / w.norm(dim=-1)
                assert float(rel.max()) <= ROW_REL_TOL[dtype]
    assert launch_counts()["flash_attention"] == n
