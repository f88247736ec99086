"""The gradient of the port's flash attention against the JAX package's.

The reference trains through ``chunked_attention``, a jnp online-softmax
recurrence that JAX differentiates (``repro/models/layers.py:131``); the
port's gradient is ``flash_attention_bwd``: its plain version
(``kernels/ref.py::flash_attention_bwd_ref``) on the CPU, the three kernels
of ``csrc/flash_attention_bwd.cu`` on the card (``flash_bwd_delta_kernel``,
then ``flash_bwd_dkdv_wgmma_kernel`` and ``flash_bwd_dq_wgmma_kernel`` in
bf16: persistent, a producer warp feeding a TMA ring to consumer
warpgroups that run ``wgmma``; FMA kernels in float32). The same seeded
numpy inputs and output gradient, ``(B, S, H, D)`` as the model hands them
over, go through ``jax.vjp`` of the reference's ``chunked_attention`` (chunk 64) and
through the port's plain backward from its forward's output and
log-sum-exp. Tolerance: 2e-5 in float32, as
``tests/test_torch_flash_attention.py`` uses.

``test_flash_backward_kernel_matches_plain_on_cuda`` holds the CUDA kernels
against the plain version on the card (each row of dq, dk and dv within
1e-2 relative in bf16 and 1e-4 in f32, a row's norm floored at 1e-2 of the
gradient's largest row), the training shape (1, 8192, 32 / 8, 64) among its
cases, and skips where there is none. On the card:
``PYTHONPATH=src python -m pytest -q tests/test_torch_flash_backward.py -m
cuda``.
"""
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

try:  # the card's machine has no JAX: only the ``cuda`` test runs there
    import jax
    import jax.numpy as jnp

    from repro.models import layers as jlayers
except ImportError:
    jax = None

from repro_torch.kernels import (flash_attention, flash_attention_bwd,
                                 launch_counts, reset_launch_counts)
from repro_torch.kernels.flash_attention import _forward
from repro_torch.kernels.ref import flash_attention_bwd_ref, flash_attention_ref
from repro_torch.models import layers as tlayers

TOL = 2e-5
CHUNK = 64
MASKS = {"causal": (True, 0), "full": (False, 0), "window48": (True, 48)}
ROW_REL_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}
LSE_TOL = {torch.bfloat16: 1e-3, torch.float32: 1e-4}
ROW_FLOOR = 1e-2


def _inputs(seed, B, S, H, KV, D):
    """q, k, v and the output's gradient, ``(B, S, heads, D)`` float32."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, S, n, D)).astype(np.float32)
            for n in (H, KV, KV, H)]


def _bhsd(a) -> torch.Tensor:
    return torch.from_numpy(a).transpose(1, 2)


def _port_grads(q, k, v, g, causal, window):
    """The port's forward (output, lse) and plain backward on the
    ``(B, H, S, D)`` views of ``(B, S, H, D)`` arrays; gradients returned
    as ``(B, S, H, D)`` numpy arrays."""
    tq, tk, tv, tg = (_bhsd(a) for a in (q, k, v, g))
    out, lse = flash_attention_ref(tq, tk, tv, causal=causal, window=window,
                                   return_lse=True)
    grads = flash_attention_bwd_ref(tq, tk, tv, out, lse, tg, causal=causal,
                                    window=window)
    return out.transpose(1, 2).numpy(), [t.transpose(1, 2).numpy()
                                         for t in grads]


@pytest.mark.parametrize("mask", sorted(MASKS))
@pytest.mark.parametrize("H,KV", [(4, 2), (4, 4)])
@pytest.mark.parametrize("S,D", [(128, 16), (256, 64)])
def test_backward_matches_jax_grad_of_chunked_attention(S, D, H, KV, mask):
    causal, window = MASKS[mask]
    q, k, v, g = _inputs(S + D + H + KV, 2, S, H, KV, D)

    def ref(q, k, v):
        return jlayers.chunked_attention(q, k, v, causal=causal, chunk=CHUNK,
                                         sliding_window=window)
    want_out, vjp = jax.vjp(ref, jnp.asarray(q), jnp.asarray(k),
                            jnp.asarray(v))
    want = vjp(jnp.asarray(g))
    out, got = _port_grads(q, k, v, g, causal, window)
    np.testing.assert_allclose(out, np.asarray(want_out), rtol=TOL, atol=TOL)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, np.asarray(b), rtol=TOL, atol=TOL,
                                   err_msg=name)


@pytest.mark.parametrize("mask", sorted(MASKS))
@pytest.mark.parametrize("H,KV,S,D", [(4, 2, 100, 16), (6, 3, 64, 32)])
def test_backward_matches_autograd_of_plain_forward(H, KV, S, D, mask):
    """The plain backward against PyTorch's autograd through the plain
    forward (materialised logits and softmax), ragged S included."""
    causal, window = MASKS[mask]
    q, k, v, g = (_bhsd(a) for a in _inputs(7, 2, S, H, KV, D))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = flash_attention_ref(*leaves, causal=causal, window=window)
    want = torch.autograd.grad(out, leaves, g)
    out2, lse = flash_attention_ref(q, k, v, causal=causal, window=window,
                                    return_lse=True)
    assert torch.equal(out2, out.detach())
    assert lse.shape == (2, H, S) and lse.dtype == torch.float32
    got = flash_attention_bwd_ref(q, k, v, out2, lse, g, causal=causal,
                                  window=window)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        torch.testing.assert_close(a, b, rtol=TOL, atol=TOL, msg=name)


def test_autograd_function_on_cpu_is_the_plain_backward():
    """On CPU tensors ``flash_attention`` records the autograd Function,
    whose gradient is the plain backward's, bit for bit; the same under
    ``torch.utils.checkpoint``, which reruns the forward. No kernel launch
    is counted."""
    q, k, v, g = _inputs(3, 1, 96, 4, 2, 16)
    qs, ks, vs = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    reset_launch_counts()
    out = tlayers.chunked_attention(qs, ks, vs, causal=True, chunk=32)
    (fn, _), = out.grad_fn.next_functions      # out is a transposed view
    assert type(fn).__name__ == "FlashAttentionFunctionBackward"
    got = torch.autograd.grad(out, (qs, ks, vs), torch.from_numpy(g))
    _, want = _port_grads(q, k, v, g, True, 0)
    for a, b in zip(got, want):
        assert np.array_equal(a.numpy(), b)
    out_ck = checkpoint(tlayers.chunked_attention, qs, ks, vs, causal=True,
                        chunk=32, use_reentrant=False)
    again = torch.autograd.grad(out_ck, (qs, ks, vs), torch.from_numpy(g))
    for a, b in zip(again, got):
        assert torch.equal(a, b)
    assert launch_counts()["flash_attention"] == 0
    assert launch_counts()["flash_attention_bwd"] == 0


def test_backward_rejects_mismatched_shapes():
    q = torch.zeros((1, 4, 8, 16))
    kv = torch.zeros((1, 2, 8, 16))
    with pytest.raises(ValueError, match="do not fit"):
        flash_attention_bwd(q, kv, kv, q, torch.zeros((1, 4, 7)), q)


# (B, H, KV, S, D, dtype, causal, window, layout): the forward's card cases,
# then the training shape as the model hands it over
CUDA_CASES = [
    (1, 8, 2, 1024, 64, torch.bfloat16, True, 0, "bshd"),
    (2, 4, 2, 1000, 64, torch.float32, True, 0, "bhsd"),
    (2, 4, 2, 1000, 64, torch.bfloat16, True, 0, "bhsd"),
    (1, 8, 2, 1, 64, torch.bfloat16, True, 0, "bshd"),
    (1, 4, 2, 65, 128, torch.bfloat16, True, 0, "bhsd"),
    (1, 2, 2, 512, 64, torch.float32, False, 0, "bhsd"),
    (1, 2, 2, 512, 64, torch.bfloat16, False, 0, "bhsd"),
    (1, 4, 2, 768, 128, torch.bfloat16, False, 0, "bhsd"),
    (1, 4, 2, 1024, 64, torch.bfloat16, True, 300, "bshd"),
    (1, 8, 2, 1536, 128, torch.bfloat16, True, 200, "bshd"),
    (1, 4, 2, 512, 192, torch.bfloat16, True, 0, "bhsd"),
    (1, 4, 2, 256, 192, torch.float32, True, 0, "bhsd"),
    (1, 32, 8, 8192, 64, torch.bfloat16, True, 0, "bshd"),
]


def _row_norms(t: torch.Tensor) -> torch.Tensor:
    return t.double().norm(dim=-1)


def _row_rel(got: torch.Tensor, want: torch.Tensor, scale: float) -> float:
    """Largest ``||got - want|| / ||want||`` over the rows of the last axis,
    a row's norm floored at ``ROW_FLOOR * scale`` (``scale``: the largest
    row norm of dq, dk and dv). Rows below the floor are sums that cancel
    (a causal q row 0 attends one key with p = 1, so its dq is exactly 0 in
    the plain version, and at S = 1 every dq and dk is), where both sides
    are rounding noise of terms of the gradient's scale."""
    den = _row_norms(want).clamp_min(max(ROW_FLOOR * scale, 1e-30))
    return float((_row_norms(got - want.to(got.dtype)) / den).max()) \
        if want.numel() else 0.0


@pytest.mark.cuda
def test_flash_backward_kernel_matches_plain_on_cuda():
    """The three backward kernels against the plain backward on the card,
    each row of dq, dk, dv within ``ROW_REL_TOL``; the forward's
    log-sum-exp against the plain one; the same bits twice; three launches
    a call."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for B, H, KV, S, D, dtype, causal, window, layout in CUDA_CASES:
        tensors = []
        for n, scale in ((H, 2.0), (KV, 2.0), (KV, 1.0), (H, 1.0)):
            shape = (B, n, S, D) if layout == "bhsd" else (B, S, n, D)
            t = (torch.randn(shape, generator=gen, device="cuda")
                 * scale).to(dtype)
            tensors.append(t if layout == "bhsd" else t.transpose(1, 2))
        q, k, v, g = tensors
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = flash_attention(*leaves, causal=causal, window=window)
        _, lse = flash_attention_ref(q, k, v, causal=causal, window=window,
                                     return_lse=True)
        _, lse_kernel = _forward(q, k, v, causal, window, with_lse=True)
        torch.testing.assert_close(lse_kernel, lse, rtol=LSE_TOL[dtype],
                                   atol=LSE_TOL[dtype])
        reset_launch_counts()
        got = torch.autograd.grad(out, leaves, g)
        assert launch_counts()["flash_attention_bwd"] == 3
        again = torch.autograd.grad(
            flash_attention(*leaves, causal=causal, window=window), leaves, g)
        want = flash_attention_bwd_ref(q, k, v, out.detach(), lse, g,
                                       causal=causal, window=window)
        torch.cuda.synchronize()
        case = (B, H, KV, S, D, dtype, causal, window, layout)
        scale = max(float(_row_norms(w).max()) for w in want)
        for name, a, b, c in zip(("dq", "dk", "dv"), got, want, again):
            assert a.dtype == dtype and a.shape == b.shape, (case, name)
            assert torch.equal(a, c), (case, name, "not repeatable")
            rel = _row_rel(a.double(), b.double(), scale)
            assert rel <= ROW_REL_TOL[dtype], (case, name, rel)
