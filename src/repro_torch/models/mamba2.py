"""Mamba-2 layer through the SSD (state-space duality) chunked algorithm
(port of ``repro/models/mamba2.py``; arXiv:2405.21060, Listing 1), with
(B, S, H, P) heads.

Prefill runs the quadratic-within-chunk, recurrent-across-chunk form; decode
the O(1) per-token state recurrence. The group count is 1 (B and C shared
across heads), Mamba-2's default. As in the reference, ``xd``, ``dA``, the
segment sums and every ``exp`` are float32, and the causal convolution is
the sum of K shifted products (not ``F.conv1d``), so the sums run in the
same order. The reference's ``lax.scan`` over chunks is a loop here, and
:func:`mamba2_decode_step` writes the state and the conv window into the
cache in place (the port's decode convention).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .config import ModelConfig
from .layers import _param, _weights


class Mamba2(nn.Module):
    """``w_in`` (d, 2 di + 2 n + h: z, x, B, C, dt), ``conv_w`` (K, di +
    2 n), ``conv_b``, ``w_out`` (di, d) in the model dtype; float32
    ``A_log`` = log(linspace(1, 16, h)), ``D`` ones, ``dt_bias`` zeros and
    ``norm_scale`` ones (``init_mamba2``, ``mamba2.py:25-44``)."""

    def __init__(self, cfg: ModelConfig, dtype, device=None,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        d, di = cfg.d_model, cfg.ssm_d_inner
        n, h, K = cfg.ssm_state, cfg.ssm_heads, cfg.ssm_conv
        conv_ch = di + 2 * n              # x, B and C go through the conv
        _weights(self, {"w_in": ((d, 2 * di + 2 * n + h), d ** -0.5),
                        "conv_w": ((K, conv_ch), K ** -0.5),
                        "w_out": ((di, d), di ** -0.5)}, dtype, device, gen)
        self.conv_b = _param(torch.zeros((conv_ch,), dtype=dtype,
                                         device=device))
        f32 = dict(dtype=torch.float32, device=device)
        # log of the float64 linspace, rounded once to float32
        self.A_log = _param(torch.log(torch.linspace(
            1.0, 16.0, h, dtype=torch.float64, device=device)).to(**f32))
        self.D = _param(torch.ones((h,), **f32))
        self.dt_bias = _param(torch.zeros((h,), **f32))
        self.norm_scale = _param(torch.ones((di,), **f32))


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """(..., T) -> (..., T, T): cumulative segment sums, -inf above the
    diagonal (so ``exp`` gives exactly 0 there)."""
    T = x.shape[-1]
    csum = torch.cumsum(x, dim=-1)
    diff = csum[..., :, None] - csum[..., None, :]
    mask = torch.tril(torch.ones((T, T), dtype=torch.bool, device=x.device))
    return diff.masked_fill(~mask, -torch.inf)


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int,
                init_state=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD forward.

    x:  (b, s, h, p)   head inputs
    dt: (b, s, h)      positive step sizes
    A:  (h,)           negative per-head decay rates
    Bm: (b, s, n)      input projection (group-shared)
    Cm: (b, s, n)      output projection (group-shared)
    Returns (y (b, s, h, p), final_state (b, h, p, n)), both float32.
    """
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of the chunk "
                         f"{chunk}")
    c = s // chunk
    f32 = torch.float32
    xd = x.to(f32) * dt.to(f32)[..., None]                      # dt-weighted
    dA = dt.to(f32) * A.to(f32)[None, None, :]                  # (b, s, h)

    # chunked views
    xc = xd.reshape(b, c, chunk, h, p)
    dAc = dA.reshape(b, c, chunk, h).permute(0, 3, 1, 2)        # (b,h,c,q)
    Bc = Bm.to(f32).reshape(b, c, chunk, n)
    Cc = Cm.to(f32).reshape(b, c, chunk, n)

    # 1) intra-chunk (quadratic) term
    L = torch.exp(_segsum(dAc))                                 # (b,h,c,q,q)
    Y_diag = torch.einsum("bcln,bcsn,bhcls,bcshp->bclhp", Cc, Bc, L, xc)

    # 2) chunk end-states
    A_cum = torch.cumsum(dAc, dim=-1)                           # (b,h,c,q)
    decay_states = torch.exp(A_cum[..., -1:] - A_cum)           # (b,h,c,q)
    states = torch.einsum("bcln,bhcl,bclhp->bchpn", Bc, decay_states, xc)

    # 3) inter-chunk recurrence, a chunk at a time
    chunk_decay = torch.exp(A_cum[..., -1])                     # (b,h,c)
    st = torch.zeros((b, h, p, n), dtype=f32, device=x.device) \
        if init_state is None else init_state.to(f32)
    states_in = []
    for i in range(c):
        states_in.append(st)
        st = st * chunk_decay[:, :, i, None, None] + states[:, i]
    states_in = torch.stack(states_in, dim=1)                   # (b,c,h,p,n)

    # 4) state -> output term
    state_decay = torch.exp(A_cum)                              # (b,h,c,q)
    Y_off = torch.einsum("bcln,bchpn,bhcl->bclhp", Cc, states_in, state_decay)

    y = (Y_diag + Y_off).reshape(b, s, h, p)
    return y, st


def _gated_norm(y: torch.Tensor, z: torch.Tensor, p: Mamba2,
                eps: float) -> torch.Tensor:
    """Mamba-2's gated RMSNorm, float32."""
    g = y * F.silu(z.to(torch.float32))
    var = g.square().mean(dim=-1, keepdim=True)
    return g * torch.rsqrt(var + eps) * p.norm_scale


def mamba2_forward(p: Mamba2, x: torch.Tensor, cfg: ModelConfig
                   ) -> torch.Tensor:
    """Full-sequence forward (training / prefill). x: (B, S, d)."""
    B, S, _ = x.shape
    di, n, h = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads
    proj = x @ p.w_in                                           # (B, S, ...)
    z, xBC, dt = torch.split(proj, [di, di + 2 * n, h], dim=-1)
    # causal depthwise conv over (x, B, C)
    w = p.conv_w                                                # (K, ch)
    K = w.shape[0]
    pad = F.pad(xBC, (0, 0, K - 1, 0))
    conv = sum(pad[:, i:i + S, :] * w[i][None, None, :] for i in range(K))
    xBC = F.silu(conv + p.conv_b)
    xs, Bm, Cm = torch.split(xBC, [di, n, n], dim=-1)
    xs = xs.reshape(B, S, h, cfg.ssm_head_dim)
    dt = F.softplus(dt.to(torch.float32) + p.dt_bias)           # (B, S, h)
    A = -torch.exp(p.A_log)                                     # (h,)
    pad = (-S) % cfg.ssm_chunk
    if pad:
        # dt = 0 padding is state-neutral: decay exp(0 A) = 1, input weight 0
        y, _ = ssd_chunked(F.pad(xs, (0, 0, 0, 0, 0, pad)),
                           F.pad(dt, (0, 0, 0, pad)), A,
                           F.pad(Bm, (0, 0, 0, pad)),
                           F.pad(Cm, (0, 0, 0, pad)), cfg.ssm_chunk)
        y = y[:, :S]
    else:
        y, _ = ssd_chunked(xs, dt, A, Bm, Cm, cfg.ssm_chunk)
    y = y + xs.to(torch.float32) * p.D[None, None, :, None]
    g = _gated_norm(y.reshape(B, S, di), z, p, cfg.norm_eps)
    return g.to(x.dtype) @ p.w_out


def mamba2_init_cache(cfg: ModelConfig, batch: int,
                      device=None) -> Dict[str, torch.Tensor]:
    """``{"state": (batch, h, p, n), "conv": (batch, K - 1, di + 2 n)}``,
    float32 zeros."""
    di, n, h = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "state": torch.zeros((batch, h, cfg.ssm_head_dim, n), **f32),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, di + 2 * n), **f32),
    }


def mamba2_decode_step(p: Mamba2, x1: torch.Tensor,
                       cache: Dict[str, torch.Tensor], cfg: ModelConfig
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token recurrent step. x1: (B, 1, d). The new state and conv
    window are written into ``cache``'s tensors, which are returned."""
    B = x1.shape[0]
    di, n, h = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads
    proj = x1[:, 0, :] @ p.w_in                                 # (B, ...)
    z, xBC, dt = torch.split(proj, [di, di + 2 * n, h], dim=-1)
    # conv window: the previous K - 1 inputs and this one
    hist = cache["conv"]                                        # (B, K-1, ch)
    window = torch.cat([hist, xBC[:, None, :].to(hist.dtype)], dim=1)
    conv = torch.einsum("bkc,kc->bc", window, p.conv_w.to(hist.dtype)) \
        + p.conv_b
    xs, Bm, Cm = torch.split(F.silu(conv), [di, n, n], dim=-1)
    xs = xs.reshape(B, h, cfg.ssm_head_dim).to(torch.float32)
    dt = F.softplus(dt.to(torch.float32) + p.dt_bias)           # (B, h)
    A = -torch.exp(p.A_log)
    dec = torch.exp(dt * A[None, :])                            # (B, h)
    xdt = xs * dt[..., None]                                    # (B, h, p)
    st = cache["state"] * dec[..., None, None] + \
        torch.einsum("bhp,bn->bhpn", xdt, Bm.to(torch.float32))
    y = torch.einsum("bhpn,bn->bhp", st, Cm.to(torch.float32))
    y = y + xs * p.D[None, :, None]
    g = _gated_norm(y.reshape(B, di), z, p, cfg.norm_eps)
    out = g.to(x1.dtype) @ p.w_out
    cache["state"].copy_(st)
    cache["conv"].copy_(window[:, 1:, :])
    return out[:, None, :], cache
