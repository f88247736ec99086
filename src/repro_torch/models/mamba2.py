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

import functools
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..parallel import P, get_parallel_context
from ..parallel.layouts import (columns_over_idle_data, on_split_heads,
                                over_model)
from ..parallel.regions import shard_map, sum_over
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


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int, init_state=None, scores=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD forward.

    x:  (b, s, h, p)   head inputs
    dt: (b, s, h)      positive step sizes
    A:  (h,)           negative per-head decay rates
    Bm: (b, s, n)      input projection (group-shared)
    Cm: (b, s, n)      output projection (group-shared)
    scores: where given, ``scores(Cc, Bc)`` makes each chunk's (b, c, l,
    s) products C B^T from the chunked (b, c, q, n) C and B (the dry run's
    layout sums them over ranks that each hold a share of n)
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
    if scores is None:
        Y_diag = torch.einsum("bcln,bcsn,bhcls,bcshp->bclhp", Cc, Bc, L, xc)
    else:
        Y_diag = torch.einsum("bcls,bhcls,bcshp->bclhp", scores(Cc, Bc), L,
                              xc)

    # 2) chunk end-states
    A_cum = torch.cumsum(dAc, dim=-1)                           # (b,h,c,q)
    decay_states = torch.exp(A_cum[..., -1:] - A_cum)           # (b,h,c,q)
    states = torch.einsum("bcln,bhcl,bclhp->bchpn", Bc, decay_states, xc)

    # 3) inter-chunk recurrence, a chunk at a time
    chunk_decay = torch.exp(A_cum[..., -1])                     # (b,h,c)
    # made from x, so that a DTensor's zeros keep its batch's layout
    st = x.new_zeros((b, h, p, n), dtype=f32) if init_state is None \
        else init_state.to(f32)
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


def _causal_conv(t: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """The causal depthwise conv of ``t`` (B, S, ch) by ``w`` (K, ch), as
    the sum of K shifted products, plus ``b``, through SiLU."""
    S, K = t.shape[1], w.shape[0]
    pad = F.pad(t, (0, 0, K - 1, 0))
    conv = sum(pad[:, i:i + S, :] * w[i][None, None, :] for i in range(K))
    return F.silu(conv + b)


def _ssd(xs, dt, A, Bm, Cm, chunk: int, scores=None) -> torch.Tensor:
    """``ssd_chunked``'s y over any sequence length: S padded to a multiple
    of the chunk and cut back."""
    S = xs.shape[1]
    pad = (-S) % chunk
    if not pad:
        return ssd_chunked(xs, dt, A, Bm, Cm, chunk, scores=scores)[0]
    # dt = 0 padding is state-neutral: decay exp(0 A) = 1, input weight 0
    y, _ = ssd_chunked(F.pad(xs, (0, 0, 0, 0, 0, pad)),
                       F.pad(dt, (0, 0, 0, pad)), A,
                       F.pad(Bm, (0, 0, 0, pad)),
                       F.pad(Cm, (0, 0, 0, pad)), chunk, scores=scores)
    return y[:, :S]


def mamba2_forward(p: Mamba2, x: torch.Tensor, cfg: ModelConfig
                   ) -> torch.Tensor:
    """Full-sequence forward (training / prefill). x: (B, S, d)."""
    if isinstance(x, DTensor) and get_parallel_context() is not None:
        return _mamba2_by_heads(p, x, cfg)
    B, S, _ = x.shape
    di, n, h = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads
    proj = x @ p.w_in                                           # (B, S, ...)
    z, xBC, dt = torch.split(proj, [di, di + 2 * n, h], dim=-1)
    # causal depthwise conv over (x, B, C)
    xBC = _causal_conv(xBC, p.conv_w, p.conv_b)
    xs, Bm, Cm = torch.split(xBC, [di, n, n], dim=-1)
    xs = xs.reshape(B, S, h, cfg.ssm_head_dim)
    dt = F.softplus(dt.to(torch.float32) + p.dt_bias)           # (B, S, h)
    A = -torch.exp(p.A_log)                                     # (h,)
    y = _ssd(xs, dt, A, Bm, Cm, cfg.ssm_chunk)
    y = y + xs.to(torch.float32) * p.D[None, None, :, None]
    g = _gated_norm(y.reshape(B, S, di), z, p, cfg.norm_eps)
    return g.to(x.dtype) @ p.w_out


def _mamba2_by_heads(p: Mamba2, x: torch.Tensor, cfg: ModelConfig
                     ) -> torch.Tensor:
    """:func:`mamba2_forward` on DTensors (the dry run), laid out as GSPMD
    lays out the reference's layer: the input projection's output columns
    split over the model axis (unevenly where it does not divide them, as
    GSPMD pads: ``w_in`` is replicated where the rules cannot split it),
    then z, x and dt split by heads over the model axis (24 heads over 16
    ranks: 2 on the first 12, as DTensor's and GSPMD's padded shares), B
    and C whole; the conv, the SSD and the gated norm run on each rank's
    heads inside the :func:`shard_map` boundary (:func:`_heads_local`), and
    the output projection contracts the gathered heads against
    ``w_out``'s split."""
    ctx = get_parallel_context()
    mesh, model = x.device_mesh, ctx.model_axis
    B, S, _ = x.shape
    di, n, h, hp = (cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads,
                    cfg.ssm_head_dim)
    K = p.conv_w.shape[0]

    def over_model(t: torch.Tensor, placement) -> torch.Tensor:
        m = mesh.mesh_dim_names.index(model)
        return t.redistribute(mesh, [placement if i == m else q
                                     for i, q in enumerate(t.placements)])

    proj = x @ over_model(p.w_in, Shard(1))
    z, xs, bc, dt = torch.split(over_model(proj, Replicate()),
                                [di, di, 2 * n, h], dim=-1)
    conv_w = over_model(p.conv_w, Replicate())
    conv_b = over_model(p.conv_b, Replicate())
    dp = ctx.data_spec if B % ctx.dp_size == 0 else None
    heads, whole = P(dp, None, model, None), P(dp, None, None)
    body = functools.partial(_heads_local, cfg=cfg, group=ctx.model_group)
    g, = shard_map(body, (
        heads, heads, whole, P(dp, None, model), P(None, model, None), P(),
        P(model, None), P(), P(model), P(model), P(model), P(model, None)),
        (heads,), out_shapes=[(B, S, h, hp)])(
        z.reshape(B, S, h, hp), xs.reshape(B, S, h, hp), bc, dt,
        conv_w[:, :di].reshape(K, h, hp), conv_w[:, di:],
        conv_b[:di].reshape(h, hp), conv_b[di:], p.A_log, p.D, p.dt_bias,
        p.norm_scale.reshape(h, hp))
    return g.reshape(B, S, di) @ p.w_out


def _heads_local(z, xs, bc, dt, conv_x, conv_bc, b_x, b_bc, A_log, D,
                 dt_bias, norm_scale, *, cfg: ModelConfig, group
                 ) -> Tuple[torch.Tensor]:
    """One rank's heads of the Mamba-2 layer between its projections, on
    local tensors: z, xs (B, S, h', P), dt (B, S, h') and their
    parameters for this rank's h' heads; bc (B, S, 2 N) and its conv's
    parameters whole. The products C B^T run on this rank's share of N,
    summed over the model group, as GSPMD splits them. Returns the gated
    norm's output (B, S, h', P) in z's dtype."""
    B, S, hl, hp = xs.shape
    n = cfg.ssm_state
    K = conv_x.shape[0]
    xs = _causal_conv(xs.reshape(B, S, hl * hp), conv_x.reshape(K, hl * hp),
                      b_x.reshape(hl * hp)).reshape(B, S, hl, hp)
    Bm, Cm = torch.split(_causal_conv(bc, conv_bc, b_bc), [n, n], dim=-1)
    dt = F.softplus(dt.to(torch.float32) + dt_bias)
    tp, rank = dist.get_world_size(group), dist.get_rank(group)

    def scores(Cc, Bc):     # C B^T over this rank's share of n, summed
        if n % tp:
            return torch.einsum("bcln,bcsn->bcls", Cc, Bc)
        k = n // tp
        return sum_over(torch.einsum("bcln,bcsn->bcls",
                                     Cc[..., rank * k:(rank + 1) * k],
                                     Bc[..., rank * k:(rank + 1) * k]), group)

    y = _ssd(xs, dt, -torch.exp(A_log), Bm, Cm, cfg.ssm_chunk, scores)
    y = y + xs.to(torch.float32) * D[None, None, :, None]
    g = y * F.silu(z.to(torch.float32))
    var = sum_over(g.square().sum(dim=(-2, -1), keepdim=True),
                   group) / cfg.ssm_d_inner
    g = g * torch.rsqrt(var + cfg.norm_eps) * norm_scale
    return (g.to(z.dtype),)


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


def _c_product(st: torch.Tensor, Cm: torch.Tensor) -> torch.Tensor:
    """y = C . state: (B, h, p, n) by (B, n) -> (B, h, p)."""
    return torch.einsum("bhpn,bn->bhp", st, Cm)


def mamba2_decode_step(p: Mamba2, x1: torch.Tensor,
                       cache: Dict[str, torch.Tensor], cfg: ModelConfig
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token recurrent step. x1: (B, 1, d). The new state and conv
    window are written into ``cache``'s tensors, which are returned."""
    B = x1.shape[0]
    di, n, h = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads
    proj = columns_over_idle_data(x1[:, 0, :], p.w_in)         # (B, ...)
    z, xBC, dt = torch.split(proj, [di, di + 2 * n, h], dim=-1)
    # conv window: the previous K - 1 inputs and this one
    hist = cache["conv"]                                        # (B, K-1, ch)
    window = torch.cat([hist, xBC[:, None, :].to(hist.dtype)], dim=1)
    conv = torch.einsum("bkc,kc->bc", window, p.conv_w.to(hist.dtype)) \
        + p.conv_b
    xs, Bm, Cm = torch.split(over_model(F.silu(conv), Replicate()),
                             [di, n, n], dim=-1)
    xs = xs.reshape(B, h, cfg.ssm_head_dim).to(torch.float32)
    dt = F.softplus(dt.to(torch.float32) + p.dt_bias)           # (B, h)
    A = -torch.exp(p.A_log)
    dec = torch.exp(dt * A[None, :])                            # (B, h)
    xdt = xs * dt[..., None]                                    # (B, h, p)
    st = over_model(cache["state"], Shard(1)) \
        * over_model(dec, Shard(1))[..., None, None] \
        + torch.einsum("bhp,bn->bhpn", over_model(xdt, Shard(1)),
                       Bm.to(torch.float32))
    Cm = Cm.to(torch.float32)
    y = on_split_heads(_c_product, st, Cm)
    y = (_c_product(st, Cm) if y is None else y) + xs * p.D[None, :, None]
    g = _gated_norm(y.reshape(B, di), z, p, cfg.norm_eps)
    out = g.to(x1.dtype) @ p.w_out
    cache["state"].copy_(st)
    cache["conv"].copy_(window[:, 1:, :])
    return out[:, None, :], cache
