"""Mamba-1 selective state-space block (falcon-mamba architecture).

Prefill runs the recurrence

    h_t = exp(dt_t * A) * h_{t-1} + dt_t * B_t * x_t,     y_t = <C_t, h_t> + D*x_t

through the ``selective_scan`` kernel wrapper
(``repro_torch.kernels.selective_scan``), which also returns the last state
for decoding.  Decode is one plain-PyTorch state update per token, as in the
reference (``repro/models/ssm.py``), which runs no kernel there.  The conv,
the scan and the gating run in f32; projections in the compute dtype.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.selective_scan import selective_scan
from repro_torch.models.config import SSMCfg
from repro_torch.models.layers import dense_init

F32 = torch.float32


def mamba_params(gen: torch.Generator, d_model: int, ssm: SSMCfg, dtype) -> dict:
    di = ssm.expand * d_model
    dtr = ssm.resolve_dt_rank(d_model)
    dev = gen.device
    # S4D-real A; dt bias so that softplus(dt) spans (1e-3, 1e-1)
    A = torch.arange(1, ssm.d_state + 1, dtype=F32, device=dev)[None, :].expand(di, ssm.d_state)
    u = torch.rand(di, generator=gen, device=dev, dtype=F32)
    dt_init = torch.exp(u * (math.log(1e-1) - math.log(1e-3)) + math.log(1e-3))
    dt_bias = dt_init + torch.log1p(-torch.exp(-dt_init))  # inverse softplus
    return {
        "in_proj": dense_init(gen, (d_model, 2 * di), dtype),
        "conv_w": dense_init(gen, (ssm.d_conv, di), dtype, scale=0.5),
        "conv_b": torch.zeros(di, dtype=dtype, device=dev),
        "x_proj": dense_init(gen, (di, dtr + 2 * ssm.d_state), dtype),
        "dt_proj": dense_init(gen, (dtr, di), dtype, scale=dtr**-0.5),
        "dt_bias": dt_bias.to(dtype),
        "A_log": torch.log(A).contiguous(),  # kept in f32
        "D": torch.ones(di, dtype=F32, device=dev),
        "out_proj": dense_init(gen, (di, d_model), dtype),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) as the reference computes it (``logaddexp(x, 0)``)."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def _causal_conv(x, w, b):
    """Depthwise causal conv over S from zero left context, as d_conv
    shifted adds in f32, cast back.  x (B, S, di); w (d_conv, di)."""
    B, S, di = x.shape
    dc = w.shape[0]
    xp = torch.cat([torch.zeros(B, dc - 1, di, dtype=x.dtype, device=x.device), x], dim=1)
    out = torch.zeros(B, S, di, dtype=F32, device=x.device)
    for i in range(dc):
        out = out + xp[:, i : i + S].float() * w[i].float()
    return (out + b.float()).to(x.dtype)


def _ssm_inputs(p, x_conv, ssm: SSMCfg, d_model: int):
    """The selective parameters (dt, A, B, C) of the conv output, in f32."""
    dtr = ssm.resolve_dt_rank(d_model)
    ds = ssm.d_state
    xdb = (x_conv @ p["x_proj"].to(x_conv.dtype)).float()
    dt_in, Bm, Cm = torch.split(xdb, [dtr, ds, ds], dim=-1)
    dt = softplus(dt_in @ p["dt_proj"].float() + p["dt_bias"].float())  # (B, S, di)
    A = -torch.exp(p["A_log"].float())  # (di, ds)
    return dt, A, Bm.contiguous(), Cm.contiguous()


def mamba_apply(p, x, ssm: SSMCfg, d_model: int, compute_dtype):
    """The mamba mixer on (B, S, d).  Returns ``(out, state)``: the decode
    state after the sequence (``conv``: the last d_conv - 1 rows of the
    conv's input, f32; ``ssm``: the scan's last state)."""
    di = ssm.expand * d_model
    xz = x @ p["in_proj"].to(compute_dtype)
    x_in, z = xz[..., :di], xz[..., di:]
    x_conv = F.silu(_causal_conv(x_in, p["conv_w"], p["conv_b"]))
    dt, A, Bm, Cm = _ssm_inputs(p, x_conv, ssm, d_model)
    y, h_last = selective_scan(dt, A, Bm, Cm, x_conv)
    y = y + p["D"].float() * x_conv.float()
    y = y * F.silu(z.float())
    out = y.to(compute_dtype) @ p["out_proj"].to(compute_dtype)
    # zeros stand before the prompt, so a prompt shorter than d_conv - 1 keeps them
    B, S, _ = x_in.shape
    left = torch.zeros(B, max(ssm.d_conv - 1 - S, 0), di, dtype=F32, device=x.device)
    conv_state = torch.cat([left, x_in[:, -(ssm.d_conv - 1):].float()], dim=1)
    return out, {"conv": conv_state, "ssm": h_last}


# ---------------------------------------------------------------------------
# decode (stateful single step)
# ---------------------------------------------------------------------------


def mamba_init_state(B: int, d_model: int, ssm: SSMCfg, device=None) -> dict:
    di = ssm.expand * d_model
    return {
        "conv": torch.zeros(B, ssm.d_conv - 1, di, dtype=F32, device=device),
        "ssm": torch.zeros(B, di, ssm.d_state, dtype=F32, device=device),
    }


def mamba_decode_step(p, x, state, ssm: SSMCfg, d_model: int, compute_dtype):
    """x (B, 1, d).  Returns ``(out (B, 1, d), new_state)``."""
    di = ssm.expand * d_model
    xz = x @ p["in_proj"].to(compute_dtype)
    x_in, z = xz[..., :di], xz[..., di:]  # (B, 1, di)
    conv_buf = torch.cat([state["conv"], x_in.float()], dim=1)  # (B, d_conv, di)
    xc = torch.einsum("bcd,cd->bd", conv_buf, p["conv_w"].float()) + p["conv_b"].float()
    x_conv = F.silu(xc)[:, None, :].to(compute_dtype)
    dt, A, Bm, Cm = _ssm_inputs(p, x_conv, ssm, d_model)
    dt_t, b_t, c_t = dt[:, 0], Bm[:, 0], Cm[:, 0]
    xc_t = x_conv[:, 0].float()
    abar = torch.exp(dt_t[..., None] * A[None])
    h = abar * state["ssm"] + (dt_t * xc_t)[..., None] * b_t[:, None, :]
    y = torch.einsum("bds,bs->bd", h, c_t)
    y = y + p["D"].float() * xc_t
    y = y * F.silu(z[:, 0].float())
    out = (y.to(compute_dtype) @ p["out_proj"].to(compute_dtype))[:, None, :]
    return out, {"conv": conv_buf[:, 1:], "ssm": h}
