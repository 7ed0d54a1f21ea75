"""Mamba2 SSD (state-space duality) layer — the twin of
:mod:`repro.models.ssm`: the chunked dual form.

The selective scan is evaluated in the SSD *dual* form — per-chunk matrix
products plus a short inter-chunk recurrence (a Python loop over chunks
where the reference runs ``lax.scan``). ``apply_mamba(use_kernel=True)``
takes the CUDA kernel of :mod:`repro_torch.kernels.ssd_scan` instead, which
has no gradient (as the reference's kernel has none); training runs this
module's plain path.

Each function does the reference's arithmetic in the reference's types:
where JAX promotes bfloat16 against float32 the port casts explicitly
(:func:`repro_torch.models.layers.matmul` for the products with weights),
and where it rounds a product to the activation type (the scores, the
states entering each chunk) so does the port.

Shapes follow the Mamba2 paper: H heads of dim P, state size N, G groups
for B/C (shared across H//G heads).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers
from repro_torch.models.schema import ParamDef, Schema


def mamba_schema(cfg: ArchConfig) -> Schema:
    d = cfg.d_model
    inner, h = cfg.ssm_inner, cfg.ssm_heads
    g, n, w = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_conv_width
    return {
        "norm": layers.rmsnorm_schema(d),
        "w_z": ParamDef((d, inner), (None, "model")),
        "w_x": ParamDef((d, inner), (None, "model")),
        "w_bc": ParamDef((d, 2 * g * n), (None, None)),
        "w_dt": ParamDef((d, h), (None, "model")),
        "dt_bias": ParamDef((h,), ("model",), init="zeros"),
        "a_log": ParamDef((h,), ("model",), init="zeros"),
        "d_skip": ParamDef((h,), ("model",), init="ones"),
        "conv_x": ParamDef((w, inner), (None, "model"), scale=0.1),
        "conv_bc": ParamDef((w, 2 * g * n), (None, None), scale=0.1),
        "out_norm": ParamDef((inner,), ("model",), init="ones"),
        "w_out": ParamDef((inner, d), ("model", None)),
    }


def causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. x: (B, S, C); w: (W, C)."""
    width = w.shape[0]
    xp = F.pad(x, (0, 0, width - 1, 0))
    s = x.shape[1]
    return sum(xp[:, i : i + s, :] * w[i] for i in range(width))


def ssd_scan(
    x: torch.Tensor,  # (B, S, H, P) — dt-scaled inputs NOT yet applied
    dt: torch.Tensor,  # (B, S, H) — softplus'd step sizes
    a: torch.Tensor,  # (H,) — negative decay rates (-exp(a_log)), float32
    b_mat: torch.Tensor,  # (B, S, G, N)
    c_mat: torch.Tensor,  # (B, S, G, N)
    chunk: int,
    initial_state: torch.Tensor | None = None,  # (B, H, P, N)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD. Returns (y (B,S,H,P), final_state (B,H,P,N))."""
    bsz, s, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    if s % chunk:
        raise ValueError(f"seq {s} not divisible by chunk {chunk}")
    nc = s // chunk
    rep = h // g
    xdt = x.dtype
    f32 = torch.float32

    xc = x.reshape(bsz, nc, chunk, h, p)
    dtc = dt.reshape(bsz, nc, chunk, h)
    bc = b_mat.reshape(bsz, nc, chunk, g, n)
    cc = c_mat.reshape(bsz, nc, chunk, g, n)

    da = dtc.to(f32) * a  # (B, nc, Q, H), negative
    cum = torch.cumsum(da, dim=2)  # within-chunk cumulative log-decay

    # ---- intra-chunk (dual/attention-like form) -------------------------
    # L[q, k] = exp(cum[q] - cum[k]) for q >= k else 0. Masked to -inf
    # before the exp: above the diagonal the exponent is positive and
    # overflows at a full chunk (the sum of 128 steps of dt * |a|), and the
    # reference's where(tri, exp(rel), 0) then has the gradient 0 * inf =
    # NaN. The values are the same.
    rel = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B,nc,Q,K,H)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    l_mat = torch.exp(rel.masked_fill(~tri[None, None, :, :, None], float("-inf")))
    scores = torch.einsum("bcqgn,bckgn->bcqkg", cc, bc)  # (B,nc,Q,K,G), x's type
    scores = torch.repeat_interleave(scores, rep, dim=-1)  # G -> H
    m = scores.to(f32) * l_mat * dtc[:, :, None, :, :].to(f32)  # dt at source step k
    y_intra = torch.einsum("bcqkh,bckhp->bcqhp", m, xc.to(f32))

    # ---- chunk states ----------------------------------------------------
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)  # (B,nc,Q,H)
    xbar = xc.to(f32) * (dtc.to(f32) * decay_to_end)[..., None]  # (B,nc,Q,H,P)
    b_h = torch.repeat_interleave(bc, rep, dim=3)  # (B,nc,Q,H,N)
    states = torch.einsum("bcqhn,bcqhp->bchpn", b_h.to(f32), xbar)

    # ---- inter-chunk recurrence -----------------------------------------
    chunk_decay = torch.exp(cum[:, :, -1, :])  # (B,nc,H)
    if initial_state is None:
        carry = torch.zeros((bsz, h, p, n), dtype=xdt, device=x.device).to(f32)
    else:
        carry = initial_state.to(f32)
    prev = []
    for c in range(nc):
        prev.append(carry)  # the state *entering* chunk c
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)  # (B,nc,H,P,N)

    c_h = torch.repeat_interleave(cc, rep, dim=3)  # (B,nc,Q,H,N)
    decay_from_start = torch.exp(cum)  # (B,nc,Q,H)
    y_inter = (
        torch.einsum("bcqhn,bchpn->bcqhp", c_h, prev_states.to(xdt)).to(f32)
        * decay_from_start[..., None]
    )

    y = (y_intra + y_inter).reshape(bsz, s, h, p)
    return y.to(xdt), carry.to(xdt)


def mamba_forward(
    params: dict,
    x: torch.Tensor,
    cfg: ArchConfig,
    *,
    use_kernel: bool = False,
    out_norm=None,
) -> tuple[torch.Tensor, dict]:
    """Training/prefill Mamba2 block over the heads of ``params``'s columns
    (all, or a rank's: the head count is ``a_log``'s; the B/C groups are
    whole). x: (B, S, D). Returns (out (B, S, D), the block's cache: final
    state and conv histories). ``out_norm(y, weight, eps)`` normalises the
    gated output (None: :func:`repro_torch.models.layers.rmsnorm`; a rank's
    heads need the mean square over every rank's)."""
    bsz, s, _ = x.shape
    h, p = params["a_log"].shape[0], cfg.ssm_head_dim
    g, n, w = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_conv_width

    hn = layers.rmsnorm(x, params["norm"], cfg.norm_eps)
    z = layers.matmul(hn, params["w_z"])
    xin_raw = layers.matmul(hn, params["w_x"])
    bc_raw = layers.matmul(hn, params["w_bc"])
    dt = F.softplus(layers.matmul(hn, params["w_dt"]) + params["dt_bias"])

    xin = F.silu(causal_conv(xin_raw, params["conv_x"]))
    bc = F.silu(causal_conv(bc_raw, params["conv_bc"]))
    b_mat, c_mat = torch.chunk(bc, 2, dim=-1)

    a = -torch.exp(params["a_log"].float())
    xh = xin.reshape(bsz, s, h, p)
    b_mat = b_mat.reshape(bsz, s, g, n)
    c_mat = c_mat.reshape(bsz, s, g, n)

    if use_kernel:
        from repro_torch.kernels import ops as kernel_ops

        y, final_state = kernel_ops.ssd_scan(xh, dt, a, b_mat, c_mat, chunk=cfg.ssm_chunk)
    else:
        y, final_state = ssd_scan(xh, dt, a, b_mat, c_mat, chunk=cfg.ssm_chunk)
    y = y + params["d_skip"][:, None] * xh  # per-head skip
    y = y.reshape(bsz, s, h * p)
    y = (out_norm or layers.rmsnorm)(y * F.silu(z), params["out_norm"], cfg.norm_eps)
    cache = {
        "state": final_state,
        "conv_x": xin_raw[:, -(w - 1):],
        "conv_bc": bc_raw[:, -(w - 1):],
    }
    return layers.matmul(y, params["w_out"]), cache


def apply_mamba(
    params: dict,
    x: torch.Tensor,
    cfg: ArchConfig,
    *,
    use_kernel: bool = False,
) -> torch.Tensor:
    """Training/prefill Mamba2 block. x: (B, S, D)."""
    return mamba_forward(params, x, cfg, use_kernel=use_kernel)[0]


# ----------------------------------------------------------------- decode
def ssm_cache_shape(cfg: ArchConfig, batch: int) -> dict:
    """``(shape, dtype)`` of each SSM cache leaf."""
    h, p = cfg.ssm_heads, cfg.ssm_head_dim
    g, n, w = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_conv_width
    dt = cfg.activation_dtype
    return {
        "state": ((batch, h, p, n), dt),
        "conv_x": ((batch, w - 1, cfg.ssm_inner), dt),
        "conv_bc": ((batch, w - 1, 2 * g * n), dt),
    }


def init_ssm_cache(cfg: ArchConfig, batch: int, device) -> dict:
    """Zeroed SSM cache on ``device``: O(1) in the context length."""
    return {
        name: torch.zeros(shape, dtype=dt, device=device)
        for name, (shape, dt) in ssm_cache_shape(cfg, batch).items()
    }


def decode_mamba(
    params: dict, x: torch.Tensor, cache: dict, cfg: ArchConfig
) -> tuple[torch.Tensor, dict]:
    """One-token Mamba2 step. x: (B, 1, D). Returns (y, new cache); the
    cache passed in is not modified."""
    bsz = x.shape[0]
    h, p = cfg.ssm_heads, cfg.ssm_head_dim
    g, n = cfg.ssm_groups, cfg.ssm_state
    rep = h // g
    f32 = torch.float32

    hn = layers.rmsnorm(x, params["norm"], cfg.norm_eps)
    z = layers.matmul(hn, params["w_z"])  # (B,1,inner)
    xin = layers.matmul(hn, params["w_x"])
    bc = layers.matmul(hn, params["w_bc"])
    dt = F.softplus(layers.matmul(hn, params["w_dt"]) + params["dt_bias"])  # (B,1,H)

    # Rolling conv caches.
    xin_hist = torch.cat([cache["conv_x"], xin], dim=1)  # (B,W,inner)
    bc_hist = torch.cat([cache["conv_bc"], bc], dim=1)
    conv_x = torch.einsum("bwc,wc->bc", *layers.promote(xin_hist, params["conv_x"]))
    conv_bc = torch.einsum("bwc,wc->bc", *layers.promote(bc_hist, params["conv_bc"]))
    xin = F.silu(conv_x)[:, None]
    bc_c = F.silu(conv_bc)[:, None]
    b_mat, c_mat = torch.chunk(bc_c, 2, dim=-1)

    a = -torch.exp(params["a_log"].float())
    xh = xin.reshape(bsz, h, p)
    b_h = torch.repeat_interleave(b_mat.reshape(bsz, g, n), rep, dim=1)  # (B,H,N)
    c_h = torch.repeat_interleave(c_mat.reshape(bsz, g, n), rep, dim=1)
    dt1 = dt[:, 0, :].to(f32)  # (B,H)

    decay = torch.exp(dt1 * a)  # (B,H)
    state = cache["state"].to(f32)
    state = state * decay[:, :, None, None] + torch.einsum(
        "bh,bhp,bhn->bhpn", dt1, xh.to(f32), b_h.to(f32)
    )
    y = torch.einsum("bhn,bhpn->bhp", c_h.to(f32), state)
    y = y + params["d_skip"][:, None].to(f32) * xh.to(f32)
    y = y.reshape(bsz, 1, h * p).to(x.dtype)
    y = layers.rmsnorm(y * F.silu(z), params["out_norm"], cfg.norm_eps)
    new_cache = {
        "state": state.to(cache["state"].dtype),
        "conv_x": xin_hist[:, 1:],
        "conv_bc": bc_hist[:, 1:],
    }
    return layers.matmul(y, params["w_out"]), new_cache
