"""Mixture-of-Experts with sort-based token dispatch (dropping, capacity C) —
the twin of :mod:`repro.models.moe`, local dispatch only.

FLOP-exact formulation: tokens are sorted by routed expert, packed into an
(E, C, D) capacity buffer, processed by per-expert SwiGLU FFNs (batched
matrix products over the expert axis), and combined back with router
gates, so only *active* experts compute.

Where results could part from the reference, the port does what the
reference does, on any device:

* **top-k ties** — ``jax.lax.top_k`` keeps the lower expert index first
  among equal probabilities (common among bf16 logits); ``torch.topk``
  promises no order, so :func:`route` takes the first k of a *stable*
  descending sort instead.
* **capacity** — ``cap = int(t * k / num_experts * capacity_factor) + 1``
  in Python floats, sized for the real expert count; the dispatch sorts
  by expert with a stable argsort, so the same (token, choice) pairs land
  past the capacity and are dropped.
* **combine** — the reference scatter-adds each token's k weighted rows
  in float32 in the sorted order (ascending expert id). ``index_add_`` on
  CUDA adds with atomics in no fixed order, so the port scatters the
  sorted rows back to (T, k, D) by the inverse permutation (one write per
  index) and adds a token's k rows in ascending expert order: deterministic
  on every device.

The expert-parallel path of the reference (a ``shard_map`` over the model
axis, ``moe.py:121-221`` there) needs a mesh; it is not ported yet
(ROADMAP.md, Queue 1, item 6). :func:`apply_moe` always runs the local
dispatch, which is what the reference runs without a model axis.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers
from repro_torch.models.schema import ParamDef, Schema


def moe_schema(cfg: ArchConfig) -> Schema:
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.padded_experts
    if cfg.moe_shard == "experts":
        ax: tuple = ("model", None, None)
    else:  # "ff": shard the per-expert hidden dim
        ax = (None, None, "model")
    out: Schema = {
        "norm": layers.rmsnorm_schema(d),
        "router": ParamDef((d, e), (None, None)),
        "wi_gate": ParamDef((e, d, f), ax),
        "wi_up": ParamDef((e, d, f), ax),
        "wo": ParamDef((e, f, d), (ax[0], ax[2], None)),
    }
    if cfg.num_shared_experts:
        fs = cfg.shared_d_ff * cfg.num_shared_experts
        out["shared_wi_gate"] = ParamDef((d, fs), (None, "model"))
        out["shared_wi_up"] = ParamDef((d, fs), (None, "model"))
        out["shared_wo"] = ParamDef((fs, d), ("model", None))
    return out


def route(
    logits: torch.Tensor, top_k: int, n_real: int | None = None
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k routing. Returns (gates (T,k) float32, expert_idx (T,k) int64,
    aux_loss).

    ``n_real``: number of real experts when the expert dim is padded —
    dummy columns are masked so they are never routed to. Among equal
    probabilities the lower expert index comes first, as in
    ``jax.lax.top_k``."""
    e = logits.shape[-1]
    if n_real is not None and n_real < e:
        mask = torch.arange(e, device=logits.device) < n_real
        logits = logits.masked_fill(~mask, -1e9)
    probs = torch.softmax(logits.float(), dim=-1)
    top, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = top[..., :top_k], order[..., :top_k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    # Switch-style load-balance loss: E * sum_e f_e * p_e.
    pe = probs.mean(dim=0)  # (E,)
    fe = torch.bincount(idx.reshape(-1), minlength=e).float() / idx.numel()
    aux = e * torch.sum(fe * pe)
    return gates, idx, aux


def dispatch(
    idx: torch.Tensor, cfg: ArchConfig, e_offset: int = 0, e_local: int | None = None
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, int]:
    """The sort-based dispatch plan of routed choices ``idx`` (T, k).

    Returns ``(order, local_e, slot, keep, cap)``: ``order`` sorts the
    T*k flattened choices by expert (stable, so a token's earlier position
    wins a contended slot); ``local_e`` and ``slot`` place each sorted
    choice in the (e_local, cap, D) buffer; ``keep`` is False where the
    choice is past its expert's capacity (dropped) or outside
    [e_offset, e_offset + e_local)."""
    t, k = idx.shape
    e = cfg.padded_experts
    e_local = e if e_local is None else e_local
    # Capacity is sized for the REAL expert count: tokens only ever route to
    # real experts, so padded columns get none.
    cap = int(t * k / cfg.num_experts * cfg.capacity_factor) + 1
    flat_e = idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    counts = torch.bincount(flat_e, minlength=e)
    starts = torch.cumsum(counts, 0) - counts
    slot = torch.arange(t * k, device=idx.device) - starts[sorted_e]
    local_e = sorted_e - e_offset
    keep = (slot < cap) & (local_e >= 0) & (local_e < e_local)
    return order, local_e, slot, keep, cap


def _moe_core(
    params: dict,
    xf: torch.Tensor,
    cfg: ArchConfig,
    e_offset: int,
    e_local: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Route + sort-dispatch + per-expert SwiGLU for experts
    [e_offset, e_offset + e_local). Returns the *partial* combined output
    (T, D) float32 (contributions of those experts only) and the aux loss.

    With (e_offset=0, e_local=E) this is the full local computation.
    """
    t, d = xf.shape
    k = cfg.top_k
    gates, idx, aux = route(
        layers.matmul(xf, params["router"]), k, n_real=cfg.num_experts
    )
    order, local_e, slot, keep, cap = dispatch(idx, cfg, e_offset, e_local)
    token_of = order // k

    # ---- the (e_local, cap + 1, D) capacity buffer ---------------------
    # Dropped choices write zeros into a spare row at slot ``cap`` (every
    # write there is zeros, so the result is the same whatever their
    # order); kept choices have one (expert, slot) each.
    slot_c = torch.where(keep, slot, cap)
    local_c = torch.where(keep, local_e, 0)
    buf = xf.new_zeros((e_local, cap + 1, d))
    buf[local_c, slot_c] = torch.where(keep[:, None], xf[token_of], 0.0).to(xf.dtype)

    # ---- per-expert SwiGLU ---------------------------------------------
    def bmm(a, w):
        return torch.bmm(*layers.promote(a, w))

    wi_gate = params["wi_gate"][e_offset:e_offset + e_local]
    wi_up = params["wi_up"][e_offset:e_offset + e_local]
    wo = params["wo"][e_offset:e_offset + e_local]
    act = F.silu(bmm(buf, wi_gate)) * bmm(buf, wi_up)
    out_buf = bmm(act, wo)

    # ---- combine ---------------------------------------------------------
    # The spare row's output is exactly zero (silu(0) * 0 @ wo).
    weight = torch.where(keep, gates.reshape(-1)[order], 0.0)
    y_sorted = out_buf[local_c, slot_c].float() * weight[:, None]
    # Back to (T, k, D) by the inverse permutation, one write per row, then
    # a token's k rows added in ascending expert order (the reference's
    # scatter order).
    y_tk = torch.empty_like(y_sorted)
    y_tk[order] = y_sorted
    y_tk = y_tk.reshape(t, k, d)
    by_expert = torch.argsort(idx, dim=-1)
    y = torch.zeros((t, d), dtype=torch.float32, device=xf.device)
    for j in range(k):
        y = y + torch.gather(y_tk, 1, by_expert[:, j, None, None].expand(t, 1, d))[:, 0]
    return y, aux


def apply_moe(
    params: dict, x: torch.Tensor, cfg: ArchConfig
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (output (B,S,D) in x's type, aux_loss scalar), by the local
    dispatch (no expert parallelism: see the module docstring)."""
    b, s, d = x.shape
    hn = layers.rmsnorm(x, params["norm"], cfg.norm_eps)
    xf = hn.reshape(b * s, d)
    y, aux = _moe_core(params, xf, cfg, 0, cfg.padded_experts)
    y = y.to(x.dtype)
    if cfg.num_shared_experts:
        shg = F.silu(layers.matmul(xf, params["shared_wi_gate"])) * layers.matmul(
            xf, params["shared_wi_up"]
        )
        y = y + layers.matmul(shg, params["shared_wo"]).to(x.dtype)
    return y.reshape(b, s, d), aux
