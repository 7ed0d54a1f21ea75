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

Under an ambient mesh (:func:`repro_torch.sharding.set_mesh`) whose model
axis divides ``padded_experts``, with ``moe_shard == "experts"``,
:func:`apply_moe` takes the reference's expert-parallel path (its
``shard_map`` over the model axis): each model rank dispatches its own data
rank's tokens to its own ``e_local`` experts (capacity sized for the local
tokens, so it drops what the reference's per-shard dispatch drops), the
shared experts are column/row parallel, and the partial outputs meet in one
all-reduce over ``model``; the aux loss is averaged over ``model`` and the
batch axes. Where the batch does not divide the DP size the tokens stay
replicated and only ``model`` is manual. With no mesh, or a model axis of
1, it is the local dispatch. :func:`apply_moe`'s expert-parallel path is
for inference and raises under autograd: it takes whole or DTensor weights
whose gradients it cannot place. The sharded train step trains through
:func:`moe_ep_local` on local shards (:mod:`repro_torch.models.sharded`),
whose collectives carry their gradients.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers
from repro_torch.models.schema import ParamDef, Schema
from repro_torch.sharding import P, ambient_mesh


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
    fe = _counts(idx.reshape(-1), e).float() / idx.numel()
    aux = e * torch.sum(fe * pe)
    return gates, idx, aux


def _counts(ids: torch.Tensor, n: int) -> torch.Tensor:
    """``bincount(ids, minlength=n)`` for ids in [0, n), as a scatter of
    ones: its shape does not depend on the values (so it runs on fake
    tensors too, where ``bincount`` cannot)."""
    return torch.zeros(n, dtype=torch.long, device=ids.device).scatter_add_(
        0, ids, torch.ones_like(ids))


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
    counts = _counts(flat_e, e)
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
    [e_offset, e_offset + e_local), whose weights ``params`` holds (its
    ``wi_gate``/``wi_up``/``wo`` have ``e_local`` experts). Returns the
    *partial* combined output (T, D) float32 (contributions of those experts
    only) and the aux loss.

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

    act = F.silu(bmm(buf, params["wi_gate"])) * bmm(buf, params["wi_up"])
    out_buf = bmm(act, params["wo"])

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


def _ep_axes(cfg: ArchConfig, mesh=None):
    """(mesh, batch axes, model axis size) when the expert-parallel path
    applies on ``mesh`` (None: the ambient mesh), else None (no mesh, no
    model axis, a model axis of 1, ``moe_shard != "experts"`` or E not
    dividing it)."""
    mesh = ambient_mesh() if mesh is None else mesh
    if mesh is None:
        return None
    names = tuple(mesh.mesh_dim_names or ())
    if "model" not in names:
        return None
    tp = mesh.shape[names.index("model")]
    if tp <= 1 or cfg.moe_shard != "experts" or cfg.padded_experts % tp:
        return None
    ba = tuple(a for a in ("pod", "data") if a in names)
    return mesh, ba, tp


def ep_specs(cfg: ArchConfig, ba: tuple[str, ...]) -> tuple[dict, P]:
    """The expert-parallel path's specs of the MoE weights and of the
    (B, S, D) tokens (the reference's shard_map in_specs)."""
    wspec = {
        "norm": P(None),
        "router": P(None, None),
        "wi_gate": P("model", None, None),
        "wi_up": P("model", None, None),
        "wo": P("model", None, None),
    }
    if cfg.num_shared_experts:
        wspec["shared_wi_gate"] = P(None, "model")
        wspec["shared_wi_up"] = P(None, "model")
        wspec["shared_wo"] = P("model", None)
    return wspec, P(ba if ba else None, None, None)


def _shared(params: dict, xf: torch.Tensor) -> torch.Tensor:
    shg = F.silu(layers.matmul(xf, params["shared_wi_gate"])) * layers.matmul(
        xf, params["shared_wi_up"]
    )
    return layers.matmul(shg, params["shared_wo"])


def moe_ep_local(
    params: dict, hn: torch.Tensor, cfg: ArchConfig, mesh, ba: tuple[str, ...]
) -> tuple[torch.Tensor, torch.Tensor]:
    """One rank's share of the expert-parallel MoE on its local shards (the
    reference's ``ep_body``): ``params`` holds this model rank's
    ``e_local`` experts and its column/row slices of the shared experts,
    ``hn`` (b, s, D) its normalised tokens. Returns (y (b, s, D) in hn's
    type, aux averaged over ``model`` and ``ba``)."""
    from repro_torch.sharding.manual import axis_index, leave
    from repro_torch.sharding.partition import mesh_axis_size

    bl, sl, d = hn.shape
    xf = hn.reshape(bl * sl, d)
    tp = mesh_axis_size(mesh, "model")
    e_local = cfg.padded_experts // tp
    r = axis_index(mesh, "model")
    y, aux = _moe_core(params, xf, cfg, r * e_local, e_local)
    if cfg.num_shared_experts:
        # Column/row tensor-parallel over the same axis: the row-parallel
        # partial rides the same all-reduce.
        y = y + _shared(params, xf).float()
    y = leave(y, "model", mesh)
    axes = ("model", *ba)
    aux = leave(aux, axes, mesh) / mesh_axis_size(mesh, axes)
    return y.to(hn.dtype).reshape(bl, sl, d), aux


def apply_moe(
    params: dict, x: torch.Tensor, cfg: ArchConfig
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (output (B,S,D) in x's type, aux_loss scalar).

    Under an ambient mesh where the expert-parallel path applies (see the
    module docstring), ``params`` and ``x`` are global values: DTensors
    placed as :func:`ep_specs` says, or plain tensors that every rank holds
    whole. The output is a DTensor placed as ``x`` when ``x`` is one, else
    the whole (B, S, D) tensor on every rank. Otherwise the local dispatch
    runs on the tensors as they are."""
    ep = _ep_axes(cfg)
    if ep is None:
        b, s, d = x.shape
        hn = layers.rmsnorm(x, params["norm"], cfg.norm_eps)
        xf = hn.reshape(b * s, d)
        y, aux = _moe_core(params, xf, cfg, 0, cfg.padded_experts)
        y = y.to(x.dtype)
        if cfg.num_shared_experts:
            y = y + _shared(params, xf).to(x.dtype)
        return y.reshape(b, s, d), aux

    from repro_torch.sharding.manual import as_dtensor, gather, is_dtensor, local_shard
    from repro_torch.sharding.partition import mesh_axis_size

    mesh, ba, _ = ep
    if torch.is_grad_enabled() and (x.requires_grad or any(
            t.requires_grad for t in params.values() if isinstance(t, torch.Tensor))):
        raise RuntimeError("apply_moe's expert-parallel path places no gradient: run it "
                           "under torch.no_grad(), or train through make_train_step under "
                           "the mesh")
    if x.shape[0] % mesh_axis_size(mesh, ba):
        # Batch doesn't divide the DP axes: manual over the model axis
        # only; tokens are replicated across DP.
        ba = ()
    wspec, bspec = ep_specs(cfg, ba)
    local = {k: local_shard(params[k], spec, mesh) for k, spec in wspec.items()}
    h = local_shard(x, bspec, mesh)
    hn = layers.rmsnorm(h, local["norm"], cfg.norm_eps)
    y, aux = moe_ep_local(local, hn, cfg, mesh, ba)
    if is_dtensor(x):
        return as_dtensor(y, bspec, mesh, shape=x.shape), aux
    return gather(y, bspec, mesh), aux
