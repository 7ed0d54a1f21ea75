"""The model's layers on one rank of a DeviceMesh, shared by the sharded
decode (:mod:`repro_torch.serve.sharded_decode`), the sharded prefill
(:mod:`repro_torch.serve.sharded_prefill`) and the sharded train step
(:mod:`repro_torch.train.sharded_step`).

Each function takes this rank's local shards, their specs (block weights'
specs with the period axis off) and the mesh, runs the unsharded layer of
:mod:`repro_torch.models` on the shards (head counts and vocab ranges come
from the tensors) and adds the collectives of
:mod:`repro_torch.sharding.manual`:

* **Row-parallel regions** (the MLP, the attention, the MoE, the
  vocab-sharded embedding and head): a layer whose ranks each compute a
  partial sum takes its replicated input and its replicated weights through
  ``enter`` and its output through ``leave``, so that under autograd every
  rank gets the unsharded gradients (Megatron's *f* and *g*; the norm sits
  inside the region, so its weight is entered too). Without autograd both
  cost nothing beyond the output's all-reduce.
* **FSDP** (a spec naming the DP axes): :func:`use` gathers the weight over
  them where it is used; its gradient is reduce-scattered back, which is
  that leaf's sum over the DP ranks.
* **Attention** with query heads that divide the model axis runs a rank's
  heads: its own K/V heads where they divide too, else the K/V projections
  all-gathered and each query head given its group's K/V. Otherwise every
  rank runs all heads and keeps its rows of the out-projection.
* **MoE**: the expert-parallel :func:`repro_torch.models.moe.moe_ep_local`
  where it applies (capacity per data shard, as the reference's
  ``shard_map``), else the dispatch over the batch gathered over the DP
  axes (the unsharded capacity), the experts' hidden dim row-parallel. The
  aux loss returned is averaged over ``model`` only: it is the data
  shard's, and a train step's mean over the DP ranks makes the reference's
  mean over shards.
* **Mamba2**: a rank's heads where they and the inner width divide the
  model axis (one B/C group, whole on every rank): the out-projection
  row-parallel, the gated output's mean square summed over the ranks
  (``psum``, whose gradient is summed too). Otherwise :func:`mamba_whole`
  gathers the weights over ``model`` (gradient: this rank's block) and
  every rank runs the block whole.

The mesh is passed in, never read from the ambient mesh: under autograd a
checkpointed period is recomputed on the autograd engine's threads, where
:func:`repro_torch.sharding.set_mesh`'s context is not set.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention, layers, ssm
from repro_torch.models import moe as moe_lib
from repro_torch.sharding import P
from repro_torch.sharding import partition as part
from repro_torch.sharding.manual import (
    all_reduce, axis_index, enter, gather_at_use, gather_whole, is_dtensor, leave,
    local_shard, psum, split,
)


# ---------------------------------------------------------------- trees
def local_tree(tree, specs, mesh):
    """``(local tensors, specs)`` of a tree: a DTensor's own placements, a
    plain tensor sliced by ``specs``."""
    if not isinstance(tree, dict):
        spec = part.spec_of(tree) if is_dtensor(tree) else specs
        return local_shard(tree, spec, mesh), spec
    loc, sp = {}, {}
    for k, v in tree.items():
        loc[k], sp[k] = local_tree(v, specs[k], mesh)
    return loc, sp


def period(tree, i: int):
    """Period ``i`` of stacked local tensors or of their specs (the leading
    dim off)."""
    if isinstance(tree, P):
        return P(*tree[1:])
    if isinstance(tree, dict):
        return {k: period(v, i) for k, v in tree.items()}
    return tree[i]


def sharded(spec: P, dim: int) -> bool:
    """Whether dimension ``dim`` of ``spec`` is split over ``model``."""
    return "model" in part.spec_axes(spec[dim])


def on_model(spec: P) -> bool:
    return any(sharded(spec, d) for d in range(len(spec)))


def model_only(spec: P) -> P:
    """``spec`` with only its ``model`` entries."""
    return P(*["model" if "model" in part.spec_axes(e) else None for e in spec])


def use(t: torch.Tensor, spec: P, mesh):
    """``(t, spec)`` with every dimension that ``spec`` splits over the DP
    axes (an FSDP weight) gathered over them, and the spec without them."""
    ba = set(part.batch_axes(mesh))
    out = list(spec)
    for d, entry in enumerate(spec):
        axes = part.spec_axes(entry)
        if axes and set(axes) <= ba:
            t = gather_at_use(t, entry, mesh, d)
            out[d] = None
    return t, P(*out)


def use_tree(p: dict, spec: dict, mesh):
    """:func:`use` over a dict of leaves: ``(tensors, specs)``."""
    loc, sp = {}, {}
    for k in p:
        loc[k], sp[k] = use(p[k], spec[k], mesh)
    return loc, sp


def _region(p: dict, spec: dict, x: torch.Tensor, mesh):
    """``p``'s replicated leaves and ``x`` through ``enter`` over model."""
    return ({k: v if on_model(spec[k]) else enter(v, "model", mesh) for k, v in p.items()},
            enter(x, "model", mesh))


# ----------------------------------------------------------- embed, head
def embed(p: dict, spec: dict, tokens: torch.Tensor, cfg: ArchConfig, mesh):
    """The input embedding of this rank's tokens (vision embeds pass)."""
    if cfg.modality == "vision_embeds":
        return tokens.to(cfg.activation_dtype)
    vdim = 1 if cfg.modality == "audio_codes" else 0
    if not sharded(spec["tok"], vdim):
        return layers.apply_embed(p, tokens, cfg)
    row0 = axis_index(mesh, "model") * p["tok"].shape[vdim]
    return leave(layers.apply_embed(p, tokens, cfg, row0=row0), "model", mesh)


def head_col0(p: dict, spec: dict, cfg: ArchConfig, mesh) -> tuple[bool, int]:
    """(vocab sharded, the vocab index of this rank's first column)."""
    vdim = 2 if cfg.modality == "audio_codes" else 1
    if not sharded(spec["w"], vdim):
        return False, 0
    return True, axis_index(mesh, "model") * p["w"].shape[vdim]


def head(p: dict, spec: dict, x: torch.Tensor, cfg: ArchConfig, mesh):
    """This rank's logits columns (all where the head is not sharded)."""
    vs, col0 = head_col0(p, spec, cfg, mesh)
    if vs:
        x = enter(x, "model", mesh)
    return layers.apply_head(p, x, cfg, col0=col0)


def cross_entropy(logits, labels, vocab_sharded: bool, col0: int, mesh):
    """Mean next-token cross-entropy of logits whose columns are the vocab
    ids ``col0 ..`` (a rank's, with ``vocab_sharded``): the row maxima,
    exp-sums and label logits meet over ``model``."""
    lf = logits.float()
    if not vocab_sharded:
        logz = torch.logsumexp(lf, dim=-1)
        ll = torch.gather(lf, -1, labels[..., None].long())[..., 0]
        return torch.mean(logz - ll)
    cols = lf.shape[-1]
    m = all_reduce(lf.detach().amax(dim=-1), "model", mesh, op="max")
    logz = m + torch.log(leave(torch.exp(lf - m[..., None]).sum(dim=-1), "model", mesh))
    ids = labels.long() - col0
    mine = (ids >= 0) & (ids < cols)
    got = torch.gather(lf, -1, ids.clamp(0, cols - 1)[..., None])[..., 0]
    ll = leave(torch.where(mine, got, 0.0), "model", mesh)
    return torch.mean(logz - ll)


# ---------------------------------------------------------------- layers
def mlp(p: dict, spec: dict, x: torch.Tensor, cfg: ArchConfig, mesh):
    if not sharded(spec["wo"], 0):
        return layers.apply_mlp(p, x, cfg)
    p, x = _region(p, spec, x, mesh)
    return leave(layers.apply_mlp(p, x, cfg), "model", mesh)


def attention_step(p: dict, spec: dict, x: torch.Tensor, cfg: ArchConfig, positions,
                   window: int, mesh):
    """Training/prefill attention on this rank. Returns (out, k, v): out the
    whole (B, S, D) output, k and v the positioned K/V rows this rank
    computed, (B, S, KV heads, hd): its own heads where the KV heads divide
    the model axis, else all of them."""
    if not sharded(spec["wq"], 1):
        return attention.attend(p, x, cfg, positions, window=window)
    p, x = _region(p, spec, x, mesh)
    tp = part.mesh_axis_size(mesh, "model")
    h, kvh = cfg.num_heads, cfg.num_kv_heads
    if h % tp == 0 and kvh % tp == 0:
        out, k, v = attention.attend(p, x, cfg, positions, window=window)
        return leave(out, "model", mesh), k, v
    b, s, _ = x.shape
    q_local = h % tp == 0

    def cols(t, w):
        if w == "wq" and q_local:
            return t
        return gather_at_use(t, "model", mesh, -1)

    q, k, v = attention._project_qkv(p, x, cfg, cols)
    q, k = attention._apply_positions(q, k, positions, cfg)
    r, rep = axis_index(mesh, "model"), h // kvh
    if q_local:
        # This rank's query heads, each beside its group's K/V head.
        hl = h // tp
        group = (r * hl + torch.arange(hl, device=x.device)) // rep
        out = attention.blocked_attention(q, k[:, :, group], v[:, :, group], causal=True,
                                          window=window)
        out = out.reshape(b, s, -1)
    else:
        out = attention.blocked_attention(q, k, v, causal=True, window=window)
        out = split(out.reshape(b, s, -1), "model", mesh, -1)
    return leave(layers.matmul(out, p["wo"]), "model", mesh), k, v


def moe(p: dict, spec: dict, x: torch.Tensor, tok_axes: tuple, cfg: ArchConfig, mesh):
    """Returns (y (B, S, D) in x's type, aux). ``tok_axes``: the DP axes the
    tokens' batch dim is split over."""
    ep = moe_lib._ep_axes(cfg, mesh)
    tp = part.mesh_axis_size(mesh, "model")
    if ep is not None:
        wspec, _ = moe_lib.ep_specs(cfg, ())
        for k, want in wspec.items():
            if spec[k] != want:
                raise ValueError(f"expert-parallel MoE: {k} placed {spec[k]}, needs {want}")
        p, x = _region(p, spec, x, mesh)
        hn = layers.rmsnorm(x, p["norm"], cfg.norm_eps)
        return moe_lib.moe_ep_local(p, hn, cfg, mesh, ())
    # Experts whole on every rank, or sharded on their hidden dim ("ff"):
    # routed and shared outputs are partial sums where their weights are
    # sharded. The dispatch sees the whole batch, as the reference's
    # (its capacity and drops are the batch's).
    region = sharded(spec["wo"], 1) or (cfg.num_shared_experts > 0
                                          and sharded(spec["shared_wo"], 0))
    if region:
        p, x = _region(p, spec, x, mesh)

    def total(y, is_partial):
        if is_partial:
            return leave(y, "model", mesh)
        if region and torch.is_grad_enabled() and y.requires_grad:
            return leave(y / tp, "model", mesh)   # replicated inside an entered region
        return y

    bl, s, d = x.shape
    hn = layers.rmsnorm(x, p["norm"], cfg.norm_eps)
    if tok_axes:
        hn = gather_at_use(hn, tok_axes, mesh, 0)
    xf = hn.reshape(-1, d)
    y, aux = moe_lib._moe_core(p, xf, cfg, 0, cfg.padded_experts)
    y = total(y, sharded(spec["wo"], 1)).to(x.dtype)
    if cfg.num_shared_experts:
        y = y + total(moe_lib._shared(p, xf), sharded(spec["shared_wo"], 0)).to(x.dtype)
    lo = axis_index(mesh, tok_axes) * bl
    return y.reshape(-1, s, d)[lo:lo + bl], total(aux, False)


_MAMBA_SPLIT = ("w_z", "w_x", "w_dt", "dt_bias", "a_log", "d_skip", "conv_x", "out_norm",
                "w_out")


def mamba_per_rank(spec: dict, cfg: ArchConfig) -> bool:
    """Whether a Mamba2 block runs on this rank's heads (else whole)."""
    return cfg.ssm_groups == 1 and all(on_model(spec[k]) for k in _MAMBA_SPLIT)


def mamba_norm(cfg: ArchConfig, mesh):
    """The gated output's RMSNorm over features split across ``model``:
    each rank's sum of squares, summed over the ranks (``psum``)."""
    def norm(y, weight, eps):
        yf = y.float()
        ms = psum(torch.sum(yf * yf, dim=-1, keepdim=True), "model", mesh) / cfg.ssm_inner
        return (yf * torch.rsqrt(ms + eps) * weight.float()).to(y.dtype)

    return norm


def mamba(p: dict, spec: dict, x: torch.Tensor, cfg: ArchConfig, mesh):
    """Training/prefill Mamba2 on this rank. Returns (out, cache): the
    cache of this rank's heads, or of all where the block runs whole."""
    if not mamba_per_rank(spec, cfg):
        return ssm.mamba_forward(mamba_whole(p, spec, mesh), x, cfg)
    p, x = _region(p, spec, x, mesh)
    out, cache = ssm.mamba_forward(p, x, cfg, out_norm=mamba_norm(cfg, mesh))
    return leave(out, "model", mesh), cache


def mamba_whole(p: dict, spec: dict, mesh) -> dict:
    """The Mamba2 weights gathered whole over ``model``."""
    out = {}
    for k, t in p.items():
        for d, entry in enumerate(spec[k]):
            if "model" in part.spec_axes(entry):
                t = gather_whole(t, "model", mesh, d)
        out[k] = t
    return out
