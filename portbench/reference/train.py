"""The reference's training steps and the numbers the benchmark compares.

:func:`follow` draws the weights from the seed, rebuilds each step's batch
from its data seed, and takes ``steps`` steps of AdamW as the configuration
states them: bfloat16 parameters, float32 moments, the gradient summed over
the micro-batch slots in float32 and divided by their count, clipped by its
global norm, the update computed in float32 and the parameter stored back in
bfloat16. It returns the same readings the benchmark takes from the port.

Leaves: every parameter, a period-stacked one split into its layers, the
embedding and head cut to the published vocabulary.
"""
from __future__ import annotations

import math
import statistics

import torch

from portbench.reference import data, lm, weights


def leaf_views(flat: dict, vocab: int):
    """Yield ``(name, tensor)`` for every compared leaf of ``{path:
    tensor}``: stacked leaves by layer, vocabulary leaves cut to ``vocab``."""
    for path in sorted(flat):
        t = flat[path]
        if path == "embed/tok":
            yield path, t[:vocab]
        elif path == "head/w":
            yield path, t[:, :vocab]
        elif path.startswith("blocks/"):
            for i in range(t.shape[0]):
                yield f"{path}[{i}]", t[i]
        else:
            yield path, t


def norms(flat: dict, vocab: int) -> dict[str, float]:
    """float32 L2 norm of every compared leaf."""
    with torch.no_grad():
        return {k: float(torch.linalg.vector_norm(v.float())) for k, v in leaf_views(flat, vocab)}


def change_norms(now: dict, sz: dict, seed: int, device) -> dict[str, float]:
    """Norm of each compared leaf's change from its drawn start, drawing the
    start again one leaf at a time."""
    out = {}
    for path, start in weights.draw(sz, seed, device):
        diff = {path: now[path].float() - start.float()}
        del start
        out.update(norms(diff, sz["vocab"]))
        del diff
    return out


def lr_at(opt: dict, step: int) -> float:
    """The learning rate of step ``step`` (1-based): linear warm-up, then a
    cosine down to ``min_lr_frac`` of the peak."""
    warm = min(step / max(opt["warmup_steps"], 1), 1.0)
    prog = min(max((step - opt["warmup_steps"]) / max(opt["total_steps"] - opt["warmup_steps"], 1),
                   0.0), 1.0)
    cos = opt["min_lr_frac"] + (1 - opt["min_lr_frac"]) * 0.5 * (1 + math.cos(math.pi * prog))
    return opt["lr"] * warm * cos


def follow(sz: dict, opt: dict, weight_seed: int, data_seeds: list[int], slots: int,
           rows: int, seq_len: int, device, precision: str = "f32",
           slots_used: int | None = None, state_reset: int | None = None) -> dict:
    """Take ``len(data_seeds)`` steps from the drawn weights. Returns the
    losses, the first step's clipped gradient norms, and each leaf's change
    over all the steps. ``slots_used`` < ``slots`` plants the fault of a
    batch cut short: the mean over the first slots only; ``state_reset``
    that of a scan whose state does not cross between chunks."""
    prec = lm.Precision(precision, state_reset)
    used = slots_used or slots
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        params = weights.make(sz, weight_seed, device)
        mu = {k: torch.zeros(v.shape, dtype=torch.float32, device=device) for k, v in params.items()}
        nu = {k: torch.zeros_like(v) for k, v in mu.items()}
        losses, grad_norms = [], None
        for step, dseed in enumerate(data_seeds, start=1):
            batch = data.text_batch(dseed, 0, slots, rows, seq_len, sz["vocab"])
            w = {k: v.float().requires_grad_(True) for k, v in params.items()}
            gsum = {k: torch.zeros_like(v) for k, v in mu.items()}
            total = 0.0
            for i in range(used):
                toks = torch.as_tensor(batch["tokens"][i], device=device)
                labels = torch.as_tensor(batch["labels"][i], device=device)
                loss = lm.loss(w, toks, labels, sz, prec)
                grads = torch.autograd.grad(loss, [w[k] for k in sorted(w)])
                with torch.no_grad():
                    for k, g in zip(sorted(w), grads):
                        gsum[k].add_(g)
                total += float(loss.detach())
                del loss, grads
            del w
            losses.append(total / used)
            with torch.no_grad():
                for g in gsum.values():
                    g.div_(used)
                gnorm = math.sqrt(sum(float(torch.sum(g * g)) for g in gsum.values()))
                scale = min(opt["clip_norm"] / max(gnorm, 1e-9), 1.0)
                if step == 1:
                    grad_norms = norms({k: g * scale for k, g in gsum.items()}, sz["vocab"])
                lr = lr_at(opt, step)
                b1, b2 = opt["beta1"], opt["beta2"]
                for k, p in params.items():
                    g = gsum[k].mul_(scale)
                    mu[k].mul_(b1).add_((1 - b1) * g)
                    nu[k].mul_(b2).add_((1 - b2) * g * g)
                    upd = (mu[k] / (1 - b1 ** step)) / (torch.sqrt(nu[k] / (1 - b2 ** step)) + opt["eps"])
                    pf = p.float()
                    params[k] = (pf - lr * (upd + opt["weight_decay"] * pf)).to(weights.DTYPE)
            del gsum
        del mu, nu
        change = change_norms(params, sz, weight_seed, device)
        return {"losses": losses, "grad_norms": grad_norms, "change_norms": change}
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def kept_leaves(ref_grad_norms: dict[str, float]) -> set[str]:
    """Leaves whose change is compared: those whose reference gradient is at
    least a thousandth of the median leaf's. A leaf below that (nought to
    rounding) moves under Adam by round-off alone."""
    med = statistics.median(ref_grad_norms.values())
    return {k for k, v in ref_grad_norms.items() if v >= 1e-3 * med}


def worst_leaf_gap(got: dict[str, float], want: dict[str, float], keep=None) -> float:
    """The largest gap between a leaf's two norms, over the larger of the
    reference's norm of that leaf and of the median leaf."""
    names = sorted(keep if keep is not None else want)
    med = statistics.median(want[k] for k in names)
    return max(abs(got[k] - want[k]) / max(want[k], med) for k in names)


def compare(prog: dict, ref: dict) -> dict[str, float]:
    """The numbers compared: each step's loss (the largest relative gap),
    the first gradient's and the change's worst leaf."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
    return {
        "loss_gap": loss_gap,
        "grad_gap": worst_leaf_gap(prog["grad_norms"], ref["grad_norms"]),
        "change_gap": worst_leaf_gap(prog["change_norms"], ref["change_norms"],
                                     kept_leaves(ref["grad_norms"])),
    }
