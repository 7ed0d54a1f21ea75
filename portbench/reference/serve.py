"""The reference's judgement of served tokens.

Greedy decoding serves, at each position, the token whose logit is the
largest. :func:`served_gaps` runs the reference once over a prompt with its
served tokens and reads, at each position that produced a served token, by
how much that token's logit lies below the reference's best there.
:func:`control_gaps` reads the same gap for the token that a lower
precision puts first at each position.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.reference import lm


def _sequence(prompt: np.ndarray, served: np.ndarray, device) -> torch.Tensor:
    seq = np.concatenate([prompt, served[:-1]])
    return torch.as_tensor(seq, device=device)[None]


def _positions(prompt: np.ndarray, served: np.ndarray) -> slice:
    """The positions whose logits chose the served tokens: the prompt's
    last, then each served token's but the last."""
    s0 = len(prompt)
    return slice(s0 - 1, s0 - 1 + len(served))


def served_gaps(params: dict, prompt: np.ndarray, served: np.ndarray, sz: dict,
                device) -> np.ndarray:
    """float32 reference: best logit minus the served token's, per served
    token."""
    out = lm.logits(params, _sequence(prompt, served, device), sz, lm.Precision("f32"))
    rows = out[0, _positions(prompt, served)]
    tok = torch.as_tensor(served, device=device).long()
    gaps = rows.max(dim=-1).values - rows.gather(-1, tok[:, None])[:, 0]
    return gaps.double().cpu().numpy()


def control_gaps(params: dict, prompt: np.ndarray, served: np.ndarray, sz: dict,
                 device, precision: str = "fp8") -> np.ndarray:
    """The gap, in the float32 reference, of the token that ``precision``
    puts first at each position of the same sequence."""
    seq, pos = _sequence(prompt, served, device), _positions(prompt, served)
    low = lm.logits(params, seq, sz, lm.Precision(precision))[0, pos].argmax(dim=-1)
    ref = lm.logits(params, seq, sz, lm.Precision("f32"))[0, pos]
    gaps = ref.max(dim=-1).values - ref.gather(-1, low[:, None])[:, 0]
    return gaps.double().cpu().numpy()
