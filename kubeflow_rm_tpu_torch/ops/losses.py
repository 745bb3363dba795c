"""Training losses (counterpart of ``kubeflow_rm_tpu/ops/losses.py``).

The cross-entropy is computed from float32 logits with an optional
z-loss regularizer (keeps the softmax normalizer bounded). Labels equal
to ``ignore_index`` contribute zero loss and zero weight, which is how
the data pipeline masks padding and prompt tokens.
"""

from __future__ import annotations

import torch

IGNORE_INDEX = -100


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, *,
                          z_loss: float = 0.0,
                          ignore_index: int = IGNORE_INDEX):
    """Mean token cross-entropy over the tokens whose label is not
    ``ignore_index``.

    Args:
      logits: (..., V) unnormalized log-probs (promoted to float32).
      labels: (...) int targets.

    Returns:
      ``(loss, aux)``: the scalar masked-mean NLL (plus the z-loss when
      asked for) and a dict of 0-dim tensors ``nll``, ``n_valid`` and,
      with a z-loss, ``z_loss``.
    """
    logits = logits.float()
    valid = labels != ignore_index
    safe = torch.where(valid, labels, 0).long()
    lse = torch.logsumexp(logits, dim=-1)
    label_logit = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = lse - label_logit
    weight = valid.float()
    n_valid = weight.sum()
    denom = torch.clamp(n_valid, min=1.0)
    nll_mean = (nll * weight).sum() / denom
    aux = {"nll": nll_mean, "n_valid": n_valid}
    loss = nll_mean
    if z_loss:
        zl = z_loss * (lse.square() * weight).sum() / denom
        aux["z_loss"] = zl
        loss = loss + zl
    return loss, aux
