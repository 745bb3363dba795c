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
                          ignore_index: int = IGNORE_INDEX,
                          total=None):
    """Mean token cross-entropy over the tokens whose label is not
    ``ignore_index``.

    Args:
      logits: (..., V) unnormalized log-probs (promoted to float32).
      labels: (...) int targets.
      total: where the tokens are one rank's share of a batch, the
        function that sums a 0-dim tensor over the ranks (an autograd
        all-reduce): the masked sums and the count go through it before
        the division, so the mean is the global token mean.

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
    if total is None:
        def total(t):
            return t
    n_valid = total(weight.sum())
    denom = torch.clamp(n_valid, min=1.0)
    nll_mean = total((nll * weight).sum()) / denom
    aux = {"nll": nll_mean, "n_valid": n_valid}
    loss = nll_mean
    if z_loss:
        zl = z_loss * total((lse.square() * weight).sum()) / denom
        aux["z_loss"] = zl
        loss = loss + zl
    return loss, aux
