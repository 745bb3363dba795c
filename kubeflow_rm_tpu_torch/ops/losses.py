"""Training losses (counterpart of ``kubeflow_rm_tpu/ops/losses.py``).

The cross-entropy is computed from float32 logits with an optional
z-loss regularizer (keeps the softmax normalizer bounded). Labels equal
to ``ignore_index`` contribute zero loss and zero weight, which is how
the data pipeline masks padding and prompt tokens.

On a mesh whose ``tp`` axis splits the vocabulary the logits stay split
(``vocab_group``): the log-sum-exp is a cross-rank maximum and a sum of
exponentials, and the label's logit is picked on the rank that holds it
and summed, as GSPMD partitions JAX's loss without ever holding the
(B, T, V) logits on one device.
"""

from __future__ import annotations

import torch

IGNORE_INDEX = -100


def _vocab_parallel(logits: torch.Tensor, labels: torch.Tensor, group):
    """(lse, label logit) of float32 ``logits`` that are this rank's
    contiguous columns of the vocabulary (rank r holds ``r·V_loc`` on),
    summed over ``group``. The shift by the maximum is detached: the
    log-sum-exp does not depend on it."""
    import torch.distributed as dist

    from kubeflow_rm_tpu_torch.parallel.collectives import (
        all_reduce, all_reduce_max,
    )

    V_loc = logits.shape[-1]
    m = all_reduce_max(logits.detach().amax(dim=-1), group)
    lse = m + torch.log(all_reduce(
        torch.exp(logits - m[..., None]).sum(dim=-1), group))
    local = labels - dist.get_rank(group) * V_loc
    inside = (local >= 0) & (local < V_loc)
    picked = torch.gather(logits, -1,
                          local.clamp(0, V_loc - 1)[..., None])[..., 0]
    return lse, all_reduce(torch.where(inside, picked, 0.0), group)


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, *,
                          z_loss: float = 0.0,
                          ignore_index: int = IGNORE_INDEX,
                          total=None, vocab_group=None):
    """Mean token cross-entropy over the tokens whose label is not
    ``ignore_index``.

    Args:
      logits: (..., V) unnormalized log-probs (promoted to float32).
      labels: (...) int targets.
      total: where the tokens are one rank's share of a batch, the
        function that sums a 0-dim tensor over the ranks (an autograd
        all-reduce): the masked sums and the count go through it before
        the division, so the mean is the global token mean.
      vocab_group: where ``logits`` are this rank's share of the
        vocabulary columns (``forward(..., local_vocab=True)`` on a tp
        mesh), the process group that holds the others.

    Returns:
      ``(loss, aux)``: the scalar masked-mean NLL (plus the z-loss when
      asked for) and a dict of 0-dim tensors ``nll``, ``n_valid`` and,
      with a z-loss, ``z_loss``.
    """
    logits = logits.float()
    valid = labels != ignore_index
    safe = torch.where(valid, labels, 0).long()
    if vocab_group is None or vocab_group.size() == 1:
        lse = torch.logsumexp(logits, dim=-1)
        label_logit = torch.gather(logits, -1, safe[..., None])[..., 0]
    else:
        lse, label_logit = _vocab_parallel(logits, safe, vocab_group)
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
