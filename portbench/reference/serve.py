"""What a served request is judged by: the reference's full forward over
the prompt and the tokens the program served, and for each served
token the gap by which its logit lies below the reference's best at
that position (0 where the program chose the reference's argmax)."""

from __future__ import annotations

import torch

from portbench.arch import Arch
from portbench.reference import decoder as ref


@torch.no_grad()
def logits(weights: dict, a: Arch, prompt: list[int], served: list[int],
           precision: str = "fp32") -> torch.Tensor:
    """(len(served), V) float32 logits that predict each served token:
    positions len(prompt) - 1 .. len(prompt) + len(served) - 2 of one
    causal sequence."""
    ref.strict_fp32()
    dev = weights["embed/tokens"].device
    seq = list(prompt) + list(served[:-1])
    x = ref.embed(weights, torch.tensor(seq, device=dev))
    lay = ref.Layers(weights, a)
    for l in range(a.layers):
        x, _ = ref.layer(x, [(0, len(seq))], lay, l, a, precision=precision,
                         kv_chunk=1)
    return ref.head(x[len(prompt) - 1:], weights, a, precision)


def gaps(ref_logits: torch.Tensor, tokens) -> torch.Tensor:
    """Per position, the reference's best logit minus the logit of
    ``tokens`` there."""
    t = torch.as_tensor(list(tokens), device=ref_logits.device)
    best = ref_logits.max(-1).values
    return best - ref_logits.gather(-1, t[:, None])[:, 0]
