"""LoRA fine-tuning steps of the plain decoder, in float32.

The forward runs layer by layer without a graph and keeps each layer's
input; the backward replays one layer at a time under autograd, from the
output's gradient back to its input, collecting the adapters' gradients
on the way. The optimizer is Adam as optax defines it (Kingma and Ba's
moments and bias correction, eps outside the root), after a clip of the
global norm, with decoupled weight decay and a cosine schedule, all in
float32.
"""

from __future__ import annotations

import math

import torch

from portbench.arch import Arch
from portbench.reference import decoder as ref

IGNORE = -100


def row_layout(docs_by_row: list[list]) -> tuple[list, list]:
    """The tokens, targets and document spans of a batch given as rows
    of documents: ``(tokens, targets)`` per row and the (start, end) of
    every document in the rows laid end to end."""
    spans, tokens, targets, off = [], [], [], 0
    for docs in docs_by_row:
        for d in docs:
            d = [int(t) for t in d]
            spans.append((off, off + len(d)))
            tokens.extend(d)
            targets.extend(d[1:] + [IGNORE])
            off += len(d)
    return (tokens, targets), spans


def _lora_of(P: dict, targets, l: int, grad: bool):
    out = {}
    for t in targets:
        A, B = P[f"blocks/{t}_lora_a"][l], P[f"blocks/{t}_lora_b"][l]
        if grad:
            A, B = A.detach().requires_grad_(), B.detach().requires_grad_()
        out[t] = (A, B)
    return out


def loss_and_grads(weights: dict, a: Arch, P: dict, docs_by_row, job: dict,
                   precision: str = "fp32"):
    """The objective on one batch and the adapters' gradients
    ``{path: (L, ...)}``."""
    dev = weights["embed/tokens"].device
    targets = tuple(job["lora_targets"])
    alpha = job["lora_alpha"]
    (tok, tgt), spans = row_layout(docs_by_row)
    tok = torch.tensor(tok, device=dev)
    tgt = torch.tensor(tgt, device=dev)
    lay = ref.Layers(weights, a)
    kw = dict(alpha=alpha, precision=precision)
    xs, auxes = [], []
    with torch.no_grad():
        x = ref.embed(weights, tok)
        for l in range(a.layers):
            xs.append(x)
            x, aux = ref.layer(x, spans, lay, l, a,
                               lora=_lora_of(P, targets, l, False), **kw)
            auxes.append(aux)
    x = x.detach().requires_grad_()
    logits = ref.head(x, weights, a, precision)
    valid = tgt != IGNORE
    lse = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(-1, tgt.clamp(min=0)[:, None])[:, 0]
    n = valid.sum()
    loss = ((lse - picked) * valid).sum() / n
    loss = loss + job["z_loss"] * (lse.square() * valid).sum() / n
    (g,) = torch.autograd.grad(loss, x)
    del logits, lse, picked
    total = float(loss.detach())
    coef = a.router_aux_coef / a.layers if a.moe else 0.0
    if a.moe:
        total += coef * sum(float(t) for t in auxes)
    grads = {p: torch.zeros_like(t) for p, t in P.items()}
    for l in reversed(range(a.layers)):
        xin = xs[l].requires_grad_()
        lora = _lora_of(P, targets, l, True)
        y, aux = ref.layer(xin, spans, lay, l, a, lora=lora, **kw)
        obj = (y * g).sum()
        if aux is not None:
            obj = obj + coef * aux
        leaves = [xin] + [t for pair in lora.values() for t in pair]
        got = torch.autograd.grad(obj, leaves)
        g = got[0]
        for i, t in enumerate(targets):
            grads[f"blocks/{t}_lora_a"][l] = got[1 + 2 * i]
            grads[f"blocks/{t}_lora_b"][l] = got[2 + 2 * i]
        xs[l] = None
        del y, aux, obj, got, xin
    return total, grads


def schedule(opt: dict, count: int) -> float:
    """optax's warmup-cosine schedule (warmup from 0, decay to a tenth)."""
    peak, warm = opt["learning_rate"], opt["warmup_steps"]
    if count < warm:
        return peak * count / warm
    decay = max(opt["total_steps"], warm + 1) - warm
    t = min(count - warm, decay)
    return peak * (0.9 * 0.5 * (1 + math.cos(math.pi * t / decay)) + 0.1)


def adam_step(P: dict, grads: dict, state: dict, opt: dict, count: int,
              store=lambda t: t):
    """One clipped AdamW update of ``P`` in place, each new parameter
    passed through ``store`` (the precision it is kept in)."""
    gnorm = math.sqrt(sum(float(g.double().square().sum())
                          for g in grads.values()))
    scale = 1.0 if gnorm < opt["grad_clip"] else opt["grad_clip"] / gnorm
    b1, b2, n = opt["b1"], opt["b2"], count + 1
    lr = schedule(opt, count)
    for p, g in grads.items():
        g = g * scale
        m = state.setdefault("mu", {}).get(p, torch.zeros_like(g))
        v = state.setdefault("nu", {}).get(p, torch.zeros_like(g))
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        state["mu"][p], state["nu"][p] = m, v
        u = (m / (1 - b1 ** n)) / ((v / (1 - b2 ** n)).sqrt() + 1e-8)
        u = u + opt["weight_decay"] * P[p]
        P[p] = store(P[p] - lr * u)


def train(weights: dict, a: Arch, adapters: dict, batches: list, job: dict,
          precision: str = "fp32") -> dict:
    """``len(batches)`` steps from ``adapters`` (``{path: tensor}``, any
    dtype). Returns each step's objective, the first step's gradient
    norm a leaf as the optimizer takes it in (before its clip), and each
    leaf's change over the steps. In fp8 (the control) the adapters are
    also kept in fp8, as the program keeps them in its own dtype."""
    ref.strict_fp32()
    store = ((lambda t: ref.fp8(t).detach()) if precision == "fp8"
             else (lambda t: t))
    P0 = {p: t.float().clone() for p, t in adapters.items()}
    P = {p: store(t.clone()) for p, t in P0.items()}
    state: dict = {}
    losses, first = [], None
    for count, docs_by_row in enumerate(batches):
        loss, grads = loss_and_grads(weights, a, P, docs_by_row, job,
                                     precision)
        losses.append(loss)
        if first is None:
            first = {p: float(g.norm()) for p, g in grads.items()}
        adam_step(P, grads, state, job["optimizer"], count, store)
    return {"losses": losses, "grad_norms": first,
            "change_norms": {p: float((P[p] - P0[p]).norm()) for p in P}}
