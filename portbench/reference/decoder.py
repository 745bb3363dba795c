"""Plain decoder of the Mistral and Mixtral family, in float32.

Written from the published description (Hugging Face's
``modeling_mistral`` and ``modeling_mixtral``), with plain torch
operations and no kernel, cache or batching of the program's. It reads
the benchmark's weights (``portbench.weights``: projections ``(in,
out)``, stacked on a leading layer axis) and upcasts one layer at a
time, so that the 16 Mixtral layers fit beside their activations.

- RMSNorm, RoPE over split halves (``rotate_half``), grouped-query
  attention (query head h reads key/value head h // group), causal
  inside each document: a document is its own sequence, positions from
  0, whatever row it was packed into.
- SwiGLU MLP, or the mixture: a float32 router, softmax, the top-k
  gates renormalised, each token's share of each chosen expert.
- LoRA on the named projections: ``h @ w + (h @ a) @ b * alpha / r``.

Departures from the published model, each the training job's or the
deployment's and not the architecture's: the mixture drops tokens past
an expert's capacity (``ceil(top_k * N * capacity_factor / E)`` slots,
claimed slot 0 of every token first, then slot 1, in token order; the
configuration file's ``assumed``), where Mixtral's own inference is
dropless; the loss adds a z-loss (1e-4 · lse²) and the router's
load-balancing loss (``E · Σ_e f_e · P_e`` averaged over layers, f_e
the share of tokens whose first choice is e).

``precision="fp8"`` is the control: every matrix product takes its two
operands rounded to float8 e4m3 (one scale a tensor, the largest
magnitude at 448) and sums in float32, as an fp8 path of a program
would; norms, softmax and the loss stay float32. Its gradients pass the
rounding straight through.
"""

from __future__ import annotations

import math

import torch

from portbench.arch import Arch

E4M3_MAX = 448.0


def strict_fp32() -> None:
    """Float32 products in float32: no TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded through float8 e4m3 at one scale (value only; the
    gradient passes straight through)."""
    s = t.detach().abs().amax().clamp(min=1e-30) / E4M3_MAX
    q = (t.detach() / s).to(torch.float8_e4m3fn).to(torch.float32) * s
    return t + (q - t.detach())


def mm(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "fp8":
        return fp8(x) @ fp8(w)
    return x @ w


def rms_norm(x, g, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * g


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (n, heads, hd) rotated by positions ``pos`` (n,)."""
    hd = x.shape[-1]
    inv = theta ** (-torch.arange(0, hd, 2, dtype=torch.float64,
                                  device=x.device) / hd)
    ang = (pos.to(torch.float64)[:, None] * inv[None]).to(torch.float32)
    c, s = ang.cos()[:, None, :], ang.sin()[:, None, :]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def attend(q, k, v, precision: str, kv_chunk: int | None = None):
    """Causal attention of one document: q (n, H, hd), k/v (n, KVH, hd)
    -> (n, H·hd). ``kv_chunk`` key/value heads at a time (memory)."""
    n, H, hd = q.shape
    KVH = k.shape[1]
    G = H // KVH
    keep = torch.ones(n, n, dtype=torch.bool, device=q.device).tril()
    outs = []
    step = kv_chunk or KVH
    for j in range(0, KVH, step):
        qj = q[:, j * G:(j + step) * G].transpose(0, 1)            # (h, n, hd)
        kj = k[:, j:j + step].repeat_interleave(G, 1).transpose(0, 1)
        vj = v[:, j:j + step].repeat_interleave(G, 1).transpose(0, 1)
        s = mm(qj, kj.transpose(1, 2), precision) / math.sqrt(hd)
        p = torch.softmax(s.masked_fill(~keep, float("-inf")), dim=-1)
        outs.append(mm(p, vj, precision).transpose(0, 1))
    return torch.cat(outs, dim=1).reshape(n, H * hd)


class Layers:
    """Layer ``l``'s weights in float32, upcast when asked for (experts
    one at a time)."""

    def __init__(self, weights: dict, a: Arch):
        self.w, self.a = weights, a

    def get(self, name: str, l: int) -> torch.Tensor:
        return self.w[f"blocks/{name}"][l].float()

    def expert(self, name: str, l: int, e: int) -> torch.Tensor:
        return self.w[f"blocks/{name}"][l, e].float()


def project(h, lay: Layers, l: int, name: str, lora: dict | None,
            alpha: float, precision: str):
    out = mm(h, lay.get(name, l), precision)
    if lora and name in lora:
        A, B = lora[name]
        out = out + mm(mm(h, A, precision), B, precision) * (alpha / A.shape[-1])
    return out


def route(logits: torch.Tensor, a: Arch):
    """Top-k routing with capacity over the N tokens of ``logits`` (N,
    E): per expert the kept (token, gate) pairs, and the aux loss."""
    N, E = logits.shape
    probs = torch.softmax(logits, dim=-1)
    gates, choice = probs.topk(a.top_k, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True)
    cap = max(1, math.ceil(a.top_k * N * a.capacity_factor / E))
    used = [0] * E
    kept = {e: ([], []) for e in range(E)}
    choice_h = choice.tolist()
    for slot in range(a.top_k):
        for n in range(N):
            e = choice_h[n][slot]
            if used[e] < cap:
                kept[e][0].append(n)
                kept[e][1].append(slot)
            used[e] += 1
    first = torch.zeros(E, device=logits.device).index_add_(
        0, choice[:, 0], torch.ones(N, device=logits.device)) / N
    aux = E * (first * probs.mean(0)).sum()
    out = {}
    for e, (toks, slots) in kept.items():
        if toks:
            t = torch.tensor(toks, device=logits.device)
            s = torch.tensor(slots, device=logits.device)
            out[e] = (t, gates[t, s])
    return out, aux


def moe(h: torch.Tensor, lay: Layers, l: int, a: Arch, precision: str):
    """(N, D) -> ((N, D), aux loss) through the mixture."""
    logits = mm(h, lay.get("router", l), precision)
    kept, aux = route(logits, a)
    out = torch.zeros_like(h)
    for e, (t, g) in kept.items():
        x = h[t]
        y = torch.nn.functional.silu(
            mm(x, lay.expert("moe_gate", l, e), precision)) \
            * mm(x, lay.expert("moe_up", l, e), precision)
        y = mm(y, lay.expert("moe_down", l, e), precision)
        out = out.index_add(0, t, y * g[:, None])
    return out, aux


def mlp(h, lay: Layers, l: int, precision: str):
    gate = mm(h, lay.get("w_gate", l), precision)
    up = mm(h, lay.get("w_up", l), precision)
    return mm(torch.nn.functional.silu(gate) * up, lay.get("w_down", l),
              precision)


def layer(x: torch.Tensor, docs: list[tuple[int, int]], lay: Layers,
          l: int, a: Arch, *, lora: dict | None = None,
          alpha: float = 16.0, precision: str = "fp32",
          kv_chunk: int | None = None):
    """One block over ``x`` (N, D), the tokens of every sequence in a
    row, ``docs`` the (start, end) of each document in it. Returns
    ``(x, aux)`` (aux None for a dense model)."""
    hd = a.head_dim
    h = rms_norm(x, lay.get("attn_norm", l), a.norm_eps)
    q = project(h, lay, l, "wq", lora, alpha, precision)
    k = project(h, lay, l, "wk", lora, alpha, precision)
    v = project(h, lay, l, "wv", lora, alpha, precision)
    outs = []
    for s, e in docs:
        pos = torch.arange(e - s, device=x.device)
        qd = rope(q[s:e].reshape(e - s, a.heads, hd), pos, a.rope_theta)
        kd = rope(k[s:e].reshape(e - s, a.kv_heads, hd), pos, a.rope_theta)
        vd = v[s:e].reshape(e - s, a.kv_heads, hd)
        outs.append(attend(qd, kd, vd, precision, kv_chunk))
    x = x + project(torch.cat(outs), lay, l, "wo", lora, alpha, precision)
    h = rms_norm(x, lay.get("mlp_norm", l), a.norm_eps)
    if a.moe:
        y, aux = moe(h, lay, l, a, precision)
        return x + y, aux
    return x + mlp(h, lay, l, precision), None


def head(x: torch.Tensor, weights: dict, a: Arch, precision: str):
    """Final norm and the output head: float32 logits."""
    h = rms_norm(x, weights["out_norm"].float(), a.norm_eps)
    return mm(h, weights["lm_head"].float(), precision)


def embed(weights: dict, tokens: torch.Tensor) -> torch.Tensor:
    return weights["embed/tokens"][tokens].float()
