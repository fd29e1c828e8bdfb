"""Plain reference of a dense grouped-query-attention decoder
(Llama-style, as Yi publishes it: arXiv:2403.04652).

Each layer: ``x += Wo attn(rope(Wq n1(x)), rope(Wk n1(x)), Wv n1(x))``,
then ``x += Wdown(silu(Wgate n2(x)) * Wup n2(x))``, with RMSNorm ``n`` of
gain ``1 + g``, rotary embeddings over the two halves of each head
(theta from the configuration), causal softmax attention in which query
head ``h`` reads key/value head ``h // (heads / kv_heads)``, and an
untied head.  Every projection runs through :func:`quant.qlinear` (int8
weights per output channel, int8 activations per tensor); the embedding
and the head stay unquantized, as served.  Arithmetic is float32; an
activation is stored in bf16 between operations (:func:`act`), as the
configuration states.  Departures from a plain float32 model: only that
quantization and storage, which are the configuration's.  The
per-tensor activation scale here spans the whole sequence of one
request; served, it spans whatever rows the program's call holds.
"""

from __future__ import annotations

import torch

from portbench.reference.quant import qlinear, quantize_weight
from portbench.weights import Leaf

__all__ = ["weight_layout", "logits", "PROJECTIONS"]

PROJECTIONS = ("wq", "wk", "wv", "wo", "gate", "up", "down")
_F32 = torch.float32


def _he(i: int, o: int) -> float:
    return (2.0 / (i + o)) ** 0.5


def weight_layout(m: dict) -> list[Leaf]:
    d, h, kvh, hd = m["d_model"], m["n_heads"], m["n_kv_heads"], m["head_dim"]
    ff, v = m["d_ff"], m["vocab_size"]
    out = [Leaf("embed", (v, d), "normal", 0.02)]
    shapes = {"wq": (d, h * hd), "wk": (d, kvh * hd), "wv": (d, kvh * hd),
              "wo": (h * hd, d), "gate": (d, ff), "up": (d, ff),
              "down": (ff, d)}
    for i in range(m["n_layers"]):
        g = f"layers.{i}"
        out.append(Leaf(f"{g}.mixer_norm", (d,), "zeros", dtype=_F32))
        out.append(Leaf(f"{g}.ffn_norm", (d,), "zeros", dtype=_F32))
        out += [Leaf(f"{g}.{n}", s, "normal", _he(*s), group=g)
                for n, s in shapes.items()]
    out.append(Leaf("final_norm", (d,), "zeros", dtype=_F32))
    if not m.get("tie_embeddings", False):
        out.append(Leaf("lm_head", (d, v), "normal", _he(d, v)))
    return out


def act(t: torch.Tensor) -> torch.Tensor:
    """An activation as the configuration stores it between operations:
    rounded to bf16 (arithmetic inside each operation stays float32)."""
    return t.to(torch.bfloat16).to(_F32)


def rms_norm(x, gain, eps):
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return x * (1.0 + gain.to(_F32))


def _rope(x, pos, theta):
    """x: (S, H, D); rotation of the halves (x1, x2) by pos * freq."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float64,
                                    device=x.device) / half)
    ang = pos.to(torch.float64)[:, None] * freqs
    sin, cos = torch.sin(ang).to(_F32)[:, None], torch.cos(ang).to(_F32)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(q, k, v, block: int = 512):
    """Causal softmax attention, query rows in blocks.  q: (S, H, D);
    k, v: (S, H, D) (already repeated to the query heads)."""
    s, h, d = q.shape
    qh, kh, vh = (t.permute(1, 0, 2) for t in (q, k, v))   # (H, S, D)
    out = torch.empty_like(qh)
    keys = torch.arange(s, device=q.device)
    for lo in range(0, s, block):
        hi = min(s, lo + block)
        sc = (qh[:, lo:hi] @ kh.transpose(1, 2)) / d ** 0.5   # (H, b, S)
        mask = keys[None, :] > torch.arange(lo, hi, device=q.device)[:, None]
        sc = sc.masked_fill(mask[None], float("-inf"))
        out[:, lo:hi] = torch.softmax(sc, dim=-1) @ vh
    return out.permute(1, 0, 2).reshape(s, h * d)


def _layer(x, w, m):
    s = x.shape[0]
    h, kvh, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    pos = torch.arange(s, device=x.device)
    n1 = act(rms_norm(x, w["mixer_norm"], m["norm_eps"]))
    q = act(qlinear(n1, w["wq"])).reshape(s, h, hd)
    k = act(qlinear(n1, w["wk"])).reshape(s, kvh, hd)
    v = act(qlinear(n1, w["wv"])).reshape(s, kvh, hd)
    q = act(_rope(q, pos, m["rope_theta"]))
    k = act(_rope(k, pos, m["rope_theta"]))
    rep = h // kvh
    k, v = k.repeat_interleave(rep, dim=1), v.repeat_interleave(rep, dim=1)
    x = act(x + act(qlinear(act(_attention(q, k, v)), w["wo"])))
    n2 = act(rms_norm(x, w["ffn_norm"], m["norm_eps"]))
    g = act(torch.nn.functional.silu(act(qlinear(n2, w["gate"]))))
    a = act(g * act(qlinear(n2, w["up"])))
    return act(x + act(qlinear(a, w["down"])))


@torch.no_grad()
def logits(weights: dict, m: dict, samples: list) -> list:
    """``samples``: ``(tokens (S,) long, first)`` pairs; returns each
    sample's float32 logits (S - first, V) at positions ``first..S-1``.
    Runs layer by layer over all samples, each layer's weights quantized
    once."""
    xs = [weights["embed"][t].to(_F32) for t, _ in samples]
    for i in range(m["n_layers"]):
        g = f"layers.{i}"
        w = {n: quantize_weight(weights[f"{g}.{n}"])
             for n in PROJECTIONS}
        w["mixer_norm"] = weights[f"{g}.mixer_norm"]
        w["ffn_norm"] = weights[f"{g}.ffn_norm"]
        xs = [_layer(x, w, m) for x in xs]
        del w
    head = (weights["embed"].t() if m.get("tie_embeddings", False)
            else weights["lm_head"]).to(_F32)
    return [act(rms_norm(x[first:], weights["final_norm"], m["norm_eps"]))
            @ head for x, (_, first) in zip(xs, samples)]
