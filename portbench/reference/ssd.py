"""Plain reference of an attention-free Mamba-2 stack (SSD, state
space duality: arXiv:2405.21060).

Each layer: ``x += Wout gnorm(ssd(conv(Win n(x))) * silu(z))``.  ``Win``
gives ``z``, the conv input ``(x, B, C)`` and ``dt``; a depthwise causal
conv of the configuration's width with bias, then SiLU; ``dt =
softplus(dt + dt_bias)``, ``A = -exp(A_log)`` per head; the SSD output
``y_i = sum_{j <= i} exp(sum_{k=j+1..i} dt_k A) (C_i . B_j) dt_j x_j +
D x_i``, computed here in its quadratic (attention-like) form over the
whole sequence, with the cumulative decays summed in float64; the gated
RMSNorm ``gnorm`` over the inner width; a tied head.  B and C are shared
by the heads of a group.  ``Win`` and ``Wout`` run through
:func:`quant.qlinear` (int8 weights per output channel, int8 activations
per tensor), as served; the embedding, the conv and the head stay
unquantized.  Arithmetic is float32 (the SSD state and scan too);
activations are stored in bf16 between operations (``dense.act``), as
the configuration states.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.dense import act, rms_norm
from portbench.reference.quant import qlinear, quantize_weight
from portbench.weights import Leaf

__all__ = ["weight_layout", "logits"]

_F32 = torch.float32


def _dims(m: dict) -> dict:
    d_in = m["ssm_expand"] * m["d_model"]
    heads = d_in // m["ssm_head_dim"]
    gn = m["ssm_groups"] * m["ssm_state"]
    return dict(d_in=d_in, heads=heads, gn=gn, conv_ch=d_in + 2 * gn)


def weight_layout(m: dict) -> list[Leaf]:
    d, v, w = m["d_model"], m["vocab_size"], m["conv_width"]
    k = _dims(m)
    proj = k["d_in"] + k["conv_ch"] + k["heads"]
    out = [Leaf("embed", (v, d), "normal", 0.02)]
    for i in range(m["n_layers"]):
        g = f"layers.{i}"
        out += [
            Leaf(f"{g}.mixer_norm", (d,), "zeros", dtype=_F32),
            Leaf(f"{g}.in_proj", (d, proj), "normal",
                 (2.0 / (d + proj)) ** 0.5, group=g),
            Leaf(f"{g}.conv_w", (w, k["conv_ch"]), "normal", 0.1, group=g),
            Leaf(f"{g}.conv_b", (k["conv_ch"],), "zeros"),
            Leaf(f"{g}.A_log", (k["heads"],), "log_uniform", dtype=_F32,
                 lo=1.0, hi=16.0),
            Leaf(f"{g}.D", (k["heads"],), "ones", dtype=_F32),
            Leaf(f"{g}.dt_bias", (k["heads"],), "dt_bias", dtype=_F32,
                 lo=1e-3, hi=1e-1),
            Leaf(f"{g}.gate_norm", (k["d_in"],), "zeros", dtype=_F32),
            Leaf(f"{g}.out_proj", (k["d_in"], d), "normal",
                 (2.0 / (k["d_in"] + d)) ** 0.5, group=g),
        ]
    out.append(Leaf("final_norm", (d,), "zeros", dtype=_F32))
    return out


def _ssd(xs, dt, a_coef, b, c, block: int = 512):
    """xs: (S, H, P); dt: (S, H); a_coef: (H,); b, c: (S, H, N).
    Returns y: (S, H, P) without the D term."""
    s = xs.shape[0]
    cum = torch.cumsum(dt.to(torch.float64) * a_coef.to(torch.float64),
                       dim=0).t()                                  # (H, S)
    xdt = (xs * dt[..., None]).permute(1, 0, 2)                    # (H, S, P)
    bh, ch = b.permute(1, 0, 2), c.permute(1, 0, 2)                # (H, S, N)
    y = torch.empty_like(xdt)
    keys = torch.arange(s, device=xs.device)
    for lo in range(0, s, block):
        hi = min(s, lo + block)
        seg = cum[:, lo:hi, None] - cum[:, None, :]                # (H, b, S)
        later = keys[None, :] > torch.arange(lo, hi, device=xs.device)[:, None]
        decay = torch.exp(seg.masked_fill(later[None], float("-inf"))).to(_F32)
        y[:, lo:hi] = ((ch[:, lo:hi] @ bh.transpose(1, 2)) * decay) @ xdt
    return y.permute(1, 0, 2)


def _layer(x, w, m, k):
    s = x.shape[0]
    h, p, n = k["heads"], m["ssm_head_dim"], m["ssm_state"]
    rep = h // m["ssm_groups"]
    proj = act(qlinear(act(rms_norm(x, w["mixer_norm"], m["norm_eps"])),
                       w["in_proj"]))
    z, xbc, dt_raw = torch.split(proj, [k["d_in"], k["conv_ch"], h], dim=-1)
    cw = w["conv_w"].to(_F32)
    width = cw.shape[0]
    xp = torch.cat([xbc.new_zeros((width - 1, xbc.shape[1])), xbc])
    conv = sum(xp[i:i + s] * cw[i] for i in range(width))
    conv = act(F.silu(conv + w["conv_b"].to(_F32)))
    xs, b, c = torch.split(conv, [k["d_in"], k["gn"], k["gn"]], dim=-1)
    xs = xs.reshape(s, h, p)
    b = b.reshape(s, -1, n).repeat_interleave(rep, dim=1)
    c = c.reshape(s, -1, n).repeat_interleave(rep, dim=1)
    dt = F.softplus(dt_raw + w["dt_bias"])
    y = _ssd(xs, dt, -torch.exp(w["A_log"]), b, c) + w["D"][:, None] * xs
    gated = act(y.reshape(s, k["d_in"]) * F.silu(z))
    out = act(qlinear(act(rms_norm(gated, w["gate_norm"], m["norm_eps"])),
                      w["out_proj"]))
    return act(x + out)


@torch.no_grad()
def logits(weights: dict, m: dict, samples: list) -> list:
    """As :func:`portbench.reference.dense.logits`."""
    k = _dims(m)
    xs = [weights["embed"][t].to(_F32) for t, _ in samples]
    for i in range(m["n_layers"]):
        g = f"layers.{i}"
        w = {name: weights[f"{g}.{name}"] for name in (
            "mixer_norm", "conv_w", "conv_b", "A_log", "D", "dt_bias",
            "gate_norm")}
        w["in_proj"] = quantize_weight(weights[f"{g}.in_proj"])
        w["out_proj"] = quantize_weight(weights[f"{g}.out_proj"])
        xs = [_layer(x, w, m, k) for x in xs]
        del w
    head = weights["embed"].t().to(_F32)
    return [act(rms_norm(x[first:], weights["final_norm"], m["norm_eps"]))
            @ head for x, (_, first) in zip(xs, samples)]
