"""Shared building blocks (port of ``repro.models.layers``).

Parameters are nested dicts of tensors, as in the reference; every
projection goes through ``repro_torch.core.linear``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.linear import linear_apply, linear_init

__all__ = ["rms_norm_init", "rms_norm", "rope", "apply_rope", "mlp_init",
           "mlp_apply", "embed_init", "embed_apply", "embed_logits"]


def rms_norm_init(dim: int, device) -> dict:
    return {"scale": torch.zeros((dim,), dtype=torch.float32, device=device)}


def rms_norm(params: dict, x: torch.Tensor, eps: float = 1e-6):
    """f32 RMSNorm with the reference's ``(1 + scale)`` gain."""
    dtype = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + params["scale"])).to(dtype)


def rope(positions: torch.Tensor, head_dim: int, theta: float = 10_000.0):
    """(sin, cos) tables in f32 for integer positions, (..., head_dim//2)."""
    half = head_dim // 2
    freqs = torch.pow(
        torch.tensor(theta, dtype=torch.float32, device=positions.device),
        -torch.arange(0, half, dtype=torch.float32, device=positions.device)
        / half)
    angles = positions.to(torch.float32)[..., None] * freqs
    return torch.sin(angles), torch.cos(angles)


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor):
    """x: (..., S, H, D); sin/cos: (..., S, D/2) broadcast over heads.
    Returns f32."""
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    sin = sin[..., None, :]
    cos = cos[..., None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def mlp_init(d_model: int, d_ff: int, *, generator, device) -> dict:
    return {"gate": linear_init(d_model, d_ff, generator=generator,
                                device=device),
            "up": linear_init(d_model, d_ff, generator=generator,
                              device=device),
            "down": linear_init(d_ff, d_model, generator=generator,
                                device=device)}


def mlp_apply(params: dict, x: torch.Tensor, *, act: str = "silu",
              quant_mode: str = "dense", quant_backend: str = "torch"):
    """Gated MLP (SwiGLU / GeGLU), activation in f32."""
    g = linear_apply(params["gate"], x, mode=quant_mode,
                     backend=quant_backend)
    u = linear_apply(params["up"], x, mode=quant_mode, backend=quant_backend)
    if act == "gelu":
        g = F.gelu(g.to(torch.float32), approximate="tanh").to(x.dtype)
    else:
        g = F.silu(g.to(torch.float32)).to(x.dtype)
    return linear_apply(params["down"], g * u, mode=quant_mode,
                        backend=quant_backend)


def embed_init(vocab: int, d_model: int, *, generator, device) -> dict:
    emb = torch.randn((vocab, d_model), generator=generator, device=device,
                      dtype=torch.float32) * 0.02
    return {"emb": emb.to(torch.bfloat16)}


def embed_apply(params: dict, tokens: torch.Tensor, *,
                scale_by_sqrt_dim: bool = False):
    x = params["emb"][tokens.long()]
    if scale_by_sqrt_dim:
        x = x * torch.sqrt(torch.tensor(float(x.shape[-1]))).to(x.dtype)
    return x


def embed_logits(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Tied LM head: x @ emb^T with f32 accumulation and f32 output."""
    return torch.matmul(x.to(torch.float32),
                        params["emb"].to(torch.float32).t())
