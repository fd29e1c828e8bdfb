"""Shared building blocks (port of ``repro.models.layers``).

Parameters are nested dicts of tensors, as in the reference; every
projection goes through ``repro_torch.core.linear``.  The vocab-parallel
embedding and logits take one tree per model shard (each holding its
slice of the vocabulary) and return the whole result on every shard.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensor

from repro_torch.core.linear import linear_apply, linear_init
from repro_torch.kernels.ops import costed, tensor_bytes
from repro_torch.distributed.collectives import all_gather, all_reduce_sum

__all__ = ["rms_norm_init", "rms_norm", "rope", "apply_rope", "mlp_init",
           "mlp_apply", "mlp_hidden", "embed_init", "embed_apply",
           "embed_logits", "bf16_matmul", "fixed_bmm", "fixed_cumsum",
           "fixed_mean",
           "entries_per_call",
           "vocab_parallel_embed", "vocab_parallel_logits",
           "vocab_parallel_argmax"]


def bf16_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of bf16 operands, summed in f32 and rounded once to
    ``a``'s dtype, as XLA's dot of bf16 operands.  On CUDA that is
    cuBLAS's bf16 GEMM.  On the CPU the operands go through f32: torch's
    bf16 CPU kernel sums K in another order than XLA's CPU dot (it moved
    reduced jamba's w8a8 logits by 0.0254 through one expert output one
    ulp off), and its f32 kernel sums as XLA does at the reduced shapes
    (the jamba logits then equal the reference's)."""
    if a.device.type == "cpu":
        return torch.matmul(a.to(torch.float32),
                            b.to(torch.float32)).to(a.dtype)
    return torch.matmul(a, b)


# f32 bytes of one ``fixed_bmm`` call's operands and result, at most
# (beyond ``_MIN_ENTRIES`` entries), the fewest and the most entries a
# call takes, and the rows of one ``fixed_cumsum`` call
_CALL_BYTES = 8 << 20
_MIN_ENTRIES = 4
_CALL_ENTRIES = 64
_SCAN_ROWS = 64
# the fewest rows of a ``fixed_mean`` call
_MEAN_ROWS = 16


def entries_per_call(m: int, k: int, n: int) -> int:
    """The entries of each ``fixed_bmm`` call at an (m, k) x (k, n)
    entry: the largest power of two from ``_MIN_ENTRIES`` up to
    ``_CALL_ENTRIES`` whose f32 operands and result fit ``_CALL_BYTES``
    (the fewest where one entry alone exceeds a quarter of it)."""
    per = 4 * (m * k + k * n + m * n)
    p = _MIN_ENTRIES
    while p < _CALL_ENTRIES and 2 * p * per <= _CALL_BYTES:
        p *= 2
    return p


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy where its first element is not 16-byte aligned (a
    fresh allocation's alignment, which the library may pick kernels
    by)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _in_fixed_calls(fn, p: int, *ts):
    """``fn(*ts)`` over the leading dimension of ``ts``, run as calls of
    exactly ``p`` contiguous entries each (the last call overlaps the one
    before it; fewer than ``p`` entries are zero-padded to ``p``), so
    every call has one shape whatever the entry count."""
    ts = [t.contiguous() for t in ts]
    total = ts[0].shape[0]
    if total < p:
        ts = [torch.cat([t, t.new_zeros((p - total,) + t.shape[1:])])
              for t in ts]
        return fn(*ts)[:total]
    outs = []
    for start in range(0, total, p):
        lo = min(start, total - p)
        outs.append(fn(*[_aligned(t[lo:lo + p]) for t in ts])[start - lo:])
    return outs[0] if len(outs) == 1 else torch.cat(outs)


def _bmm_cost(a, b):
    """The product's own work; the zero entries the fixed calls pad with
    are reported apart (no other route of the same attention runs
    them)."""
    n, m, k = a.shape
    per = m * k * b.shape[2]
    p = entries_per_call(m, k, b.shape[2])
    padding = (p * max(1, -(-n // p)) - n) * per
    out = n * m * b.shape[2] * a.element_size()
    return 0, n * per, tensor_bytes(a, b) + out, padding


class _FixedBmm(torch.autograd.Function):
    """``torch.bmm`` in fixed calls, its backward two more
    :func:`fixed_bmm` calls (so the gradients keep one sum order per
    entry too, and a static walk counts them by their cost)."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        if isinstance(a, FakeTensor):      # no values to order
            return torch.bmm(a, b)
        return _in_fixed_calls(torch.bmm,
                               entries_per_call(a.shape[1], a.shape[2],
                                                b.shape[2]), a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = fixed_bmm(g, b.transpose(1, 2)) if ctx.needs_input_grad[0] \
            else None
        gb = fixed_bmm(a.transpose(1, 2), g) if ctx.needs_input_grad[1] \
            else None
        return ga, gb


@costed(_bmm_cost)
def fixed_bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.bmm(a, b)`` for a (N, m, k) and b (N, k, n), in calls of
    ``entries_per_call(m, k, n)`` entries (``_in_fixed_calls``).  cuBLAS
    picks its batched-GEMM kernel, and with it the sum order, by the
    batch count too; here every entry is summed in the order its
    (m, k, n) fixes, so an entry's result does not depend on how many
    heads or slots share the batch (a tensor-parallel shard's heads equal
    the unsharded call's rows bit for bit).  Differentiable: the backward
    is two ``fixed_bmm`` calls.  Fake tensors (the dry run's) hold no
    values to order: one call gives the result's shape, and a walk counts
    this entry point by its cost alone."""
    return _FixedBmm.apply(a, b)


def fixed_cumsum(a: torch.Tensor) -> torch.Tensor:
    """``torch.cumsum(a, -1)`` in calls of ``_SCAN_ROWS`` rows
    (``_in_fixed_calls``): torch's CUDA scan shapes its thread block, and
    with it the sum order within a row, by the row count too, so a
    tensor-parallel shard's rows would leave the unsharded call's."""
    rows = a.reshape(-1, a.shape[-1])
    return _in_fixed_calls(lambda t: torch.cumsum(t, dim=-1), _SCAN_ROWS,
                           rows).reshape(a.shape)


def rms_norm_init(dim: int, device) -> dict:
    return {"scale": torch.zeros((dim,), dtype=torch.float32, device=device)}


def fixed_mean(a: torch.Tensor) -> torch.Tensor:
    """``torch.mean(a, -1, keepdim=True)`` where every row's sum order is
    one whatever the row count: a call of fewer than ``_MEAN_ROWS`` rows
    runs zero-padded to that many.  torch's CUDA reduction shapes its
    thread block by the number of outputs below 16 and keeps one shape
    from 16 up (``chip_smoke.py``'s ``check_fixed_mean`` holds this on the
    card at the models' widths), so without the pad a data row's slots
    would sum in another order than the whole batch's."""
    rows = a.reshape(-1, a.shape[-1])
    n = rows.shape[0]
    if n >= _MEAN_ROWS:
        return torch.mean(a, dim=-1, keepdim=True)
    padded = F.pad(rows, (0, 0, 0, _MEAN_ROWS - n))
    return torch.mean(padded, dim=-1, keepdim=True)[:n].reshape(
        a.shape[:-1] + (1,))


def rms_norm(params: dict, x: torch.Tensor, eps: float = 1e-6):
    """f32 RMSNorm with the reference's ``(1 + scale)`` gain; the mean of
    squares through :func:`fixed_mean`."""
    dtype = x.dtype
    x = x.to(torch.float32)
    var = fixed_mean(torch.square(x))
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + params["scale"])).to(dtype)


def rope(positions: torch.Tensor, head_dim: int, theta: float = 10_000.0):
    """(sin, cos) tables in f32 for integer positions, (..., head_dim//2)."""
    half = head_dim // 2
    # a fill, not a host-to-device copy, so a CUDA graph can capture it
    freqs = torch.pow(
        torch.full((), theta, dtype=torch.float32, device=positions.device),
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


def mlp_hidden(params: dict, x: torch.Tensor, *, act: str = "silu",
               quant_mode: str = "dense", quant_backend: str = "torch",
               x_amax=None):
    """The gated hidden state ``act(x @ gate) * (x @ up)``, activation in
    f32: the input of ``down`` (a column-parallel shard's slice of it).
    ``x_amax``: the batch-wide amax over data rows (int modes)."""
    kw = dict(mode=quant_mode, backend=quant_backend, x_amax=x_amax)
    g = linear_apply(params["gate"], x, **kw)
    u = linear_apply(params["up"], x, **kw)
    if act == "gelu":
        g = F.gelu(g.to(torch.float32), approximate="tanh").to(x.dtype)
    else:
        g = F.silu(g.to(torch.float32)).to(x.dtype)
    return g * u


def mlp_apply(params: dict, x: torch.Tensor, *, act: str = "silu",
              quant_mode: str = "dense", quant_backend: str = "torch"):
    """Gated MLP (SwiGLU / GeGLU), activation in f32."""
    return linear_apply(params["down"],
                        mlp_hidden(params, x, act=act, quant_mode=quant_mode,
                                   quant_backend=quant_backend),
                        mode=quant_mode, backend=quant_backend)


def embed_init(vocab: int, d_model: int, *, generator, device) -> dict:
    emb = torch.randn((vocab, d_model), generator=generator, device=device,
                      dtype=torch.float32) * 0.02
    return {"emb": emb.to(torch.bfloat16)}


def embed_apply(params: dict, tokens: torch.Tensor, *,
                scale_by_sqrt_dim: bool = False):
    x = params["emb"][tokens.long()]
    return _scale_embed(x) if scale_by_sqrt_dim else x


def _scale_embed(x):
    return x * torch.sqrt(torch.tensor(float(x.shape[-1]))).to(x.dtype)


def embed_logits(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Tied LM head: x @ emb^T with f32 accumulation and f32 output."""
    return torch.matmul(x.to(torch.float32),
                        params["emb"].to(torch.float32).t())


def vocab_parallel_embed(shards: list, tokens: list, *,
                         scale_by_sqrt_dim: bool = False) -> list:
    """Embedding lookup with the table split by vocab: shard ``s`` holds
    rows ``[s V/tp, (s + 1) V/tp)`` (``shards[s]["emb"]``) and looks up the
    tokens it owns, zeros elsewhere; the shards' rows are summed.  Exactly
    one shard adds a non-zero row for each token, so the sum is the
    unsharded lookup.  ``tokens`` is one copy per shard."""
    parts = []
    for s, (p, tok) in enumerate(zip(shards, tokens)):
        emb = p["emb"]
        local = tok.long() - s * emb.shape[0]
        hit = (local >= 0) & (local < emb.shape[0])
        rows = emb[torch.where(hit, local, torch.zeros_like(local))]
        parts.append(torch.where(hit[..., None], rows,
                                 torch.zeros_like(rows)))
    xs = all_reduce_sum(parts)
    return [_scale_embed(x) for x in xs] if scale_by_sqrt_dim else xs


def vocab_parallel_logits(shards: list, xs: list, *, tied: bool) -> list:
    """f32 logits with the head split by vocab: each shard's slice (the
    tied ``emb`` transposed, or an untied ``lm_head``'s columns through
    :func:`bf16_matmul`), gathered in shard order, so the vocabulary is
    in the unsharded order before an argmax or a sampler sees it."""
    if tied:
        parts = [embed_logits(p, x) for p, x in zip(shards, xs)]
    else:
        parts = [bf16_matmul(x, p["w"].to(x.dtype)).to(torch.float32)
                 for p, x in zip(shards, xs)]
    return all_gather(parts, dim=-1)


def vocab_parallel_argmax(parts: list) -> list:
    """The argmax over the whole vocabulary of logits split by vocab
    (``parts``: each shard's slice, in shard order), on every shard: each
    shard's maximum and its index (offset to the whole vocabulary) are
    gathered, and the first shard holding the largest maximum wins, so
    ties go to the lowest index, as ``torch.argmax`` of the whole
    logits."""
    offsets, start = [], 0
    for p in parts:
        offsets.append(start)
        start += p.shape[-1]
    best = [torch.max(p, dim=-1) for p in parts]
    vals = all_gather([b.values.unsqueeze(-1) for b in best])
    idx = all_gather([(b.indices + o).unsqueeze(-1)
                      for b, o in zip(best, offsets)])
    return [i.gather(-1, torch.argmax(v, dim=-1, keepdim=True)).squeeze(-1)
            for v, i in zip(vals, idx)]
