"""Mamba2 (SSD: state-space duality) mixer block (port of
``repro.models.mamba``).

Prefill and training run the chunked SSD algorithm: quadratic,
attention-like math inside fixed-size chunks and a linear state
recurrence across them (the reference's ``lax.scan`` over chunks is a
Python loop here, in the same order).  Decode is the O(1) recurrence on
the (H, N, P) state: no cache grows with the sequence.

The parameter layout is the reference's: a fused ``in_proj`` producing
(z, x, B, C, dt), a depthwise causal conv over (x, B, C), per-head A, D
and dt-bias scalars (f32), a gated RMSNorm and ``out_proj``; both
projections are ``QuantLinear``s, so the quant modes run them through
the nibble kernel on the card.

Every cast of the reference is kept: the conv runs in f32 and returns to
the projection's dtype, the SSM state and the scan are f32, ``y`` returns
to the input dtype before the gated norm, and the cache holds ``conv`` in
bf16 and ``ssm`` in f32.  The reference's multi-operand einsums are
written as pairwise products in the order its ``jnp.einsum`` contracts
them (opt_einsum's ``optimal`` path at these shapes: see each product).
The conv is the reference's sum of ``conv_width`` shifted products, not a
cuDNN convolution (which runs TF32 unless told otherwise).  Nothing here
reads the device from the host, so a decode step captures into a CUDA
graph; :func:`mamba_step` writes the new state into the cache tensors in
place.

Tensor parallelism (:func:`mamba_cols_shards`): each shard runs its SSD
heads (its columns of z, x and dt, the B/C groups of its heads, its conv
channels and state; :class:`SSMDims` names the widths a call runs at),
the gated norm runs whole on each device over the shards' outputs
gathered in shard order, and the caller runs ``out_proj`` row-parallel
(over data rows with the batch-wide amax; a replicated mixer is
:func:`mamba_heads` then ``out_proj``).  Every batched
product and scan of the SSD runs in calls of one shape
(``layers.fixed_bmm``, ``layers.fixed_cumsum``), so a shard's heads
equal the unsharded call's bit for bit.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core.linear import linear_apply, linear_init
from repro_torch.distributed.collectives import all_gather, per_device
from repro_torch.distributed.sharding import ssm_segments
from repro_torch.models.layers import fixed_bmm, fixed_cumsum, rms_norm, \
    rms_norm_init

__all__ = ["mamba_init", "mamba_apply", "mamba_step", "init_mamba_cache",
           "mamba_heads", "mamba_cols_shards", "SSMDims", "ssm_dims"]


@dataclasses.dataclass(frozen=True)
class SSMDims:
    """The widths one mixer call runs at: the whole mixer, or one
    tensor-parallel shard's heads (``d_inner``, ``heads``), its B/C
    ``groups`` and, where it holds every group, the offset ``head_lo`` of
    its heads among the groups' repeated heads (``rep`` heads a group)."""
    d_inner: int
    heads: int
    head_dim: int
    groups: int
    state: int
    rep: int
    head_lo: int = 0

    @property
    def conv_ch(self) -> int:
        return self.d_inner + 2 * self.groups * self.state


def ssm_dims(cfg, seg=None) -> SSMDims:
    """The whole mixer's widths, or those of the shard whose pieces
    ``seg`` (``distributed.sharding.ssm_segments``) names."""
    rep = cfg.ssm_heads // cfg.ssm_groups
    if seg is None:
        return SSMDims(cfg.d_inner, cfg.ssm_heads, cfg.ssm_head_dim,
                       cfg.ssm_groups, cfg.ssm_state, rep)
    return SSMDims(seg.heads * cfg.ssm_head_dim, seg.heads,
                   cfg.ssm_head_dim, seg.groups, cfg.ssm_state, rep,
                   seg.head_lo - seg.group_lo * rep)


def mamba_init(cfg, *, generator, device) -> dict:
    """The reference's init rules: He-scaled projections, ``conv_w``
    normal x 0.1 in bf16, ``conv_b`` zeros, ``A_log = log(1..H)``, ``D``
    ones and ``dt_bias`` zeros in f32, a zero norm gain."""
    d = cfg.d_model
    dm = ssm_dims(cfg)
    d_in, h, conv_ch = dm.d_inner, dm.heads, dm.conv_ch
    kw = dict(generator=generator, device=device)
    proj_out = d_in + conv_ch + h            # z, x, B, C, dt
    in_proj = linear_init(d, proj_out, **kw)
    conv_w = (torch.randn((cfg.conv_width, conv_ch), dtype=torch.float32,
                          **kw) * 0.1).to(torch.bfloat16)
    return {
        "in_proj": in_proj,
        "conv_w": conv_w,
        "conv_b": torch.zeros((conv_ch,), dtype=torch.bfloat16,
                              device=device),
        "A_log": torch.log(torch.arange(1, h + 1, dtype=torch.float32,
                                        device=device)),
        "D": torch.ones((h,), dtype=torch.float32, device=device),
        "dt_bias": torch.zeros((h,), dtype=torch.float32, device=device),
        "norm": rms_norm_init(d_in, device),
        "out_proj": linear_init(d_in, d, **kw),
    }


def _split_proj(dm: SSMDims, proj):
    return torch.split(proj, [dm.d_inner, dm.conv_ch, dm.heads], dim=-1)


def _heads_bc(dm: SSMDims, t, lead):
    """B or C (..., groups * N) to the call's heads (..., heads, N): the
    groups repeated to their heads (``jnp.repeat``), then this call's
    heads among them."""
    t = _repeat_groups(t.reshape(*lead, dm.groups, dm.state), dm.rep)
    if t.shape[-2] != dm.heads:
        t = t[..., dm.head_lo:dm.head_lo + dm.heads, :]
    return t


def _causal_conv(xbc, conv_w, conv_b, carry=None):
    """Depthwise causal conv of width W in f32, back to ``xbc``'s dtype.
    ``carry``: the (B, W-1, C) history, or None (zeros).  Returns the
    output and the new history."""
    w = conv_w.shape[0]
    if carry is None:
        pad = xbc.new_zeros((xbc.shape[0], w - 1, xbc.shape[-1]))
    else:
        pad = carry.to(xbc.dtype)
    xp = torch.cat([pad, xbc], dim=1)
    s = xbc.shape[1]
    out = sum(xp[:, i:i + s] * conv_w[i][None, None, :] for i in range(w))
    out = F.silu((out + conv_b[None, None, :]).to(torch.float32))
    new_carry = xp[:, xp.shape[1] - (w - 1):] if w > 1 else pad
    return out.to(xbc.dtype), new_carry


def _softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` as JAX computes it."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


def _repeat_groups(t, rep: int):
    """``jnp.repeat(t, rep, axis=-2)`` from groups to heads (each group's
    row ``rep`` times in a row), as a view and a copy (capturable)."""
    *lead, g, n = t.shape
    return t[..., None, :].expand(*lead, g, rep, n).reshape(*lead, g * rep, n)


def _matmul(a, b):
    """``a @ b`` over equal leading (batch) dims through ``fixed_bmm``:
    every (slot, chunk, head) entry is summed in an order its shape fixes,
    whatever the number of heads beside it (a tensor-parallel shard's
    heads equal the unsharded call's bit for bit)."""
    out = fixed_bmm(a.reshape(-1, *a.shape[-2:]),
                    b.reshape(-1, *b.shape[-2:]))
    return out.reshape(*a.shape[:-2], *out.shape[-2:])


def _segsum(a):
    """Lower-triangular pairwise cumulative sums: out[..., i, j] =
    sum(a[..., j+1:i+1]), -inf above the diagonal.  a: (..., L)."""
    l = a.shape[-1]
    cum = fixed_cumsum(a)
    diff = cum[..., :, None] - cum[..., None, :]
    mask = torch.ones((l, l), dtype=torch.bool, device=a.device).tril()
    return diff.masked_fill(~mask, float("-inf"))


def _ssd_chunked(x, dt, a_coef, b_in, c_in, chunk):
    """Chunked SSD scan.

    x: (B,S,H,P); dt: (B,S,H) (post-softplus, f32); a_coef: (H,) negative;
    b_in/c_in: (B,S,H,N) (already broadcast from groups to heads).
    Returns y: (B,S,H,P) f32 and the final state (B,H,N,P) f32.
    """
    bsz, s, h, p = x.shape
    n = b_in.shape[-1]
    nc = s // chunk
    if s % chunk:
        raise ValueError(f"sequence {s} is not a whole number of chunks "
                         f"of {chunk}")

    def to_chunks(t):
        return t.reshape(bsz, nc, chunk, *t.shape[2:])

    xc, dtc, bc, cc = map(to_chunks, (x, dt, b_in, c_in))
    bc, cc = bc.to(torch.float32), cc.to(torch.float32)
    a = dtc * a_coef[None, None, None, :]            # (B,NC,L,H) log-decay
    a = a.permute(0, 1, 3, 2)                        # (B,NC,H,L)
    a_cum = fixed_cumsum(a)

    xdt = xc * dtc[..., None]                        # (B,NC,L,H,P) f32
    xdt_h = xdt.permute(0, 1, 3, 2, 4)               # (B,NC,H,L,P)
    c_h = cc.permute(0, 1, 3, 2, 4)                  # (B,NC,H,L,N)
    b_h = bc.permute(0, 1, 3, 4, 2)                  # (B,NC,H,N,L)

    # intra-chunk (diagonal) term, "bclhn,bcshn,bchls,bcshp->bclhp": C.B
    # over n, times the decay matrix, then over s with x*dt
    l_mat = torch.exp(_segsum(a))                    # (B,NC,H,L,L)
    scores = _matmul(c_h, b_h) * l_mat          # (B,NC,H,L,S)
    y_diag = _matmul(scores, xdt_h)             # (B,NC,H,L,P)

    # chunk-final states, "bcshn,bchs,bcshp->bchnp": x*dt times the decay
    # to the chunk's end, then B over s
    decay_to_end = torch.exp(a_cum[..., -1:] - a_cum)      # (B,NC,H,L)
    states = _matmul(b_h, xdt_h * decay_to_end[..., None])

    # inter-chunk recurrence, in chunk order; each chunk reads the state
    # entering it
    chunk_decay = torch.exp(a_cum[..., -1])          # (B,NC,H)
    prev = torch.zeros((bsz, h, n, p), dtype=torch.float32, device=x.device)
    entering = []
    for c in range(nc):
        entering.append(prev)
        prev = states[:, c] + chunk_decay[:, c, :, None, None] * prev
    prev_states = torch.stack(entering, dim=1)       # (B,NC,H,N,P)

    # inter-chunk (off-diagonal) output, "bclhn,bchnp,bchl->bclhp": the
    # reference contracts C with the states first where N >= P (mamba2),
    # and scales C by exp(a_cum) first where N < P (jamba)
    exp_cum = torch.exp(a_cum)[..., None]            # (B,NC,H,L,1)
    if n < p:
        y_off = _matmul(c_h * exp_cum, prev_states)
    else:
        y_off = _matmul(c_h, prev_states) * exp_cum
    y = (y_diag + y_off).permute(0, 1, 3, 2, 4).reshape(bsz, s, h, p)
    return y, prev


def _chunk_len(cfg, s: int) -> int:
    """The reference's rule: ``min(ssm_chunk, S)``, and the whole
    sequence as one chunk when S is not a multiple of it."""
    chunk = min(cfg.ssm_chunk, s)
    return s if s % chunk else chunk


def _gated(y, z, x):
    """``y * silu(z)`` in f32, back to ``x``'s dtype: the gated norm's
    input."""
    return (y * F.silu(z.to(torch.float32))).to(x.dtype)


def _norm_out(params, cfg, gated):
    """The gated norm over all of ``d_inner``, then ``out_proj``."""
    y = rms_norm(params["norm"], gated, cfg.norm_eps)
    return linear_apply(params["out_proj"], y, mode=cfg.quant_mode,
                        backend=cfg.quant_backend)


def _apply_heads(params, cfg, dm: SSMDims, x, *, return_cache: bool,
                 x_amax=None):
    """The SSD pass over the heads ``dm`` names, up to the gated norm:
    returns ``(gated (B, S, dm.d_inner), cache_or_None)``.  ``x_amax``:
    the batch-wide amax of ``x`` over data rows (int modes)."""
    bsz, s, _ = x.shape
    proj = linear_apply(params["in_proj"], x, mode=cfg.quant_mode,
                        backend=cfg.quant_backend, x_amax=x_amax)
    z, xbc, dt_raw = _split_proj(dm, proj)
    xbc, conv_carry = _causal_conv(xbc, params["conv_w"].to(torch.float32),
                                   params["conv_b"].to(torch.float32))

    gn = dm.groups * dm.state
    xs, b_in, c_in = torch.split(xbc, [dm.d_inner, gn, gn], dim=-1)
    xs = xs.reshape(bsz, s, dm.heads, dm.head_dim)
    b_in = _heads_bc(dm, b_in, (bsz, s))
    c_in = _heads_bc(dm, c_in, (bsz, s))

    dt = _softplus(dt_raw.to(torch.float32)
                   + params["dt_bias"][None, None, :])
    a_coef = -torch.exp(params["A_log"])

    y, final_state = _ssd_chunked(xs, dt, a_coef, b_in, c_in,
                                  _chunk_len(cfg, s))
    y = y + params["D"][None, None, :, None] * xs.to(torch.float32)
    gated = _gated(y.reshape(bsz, s, dm.d_inner), z, x)

    cache = None
    if return_cache:
        cache = {"conv": conv_carry.to(torch.bfloat16),
                 "ssm": final_state.to(torch.float32)}
    return gated, cache


def mamba_apply(params, cfg, x, *, return_cache: bool = False):
    """Full-sequence SSD pass.  x: (B, S, D).  Returns ``(out,
    cache_or_None)``; with ``return_cache`` (prefill) the cache holds the
    conv tail and the final SSM state for decode to continue from."""
    gated, cache = _apply_heads(params, cfg, ssm_dims(cfg), x,
                                return_cache=return_cache)
    return _norm_out(params, cfg, gated), cache


def init_mamba_cache(cfg, batch: int, device, dims: SSMDims | None = None
                     ) -> dict:
    """Per-slot decode state: the (B, W-1, C) conv history in bf16 and
    the (B, H, N, P) SSM state in f32 (a shard's channels and heads with
    its ``dims``)."""
    dm = dims or ssm_dims(cfg)
    return {"conv": torch.zeros((batch, cfg.conv_width - 1, dm.conv_ch),
                                dtype=torch.bfloat16, device=device),
            "ssm": torch.zeros((batch, dm.heads, dm.state, dm.head_dim),
                               dtype=torch.float32, device=device)}


def _step_heads(params, cfg, dm: SSMDims, x, cache, x_amax=None):
    """One decode step over the heads ``dm`` names, up to the gated norm;
    writes the new conv history and SSM state into ``cache`` in place."""
    bsz, s, _ = x.shape
    if s != 1:
        raise ValueError(f"a mamba decode step takes one token a slot, got "
                         f"{s}")
    h, p, n = dm.heads, dm.head_dim, dm.state
    proj = linear_apply(params["in_proj"], x, mode=cfg.quant_mode,
                        backend=cfg.quant_backend, x_amax=x_amax)
    z, xbc, dt_raw = _split_proj(dm, proj)
    xbc, conv_carry = _causal_conv(
        xbc, params["conv_w"].to(torch.float32),
        params["conv_b"].to(torch.float32), carry=cache["conv"])

    gn = dm.groups * n
    xs, b_in, c_in = torch.split(xbc[:, 0], [dm.d_inner, gn, gn], dim=-1)
    xs = xs.reshape(bsz, h, p).to(torch.float32)
    b_in = _heads_bc(dm, b_in, (bsz,)).to(torch.float32)
    c_in = _heads_bc(dm, c_in, (bsz,)).to(torch.float32)

    dt = _softplus(dt_raw[:, 0].to(torch.float32)
                   + params["dt_bias"][None, :])              # (B,H)
    a_coef = -torch.exp(params["A_log"])
    decay = torch.exp(dt * a_coef[None, :])                   # (B,H)

    # "bhn,bh,bhp->bhnp": dt meets x first where P < N (mamba2), B first
    # otherwise, as the reference's einsum pairs them
    if p < n:
        update = b_in[..., :, None] * (dt[..., None] * xs)[..., None, :]
    else:
        update = (b_in * dt[..., None])[..., :, None] * xs[..., None, :]
    state = decay[..., None, None] * cache["ssm"] + update
    y = _matmul(c_in[..., None, :], state)[..., 0, :] \
        + params["D"][None, :, None] * xs                     # (B,H,P)

    gated = _gated(y.reshape(bsz, 1, dm.d_inner), z, x)
    cache["conv"].copy_(conv_carry)
    cache["ssm"].copy_(state)
    return gated


def mamba_step(params, cfg, x, cache):
    """Single-token decode, the O(1) state update.  x: (B, 1, D).  The new
    conv history and SSM state are written into ``cache``'s tensors in
    place (a captured graph replays against them); returns ``(out,
    cache)``."""
    gated = _step_heads(params, cfg, ssm_dims(cfg), x, cache)
    return _norm_out(params, cfg, gated), cache


def mamba_heads(params, cfg, x, *, mode: str, cache=None, x_amax=None):
    """The whole mixer up to ``out_proj``: the SSD pass (``mode``
    "prefill" / "train") or one decode step (its state written in place),
    then the gated norm.  Returns ``(normed, cache_or_None)``; a data
    row's replicated mixer runs this and then ``out_proj`` with the
    batch-wide amax."""
    dm = ssm_dims(cfg)
    if mode == "decode":
        gated = _step_heads(params, cfg, dm, x, cache, x_amax)
    else:
        gated, cache = _apply_heads(params, cfg, dm, x, x_amax=x_amax,
                                    return_cache=(mode == "prefill"))
    return rms_norm(params["norm"], gated, cfg.norm_eps), cache


def mamba_cols_shards(ps: list, cfg, xs: list, layout, *, mode: str,
                      caches: list | None = None, x_amax=None):
    """The mixer over tensor-parallel shards split by SSD head
    (``layout.ssm_heads``) up to ``out_proj``: ``ps[s]`` holds shard
    ``s``'s pieces (``distributed.sharding.ssm_segments``), ``xs`` the
    replicated input, ``caches`` (decode) each shard's conv history and
    SSM state, ``x_amax`` the batch-wide amax over data rows (int modes).
    Each shard runs its heads (``mode`` "prefill" / "train": the SSD
    pass, "decode": one step, its state written in place); the gated
    norm needs all of ``d_inner``, so the shards' gated outputs are
    gathered in shard order and the norm runs whole once a device,
    exactly tp=1's.  Returns (each shard's columns of the normed output,
    the input of the row-parallel ``out_proj``; per-shard caches or
    Nones)."""
    gated, cs = [], []
    for i, (p, x) in enumerate(zip(ps, xs)):
        dm = ssm_dims(cfg, ssm_segments(cfg, layout, i))
        a = None if x_amax is None else x_amax[i]
        if mode == "decode":
            gated.append(_step_heads(p, cfg, dm, x, caches[i], a))
            cs.append(caches[i])
        else:
            g, c = _apply_heads(p, cfg, dm, x, x_amax=a,
                                return_cache=(mode == "prefill"))
            gated.append(g)
            cs.append(c)
    whole = all_gather(gated)
    devs = [x.device for x in xs]
    normed = per_device(devs, lambda i: rms_norm(ps[i]["norm"], whole[i],
                                                 cfg.norm_eps))
    cols = [n.narrow(-1, sum(g.shape[-1] for g in gated[:i]),
                     gated[i].shape[-1]) for i, n in enumerate(normed)]
    return cols, cs
