"""Token sampling with index-derived keys (port of the reference's
``_sampler`` / ``_slot_sampler`` / ``_fold_counts`` / ``_TAG_*`` and the
temperature branch of its ``verify``, ``repro.serve.engine``).

The reference draws token ``i`` of request ``r`` from the key
``fold_in(fold_in(base_key, r.id), i)`` of JAX's default PRNG, threefry
2x32 with ``jax_threefry_partitionable=True``.  This module computes the
same keys and the same random bits with plain integer tensor ops, so the
port's sampled streams draw from the reference's noise, and nothing is
threaded through a decode loop: a draw is a function of (request key,
stream index) alone, which keeps sampled streams bit-stable under
evict-and-resume and lets a captured CUDA graph sample from per-slot key
and count buffers.

A key is an int64 tensor whose last axis holds JAX's two uint32 words
(values in ``[0, 2**32)``); leading axes batch keys, the way ``jax.vmap``
maps the reference's functions over slots.  The 32-bit arithmetic runs in
int64 masked to ``0xFFFFFFFF`` (no uint32 tensor type has the ops), the
same ops on the CPU and on the card.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["prng_key", "as_key", "threefry2x32", "fold_in", "random_bits",
           "uniform", "gumbel", "categorical", "softmax", "sample",
           "draft_sample", "spec_accept", "TAG_ACCEPT", "TAG_RESAMPLE",
           "TAG_DRAFT"]

# sub-draw tags folded below a stream-index key where one token index
# needs several independent draws (speculative decoding), as in the
# reference: no draw aliases another
TAG_ACCEPT = 1
TAG_RESAMPLE = 2
TAG_DRAFT = 3

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_TINY = float(np.finfo(np.float32).tiny)


def prng_key(seed: int) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` (threefry): ``[seed >> 32, seed &
    0xFFFFFFFF]`` as an int64 (2,) CPU tensor."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return torch.tensor([seed >> 32, seed & _MASK], dtype=torch.int64)


def as_key(rng) -> torch.Tensor:
    """A base key from an int seed or a (2,) array of uint32 words (a JAX
    key's data, e.g. ``np.asarray(jax.random.PRNGKey(s))``) or a key
    tensor."""
    if isinstance(rng, torch.Tensor):
        return rng.to(torch.int64)
    if isinstance(rng, (int, np.integer)):
        return prng_key(int(rng))
    key = torch.as_tensor(np.asarray(rng, np.uint32).astype(np.int64))
    if key.shape != (2,):
        raise ValueError(f"a key is two uint32 words, got shape "
                         f"{tuple(key.shape)}")
    return key


def _rotl(x, d: int):
    return ((x << d) | (x >> (32 - d))) & _MASK


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 hash of JAX's ``threefry2x32_p`` (20 rounds, key
    injection every 4): key words ``k0, k1`` and count words ``x0, x1``,
    int64 tensors of uint32 values that broadcast together; returns the
    two output words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def fold_in(keys, data):
    """``jax.random.fold_in`` over a batch of keys: ``keys`` (..., 2),
    ``data`` an int or an integer tensor that broadcasts against
    ``keys[..., 0]``.  JAX hashes the count pair ``[0, data]`` under the
    key and takes the two words as the new key."""
    if isinstance(data, torch.Tensor):
        data = data.to(torch.int64) & _MASK
    else:                 # a fill, not a host copy (legal in a graph)
        data = torch.full((), int(data) & _MASK, dtype=torch.int64,
                          device=keys.device)
    y0, y1 = threefry2x32(keys[..., 0], keys[..., 1],
                          torch.zeros_like(data), data)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def random_bits(keys, shape=()):
    """32 random bits per element of ``shape`` for each key (``keys``
    (*batch, 2) -> (*batch, *shape)): JAX's partitionable layout, the
    hash of the element's flat index split into (high, low) words, the
    two output words xor-ed."""
    shape = tuple(shape)
    idx = torch.arange(math.prod(shape), dtype=torch.int64,
                       device=keys.device).reshape(shape)
    lead = keys.shape[:-1] + (1,) * len(shape)
    y0, y1 = threefry2x32(keys[..., 0].reshape(lead),
                          keys[..., 1].reshape(lead), idx >> 32,
                          idx & _MASK)
    return y0 ^ y1


def uniform(keys, shape=(), minval: float = 0.0, maxval: float = 1.0):
    """``jax.random.uniform`` in f32: the top 23 bits as a mantissa of a
    float in [1, 2), minus 1, then scaled to [minval, maxval)."""
    bits = random_bits(keys, shape)
    f = (((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
         - 1.0)
    lo = np.float32(minval)
    span = float(np.float32(maxval) - lo)
    return torch.clamp(f * span + float(lo), min=float(lo))


def gumbel(keys, shape=()):
    """``jax.random.gumbel`` (f32, the default "low" mode):
    ``-log(-log(u))`` with ``u`` uniform on ``[tiny, 1)``."""
    return -torch.log(-torch.log(uniform(keys, shape, _TINY, 1.0)))


def categorical(keys, logits):
    """``jax.random.categorical`` over the last axis by the Gumbel-max
    trick: ``argmax(gumbel + logits)``.  A single key (2,) draws noise of
    ``logits``' whole shape, as the reference's unbatched call does; a
    batch of keys (*batch, 2) maps over ``logits``' leading axes, each key
    drawing noise of the remaining shape (``jax.vmap``)."""
    noise = gumbel(keys, logits.shape[keys.ndim - 1:])
    return torch.argmax(noise + logits, dim=-1)


def softmax(x):
    """``jax.nn.softmax`` over the last axis, in its order of operations."""
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def _scaled(logits, temperature: float):
    """f32 logits over the temperature, a true division by an f32 tensor
    (PyTorch's CUDA division by a Python scalar multiplies by its
    reciprocal, which can round otherwise)."""
    t = torch.full((), temperature, dtype=torch.float32,
                   device=logits.device)
    return logits.float() / t


def sample(logits, keys, temperature: float):
    """(..., V) logits -> (...) tokens: the argmax when ``temperature`` is
    0, else one categorical draw per key of ``keys`` (..., 2) from
    ``logits / temperature`` in f32 (the reference's ``_slot_sampler``)."""
    if temperature > 0.0:
        return categorical(keys, _scaled(logits, temperature))
    return torch.argmax(logits.float(), dim=-1)


def draft_sample(logits, keys, temperature: float):
    """One draft step's token and distribution (the reference's draft
    body): greedy, the argmax and a width-1 zero dummy (the verify's
    signature stays uniform); sampled, a draw under ``fold_in(keys,
    TAG_DRAFT)`` (``keys``: the slots' stream keys of this index) from
    ``logits / temperature`` and its softmax, which the verify needs for
    ``q(d)``."""
    if temperature <= 0.0:
        return (torch.argmax(logits.float(), dim=-1),
                logits.new_zeros((logits.shape[0], 1), dtype=torch.float32))
    lg = _scaled(logits, temperature)
    return categorical(fold_in(keys, TAG_DRAFT), lg), softmax(lg)


def spec_accept(logits, drafts, forced_on, dprobs, keys, counts,
                temperature: float):
    """The verify's decision (the reference's ``verify``): ``logits`` (B,
    k + 1, V) of the dense model at ``[token, drafts]``, ``drafts`` (B, k),
    ``forced_on`` (B, k) replayed drafts (committed history, force-
    accepted), ``dprobs`` (k, B, V) the draft's distributions (a width-1
    dummy when greedy), ``keys`` (B, 2) the slots' request keys and
    ``counts`` (B,) the stream index of ``drafts[:, 0]``.  Returns ``out``
    (B, k + 1), the accepted draft or the replacement at each position
    and then the bonus token, and ``accept`` (B, k).

    Greedy: a draft is accepted where it equals the dense argmax, which
    replaces it otherwise.  Sampled: rejection sampling; draft ``d`` at
    index ``i`` is accepted where ``u * q(d) <= p(d)``, ``u`` uniform
    under ``fold_in(key_i, TAG_ACCEPT)``; a rejection resamples from
    ``normalize(max(p - q, 0))`` (from ``p`` where that sums to 0) under
    ``fold_in(key_i, TAG_RESAMPLE)``; the bonus token is drawn from the
    last position's ``p`` under the stream key of index ``counts + k``."""
    k = drafts.shape[1]
    if temperature <= 0.0:
        g = torch.argmax(logits.float(), dim=-1)
        accept = forced_on | (drafts == g[:, :-1])
        out = torch.cat([torch.where(forced_on, drafts, g[:, :-1]),
                         g[:, -1:]], dim=1)
        return out, accept
    lg = _scaled(logits, temperature)
    p = softmax(lg)
    q = dprobs.transpose(0, 1)                               # (B, k, V)
    pd = torch.gather(p[:, :-1], -1, drafts[..., None])[..., 0]
    qd = torch.gather(q, -1, drafts[..., None])[..., 0]
    idx = counts[:, None].long() + torch.arange(k, device=drafts.device)
    step_keys = fold_in(keys[:, None, :], idx)               # (B, k, 2)
    u = uniform(fold_in(step_keys, TAG_ACCEPT))
    accept = forced_on | (u * qd <= pd)
    resid = torch.clamp(p[:, :-1] - q, min=0.0)
    rs = resid.sum(dim=-1, keepdim=True)
    resid = torch.where(rs > 0, resid / rs, p[:, :-1])
    corr = categorical(fold_in(step_keys, TAG_RESAMPLE),
                       torch.log(resid + 1e-30))
    bonus = categorical(fold_in(keys, counts.long() + k), lg[:, -1])
    out = torch.cat([torch.where(accept, drafts, corr), bonus[:, None]],
                    dim=1)
    return out, accept
