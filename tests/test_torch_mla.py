"""Port parity for multi-head latent attention (``mla_apply`` against
``repro.models.attention.mla_apply``) on reduced deepseek-v3 (4 heads,
q_lora 32, kv_lora 16, rope 8, nope 8, v 16), dense and ``w8a8_nibble``:
the full-sequence forward (chunked and flash), prefill then decode
against the dense slab, paged decode through a page table, and the
context prefill over cached latents; plus the reference's
``test_mla_cache_equivalence`` (decoding from the latent cache equals the
full pass) inside the port.

Tolerance OUT_ATOL = 0.08 (the model tests' LOGIT_ATOL): both packages
compute the same function, but XLA and torch round f32 ``sin``/``cos``/
``exp`` differently in the last ulp, which flips some bf16 (and in w8a8
some int8) roundings.  Exact: the cached latents of a dense prefill (no
RoPE before them).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models import attention as jattn
from repro_torch.configs import get_config, reduced
from repro_torch.models import attention as tattn

torch.set_num_threads(1)

OUT_ATOL = 0.08


def _cfgs(**over):
    return (jreduced(jget_config("deepseek-v3-671b")).replace(
        quant_backend="xla", **over),
        reduced(get_config("deepseek-v3-671b")).replace(**over))


def _to_torch(node):
    if isinstance(node, dict):
        return {k: _to_torch(v) for k, v in node.items()}
    t = torch.from_numpy(np.array(node.astype(jnp.float32)))
    return t if node.dtype == jnp.float32 else t.to(torch.bfloat16)


def _setup(mode="dense", impl="chunked"):
    jcfg, tcfg = _cfgs(quant_mode=mode, attn_impl=impl)
    jp = jattn.mla_init(jax.random.PRNGKey(0), jcfg)
    return jcfg, jp, tcfg, _to_torch(jp)


def _x(shape, seed=1):
    x = np.random.default_rng(seed).standard_normal(shape) * 0.5
    return (jnp.asarray(x, jnp.bfloat16),
            torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16))


def _pos(b, s, start=0):
    p = np.broadcast_to(np.arange(start, start + s)[None], (b, s)) \
        .astype(np.int32)
    return jnp.asarray(p), torch.from_numpy(p.copy()).long()


def _close(got, want, atol=OUT_ATOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=atol, rtol=0)


MODES = ["dense", "w8a8_nibble"]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("impl", ["chunked", "flash"])
def test_full_sequence_matches_reference(mode, impl):
    jcfg, jp, tcfg, tp = _setup(mode, impl)
    jx, tx = _x((2, 9, jcfg.d_model))
    jpos, tpos = _pos(2, 9)
    want, _ = jattn.mla_apply(jp, jcfg, jx, positions=jpos)
    got, cache = tattn.mla_apply(tp, tcfg, tx, positions=tpos)
    assert cache is None and got.shape == want.shape
    _close(got, want)


def test_flash_matches_chunked_in_port():
    _, _, tcfg, tp = _setup()
    _, tx = _x((2, 11, tcfg.d_model), seed=5)
    _, tpos = _pos(2, 11)
    a, _ = tattn.mla_apply(tp, tcfg, tx, positions=tpos)
    b, _ = tattn.mla_apply(tp, tcfg.replace(attn_impl="flash"), tx,
                           positions=tpos)
    np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                               atol=2e-2, rtol=0)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("paged", [False, True])
def test_prefill_then_decode_matches_reference(mode, paged):
    """Prefill 5 rows (latents handed back, exact), write them into a
    2-slot slab or page pools, then 3 decode steps at per-slot positions
    against the reference's same steps."""
    jcfg, jp, tcfg, tp = _setup(mode)
    b, s0, max_len, ps = 2, 5, 12, 4
    jx, tx = _x((b, s0 + 3, jcfg.d_model), seed=2)
    jpos, tpos = _pos(b, s0)
    jout, jc = jattn.mla_apply(jp, jcfg, jx[:, :s0], positions=jpos,
                               return_cache=True)
    tout, tc = tattn.mla_apply(tp, tcfg, tx[:, :s0], positions=tpos,
                               return_cache=True)
    _close(tout, jout)
    np.testing.assert_array_equal(
        tc["c_kv"].float().numpy(), np.asarray(jc["c_kv"].astype(jnp.float32)))
    _close(tc["k_rope"], jc["k_rope"], atol=2e-2)

    if paged:
        n_pages = b * max_len // ps + 1
        table = np.arange(1, n_pages).reshape(b, -1)[:, ::-1].astype(np.int32)
        jcache = jattn.init_paged_mla_cache(jcfg, n_pages, ps)
        tcache = tattn.init_paged_mla_cache(tcfg, n_pages, ps, "cpu")
        jtab, ttab = jnp.asarray(table), torch.from_numpy(table.copy())
        for key in ("c_kv", "k_rope"):
            for slot in range(b):
                jcache[key] = jattn.scatter_prefill_rows(
                    jcache[key], jc[key][slot:slot + 1], jtab[slot], 0)
                tattn.scatter_prefill_rows(
                    tcache[key], tc[key][slot:slot + 1], ttab[slot], 0)
    else:
        jtab = ttab = None
        jcache = jattn.init_mla_cache(jcfg, b, max_len)
        tcache = tattn.init_mla_cache(tcfg, b, max_len, "cpu")
        for key in ("c_kv", "k_rope"):
            jcache[key] = jcache[key].at[:, :s0].set(jc[key])
            tcache[key][:, :s0] = tc[key]
    for t in range(3):
        idx = np.array([s0 + t, s0 + t], np.int32)
        jout, jcache = jattn.mla_apply(
            jp, jcfg, jx[:, s0 + t:s0 + t + 1],
            positions=jnp.asarray(idx)[:, None], cache=jcache,
            cache_index=jnp.asarray(idx), page_table=jtab)
        tout, tcache = tattn.mla_apply(
            tp, tcfg, tx[:, s0 + t:s0 + t + 1],
            positions=torch.from_numpy(idx).long()[:, None], cache=tcache,
            cache_index=torch.from_numpy(idx).long(), page_table=ttab)
        _close(tout, jout)
    for key in ("c_kv", "k_rope"):
        _close(tcache[key], jcache[key], atol=2e-2)


@pytest.mark.parametrize("start", [0, 4])
def test_context_prefill_matches_reference(start):
    """A suffix at ``start`` over latents cached in pages: the reference's
    splice and the port's agree; ``start == 0`` equals the plain
    prefill of the port bit for bit."""
    jcfg, jp, tcfg, tp = _setup()
    s, ps = 8, 4
    jx, tx = _x((1, s, jcfg.d_model), seed=3)
    jpos, tpos = _pos(1, s)
    # cache the whole prompt's latents in pages 2, 1 (reversed order)
    _, jc = jattn.mla_apply(jp, jcfg, jx, positions=jpos, return_cache=True)
    _, tc = tattn.mla_apply(tp, tcfg, tx, positions=tpos, return_cache=True)
    table = np.array([2, 1, 0], np.int32)
    jpool = jattn.init_paged_mla_cache(jcfg, 4, ps)
    tpool = tattn.init_paged_mla_cache(tcfg, 4, ps, "cpu")
    for key in ("c_kv", "k_rope"):
        jpool[key] = jattn.scatter_prefill_rows(jpool[key], jc[key],
                                                jnp.asarray(table), 0)
        tattn.scatter_prefill_rows(tpool[key], tc[key],
                                   torch.from_numpy(table), 0)
    suffix = s - start
    jsx = jnp.concatenate([jx[:, start:], jnp.zeros_like(jx[:, :start])], 1)
    tsx = torch.cat([tx[:, start:], torch.zeros_like(tx[:, :start])], 1)
    jpos, tpos = _pos(1, s, start)
    jout, jnew = jattn.mla_apply(
        jp, jcfg, jsx, positions=jpos, cache=jpool, return_cache=True,
        page_table=jnp.asarray(table)[None], context_start=start)
    tout, tnew = tattn.mla_apply(
        tp, tcfg, tsx, positions=tpos, cache=tpool, return_cache=True,
        page_table=torch.from_numpy(table)[None],
        context_start=torch.tensor(start))
    _close(tout[:, :suffix], jout[:, :suffix])
    assert set(tnew) == {"c_kv", "k_rope"}
    if start == 0:
        plain, _ = tattn.mla_apply(tp, tcfg, tx, positions=_pos(1, s)[1])
        assert torch.equal(tout, plain)


def test_mla_cache_equivalence():
    """Decoding from the compressed latent cache equals the full pass
    (``tests/test_attention.py::test_mla_cache_equivalence`` in the port):
    the cache stores (c_kv, k_rope) only, K/V are re-expanded."""
    _, _, cfg, params = _setup()
    b, s = 1, 8
    _, x = _x((b, s, cfg.d_model), seed=6)
    pos = torch.arange(s)[None].expand(b, s)
    full, _ = tattn.mla_apply(params, cfg, x, positions=pos)
    out_pre, cache = tattn.mla_apply(params, cfg, x[:, :4],
                                     positions=pos[:, :4], return_cache=True)
    big = tattn.init_mla_cache(cfg, b, s, "cpu")
    big["c_kv"][:, :4] = cache["c_kv"]
    big["k_rope"][:, :4] = cache["k_rope"]
    outs = [out_pre.float()]
    for t in range(4, s):
        o, big = tattn.mla_apply(params, cfg, x[:, t:t + 1],
                                 positions=pos[:, t:t + 1], cache=big,
                                 cache_index=t)
        outs.append(o.float())
    got = torch.cat(outs, 1)
    np.testing.assert_allclose(got.numpy(), full.float().numpy(),
                               rtol=0.06, atol=0.06)


def test_mla_cache_is_compressed():
    """Per-token MLA cache values at full width: kv_lora + rope = 576,
    more than 40x fewer than full K/V (``test_mla_cache_is_compressed``)."""
    cfg = get_config("deepseek-v3-671b")
    c = tattn.init_paged_mla_cache(cfg.replace(kv_lora_rank=512), 2, 1,
                                   "cpu")
    per_tok = sum(v[0].numel() for v in c.values())
    assert per_tok == cfg.kv_lora_rank + cfg.qk_rope_dim == 576
    assert per_tok * 40 < 2 * cfg.n_heads * (cfg.qk_nope_dim
                                             + cfg.qk_rope_dim)
