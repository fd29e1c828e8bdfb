"""Port parity for the serve engine: the port's ``Engine`` against the
reference ``Engine`` on one seed-pinned staggered workload (more requests
than slots, mixed prompt lengths and budgets, so slots refill mid-stream
next to older sequences), reduced yi-6b, greedy, ``attn_impl="flash"``,
in ``dense``, ``w8a8_nibble`` and ``lut`` (the reference on its ``xla``
LUT formula) over dense and paged caches.

Greedy streams must be equal token for token.  A divergence is accepted
only at an exact tie: the reference's logits at the diverging step, read
back from its own run, must rank the port's token within LOGIT_TOL of its
own top-1 (yi-6b's logits are bf16, so ties are common; the two packages'
logits agree to LOGIT_TOL, see test_torch_model.py).  In the integer
modes the activation scale is taken over the whole batch, so once one stream
diverges the others in its batch may follow; only the first divergence in
time is then held to the tie rule.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serve.engine as jengine
from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models import model_init
from repro_torch.configs import get_config, reduced
from repro_torch.models import load_jax_params
from repro_torch.serve import Engine, ServeConfig

torch.set_num_threads(1)

jmodel_init = jax.jit(model_init, static_argnums=1)

LOGIT_TOL = 0.08
SPEC = [(4, 6), (8, 3), (5, 7), (6, 1), (3, 5), (7, 4)]   # (prompt, new)


def _recorders(monkeypatch):
    """Wrap the reference engine's model calls so every prefill and decode
    step reports its inputs and logits back to the host, in order."""
    records = []
    orig_decode, orig_prefill = jengine.decode_step, jengine.prefill

    def decode_step(params, cfg, token, caches, index, **kw):
        logits, caches = orig_decode(params, cfg, token, caches, index,
                                     **kw)
        jax.debug.callback(
            lambda t, p, lg: records.append(
                ("decode", np.asarray(t)[:, 0], np.asarray(p),
                 np.asarray(lg, np.float32))),
            token, index, logits[:, -1], ordered=True)
        return logits, caches

    def prefill(params, cfg, tokens, **kw):
        out = orig_prefill(params, cfg, tokens, **kw)
        jax.debug.callback(
            lambda t, lg: records.append(
                ("prefill", np.asarray(t)[0], None,
                 np.asarray(lg, np.float32)[:, -1])),
            tokens, out[0], ordered=True)
        return out

    monkeypatch.setattr(jengine, "decode_step", decode_step)
    monkeypatch.setattr(jengine, "prefill", prefill)
    return records


def _reference_logits(records, prompt, stream, i):
    """(record index, logits row) with which the reference emitted
    ``stream[i]`` for this request."""
    p = len(prompt)
    for n, (kind, tok, pos, logits) in enumerate(records):
        if i == 0 and kind == "prefill" and np.array_equal(tok[:p], prompt):
            return n, logits[0]
        if i > 0 and kind == "decode":
            hit = np.nonzero((tok == stream[i - 1]) & (pos == p + i - 1)
                             & (logits.argmax(-1) == stream[i]))[0]
            if hit.size:
                return n, logits[hit[0]]
    raise AssertionError(f"no reference step emitted token {i}")


@pytest.mark.parametrize("mode", ["dense", "w8a8_nibble", "lut"])
@pytest.mark.parametrize("cache_mode", ["dense", "paged"])
def test_staggered_streams_match_reference(monkeypatch, mode, cache_mode):
    over = dict(quant_mode=mode, attn_impl="flash", cache_mode=cache_mode,
                page_size=4, n_layers=2)
    jcfg = jreduced(jget_config("yi-6b")).replace(**over)
    tcfg = reduced(get_config("yi-6b")).replace(**over)
    jparams = jmodel_init(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree_util.tree_map(
        lambda a: np.array(a.astype(jnp.float32)), jparams)
    tparams = load_jax_params(tree, tcfg, device="cpu")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, jcfg.vocab_size, p).astype(np.int32)
               for p, _ in SPEC]

    records = _recorders(monkeypatch)
    kw = dict(batch=3, max_len=24, prefill_len=8, decode_chunk=3)
    jeng = jengine.Engine(jcfg, jparams, jengine.ServeConfig(**kw))
    jids = [jeng.submit(p, n) for p, (_, n) in zip(prompts, SPEC)]
    jdone = jeng.run()
    teng = Engine(tcfg, tparams, ServeConfig(**kw), device="cpu")
    tids = [teng.submit(p, n) for p, (_, n) in zip(prompts, SPEC)]
    tdone = teng.run()
    assert teng.leaked_pages() == 0

    firsts = []          # (record index, reference margin, token index)
    for jid, tid, prompt, (_, n) in zip(jids, tids, prompts, SPEC):
        want, got = jdone[jid].tokens, tdone[tid].tokens
        assert len(got) == len(want) == n
        diff = [i for i in range(n) if want[i] != got[i]]
        if not diff:
            continue
        i = diff[0]
        rec, logits = _reference_logits(records, prompt, want, i)
        firsts.append((rec, logits[want[i]] - logits[got[i]], i))
    if not firsts:
        return
    firsts.sort()
    held = firsts[:1] if mode != "dense" else firsts
    for rec, margin, i in held:
        assert margin <= LOGIT_TOL, (
            f"streams diverge at token {i} where the reference's margin "
            f"is {margin} > {LOGIT_TOL}: not a tie")
