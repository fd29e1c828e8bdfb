"""Temperature sampling in the port (``serve/sampling.py``), against the
installed JAX, and the reference's sampled contracts held inside the port.

* Bit for bit against ``jax.random`` under ``jax_threefry_partitionable``
  (JAX 0.9's default, set here by its context manager so nothing leaks
  into other test files): ``PRNGKey``, ``fold_in`` key words over a grid
  of request ids and stream indices, ``random_bits`` and ``uniform``.
* ``categorical`` on the same f32 logits (V 256 and 64000, 64 keys):
  equal tokens, except where JAX's own top two perturbed scores lie
  within 1e-6.  Gumbel noise within 2 ulp at the scale of ``max(|g|,
  1)``: each of its two ``log`` calls is within 1 ulp of XLA's, and
  ``-log(-log(u))`` near 0 turns that into an absolute, not a relative,
  error.
* ``spec_accept`` against a JAX transcription of the reference's verify
  decision (``src/repro/serve/engine.py:1085-1108``), greedy and sampled;
  the rejection sampler's output distribution is ``p`` (chi-square).
* ``make_serve_step`` (the reference's ``test_serve.py:90`` contract) and
  the engine's sampled contracts (``test_tail_latency.py:291``,
  ``test_spec_decode.py:111``, staggered against solo in ``dense``) on
  reduced yi-6b, CPU, plain kernel versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.models import decode_step, init_caches, model_init
from repro_torch.serve import Engine, ServeConfig, make_serve_step
from repro_torch.serve import sampling as S

torch.set_num_threads(1)

TAG_ACCEPT, TAG_RESAMPLE = 1, 2         # the reference's tags


@pytest.fixture
def partitionable():
    if not hasattr(jax, "threefry_partitionable"):
        pytest.skip("the installed JAX has no threefry_partitionable "
                    "context manager")
    with jax.threefry_partitionable(True):
        yield


def _words(key) -> np.ndarray:
    return np.asarray(key).astype(np.int64)


@pytest.mark.parametrize("seed", [0, 1, 42, 2**31 + 7, 2**32 - 1])
def test_fold_in_and_uniform_match_jax(partitionable, seed):
    base = jax.random.PRNGKey(seed)
    assert np.array_equal(S.prng_key(seed).numpy(), _words(base))
    assert torch.equal(S.as_key(np.asarray(base)), S.prng_key(seed))
    ids = [0, 1, 7, 1 << 20, 2**32 - 1]
    idx = [0, 1, 2, 31, 4096, 65535]
    req = S.fold_in(S.prng_key(seed)[None], torch.tensor(ids))   # (5, 2)
    stream = S.fold_in(req[:, None, :], torch.tensor(idx))       # (5, 6, 2)
    bits = S.random_bits(stream)
    u = S.uniform(stream)
    for a, rid in enumerate(ids):
        rkey = jax.random.fold_in(base, rid)
        assert np.array_equal(req[a].numpy(), _words(rkey))
        for b, i in enumerate(idx):
            key = jax.random.fold_in(rkey, i)
            assert np.array_equal(stream[a, b].numpy(), _words(key))
            assert int(bits[a, b]) == int(jax.random.bits(key, (),
                                                          jnp.uint32))
            assert float(u[a, b]) == float(jax.random.uniform(key, ()))


@pytest.mark.parametrize("shape", [(), (5,), (3, 4), (2, 3, 70)])
def test_random_bits_layout_matches_jax(partitionable, shape):
    key = jax.random.PRNGKey(3)
    want = np.asarray(jax.random.bits(key, shape, jnp.uint32))
    got = S.random_bits(S.prng_key(3), shape).numpy()
    assert got.shape == want.shape
    assert np.array_equal(got, want.astype(np.int64))
    lo = float(np.finfo(np.float32).tiny)
    assert np.array_equal(
        S.uniform(S.prng_key(3), shape, lo, 1.0).numpy(),
        np.asarray(jax.random.uniform(key, shape, minval=lo, maxval=1.0)))


@pytest.mark.parametrize("vocab", [256, 64000])
def test_categorical_matches_jax(partitionable, vocab):
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(5),
                                                 i))(jnp.arange(64))
    tkeys = torch.as_tensor(_words(keys))
    logits = (np.random.default_rng(vocab).standard_normal((64, vocab))
              * 3).astype(np.float32)
    noise = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (vocab,)))(
        keys))
    got_noise = S.gumbel(tkeys, (vocab,)).numpy()
    scale = np.spacing(np.maximum(np.abs(noise), 1.0).astype(np.float32))
    assert np.all(np.abs(got_noise - noise) <= 2 * scale)
    want = np.asarray(jax.vmap(jax.random.categorical)(
        keys, jnp.asarray(logits)))
    got = S.categorical(tkeys, torch.as_tensor(logits)).numpy()
    top2 = -np.sort(-(noise + logits), axis=-1)[:, :2]
    near = (top2[:, 0] - top2[:, 1]) <= 1e-6
    assert np.array_equal(got[~near], want[~near])


def test_unbatched_categorical_matches_jax(partitionable):
    """One key over a (B, V) batch (``make_serve_step``'s draw): the noise
    covers the whole batch by flat index, as JAX's unbatched call."""
    logits = np.random.default_rng(1).standard_normal((6, 300)) \
        .astype(np.float32)
    want = np.asarray(jax.random.categorical(jax.random.PRNGKey(9),
                                             jnp.asarray(logits)))
    got = S.categorical(S.prng_key(9), torch.as_tensor(logits)).numpy()
    assert np.array_equal(got, want)


def _jax_verify(lg, d, f_on, dprobs, keys, counts, k, temp):
    """The reference's verify decision (``src/repro/serve/engine.py``
    1085-1108), transcribed: ``lg`` (B, k+1, V) f32 dense logits, ``d``
    (B, k) drafts, ``f_on`` (B, k), ``dprobs`` (k, B, V)."""
    if temp <= 0.0:
        g = jnp.argmax(lg, axis=-1).astype(jnp.int32)
        accept = f_on | (d == g[:, :-1])
        out = jnp.concatenate([jnp.where(f_on, d, g[:, :-1]), g[:, -1:]],
                              axis=1)
        return out, accept
    p = jax.nn.softmax(lg / temp, axis=-1)
    q = jnp.moveaxis(dprobs, 0, 1)
    pd = jnp.take_along_axis(p[:, :-1], d[..., None], axis=-1)[..., 0]
    qd = jnp.take_along_axis(q, d[..., None], axis=-1)[..., 0]
    idx = counts[:, None] + jnp.arange(k)[None, :]
    step_keys = jax.vmap(lambda key, ii: jax.vmap(
        lambda i: jax.random.fold_in(key, i))(ii))(keys, idx)
    u = jax.vmap(jax.vmap(lambda sk: jax.random.uniform(
        jax.random.fold_in(sk, TAG_ACCEPT), ())))(step_keys)
    accept = f_on | (u * qd <= pd)
    resid = jnp.maximum(p[:, :-1] - q, 0.0)
    rs = jnp.sum(resid, axis=-1, keepdims=True)
    resid = jnp.where(rs > 0, resid / rs, p[:, :-1])
    corr = jax.vmap(jax.vmap(
        lambda sk, pr: jax.random.categorical(
            jax.random.fold_in(sk, TAG_RESAMPLE),
            jnp.log(pr + 1e-30))))(step_keys, resid)
    bonus = jax.vmap(jax.random.categorical)(
        jax.vmap(jax.random.fold_in)(keys, counts + k), lg[:, -1] / temp)
    out = jnp.concatenate([jnp.where(accept, d, corr.astype(jnp.int32)),
                           bonus.astype(jnp.int32)[:, None]], axis=1)
    return out, accept


@pytest.mark.parametrize("temp", [0.0, 0.8, 1.5])
def test_spec_accept_matches_jax(partitionable, temp):
    """Random drafts drawn from q, some forced; the last slot's draft
    distribution equals its dense one, so its residual sums to 0 and a
    rejection resamples from p."""
    b, k, v = 6, 4, 256
    rng = np.random.default_rng(int(temp * 10))
    lg = (rng.standard_normal((b, k + 1, v)) * 2).astype(np.float32)
    dlg = lg[:, :-1] + rng.standard_normal((b, k, v)).astype(np.float32)
    dlg[-1] = lg[-1, :-1]
    q = np.asarray(jax.nn.softmax(jnp.asarray(dlg) / (temp or 1.0),
                                  axis=-1))
    q64 = q.astype(np.float64) / q.astype(np.float64).sum(-1, keepdims=True)
    d = np.stack([[rng.choice(v, p=q64[i, j]) for j in range(k)]
                  for i in range(b)]).astype(np.int32)
    f_on = rng.random((b, k)) < 0.2
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(2),
                                                 i))(jnp.arange(b))
    counts = rng.integers(1, 50, b).astype(np.int32)
    dprobs = (np.ascontiguousarray(np.moveaxis(q, 1, 0)) if temp > 0
              else np.zeros((k, b, 1), np.float32))
    want = _jax_verify(jnp.asarray(lg), jnp.asarray(d), jnp.asarray(f_on),
                       jnp.asarray(dprobs), keys, jnp.asarray(counts), k,
                       temp)
    got = S.spec_accept(torch.as_tensor(lg), torch.as_tensor(d).long(),
                        torch.as_tensor(f_on), torch.tensor(dprobs),
                        torch.as_tensor(_words(keys)),
                        torch.as_tensor(counts), temp)
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))


def test_rejection_sampler_keeps_p():
    """Drafts from q, accepted where ``u q(d) <= p(d)`` and resampled from
    ``normalize(max(p - q, 0))`` otherwise: the first emitted token is
    distributed as p (V 8, 20000 independent keys, chi-square)."""
    n, v, temp = 20000, 8, 1.0
    rng = np.random.default_rng(0)
    p_logits = rng.standard_normal(v).astype(np.float32) * 1.5
    q_logits = rng.standard_normal(v).astype(np.float32) * 1.5
    p = S.softmax(torch.as_tensor(p_logits)).double().numpy()
    q = S.softmax(torch.as_tensor(q_logits))
    d = torch.as_tensor(rng.choice(v, size=n, p=q.double().numpy()
                                   / q.double().sum().item()))
    lg = torch.as_tensor(p_logits).expand(n, 2, v)
    keys = S.fold_in(S.prng_key(11)[None], torch.arange(n))
    out, accept = S.spec_accept(lg, d[:, None], torch.zeros((n, 1), dtype=torch.bool),
                                q.expand(1, n, v), keys,
                                torch.zeros(n, dtype=torch.int64), temp)
    assert 0.0 < accept.float().mean().item() < 1.0
    counts = np.bincount(out[:, 0].numpy(), minlength=v)
    _, pval = scipy.stats.chisquare(counts, n * p / p.sum())
    assert pval > 1e-3


# ---------------------------------------------------------------------------
# make_serve_step and the engine's sampled contracts
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model():
    cfg = reduced(get_config("yi-6b"))
    return cfg, model_init(cfg, device="cpu")


def test_serve_step_greedy_is_argmax(model):
    cfg, params = model
    step = make_serve_step(cfg, ServeConfig(batch=2, max_len=16))
    tok = torch.tensor([[3], [5]])
    caches = init_caches(cfg, 2, 16, device="cpu")
    nxt, _ = step(params, caches, tok, torch.tensor([0, 2]), 0)
    lg, _ = decode_step(params, cfg, tok, init_caches(cfg, 2, 16,
                                                      device="cpu"),
                        torch.tensor([0, 2]))
    assert torch.equal(nxt[:, 0], torch.argmax(lg[:, -1], dim=-1))


def test_temperature_sampling_varies(model):
    """``test_serve.py:90``: at temperature 5 the step's token varies over
    8 seeds, and so does the engine's first token (the prefill's draw goes
    through the same sampler)."""
    cfg, params = model
    scfg = ServeConfig(batch=1, max_len=16, temperature=5.0)
    step = make_serve_step(cfg, scfg)
    outs = set()
    for s in range(8):
        t, _ = step(params, init_caches(cfg, 1, 16, device="cpu"),
                    torch.zeros((1, 1), dtype=torch.int64), 2, s)
        outs.add(int(t[0, 0]))
    assert len(outs) > 1
    engine = Engine(cfg, params, scfg, device="cpu")
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (1, 6))
    firsts = {int(engine.generate(prompts, 2, rng=s)[0, 6])
              for s in range(8)}
    assert len(firsts) > 1


def test_serve_step_refuses_paged(model):
    cfg, _ = model
    with pytest.raises(ValueError, match="paged"):
        make_serve_step(cfg, ServeConfig(batch=1, max_len=16,
                                         cache_mode="paged", page_size=4))


def _scfg(**over):
    kw = dict(batch=3, max_len=16, prefill_len=8, decode_chunk=3,
              cache_mode="paged", page_size=4, temperature=0.7)
    kw.update(over)
    return ServeConfig(**kw)


def _prompts(vocab, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lens]


def _drive(cfg, params, prompts, budgets, scfg, arrivals=None):
    engine = Engine(cfg, params, scfg, device="cpu")
    arrivals = arrivals or [0.0] * len(prompts)
    ids = [engine.submit(p, n, arrival=a)
           for p, n, a in zip(prompts, budgets, arrivals)]
    done = engine.run()
    return engine, [done[i].tokens for i in ids]


@pytest.mark.parametrize("quant", ["dense", "w8a8_nibble"])
def test_sampled_streams_stable_under_replay_and_swap(model, quant):
    """``test_tail_latency.py:291``: an overcommitted pool preempts; the
    replay engine and the swap engine draw the same sampled streams as
    each other and, in ``dense`` (rows independent), as an uncontended
    pool."""
    cfg, params = model
    prompts = _prompts(cfg.vocab_size, (4, 6, 5, 7), seed=6)
    budgets = [8] * 4
    _, want = _drive(cfg, params, prompts, budgets, _scfg(quant_mode=quant))
    replay, got = _drive(cfg, params, prompts, budgets, _scfg(
        quant_mode=quant, alloc_mode="incremental", num_pages=7))
    swap, got_swap = _drive(cfg, params, prompts, budgets, _scfg(
        quant_mode=quant, alloc_mode="incremental", num_pages=7,
        swap_mode="host"))
    assert replay.stats["preemptions"] >= 1 and swap.stats["swap_in"] >= 1
    assert got_swap == got
    if quant == "dense":
        assert got == want
    assert replay.leaked_pages() == 0 and swap.leaked_pages() == 0


def test_sampled_staggered_matches_solo_dense(model):
    """Staggered arrivals into a shared batch draw, in ``dense``, the
    stream each request draws alone under the same request id."""
    cfg, params = model
    prompts = _prompts(cfg.vocab_size, (4, 7, 5), seed=8)
    scfg = _scfg(quant_mode="dense", cache_mode="dense", page_size=None,
                 batch=2)
    _, got = _drive(cfg, params, prompts, [6, 6, 6], scfg,
                    arrivals=[0.0, 0.002, 0.004])
    for rid, p in enumerate(prompts):
        solo = Engine(cfg, params, scfg, device="cpu")
        solo._next_id = rid              # the same request key
        i = solo.submit(p, 6)
        assert solo.run()[i].tokens == got[rid]


def test_spec_temperature_drains_and_accounts(model):
    """``test_spec_decode.py:111``: rejection sampling drains, leaks
    nothing, every emitted token but the prefill firsts came from a
    round, and the acceptance rate is a rate."""
    cfg, params = model
    prompts = _prompts(cfg.vocab_size, (5, 3, 6), seed=5)
    engine, got = _drive(cfg, params, prompts, [6, 6, 6], _scfg(
        temperature=0.8, alloc_mode="incremental", spec_decode=True,
        spec_k=3, spec_quant_mode="w8a8_nibble"))
    assert all(len(t) == 6 for t in got)
    assert engine.leaked_pages() == 0
    assert engine.spec_tokens == 15        # 18 emitted - 3 prefill firsts
    assert 0.0 <= engine.stats["acceptance_rate"] <= 1.0
    assert engine.compile_counts == {"prefill": 1, "decode_chunk": 0,
                                     "draft": 1, "verify": 1}
