"""Port parity for the MoE block (``repro_torch.models.moe`` against
``repro.models.moe``'s local path): routing, the capacity rule, the sort
dispatch with drops, the shared expert and the aux loss, on reduced
deepseek-v3 (4 experts, top-2, a shared expert) and reduced llama4 (top-1),
with the shared expert dense and ``w8a8_nibble``.

Tolerances: routing equal, or where a token's chosen experts differ, the
reference's router probabilities of the two choices within ROUTE_TIE
(torch and XLA sum the f32 router product in different orders); outputs
within OUT_ATOL (bf16 outputs of |x| < 4: a few ulp); aux within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models import moe as jmoe
from repro_torch.configs import get_config, reduced
from repro_torch.models import moe as tmoe

torch.set_num_threads(1)

OUT_ATOL = 2e-2
AUX_ATOL = 1e-6
ROUTE_TIE = 1e-6

jmoe_apply = jax.jit(jmoe.moe_apply, static_argnums=1)
jroute = jax.jit(jmoe._route, static_argnums=1)


def _cfgs(arch, **over):
    return (jreduced(jget_config(arch)).replace(**over),
            reduced(get_config(arch)).replace(**over))


def _params(jcfg, seed=0):
    """Reference ``moe_init`` weights, and the same values as torch
    tensors (bf16 stacks, f32 router) for the port."""
    jp = jmoe.moe_init(jax.random.PRNGKey(seed), jcfg)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        t = torch.from_numpy(np.array(node.astype(jnp.float32)))
        return t if node.dtype == jnp.float32 else t.to(torch.bfloat16)

    return jp, conv(jp)


def _x(shape, seed=1, scale=0.5):
    x = np.random.default_rng(seed).standard_normal(shape) * scale
    return (jnp.asarray(x, jnp.bfloat16),
            torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16))


def _hold_routing(jp, jcfg, tp, tcfg, jx, tx):
    """Routing equal per token, or a tie in the reference's probs."""
    d = jx.shape[-1]
    jw, je, jaux = jroute(jp, jcfg, jx.reshape(-1, d))
    tw, te, taux = tmoe._route(tp, tcfg, tx.reshape(-1, d))
    je = np.sort(np.asarray(je), -1)
    te = np.sort(te.numpy(), -1)
    logits = np.asarray(jnp.dot(jx.reshape(-1, d),
                                jp["router"].astype(jnp.bfloat16),
                                preferred_element_type=jnp.float32))
    probs = np.asarray(jax.nn.softmax(logits, -1))
    for t in np.nonzero((je != te).any(-1))[0]:
        only_j = np.setdiff1d(je[t], te[t])
        only_t = np.setdiff1d(te[t], je[t])
        gap = np.abs(probs[t, only_j] - probs[t, only_t]).max()
        assert gap <= ROUTE_TIE, (t, je[t], te[t], gap)
    assert abs(float(taux) - float(jaux)) <= AUX_ATOL
    return int((je != te).any(-1).sum())


CASES = [("deepseek-v3-671b", "dense"), ("deepseek-v3-671b", "w8a8_nibble"),
         ("llama4-maverick-400b-a17b", "dense"),
         ("llama4-maverick-400b-a17b", "w8a8_nibble")]


@pytest.mark.parametrize("arch,mode", CASES)
def test_moe_apply_matches_reference(arch, mode):
    jcfg, tcfg = _cfgs(arch, quant_mode=mode)
    jcfg = jcfg.replace(quant_backend="xla")
    jp, tp = _params(jcfg)
    jx, tx = _x((2, 12, jcfg.d_model))
    _hold_routing(jp, jcfg, tp, tcfg, jx, tx)
    want, jaux = jmoe_apply(jp, jcfg, jx)
    got, aux = tmoe.moe_apply(tp, tcfg, tx)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=OUT_ATOL, rtol=0)
    assert abs(float(aux) - float(jaux)) <= AUX_ATOL


def test_moe_drops_match_reference_and_stay_finite():
    """Capacity factor 0.01 on 64 tokens: the floor of 8 rows an expert
    drops most assignments; the port drops the same ones (the stable
    sort keeps the earliest tokens) and stays finite."""
    jcfg, tcfg = _cfgs("deepseek-v3-671b", capacity_factor=0.01,
                       n_shared_experts=0)
    jp, tp = _params(jcfg, seed=3)
    jx, tx = _x((2, 32, jcfg.d_model), seed=2, scale=1.0)
    assert tmoe._capacity(tcfg, 64, tcfg.n_experts) == 8
    _hold_routing(jp, jcfg, tp, tcfg, jx, tx)
    want, _ = jmoe_apply(jp, jcfg, jx)
    got, _ = tmoe.moe_apply(tp, tcfg, tx)
    assert bool(torch.isfinite(got.float()).all())
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=OUT_ATOL, rtol=0)
    # most rows dropped: many tokens get nothing from the routed experts
    assert int((got.float().abs().sum(-1) == 0).sum()) > 0


@pytest.mark.parametrize("n_tokens,n_experts,top_k,factor,want", [
    (64, 4, 2, 1.25, 40),      # 2*64/4*1.25 (tests/test_moe_mamba.py)
    (1, 4, 2, 1.25, 8),        # the floor
    (128, 256, 8, 1.25, 8),    # deepseek-v3 prefill: int(5.0) -> floor
    (4096, 256, 8, 1.25, 160),
    (30, 7, 3, 1.1, 14),       # int() truncates 14.14
])
def test_capacity_formula(n_tokens, n_experts, top_k, factor, want):
    jcfg, tcfg = _cfgs("deepseek-v3-671b", top_k=top_k,
                       capacity_factor=factor)
    assert tmoe._capacity(tcfg, n_tokens, n_experts) == want
    assert jmoe._capacity(jcfg, n_tokens, n_experts) == want


def test_shared_expert_added():
    _, tcfg = _cfgs("deepseek-v3-671b")
    tp = tmoe.moe_init(tcfg, generator=torch.Generator().manual_seed(0),
                       device="cpu")
    _, tx = _x((1, 4, tcfg.d_model))
    with_shared, _ = tmoe.moe_apply(tp, tcfg, tx)
    no = dict(tp, shared={k: {"w": torch.zeros_like(v["w"])}
                          for k, v in tp["shared"].items()})
    without, _ = tmoe.moe_apply(no, tcfg, tx)
    assert float((with_shared.float() - without.float()).abs().max()) > 0
    assert tp["router"].dtype == torch.float32
    assert tp["w_gate"].dtype == torch.bfloat16
    assert tp["w_gate"].shape == (tcfg.n_experts, tcfg.d_model,
                                  tcfg.d_ff_expert)


def test_combine_is_deterministic():
    """Two calls give the same bits (the combine sums each token's rows
    in one fixed order, never by atomics)."""
    _, tcfg = _cfgs("deepseek-v3-671b")
    tp = tmoe.moe_init(tcfg, generator=torch.Generator().manual_seed(1),
                       device="cpu")
    _, tx = _x((3, 10, tcfg.d_model), seed=4, scale=1.0)
    a, aux_a = tmoe.moe_apply(tp, tcfg, tx)
    b, aux_b = tmoe.moe_apply(tp, tcfg, tx)
    assert torch.equal(a, b) and torch.equal(aux_a, aux_b)


def test_moe_matches_all_expert_oracle():
    """With ample capacity the block equals running every expert on every
    token and weighting by the router's top-k (the reference's oracle)."""
    _, tcfg = _cfgs("deepseek-v3-671b", capacity_factor=8.0,
                    n_shared_experts=0)
    tp = tmoe.moe_init(tcfg, generator=torch.Generator().manual_seed(2),
                       device="cpu")
    _, tx = _x((2, 8, tcfg.d_model))
    got, aux = tmoe.moe_apply(tp, tcfg, tx)
    xt = tx.reshape(-1, tcfg.d_model).float()
    top_w, top_e, _ = tmoe._route(tp, tcfg, tx.reshape(-1, tcfg.d_model))
    outs = torch.stack([
        (torch.nn.functional.silu(xt @ tp["w_gate"][e].float())
         * (xt @ tp["w_up"][e].float())) @ tp["w_down"][e].float()
        for e in range(tcfg.n_experts)], 1)
    w_full = torch.zeros((xt.shape[0], tcfg.n_experts))
    w_full.scatter_add_(1, top_e, top_w)
    ref = torch.einsum("te,ted->td", w_full, outs).reshape(got.shape)
    rel = float((got.float() - ref).norm() / ref.norm())
    assert rel < 0.05, rel
    assert float(aux) > 0
