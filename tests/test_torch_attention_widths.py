"""Port parity for attention at every head width the kernels take (head
dims up to 256, any d, zero-padded) and any paged group size.

* The wrappers' zero padding: the plain forward, backward and paged
  decode on heads zero-padded as the CUDA wrappers pad them, sliced back,
  equal the unpadded plain results (f32, atol/rtol 1e-6: zero columns add
  exact zeros, the matmuls may only block the sums differently).
* Parity with the reference at the new widths: ``ops.flash_mha`` forward
  and gradients against ``repro.kernels.ops.flash_mha`` (interpret-mode
  Pallas) at d = 256 and d = 192 / dv = 128, and ``ops.paged_flash_decode``
  at G = 32, with the tolerances of test_torch_kernels.py and
  test_torch_train.py (f32 1e-5; bf16 outputs atol 2e-2, bf16 gradients
  2e-2 relative norm).
* Rows with no key in their window: the plain forward averages all
  values with lse -1e30, as the reference kernel does, and the plain
  backward takes p = 1 on every key there, as the reference backward
  does.
* The dv product's split of p into bf16 hi + lo halves (the backward
  kernel's design) stays within 1e-4 relative norm of the f32 product.
* ``bwd_width``: the backward's instance is the narrowest that holds d
  and dv.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops

torch.set_num_threads(1)

F32_TOL = 1e-5
BF16_ATOL = 2e-2
BF16_GRAD_RTOL = 2e-2
PAD_TOL = 1e-6
SPLIT_RTOL = 1e-4


def _rng(seed):
    return np.random.default_rng(seed)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _attn_inputs(seed, bkv, group, s, d, dv):
    r = _rng(seed)
    bh = bkv * group
    q = r.standard_normal((bh, s, d)).astype(np.float32)
    k = r.standard_normal((bkv, s, d)).astype(np.float32)
    v = r.standard_normal((bkv, s, dv)).astype(np.float32)
    do = r.standard_normal((bh, s, dv)).astype(np.float32)
    return q, k, v, do


WIDTHS = [dict(d=20, dv=20), dict(d=192, dv=128), dict(d=256, dv=256)]


@pytest.mark.parametrize("w", WIDTHS)
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (5, 20.0)])
def test_padded_heads_equal_unpadded_plain(w, window, softcap):
    """The forward and backward on heads padded as the wrappers pad them
    (the forward to multiples of 8, the backward to its instance's
    width), sliced back, equal the unpadded results."""
    d, dv = w["d"], w["dv"]
    q, k, v, do = (torch.from_numpy(a) for a in
                   _attn_inputs(d + dv + window, 2, 2, 11, d, dv))
    kw = dict(scale=d ** -0.5, causal=True, window=window, softcap=softcap,
              group=2)
    o, lse = fa.flash_attention_fwd_plain(q, k, v, **kw)
    d8, dv8 = fa._round8(d), fa._round8(dv)
    op, lsep = fa.flash_attention_fwd_plain(
        fa.pad_heads(q, d8), fa.pad_heads(k, d8), fa.pad_heads(v, dv8), **kw)
    assert op.shape == (4, 11, dv8)
    torch.testing.assert_close(op[..., :dv], o, atol=PAD_TOL, rtol=PAD_TOL)
    assert not op[..., dv:].any()
    torch.testing.assert_close(lsep, lse, atol=PAD_TOL, rtol=PAD_TOL)

    dmat = (do * o).sum(-1)
    want = fa.flash_attention_bwd_plain(q, k, v, lse, do, dmat, **kw)
    width = fa.bwd_width(d, dv)
    assert width >= max(d, dv) and width in fa.BWD_WIDTHS
    got = fa.flash_attention_bwd_plain(
        *(fa.pad_heads(t, width) for t in (q, k, v)), lse,
        fa.pad_heads(do, width), dmat, **kw)
    for name, g, ref, n in zip(("dq", "dk", "dv"), got, want, (d, d, dv)):
        assert g.shape[-1] == width
        torch.testing.assert_close(g[..., :n], ref, atol=PAD_TOL,
                                   rtol=PAD_TOL, msg=name)
        assert not g[..., n:].any(), name


def _paged_inputs(seed, b=3, kvh=2, g=2, d=16, dv=16, ps=4, per_slot=5):
    r = _rng(seed)
    num_pages = b * per_slot + 1
    kp = r.standard_normal((num_pages, ps, kvh, d)).astype(np.float32)
    vp = r.standard_normal((num_pages, ps, kvh, dv)).astype(np.float32)
    q = r.standard_normal((b, 1, kvh * g, d)).astype(np.float32)
    q_pos = r.integers(0, per_slot * ps, b).astype(np.int32)
    perm = r.permutation(np.arange(1, num_pages)).reshape(b, per_slot)
    table = np.zeros((b, per_slot), np.int32)       # trash page past live
    for i in range(b):
        live = q_pos[i] // ps + 1
        table[i, :live] = perm[i, :live]
    return q, kp, vp, table, q_pos


@pytest.mark.parametrize("w", WIDTHS)
def test_paged_padded_heads_equal_unpadded_plain(w):
    d, dv = w["d"], w["dv"]
    q, kp, vp, table, q_pos = (torch.from_numpy(a) for a in
                               _paged_inputs(d, d=d, dv=dv))
    b, _, h, _ = q.shape
    qg = q.reshape(b, 2, h // 2, d)
    kw = dict(scale=d ** -0.5, window=0, softcap=0.0)
    want = fa.paged_decode_attention_plain(qg, kp, vp, table, q_pos, **kw)
    d8, dv8 = fa._round8(d), fa._round8(dv)
    got = fa.paged_decode_attention_plain(
        fa.pad_heads(qg, d8), fa.pad_heads(kp, d8), fa.pad_heads(vp, dv8),
        table, q_pos, **kw)
    torch.testing.assert_close(got[..., :dv], want, atol=PAD_TOL,
                               rtol=PAD_TOL)
    assert not got[..., dv:].any()


@pytest.mark.parametrize("w", [dict(d=256, dv=256), dict(d=192, dv=128)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_mha_wide_heads_match_reference(w, dtype):
    """Forward and gradients of ``ops.flash_mha`` at the widths the
    kernels gained, against the reference (which pads them to 256)."""
    d, dv = w["d"], w["dv"]
    q, k, v, do = _attn_inputs(d + dv, 1, 2, 9, d, dv)
    args = (d ** -0.5, True, 0, 0.0, 2)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))

    def jloss(q, k, v):
        o = jops.flash_mha(q, k, v, *args, True)
        return jnp.sum(o.astype(jnp.float32) * jnp.asarray(do)), o

    (_, jo), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                         has_aux=True)(
        *(jnp.asarray(a, jdt) for a in (q, k, v)))
    leaves = [torch.from_numpy(a).to(tdt).requires_grad_(True)
              for a in (q, k, v)]
    o = ops.flash_mha(*leaves, *args)
    assert o.shape == (2, 9, dv) and o.dtype == tdt
    got = torch.autograd.grad((o.float() * torch.from_numpy(do)).sum(),
                              leaves)
    o = o.detach().float().numpy()
    jo = np.asarray(jo.astype(jnp.float32))
    if dtype == "f32":
        np.testing.assert_allclose(o, jo, atol=F32_TOL, rtol=F32_TOL)
    else:
        np.testing.assert_allclose(o, jo, atol=BF16_ATOL)
    for name, g, ref in zip("qkv", got, jgrads):
        assert g.dtype == tdt and g.shape == ref.shape, name
        g = g.float().numpy()
        ref = np.asarray(ref.astype(jnp.float32))
        if dtype == "f32":
            np.testing.assert_allclose(g, ref, atol=F32_TOL, rtol=F32_TOL,
                                       err_msg=f"d{name}")
        else:
            assert _rel(g, ref) <= BF16_GRAD_RTOL, (name, _rel(g, ref))


@pytest.mark.parametrize("causal,sq,sk,window", [(False, 100, 40, 20),
                                                  (True, 60, 40, 8)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_plain_forward_matches_reference_on_rows_with_no_key(causal, sq, sk,
                                                             window, dtype):
    """Rows with no key in their window (q >= Sk + window - 1): the
    reference kernel (interpret-mode Pallas, blocks dividing Sq and Sk)
    averages all Sk values there, with lse -1e30, and so does the plain
    version that the CUDA kernels are held to."""
    from repro.kernels.flash_attention import flash_attention_fwd_pallas
    r = _rng(sq + window)
    q = r.standard_normal((4, sq, 16)).astype(np.float32)
    k, v = (r.standard_normal((2, sk, 16)).astype(np.float32)
            for _ in range(2))
    kw = dict(scale=0.25, causal=causal, window=window, softcap=0.0,
              group=2)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    jo, jlse = flash_attention_fwd_pallas(
        *(jnp.asarray(a, jdt) for a in (q, k, v)), bq=20, bk=40,
        interpret=True, **kw)
    o, lse = fa.flash_attention_fwd_plain(
        *(torch.from_numpy(a).to(tdt) for a in (q, k, v)), **kw)
    jo = np.asarray(jo.astype(jnp.float32))
    jlse = np.asarray(jlse)
    no_key = np.arange(sq) >= sk + window - 1
    assert no_key.any() and (jlse[:, no_key] == np.float32(-1e30)).all()
    np.testing.assert_array_equal(lse.numpy()[:, no_key], jlse[:, no_key])
    np.testing.assert_allclose(lse.numpy(), jlse, atol=F32_TOL, rtol=0)
    atol = F32_TOL if dtype == "f32" else BF16_ATOL
    np.testing.assert_allclose(o.float().numpy(), jo, atol=atol)
    mean = np.asarray(jnp.asarray(v, jdt).astype(jnp.float32)).mean(1)
    np.testing.assert_allclose(jo[:, no_key],
                               np.repeat(mean, 2, 0)[:, None].repeat(
                                   no_key.sum(), 1), atol=atol)


@pytest.mark.parametrize("causal,sq,sk,window", [(False, 100, 40, 20),
                                                  (True, 60, 40, 8)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_plain_backward_matches_reference_on_rows_with_no_key(causal, sq, sk,
                                                              window, dtype):
    """Rows with no key in their window (q >= Sk + window - 1) have lse
    -1e30, so the reference backward (interpret-mode Pallas, blocks
    dividing Sq and Sk) recomputes p = 1 on every key there, and those
    rows add to dq, dk and dv.  The plain backward, which the CUDA kernels
    are held to, gives the same gradients (f32 1e-5; bf16 2e-2 relative
    norm, as the gradients above)."""
    from repro.kernels.flash_attention import (flash_attention_bwd_pallas,
                                               flash_attention_fwd_pallas)
    r = _rng(sq + window + 1)
    group = 2
    q, do = (r.standard_normal((4, sq, 16)).astype(np.float32)
             for _ in range(2))
    k, v = (r.standard_normal((2, sk, 16)).astype(np.float32)
            for _ in range(2))
    kw = dict(scale=0.25, causal=causal, window=window, softcap=0.0,
              group=group)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    jq, jk, jv, jdo = (jnp.asarray(a, jdt) for a in (q, k, v, do))
    jo, jlse = flash_attention_fwd_pallas(jq, jk, jv, bq=20, bk=40,
                                          interpret=True, **kw)
    jdq, jdk_h, jdv_h = flash_attention_bwd_pallas(
        jq, jk, jv, jo, jlse, jdo, bq=20, bk=40, interpret=True, **kw)
    jdk = np.asarray(jdk_h).reshape(2, group, sk, 16).sum(1)
    jdv = np.asarray(jdv_h).reshape(2, group, sk, 16).sum(1)
    jdq = np.asarray(jdq)
    no_key = np.arange(sq) >= sk + window - 1
    assert no_key.any() and (np.asarray(jlse)[:, no_key] == -1e30).all()
    # those rows carry gradient in the reference: the case is not vacuous
    assert np.abs(jdq[:, no_key]).max() > 0.1
    o32 = np.asarray(jo.astype(jnp.float32))
    dmat = (np.asarray(jdo.astype(jnp.float32)) * o32).sum(-1)
    got = fa.flash_attention_bwd_plain(
        *(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
        torch.from_numpy(np.array(jlse)),
        torch.from_numpy(do).to(tdt), torch.from_numpy(dmat), **kw)
    for name, g, ref in zip(("dq", "dk", "dv"), got, (jdq, jdk, jdv)):
        g = g.numpy()
        assert g.shape == ref.shape, name
        if dtype == "f32":
            np.testing.assert_allclose(g, ref, atol=F32_TOL, rtol=F32_TOL,
                                       err_msg=name)
        else:
            assert _rel(g, ref) <= BF16_GRAD_RTOL, (name, _rel(g, ref))
        if name == "dq":
            assert _rel(g[:, no_key], ref[:, no_key]) <= (
                F32_TOL if dtype == "f32" else BF16_GRAD_RTOL)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_paged_decode_group_32_matches_reference(dtype):
    q, kp, vp, table, q_pos = _paged_inputs(32, b=2, kvh=1, g=32)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    want = np.asarray(jops.paged_flash_decode(
        jnp.asarray(q, jdt), jnp.asarray(kp, jdt), jnp.asarray(vp, jdt),
        jnp.asarray(table), jnp.asarray(q_pos), scale=0.25,
        interpret=True).astype(jnp.float32))
    got = ops.paged_flash_decode(
        torch.from_numpy(q).to(tdt), torch.from_numpy(kp).to(tdt),
        torch.from_numpy(vp).to(tdt), torch.from_numpy(table),
        torch.from_numpy(q_pos), scale=0.25)
    assert got.shape == want.shape == (2, 1, 32, 16)
    if dtype == "f32":
        np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL,
                                   rtol=F32_TOL)
    else:
        np.testing.assert_allclose(got.float().numpy(), want, atol=BF16_ATOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dv_split_of_p_into_bf16_halves(seed):
    """The backward kernel's dv product: p (f32) split as p_hi = bf16(p),
    p_lo = bf16(p - p_hi), each times bf16 do, summed in f32, against the
    f32 product, on random causal inputs at the training shape's head
    width."""
    r = _rng(seed)
    bh, s, d = 4, 96, 128
    q, k, v, do = (torch.from_numpy(r.standard_normal((bh, s, d))
                                    .astype(np.float32)).bfloat16()
                   for _ in range(4))
    _, lse = fa.flash_attention_fwd_plain(q, k, v, scale=d ** -0.5)
    s_, _ = fa._scores(q, k, scale=d ** -0.5, causal=True, window=0,
                       softcap=0.0)
    p = torch.exp(s_ - lse[..., None])
    do32 = do.float()
    want = torch.matmul(p.double().transpose(1, 2), do32.double())
    hi = p.bfloat16().float()
    lo = (p - hi).bfloat16().float()
    split = (torch.matmul(hi.transpose(1, 2), do32)
             + torch.matmul(lo.transpose(1, 2), do32))
    err = ((split.double() - want).norm() / want.norm()).item()
    assert err <= SPLIT_RTOL, err
    # p rounded to bf16 alone (the forward's cast) is far outside it
    hi_only = torch.matmul(hi.transpose(1, 2), do32).double()
    assert ((hi_only - want).norm() / want.norm()).item() > 10 * err


@pytest.mark.parametrize("d,dv,width", [
    (128, 128, 128), (8, 8, 64), (64, 64, 64), (65, 64, 128), (100, 100, 128),
    (192, 128, 256), (128, 192, 256), (256, 256, 256), (20, 20, 64)])
def test_bwd_width_is_the_narrowest_instance(d, dv, width):
    assert fa.bwd_width(d, dv) == width


def test_bwd_width_refuses_heads_above_256():
    with pytest.raises(ValueError, match="256"):
        fa.bwd_width(264, 128)
