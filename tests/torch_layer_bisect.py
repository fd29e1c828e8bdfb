"""Layer-by-layer comparison of the port's model with the reference's: a
test utility (no tests here).

``reference_prefix_outputs`` compiles each prefix of the reference's
layer stack (the embedding, then layers ``0..i``) on its own with
``test_torch_model.exact_jit`` and returns the hidden state after each;
``port_layer_outputs`` runs the port's layers one at a time and returns
the same states.  ``first_difference`` names the first layer whose
output differs and by how much.  Both sides run the layers of the
unrolled list (the reference's through ``unstack_jax_tree``), so a
prefix, block or suffix layer is addressed by its index alone.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import test_torch_model as tm
from repro.models import transformer as jtr
from repro_torch.models import transformer as ttr
from repro_torch.models import unstack_jax_tree


def reference_layers(jp, jcfg):
    """The reference's per-layer parameter trees, in layer order."""
    return unstack_jax_tree(jp, jcfg, lambda _k, v: v)["layers"]


def _positions(b, s):
    return jnp.broadcast_to(jnp.arange(s)[None, :], (b, s))


def reference_prefix_outputs(jp, jcfg, tokens, mode="prefill"):
    """Hidden states (float32 numpy) after layers 0, 1, ...: prefix ``i``
    is one program, compiled without excess precision."""
    layers = reference_layers(jp, jcfg)
    specs = jcfg.layer_specs
    outs = []
    for i in range(len(layers)):
        def prefix(embed, lps, toks, n=i + 1):
            x = jtr._embed_inputs({"embed": embed}, jcfg, toks, None)
            pos = _positions(*toks.shape)
            for p, spec in zip(lps[:n], specs[:n]):
                x, _, _ = jtr._layer_apply(p, jcfg, spec, x, positions=pos,
                                           mode=mode)
            return x

        x = tm.exact_jit(prefix)(jp["embed"], layers[:i + 1],
                                 jnp.asarray(tokens))
        outs.append(np.asarray(x.astype(jnp.float32)))
    return outs


def port_layer_outputs(params, cfg, tokens, mode="prefill"):
    """The port's hidden states after each layer, one layer at a time."""
    toks = torch.as_tensor(np.asarray(tokens)).long()
    x = ttr._embed_inputs(params, cfg, toks)
    b, s = toks.shape
    pos = torch.broadcast_to(torch.arange(s)[None, :], (b, s))
    outs = []
    with torch.no_grad():
        for p, spec in zip(params["layers"], cfg.layer_specs):
            x, _, _ = ttr._layer_apply(p, cfg, spec, x, positions=pos,
                                       mode=mode)
            outs.append(x.float().numpy())
    return outs


def first_difference(got, want):
    """(index, max |got - want|) of the first differing state, or None."""
    for i, (a, b) in enumerate(zip(got, want)):
        err = float(np.abs(a - b).max())
        if err:
            return i, err
    return None
