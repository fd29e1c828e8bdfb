"""The system under test: ``repro_torch``'s serving engine, built from a
configuration file and the benchmark's seeded weights.

This is the one module of the benchmark that imports the program.  It
puts the raw weights into the program's parameter tree (the program
then quantizes them itself), builds the ``ServeConfig`` from the
configuration's serving knobs and the mix's slots and cache budget, and
reads the running requests back after the window.
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig, get_config
from repro_torch.models.transformer import prepare_params
from repro_torch.serve.engine import Engine, ServeConfig

__all__ = ["model_config", "build_engine", "running_requests"]

_PROJ = {"dense": ("wq", "wk", "wv", "wo"), "mlp": ("gate", "up", "down")}


def model_config(config: dict, model: dict, quant_mode: str | None = None
                 ) -> ModelConfig:
    """The program's ``ModelConfig``: its module for ``config["arch"]``
    with every size of ``model`` and the serving knobs that live on the
    model config set as the file states them."""
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    serve = config["serve"]
    kw = {k: v for k, v in model.items() if k in fields}
    for k in ("quant_mode", "quant_backend", "attn_impl", "cache_mode",
              "page_size"):
        kw[k] = serve[k]
    if quant_mode is not None:
        kw["quant_mode"] = quant_mode
    return get_config(config["arch"], **kw)


def _params(w: dict, cfg: ModelConfig, family: str) -> dict:
    layers = []
    for i in range(cfg.n_layers):
        g = f"layers.{i}."
        layer = {"mixer_norm": {"scale": w[g + "mixer_norm"]}}
        if family == "dense":
            layer["attn"] = {n: {"w": w[g + n]} for n in _PROJ["dense"]}
            layer["ffn_norm"] = {"scale": w[g + "ffn_norm"]}
            layer["mlp"] = {n: {"w": w[g + n]} for n in _PROJ["mlp"]}
        else:
            layer["mamba"] = {
                "in_proj": {"w": w[g + "in_proj"]},
                "out_proj": {"w": w[g + "out_proj"]},
                "norm": {"scale": w[g + "gate_norm"]},
                **{n: w[g + n] for n in ("conv_w", "conv_b", "A_log", "D",
                                         "dt_bias")}}
        layers.append(layer)
    params = {"embed": {"emb": w["embed"]}, "layers": layers,
              "final_norm": {"scale": w["final_norm"]}}
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": w["lm_head"]}
    return prepare_params(params, cfg)


def build_engine(config: dict, model: dict, mix, weights: dict, device,
                 quant_mode: str | None = None) -> Engine:
    cfg = model_config(config, model, quant_mode)
    serve = config["serve"]
    scfg = ServeConfig(batch=mix.slots, max_len=mix.max_len,
                       temperature=float(serve["temperature"]),
                       eos_id=int(serve["eos_id"]), prefill_len=0,
                       decode_chunk=int(serve["decode_chunk"]),
                       alloc_mode="reserve")
    params = _params(weights, cfg, config["reference"])
    return Engine(cfg, params, scfg, device=device)


def running_requests(engine: Engine) -> list:
    """The requests holding a slot.  The engine hands finished requests
    back (``drain``) but keeps running ones in its slots; this is the
    benchmark's one read of its private state."""
    return [r for r in engine._slots if r is not None]

