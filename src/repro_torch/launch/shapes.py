"""The dry run's input-shape grid and its input builders (port of
``repro.launch.shapes``).

``ShapeCase``, ``SHAPES``, ``skip_reason`` and ``runnable`` are the
reference's.  The builders make the inputs of one cell with the
reference's shapes and dtypes on ``device``: called under
``torch._subclasses.fake_tensor.FakeTensorMode`` (as the dry run calls
them) they are fake tensors, which allocate nothing; outside it, zeros.
The caches come from the port's ``init_caches`` (one device) or
``init_shard_caches`` (a mesh's entries).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig

__all__ = ["SHAPES", "ShapeCase", "runnable", "skip_reason",
           "train_input_structs", "decode_input_structs",
           "prefill_input_structs"]


@dataclasses.dataclass(frozen=True)
class ShapeCase:
    name: str
    kind: str          # train | prefill | decode
    seq: int
    batch: int


SHAPES = {
    "train_4k": ShapeCase("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeCase("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeCase("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeCase("long_500k", "decode", 524_288, 1),
}

# long_500k requires sub-quadratic attention: runs for the SSM and the
# hybrid (jamba: only 1-in-8 layers hold KV); skipped for the 8 archs
# with periodic full-attention layers (DESIGN.md §6).
_LONG_OK = {"mamba2-780m", "jamba-v0.1-52b"}


def skip_reason(cfg: ModelConfig, case: ShapeCase) -> str | None:
    if case.name == "long_500k" and cfg.name not in _LONG_OK:
        return ("full-attention layers present: 500k dense KV decode is "
                "the mandated sub-quadratic skip (DESIGN.md §6)")
    return None


def runnable(cfg: ModelConfig, case: ShapeCase) -> bool:
    return skip_reason(cfg, case) is None


def _stub(cfg: ModelConfig, batch: int, device) -> dict:
    """A VLM's patch embeddings or an encoder-decoder's frames, bf16."""
    out = {}
    if cfg.family == "vlm":
        out["patch_embeds"] = torch.zeros(
            (batch, cfg.n_patches, cfg.d_model), dtype=torch.bfloat16,
            device=device)
    if cfg.is_encdec:
        out["frames"] = torch.zeros((batch, cfg.enc_seq_len, cfg.d_model),
                                    dtype=torch.bfloat16, device=device)
    return out


def train_input_structs(cfg: ModelConfig, case: ShapeCase,
                        device="meta") -> dict:
    b, s = case.batch, case.seq
    batch = {"tokens": torch.zeros((b, s), dtype=torch.int32, device=device),
             "labels": torch.zeros((b, s), dtype=torch.int32, device=device)}
    batch.update(_stub(cfg, b, device))
    return batch


def prefill_input_structs(cfg: ModelConfig, case: ShapeCase,
                          device="meta") -> dict:
    out = {"tokens": torch.zeros((case.batch, case.seq), dtype=torch.int32,
                                 device=device)}
    out.update(_stub(cfg, case.batch, device))
    return out


def decode_input_structs(cfg: ModelConfig, case: ShapeCase, device="meta",
                         params=None) -> dict:
    """Decode cells: one new token against a ``seq``-long cache, per
    entry of ``params`` (``Shards``, its data rows laid out under the
    reference's mesh semantics, which the dry run serves in) where given,
    else on ``device``; an encoder-decoder's ``enc_out`` beside it."""
    from repro_torch.models import init_caches
    from repro_torch.models.transformer import init_shard_caches
    caches = (init_shard_caches(cfg, case.batch, case.seq, params,
                                semantics="mesh")
              if params is not None
              else init_caches(cfg, case.batch, case.seq, device=device))
    out = {"token": torch.zeros((case.batch, 1), dtype=torch.int32,
                                device=device),
           "caches": caches,
           "index": torch.zeros((), dtype=torch.int32, device=device)}
    if cfg.is_encdec:
        out["enc_out"] = torch.zeros((case.batch, cfg.enc_seq_len,
                                      cfg.d_model), dtype=torch.bfloat16,
                                     device=device)
    return out
