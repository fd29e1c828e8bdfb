"""Training launcher (port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b \\
        --steps 200 --seq 256 --batch 8 --quant qat [--reduced | --full] \\
        [--device cuda]

``--reduced`` (the default) runs the smoke-scale variant of the arch;
``--full`` the published widths.  A VLM (phi-3-vision-4.2b) trains on
stub patch embeddings and an encoder-decoder (whisper-base) on stub
frames: N(0, 1) x 0.02 in bf16 from a ``torch.Generator`` seeded with the
step (the reference draws them from ``PRNGKey(step)``; the values
differ, the rule is the same).  Runs on the CUDA device unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, reduced
from repro_torch.data import DataConfig
from repro_torch.optim import AdamWConfig
from repro_torch.train import TrainConfig
from repro_torch.train.trainer import Trainer, TrainerConfig


def stub_extras(cfg, batch: int, device="cuda"):
    """``extra_batch_fn`` for a VLM (``patch_embeds`` (B, n_patches, D))
    or an encoder-decoder (``frames`` (B, enc_seq_len, D)), else None:
    N(0, 1) x 0.02 in bf16, drawn on ``device`` from a generator seeded
    with the step."""
    if cfg.family == "vlm":
        key, rows = "patch_embeds", cfg.n_patches
    elif cfg.is_encdec:
        key, rows = "frames", cfg.enc_seq_len
    else:
        return None
    device = resolve_device(device)

    def extra(step):
        gen = torch.Generator(device=device).manual_seed(step)
        x = torch.randn((batch, rows, cfg.d_model), generator=gen,
                        device=device, dtype=torch.bfloat16)
        return {key: x * 0.02}
    return extra


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--quant", default="dense", choices=["dense", "qat"])
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    cfg = cfg.replace(quant_mode=args.quant)

    tcfg = TrainConfig(
        optimizer=AdamWConfig(lr=args.lr),
        microbatches=args.microbatches,
        total_steps=args.steps,
        warmup_steps=max(1, args.steps // 10),
    )
    rcfg = TrainerConfig(steps=args.steps,
                         checkpoint_dir=args.checkpoint_dir,
                         checkpoint_every=args.checkpoint_every)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                      global_batch=args.batch)

    trainer = Trainer(cfg, tcfg, rcfg, dcfg,
                      stub_extras(cfg, args.batch, args.device),
                      device=args.device)
    history = trainer.run()

    first, last = history[0]["loss"], history[-1]["loss"]
    print(f"\nloss {first:.4f} -> {last:.4f} "
          f"({'improved' if last < first else 'NOT improved'})")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(history, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
