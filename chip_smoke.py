"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile] [--out results.json]

Phases (any failure exits non-zero and prints no result line):

1. Device: the card's name and power limit (nvidia-smi); TF32 off for
   matmuls and cuDNN.
2. Kernels: build the six CUDA sources in ``src/repro_torch/csrc`` (one
   nvcc per source, in parallel), run each wrapper at its main path's
   shapes on the card and hold it against its plain PyTorch version
   (nibble and LUT matmuls: ``torch.equal``; attention forward and
   backward: stated tolerances, at the main paths' head width and at the
   256-wide instance; the forward also without the causal mask; paged
   decode also at a group of 32), and time kernel, plain version and a
   PyTorch library yardstick with CUDA events (the nibble and LUT kernels,
   the flash forward at the prefill and training shapes, the flash
   backward's two kernels together and apart (SDPA's backward too), and
   paged decode, also in a CUDA graph: device time without host gaps; the nibble and paged
   wrappers' host time per call too).  Paged decode is also checked at
   4096 rows a slot (many splits, a window across them) and at page size
   4, and times a scaling line (1, 160, 1024 and 4096 live rows a slot,
   each call on pools that are cold in L2).  The backward is also held
   on rows with no key in their window.  The f32 routes of the three
   attention entry points (``csrc/attention_f32.cu``) are held to their
   plain versions at small shapes, each showing its own launch counter.
2b. Paper: the paper's multiplier layer on the card.  Every 8-bit
   (a, b) through ``shift_add``, ``wallace``, ``lut_array`` and unsigned
   ``nibble_precompute`` ([0, 256)²) and through ``booth_radix2`` and
   signed ``nibble_precompute`` ([-128, 128)²), a 256-lane vector per
   broadcast b, and ``lut_array_16bit`` over all 65536 16-bit A for each
   of the 256 B: every product must equal a * b and every ``cycles``
   ``cycle_model.total_cycles``.  Table 2 (cycles per operand and for 16
   operands), Fig. 3 (8 operands from ``default_rng(42)``, b = 0xB7:
   nibble 16 cycles, LUT array 1, both exact) and the Fig. 4 ratios at 16
   operands, each held to the paper's value within
   ``tests/test_cycle_model.py``'s bounds.  Then the link to the kernels
   at yi-6b's ``wq`` at decode (int8 x (4, 4096), w (4096, 4096)):
   Algorithm 2's signed products summed over k on the card must equal
   ``ops.nibble_matmul`` (row 1) and ``ops.lut_matmul`` (row 5), and
   ``ops.quant_matmul_fused`` must equal ``ops.quant_matmul`` on
   ``quantize_rows``'s output, bit for bit; counters zeroed just before
   the phase and read after it: rows 1 and 5 must have launched
   (``paper_launches``).  Prints the phase's wall time and the link
   check's time.  The serve, families, ssm, enc-dec + VLM and train
   phases print each built model's ``param_count()`` beside the elements
   and bytes its tree holds.
3. Serve: yi-6b at full published width (random weights from a seed),
   every projection ``w8a8_nibble`` on the CUDA backend, flash prefill,
   paged decode; 8 requests through ``Engine.submit`` / ``Engine.run``.
   Launch counters are zeroed just before and read just after; every
   kernel of the path must have launched.  Then the first request's
   prefill runs through the plain path (``quant_backend="torch"``,
   ``attn_impl="chunked"``) and its logits are held to the kernel path's.
   Every engine of every phase runs captured (the default on CUDA): it
   must hold one CUDA graph per captured stage once warm (the decode
   chunk; under ``spec_decode`` the draft and the verify).
3b. Sampling + graphs: the serve requests through a ``capture=False``
   engine against the serve phase's captured one (equal streams, each
   divergence held to a near-tie as in phase 6, and equal launch
   counters); host ms per decode chunk, eager and captured, the median
   of 7 alternated chunks; temperature 0.7 on the workload phase's pool
   and bursty traffic: dense 4-layer streams from a reserve, a replay
   and a ``swap_mode="host"`` engine must be equal (preemptions and
   swap-ins required), and a full-width sampled ``spec_decode`` engine
   with the host swap must drain without a leak and with ``spec_tokens``
   equal to the emitted tokens minus the firsts; then the sampler on the
   card against the CPU (key words and random bits equal, tokens equal
   off near-ties).
3c. Static: the gate's grid (``repro_torch.staticcheck``) on the card,
   captured, ``nibble-cuda`` included (the nibble, flash forward and
   paged decode kernels): any finding fails.  The same grid walked on
   the CPU (plain versions): every cell's static MACs per stage on the
   card must equal the CPU walk's exactly (``nibble-cuda`` against the
   CPU's ``nibble``), so the count does not depend on which
   implementation runs.  Then the serve phase's engine (drained): its
   captured decode chunk's and its prefill's static rows (MACs, flops,
   ``io_bytes``, ``bytes_accessed``, ``stage_roofline``), the chunk's
   graph replayed with CUDA events on the same engine, and ``step_s`` over
   that time (phase 3b's chunks run at another ``max_len``, so its host
   time is not set against this floor).
4. Workload: the same weights through ``run_timed_workload`` (the
   launcher's timed driver) over an overcommitted paged pool
   (``alloc_mode="incremental"``, 1 trash + 18 allocatable pages of 16
   rows against 4 slots x 12 worst-case pages): a bursty stream of 16
   requests x 64 new tokens with a priority mix and aging.  Every stream
   must be complete and in the vocabulary, with at least one preemption,
   no leaked page, one signature per stage and the nibble, flash-forward
   and paged kernels launched (counters zeroed just before, read just
   after).  Prints TTFT and ITL percentiles beside the card's name and
   power limit.  Then, in ``quant_mode="dense"`` at full width cut to 4
   layers, the same uniform overcommitted workload through the
   incremental pool and through an uncontended ``reserve`` pool must give
   equal greedy streams, token for token, with preemptions in the first.
4b. Fleet: two replicas of the same full-width yi-6b behind one
   ``Router`` on the one card, sharing the serve phase's weight tree, each
   with the workload phase's pool and ``prefix_cache=True``, through
   ``run_timed_workload``: the workload phase's bursty traffic with
   ``shared_prefix=0.75``.  Prints fleet tok/s, TTFT p50/p99, ITL p99,
   placements and affinity hits per replica and the peak memory; requires
   2 replicas on 1 device, 16 placements, one signature per stage, one
   CUDA graph per replica, no leak after ``release_prefix_cache()``, the
   nibble and paged kernels launched (counters zeroed just before, read
   just after) and no flash forward (a prefix-cache prefill attends in
   ``attention_core``) nor f32 route.  Then, dense at full width cut to 4
   layers, the same 8 requests at arrival 0 through a two-replica fleet
   and through one engine: equal streams, each divergence held to a
   near-tie as in phase 6 (flash and paged launched).  Then the capacity
   model: the workload phase's engine, drained, is calibrated
   (``calibrate_engine``: each stage timed on a recorded signature, the
   decode chunk by replaying its graph; the host overhead from a probe),
   and ``predict`` on that phase's workload prints predicted against
   measured tok/s and TTFT p50 with the relative error (no limit; it must
   not raise and must find the workload feasible).  Every engine any
   phase builds holds ``analytic_cache_token_bytes(cfg)`` equal to its
   ``cache_token_bytes``.  Last, the launcher in process on reduced
   yi-6b: ``--dp 2``, ``--predict`` and ``--autotune max-tok-s
   --ttft-slo-ms 100``, each returning 0.
5. Prefix cache and host swap: the same weights and the workload phase's
   pool and traffic, with ``prefix_cache=True``, ``swap_mode="host"`` and
   ``shared_prefix=0.75`` (a 64-token shared head, 4 pages).  Every
   stream must be complete, with preemptions, swap-outs all swapped back
   in, replayed steps saved, prefix hits, zero device and host leaks after
   the index is released, one signature per stage, nibble and paged
   launches and no flash-forward launch (the context prefill attends in
   plain PyTorch, as the reference's does).  Printed beside the workload
   phase's replay-only numbers.  Then, dense at full width cut to 4
   layers: the workload phase's uniform check through the overcommitted
   pool with the host swap must equal the reserve pool's streams 8/8 in
   fewer decode chunks than the replay run; and 8 shared-prefix requests
   plus one 128-token prompt submitted twice (copy-on-write) through one
   prefix-cache engine must equal each request served alone through a
   fresh one, with ``prefill_tokens`` equal to the prompt tokens minus
   the rows ``hash_chunks`` says were cached.  Each prefix-hit stream
   that differs from a prefix-off engine's (flash prefill there,
   ``attention_core`` here) is held to a near-tie, as in phase 6.
6. Spec + wave: (a) the serve phase's weights and 8 requests x 32 new
   tokens, 4 slots, paged (page 16, incremental), flash attention: a
   dense ``decode_chunk=1`` baseline against ``spec_decode`` with a
   ``w8a8_nibble`` draft on the CUDA backend (``spec_k`` 4, dense
   verify).  Prints both tok/s, the acceptance rate, tokens per round,
   rounds and rolled-back pages; the spec run must launch the nibble,
   flash-forward and paged kernels (counters zeroed just before, read just
   after), no f32 route, with the stage pins ``{"prefill": 1,
   "decode_chunk": 0, "draft": 1, "verify": 1}`` and no leak.  (b) Each
   spec stream that differs from the baseline's is held to a near-tie: a
   dense full-width prefill over the prompt and the common prefix gives
   the margin ``l(baseline token) - l(spec token)`` at the first
   divergence, which must not exceed the serve phase's logit tolerance
   (printed beside the measured kernel-vs-plain difference).  (c) The
   tail run: the workload phase's pool and bursty traffic in
   ``w8a8_nibble`` with ``prefill_chunk=32``, ``admit_group=4`` and
   ``swap_mode="host"``; TTFT, ITL, tok/s, waves, preemptions and swaps
   beside the workload phase's; pins ``{"prefill": 0, "decode_chunk": 1,
   "prefill_chunk": 1}``, nibble and paged launches, no flash forward (a
   wave attends in ``attention_core``), no leak on either pool.  (d)
   Dense at full width cut to 4 layers, ``attn_impl="chunked"`` on both
   sides: the wave engine (chunk 32, group 4) against the monolithic one,
   and a spec engine (``w8a8_nibble`` draft) against the non-spec one;
   equal-stream counts printed, every divergence held to the rule of (b).
7. LUT serve: the same weights with ``quant_mode="lut"`` (the LUT-selection
   kernel), 4 of the requests x 16 new tokens; the greedy streams must
   equal, token for token, what ``w8a8_nibble`` serves for the same
   requests (both compute the same int32 product and epilogue).
7a. Int8 KV cache: the same weights with ``kv_cache_dtype="int8"``: the
   serve requests through a captured paged incremental engine (nibble
   and flash forward launched, the paged-decode kernel never: the decode
   dequantizes gathered pages in ``attention_core``, as the reference
   does) beside a bf16 engine with the same settings (tok/s, host ms per
   captured decode chunk, cache bytes per token: bf16 / int8 >= 1.9);
   the workload phase's pool and bursty traffic with ``swap_mode="host"``
   (preemptions, swap-ins, no leak); teacher-forced int8-cache decode
   logits within 5% of the largest bf16 forward logit (the reference's
   rule); dense at 4 layers: paged int8 streams equal to the dense
   slab's, and the host-swap engine's equal to the replay engine's,
   token for token.
7t. Tensor parallelism: the serve phase's weights, settings and
   8 requests x 32 through a tp=1 engine and a tp=2 engine over
   ``devices=[cuda:0, cuda:0]`` (the shards share the card): streams
   equal token for token or each divergence held to a near-tie (the
   margin rule), ``mesh_shape`` (1, 2), 2 devices, no leak, the decode
   chunk captured; launches per decode step 448 nibble (14 a layer) and
   64 paged decode, 64 flash forward per prefill, each twice tp=1's on
   the same schedule.  The row-parallel path at yi-6b's shard shapes
   (``wo`` 2048 -> 4096 and ``down`` 5504 -> 4096 a shard, M 4 and 128:
   each shard's exact int32 product on the nibble kernel, summed, the
   epilogue once) equal to the unsharded fused kernel bit for bit; the
   nibble kernel at the column shards (``wq`` 4096 -> 2048, ``wk``/``wv``
   4096 -> 256, ``gate``/``up`` 4096 -> 5504) and paged decode at KVH 2,
   G 8, d 128 held to their plain versions and timed beside the bound and
   a library call; tok/s and host ms per captured decode chunk at tp=1
   and tp=2, the largest logit difference of one paged decode step and
   of the prefill (tp=2 against tp=1), peak memory; then gemma3-1b at
   full width cut to 2 layers (KVH 1: its attention replicated on both
   shards, the tied head vocab-parallel), 4 requests x 16 at tp=1 and
   tp=2, streams held the same way.
7p. A data axis inside one engine (before the serve phase,
   ``check_fixed_mean``: each row of an ``rms_norm`` mean call of 1-1024
   rows equal to the row alone, at the models' widths): the serve
   phase's weights, settings
   and 8 requests x 32 at mesh (1, 1), (2, 1) and (2, 2) over cuda:0
   repeated 1, 2 and 4 times (each entry stores its FSDP pieces, every
   step gathers each layer's weights at use, slots split over the data
   rows): every stream equal to (1, 1)'s, the decode chunk captured;
   launches held a decode step (224 nibble and 32 paged decode per
   entry: every row runs its slots) and a batch-1 prefill (224 nibble
   and 32 flash forward per model shard: one row runs it); the paged
   decode plan at each shape's slots a row and KV heads a shard must be
   one split count and span; the first four prompts prefilled into four slots and one
   decode step of all four at (2, 1) and (2, 2) against (1, 1): max
   |dlogit| 0; parameter bytes stored per entry, weight bytes gathered
   per decode step, tok/s and peak memory per shape; host ms per
   captured decode chunk at each shape in turns and the ratio to (1,
   1); then ``dense`` at (2, 1): that step's logits within the serve
   phase's logit tolerance.  The families phase adds llama4 (2 layers)
   at (2, 1) after its tp pair, 4 x 16, eagerly (a full-width expert
   layer gathers 32 GB at use), and the ssm phase mamba2-780m at (2, 1),
   8 x 32 and the 512-token prompt: each stream equal to the (1, 1)
   cell's.
7b. Families (the yi-6b weights freed first): the nibble kernel at
   MLA's ``wkv_b`` (4 slots x 160 gathered latent rows) and ``wq_b``
   shapes (``torch.equal``), the flash forward at 128 heads with q/k 192
   and v 128, paged decode at llama4's group 5 and gemma3-1b's head_dim
   256 with a window, each held to its plain version and timed beside
   its bound and a library call; then deepseek-v3-671b at full width cut
   to 4 layers (3 dense MLA + 1 MoE of 256 experts, top-8), llama4 at
   full width cut to 2 layers (dense + MoE of 128 experts, top-1) and
   gemma3-1b at full width and depth, each through a captured engine
   (``w8a8_nibble`` on CUDA, flash prefill, paged incremental, 4 slots;
   counters zeroed just before, read just after: nibble and flash
   launched, paged decode on llama4 and gemma3 and never on deepseek's
   MLA layers), host ms per decode chunk, memory allocated, and the
   first request's prefill held to the plain path kernel by kernel
   (``hold_family_prefill``: the nibble path bit for bit, the flash path
   in ``dense`` within the serve phase's relative tolerance, the end-to-
   end w8a8 difference printed).  deepseek-v3 also runs dense: an
   overcommitted incremental pool with the prefix cache and the host
   swap against a reserve pool (preemptions and swap-ins required;
   streams equal or each divergence a near-tie).  TP families, MoE part
   (each model on the weights it was served with, before they are
   freed): the nibble kernel at the shard shapes new to it (MLA ``wkv_b``
   at decode (640, 512, 16384) and ``wq_b`` (4, 1536, 12288) at 64 heads
   a shard, the shared expert's ``gate``/``up`` (4, 7168, 1024)) and
   paged decode at llama4's shard (KVH 4, G 5, d 128), held to their
   plain versions and timed; then deepseek-v3's 8 requests x 32 and
   llama4's 4 x 16 through a tp=1 engine and a tp=2 engine over
   ``devices=[cuda:0, cuda:0]`` (experts split by expert, the MLA latent
   part and pools once on the shared card): streams equal or near-ties,
   the prefill's and one decode step's logits equal or within one bf16
   ulp of the largest logit, the tp=2 chunk captured, launches a decode
   step and a prefill held to ``TP_FAMILY_LAUNCHES`` (deepseek-v3 32
   nibble at tp=1, 56 at tp=2; llama4 14 nibble and 2 paged, 28 and 4;
   flash twice tp=1's), tok/s, host ms per captured chunk at both widths
   in turns, peak memory.
7c. SSM (the families' weights freed first): the nibble kernel at
   mamba2-780m's ``in_proj`` (N 6448) and ``out_proj`` at decode, its
   ``in_proj`` at a 512-token prefill and jamba's ``in_proj`` (N 16544)
   at decode (``torch.equal``), the flash forward at jamba's prefill and
   paged decode at its group 4, each held to its plain version and timed
   beside its bound and a library call; then mamba2-780m at full width
   and depth (48 SSD mixers, ``w8a8_nibble`` on CUDA, paged incremental,
   4 slots): 8 requests of 32-128 tokens and one of 512 x 32 through a
   captured engine (nibble 96 launches a decode step and a prefill,
   flash and paged none), equal streams from a ``capture=False`` engine
   and from the plain path, prefill logits equal to the plain path's bit
   for bit, host ms per decode chunk, and in ``dense`` an overcommitted
   incremental pool (replay, preemptions required) equal to a reserve
   pool; then jamba-v0.1-52b at full width cut to one block of 8 layers
   (1 attention, 7 mamba, 4 MoE of 16 experts top-2) served as the
   families are (rows 1-3 launched, the prefill held kernel by kernel).
7d. Enc-dec + VLM (the SSM models freed first): the nibble kernel at
   whisper-base's cross K/V projection of a decode step (6000, 512, 512;
   ``torch.equal``), the flash forward at phi-3-vision's head_dim 96 (4 x
   576 patches + 128 tokens) and whisper's decoder d 64, paged decode at
   phi-3-vision's 32 KV heads of 96 and whisper's 8 of 64, each held to
   its plain version and timed beside its bound and a library call; then
   phi-3-vision-4.2b at full width and depth (32 layers) and whisper-base
   at full width and depth (6 + 6 layers), each: 4 requests with their
   stub inputs (576 patch embeddings + 32-128 prompt tokens; 1500 frames
   + 16 tokens) through ``prefill`` and 32 greedy ``decode_step``s on
   dense caches (whisper's cross-attending ``enc_out``; nibble and flash
   launched), that prefill held to the plain path kernel by kernel with
   the same inputs, then the model served text-only as the families are
   (rows 1-3 launched, row 3 at d 96 and 64), then at tp=2 on
   ``[cuda:0, cuda:0]`` (TP families, enc-dec and VLM part): the same
   stub-input requests through ``prefill`` and 32 decode steps on shards
   (the encoder over the shards, patches prepended on the shared card),
   streams equal or near-ties, the prefill's and first step's logits
   equal or within one bf16 ulp, nibble and flash launches twice tp=1's;
   and 4 of the served requests x 16 text-only through a tp=1 and a tp=2
   engine, held the same way (rows 1-3 twice tp=1's, captured); then 4
   QAT steps of whisper-base through ``Trainer(extra_batch_fn=)`` at
   batch 8 x seq 128 (finite losses; rows 2 and 4 launched).
8. Train: full-width qwen3-4b (all 36 layers), QAT, flash attention
   (forward, remat recompute and the backward kernels), remat, batch 8 x
   seq 256, 4 AdamW steps through ``Trainer.run`` on ``SyntheticLM``
   data; losses must be finite and the flash forward, dq and dk/dv
   kernels must have launched.
8b. Train families (qwen3-4b freed first): rows 2 and 4 held to their
   plain versions and timed (loop, CUDA graph, plain, SDPA forward and
   forward + backward, bound) at deepseek-v3's MLA training shape (BH
   1024, G 1, S 256, q/k 192, v 128, through the 256 instance) and at
   gemma3-1b's (BH 16, G 4, S 1024, d 256, window 512); then 3 QAT steps
   each (remat, AdamW, ``Trainer`` on ``SyntheticLM``) of (a) gemma3-1b
   at full width and depth, flash, batch 4 x seq 1024 (the window
   binds), (b) deepseek-v3-671b at full width cut to its first 2 (dense
   MLA) layers, flash, ``mtp_weight`` 0.3, batch 8 x seq 256, and (c)
   jamba-v0.1-52b at full width cut to its first 2 layers (mamba + MLP,
   mamba + MoE of 16 experts top-2), batch 4 x seq 512 (two SSD chunks),
   each model freed before the next: per-step loss, grad norm and
   ``aux``, steady tokens/s, peak memory and launches; every loss finite,
   ``aux`` > 0 in (c), rows 2 and 4 launched in (a) and (b) and no f32
   route; on one batch of (b) the loss with MTP exceeds the loss without
   by exactly the MTP term.
8c. Train gradients: one step's gradients through the kernels (flash)
   held to the plain path's (``attn_impl="chunked"``) leaf by leaf, in
   ``qat`` and ``dense``, on full-width qwen3-4b cut to 2 layers,
   deepseek-v3-671b cut to its first 2 layers and gemma3-1b cut to its
   first 6 (one 5:1 block) at seq 1024.

8d. Mesh train (``phase_mesh_train``): the sharded training step
   (``make_train_step`` over ``sharding.train_shards``) on meshes of the
   one card repeated, every entry a card of its own.  (a) full-width
   qwen3-4b as phase 8 (QAT, flash, remat, AdamW, batch 8 x seq 256,
   no warmup), 2 steps at (1, 1) (unsharded), (1, 2) and (2, 1), each
   from the same weights (a host copy) and the same two batches: per
   step loss, grad norm and wall; the collective bytes by kind and axis
   (``collectives.collective_bytes``); rows 2 and 4 launched exactly
   twice (1, 1)'s; peak memory; loss within ``MESH_LOSS_ATOL`` and grad
   norm within ``MESH_GNORM_RTOL`` of (1, 1)'s at each step (the CPU
   tests' tolerances, ``tests/test_torch_mesh_train.py``).  (b) at (1, 2)
   against (1, 1), one step each: deepseek-v3-671b cut as phase 8b cuts it
   (its 2 dense MLA layers, MTP 0.3: the MLA heads split) and
   jamba-v0.1-52b cut to its first 2 layers (its MoE of 16 experts split
   by expert: the reference's mesh MoE at dp = 1 equals the unsharded
   one up to the bf16 combine), the aux printed and held within
   ``MESH_AUX_ATOL``.  (c) The dry run
   (``python -m repro_torch.launch.dryrun``, fake tensors, host only)
   over ``256gpu_32x8`` for yi-6b and deepseek-v3-671b at ``train_4k``
   and ``decode_32k``, started as a subprocess when the script starts
   (it runs beside the card's phases) and collected here: every cell
   ``ok``, ``format_table``, each record's per-card memory and ``fits``
   and the subprocess's seconds.  (d) Fake against real: reduced yi-6b
   (``dense``, ``chunked``, 2 layers) at (2, 2), the dry run's walk once on
   fake ``meta:N`` entries and once on real tensors on ``cuda:0``
   repeated: flops, collective bytes and ``io_bytes`` must be equal.

The last three lines are the per-kernel JSON, the card's name and power
limit as nvidia-smi gives them, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import itertools
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np

# the training phase holds ~50 GB of long-lived state next to short-lived
# GB-sized temporaries: expandable segments keep them from fragmenting
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import torch  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import cycle_model  # noqa: E402
from repro_torch.core import multipliers as tmul  # noqa: E402
from repro_torch.core.nibble import pack_int4  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.kernels import _build, flash_attention as fa  # noqa: E402
from repro_torch.kernels import lut_matmul as lm  # noqa: E402
from repro_torch.kernels import nibble_matmul as nm  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels.quant_matmul_fused import (  # noqa: E402
    quantize_rows)
from repro_torch.launch.train import stub_extras  # noqa: E402
from repro_torch.launch.mesh import HW, make_local_mesh  # noqa: E402
from repro_torch.distributed import collectives  # noqa: E402
from repro_torch.distributed.sharding import shard_params  # noqa: E402
from repro_torch.distributed.sharding import train_shards  # noqa: E402
from repro_torch.core.linear import (linear_apply,  # noqa: E402
                                     linear_apply_row)
from repro_torch.models import (decode_step, forward,  # noqa: E402
                                init_caches, merge_slot_paged_caches,
                                model_init, prefill)
from repro_torch.models.transformer import init_shard_caches  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.attention import attention_core  # noqa: E402
from repro_torch.models.layers import fixed_mean  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.capacity import (Knobs, WorkloadShape,  # noqa: E402
                                  analytic_cache_token_bytes, predict)
from repro_torch.capacity.calibrate import calibrate_engine  # noqa: E402
from repro_torch.launch import serve as serve_launcher  # noqa: E402
from repro_torch.serve import Engine as _PortEngine  # noqa: E402
from repro_torch.serve import (Router, ServeConfig,  # noqa: E402
                                draw_workload, hash_chunks, pages_needed,
                                run_timed_workload, sampling)
from repro_torch.train import TrainConfig, make_train_step  # noqa: E402
from repro_torch.train.step import (accumulate_grads,  # noqa: E402
                                    cross_entropy, make_loss_fn)
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402
from repro_torch.tree import tree_paths  # noqa: E402

DEV = "cuda"
DEV_ONE = "cuda:0"      # a mesh of the one card repeated

# H100 SXM published peaks (dense): HBM bytes/s, int8 ops/s, bf16 FLOP/s
HBM_BPS = HW.HBM_BW
INT8_OPS = HW.PEAK_INT8_OPS
BF16_FLOPS = HW.PEAK_BF16_FLOPS

# attention kernels vs their plain versions: same inputs in bf16; both
# accumulate in f32, but the kernel rescales online per 32-key tile and
# rounds p to bf16 against the running max, the plain version against the
# final max, so outputs (|o| < ~1, bf16 ulp <= 2**-8) differ by a few ulp
ATTN_ATOL = 2e-2
LSE_ATOL = 1e-3
# the f32 attention routes vs their plain versions: the same f32 function
# (no rounding of p or ds), only the order of the f32 sums differs; absolute
# on o and lse, relative Frobenius norm on the gradients
F32_TOL = 1e-4
# full-width prefill logits, kernel path vs plain path: the nibble kernel is
# bit-exact, but flash vs chunked attention round differently, which over
# 32 layers flips some int8 activation roundings; bound relative to the
# logits' own scale
LOGIT_RTOL = 0.1
# flash backward vs its plain version (same bf16 inputs, f32 sums in
# another order; ds rounded to bf16 may flip by one ulp where the two f32
# values straddle a midpoint): relative Frobenius norm per gradient
BWD_RTOL = 1e-3
# model-level gradients, kernel path (flash) vs plain path (chunked), per
# leaf in relative Frobenius norm.  The two attention paths round p and
# the outputs to bf16 at other points, and those ulps flip bf16 roundings
# downstream; in QAT a flipped activation moves a fake-quantized value by
# a whole int8 step.  On the CPU the reference's own flash and chunked
# paths differ by 1.8% (dense) and 3.6% (qat) on reduced qwen3-4b.
MODEL_GRAD_RTOL = {"dense": 0.05, "qat": 0.15}

# every engine a phase builds holds its cache bytes per token to the
# capacity model's closed form: config name, layers, KV dtype -> bytes
CACHE_BYTES: dict = {}


def hold_cache_bytes(engine) -> int:
    """``analytic_cache_token_bytes(cfg)`` must equal what the engine
    allocates per cached token."""
    cfg = engine.cfg
    want, got = analytic_cache_token_bytes(cfg), engine.cache_token_bytes
    if want != got:
        raise AssertionError(f"{cfg.name}: analytic cache bytes per token "
                             f"{want} != the engine's {got}")
    CACHE_BYTES[f"{cfg.name}/{cfg.n_layers}L/{cfg.kv_cache_dtype}"] = got
    return got


class Engine(_PortEngine):
    """The port's engine, held to the capacity model's cache bytes when
    built (``hold_cache_bytes``); everything else is the port's."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        hold_cache_bytes(self)


MM_SHAPES_DECODE = [  # one decode layer's projections at 4 slots
    ("wq", 4, 4096, 4096), ("wk", 4, 4096, 512), ("wv", 4, 4096, 512),
    ("wo", 4, 4096, 4096), ("gate", 4, 4096, 11008),
    ("up", 4, 4096, 11008), ("down", 4, 11008, 4096)]
MM_CHECK_SHAPES = [(4, 4096, 4096), (4, 4096, 512), (4, 4096, 11008),
                   (4, 11008, 4096), (128, 4096, 11008)]
NIBBLE_CHECK_SHAPES = MM_CHECK_SHAPES + [(1, 4096, 512), (65, 4096, 4096),
                                         (4, 4096 + 16, 4096)]


def cuda_ms(fn, iters=20, warmup=3) -> float:
    """Median milliseconds of ``fn`` over ``iters`` CUDA-event-timed runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def graph_ms(fn, reps=20) -> float:
    """Device milliseconds of one ``fn`` call: ``reps`` calls captured in
    one CUDA graph and replayed, so no host time falls between them (the
    median of 5 timed replays after one warm-up).  The warm-up calls run
    on a side stream, as PyTorch's capture of autograd's backward asks."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return cuda_ms(graph.replay, iters=5, warmup=1) / reps


def bound_ms(n_bytes: float, ops: float, peak_ops: float):
    t_bytes = n_bytes / HBM_BPS * 1e3
    t_ops = ops / peak_ops * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    line = smi.stdout.strip().splitlines()[0]
    print(line, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"capability {torch.cuda.get_device_capability(0)}", flush=True)
    return line


def phase_build() -> None:
    t = time.perf_counter()
    logs = _build.build_all()
    print(f"built {sorted(_build.SOURCES)} in "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    for name, log in logs.items():
        for ln in log.splitlines():
            if "registers" in ln or "spill" in ln:
                print(f"  [{name}] {ln.strip()}")


def _int_mm_ms(x, wt, timer=cuda_ms):
    """torch._int_mm yardstick (M padded to at least 32 and to a multiple
    of 8: cuBLASLt needs M > 16), timed by ``timer``."""
    m = max(32, -(-x.shape[0] // 8) * 8)
    xp = torch.zeros((m, x.shape[1]), dtype=torch.int8, device=x.device)
    xp[:x.shape[0]] = x
    for b in (wt.t(), wt.t().contiguous()):
        try:
            torch._int_mm(xp, b)
        except RuntimeError as exc:
            err = exc
            continue
        return timer(lambda: torch._int_mm(xp, b))
    print(f"  torch._int_mm unavailable: {err}")
    return None


def host_us(fn, calls=200) -> float:
    """Host microseconds per call of ``fn``: ``calls`` calls enqueued back
    to back (no synchronisation between them), so a call whose device work
    is shorter than its host work is timed by its host work."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    host = time.perf_counter() - t
    torch.cuda.synchronize()
    return host / calls * 1e6


def check_nibble(gen) -> dict:
    dev = DEV
    for ln in _build.build_logs.get("nibble_matmul", "").splitlines():
        if "entry function" in ln or "registers" in ln or "spill" in ln:
            print(f"  [nibble_matmul ptxas] {ln.strip()}")
    # the main path's shapes, plus the kernel's edges: one row, a ragged
    # 64-row tile, and K = 4096 + 16 (off the 128-byte stage and the split)
    for m, k, n in NIBBLE_CHECK_SHAPES:
        x = torch.randint(-128, 128, (m, k), dtype=torch.int8, device=dev,
                          generator=gen)
        wt = torch.randint(-128, 128, (n, k), dtype=torch.int8, device=dev,
                           generator=gen)
        w4 = torch.randint(-8, 8, (k, n), dtype=torch.int8, device=dev,
                           generator=gen)
        # the extreme products: -128 (the hs plane's -128) in every row at
        # the first and last k, against -128 and 127 (int4: -8 and 7)
        x[:, 0] = -128
        x[:, -1] = -128
        wt[:2, 0] = torch.tensor([-128, 127], dtype=torch.int8)
        wt[-2:, -1] = torch.tensor([-128, 127], dtype=torch.int8)
        w4[0, :2] = torch.tensor([-8, 7], dtype=torch.int8)
        w4[-1, -2:] = torch.tensor([-8, 7], dtype=torch.int8)
        w = wt.t()
        w4p = pack_int4(w4)
        xs = torch.rand((m, 1), device=dev, generator=gen) * 0.01 + 1e-4
        ws = torch.rand((1, n), device=dev, generator=gen) * 0.01 + 1e-4
        f32 = torch.float32
        checks = {
            "int32": (nm.nibble_matmul_cuda(x, w), nm.nibble_matmul_plain(x, w)),
            "bf16": (nm.nibble_matmul_cuda(x, w, xs, ws),
                     nm.nibble_matmul_plain(x, w, xs, ws)),
            "f32": (nm.nibble_matmul_cuda(x, w, xs, ws, out_dtype=f32),
                    nm.nibble_matmul_plain(x, w, xs, ws, out_dtype=f32)),
            "int4": (nm.nibble_matmul_cuda(x, w4p, w_packed=True),
                     nm.nibble_matmul_plain(x, w4p, w_packed=True)),
        }
        torch.cuda.synchronize()
        for what, (got, want) in checks.items():
            if not torch.equal(got, want):
                err = (got.float() - want.float()).abs().max().item()
                raise AssertionError(f"nibble matmul {what} ({m},{k},{n}) "
                                     f"differs from plain: max err {err}")
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        print(f"  nibble ({m},{k},{n}) {nm.nibble_plan(m, n, k, sms)}: "
              f"int32, bf16, f32, int4 torch.equal", flush=True)
    # time one decode layer's seven projections with the main path's
    # arguments (N-major int8 weight, a per-tensor activation scale, a
    # per-column weight scale, bf16 out): in a loop (host time of each
    # call included, as in earlier rows) and in a CUDA graph (device time)
    ms = plain = lib = dev_ms = lib_dev = 0.0
    n_bytes = ops = 0
    layer, prefill = [], {}
    for name, m, k, n in MM_SHAPES_DECODE + [("prefill-up", 128, 4096,
                                              11008)]:
        x = torch.randint(-128, 128, (m, k), dtype=torch.int8, device=dev,
                          generator=gen)
        wt = torch.randint(-128, 128, (n, k), dtype=torch.int8, device=dev,
                           generator=gen)
        xs = torch.tensor(1e-3, device=dev)
        ws = torch.full((1, n), 1e-3, device=dev)

        def call(x=x, wt=wt, xs=xs, ws=ws):
            return nm.nibble_matmul_cuda(x, wt.t(), xs, ws)

        t_k = cuda_ms(call)
        t_p = cuda_ms(lambda: nm.nibble_matmul_plain(x, wt.t(), xs, ws),
                      iters=5)
        t_l = _int_mm_ms(x, wt)
        t_g = graph_ms(call)
        t_gl = _int_mm_ms(x, wt, timer=graph_ms)
        print(f"  nibble {name} ({m},{k},{n}): kernel {t_k:.4f} ms, plain "
              f"{t_p:.4f} ms, _int_mm {t_l} ms; in a CUDA graph: kernel "
              f"{t_g:.4f} ms, _int_mm {t_gl} ms", flush=True)
        if name == "prefill-up":
            pb, pby = bound_ms(m * k + k * n + 2 * m * n + 4 + 4 * n,
                               2 * m * n * k, INT8_OPS)
            prefill = {"prefill_ms": t_k, "prefill_graph_ms": t_g,
                       "prefill_int_mm_ms": t_l,
                       "prefill_int_mm_graph_ms": t_gl,
                       "prefill_bound_ms": pb}
            print(f"  nibble prefill bound {pb:.4f} ms ({pby})", flush=True)
            continue
        layer.append(call)
        ms += t_k
        plain += t_p
        dev_ms += t_g
        lib = None if (lib is None or t_l is None) else lib + t_l
        lib_dev = None if (lib_dev is None or t_gl is None) else \
            lib_dev + t_gl
        n_bytes += m * k + k * n + 2 * m * n + 4 + 4 * n
        ops += 2 * m * n * k
    layer_graph = graph_ms(lambda: [c() for c in layer], reps=5)
    b, by = bound_ms(n_bytes, ops, INT8_OPS)
    print(f"  nibble decode layer: kernel {ms:.4f} ms ({dev_ms:.4f} ms in a "
          f"CUDA graph per projection, {layer_graph:.4f} ms as one graph of "
          f"the layer), _int_mm {lib} ms ({lib_dev} ms in a CUDA graph), "
          f"bound {b:.4f} ms ({by})", flush=True)
    # host time per call at wq's shape: the wrapper, the entry point the
    # model calls, and the parts of a call
    x = torch.randint(-128, 128, (4, 4096), dtype=torch.int8, device=dev,
                      generator=gen)
    wt = torch.randint(-128, 128, (4096, 4096), dtype=torch.int8,
                       device=dev, generator=gen)
    xs = torch.tensor(1e-3, device=dev)
    ws = torch.full((1, 4096), 1e-3, device=dev)
    x3 = x[None]                       # (batch, tokens, d) as the model's
    o = torch.empty((4, 4096), dtype=torch.bfloat16, device=dev)
    plan = nm.nibble_plan(4, 4096, 4096,
                          torch.cuda.get_device_properties(0)
                          .multi_processor_count)
    fn = nm._lib()
    args = (x.data_ptr(), wt.data_ptr(), xs.data_ptr(), 0, ws.data_ptr(), 1,
            o.data_ptr(), 4, 4096, 4096, 0, 1, plan.rows, plan.k_chunk,
            torch.cuda.current_stream().cuda_stream)
    host = {
        "nibble_matmul_cuda": host_us(lambda: nm.nibble_matmul_cuda(
            x, wt.t(), xs, ws)),
        "ops.quant_matmul": host_us(lambda: kops.quant_matmul(
            x3, wt.t(), x_scale=xs, w_scale=ws,
            out_dtype=torch.bfloat16)),
        "C launch alone": host_us(lambda: fn(*args)),
        "torch.empty": host_us(lambda: torch.empty(
            (4, 4096), dtype=torch.bfloat16, device=dev)),
        "current_stream": host_us(
            lambda: torch.cuda.current_stream(x.device).cuda_stream),
    }
    print("  nibble host time per call (us): " + ", ".join(
        f"{k_} {v:.2f}" for k_, v in host.items()), flush=True)
    return {"name": "nibble_matmul", "route": "cuda",
            "source": "src/repro_torch/csrc/nibble_matmul.cu",
            "replaces": "src/repro/kernels/nibble_matmul.py:161",
            "max_abs_err": 0.0, "ms": ms, "plain_ms": plain,
            "bound_ms": b, "bound_by": by, "library_ms": lib,
            "graph_ms": dev_ms, "layer_graph_ms": layer_graph,
            "library_graph_ms": lib_dev, **prefill, "host_us": host,
            "shapes": "one decode layer: wq,wk,wv,wo,gate,up,down at M=4"}


def _sdpa_gqa(q, k, v, **kw):
    try:
        return torch.nn.functional.scaled_dot_product_attention(
            q, k, v, enable_gqa=True, **kw)
    except TypeError:               # torch without enable_gqa
        g = q.shape[1] // k.shape[1]
        return torch.nn.functional.scaled_dot_product_attention(
            q, k.repeat_interleave(g, 1), v.repeat_interleave(g, 1), **kw)


def _ptxas(name: str) -> list:
    """The ptxas lines of one library's build: entry, registers, spills."""
    lines = [ln.strip() for ln in _build.build_logs.get(name, "").splitlines()
             if "entry function" in ln or "registers" in ln or "spill" in ln]
    for ln in lines:
        print(f"  [{name} ptxas] {ln}")
    return lines


def _fwd_bound(bh, group, s, d):
    """Bytes (q, k, v, o in bf16, lse in f32) and useful causal FLOPs of
    the flash forward at one shape; the bound and what bounds it."""
    n_bytes = 2 * (2 * bh * s * d + 2 * (bh // group) * s * d) + 4 * bh * s
    flops = 2 * 2 * bh * (s * (s + 1) // 2) * d
    return bound_ms(n_bytes, flops, BF16_FLOPS), n_bytes, flops


def _time_fwd(q, k, v, kw, heads):
    """The forward kernel and SDPA's forward (GQA, ``heads`` query heads
    per sequence) at one shape, each in a loop and in a CUDA graph."""
    bh, s, d = q.shape
    nb = bh // heads
    q4 = q.reshape(nb, heads, s, d)
    k4, v4 = (t.reshape(nb, -1, s, t.shape[-1]) for t in (k, v))

    def kernel():
        return fa.flash_attention_fwd_cuda(q, k, v, **kw)

    def sdpa():
        return _sdpa_gqa(q4, k4, v4, is_causal=True, scale=kw["scale"])

    return {"ms": cuda_ms(kernel), "graph_ms": graph_ms(kernel),
            "library_ms": cuda_ms(sdpa), "library_graph_ms": graph_ms(sdpa)}


def _fwd_scaling(gen) -> dict:
    """The forward and SDPA's forward (device time, CUDA graphs) at three
    shapes of 1024 blocks of 64 query rows (group 4, d 128, causal) that
    walk 1, 2.5 and 8.5 K/V tiles per block on average: the per-block cost
    against the per-tile rate."""
    out = {}
    for bh, s in ((1024, 64), (256, 256), (64, 1024)):
        q = torch.randn((bh, s, 128), device=DEV, generator=gen).bfloat16()
        k, v = (torch.randn((bh // 4, s, 128), device=DEV, generator=gen)
                .bfloat16() for _ in range(2))
        kw = dict(scale=128 ** -0.5, causal=True, group=4)
        q4, k4, v4 = (t.reshape(bh // 32, -1, s, 128) for t in (q, k, v))
        out[f"BH={bh} S={s}"] = (
            graph_ms(lambda: fa.flash_attention_fwd_cuda(q, k, v, **kw)),
            graph_ms(lambda: _sdpa_gqa(q4, k4, v4, is_causal=True,
                                       scale=kw["scale"])))
    print("  flash fwd scaling (1024 blocks of 64 rows), graph ms kernel / "
          "sdpa: " + ", ".join(f"{n} {a:.4f} / {b:.4f}"
                               for n, (a, b) in out.items()), flush=True)
    return out


def check_flash(gen) -> dict:
    dev = DEV
    ptxas = _ptxas("flash_attention")
    bh, group, s, d = 32, 8, 128, 128
    scale = 1.0 / math.sqrt(d)
    worst = 0.0
    # the main path's head width (two 64-row query tiles, the second
    # ragged at Sq 100), then the 256-wide instance (head_dim 256, and
    # MLA's q/k 192 with v 128), then no causal mask, Sq != Sk, and rows
    # with no key in their window (q >= Sk + window - 1: o is the mean of
    # all values, lse -1e30, as in the reference)
    cases = [dict(sq=s, window=0, softcap=0.0),
             dict(sq=100, window=0, softcap=0.0),
             dict(sq=s, window=40, softcap=30.0),
             dict(sq=s, window=0, softcap=0.0, d=256, dv=256),
             dict(sq=100, window=0, softcap=0.0, d=192, dv=128),
             dict(sq=100, sk=s, window=0, softcap=0.0, causal=False),
             dict(sq=100, sk=40, window=20, softcap=0.0, causal=False)]
    for c in cases:
        sq, dq_, dv_ = c["sq"], c.get("d", d), c.get("dv", d)
        sk = c.get("sk", sq)
        q = torch.randn((bh, sq, dq_), device=dev, generator=gen).bfloat16()
        k = torch.randn((bh // group, sk, dq_), device=dev,
                        generator=gen).bfloat16()
        v = torch.randn((bh // group, sk, dv_), device=dev,
                        generator=gen).bfloat16()
        kw = dict(scale=dq_ ** -0.5, causal=c.get("causal", True),
                  window=c["window"], softcap=c["softcap"], group=group)
        o, lse = fa.flash_attention_fwd_cuda(q, k, v, **kw)
        o_p, lse_p = fa.flash_attention_fwd_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        err = (o.float() - o_p.float()).abs().max().item()
        err_l = (lse - lse_p).abs().max().item()
        print(f"  flash {c}: max|o err| {err:.3e} (atol {ATTN_ATOL}), "
              f"max|lse err| {err_l:.3e} (atol {LSE_ATOL})", flush=True)
        if not (err <= ATTN_ATOL and err_l <= LSE_ATOL):
            raise AssertionError(f"flash forward {c} disagrees with plain")
        worst = max(worst, err)
    q = torch.randn((bh, s, d), device=dev, generator=gen).bfloat16()
    k = torch.randn((bh // group, s, d), device=dev, generator=gen).bfloat16()
    v = torch.randn((bh // group, s, d), device=dev, generator=gen).bfloat16()
    kw = dict(scale=scale, causal=True, group=group)
    t = _time_fwd(q, k, v, kw, heads=32)
    plain = cuda_ms(lambda: fa.flash_attention_fwd_plain(q, k, v, **kw))
    (b, by), _, _ = _fwd_bound(bh, group, s, d)
    print(f"  flash timing (BH={bh}, G={group}, S={s}, d={d}): "
          f"kernel {t['ms']:.4f} ms, graph {t['graph_ms']:.4f} ms, plain "
          f"{plain:.4f} ms, sdpa {t['library_ms']:.4f} ms, graph "
          f"{t['library_graph_ms']:.4f} ms, bound {b:.5f} ms ({by})",
          flush=True)
    return {"name": "flash_attention_fwd", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:90",
            "max_abs_err": worst, "ms": t["ms"], "plain_ms": plain,
            "bound_ms": b, "bound_by": by, "library_ms": t["library_ms"],
            "graph_ms": t["graph_ms"],
            "library_graph_ms": t["library_graph_ms"], "ptxas": ptxas,
            "shapes": f"BH={bh} group={group} Sq=Sk={s} d={d} causal"}


def _paged_inputs(gen, rng, b, kvh, g, d, ps, per_slot, q_pos=None,
                  n_sets=1):
    """``n_sets`` pairs of random bf16 pools (one page per slot and table
    entry, plus the trash page 0), a query, a page table through a random
    permutation (trash page past each slot's live length) and q_pos (drawn
    with ``rng`` unless given)."""
    num_pages = b * per_slot + 1
    pools = [tuple(torch.randn((num_pages, ps, kvh, d), device=DEV,
                               generator=gen).bfloat16() for _ in range(2))
             for _ in range(n_sets)]
    q = torch.randn((b, kvh, g, d), device=DEV, generator=gen).bfloat16()
    if q_pos is None:
        q_pos = rng.integers(0, per_slot * ps, b).astype(np.int32)
    q_pos = np.asarray(q_pos, np.int32)
    perm = rng.permutation(np.arange(1, num_pages)).reshape(b, per_slot)
    table = np.zeros((b, per_slot), np.int32)      # trash page 0 past live
    for i in range(b):
        live = min(per_slot, q_pos[i] // ps + 1)
        table[i, :live] = perm[i, :live]
    return (q, pools, torch.as_tensor(table, device=DEV),
            torch.as_tensor(q_pos, device=DEV))


def _paged_bytes(q, table, q_pos, ps, dv):
    """Bytes paged decode must move (the live K/V rows once, q and o, the
    table and q_pos) and the live rows."""
    b, kvh, g, d = q.shape
    rows = int((q_pos.long() + 1).clamp(max=table.shape[1] * ps).sum())
    return 2 * (rows * kvh * (d + dv) + b * kvh * g * (d + dv)) \
        + 4 * table.numel() + 4 * b, rows


def _paged_sdpa(q, kp, vp, table, q_pos, scale, window=0):
    """The yardstick: gather the table's pages (as the plain version
    does) and run SDPA with the causal-by-position mask (and the sliding
    window's, an explicit boolean mask)."""
    b, kvh, g, d = q.shape
    ps, dv = kp.shape[1], vp.shape[-1]
    L = table.shape[1] * ps
    key = torch.arange(L, device=DEV)[None, :]
    qp = q_pos[:, None].long()
    mask = key <= qp
    if window:
        mask &= (qp - key) < window
    mask = mask[:, None, None, :]
    idx = table.long()

    def fn():
        kk = kp[idx].reshape(b, L, kvh, d).transpose(1, 2)
        vv = vp[idx].reshape(b, L, kvh, dv).transpose(1, 2)
        return _sdpa_gqa(q.reshape(b, kvh * g, 1, d), kk, vv, attn_mask=mask,
                         scale=scale)
    return fn


def _paged_graph(q, pools, table, q_pos, scale):
    """Graph times (ms) of the kernel and of the SDPA yardstick, each call
    on the next of ``pools`` in turn, so that every call finds its K/V
    rows cold in L2, as each layer's decode step does."""
    kernel = [lambda kp=kp, vp=vp: fa.paged_decode_attention_cuda(
        q, kp, vp, table, q_pos, scale=scale) for kp, vp in pools]
    sdpa = [_paged_sdpa(q, kp, vp, table, q_pos, scale) for kp, vp in pools]
    reps = max(20, len(pools))

    def cycle(fns):
        turn = itertools.count()
        return lambda: fns[next(turn) % len(fns)]()
    return graph_ms(cycle(kernel), reps), graph_ms(cycle(sdpa), reps)


def _sets_for(num_pages, ps, kvh, d):
    """Pool pairs whose bytes together exceed the 50 MB L2 twice over."""
    return max(1, math.ceil(100e6 / (2 * num_pages * ps * kvh * d * 2)))


def _paged_scaling(gen) -> dict:
    """Graph times of the kernel and of the yardstick at B 4, KVH 4, G 8,
    d 128, page 16 with every slot at 160 (the serve run's max_len), 1024
    and 4096 (yi-6b's published context) live rows, beside the bound; and
    first at one live row a slot (the fixed cost of a call)."""
    b, kvh, g, d, ps = 4, 4, 8, 128, 16
    rng = np.random.default_rng(2)
    out = {}
    # first the fixed cost: one live row a slot in a table of 160
    for live, cap in ((1, 160), (160, 160), (1024, 1024), (4096, 4096)):
        per_slot = cap // ps
        n_sets = _sets_for(b * per_slot + 1, ps, kvh, d)
        q, pools, table, q_pos = _paged_inputs(gen, rng, b, kvh, g, d, ps,
                                               per_slot,
                                               q_pos=[live - 1] * b,
                                               n_sets=n_sets)
        n_bytes, rows = _paged_bytes(q, table, q_pos, ps, d)
        bd, _ = bound_ms(n_bytes, 4 * rows * kvh * g * d, BF16_FLOPS)
        t_k, t_s = _paged_graph(q, pools, table, q_pos, d ** -0.5)
        plan = fa.paged_plan(cap, b, kvh, g, _sms())
        out[f"live={live}"] = {"graph_ms": t_k, "library_graph_ms": t_s,
                               "bound_ms": bd, "pool_sets": n_sets,
                               "splits": plan.n_split}
        del q, pools
    print("  paged scaling (B 4, KVH 4, G 8, d 128, page 16; every slot at "
          "the live rows; graph ms kernel / sdpa over gathered pages / "
          "bound): " + ", ".join(
              f"{n} {r['graph_ms']:.4f} / {r['library_graph_ms']:.4f} / "
              f"{r['bound_ms']:.5f}" for n, r in out.items()), flush=True)
    return out


def _sms() -> int:
    return torch.cuda.get_device_properties(0).multi_processor_count


def check_paged(gen) -> dict:
    ptxas = _ptxas("paged_decode")
    b, kvh, g, d, ps, per_slot = 4, 4, 8, 128, 16, 16
    scale = 1.0 / math.sqrt(d)
    rng = np.random.default_rng(0)
    q, pools, table_t, qpos_t = _paged_inputs(gen, rng, b, kvh, g, d, ps,
                                              per_slot)
    kp, vp = pools[0]
    worst = 0.0
    # the main path's shape under three options, then head_dim 256, a group
    # of 32 query heads (two 16-head chunks in one launch), a long cache
    # (4096 rows a slot) with q_pos on the first tile, mid-cache and on the
    # table's last row under a window, and page size 4 (the reference
    # serve_bench's)
    wide = {"d=256": (kvh, g, 256), "G=32": (1, 32, d)}
    cases = [("", (0, 0.0)), ("", (48, 0.0)), ("", (0, 30.0)),
             ("d=256", (0, 0.0)), ("G=32", (0, 30.0)),
             ("4096 rows", (0, 0.0)), ("4096 rows", (700, 0.0)),
             ("page 4", (0, 0.0)), ("page 4", (50, 20.0))]
    for name, (window, softcap) in cases:
        kw = dict(scale=scale, window=window, softcap=softcap)
        qq, kpp, vpp, tt, pp = q, kp, vp, table_t, qpos_t
        if name in wide:
            kvh_, g_, d_ = wide[name]
            kpp, vpp = (torch.randn((b * per_slot + 1, ps, kvh_, d_),
                                    device=DEV, generator=gen).bfloat16()
                        for _ in range(2))
            qq = torch.randn((b, kvh_, g_, d_), device=DEV,
                             generator=gen).bfloat16()
            kw["scale"] = d_ ** -0.5
        elif name == "4096 rows":
            qq, ((kpp, vpp),), tt, pp = _paged_inputs(
                gen, rng, b, kvh, g, d, ps, 256, q_pos=[3, 2000, 4095, 3333])
        elif name == "page 4":
            qq, ((kpp, vpp),), tt, pp = _paged_inputs(gen, rng, b, kvh, g, d,
                                                      4, 40)
        o = fa.paged_decode_attention_cuda(qq, kpp, vpp, tt, pp, **kw)
        o_p = fa.paged_decode_attention_plain(qq, kpp, vpp, tt, pp, **kw)
        torch.cuda.synchronize()
        err = (o.float() - o_p.float()).abs().max().item()
        plan = fa.paged_plan(tt.shape[1] * kpp.shape[1], *qq.shape[:3],
                             _sms())
        print(f"  paged {name or 'main shape'} window={window} "
              f"softcap={softcap} (q_pos {pp.tolist()}, capacity "
              f"{tt.shape[1] * kpp.shape[1]}, {plan.n_split} splits of "
              f"{plan.span}): max|err| {err:.3e} (atol {ATTN_ATOL})",
              flush=True)
        if not err <= ATTN_ATOL:
            raise AssertionError("paged decode disagrees with plain")
        worst = max(worst, err)
    kw = dict(scale=scale)

    def call():
        return fa.paged_decode_attention_cuda(q, kp, vp, table_t, qpos_t,
                                              **kw)

    ms = cuda_ms(call)
    plain = cuda_ms(lambda: fa.paged_decode_attention_plain(
        q, kp, vp, table_t, qpos_t, **kw))
    lib = cuda_ms(_paged_sdpa(q, kp, vp, table_t, qpos_t, scale))
    # host time per call: the wrapper and its parts
    o = torch.empty((b, kvh, g, d), dtype=torch.bfloat16, device=DEV)
    plan = fa.paged_plan(per_slot * ps, b, kvh, g, _sms())
    fn = fa._fn("paged_decode", "paged_decode_attention", 6, 7, 2, 3)
    args = (q.data_ptr(), kp.data_ptr(), vp.data_ptr(), table_t.data_ptr(),
            qpos_t.data_ptr(), o.data_ptr(), b, kvh, g, d, d, ps, per_slot,
            scale, 0.0, 0, plan.n_split, plan.span,
            torch.cuda.current_stream().cuda_stream)
    host = {"paged_decode_attention_cuda": host_us(call),
            "C launch alone": host_us(lambda: fn(*args)),
            "paged_plan": host_us(lambda: fa.paged_plan(
                per_slot * ps, b, kvh, g, _sms()))}
    sets = _paged_inputs(gen, np.random.default_rng(0), b, kvh, g, d, ps,
                         per_slot,
                         n_sets=_sets_for(kp.shape[0], ps, kvh, d))[1]
    g_ms, lib_g = _paged_graph(q, sets, table_t, qpos_t, scale)
    del sets
    n_bytes, rows = _paged_bytes(q, table_t, qpos_t, ps, d)
    bd, by = bound_ms(n_bytes, 4 * rows * kvh * g * d, BF16_FLOPS)
    print(f"  paged timing (B={b}, KVH={kvh}, G={g}, d={d}, live rows "
          f"{rows}): kernel {ms:.4f} ms, graph {g_ms:.4f} ms, plain "
          f"{plain:.4f} ms, sdpa over gathered pages {lib:.4f} ms, graph "
          f"{lib_g:.4f} ms, bound {bd:.5f} ms ({by}); host time per call "
          f"(us): " + ", ".join(f"{k_} {v:.2f}" for k_, v in host.items()),
          flush=True)
    scaling = _paged_scaling(gen)
    return {"name": "paged_decode_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/paged_decode.cu",
            "replaces": "src/repro/kernels/flash_attention.py:182",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain,
            "bound_ms": bd, "bound_by": by, "library_ms": lib,
            "graph_ms": g_ms, "library_graph_ms": lib_g, "host_us": host,
            "scaling_graph_ms": scaling, "ptxas": ptxas,
            "shapes": f"B={b} KVH={kvh} G={g} d={d} page_size={ps} "
                      f"{per_slot} pages/slot"}


def _rel(a, b) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def _bwd_parts(q, k, v, lse, do, dmat, **kw):
    """The dq kernel alone and the dk/dv kernel alone, launched as
    ``flash_attention_bwd_cuda`` launches them (head width already the
    instance's; no counters: these launches only time the two halves)."""
    bh, sq, d = q.shape
    bkv, sk, dv = v.shape
    w = fa.bwd_width(d, dv)
    if (d, dv) != (w, w):
        raise ValueError("time the kernels at an instance width")
    dq = torch.empty((bh, sq, w), dtype=torch.float32, device=q.device)
    dk, dvo = (torch.empty((bkv, sk, w), dtype=torch.float32,
                           device=q.device) for _ in range(2))
    ptrs = [t.data_ptr() for t in (q, k, v, do, lse, dmat)]
    fdq = fa._fn("flash_attention_bwd", "flash_attention_bwd_dq", 7, 5, 2, 2)
    fdkv = fa._fn("flash_attention_bwd", "flash_attention_bwd_dkv", 8, 5, 2,
                  2)

    def args():                    # the current stream: a graph captures
        return [bh, sq, sk, w, kw["group"], float(kw["scale"]),
                float(kw.get("softcap", 0.0)), int(bool(kw["causal"])),
                int(kw.get("window", 0)),
                torch.cuda.current_stream(q.device).cuda_stream]

    def run_dq():
        _build.check(fdq(*ptrs, dq.data_ptr(), *args()), "bwd dq")

    def run_dkv():
        _build.check(fdkv(*ptrs, dk.data_ptr(), dvo.data_ptr(), *args()),
                     "bwd dkv")

    return run_dq, run_dkv


def _check_bwd(q, k, v, do, kw, label) -> float:
    """The backward kernels against the plain backward on one input, in
    relative Frobenius norm per gradient; returns the largest |error|."""
    o, lse = fa.flash_attention_fwd_cuda(q, k, v, **kw)
    dmat = (do.float() * o.float()).sum(-1)
    got = fa.flash_attention_bwd_cuda(q, k, v, lse, do, dmat, **kw)
    want = fa.flash_attention_bwd_plain(q, k, v, lse, do, dmat, **kw)
    torch.cuda.synchronize()
    errs = {n: _rel(a, b) for n, a, b in zip(("dq", "dk", "dv"), got, want)}
    err = max((a - b).abs().max().item() for a, b in zip(got, want))
    print(f"  flash bwd {label}: rel-norm err "
          + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
          + f" (bound {BWD_RTOL}); max|err| {err:.3e}", flush=True)
    if not max(errs.values()) <= BWD_RTOL:
        raise AssertionError(f"flash backward {label} disagrees with plain")
    return err


def check_flash_bwd(gen, fwd_row: dict) -> dict:
    """The backward at the training shape: qwen3-4b (32 query heads over
    8 KV heads, head_dim 128) at batch 8, seq 256.  The forward that feeds
    it is first held to its plain version at this shape too; its error is
    folded into ``fwd_row``, and its times at this shape (loop and CUDA
    graph, beside SDPA's forward both ways) and bound go into it as
    ``train_*``.  Then small checks of the 256-wide instance (head_dim
    256, MLA's 192 / 128)."""
    dev = DEV
    ptxas = _ptxas("flash_attention_bwd")
    bkv, group, s, d = 64, 4, 256, 128
    bh = bkv * group
    scale = 1.0 / math.sqrt(d)
    worst = 0.0
    for c in (dict(window=0, softcap=0.0), dict(window=64, softcap=30.0)):
        q, do = (torch.randn((bh, s, d), device=dev, generator=gen)
                 .bfloat16() for _ in range(2))
        k, v = (torch.randn((bkv, s, d), device=dev, generator=gen)
                .bfloat16() for _ in range(2))
        kw = dict(scale=scale, causal=True, group=group, **c)
        o, lse = fa.flash_attention_fwd_cuda(q, k, v, **kw)
        o_p, lse_p = fa.flash_attention_fwd_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        err_o = (o.float() - o_p.float()).abs().max().item()
        err_l = (lse - lse_p).abs().max().item()
        print(f"  flash fwd (training shape) {c}: max|o err| {err_o:.3e} "
              f"(atol {ATTN_ATOL}), max|lse err| {err_l:.3e} "
              f"(atol {LSE_ATOL})", flush=True)
        if not (err_o <= ATTN_ATOL and err_l <= LSE_ATOL):
            raise AssertionError(f"flash forward at the training shape {c} "
                                 f"disagrees with plain")
        fwd_row["max_abs_err"] = max(fwd_row["max_abs_err"], err_o)
        fwd_row["shapes"] += f"; checked at BH={bh} group={group} S={s} {c}"
        del o, lse, o_p, lse_p
        worst = max(worst, _check_bwd(q, k, v, do, kw,
                                      f"(training shape) {c}"))
    for dq_, dv_, s_ in ((256, 256, 200), (192, 128, 160)):
        qs = torch.randn((16, s_, dq_), device=dev, generator=gen).bfloat16()
        dos = torch.randn((16, s_, dv_), device=dev, generator=gen).bfloat16()
        ks = torch.randn((4, s_, dq_), device=dev, generator=gen).bfloat16()
        vs = torch.randn((4, s_, dv_), device=dev, generator=gen).bfloat16()
        kw = dict(scale=dq_ ** -0.5, causal=True, group=4, window=0,
                  softcap=0.0)
        worst = max(worst, _check_bwd(qs, ks, vs, dos, kw,
                                      f"(BH=16 group=4 S={s_} d={dq_} "
                                      f"dv={dv_})"))
    # rows with no key in their window (q >= Sk + window - 1): lse -1e30,
    # p = 1 on every key, as in the reference
    for causal, sq_, sk_, window in ((False, 100, 40, 20), (True, 60, 40, 8)):
        qs, dos = (torch.randn((16, sq_, d), device=dev, generator=gen)
                   .bfloat16() for _ in range(2))
        ks, vs = (torch.randn((4, sk_, d), device=dev, generator=gen)
                  .bfloat16() for _ in range(2))
        kw = dict(scale=scale, causal=causal, group=4, window=window,
                  softcap=0.0)
        worst = max(worst, _check_bwd(qs, ks, vs, dos, kw,
                                      f"no key in window (BH=16 group=4 "
                                      f"Sq={sq_} Sk={sk_} causal={causal} "
                                      f"window={window})"))
    kw = dict(scale=scale, causal=True, group=group)
    o, lse = fa.flash_attention_fwd_cuda(q, k, v, **kw)
    dmat = (do.float() * o.float()).sum(-1)

    def pair():
        return fa.flash_attention_bwd_cuda(q, k, v, lse, do, dmat, **kw)

    ms = cuda_ms(pair)
    g_ms = graph_ms(pair)
    run_dq, run_dkv = _bwd_parts(q, k, v, lse, do, dmat, **kw)
    dq_ms, dkv_ms = graph_ms(run_dq), graph_ms(run_dkv)
    plain = cuda_ms(lambda: fa.flash_attention_bwd_plain(q, k, v, lse, do,
                                                         dmat, **kw), iters=5)
    t = _time_fwd(q, k, v, kw, heads=32)
    (fb, fby), fbytes, fflops = _fwd_bound(bh, group, s, d)
    fwd_row.update(train_ms=t["ms"], train_graph_ms=t["graph_ms"],
                   library_train_ms=t["library_ms"],
                   library_train_graph_ms=t["library_graph_ms"],
                   train_bound_ms=fb)
    scaling = _fwd_scaling(gen)
    fwd_row["scaling_graph_ms"] = scaling
    print(f"  flash fwd timing (training shape, BH={bh}, G={group}, S={s}, "
          f"d={d}): kernel {t['ms']:.4f} "
          f"ms, graph {t['graph_ms']:.4f} ms; sdpa (GQA) {t['library_ms']:.4f}"
          f" ms, graph {t['library_graph_ms']:.4f} ms; bound {fb:.5f} ms "
          f"({fby}, {fbytes / 1e6:.1f} MB, {fflops / 1e9:.2f} GFLOP)",
          flush=True)
    # yardstick: SDPA forward + backward with the KV heads expanded, minus
    # SDPA's forward alone
    b = bkv // 8
    qq = q.reshape(b, 32, s, d).detach().requires_grad_(True)
    kk, vv = (t.reshape(b, 8, s, d).repeat_interleave(group, 1).detach()
              .requires_grad_(True) for t in (k, v))
    do4 = do.reshape(b, 32, s, d)

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            qq, kk, vv, is_causal=True, scale=scale)

    def sdpa_fwd_bwd():
        return torch.autograd.grad(sdpa(), (qq, kk, vv), do4)

    t_fb = cuda_ms(sdpa_fwd_bwd)
    t_f = cuda_ms(sdpa)
    lib = t_fb - t_f
    g_fb, g_f = graph_ms(sdpa_fwd_bwd), graph_ms(sdpa)
    lib_graph = g_fb - g_f
    n_bytes = 2 * (q.numel() + k.numel() + v.numel() + do.numel()) \
        + 4 * (lse.numel() + dmat.numel()) \
        + 4 * (q.numel() + k.numel() + v.numel())
    pairs = bh * s * (s + 1) // 2
    flops = 10 * d * pairs
    bd, by = bound_ms(n_bytes, flops, BF16_FLOPS)
    print(f"  flash bwd timing (BH={bh}, G={group}, S={s}, d={d}): kernels "
          f"{ms:.4f} ms in a loop, {g_ms:.4f} ms in a CUDA graph (dq "
          f"{dq_ms:.4f}, dk/dv {dkv_ms:.4f}), plain {plain:.4f} ms, sdpa "
          f"fwd+bwd {t_fb:.4f} - fwd {t_f:.4f} = {lib:.4f} ms (in a CUDA "
          f"graph {g_fb:.4f} - {g_f:.4f} = {lib_graph:.4f} ms), bound "
          f"{bd:.5f} ms ({by}, {n_bytes / 1e6:.1f} MB, {flops / 1e9:.2f} "
          f"GFLOP)", flush=True)
    return {"name": "flash_attention_bwd", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
            "replaces": "src/repro/kernels/flash_attention.py:321",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain,
            "bound_ms": bd, "bound_by": by, "library_ms": lib,
            "graph_ms": g_ms, "library_graph_ms": lib_graph,
            "dq_graph_ms": dq_ms, "dkv_graph_ms": dkv_ms,
            "ptxas": ptxas,
            "shapes": f"BH={bh} group={group} Sq=Sk={s} d={d} causal "
                      f"(dq + dk/dv kernels)"}


def check_attention_f32(gen) -> dict:
    """The f32 routes of the three attention entry points (the SIMT kernels
    of ``csrc/attention_f32.cu``) against their plain versions at small
    shapes: forward (causal with window and softcap, the 256-wide instance,
    no causal mask), paged decode (a group of 20 over two head chunks) and
    the backward.  Each route's own counter must show one launch per call
    and the bf16 counters none."""
    dev = DEV
    _ptxas("attention_f32")
    errs = {}

    def counted(names, fn):
        before = {attr: getattr(fa, attr)
                  for mod, attr in COUNTERS.values() if mod is fa}
        out = fn()
        torch.cuda.synchronize()
        got = {n: getattr(fa, n) - before[n] for n in before}
        want = {n: int(n in names) for n in before}
        if got != want:
            raise AssertionError(f"f32 route launches {got}, expected {want}")
        return out

    for name, (bkv, group, s, sk, d, dv, causal, window, softcap) in {
            "fwd": (2, 4, 100, 100, 128, 128, True, 40, 30.0),
            "fwd d=256": (2, 2, 70, 70, 256, 256, True, 0, 0.0),
            "fwd 192/128 non-causal": (2, 2, 50, 90, 192, 128, False, 0,
                                       0.0),
            "fwd no key in window": (2, 2, 100, 40, 128, 128, False, 20,
                                     0.0),
            "bwd": (2, 4, 130, 130, 128, 128, True, 64, 20.0),
            "bwd d=256": (2, 2, 70, 70, 256, 256, True, 0, 0.0),
            "bwd no key in window": (2, 2, 100, 40, 128, 128, False, 20,
                                     0.0)}.items():
        q = torch.randn((bkv * group, s, d), device=dev, generator=gen)
        k = torch.randn((bkv, sk, d), device=dev, generator=gen)
        v = torch.randn((bkv, sk, dv), device=dev, generator=gen)
        kw = dict(scale=d ** -0.5, causal=causal, window=window,
                  softcap=softcap, group=group)
        if name.startswith("fwd"):
            o, lse = counted(("fwd_f32_launches",),
                             lambda: fa.flash_attention_fwd_cuda(q, k, v,
                                                                 **kw))
            o_p, lse_p = fa.flash_attention_fwd_plain(q, k, v, **kw)
            errs[name] = max((o - o_p).abs().max().item(),
                             (lse - lse_p).abs().max().item())
            what = "max|o, lse err|"
        else:
            do = torch.randn((bkv * group, s, dv), device=dev, generator=gen)
            o, lse = fa.flash_attention_fwd_plain(q, k, v, **kw)
            dmat = (do * o).sum(-1)
            got = counted(("bwd_f32_dq_launches", "bwd_f32_dkv_launches"),
                          lambda: fa.flash_attention_bwd_cuda(
                              q, k, v, lse, do, dmat, **kw))
            want = fa.flash_attention_bwd_plain(q, k, v, lse, do, dmat, **kw)
            errs[name] = max(_rel(a, b) for a, b in zip(got, want))
            what = "rel-norm err of dq, dk, dv"
        print(f"  f32 {name} (BKV={bkv} group={group} Sq={s} Sk={sk} d={d} "
              f"dv={dv} causal={causal} window={window} softcap={softcap}): "
              f"{what} {errs[name]:.3e} (tol {F32_TOL})", flush=True)
    rng = np.random.default_rng(1)
    b, kvh, g, d, ps, per_slot = 3, 2, 20, 128, 16, 6
    num_pages = b * per_slot + 1
    kp, vp = (torch.randn((num_pages, ps, kvh, d), device=dev, generator=gen)
              for _ in range(2))
    q = torch.randn((b, kvh, g, d), device=dev, generator=gen)
    q_pos = rng.integers(0, per_slot * ps, b).astype(np.int32)
    perm = rng.permutation(np.arange(1, num_pages)).reshape(b, per_slot)
    table = np.zeros((b, per_slot), np.int32)
    for i in range(b):
        table[i, :q_pos[i] // ps + 1] = perm[i, :q_pos[i] // ps + 1]
    args = (q, kp, vp, torch.as_tensor(table, device=dev),
            torch.as_tensor(q_pos, device=dev))
    kw = dict(scale=d ** -0.5, window=48, softcap=30.0)
    o = counted(("paged_f32_launches",),
                lambda: fa.paged_decode_attention_cuda(*args, **kw))
    errs["paged"] = (o - fa.paged_decode_attention_plain(*args, **kw)) \
        .abs().max().item()
    print(f"  f32 paged (B={b} KVH={kvh} G={g} d={d} window=48 softcap=30): "
          f"max|err| {errs['paged']:.3e} (tol {F32_TOL})", flush=True)
    bad = {n: e for n, e in errs.items() if not e <= F32_TOL}
    if bad:
        raise AssertionError(f"f32 attention routes disagree with plain: "
                             f"{bad}")
    return errs


def check_lut(gen) -> dict:
    dev = DEV
    for ln in _build.build_logs.get("lut_matmul", "").splitlines():
        if "entry function" in ln or "registers" in ln or "spill" in ln:
            print(f"  [lut_matmul ptxas] {ln.strip()}")
    # the main path's shapes, plus one decode row at N = 512 and a ragged
    # row tile at N = 4096 (the kernel's split of K and its row tiles)
    for m, k, n in MM_CHECK_SHAPES + [(1, 4096, 512), (65, 4096, 4096)]:
        x = torch.randint(-128, 128, (m, k), dtype=torch.int8, device=dev,
                          generator=gen)
        wt = torch.randint(-128, 128, (n, k), dtype=torch.int8, device=dev,
                           generator=gen)
        x[0, :2] = torch.tensor([-128, 127], dtype=torch.int8)
        wt[:2, 0] = torch.tensor([-128, 127], dtype=torch.int8)
        x[:, 0] = -128        # t_hi's extreme, (-8 << 4) * -128, in every row
        got = lm.lut_matmul_cuda(x, wt.t())
        plain = lm.lut_matmul_plain(x, wt.t())
        nib = nm.nibble_matmul_cuda(x, wt.t())
        torch.cuda.synchronize()
        if not (torch.equal(got, plain) and torch.equal(got, nib)):
            raise AssertionError(f"LUT matmul ({m},{k},{n}) differs from "
                                 f"its plain version or the nibble kernel")
        print(f"  lut ({m},{k},{n}): torch.equal to plain and to the nibble "
              f"kernel's int32", flush=True)
    ms = plain = lib = dev_ms = lib_dev = 0.0
    n_bytes = ops = 0
    prefill = {}
    for name, m, k, n in MM_SHAPES_DECODE + [("prefill-up", 128, 4096,
                                              11008)]:
        x = torch.randint(-128, 128, (m, k), dtype=torch.int8, device=dev,
                          generator=gen)
        wt = torch.randint(-128, 128, (n, k), dtype=torch.int8, device=dev,
                           generator=gen)
        t_k = cuda_ms(lambda: lm.lut_matmul_cuda(x, wt.t()))
        t_p = cuda_ms(lambda: lm.lut_matmul_plain(x, wt.t()), iters=5)
        t_l = _int_mm_ms(x, wt)
        # device time alone (host time of each call excluded), beside the
        # nibble kernel's and _int_mm's at the same shape
        t_g = graph_ms(lambda: lm.lut_matmul_cuda(x, wt.t()))
        t_gn = graph_ms(lambda: nm.nibble_matmul_cuda(x, wt.t()))
        t_gl = _int_mm_ms(x, wt, timer=graph_ms)
        print(f"  lut {name} ({m},{k},{n}): kernel {t_k:.4f} ms, plain "
              f"{t_p:.4f} ms, _int_mm {t_l} ms; in a CUDA graph: kernel "
              f"{t_g:.4f} ms, nibble kernel {t_gn:.4f} ms, _int_mm {t_gl} "
              f"ms", flush=True)
        if name == "prefill-up":
            prefill = {"prefill_ms": t_k, "prefill_graph_ms": t_g,
                       "prefill_int_mm_ms": t_l, "prefill_int_mm_graph_ms":
                       t_gl}
            continue
        ms += t_k
        plain += t_p
        dev_ms += t_g
        lib = None if (lib is None or t_l is None) else lib + t_l
        lib_dev = None if (lib_dev is None or t_gl is None) else \
            lib_dev + t_gl
        n_bytes += m * k + k * n + 4 * m * n
        ops += 2 * m * n * k
    b, by = bound_ms(n_bytes, ops, INT8_OPS)
    print(f"  lut decode layer: kernel {ms:.4f} ms ({dev_ms:.4f} ms in a "
          f"CUDA graph), _int_mm {lib} ms ({lib_dev} ms in a CUDA graph), "
          f"bound {b:.4f} ms ({by})", flush=True)
    return {"name": "lut_matmul", "route": "cuda",
            "source": "src/repro_torch/csrc/lut_matmul.cu",
            "replaces": "src/repro/kernels/lut_matmul.py:87",
            "max_abs_err": 0.0, "ms": ms, "plain_ms": plain,
            "bound_ms": b, "bound_by": by, "library_ms": lib,
            "graph_ms": dev_ms, "library_graph_ms": lib_dev, **prefill,
            "shapes": "one decode layer: wq,wk,wv,wo,gate,up,down at M=4"}


# Table 2 of the paper: cycles per operand and for 16 operands
PAPER_TABLE2 = {"shift_add": (8, 128), "booth_radix2": (4, 64),
                "nibble_precompute": (2, 32), "wallace": (1, 1),
                "lut_array": (1, 1)}
# the exhaustive 8-bit sweeps: (architecture, signed operands)
PAPER_SWEEPS = [("shift_add", False), ("wallace", False),
                ("lut_array", False), ("nibble_precompute", False),
                ("booth_radix2", True), ("nibble_precompute", True)]


def _sweep_8bit(arch: str, signed: bool) -> int:
    """Every (a, b) of the 8-bit range through one multiplier model on the
    card: a 256-lane vector per broadcast b.  Fails on a wrong product or
    a cycle count other than ``cycle_model.total_cycles``; returns the
    number of products checked."""
    lanes = (torch.arange(-128, 128, device=DEV) if signed
             else torch.arange(256, device=DEV))
    kw = {"signed": True} if signed and arch == "nibble_precompute" else {}
    cycles = cycle_model.total_cycles(arch, lanes.numel())
    wrong = torch.zeros((), dtype=torch.int64, device=DEV)
    for b in lanes.tolist():
        tr = tmul.MULTIPLIERS[arch](lanes, b, **kw)
        if tr.cycles != cycles or tr.products.device != lanes.device:
            raise AssertionError(f"{arch}: {tr.cycles} cycles on "
                                 f"{tr.products.device}, expected {cycles}")
        wrong += (tr.products != lanes * b).sum()
    if int(wrong):
        raise AssertionError(f"{arch} (signed={signed}): {int(wrong)} wrong "
                             f"products of 65536")
    return lanes.numel() ** 2


def _paper_tables() -> dict:
    """Table 2, Fig. 3 and the Fig. 4 ratios from the port, held to the
    paper's values and to ``tests/test_cycle_model.py``'s bounds."""
    out = {"table2": {}}
    a16 = torch.arange(16, device=DEV)
    for arch, (per_op, total_16) in PAPER_TABLE2.items():
        tr = tmul.MULTIPLIERS[arch](a16, 7)
        got = (tr.cycles_per_operand, tr.cycles,
               cycle_model.cycles_per_operand(arch),
               cycle_model.total_cycles(arch, 16))
        print(f"  table2 {arch}: cycles/operand {got[0]} (model {got[2]}, "
              f"paper {per_op}), 16 operands {got[1]} (model {got[3]}, "
              f"paper {total_16})", flush=True)
        if got != (per_op, total_16, per_op, total_16):
            raise AssertionError(f"Table 2 {arch}: {got}")
        out["table2"][arch] = got[:2]
    a = torch.as_tensor(np.random.default_rng(42).integers(0, 256, 8),
                        device=DEV)
    for arch, want in (("nibble_precompute", 16), ("lut_array", 1)):
        tr = tmul.MULTIPLIERS[arch](a, 0xB7)
        exact = torch.equal(tr.products, (a * 0xB7).int())
        print(f"  fig3 {arch}: 8 operands, b = 0xB7, {tr.cycles} cycles "
              f"(paper {want}), products exact {exact}", flush=True)
        if not exact or tr.cycles != want:
            raise AssertionError(f"Fig. 3 {arch}")
        out[f"fig3_{arch}_cycles"] = tr.cycles
    ratios = {
        "area_vs_shift_add": (cycle_model.improvement_vs(
            "shift_add", "nibble_precompute", "area", 16), 1.69, 0.02),
        "power_vs_shift_add": (cycle_model.improvement_vs(
            "shift_add", "nibble_precompute", "power", 16), 1.63, 0.03),
        "area_vs_lut_array": (cycle_model.improvement_vs(
            "lut_array", "nibble_precompute", "area", 16), 2.6, 0.1)}
    for name, (r, paper, tol) in ratios.items():
        print(f"  fig4 {name} at 16 operands: {r:.4f}x (paper {paper}x, "
              f"held within {tol})", flush=True)
        if abs(r - paper) >= tol:
            raise AssertionError(f"Fig. 4 {name}: {r}")
        out[f"fig4_{name}"] = r
    r = cycle_model.improvement_vs("lut_array", "nibble_precompute", "power",
                                   16)
    print(f"  fig4 power_vs_lut_array at 16 operands: {r:.4f}x (paper: "
          f"over 2.7x)", flush=True)
    if not r > 2.7:
        raise AssertionError(f"Fig. 4 power_vs_lut_array: {r}")
    out["fig4_power_vs_lut_array"] = r
    return out


def _link_nibble_kernel(gen, m=4, k=4096, n=4096, k_chunk=256) -> dict:
    """The paper's model against kernel rows 1 and 5 at yi-6b's ``wq`` at
    decode: int8 x (m, k) and w (k, n); Algorithm 2's signed products
    ``nibble_precompute(w[k, :], x[i, k], signed=True)`` (the lanes are a
    weight row, the broadcast operand an activation, as in the kernel's
    shared weight tile) summed over k on the card, ``k_chunk`` rows of w
    at a time, must equal ``ops.nibble_matmul`` and ``ops.lut_matmul``;
    ``ops.quant_matmul_fused`` must equal ``ops.quant_matmul`` on
    ``quantize_rows``'s output."""
    x = torch.randint(-128, 128, (m, k), dtype=torch.int8, device=DEV,
                      generator=gen)
    w = torch.randint(-128, 128, (k, n), dtype=torch.int8, device=DEV,
                      generator=gen)
    x[:, 0] = -128                       # the extreme products at k = 0
    w[0, :2] = torch.tensor([-128, 127], dtype=torch.int8)
    torch.cuda.synchronize()
    t = time.perf_counter()
    acc = torch.zeros((m, n), dtype=torch.int32, device=DEV)
    for k0 in range(0, k, k_chunk):
        tr = tmul.nibble_precompute(w[None, k0:k0 + k_chunk],
                                    x[:, k0:k0 + k_chunk, None], signed=True)
        acc += tr.products.sum(1, dtype=torch.int32)
    torch.cuda.synchronize()
    model_ms = (time.perf_counter() - t) * 1e3
    row1 = kops.nibble_matmul(x, w)
    row5 = kops.lut_matmul(x, w)
    xf = torch.randn((m, k), device=DEV, generator=gen).bfloat16()
    ws = torch.rand((1, n), device=DEV, generator=gen) * 0.01 + 1e-4
    fused = kops.quant_matmul_fused(xf, w, ws)
    xq, xs = quantize_rows(xf)
    unfused = kops.quant_matmul(xq, w, x_scale=xs, w_scale=ws)
    checks = {"row 1 (nibble_matmul)": torch.equal(row1, acc),
              "row 5 (lut_matmul)": torch.equal(row5, acc),
              "quant_matmul_fused": torch.equal(fused, unfused)}
    print(f"  link ({m},{k},{n}): Algorithm 2 summed over k on the card in "
          f"{model_ms:.1f} ms; {checks}", flush=True)
    if not all(checks.values()):
        raise AssertionError(f"paper model vs kernels: {checks}")
    return {"link_shape": [m, k, n], "link_model_ms": model_ms}


def phase_paper() -> dict:
    """The paper's multiplier layer on the card: the exhaustive 8-bit
    products of the five models and the 16-bit LUT array, Table 2, Fig. 3
    and Fig. 4 from the port's cycle model, and the link from Algorithm 2
    to kernel rows 1 and 5 (launch counters zeroed just before, read just
    after)."""
    t0 = time.perf_counter()
    reset_counts()
    out = {"sweeps": {}}
    for arch, signed in PAPER_SWEEPS:
        t = time.perf_counter()
        n = _sweep_8bit(arch, signed)
        torch.cuda.synchronize()
        label = f"{arch}{' signed' if signed else ''}"
        ms = (time.perf_counter() - t) * 1e3
        print(f"  {label}: {n} products exact, cycles = total_cycles "
              f"({ms:.1f} ms)", flush=True)
        out["sweeps"][label] = ms
    t = time.perf_counter()
    a16 = torch.arange(65536, device=DEV)
    wrong = torch.zeros((), dtype=torch.int64, device=DEV)
    for b in range(256):
        o1, o2 = tmul.lut_array_16bit(a16, b)
        wrong += ((o1.long() + (o2.long() << 8)) != a16 * b).sum()
    if int(wrong):
        raise AssertionError(f"lut_array_16bit: {int(wrong)} wrong products")
    ms = (time.perf_counter() - t) * 1e3
    print(f"  lut_array_16bit: {65536 * 256} products exact ({ms:.1f} ms)",
          flush=True)
    out["sweeps"]["lut_array_16bit"] = ms
    out.update(_paper_tables())
    out.update(_link_nibble_kernel(
        torch.Generator(device=DEV).manual_seed(0)))
    out["counts"] = read_counts()
    require_launched(out["counts"], ("nibble_matmul", "lut_matmul"))
    out["wall_s"] = time.perf_counter() - t0
    print(f"paper: {out['wall_s']:.1f} s; launches nibble "
          f"{out['counts']['nibble_matmul']}, lut "
          f"{out['counts']['lut_matmul']}", flush=True)
    return out


COUNTERS = {
    "nibble_matmul": (nm, "launches"),
    "flash_attention_fwd": (fa, "fwd_launches"),
    "paged_decode_attention": (fa, "paged_launches"),
    "flash_attention_bwd_dq": (fa, "bwd_dq_launches"),
    "flash_attention_bwd_dkv": (fa, "bwd_dkv_launches"),
    "lut_matmul": (lm, "lut_launches"),
    "flash_attention_fwd_f32": (fa, "fwd_f32_launches"),
    "paged_decode_attention_f32": (fa, "paged_f32_launches"),
    "flash_attention_bwd_dq_f32": (fa, "bwd_f32_dq_launches"),
    "flash_attention_bwd_dkv_f32": (fa, "bwd_f32_dkv_launches"),
}


def reset_counts() -> None:
    for mod, attr in COUNTERS.values():
        setattr(mod, attr, 0)


def read_counts() -> dict:
    return {name: getattr(mod, attr)
            for name, (mod, attr) in COUNTERS.items()}


def require_launched(counts: dict, names) -> None:
    missing = [n for n in names if counts[n] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: "
                             f"{missing}")


F32_ROUTES = ("flash_attention_fwd_f32", "paged_decode_attention_f32",
              "flash_attention_bwd_dq_f32", "flash_attention_bwd_dkv_f32")


def require_no_f32(counts: dict) -> None:
    """The model paths feed bf16: an f32 route launched there would be a
    path that fell onto the slow SIMT kernels."""
    used = {n: counts[n] for n in F32_ROUTES if counts[n]}
    if used:
        raise AssertionError(f"f32 attention routes launched on a bf16 "
                             f"main path: {used}")


SPEC_CAPTURES = {"decode_chunk": 0, "draft": 1, "verify": 1}


def require_captured(engine, label: str) -> dict:
    """A warm engine holds one CUDA graph per captured stage: the decode
    chunk, or under ``spec_decode`` the draft and the verify."""
    want = SPEC_CAPTURES if engine.scfg.spec_decode else {"decode_chunk": 1}
    got = engine.capture_counts
    if got != want:
        raise AssertionError(f"{label}: CUDA graphs {got}, expected {want}")
    return got


def _check_streams(streams: dict, n_new: int, vocab: int) -> None:
    for n, toks in streams.items():
        if len(toks) != n_new or not all(0 <= x < vocab for x in toks):
            raise AssertionError(f"request {n}: bad stream {toks}")


def _serve_timed(engine, prompts, n_new) -> tuple:
    """A warm-up request (first-call allocations), then ``prompts``
    through ``submit``/``run`` with the launch counters zeroed just before
    and read just after; every stream complete, no page leaked.  Returns
    ``(streams, wall seconds, counts)``."""
    engine.submit(prompts[0], 2)
    engine.run()
    torch.cuda.synchronize()
    reset_counts()
    t = time.perf_counter()
    ids = [engine.submit(p, n_new) for p in prompts]
    done = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = read_counts()
    streams = [done[i].tokens for i in ids]
    _check_streams(dict(enumerate(streams)), n_new, engine.cfg.vocab_size)
    if engine.leaked_pages():
        raise AssertionError(f"{engine.leaked_pages()} pages leaked")
    return streams, wall, counts


_QUANT_LEAVES = ("qt8", "s8", "qt4", "s4")


def param_line(cfg, params) -> dict:
    """``cfg.param_count()`` (the analytical count, total and active)
    beside what the built tree holds: its elements without the prepared
    int8 copies and their scales, and its bytes with them.  Printed only:
    the CPU tests hold the count."""
    leaves = [(p, t) for p, t in tree_paths(params)
              if isinstance(t, torch.Tensor)]
    n = sum(t.numel() for p, t in leaves
            if p.rsplit("/", 1)[-1] not in _QUANT_LEAVES)
    n_bytes = sum(t.numel() * t.element_size() for _, t in leaves)
    out = {"param_count": cfg.param_count(),
           "param_count_active": cfg.param_count(active_only=True),
           "tree_elements": n, "tree_bytes": n_bytes}
    print(f"  {cfg.name} at n_layers={cfg.n_layers}: param_count() "
          f"{out['param_count']} (active {out['param_count_active']}); the "
          f"tree holds {n} elements without its int8 copies, "
          f"{n_bytes / 2**30:.3f} GiB with them", flush=True)
    return out


def phase_serve() -> dict:
    cfg = get_config("yi-6b").replace(
        quant_mode="w8a8_nibble", quant_backend="cuda", attn_impl="flash",
        cache_mode="paged", page_size=16)
    print(f"serve: {cfg.name} n_layers={cfg.n_layers} d_model={cfg.d_model} "
          f"heads={cfg.n_heads}/{cfg.n_kv_heads} head_dim={cfg.head_dim} "
          f"d_ff={cfg.d_ff} vocab={cfg.vocab_size} (full width, all layers)",
          flush=True)
    t = time.perf_counter()
    params = model_init(cfg, seed=0, device=DEV)
    torch.cuda.synchronize()
    print(f"  weights built and quantized in {time.perf_counter() - t:.1f} s"
          f", {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated",
          flush=True)
    params_line = param_line(cfg, params)
    n_req, n_new, prefill_len = 8, 32, 128
    scfg = ServeConfig(batch=4, max_len=prefill_len + n_new,
                       prefill_len=prefill_len, decode_chunk=8)
    engine = Engine(cfg, params, scfg, device=DEV)
    rng = np.random.default_rng(0)
    lens = rng.integers(32, prefill_len + 1, n_req)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in lens]
    streams, wall, counts = _serve_timed(engine, prompts, n_new)
    n_tok = sum(map(len, streams))
    print(f"  served {n_req} requests (prompt lengths {lens.tolist()}), "
          f"{n_tok} tokens in {wall:.3f} s: {n_tok / wall:.2f} tok/s "
          f"({engine.decode_chunks} decode chunks)", flush=True)
    print(f"  launches in the serve run: {counts}", flush=True)
    for i in range(2):
        print(f"  request {i} first tokens: {streams[i][:8]}")
    require_launched(counts, ("nibble_matmul", "flash_attention_fwd",
                              "paged_decode_attention"))
    require_no_f32(counts)
    captures = require_captured(engine, "serve")

    # the first request's prefill: kernel path vs plain path
    held = hold_plain_prefill(params, cfg, prompts[0], prefill_len)
    diff, tol = held["logit_diff"], held["logit_tol"]
    print(f"  prefill logits kernel vs plain path: max|diff| {diff:.4e}, "
          f"max|logit| {tol / LOGIT_RTOL:.4f}, tolerance {tol:.4e}; "
          f"argmax {held['argmax'][0]} vs {held['argmax'][1]}; first "
          f"served token {streams[0][0]}", flush=True)
    return {"counts": counts, "tok_s": n_tok / wall, "wall_s": wall,
            "decode_chunks": engine.decode_chunks, "logit_diff": diff,
            "logit_tol": tol, "captures": captures, "engine": engine,
            "prompts": prompts, "streams": streams, "params": params,
            "param_count": params_line}


def time_decode_chunks(cfg, params, prompts, reps=7) -> dict:
    """Host milliseconds per decode chunk (4 active slots, the serve
    phase's settings) of an eager engine, a captured one and a captured
    one sampling at temperature 0.7, each warmed by one chunk (the
    capture), then ``reps`` chunks each in rotating order, every chunk
    ending in its host read; medians."""
    n_new = 8 * (reps + 2)
    scfg = ServeConfig(batch=4, max_len=128 + n_new + (-n_new) % 16,
                       prefill_len=128, decode_chunk=8)
    engines = {
        "eager": Engine(cfg, params, scfg, device=DEV, capture=False),
        "captured": Engine(cfg, params, scfg, device=DEV),
        "captured_sampled": Engine(cfg, params, dataclasses.replace(
            scfg, temperature=0.7), device=DEV)}
    for eng in engines.values():
        for p in prompts[:4]:
            eng.submit(p, n_new)
        eng.start()
        eng._admit(0.0)
        eng._run_chunk(0.0)
    names = list(engines)
    runs = {name: [] for name in names}
    for i in range(reps):
        for name in names[i % 3:] + names[:i % 3]:
            torch.cuda.synchronize()
            t = time.perf_counter()
            engines[name]._run_chunk(0.0)
            runs[name].append((time.perf_counter() - t) * 1e3)
    if not all(e._active.all() for e in engines.values()):
        raise AssertionError("a slot finished inside the timed chunks")
    require_captured(engines["captured"], "timed chunks")
    require_captured(engines["captured_sampled"], "timed sampled chunks")
    return {"ms": {n: statistics.median(r) for n, r in runs.items()},
            "runs": runs}


def _static_row(stage, sig, pools) -> dict:
    """One stage walk's static counts and roofline terms."""
    from repro_torch.roofline.analysis import stage_roofline
    from repro_torch.staticcheck.flops import walk_stage
    walk, _ = walk_stage(stage, sig, pools)
    row = walk.cost.to_dict()
    row["roofline"] = stage_roofline(row)
    return row


def phase_static(engine, smi: str) -> dict:
    """The gate's grid on the card against the CPU walk, then the serve
    phase's drained engine: static rows of its captured decode chunk and
    its prefill beside the chunk's measured time (see the docstring,
    3c)."""
    from repro_torch.staticcheck import runner
    from repro_torch.staticcheck.flops import analytic_macs
    from repro_torch.tree import tree_leaves
    t_phase = time.perf_counter()
    card_f, card = runner.run_graph_layer(device=DEV)
    cpu_f, cpu = runner.run_graph_layer(device="cpu")
    for label, f in (("card", card_f), ("CPU", cpu_f)):
        if f:
            raise AssertionError(f"static gate on the {label}: "
                                 + "; ".join(x.render() for x in f))
    cpu_macs = {(r["cell"], r["stage"], r["signature"]):
                (r["int_dot_macs"], r["float_dot_macs"]) for r in cpu}
    plain_of = {"nibble-cuda": "nibble"}
    for r in card:
        key = (plain_of.get(r["cell"], r["cell"]), r["stage"],
               r["signature"])
        got = (r["int_dot_macs"], r["float_dot_macs"])
        if cpu_macs.get(key) != got:
            raise AssertionError(f"static MACs of {r['cell']}/{r['stage']} "
                                 f"on the card {got} != the CPU walk's "
                                 f"{cpu_macs.get(key)}")
    print(f"static: gate clean on the card ({len(card)} stage walks over "
          f"{[c.name for c in runner.GRID_CELLS]}, captured) and on the CPU "
          f"({len(cpu)}); static MACs per stage equal on both, nibble-cuda "
          f"(flash + paged kernels) against the CPU's nibble: "
          + ", ".join(f"{r['cell']}/{r['stage']} {r['dot_macs']}"
                      for r in card), flush=True)

    stages = engine.stage_programs()
    pools = tree_leaves(engine._caches)
    rows = {name: _static_row(stages[name], stages[name].signatures[0],
                              pools) for name in ("decode_chunk", "prefill")}
    engine.reset()
    cfg, scfg = engine.cfg, engine.scfg
    geo = {"decode_chunk": dict(tokens=scfg.batch * scfg.decode_chunk,
                                kv_len=scfg.max_len,
                                logit_positions=scfg.batch
                                * scfg.decode_chunk),
           "prefill": dict(tokens=scfg.prefill_len,
                           kv_len=scfg.prefill_len, logit_positions=1)}
    for name, row in rows.items():
        want = analytic_macs(cfg, quantized=True, **geo[name])
        row["analytic_macs"] = want["total_macs"]
        if row["dot_macs"] != want["total_macs"]:
            raise AssertionError(f"serve cell {name}: static MACs "
                                 f"{row['dot_macs']} != analytic {want}")
    # the chunk's graph, replayed on its static buffers (CUDA events)
    chunk = stages["decode_chunk"]
    sig = chunk.signatures[0]
    for _ in range(2):
        chunk.rerun(sig)
    reps, a, b = 10, torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for _ in range(reps):
        chunk.rerun(sig)
    b.record()
    torch.cuda.synchronize()
    replay_ms = a.elapsed_time(b) / reps
    for name, row in rows.items():
        r = row["roofline"]
        print(f"  serve cell {name} ({cfg.name} full width, 4 slots, max_len "
              f"{scfg.max_len}, decode_chunk {scfg.decode_chunk}): MACs "
              f"{row['dot_macs']} (int {row['int_dot_macs']}, analytic "
              f"{row['analytic_macs']}), flops {row['total_flops']}, "
              f"io_bytes {row['io_bytes']}, bytes_accessed "
              f"{row['bytes_accessed']}, padding MACs "
              f"{row['padding_macs']}; roofline compute "
              f"{r['compute_s'] * 1e3:.4f} ms, memory "
              f"{r['memory_s'] * 1e3:.4f} ms, step {r['step_s'] * 1e3:.4f} "
              f"ms ({r['dominant']}, intensity "
              f"{r['arithmetic_intensity']:.1f} against the mix's ridge "
              f"{r['ridge_intensity']:.1f}; int8 {r['ridge_int8']:.1f}, bf16 "
              f"{r['ridge_bf16']:.1f})", flush=True)
    step = rows["decode_chunk"]["roofline"]["step_s"] * 1e3
    print(f"  captured decode chunk measured ({smi}): graph replay "
          f"{replay_ms:.3f} ms (CUDA events, {reps} replays, max_len "
          f"{scfg.max_len}); step_s / measured {step / replay_ms:.4f}",
          flush=True)
    wall = time.perf_counter() - t_phase
    print(f"  static phase {wall:.1f} s", flush=True)
    return {"grid_card": card, "grid_cpu": cpu, "serve_rows": rows,
            "replay_ms": replay_ms, "step_over_replay": step / replay_ms,
            "wall_s": wall}


def check_sampler(n_keys=64, vocab=64000) -> dict:
    """``serve/sampling.py`` on the card against the CPU for the same f32
    logits and keys: key words and uniform bits equal; categorical tokens
    equal except where the CPU's top two perturbed scores lie within
    1e-5 (the card's ``log`` may round otherwise)."""
    keys = sampling.fold_in(sampling.prng_key(0)[None],
                            torch.arange(n_keys))
    sub = sampling.fold_in(keys, 7)
    keys_equal = torch.equal(sampling.fold_in(keys.to(DEV), 7).cpu(), sub)
    bits_equal = torch.equal(
        sampling.random_bits(keys.to(DEV), (vocab,)).cpu(),
        sampling.random_bits(keys, (vocab,)))
    uniform_equal = torch.equal(sampling.uniform(sub.to(DEV)).cpu(),
                                sampling.uniform(sub))
    logits = torch.randn((n_keys, vocab),
                         generator=torch.Generator().manual_seed(0)) * 3
    want = sampling.categorical(keys, logits)
    got = sampling.categorical(keys.to(DEV), logits.to(DEV)).cpu()
    top2 = (sampling.gumbel(keys, (vocab,)) + logits).topk(2).values
    near = (top2[:, 0] - top2[:, 1]) < 1e-5
    differ = got != want
    out = {"keys_equal": keys_equal, "bits_equal": bits_equal,
           "uniform_equal": uniform_equal, "tokens_differ": int(differ.sum()),
           "near_ties": int(near.sum()),
           "differ_off_tie": int((differ & ~near).sum())}
    print(f"  sampler card vs CPU ({n_keys} keys x {vocab}): key words "
          f"equal {keys_equal}, random bits equal {bits_equal}, uniforms "
          f"equal {uniform_equal}; tokens differ at {out['tokens_differ']} "
          f"of {n_keys} ({out['near_ties']} perturbed-score gaps < 1e-5, "
          f"{out['differ_off_tie']} differences off them)", flush=True)
    if not (keys_equal and bits_equal and uniform_equal) \
            or out["differ_off_tie"]:
        raise AssertionError("the sampler on the card disagrees with the CPU")
    return out


def phase_graphs(params, smi: str, serve: dict) -> dict:
    """Sampling and CUDA graphs at full width: the serve requests through
    an eager engine against the serve phase's captured one (streams,
    launch counters), host ms per decode chunk both ways, temperature 0.7
    on the workload's overcommitted pool (dense 4-layer: reserve, replay
    and swap engines draw equal streams; full width: spec with sampling
    drains and accounts), and the sampler on the card against the CPU."""
    cfg = get_config("yi-6b").replace(
        quant_mode="w8a8_nibble", quant_backend="cuda", attn_impl="flash",
        cache_mode="paged", page_size=16)
    prompts, n_new, prefill_len, slots = serve["prompts"], 32, 128, 4
    print(f"sampling + graphs: {cfg.name} full width, all {cfg.n_layers} "
          f"layers, w8a8_nibble on the CUDA backend, paged (page 16); the "
          f"serve phase's {len(prompts)} requests x {n_new} through a "
          f"capture=False engine against the serve phase's captured one",
          flush=True)
    t_phase = time.perf_counter()
    # (1) eager against captured, greedy
    eager = Engine(cfg, params, ServeConfig(
        batch=slots, max_len=prefill_len + n_new, prefill_len=prefill_len,
        decode_chunk=8), device=DEV, capture=False)
    streams, eager_wall, counts = _serve_timed(eager, prompts, n_new)
    if set(eager.capture_counts.values()) != {0}:
        raise AssertionError(f"capture=False captured {eager.capture_counts}")
    del eager
    eager_tok_s = sum(map(len, streams)) / eager_wall
    tie = hold_margins(
        "captured streams against the eager engine's",
        divergence_margins(params, cfg, prompts, streams, serve["streams"]),
        len(prompts), serve)
    print(f"  serve tok/s ({smi}): eager {eager_tok_s:.2f}, captured "
          f"{serve['tok_s']:.2f} (the serve phase's run); launches eager "
          f"{counts}", flush=True)
    if counts != serve["counts"]:
        raise AssertionError(f"launch counters differ: eager {counts}, "
                             f"captured {serve['counts']}")
    chunk = time_decode_chunks(cfg, params, prompts)
    ms = chunk["ms"]
    print(f"  host ms per decode chunk (4 slots x 8 steps, median of "
          f"{len(chunk['runs']['eager'])} in rotation; {smi}): eager "
          f"{ms['eager']:.3f}, captured {ms['captured']:.3f} "
          f"({ms['eager'] / ms['captured']:.2f}x), captured at temperature "
          f"0.7 {ms['captured_sampled']:.3f}; runs "
          + "; ".join(f"{n} {[round(x, 2) for x in r]}"
                      for n, r in chunk["runs"].items()), flush=True)

    # (3) temperature 0.7 on the workload's pool and traffic
    worst = pages_needed(prefill_len + 64 - 1, cfg.page_size)
    num_pages = 1 + worst * 3 // 2
    traffic = dict(requests=16, prompt_budget=prefill_len, new_tokens=64,
                   stagger_s=0.05, seed=0, priority_mix=0.25,
                   arrival_mode="bursty", collect_streams=True)
    pool = dict(batch=slots, max_len=prefill_len + 64,
                prefill_len=prefill_len, decode_chunk=8,
                priority_aging_s=1.0, temperature=0.7)
    dcfg = cfg.replace(quant_mode="dense", n_layers=4)
    dparams = {**params, "layers": params["layers"][:4]}
    sampled = {}
    for label, over in (("reserve", dict(alloc_mode="reserve")),
                        ("replay", dict(alloc_mode="incremental",
                                        num_pages=num_pages)),
                        ("swap", dict(alloc_mode="incremental",
                                      num_pages=num_pages,
                                      swap_mode="host"))):
        eng = Engine(dcfg, dparams, ServeConfig(**pool, **over), device=DEV)
        res = run_timed_workload(eng, cfg.vocab_size, **traffic)
        torch.cuda.synchronize()
        _check_streams(res["streams"], 64, cfg.vocab_size)
        if eng.leaked_pages():
            raise AssertionError(f"{eng.leaked_pages()} pages leaked")
        require_captured(eng, f"sampled dense {label}")
        sampled[label] = res
    same = {k: sum(sampled[k]["streams"][n] == sampled["reserve"]["streams"]
                   [n] for n in range(16)) for k in ("replay", "swap")}
    print(f"  sampled dense 4-layer (temperature 0.7, the workload's bursty "
          f"16 x 64): reserve {sampled['reserve']['pool_pages']} pages, "
          f"replay and swap {num_pages} pages with "
          f"{sampled['replay']['preemptions']} and "
          f"{sampled['swap']['preemptions']} preemptions (swap in "
          f"{sampled['swap']['swap_in']}); streams equal to the reserve "
          f"pool's: replay {same['replay']}/16, swap {same['swap']}/16 "
          f"({smi})", flush=True)
    if min(sampled["replay"]["preemptions"],
           sampled["swap"]["preemptions"]) < 1 \
            or sampled["swap"]["swap_in"] < 1:
        raise AssertionError("the sampled overcommitted pools preempted or "
                             "swapped nobody")
    if same != {"replay": 16, "swap": 16}:
        raise AssertionError("a sampled stream changed under preemption")
    del eng

    eng = Engine(cfg, params, ServeConfig(
        **pool, alloc_mode="incremental", num_pages=num_pages,
        spec_decode=True, spec_k=4, swap_mode="host"), device=DEV)
    reset_counts()
    res = run_timed_workload(eng, cfg.vocab_size, **traffic)
    torch.cuda.synchronize()
    spec_counts = read_counts()
    _check_streams(res.pop("streams"), 64, cfg.vocab_size)
    st = eng.stats
    firsts = traffic["requests"]
    print(f"  sampled spec at full width (temperature 0.7, w8a8_nibble "
          f"draft, spec_k 4, the workload's pool with swap_mode host; "
          f"{smi}): {res['tok_per_s']} tok/s, {res['preemptions']} "
          f"preemptions, swap in {st['swap_in']}, acceptance "
          f"{st['acceptance_rate']:.4f}, tokens per round "
          f"{st['tokens_per_step']:.4f}, spec_tokens {eng.spec_tokens} "
          f"(emitted {res['tokens']} - firsts {firsts}); launches "
          f"{spec_counts}", flush=True)
    eng.release_prefix_cache()
    if eng.leaked_pages() or eng.host_pool.in_use:
        raise AssertionError(f"{eng.leaked_pages()} pages leaked")
    if res["preemptions"] < 1:
        raise AssertionError("the sampled spec run preempted nobody")
    if eng.spec_tokens != res["tokens"] - firsts \
            or not 0.0 <= st["acceptance_rate"] <= 1.0:
        raise AssertionError("sampled spec accounting broken")
    require_captured(eng, "sampled spec")
    require_launched(spec_counts, ("nibble_matmul", "paged_decode_attention"))
    require_no_f32(spec_counts)
    res["spec_tokens"] = eng.spec_tokens
    del eng

    # (4) the sampler on the card against the CPU
    samp = check_sampler()
    wall = time.perf_counter() - t_phase
    print(f"  sampling + graphs phase {wall:.1f} s", flush=True)
    return {"eager_tok_s": eager_tok_s, "captured_tok_s": serve["tok_s"],
            "eager_counts": counts, "tie": tie, "chunk_ms": chunk,
            "sampled_dense": {k: {f: v[f] for f in (
                "preemptions", "swap_in", "tok_per_s", "pool_pages")}
                for k, v in sampled.items()} | {"streams_equal": same},
            "sampled_spec": {f: res[f] for f in (
                "tok_per_s", "preemptions", "acceptance_rate",
                "tokens_per_step", "tokens", "spec_tokens")},
            "sampler": samp, "wall_s": wall}


def phase_workload(params, smi: str) -> dict:
    """The serve phase's weights through the launcher's timed driver over
    an overcommitted incremental pool (bursty arrivals, priority mix,
    aging), then a dense bit-match check of preemption at 4 layers."""
    cfg = get_config("yi-6b").replace(
        quant_mode="w8a8_nibble", quant_backend="cuda", attn_impl="flash",
        cache_mode="paged", page_size=16)
    n_req, n_new, prefill_len, slots = 16, 64, 128, 4
    worst = pages_needed(prefill_len + n_new - 1, cfg.page_size)
    num_pages = 1 + worst * 3 // 2       # the trash page + 1.5 worst cases
    scfg = ServeConfig(batch=slots, max_len=prefill_len + n_new,
                       prefill_len=prefill_len, decode_chunk=8,
                       priority_aging_s=1.0, alloc_mode="incremental",
                       num_pages=num_pages)
    print(f"workload: {cfg.name} full width, all {cfg.n_layers} layers, "
          f"w8a8_nibble on the CUDA backend, flash attention; paged pool "
          f"page {cfg.page_size}, {num_pages} pages (1 trash + "
          f"{num_pages - 1}) against {slots} slots x {worst} worst-case "
          f"pages, alloc_mode=incremental; bursty, {n_req} requests x "
          f"{n_new} new tokens, stagger 0.05 s, priority mix 0.25, aging "
          f"1.0 s", flush=True)
    t_phase = time.perf_counter()
    engine = Engine(cfg, params, scfg, device=DEV)
    reset_counts()
    r = run_timed_workload(engine, cfg.vocab_size, requests=n_req,
                           prompt_budget=prefill_len, new_tokens=n_new,
                           stagger_s=0.05, seed=0, priority_mix=0.25,
                           arrival_mode="bursty", collect_streams=True)
    torch.cuda.synchronize()
    counts = read_counts()
    streams = r.pop("streams")
    print(f"  result ({smi}): {json.dumps(r)}", flush=True)
    print(f"  ttft p50 {r['ttft_p50_ms']} ms, p99 {r['ttft_p99_ms']} ms; "
          f"itl p50 {r['itl_p50_ms']} ms, p99 {r['itl_p99_ms']} ms; "
          f"{r['tok_per_s']} tok/s; occupancy {r['occupancy']}, "
          f"concurrency {r['concurrency']}, preemptions "
          f"{r['preemptions']} ({smi})", flush=True)
    print(f"  launches in the workload run (warm-up included): {counts}",
          flush=True)
    _check_streams(streams, n_new, cfg.vocab_size)
    if r["preemptions"] < 1:
        raise AssertionError("the overcommitted pool preempted nobody")
    if engine.leaked_pages():
        raise AssertionError(f"{engine.leaked_pages()} pages leaked")
    if r["compile_counts"] != {"prefill": 1, "decode_chunk": 1}:
        raise AssertionError(f"stage signatures {r['compile_counts']}")
    r["captures"] = require_captured(engine, "workload")
    require_launched(counts, ("nibble_matmul", "flash_attention_fwd",
                              "paged_decode_attention"))
    require_no_f32(counts)

    # preemption's bit-match, where rows do not depend on each other
    n_layers = 4
    dcfg = cfg.replace(quant_mode="dense", n_layers=n_layers)
    dparams = {**params, "layers": params["layers"][:n_layers]}

    def serve(alloc_mode, pages):
        eng = Engine(dcfg, dparams, ServeConfig(
            batch=slots, max_len=prefill_len + n_new,
            prefill_len=prefill_len, decode_chunk=8, alloc_mode=alloc_mode,
            num_pages=pages), device=DEV)
        res = run_timed_workload(eng, cfg.vocab_size, requests=8,
                                 prompt_budget=prefill_len,
                                 new_tokens=n_new, seed=1,
                                 collect_streams=True)
        torch.cuda.synchronize()
        _check_streams(res["streams"], n_new, cfg.vocab_size)
        if eng.leaked_pages():
            raise AssertionError(f"{eng.leaked_pages()} pages leaked")
        require_captured(eng, "dense 4-layer workload")
        return res

    inc = serve("incremental", num_pages)
    ref = serve("reserve", None)
    dense_runs = {"ref_streams": ref["streams"],
                  "replay_decode_chunks": inc["decode_chunks"]}
    same = sum(inc["streams"][n] == ref["streams"][n] for n in ref["streams"])
    print(f"  dense bit-match ({dcfg.name} full width cut to {n_layers} "
          f"layers, uniform, 8 requests x {n_new}): incremental pool "
          f"({num_pages} pages) {inc['preemptions']} preemptions, "
          f"{inc['tok_per_s']} tok/s; reserve pool ({ref['pool_pages']} "
          f"pages) {ref['preemptions']} preemptions; streams equal "
          f"{same}/8 ({smi})", flush=True)
    if inc["preemptions"] < 1:
        raise AssertionError("the dense check preempted nobody")
    if same != len(ref["streams"]):
        raise AssertionError("a preempted dense stream differs from the "
                             "uncontended one")
    print(f"  workload phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return {"counts": counts, "result": r,
            "bitmatch": {"preemptions": inc["preemptions"],
                         "streams_equal": same}, "dense_runs": dense_runs,
            "engine": engine, "scfg": scfg}


def _fleet_bitmatch(params, cfg, scfg, serve: dict, n_req=8, n_new=64
                    ) -> dict:
    """Dense, full width cut to 4 layers, the workload phase's pool: the
    same requests at arrival 0 through a two-replica fleet and through one
    engine; equal greedy streams, each divergence held to a near-tie.
    Launch counters zeroed just before the fleet's run, read just after
    (dense projections are plain matmuls: flash and paged launch)."""
    dcfg = cfg.replace(quant_mode="dense", n_layers=4)
    dparams = {**params, "layers": params["layers"][:4]}
    draw = draw_workload(cfg.vocab_size, requests=n_req, prompt_budget=128,
                         new_tokens=n_new, seed=2, arrival_mode="bursty")
    solo = Engine(dcfg, dparams, scfg, device=DEV)
    ids = [solo.submit(p, n_new) for p in draw.prompts]
    done = solo.run()
    want = [done[i].tokens for i in ids]
    fleet = Router(dcfg, dparams, scfg, replicas=2, device=DEV)
    for eng in fleet.replicas:
        hold_cache_bytes(eng)
    fleet.submit(draw.prompts[0], 2)
    fleet.submit(draw.prompts[1], 2)
    fleet.run()
    torch.cuda.synchronize()
    reset_counts()
    gids = [fleet.submit(p, n_new) for p in draw.prompts]
    fdone = fleet.run()
    torch.cuda.synchronize()
    counts = read_counts()
    got = [fdone[g].tokens for g in gids]
    _check_streams(dict(enumerate(got)), n_new, cfg.vocab_size)
    if fleet.leaked_pages() or solo.leaked_pages():
        raise AssertionError("the dense fleet check leaked pages")
    require_launched(counts, ("flash_attention_fwd",
                              "paged_decode_attention"))
    require_no_f32(counts)
    margins = divergence_margins(dparams, dcfg, draw.prompts, want, got)
    held = hold_margins(f"dense fleet vs one engine ({dcfg.name} cut to 4 "
                        f"layers, {n_req} requests x {n_new} at arrival 0, "
                        f"placements {fleet.placements})", margins, n_req,
                        serve)
    return {**held, "counts": counts, "placements": fleet.placements,
            "preemptions": fleet.stats["preemptions"]}


def _capacity_check(engine, workload: dict, smi: str) -> dict:
    """Calibrate the workload phase's engine (drained; each stage timed on
    a recorded signature, the decode chunk by replaying its CUDA graph)
    and predict that phase's workload: predicted against measured tok/s
    and TTFT p50, with the relative error (printed; a bring-up sets no
    limit on it).  ``predict`` must not raise and must find the workload
    feasible: it ran."""
    r = workload["result"]
    t = time.perf_counter()
    costs = calibrate_engine(engine)
    cal_s = time.perf_counter() - t
    shape = WorkloadShape(requests=16, prompt_budget=128, new_tokens=64,
                          stagger_s=0.05, seed=0, priority_mix=0.25,
                          arrival_mode="bursty")
    pred = predict(Knobs.from_engine(engine), shape, costs,
                   cache_token_bytes=engine.cache_token_bytes)
    if not pred["feasible"] or "tok_per_s" not in pred:
        raise AssertionError(f"predict found the workload that ran "
                             f"infeasible: {pred['infeasible_reason']}")
    err = {k: (pred[k] - r[k]) / r[k] for k in ("tok_per_s", "ttft_p50_ms")}
    print(f"  calibrated StageCosts of the workload engine in {cal_s:.1f} s "
          f"({smi}): {json.dumps(costs.to_dict())}", flush=True)
    print(f"  capacity model: predicted {pred['tok_per_s']:.2f} tok/s "
          f"against the measured {r['tok_per_s']} (relative error "
          f"{err['tok_per_s']:+.3f}); TTFT p50 {pred['ttft_p50_ms']:.1f} ms "
          f"against {r['ttft_p50_ms']} ({err['ttft_p50_ms']:+.3f}); "
          f"preemptions {pred['preemptions']} against {r['preemptions']}; "
          f"decode chunks {pred['decode_chunks']} against "
          f"{r['decode_chunks']}", flush=True)
    keep = ("tok_per_s", "ttft_p50_ms", "ttft_p99_ms", "preemptions",
            "decode_chunks", "wall_s", "cache_kb_per_req")
    return {"costs": costs.to_dict(), "calibrate_s": cal_s,
            "predicted": {k: pred[k] for k in keep},
            "measured": {k: r[k] for k in keep}, "rel_err": err}


def _launcher_runs() -> dict:
    """The serving launcher in process on reduced yi-6b: ``--dp 2`` (a
    fleet with the prefix cache), ``--predict`` (one engine, then its
    calibration and prediction) and ``--autotune max-tok-s --ttft-slo-ms
    100`` (no model run); each must return 0."""
    base = ["--arch", "yi-6b", "--reduced", "--quant", "w8a8_nibble",
            "--cache-mode", "paged", "--page-size", "16", "--batch", "4",
            "--prompt-len", "32", "--new-tokens", "16", "--requests", "8"]
    runs = {"dp": base + ["--workload", "bursty", "--dp", "2",
                          "--prefix-cache", "--shared-prefix", "0.5"],
            "predict": base + ["--workload", "uniform", "--predict"],
            "autotune": base + ["--workload", "uniform", "--autotune",
                                "max-tok-s", "--ttft-slo-ms", "100"]}
    out = {}
    for name, argv in runs.items():
        print(f"  launcher {' '.join(argv)}", flush=True)
        t = time.perf_counter()
        rc = serve_launcher.main(argv)
        if rc != 0:
            raise AssertionError(f"the launcher's {name} run returned {rc}")
        out[name] = round(time.perf_counter() - t, 2)
    return out


def phase_fleet(params, smi: str, workload: dict, serve: dict) -> dict:
    """Two full-width yi-6b replicas behind one ``Router`` on the one card,
    sharing the serve phase's weights: the workload phase's pool and
    bursty traffic with the prefix cache (75% of prompts share a head);
    then the dense fleet bit-match, the capacity model on the workload
    phase's engine, and the launcher's ``--dp`` / ``--predict`` /
    ``--autotune``."""
    cfg = get_config("yi-6b").replace(
        quant_mode="w8a8_nibble", quant_backend="cuda", attn_impl="flash",
        cache_mode="paged", page_size=16)
    scfg = dataclasses.replace(workload["scfg"], prefix_cache=True)
    n_req, n_new = 16, 64
    print(f"fleet: 2 replicas of {cfg.name} (full width, all "
          f"{cfg.n_layers} layers, w8a8_nibble on the CUDA backend, flash "
          f"attention) on one card, one shared weight tree; each the "
          f"workload phase's pool ({scfg.num_pages} pages of "
          f"{cfg.page_size}) with prefix_cache=True; bursty, {n_req} "
          f"requests x {n_new} new tokens, stagger 0.05 s, priority mix "
          f"0.25, shared_prefix 0.75", flush=True)
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    fleet = Router(cfg, params, scfg, replicas=2, device=DEV)
    for eng in fleet.replicas:
        hold_cache_bytes(eng)
    reset_counts()
    r = run_timed_workload(fleet, cfg.vocab_size, requests=n_req,
                           prompt_budget=128, new_tokens=n_new,
                           stagger_s=0.05, seed=0, priority_mix=0.25,
                           shared_prefix=0.75, arrival_mode="bursty",
                           collect_streams=True)
    torch.cuda.synchronize()
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    streams = r.pop("streams")
    _check_streams(streams, n_new, cfg.vocab_size)
    print(f"  result ({smi}): {json.dumps(r)}", flush=True)
    print(f"  fleet {r['tok_per_s']} tok/s; ttft p50 {r['ttft_p50_ms']} ms, "
          f"p99 {r['ttft_p99_ms']} ms; itl p99 {r['itl_p99_ms']} ms; "
          f"placements {[p['placed'] for p in r['per_replica']]}, affinity "
          f"hits {fleet.affinity_hits}; prefix hit rate "
          f"{r['prefix_hit_rate']}; preemptions {r['preemptions']}; peak "
          f"memory {peak / 2**30:.3f} GiB ({smi})", flush=True)
    print(f"  launches in the fleet run (warm-up included): {counts}",
          flush=True)
    if (r["dp_replicas"], r["device_count"]) != (2, 1):
        raise AssertionError(f"fleet topology {r['dp_replicas']} replicas "
                             f"on {r['device_count']} devices")
    if sum(p["placed"] for p in r["per_replica"]) != n_req:
        raise AssertionError(f"placements {r['per_replica']}")
    if r["compile_counts"] != {"prefill": 1, "decode_chunk": 1}:
        raise AssertionError(f"stage signatures {r['compile_counts']}")
    if fleet.capture_counts != {"decode_chunk": 1}:
        raise AssertionError(f"CUDA graphs {fleet.capture_counts}")
    fleet.release_prefix_cache()
    if fleet.leaked_pages():
        raise AssertionError(f"{fleet.leaked_pages()} pages leaked")
    # the prefix-cache prefill attends in attention_core (the reference's
    # context prefill), so the flash forward launches in the dense check
    require_launched(counts, ("nibble_matmul", "paged_decode_attention"))
    if counts["flash_attention_fwd"]:
        raise AssertionError("a prefix-cache prefill ran the flash kernel")
    require_no_f32(counts)
    out = {"counts": counts, "result": r, "peak_bytes": peak,
           "affinity_hits": list(fleet.affinity_hits),
           "capture_counts": fleet.capture_counts}
    del fleet
    out["bitmatch"] = _fleet_bitmatch(
        params, cfg, dataclasses.replace(scfg, prefix_cache=False), serve)
    out["capacity"] = _capacity_check(workload.pop("engine"), workload, smi)
    out["launcher_s"] = _launcher_runs()
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"  fleet phase {out['wall_s']:.1f} s", flush=True)
    return out


def _cached_rows(prompts, page_size) -> list:
    """Rows a prefix cache that never reclaims serves from cache, per
    prompt in submission order: the longest run of already-indexed chunk
    keys (``hash_chunks``), one row less where it covers the whole prompt
    (its last token runs again, into a copy-on-write page)."""
    seen, out = set(), []
    for p in prompts:
        keys = hash_chunks(p, page_size)
        hits = next((j for j, k in enumerate(keys) if k not in seen),
                    len(keys))
        rows = hits * page_size
        out.append(rows - 1 if rows == len(p) else rows)
        seen.update(keys)
    return out


def divergence_margins(params, cfg, prompts, want, got, extras=None
                       ) -> list:
    """``(request, token, margin)`` for each stream of ``got`` that differs
    from ``want``: at its first divergence ``i``, a dense ``prefill``
    under ``cfg`` over the prompt plus ``want[:i]`` (with the request's
    ``extras[n]``, a VLM's patches or an encoder's frames, where given)
    gives the logits, and the margin is ``l(want[i]) - l(got[i])`` (a tie
    reads ~0)."""
    out = []
    for n, (p, w, g) in enumerate(zip(prompts, want, got)):
        if len(w) != len(g):
            raise AssertionError(f"request {n}: {len(g)} tokens against "
                                 f"{len(w)}")
        diff = [i for i in range(len(w)) if w[i] != g[i]]
        if not diff:
            continue
        i = diff[0]
        toks = np.concatenate([p, np.asarray(w[:i], np.int32)])
        logits, _, _ = prefill(params, cfg, torch.as_tensor(
            toks, device=DEV).long()[None],
            **({} if extras is None else extras[n]))
        lg = logits[0, -1].float()
        out.append((n, i, float(lg[w[i]] - lg[g[i]])))
    return out


def hold_margins(label: str, margins: list, n: int, serve: dict) -> dict:
    """Print the equal-stream count and every divergence margin beside the
    serve phase's measured route difference; fail on a margin above its
    tolerance (a divergence that is not a near-tie)."""
    tol = serve["logit_tol"]
    worst = max((m for _, _, m in margins), default=0.0)
    print(f"  {label}: streams equal {n - len(margins)}/{n}; divergence "
          f"margins (request, token, l(want) - l(got)) "
          f"{[(r, i, round(m, 4)) for r, i, m in margins]}; max {worst:.4f}"
          f" against the tolerance {tol:.4f} (the serve phase's kernel-vs-"
          f"plain logit difference {serve['logit_diff']:.4f})", flush=True)
    if worst > tol:
        raise AssertionError(f"{label}: a divergence margin {worst} exceeds "
                             f"{tol}: not a near-tie")
    return {"streams_equal": n - len(margins), "margins": margins,
            "max_margin": worst}


def phase_prefix_swap(params, smi: str, workload: dict, serve: dict
                      ) -> dict:
    """The workload phase's pool and bursty traffic with the prefix cache
    and the host swap on (75% of prompts share a 64-token head), then two
    dense bit-match checks at 4 layers: swap-resume against the reserve
    pool, and prefix hits and copy-on-write against solo misses."""
    cfg = get_config("yi-6b").replace(
        quant_mode="w8a8_nibble", quant_backend="cuda", attn_impl="flash",
        cache_mode="paged", page_size=16)
    n_req, n_new, prefill_len, slots = 16, 64, 128, 4
    num_pages = workload["result"]["pool_pages"]
    scfg = ServeConfig(batch=slots, max_len=prefill_len + n_new,
                       prefill_len=prefill_len, decode_chunk=8,
                       priority_aging_s=1.0, alloc_mode="incremental",
                       num_pages=num_pages, prefix_cache=True,
                       swap_mode="host")
    print(f"prefix+swap: {cfg.name} full width, all {cfg.n_layers} layers, "
          f"w8a8_nibble on the CUDA backend; the workload phase's pool "
          f"({num_pages} pages of {cfg.page_size}, incremental) with "
          f"prefix_cache=True, swap_mode=host; bursty, {n_req} requests x "
          f"{n_new} new tokens, shared_prefix 0.75 (a {prefill_len // 2}-"
          f"token head), priority mix 0.25, aging 1.0 s", flush=True)
    t_phase = time.perf_counter()
    engine = Engine(cfg, params, scfg, device=DEV)
    reset_counts()
    r = run_timed_workload(engine, cfg.vocab_size, requests=n_req,
                           prompt_budget=prefill_len, new_tokens=n_new,
                           stagger_s=0.05, seed=0, priority_mix=0.25,
                           shared_prefix=0.75, arrival_mode="bursty",
                           collect_streams=True)
    torch.cuda.synchronize()
    counts = read_counts()
    streams = r.pop("streams")
    st = engine.stats
    prompt_tokens = r["workload_shape"]["prompt_tokens"]
    base = workload["result"]
    print(f"  result ({smi}): {json.dumps(r)}", flush=True)
    print(f"  {r['tok_per_s']} tok/s (replay-only workload phase "
          f"{base['tok_per_s']}); ttft p50 {r['ttft_p50_ms']} / p99 "
          f"{r['ttft_p99_ms']} ms ({base['ttft_p50_ms']} / "
          f"{base['ttft_p99_ms']}); itl p50 {r['itl_p50_ms']} / p99 "
          f"{r['itl_p99_ms']} ms ({base['itl_p50_ms']} / "
          f"{base['itl_p99_ms']}); {r['prefill_tokens']} tokens prefilled "
          f"for {prompt_tokens} prompt tokens (replay-only "
          f"{base['prefill_tokens']}); {r['decode_chunks']} decode chunks "
          f"({base['decode_chunks']}); {r['preemptions']} preemptions "
          f"({base['preemptions']}) ({smi})", flush=True)
    print(f"  swap out {st['swap_out']}, in {st['swap_in']}, replay steps "
          f"saved {st['replay_steps_saved']}, host pool {st['host_pages']} "
          f"pages; prefix hits {st['prefix_hits']}, hit rate "
          f"{st['prefix_hit_rate']:.3f}, cow {st['cow_copies']}, index "
          f"{st['prefix_pages']} pages, demotions {st['prefix_demotions']}, "
          f"cold hits {st['prefix_cold_hits']}", flush=True)
    print(f"  launches in the run (warm-up included): {counts}", flush=True)
    _check_streams(streams, n_new, cfg.vocab_size)
    if r["preemptions"] < 1 or st["swap_out"] < 1:
        raise AssertionError("the overcommitted pool swapped nobody out")
    if st["swap_in"] != st["swap_out"] or st["replay_steps_saved"] < 1:
        raise AssertionError(f"swap out {st['swap_out']}, in "
                             f"{st['swap_in']}, saved "
                             f"{st['replay_steps_saved']}")
    if st["prefix_hits"] < 1 or not st["prefix_hit_rate"] > 0:
        raise AssertionError("no prefix hit on shared heads")
    engine.release_prefix_cache()
    if engine.leaked_pages() or engine.host_pool.in_use:
        raise AssertionError(f"{engine.leaked_pages()} pages leaked "
                             f"({engine.host_pool.in_use} on the host)")
    if r["compile_counts"] != {"prefill": 1, "decode_chunk": 1}:
        raise AssertionError(f"stage signatures {r['compile_counts']}")
    r["captures"] = require_captured(engine, "prefix+swap")
    require_launched(counts, ("nibble_matmul", "paged_decode_attention"))
    if counts["flash_attention_fwd"]:
        raise AssertionError("the prefix engine launched the flash "
                             "forward (its context prefill is plain)")
    require_no_f32(counts)
    del engine

    n_layers = 4
    dcfg = cfg.replace(quant_mode="dense", n_layers=n_layers)
    dparams = {**params, "layers": params["layers"][:n_layers]}

    def dense_engine(**kw):
        return Engine(dcfg, dparams, ServeConfig(
            batch=slots, max_len=prefill_len + n_new,
            prefill_len=prefill_len, decode_chunk=8, **kw), device=DEV)

    # swap-resume: the workload phase's dense check with the host swap
    eng = dense_engine(alloc_mode="incremental", num_pages=num_pages,
                       swap_mode="host")
    sw = run_timed_workload(eng, cfg.vocab_size, requests=8,
                            prompt_budget=prefill_len, new_tokens=n_new,
                            seed=1, collect_streams=True)
    torch.cuda.synchronize()
    ref = workload["dense_runs"]
    same_sw = sum(sw["streams"][n] == ref["ref_streams"][n]
                  for n in ref["ref_streams"])
    print(f"  dense swap bit-match ({n_layers} layers, uniform, 8 requests "
          f"x {n_new}): {sw['preemptions']} preemptions, swap in "
          f"{sw['swap_in']}, {sw['replay_steps_saved']} replay steps saved, "
          f"{sw['decode_chunks']} decode chunks (replay run "
          f"{ref['replay_decode_chunks']}), {sw['prefill_tokens']} tokens "
          f"prefilled; streams equal to the reserve pool's {same_sw}/8 "
          f"({smi})", flush=True)
    eng.release_prefix_cache()
    if eng.leaked_pages():
        raise AssertionError(f"{eng.leaked_pages()} pages leaked")
    require_captured(eng, "dense swap")
    if same_sw != 8 or sw["swap_in"] < 1:
        raise AssertionError("a swapped dense stream differs from the "
                             "uncontended one, or nothing swapped in")
    if not sw["decode_chunks"] < ref["replay_decode_chunks"]:
        raise AssertionError("the swap saved no decode chunk")

    # prefix hits and copy-on-write against solo misses (a pool large
    # enough that the index never reclaims)
    draw = draw_workload(cfg.vocab_size, requests=8,
                         prompt_budget=prefill_len, new_tokens=n_new,
                         seed=1, shared_prefix=0.75)
    twice = np.random.default_rng(2).integers(
        0, cfg.vocab_size, prefill_len).astype(np.int32)
    prompts = list(draw.prompts) + [twice, twice]
    big = slots * pages_needed(prefill_len + n_new, cfg.page_size) \
        + len(prompts) * prefill_len // cfg.page_size + 1
    eng = dense_engine(prefix_cache=True, num_pages=big)

    def serve_all(engine, batch):
        ids = [engine.submit(p, n_new) for p in batch]
        done = engine.run()
        torch.cuda.synchronize()
        return [done[i].tokens for i in ids]

    got = serve_all(eng, prompts)
    pst = eng.stats
    cached = _cached_rows(prompts, cfg.page_size)
    want_prefill = sum(len(p) for p in prompts) - sum(cached)
    solo = []
    for p in prompts:
        eng.reset()                  # a fresh index: every request misses
        solo += serve_all(eng, [p])
    eng.release_prefix_cache()
    if eng.leaked_pages():
        raise AssertionError(f"{eng.leaked_pages()} pages leaked")
    require_captured(eng, "dense prefix")
    plain = serve_all(dense_engine(), prompts)
    same_pf = sum(a == b for a, b in zip(got, solo))
    same_plain = sum(a == b for a, b in zip(got, plain))
    # the prefix-off engine prefills through the flash kernel, the prefix
    # engine through attention_core: hold each divergence to a near-tie
    vs_off = hold_margins(
        "prefix-hit streams against the prefix-off engine's",
        divergence_margins(dparams, dcfg, prompts, plain, got),
        len(prompts), serve)
    print(f"  dense prefix bit-match ({n_layers} layers, {len(prompts)} "
          f"requests, 8 with shared_prefix 0.75 seed 1 and one 128-token "
          f"prompt twice): hits {pst['prefix_hits']}, cow "
          f"{pst['cow_copies']}, prefill tokens {pst['prefill_tokens']} "
          f"(hash_chunks says {want_prefill}: {sum(len(p) for p in prompts)}"
          f" prompt tokens - {sum(cached)} cached rows); streams equal to "
          f"solo misses {same_pf}/{len(prompts)}; equal to a prefix-off "
          f"engine's (flash prefill; margins above) {same_plain}/"
          f"{len(prompts)} ({smi})", flush=True)
    if same_pf != len(prompts) or pst["cow_copies"] < 1:
        raise AssertionError("a prefix-hit stream differs from its solo "
                             "miss, or no copy-on-write fired")
    if pst["prefill_tokens"] != want_prefill:
        raise AssertionError(f"prefilled {pst['prefill_tokens']} tokens, "
                             f"expected {want_prefill}")
    wall = time.perf_counter() - t_phase
    print(f"  prefix+swap phase {wall:.1f} s", flush=True)
    return {"counts": counts, "result": r, "stats": st,
            "dense_swap": {k: sw[k] for k in (
                "preemptions", "swap_out", "swap_in", "replay_steps_saved",
                "decode_chunks", "prefill_tokens", "tok_per_s")}
            | {"streams_equal": same_sw,
               "replay_decode_chunks": ref["replay_decode_chunks"]},
            "dense_prefix": {"prefix_hits": pst["prefix_hits"],
                             "cow_copies": pst["cow_copies"],
                             "prefill_tokens": pst["prefill_tokens"],
                             "expected_prefill_tokens": want_prefill,
                             "streams_equal": same_pf,
                             "equal_to_prefix_off": same_plain,
                             "prefix_off_margins": vs_off["margins"]},
            "wall_s": wall}


SPEC_COUNTS = {"prefill": 1, "decode_chunk": 0, "draft": 1, "verify": 1}
WAVE_COUNTS = {"prefill": 0, "decode_chunk": 1, "prefill_chunk": 1}


def phase_spec_wave(params, smi: str, serve: dict, workload: dict) -> dict:
    """Self-speculative decoding and the wave prefill at full width: the
    spec pair (a dense ``decode_chunk=1`` baseline against a
    ``w8a8_nibble`` draft with a dense verifier) on the serve phase's
    requests, each divergence held to a near-tie; the tail run (the
    workload phase's pool and traffic with chunked prefill, grouped
    admission and the host swap); then dense 4-layer checks with the plain
    attention on both sides: wave against monolithic, spec against
    non-spec."""
    base = get_config("yi-6b").replace(
        quant_backend="cuda", attn_impl="flash", cache_mode="paged",
        page_size=16)
    prompts, n_new, prefill_len, slots = serve["prompts"], 32, 128, 4
    kw = dict(batch=slots, max_len=prefill_len + n_new,
              prefill_len=prefill_len, alloc_mode="incremental")
    t_phase = time.perf_counter()
    print(f"spec + wave: {base.name} full width, all {base.n_layers} "
          f"layers, paged (page 16, incremental), flash attention, 4 slots;"
          f" the serve phase's {len(prompts)} requests x {n_new} new tokens:"
          f" a dense decode_chunk=1 baseline against spec_decode with a "
          f"w8a8_nibble draft on the CUDA backend, spec_k 4", flush=True)
    # (a) the spec pair
    dense_cfg = base.replace(quant_mode="dense")
    n_tok = len(prompts) * n_new
    baseline = Engine(dense_cfg, params, ServeConfig(decode_chunk=1, **kw),
                      device=DEV)
    want, base_wall, _ = _serve_timed(baseline, prompts, n_new)
    require_captured(baseline, "spec baseline")
    del baseline
    engine = Engine(base.replace(quant_mode="w8a8_nibble"), params,
                    ServeConfig(spec_decode=True, spec_k=4, **kw),
                    device=DEV)
    got, spec_wall, counts = _serve_timed(engine, prompts, n_new)
    base_tok_s, spec_tok_s = n_tok / base_wall, n_tok / spec_wall
    st = engine.stats
    spec = {"baseline_tok_s": base_tok_s, "spec_tok_s": spec_tok_s,
            "acceptance_rate": st["acceptance_rate"],
            "tokens_per_step": st["tokens_per_step"],
            "spec_rounds": st["spec_rounds"],
            "spec_rollback_pages": st["spec_rollback_pages"],
            "compile_counts": engine.compile_counts, "counts": counts,
            "captures": require_captured(engine, "spec")}
    print(f"  spec pair ({smi}): baseline {base_tok_s:.2f} tok/s, spec "
          f"{spec_tok_s:.2f} tok/s; acceptance {st['acceptance_rate']:.4f}"
          f", tokens per round {st['tokens_per_step']:.4f}, "
          f"{st['spec_rounds']} rounds, {st['spec_rollback_pages']} pages "
          f"rolled back; stages {engine.compile_counts}, CUDA graphs "
          f"{engine.capture_counts} (both engines captured)", flush=True)
    print(f"  launches in the spec run: {counts}", flush=True)
    if engine.compile_counts != SPEC_COUNTS:
        raise AssertionError(f"stage signatures {engine.compile_counts}")
    require_launched(counts, ("nibble_matmul", "flash_attention_fwd",
                              "paged_decode_attention"))
    require_no_f32(counts)
    del engine
    # (b) the tie rule for the pair
    spec["tie"] = hold_margins(
        "spec streams against the dense baseline's",
        divergence_margins(params, dense_cfg, prompts, want, got),
        len(prompts), serve)

    # (c) the tail run
    wl = workload["result"]
    tail_cfg = base.replace(quant_mode="w8a8_nibble")
    engine = Engine(tail_cfg, params, ServeConfig(
        batch=slots, max_len=prefill_len + 64, prefill_len=prefill_len,
        decode_chunk=8, priority_aging_s=1.0, alloc_mode="incremental",
        num_pages=wl["pool_pages"], prefill_chunk=32, admit_group=4,
        swap_mode="host"), device=DEV)
    print(f"  tail run: the workload phase's pool ({wl['pool_pages']} pages"
          f" of 16) and bursty traffic (16 x 64, priority mix 0.25), "
          f"w8a8_nibble, prefill_chunk 32, admit_group 4, swap_mode host",
          flush=True)
    reset_counts()
    r = run_timed_workload(engine, tail_cfg.vocab_size, requests=16,
                           prompt_budget=prefill_len, new_tokens=64,
                           stagger_s=0.05, seed=0, priority_mix=0.25,
                           arrival_mode="bursty", collect_streams=True)
    torch.cuda.synchronize()
    tail_counts = read_counts()
    _check_streams(r.pop("streams"), 64, tail_cfg.vocab_size)
    tst = engine.stats
    print(f"  tail ({smi}): {r['tok_per_s']} tok/s (workload phase "
          f"{wl['tok_per_s']}); ttft p50 {r['ttft_p50_ms']} / p99 "
          f"{r['ttft_p99_ms']} ms ({wl['ttft_p50_ms']} / "
          f"{wl['ttft_p99_ms']}); itl p99 {r['itl_p99_ms']} ms "
          f"({wl['itl_p99_ms']}); {r['prefill_waves']} waves, "
          f"{r['decode_chunks']} decode chunks ({wl['decode_chunks']}); "
          f"{r['preemptions']} preemptions ({wl['preemptions']}); swap out "
          f"{tst['swap_out']}, in {tst['swap_in']}; {r['prefill_tokens']} "
          f"tokens prefilled ({wl['prefill_tokens']})", flush=True)
    print(f"  launches in the tail run (warm-up included): {tail_counts}",
          flush=True)
    if r["compile_counts"] != WAVE_COUNTS:
        raise AssertionError(f"stage signatures {r['compile_counts']}")
    r["captures"] = require_captured(engine, "tail")
    require_launched(tail_counts, ("nibble_matmul", "paged_decode_attention"))
    if tail_counts["flash_attention_fwd"]:
        raise AssertionError("the wave engine launched the flash forward "
                             "(waves attend in attention_core)")
    require_no_f32(tail_counts)
    if engine.leaked_pages() or engine.host_pool.in_use:
        raise AssertionError(f"{engine.leaked_pages()} pages leaked "
                             f"({engine.host_pool.in_use} on the host)")
    del engine

    # (d) dense 4-layer checks, attention_core on both sides
    n_layers = 4
    dcfg = dense_cfg.replace(n_layers=n_layers, attn_impl="chunked")
    dparams = {**params, "layers": params["layers"][:n_layers]}

    def dense_run(**over):
        eng = Engine(dcfg, dparams, ServeConfig(**dict(kw, **over)),
                     device=DEV)
        ids = [eng.submit(p, n_new) for p in prompts]
        done = eng.run()
        torch.cuda.synchronize()
        eng.release_prefix_cache()
        if eng.leaked_pages():
            raise AssertionError(f"{eng.leaked_pages()} pages leaked")
        require_captured(eng, "dense 4-layer spec/wave")
        return [done[i].tokens for i in ids], eng.compile_counts

    mono, _ = dense_run()
    wave, wave_pins = dense_run(prefill_chunk=32, admit_group=4)
    plain, _ = dense_run(decode_chunk=1)
    spec4, spec_pins = dense_run(spec_decode=True,
                                 spec_quant_mode="w8a8_nibble")
    if wave_pins != WAVE_COUNTS or spec_pins != SPEC_COUNTS:
        raise AssertionError(f"4-layer stage signatures {wave_pins}, "
                             f"{spec_pins}")
    dense = {
        "wave": hold_margins(
            f"dense {n_layers}-layer wave (chunk 32, group 4) against "
            f"monolithic", divergence_margins(dparams, dcfg, prompts, mono,
                                              wave), len(prompts), serve),
        "spec": hold_margins(
            f"dense {n_layers}-layer spec (w8a8_nibble draft) against "
            f"non-spec", divergence_margins(dparams, dcfg, prompts, plain,
                                            spec4), len(prompts), serve)}
    wall = time.perf_counter() - t_phase
    print(f"  spec + wave phase {wall:.1f} s", flush=True)
    return {"spec": spec, "tail": r, "tail_counts": tail_counts,
            "tail_swap": {k: tst[k] for k in ("swap_out", "swap_in",
                                              "replay_steps_saved")},
            "dense": dense, "counts": counts, "wall_s": wall}


def phase_lut_serve(params, prompts, n_req=4, n_new=16,
                    prefill_len=128) -> dict:
    """The serve phase's model and settings in ``quant_mode="lut"``: the
    streams must equal what ``w8a8_nibble`` serves for the same requests
    (the prepared int8 weights are the same for both modes)."""
    base = get_config("yi-6b").replace(
        quant_mode="w8a8_nibble", quant_backend="cuda", attn_impl="flash",
        cache_mode="paged", page_size=16)
    scfg = ServeConfig(batch=4, max_len=prefill_len + 32,
                       prefill_len=prefill_len, decode_chunk=8)

    def serve(cfg):
        engine = Engine(cfg, params, scfg, device=DEV)
        ids = [engine.submit(p, n_new) for p in prompts[:n_req]]
        done = engine.run()
        torch.cuda.synchronize()
        if engine.leaked_pages():
            raise AssertionError(f"{engine.leaked_pages()} pages leaked")
        require_captured(engine, f"{cfg.quant_mode} serve")
        return [done[i].tokens for i in ids]

    want = serve(base)
    print(f"lut serve: {base.name} full width, quant_mode=lut on the CUDA "
          f"backend, {n_req} requests x {n_new} new tokens (the serve "
          f"phase's settings; no layer cut)", flush=True)
    reset_counts()
    t = time.perf_counter()
    got = serve(base.replace(quant_mode="lut"))
    wall = time.perf_counter() - t
    counts = read_counts()
    n_tok = sum(len(x) for x in got)
    print(f"  served {n_tok} tokens in {wall:.3f} s: {n_tok / wall:.2f} "
          f"tok/s; launches {counts}", flush=True)
    require_launched(counts, ("lut_matmul", "flash_attention_fwd",
                              "paged_decode_attention"))
    require_no_f32(counts)
    if counts["nibble_matmul"]:
        raise AssertionError("the lut path launched the nibble kernel")
    same = sum(a == b for a, b in zip(got, want))
    print(f"  lut streams equal to w8a8_nibble streams: {same}/{n_req} "
          f"requests token for token; first: {got[0][:8]}", flush=True)
    if got != want:
        raise AssertionError(f"lut streams {got} differ from w8a8_nibble "
                             f"streams {want}")
    return {"counts": counts, "tok_s": n_tok / wall, "wall_s": wall}


# ---------------------------------------------------------------------------
# The int8 KV cache on yi-6b
# ---------------------------------------------------------------------------

INT8_DECODE_RTOL = 0.05   # the reference's rule (tests/test_serve.py)


@torch.no_grad()
def _int8_decode_error(params, cfg, prompt, n_pre=32) -> float:
    """Teacher-forced: prefill ``prompt[:n_pre]`` into int8 caches, decode
    the rest one token a step; the largest difference from the bf16
    forward's logits over the largest forward logit (``dense``, so the
    difference is the cache's alone)."""
    dense = cfg.replace(quant_mode="dense", cache_mode="dense",
                        kv_cache_dtype="int8")
    toks = torch.as_tensor(prompt, device=DEV).long()[None]
    s = toks.shape[1]
    full, _ = forward(params, dense, toks)       # no cache: bf16 K/V
    logits, caches, _ = prefill(params, dense, toks[:, :n_pre], max_len=s)
    got = [logits[:, -1]]
    for t in range(n_pre, s - 1):
        lg, caches = decode_step(params, dense, toks[:, t:t + 1], caches, t)
        got.append(lg[:, -1])
    want = full[:, n_pre - 1:s - 1].float()
    got = torch.stack(got, 1).float()
    return ((got - want).abs().max() / want.abs().max()).item()


def phase_int8_kv(params, prompts, smi: str) -> dict:
    """The serve phase's weights with ``kv_cache_dtype="int8"``: the serve
    requests through a captured paged incremental engine (never the paged
    kernel: the decode dequantizes gathered pages in ``attention_core``,
    as the reference does) beside a bf16 engine with the same settings,
    host ms per captured decode chunk both ways; the workload phase's
    overcommitted pool and traffic with the host swap; teacher-forced
    int8 decode against the bf16 forward; then dense, cut to 4 layers,
    paged against the dense slab and the host swap against replay, token
    for token."""
    base = get_config("yi-6b").replace(
        quant_mode="w8a8_nibble", quant_backend="cuda", attn_impl="flash",
        cache_mode="paged", page_size=16)
    cfg = base.replace(kv_cache_dtype="int8")
    n_new, prefill_len, slots = 32, 128, 4
    scfg = ServeConfig(batch=slots, max_len=prefill_len + n_new,
                       prefill_len=prefill_len, decode_chunk=8,
                       alloc_mode="incremental")
    print(f"int8 kv: {cfg.name} full width, all {cfg.n_layers} layers, "
          f"w8a8_nibble on the CUDA backend, kv_cache_dtype=int8 (int8 K/V, "
          f"f32 scale per token and KV head), paged incremental (page 16), "
          f"{slots} slots, the serve phase's {len(prompts)} requests x "
          f"{n_new}", flush=True)
    t_phase = time.perf_counter()
    out, engines = {}, {}
    for label, c in (("bf16", base), ("int8", cfg)):
        eng = Engine(c, params, scfg, device=DEV)
        streams, wall, counts = _serve_timed(eng, prompts, n_new)
        require_captured(eng, f"{label} kv serve")
        require_no_f32(counts)
        out[label] = {"tok_s": sum(map(len, streams)) / wall, "wall_s": wall,
                      "counts": counts, "streams": streams,
                      "cache_token_bytes": eng.cache_token_bytes}
        engines[label] = eng
    for label in engines:
        reset_counts()
        out[label]["chunk_ms"] = _chunk_ms(engines[label], prompts)
        out[label]["chunk_counts"] = read_counts()
    del engines
    i8, b16 = out["int8"], out["bf16"]
    require_launched(i8["counts"], ("nibble_matmul", "flash_attention_fwd"))
    if i8["counts"]["paged_decode_attention"] \
            or i8["chunk_counts"]["paged_decode_attention"]:
        raise AssertionError("the paged-decode kernel ran on int8 pools")
    ratio = b16["cache_token_bytes"] / i8["cache_token_bytes"]
    same = sum(a == b for a, b in zip(i8["streams"], b16["streams"]))
    print(f"  int8: {i8['tok_s']:.2f} tok/s, host ms per captured decode "
          f"chunk {i8['chunk_ms']:.3f}; bf16 (same settings, this call): "
          f"{b16['tok_s']:.2f} tok/s, {b16['chunk_ms']:.3f} ms ({smi}); "
          f"launches int8 {i8['counts']}; cache bytes per token bf16 "
          f"{b16['cache_token_bytes']} / int8 {i8['cache_token_bytes']} = "
          f"{ratio:.4f}; streams equal to bf16's {same}/{len(prompts)} "
          f"(not required: int8 rows move the logits)", flush=True)
    if ratio < 1.9:
        raise AssertionError(f"int8 cache bytes ratio {ratio} < 1.9")

    # the workload phase's overcommitted pool and traffic, host swap
    worst = pages_needed(prefill_len + 64 - 1, cfg.page_size)
    num_pages = 1 + worst * 3 // 2
    eng = Engine(cfg, params, ServeConfig(
        batch=slots, max_len=prefill_len + 64, prefill_len=prefill_len,
        decode_chunk=8, priority_aging_s=1.0, alloc_mode="incremental",
        num_pages=num_pages, swap_mode="host"), device=DEV)
    reset_counts()
    res = run_timed_workload(eng, cfg.vocab_size, requests=16,
                             prompt_budget=prefill_len, new_tokens=64,
                             stagger_s=0.05, seed=0, priority_mix=0.25,
                             arrival_mode="bursty", collect_streams=True)
    torch.cuda.synchronize()
    swap_counts = read_counts()
    _check_streams(res.pop("streams"), 64, cfg.vocab_size)
    print(f"  int8 + host swap (the workload's {num_pages}-page pool, bursty "
          f"16 x 64; {smi}): {res['tok_per_s']} tok/s, ttft p50 "
          f"{res['ttft_p50_ms']} ms, itl p99 {res['itl_p99_ms']} ms, "
          f"{res['preemptions']} preemptions, swap out {res['swap_out']} / "
          f"in {res['swap_in']}; launches {swap_counts}", flush=True)
    if res["preemptions"] < 1 or res["swap_in"] < 1:
        raise AssertionError("the int8 swap run preempted or swapped nobody")
    if eng.leaked_pages() or eng.host_pool.in_use:
        raise AssertionError("the int8 swap run leaked pages")
    if swap_counts["paged_decode_attention"]:
        raise AssertionError("the paged-decode kernel ran on int8 pools")
    require_captured(eng, "int8 swap")
    del eng

    err = _int8_decode_error(params, cfg, np.concatenate(prompts)[:96])
    print(f"  teacher-forced int8-cache decode (dense, full width, 32 "
          f"prompt + 63 decoded tokens) against the bf16 forward: max|diff| "
          f"/ max|logit| {err:.4f} (bound {INT8_DECODE_RTOL})", flush=True)
    if not err < INT8_DECODE_RTOL:
        raise AssertionError(f"int8 decode drifts {err} from bf16")

    # exact checks, dense at 4 layers
    dcfg = cfg.replace(quant_mode="dense", n_layers=4)
    dparams = {**params, "layers": params["layers"][:4]}
    runs = {}
    for label, over in (("slab", dict(cache_mode="dense",
                                      alloc_mode="reserve")),
                        ("paged", {})):
        eng = Engine(dcfg, dparams, dataclasses.replace(scfg, **over),
                     device=DEV)
        runs[label], _, _ = _serve_timed(eng, prompts, n_new)
        require_captured(eng, f"int8 dense {label}")
    paged_same = sum(a == b for a, b in zip(runs["paged"], runs["slab"]))
    over = _dense_overcommit_int8(dcfg, dparams)
    print(f"  dense 4-layer int8: paged streams equal to the dense slab's "
          f"{paged_same}/{len(prompts)}; host swap ({over['preemptions']} "
          f"preemptions, {over['swap_in']} swap-ins) against replay "
          f"{over['equal']}/{over['n']}", flush=True)
    if paged_same != len(prompts) or over["equal"] != over["n"]:
        raise AssertionError("int8 streams differ between paged and slab, or "
                             "between swap and replay")
    wall = time.perf_counter() - t_phase
    print(f"  int8 kv phase {wall:.1f} s", flush=True)
    for r in (i8, b16):
        del r["streams"]
    return {"int8": i8, "bf16": b16, "bytes_ratio": ratio, "swap": res,
            "swap_counts": swap_counts, "decode_rel_err": err,
            "paged_equal": paged_same, "swap_vs_replay": over,
            "counts": i8["counts"], "wall_s": wall}


def _dense_overcommit_int8(dcfg, dparams) -> dict:
    """The uniform 8 x 64 workload through a 1.5-worst-case incremental
    pool, with the host swap and with replay: equal streams."""
    prefill_len, n_new = 128, 64
    num_pages = 1 + pages_needed(prefill_len + n_new - 1,
                                 dcfg.page_size) * 3 // 2
    res = {}
    for label, mech in (("replay", {}), ("swap", {"swap_mode": "host"})):
        eng = Engine(dcfg, dparams, ServeConfig(
            batch=4, max_len=prefill_len + n_new, prefill_len=prefill_len,
            decode_chunk=8, alloc_mode="incremental", num_pages=num_pages,
            **mech), device=DEV)
        res[label] = run_timed_workload(eng, dcfg.vocab_size, requests=8,
                                        prompt_budget=prefill_len,
                                        new_tokens=n_new, seed=1,
                                        collect_streams=True)
        torch.cuda.synchronize()
        if eng.leaked_pages() or (eng.host_pool and eng.host_pool.in_use):
            raise AssertionError(f"int8 {label}: pages leaked")
        require_captured(eng, f"int8 dense {label}")
    sw = res["swap"]
    if sw["preemptions"] < 1 or sw["swap_in"] < 1:
        raise AssertionError("the int8 dense swap run swapped nobody")
    equal = sum(sw["streams"][n] == res["replay"]["streams"][n]
                for n in range(8))
    return {"preemptions": sw["preemptions"], "swap_in": sw["swap_in"],
            "equal": equal, "n": 8}


# ---------------------------------------------------------------------------
# Tensor parallelism inside one engine: yi-6b at tp=2 on one card
# ---------------------------------------------------------------------------

# the shards share the one card, as the CPU tests share the CPU
TP_DEVICES = ["cuda:0", "cuda:0"]


def _row_parallel_check(whole_params, shards, gen) -> dict:
    """``wo`` and ``down`` of layer 0 at M 4 and 128: the row-parallel
    path over the engine's two shards (each shard's half of K through the
    nibble kernel's exact int32 mode, the partials summed, the epilogue
    once) against the unsharded projection through the fused kernel, bit
    for bit."""
    out = {}
    for name, (blk, lin) in (("wo", ("attn", "wo")),
                             ("down", ("mlp", "down"))):
        whole = whole_params["layers"][0][blk][lin]
        parts = [p["layers"][0][blk][lin] for p in shards]
        k, n = whole["w"].shape
        half = parts[0]["qt8"].shape[1]
        for m in (4, 128):
            x = (torch.randn((m, k), device=DEV, generator=gen)
                 * 0.5).bfloat16()
            want = linear_apply(whole, x, mode="w8a8_nibble",
                                backend="cuda")
            got = linear_apply_row(parts, [x[:, :half], x[:, half:]],
                                   mode="w8a8_nibble", backend="cuda")
            if not all(torch.equal(g, want) for g in got):
                diff = (got[0].float() - want.float()).abs().max().item()
                raise AssertionError(f"row-parallel {name} at M={m} differs "
                                     f"from the fused kernel: {diff}")
            out[f"{name} M={m}"] = {"shard": (m, half, n), "equal": True}
    print(f"  row-parallel int32 partials + epilogue equal to the fused "
          f"kernel bit for bit: {sorted(out)}", flush=True)
    return out


def _tp_step_diff(params, tp_params, cfg, prompt) -> dict:
    """The prompt's prefill and one paged decode step (the argmax token
    at the next row) at tp=1 and tp=2: the largest logit difference of
    each."""
    ps = cfg.page_size
    n = len(prompt)
    grow = -(-n // ps) * ps
    pages = list(range(1, grow // ps + 2))
    tok = torch.as_tensor(prompt, device=DEV).long()[None]
    table = torch.tensor([pages], device=DEV)
    out = {}
    logits = []
    for p in (params, tp_params):
        lp, one, _ = prefill(p, cfg, tok, max_len=grow)
        if p is params:
            pool = init_caches(cfg, 1, len(pages) * ps, device=DEV)
        else:
            pool = init_shard_caches(cfg, 1, len(pages) * ps, p)
        merge_slot_paged_caches(pool, one, 0, table[0])
        nxt = torch.argmax(lp[:, -1], dim=-1)[:, None] if not logits \
            else logits[0][2]
        ld, _ = decode_step(p, cfg, nxt, pool, torch.tensor([n], device=DEV),
                            page_table=table)
        logits.append((lp, ld, nxt))
    out["prefill_max_abs_diff"] = (logits[0][0] - logits[1][0]).abs() \
        .max().item()
    out["decode_max_abs_diff"] = (logits[0][1] - logits[1][1]).abs() \
        .max().item()
    out["max_abs_logit"] = logits[0][1].abs().max().item()
    out["max_abs_prefill_logit"] = logits[0][0].abs().max().item()
    return out


def _tp_pair(cfg, params, scfg, prompts, n_new, label, serve) -> dict:
    """``prompts`` through a tp=1 engine and a tp=2 engine on
    ``TP_DEVICES`` (``_serve_timed``: launch counts of the timed run);
    the streams held equal or to the margin rule, the tp=2 engine's
    topology, capture and leaks checked."""
    e1 = Engine(cfg, params, scfg, device=DEV)
    s1, w1, c1 = _serve_timed(e1, prompts, n_new)
    e2 = Engine(cfg, params, dataclasses.replace(scfg, tp=2),
                devices=TP_DEVICES)
    s2, w2, c2 = _serve_timed(e2, prompts, n_new)
    if e2.mesh_shape != (1, 2) or e2.device_count != 2:
        raise AssertionError(f"{label}: mesh {e2.mesh_shape}, "
                             f"{e2.device_count} devices")
    require_captured(e2, f"{label} tp=2")
    require_no_f32(c2)
    margins = [] if s1 == s2 else divergence_margins(params, cfg, prompts,
                                                     s1, s2)
    held = hold_margins(f"{label}: tp=2 against tp=1", margins,
                        len(prompts), serve)
    n_tok = sum(map(len, s2))
    return {"engines": (e1, e2), "counts_tp1": c1, "counts": c2,
            "tok_s_tp1": n_tok / w1, "tok_s": n_tok / w2, "held": held}


def phase_tp(params, prompts, serve: dict, smi: str, gen) -> dict:
    """Tensor parallelism on one card (docstring item 7t)."""
    cfg = get_config("yi-6b").replace(
        quant_mode="w8a8_nibble", quant_backend="cuda", attn_impl="flash",
        cache_mode="paged", page_size=16)
    n_new, prefill_len = 32, 128
    scfg = ServeConfig(batch=4, max_len=prefill_len + n_new,
                       prefill_len=prefill_len, decode_chunk=8)
    print(f"tp: {cfg.name} full width, all layers, w8a8_nibble on CUDA, "
          f"paged (page 16), 4 slots; the serve phase's {len(prompts)} "
          f"requests x {n_new} at tp=1 and at tp=2 over {TP_DEVICES} "
          f"({smi})", flush=True)
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    pair = _tp_pair(cfg, params, scfg, prompts, n_new, "yi-6b", serve)
    e1, e2 = pair.pop("engines")
    c1, c2 = pair["counts_tp1"], pair["counts"]
    require_launched(c2, ("nibble_matmul", "flash_attention_fwd",
                          "paged_decode_attention"))
    steps = c1["paged_decode_attention"] // 32
    prefills = c1["flash_attention_fwd"] // 32
    want = {"nibble_matmul": 448 * (steps + prefills),
            "paged_decode_attention": 64 * steps,
            "flash_attention_fwd": 64 * prefills}
    got = {k: c2[k] for k in want}
    if got != want or any(c2[k] != 2 * c1[k] for k in want):
        raise AssertionError(f"tp=2 launches {got}, expected {want} (tp=1: "
                             f"{ {k: c1[k] for k in want} })")
    print(f"  launches, {steps} decode steps and {prefills} prefills: tp=2 "
          f"{got} (448 nibble and 64 paged a step, 64 flash a prefill), "
          f"tp=1 { {k: c1[k] for k in want} }", flush=True)
    out = dict(pair, steps=steps, prefills=prefills,
               mesh_shape=list(e2.mesh_shape), device_count=e2.device_count,
               captures=e2.capture_counts)
    reset_counts()
    out["row_parallel"] = _row_parallel_check(params, e2.params, gen)
    out["step_diff"] = _tp_step_diff(params, e2.params, cfg, prompts[0])
    print(f"  one paged decode step, tp=2 against tp=1: max|dlogit| "
          f"{out['step_diff']['decode_max_abs_diff']:.4e} (max|logit| "
          f"{out['step_diff']['max_abs_logit']:.4f}); prefill "
          f"{out['step_diff']['prefill_max_abs_diff']:.4e}", flush=True)
    chunk = {"tp1": [], "tp2": []}
    for name, eng in (("tp1", e1), ("tp2", e2), ("tp2", e2), ("tp1", e1)):
        chunk[name].append(_chunk_ms(eng, prompts))
    out["chunk_ms"] = {k: statistics.median(v) for k, v in chunk.items()}
    out["chunk_runs"] = chunk
    out["max_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
    print(f"  ({smi}) tok/s tp=1 {out['tok_s_tp1']:.2f}, tp=2 "
          f"{out['tok_s']:.2f}; host ms per captured decode chunk tp=1 "
          f"{out['chunk_ms']['tp1']:.3f}, tp=2 {out['chunk_ms']['tp2']:.3f} "
          f"(runs {chunk}); max memory allocated "
          f"{out['max_memory_gib']:.2f} GiB", flush=True)
    del e1, e2
    gc.collect()
    torch.cuda.empty_cache()
    rng = np.random.default_rng(2)
    out["shapes"] = {
        "wq shard": _nibble_case(gen, "tp wq shard", 4, 4096, 2048),
        "wk/wv shard": _nibble_case(gen, "tp wk/wv shard", 4, 4096, 256),
        "gate/up shard": _nibble_case(gen, "tp gate/up shard", 4, 4096,
                                      5504),
        "paged shard": _paged_case(gen, rng, "tp shard", 2, 8, 128, 0)}
    out["gemma3"] = _tp_gemma3(serve, smi)
    out["qat"] = _tp_qat(params, prompts, serve, smi)
    out["attention_core_heads"] = check_attention_core_heads(gen)
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"  tp phase {out['wall_s']:.1f} s", flush=True)
    return out


def _tp_qat(params, prompts, serve: dict, smi: str) -> dict:
    """The serve cell's full-width yi-6b in ``qat`` (fake-quantized
    operands, f32 products) at tp=1 and tp=2 on ``TP_DEVICES``, 4
    requests x 16: a row-parallel ``qat`` projection takes the shards'
    amaxes by max and sums f32 partials, so tp=2 is within a rounding of
    tp=1, not bit for bit.  The prefill's and one decode step's logits
    are held within the serve phase's logit tolerance (the dense bound of
    the margin rule), the streams equal or diverging only at a near-tie
    (``hold_margins``)."""
    cfg = get_config("yi-6b").replace(
        quant_mode="qat", attn_impl="flash", cache_mode="paged",
        page_size=16)
    scfg = ServeConfig(batch=4, max_len=128 + 16, prefill_len=128,
                       decode_chunk=8)
    pair = _tp_pair(cfg, params, scfg, prompts[:4], 16, "yi-6b qat",
                    serve)
    e1, e2 = pair.pop("engines")
    diff = _tp_step_diff(params, e2.params, cfg, prompts[0])
    worst = max(diff["prefill_max_abs_diff"], diff["decode_max_abs_diff"])
    print(f"  yi-6b qat ({smi}): tp=2 against tp=1 max|dlogit| prefill "
          f"{diff['prefill_max_abs_diff']:.4e}, one decode step "
          f"{diff['decode_max_abs_diff']:.4e} (max|logit| "
          f"{diff['max_abs_logit']:.4f}; bound {serve['logit_tol']:.4f}); "
          f"tok/s tp=1 {pair['tok_s_tp1']:.2f}, tp=2 {pair['tok_s']:.2f}",
          flush=True)
    if worst > serve["logit_tol"]:
        raise AssertionError(f"yi-6b qat: tp=2 logits {worst} from tp=1's,"
                             f" above {serve['logit_tol']}")
    del e1, e2
    gc.collect()
    torch.cuda.empty_cache()
    return dict(pair, step_diff=diff)


# ``fixed_mean``'s check: the models' widths, and row counts a call takes
MEAN_WIDTHS = (64, 96, 128, 256, 512, 1152, 1536, 2048, 2560, 3072, 3584,
               4096, 5120, 7168, 8192, 14336)
MEAN_ROW_COUNTS = (1, 2, 3, 4, 8, 15, 16, 17, 64, 257, 1024)


def check_fixed_mean() -> dict:
    """``layers.fixed_mean`` (``rms_norm``'s mean of squares) on the card:
    every row of a call of R rows must equal the same row in a call of
    its own, at the models' widths and R from 1 to 1024 (a data row's
    slots against the whole batch's); the rows where the plain
    ``torch.mean`` differs that way are counted beside it (printed, no
    limit)."""
    gen = torch.Generator(device=DEV).manual_seed(5)
    t = time.perf_counter()
    n = max(MEAN_ROW_COUNTS)
    plain, bad = {}, {}
    for d in MEAN_WIDTHS:
        x = torch.randn((n, d), device=DEV, generator=gen) ** 2
        alone = torch.cat([fixed_mean(x[i:i + 1]) for i in range(n)])
        alone_plain = torch.cat([torch.mean(x[i:i + 1], -1, keepdim=True)
                                 for i in range(n)])
        for r in MEAN_ROW_COUNTS:
            miss = int((fixed_mean(x[:r]) != alone[:r]).sum())
            if miss:
                bad[f"{d}x{r}"] = miss
            miss = int((torch.mean(x[:r], -1, keepdim=True)
                        != alone_plain[:r]).sum())
            if miss:
                plain[f"{d}x{r}"] = miss
    out = {"plain_rows_differing": plain, "seconds":
           time.perf_counter() - t}
    print(f"fixed_mean: every row of a call of 1-1024 rows equals its row "
          f"alone at widths {MEAN_WIDTHS}: "
          f"{'yes' if not bad else bad}; plain torch.mean rows that differ "
          f"(width x rows: rows) {plain} ({out['seconds']:.1f} s)",
          flush=True)
    if bad:
        raise AssertionError(f"fixed_mean depends on the row count: {bad}")
    return out


# the data-axis shapes on the one card: (dp, tp) -> its entries
DP_SHAPES = ((1, 1), (2, 1), (2, 2))


def _dp_devices(shape) -> list:
    return [DEV + ":0"] * (shape[0] * shape[1])


def _dp_step_diff(params, dp_params, cfg, prompts) -> dict:
    """The first four prompts prefilled alone into four slots over paged
    pools (slots 0-1 on data row 0, 2-3 on row 1 at dp=2), then one
    decode step of all four at per-slot positions, on the single-device
    tree and on ``dp_params``: the largest difference of the prefills'
    logits and of the step's."""
    ps, b = cfg.page_size, 4
    prompts = prompts[:b]
    per_slot = -(-(max(map(len, prompts)) + 1) // ps)
    table = torch.arange(1, 1 + b * per_slot, device=DEV).reshape(b, -1)
    c = cfg.replace(num_pages=1 + b * per_slot)
    lens = torch.tensor([len(p) for p in prompts], device=DEV)
    out, nxt = [], None
    for p in (params, dp_params):
        caches = (init_caches(c, b, per_slot * ps, device=DEV)
                  if p is params else
                  init_shard_caches(c, b, per_slot * ps, p))
        pre = []
        for slot, prompt in enumerate(prompts):
            tok = torch.as_tensor(prompt, device=DEV).long()[None]
            lp, one, _ = prefill(p, c, tok, max_len=-(-len(prompt) // ps)
                                 * ps)
            merge_slot_paged_caches(caches, one, slot, table[slot])
            pre.append(lp)
        pre = torch.cat(pre)
        if nxt is None:
            nxt = torch.argmax(pre[:, -1], dim=-1)[:, None]
        ld, _ = decode_step(p, c, nxt, caches, lens, page_table=table)
        out.append((pre, ld))
    return {"prefill_max_abs_diff": (out[0][0] - out[1][0]).abs().max()
            .item(),
            "decode_max_abs_diff": (out[0][1] - out[1][1]).abs().max()
            .item(),
            "max_abs_logit": out[0][1].abs().max().item(),
            "max_abs_prefill_logit": out[0][0].abs().max().item()}


def _dp_per_unit(shape) -> dict:
    """yi-6b's launches at ``shape``: a decode step runs every data row's
    slots (``dp * tp`` copies of the 224 projections and 32 paged decodes
    of tp=1), a batch-1 prefill one row (``tp`` copies of its 224
    projections and 32 flash forwards)."""
    dp, tp = shape
    return {"step": {"nibble_matmul": 224 * dp * tp,
                     "paged_decode_attention": 32 * dp * tp},
            "prefill": {"nibble_matmul": 224 * tp,
                        "flash_attention_fwd": 32 * tp}}


def phase_dp(params, prompts, serve: dict, smi: str) -> dict:
    """A data axis above 1 inside one engine on one card (docstring item
    7p): the serve cell at (1, 1), (2, 1) and (2, 2)."""
    cfg = get_config("yi-6b").replace(
        quant_mode="w8a8_nibble", quant_backend="cuda", attn_impl="flash",
        cache_mode="paged", page_size=16)
    n_new, prefill_len = 32, 128
    scfg = ServeConfig(batch=4, max_len=prefill_len + n_new,
                       prefill_len=prefill_len, decode_chunk=8)
    print(f"dp: {cfg.name} full width, all layers, w8a8_nibble on CUDA, "
          f"paged (page 16), 4 slots; the serve phase's {len(prompts)} "
          f"requests x {n_new} at {list(DP_SHAPES)} over cuda:0 repeated "
          f"({smi})", flush=True)
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    plans = {str(shape): fa.paged_plan(
        scfg.max_len, scfg.batch // shape[0],
        cfg.n_kv_heads // shape[1], cfg.n_heads // cfg.n_kv_heads,
        _sms())._asdict() for shape in DP_SHAPES}
    print(f"  paged decode plans (capacity {scfg.max_len}, slots a row, KV "
          f"heads a shard): {plans}: one split count and span",
          flush=True)
    # the grid follows the slots and heads; the splits and their span fix
    # each row's combine order
    if len({(v["n_split"], v["span"]) for v in plans.values()}) != 1:
        raise AssertionError(f"the paged plan changes with the data axis: "
                             f"{plans}")
    engines, streams_at, out = {}, {}, {"plans": plans}
    for shape in DP_SHAPES:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        eng = Engine(cfg, params, dataclasses.replace(scfg,
                                                      mesh_shape=shape),
                     devices=_dp_devices(shape))
        streams, wall, counts = _serve_timed(eng, prompts, n_new)
        if eng.mesh_shape != shape or eng.device_count != len(
                _dp_devices(shape)):
            raise AssertionError(f"dp {shape}: mesh {eng.mesh_shape}, "
                                 f"{eng.device_count} devices")
        require_captured(eng, f"dp {shape}")
        require_no_f32(counts)
        require_launched(counts, ("nibble_matmul", "flash_attention_fwd",
                                  "paged_decode_attention"))
        n_tok = sum(map(len, streams))
        streams_at[shape] = streams
        out[str(shape)] = {
            "counts": counts, "tok_s": n_tok / wall,
            "param_bytes": eng.param_bytes,
            "gathered_bytes_per_step": eng.gathered_bytes_per_step,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "captures": eng.capture_counts}
        engines[shape] = eng
    base = out[str((1, 1))]
    prefills = base["counts"]["flash_attention_fwd"] // 32
    steps = base["counts"]["paged_decode_attention"] // 32
    for shape in DP_SHAPES:
        r = out[str(shape)]
        per = _dp_per_unit(shape)
        want = {k: per["step"].get(k, 0) * steps
                + per["prefill"].get(k, 0) * prefills
                for k in ("nibble_matmul", "paged_decode_attention",
                          "flash_attention_fwd")}
        got = {k: r["counts"][k] for k in want}
        equal = [a == b for a, b in zip(streams_at[shape],
                                        streams_at[(1, 1)])]
        print(f"  dp {shape}: streams equal (1, 1)'s {sum(equal)}/"
              f"{len(equal)}; launches {got} for {steps} decode steps and "
              f"{prefills} prefills (a step {per['step']}, a prefill "
              f"{per['prefill']}); tok/s {r['tok_s']:.2f}; parameter bytes "
              f"stored per entry {r['param_bytes']}; weight bytes gathered "
              f"per decode step {r['gathered_bytes_per_step']}; peak memory "
              f"{r['peak_gib']:.2f} GiB", flush=True)
        if not all(equal):
            raise AssertionError(f"dp {shape}: streams differ from (1, 1)'s:"
                                 f" {equal}")
        if got != want:
            raise AssertionError(f"dp {shape}: launches {got}, expected "
                                 f"{want}")
        r["steps"], r["prefills"], r["per_unit"] = steps, prefills, per
    reset_counts()
    for shape in DP_SHAPES[1:]:
        d = _dp_step_diff(params, engines[shape].params, cfg, prompts)
        out[str(shape)]["step_diff"] = d
        print(f"  dp {shape} against (1, 1), four slots: max|dlogit| "
              f"prefill {d['prefill_max_abs_diff']}, one decode step "
              f"{d['decode_max_abs_diff']} (max|logit| "
              f"{d['max_abs_logit']:.4f})", flush=True)
        if d["prefill_max_abs_diff"] or d["decode_max_abs_diff"]:
            raise AssertionError(f"dp {shape}: logits differ from (1, 1)'s:"
                                 f" {d}")
    runs = {str(s): [] for s in DP_SHAPES}
    for shape in DP_SHAPES + DP_SHAPES[::-1]:
        runs[str(shape)].append(_chunk_ms(engines[shape], prompts))
    chunk = {k: statistics.median(v) for k, v in runs.items()}
    out["chunk_ms"], out["chunk_runs"] = chunk, runs
    out["chunk_ratio"] = {k: v / chunk[str((1, 1))] for k, v in chunk.items()}
    print(f"  ({smi}) host ms per captured decode chunk, in turns: {chunk} "
          f"(runs {runs}); ratio to (1, 1) {out['chunk_ratio']}", flush=True)
    del engines
    gc.collect()
    torch.cuda.empty_cache()
    dcfg = cfg.replace(quant_mode="dense")
    mesh = make_local_mesh(dp=2, tp=1, devices=_dp_devices((2, 1)))
    dense = _dp_step_diff(params, shard_params(params, dcfg, mesh), dcfg,
                          prompts)
    worst = max(dense["prefill_max_abs_diff"], dense["decode_max_abs_diff"])
    print(f"  dense at (2, 1) against (1, 1), four slots: max|dlogit| "
          f"prefill {dense['prefill_max_abs_diff']:.4e}, one decode step "
          f"{dense['decode_max_abs_diff']:.4e} (bound: the serve phase's "
          f"logit tolerance {serve['logit_tol']:.4f})", flush=True)
    if worst > serve["logit_tol"]:
        raise AssertionError(f"dense at (2, 1): logits {worst} from (1, 1)'s"
                             f", above {serve['logit_tol']}")
    out["dense_step_diff"] = dense
    gc.collect()
    torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"  dp phase {out['wall_s']:.1f} s", flush=True)
    return out


def dp_family(cfg, run: dict, smi: str, capture=None) -> dict:
    """A family cell at (2, 1) on ``cuda:0`` repeated (docstring item 7p):
    the model's served requests, on its served weights, must give the
    (1, 1) cell's streams token for token.  The caller's weight tree is
    dropped once the engine stores its pieces (``run["params"]`` is
    popped), so a model the card holds once fits beside its pieces and
    one layer's gather."""
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    prompts, scfg = run["prompts"], run["scfg"]
    n_new = len(run["streams"][0])
    eng = Engine(cfg, run.pop("params"), dataclasses.replace(
        scfg, mesh_shape=(2, 1)), devices=_dp_devices((2, 1)),
        capture=capture)
    gc.collect()
    torch.cuda.empty_cache()
    streams, wall, counts = _serve_timed(eng, prompts, n_new)
    equal = [a == b for a, b in zip(streams, run["streams"])]
    out = {"counts": counts, "streams_equal": sum(equal),
           "tok_s": sum(map(len, streams)) / wall,
           "param_bytes": eng.param_bytes,
           "gathered_bytes_per_step": eng.gathered_bytes_per_step,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "captures": eng.capture_counts}
    kernels = {k: counts[k] for k in FAMILY_KERNELS}
    print(f"  dp {cfg.name} at (2, 1) ({smi}): streams equal (1, 1)'s "
          f"{sum(equal)}/{len(equal)} (prompt lengths "
          f"{[len(p) for p in prompts]} x {n_new}); launches {kernels}; "
          f"tok/s {out['tok_s']:.2f}; parameter bytes per entry "
          f"{out['param_bytes']}; gathered per decode step "
          f"{out['gathered_bytes_per_step']}; peak {out['peak_gib']:.2f} GiB;"
          f" CUDA graphs {out['captures']}", flush=True)
    if not all(equal):
        raise AssertionError(f"dp {cfg.name}: streams differ from (1, 1)'s:"
                             f" {equal}")
    require_no_f32(counts)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return out


def check_attention_core_heads(gen) -> dict:
    """Queue 3 lead 1, directly: ``attention_core`` over each tp=2 shard's
    heads alone (as a card of its own runs them) against the same rows of
    the whole call, bit for bit, at MLA's decode (4 slots, 128 heads of
    q/k 192 and v 128 against 2 x 64, 160 rows) and phi-3-vision's (32
    heads of d 96 against 2 x 16, 736 rows)."""
    out = {}
    for label, (b, h, d, dv, sk) in (
            ("MLA decode 64 of 128 heads", (4, 128, 192, 128, 160)),
            ("phi-3-vision decode 16 of 32 heads", (4, 32, 96, 96, 736))):
        q = torch.randn((b, 1, h, d), device=DEV, generator=gen).bfloat16()
        k = torch.randn((b, sk, h, d), device=DEV, generator=gen).bfloat16()
        v = torch.randn((b, sk, h, dv), device=DEV, generator=gen) \
            .bfloat16()
        qp = torch.full((b, 1), sk - 1, device=DEV)
        kp = torch.arange(sk, device=DEV)[None].expand(b, sk)
        scale = 1.0 / d ** 0.5
        whole = attention_core(q, k, v, qp, kp, scale=scale)
        half = h // 2
        diff = max((attention_core(q[:, :, sl], k[:, :, sl], v[:, :, sl],
                                   qp, kp, scale=scale)
                    - whole[:, :, sl]).abs().max().item()
                   for sl in (slice(0, half), slice(half, h)))
        out[label] = diff
    print(f"  attention_core per shard against the whole call, max diff "
          f"{out}", flush=True)
    if any(out.values()):
        raise AssertionError(f"attention_core rows depend on the heads "
                             f"beside them: {out}")
    return out


def _attend_block_einsums(q, k, v, q_pos, k_pos, *, scale, causal, window,
                          softcap):
    """``attention_core``'s products before they were made independent of
    the head count: one f32 einsum each over a batch of every (slot, kv
    head), kept for ``attention_core_ab``."""
    logits = torch.einsum("bqhgd,bkhd->bhgqk", q.to(torch.float32),
                          k.to(torch.float32)) * scale
    if softcap:
        logits = torch.tanh(logits / softcap) * softcap
    dq = q_pos[:, None, None, :, None]
    dk = k_pos[:, None, None, None, :]
    mask = torch.ones((), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (dk <= dq)
    if window:
        mask = mask & (dq - dk < window)
    logits = torch.where(mask, logits, torch.full_like(logits, -2.0 ** 30))
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhgqk,bkhd->bqhgd",
                        probs.to(v.dtype).to(torch.float32),
                        v.to(torch.float32))


def _kernel_launches(fn) -> int:
    """CUDA kernels one eager ``fn()`` launches (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA)


# one turn of ``serve_ab``, run by ``python3 -c`` at a tree's root with
# that tree's ``chip_smoke.py``: the serve phase's yi-6b requests through
# a ``capture=False`` engine and a captured one
_SERVE_TURN = r"""
import json, time
import numpy as np
import chip_smoke as cs
t0 = time.perf_counter()
cs.phase_build()
cfg = cs.get_config("yi-6b").replace(
    quant_mode="w8a8_nibble", quant_backend="cuda", attn_impl="flash",
    cache_mode="paged", page_size=16)
params = cs.model_init(cfg, seed=0, device=cs.DEV)
rng = np.random.default_rng(0)
lens = rng.integers(32, 129, 8)
prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
           for n in lens]
out = {}
for label, capture in (("eager", False), ("captured", True)):
    eng = cs.Engine(cfg, params, cs.ServeConfig(
        batch=4, max_len=160, prefill_len=128, decode_chunk=8),
        device=cs.DEV, capture=capture)
    streams, wall, _ = cs._serve_timed(eng, prompts, 32)
    out[label + "_tok_s"] = sum(map(len, streams)) / wall
    del eng
out["process_s"] = time.perf_counter() - t0
print("SERVE_TURN " + json.dumps(out), flush=True)
"""


def serve_ab(trees, pairs: int = 3) -> list:
    """The serve phase's requests, eager and captured, under each tree's
    ``chip_smoke.py`` in turns (a, b, b, a, a, b, ...: ``pairs`` turns
    each), each turn a process of its own started at the tree's root.
    Not run by ``main``: ``python3 -c "import chip_smoke as c;
    c.serve_ab(['path/to/parent', '.'])"`` compares a parent tree's
    serving with this tree's on one card."""
    order = [trees[(i + 1) // 2 % 2] for i in range(2 * pairs)]
    out = []
    for tree in order:
        proc = subprocess.run([sys.executable, "-c", _SERVE_TURN], cwd=tree,
                              capture_output=True, text=True, timeout=600)
        line = [ln for ln in proc.stdout.splitlines()
                if ln.startswith("SERVE_TURN ")]
        if proc.returncode or not line:
            raise AssertionError(f"serve turn in {tree}: "
                                 f"{proc.stderr[-2000:]}")
        out.append({"tree": tree, **json.loads(line[0].split(" ", 1)[1])})
        print(f"serve_ab {tree}: {out[-1]}", flush=True)
    return out


@torch.no_grad()
def costed_overhead(reps: int = 4, calls: int = 2000) -> dict:
    """What the kernels' cost hook (``kernels.ops.costed``) adds to an
    eager call: host microseconds per call of ``quant_matmul`` through
    its costed entry and straight to the function it wraps, in turns
    (entry, bare, bare, entry; medians), at a shape whose kernel is
    shorter than the call's host work (1 x 256 int8 against 256 x 256, the
    nibble kernel), so the loop times the host; and the costed calls
    of one eager decode chunk (the serve phase's engine, 4 slots, its
    chunk's body run eagerly on zeros), counted by a hook that only
    counts, beside that chunk's host ms."""
    gen = torch.Generator(device=DEV).manual_seed(0)
    x = torch.randint(-128, 128, (1, 256), generator=gen, device=DEV,
                      dtype=torch.int8)
    w = torch.randint(-128, 128, (256, 256), generator=gen, device=DEV,
                      dtype=torch.int8)
    entry = kops.quant_matmul
    bare = entry.__wrapped__
    times = {"entry": [], "bare": []}
    for name in ("entry", "bare", "bare", "entry") * reps:
        fn = entry if name == "entry" else bare
        times[name].append(host_us(lambda: fn(x, w), calls))
    per = {k: statistics.median(v) for k, v in times.items()}

    cfg = get_config("yi-6b").replace(
        quant_mode="w8a8_nibble", quant_backend="cuda", attn_impl="flash",
        cache_mode="paged", page_size=16)
    params = model_init(cfg, seed=0, device=DEV)
    eng = Engine(cfg, params, ServeConfig(batch=4, max_len=160,
                                          prefill_len=128, decode_chunk=8),
                 device=DEV, capture=False)
    rng = np.random.default_rng(0)
    for n in (40, 60, 80, 100):
        eng.submit(rng.integers(0, cfg.vocab_size, n).astype(np.int32), 8)
    eng.run()
    chunk = eng.stage_programs()["decode_chunk"]
    sig = chunk.signatures[0]
    calls_seen = []

    def count(fn, cost, args, kwargs):
        calls_seen.append(fn.__name__)
        return fn(*args, **kwargs)

    kops.cost_hook = count
    try:
        chunk.rerun(sig)          # the chunk's body on zeros, eagerly
    finally:
        kops.cost_hook = None
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(3):
        chunk.rerun(sig)
    torch.cuda.synchronize()
    chunk_ms = (time.perf_counter() - t) / 3 * 1e3
    del eng, params, chunk
    torch.cuda.empty_cache()
    out = {"entry_us": per["entry"], "bare_us": per["bare"],
           "runs_us": times, "calls_per_chunk": len(calls_seen),
           "by_fn": {n: calls_seen.count(n) for n in sorted(set(calls_seen))},
           "eager_chunk_ms": chunk_ms}
    out["chunk_overhead_ms"] = (len(calls_seen)
                                * (per["entry"] - per["bare"]) / 1e3)
    print(f"costed_overhead: {out}", flush=True)
    return out


@torch.no_grad()
def attention_core_ab(smi: str) -> dict:
    """Each path that attends in ``attention_core``, under the earlier
    formulation (``_attend_block_einsums``) and the current one
    (``fixed_bmm`` entries of one shape), in turns (old, new, new, old; the medians):
    device ms of one call captured in a CUDA graph (the decode steps) or
    CUDA-event ms of an eager call (the prefills and the encoder, which
    run eagerly in the engine), and the CUDA kernels one eager call
    launches.  Paths, at full width: MLA decode (deepseek-v3 cut to its
    first layer, 4 slots x 160 paged rows), the spec verify at S = 5
    (yi-6b cut to 4 layers, ``dense`` as the verify runs), the int8-KV
    decode (yi-6b 4 layers, ``w8a8_nibble``), a wave chunk (S 32) and a
    context prefill (S 128) against 64 cached rows (yi-6b 4 layers), and
    whisper-base's encoder over 4 x 1500 stub frames."""
    import repro_torch.models.attention as attn_mod
    from repro_torch.models import encode
    paged = dict(quant_backend="cuda", attn_impl="flash", cache_mode="paged",
                 page_size=16)
    b, rows = 4, 160
    table = torch.arange(1, 1 + b * rows // 16, device=DEV).reshape(b, -1)
    pos = torch.tensor([150, 120, 100, 159], device=DEV)
    gen = torch.Generator(device=DEV).manual_seed(5)

    def toks(cfg, s, n=b):
        return torch.randint(0, cfg.vocab_size, (n, s), device=DEV,
                             generator=gen)

    def decode_case(cfg, s=1):
        params = model_init(cfg, seed=0, device=DEV)
        pools = init_caches(cfg, b, rows, device=DEV)
        tok = toks(cfg, s)
        return (lambda: decode_step(params, cfg, tok, pools, pos,
                                    page_table=table)), True

    cases = {}
    cases["MLA decode (deepseek-v3, 1 layer)"] = decode_case(
        get_config("deepseek-v3-671b").replace(
            n_layers=1, quant_mode="w8a8_nibble", **paged))
    yi4 = get_config("yi-6b").replace(n_layers=4, **paged)
    cases["spec verify S=5 (yi-6b, 4 layers, dense)"] = decode_case(
        yi4.replace(quant_mode="dense"), s=5)
    cases["int8-KV decode (yi-6b, 4 layers)"] = decode_case(
        yi4.replace(quant_mode="w8a8_nibble", kv_cache_dtype="int8"))
    wcfg = yi4.replace(quant_mode="w8a8_nibble")
    wparams = model_init(wcfg, seed=0, device=DEV)
    wpools = init_caches(wcfg, b, rows, device=DEV)
    for label, s in (("wave chunk S=32", 32), ("context prefill S=128", 128)):
        tok = toks(wcfg, s, 1)
        cases[f"{label} (yi-6b, 4 layers)"] = (
            lambda tok=tok: prefill(wparams, wcfg, tok, ctx_caches=wpools,
                                    ctx_table=table[:1],
                                    ctx_start=torch.tensor(64, device=DEV)),
            False)
    ecfg = get_config("whisper-base").replace(quant_mode="w8a8_nibble",
                                              **paged)
    eparams = model_init(ecfg, seed=0, device=DEV)
    frames = _stub_inputs(ecfg, b, 0)["frames"]
    cases["encoder (whisper-base, 4 x 1500)"] = (
        lambda: encode(eparams, ecfg, frames), False)
    new_block = attn_mod._attend_block
    runs = {label: {"old": [], "new": []} for label in cases}
    launches = {label: {} for label in cases}
    try:
        for variant in ("old", "new", "new", "old"):
            attn_mod._attend_block = (_attend_block_einsums
                                      if variant == "old" else new_block)
            for label, (fn, captured) in cases.items():
                if variant not in launches[label]:
                    launches[label][variant] = _kernel_launches(fn)
                runs[label][variant].append(
                    graph_ms(fn, reps=5) if captured else cuda_ms(fn,
                                                                  iters=10))
    finally:
        attn_mod._attend_block = new_block
    out = {}
    for label in cases:
        ms = {v: statistics.median(runs[label][v]) for v in ("old", "new")}
        out[label] = {"ms": ms, "runs": runs[label],
                      "launches": launches[label],
                      "captured": cases[label][1]}
        print(f"  attention_core A/B, {label} ({smi}): "
              f"{'graph' if cases[label][1] else 'eager'} ms old "
              f"{ms['old']:.4f}, new {ms['new']:.4f} (runs "
              f"{runs[label]}); kernel launches a call old "
              f"{launches[label]['old']}, new {launches[label]['new']}",
              flush=True)
    return out


def _tp_gemma3(serve: dict, smi: str) -> dict:
    """gemma3-1b at full width cut to 2 layers (KVH 1: attention
    replicated on both shards, the tied head vocab-parallel): 4 requests
    x 16 at tp=1 and tp=2, streams held as the yi-6b pair's."""
    cfg = get_config("gemma3-1b").replace(
        n_layers=2, quant_mode="w8a8_nibble", quant_backend="cuda",
        attn_impl="flash", cache_mode="paged", page_size=16)
    params = model_init(cfg, seed=0, device=DEV)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in rng.integers(32, 129, 4)]
    scfg = ServeConfig(batch=4, max_len=128 + 16, prefill_len=128,
                       decode_chunk=8)
    pair = _tp_pair(cfg, params, scfg, prompts, 16, "gemma3-1b 2 layers",
                    serve)
    pair.pop("engines")
    require_launched(pair["counts"], ("nibble_matmul", "flash_attention_fwd",
                                      "paged_decode_attention"))
    print(f"  gemma3-1b 2 layers ({smi}): tok/s tp=1 "
          f"{pair['tok_s_tp1']:.2f}, tp=2 {pair['tok_s']:.2f}; launches "
          f"tp=2 {pair['counts']}", flush=True)
    return pair


# ---------------------------------------------------------------------------
# TP families: MLA, MoE, the encoder-decoder and the VLM at tp=2
# ---------------------------------------------------------------------------

# launches of one decode step (and of one prefill, whose projections are
# the same) at tp=1 and tp=2, counted from the code: deepseek-v3 (4
# layers) runs 8 nibble projections a layer (wq_a, wq_b, wkv_a, wkv_b, wo
# and the MLP's or the shared expert's gate, up, down), at tp=2 the
# latent wq_a / wkv_a once on the shared card and the rest on both
# shards (14 a layer); llama4 (2 layers) 7 a layer and one paged decode,
# every one on both shards at tp=2.  The flash forward runs once a layer
# a prefill, at tp=2 once a shard.
TP_FAMILY_LAUNCHES = {
    "deepseek-v3-671b": ({"nibble_matmul": 32, "flash_attention_fwd": 4,
                          "paged_decode_attention": 0},
                         {"nibble_matmul": 56, "flash_attention_fwd": 8,
                          "paged_decode_attention": 0}),
    "llama4-maverick-400b-a17b": (
        {"nibble_matmul": 14, "flash_attention_fwd": 2,
         "paged_decode_attention": 2},
        {"nibble_matmul": 28, "flash_attention_fwd": 4,
         "paged_decode_attention": 4})}


def _bf16_ulp(x: float) -> float:
    """One bf16 ulp at ``|x|`` (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(abs(x))) - 7) if x else 0.0


def hold_tp_logits(label: str, diff: dict) -> dict:
    """tp=2's prefill and decode logits against tp=1's: equal, or the
    largest gap within one bf16 ulp of the largest logit."""
    big = max(diff["max_abs_logit"], diff["max_abs_prefill_logit"])
    worst = max(diff["prefill_max_abs_diff"], diff["decode_max_abs_diff"])
    tol = _bf16_ulp(big)
    print(f"  {label}: tp=2 against tp=1, max|dlogit| prefill "
          f"{diff['prefill_max_abs_diff']:.4e}, one decode step "
          f"{diff['decode_max_abs_diff']:.4e} (max|logit| {big:.4f}, one "
          f"bf16 ulp {tol:.4e})", flush=True)
    if worst > tol:
        raise AssertionError(f"{label}: tp=2 logits {worst} from tp=1's, "
                             f"above one bf16 ulp {tol}")
    return dict(diff, ulp=tol)


def _hold_per_step(label, counts, per, prefills) -> int:
    """Decode steps of a run from its nibble launches (a prefill and a
    step launch the same projections), then every kernel's count held to
    ``per`` a step and a prefill; returns the steps."""
    units, rest = divmod(counts["nibble_matmul"], per["nibble_matmul"])
    steps = units - prefills
    want = {"nibble_matmul": per["nibble_matmul"] * units,
            "flash_attention_fwd": per["flash_attention_fwd"] * prefills,
            "paged_decode_attention":
                per["paged_decode_attention"] * steps}
    got = {k: counts[k] for k in want}
    if rest or steps <= 0 or got != want:
        raise AssertionError(f"{label}: launches {got}, expected {want} "
                             f"({prefills} prefills)")
    return steps


def _chunks_in_turns(e1, e2, prompts) -> dict:
    chunk = {"tp1": [], "tp2": []}
    for name, eng in (("tp1", e1), ("tp2", e2), ("tp2", e2), ("tp1", e1)):
        chunk[name].append(_chunk_ms(eng, prompts))
    return {"chunk_ms": {k: statistics.median(v) for k, v in chunk.items()},
            "chunk_runs": chunk}


def tp_family_moe(cfg, run: dict, serve: dict, smi: str) -> dict:
    """A MoE model of the families phase at tp=2 (docstring item 7b,
    last part): its served requests through a tp=1 engine and a tp=2
    engine on ``TP_DEVICES`` (the same weights), streams and logits held,
    launches per decode step and prefill held to ``TP_FAMILY_LAUNCHES``,
    host ms per captured chunk in turns, tok/s and peak memory."""
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params, prompts = run["params"], run["prompts"]
    n_new = len(run["streams"][0])
    pair = _tp_pair(cfg, params, run["scfg"], prompts, n_new,
                    f"tp families {cfg.name}", serve)
    e1, e2 = pair.pop("engines")
    per1, per2 = TP_FAMILY_LAUNCHES[cfg.name]
    n = len(prompts)
    steps = _hold_per_step(f"{cfg.name} tp=1", pair["counts_tp1"], per1, n)
    if _hold_per_step(f"{cfg.name} tp=2", pair["counts"], per2, n) != steps:
        raise AssertionError(f"{cfg.name}: tp=2 ran another schedule")
    require_launched(pair["counts"], [k for k, v in per2.items() if v])
    pair.update(steps=steps, prefills=n, per_step={"tp1": per1, "tp2": per2},
                layout=dataclasses.asdict(e2.tp_layout),
                captures=e2.capture_counts)
    if not (e2.tp_layout.experts and e2.tp_layout.shared):
        raise AssertionError(f"{cfg.name}: experts not split at tp=2: "
                             f"{e2.tp_layout}")
    pair["step_diff"] = hold_tp_logits(
        f"tp families {cfg.name}",
        _tp_step_diff(params, e2.params, cfg, prompts[0]))
    pair.update(_chunks_in_turns(e1, e2, prompts))
    pair["max_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
    print(f"  tp families {cfg.name} ({smi}): {n} x {n_new}, {steps} decode "
          f"steps, {n} prefills; launches a step and a prefill {per1} at "
          f"tp=1, {per2} at tp=2 (held); tok/s tp=1 {pair['tok_s_tp1']:.2f},"
          f" tp=2 {pair['tok_s']:.2f}; host ms per captured decode chunk "
          f"tp=1 {pair['chunk_ms']['tp1']:.3f}, tp=2 "
          f"{pair['chunk_ms']['tp2']:.3f} (runs {pair['chunk_runs']}); max "
          f"memory allocated {pair['max_memory_gib']:.2f} GiB (both engines,"
          f" one weight tree, the expert stacks' shards views); layout "
          f"{pair['layout']}", flush=True)
    del e1, e2
    gc.collect()
    torch.cuda.empty_cache()
    return pair


def _tp2_params(params, cfg):
    return shard_params(params, cfg, make_local_mesh(tp=2,
                                                     devices=TP_DEVICES))


def tp_family_extras(cfg, params, prompts, extra, direct: dict,
                     served: dict, serve: dict, smi: str) -> dict:
    """An enc-dec or VLM model of the enc-dec + VLM phase at tp=2
    (docstring item 7d, last part): its requests with their stub inputs
    through ``prefill`` and 32 greedy decode steps on tp=2 shards against
    ``direct`` (the same at tp=1): streams equal or near-ties, the
    prefill's and the first step's logits equal or within one bf16 ulp,
    nibble and flash launches twice tp=1's; then 4 of the served requests
    x 16 text-only through a tp=1 and a tp=2 engine, held the same way
    (launches twice tp=1's, the chunk captured)."""
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tp2 = _tp2_params(params, cfg)
    got = _direct_decode(tp2, cfg, prompts, extra)
    want = {k: direct["counts"][k] * 2 for k in ("nibble_matmul",
                                                 "flash_attention_fwd")}
    if {k: got["counts"][k] for k in want} != want:
        raise AssertionError(f"{cfg.name} tp=2 direct launches "
                             f"{got['counts']}, expected {want}")
    require_no_f32(got["counts"])
    key = next(iter(extra))
    per_req = [{key: extra[key][i:i + 1]} for i in range(len(prompts))]
    dcfg = cfg.replace(cache_mode="dense")
    margins = ([] if got["streams"] == direct["streams"] else
               divergence_margins(params, dcfg, prompts, direct["streams"],
                                  got["streams"], extras=per_req))
    held = hold_margins(f"tp families {cfg.name} with {key}, 32 direct "
                        f"steps", margins, len(prompts), serve)
    (p1, d1), (p2, d2) = direct["logits"], got["logits"]
    diff = hold_tp_logits(f"tp families {cfg.name} with {key}", {
        "prefill_max_abs_diff": (p1 - p2).abs().max().item(),
        "decode_max_abs_diff": (d1 - d2).abs().max().item(),
        "max_abs_logit": d1.abs().max().item(),
        "max_abs_prefill_logit": p1.abs().max().item()})
    out = {"direct_counts": got["counts"], "direct_held": held,
           "direct_step_diff": diff,
           "direct_decode_step_ms": {"tp1": direct["decode_step_ms"],
                                     "tp2": got["decode_step_ms"]},
           "direct_prefill_ms": {"tp1": direct["prefill_ms"],
                                 "tp2": got["prefill_ms"]}}
    del tp2, got
    text = served["prompts"][:4]
    pair = _tp_pair(cfg, params, served["scfg"], text, 16,
                    f"tp families {cfg.name} text-only", serve)
    e1, e2 = pair.pop("engines")
    c1, c2 = pair["counts_tp1"], pair["counts"]
    if any(c2[k] != 2 * c1[k] for k in FAMILY_KERNELS):
        raise AssertionError(f"{cfg.name} text-only tp=2 launches {c2}, "
                             f"expected twice tp=1's {c1}")
    require_launched(c2, FAMILY_KERNELS)
    pair.update(_chunks_in_turns(e1, e2, text))
    del e1, e2
    out.update(pair, max_memory_gib=torch.cuda.max_memory_allocated() / 2**30)
    print(f"  tp families {cfg.name} ({smi}): direct (eager, dense caches) "
          f"prefill {out['direct_prefill_ms']} ms, decode step "
          f"{out['direct_decode_step_ms']} ms; launches tp=2 "
          f"{ {k: out['direct_counts'][k] for k in want} } (twice tp=1's); "
          f"text-only 4 x 16: tok/s tp=1 {pair['tok_s_tp1']:.2f}, tp=2 "
          f"{pair['tok_s']:.2f}, launches tp=2 "
          f"{ {k: c2[k] for k in FAMILY_KERNELS} } (twice tp=1's); host ms "
          f"per captured chunk tp=1 {out['chunk_ms']['tp1']:.3f}, tp=2 "
          f"{out['chunk_ms']['tp2']:.3f}; max memory allocated "
          f"{out['max_memory_gib']:.2f} GiB", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    return out


def check_tp_family_shapes(gen) -> dict:
    """Rows 1 and 3 at the shard shapes the tp families give them first,
    held to their plain versions and timed beside the bound and a library
    call: the nibble kernel at deepseek-v3's MLA ``wkv_b`` at decode (4
    slots x 160 gathered latent rows, 64 heads a shard), ``wq_b`` (64
    heads a shard) and the shared expert's ``gate`` / ``up`` (1024 a
    shard); paged decode at llama4's shard (KVH 4, G 5, d 128)."""
    rng = np.random.default_rng(8)
    return {
        "nibble_matmul": {
            label: _nibble_case(gen, f"tp {label}", *shape)
            for label, shape in (
                ("MLA wkv_b decode shard", (640, 512, 16384)),
                ("MLA wq_b shard", (4, 1536, 12288)),
                ("shared gate/up shard", (4, 7168, 1024)))},
        "paged_decode_attention": {
            "llama4 shard": _paged_case(gen, rng, "tp llama4 shard", 4, 5,
                                        128, 0)}}


# ---------------------------------------------------------------------------
# Families: MLA + MoE (deepseek-v3), MoE over GQA (llama4), gemma3-1b
# ---------------------------------------------------------------------------

def _timed_case(call, plain, lib, n_bytes, ops, peak) -> dict:
    """Loop and graph times of ``call``, the plain version's and the
    library call's (``lib`` None: no library call computes it), and the
    bound of the work."""
    b, by = bound_ms(n_bytes, ops, peak)
    out = {"ms": cuda_ms(call), "graph_ms": graph_ms(call),
           "plain_ms": cuda_ms(plain, iters=5), "bound_ms": b,
           "bound_by": by, "library_ms": None, "library_graph_ms": None}
    if lib is not None:
        out["library_ms"] = cuda_ms(lib)
        out["library_graph_ms"] = graph_ms(lib)
    return out


def _print_case(label, r) -> None:
    print(f"  {label}: max|err| {r['max_abs_err']:.3e}; kernel "
          f"{r['ms']:.4f} ms, graph {r['graph_ms']:.4f} ms, plain "
          f"{r['plain_ms']:.4f} ms, library {r['library_ms']} ms (graph "
          f"{r['library_graph_ms']} ms){r.get('library_note', '')}, bound "
          f"{r['bound_ms']:.5f} ms ({r['bound_by']})", flush=True)


def _nibble_case(gen, label, m, k, n) -> dict:
    """The nibble kernel at (M, K, N), exact and scaled, against its plain
    version (``torch.equal``), timed beside ``_int_mm`` and the bound."""
    x = torch.randint(-128, 128, (m, k), dtype=torch.int8, device=DEV,
                      generator=gen)
    wt = torch.randint(-128, 128, (n, k), dtype=torch.int8, device=DEV,
                       generator=gen)
    xs = torch.tensor(1e-3, device=DEV)
    ws = torch.rand((1, n), device=DEV, generator=gen) * 0.01 + 1e-4
    for args in ((), (xs, ws)):
        got = nm.nibble_matmul_cuda(x, wt.t(), *args)
        want = nm.nibble_matmul_plain(x, wt.t(), *args)
        if not torch.equal(got, want):
            raise AssertionError(f"nibble {label} ({m},{k},{n}) differs "
                                 f"from plain")
    r = _timed_case(
        lambda: nm.nibble_matmul_cuda(x, wt.t(), xs, ws),
        lambda: nm.nibble_matmul_plain(x, wt.t(), xs, ws),
        None, m * k + k * n + 2 * m * n + 4 + 4 * n, 2 * m * n * k,
        INT8_OPS)
    r["library_ms"] = _int_mm_ms(x, wt)
    r["library_graph_ms"] = _int_mm_ms(x, wt, timer=graph_ms)
    r["max_abs_err"] = 0.0
    r["shape"] = (m, k, n)
    _print_case(f"nibble {label} ({m},{k},{n}) torch.equal", r)
    return r


def _flash_case(gen, label, heads, group, s, d, dv=None, *, batch=1
                ) -> dict:
    """The flash forward (causal) over ``batch`` sequences of ``heads``
    query heads (``heads // group`` K/V heads) against its plain version,
    timed beside SDPA's forward (GQA) where a backend takes the shapes."""
    dv = dv or d
    bh = batch * heads
    q = torch.randn((bh, s, d), device=DEV, generator=gen).bfloat16()
    k = torch.randn((bh // group, s, d), device=DEV, generator=gen)\
        .bfloat16()
    v = torch.randn((bh // group, s, dv), device=DEV, generator=gen)\
        .bfloat16()
    kw = dict(scale=d ** -0.5, causal=True, group=group)
    o, lse = fa.flash_attention_fwd_cuda(q, k, v, **kw)
    o_p, lse_p = fa.flash_attention_fwd_plain(q, k, v, **kw)
    err = (o.float() - o_p.float()).abs().max().item()
    err_l = (lse - lse_p).abs().max().item()
    if not (err <= ATTN_ATOL and err_l <= LSE_ATOL):
        raise AssertionError(f"flash forward {label} disagrees with plain: "
                             f"{err}, lse {err_l}")
    q4 = q.reshape(batch, heads, s, d)
    k4, v4 = (t.reshape(batch, heads // group, s, t.shape[-1])
              for t in (k, v))

    def sdpa():
        return _sdpa_gqa(q4, k4, v4, is_causal=True, scale=kw["scale"])

    note = ""
    try:
        sdpa()
    except RuntimeError as exc:          # no SDPA backend takes dv != d
        sdpa, note = None, f" (SDPA n/a: {str(exc)[:120]})"
    pairs = bh * s * (s + 1) // 2
    kvh = bh // group
    r = _timed_case(lambda: fa.flash_attention_fwd_cuda(q, k, v, **kw),
                    lambda: fa.flash_attention_fwd_plain(q, k, v, **kw),
                    sdpa, 2 * (bh * s * (d + dv) + kvh * s * (d + dv))
                    + 4 * bh * s, 2 * pairs * (d + dv), BF16_FLOPS)
    r.update(max_abs_err=err, lse_err=err_l, library_note=note,
             shape=f"BH={bh} group={group} S={s} d={d} dv={dv} causal "
                   f"(instance {fa.bwd_width(d, dv)})")
    _print_case(f"flash {label} ({r['shape']})", r)
    return r


def _paged_case(gen, rng, label, kvh, g, d, window) -> dict:
    """Paged decode at B 4, page 16, 10 pages a slot, against its plain
    version, timed beside SDPA over the gathered pages (its mask holds
    the window too); without a window also in CUDA graphs that find every
    call's K/V cold in L2."""
    ps, per_slot = 16, 10
    n_sets = _sets_for(4 * per_slot + 1, ps, kvh, d)
    q, pools, table, q_pos = _paged_inputs(gen, rng, 4, kvh, g, d, ps,
                                           per_slot, n_sets=n_sets)
    kp, vp = pools[0]
    kw = dict(scale=d ** -0.5, window=window)
    o = fa.paged_decode_attention_cuda(q, kp, vp, table, q_pos, **kw)
    o_p = fa.paged_decode_attention_plain(q, kp, vp, table, q_pos, **kw)
    err = (o.float() - o_p.float()).abs().max().item()
    if not err <= ATTN_ATOL:
        raise AssertionError(f"paged decode {label} disagrees with plain")
    n_bytes, live = _paged_bytes(q, table, q_pos, ps, d)
    r = _timed_case(
        lambda: fa.paged_decode_attention_cuda(q, kp, vp, table, q_pos,
                                               **kw),
        lambda: fa.paged_decode_attention_plain(q, kp, vp, table, q_pos,
                                                **kw),
        _paged_sdpa(q, kp, vp, table, q_pos, kw["scale"], window),
        n_bytes, 4 * live * kvh * g * d, BF16_FLOPS)
    if not window:
        # device time with every call cold in L2, as a layer's is
        r["graph_ms"], r["library_graph_ms"] = _paged_graph(
            q, pools, table, q_pos, kw["scale"])
    r.update(max_abs_err=err, live_rows=live,
             shape=f"B=4 KVH={kvh} G={g} d={d} page {ps} window {window}")
    _print_case(f"paged {label} ({r['shape']}, {live} live rows)", r)
    return r


def check_family_shapes(gen) -> dict:
    """Rows 1-3 at the shapes the families phase gives them, held to their
    plain versions and timed beside the bound and a library call: the
    nibble kernel at MLA's ``wkv_b`` over 4 slots x 160 gathered latent
    rows and at ``wq_b`` (decode, M 4), ``torch.equal``; the flash forward
    at deepseek-v3's prefill (128 heads, S 128, q/k 192, v 128, run in the
    256-wide instance); paged decode at llama4's group 5 and at
    gemma3-1b's head_dim 256, group 4, window 512 (the yardstick's mask
    holds the window)."""
    rng = np.random.default_rng(5)
    return {
        "nibble_matmul": {
            name: _nibble_case(gen, name, *shape) for name, shape in (
                ("wkv_b decode", (640, 512, 32768)),
                ("wq_b decode", (4, 1536, 24576)))},
        "flash_attention_fwd": {
            "mla prefill": _flash_case(gen, "MLA prefill", 128, 1, 128, 192,
                                       128)},
        "paged_decode_attention": {
            name: _paged_case(gen, rng, name, *shape) for name, shape in (
                ("llama4 G=5", (8, 5, 128, 0)),
                ("gemma3 d=256 G=4 window 512", (1, 4, 256, 512)))}}


def check_ssm_shapes(gen) -> dict:
    """Rows 1-3 at the ssm phase's shapes: the nibble kernel at
    mamba2-780m's ``in_proj`` (N 6448) and ``out_proj`` at decode (M 4)
    and ``in_proj`` at the 512-token prefill, and at jamba's ``in_proj``
    (N 16544) at decode, ``torch.equal`` (neither N is a multiple of 64:
    the edge tiles run); the flash forward at jamba's prefill (32/8
    heads, d 128) at S 128 and at an uneven S 114, the length of the
    phase's first jamba prompt (the engine prefills a model with mamba
    mixers at the exact prompt length, so the tile tail runs); paged
    decode at jamba's group 4; and each at the shapes a tp=2 shard gives
    it (mamba2's ``in_proj`` shard N 3352 and ``out_proj`` shard K 1536,
    jamba's ``in_proj`` shard N 8288; 16/4 heads; KVH 4)."""
    rng = np.random.default_rng(6)
    return {
        "nibble_matmul": {
            name: _nibble_case(gen, name, *shape) for name, shape in (
                ("mamba2 in_proj decode", (4, 1536, 6448)),
                ("mamba2 out_proj decode", (4, 3072, 1536)),
                ("mamba2 in_proj prefill 512", (512, 1536, 6448)),
                ("jamba in_proj decode", (4, 4096, 16544)),
                ("mamba2 in_proj decode tp=2 shard", (4, 1536, 3352)),
                ("mamba2 out_proj decode tp=2 shard", (4, 1536, 1536)),
                ("jamba in_proj decode tp=2 shard", (4, 4096, 8288)))},
        "flash_attention_fwd": {
            f"jamba prefill S={n}": _flash_case(gen, f"jamba prefill S={n}",
                                                32, 4, n, 128)
            for n in (128, 114)} | {
            "jamba prefill S=114 tp=2 shard": _flash_case(
                gen, "jamba prefill S=114 tp=2 shard", 16, 4, 114, 128)},
        "paged_decode_attention": {
            "jamba G=4": _paged_case(gen, rng, "jamba G=4", 8, 4, 128, 0),
            "jamba G=4 tp=2 shard": _paged_case(
                gen, rng, "jamba G=4 tp=2 shard", 4, 4, 128, 0)}}


def _chunk_ms(engine, prompts, reps=3) -> float:
    """Host milliseconds per decode chunk of a warm captured engine with
    every slot active: one chunk after admission, then ``reps`` timed,
    each ending in its host read; the median."""
    engine.reset()
    n_new = engine.scfg.decode_chunk * (reps + 2)
    for p in prompts[:engine.scfg.batch]:
        engine.submit(p[:engine.scfg.max_len - n_new], n_new)
    engine.start()
    engine._admit(0.0)
    engine._run_chunk(0.0)
    runs = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        engine._run_chunk(0.0)
        runs.append((time.perf_counter() - t) * 1e3)
    if not engine._active.all():
        raise AssertionError("a slot finished inside the timed chunks")
    return statistics.median(runs)


def _route_recorder(rec: list):
    """A stand-in for ``moe._route`` that appends each call's result and
    router logits (the reference's bf16 product, f32 accumulation)."""
    route = tmoe._route

    def recording(p, cfg, xt):
        out = route(p, cfg, xt)
        rec.append((out, xt.float() @ p["router"].to(xt.dtype).float()))
        return out
    return recording


def _route_flips(kernel_routes, plain_routes, n_real) -> dict:
    """MoE choices of the real tokens that the two paths' roundings
    flipped, and the two paths' router logits (the MoE input, after
    every kernel before it) compared: the largest difference and the
    relative norm.  Reported, not held: the held logits below take one
    routing on both paths."""
    flips, worst, rel = 0, 0.0, 0.0
    for (k_out, lg_k), (p_out, lg_p) in zip(kernel_routes, plain_routes):
        lg_k, lg_p = lg_k[:n_real], lg_p[:n_real]
        worst = max(worst, (lg_k - lg_p).abs().max().item())
        rel = max(rel, ((lg_k - lg_p).norm() / lg_p.norm()).item())
        e_k = k_out[1][:n_real].sort(-1).values
        e_p = p_out[1][:n_real].sort(-1).values
        flips += int((e_k != e_p).any(-1).sum())
    return {"flipped_tokens": flips, "router_logit_max_diff": worst,
            "router_logit_rel_diff": rel}


def compare_plain_prefill(params, cfg, prompt, prefill_len, extra=None
                          ) -> dict:
    """One prompt's prefill logits through the kernel path and through the
    plain path (``quant_backend="torch"``, ``attn_impl="chunked"``): the
    largest difference, and LOGIT_RTOL of the largest plain logit as the
    tolerance.  ``extra`` holds a VLM's ``extra_embeds`` (prepended: the
    logits index moves past them) or an encoder-decoder's ``frames``, the
    same tensors on both paths.  In an MoE model the compared plain run
    takes the kernel run's routing (each MoE layer's top-k choices and
    weights), so the difference measures the kernels, not an expert
    choice that the paths' roundings flipped (a flip also moves which
    later tokens overflow an expert); a free plain run counts the flips
    (``_route_flips``)."""
    extra = extra or {}
    padded = torch.zeros((1, prefill_len), dtype=torch.int64, device=DEV)
    padded[0, :prompt.size] = torch.as_tensor(prompt, device=DEV)
    plain_cfg = cfg.replace(quant_backend="torch", attn_impl="chunked")
    n_pre = extra["extra_embeds"].shape[1] if "extra_embeds" in extra else 0
    idx = n_pre + prompt.size - 1
    rec, route = [], tmoe._route
    tmoe._route = _route_recorder(rec)
    try:
        got, _, _ = prefill(params, cfg, padded, logits_index=idx, **extra)
        kernel_routes = rec[:]
        del rec[:]
        ref, _, _ = prefill(params, plain_cfg, padded, logits_index=idx,
                            **extra)
        out = {}
        if kernel_routes:
            out = _route_flips(kernel_routes, rec, prompt.size)
            replay = iter(kernel_routes)
            tmoe._route = lambda p, c, xt: next(replay)[0]
            ref, _, _ = prefill(params, plain_cfg, padded,
                                logits_index=idx, **extra)
    finally:
        tmoe._route = route
    torch.cuda.synchronize()
    if not (torch.isfinite(ref).all() and torch.isfinite(got).all()):
        raise AssertionError("non-finite prefill logits")
    return {"logit_diff": (got - ref).abs().max().item(),
            "logit_tol": LOGIT_RTOL * ref.abs().max().item(),
            "argmax": (int(got.argmax()), int(ref.argmax())), **out}


def hold_plain_prefill(params, cfg, prompt, prefill_len, extra=None
                       ) -> dict:
    """``compare_plain_prefill``, failing when the difference exceeds the
    tolerance."""
    r = compare_plain_prefill(params, cfg, prompt, prefill_len, extra)
    if not r["logit_diff"] <= r["logit_tol"]:
        raise AssertionError(f"{cfg.name}: kernel-path prefill logits "
                             f"disagree with the plain path: {r}")
    return r


def hold_family_prefill(params, cfg, prompt, prefill_len, extra=None
                        ) -> dict:
    """The kernel path against the plain path, held kernel by kernel:
    (1) with attention through ``attention_core`` on both sides, every
    projection through the nibble kernel gives the plain path's logits
    bit for bit; (2) in ``quant_mode="dense"`` the flash-forward path
    holds the chunked one within LOGIT_RTOL; (3) the end-to-end w8a8
    difference is measured beside them.  (3) is (2)'s attention
    difference amplified by the per-tensor activation scales: on
    deepseek-v3 it exceeds LOGIT_RTOL with the plain nibble path on both
    sides as well (``PERF.md`` §6).  ``extra``: as in
    ``compare_plain_prefill``."""
    exact = compare_plain_prefill(params, cfg.replace(attn_impl="chunked"),
                                  prompt, prefill_len, extra)
    if exact["logit_diff"] != 0.0:
        raise AssertionError(f"{cfg.name}: nibble-kernel prefill logits "
                             f"differ from the plain path's: {exact}")
    return {"nibble_exact": exact,
            "flash_dense": hold_plain_prefill(
                params, cfg.replace(quant_mode="dense"), prompt, prefill_len,
                extra),
            "end_to_end": compare_plain_prefill(params, cfg, prompt,
                                                prefill_len, extra)}


def _has_mamba(cfg) -> bool:
    return any(spec.mixer == "mamba" for spec in cfg.layer_specs)


def hold_family_served(params, cfg, prompts, prefill_len) -> dict:
    """``hold_family_prefill`` on the first served prompt at the length the
    engine prefills it: ``prefill_len``, or the prompt's own length on a
    model with mamba mixers (the engine prefills those unpadded)."""
    p = prompts[0]
    n = p.size if _has_mamba(cfg) else prefill_len
    held = hold_family_prefill(params, cfg, p, n)
    print(f"  {cfg.name} prefill logits ({p.size} tokens at length {n}) "
          f"kernel vs plain path: nibble path (chunked attention on both "
          f"sides) bit for bit; flash path in dense {held['flash_dense']}; "
          f"end to end in w8a8, measured {held['end_to_end']}", flush=True)
    return {**held, "logit_diff": held["flash_dense"]["logit_diff"],
            "logit_tol": held["flash_dense"]["logit_tol"]}


def hold_exact_served(params, cfg, prompts, prefill_len) -> dict:
    """For a model with neither attention nor MoE (the nibble kernel is its
    only kernel): the first and the longest served prompt's prefill logits
    through the kernels equal the plain path's bit for bit, each at its
    exact length, as the engine prefills it."""
    del prefill_len
    runs = []
    for p in (prompts[0], max(prompts, key=len)):
        r = compare_plain_prefill(params, cfg, p, p.size)
        print(f"  {cfg.name} prefill logits ({p.size} tokens) kernel vs "
              f"plain path: {r}", flush=True)
        if r["logit_diff"] != 0.0:
            raise AssertionError(f"{cfg.name}: nibble-kernel prefill logits "
                                 f"differ from the plain path's: {r}")
        runs.append(r)
    return {"exact": runs, "logit_diff": 0.0, "logit_tol": 0.0}


def _serve_family(cfg, smi, n_req, n_new, *, expect, prefill_len=128,
                  long_lens=(), hold=hold_family_served, params=None
                  ) -> tuple:
    """Random weights (seed 0) for ``cfg`` unless ``params`` are given,
    then ``n_req`` requests of
    32-``prefill_len`` prompt tokens, and one more of each length in
    ``long_lens``, x ``n_new`` through a captured engine (4 slots, paged
    incremental, decode chunk 8), launch counters zeroed just before and
    read just after; ``expect`` maps each kernel to whether it must launch
    (True) or must not (False).  Then host ms per captured chunk (its
    launches kept) and ``hold``, which holds the prefill's kernels to the
    plain path.  Returns the record and the run: params, prompts, streams
    and the serve settings."""
    t = time.perf_counter()
    if params is None:
        params = model_init(cfg, seed=0, device=DEV)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    mem = torch.cuda.memory_allocated() / 2**30
    params_line = param_line(cfg, params)
    rng = np.random.default_rng(0)
    lens = rng.integers(32, prefill_len + 1, n_req).tolist() + list(long_lens)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in lens]
    scfg = ServeConfig(
        batch=4, max_len=max(lens + [prefill_len]) + n_new
        + (-n_new) % cfg.page_size, prefill_len=prefill_len, decode_chunk=8,
        alloc_mode="incremental")
    engine = Engine(cfg, params, scfg, device=DEV)
    streams, wall, counts = _serve_timed(engine, prompts, n_new)
    n_tok = sum(map(len, streams))
    require_captured(engine, cfg.name)
    require_no_f32(counts)
    require_launched(counts, [n for n, on in expect.items() if on])
    off = {n: counts[n] for n, on in expect.items() if not on and counts[n]}
    if off:
        raise AssertionError(f"{cfg.name}: kernels launched off their path: "
                             f"{off}")
    reset_counts()
    chunk = _chunk_ms(engine, prompts)
    out = {"tok_s": n_tok / wall, "wall_s": wall, "init_s": init_s,
           "gib_allocated": mem, "chunk_ms": chunk, "counts": counts,
           "chunk_counts": read_counts(),
           "decode_chunks": engine.decode_chunks,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "param_count": params_line}
    print(f"  {cfg.name}: weights {init_s:.1f} s, {mem:.2f} GiB allocated; "
          f"{len(lens)} requests (prompts {lens}) x {n_new}: {n_tok} "
          f"tokens in {wall:.3f} s, {n_tok / wall:.2f} tok/s; host ms per "
          f"decode chunk (captured, 4 slots) {chunk:.3f}; launches "
          f"{ {n: counts[n] for n in expect} }; first tokens "
          f"{streams[0][:8]} ({smi})", flush=True)
    del engine
    held = hold(params, cfg, prompts, prefill_len)
    out.update(held=held, logit_diff=held["logit_diff"],
               logit_tol=held["logit_tol"])
    return out, {"params": params, "prompts": prompts, "streams": streams,
                 "scfg": scfg}


FAMILY_KERNELS = ("nibble_matmul", "flash_attention_fwd",
                  "paged_decode_attention")


def phase_families(smi: str, serve: dict) -> dict:
    """deepseek-v3 (full width, 4 layers: 3 dense MLA + 1 MoE) served, its
    dense prefix + swap check and its tp=2 pair, llama4 (full width, 2
    layers: dense + MoE) served and its tp=2 pair, gemma3-1b (full width
    and depth) served; each model's weights freed before the next."""
    t_phase = time.perf_counter()
    print(f"families: {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
          f"allocated before the first model", flush=True)
    paged = dict(quant_mode="w8a8_nibble", quant_backend="cuda",
                 attn_impl="flash", cache_mode="paged", page_size=16)
    out = {}

    cfg = get_config("deepseek-v3-671b").replace(n_layers=4, **paged)
    print(f"  {cfg.name}: full width cut to {cfg.n_layers} layers (3 dense "
          f"MLA, d_ff {cfg.d_ff}; 1 MoE, {cfg.n_experts} experts top-"
          f"{cfg.top_k} + {cfg.n_shared_experts} shared, d_ff_expert "
          f"{cfg.d_ff_expert}); {cfg.n_heads} heads, q_lora "
          f"{cfg.q_lora_rank}, kv_lora {cfg.kv_lora_rank}, rope "
          f"{cfg.qk_rope_dim}, nope {cfg.qk_nope_dim}, v {cfg.v_head_dim}, "
          f"vocab {cfg.vocab_size}", flush=True)
    r, run = _serve_family(cfg, smi, 8, 32, expect={
        "nibble_matmul": True, "flash_attention_fwd": True,
        "paged_decode_attention": False})
    r["dense_check"] = _dense_overcommit(run["params"], cfg, r, "deepseek",
                                         prefix_cache=True,
                                         swap_mode="host")
    r["tp"] = tp_family_moe(cfg, run, serve, smi)
    out[cfg.name] = r
    del run
    gc.collect()
    torch.cuda.empty_cache()

    cfg = get_config("llama4-maverick-400b-a17b").replace(n_layers=2,
                                                          **paged)
    print(f"  {cfg.name}: full width cut to {cfg.n_layers} layers (dense "
          f"d_ff {cfg.d_ff}, then MoE: {cfg.n_experts} experts top-"
          f"{cfg.top_k} + {cfg.n_shared_experts} shared, d_ff_expert "
          f"{cfg.d_ff_expert}); {cfg.n_heads}/{cfg.n_kv_heads} heads (group "
          f"{cfg.n_heads // cfg.n_kv_heads})", flush=True)
    out[cfg.name], run = _serve_family(
        cfg, smi, 4, 16, expect=dict.fromkeys(FAMILY_KERNELS, True))
    out[cfg.name]["tp"] = tp_family_moe(cfg, run, serve, smi)
    # eager: a captured chunk's pool would keep the 32 GB of gathered
    # expert stacks beside an eager prefill's gather
    out[cfg.name]["dp"] = dp_family(cfg, run, smi, capture=False)
    del run
    gc.collect()
    torch.cuda.empty_cache()

    cfg = get_config("gemma3-1b").replace(**paged)
    print(f"  {cfg.name}: full width and depth ({cfg.n_layers} layers, 5 "
          f"local (window {cfg.sliding_window}) : 1 global, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads, head_dim {cfg.head_dim})",
          flush=True)
    out[cfg.name], _ = _serve_family(
        cfg, smi, 8, 32, expect=dict.fromkeys(FAMILY_KERNELS, True))
    gc.collect()
    torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"  families phase {out['wall_s']:.1f} s", flush=True)
    return out


def _dense_overcommit(params, cfg, served, label, **mech) -> dict:
    """``cfg`` in ``dense`` at the same width and depth: the uniform
    workload (8 requests x 64) through an overcommitted incremental pool
    (1.5 worst cases) with the mechanisms ``mech`` against a reserve pool;
    preemptions required (and swap-ins with the host swap); zero device
    and host leaks.  Streams must be equal, or, where ``mech`` routes a
    prefill differently, each divergence a near-tie (phase 6's rule, with
    this model's kernel-vs-plain tolerance).  Both engines attend in
    ``attention_core`` (``attn_impl="chunked"``): a context prefill does
    anyway, and a flash prefill's roundings would flip MoE choices, which
    are not what this check holds."""
    dcfg = cfg.replace(quant_mode="dense", attn_impl="chunked")
    prefill_len, n_new = 128, 64
    worst = pages_needed(prefill_len + n_new - 1, cfg.page_size)
    num_pages = 1 + worst * 3 // 2
    traffic = dict(requests=8, prompt_budget=prefill_len, new_tokens=n_new,
                   seed=1)

    def serve(**kw):
        eng = Engine(dcfg, params, ServeConfig(
            batch=4, max_len=prefill_len + n_new, prefill_len=prefill_len,
            decode_chunk=8, **kw), device=DEV)
        res = run_timed_workload(eng, cfg.vocab_size, collect_streams=True,
                                 **traffic)
        torch.cuda.synchronize()
        _check_streams(res["streams"], n_new, cfg.vocab_size)
        eng.release_prefix_cache()
        if eng.leaked_pages():
            raise AssertionError(f"{eng.leaked_pages()} pages leaked")
        if eng.host_pool is not None and eng.host_pool.in_use:
            raise AssertionError(f"{eng.host_pool.in_use} host pages leaked")
        require_captured(eng, f"{label} dense check")
        return res

    got = serve(alloc_mode="incremental", num_pages=num_pages, **mech)
    want = serve(alloc_mode="reserve")
    swap = mech.get("swap_mode") == "host"
    if got["preemptions"] < 1 or (swap and got["swap_in"] < 1):
        raise AssertionError(f"the dense check preempted {got['preemptions']}"
                             f" and swapped in {got['swap_in']}")
    what = (f"{cfg.name} dense, {num_pages}-page incremental pool"
            f"{' ' + str(mech) if mech else ''} ({got['preemptions']} "
            f"preemptions, {got['swap_in']} swap-ins) against a reserve pool")
    n = traffic["requests"]
    out = {"preemptions": got["preemptions"], "swap_in": got["swap_in"],
           "tok_s": got["tok_per_s"], "num_pages": num_pages}
    if not mech:
        equal = sum(got["streams"][i] == want["streams"][i]
                    for i in range(n))
        print(f"  {what}: {equal}/{n} streams equal", flush=True)
        if equal != n:
            raise AssertionError(f"{what}: replayed streams differ")
        return {**out, "equal": equal}
    prompts = draw_workload(cfg.vocab_size, **traffic).prompts
    margins = divergence_margins(
        params, dcfg, prompts, [want["streams"][i] for i in range(n)],
        [got["streams"][i] for i in range(n)])
    return {**out, **hold_margins(what, margins, n, served)}


def _mamba2_extra(cfg, r, run) -> None:
    """mamba2-780m's checks beyond ``_serve_family``'s: the nibble kernel
    launched 2 x 48 times a decode step and a prefill over the timed
    chunks; the served requests through a ``capture=False`` engine and
    through the plain path (``quant_backend="torch"``), both equal to the
    kernel engine's streams token for token; the dense overcommit check
    (replay against a reserve pool, equal streams)."""
    per = 2 * cfg.n_layers
    n_chunk = r["chunk_counts"]["nibble_matmul"]
    steps = r["decode_chunks"] * run["scfg"].decode_chunk
    batch = run["scfg"].batch
    print(f"  {cfg.name}: {per} nibble launches a decode step and a "
          f"prefill: {n_chunk} over {steps} steps and {batch} prefills",
          flush=True)
    if n_chunk != per * (steps + batch):
        raise AssertionError(f"{cfg.name}: {n_chunk} nibble launches over "
                             f"{steps} decode steps and {batch} prefills, "
                             f"expected {per} each")
    r["nibble_per_step"] = per
    streams, n = run["streams"], len(run["prompts"])
    for label, c, kw in (("capture=False", cfg, {"capture": False}),
                         ("plain path", cfg.replace(quant_backend="torch"),
                          {})):
        eng = Engine(c, run["params"], run["scfg"], device=DEV, **kw)
        got, wall, _ = _serve_timed(eng, run["prompts"], len(streams[0]))
        equal = sum(a == b for a, b in zip(got, streams))
        print(f"  {cfg.name} {label}: {equal}/{n} streams equal the kernel "
              f"engine's ({n * len(streams[0]) / wall:.2f} tok/s)",
              flush=True)
        if equal != n:
            raise AssertionError(f"{cfg.name}: {label} streams differ")
        r[f"{label} tok_s"] = n * len(streams[0]) / wall
        del eng
    r["dense_check"] = _dense_overcommit(run["params"], cfg, r, cfg.name)


# launches of one decode step and one prefill of the ssm models at tp=1
# and tp=2, counted from the code: mamba2-780m runs in_proj and out_proj a
# layer (2 x 48); jamba (one block of 8) in_proj / out_proj on its seven
# mamba layers, wq / wk / wv / wo on its attention layer and gate / up /
# down on its four dense MLPs (its MoE experts run no kernel), one paged
# decode a step and one flash forward a prefill; at tp=2 every one of
# them on both shards
TP_SSM_LAUNCHES = {
    "mamba2-780m": ({"nibble_matmul": 96, "flash_attention_fwd": 0,
                     "paged_decode_attention": 0},
                    {"nibble_matmul": 192, "flash_attention_fwd": 0,
                     "paged_decode_attention": 0}),
    "jamba-v0.1-52b": ({"nibble_matmul": 30, "flash_attention_fwd": 1,
                        "paged_decode_attention": 1},
                       {"nibble_matmul": 60, "flash_attention_fwd": 2,
                        "paged_decode_attention": 2})}


def tp_family_ssm(cfg, run: dict, serve: dict, smi: str) -> dict:
    """A model of the ssm phase at tp=2 on ``TP_DEVICES``, on its served
    weights: its requests (mamba2: the 8 x 32 and the 512-token prompt)
    through a tp=1 and a tp=2 engine, every stream equal (no margin rule:
    each SSD head's state, each attention row and every integer
    projection is tp=1's bit for bit) and equal to the ssm cell's; the
    prefill's and one decode step's logits equal (max |dlogit| 0) on the
    first and the longest prompt; launches a step and a prefill held to
    ``TP_SSM_LAUNCHES``; the captured tp=2 engine against a
    ``capture=False`` one on the first 4 prompts; host ms per captured
    chunk in turns, tok/s, peak memory."""
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params, prompts, scfg = run["params"], run["prompts"], run["scfg"]
    n_new = len(run["streams"][0])
    e1 = Engine(cfg, params, scfg, device=DEV)
    s1, w1, c1 = _serve_timed(e1, prompts, n_new)
    e2 = Engine(cfg, params, dataclasses.replace(scfg, tp=2),
                devices=TP_DEVICES)
    s2, w2, c2 = _serve_timed(e2, prompts, n_new)
    label = f"tp ssm {cfg.name}"
    if e2.mesh_shape != (1, 2) or e2.device_count != 2 \
            or not e2.tp_layout.ssm_heads:
        raise AssertionError(f"{label}: mesh {e2.mesh_shape}, "
                             f"{e2.device_count} devices, layout "
                             f"{e2.tp_layout}")
    require_captured(e2, f"{label} tp=2")
    require_no_f32(c2)
    equal = [a == b for a, b in zip(s1, s2)]
    served = [a == b for a, b in zip(s1, run["streams"])]
    print(f"  {label}: tp=2 streams equal tp=1's {sum(equal)}/{len(equal)}"
          f" (prompt lengths {[len(p) for p in prompts]}); tp=1 equal to "
          f"the ssm cell's {sum(served)}/{len(served)}", flush=True)
    if not all(equal) or not all(served):
        raise AssertionError(f"{label}: streams differ: tp=2 {equal}, "
                             f"the cell's {served}")
    per1, per2 = TP_SSM_LAUNCHES[cfg.name]
    n = len(prompts)
    steps = _hold_per_step(f"{cfg.name} tp=1", c1, per1, n)
    if _hold_per_step(f"{cfg.name} tp=2", c2, per2, n) != steps:
        raise AssertionError(f"{cfg.name}: tp=2 ran another schedule")
    require_launched(c2, [k for k, v in per2.items() if v])
    diffs = {}
    for name, p in (("first", prompts[0]),
                    ("longest", max(prompts, key=len))):
        d = _tp_step_diff(params, e2.params, cfg, p)
        diffs[f"{name} ({len(p)} tokens)"] = d
        print(f"  {label}, {name} prompt ({len(p)} tokens): tp=2 against "
              f"tp=1 max|dlogit| prefill {d['prefill_max_abs_diff']}, one "
              f"decode step {d['decode_max_abs_diff']}", flush=True)
        if d["prefill_max_abs_diff"] or d["decode_max_abs_diff"]:
            raise AssertionError(f"{label}: tp=2 logits differ from tp=1's:"
                                 f" {d}")
    few = prompts[:4]
    eager = Engine(cfg, params, dataclasses.replace(scfg, tp=2),
                   devices=TP_DEVICES, capture=False)
    se, _, _ = _serve_timed(eager, few, n_new)
    sc, _, _ = _serve_timed(e2, few, n_new)
    if any(eager.capture_counts.values()) or se != sc:
        raise AssertionError(f"{label}: capture=False streams differ from "
                             f"the captured tp=2 engine's (graphs "
                             f"{eager.capture_counts})")
    del eager
    n_tok = sum(map(len, s2))
    out = {"counts_tp1": c1, "counts": c2, "steps": steps, "prefills": n,
           "per_step": {"tp1": per1, "tp2": per2}, "streams_equal":
           sum(equal), "step_diff": diffs, "tok_s_tp1": n_tok / w1,
           "tok_s": n_tok / w2, "layout": dataclasses.asdict(e2.tp_layout),
           "captures": e2.capture_counts, "eager_equal": len(few)}
    out.update(_chunks_in_turns(e1, e2, prompts))
    out["max_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
    print(f"  {label} ({smi}): {n} x {n_new}, {steps} decode steps, {n} "
          f"prefills; launches a step and a prefill {per1} at tp=1, {per2} "
          f"at tp=2 (held); capture=False at tp=2 equal on {len(few)} "
          f"prompts; tok/s tp=1 {out['tok_s_tp1']:.2f}, tp=2 "
          f"{out['tok_s']:.2f}; host ms per captured decode chunk tp=1 "
          f"{out['chunk_ms']['tp1']:.3f}, tp=2 {out['chunk_ms']['tp2']:.3f}"
          f" (runs {out['chunk_runs']}); max memory allocated "
          f"{out['max_memory_gib']:.2f} GiB; layout {out['layout']}",
          flush=True)
    del e1, e2
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_ssm(smi: str, serve: dict) -> dict:
    """mamba2-780m at full width and depth, 8 requests of 32-128 prompt
    tokens and one of 512 (two SSD chunks of 256, the inter-chunk loop),
    the nibble kernel launched and the attention kernels never, its
    prefill bit for bit the plain path's (``hold_exact_served``), then
    ``_mamba2_extra`` and its tp=2 pair (``tp_family_ssm``); then
    jamba-v0.1-52b at full width cut to one block of 8 layers, rows 1-3
    launched, its prefill held kernel by kernel at the exact length the
    engine runs, and its tp=2 pair; each served as the families are
    (``_serve_family``), each model's weights freed before the next."""
    t_phase = time.perf_counter()
    print(f"ssm: {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated "
          f"before the first model", flush=True)
    paged = dict(quant_mode="w8a8_nibble", quant_backend="cuda",
                 attn_impl="flash", cache_mode="paged", page_size=16)
    out = {}
    cfg = get_config("mamba2-780m").replace(**paged)
    print(f"  {cfg.name}: full width and depth ({cfg.n_layers} SSD mixers, "
          f"no FFN; d_model {cfg.d_model}, d_inner {cfg.d_inner}, "
          f"{cfg.ssm_heads} heads of {cfg.ssm_head_dim}, state "
          f"{cfg.ssm_state}, {cfg.ssm_groups} group, conv {cfg.conv_width}, "
          f"chunk {cfg.ssm_chunk}, vocab {cfg.vocab_size}, tied)",
          flush=True)
    r, run = _serve_family(cfg, smi, 8, 32, long_lens=(512,),
                           hold=hold_exact_served, expect={
                               "nibble_matmul": True,
                               "flash_attention_fwd": False,
                               "paged_decode_attention": False})
    _mamba2_extra(cfg, r, run)
    r["tp"] = tp_family_ssm(cfg, run, serve, smi)
    r["dp"] = dp_family(cfg, run, smi)
    out[cfg.name] = r
    del run
    gc.collect()
    torch.cuda.empty_cache()

    cfg = get_config("jamba-v0.1-52b").replace(n_layers=8, **paged)
    print(f"  {cfg.name}: full width cut to {cfg.n_layers} layers (one "
          f"block of 8: attention at layer 4 ({cfg.n_heads}/"
          f"{cfg.n_kv_heads} heads, head_dim {cfg.head_dim}), mamba (state "
          f"{cfg.ssm_state}, {cfg.ssm_heads} heads of {cfg.ssm_head_dim}) "
          f"elsewhere; MoE ({cfg.n_experts} experts top-{cfg.top_k}, "
          f"d_ff_expert {cfg.d_ff_expert}) on odd layers, dense d_ff "
          f"{cfg.d_ff} on even; vocab {cfg.vocab_size}, untied)",
          flush=True)
    out[cfg.name], run = _serve_family(
        cfg, smi, 8, 32, expect=dict.fromkeys(FAMILY_KERNELS, True))
    out[cfg.name]["tp"] = tp_family_ssm(cfg, run, serve, smi)
    del run
    gc.collect()
    torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"  ssm phase {out['wall_s']:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------------------
# Encoder-decoder (whisper-base) and VLM (phi-3-vision-4.2b)
# ---------------------------------------------------------------------------

def check_encdec_vlm_shapes(gen) -> dict:
    """Rows 1-3 at the enc-dec and VLM phase's shapes, held to their plain
    versions and timed beside the bound and a library call: the nibble
    kernel at whisper's cross K/V projection of a decode step (4 slots x
    1500 frames, 512 -> 512; ``torch.equal``); the flash forward at
    phi-3-vision's head_dim 96 (the 128 instance) over 4 prompts of 576
    patches + 128 tokens and at whisper's decoder prefill (d 64); paged
    decode at phi-3-vision's 32 KV heads of 96 and whisper's 8 of 64."""
    rng = np.random.default_rng(7)
    return {
        "nibble_matmul": {
            "whisper cross K/V decode": _nibble_case(
                gen, "whisper cross K/V decode", 6000, 512, 512)},
        "flash_attention_fwd": {
            "phi3v prefill d=96": _flash_case(
                gen, "phi-3-vision prefill, 576 patches + 128", 32, 1, 704,
                96, batch=4),
            "whisper prefill d=64": _flash_case(
                gen, "whisper decoder prefill", 8, 1, 128, 64)},
        "paged_decode_attention": {
            name: _paged_case(gen, rng, name, *shape) for name, shape in (
                ("phi3v d=96", (32, 1, 96, 0)),
                ("whisper d=64", (8, 1, 64, 0)))}}


def _stub_inputs(cfg, batch: int, seed: int) -> dict:
    """The launcher's stub frontend inputs (N(0, 1) x 0.02 in bf16 from a
    generator seeded with ``seed``) under ``prefill``'s keywords."""
    extra = stub_extras(cfg, batch, DEV)(seed)
    return {"extra_embeds" if k == "patch_embeds" else k: v
            for k, v in extra.items()}


@torch.no_grad()
def _direct_decode(params, cfg, prompts, extra, n_steps=32) -> dict:
    """The requests as one batch, prompts zero-padded to the longest after
    the extras: ``prefill`` (logits at each prompt's last token), then
    ``n_steps`` greedy ``decode_step``s on dense caches at per-slot
    positions, cross-attending ``enc_out`` where the model has one; launch
    counters zeroed just before and read just after."""
    dcfg = cfg.replace(cache_mode="dense")
    n_pre = extra["extra_embeds"].shape[1] if "extra_embeds" in extra else 0
    plen = max(p.size for p in prompts)
    toks = torch.zeros((len(prompts), plen), dtype=torch.int64, device=DEV)
    for i, p in enumerate(prompts):
        toks[i, :p.size] = torch.as_tensor(p, device=DEV)
    lens = torch.as_tensor([p.size for p in prompts], device=DEV)
    torch.cuda.synchronize()
    reset_counts()
    t = time.perf_counter()
    logits, caches, enc = prefill(params, dcfg, toks,
                                  max_len=n_pre + plen + n_steps,
                                  logits_index=n_pre + lens - 1, **extra)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t) * 1e3
    finite = bool(torch.isfinite(logits).all())
    tok = logits[:, -1].argmax(-1, keepdim=True)
    pos, out, first = n_pre + lens, [tok], []
    t = time.perf_counter()
    for _ in range(n_steps):
        lg, caches = decode_step(params, dcfg, tok, caches, pos, enc_out=enc)
        if not first:
            first.append(lg)
        finite &= bool(torch.isfinite(lg).all())
        tok = lg[:, -1].argmax(-1, keepdim=True)
        pos = pos + 1
        out.append(tok)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t) * 1e3 / n_steps
    counts = read_counts()
    streams = torch.cat(out, 1).cpu().tolist()
    if not finite:
        raise AssertionError(f"{cfg.name}: non-finite logits")
    _check_streams(dict(enumerate(streams)), n_steps + 1, cfg.vocab_size)
    return {"prefill_ms": prefill_ms, "decode_step_ms": step_ms,
            "counts": counts, "first_tokens": [s_[:8] for s_ in streams],
            "enc_out": None if enc is None else list(enc.shape),
            "streams": streams, "logits": (logits, first[0])}


def _encdec_vlm_model(cfg, smi, seed, prompt_lens, serve) -> tuple:
    """Weights (seed 0), then the requests with their stub inputs
    through ``_direct_decode`` (rows 1 and 2 launched), the first
    request's prefill held kernel by kernel with its own extras, then the
    model served text-only (``_serve_family``: rows 1-3 launched, 8 x
    32, the prefill held again)."""
    t = time.perf_counter()
    params = model_init(cfg, seed=0, device=DEV)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    mem = torch.cuda.memory_allocated() / 2**30
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in prompt_lens]
    extra = _stub_inputs(cfg, len(prompts), seed)
    direct = _direct_decode(params, cfg, prompts, extra)
    require_launched(direct["counts"], ("nibble_matmul",
                                        "flash_attention_fwd"))
    require_no_f32(direct["counts"])
    key = next(iter(extra))
    one = {key: extra[key][:1]}
    cross = (f", cross K/V over {cfg.enc_seq_len} frames" if cfg.is_encdec
             else "")
    held = hold_family_prefill(params, cfg, prompts[0], int(prompts[0].size),
                               one)
    print(f"  {cfg.name}: weights {init_s:.1f} s, {mem:.2f} GiB allocated; "
          f"{len(prompts)} requests of {key} {list(extra[key].shape)} + "
          f"prompts {list(prompt_lens)}: prefill {direct['prefill_ms']:.1f} "
          f"ms, {direct['decode_step_ms']:.3f} ms a decode step (eager, "
          f"dense caches{cross}); "
          f"launches {direct['counts']}; first tokens "
          f"{direct['first_tokens'][0]} ({smi})", flush=True)
    print(f"  {cfg.name} prefill with its {key} kernel vs plain path: nibble "
          f"path bit for bit; flash path in dense {held['flash_dense']}; end "
          f"to end in w8a8, measured {held['end_to_end']}", flush=True)
    served, run = _serve_family(cfg, smi, 8, 32, params=params,
                                expect=dict.fromkeys(FAMILY_KERNELS, True))
    tp = tp_family_extras(cfg, params, prompts, extra, direct, run, serve,
                          smi)
    del run, params, direct["logits"], direct["streams"]
    gc.collect()
    torch.cuda.empty_cache()
    return {"init_s": init_s, "gib_allocated": mem, "direct": direct,
            "held_with_extras": held, "served": served,
            "counts": served["counts"], "tp": tp}


def phase_encdec_vlm(smi: str, serve: dict) -> dict:
    """phi-3-vision-4.2b at full width and depth: 4 requests of 576 stub
    patch embeddings + 32-128 prompt tokens through ``prefill`` and 32
    greedy decode steps, the prefill held kernel by kernel, then served
    text-only through a captured paged engine; whisper-base at full width
    and depth the same way with 1500 stub frames and 16-token prompts;
    then 4 QAT steps of whisper-base through ``Trainer(extra_batch_fn=)``
    (rows 2 and 4 launched).  Each model's weights freed before the
    next."""
    t_phase = time.perf_counter()
    print(f"enc-dec + vlm: {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
          f"allocated before the first model", flush=True)
    paged = dict(quant_mode="w8a8_nibble", quant_backend="cuda",
                 attn_impl="flash", cache_mode="paged", page_size=16)
    out = {}
    cfg = get_config("phi-3-vision-4.2b").replace(**paged)
    print(f"  {cfg.name}: full width and depth ({cfg.n_layers} layers, "
          f"d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
          f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, untied; "
          f"{cfg.n_patches} stub patch embeddings)", flush=True)
    lens = np.random.default_rng(11).integers(32, 129, 4).tolist()
    out[cfg.name] = _encdec_vlm_model(cfg, smi, 11, lens, serve)
    cfg = get_config("whisper-base").replace(**paged)
    print(f"  {cfg.name}: full width and depth ({cfg.n_enc_layers} encoder "
          f"+ {cfg.n_layers} decoder layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads of {cfg.head_dim}, d_ff {cfg.d_ff}, GELU, "
          f"vocab {cfg.vocab_size}, tied; {cfg.enc_seq_len} stub frames)",
          flush=True)
    out[cfg.name] = _encdec_vlm_model(cfg, smi, 12, [16] * 4, serve)
    out["whisper-base train"] = _train_whisper(smi)
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"  enc-dec + vlm phase {out['wall_s']:.1f} s", flush=True)
    return out


def _train_whisper(smi: str, batch=8, seq=128, steps=4) -> dict:
    cfg = get_config("whisper-base").replace(quant_mode="qat",
                                             attn_impl="flash", remat=True)
    print(f"  {cfg.name} train: QAT, flash attention, remat, batch {batch} "
          f"x seq {seq} + {cfg.enc_seq_len} stub frames, {steps} steps "
          f"through Trainer(extra_batch_fn=)", flush=True)
    trainer = Trainer(cfg, TrainConfig(total_steps=steps,
                                       warmup_steps=max(1, steps // 10)),
                      TrainerConfig(steps=steps, log_every=1),
                      DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                 global_batch=batch),
                      stub_extras(cfg, batch, DEV), device=DEV)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t = time.perf_counter()
    history = trainer.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [h["loss"] for h in history]
    print(f"    losses {[round(x, 4) for x in losses]}, {wall:.2f} s, peak "
          f"{peak:.2f} GiB; launches {counts} ({smi})", flush=True)
    if not all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
               for h in history):
        raise AssertionError("non-finite whisper-base training loss")
    require_launched(counts, ("flash_attention_fwd", "flash_attention_bwd_dq",
                              "flash_attention_bwd_dkv"))
    require_no_f32(counts)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return {"losses": losses, "wall_s": wall, "peak_gib": peak,
            "counts": counts, "history": history}


def phase_train(profile: bool) -> dict:
    """Full-width qwen3-4b, QAT, flash attention, remat: 4 Trainer steps."""
    cfg = get_config("qwen3-4b").replace(quant_mode="qat", attn_impl="flash",
                                         remat=True)
    batch, seq, steps = 8, 256, 4
    print(f"train: {cfg.name} n_layers={cfg.n_layers} d_model={cfg.d_model} "
          f"heads={cfg.n_heads}/{cfg.n_kv_heads} head_dim={cfg.head_dim} "
          f"d_ff={cfg.d_ff} vocab={cfg.vocab_size} tied head (full width, "
          f"all layers), quant_mode=qat attn_impl=flash remat=True, batch "
          f"{batch} x seq {seq}, {steps} steps", flush=True)
    tcfg = TrainConfig(optimizer=AdamWConfig(), total_steps=steps,
                       warmup_steps=max(1, steps // 10))
    rcfg = TrainerConfig(steps=steps, log_every=1)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                      global_batch=batch)
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    trainer = Trainer(cfg, tcfg, rcfg, dcfg, device=DEV)
    torch.cuda.synchronize()
    n_params = sum(t_.numel() for _, t_ in tree_paths(trainer.params))
    params_line = param_line(cfg, trainer.params)
    print(f"  {n_params / 1e9:.3f} B parameters, initialised in "
          f"{time.perf_counter() - t:.1f} s; "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated "
          f"(bf16 params + f32 moments)", flush=True)
    reset_counts()
    t = time.perf_counter()
    history = trainer.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    for h in history:
        print(f"  step {h['step']}: loss {h['loss']:.6f}, grad norm "
              f"{h['grad_norm']:.6f}, lr {h['lr']:.3e}, "
              f"{h['step_time_s']:.3f} s", flush=True)
        if not (math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])):
            raise AssertionError(f"non-finite loss at step {h['step']}")
    steady = [h["step_time_s"] for h in history[1:]]
    tok_s = batch * seq * len(steady) / sum(steady)
    print(f"  {steps} steps in {wall:.2f} s; steady {tok_s:.1f} tokens/s "
          f"(steps 1-{steps - 1}); peak memory allocated "
          f"{peak / 1e9:.2f} GB", flush=True)
    per_step = {k: v / steps for k, v in counts.items() if v}
    print(f"  launches in the train run: {counts}; per step {per_step}",
          flush=True)
    require_launched(counts, ("flash_attention_fwd",
                              "flash_attention_bwd_dq",
                              "flash_attention_bwd_dkv"))
    require_no_f32(counts)
    out = {"counts": counts, "history": history, "wall_s": wall,
           "tok_s": tok_s, "peak_bytes": peak, "n_params": n_params,
           "param_count": params_line}
    if profile:
        out["profile"] = profile_train_step(trainer)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return out


def profile_train_step(trainer) -> dict:
    """One more training step under torch.profiler: device time by
    kernel and the idle share."""
    from torch.profiler import ProfilerActivity, profile
    batch = trainer.data.batch(trainer.rcfg.steps)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        trainer.step_fn(trainer.params, trainer.opt_state, batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    kernels = _device_times(prof)
    busy = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    print(f"profile: one train step, wall {wall_us / 1e3:.1f} ms, device "
          f"busy {busy / 1e3:.1f} ms, idle share {1 - busy / wall_us:.3f}",
          flush=True)
    for name, us in top:
        print(f"  {us / 1e3:9.2f} ms  {name[:90]}")
    # the attention kernels of the step, wherever they rank
    attn = {n: us / 1e3 for n, us in kernels.items()
            if "flash_" in n or "bwd_dq_kernel" in n or "bwd_dkv_kernel" in n}
    for name, t_ms in sorted(attn.items(), key=lambda kv: -kv[1]):
        print(f"  attention {t_ms:9.2f} ms ({t_ms / (busy / 1e3):.2%} of "
              f"device time)  {name[:70]}")
    fwd = sum(t_ms for n, t_ms in attn.items() if "flash_fwd" in n)
    print(f"  flash forward: {fwd:.2f} ms of {busy / 1e3:.1f} ms device "
          f"time ({fwd / (busy / 1e3):.2%})", flush=True)
    return {"wall_ms": wall_us / 1e3, "busy_ms": busy / 1e3,
            "top": [(n, us / 1e3) for n, us in top], "attention": attn,
            "flash_fwd_ms": fwd}


# (config, cut, batch, seq, TrainConfig fields) of the gradient checks
GRAD_CASES = (
    ("qwen3-4b", lambda c: c.replace(n_layers=2), 8, 256, {}),
    ("deepseek-v3-671b", lambda c: c.replace(
        n_layers=2, prefix_pattern=c.prefix_pattern[:2]), 8, 256,
     {"mtp_weight": 0.3}),
    ("gemma3-1b", lambda c: c.replace(n_layers=6, suffix_pattern=()), 4,
     1024, {}))


def check_train_grads() -> dict:
    """One step's gradients at full width, kernel path (flash) vs plain
    path (chunked), leaf by leaf, in ``qat`` and ``dense``: qwen3-4b cut
    to 2 layers, deepseek-v3-671b cut to its first 2 (MLA at q/k 192, v
    128 through the 256 instance) and gemma3-1b cut to its first 6 (one
    5:1 block: head_dim 256, window 512 at seq 1024)."""
    out = {}
    for arch, cut, batch_n, seq, tover in GRAD_CASES:
        for mode in ("qat", "dense"):
            full = get_config(arch)
            cfg = cut(full).replace(quant_mode=mode, remat=True)
            print(f"train grads: {cfg.name} full width cut to n_layers="
                  f"{cfg.n_layers} (of {full.n_layers}), quant_mode={mode}, "
                  f"batch {batch_n} x seq {seq}{', ' if tover else ''}"
                  f"{', '.join(f'{k}={v}' for k, v in tover.items())}: "
                  f"flash kernels vs plain chunked attention", flush=True)
            params = model_init(cfg, seed=1, device=DEV)
            batch = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                           seq_len=seq, global_batch=batch_n),
                                device=DEV).batch(0)
            res = {}
            for impl in ("flash", "chunked"):
                c = cfg.replace(attn_impl=impl)
                reset_counts()
                loss, _, g = accumulate_grads(
                    make_loss_fn(c, TrainConfig(**tover)), params, batch, 1)
                res[impl] = (float(loss), dict(tree_paths(g)), read_counts())
            require_launched(res["flash"][2], (
                "flash_attention_fwd", "flash_attention_bwd_dq",
                "flash_attention_bwd_dkv"))
            require_no_f32(res["flash"][2])
            errs = {p: _rel(a, res["chunked"][1][p])
                    for p, a in res["flash"][1].items()}
            worst = sorted(errs.items(), key=lambda kv: -kv[1])
            print(f"  loss flash {res['flash'][0]:.6f} vs chunked "
                  f"{res['chunked'][0]:.6f}; worst rel-norm errors: "
                  + ", ".join(f"{p} {e:.3e}" for p, e in worst[:4])
                  + f" (bound {MODEL_GRAD_RTOL[mode]})", flush=True)
            if not worst[0][1] <= MODEL_GRAD_RTOL[mode]:
                raise AssertionError(f"{arch} {mode}: kernel-path gradients "
                                     f"disagree with the plain path")
            out[f"{arch} {mode}"] = {
                "loss": {k: v[0] for k, v in res.items()},
                "worst": worst[:4]}
            del params, res, batch
            gc.collect()
            torch.cuda.empty_cache()
    return out


def _window_pairs(s: int, window: int) -> int:
    """(query, key) pairs a causal row set of length ``s`` attends, each
    row at most ``window`` keys back (0: no window)."""
    if not window or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def _train_shape(gen, label, bh, group, s, d, dv, window, heads) -> dict:
    """Rows 2 and 4 at one training shape: each held to its plain version
    (the forward within ATTN_ATOL / LSE_ATOL, the backward within
    BWD_RTOL), then timed in a loop and in a CUDA graph beside the plain
    version and SDPA (its forward, and its forward + backward minus its
    forward, with the KV heads expanded and, under a window, a boolean
    mask), and their bounds from the pairs this mask keeps."""
    bkv = bh // group
    q, do = (torch.randn((bh, s, n), device=DEV, generator=gen).bfloat16()
             for n in (d, dv))
    k = torch.randn((bkv, s, d), device=DEV, generator=gen).bfloat16()
    v = torch.randn((bkv, s, dv), device=DEV, generator=gen).bfloat16()
    kw = dict(scale=d ** -0.5, causal=True, group=group, window=window,
              softcap=0.0)
    o, lse = fa.flash_attention_fwd_cuda(q, k, v, **kw)
    o_p, lse_p = fa.flash_attention_fwd_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    err_o = (o.float() - o_p.float()).abs().max().item()
    err_l = (lse - lse_p).abs().max().item()
    if not (err_o <= ATTN_ATOL and err_l <= LSE_ATOL):
        raise AssertionError(f"flash forward at {label} disagrees with "
                             f"plain: {err_o}, {err_l}")
    del o_p, lse_p
    err_b = _check_bwd(q, k, v, do, kw, label)
    dmat = (do.float() * o.float()).sum(-1)

    def fwd():
        return fa.flash_attention_fwd_cuda(q, k, v, **kw)

    def bwd():
        return fa.flash_attention_bwd_cuda(q, k, v, lse, do, dmat, **kw)

    w = fa.bwd_width(d, dv)
    # the instance's width; held here, since the timed launches read them
    # through raw pointers
    padded = [torch.nn.functional.pad(t, (0, w - t.shape[-1]))
              for t in (q, k, v, do)]
    run_dq, run_dkv = _bwd_parts(*padded[:3], lse, padded[3], dmat, **kw)
    nb = bh // heads
    q4 = q.reshape(nb, heads, s, d).detach().requires_grad_(True)
    k4, v4 = (t.reshape(nb, heads // group, s, t.shape[-1])
              .repeat_interleave(group, 1).detach().requires_grad_(True)
              for t in (k, v))
    do4 = do.reshape(nb, heads, s, dv)
    i = torch.arange(s, device=DEV)
    mask = i[None, :] <= i[:, None]
    if window:
        mask &= (i[:, None] - i[None, :]) < window
    sdpa_kw = (dict(is_causal=True) if not window else dict(attn_mask=mask))

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            q4, k4, v4, scale=kw["scale"], **sdpa_kw)

    def sdpa_fwd_bwd():
        return torch.autograd.grad(sdpa(), (q4, k4, v4), do4)

    t = {"fwd_ms": cuda_ms(fwd), "fwd_graph_ms": graph_ms(fwd),
         "fwd_plain_ms": cuda_ms(lambda: fa.flash_attention_fwd_plain(
             q, k, v, **kw), iters=5),
         "bwd_ms": cuda_ms(bwd), "bwd_graph_ms": graph_ms(bwd),
         "dq_graph_ms": graph_ms(run_dq), "dkv_graph_ms": graph_ms(run_dkv),
         "bwd_plain_ms": cuda_ms(lambda: fa.flash_attention_bwd_plain(
             q, k, v, lse, do, dmat, **kw), iters=5),
         "sdpa_fwd_ms": cuda_ms(sdpa), "sdpa_fwd_graph_ms": graph_ms(sdpa),
         "sdpa_fwd_bwd_ms": cuda_ms(sdpa_fwd_bwd),
         "sdpa_fwd_bwd_graph_ms": graph_ms(sdpa_fwd_bwd)}
    t["sdpa_bwd_ms"] = t["sdpa_fwd_bwd_ms"] - t["sdpa_fwd_ms"]
    t["sdpa_bwd_graph_ms"] = t["sdpa_fwd_bwd_graph_ms"] \
        - t["sdpa_fwd_graph_ms"]
    pairs = bh * _window_pairs(s, window)
    io = q.numel() + k.numel() + v.numel()
    f_bytes = 2 * (io + bh * s * dv) + 4 * bh * s
    f_flops = 2 * pairs * (d + dv)
    b_bytes = 2 * (io + do.numel()) + 4 * 2 * bh * s + 4 * io
    b_flops = 2 * pairs * (3 * d + 2 * dv)
    t["fwd_bound_ms"], t["fwd_bound_by"] = bound_ms(f_bytes, f_flops,
                                                    BF16_FLOPS)
    t["bwd_bound_ms"], t["bwd_bound_by"] = bound_ms(b_bytes, b_flops,
                                                    BF16_FLOPS)
    t.update(fwd_max_abs_err=err_o, lse_max_abs_err=err_l,
             bwd_max_abs_err=err_b,
             shape=f"BH={bh} G={group} S={s} q/k {d} v {dv} causal "
                   f"window {window} (bwd instance {w})")
    print(f"  {label} ({t['shape']}): fwd kernel {t['fwd_ms']:.4f} ms, "
          f"graph {t['fwd_graph_ms']:.4f} ms, plain {t['fwd_plain_ms']:.4f} "
          f"ms, sdpa {t['sdpa_fwd_ms']:.4f} ms (graph "
          f"{t['sdpa_fwd_graph_ms']:.4f}), bound {t['fwd_bound_ms']:.5f} ms "
          f"({t['fwd_bound_by']}); bwd kernels {t['bwd_ms']:.4f} ms, graph "
          f"{t['bwd_graph_ms']:.4f} ms (dq {t['dq_graph_ms']:.4f}, dk/dv "
          f"{t['dkv_graph_ms']:.4f}), plain {t['bwd_plain_ms']:.4f} ms, sdpa "
          f"fwd+bwd - fwd {t['sdpa_bwd_ms']:.4f} ms (graph "
          f"{t['sdpa_bwd_graph_ms']:.4f}), bound {t['bwd_bound_ms']:.5f} ms "
          f"({t['bwd_bound_by']}, {b_bytes / 1e6:.1f} MB, "
          f"{b_flops / 1e9:.2f} GFLOP)", flush=True)
    return t


def check_train_family_shapes(gen) -> dict:
    """Rows 2 and 4 at the train families phase's two new shapes."""
    return {"deepseek-v3 MLA train": _train_shape(
                gen, "flash deepseek-v3 MLA train", 1024, 1, 256, 192, 128,
                0, 128),
            "gemma3-1b train": _train_shape(
                gen, "flash gemma3-1b train", 16, 4, 1024, 256, 256, 512, 4)}


def _train_family(cfg, tcfg, batch, seq, steps, smi, what) -> dict:
    """``steps`` steps of ``Trainer.run`` on ``SyntheticLM``: per-step
    loss, grad norm and aux, steady tokens/s, peak memory, launches."""
    print(f"  {cfg.name}: {what}; quant_mode={cfg.quant_mode} attn_impl="
          f"{cfg.attn_impl} remat={cfg.remat}, batch {batch} x seq {seq}, "
          f"{steps} steps", flush=True)
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    trainer = Trainer(cfg, tcfg, TrainerConfig(steps=steps, log_every=1),
                      DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                 global_batch=batch), device=DEV)
    torch.cuda.synchronize()
    params_line = param_line(cfg, trainer.params)
    print(f"    initialised in {time.perf_counter() - t:.1f} s; "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated (bf16 "
          f"params + f32 moments)", flush=True)
    reset_counts()
    t = time.perf_counter()
    history = trainer.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    for h in history:
        print(f"    step {h['step']}: loss {h['loss']:.6f}, grad norm "
              f"{h['grad_norm']:.6f}, aux {h['aux']:.6f}, lr {h['lr']:.3e}, "
              f"{h['step_time_s']:.3f} s", flush=True)
        if not all(math.isfinite(h[k]) for k in ("loss", "grad_norm",
                                                  "aux")):
            raise AssertionError(f"{cfg.name}: non-finite loss at step "
                                 f"{h['step']}")
    steady = [h["step_time_s"] for h in history[1:]]
    tok_s = batch * seq * len(steady) / sum(steady)
    print(f"    {steps} steps in {wall:.2f} s; steady {tok_s:.1f} tokens/s "
          f"(steps 1-{steps - 1}); peak memory allocated {peak / 1e9:.2f} "
          f"GB; launches {counts} ({smi})", flush=True)
    require_no_f32(counts)
    return {"trainer": trainer, "history": history, "wall_s": wall,
            "tok_s": tok_s, "peak_bytes": peak, "counts": counts,
            "param_count": params_line}


def _free(out: dict) -> None:
    del out["trainer"]
    gc.collect()
    torch.cuda.empty_cache()


def phase_train_families(smi: str) -> dict:
    """3 QAT steps (remat, AdamW, ``Trainer``) of gemma3-1b at full width
    and depth, deepseek-v3-671b cut to its first 2 layers with the MTP
    term, and jamba-v0.1-52b cut to its first 2 layers, at published
    widths; each model freed before the next."""
    t_phase = time.perf_counter()
    print(f"train families: {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
          f"allocated before the first model", flush=True)
    qat = dict(quant_mode="qat", remat=True)
    steps = 3
    out = {}

    def tconf(**kw):
        return TrainConfig(total_steps=steps, warmup_steps=1, **kw)

    cfg = get_config("gemma3-1b").replace(attn_impl="flash", **qat)
    r = _train_family(
        cfg, tconf(), 4, 1024, steps, smi,
        f"full width and depth ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
        f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, tied; 5 "
        f"local (window {cfg.sliding_window}) : 1 global)")
    require_launched(r["counts"], ("flash_attention_fwd",
                                   "flash_attention_bwd_dq",
                                   "flash_attention_bwd_dkv"))
    _free(r)
    out[cfg.name] = r

    full = get_config("deepseek-v3-671b")
    cfg = full.replace(n_layers=2, prefix_pattern=full.prefix_pattern[:2],
                       attn_impl="flash", **qat)
    tcfg = tconf(mtp_weight=0.3, mtp_depth=1)
    r = _train_family(
        cfg, tcfg, 8, 256, steps, smi,
        f"full width cut to its first 2 layers (dense MLA: {cfg.n_heads} "
        f"heads, q_lora {cfg.q_lora_rank}, kv_lora {cfg.kv_lora_rank}, rope "
        f"{cfg.qk_rope_dim}, nope {cfg.qk_nope_dim}, v {cfg.v_head_dim}; "
        f"d_ff {cfg.d_ff}; vocab {cfg.vocab_size}, untied), mtp_weight "
        f"{tcfg.mtp_weight}, mtp_depth {tcfg.mtp_depth}")
    require_launched(r["counts"], ("flash_attention_fwd",
                                   "flash_attention_bwd_dq",
                                   "flash_attention_bwd_dkv"))
    trainer = r["trainer"]
    batch = trainer.data.batch(steps)
    with torch.no_grad():
        with_mtp, _ = make_loss_fn(cfg, tcfg)(trainer.params, batch)
        without, _ = make_loss_fn(cfg, tconf())(trainer.params, batch)
        logits, _ = forward(trainer.params, cfg, batch["tokens"])
        term = cross_entropy(logits[:, :-2], batch["labels"][:, 1:-1])
    del logits
    gap = float(with_mtp - without)
    want = float(tcfg.mtp_weight * term)
    tol = 1e-6 * abs(float(with_mtp))
    print(f"    MTP on one batch: loss {float(with_mtp):.6f} with, "
          f"{float(without):.6f} without, gap {gap:.6f}; mtp_weight x "
          f"shifted CE {want:.6f} (|diff| {abs(gap - want):.2e}, bound "
          f"{tol:.2e})", flush=True)
    if not (want > 0 and abs(gap - want) <= tol):
        raise AssertionError("deepseek-v3: the MTP term is not the gap "
                             "between the losses with and without it")
    r["mtp"] = {"with": float(with_mtp), "without": float(without),
                "term": want}
    del trainer
    _free(r)
    out[cfg.name] = r

    full = get_config("jamba-v0.1-52b")
    cfg = full.replace(n_layers=2, block_pattern=full.block_pattern[:2],
                       attn_impl="flash", **qat)
    r = _train_family(
        cfg, tconf(), 4, 512, steps, smi,
        f"full width cut to its first 2 layers (mamba + MLP d_ff "
        f"{cfg.d_ff}, mamba + MoE of {cfg.n_experts} experts top-"
        f"{cfg.top_k}, d_ff_expert {cfg.d_ff_expert}; d_model "
        f"{cfg.d_model}, {cfg.ssm_heads} SSD heads of {cfg.ssm_head_dim}, "
        f"state {cfg.ssm_state}, chunk {cfg.ssm_chunk}; vocab "
        f"{cfg.vocab_size}, untied; no attention layer)")
    if not all(h["aux"] > 0 for h in r["history"]):
        raise AssertionError("jamba: the MoE aux loss is not positive")
    _free(r)
    out[cfg.name] = r
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"  train families phase {out['wall_s']:.1f} s", flush=True)
    return out


# the CPU tests' tolerances for the mesh step against the unsharded one
# (tests/test_torch_mesh_train.py)
MESH_LOSS_ATOL = 1e-3
MESH_GNORM_RTOL = 5e-3
MESH_AUX_ATOL = 1e-3
DRYRUN_CELLS = (["yi-6b", "deepseek-v3-671b"], ["train_4k", "decode_32k"])


def start_dryrun(path: str):
    """The dry run's cells as a subprocess (host work on fake tensors, so
    it runs beside the card's phases); :func:`finish_dryrun` collects
    it."""
    archs, shapes_ = DRYRUN_CELLS
    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "src"),
        OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    cmd = [sys.executable, "-W", "ignore", "-m", "repro_torch.launch.dryrun",
           "--arch", *archs, "--shape", *shapes_, "--singlepod",
           "--out", path]
    return subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), \
        time.perf_counter()


def finish_dryrun(proc, t0: float, path: str, smi: str,
                  limit_s: float) -> dict:
    """Wait for the dry run (at most ``limit_s`` more seconds; past that it
    is stopped and the phase fails), then print its table and each
    record's per-card memory."""
    from repro_torch.roofline import analyze_file, format_table
    try:
        log, _ = proc.communicate(timeout=limit_s)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise AssertionError(f"dry run: not done {limit_s:.0f} s after the "
                             f"card's phases")
    wall = time.perf_counter() - t0
    for line in log.splitlines():
        if line.startswith(("[ok]", "[FAIL]", "dry-run:")):
            print(f"  {line}", flush=True)
    if proc.returncode != 0:
        raise AssertionError(f"dry run: exit {proc.returncode}\n{log[-3000:]}")
    with open(path) as f:
        records = json.load(f)
    archs, shapes_ = DRYRUN_CELLS
    if len(records) != len(archs) * len(shapes_) \
            or any(r["status"] != "ok" for r in records):
        raise AssertionError(f"dry run: a cell is not ok: {records}")
    print("  " + format_table(analyze_file(path)).replace("\n", "\n  "),
          flush=True)
    for r in records:
        print(f"  {r['arch']} {r['shape']} {r['mesh']}: per card "
              f"{r['argument_size_in_bytes'] / 1e9:.2f} GB stored + "
              f"{r['temp_size_in_bytes'] / 1e9:.2f} GB peak live, fits "
              f"{r['fits']} (HBM {HW.HBM_BYTES / 1e9:.0f} GB); "
              f"{r['scan_trips']} blocks from 1 and 2, data rows from "
              f"{r['data_rows_walked']}; walked in {r['walk_s']} s",
              flush=True)
    print(f"  dry run: {len(records)} cells in {wall:.1f} s of host time "
          f"(data-sheet arithmetic, not a measurement; {smi})", flush=True)
    return {"records": records, "wall_s": wall}


def _tree_to(tree, dev):
    """A copy of ``tree`` on ``dev`` (always a copy: a step updates its
    parameters in place)."""
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, dev) for v in tree]
    return tree.to(dev, copy=True)


def _mesh_steps(cfg, tcfg, host_params, batches, shape) -> dict:
    """``len(batches)`` steps of ``make_train_step`` from ``host_params``:
    unsharded (``shape`` None) or over a ``shape`` mesh of the one card
    repeated.  Per step loss, grad norm, aux and wall; launches,
    collective bytes, peak memory."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = _tree_to(host_params, DEV)
    if shape is not None:
        mesh = make_local_mesh(dp=shape[0], tp=shape[1],
                               devices=[DEV_ONE] * (shape[0] * shape[1]))
        params = train_shards(params, cfg, mesh)
    opt = adamw_init(params, tcfg.optimizer)
    step = make_train_step(cfg, tcfg)
    torch.cuda.synchronize()
    reset_counts()
    collectives.reset_collective_counts()
    hist = []
    for b in batches:
        t = time.perf_counter()
        params, opt, m = step(params, opt, b)
        torch.cuda.synchronize()
        hist.append({"loss": float(m["loss"]),
                     "grad_norm": float(m["grad_norm"]),
                     "aux": float(m["aux"]),
                     "wall_s": time.perf_counter() - t})
    out = {"history": hist, "counts": read_counts(),
           "collective_bytes": collectives.collective_bytes(),
           "collective_calls": collectives.collective_calls(),
           "peak_bytes": torch.cuda.max_memory_allocated()}
    del params, opt, step
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _print_mesh_run(label: str, r: dict, smi: str) -> None:
    for i, h in enumerate(r["history"]):
        print(f"    {label} step {i}: loss {h['loss']:.6f}, grad norm "
              f"{h['grad_norm']:.6f}, aux {h['aux']:.6f}, {h['wall_s']:.3f} s",
              flush=True)
    moved = {k: v for k, v in r["collective_bytes"].items()
             if any(v.values())}
    print(f"    {label}: collective bytes {moved} in "
          f"{r['collective_calls']} calls; launches "
          f"{ {k: v for k, v in r['counts'].items() if v} }; peak memory "
          f"{r['peak_bytes'] / 1e9:.2f} GB ({smi})", flush=True)


def _hold_mesh(label: str, got: dict, want: dict, aux: bool = False) -> None:
    for i, (g, w) in enumerate(zip(got["history"], want["history"])):
        dl = abs(g["loss"] - w["loss"])
        dg = abs(g["grad_norm"] / w["grad_norm"] - 1)
        da = abs(g["aux"] - w["aux"])
        print(f"    {label} step {i} against (1, 1): |dloss| {dl:.2e} "
              f"(bound {MESH_LOSS_ATOL}), grad norm rel {dg:.2e} (bound "
              f"{MESH_GNORM_RTOL}), |daux| {da:.2e}", flush=True)
        if not (math.isfinite(g["loss"]) and dl <= MESH_LOSS_ATOL
                and dg <= MESH_GNORM_RTOL
                and (not aux or da <= MESH_AUX_ATOL)):
            raise AssertionError(f"{label}: step {i} leaves (1, 1)'s loss, "
                                 f"grad norm or aux")


def _fake_vs_real() -> dict:
    """The dry run's walk of reduced yi-6b (dense, chunked, 2 layers) at
    (2, 2): fake ``meta:N`` entries against real tensors on the card."""
    from repro_torch.configs import reduced
    from repro_torch.launch import dryrun
    from repro_torch.launch.shapes import ShapeCase
    cfg = reduced(get_config("yi-6b")).replace(n_layers=2)
    case = ShapeCase("check", "train", 64, 8)
    t = time.perf_counter()
    fake = dryrun.walk_cell(cfg, case, dryrun._walk_mesh(2, 2),
                            quant_moments=False)
    real = dryrun.walk_cell(
        cfg, case, make_local_mesh(dp=2, tp=2, devices=[DEV_ONE] * 4),
        quant_moments=False, params=model_init(cfg, seed=0, device=DEV),
        fake=False)
    keys = ("flops", "collective_bytes", "io_bytes", "bytes_accessed")
    print(f"  fake against real (reduced yi-6b, dense, chunked, (2, 2)): "
          + ", ".join(f"{k} {fake[k]} / {real[k]}" for k in keys
                      if k != "collective_bytes")
          + f"; collective bytes equal: "
          f"{fake['collective_bytes'] == real['collective_bytes']} "
          f"({time.perf_counter() - t:.1f} s)", flush=True)
    bad = [k for k in keys if fake[k] != real[k]]
    if bad:
        raise AssertionError(f"fake walk differs from the real one on the "
                             f"card: {bad}")
    return {"fake": fake, "real": real}


def phase_mesh_train(smi: str, dry) -> dict:
    """Phase 8d (see the module docstring)."""
    t_phase = time.perf_counter()
    out = {}
    cfg = get_config("qwen3-4b").replace(quant_mode="qat", attn_impl="flash",
                                         remat=True)
    batch, seq, steps = 8, 256, 2
    tcfg = TrainConfig(optimizer=AdamWConfig(), total_steps=10,
                       warmup_steps=0)
    print(f"mesh train: {cfg.name} full width ({cfg.n_layers} layers), "
          f"quant_mode=qat attn_impl=flash remat, batch {batch} x seq {seq}, "
          f"{steps} steps at (1, 1), (1, 2) and (2, 1) on one card repeated",
          flush=True)
    host = _tree_to(model_init(cfg, seed=0, device=DEV), "cpu")
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                  global_batch=batch), device=DEV)
    batches = [data.batch(i) for i in range(steps)]
    runs = {"(1, 1)": _mesh_steps(cfg, tcfg, host, batches, None)}
    _print_mesh_run("(1, 1)", runs["(1, 1)"], smi)
    require_launched(runs["(1, 1)"]["counts"], (
        "flash_attention_fwd", "flash_attention_bwd_dq",
        "flash_attention_bwd_dkv"))
    for shape in ((1, 2), (2, 1)):
        label = str(shape)
        runs[label] = r = _mesh_steps(cfg, tcfg, host, batches, shape)
        _print_mesh_run(label, r, smi)
        _hold_mesh(f"qwen3-4b {label}", r, runs["(1, 1)"])
        for k in ("flash_attention_fwd", "flash_attention_bwd_dq",
                  "flash_attention_bwd_dkv"):
            if r["counts"][k] != 2 * runs["(1, 1)"]["counts"][k]:
                raise AssertionError(f"{label}: {k} launched "
                                     f"{r['counts'][k]} times, not twice "
                                     f"(1, 1)'s")
        require_no_f32(r["counts"])
    del host
    out["qwen3-4b"] = runs

    full = get_config("deepseek-v3-671b")
    ds = full.replace(n_layers=2, prefix_pattern=full.prefix_pattern[:2],
                      attn_impl="flash", quant_mode="qat", remat=True)
    full = get_config("jamba-v0.1-52b")
    jb = full.replace(n_layers=2, block_pattern=full.block_pattern[:2],
                      attn_impl="flash", quant_mode="qat", remat=True)
    for c, tc, what in (
            (ds, TrainConfig(total_steps=10, warmup_steps=0, mtp_weight=0.3),
             "its 2 dense MLA layers, MTP 0.3"),
            (jb, TrainConfig(total_steps=10, warmup_steps=0),
             f"its first 2 layers, MoE of {jb.n_experts} experts")):
        print(f"  {c.name} full width cut to {what}: 1 step at (1, 1) and "
              f"(1, 2), batch 4 x seq 256", flush=True)
        host = _tree_to(model_init(c, seed=0, device=DEV), "cpu")
        b = [SyntheticLM(DataConfig(vocab_size=c.vocab_size, seq_len=256,
                                    global_batch=4), device=DEV).batch(0)]
        pair = {"(1, 1)": _mesh_steps(c, tc, host, b, None),
                "(1, 2)": _mesh_steps(c, tc, host, b, (1, 2))}
        del host
        for label, r in pair.items():
            _print_mesh_run(label, r, smi)
            require_no_f32(r["counts"])
        _hold_mesh(f"{c.name} (1, 2)", pair["(1, 2)"], pair["(1, 1)"],
                   aux=True)
        out[c.name] = pair
    if not out[jb.name]["(1, 2)"]["history"][0]["aux"] > 0:
        raise AssertionError("jamba: the mesh step's aux is not positive")
    out["fake_vs_real"] = _fake_vs_real()
    out["wall_s"] = time.perf_counter() - t_phase
    out["dryrun"] = finish_dryrun(*dry, smi, limit_s=600)
    print(f"  mesh train phase {out['wall_s']:.1f} s", flush=True)
    return out


def _device_times(prof) -> dict:
    """Self device time (us) per CUDA kernel name from a profiler run."""
    kernels = {}
    for ev in prof.key_averages():
        if str(getattr(ev, "device_type", "")).endswith("CUDA"):
            us = getattr(ev, "self_device_time_total", None)
            if us is None:
                us = ev.self_cuda_time_total
            kernels[ev.key] = kernels.get(ev.key, 0.0) + us
    return kernels


def phase_profile(engine, prompts, n_new=32) -> dict:
    """One wave of 4 requests under torch.profiler: wall time, device time
    per kernel (self device time of CUDA events) and the idle share."""
    from torch.profiler import ProfilerActivity, profile
    for p in prompts[:4]:
        engine.submit(p, n_new)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        engine.run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    kernels = _device_times(prof)
    busy = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    print(f"profile: 4 requests x {n_new} tokens, wall {wall_us / 1e3:.1f} "
          f"ms, device busy {busy / 1e3:.1f} ms, idle share "
          f"{1 - busy / wall_us:.3f}", flush=True)
    for name, us in top:
        print(f"  {us / 1e3:9.2f} ms  {name[:90]}")
    # the paged decode kernel, wherever it ranks
    paged = {n: us / 1e3 for n, us in kernels.items() if "paged_decode" in n}
    for name, t_ms in paged.items():
        print(f"  paged decode {t_ms:9.2f} ms ({t_ms / (busy / 1e3):.2%} of "
              f"device time)  {name[:70]}", flush=True)
    return {"wall_ms": wall_us / 1e3, "busy_ms": busy / 1e3,
            "top": [(n, us / 1e3) for n, us in top], "paged": paged}


# PyTorch ops whose kernels a profile row splits out: a kernel launched
# under one of them (in an eager run, where every kernel has a CPU op
# above it) is classed by its device name in every row, so a captured
# row, whose kernels have no CPU op above them, gets its eager row's split
_OP_CLASSES = {"aten::mm": "dense_gemm", "aten::bmm": "attn_core_einsum",
               "aten::_softmax": "attn_core_softmax"}


def _learn_kernel_classes(prof, classes: dict) -> None:
    """Add to ``classes`` (kernel name -> set of classes) the kernels that
    ran under an op of ``_OP_CLASSES`` in this profile."""
    for ev in prof.events():
        if not ev.kernels:
            continue
        op = ev
        while op is not None and op.name not in _OP_CLASSES:
            op = op.cpu_parent
        if op is not None:
            for k in ev.kernels:
                classes.setdefault(k.name, set()).add(_OP_CLASSES[op.name])


def _kernel_class(name: str, classes: dict) -> str:
    if "nibble" in name:
        return "nibble"
    if "paged_decode" in name:
        return "paged_decode"
    if "flash" in name:
        return "flash_fwd"
    return "+".join(sorted(classes.get(name, ()))) or "other"


class _TimedGraph:
    """A captured stage's CUDA graph with CUDA events around each replay:
    the device span of the graph's kernels and the gaps between them."""

    def __init__(self, graph):
        self.graph = graph
        self.events = []

    def replay(self):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        self.graph.replay()
        b.record()
        self.events.append((a, b))

    def span_ms(self) -> float:
        """Device ms of the replays since the last read (after a sync)."""
        ms = sum(a.elapsed_time(b) for a, b in self.events)
        self.events.clear()
        return ms


def profile_spec_wave(params, prompts) -> dict:
    """One decode chunk and one speculation round, each eager and
    captured, and one wave, at full width (each after one unprofiled
    warm-up of the same stage, which captures its graphs).  Each stage
    but the wave runs once more unprofiled for its host wall time, with
    CUDA events around every graph replay in that same call (a lower
    bound of the idle share: the span holds the gaps inside the graph),
    then once under torch.profiler: wall time, device busy time and
    idle share, and the device time of the nibble and paged kernels, the
    flash forward, the dense GEMMs (``aten::mm``: projections and head),
    attention_core's einsums (``aten::bmm``) and softmax
    (``aten::_softmax``), each classed by device kernel name as the eager
    runs launch them (``_learn_kernel_classes``)."""
    from torch.profiler import ProfilerActivity, profile
    base = get_config("yi-6b").replace(
        quant_mode="w8a8_nibble", quant_backend="cuda", attn_impl="flash",
        cache_mode="paged", page_size=16)
    kw = dict(batch=4, max_len=192, prefill_len=128,
              alloc_mode="incremental")
    out, classes = {}, {}

    def chunk(e):
        e._run_chunk(0.0)

    def spec(e):
        e._run_spec_round(0.0)

    def wave(e):
        e._run_wave()

    for label, over, stage, capture in (
            ("decode chunk, eager", {}, chunk, False),
            ("decode chunk, captured", {}, chunk, True),
            ("spec round, eager", dict(spec_decode=True, spec_k=4), spec,
             False),
            ("spec round, captured", dict(spec_decode=True, spec_k=4), spec,
             True),
            ("wave", dict(prefill_chunk=32, admit_group=4), wave, None)):
        engine = Engine(base, params, ServeConfig(**kw, **over), device=DEV,
                        capture=capture)
        for p in prompts[:4]:
            engine.submit(p, 32)
        engine.start()
        engine._admit(0.0)
        stage(engine)                 # warm-up of the stage
        torch.cuda.synchronize()
        graphs = []
        for st in engine._stages.values():
            for bufs in getattr(st, "_buffers", {}).values():
                if bufs.graph is not None:
                    bufs.graph = _TimedGraph(bufs.graph)
                    graphs.append(bufs.graph)
        res = {}
        if stage is not wave:
            t = time.perf_counter()
            stage(engine)
            torch.cuda.synchronize()
            res["unprofiled_wall_ms"] = (time.perf_counter() - t) * 1e3
            if graphs:
                res["unprofiled_graph_span_ms"] = sum(g.span_ms()
                                                      for g in graphs)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            stage(engine)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t) * 1e3
        if graphs:
            res["graph_span_ms"] = sum(g.span_ms() for g in graphs)
        engine.run()
        _learn_kernel_classes(prof, classes)
        kernels = _device_times(prof)
        busy = sum(kernels.values()) / 1e3
        parts = dict.fromkeys(("nibble", "paged_decode", "flash_fwd",
                               "dense_gemm", "attn_core_einsum",
                               "attn_core_softmax"), 0.0)
        for name, us in kernels.items():
            cls = _kernel_class(name, classes)
            parts[cls] = parts.get(cls, 0.0) + us / 1e3
        parts["other"] = parts.pop("other", 0.0)
        line = (f"profile {label} (4 slots, full width): wall {wall:.2f} ms, "
                f"device busy {busy:.2f} ms, idle share "
                f"{1 - busy / wall:.3f}")
        if "graph_span_ms" in res:
            line += (f", graph span {res['graph_span_ms']:.2f} ms "
                     f"(busy {busy / res['graph_span_ms']:.1%} of it)")
        if "unprofiled_wall_ms" in res:
            line += (f"; unprofiled, same engine: wall "
                     f"{res['unprofiled_wall_ms']:.2f} ms")
        if "unprofiled_graph_span_ms" in res:
            span, w = res["unprofiled_graph_span_ms"], res["unprofiled_wall_ms"]
            line += (f", graph span {span:.2f} ms, idle share outside the "
                     f"graphs' span {1 - span / w:.3f}")
        print(line + "; device ms "
              + ", ".join(f"{k} {v:.3f} ({v / busy:.1%})"
                          for k, v in parts.items()), flush=True)
        out[label] = {"wall_ms": wall, "busy_ms": busy, "parts_ms": parts,
                      **res}
        del engine
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", action="store_true",
                    help="after serving, profile one wave of 4 requests; "
                         "after the spec + wave phase, one decode chunk "
                         "and one speculation round (each eager and "
                         "captured) and one prefill wave")
    ap.add_argument("--out", default=None, help="write details as JSON")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    smi = phase_device()
    dry_path = os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "build",
        "dryrun_records.json")
    os.makedirs(os.path.dirname(dry_path), exist_ok=True)
    dry = start_dryrun(dry_path)
    try:
        return _main(args, t0, smi, dry + (dry_path,))
    finally:
        if dry[0].poll() is None:
            dry[0].kill()
            dry[0].communicate()


def _main(args, t0, smi, dry) -> int:
    phase_build()
    gen = torch.Generator(device=DEV).manual_seed(0)
    rows = [check_nibble(gen), check_flash(gen), check_paged(gen)]
    rows += [check_flash_bwd(gen, rows[1]), check_lut(gen)]
    f32 = check_attention_f32(gen)
    paper = phase_paper()
    rows[0]["paper_launches"] = paper["counts"]["nibble_matmul"]
    rows[4]["paper_launches"] = paper["counts"]["lut_matmul"]
    rowmean = check_fixed_mean()
    serve = phase_serve()
    engine, prompts = serve.pop("engine"), serve.pop("prompts")
    params = serve.pop("params")
    for r in rows[:3]:
        r["launches"] = serve["counts"][r["name"]]
    if args.profile:
        serve["profile"] = phase_profile(engine, prompts)
    serve["prompts"] = prompts
    graphs = phase_graphs(params, smi, serve)
    del serve["prompts"], serve["streams"]
    static = phase_static(engine, smi)
    del engine
    workload = phase_workload(params, smi)
    for r in rows[:3]:
        r["workload_launches"] = workload["counts"][r["name"]]
    fleet = phase_fleet(params, smi, workload, serve)
    del workload["scfg"]
    for r in rows[:3]:
        r["fleet_launches"] = {
            "fleet": fleet["counts"][r["name"]],
            "dense_fleet": fleet["bitmatch"]["counts"][r["name"]]}
    prefix_swap = phase_prefix_swap(params, smi, workload, serve)
    del workload["dense_runs"]
    for r in rows[:3]:
        r["prefix_swap_launches"] = prefix_swap["counts"][r["name"]]
    serve["prompts"] = prompts
    spec_wave = phase_spec_wave(params, smi, serve, workload)
    del serve["prompts"]
    for r in rows[:3]:
        r["spec_launches"] = spec_wave["counts"][r["name"]]
        r["tail_launches"] = spec_wave["tail_counts"][r["name"]]
    if args.profile:
        spec_wave["profile"] = profile_spec_wave(params, prompts)
    lut = phase_lut_serve(params, prompts)
    rows[4]["launches"] = lut["counts"]["lut_matmul"]
    int8kv = phase_int8_kv(params, prompts, smi)
    for r in rows[:3]:
        r["int8kv_launches"] = int8kv["counts"][r["name"]]
    tp = phase_tp(params, prompts, serve, smi, gen)
    for r in rows[:3]:
        r["tp_launches"] = {"yi-6b": tp["counts"][r["name"]],
                            "gemma3-1b 2 layers":
                            tp["gemma3"]["counts"][r["name"]]}
    rows[0]["tp_shapes"] = {k: tp["shapes"][k] for k in
                            ("wq shard", "wk/wv shard", "gate/up shard")}
    rows[2]["tp_shapes"] = {"paged shard": tp["shapes"]["paged shard"]}
    dp = phase_dp(params, prompts, serve, smi)
    for r in rows[:3]:
        r["dp_launches"] = {"yi-6b " + s: dp[s]["counts"][r["name"]]
                            for s in ("(2, 1)", "(2, 2)")}
    del params
    gc.collect()
    torch.cuda.empty_cache()
    shapes = check_family_shapes(gen)
    tp_shapes = check_tp_family_shapes(gen)
    families = phase_families(smi, serve)
    ssm_shapes = check_ssm_shapes(gen)
    ssm = phase_ssm(smi, serve)
    ev_shapes = check_encdec_vlm_shapes(gen)
    encdec_vlm = phase_encdec_vlm(smi, serve)
    tp_families = {name: f["tp"] for phase in (families, ssm, encdec_vlm)
                   for name, f in phase.items()
                   if isinstance(f, dict) and "tp" in f}
    print(f"tp families: {sorted(tp_families)} at tp=2 on {TP_DEVICES}",
          flush=True)
    for r in rows[:3]:
        r["families_shapes"] = shapes[r["name"]]
        r["ssm_shapes"] = ssm_shapes[r["name"]]
        r["encdec_vlm_shapes"] = ev_shapes[r["name"]]
        for key, phase in (("families_launches", families),
                           ("ssm_launches", ssm)):
            r[key] = {name: f["counts"][r["name"]]
                      for name, f in phase.items() if isinstance(f, dict)}
        r["encdec_vlm_launches"] = {
            name: ({"with_inputs": f["direct"]["counts"][r["name"]],
                    "served": f["counts"][r["name"]]} if "direct" in f
                   else f["counts"][r["name"]])
            for name, f in encdec_vlm.items() if isinstance(f, dict)}
    for r in rows[:3]:
        r["tp_families_launches"] = {
            name: {"tp1": t["counts_tp1"][r["name"]],
                   "tp2": t["counts"][r["name"]]}
            for name, t in tp_families.items()}
        if r["name"] in tp_shapes:
            r["tp_families_shapes"] = tp_shapes[r["name"]]
    for r in rows[:3]:
        r["dp_launches"].update({
            f"{name} (2, 1)": f["dp"]["counts"][r["name"]]
            for phase in (families, ssm) for name, f in phase.items()
            if isinstance(f, dict) and "dp" in f})
    tc = encdec_vlm["whisper-base train"]["counts"]
    rows[3]["encdec_vlm_launches"] = {"whisper-base train": (
        tc["flash_attention_bwd_dq"] + tc["flash_attention_bwd_dkv"])}
    train = phase_train(args.profile)
    rows[3]["launches"] = (train["counts"]["flash_attention_bwd_dq"]
                           + train["counts"]["flash_attention_bwd_dkv"])
    train_shapes = check_train_family_shapes(gen)
    train_families = phase_train_families(smi)
    for r, keys in ((rows[1], ("flash_attention_fwd",)),
                    (rows[3], ("flash_attention_bwd_dq",
                               "flash_attention_bwd_dkv"))):
        r["train_families_shapes"] = train_shapes
        r["train_families_launches"] = {
            name: sum(f["counts"][k] for k in keys)
            for name, f in train_families.items() if isinstance(f, dict)}
    grads = check_train_grads()
    mesh_train = phase_mesh_train(smi, dry)
    for r, keys in ((rows[1], ("flash_attention_fwd",)),
                    (rows[3], ("flash_attention_bwd_dq",
                               "flash_attention_bwd_dkv"))):
        r["mesh_train_launches"] = {
            f"qwen3-4b {shape}": sum(run["counts"][k] for k in keys)
            for shape, run in mesh_train["qwen3-4b"].items()}
    print(f"cache bytes per token held to the capacity model's closed form "
          f"on {len(CACHE_BYTES)} configs: {CACHE_BYTES}", flush=True)
    print(f"total {time.perf_counter() - t0:.1f} s", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"nvidia_smi": smi, "kernels": rows,
                       "attention_f32_errors": f32, "paper": paper,
                       "serve": serve,
                       "workload": workload, "fleet": fleet,
                       "cache_token_bytes": CACHE_BYTES,
                       "prefix_swap": prefix_swap,
                       "spec_wave": spec_wave, "graphs": graphs,
                       "lut_serve": lut, "int8_kv": int8kv, "tp": tp,
                       "dp": dp, "fixed_mean": rowmean,
                       "families": families, "ssm": ssm,
                       "encdec_vlm": encdec_vlm, "train": train,
                       "train_families": train_families,
                       "train_grads": grads, "static": static,
                       "mesh_train": mesh_train,
                       "torch": torch.__version__},
                      f, indent=1)
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    # device times (CUDA graphs), the forward's training shape and the
    # workload and prefix+swap phases' launches, where a row has them
    extra = ("graph_ms", "library_graph_ms", "train_ms", "train_graph_ms",
             "library_train_ms", "library_train_graph_ms", "train_bound_ms",
             "workload_launches", "fleet_launches", "prefix_swap_launches",
             "spec_launches",
             "tail_launches", "families_launches", "families_shapes",
             "ssm_launches", "ssm_shapes", "int8kv_launches",
             "encdec_vlm_launches", "encdec_vlm_shapes", "paper_launches",
             "train_families_launches", "train_families_shapes",
             "tp_launches", "tp_shapes", "tp_families_launches",
             "tp_families_shapes", "dp_launches", "mesh_train_launches")
    print(json.dumps({"kernels": [
        {k: r[k] for k in keys + extra if k in r} for r in rows]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
