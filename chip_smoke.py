#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases:
  1. Build each CUDA kernel of the main path from the sources in this
     checkout and hold it against its plain PyTorch version, in f32 and bf16,
     at the JAX kernel tests' shapes and at the plain path's chunk shape.
  2. Build the full-width MPNN-ensemble surrogate (E=16, hidden 64, seeded
     random weights) and hold its kernel forward on the main path's chunk
     (the whole 10,000-molecule space) against its plain forward over the
     same molecules in plain-path chunks of 128.
  3. Serve: featurize the 10,000-molecule space and answer 3 re-score
     requests (predict, UCB, reorder) through ``rank_space``, perturbing the
     weights between requests as a retrain would; each predict is one chunk
     on the card. Kernel launch counts are set to 0 just before this phase
     and read just after it.
  4. Report: time each kernel, its plain version and the one PyTorch call
     that computes the same function, with CUDA events at the plain path's
     chunk shape, beside the bound for that work. 4b: the typed entry
     (bond types and edge matrices, no edge tensor) on the space's real
     bonds, held at 1e-5 against the dense kernel on the edge tensor built
     from the same bonds at the plain path's chunk, and against its plain
     version at the typed path's chunk (the whole space), where it is timed
     beside its plain version and the roofline's bound.
  5. Hold the flash-attention kernel against its plain version on the six
     cases of the JAX kernel tests, in f32 and bf16, at the serving shape
     (8, 2048, 16 heads, 8 KV heads, hd 128) in bf16, and, in bf16 at hd
     128, at shapes off the tensor-core kernel's 128-row and 128-key tiles
     (Sq = Sk = 1000; Sq = 37), at q_offset 128 with Sk = 2 Sq, at GQA
     group 5, and with a window and a softcap (a cap of 2 among them, which
     moves these scores by O(1)).
  6. Build internlm2-1.8b at its published widths (24 layers, d_model 2048,
     vocab 92544) with seeded random f32 weights drawn on the card, and hold
     one prefill (B=2, S=1024) through the kernel against the same prefill
     through the plain attention: last-position logits and the KV cache.
  7. Serve: answer 3 requests of 8 prompts x 2048 tokens, 32 new tokens
     each, through ``repro_torch.serving.Engine`` in bf16. The flash launch
     count is set to 0 just before this phase and read just after it.
  8. Report: time the flash kernel, its plain version and PyTorch's
     ``scaled_dot_product_attention`` at the serving shape, beside the bound
     and the kernel's TFLOP/s.
  9. Hold the Mamba2 SSD scan kernel against its plain version
     (``ssd_chunked``) with a random initial state on the three shapes of
     the JAX kernel tests, in f32 (the CUDA-core kernel) and bf16 (the TMA +
     wgmma kernel), and at zamba2-1.2b's serving shape (8, 2048, 64 heads,
     P=64, G=1, N=64, Q=128) in bf16 with a bf16 log decay, as the model
     passes it; and the flash kernel at zamba2's
     attention shape (8, 2048, 32 heads, 32 KV heads, hd 64) in bf16, and
     at hd 64 off the tiles (Sq = Sk = 1000; Sq = 37) and with a window and
     a softcap (of 50 and of 2).
 10. Build zamba2-1.2b at its published widths and depth (38 Mamba2 layers,
     d_model 2048, one shared attention block after every 6, vocab 32000)
     with seeded random f32 weights drawn on the card, and hold one prefill
     (B=2, S=1024) through both kernels against the same prefill through
     both plain versions: last-position logits, conv and SSM states and the
     KV cache. Then the same weights in bf16: the bf16 prefill through both
     kernels (the tensor-core SSD kernel among them) and through both plain
     versions: the kernels' logits and SSM states may lie at most twice as
     far from the f32 ones as the plain versions' (``BF16_PREFILL_RATIO``).
 11. Serve: answer 3 requests of 8 prompts x 2048 tokens, 32 new tokens
     each, through ``Engine`` with zamba2-1.2b in bf16. Both kernels' launch
     counts are set to 0 just before this phase and read just after it.
 12. Report: time the SSD kernel and its plain
     version at the serving shape, and the flash kernel at zamba2's
     attention shape, beside the bounds.
 13. Hold the RWKV6 WKV scan kernel against its plain version
     (``wkv6_chunked``) with a random initial state and a random bonus u on
     the two shapes of the JAX kernel test and a strong-decay case
     (log_w = -11.9 |normal|), in f32 (the step kernel) and bf16 (the
     chunked tensor-core kernel), and at rwkv6-3b's serving
     shape (8, 2048, 40 heads, K=V=64, Q=64) in bf16 with a bf16 log decay,
     as the model passes it.
 14. Build rwkv6-3b at its published widths and depth (32 layers, d_model
     2560, 40 heads of 64, d_ff 8960, vocab 65536) with seeded random f32
     weights drawn on the card, the leaves the reference initializer zeroes
     (the token-shift lerps, the decay bias, the bonus) or sets to ones
     (``ln_x``) drawn at random too, and hold one prefill (B=2, S=1024)
     through the kernel against the same prefill through ``wkv6_chunked``:
     last-position logits, both token shifts and the WKV state. Then the
     same weights in bf16 through the tensor-core kernel against the bf16
     prefill through ``wkv6_chunked``, as in phase 10.
 15. Serve: answer 3 requests of 8 prompts x 2048 tokens, 32 new tokens
     each, through ``Engine`` with rwkv6-3b in bf16. The WKV launch count
     is set to 0 just before this phase and read just after it.
 16. Report: time the WKV kernel and its plain
     version at the serving shape, beside the bound of the function: its
     bytes, and the chunked form's tensor-core operations (the step form's
     f32 operation count, the f32 step kernel's bound, as a note).
 17. Hold the grouped-matmul (gmm) kernel against its plain version
     (``gmm_reference``) on the two shapes of the JAX kernel test and on
     ragged row counts (53, 1, 8), in f32 and bf16, and on every shape
     llama4-scout's serving gives it, in bf16: prefill gate/up
     (16, 2048, 5120) x (16, 5120, 8192), prefill down (16, 2048, 8192) x
     (16, 8192, 5120), decode gate/up (16, 8, 5120) x (16, 5120, 8192),
     decode down (16, 8, 8192) x (16, 8192, 5120); at both decode shapes
     with a ``live`` mask of 8 of the 16 experts, whose rows of xe are zero
     and whose weights are NaN (the kernel must write zeros there and read
     none of them); and the flash kernel at llama4-scout's attention shape
     (8, 2048, 40 heads, 8 KV heads, hd 128) in bf16.
 18. Build llama4-scout at its published widths (d_model 5120, 40 heads /
     8 KV heads of 128, 16 experts top-1 of d_ff 8192, vocab 202048) cut to
     4 layers, with seeded random f32 weights drawn on the card, and hold
     one prefill (B=2, S=1024) with the expert products in the kernel
     (``moe_impl="gmm"``) against the same prefill through the plain
     einsums (``moe_impl="dropping"``): last-position logits and the KV
     cache, the launch counts of both passes, and every token's top-1
     expert in every layer. A different top-1 expert where the top two
     gates are more than 1e-5 apart is a fault; a flip at a smaller margin
     (a near-tie two correct passes may break differently) takes its batch
     row out of the comparison, and is logged. Then one decode step at
     batch 8 after a 16-token prompt, gmm against the plain einsums from
     one cache, where top-1 routing leaves at least 8 experts empty in
     every layer and the kernel skips them: logits and the cache.
 19. Serve: answer 3 requests of 8 prompts x 2048 tokens, 32 new tokens
     each, through ``Engine`` with llama4-scout cut to 12 layers (50.3 GiB
     of bf16 weights; the published 48 do not fit one card). Every MoE FFN
     of prefill and decode runs the gmm kernel and every prefill attention
     the flash kernel; both launch counts are set to 0 just before this
     phase and read just after it. The live experts of every MoE FFN call
     (those the kernel does not skip) are counted and logged.
 20. Report: time the gmm kernel, its plain version and ``torch.bmm`` at
     the prefill (gate) and decode shapes in bf16, decode twice (every
     expert live, and 8 of 16 live), and the flash kernel at llama4-scout's
     attention shape, beside the bounds and TFLOP/s.
 21. Retrain the full-width surrogate on the card and hold it against the
     same retrain on the CPU: the same seeded initial weights, the same
     (E, n) bootstrap indices, the campaign's 48 pre-campaign molecules.
     The first epoch's loss gradients and the weights after one Adam epoch
     within 1e-5 of each tensor's scale, the last loss of a three-epoch
     retrain within 1e-4, and that loss below the first epoch's. Then time
     an epoch on the card at 48 and at 112 molecules (the most a campaign
     of budget 64 trains on) and read the peak memory.
 22. Campaign: ``run_campaign`` at full width on the card under each policy
     (random, no-retrain, update-n) with the ``AppConfig`` defaults (800
     molecules, a retrain every 16 results, 200 epochs) but a budget of 64
     (of 120). Under
     update-n each QC assay waits before the oracle answers, long enough
     that the longest retrain of the campaign (200 epochs at 112 molecules,
     timed in phase 21) returns before the next 16 results are in: the
     paper's assays take hours and its retrains minutes, so there the model
     is refreshed after every n results. Random and no-retrain never
     retrain; a wait would change nothing they assay. Every re-score (the initial ranking, one after each retrain,
     and the two MAE predicts around the campaign) goes through the
     ``mpnn_mp`` kernel; its launch count is set to 0 just before each
     campaign and read just after it, and must equal message steps x
     chunks summed over those predicts. Training runs no kernel. update-n
     must retrain at least once and re-score after every retrain, and
     every retrain payload must reach the Updater as numpy, its large
     leaves through Value Server proxies.
 23. Train step on the card against the CPU: internlm2-1.8b at published
     widths cut to 2 layers, f32, B=2, S=256, 3 steps with no warmup, each
     from one state on both devices (the CPU's state before the step, copied
     to the card): metrics within 1e-5 relative, m and v within 1e-5
     relative plus 5e-5 of each tensor's largest |value|, params by
     ``hold_adam_step``'s rule at step t (1e-5 of the scale plus the
     difference of the two devices' Adam steps from their own m and v).
     Then the gradients under remat "block" against remat "none" on the
     card, and a train step with ``attn_impl="kernel"`` must raise before
     it launches anything.
 24. Train internlm2-1.8b at its published widths and depth (24 layers,
     1.889 G parameters) in bf16 with remat "block" through
     ``launch.train.train``: batch 8 x 2048 as 2 microbatches of 4, 10
     steps at lr 3e-4 (warmup 1), the copied ``tokens.make_batch`` data.
     Every kernel launch count is set to 0 just before and must still be 0
     just after: training runs no hand-written kernel. Reports ms per step
     (median of steps 3-10), tokens/s, model TFLOP/s, mfu and peak memory;
     the mean loss of the last 5 steps must be below that of the first 5.
 25. Checkpoint on the card: the 2-layer cut in bf16 trains 2 steps, is
     saved at step 2 (``CheckpointManager.save``) and trains on in place;
     the restored step-2 state must equal a copy taken at step 2 bit for
     bit. Then a run interrupted after 2 of 4 steps and resumed from its
     checkpoint against the uninterrupted run: losses within 1e-3 relative,
     weights within ``RESUME_TOL_LR`` lr plus one bf16 ulp a step. Reports
     GB written and seconds.
 26. Hold the flash-attention kernel against its plain version at head dim
     256 (gemma2), f32 and bf16: a window that starts inside a 64-key tile
     with a softcap of 50, GQA 8/4 and a ragged last tile; a softcap of 2;
     a decode-like offset; one prompt of 5120 past a 4096 window; and at
     the cross-attention shape, non-causal with Sq != Sk at hd 64. Then in
     bf16 at each new arch's serving shape: gemma2 (8, 2048, 8 heads, 4 KV
     heads, hd 256, window 4096, softcap 50), seamless's cross-attention
     (8 x 2048 queries against 1536 frames, 16 heads of 64) and qwen2-vl
     (8, 2048, 64 heads, 8 KV heads, hd 128).
 27. Build gemma2-2b at its published widths and depth (26 layers in 13
     local/global periods, d_model 2304, 8 heads / 4 KV heads of 256, d_ff
     9216, vocab 256000, window 4096, softcaps 50 and 30) with seeded random
     f32 weights, and hold one prefill of 1 x 5120 tokens (past the window,
     so the 13 local layers mask in the kernel) through the kernel against
     the plain attention: logits and the KV cache; without the window the
     logits must move. Then the same weights in bf16, held as in phase 10
     (logits and K/V at most BF16_PREFILL_RATIO times as far from f32 as the
     plain bf16 prefill).
 28. Serve gemma2-2b in bf16 through ``Engine``: 3 requests of 8 x 2048
     tokens, 32 new, then one of 2 x 8192 (the window bites in the kernel's
     prefill and in the plain decode over the cache); 26 flash launches a
     request, counted from 0 around each.
 29. Build seamless-m4t-medium at its published widths (12 encoder and 12
     decoder layers, d_model 1024, 16 heads of 64, vocab 256206) in f32 and
     hold one prefill (B=2, S=1024 tokens, 768 random frames) through the
     kernel (encoder self-attention, decoder self- and cross-attention, 36
     launches) against the plain attention: logits, self and cross K/V;
     zero frames in place of the random ones must move the logits.
 30. Serve seamless-m4t-medium in bf16 through ``Engine``: 3 requests of 8 x
     2048 tokens with 1536 random frames each, 32 new; 36 flash launches a
     request.
 31. Build qwen2-vl-72b at its published widths (d_model 8192, 64 heads / 8
     KV heads of 128, d_ff 29568, vocab 152064, M-RoPE sections 16/24/24)
     cut to 2 layers in f32, and hold one prefill of 2 x 1024 embeddings (a
     24 x 32 grid of image patches, then text, at distinct temporal /
     height / width positions) through the kernel against the plain
     attention; plain RoPE in place of M-RoPE must move the logits.
 32. Serve qwen2-vl-72b cut to 24 of its 80 layers in bf16 through
     ``Engine``: 3 requests of 8 x 2048 tokens, 32 new; 24 flash launches a
     request.
 33. Report: time the flash kernel, its plain version and SDPA at the
     gemma2, cross-attention and qwen2-vl serving shapes (SDPA has no logit
     softcap: at gemma2's shape its time without cap and window is a note).

 34. Hold the flash-attention kernel against its plain version at head dim
     112 (kimi-k2; the binding zero-pads q, k and v to the kernel's 128 and
     scales by 112 ** -0.5), f32 and bf16: the JAX kernel tests' six cases,
     off the tiles (Sq = Sk = 1000; Sq = 37), a window with a softcap of 2
     and a q_offset; then kimi-k2's serving shape (8, 2048, 64 heads, 8 KV
     heads, hd 112) in bf16, timed against the plain version and SDPA
     beside the true head dim's bound.
 35. kimi-k2-1t-a32b at published widths (d_model 7168, 64 / 8 heads of
     112, 384 experts top-8 of d_ff 2048, vocab 163840) cut to 1 layer: its
     attention sub-layer in f32 on its own weights, kernel against plain on
     2 x 1024 tokens; gmm against ``gmm_reference`` at its four product
     shapes with E = 384 in bf16 (decode also with 64 of 384 experts live),
     timed at the prefill and decode shapes; then 3 requests of 8 x 2048 +
     32 in bf16 through ``Engine``: 1 flash and 96 gmm launches a request.
 36. The multi-process fabric, in a fresh interpreter (``--fabric``) that
     never initialises CUDA, so that its forked children can: a ``proc``
     broker (round trip timed), one inference shard (``start_inference_
     shard``) serving internlm2-1.8b at published widths in bf16 on the
     card behind ``InferenceClient`` (3 requests of 8 x 2048 + 32; its
     engine factory writes its flash launch count, 24 a request, to a file
     the script reads), and a one-worker ``ProcessPoolTaskServer`` whose
     method re-scores the 10,000-molecule space at full width on the card
     (3 ``mpnn_mp`` launches a re-score, one chunk; its peak device memory
     is logged). Back in this process: the
     shard's tokens against an in-process prefill and decode on the same
     seeded weights, up to the first near-tie (top-2 logits within 1e-3),
     and the worker's scores within 1e-6 of the in-process re-score's.
 37. synapp over the ``proc`` transport in the same interpreter: 4 pool
     workers, 2 Value Server shards and one scorer shard ranking 3
     candidates a task, then without the scorer (the paper's envelope):
     per-task dispatch overhead ((N x makespan - summed task runtimes) / T)
     and result latency.
 38. kimi-k2's expert-parallel prefill (``moe_impl="ep_a2a"``) at
     published widths cut to one layer, on a (1, 2) mesh of two spawned
     ranks sharing the card over gloo (collectives staged through the host).
 39. The sharded train step (``build_program("train")``) on the same mesh,
     2 steps in each of dp_tp and fsdp_tp, each held against the
     single-process step.
 40. Training gemma2-2b (published widths and depth) and qwen2-vl-72b (one
     layer) through ``launch.train.train``.
 41. The sharded prefill and decode programs (``build_program("prefill")``,
     ``shard_cache``, ``build_program("decode")``) of internlm2-1.8b and
     zamba2-1.2b at published widths and depth, bf16, with
     ``attn_impl="kernel"``, on the (1, 2) mesh: a prefill of 2 x 2048
     (a first call, then the timed one), then 16 decode steps
     teacher-forced with the single process's greedy tokens. First flash
     and SSD are held against their plain versions at the per-rank shapes.
     The kernels run on each rank's local heads
     (``kernels/dispatch.run_local``); their launches are counted on each
     rank from 0 around the timed prefill and must be > 0. Held against
     the single process on the same weights drawn on the card (in f32,
     cast to bf16), at the prefill and at every decode step: the sharded
     bf16 logits at most ``BF16_PREFILL_RATIO`` times as far from the f32
     logits of the plain versions (same tokens) as the single process's
     bf16 logits through the kernels (bf16 noise: the row-parallel partial
     sums meet in bf16, in another order; the distances are logged in bf16
     ulps at the logits' scale), and the argmax equal to the single
     process's greedy token in every row whose top-2 gap exceeds twice the
     two passes' distance. The same programs in f32 at published widths
     cut to ``SHARDED_F32_CUT`` layers, 4 teacher-forced decode steps, held
     against the single process through the same kernels at
     ``SHARDED_F32_TOL`` of the logits' scale (far inside bf16's noise, so
     a wrong cache write shows). Then flash and SSD timed at the per-rank
     shapes beside SDPA and the bound.
 42. The dry run (``python -m repro_torch.launch.dryrun``) of internlm2-1.8b
     and kimi-k2-1t-a32b at train_4k and decode_32k and of zamba2-1.2b at
     long_500k on the single-pod mesh (a fake world of 256 ranks, meta
     tensors), one subprocess a cell that sees no card, started after
     phase 41: every cell's status must be ok.

The kernels are built first, one ``nvcc`` per source, all in parallel;
``ptxas`` reports each kernel's registers and spills. Every time (kernel,
plain version, PyTorch call) is the median over CUDA events of ten calls an
event pair, so that a binding's host work overlaps the previous call's
kernel instead of sitting inside the events.

Prints the card's name and power limit, one ``{"kernels": [...]}`` line and,
last, ``{"ok": true, "device": {...}}``. Exits non-zero, printing no result,
without a CUDA device or when any check fails.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import subprocess
import sys
import threading
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

from repro_torch.apps.electrolyte import (FEATURES, AppConfig,  # noqa: E402
                                          Surrogate, rank_space, run_campaign)
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.configs.base import (ShapeConfig,  # noqa: E402
                                      ShardingConfig, TrainConfig,
                                      get_config, model_flops_per_token,
                                      param_count)
from repro_torch.configs.mpnn_surrogate import CONFIG  # noqa: E402
from repro_torch.data import molecules  # noqa: E402
from repro_torch.data.molecules import (MoleculeSpace,  # noqa: E402
                                        featurize, oracle_batch)
from repro_torch.data.tokens import make_batch  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_reference  # noqa: E402
from repro_torch.kernels.mamba2_ssd import mamba2_ssd  # noqa: E402
from repro_torch.kernels.mamba2_ssd import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.mamba2_ssd.ref import ssd_chunked  # noqa: E402
from repro_torch.kernels.moe_gmm import moe_gmm  # noqa: E402
from repro_torch.kernels.moe_gmm import ops as gmm_ops  # noqa: E402
from repro_torch.kernels.moe_gmm.ref import gmm_reference  # noqa: E402
from repro_torch.kernels.mpnn_mp import mpnn_mp, ops  # noqa: E402
from repro_torch.kernels.mpnn_mp.ref import (  # noqa: E402
    message_pass_reference, message_pass_typed_reference)
from repro_torch.kernels.rwkv6_scan import ops as wkv_ops  # noqa: E402
from repro_torch.kernels.rwkv6_scan import rwkv6_scan  # noqa: E402
from repro_torch.kernels.rwkv6_scan.ref import wkv6_chunked  # noqa: E402
from repro_torch.distributed import axisenv, comm  # noqa: E402
from repro_torch.launch import hlo_analysis, sharded  # noqa: E402
from repro_torch.launch import steps as train_steps  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.launch.serve import engine_tokens_per_s  # noqa: E402
from repro_torch.launch.train import train as train_lm  # noqa: E402
from repro_torch.models import api as lm_api  # noqa: E402
from repro_torch.models import attention as lm_attn  # noqa: E402
from repro_torch.models import moe as lm_moe  # noqa: E402
from repro_torch.models import moe_ep  # noqa: E402
from repro_torch.models import transformer as lm_transformer  # noqa: E402
from repro_torch.models.convert import params_to_numpy  # noqa: E402
from repro_torch.models.layers import InitMaker  # noqa: E402
from repro_torch.models.mlp import _ACTS  # noqa: E402
from repro_torch.models.mpnn import mpnn_loss, param_shapes  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402
from repro_torch.utils.trees import (tree_flatten_with_paths,  # noqa: E402
                                     tree_leaves, tree_map, whole)

DEV = "cuda"
SEED = 0
REQUESTS = 3
KAPPA = 2.0
SPACE = MoleculeSpace()                 # the default 10,000-molecule space
TEST_SHAPES = [(3, 16, 32), (2, 8, 64)]  # tests/test_kernels.py::test_mpnn_kernel
# f32: kernel and plain version both sum in f32, in different orders.
# bf16: both round an f32 sum to bf16, so they may differ by one bf16 ulp
# (<= 2**-7 relative).
TOLERANCE = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2.0 ** -7, 1e-4)}
# H100 SXM datasheet peaks (H100 80GB HBM3, 700 W), the port's one set
# (``launch/hlo_analysis.py``): HBM3 bytes/s, f32 FLOP/s outside the tensor
# cores, bf16 dense FLOP/s on them.
HBM_BYTES_PER_S = hlo_analysis.HBM_BW
F32_FLOP_PER_S = hlo_analysis.F32_FLOPS
BF16_FLOP_PER_S = hlo_analysis.PEAK_FLOPS

LM_ARCH = "internlm2-1.8b"
# (B, Sq, Sk, H, KVH, hd, causal, window, softcap, q_offset):
# tests/test_kernels.py::test_flash_attention
FA_CASES = [
    (2, 128, 128, 4, 2, 32, True, None, None, 0),
    (1, 256, 256, 4, 4, 64, True, 64, None, 0),
    (2, 128, 128, 8, 2, 32, True, None, 50.0, 0),
    (1, 128, 256, 4, 2, 32, True, None, None, 128),
    (2, 128, 128, 4, 1, 32, False, None, None, 0),
    (1, 64, 64, 2, 2, 128, True, 32, 30.0, 0),
]
SERVE_REQUESTS, SERVE_BATCH, SERVE_PROMPT, SERVE_MAX_NEW = 3, 8, 2048, 32
# Device memory that gc.collect() may free before a serving phase: an
# earlier phase's tensors held only by reference cycles.
GC_FREED_MAX = 64 * 2**20
# The prefill attention of internlm2-1.8b at the serving batch.
FA_SERVING = (SERVE_BATCH, SERVE_PROMPT, SERVE_PROMPT, 16, 8, 128, True,
              None, None, 0)
# The JAX kernel tests' tolerances: f32 kernel and plain version differ only
# in summation order; in bf16 both round an f32 result to bf16.
FA_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# The bf16 tensor-core kernel off the serving shapes, at hd 128: ragged
# 128-row and 128-key tiles, a 37-token prompt, q_offset 128 with
# Sk = 2 Sq, GQA group 5, and a window with a softcap. The inputs' scores
# have a standard deviation near 1, which a cap of 30 or 50 moves by about
# 1e-2 and a cap of 2 by O(1): the cases with softcap 2 fail a kernel that
# skips the cap.
FA_BF16_CASES = [
    (2, 1000, 1000, 16, 8, 128, True, None, None, 0),
    (8, 37, 37, 16, 8, 128, True, None, None, 0),
    (2, 512, 1024, 16, 8, 128, True, None, None, 128),
    (2, 1024, 1024, 40, 8, 128, True, None, None, 0),
    (2, 1024, 1024, 16, 8, 128, True, 256, 30.0, 0),
    (2, 1024, 1024, 16, 8, 128, True, None, 2.0, 0),
    (2, 1000, 1000, 16, 8, 128, True, 256, 2.0, 0),
]
PREFILL_SHAPE = (2, 1024)
# f32 on both sides, TF32 off: the prefills differ only in the kernels'
# summation orders (about 1e-7 relative per op), which many layers of random
# weights amplify: internlm2's 24 layers stay near 1e-5, zamba2's 38 Mamba2
# recurrences near 1e-3 on the O(10) SSM states, as two correct plain scan
# orders (ssd_chunked, ssd_naive) also do. A real fault moves the O(1)
# logits and states by O(1).
PREFILL_TOL = 1e-3
# bf16 prefills (phases 10 and 14): both passes round every weight, matmul
# output and activation to bf16. Where the kernel's f32 result and the plain
# version's fall on two sides of a bf16 rounding boundary the two differ by
# one ulp there, and the stack carries such flips on and grows them to the
# size of bf16's own rounding noise: a first hold, kernel-vs-plain at most
# the plain bf16 prefill's distance from the plain f32 one, failed on
# rwkv6-3b's logits at 1.135 times it (zamba2-1.2b: 0.904 and 0.857 on an
# H100). So each bf16 prefill is held against the f32 prefill of the same
# weights, the nearest thing to the exact result: the kernel's bf16 logits
# and scan states may lie at most BF16_PREFILL_RATIO times as far from the
# f32 ones as the plain version's bf16 ones do. Two bf16 passes that differ
# only by rounding lie about equally far: the kernels read 0.80-1.42 on an
# H100. Builds of the kernels with one phase left out
# (benchmarks/bench_port_scan_ablation.py --holds) read 5.4-66 in each
# output that the fault moves at all. Faults that leave the prefill within
# bf16's noise (a lost precision term; the SSD carry-in, which zamba2's fast
# random decays hide) are the kernel holds' to catch (phases 9 and 13), and
# they do. The RMS distances
# are logged beside (0.90-1.06 for the kernels) and not held.
BF16_PREFILL_RATIO = 2.0

HYBRID_ARCH = "zamba2-1.2b"
# (B, L, H, P, G, N, Q): tests/test_kernels.py::test_mamba2_ssd_kernel
SSD_CASES = [
    (2, 256, 4, 32, 1, 16, 64),
    (1, 128, 8, 64, 2, 32, 128),
    (2, 256, 4, 32, 4, 16, 64),
]
# The scan of one zamba2-1.2b Mamba2 layer at the serving batch: d_inner
# 4096 in 64 heads of P=64, one B/C group of N=64, chunk 128.
SSD_SERVING = (SERVE_BATCH, SERVE_PROMPT, 64, 64, 1, 64, 128)
# The JAX kernel test's tolerances: in f32 the kernel and ssd_chunked sum in
# other orders; in bf16 both round an f32 result to bf16, so they may differ
# by one bf16 ulp (2**-8 relative), inside the 1e-1 relative term.
SSD_TOL = {torch.float32: 1e-3, torch.bfloat16: 1e-1}
# zamba2-1.2b's shared attention block at the serving batch: MHA, hd 64.
FA_HYBRID = (SERVE_BATCH, SERVE_PROMPT, SERVE_PROMPT, 32, 32, 64, True,
             None, None, 0)
# The same off the tiles and with a window and a softcap, at hd 64.
FA_HYBRID_CASES = [
    (2, 1000, 1000, 32, 32, 64, True, None, None, 0),
    (8, 37, 37, 32, 32, 64, True, None, None, 0),
    (2, 1024, 1024, 32, 32, 64, True, 256, 50.0, 0),
    (2, 1024, 1024, 32, 32, 64, True, None, 2.0, 0),
    (2, 1000, 1000, 32, 32, 64, True, 256, 2.0, 0),
]

RWKV_ARCH = "rwkv6-3b"
# (B, L, H, K, V, Q, decay): log_w = -decay |normal|.
# tests/test_kernels.py::test_rwkv6_kernel, then the strong decay of
# ::test_rwkv6_chunked_ref_strong_decay_stable, whose (1,256,2,16,16) is
# widened to the kernel's smallest head size, 32.
WKV_CASES = [
    (2, 128, 4, 32, 32, 64, 2.0),
    (1, 128, 2, 64, 64, 32, 2.0),
    (1, 256, 2, 32, 32, 64, 11.9),
]
# One rwkv6-3b layer's scan at the serving batch: 40 heads of 64, chunk 64.
WKV_SERVING = (SERVE_BATCH, SERVE_PROMPT, 40, 64, 64, 64, 2.0)
# f32: the JAX kernel test's rtol = atol = 1e-4; kernel and wkv6_chunked
# differ in summation order and in forming the decays (per-step products
# against exp of cumsums). bf16 y: both compute in f32 from the same bf16
# inputs and round once to bf16, so they may differ by one bf16 ulp of the
# largest |y| (``bf16_ulp``); the f32 state keeps 1e-4.
WKV_TOL = 1e-4

MOE_ARCH = "llama4-scout-17b-a16e"
MOE_PREFILL_LAYERS = 4     # 38.6 GiB of f32 weights
MOE_SERVE_LAYERS = 12      # 50.3 GiB of bf16 weights
# (G, M, D, F): tests/test_kernels.py::test_gmm_kernel, then ragged row
# counts: reduced kimi-k2's 53 slots, one slot, and 8 (decode at B=8).
GMM_CASES = [(4, 128, 256, 512), (8, 64, 128, 128), (8, 53, 128, 64),
             (4, 1, 128, 64), (16, 8, 512, 256)]
# llama4-scout's products at the serving batch: capacity 256 slots per row
# in prefill (round(2048 / 16 * 1.25) = 160, rounded up to a multiple of
# 128), one in decode; rows = 8 batch rows x slots.
GMM_PREFILL = (16, SERVE_BATCH * 256, 5120, 8192)
GMM_PREFILL_DOWN = (16, SERVE_BATCH * 256, 8192, 5120)
GMM_DECODE = (16, SERVE_BATCH, 5120, 8192)
GMM_DECODE_DOWN = (16, SERVE_BATCH, 8192, 5120)
# f32: kernel and plain version differ only in summation order. bf16: both
# round an f32 sum of exact products once, so they may differ by one bf16
# ulp of the largest |out| (``bf16_ulp``).
GMM_TOL = 1e-4
# Two correct passes may route a token to different experts where its top
# two gates are this close (summation order moves a gate by ~1e-7).
ROUTE_MARGIN = 1e-5
# llama4-scout's prefill attention at the serving batch: GQA group 5.
FA_MOE = (SERVE_BATCH, SERVE_PROMPT, SERVE_PROMPT, 40, 8, 128, True, None,
          None, 0)
# Decode at batch 8 with top-1 routing leaves at least 8 of the 16 experts
# without a token; the gmm kernel skips them (``live``).
GMM_LIVE = 8
# Phase 18's decode step follows a prompt of this many tokens.
MOE_DECODE_PROMPT = 16

# The app's defaults (800 molecules, a retrain every 16 results, 200
# epochs) with the budget of 120 cut to 64, so that the script keeps its
# time limit: update-n still retrains 4 times.
CAMPAIGN = AppConfig(qc_budget=64)
# f32 on both sides: the card's and the CPU's retrain differ only in
# summation order, as the port and the JAX package do in the CPU tests (1e-5
# there at unit scale); held relative to each tensor's largest |value|.
TRAIN_TOL = 1e-5
RETRAIN_EPOCHS = 3
# Three Adam epochs carry the summation differences into the weights, but
# each step is at most lr = 5e-3 a weight: the last loss (~1) moves by far
# less than 1e-4.
LOSS_TOL = 1e-4
TIMED_EPOCHS = 10
POLICIES = ("random", "no-retrain", "update-n")

# Phase 23: the published widths cut to 2 layers, f32, on both devices.
TRAIN_CUT = 2
TRAIN_SHAPE = (2, 256)
TRAIN_STEPS = 3
# f32 moments of gradients near zero are noise on both devices; held to
# 5e-5 of each tensor's largest |value| (as the CPU tests hold the port to
# the JAX package), and 1e-5 relative elsewhere.
MOMENT_TOL = 5e-5
# Phase 24: the trainer at full width.
FULL_TRAIN = dict(batch=8, seq=2048, microbatches=2, steps_total=10, lr=3e-4)
# Phase 25: checkpoint at step CKPT_STEP of CKPT_STEPS.
CKPT_STEP, CKPT_STEPS = 2, 4
# The interrupted and the uninterrupted run repeat the same operations on
# the same data, but on the card a kernel that sums with atomics may sum in
# another order in each run: a weight may then differ by the two runs' Adam
# steps (|m_hat| / sqrt(v_hat) <= 1.01 over the first 4 steps at b1 0.9, b2
# 0.95, so at most 2.02 lr a step) plus one bf16 ulp of the weight a step,
# over all CKPT_STEPS steps.
RESUME_TOL_LR = 2.02


# Phases 26-31: the archs with gemma2's local/global stack, the enc-dec
# stack and M-RoPE.
GEMMA_ARCH = "gemma2-2b"
ENCDEC_ARCH = "seamless-m4t-medium"
VLM_ARCH = "qwen2-vl-72b"
# gemma2's f32 prefill: one prompt longer than the 4096 window, so the 13
# local layers mask in the kernel.
GEMMA_PREFILL_SHAPE = (1, 5120)
# One more gemma2 request: 2 prompts of 8192, so the window bites in the
# kernel's prefill and in the plain decode over the cache.
GEMMA_LONG = (2, 8192)
# seamless-m4t-medium: random frames (zero frames give zero cross K/V) of a
# length other than the prompt's, so cross-attention has Sq != Sk.
ENCDEC_PREFILL_FRAMES = 768
ENCDEC_SERVE_FRAMES = 1536
# qwen2-vl-72b: the f32 hold cut to 2 layers (17 GiB with the f32
# embeddings), serving cut to 24 of the 80 layers (42 GB of bf16 layers and
# 5 GB of embeddings; the published 80, ~144 GB, do not fit one card). The
# f32 prompt is an image of VLM_GRID patches, then text (``vl_positions``).
VLM_PREFILL_LAYERS = 2
VLM_SERVE_LAYERS = 24
VLM_GRID = (24, 32)
# The flash kernel at head dim 256 and at the cross shape, off the tiles:
# a window that starts inside a 64-key tile with gemma2's softcap and GQA
# 8/4 and a ragged last tile, a cap of 2 (which moves these scores by O(1)),
# a decode-like offset, the f32 prefill's 5120 past its 4096 window, and
# non-causal Sq != Sk at hd 64.
FA_NEW_CASES = [
    (2, 300, 300, 8, 4, 256, True, 100, 50.0, 0),
    (1, 200, 200, 8, 4, 256, True, 70, 2.0, 0),
    (1, 37, 333, 8, 4, 256, True, None, None, 296),
    (1, 5120, 5120, 8, 4, 256, True, 4096, 50.0, 0),
    (2, 300, 200, 16, 16, 64, False, None, None, 0),
    (2, 128, 384, 16, 16, 64, False, None, None, 0),
]
# The prefill attention of each arch at the serving batch, in bf16: gemma2's
# local layers (window 4096, softcap 50), seamless's cross-attention
# against 1536 frames and its encoder's self-attention over them, and
# qwen2-vl's GQA 64/8.
FA_GEMMA = (SERVE_BATCH, SERVE_PROMPT, SERVE_PROMPT, 8, 4, 256, True, 4096,
            50.0, 0)
FA_CROSS = (SERVE_BATCH, SERVE_PROMPT, ENCDEC_SERVE_FRAMES, 16, 16, 64, False,
            None, None, 0)
FA_ENC = (SERVE_BATCH, ENCDEC_SERVE_FRAMES, ENCDEC_SERVE_FRAMES, 16, 16, 64,
          False, None, None, 0)
FA_VLM = (SERVE_BATCH, SERVE_PROMPT, SERVE_PROMPT, 64, 8, 128, True, None,
          None, 0)

KIMI_ARCH = "kimi-k2-1t-a32b"
# One layer's 384 experts are 33.8 GB in bf16 (67.6 in f32): kimi-k2 runs as
# a one-layer cut, its weights drawn in bf16 on the card; its f32 hold is of
# layer 0's attention sub-layer alone, on its own weights.
KIMI_LAYERS = 1
KIMI_ATTN_SHAPE = (2, 1024)
KIMI_ATTN_TOL = 1e-4
# Head dim 112 (kimi-k2), which the binding zero-pads to the kernel's 128:
# the JAX kernel tests' six cases at hd 112, off the 128-row and 128-key
# tiles (Sq = Sk = 1000; Sq = 37), a window with a softcap of 2, a q_offset
# with Sk = 2 Sq, then kimi-k2's serving shape.
FA_HD112_CASES = [case[:5] + (112,) + case[6:] for case in FA_CASES] + [
    (2, 1000, 1000, 16, 8, 112, True, None, None, 0),
    (8, 37, 37, 64, 8, 112, True, None, None, 0),
    (2, 1000, 1000, 16, 8, 112, True, 256, 2.0, 0),
    (2, 512, 1024, 16, 8, 112, True, None, None, 128),
]
FA_KIMI = (SERVE_BATCH, SERVE_PROMPT, SERVE_PROMPT, 64, 8, 112, True, None,
           None, 0)
# A kimi-k2 decode step routes 8 tokens top-8: at most 64 of 384 experts live.
KIMI_DECODE_LIVE = 64

# Phases 36-37 run in a fresh interpreter (``--fabric``) that never touches
# CUDA: torch cannot initialise CUDA in a child forked from a process that
# has, and the fabric forks its broker, shard and workers (start method
# ``fork``, as in the JAX package). Each forked child initialises the card.
FABRIC_SEED = SEED + 47

# Phases 38-39: two ranks share the one card on a (1, 2) ("data", "model")
# mesh. NCCL refuses two ranks on one device, so they talk over gloo, and
# DTensor's collectives are staged through the host
# (``distributed/comm.py``): their times say nothing about an interconnect.
EP_MESH = (1, 2)
# kimi-k2's expert-parallel prefill at published widths cut to one layer:
# each rank draws its 192 of the 384 experts (16.9 GB in bf16).
EP_LAYERS = 1
# The f32 EP layer at reduced widths against the single-process dropping
# path at a capacity that drops nothing: they differ in summation order.
EP_REDUCED_SHAPE = (4, 64)
EP_F32_TOL = 1e-5
# Phase 39: the sharded train step (phase 23's cut: 2 layers, f32, B=2,
# S=256) in two modes, each step from the single-process state before it,
# held by phase 23's rule; metrics to 1e-6 relative.
SHARDED_MODES = ("dp_tp", "fsdp_tp")
SHARDED_METRIC_TOL = 1e-6
SHARDED_TRAIN_STEPS = 2
# Phase 41: the sharded prefill (B, S) and teacher-forced decode steps on the
# mesh, and the per-rank shapes of its kernels at tp = 2: internlm2's flash
# (8 of 16 heads, 4 of 8 KV heads) and zamba2's SSD (32 of 64 heads).
SHARDED_SERVE_ARCHS = (LM_ARCH, HYBRID_ARCH)
SHARDED_SERVE_SHAPE = (2, 2048)
SHARDED_SERVE_STEPS = 16
# The sharded decode program is also held in f32, where sharded and single
# process agree far inside bf16's noise: internlm2 cut to 2 layers, zamba2
# to 8 (a group of 6 Mamba2 layers, the shared attention block, a tail of
# 2), 4 decode steps, logits within 1e-4 of their scale (the CPU test's
# tolerance for zamba2's sharded programs).
SHARDED_F32_CUT = {LM_ARCH: 2, HYBRID_ARCH: 8}
SHARDED_F32_STEPS = 4
SHARDED_F32_TOL = 1e-4
SHARDED_FA_RANK = (2, 2048, 2048, 8, 4, 128, True, None, None, 0)
SHARDED_SSD_RANK = (2, 2048, 32, 64, 1, 64, 128)
# Phase 42: the dry run's cells on the single-pod mesh, as (arch, shape),
# one subprocess each, and the seconds phase 42 waits for them.
DRY_RUN_CELLS = (("kimi-k2-1t-a32b", "train_4k"),
                 ("internlm2-1.8b", "train_4k"),
                 ("kimi-k2-1t-a32b", "decode_32k"),
                 ("internlm2-1.8b", "decode_32k"),
                 ("zamba2-1.2b", "long_500k"))
DRY_RUN_TIMEOUT = 600
ROOT = os.path.dirname(os.path.abspath(__file__))
# Phase 40: the trainer at published widths on gemma2-2b (8 x 2048 a step;
# a microbatch of 2 x 2048 has 4.2 GB of f32 logits at vocab 256,000) and
# on qwen2-vl-72b cut to one layer (its 2.5 G embedding parameters alone
# take 40 GB of bf16 weights, f32 moments and f32 gradient sums).
GEMMA_TRAIN = dict(batch=8, seq=2048, microbatches=4, steps_total=10,
                   lr=3e-4)
VLM_TRAIN = dict(batch=8, seq=2048, microbatches=8, steps_total=6, lr=3e-4,
                 num_layers=1)
FABRIC_TIMEOUT = 480          # seconds for the whole fabric interpreter
FABRIC_GET_TIMEOUT = 240      # seconds for one request's results
RESCORE_TOPIC = "rescore"
RESCORE_TASKS = 2
SCORE_RTOL = 1e-6
NEAR_TIE = 1e-3               # top-2 logit gap below which tokens may differ
BROKER_PINGS = 500
SYNAPP = dict(T=100, D=0.005, I=1 << 16, N=4, vs_shards=2,
              score_candidates=3, inference_shards=1)


T0 = time.perf_counter()


def log(msg: str) -> None:
    """Print ``msg``; a phase's first line carries the script's seconds so
    far, so that each phase's seconds can be read off the log."""
    if msg.startswith("phase "):
        msg = f"[{time.perf_counter() - T0:.1f} s] {msg}"
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke FAILED: {what}")


def median_ms(fn, reps: int = 10, warmup: int = 2, inner: int = 10) -> float:
    """Median device time of one call of fn, from CUDA events around
    ``inner`` calls in a row (so that the host work of a binding overlaps
    the previous call's kernel instead of sitting inside the events)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return float(np.median(times))


def ptxas_summary(name: str) -> list[str]:
    """Each kernel of library ``name`` with its registers and spills, from
    the ``ptxas -v`` report of its build. A kernel that rebalances registers
    with setmaxnreg shows its launch count here."""
    out, spills = [], ""
    for line in _build.ptxas_report(name).splitlines():
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spills = f"spills {m.group(1)}/{m.group(2)} bytes stored/loaded"
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.append(f"{m.group(1)} registers, {spills}")
        m = re.search(r"entry function '\w*?\d((?:flash|gmm|ssd|wkv6)_\w*?kernel)"
                      r"((?:I?Li\d+E)*)", line)
        if m:
            args = re.findall(r"Li(\d+)E", m.group(2))
            out.append(m.group(1) + (f"<{','.join(args)}>" if args else ""))
    return [f"{k}: {r}" for k, r in zip(out[::2], out[1::2])]


def kernel_inputs(B, N, Hd, dtype, gen):
    h = torch.randn(B, N, Hd, generator=gen, device=DEV, dtype=dtype)
    e = torch.randn(B, N, N, Hd, Hd, generator=gen, device=DEV, dtype=dtype)
    e.mul_(0.1)
    adj = (torch.rand(B, N, N, generator=gen, device=DEV) > 0.5).float()
    return h, e, adj


def hold_kernel(h, e, adj) -> float:
    """Kernel against the plain version on the same inputs; max abs error."""
    got = ops.message_pass(h, e, adj, impl="kernel")
    want = message_pass_reference(h, e, adj)
    torch.cuda.synchronize()
    check(got.dtype == h.dtype and got.shape == h.shape,
          f"mpnn_mp output {got.dtype} {tuple(got.shape)}")
    rtol, atol = TOLERANCE[h.dtype]
    err = (got.float() - want.float()).abs().max().item()
    check(torch.allclose(got.float(), want.float(), rtol=rtol, atol=atol),
          f"mpnn_mp {tuple(h.shape)} {h.dtype}: max abs err {err}")
    log(f"  mpnn_mp {tuple(h.shape)} {str(h.dtype):14s} max abs err {err:.3e}"
        f" (rtol {rtol:.2e}, atol {atol:.0e})")
    return err


def phase_kernels(chunk_batch: int) -> dict:
    log("phase 1: build and hold kernels")
    t0 = time.perf_counter()
    mpnn_mp.library()
    log(f"  mpnn_mp built in {time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    shape = (chunk_batch, SPACE.max_atoms, CONFIG.hidden)
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        for s in TEST_SHAPES + [shape]:
            errs[s, dtype] = hold_kernel(*kernel_inputs(*s, dtype, gen))
    return {"max_abs_err": errs[shape, torch.float32],
            "max_abs_err_bf16": errs[shape, torch.bfloat16]}


def phase_surrogate(sur: Surrogate, feats: dict) -> None:
    """The kernel forward on the main path's first chunk of the space (the
    typed rule's, the whole space at full width) against the plain forward
    over the same molecules in the plain path's chunks."""
    log("phase 2: full-width surrogate, kernel forward against plain forward")
    n = min(sur.chunk_size(SPACE.max_atoms, "kernel"), SPACE.num_molecules)
    plain = sur.chunk_size(SPACE.max_atoms, "ref")
    x = [torch.as_tensor(feats[k][:n], device=DEV) for k in FEATURES]
    with torch.inference_mode():
        got = sur.model(*x, impl="kernel")
        want = torch.cat([sur.model(*(t[s:s + plain] for t in x), impl="ref")
                          for s in range(0, n, plain)], dim=1)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    check(got.shape == (CONFIG.ensemble, n), f"forward shape {tuple(got.shape)}")
    check(bool(torch.isfinite(got).all()), "non-finite predictions")
    check(torch.allclose(got, want, rtol=1e-4, atol=1e-4),
          f"kernel forward vs plain forward: max abs err {err}")
    log(f"  E={CONFIG.ensemble} hidden={CONFIG.hidden}: {n} molecules in one "
        f"kernel forward against {math.ceil(n / plain)} plain forwards of "
        f"{plain}: max abs err {err:.3e} (rtol 1e-4, atol 1e-4)")


def perturb(model: torch.nn.Module, gen: torch.Generator) -> None:
    """Move every weight a little, as a retrain would."""
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.randn(p.shape, generator=gen, device=p.device), alpha=0.01)


def phase_serve(sur: Surrogate, feats: dict) -> dict:
    log(f"phase 3: serve {REQUESTS} re-score requests over "
        f"{SPACE.num_molecules} molecules")
    gen = torch.Generator(device=DEV).manual_seed(SEED + 1)
    n = SPACE.num_molecules
    torch.cuda.reset_peak_memory_stats()
    previous = None
    mpnn_mp.LAUNCHES = 0
    for r in range(REQUESTS):
        if r:
            perturb(sur.model, gen)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scores, order = rank_space(sur, feats, KAPPA)
        wall = time.perf_counter() - t0
        finite = bool(np.isfinite(scores).all())
        check(scores.shape == (n,) and finite, f"request {r}: scores "
              f"{scores.shape}, finite={finite}")
        check(np.array_equal(np.sort(order), np.arange(n)),
              f"request {r}: order is not a permutation")
        check(previous is None or not np.array_equal(scores, previous),
              f"request {r}: scores did not change after the update")
        previous = scores
        log(f"  request {r}: {wall * 1e3:.1f} ms wall, top-10 "
            f"{order[:10].tolist()}, all {n} scores finite")
    launches = mpnn_mp.LAUNCHES
    per_request = CONFIG.message_steps * math.ceil(
        n / sur.chunk_size(SPACE.max_atoms, "kernel"))
    log(f"  mpnn_mp launches {launches} ({per_request} per re-score); peak "
        f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    check(launches == REQUESTS * per_request,
          f"mpnn_mp launched {launches} times, expected {REQUESTS * per_request}")
    return {"launches": launches, "launches_per_rescore": per_request}


def phase_report(chunk_batch: int) -> dict:
    log("phase 4: time mpnn_mp at the plain path's chunk shape (f32)")
    gen = torch.Generator(device=DEV).manual_seed(SEED + 2)
    h, e, adj = kernel_inputs(chunk_batch, SPACE.max_atoms, CONFIG.hidden,
                              torch.float32, gen)
    ms = median_ms(lambda: ops.message_pass(h, e, adj, impl="kernel"))
    plain_ms = median_ms(lambda: message_pass_reference(h, e, adj))
    library_ms = median_ms(lambda: torch.einsum("bijkl,bjl,bij->bik", e, h, adj))
    B, N, Hd = h.shape
    moved = sum(t.numel() * t.element_size() for t in (h, e, adj, h))
    flops = 2 * B * N * N * Hd * Hd
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    flops_ms = flops / F32_FLOP_PER_S * 1e3
    log(f"  kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, torch.einsum "
        f"{library_ms:.3f} ms; bound {max(bytes_ms, flops_ms):.3f} ms "
        f"({moved / 2**30:.2f} GiB moved, {flops / 1e9:.2f} GFLOP)")
    return {"ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, flops_ms),
            "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
            "library_ms": library_ms, "shape": [B, N, Hd], "dtype": "float32"}


def phase_typed_report(dense_chunk: int, chunk: int, feats: dict) -> dict:
    """The typed entry on the space's first molecules (real bonds and
    masks). On the first ``dense_chunk`` (the plain path's chunk) it is held
    against the dense kernel on the edge tensor built from the same bonds
    and edge_w. On the first ``chunk`` (the typed path's, the shape the
    re-score gives it) it is held against its plain version, which builds no
    edge tensor either, and timed beside it."""
    log(f"phase 4b: the typed mpnn_mp entry at the typed path's chunk of "
        f"{chunk} molecules and against the dense kernel at {dense_chunk}, "
        f"real bonds (f32)")
    gen = torch.Generator(device=DEV).manual_seed(SEED + 3)
    E, Hd, nb = CONFIG.ensemble, CONFIG.hidden, CONFIG.num_bond_types
    bonds, mask = (torch.as_tensor(feats[k][:chunk], device=DEV)
                   for k in ("bonds", "mask"))
    B, N = mask.shape
    adj = (bonds > 0).float() * mask[:, :, None] * mask[:, None, :]
    h4 = torch.randn(E, B, N, Hd, generator=gen, device=DEV) * mask[..., None]
    h = h4.reshape(E * B, N, Hd)
    w = 0.05 * torch.randn(E, nb, Hd * Hd, generator=gen, device=DEV)
    errs = {}

    b = dense_chunk
    hb = h4[:, :b].reshape(E * b, N, Hd)
    got = ops.message_pass_typed(hb, bonds[:b], w, adj[:b], impl="kernel")
    edge = torch.matmul(torch.nn.functional.one_hot(bonds[:b].long(), nb)
                        .float().reshape(1, b * N * N, nb), w)
    dense = ops.message_pass(hb, edge.reshape(E * b, N, N, Hd, Hd),
                             adj[:b].expand(E, b, N, N).reshape(E * b, N, N),
                             impl="kernel")
    del edge
    errs["dense kernel"] = (got - dense).abs().max().item()
    check(torch.allclose(got, dense, rtol=1e-5, atol=1e-5),
          f"typed mpnn_mp vs dense kernel at {b} molecules: max abs err "
          f"{errs['dense kernel']}")
    del got, dense, hb

    got = ops.message_pass_typed(h, bonds, w, adj, impl="kernel")
    plain = message_pass_typed_reference(h, bonds, w, adj)
    torch.cuda.synchronize()
    errs["plain"] = (got - plain).abs().max().item()
    check(torch.allclose(got, plain, rtol=1e-5, atol=1e-5),
          f"typed mpnn_mp vs plain at {B} molecules: max abs err "
          f"{errs['plain']}")
    del got, plain
    ms = median_ms(lambda: ops.message_pass_typed(h, bonds, w, adj,
                                                   impl="kernel"))
    plain_ms = median_ms(lambda: message_pass_typed_reference(h, bonds, w, adj))
    # the bound of portbench/metrics/mpnn_mp_roofline.py for one step
    pairs = float(adj.sum())
    moved = (2 * h.numel() * 4 + bonds.numel() * bonds.element_size()
             + w.numel() * 4 + adj.numel() * 4)
    flops = 2.0 * Hd * Hd * E * pairs
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    flops_ms = flops / F32_FLOP_PER_S * 1e3
    log(f"  max abs err {errs['plain']:.3e} against the plain version at "
        f"{B} molecules, {errs['dense kernel']:.3e} against the dense kernel "
        f"at {b} (rtol 1e-5, atol 1e-5); {int(pairs)} adjacent pairs "
        f"({pairs / adj.numel():.4f})")
    log(f"  kernel {ms:.4f} ms, plain {plain_ms:.3f} ms; bound "
        f"{max(bytes_ms, flops_ms):.4f} ms ({flops / 1e9:.3f} GFLOP, "
        f"{moved / 2**20:.2f} MiB): {100 * max(bytes_ms, flops_ms) / ms:.1f}%")
    return {"ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, flops_ms),
            "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
            "max_abs_err": errs["plain"],
            "max_abs_err_dense": errs["dense kernel"], "dense_molecules": b,
            "shape": [E, B, N, Hd, nb], "dtype": "float32"}


def fa_inputs(case, dtype, gen):
    B, Sq, Sk, H, KVH, hd = case[:6]
    q = torch.randn(B, Sq, H, hd, generator=gen, device=DEV, dtype=dtype)
    k = torch.randn(B, Sk, KVH, hd, generator=gen, device=DEV, dtype=dtype)
    v = torch.randn(B, Sk, KVH, hd, generator=gen, device=DEV, dtype=dtype)
    causal, window, softcap, q_offset = case[6:]
    return (q, k, v), dict(causal=causal, window=window, softcap=softcap,
                           q_offset=q_offset)


def hold_flash(case, dtype, gen) -> float:
    """Kernel against the plain version on the same inputs; max abs error."""
    (q, k, v), kw = fa_inputs(case, dtype, gen)
    got = fa_ops.attention(q, k, v, impl="kernel", **kw)
    want = attention_reference(q, k, v, **kw)
    torch.cuda.synchronize()
    check(got.dtype == q.dtype and got.shape == q.shape,
          f"flash_attention output {got.dtype} {tuple(got.shape)}")
    tol = FA_TOL[dtype]
    err = (got.float() - want.float()).abs().max().item()
    check(torch.allclose(got.float(), want.float(), rtol=tol, atol=tol),
          f"flash_attention {case} {dtype}: max abs err {err}")
    log(f"  flash_attention {case[:6]} {kw} {str(dtype):14s} max abs err "
        f"{err:.3e} (rtol = atol = {tol:.0e})")
    return err


def phase_flash_kernels() -> dict:
    log("phase 5: hold flash_attention against its plain version")
    gen = torch.Generator(device=DEV).manual_seed(SEED + 3)
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        for case in FA_CASES:
            errs[case, dtype] = hold_flash(case, dtype, gen)
    errs[FA_SERVING] = hold_flash(FA_SERVING, torch.bfloat16, gen)
    for case in FA_BF16_CASES:
        hold_flash(case, torch.bfloat16, gen)
    return {"max_abs_err": errs[FA_SERVING]}


def lm_tokens(rng, batch, seq, vocab):
    return rng.integers(0, vocab, size=(batch, seq), dtype=np.int32)


def phase_lm_prefill() -> None:
    log(f"phase 6: full-width {LM_ARCH} in f32, prefill through the kernel "
        "against prefill through the plain attention")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(LM_ARCH).replace(param_dtype="float32",
                                      compute_dtype="float32",
                                      attn_impl="kernel")
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEV).manual_seed(SEED + 4)
    params = lm_api.init_params(cfg, gen, device=DEV)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in _leaves(params))
    log(f"  {cfg.num_layers} layers, d_model {cfg.d_model}, {cfg.num_heads} "
        f"heads / {cfg.num_kv_heads} KV heads of {cfg.resolved_head_dim}, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}: {n / 1e9:.3f} G "
        f"parameters drawn on the card in {time.perf_counter() - t0:.1f} s")
    B, S = PREFILL_SHAPE
    tokens = torch.as_tensor(
        lm_tokens(np.random.default_rng(SEED), B, S, cfg.vocab_size),
        device=DEV)
    with torch.inference_mode():
        got, got_cache = lm_api.prefill(params, cfg, {"tokens": tokens})
        want, want_cache = lm_api.prefill(
            params, cfg.replace(attn_impl="ref"), {"tokens": tokens})
    torch.cuda.synchronize()
    hold_prefill(B, S, cfg, got, want, got_cache, want_cache)


def _take_rows(tree, rows):
    return {k: _take_rows(v, rows) if isinstance(v, dict) else v[:, rows]
            for k, v in tree.items()}


def hold_prefill(B, S, cfg, got, want, got_cache, want_cache,
                 rows=None, stage: str = "prefill") -> None:
    """Kernel prefill against plain prefill: logits and every cache leaf
    (every leaf is (layers, batch, ...)), of the batch rows ``rows`` only
    if given."""
    check(got.shape == (B, cfg.vocab_size) and bool(torch.isfinite(got).all()),
          f"{stage} logits {tuple(got.shape)} not finite or misshapen")
    if rows is not None:
        got, want = got[rows], want[rows]
        got_cache = _take_rows(got_cache, rows)
        want_cache = _take_rows(want_cache, rows)
    for what, a, b in (("logits", got, want),
                       *((f"cache {path}", a, b) for (path, a), (_, b) in
                         zip(_named_leaves(got_cache),
                             _named_leaves(want_cache)))):
        err = (a.float() - b.float()).abs().max().item()
        check(torch.allclose(a.float(), b.float(), rtol=PREFILL_TOL,
                             atol=PREFILL_TOL),
              f"f32 {stage} {what}: kernel vs plain max abs err {err}")
        log(f"  B={B} S={S} {what} {tuple(a.shape)}: kernel vs plain max abs "
            f"err {err:.3e} (rtol = atol = {PREFILL_TOL:.0e})")


def hold_bf16_prefill(params, cfg, tokens, f32_logits, f32_cache,
                      state, counters) -> dict:
    """The f32 weights ``params`` cast to bf16: prefill through the kernels
    and prefill through the plain versions, the logits and every cache leaf
    named ``state`` (a name or a tuple of names) of each held against the
    plain f32 prefill (``f32_logits``, ``f32_cache``) by BF16_PREFILL_RATIO.
    ``counters`` maps a kernel module to the design its bf16 launches must
    report; each must run once a layer in the kernel pass and never in the
    plain one."""
    names = (state,) if isinstance(state, str) else state
    cfg16 = cfg.replace(param_dtype="bfloat16", compute_dtype="bfloat16")
    p16 = _cast_tree(params, torch.bfloat16)
    before = {m: dict(m.LAUNCHES_BY_DESIGN) for m in counters}
    with torch.inference_mode():
        got, got_cache = lm_api.prefill(p16, cfg16, {"tokens": tokens})
        mid = {m: dict(m.LAUNCHES_BY_DESIGN) for m in counters}
        want, want_cache = lm_api.prefill(
            p16, cfg16.replace(attn_impl="ref"), {"tokens": tokens})
    torch.cuda.synchronize()
    del p16
    for m, design in counters.items():
        ran = {d: mid[m][d] - before[m][d] for d in m.DESIGNS}
        check(ran == {d: cfg.num_layers * (d == design) for d in m.DESIGNS}
              and m.LAUNCHES_BY_DESIGN == mid[m],
              f"bf16 prefill launches of {m.__name__}: {ran}, plain pass "
              f"{ {d: m.LAUNCHES_BY_DESIGN[d] - mid[m][d] for d in m.DESIGNS} }")
    check(bool(torch.isfinite(got).all()), "bf16 prefill logits not finite")
    pairs = [("logits", got, want, f32_logits)] + [
        (path, a, b, c) for (path, a), (_, b), (_, c) in
        zip(_named_leaves(got_cache), _named_leaves(want_cache),
            _named_leaves(f32_cache))
        if path.endswith(tuple("/" + n for n in names))]
    out = {}
    for what, a, b, c in pairs:
        a, b, c = a.double(), b.double(), c.double()
        out[what] = {
            "finite": bool(torch.isfinite(a).all()),
            "max_abs_err": (a - b).abs().max().item(),
            "kernel_vs_f32": (a - c).abs().max().item(),
            "plain_vs_f32": (b - c).abs().max().item(),
            "kernel_vs_f32_rms": (a - c).square().mean().sqrt().item(),
            "plain_vs_f32_rms": (b - c).square().mean().sqrt().item()}
        e = out[what]
        log(f"  bf16 B={tokens.shape[0]} S={tokens.shape[1]} {what} "
            f"{tuple(a.shape)}: kernel vs plain max abs err "
            f"{e['max_abs_err']:.3e}; from the f32 prefill, max abs: kernel "
            f"{e['kernel_vs_f32']:.3e}, plain {e['plain_vs_f32']:.3e} (ratio "
            f"{e['kernel_vs_f32'] / e['plain_vs_f32']:.3f}, limit "
            f"{BF16_PREFILL_RATIO}); rms: kernel {e['kernel_vs_f32_rms']:.3e}, "
            f"plain {e['plain_vs_f32_rms']:.3e} (ratio "
            f"{e['kernel_vs_f32_rms'] / e['plain_vs_f32_rms']:.3f})")
    for what, e in out.items():
        check(e["finite"]
              and e["kernel_vs_f32"] <= BF16_PREFILL_RATIO * e["plain_vs_f32"],
              f"bf16 prefill {what}: kernel {e['kernel_vs_f32']} from f32, "
              f"plain {e['plain_vs_f32']}")
    return out


def _cast_tree(tree, dtype):
    return {k: _cast_tree(v, dtype) if isinstance(v, dict)
            else v.to(dtype) if v.is_floating_point() else v
            for k, v in tree.items()}


def _named_leaves(tree, path=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _named_leaves(v, f"{path}/{k}")
        else:
            yield f"{path}/{k}", v


def _leaves(tree):
    for _, v in _named_leaves(tree):
        yield v


def phase_lm_serve() -> dict:
    cfg = get_config(LM_ARCH).replace(attn_impl="kernel")
    return serve(7, cfg, SEED + 5,
                 {"flash_attention": (flash_attention, cfg.num_layers)})


def serve(phase: int, cfg, seed: int, kernels: dict, *,
          requests: int = SERVE_REQUESTS, batch: int = SERVE_BATCH,
          prompt: int = SERVE_PROMPT, params=None, frames_len=None) -> dict:
    """Answer ``requests`` requests of ``batch`` x ``prompt`` tokens through
    ``Engine``. ``kernels`` maps a kernel's name to (its module, launches
    per request); every count is set to 0 just before the requests and must
    read requests x per request just after them. ``params``, if given, are
    served instead of weights drawn from ``seed``. ``frames_len``: an
    enc-dec model's encoder reads seeded random frames of this many
    positions. What an earlier phase left to the cyclic collector must be
    under GC_FREED_MAX: the port's objects free their tensors by reference
    counting."""
    log(f"phase {phase}: serve {requests} request(s) of {batch} x {prompt} "
        f"tokens, {SERVE_MAX_NEW} new, {cfg.name} in bf16")
    if params is None:
        gen = torch.Generator(device=DEV).manual_seed(seed)
        params = lm_api.init_params(cfg, gen, device=DEV)
    engine = Engine(cfg, params, max_new=SERVE_MAX_NEW)
    rng = np.random.default_rng(seed)
    times = {"prefill": [], "decode": []}
    bad_logits = torch.zeros((), dtype=torch.long, device=DEV)

    def timed(name, fn):
        def run(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)     # returns host tokens: the device is done
            times[name].append(time.perf_counter() - t0)
            return out
        return run

    def finite(fn):
        def run(*args, **kw):
            logits, cache = fn(*args, **kw)
            bad_logits.add_((~torch.isfinite(logits)).sum())
            return logits, cache
        return run

    engine.prefill_batch = timed("prefill", engine.prefill_batch)
    engine.decode_batch = timed("decode", engine.decode_batch)
    plain = lm_api.prefill, lm_api.decode_step
    lm_api.prefill, lm_api.decode_step = finite(plain[0]), finite(plain[1])
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    gc.collect()
    freed = resident - torch.cuda.memory_allocated()
    weights = sum(t.numel() * t.element_size() for t in _leaves(params))
    log(f"  device memory before the requests {resident / 2**30:.2f} GiB "
        f"(weights {weights / 2**30:.2f} GiB); gc.collect() freed "
        f"{freed / 2**20:.1f} MiB")
    check(freed < GC_FREED_MAX, f"{freed / 2**20:.1f} MiB of device memory "
          "was held only by reference cycles")
    torch.cuda.reset_peak_memory_stats()
    for module, _ in kernels.values():
        module.LAUNCHES = 0
        if hasattr(module, "LAUNCHES_BY_DESIGN"):
            module.LAUNCHES_BY_DESIGN = dict.fromkeys(module.DESIGNS, 0)
    timing = {"prefill_ms": [], "decode_ms_per_step": []}
    try:
        for r in range(requests):
            times["prefill"].clear()
            times["decode"].clear()
            prompts = lm_tokens(rng, batch, prompt, cfg.vocab_size)
            frames = None
            if frames_len is not None:
                frames = rng.standard_normal(
                    (batch, frames_len, cfg.d_model)).astype(np.float32)
            t0 = time.perf_counter()
            out = engine.generate(prompts, frames=frames)
            wall = time.perf_counter() - t0
            check(out.shape == (batch, prompt + SERVE_MAX_NEW),
                  f"request {r}: output {out.shape}")
            check(np.array_equal(out[:, :prompt], prompts),
                  f"request {r}: prompts not echoed")
            new = out[:, prompt:]
            check(bool(((new >= 0) & (new < cfg.vocab_size)).all()),
                  f"request {r}: token outside the vocabulary")
            if r == 0:
                warm_ns = time.perf_counter_ns()    # warm calls after it
            log(f"  request {r}: prefill {times['prefill'][0] * 1e3:.1f} ms, "
                f"decode {np.mean(times['decode']) * 1e3:.2f} ms/step over "
                f"{len(times['decode'])} steps, wall {wall * 1e3:.1f} ms; "
                f"row 0 tail {new[0, -6:].tolist()}")
            timing["prefill_ms"].append(times["prefill"][0] * 1e3)
            timing["decode_ms_per_step"].append(
                float(np.mean(times["decode"])) * 1e3)
    finally:
        lm_api.prefill, lm_api.decode_step = plain
        # the wrappers hold the engine's bound methods: a cycle through it
        del engine.prefill_batch, engine.decode_batch
    launches = {name: module.LAUNCHES for name, (module, _) in kernels.items()}
    check(bad_logits.item() == 0, f"{bad_logits.item()} non-finite logits")
    log(f"  all logits finite; launches " + ", ".join(
            f"{name} {launches[name]} ({per} per request)"
            for name, (_, per) in kernels.items())
        + f"; steady-state {engine_tokens_per_s(warm_ns):.1f} tok/s over "
        f"{requests - 1} warm requests; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for name, (_, per) in kernels.items():
        check(launches[name] == requests * per,
              f"{name} launched {launches[name]} times, expected "
              f"{requests * per}")
    out = {name: {"launches": launches[name], "launches_per_request": per}
           for name, (_, per) in kernels.items()}
    out["timing"] = {**timing, "tok_s": engine_tokens_per_s(warm_ns)}
    for name, (module, _) in kernels.items():
        if hasattr(module, "LAUNCHES_BY_DESIGN"):
            out[name]["launches_by_design"] = dict(module.LAUNCHES_BY_DESIGN)
            log(f"  {name} launches by kernel: {module.LAUNCHES_BY_DESIGN}")
    return out


def live_pairs(Sq, Sk, causal, window, q_offset) -> int:
    """(query, key) pairs the mask keeps: the work the attention must do."""
    qpos = np.arange(Sq, dtype=np.int64) + q_offset
    hi = np.minimum(qpos + 1, Sk) if causal else np.full(Sq, Sk)
    lo = np.maximum(qpos - window + 1, 0) if window else np.zeros(Sq, np.int64)
    return int(np.maximum(hi - lo, 0).sum())


def phase_flash_report() -> dict:
    log("phase 8: time flash_attention at the serving shape (bf16)")
    return time_flash(FA_SERVING, SEED + 6)


def flex_call(qt, kt, vt, kw):
    """One compiled ``flex_attention`` call computing the kernel's function
    on (B, H, S, hd) inputs where SDPA cannot: the tanh softcap as a score
    mod, the causal mask and look-back window as a block mask."""
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)
    cap, window, causal = kw["softcap"], kw["window"], kw["causal"]

    def score_mod(score, b, h, qi, ki):
        return score if cap is None else cap * torch.tanh(score / cap)

    def mask_mod(b, h, qi, ki):
        keep = qi >= ki if causal else ki >= 0
        return keep if window is None else keep & (qi - ki < window)

    mask = create_block_mask(mask_mod, None, None, qt.shape[2], kt.shape[2],
                             device=qt.device)
    flex = torch.compile(flex_attention, dynamic=False)
    return lambda: flex(qt, kt, vt, score_mod=score_mod, block_mask=mask,
                        enable_gqa=True)


def time_flash(case, seed: int) -> dict:
    """Kernel, plain version and the library call at ``case`` in bf16,
    beside the bound. The library call is SDPA where it computes the same
    function; SDPA has no logit softcap and no look-back window, so at a
    case with either it is ``flex_attention`` (compiled, held against the
    plain version first) and SDPA's time without them is logged as a note."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    (q, k, v), kw = fa_inputs(case, torch.bfloat16, gen)
    ms = median_ms(lambda: fa_ops.attention(q, k, v, impl="kernel", **kw))
    plain_ms = median_ms(lambda: attention_reference(q, k, v, **kw))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    check(kw["q_offset"] == 0, "SDPA's causal mask has no query offset")
    sdpa_ms = median_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=kw["causal"], enable_gqa=True))
    exact = kw["softcap"] is None and kw["window"] is None
    library_ms, library = sdpa_ms, "scaled_dot_product_attention"
    if not exact:
        flex = flex_call(qt, kt, vt, kw)
        err = (flex().transpose(1, 2).float()
               - attention_reference(q, k, v, **kw).float()).abs().max().item()
        check(err <= FA_TOL[torch.bfloat16],
              f"flex_attention against the plain version: {err}")
        library_ms, library = median_ms(flex), "flex_attention"
        log(f"  flex_attention (softcap score mod, causal + window block "
            f"mask, compiled) vs plain max abs err {err:.3e}")
    B, Sq, H, hd = q.shape
    moved = sum(t.numel() * t.element_size() for t in (q, k, v, q))
    flops = 4 * hd * B * H * live_pairs(Sq, k.shape[1], kw["causal"],
                                        kw["window"], kw["q_offset"])
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    flops_ms = flops / BF16_FLOP_PER_S * 1e3
    lib = f"{library} {library_ms:.3f} ms ({flops / library_ms / 1e9:.1f} TFLOP/s)"
    if not exact:
        lib += f"; note: SDPA without the softcap and window {sdpa_ms:.3f} ms"
    log(f"  {case[:6]} {kw}: kernel {ms:.3f} ms ({flops / ms / 1e9:.1f} "
        f"TFLOP/s), plain {plain_ms:.3f} ms, {lib}; bound "
        f"{max(bytes_ms, flops_ms):.3f} ms ({flops / 1e9:.1f} GFLOP at "
        f"{BF16_FLOP_PER_S / 1e12:.0f} TFLOP/s = {flops_ms:.3f} ms; "
        f"{moved / 2**20:.0f} MiB at {HBM_BYTES_PER_S / 1e12:.2f} TB/s = "
        f"{bytes_ms:.3f} ms)")
    return {"ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, flops_ms),
            "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
            "library_ms": library_ms, "library": library,
            "shape": list(case[:6]), "dtype": "bfloat16",
            "tflops": flops / ms / 1e9,
            **({} if exact else {"sdpa_without_cap_or_window_ms": sdpa_ms})}


def ssd_inputs(case, dtype, gen, la_dtype=torch.float32):
    """x, b, c in ``dtype``; log_a = -0.3|normal| (as the JAX kernel test
    draws it) in ``la_dtype``; a random f32 initial state."""
    B, L, H, P, G, N, _ = case
    x = torch.randn(B, L, H, P, generator=gen, device=DEV, dtype=dtype)
    la = (torch.randn(B, L, H, generator=gen, device=DEV).abs_()
          .mul_(-0.3).to(la_dtype))
    b = torch.randn(B, L, G, N, generator=gen, device=DEV, dtype=dtype)
    c = torch.randn(B, L, G, N, generator=gen, device=DEV, dtype=dtype)
    s0 = torch.randn(B, H, P, N, generator=gen, device=DEV)
    return x, la, b, c, s0


def hold_ssd(case, dtype, gen, la_dtype=torch.float32) -> float:
    """Kernel against ssd_chunked on the same inputs; max abs error of y and
    of the final state."""
    x, la, b, c, s0 = ssd_inputs(case, dtype, gen, la_dtype)
    Q = case[-1]
    y, s = ssd_ops.ssd(x, la, b, c, s0, impl="kernel", chunk=Q)
    y_want, s_want = ssd_chunked(x, la, b, c, s0, chunk=Q)
    torch.cuda.synchronize()
    check(y.dtype == x.dtype and y.shape == x.shape and s.dtype == torch.float32
          and s.shape == s0.shape,
          f"mamba2_ssd outputs {y.dtype} {tuple(y.shape)}, {s.dtype} "
          f"{tuple(s.shape)}")
    tol = SSD_TOL[dtype]
    errs = []
    for what, a, b_ in (("y", y, y_want), ("state", s, s_want)):
        err = (a.float() - b_.float()).abs().max().item()
        check(torch.allclose(a.float(), b_.float(), rtol=tol, atol=tol),
              f"mamba2_ssd {case} {dtype} {what}: max abs err {err}")
        errs.append(err)
    log(f"  mamba2_ssd {case} {str(dtype):14s} log_a {str(la_dtype):14s} max "
        f"abs err y {errs[0]:.3e} (max |y| {y_want.float().abs().max().item():.1f}),"
        f" state {errs[1]:.3e} (rtol = atol = {tol:.0e})")
    return max(errs)


def phase_ssd_kernels() -> dict:
    log("phase 9: hold mamba2_ssd against ssd_chunked, and flash_attention at "
        f"{HYBRID_ARCH}'s attention shape")
    gen = torch.Generator(device=DEV).manual_seed(SEED + 7)
    for dtype in (torch.float32, torch.bfloat16):
        for case in SSD_CASES:
            hold_ssd(case, dtype, gen)
    err = hold_ssd(SSD_SERVING, torch.bfloat16, gen, la_dtype=torch.bfloat16)
    flash_err = hold_flash(FA_HYBRID, torch.bfloat16, gen)
    for case in FA_HYBRID_CASES:
        hold_flash(case, torch.bfloat16, gen)
    return {"max_abs_err": err}, flash_err


def phase_hybrid_prefill() -> dict:
    log(f"phase 10: full-width {HYBRID_ARCH} in f32, then bf16, prefill "
        "through both kernels against prefill through both plain versions")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(HYBRID_ARCH).replace(param_dtype="float32",
                                          compute_dtype="float32",
                                          attn_impl="kernel")
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEV).manual_seed(SEED + 8)
    params = lm_api.init_params(cfg, gen, device=DEV)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in _leaves(params))
    log(f"  {cfg.num_layers} Mamba2 layers (shared attention after every "
        f"{cfg.attn_every}), d_model {cfg.d_model}, {cfg.num_heads} heads of "
        f"{cfg.resolved_head_dim}, SSM state {cfg.ssm_state}, vocab "
        f"{cfg.vocab_size}: {n / 1e9:.3f} G parameters drawn on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    B, S = PREFILL_SHAPE
    tokens = torch.as_tensor(
        lm_tokens(np.random.default_rng(SEED + 8), B, S, cfg.vocab_size),
        device=DEV)
    ssd0, fa0 = mamba2_ssd.LAUNCHES, flash_attention.LAUNCHES
    with torch.inference_mode():
        got, got_cache = lm_api.prefill(params, cfg, {"tokens": tokens})
        ssd1, fa1 = mamba2_ssd.LAUNCHES, flash_attention.LAUNCHES
        want, want_cache = lm_api.prefill(
            params, cfg.replace(attn_impl="ref"), {"tokens": tokens})
    torch.cuda.synchronize()
    groups = cfg.num_layers // cfg.attn_every
    check(ssd1 - ssd0 == cfg.num_layers and fa1 - fa0 == groups
          and mamba2_ssd.LAUNCHES == ssd1 and flash_attention.LAUNCHES == fa1,
          f"prefill launches: mamba2_ssd {ssd1 - ssd0}, flash {fa1 - fa0}; "
          f"plain prefill {mamba2_ssd.LAUNCHES - ssd1}, "
          f"{flash_attention.LAUNCHES - fa1}")
    hold_prefill(B, S, cfg, got, want, got_cache, want_cache)
    del got, got_cache
    torch.cuda.empty_cache()
    return hold_bf16_prefill(params, cfg, tokens, want, want_cache, "ssm",
                             {mamba2_ssd: "wgmma+tma"})


def phase_hybrid_serve() -> dict:
    cfg = get_config(HYBRID_ARCH).replace(attn_impl="kernel")
    groups = cfg.num_layers // cfg.attn_every
    out = serve(11, cfg, SEED + 9,
                {"mamba2_ssd": (mamba2_ssd, cfg.num_layers),
                 "flash_attention": (flash_attention, groups)})
    ran = out["mamba2_ssd"]["launches_by_design"]
    check(ran["wgmma+tma"] == out["mamba2_ssd"]["launches"],
          f"bf16 serving launched the SSD kernels {ran}")
    return out


def phase_ssd_report() -> tuple[dict, dict]:
    log(f"phase 12: time mamba2_ssd at the serving shape {SSD_SERVING} (bf16, "
        f"bf16 log decay), and flash_attention at {FA_HYBRID[:6]}")
    return time_ssd(SSD_SERVING, SEED + 10), time_flash(FA_HYBRID, SEED + 11)


def time_ssd(case, seed: int) -> dict:
    """Kernel and plain version at ``case`` in bf16 (bf16 log decay),
    beside the bound; no library call computes the scan."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    x, la, b, c, s0 = ssd_inputs(case, torch.bfloat16, gen, torch.bfloat16)
    Q = case[-1]
    ms = median_ms(lambda: ssd_ops.ssd(x, la, b, c, s0, impl="kernel", chunk=Q))
    plain_ms = median_ms(lambda: ssd_chunked(x, la, b, c, s0, chunk=Q))
    B, L, H, P, G, N, _ = case
    y_bytes = x.numel() * x.element_size()
    s_bytes = s0.numel() * s0.element_size()
    moved = sum(t.numel() * t.element_size() for t in (x, la, b, c, s0)) \
        + y_bytes + s_bytes
    # per (b, h, chunk): C B^T and M x over the lower triangle of the Q x Q
    # tile (M is 0 above it), C S^T and the rank-Q state update
    flops = 2 * B * H * (L // Q) * (Q * (Q + 1) // 2 * (N + P) + 2 * Q * P * N)
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    flops_ms = flops / BF16_FLOP_PER_S * 1e3
    log(f"  kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, library: none; bound "
        f"{max(bytes_ms, flops_ms):.3f} ms ({moved / 2**20:.0f} MiB at "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s = {bytes_ms:.3f} ms; "
        f"{flops / 1e9:.1f} GFLOP at {BF16_FLOP_PER_S / 1e12:.0f} TFLOP/s = "
        f"{flops_ms:.3f} ms, at {F32_FLOP_PER_S / 1e12:.0f} TFLOP/s f32 = "
        f"{flops / F32_FLOP_PER_S * 1e3:.3f} ms)")
    return {"ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, flops_ms),
            "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
            "library_ms": None, "shape": list(case), "dtype": "bfloat16"}


def bf16_ulp(t) -> float:
    """One bf16 ulp (8 significant bits) at the largest |t|."""
    return 2.0 ** (math.floor(math.log2(t.float().abs().max().item())) - 7)


def wkv_inputs(case, dtype, gen, lw_dtype=torch.float32, u_dtype=torch.float32):
    """r, k, v in ``dtype``; log_w = -decay |normal| in ``lw_dtype``;
    u = 0.5 normal in ``u_dtype``; a random f32 initial state."""
    B, L, H, K, V, _, decay = case
    r = torch.randn(B, L, H, K, generator=gen, device=DEV, dtype=dtype)
    k = torch.randn(B, L, H, K, generator=gen, device=DEV, dtype=dtype)
    v = torch.randn(B, L, H, V, generator=gen, device=DEV, dtype=dtype)
    lw = (torch.randn(B, L, H, K, generator=gen, device=DEV).abs_()
          .mul_(-decay).to(lw_dtype))
    u = torch.randn(H, K, generator=gen, device=DEV).mul_(0.5).to(u_dtype)
    s0 = torch.randn(B, H, K, V, generator=gen, device=DEV)
    return r, k, v, lw, u, s0


def hold_wkv(case, dtype, gen, lw_dtype=torch.float32,
             u_dtype=torch.float32) -> float:
    """Kernel against wkv6_chunked on the same inputs; max abs error of y
    and of the final state."""
    r, k, v, lw, u, s0 = wkv_inputs(case, dtype, gen, lw_dtype, u_dtype)
    Q = case[5]
    y, s = wkv_ops.wkv6(r, k, v, lw, u, s0, impl="kernel", chunk=Q)
    y_want, s_want = wkv6_chunked(r, k, v, lw, u, s0, chunk=Q)
    torch.cuda.synchronize()
    check(y.dtype == r.dtype and y.shape == v.shape and s.dtype == torch.float32
          and s.shape == s0.shape,
          f"rwkv6_scan outputs {y.dtype} {tuple(y.shape)}, {s.dtype} "
          f"{tuple(s.shape)}")
    y_atol = WKV_TOL if dtype == torch.float32 else bf16_ulp(y_want)
    errs = []
    for what, a, b_, atol in (("y", y, y_want, y_atol),
                              ("state", s, s_want, WKV_TOL)):
        err = (a.float() - b_.float()).abs().max().item()
        check(bool(torch.isfinite(a).all())
              and torch.allclose(a.float(), b_.float(), rtol=WKV_TOL, atol=atol),
              f"rwkv6_scan {case} {dtype} {what}: max abs err {err}")
        errs.append(err)
    log(f"  rwkv6_scan {case[:6]} decay {case[6]} {str(dtype):14s} log_w "
        f"{str(lw_dtype):14s} max abs err y {errs[0]:.3e} (max |y| "
        f"{y_want.float().abs().max().item():.1f}, atol {y_atol:.1e}), state "
        f"{errs[1]:.3e} (rtol {WKV_TOL:.0e})")
    return max(errs)


def phase_rwkv_kernels() -> dict:
    log("phase 13: hold rwkv6_scan against wkv6_chunked")
    gen = torch.Generator(device=DEV).manual_seed(SEED + 12)
    for dtype in (torch.float32, torch.bfloat16):
        for case in WKV_CASES:
            hold_wkv(case, dtype, gen, lw_dtype=dtype)
    err = hold_wkv(WKV_SERVING, torch.bfloat16, gen, lw_dtype=torch.bfloat16,
                   u_dtype=torch.bfloat16)
    return {"max_abs_err": err}


def randomise_rwkv_leaves(params, gen) -> None:
    """Draw, in place, the leaves the reference initializer sets to zeros
    (the token-shift lerps, the decay bias, the bonus u) or ones (ln_x), so
    that a wrong token shift or bonus term shows in the outputs."""
    tm, cm = params["stack"]["rwkv"]["tmix"], params["stack"]["rwkv"]["cmix"]
    for t in [tm[f"mu_{n}"] for n in "rkvgw"] + [cm["mu_k"]]:
        t.copy_(torch.rand(t.shape, generator=gen, device=DEV))
    tm["w0"].copy_(torch.randn(tm["w0"].shape, generator=gen, device=DEV))
    tm["u"].copy_(torch.randn(tm["u"].shape, generator=gen, device=DEV) * 0.5)
    tm["ln_x"].copy_(torch.rand(tm["ln_x"].shape, generator=gen, device=DEV) + 0.5)


def phase_rwkv_prefill() -> dict:
    log(f"phase 14: full-width {RWKV_ARCH} in f32, then bf16, prefill through "
        "the kernel against prefill through wkv6_chunked")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(RWKV_ARCH).replace(param_dtype="float32",
                                        compute_dtype="float32",
                                        attn_impl="kernel")
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEV).manual_seed(SEED + 13)
    params = lm_api.init_params(cfg, gen, device=DEV)
    randomise_rwkv_leaves(params, gen)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in _leaves(params))
    log(f"  {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.d_model // cfg.rwkv_head_size} heads of {cfg.rwkv_head_size}, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}: {n / 1e9:.3f} G parameters "
        f"drawn on the card in {time.perf_counter() - t0:.1f} s")
    B, S = PREFILL_SHAPE
    tokens = torch.as_tensor(
        lm_tokens(np.random.default_rng(SEED + 13), B, S, cfg.vocab_size),
        device=DEV)
    wkv0 = rwkv6_scan.LAUNCHES
    with torch.inference_mode():
        got, got_cache = lm_api.prefill(params, cfg, {"tokens": tokens})
        wkv1 = rwkv6_scan.LAUNCHES
        want, want_cache = lm_api.prefill(
            params, cfg.replace(attn_impl="ref"), {"tokens": tokens})
    torch.cuda.synchronize()
    check(wkv1 - wkv0 == cfg.num_layers and rwkv6_scan.LAUNCHES == wkv1,
          f"prefill launches: rwkv6_scan {wkv1 - wkv0}; plain prefill "
          f"{rwkv6_scan.LAUNCHES - wkv1}")
    log(f"  rwkv6_scan launches: kernel prefill {wkv1 - wkv0}, plain prefill "
        f"{rwkv6_scan.LAUNCHES - wkv1}")
    hold_prefill(B, S, cfg, got, want, got_cache, want_cache)
    del got, got_cache
    torch.cuda.empty_cache()
    return hold_bf16_prefill(params, cfg, tokens, want, want_cache, "state",
                             {rwkv6_scan: "mma"})


def phase_rwkv_serve() -> dict:
    cfg = get_config(RWKV_ARCH).replace(attn_impl="kernel")
    gen = torch.Generator(device=DEV).manual_seed(SEED + 14)
    params = lm_api.init_params(cfg, gen, device=DEV)
    randomise_rwkv_leaves(params, gen)
    out = serve(15, cfg, SEED + 14,
                {"rwkv6_scan": (rwkv6_scan, cfg.num_layers)}, params=params)
    del params
    ran = out["rwkv6_scan"]["launches_by_design"]
    check(ran["mma"] == out["rwkv6_scan"]["launches"],
          f"bf16 serving launched the WKV kernels {ran}")
    return out


def phase_rwkv_report() -> dict:
    log(f"phase 16: time rwkv6_scan at the serving shape {WKV_SERVING[:6]} "
        "(bf16, bf16 log decay)")
    gen = torch.Generator(device=DEV).manual_seed(SEED + 15)
    case = WKV_SERVING
    r, k, v, lw, u, s0 = wkv_inputs(case, torch.bfloat16, gen, torch.bfloat16,
                                    torch.bfloat16)
    Q = case[5]
    ms = median_ms(lambda: wkv_ops.wkv6(r, k, v, lw, u, s0, impl="kernel",
                                        chunk=Q))
    plain_ms = median_ms(lambda: wkv6_chunked(r, k, v, lw, u, s0, chunk=Q))
    B, L, H, K, V = case[:5]
    # inputs read once (u as the f32 copy the kernel reads), y and the final
    # state written once
    moved = (sum(t.numel() * t.element_size() for t in (r, k, v, lw, s0))
             + u.numel() * 4 + v.numel() * v.element_size()
             + s0.numel() * s0.element_size())
    # the function in its chunked form, per (b, h) and 64-step chunk: the
    # carry-in (Q,K)x(K,V), the causal half of the (Q,Q) decayed r k^T and of
    # A v, the rank-Q state update, each two operations a multiply-add
    Qc = 64
    chunk_flops = 2 * Qc * K * V + Qc * Qc * K + Qc * Qc * V + 2 * Qc * K * V
    flops = B * H * (L // Qc) * chunk_flops
    # the step form's f32 count (the f32 step kernel's bound), kept as a note:
    # r S, S w + k v, the bonus a = sum r u k and a v, per (b, h, step)
    step_flops = B * H * L * (5 * K * V + 3 * K + 2 * V)
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    flops_ms = flops / BF16_FLOP_PER_S * 1e3
    step_ms = step_flops / F32_FLOP_PER_S * 1e3
    log(f"  kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, library: none; bound "
        f"{max(bytes_ms, flops_ms):.3f} ms ({moved / 2**20:.0f} MiB at "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s = {bytes_ms:.3f} ms; chunked form "
        f"{flops / 1e9:.1f} GFLOP at {BF16_FLOP_PER_S / 1e12:.0f} TFLOP/s bf16 = "
        f"{flops_ms:.3f} ms); note: the step form's {step_flops / 1e9:.1f} GFLOP "
        f"at {F32_FLOP_PER_S / 1e12:.0f} TFLOP/s f32 = {step_ms:.3f} ms")
    return {"ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, flops_ms),
            "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
            "library_ms": None, "shape": list(case[:6]), "dtype": "bfloat16"}


def gmm_inputs(case, dtype, gen):
    """xe = normal, w = normal / sqrt(D) (the scale of the model's weights),
    both in ``dtype``."""
    G, M, D, F = case
    xe = torch.randn(G, M, D, generator=gen, device=DEV, dtype=dtype)
    w = torch.randn(G, D, F, generator=gen, device=DEV).div_(math.sqrt(D))
    return xe, w.to(dtype)


def hold_gmm(case, dtype, gen) -> float:
    """Kernel against gmm_reference on the same inputs; max abs error."""
    xe, w = gmm_inputs(case, dtype, gen)
    got = gmm_ops.gmm(xe, w, impl="kernel")
    want = gmm_reference(xe, w)
    torch.cuda.synchronize()
    G, M, _, F = case
    check(got.dtype == xe.dtype and got.shape == (G, M, F),
          f"moe_gmm output {got.dtype} {tuple(got.shape)}")
    if dtype == torch.float32:
        rtol, atol = GMM_TOL, GMM_TOL
    else:
        rtol, atol = 0.0, bf16_ulp(want)
    err = (got.float() - want.float()).abs().max().item()
    check(bool(torch.isfinite(got).all())
          and torch.allclose(got.float(), want.float(), rtol=rtol, atol=atol),
          f"moe_gmm {case} {dtype}: max abs err {err}")
    log(f"  moe_gmm {case} {str(dtype):14s} max abs err {err:.3e} (max |out| "
        f"{want.float().abs().max().item():.2f}; rtol {rtol:.0e}, atol "
        f"{atol:.1e})")
    return err


def hold_gmm_live(case, gen, n_live: int = GMM_LIVE) -> float:
    """The kernel with ``live`` marking ``n_live`` of the G experts at a
    decode shape. The other experts' rows of xe are zero, as the dispatch
    gives them, and their weights NaN: the kernel must write zeros there
    without reading them, and agree with gmm_reference elsewhere."""
    xe, w = gmm_inputs(case, torch.bfloat16, gen)
    G = case[0]
    live = torch.arange(G, device=DEV) % (G // n_live) == 0
    xe[~live] = 0
    want = gmm_reference(xe, w)
    w[~live] = float("nan")
    got = gmm_ops.gmm(xe, w, impl="kernel", live=live)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    check(bool(torch.isfinite(got).all()) and not bool(got[~live].any())
          and torch.allclose(got.float(), want.float(), rtol=0.0,
                             atol=bf16_ulp(want)),
          f"moe_gmm {case} live {n_live} of {G}: max abs err {err}")
    log(f"  moe_gmm {case} live {int(live.sum())} of {G} (the others' weights "
        f"NaN) max abs err {err:.3e}, zeros where not live")
    return err


def phase_gmm_kernels() -> tuple[dict, float]:
    log("phase 17: hold moe_gmm against gmm_reference, and flash_attention "
        f"at {MOE_ARCH}'s attention shape")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=DEV).manual_seed(SEED + 16)
    for dtype in (torch.float32, torch.bfloat16):
        for case in GMM_CASES:
            hold_gmm(case, dtype, gen)
    errs = {case: hold_gmm(case, torch.bfloat16, gen)
            for case in (GMM_PREFILL, GMM_PREFILL_DOWN, GMM_DECODE,
                         GMM_DECODE_DOWN)}
    for case in (GMM_DECODE, GMM_DECODE_DOWN):
        hold_gmm_live(case, gen)
    torch.cuda.empty_cache()
    flash_err = hold_flash(FA_MOE, torch.bfloat16, gen)
    return {"max_abs_err": errs[GMM_PREFILL],
            "max_abs_err_prefill_down": errs[GMM_PREFILL_DOWN],
            "max_abs_err_decode": errs[GMM_DECODE],
            "max_abs_err_decode_down": errs[GMM_DECODE_DOWN]}, flash_err


def phase_moe_prefill() -> None:
    log(f"phase 18: {MOE_ARCH} at published widths, {MOE_PREFILL_LAYERS} "
        "layers, in f32: prefill through the gmm kernel against prefill "
        "through the plain einsums")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(MOE_ARCH).replace(
        num_layers=MOE_PREFILL_LAYERS, param_dtype="float32",
        compute_dtype="float32", attn_impl="kernel", moe_impl="gmm")
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEV).manual_seed(SEED + 17)
    params = lm_api.init_params(cfg, gen, device=DEV)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in _leaves(params))
    log(f"  {cfg.num_layers} layers, d_model {cfg.d_model}, {cfg.num_heads} "
        f"heads / {cfg.num_kv_heads} KV heads of {cfg.resolved_head_dim}, "
        f"{cfg.num_experts} experts top-{cfg.num_experts_per_token} of d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}: {n / 1e9:.3f} G parameters "
        f"({n * 4 / 2**30:.1f} GiB) drawn on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    B, S = PREFILL_SHAPE
    tokens = torch.as_tensor(
        lm_tokens(np.random.default_rng(SEED + 17), B, S, cfg.vocab_size),
        device=DEV)
    routes = []     # per router call: (top-1 expert, top-1 minus top-2 gate)
    router = lm_moe._router

    def recording_router(p, x, c):
        gates, topw, topi = router(p, x, c)
        top2 = gates.topk(2, dim=-1).values
        routes.append((topi[..., 0], top2[..., 0] - top2[..., 1]))
        return gates, topw, topi

    lm_moe._router = recording_router
    try:
        g0 = moe_gmm.LAUNCHES
        with torch.inference_mode():
            got, got_cache = lm_api.prefill(params, cfg, {"tokens": tokens})
            g1 = moe_gmm.LAUNCHES
            want, want_cache = lm_api.prefill(
                params, cfg.replace(moe_impl="dropping"), {"tokens": tokens})
        torch.cuda.synchronize()
    finally:
        lm_moe._router = router
    L = cfg.num_layers
    log(f"  moe_gmm launches: kernel prefill {g1 - g0}, plain prefill "
        f"{moe_gmm.LAUNCHES - g1}")
    check(g1 - g0 == 3 * L and moe_gmm.LAUNCHES == g1,
          f"prefill launches: moe_gmm {g1 - g0}, plain prefill "
          f"{moe_gmm.LAUNCHES - g1}; expected {3 * L} and 0")
    check(len(routes) == 2 * L, f"{len(routes)} router calls, expected {2 * L}")
    flipped = torch.zeros(B, dtype=torch.bool, device=DEV)
    smallest = math.inf
    for layer, ((e_k, m_k), (e_p, m_p)) in enumerate(zip(routes[:L], routes[L:])):
        flip = e_k != e_p
        margin = torch.minimum(m_k, m_p)
        smallest = min(smallest, margin.min().item())
        if bool(flip.any()):
            worst = margin[flip].max().item()
            log(f"  layer {layer}: {int(flip.sum())} top-1 flip(s), largest "
                f"gate margin among them {worst:.3e}")
            check(worst <= ROUTE_MARGIN,
                  f"layer {layer}: top-1 expert differs at a gate margin of "
                  f"{worst:.3e} > {ROUTE_MARGIN:.0e}")
            flipped |= flip.any(-1)
    rows = [b for b in range(B) if not flipped[b]]
    log(f"  top-1 experts of {B * S} tokens in {L} layers: "
        f"{'identical' if len(rows) == B else f'flips in rows {sorted(set(range(B)) - set(rows))}'}"
        f"; smallest top-1/top-2 gate margin {smallest:.3e}; holding rows {rows}")
    check(len(rows) > 0, "every batch row had a routing flip")
    hold_prefill(B, S, cfg, got, want, got_cache, want_cache, rows=rows)
    del got_cache, want_cache
    hold_moe_decode(params, cfg)


@contextlib.contextmanager
def recorded_live(lives: list):
    """Append (rows of xe, ``live``) of every call of the gmm path's expert
    FFN to ``lives``; ``live`` stays on the device (no host sync)."""
    real = gmm_ops.expert_ffn

    def recording(p, xe, c, live=None):
        lives.append((xe.shape[1], live))
        return real(p, xe, c, live=live)

    gmm_ops.expert_ffn = recording
    try:
        yield lives
    finally:
        gmm_ops.expert_ffn = real


def _clone_tree(tree):
    return {k: _clone_tree(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


def hold_moe_decode(params, cfg) -> None:
    """One f32 decode step at the serving batch, through the gmm kernel
    against the plain einsums from one cache: SERVE_BATCH tokens routed
    top-1 leave at least 16 - SERVE_BATCH experts empty in every layer, and
    the kernel skips them. Logits and every cache leaf are held."""
    B, S = SERVE_BATCH, MOE_DECODE_PROMPT
    tokens = torch.as_tensor(lm_tokens(np.random.default_rng(SEED + 22), B,
                                       S + 1, cfg.vocab_size), device=DEV)
    lives = []
    with torch.inference_mode():
        _, cache = lm_api.prefill(params, cfg, {"tokens": tokens[:, :S]},
                                  reserve=S + 1)
        plain_cache = _clone_tree(cache)
        g0 = moe_gmm.LAUNCHES
        with recorded_live(lives):
            got, got_cache = lm_api.decode_step(params, cfg, cache,
                                                tokens[:, S:], S)
        g1 = moe_gmm.LAUNCHES
        want, want_cache = lm_api.decode_step(
            params, cfg.replace(moe_impl="dropping"), plain_cache,
            tokens[:, S:], S)
    torch.cuda.synchronize()
    L, E = cfg.num_layers, cfg.num_experts
    counts = [int(live.sum()) for _, live in lives]
    log(f"  decode step, B={B} after {S} tokens: moe_gmm launches {g1 - g0}, "
        f"plain {moe_gmm.LAUNCHES - g1}; live experts per layer {counts} "
        f"of {E}")
    check(g1 - g0 == 3 * L and moe_gmm.LAUNCHES == g1,
          f"decode launches: moe_gmm {g1 - g0}, plain "
          f"{moe_gmm.LAUNCHES - g1}; expected {3 * L} and 0")
    check(len(lives) == L and all(m == B for m, _ in lives)
          and max(counts) <= B < E,
          f"decode expert FFN calls {[(m, c) for (m, _), c in zip(lives, counts)]}:"
          f" expected {L} calls of {B} rows with at most {B} of {E} live")
    hold_prefill(B, 1, cfg, got, want, got_cache, want_cache,
                 stage="decode step")


def phase_moe_serve() -> dict:
    cfg = get_config(MOE_ARCH).replace(num_layers=MOE_SERVE_LAYERS,
                                       attn_impl="kernel", moe_impl="gmm")
    L = cfg.num_layers
    lives = []
    with recorded_live(lives):
        out = serve(19, cfg, SEED + 18,
                    {"moe_gmm": (moe_gmm, 3 * L * SERVE_MAX_NEW),
                     "flash_attention": (flash_attention, L)})
    out["moe_gmm"]["served_live_experts"] = live_counts(lives, cfg)
    return out


def live_counts(lives, cfg) -> dict:
    """The live experts of every expert FFN call of the served requests, in
    prefill (GMM_PREFILL's rows) and decode (GMM_DECODE's rows) apart: the
    share of the expert weights the gmm kernel skipped."""
    L, E = cfg.num_layers, cfg.num_experts
    calls = {"prefill": (GMM_PREFILL[1], SERVE_REQUESTS * L),
             "decode": (GMM_DECODE[1], SERVE_REQUESTS * L * (SERVE_MAX_NEW - 1))}
    out = {}
    for stage, (rows, n) in calls.items():
        sel = [live for m, live in lives if m == rows]
        check(len(sel) == n, f"{len(sel)} {stage} expert FFN calls of {rows} "
              f"rows, expected {n}")
        counts = torch.stack(sel).sum(1).cpu().numpy()
        hist = np.bincount(counts, minlength=E + 1).tolist()
        log(f"  {stage}: live experts of {E} over {n} expert FFN calls: mean "
            f"{counts.mean():.4f}, min {counts.min()}, max {counts.max()}; "
            f"calls by live count 0..{E}: {hist}; the kernel read "
            f"{counts.mean() / E:.4f} of the expert weights")
        out[stage] = {"calls": n, "mean": float(counts.mean()),
                      "min": int(counts.min()), "max": int(counts.max())}
    check(len(lives) == sum(n for _, n in calls.values()),
          f"{len(lives)} expert FFN calls, expected "
          f"{sum(n for _, n in calls.values())}")
    return out


def time_gmm(case, seed: int, live_experts: int | None = None) -> dict:
    """Kernel, plain version and torch.bmm at ``case`` in bf16, beside the
    bound. With ``live_experts``, only that
    many experts hold tokens (the others' rows are zero) and the kernel is
    told so; the bound counts the live experts' weights and products."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    xe, w = gmm_inputs(case, torch.bfloat16, gen)
    G, M, D, F = case
    live = None
    if live_experts is not None:
        live = torch.arange(G, device=DEV) % (G // live_experts) == 0
        xe[~live] = 0
    ms = median_ms(lambda: gmm_ops.gmm(xe, w, impl="kernel", live=live))
    plain_ms = median_ms(lambda: gmm_reference(xe, w))
    library_ms = median_ms(lambda: torch.bmm(xe, w))
    g = G if live is None else int(live.sum())
    moved = (xe.numel() + g * D * F + G * M * F) * xe.element_size()
    flops = 2 * g * M * D * F
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    flops_ms = flops / BF16_FLOP_PER_S * 1e3
    log(f"  {case}{'' if live is None else f' {g} of {G} live'}: kernel "
        f"{ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s, "
        f"{moved / ms / 1e9:.3f} TB/s), "
        f"plain {plain_ms:.3f} ms, torch.bmm {library_ms:.3f} ms "
        f"({2 * G * M * D * F / library_ms / 1e9:.1f} TFLOP/s); bound "
        f"{max(bytes_ms, flops_ms):.3f} ms ({flops / 1e12:.3f} TFLOP at "
        f"{BF16_FLOP_PER_S / 1e12:.0f} TFLOP/s = {flops_ms:.3f} ms; "
        f"{moved / 1e9:.3f} GB at {HBM_BYTES_PER_S / 1e12:.2f} TB/s = "
        f"{bytes_ms:.3f} ms)")
    return {"ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, flops_ms),
            "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
            "library_ms": library_ms, "shape": list(case), "dtype": "bfloat16",
            "tflops": flops / ms / 1e9, "live_experts": g}


def phase_gmm_report() -> tuple[dict, dict]:
    log(f"phase 20: time moe_gmm at the prefill {GMM_PREFILL} and decode "
        f"{GMM_DECODE} shapes (bf16; decode with every expert live and with "
        f"{GMM_LIVE} of 16), and flash_attention at {FA_MOE[:6]}")
    gmm = time_gmm(GMM_PREFILL, SEED + 19)
    gmm["decode"] = time_gmm(GMM_DECODE, SEED + 20)
    gmm["decode_live"] = time_gmm(GMM_DECODE, SEED + 20, GMM_LIVE)
    check(gmm["decode_live"]["ms"] < gmm["decode"]["ms"],
          f"gmm decode with {GMM_LIVE} of 16 experts live took "
          f"{gmm['decode_live']['ms']:.3f} ms, all live "
          f"{gmm['decode']['ms']:.3f} ms")
    torch.cuda.empty_cache()
    return gmm, time_flash(FA_MOE, SEED + 21)


def hold_scaled(got: dict, want: dict, tol: float, what: str) -> float:
    """Each tensor of got within tol times the largest |value| of want's
    (at least 1); returns the largest error relative to that scale."""
    worst = 0.0
    for name, w in want.items():
        w = torch.as_tensor(w).float()
        err = (torch.as_tensor(got[name]).float() - w).abs().max().item()
        scale = max(1.0, w.abs().max().item())
        check(err <= tol * scale, f"{what} {name}: max abs err {err:.3e} at "
              f"scale {scale:.3g}, tolerance {tol:.0e} of the scale")
        worst = max(worst, err / scale)
    return worst


def hold_adam_step(got: dict, want: dict, g_got: dict, g_want: dict,
                   lr: float = CAMPAIGN.lr, eps: float = 1e-8):
    """Weights after one Adam epoch on two devices. Adam's first step is
    lr g / (|g| + eps), close to lr sign(g): where a gradient lies within a
    few eps of zero, its rounding moves the step by up to 2 lr. So each
    weight may differ by TRAIN_TOL of its tensor's scale plus the difference
    of the two steps that the two devices' gradients (held to TRAIN_TOL
    before) give. Returns the largest error relative to the scale outside
    that term, and how many weights needed the term."""
    worst, n_adam = 0.0, 0
    for name, w in want.items():
        w, v = torch.as_tensor(w), torch.as_tensor(got[name])
        step = lambda g: lr * g / (g.abs() + eps)         # noqa: E731
        adam = (step(g_got[name]) - step(g_want[name])).abs()
        scale = max(1.0, w.abs().max().item())
        err = (v - w).abs()
        bad = err > TRAIN_TOL * scale + adam
        if bad.any():
            check(False, f"one-epoch weight {name}: {int(bad.sum())} weights "
                  f"off by up to {err[bad].max().item():.3e} beyond "
                  f"{TRAIN_TOL:.0e} of the scale {scale:.3g} and Adam's step")
        n_adam += int((err > TRAIN_TOL * scale).sum())
        worst = max(worst, (err - adam).clamp(min=0).max().item() / scale)
    return worst, n_adam


def phase_retrain() -> float:
    log(f"phase 21: full-width retrain on the card against the CPU "
        f"({CAMPAIGN.initial_train} molecules, E={CONFIG.ensemble})")
    space = MoleculeSpace(num_molecules=CAMPAIGN.num_molecules, seed=42)
    n = CAMPAIGN.initial_train
    feats, y = featurize(space, range(n)), oracle_batch(space, range(n))
    idx = np.random.default_rng(SEED + 22).integers(0, n, (CONFIG.ensemble, n))
    y_n = ((y - y.mean()) / y.std()).astype(np.float32)
    batch = {**{k: feats[k][idx] for k in FEATURES}, "y": y_n[idx]}
    devices = (DEV, "cpu")

    grads, first_loss = {}, {}
    for dev in devices:
        model = Surrogate(CONFIG, seed=SEED, device=dev).model
        loss = mpnn_loss(model, {k: torch.from_numpy(v).to(dev)
                                 for k, v in batch.items()})
        loss.sum().backward()
        grads[dev] = {k: p.grad.cpu() for k, p in model.named_parameters()}
        first_loss[dev] = loss.detach().cpu()
    grad_err = hold_scaled(grads[DEV], grads["cpu"], TRAIN_TOL, "gradient")
    hold_scaled({"loss": first_loss[DEV]}, {"loss": first_loss["cpu"]},
                TRAIN_TOL, "first loss")

    params = {}
    for dev in devices:
        sur = Surrogate(CONFIG, seed=SEED, device=dev)
        sur.train(feats, y, CAMPAIGN.lr, 1, idx=idx)
        params[dev] = params_to_numpy(sur.model)
    param_err, n_adam = hold_adam_step(params[DEV], params["cpu"],
                                       grads[DEV], grads["cpu"])

    last = {dev: Surrogate(CONFIG, seed=SEED, device=dev).train(
        feats, y, CAMPAIGN.lr, RETRAIN_EPOCHS, idx=idx) for dev in devices}
    loss_err = abs(last[DEV] - last["cpu"])
    check(loss_err <= LOSS_TOL, f"last loss card {last[DEV]:.6f} against CPU "
          f"{last['cpu']:.6f}, tolerance {LOSS_TOL:.0e}")
    start = first_loss[DEV].mean().item()
    check(last[DEV] < start, f"loss did not fall: {start:.4f} at epoch 1, "
          f"{last[DEV]:.4f} at epoch {RETRAIN_EPOCHS}")
    log(f"  first-epoch gradients within {grad_err:.3e} of their scale, "
        f"one-epoch weights {param_err:.3e} ({n_adam} weights of "
        f"{sum(v.size for v in params['cpu'].values())} beyond it by Adam's "
        f"step on a near-zero gradient); loss {start:.4f} at epoch 1, "
        f"{last[DEV]:.6f} at epoch {RETRAIN_EPOCHS} (CPU {last['cpu']:.6f}, "
        f"|diff| {loss_err:.3e})")

    epoch_ms = {}
    for n_mol in (n, n + CAMPAIGN.qc_budget):
        f = featurize(space, range(n_mol))
        yy = oracle_batch(space, range(n_mol))
        sur = Surrogate(CONFIG, seed=SEED, device=DEV)
        sur.train(f, yy, CAMPAIGN.lr, 2)                    # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        sur.train(f, yy, CAMPAIGN.lr, TIMED_EPOCHS)          # ends in a sync
        ms = epoch_ms[n_mol] = (time.perf_counter() - t0) / TIMED_EPOCHS * 1e3
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"  {n_mol} molecules: {ms:.1f} ms an epoch (host clock over "
            f"{TIMED_EPOCHS}), peak device memory {peak:.2f} GiB")
        del sur
        torch.cuda.empty_cache()
    return epoch_ms[n + CAMPAIGN.qc_budget]


@contextlib.contextmanager
def assays_taking(seconds: float):
    """Each QC assay of a campaign waits ``seconds`` before the synthetic
    oracle (about a millisecond) answers; ``run_campaign`` looks the oracle
    up on the module at each call. Only the assays that the Task Server's
    QC workers run wait: the pre-campaign training set and the MAE targets
    (``oracle_batch`` on the calling thread) stand for data already at
    hand."""
    oracle = molecules.qc_oracle

    def slow_oracle(space, mol_id):
        if threading.current_thread().name.startswith("worker-qc"):
            time.sleep(seconds)
        return oracle(space, mol_id)

    molecules.qc_oracle = slow_oracle
    try:
        yield
    finally:
        molecules.qc_oracle = oracle


def join_workers(timeout: float = 300.0) -> None:
    """Wait for a campaign's Task Server worker threads: a retrain still
    running when the budget is spent finishes after run_campaign returns."""
    for th in threading.enumerate():
        if th.name.startswith("worker-"):
            th.join(timeout)
            check(not th.is_alive(), f"{th.name} still running")


def phase_campaign(epoch_ms: float) -> dict:
    # the longest retrain (the most molecules) within n_retrain results
    qc_seconds = (epoch_ms * CAMPAIGN.train_epochs / 1e3
                  * CAMPAIGN.parallel_qc / CAMPAIGN.n_retrain)
    log(f"phase 22: run_campaign at full width under {', '.join(POLICIES)} "
        f"({CAMPAIGN.num_molecules} molecules, budget {CAMPAIGN.qc_budget}, "
        f"retrain every {CAMPAIGN.n_retrain}, {CAMPAIGN.train_epochs} epochs; "
        f"update-n's assays take {qc_seconds:.3f} s, {CAMPAIGN.parallel_qc} "
        f"at a time, so that a {CAMPAIGN.train_epochs}-epoch retrain at "
        f"{epoch_ms:.1f} ms an epoch returns within {CAMPAIGN.n_retrain} "
        f"results)")
    chunk = Surrogate(CONFIG, seed=SEED, device=DEV).chunk_size(16, "kernel")
    per_space = CONFIG.message_steps * math.ceil(CAMPAIGN.num_molecules / chunk)
    per_mae = CONFIG.message_steps * math.ceil(64 / chunk)
    sizes = {k: 4 * math.prod(shape)
             for k, shape in param_shapes(CONFIG).items()}
    proxied = [k for k, v in sizes.items() if v >= 1 << 16]
    unproxied = sum(v for k, v in sizes.items() if k not in proxied)
    outs, launches = {}, 0
    for policy in POLICIES:
        app = dataclasses.replace(CAMPAIGN, policy=policy)
        wait = qc_seconds if policy == "update-n" else 0.0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mpnn_mp.LAUNCHES = 0
        t0 = time.perf_counter()
        with assays_taking(wait):
            out = run_campaign(app, device=DEV, cfg=CONFIG)
            wall = time.perf_counter() - t0
            join_workers()
        n_launched = mpnn_mp.LAUNCHES
        peak = torch.cuda.max_memory_allocated() / 2**30
        events = [(kind, p) for _, kind, p in out["trace"] if kind != "qc"]
        reorders = [p["seconds"] for kind, p in events if kind == "reorder"]
        retrains = [p for kind, p in events if kind == "retrain"]
        check(out["n_evaluated"] >= app.qc_budget,
              f"{policy}: {out['n_evaluated']} assays of {app.qc_budget}")
        check(len(reorders) == (policy != "random") + len(retrains),
              f"{policy}: {len(reorders)} re-scores after "
              f"{len(retrains)} retrains")
        want = per_space * len(reorders) + 2 * per_mae
        check(n_launched == want, f"{policy}: mpnn_mp launched {n_launched} "
              f"times, expected {want} ({len(reorders)} re-scores x "
              f"{per_space} + 2 MAE predicts x {per_mae})")
        for i, (kind, p) in enumerate(events):
            if kind == "retrain":
                check(i + 1 < len(events) and events[i + 1][0] == "reorder",
                      f"{policy}: no re-score after retrain {i}")
                check(p["leaf_types"] == ["ndarray"],
                      f"{policy}: retrain payload leaves {p['leaf_types']}")
                check(unproxied < p["output_size"] < unproxied + 4096,
                      f"{policy}: retrain result pickled to "
                      f"{p['output_size']} bytes; without {proxied} it is "
                      f"{unproxied}")
        puts = out["value_server"]["puts"]
        check(puts >= len(proxied) * len(retrains),
              f"{policy}: {puts} Value Server puts for {len(retrains)} "
              f"retrains of {len(proxied)} proxied leaves")
        if policy == "update-n":
            check(len(retrains) >= 1, "update-n never retrained")
        launches += n_launched
        outs[policy] = out
        retrain_ms = ", ".join(f"{p['seconds'] * 1e3:.0f}" for p in retrains)
        rescore_ms = ", ".join(f"{t * 1e3:.1f}" for t in reorders)
        log(f"  {policy}: {wall:.1f} s wall, assays of {wait:.3f} s; "
            f"{out['n_evaluated']} assays, "
            f"{out['n_high']} high-IP, success {out['success_rate']:.4f}, "
            f"best {out['best']:.3f} V, MAE {out['initial_mae']:.3f} -> "
            f"{out['final_mae']:.3f}; {len(retrains)} retrains "
            f"[{retrain_ms}] ms, {len(reorders)} re-scores [{rescore_ms}] ms; "
            f"mpnn_mp launches {n_launched}; Value Server puts {puts}; "
            f"peak device memory {peak:.2f} GiB")
        torch.cuda.empty_cache()
    log(f"  success rate update-n {outs['update-n']['success_rate']:.4f}, "
        f"no-retrain {outs['no-retrain']['success_rate']:.4f}, random "
        f"{outs['random']['success_rate']:.4f}")
    return {"launches": launches}


def zero_launches() -> dict:
    """Set every binding's launch count to 0; return the bindings."""
    mods = {"mpnn_mp": mpnn_mp, "flash_attention": flash_attention,
            "mamba2_ssd": mamba2_ssd, "rwkv6_scan": rwkv6_scan,
            "moe_gmm": moe_gmm}
    for m in mods.values():
        m.LAUNCHES = 0
        if hasattr(m, "LAUNCHES_BY_DESIGN"):
            m.LAUNCHES_BY_DESIGN = dict.fromkeys(m.DESIGNS, 0)
    return mods


def launch_counts(mods: dict) -> dict:
    return {name: m.LAUNCHES for name, m in mods.items()}


def train_cut(dtype: str):
    return get_config(LM_ARCH).replace(num_layers=TRAIN_CUT, param_dtype=dtype,
                                       compute_dtype=dtype)


def adam_direction(m, v, step: int, tc: TrainConfig):
    return (m / (1 - tc.b1 ** step)) / ((v / (1 - tc.b2 ** step)).sqrt()
                                        + tc.eps)


def hold_train_state(got: dict, want: dict, step: int, lr: float,
                     tc: TrainConfig):
    """The card's state (``got``, flattened) against the CPU's (or another
    card state's, on its device) after train step ``step``: m and v within 1e-5 relative plus MOMENT_TOL of each
    tensor's largest |value|; params by ``hold_adam_step``'s rule at step t:
    TRAIN_TOL of max(1, the tensor's largest |value|) plus lr |u - u'|, u
    and u' the two devices' Adam directions from their own m and v.
    Returns (worst moment error over its scale, worst param error over its
    scale outside Adam's term, weights that needed the term)."""
    worst_m = worst_p = 0.0
    n_adam = 0
    for key, w in want.items():
        if not key.startswith("params/"):
            continue
        rest = key[len("params"):]
        mv = {}
        for which in (".m", ".v"):
            wk = want[f"opt/{which}{rest}"]
            gk = got[f"opt/{which}{rest}"].to(wk.device)
            err = (gk - wk).abs()
            scale = wk.abs().max().item()
            bad = err > 1e-5 * wk.abs() + MOMENT_TOL * scale
            check(not bad.any(), f"step {step} {which} of {key}: "
                  f"{int(bad.sum())} values off by up to "
                  f"{err.max().item():.3e} at scale {scale:.3e}")
            worst_m = max(worst_m, err.max().item() / max(scale, 1e-30))
            mv[which] = (gk, wk)
        adam = lr * (adam_direction(*(t[0] for t in mv.values()), step, tc)
                     - adam_direction(*(t[1] for t in mv.values()), step, tc)
                     ).abs()
        g = got[key].to(w.device)
        scale = max(1.0, w.abs().max().item())
        err = (g - w).abs()
        bad = err > TRAIN_TOL * scale + adam
        check(not bad.any(), f"step {step} {key}: {int(bad.sum())} weights "
              f"off by up to {err[bad].max().item() if bad.any() else 0:.3e} "
              f"beyond {TRAIN_TOL:.0e} of the scale {scale:.3g} and Adam's "
              "step")
        n_adam += int((err > TRAIN_TOL * scale).sum())
        worst_p = max(worst_p, (err - adam).clamp(min=0).max().item() / scale)
    return worst_m, worst_p, n_adam


def phase_train_step() -> None:
    B, S = TRAIN_SHAPE
    log(f"phase 23: {LM_ARCH} at published widths cut to {TRAIN_CUT} layers, "
        f"f32, B={B}, S={S}: {TRAIN_STEPS} train steps on the card against "
        "the CPU, each from one state")
    cfg = train_cut("float32")
    tc = TrainConfig(warmup_steps=0)
    card = train_steps.init_state(
        cfg, torch.Generator(device=DEV).manual_seed(SEED + 23), DEV)
    cpu = tree_map(lambda t: t.to("cpu", copy=True), card)
    step_fn = train_steps.make_train_step(cfg, tc)
    rng = np.random.default_rng(SEED + 23)
    n = sum(t.numel() for t in tree_leaves(cpu["params"]))
    for t in range(1, TRAIN_STEPS + 1):
        toks = rng.integers(0, cfg.vocab_size, size=(B, S + 1), dtype=np.int32)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        for dst, src in zip(tree_leaves(card), tree_leaves(cpu)):
            dst.copy_(src)
        t0 = time.perf_counter()
        card, m_card = step_fn(card, {k: torch.from_numpy(v).to(DEV)
                                      for k, v in batch.items()})
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        cpu, m_cpu = step_fn(cpu, {k: torch.from_numpy(v)
                                   for k, v in batch.items()})
        cpu_s = time.perf_counter() - t0
        for name, want in m_cpu.items():
            got = float(m_card[name])
            check(abs(got - float(want)) <= 1e-5 * abs(float(want)),
                  f"step {t} metric {name}: card {got}, CPU {float(want)}")
        worst_m, worst_p, n_adam = hold_train_state(
            dict(tree_flatten_with_paths(card)),
            dict(tree_flatten_with_paths(cpu)), t, float(m_cpu["lr"]), tc)
        log(f"  step {t}: loss {float(m_card['loss']):.6f} (CPU "
            f"{float(m_cpu['loss']):.6f}), gnorm {float(m_card['grad_norm']):.4f}; "
            f"m and v within {worst_m:.3e} of their scale, params "
            f"{worst_p:.3e} ({n_adam} of {n} beyond it by Adam's step); "
            f"{card_s:.2f} s on the card, {cpu_s:.1f} s on the CPU")
    del cpu

    batch = {k: torch.from_numpy(v).to(DEV) for k, v in batch.items()}
    grads = {}
    for remat in ("none", "block"):
        g, _ = train_steps._grads_of(card["params"], cfg.replace(remat=remat),
                                     batch)
        grads[remat] = dict(tree_flatten_with_paths(g))
    worst, same = 0.0, 0
    for key, want in grads["none"].items():
        got = grads["block"][key]
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        check(err <= 1e-6 * scale, f"remat block against none, {key}: max abs "
              f"err {err:.3e} at scale {scale:.3e}")
        worst = max(worst, err / max(scale, 1e-30))
        same += bool(torch.equal(got, want))
    log(f"  remat block against none on the card: gradients within "
        f"{worst:.3e} of their scale, {same} of {len(grads['none'])} "
        "bit for bit")
    del grads

    mods = zero_launches()
    try:
        train_steps.make_train_step(cfg.replace(attn_impl="kernel"), tc)(
            card, batch)
    except RuntimeError as e:
        check("no backward" in str(e), f"unexpected error {e}")
        log(f"  attn_impl='kernel' refused: {str(e)[:80]}...")
    else:
        check(False, "a train step through the flash kernel did not raise")
    check(not any(launch_counts(mods).values()),
          f"launches before the refusal: {launch_counts(mods)}")
    del card
    torch.cuda.empty_cache()


def phase_train_full() -> dict:
    cfg = get_config(LM_ARCH)
    ft = FULL_TRAIN
    log(f"phase 24: train {LM_ARCH} at published widths and depth "
        f"({cfg.num_layers} layers, {param_count(cfg) / 1e9:.3f} G "
        f"parameters) in bf16, remat {cfg.remat!r}: batch {ft['batch']} x "
        f"{ft['seq']} as {ft['microbatches']} microbatches, "
        f"{ft['steps_total']} steps at lr {ft['lr']}")
    mods = zero_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = []
    t0 = time.perf_counter()
    _, losses = train_lm(LM_ARCH, reduced=False, log_every=5, device=DEV,
                         print_fn=lambda msg: log("  " + msg),
                         step_ms=step_ms, **ft)
    wall = time.perf_counter() - t0
    launches = launch_counts(mods)
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(not any(launches.values()), f"kernel launches in training: {launches}")
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    check(last < first, f"loss did not fall: {first:.4f} -> {last:.4f}")
    tokens = ft["batch"] * ft["seq"]
    ms = float(np.median(step_ms[2:]))
    flops = model_flops_per_token(cfg, ft["seq"], training=True) * tokens
    tflops = flops / ms / 1e9
    out = {"ms_per_step": ms, "tokens_per_s": tokens / ms * 1e3,
           "model_tflops": tflops, "mfu": tflops * 1e12 / BF16_FLOP_PER_S,
           "peak_gib": peak, "loss_first5": first, "loss_last5": last,
           "first_step_ms": step_ms[0]}
    log(f"  {ms:.1f} ms a step (median of steps 3-{len(step_ms)}; steps "
        f"{min(step_ms[2:]):.1f}-{max(step_ms[2:]):.1f}, the first "
        f"{step_ms[0]:.1f}), {out['tokens_per_s']:.0f} tokens/s, "
        f"{tflops:.1f} model TFLOP/s ({flops / 1e12:.1f} TFLOP a step), mfu "
        f"{out['mfu']:.4f}, peak device memory {peak:.2f} GiB; loss "
        f"{first:.4f} -> {last:.4f} (means of the first and last 5 steps); "
        f"{wall:.1f} s in all; kernel launches {launches}")
    torch.cuda.empty_cache()
    return out


def phase_checkpoint() -> None:
    import shutil
    import tempfile
    log(f"phase 25: checkpoint on the card, {LM_ARCH} cut to {TRAIN_CUT} "
        f"layers in bf16: save at step {CKPT_STEP}, train on, restore; resume "
        f"after {CKPT_STEP} of {CKPT_STEPS} steps against the uninterrupted "
        "run")
    cfg = train_cut("bfloat16")
    tc = TrainConfig(warmup_steps=0)
    B, S = TRAIN_SHAPE
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        state = train_steps.init_state(
            cfg, torch.Generator(device=DEV).manual_seed(SEED + 25), DEV)
        step_fn = train_steps.make_train_step(cfg, tc)
        manager = CheckpointManager(os.path.join(root, "inplace"))
        for step in range(CKPT_STEPS):
            batch = make_batch(cfg, "train", B, S, step=step, seed=SEED)
            state, _ = step_fn(state, {k: torch.from_numpy(v).to(DEV)
                                       for k, v in batch.items()})
            if step + 1 == CKPT_STEP:
                copy = tree_map(lambda t: t.clone(), state)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                manager.save(CKPT_STEP, state)
                save_s = time.perf_counter() - t0       # the host copy
        manager.wait()
        write_s = time.perf_counter() - t0
        path = os.path.join(root, "inplace", f"step_{CKPT_STEP}")
        gb = sum(os.path.getsize(os.path.join(path, f))
                 for f in os.listdir(path)) / 1e9
        t0 = time.perf_counter()
        step, back = manager.restore(state)
        torch.cuda.synchronize()
        read_s = time.perf_counter() - t0
        check(step == CKPT_STEP, f"restored step {step}")
        for (key, got), (_, want) in zip(tree_flatten_with_paths(back),
                                         tree_flatten_with_paths(copy)):
            check(got.device == want.device and got.dtype == want.dtype
                  and torch.equal(got, want), f"restored {key} differs")
        moved = sum(not torch.equal(a, b) for a, b in
                    zip(tree_leaves(state), tree_leaves(copy)))
        check(moved > 0, "training after the save changed nothing")
        log(f"  {gb:.3f} GB written; save returned after the host copy in "
            f"{save_s:.2f} s, the write done {write_s:.2f} s after the save "
            f"began; restore {read_s:.2f} s; the step-{CKPT_STEP} state "
            f"restored bit for bit while training went on ({moved} leaves "
            "moved since)")
        del state, copy, back

        lr = FULL_TRAIN["lr"]
        kw = dict(reduced=False, num_layers=TRAIN_CUT, batch=B, seq=S, lr=lr,
                  steps_total=CKPT_STEPS, log_every=100, device=DEV,
                  print_fn=lambda *a: None)
        full, full_losses = train_lm(LM_ARCH, **kw)
        ck = os.path.join(root, "resume")
        train_lm(LM_ARCH, stop_after=CKPT_STEP, ckpt_dir=ck, ckpt_every=100,
                 **kw)
        res, res_losses = train_lm(LM_ARCH, ckpt_dir=ck, resume=True, **kw)
        same, worst = 0, 0.0
        flat_full = tree_flatten_with_paths(full)
        for (key, a), (_, b) in zip(flat_full, tree_flatten_with_paths(res)):
            if torch.equal(a, b):
                same += 1
                continue
            if not key.startswith("params/"):
                continue
            ulp = 2.0 ** -7 * a.float().abs()
            err = (a.float() - b.float()).abs()
            bad = err > CKPT_STEPS * (RESUME_TOL_LR * lr + ulp)
            check(not bad.any(), f"resumed {key}: {int(bad.sum())} weights "
                  f"off by up to {err.max().item():.3e}")
            worst = max(worst, err.max().item())
        for a, b in zip(full_losses[CKPT_STEP:], res_losses):
            check(abs(a - b) <= 1e-3 * abs(a),
                  f"resumed losses {res_losses} against {full_losses}")
        log(f"  resume after {CKPT_STEP} of {CKPT_STEPS} steps: {same} of "
            f"{len(flat_full)} leaves bit for bit with the uninterrupted run, "
            f"the largest param difference {worst:.3e}; losses "
            f"{[round(x, 6) for x in res_losses]} against "
            f"{[round(x, 6) for x in full_losses[CKPT_STEP:]]}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    check(not os.path.exists(root), f"{root} left behind")
    torch.cuda.empty_cache()


def phase_new_flash_kernels() -> dict:
    log("phase 26: hold flash_attention at head dim 256 (gemma2) and at the "
        "cross-attention shape (non-causal, Sq != Sk) against its plain "
        "version, then at each new arch's serving shape in bf16")
    gen = torch.Generator(device=DEV).manual_seed(SEED + 30)
    for dtype in (torch.float32, torch.bfloat16):
        for case in FA_NEW_CASES:
            hold_flash(case, dtype, gen)
    return {f"max_abs_err_{name}": hold_flash(case, torch.bfloat16, gen)
            for name, case in (("gemma2", FA_GEMMA), ("cross", FA_CROSS),
                               ("encoder", FA_ENC), ("vlm", FA_VLM))}


def draw_lm(cfg, seed: int):
    """Seeded random weights of ``cfg`` drawn on the card, with a log line
    of the widths and the size."""
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEV).manual_seed(seed)
    params = lm_api.init_params(cfg, gen, device=DEV)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in _leaves(params))
    size = sum(t.numel() * t.element_size() for t in _leaves(params))
    layers = (f"{cfg.encoder_layers} encoder + {cfg.num_layers} decoder"
              if cfg.is_encdec else f"{cfg.num_layers}")
    log(f"  {cfg.name}: {layers} layers, d_model {cfg.d_model}, "
        f"{cfg.num_heads} heads / {cfg.num_kv_heads} KV heads of "
        f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}: "
        f"{n / 1e9:.3f} G parameters ({size / 2**30:.2f} GiB, "
        f"{cfg.param_dtype}) drawn on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    return params


def f32_config(arch: str, **kw):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return get_config(arch).replace(param_dtype="float32",
                                    compute_dtype="float32",
                                    attn_impl="kernel", **kw)


def kernel_and_plain_prefill(params, cfg, batch, launches: int):
    """Prefill through the flash kernel, then through the plain attention;
    the kernel must run ``launches`` times in the first and never in the
    second. Returns (kernel logits, cache, plain logits, cache)."""
    fa0 = flash_attention.LAUNCHES
    with torch.inference_mode():
        got, got_cache = lm_api.prefill(params, cfg, batch)
        fa1 = flash_attention.LAUNCHES
        want, want_cache = lm_api.prefill(params, cfg.replace(attn_impl="ref"),
                                          batch)
    torch.cuda.synchronize()
    check(fa1 - fa0 == launches and flash_attention.LAUNCHES == fa1,
          f"{cfg.name} prefill: flash launched {fa1 - fa0} times (expected "
          f"{launches}), plain prefill {flash_attention.LAUNCHES - fa1}")
    return got, got_cache, want, want_cache


def hold_moves(what: str, base, moved) -> None:
    """A prefill without one feature of the config must move the logits by
    ten times PREFILL_TOL or more: the feature is really on the path."""
    err = (base.float() - moved.float()).abs().max().item()
    check(err > 10 * PREFILL_TOL, f"{what} moves the logits by only {err}")
    log(f"  {what}: logits move by {err:.3e}")


def phase_gemma_prefill() -> dict:
    cfg = f32_config(GEMMA_ARCH)
    B, S = GEMMA_PREFILL_SHAPE
    log(f"phase 27: {GEMMA_ARCH} at published widths and depth in f32, "
        f"prefill of {B} x {S} (past the {cfg.sliding_window} window) "
        "through the kernel against prefill through the plain attention, "
        "then the same weights in bf16")
    check(S > cfg.sliding_window, "the prompt must outrun the window")
    params = draw_lm(cfg, SEED + 31)
    tokens = torch.as_tensor(
        lm_tokens(np.random.default_rng(SEED + 31), B, S, cfg.vocab_size),
        device=DEV)
    got, got_cache, want, want_cache = kernel_and_plain_prefill(
        params, cfg, {"tokens": tokens}, cfg.num_layers)
    hold_prefill(B, S, cfg, got, want, got_cache, want_cache)
    with torch.inference_mode():
        wide, _ = lm_api.prefill(params, cfg.replace(sliding_window=None),
                                 {"tokens": tokens})
    hold_moves("the local layers' window", got, wide)
    del got, got_cache, wide
    torch.cuda.empty_cache()
    fa0 = flash_attention.LAUNCHES
    out = hold_bf16_prefill(params, cfg, tokens, want, want_cache, ("k", "v"),
                            {})
    check(flash_attention.LAUNCHES - fa0 == cfg.num_layers,
          f"bf16 prefill: flash launched {flash_attention.LAUNCHES - fa0} "
          f"times, expected {cfg.num_layers}")
    return out


def phase_gemma_serve() -> dict:
    cfg = get_config(GEMMA_ARCH).replace(attn_impl="kernel")
    params = draw_lm(cfg, SEED + 32)
    kernels = {"flash_attention": (flash_attention, cfg.num_layers)}
    out = serve(28, cfg, SEED + 32, kernels, params=params)
    B, S = GEMMA_LONG
    long = serve(28, cfg, SEED + 33, kernels, requests=1, batch=B, prompt=S,
                 params=params)
    return {"launches": out["flash_attention"]["launches"]
            + long["flash_attention"]["launches"],
            "launches_per_request": cfg.num_layers}


def phase_encdec_prefill() -> None:
    cfg = f32_config(ENCDEC_ARCH)
    B, S = PREFILL_SHAPE
    log(f"phase 29: {ENCDEC_ARCH} at published widths and depth in f32, "
        f"prefill of {B} x {S} tokens against {ENCDEC_PREFILL_FRAMES} random "
        "frames through the kernel (encoder, decoder and cross-attention) "
        "against prefill through the plain attention")
    params = draw_lm(cfg, SEED + 34)
    rng = np.random.default_rng(SEED + 34)
    batch = {"tokens": torch.as_tensor(lm_tokens(rng, B, S, cfg.vocab_size),
                                       device=DEV),
             "frames": torch.as_tensor(rng.standard_normal(
                 (B, ENCDEC_PREFILL_FRAMES, cfg.d_model)).astype(np.float32),
                 device=DEV)}
    got, got_cache, want, want_cache = kernel_and_plain_prefill(
        params, cfg, batch, cfg.encoder_layers + 2 * cfg.num_layers)
    check(tuple(got_cache["cross"]["k"].shape[1:3])
          == (B, ENCDEC_PREFILL_FRAMES), "cross K/V misshapen")
    hold_prefill(B, S, cfg, got, want, got_cache, want_cache)
    with torch.inference_mode():
        zeros, _ = lm_api.prefill(
            params, cfg, {**batch, "frames": torch.zeros_like(batch["frames"])})
    hold_moves("zero frames in place of the random ones", got, zeros)


def phase_encdec_serve() -> dict:
    cfg = get_config(ENCDEC_ARCH).replace(attn_impl="kernel")
    per = cfg.encoder_layers + 2 * cfg.num_layers
    return serve(30, cfg, SEED + 35, {"flash_attention": (flash_attention, per)},
                 frames_len=ENCDEC_SERVE_FRAMES)["flash_attention"]


def vl_positions(batch: int, seq: int, grid) -> torch.Tensor:
    """(3, B, S) M-RoPE positions of an image-then-text prompt, temporal /
    height / width: patch (r, c) of the grid at (0, r, c), then text token j
    at max(grid) + j on every axis."""
    rows, cols = grid
    n = rows * cols
    pos = torch.zeros(3, seq, dtype=torch.long)
    pos[1, :n] = torch.arange(n) // cols
    pos[2, :n] = torch.arange(n) % cols
    pos[:, n:] = max(grid) + torch.arange(seq - n)
    return pos[:, None].expand(3, batch, seq).to(DEV)


def phase_vlm_prefill() -> None:
    cfg = f32_config(VLM_ARCH, num_layers=VLM_PREFILL_LAYERS)
    B, S = PREFILL_SHAPE
    log(f"phase 31: {VLM_ARCH} at published widths cut to "
        f"{VLM_PREFILL_LAYERS} layers, f32, prefill of {B} x {S} embeddings "
        f"({VLM_GRID[0]} x {VLM_GRID[1]} image patches, then text) at "
        "distinct (3, B, S) M-RoPE positions through the kernel against "
        "prefill through the plain attention")
    params = draw_lm(cfg, SEED + 36)
    gen = torch.Generator(device=DEV).manual_seed(SEED + 36)
    pos = vl_positions(B, S, VLM_GRID)
    check(not torch.equal(pos[0], pos[1]) and not torch.equal(pos[1], pos[2]),
          "the three position axes must differ")
    batch = {"embeds": torch.randn(B, S, cfg.d_model, generator=gen,
                                   device=DEV) * cfg.d_model ** -0.5,
             "positions": pos}
    got, got_cache, want, want_cache = kernel_and_plain_prefill(
        params, cfg, batch, cfg.num_layers)
    hold_prefill(B, S, cfg, got, want, got_cache, want_cache)
    with torch.inference_mode():
        plain_rope, _ = lm_api.prefill(
            params, cfg.replace(mrope_sections=None), batch)
    hold_moves("plain RoPE over the temporal axis in place of M-RoPE", got,
               plain_rope)


def phase_vlm_serve() -> dict:
    cfg = get_config(VLM_ARCH).replace(num_layers=VLM_SERVE_LAYERS,
                                       attn_impl="kernel")
    full = get_config(VLM_ARCH)
    log(f"phase 32: {VLM_ARCH} cut to {cfg.num_layers} of {full.num_layers} layers, "
        f"published widths: {param_count(cfg) / 1e9:.2f} G of "
        f"{param_count(full) / 1e9:.2f} G parameters, "
        f"{2 * param_count(cfg) / 2**30:.1f} GiB in bf16")
    return serve(32, cfg, SEED + 38,
                 {"flash_attention": (flash_attention, cfg.num_layers)}
                 )["flash_attention"]


def phase_new_flash_report() -> dict:
    log("phase 33: time flash_attention at the gemma2, cross-attention, "
        "seamless encoder and qwen2-vl serving shapes (bf16)")
    return {"gemma2_shape": time_flash(FA_GEMMA, SEED + 39),
            "cross_shape": time_flash(FA_CROSS, SEED + 40),
            "encoder_shape": time_flash(FA_ENC, SEED + 42),
            "vlm_shape": time_flash(FA_VLM, SEED + 41)}


def phase_hd112_flash() -> dict:
    log("phase 34: hold flash_attention at head dim 112 (kimi-k2: zero-padded "
        "to the kernel's 128, scaled by 112 ** -0.5) against its plain "
        "version, f32 and bf16, then time it at kimi-k2's serving shape")
    gen = torch.Generator(device=DEV).manual_seed(SEED + 43)
    for dtype in (torch.float32, torch.bfloat16):
        for case in FA_HD112_CASES:
            hold_flash(case, dtype, gen)
    err = hold_flash(FA_KIMI, torch.bfloat16, gen)
    torch.cuda.empty_cache()
    timed = time_flash(FA_KIMI, SEED + 44)
    B, Sq, Sk, H = FA_KIMI[:4]
    padded = 4 * 128 * B * H * live_pairs(Sq, Sk, True, None, 0)
    log(f"  the padded launch does {padded / 1e9:.1f} GFLOP at head dim 128; "
        f"at it the kernel ran {padded / timed['ms'] / 1e9:.1f} TFLOP/s")
    return {"max_abs_err_kimi": err, "kimi_shape": {
        **timed, "padded_gflop": padded / 1e9}}


def kimi_attention_hold() -> float:
    """Layer 0's attention sub-layer of kimi-k2 at published widths in f32,
    on its own seeded weights: through the kernel (hd 112 padded to 128)
    against the plain attention, on KIMI_ATTN_SHAPE tokens."""
    cfg = f32_config(KIMI_ARCH, num_layers=KIMI_LAYERS)
    gen = torch.Generator(device=DEV).manual_seed(SEED + 45)
    p = lm_attn.attention_params(InitMaker(gen, torch.float32, DEV), cfg)
    B, S = KIMI_ATTN_SHAPE
    x = torch.randn(B, S, cfg.d_model, generator=gen, device=DEV)
    cos, sin = lm_transformer.rope_tables(
        cfg, lm_transformer.positions_for(cfg, B, S, device=DEV))
    fa0 = flash_attention.LAUNCHES
    with torch.inference_mode():
        got, _ = lm_attn.self_attention(p, x, cfg, cos=cos, sin=sin)
        fa1 = flash_attention.LAUNCHES
        want, _ = lm_attn.self_attention(p, x, cfg.replace(attn_impl="ref"),
                                         cos=cos, sin=sin)
    torch.cuda.synchronize()
    check(fa1 - fa0 == 1 and flash_attention.LAUNCHES == fa1,
          f"attention sub-layer: flash launched {fa1 - fa0} times, plain "
          f"{flash_attention.LAUNCHES - fa1}")
    err = (got - want).abs().max().item()
    check(bool(torch.isfinite(got).all()) and torch.allclose(
        got, want, rtol=KIMI_ATTN_TOL, atol=KIMI_ATTN_TOL),
        f"kimi-k2 attention sub-layer, kernel vs plain: max abs err {err}")
    log(f"  layer 0 attention sub-layer, {B} x {S} tokens, {cfg.num_heads} "
        f"heads / {cfg.num_kv_heads} KV heads of {cfg.resolved_head_dim}, "
        f"f32: kernel vs plain max abs err {err:.3e} (max |out| "
        f"{want.abs().max().item():.2f}; rtol = atol = {KIMI_ATTN_TOL:.0e})")
    return err


def phase_kimi() -> dict:
    cfg = get_config(KIMI_ARCH).replace(num_layers=KIMI_LAYERS,
                                        attn_impl="kernel", moe_impl="gmm")
    E, D, F = cfg.num_experts, cfg.d_model, cfg.d_ff
    prefill_rows = SERVE_BATCH * lm_moe._capacity(cfg, SERVE_PROMPT)
    decode_rows = SERVE_BATCH * lm_moe._capacity(cfg, 1)
    log(f"phase 35: {KIMI_ARCH} at published widths cut to {KIMI_LAYERS} "
        f"layer: the f32 attention sub-layer at head dim 112, gmm at {E} "
        f"experts, then serving in bf16")
    out = {"max_abs_err_attention_f32": kimi_attention_hold()}
    torch.cuda.empty_cache()
    gen = torch.Generator(device=DEV).manual_seed(SEED + 46)
    shapes = {"prefill": (E, prefill_rows, D, F),
              "prefill_down": (E, prefill_rows, F, D),
              "decode": (E, decode_rows, D, F),
              "decode_down": (E, decode_rows, F, D)}
    for name, case in shapes.items():
        out[f"max_abs_err_{name}"] = hold_gmm(case, torch.bfloat16, gen)
        torch.cuda.empty_cache()
    for name in ("decode", "decode_down"):
        hold_gmm_live(shapes[name], gen, KIMI_DECODE_LIVE)
        torch.cuda.empty_cache()
    out["prefill_shape"] = time_gmm(shapes["prefill"], SEED + 47)
    torch.cuda.empty_cache()
    out["decode_shape_live"] = time_gmm(shapes["decode"], SEED + 48,
                                        KIMI_DECODE_LIVE)
    torch.cuda.empty_cache()
    log(f"  {KIMI_ARCH} cut to {KIMI_LAYERS} layer: "
        f"{param_count(cfg) / 1e9:.2f} G parameters, "
        f"{2 * param_count(cfg) / 2**30:.1f} GiB in bf16")
    L = cfg.num_layers
    served = serve(35, cfg, SEED + 49,
                   {"moe_gmm": (moe_gmm, 3 * L * SERVE_MAX_NEW),
                    "flash_attention": (flash_attention, L)})
    return {"gmm": out, "served": served}


# -- phases 36-37: the multi-process fabric, in a fresh interpreter ----------

def fabric_engine(path: str):
    """The inference shard's engine factory: internlm2-1.8b at published
    widths and depth in bf16 on the card, seeded with FABRIC_SEED. After
    every prefill and decode step it writes the flash launch count and the
    step's time to ``path`` (JSON), which the script reads after the
    requests: the fabric itself carries no counts."""
    cfg = get_config(LM_ARCH).replace(attn_impl="kernel")
    gen = torch.Generator(device=DEV).manual_seed(FABRIC_SEED)
    engine = Engine(cfg, lm_api.init_params(cfg, gen, device=DEV),
                    max_new=SERVE_MAX_NEW)
    flash_attention.LAUNCHES = 0
    stats = {"flash_launches": 0, "prefill_s": [], "decode_s": [],
             "pid": os.getpid(), "device": torch.cuda.get_device_name(0)}

    def write():
        stats["flash_launches"] = flash_attention.LAUNCHES
        with open(path + ".tmp", "w") as f:
            json.dump(stats, f)
        os.replace(path + ".tmp", path)

    def timed(name, fn):
        def run(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)     # returns host tokens: the device is done
            stats[name].append(time.perf_counter() - t0)
            write()
            return out
        return run

    engine.prefill_batch = timed("prefill_s", engine.prefill_batch)
    engine.decode_batch = timed("decode_s", engine.decode_batch)
    write()
    return engine


_POOL_STATE: dict = {}


def pool_rescore(seed: int) -> dict:
    """The process-pool worker's re-score: the full-width surrogate drawn
    from ``seed`` on the card ranks the whole space through ``rank_space``.
    The first call builds the surrogate and featurizes the space; later
    calls reuse them. Everything returned is numpy or a number."""
    if "sur" not in _POOL_STATE:
        _POOL_STATE["sur"] = Surrogate(CONFIG, seed=seed, device=DEV)
        _POOL_STATE["feats"] = featurize(SPACE, range(SPACE.num_molecules))
    sur, feats = _POOL_STATE["sur"], _POOL_STATE["feats"]
    before = mpnn_mp.LAUNCHES
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scores, order = rank_space(sur, feats, KAPPA)
    wall = time.perf_counter() - t0
    return {"scores": scores, "order": order,
            "launches": mpnn_mp.LAUNCHES - before, "wall_s": wall,
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "pid": os.getpid(), "device": torch.cuda.get_device_name(0)}


def _percentiles(xs) -> dict:
    xs = np.asarray(xs) * 1e6
    return {"median_us": float(np.median(xs)),
            "p99_us": float(np.percentile(xs, 99))}


def fabric_serve_and_rescore(outdir: str) -> dict:
    """Phase 36's fabric run: a ``proc`` broker, one inference shard and a
    one-worker process pool, all forked before anything touches CUDA."""
    from repro_torch.core import ColmenaQueues, ProcessPoolTaskServer
    from repro_torch.serving.shard import (InferenceClient, ServeSpec,
                                           send_shard_stop,
                                           start_inference_shard)
    stats_path = os.path.join(outdir, "shard_stats.json")
    spec = ServeSpec(engine_factory=lambda: fabric_engine(stats_path),
                     max_batch=SERVE_BATCH, prompt_buckets=(SERVE_PROMPT,),
                     max_batch_delay_ms=5000.0, max_new_cap=SERVE_MAX_NEW)
    queues = ColmenaQueues([RESCORE_TOPIC], backend="proc", serve_spec=spec,
                           lease_timeout=600.0)
    shard = pool = None
    try:
        rtt = []
        for _ in range(BROKER_PINGS):
            t0 = time.perf_counter()
            queues.transport.clock_sync()
            rtt.append(time.perf_counter() - t0)
        log(f"  broker round trip (clock_sync, one frame each way, "
            f"{BROKER_PINGS} calls): median {np.median(rtt) * 1e6:.1f} us, "
            f"p99 {np.percentile(rtt, 99) * 1e6:.1f} us")
        shard = start_inference_shard(queues.transport.address, spec,
                                      lease_timeout=600.0,
                                      identity="infer-shard:0")
        pool = ProcessPoolTaskServer(queues, workers_per_topic=1)
        pool.register(pool_rescore, topic=RESCORE_TOPIC, name="rescore")
        pool.start()
        rng = np.random.default_rng(FABRIC_SEED)
        vocab = get_config(LM_ARCH).vocab_size
        prompts = np.stack([lm_tokens(rng, SERVE_BATCH, SERVE_PROMPT, vocab)
                            for _ in range(SERVE_REQUESTS)])
        client = InferenceClient(queues)
        tokens, walls = [], []
        for r in range(SERVE_REQUESTS):
            t0 = time.perf_counter()
            res = client.infer(prompts[r].tolist(), max_new=SERVE_MAX_NEW,
                               timeout=FABRIC_GET_TIMEOUT)
            walls.append(time.perf_counter() - t0)
            check(all(x.success for x in res),
                  f"shard request {r}: {[x.error for x in res if not x.success]}")
            tokens.append([x.value for x in res])
            log(f"  shard request {r}: {SERVE_BATCH} x {SERVE_PROMPT} + "
                f"{SERVE_MAX_NEW} through InferenceClient in "
                f"{walls[-1] * 1e3:.1f} ms")
        rescores = []
        for t in range(RESCORE_TASKS):
            queues.send_task(FABRIC_SEED, method="rescore", topic=RESCORE_TOPIC)
            t0 = time.perf_counter()
            res = queues.get_result(RESCORE_TOPIC, timeout=FABRIC_GET_TIMEOUT)
            check(res is not None and res.success,
                  f"re-score task {t}: {res and res.error}")
            rescores.append(res.value)
            log(f"  pool re-score {t} on worker {res.worker}: "
                f"{res.value['wall_s'] * 1e3:.1f} ms in rank_space, "
                f"{(time.perf_counter() - t0) * 1e3:.1f} ms round trip, "
                f"{res.value['launches']} mpnn_mp launches")
    finally:
        if shard is not None:
            try:
                send_shard_stop(queues.transport, spec.topic)
            except (ConnectionError, OSError):
                pass
            shard.join(timeout=60)
            if shard.is_alive():
                shard.terminate()
                shard.join(timeout=10)
        if pool is not None:
            pool.stop()
        queues.shutdown()
    check(shard.exitcode == 0, f"inference shard exited {shard.exitcode}")
    with open(stats_path) as f:
        shard_stats = json.load(f)
    np.savez(os.path.join(outdir, "fabric.npz"), prompts=prompts,
             tokens=np.asarray(tokens, np.int64),
             scores=np.stack([r["scores"] for r in rescores]),
             orders=np.stack([r["order"] for r in rescores]))
    return {"broker_rtt": _percentiles(rtt), "client_wall_s": walls,
            "shard": shard_stats,
            "rescore": [{k: v for k, v in r.items()
                         if k not in ("scores", "order")} for r in rescores]}


def fabric_synapp(**overrides) -> dict:
    """Phase 37: the port's synapp over the ``proc`` transport with
    process-pool workers, a sharded Value Server and one inference shard
    ranking each submission's candidates (``score_candidates=0``: none, the
    paper's envelope)."""
    from repro_torch.apps.synapp import SynConfig, run_synapp
    cfg = SynConfig(backend="proc", lease_timeout=60.0,
                    **{**SYNAPP, **overrides})
    res = run_synapp(cfg)
    check(res["completed_total"] == cfg.T and res["n_results"] == cfg.T
          and res["scored"] == cfg.T * cfg.score_candidates,
          f"synapp completed {res['completed_total']} of {cfg.T}, scored "
          f"{res['scored']}")
    busy = res["utilization"] * cfg.N * res["makespan"]
    per_task = (cfg.N * res["makespan"] - busy) / res["n_results"]
    latency = sum(v for k, v in res["medians"].items() if "result" in k)
    scorer = (f"{cfg.inference_shards} scorer shard, {cfg.score_candidates} "
              "candidates a task" if cfg.score_candidates else "no scorer")
    log(f"  synapp T={cfg.T} D={cfg.D} s I={cfg.I} B N={cfg.N} (proc "
        f"backend, {cfg.vs_shards} Value Server shards, {scorer}): makespan {res['makespan']:.3f} s, summed "
        f"task runtimes {busy:.3f} s, utilization {res['utilization']:.3f}")
    log(f"  per-task dispatch overhead (N x makespan - summed runtimes) / T "
        f"= {per_task * 1e3:.3f} ms; result latency (median result "
        f"components) {latency * 1e3:.3f} ms; median overhead "
        f"{res['total_overhead_median'] * 1e3:.3f} ms")
    for k, v in sorted(res["medians"].items()):
        log(f"    {k:24s} {v * 1e6:10.1f} us")
    return {"makespan_s": res["makespan"], "busy_s": busy,
            "utilization": res["utilization"],
            "per_task_overhead_ms": per_task * 1e3,
            "result_latency_ms": latency * 1e3,
            "median_overhead_ms": res["total_overhead_median"] * 1e3,
            "medians_us": {k: v * 1e6 for k, v in res["medians"].items()},
            "config": {**SYNAPP, **overrides}}


def fabric_main(outdir: str) -> None:
    """``chip_smoke.py --fabric DIR``: phases 36 and 37 in an interpreter
    that never initialises CUDA; the forked shard and pool worker each do.
    Logs as it goes and prints one JSON line last."""
    log("phase 36: serve internlm2-1.8b from a forked inference shard and "
        "re-score from a process-pool worker over a proc broker")
    out = {"fabric": fabric_serve_and_rescore(outdir)}
    log("phase 37: synapp on the proc fabric, with the scorer shard "
        "steering each submission, then without it (the paper's envelope)")
    out["synapp"] = fabric_synapp()
    out["synapp_envelope"] = fabric_synapp(score_candidates=0)
    print(json.dumps(out), flush=True)


def run_fabric(outdir: str) -> dict:
    """Start ``chip_smoke.py --fabric`` in its own session, relay its log
    and read its JSON line; kill its whole process group if it outlives
    FABRIC_TIMEOUT."""
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--fabric", outdir],
        stdout=subprocess.PIPE, text=True, start_new_session=True)
    lines = []
    timer = threading.Timer(FABRIC_TIMEOUT,
                            lambda: os.killpg(proc.pid, 9))
    timer.start()
    try:
        for line in proc.stdout:
            lines.append(line.rstrip("\n"))
            if not line.startswith("{"):
                log("  | " + lines[-1])
        rc = proc.wait()
    finally:
        timer.cancel()
        with contextlib.suppress(ProcessLookupError):
            os.killpg(proc.pid, 9)      # anything the fabric left behind
    check(rc == 0, f"the fabric interpreter exited {rc}")
    return json.loads(lines[-1])


def greedy_with_gaps(params, cfg, prompts):
    """Greedy tokens of an in-process prefill and decode at the shard's
    padded shape, and each step's top-2 logit gap."""
    B, S = prompts.shape
    toks, gaps = [], []
    with torch.inference_mode():
        logits, cache = lm_api.prefill(
            params, cfg, {"tokens": torch.as_tensor(prompts, device=DEV)},
            reserve=S + SERVE_MAX_NEW)
        for step in range(SERVE_MAX_NEW):
            if step:
                logits, cache = lm_api.decode_step(params, cfg, cache, cur,
                                                   S + step - 1)
            top = logits.float().topk(2, dim=-1).values
            gaps.append((top[:, 0] - top[:, 1]).cpu().numpy())
            cur = logits.argmax(-1)[:, None]
            toks.append(cur[:, 0].cpu().numpy())
    return np.stack(toks, 1), np.stack(gaps, 1)


def phase_fabric(lm_timing: dict) -> dict:
    """Phases 36-37: run the fabric interpreter, then hold what its shard
    and pool worker computed against in-process runs on the same seeded
    weights."""
    import tempfile
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip-smoke-fabric-") as outdir:
        t0 = time.perf_counter()
        out = run_fabric(outdir)
        fabric_s = time.perf_counter() - t0
        data = dict(np.load(os.path.join(outdir, "fabric.npz")))
    fab, shard = out["fabric"], out["fabric"]["shard"]
    log(f"phase 36 (held in this process): the fabric interpreter took "
        f"{fabric_s:.1f} s")
    cfg = get_config(LM_ARCH).replace(attn_impl="kernel")
    per = cfg.num_layers
    check(shard["flash_launches"] == SERVE_REQUESTS * per,
          f"the shard launched flash {shard['flash_launches']} times, "
          f"expected {SERVE_REQUESTS * per}")
    check(len(shard["prefill_s"]) == SERVE_REQUESTS
          and len(shard["decode_s"]) == SERVE_REQUESTS * (SERVE_MAX_NEW - 1),
          f"the shard ran {len(shard['prefill_s'])} prefills and "
          f"{len(shard['decode_s'])} decode steps")
    steps = SERVE_MAX_NEW - 1
    for r in range(SERVE_REQUESTS):
        dec = shard["decode_s"][r * steps:(r + 1) * steps]
        log(f"  shard request {r}: prefill {shard['prefill_s'][r] * 1e3:.1f} "
            f"ms, decode {np.mean(dec) * 1e3:.2f} ms/step, client wall "
            f"{fab['client_wall_s'][r] * 1e3:.1f} ms; in-process (phase 7) "
            f"prefill {lm_timing['prefill_ms'][r]:.1f} ms, decode "
            f"{lm_timing['decode_ms_per_step'][r]:.2f} ms/step")
    warm = fab["client_wall_s"][1:]
    shard_tok_s = SERVE_BATCH * SERVE_MAX_NEW * len(warm) / sum(warm)
    log(f"  shard tok/s over the warm requests, client wall: "
        f"{shard_tok_s:.1f}; in-process (phase 7) {lm_timing['tok_s']:.1f}; "
        f"broker round trip median {fab['broker_rtt']['median_us']:.1f} us; "
        f"flash launches {shard['flash_launches']} ({per} per request)")

    params = lm_api.init_params(
        cfg, torch.Generator(device=DEV).manual_seed(FABRIC_SEED), device=DEV)
    ties, equal = [], 0
    for r in range(SERVE_REQUESTS):
        want, gaps = greedy_with_gaps(params, cfg, data["prompts"][r])
        got = data["tokens"][r]
        check(got.shape == want.shape, f"shard tokens {got.shape}")
        for b in range(SERVE_BATCH):
            near = np.flatnonzero(gaps[b] < NEAR_TIE)
            upto = near[0] if near.size else SERVE_MAX_NEW
            if near.size:
                ties.append((r, b, int(upto), float(gaps[b, upto])))
            equal += bool(np.array_equal(got[b], want[b]))
            check(np.array_equal(got[b, :upto], want[b, :upto]),
                  f"request {r} row {b}: shard tokens {got[b, :upto].tolist()}"
                  f" != in-process {want[b, :upto].tolist()}")
    del params
    torch.cuda.empty_cache()
    log(f"  shard tokens against the in-process greedy tokens: "
        f"{equal} of {SERVE_REQUESTS * SERVE_BATCH} rows equal in all "
        f"{SERVE_MAX_NEW}; {len(ties)} rows reach a near-tie (top-2 gap < "
        f"{NEAR_TIE:.0e}), where the hold stops; (request, row, step, gap): "
        f"{ties}")

    sur = Surrogate(CONFIG, seed=FABRIC_SEED, device=DEV)
    feats = featurize(SPACE, range(SPACE.num_molecules))
    want, order = rank_space(sur, feats, KAPPA)
    per_task = CONFIG.message_steps * math.ceil(
        SPACE.num_molecules / sur.chunk_size(SPACE.max_atoms, "kernel"))
    del sur, feats
    torch.cuda.empty_cache()
    for t, info in enumerate(fab["rescore"]):
        got = data["scores"][t]
        err = float(np.abs(got - want).max())
        check(np.allclose(got, want, rtol=SCORE_RTOL,
                          atol=SCORE_RTOL * np.abs(want).max()),
              f"pool re-score {t}: max abs err {err} against in-process")
        diff = np.flatnonzero(data["orders"][t] != order)
        check(np.allclose(want[data["orders"][t][diff]], want[order[diff]],
                          rtol=SCORE_RTOL, atol=0),
              f"pool re-score {t}: order differs at {diff.size} places "
              "that are not ties")
        check(info["launches"] == per_task,
              f"pool re-score {t}: mpnn_mp launched {info['launches']} "
              f"times, expected {per_task}")
        log(f"  pool re-score {t}: max abs err {err:.3e} against the "
            f"in-process re-score (rtol {SCORE_RTOL:.0e}), order differs at "
            f"{diff.size} tied places, {info['launches']} mpnn_mp launches "
            f"({CONFIG.message_steps} steps x {per_task // CONFIG.message_steps}"
            f" chunks), {info['wall_s'] * 1e3:.1f} ms, the worker's peak "
            f"device memory {info['peak_bytes'] / 2**30:.2f} GiB")
    syn, env = out["synapp"], out["synapp_envelope"]
    return {"flash": {"launches": shard["flash_launches"],
                      "launches_per_request": per},
            "mpnn_mp": {"launches": sum(i["launches"] for i in fab["rescore"]),
                        "launches_per_rescore": per_task},
            "summary": {"broker_rtt_us": fab["broker_rtt"],
                        "shard_prefill_ms": [x * 1e3 for x in shard["prefill_s"]],
                        "shard_tok_s": shard_tok_s,
                        "rescore_ms": [i["wall_s"] * 1e3 for i in fab["rescore"]],
                        "rescore_peak_bytes": [i["peak_bytes"]
                                               for i in fab["rescore"]],
                        "synapp_per_task_overhead_ms":
                            syn["per_task_overhead_ms"],
                        "synapp_result_latency_ms": syn["result_latency_ms"],
                        "envelope_per_task_overhead_ms":
                            env["per_task_overhead_ms"],
                        "envelope_result_latency_ms":
                            env["result_latency_ms"],
                        "fabric_s": fabric_s}}



# -- phases 38-40: multi-device on torch.distributed, and training archs ------

def ep_env(mesh) -> dict:
    return dict(batch=(), batch_sizes=(), model="model",
                model_size=EP_MESH[1], mesh=mesh)


def hold_ep_gmm(p, xe, live, cfg, chunk: int = 16) -> list:
    """One rank's local experts through the gmm kernel against the plain
    gmm, product by product (gate, up, down on the same inputs), by the
    bf16 gmm hold: one bf16 ulp of the largest |out|. Taken ``chunk``
    experts at a time: the plain gmm's f32 copy of all 192 experts' weights
    alone would be 10.5 GiB a rank."""
    cd = torch.bfloat16
    errs, peaks = [0.0] * 3, [0.0] * 3
    for e0 in range(0, xe.shape[0], chunk):
        sl = slice(e0, e0 + chunk)
        rows, outs = xe[sl], []
        for i, name in enumerate(("wi_gate", "wi_up", "wo")):
            if name == "wo":
                rows = (_ACTS[cfg.act](outs[0].float())
                        * outs[1].float()).to(cd)
            w = p[name][sl].to(cd)
            got = gmm_ops.gmm(rows, w, impl="kernel", live=live[sl])
            want = gmm_reference(rows, w)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got).all()),
                  f"EP gmm {name}: non-finite output")
            errs[i] = max(errs[i], (got.float() - want.float()).abs().max()
                          .item())
            peaks[i] = max(peaks[i], want.float().abs().max().item())
            outs.append(want)
    for name, err, peak in zip(("gate", "up", "down"), errs, peaks):
        tol = 2.0 ** (math.floor(math.log2(peak)) - 7)     # bf16_ulp
        check(err <= tol, f"EP gmm {name} {tuple(xe.shape)}: max abs err "
              f"{err} > {tol}")
    return errs


def ep_rank(rank: int, world: int, payload, device) -> dict:
    """Phase 38 on one rank: the f32 EP layer at reduced widths, then
    kimi-k2's EP prefill at published widths with its holds and counts."""
    mesh = make_mesh(EP_MESH, ("data", "model"), device)
    out = {}
    rcfg = get_config(KIMI_ARCH, reduced=True).replace(
        param_dtype="float32", compute_dtype="float32", moe_impl="ep_a2a",
        capacity_factor=8.0)
    gen = torch.Generator(device=DEV).manual_seed(SEED + 38)
    p = {k: v[0] for k, v in lm_api.init_params(rcfg, gen, DEV)[
        "stack"]["uniform"]["ffn"].items()}
    x = torch.randn(*EP_REDUCED_SHAPE, rcfg.d_model, generator=gen,
                    device=DEV)
    mods = zero_launches()
    with axisenv.activation_axes(**ep_env(mesh)):
        y, aux = lm_moe.moe_ffn(p, x, rcfg)
    y_ref, aux_ref = lm_moe.moe_dropping(p, x, rcfg)
    out["f32_err"] = (y - y_ref).abs().max().item()
    out["f32_aux"] = (float(aux), float(aux_ref))
    check(out["f32_err"] <= EP_F32_TOL and mods["moe_gmm"].LAUNCHES == 3,
          f"rank {rank}: f32 EP layer against moe_dropping, max abs err "
          f"{out['f32_err']}, {mods['moe_gmm'].LAUNCHES} gmm launches")
    del p, x, y, y_ref

    cfg = get_config(KIMI_ARCH).replace(num_layers=EP_LAYERS,
                                        attn_impl="kernel", moe_impl="ep_a2a")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = sharded.init_ep_params(cfg, mesh, SEED + 38, DEV)
    torch.cuda.synchronize()
    out["draw_s"] = time.perf_counter() - t0
    rng = np.random.default_rng(SEED + 38)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, size=(SERVE_BATCH, SERVE_PROMPT),
        dtype=np.int64)).to(DEV)
    calls, groups = [], []
    ffn, pos = moe_ep.local_expert_ffn, moe_ep._positions_in_group

    def record_ffn(p, xe, cfg, live):
        calls.append((p, xe, live))
        return ffn(p, xe, cfg, live)

    def record_pos(ids, n, cap):
        got = pos(ids, n, cap)
        groups.append((ids, n, got[1]))
        return got

    moe_ep.local_expert_ffn, moe_ep._positions_in_group = record_ffn, record_pos
    mods = zero_launches()
    try:
        with axisenv.activation_axes(**ep_env(mesh)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, _ = lm_api.prefill(params, cfg, {"tokens": tokens})
            torch.cuda.synchronize()
            out["prefill_ms"] = (time.perf_counter() - t0) * 1e3
    finally:
        moe_ep.local_expert_ffn, moe_ep._positions_in_group = ffn, pos
    out["launches"] = launch_counts(mods)
    check(tuple(logits.shape) == (SERVE_BATCH, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()),
          f"rank {rank}: EP prefill logits {tuple(logits.shape)}")
    # the send lanes' drops, then the local experts' (rows of other ranks'
    # lanes that hold no assignment have group E_loc and are not dropped)
    (ids, _, keep), (eids, n, ekeep) = groups
    dropped = int((~keep).sum()) + int(((eids < n - 1) & ~ekeep).sum())
    out["assignments"] = ids.numel()
    out["dropped_share"] = dropped / ids.numel()
    (p, xe, live), = calls
    out["ep_shape"] = [int(xe.shape[0]), int(xe.shape[1]),
                       cfg.d_model, cfg.d_ff]
    out["live_experts"] = int(live.sum())
    del calls, groups, logits
    torch.cuda.empty_cache()
    out["gmm_errs"] = hold_ep_gmm(p, xe, live, cfg)
    del p, xe
    torch.cuda.empty_cache()

    # the EP layer alone at the prefill shape, and its all-to-alls
    layer = {k: v[0] for k, v in params["stack"]["uniform"]["ffn"].items()}
    xb = torch.randn(SERVE_BATCH, SERVE_PROMPT, cfg.d_model, generator=gen,
                     device=DEV).to(torch.bfloat16)
    a2a_ms, layer_ms = [], []
    a2a = moe_ep._all_to_all

    def timed_a2a(t, group, grad):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = a2a(t, group, grad)
        torch.cuda.synchronize()
        a2a_ms.append((time.perf_counter() - t0) * 1e3)
        return r

    moe_ep._all_to_all = timed_a2a
    try:
        for _ in range(3):
            a2a_ms.clear()
            with axisenv.activation_axes(**ep_env(mesh)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                lm_moe.moe_ffn(layer, xb, cfg)
                torch.cuda.synchronize()
            layer_ms.append((time.perf_counter() - t0) * 1e3)
    finally:
        moe_ep._all_to_all = a2a
    out["layer_ms"] = float(np.median(layer_ms))
    out["a2a_share"] = sum(a2a_ms) / layer_ms[-1]
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return out


def phase_ep() -> dict:
    cfg = get_config(KIMI_ARCH)
    tp = EP_MESH[1]
    C_send, C_e = moe_ep.capacities(cfg, SERVE_BATCH, SERVE_PROMPT, tp, 1)
    log(f"phase 38: {KIMI_ARCH} expert-parallel (moe_impl='ep_a2a') on a "
        f"{EP_MESH} mesh of {tp} spawned ranks sharing the card over gloo: "
        f"{cfg.num_experts // tp} experts a rank, prefill {SERVE_BATCH} x "
        f"{SERVE_PROMPT} bf16 at {EP_LAYERS} layer, C_send {C_send}, C_e "
        f"{C_e}")
    t0 = time.perf_counter()
    ranks = sharded.run_world(ep_rank, tp, None, device="cuda",
                              timeout_s=900)
    wall = time.perf_counter() - t0
    for r, o in enumerate(ranks):
        check(o["launches"]["moe_gmm"] == 3 * EP_LAYERS
              and o["launches"]["flash_attention"] == EP_LAYERS
              and not any(v for k, v in o["launches"].items()
                          if k not in ("moe_gmm", "flash_attention")),
              f"rank {r}: EP prefill launches {o['launches']}")
        check(o["ep_shape"] == [cfg.num_experts // tp, C_e, cfg.d_model,
                                cfg.d_ff], f"rank {r}: EP gmm shape "
              f"{o['ep_shape']}")
        log(f"  rank {r}: f32 EP layer (reduced, cf 8) against moe_dropping "
            f"max abs err {o['f32_err']:.3e}, aux {o['f32_aux'][0]:.6f} "
            f"(single process {o['f32_aux'][1]:.6f}); {o['draw_s']:.1f} s to "
            f"draw its weights; prefill {o['prefill_ms']:.1f} ms; launches "
            f"{o['launches']}; gmm at {tuple(o['ep_shape'])} ({o['live_experts']}"
            f" live) against the plain gmm, max abs err gate/up/down "
            f"{', '.join(f'{e:.3e}' for e in o['gmm_errs'])}; dropped "
            f"{o['dropped_share']:.4f} of {o['assignments']} assignments; EP "
            f"layer {o['layer_ms']:.1f} ms, all-to-alls {o['a2a_share']:.3f} "
            f"of it; peak {o['peak_gib']:.2f} GiB")
    log(f"  phase 38: {wall:.1f} s in all")
    torch.cuda.empty_cache()
    case = tuple(ranks[0]["ep_shape"])
    timing = time_gmm(case, SEED + 50)
    torch.cuda.empty_cache()
    timing_down = time_gmm((case[0], case[1], case[3], case[2]), SEED + 51)
    torch.cuda.empty_cache()
    return {"gmm": {**timing, "down": timing_down,
                    "launches_per_rank": [o["launches"]["moe_gmm"]
                                          for o in ranks],
                    "max_abs_err": max(max(o["gmm_errs"]) for o in ranks)},
            "launches": {"moe_gmm": sum(o["launches"]["moe_gmm"]
                                        for o in ranks),
                         "flash_attention": sum(
                             o["launches"]["flash_attention"] for o in ranks)},
            "summary": {"layer_ms": [o["layer_ms"] for o in ranks],
                        "a2a_share": [o["a2a_share"] for o in ranks],
                        "dropped_share": [o["dropped_share"] for o in ranks],
                        "peak_gib": [o["peak_gib"] for o in ranks],
                        "prefill_ms": [o["prefill_ms"] for o in ranks],
                        "wall_s": wall}}


def sharded_train_rank(rank: int, world: int, payload, device) -> dict:
    """Phase 39 on one rank: each mode's sharded steps, each from the
    single-process state before it; rank 0 holds them."""
    mesh = make_mesh(EP_MESH, ("data", "model"), device)
    cfg = train_cut("float32")
    tc = TrainConfig(warmup_steps=0)
    B, S = TRAIN_SHAPE
    shape = ShapeConfig("train", "train", S, B)
    out = {}
    for mode in SHARDED_MODES:
        sc = ShardingConfig(mode=mode, zero=1)
        ref = train_steps.init_state(
            cfg, torch.Generator(device=DEV).manual_seed(SEED + 39), DEV)
        ref_step = train_steps.make_train_step(cfg, tc)
        prog, _ = train_steps.build_program(cfg, shape, mesh, tc=tc, sc=sc)
        specs = train_steps.state_shardings(cfg, mesh, sc)
        bspecs = train_steps.input_shardings(cfg, shape, mesh, mode)["batch"]
        rng = np.random.default_rng(SEED + 39)
        ms, worst = [], []
        for t in range(1, SHARDED_TRAIN_STEPS + 1):
            toks = rng.integers(0, cfg.vocab_size, size=(B, S + 1),
                                dtype=np.int32)
            batch = {"tokens": torch.from_numpy(toks[:, :-1]).to(DEV),
                     "labels": torch.from_numpy(toks[:, 1:]).to(DEV)}
            dstate = train_steps.shard_tree(ref, specs, mesh)
            dbatch = train_steps.shard_tree(batch, bspecs, mesh)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dstate, dm = prog(dstate, dbatch)
            dm = {k: float(whole(v)) for k, v in dm.items()}
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            placed = (sharded.placements_match(dstate["params"],
                                                specs["params"], mesh)
                      and sharded.placements_match(dstate["opt"].m,
                                                    specs["opt"].m, mesh))
            check(placed, f"{mode} step {t}: a placement is not its spec")
            got = train_steps.full_tree(dstate)
            del dstate
            ref, rm = ref_step(ref, batch)
            if rank == 0:
                for name, want in rm.items():
                    w = float(want)
                    check(abs(dm[name] - w) <= SHARDED_METRIC_TOL * max(
                        abs(w), 1e-30), f"{mode} step {t} metric {name}: "
                          f"sharded {dm[name]}, single process {w}")
                worst.append(hold_train_state(
                    dict(tree_flatten_with_paths(got)),
                    dict(tree_flatten_with_paths(ref)), t, float(rm["lr"]),
                    tc))
            del got
        out[mode] = {"ms": ms, "worst": worst,
                     "loss": float(rm["loss"]),
                     "grad_norm": float(rm["grad_norm"])}
        del ref
        torch.cuda.empty_cache()
    out["staged"] = dict(comm.STAGED)
    return out


def phase_sharded_train() -> dict:
    B, S = TRAIN_SHAPE
    log(f"phase 39: the sharded train step (build_program) of {LM_ARCH} at "
        f"published widths cut to {TRAIN_CUT} layers, f32, B={B}, S={S}, on "
        f"the {EP_MESH} mesh of 2 ranks sharing the card over gloo, modes "
        f"{', '.join(SHARDED_MODES)} (ZeRO-1): {SHARDED_TRAIN_STEPS} steps "
        "each, "
        "each from the single-process state before it")
    t0 = time.perf_counter()
    ranks = sharded.run_world(sharded_train_rank, EP_MESH[1], None,
                              device="cuda", timeout_s=900)
    out = {}
    for mode in SHARDED_MODES:
        o = ranks[0][mode]
        for t, (wm, wp, n_adam) in enumerate(o["worst"], 1):
            log(f"  {mode} step {t}: {o['ms'][t - 1]:.1f} ms a sharded step "
                f"(rank 0); m and v within {wm:.3e} of their scale, params "
                f"{wp:.3e} ({n_adam} beyond it by Adam's step)")
        out[mode] = {"ms_per_step": float(np.median(o["ms"])),
                     "ms": o["ms"], "ms_rank1": ranks[1][mode]["ms"]}
    log(f"  host-staged collectives on rank 0: {ranks[0]['staged']}; "
        f"{time.perf_counter() - t0:.1f} s in all")
    out["staged"] = ranks[0]["staged"]
    torch.cuda.empty_cache()
    return out


def phase_train_archs() -> dict:
    out = {}
    for n, (arch, kw) in enumerate(((GEMMA_ARCH, GEMMA_TRAIN),
                                    (VLM_ARCH, VLM_TRAIN))):
        kw = dict(kw)
        layers = kw.pop("num_layers", None)
        cfg = get_config(arch)
        if layers:
            cfg = cfg.replace(num_layers=layers)
        log(f"phase 40.{n + 1}: train {arch} at published widths"
            f"{f' cut to {layers} layer(s)' if layers else ''} "
            f"({cfg.num_layers} layers, {param_count(cfg) / 1e9:.3f} G "
            f"parameters) in bf16, remat {cfg.remat!r}: batch {kw['batch']} "
            f"x {kw['seq']} as {kw['microbatches']} microbatches, "
            f"{kw['steps_total']} steps")
        mods = zero_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step_ms = []
        t0 = time.perf_counter()
        state, losses = train_lm(arch, reduced=False, log_every=2,
                                 device=DEV,
                                 print_fn=lambda msg: log("  " + msg),
                                 step_ms=step_ms, num_layers=layers, **kw)
        wall = time.perf_counter() - t0
        launches = launch_counts(mods)
        peak = torch.cuda.max_memory_allocated() / 2**30
        check(not any(launches.values()),
              f"kernel launches in training: {launches}")
        # a few steps at lr 3e-4 from random weights need not lower the loss
        # (gemma2's softcapped logits start near the cap): held are the
        # losses' finiteness and the optimizer's step count
        check(all(math.isfinite(x) for x in losses), f"losses {losses}")
        check(int(state["opt"].step) == kw["steps_total"],
              f"{arch}: {int(state['opt'].step)} optimizer steps")
        del state
        tokens = kw["batch"] * kw["seq"]
        ms = float(np.median(step_ms[2:]))
        flops = model_flops_per_token(cfg, kw["seq"], training=True) * tokens
        tflops = flops / ms / 1e9
        out[arch] = {"ms_per_step": ms, "tokens_per_s": tokens / ms * 1e3,
                     "model_tflops": tflops,
                     "mfu": tflops * 1e12 / BF16_FLOP_PER_S,
                     "peak_gib": peak, "loss_first": losses[0],
                     "loss_last": losses[-1], "first_step_ms": step_ms[0],
                     "num_layers": cfg.num_layers}
        log(f"  {ms:.1f} ms a step (median of steps 3-{len(step_ms)}; the "
            f"first {step_ms[0]:.1f}), {out[arch]['tokens_per_s']:.0f} "
            f"tokens/s, {tflops:.1f} model TFLOP/s, mfu "
            f"{out[arch]['mfu']:.4f}, peak device memory {peak:.2f} GiB; loss "
            f"{losses[0]:.4f} -> {losses[-1]:.4f}; {wall:.1f} s in all")
        torch.cuda.empty_cache()
    return out


def sharded_serve_rank(rank: int, world: int, payload, device) -> dict:
    """Phase 41 on one rank: each arch's sharded programs in bf16 at full
    depth (16 decode steps) and in f32 at ``SHARDED_F32_CUT`` layers
    (``SHARDED_F32_STEPS``), teacher-forced with ``payload[arch]``, the
    single process's greedy tokens."""
    mesh = make_mesh(EP_MESH, ("data", "model"), device)
    out = {}
    for arch in SHARDED_SERVE_ARCHS:
        feed = payload[arch]
        out[arch] = sharded_serve_run(sharded_serve_config(arch), mesh, feed,
                                      SHARDED_SERVE_STEPS)
        out[arch]["f32_cut_logits"] = sharded_serve_run(
            sharded_serve_config(arch, f32_cut=True), mesh, feed,
            SHARDED_F32_STEPS, warm=False)["logits"]
    return out


def sharded_serve_run(cfg, mesh, feed, n: int, warm: bool = True) -> dict:
    """One config's sharded prefill of SHARDED_SERVE_SHAPE through
    ``build_program`` (with ``warm``, a first call, then the timed one;
    the flash and SSD launches are counted around the last),
    ``shard_cache``, then ``n`` decode steps, step t taking ``feed[:, t]``;
    the logits (n + 1, B, V) f32 of the prefill and each step, times,
    counts and peak memory."""
    sc = ShardingConfig(mode="dp_tp")
    B, S = SHARDED_SERVE_SHAPE
    pre = ShapeConfig("prefill", "prefill", S, B)
    dec = ShapeConfig("decode", "decode", S + n, B)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params = train_steps.shard_tree(
        sharded_serve_weights(cfg),
        train_steps.state_shardings(cfg, mesh, sc)["params"], mesh)
    torch.cuda.empty_cache()
    prompts = np.random.default_rng(SEED + 41).integers(
        0, cfg.vocab_size, size=(B, S), dtype=np.int64)
    batch = train_steps.shard_tree(
        {"tokens": torch.from_numpy(prompts).to(DEV)},
        train_steps.input_shardings(cfg, pre, mesh)["batch"], mesh)
    tok_spec = train_steps.input_shardings(cfg, dec, mesh)["tokens"]
    feed = torch.from_numpy(feed).to(DEV)
    prefill, _ = train_steps.build_program(cfg, pre, mesh, sc=sc)
    decode, _ = train_steps.build_program(cfg, dec, mesh, sc=sc)
    cold_s = None
    with torch.no_grad():
        # the first call also pays DTensor's sharding propagation and the
        # local-map set-up: it is timed apart
        if warm:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            whole(prefill(params, batch)[0])
            torch.cuda.synchronize()
            cold_s = time.perf_counter() - t0
        mods = zero_launches()
        comm.STAGED.clear()
        comm.STAGED_S.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill(params, batch)
        logits = whole(logits)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        launches = launch_counts(mods)
        staged = (sum(comm.STAGED.values()), sum(comm.STAGED_S.values()))
        cache = train_steps.shard_cache(cache, cfg, dec, mesh)
        placed = sharded.placements_match(
            cache, train_steps.input_shardings(cfg, dec, mesh)["cache"],
            mesh)
        steps = [logits.float().cpu().numpy()]
        comm.STAGED.clear()
        comm.STAGED_S.clear()
        step_s = []
        for t in range(n):
            cur = train_steps.shard_tree(feed[:, t:t + 1], tok_spec, mesh)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = decode(params, cache, cur, S + t)
            logits = whole(logits)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            steps.append(logits.float().cpu().numpy())
    out = {
        "logits": np.stack(steps), "launches": launches, "placed": placed,
        "prefill_ms": prefill_s * 1e3,
        "prefill_cold_ms": cold_s and cold_s * 1e3,
        "decode_ms": float(np.median(step_s)) * 1e3,
        "prefill_staged": staged,
        "decode_staged": (sum(comm.STAGED.values()),
                          sum(comm.STAGED_S.values())),
        "decode_s": sum(step_s),
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    del params, cache, batch
    torch.cuda.empty_cache()
    return out


def sharded_serve_config(arch: str, f32_cut: bool = False):
    """Phase 41's config of ``arch``: published widths through the kernels,
    at full depth in bf16, or cut to SHARDED_F32_CUT[arch] layers in f32."""
    cfg = get_config(arch).replace(attn_impl="kernel")
    if not f32_cut:
        return cfg
    return cfg.replace(num_layers=SHARDED_F32_CUT[arch],
                       param_dtype="float32", compute_dtype="float32")


def sharded_serve_weights(cfg, dtype=None):
    """Phase 41's weights of ``cfg``: drawn in f32 on the card from a seed,
    cast to ``dtype`` (default the config's); every rank and the single
    process draw the same."""
    dtype = dtype or getattr(torch, cfg.param_dtype)
    params = lm_api.init_params(
        cfg.replace(param_dtype="float32", compute_dtype="float32"),
        torch.Generator(device=DEV).manual_seed(SEED + 41), DEV)
    return params if dtype == torch.float32 else _cast_tree(params, dtype)


def forced_decode(params, cfg, prompts, steps: int, feed=None):
    """Single-process prefill and ``steps`` decode steps. Step t takes
    ``feed[:, t - 1]``, or the greedy token (the argmax of the logits
    before it) without ``feed``. Returns the logits (steps + 1, B, V) f32,
    the greedy tokens (B, steps + 1) and each token's top-2 gap."""
    B, S = prompts.shape
    logits_t, toks, gaps = [], [], []
    with torch.no_grad():
        logits, cache = lm_api.prefill(
            params, cfg, {"tokens": torch.as_tensor(prompts, device=DEV)},
            reserve=S + steps)
        for t in range(steps + 1):
            if t:
                cur = toks[-1] if feed is None else torch.as_tensor(
                    feed[:, t - 1], device=DEV)
                logits, cache = lm_api.decode_step(params, cfg, cache,
                                                   cur[:, None], S + t - 1)
            top = logits.float().topk(2, dim=-1).values
            gaps.append((top[:, 0] - top[:, 1]).cpu().numpy())
            toks.append(logits.argmax(-1))
            logits_t.append(logits.float().cpu().numpy())
    return (np.stack(logits_t), torch.stack(toks, 1).cpu().numpy(),
            np.stack(gaps, 1))


def sharded_serve_refs(arch: str, prompts) -> dict:
    """The single process's bf16 greedy decode through the kernels, the f32
    decode through the plain versions teacher-forced with its tokens, on
    phase 41's weights, and the f32 cut-depth decode through the kernels,
    teacher-forced with the same tokens."""
    n, m = SHARDED_SERVE_STEPS, SHARDED_F32_STEPS
    cfg = sharded_serve_config(arch)
    params = sharded_serve_weights(cfg, torch.float32)
    f32_cfg = cfg.replace(param_dtype="float32", compute_dtype="float32",
                          attn_impl="ref")
    bf16 = _cast_tree(params, torch.bfloat16)
    single, toks, gaps = forced_decode(bf16, cfg, prompts, n)
    del bf16
    torch.cuda.empty_cache()
    f32, _, _ = forced_decode(params, f32_cfg, prompts, n, feed=toks[:, :n])
    del params
    torch.cuda.empty_cache()
    cut = sharded_serve_config(arch, f32_cut=True)
    f32_cut, _, _ = forced_decode(sharded_serve_weights(cut), cut, prompts,
                                  m, feed=toks[:, :m])
    torch.cuda.empty_cache()
    return {"single": single, "f32": f32, "tokens": toks, "gaps": gaps,
            "f32_cut": f32_cut}


def hold_f32_cut(arch: str, ranks, want) -> float:
    """Each rank's f32 cut-depth logits (prefill and decode steps) against
    the single process's through the same kernels: max abs error within
    SHARDED_F32_TOL of the logits' scale."""
    scale = float(np.abs(want).max())
    err = max(float(np.abs(o[arch]["f32_cut_logits"] - want).max())
              for o in ranks)
    check(err <= SHARDED_F32_TOL * scale,
          f"{arch} f32 at {SHARDED_F32_CUT[arch]} layers: sharded logits "
          f"max abs err {err:.3e} at scale {scale:.3e}")
    log(f"  {arch} f32 at {SHARDED_F32_CUT[arch]} layers, prefill and "
        f"{want.shape[0] - 1} teacher-forced decode steps: sharded against "
        f"the single process max abs err {err:.3e} at |logit| <= "
        f"{scale:.3e} (held at {SHARDED_F32_TOL:.0e} of it)")
    return err


def hold_forced_decode(arch: str, ranks, ref) -> dict:
    """Phase 41's hold of one arch, step by step (step 0 the prefill): each
    rank's bf16 logits at most BF16_PREFILL_RATIO times as far from the
    f32 plain decode's as the single process's; its argmax the single
    process's greedy token in every row whose top-2 gap there exceeds
    twice the rank's distance from the single process's logits."""
    single, f32, toks, gaps = (ref[k] for k in
                               ("single", "f32", "tokens", "gaps"))
    ulp = 2.0 ** (math.floor(math.log2(np.abs(single).max())) - 7)
    worst, err_max, held, same = 0.0, 0.0, 0, 0
    prefill = {"to_f32_ulps": 0.0, "logit_err_ulps": 0.0}
    for t in range(single.shape[0]):
        want = f32[t].astype(np.float64)
        single_to_f32 = float(np.abs(single[t] - want).max())
        if t == 0:
            prefill["single_to_f32_ulps"] = single_to_f32 / ulp
        for r, o in enumerate(ranks):
            got = o[arch]["logits"][t]
            to_f32 = float(np.abs(got - want).max())
            err = float(np.abs(got - single[t]).max())
            check(to_f32 <= BF16_PREFILL_RATIO * single_to_f32,
                  f"{arch} rank {r} step {t}: sharded bf16 logits "
                  f"{to_f32 / ulp:.2f} ulps from the f32 plain decode, the "
                  f"single process's {single_to_f32 / ulp:.2f}")
            worst = max(worst, to_f32 / single_to_f32)
            err_max = max(err_max, err)
            sure = gaps[:, t] > 2 * err
            got_toks = got.argmax(-1)
            check(np.array_equal(got_toks[sure], toks[sure, t]),
                  f"{arch} rank {r} step {t}: sharded tokens "
                  f"{got_toks.tolist()} != single process "
                  f"{toks[:, t].tolist()} where the top-2 gaps "
                  f"{gaps[:, t].tolist()} exceed 2 x {err:.4f}")
            held += int(sure.sum())
            same += int((got_toks == toks[:, t]).sum())
            if t == 0:
                prefill["to_f32_ulps"] = max(prefill["to_f32_ulps"],
                                             to_f32 / ulp)
                prefill["logit_err_ulps"] = max(prefill["logit_err_ulps"],
                                                err / ulp)
    n = single.shape[0] * single.shape[1] * len(ranks)
    log(f"  {arch}: bf16 logits (|logit| <= {np.abs(single).max():.2f}, one "
        f"bf16 ulp {ulp:.4g}) at the prefill: sharded {prefill['to_f32_ulps']:.2f} "
        f"ulps from the f32 plain prefill, single process "
        f"{prefill['single_to_f32_ulps']:.2f}, sharded against single "
        f"{prefill['logit_err_ulps']:.2f}; over the prefill and "
        f"{single.shape[0] - 1} teacher-forced decode steps the sharded "
        f"distance from f32 is at most {worst:.3f}x the single process's "
        f"(held at {BF16_PREFILL_RATIO}x), at most {err_max / ulp:.2f} ulps "
        f"from the single process; greedy tokens equal in {same} of {n} "
        f"(rank, step, row), held in the {held} whose top-2 gap exceeds "
        "twice that distance")
    return {**prefill, "logit_err": err_max, "worst_ratio_to_f32": worst,
            "tokens_equal": same, "tokens_held": held, "tokens": n}


def phase_sharded_serve() -> dict:
    B, S = SHARDED_SERVE_SHAPE
    n = SHARDED_SERVE_STEPS
    log(f"phase 41: the sharded prefill and decode programs of "
        f"{', '.join(SHARDED_SERVE_ARCHS)} at published widths and depth in "
        f"bf16 (attn_impl='kernel') on the {EP_MESH} mesh of {EP_MESH[1]} "
        f"spawned ranks sharing the card over gloo: prefill {B} x {S}, then "
        f"{n} decode steps teacher-forced with the single process's greedy "
        f"tokens; flash and SSD held at their per-rank shapes")
    gen = torch.Generator(device=DEV).manual_seed(SEED + 41)
    errs = {"flash_attention": hold_flash(SHARDED_FA_RANK, torch.bfloat16,
                                          gen),
            "mamba2_ssd": hold_ssd(SHARDED_SSD_RANK, torch.bfloat16, gen,
                                   torch.bfloat16)}
    refs = {}
    for arch in SHARDED_SERVE_ARCHS:
        vocab = get_config(arch).vocab_size
        prompts = np.random.default_rng(SEED + 41).integers(
            0, vocab, size=(B, S), dtype=np.int64)
        refs[arch] = sharded_serve_refs(arch, prompts)
    t0 = time.perf_counter()
    ranks = sharded.run_world(
        sharded_serve_rank, EP_MESH[1],
        {arch: refs[arch]["tokens"][:, :n] for arch in SHARDED_SERVE_ARCHS},
        device="cuda", timeout_s=600)
    wall = time.perf_counter() - t0
    out = {"wall_s": wall}
    for arch in SHARDED_SERVE_ARCHS:
        cfg = get_config(arch)
        kernels = ("flash_attention", "mamba2_ssd") \
            if cfg.family == "hybrid" else ("flash_attention",)
        f32_cut_err = hold_f32_cut(arch, ranks, refs[arch]["f32_cut"])
        for r, o in enumerate(ranks):
            got = o[arch]
            check(all(got["launches"][k] > 0 for k in kernels),
                  f"{arch} rank {r}: prefill launches {got['launches']}")
            check(got["placed"], f"{arch} rank {r}: a cache leaf is off its "
                  "cache_spec placement")
            pn, ps = got["prefill_staged"]
            dn, ds = got["decode_staged"]
            log(f"  {arch} rank {r}: prefill {got['prefill_ms']:.1f} ms (the "
                f"first call {got['prefill_cold_ms']:.1f}), decode "
                f"{got['decode_ms']:.2f} ms a step (median of {n}); launches "
                f"{got['launches']}; host-staged collectives: prefill {pn} "
                f"({ps / (got['prefill_ms'] / 1e3):.3f} of its wall), decode "
                f"{dn} ({ds / got['decode_s']:.3f}); peak "
                f"{got['peak_gib']:.2f} GiB")
        out[arch] = {
            "prefill_ms": [o[arch]["prefill_ms"] for o in ranks],
            "prefill_cold_ms": [o[arch]["prefill_cold_ms"] for o in ranks],
            "decode_ms": [o[arch]["decode_ms"] for o in ranks],
            "launches": [o[arch]["launches"] for o in ranks],
            "staged_prefill": [o[arch]["prefill_staged"] for o in ranks],
            "staged_decode": [o[arch]["decode_staged"] for o in ranks],
            "peak_gib": [o[arch]["peak_gib"] for o in ranks],
            "f32_cut_err": f32_cut_err,
            **hold_forced_decode(arch, ranks, refs[arch])}
    log(f"  phase 41 ranks: {wall:.1f} s")
    log(f"  flash at internlm2's per-rank shape {SHARDED_FA_RANK[:6]}, SSD "
        f"at zamba2's {SHARDED_SSD_RANK}:")
    out["flash_rank_shape"] = {
        **time_flash(SHARDED_FA_RANK, SEED + 41),
        "max_abs_err": errs["flash_attention"]}
    out["ssd_rank_shape"] = {**time_ssd(SHARDED_SSD_RANK, SEED + 42),
                             "max_abs_err": errs["mamba2_ssd"]}
    torch.cuda.empty_cache()
    return out


def start_dry_runs(outdir: str) -> list:
    """Phase 42's dry runs, one subprocess a cell that sees no card (its
    fake world needs none), one torch thread each. They start after the
    last timed phase, so that no time above shares the host with them."""
    import atexit

    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.path.join(ROOT, "src")}
    procs = []
    atexit.register(stop_dry_runs, procs)
    for arch, shape in DRY_RUN_CELLS:
        log_path = os.path.join(outdir, f"{arch}_{shape}.log")
        with open(log_path, "w") as f:
            procs.append((subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                 arch, "--shape", shape, "--mesh", "single", "--out",
                 outdir], env=env, cwd=ROOT, stdout=f,
                stderr=subprocess.STDOUT, start_new_session=True), log_path))
    return procs


def stop_dry_runs(procs) -> None:
    """Kill the dry runs still running (each in its own session)."""
    for p, _ in procs:
        if p.poll() is None:
            os.killpg(p.pid, 9)
            p.wait()


def phase_dry_run(procs, outdir: str) -> dict:
    log(f"phase 42: the dry run on a fake world of 256 ranks (meta tensors, "
        f"no card): {DRY_RUN_CELLS}")
    t0 = time.perf_counter()
    try:
        for p, log_path in procs:
            try:
                p.wait(timeout=DRY_RUN_TIMEOUT)
            except subprocess.TimeoutExpired:
                check(False, f"dry run {p.args} not done {DRY_RUN_TIMEOUT} "
                      "s into phase 42")
            with open(log_path) as f:
                text = f.read()
            check(p.returncode == 0, f"dry run {p.args} exit "
                  f"{p.returncode}: {text[-3000:]}")
    finally:
        stop_dry_runs(procs)
    out = {}
    for arch, shape in DRY_RUN_CELLS:
        with open(os.path.join(outdir, f"{arch}_{shape}_single.json")) as f:
            rec = json.load(f)
        check(rec["status"] == "ok", f"dry run {arch} {shape}: "
              f"{rec.get('error', rec.get('reason'))}")
        r = rec["roofline"]
        out[f"{arch} {shape}"] = {
            "compute_s": r["compute_s"],
            "memory_analytic_s": r["memory_analytic_s"],
            "collective_s": r["collective_s"],
            "dominant": r["dominant_analytic"],
            "useful_flop_frac": rec["useful_flop_frac"],
            "hlo_flops_per_dev": rec["hlo_flops_per_dev"],
            "run_s": rec["t_run_s"]}
        log(f"  {arch} {shape}: compute {r['compute_s']:.4g} s, memory "
            f"(analytic) {r['memory_analytic_s']:.4g} s, collective "
            f"{r['collective_s']:.4g} s, dominant {r['dominant_analytic']}; "
            f"useful_flop_frac {rec['useful_flop_frac']:.4f}; "
            f"{rec['t_run_s']:.1f} s to run the cell")
    log(f"  phase 42: waited {time.perf_counter() - t0:.1f} s for the dry "
        "runs")
    return out


def main() -> None:
    if sys.argv[1:2] == ["--fabric"]:
        fabric_main(sys.argv[2])
        return
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    t_start = t0 = time.perf_counter()
    built = _build.build_libraries()
    log(f"built {', '.join(built)} from source, one nvcc each in parallel, "
        f"in {time.perf_counter() - t0:.1f} s")
    for name in ("flash_attention", "mamba2_ssd", "rwkv6_scan", "moe_gmm"):
        for line in ptxas_summary(name):
            log(f"  ptxas {name}: {line}")
    sur = Surrogate(CONFIG, seed=SEED, device=DEV)
    # the dense kernel's edge tensor at the plain path's chunk
    chunk_batch = CONFIG.ensemble * sur.chunk_size(SPACE.max_atoms, "ref")
    kernel = phase_kernels(chunk_batch)

    t0 = time.perf_counter()
    feats = featurize(SPACE, range(SPACE.num_molecules))
    log(f"featurized {SPACE.num_molecules} molecules in "
        f"{time.perf_counter() - t0:.1f} s; adjacency density "
        f"{(feats['bonds'] > 0).mean():.4f} of the N*N atom pairs")
    phase_surrogate(sur, feats)
    kernel.update(phase_serve(sur, feats))
    kernel.update(phase_report(chunk_batch))
    kernel["typed"] = phase_typed_report(
        sur.chunk_size(SPACE.max_atoms, "ref"),
        min(sur.chunk_size(SPACE.max_atoms, "kernel"), SPACE.num_molecules),
        feats)
    del sur, feats
    torch.cuda.empty_cache()

    flash = phase_flash_kernels()
    phase_lm_prefill()
    torch.cuda.empty_cache()
    lm = phase_lm_serve()
    lm_launches = lm["flash_attention"]
    torch.cuda.empty_cache()
    flash.update(phase_flash_report())

    ssd, flash["max_abs_err_hybrid"] = phase_ssd_kernels()
    ssd["bf16_prefill"] = phase_hybrid_prefill()
    torch.cuda.empty_cache()
    hybrid = phase_hybrid_serve()
    ssd.update(hybrid["mamba2_ssd"])
    # the flash kernel runs on six serving paths; each is counted alone
    flash["launches_by_path"] = {LM_ARCH: lm_launches,
                                 HYBRID_ARCH: hybrid["flash_attention"]}
    torch.cuda.empty_cache()
    ssd_times, flash["hybrid_shape"] = phase_ssd_report()
    ssd.update(ssd_times)

    wkv = phase_rwkv_kernels()
    wkv["bf16_prefill"] = phase_rwkv_prefill()
    torch.cuda.empty_cache()
    wkv.update(phase_rwkv_serve()["rwkv6_scan"])
    torch.cuda.empty_cache()
    wkv.update(phase_rwkv_report())
    torch.cuda.empty_cache()

    gmm, flash["max_abs_err_moe"] = phase_gmm_kernels()
    phase_moe_prefill()
    torch.cuda.empty_cache()
    moe = phase_moe_serve()
    gmm.update(moe["moe_gmm"])
    # the gmm kernel runs on two serving paths; each is counted alone
    gmm_paths = {MOE_ARCH: {k: gmm.pop(k) for k in
                            ("launches", "launches_per_request")}}
    flash["launches_by_path"][MOE_ARCH] = moe["flash_attention"]
    torch.cuda.empty_cache()
    gmm_times, flash["moe_shape"] = phase_gmm_report()
    gmm.update(gmm_times)
    torch.cuda.empty_cache()

    epoch_ms = phase_retrain()
    # the mpnn_mp kernel runs on two paths; each was counted alone
    kernel["launches_by_path"] = {
        "rescore": kernel["launches"],
        "campaign": phase_campaign(epoch_ms)["launches"]}
    kernel["launches"] = sum(kernel["launches_by_path"].values())

    phase_train_step()
    train = phase_train_full()
    phase_checkpoint()
    torch.cuda.empty_cache()

    flash.update(phase_new_flash_kernels())
    torch.cuda.empty_cache()
    flash["bf16_prefill_gemma2"] = phase_gemma_prefill()
    torch.cuda.empty_cache()
    paths = flash["launches_by_path"]
    paths[GEMMA_ARCH] = phase_gemma_serve()
    torch.cuda.empty_cache()
    phase_encdec_prefill()
    torch.cuda.empty_cache()
    paths[ENCDEC_ARCH] = phase_encdec_serve()
    torch.cuda.empty_cache()
    phase_vlm_prefill()
    torch.cuda.empty_cache()
    paths[VLM_ARCH] = phase_vlm_serve()
    torch.cuda.empty_cache()
    flash.update(phase_new_flash_report())
    torch.cuda.empty_cache()

    flash.update(phase_hd112_flash())
    torch.cuda.empty_cache()
    kimi = phase_kimi()
    gmm["kimi_k2"] = kimi["gmm"]
    gmm_paths[KIMI_ARCH] = kimi["served"]["moe_gmm"]
    paths[KIMI_ARCH] = kimi["served"]["flash_attention"]
    del kimi
    torch.cuda.empty_cache()
    fabric = phase_fabric(lm["timing"])
    torch.cuda.empty_cache()
    ep = phase_ep()
    gmm["kimi_k2_ep"] = ep["gmm"]
    gmm_paths[f"{KIMI_ARCH} EP prefill, {EP_MESH[1]} ranks"] = {
        "launches": ep["launches"]["moe_gmm"]}
    paths[f"{KIMI_ARCH} EP prefill, {EP_MESH[1]} ranks"] = {
        "launches": ep["launches"]["flash_attention"]}
    sharded_train = phase_sharded_train()
    train_archs = phase_train_archs()
    sharded_serve = phase_sharded_serve()
    for arch in SHARDED_SERVE_ARCHS:
        paths[f"{arch} sharded prefill, {EP_MESH[1]} ranks"] = {
            "launches": sum(r["flash_attention"]
                            for r in sharded_serve[arch]["launches"])}
    ssd["launches_by_path"] = {
        HYBRID_ARCH: ssd["launches"],
        f"{HYBRID_ARCH} sharded prefill, {EP_MESH[1]} ranks": sum(
            r["mamba2_ssd"] for r in sharded_serve[HYBRID_ARCH]["launches"])}
    ssd["launches"] = sum(ssd["launches_by_path"].values())
    flash["sharded_rank_shape"] = sharded_serve.pop("flash_rank_shape")
    ssd["sharded_rank_shape"] = sharded_serve.pop("ssd_rank_shape")
    import shutil
    import tempfile
    dry_dir = tempfile.mkdtemp(prefix="dryrun-")
    dry_run = phase_dry_run(start_dry_runs(dry_dir), dry_dir)
    shutil.rmtree(dry_dir, ignore_errors=True)
    paths["fabric shard, " + LM_ARCH] = fabric["flash"]
    kernel["launches_by_path"]["pool worker re-score"] = \
        fabric["mpnn_mp"]["launches"]
    kernel["launches"] = sum(kernel["launches_by_path"].values())
    flash["launches"] = sum(v["launches"] for v in paths.values())
    gmm["launches_by_path"] = gmm_paths
    gmm["launches"] = sum(v["launches"] for v in gmm_paths.values())

    card = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(card)
    log(f"train: {json.dumps(train)}")
    log(f"fabric: {json.dumps(fabric['summary'])}")
    log(f"ep: {json.dumps(ep['summary'])}")
    log(f"sharded train: {json.dumps(sharded_train)}")
    log(f"train archs: {json.dumps(train_archs)}")
    log(f"sharded serve: {json.dumps(sharded_serve)}")
    log(f"dry run: {json.dumps(dry_run)}")
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    log(json.dumps({"kernels": [{
        "name": "mpnn_mp", "route": "cuda",
        "source": "src/repro_torch/kernels/mpnn_mp/mpnn_mp.cu",
        "replaces": "src/repro/kernels/mpnn_mp/mpnn_mp.py:38",
        **kernel}, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/flash_attention.py:91",
        "design": "wgmma+tma", **flash}, {
        "name": "mamba2_ssd", "route": "cuda",
        "source": "src/repro_torch/kernels/mamba2_ssd/mamba2_ssd.cu",
        "replaces": "src/repro/kernels/mamba2_ssd/mamba2_ssd.py:74",
        "design": "wgmma+tma", **ssd}, {
        "name": "rwkv6_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/rwkv6_scan/rwkv6_scan.cu",
        "replaces": "src/repro/kernels/rwkv6_scan/rwkv6_scan.py:68",
        "design": "mma", **wkv}, {
        "name": "moe_gmm", "route": "cuda",
        "source": "src/repro_torch/kernels/moe_gmm/moe_gmm.cu",
        "replaces": "src/repro/kernels/moe_gmm/moe_gmm.py:42",
        "design": "wgmma+tma", **gmm}]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
