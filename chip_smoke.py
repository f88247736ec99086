#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) end to end on one card.

    python3 chip_smoke.py [--seed N]

Phases, in order; the first failed check exits non-zero and no result is
printed:

1. device   — the card's name and count, ``nvidia-smi``'s name and power
              limit, the CUDA, nvcc and Triton versions;
2. build    — builds the kernels from ``src/repro_torch/kernels/csrc``
              (seconds, and ``-Xptxas -v``: registers and spills; a bf16
              flash kernel, forward or backward, that spills fails);
3. kernels  — each kernel against its plain PyTorch version on the card, at
              the main path's shapes and at ragged ones (the gathered
              segment-sum on a synthetic plan of fan-in 1 to 128 at the
              replay's width; flash attention: the llama3.2-1b, qwen2-7b,
              qwen2-moe-a2.7b (MHA), glm4-9b (32 / 2), qwen2-vl-2b (12 / 2)
              and nemotron-4-340b (96 / 8 of head_dim 192) prefill head
              layouts at 4096 tokens and qwen2-7b's window of 4096 at 8192,
              each also read through the
              strides of a (B, S, H, D) transpose as the prefill hands it
              over, S = 1, 65 and 1000, non-causal, windows of 512 and
              300, head_dim 128 non-causal and with a window of 200 in
              bf16, head_dim 192 in both dtypes; peaked softmax, each
              element and each row held to its tolerance), and the same
              bits twice; the flash backward (three kernels) on the same
              cases but phase 4l's layouts (held forward only) against its
              plain version (each row of dq, dk and dv
              held to its tolerance) and at the training shape (1, 8192,
              32 / 8, 64) against autograd of float32 full attention (at
              most twice the plain backward's distance plus 1e-2), and the
              forward's log-sum-exp against the plain one;
4. main path — records two congested 256-host fat-tree runs (128
              participants allreducing 1 MiB each) with the port's
              simulator, compiles the dynamic trees, lowers each into a
              replay plan, and replays both in fixed point on a seeded
              (128, 1024, 256) float32 input: the int32 results must be
              bit-identical and exact, and the replay must launch
              quantize and dequantize once and the gathered segment-sum
              once per tree level;
4c. switch  — the single-switch aggregation of fig6's software switch:
              ``packet_accumulate`` of 4096 packets of 32 float32 values
              into 1024 descriptor slots, one launch a call;
4e. failure — phase 4's world (seed 3, timeout 50 ns, noise 0.2) recorded
              three more times: go-back-N under 0.1 % packet loss (64 KiB a
              participant), go-back-N with spine 5 crashed from 20 us to
              120 us (256 KiB), and DCQCN (64 KiB); every run correct, and
              each trace replayed on the card exact, bit for bit, with
              quantize and dequantize once and the gathered segment-sum
              once per tree level;
4f. flow    — the flow backend (``get_backend("flow")``) over fig7 + fig8
              + lb, 8 repetitions, at ``fat_tree_4096`` and
              ``three_tier_4096`` (168 cells each): one batched solve on
              the card a matrix, every cell within a relative 1e-6 of the
              same solve on the CPU and 1e-4 of ``model.solve_cell``;
              lowering wall, the solve's device time and host wall, and
              Canary's goodput over one static tree's under congestion;
4b. model   — llama3.2-1b at full width (16 layers, bf16, random weights
              from seed 0) on the port's serving engine: a 4096-token
              prefill (``Engine.prefill_fn``) that must launch the flash
              kernel once a layer and agree with the same forward through
              plain full attention; then ``Engine.generate`` answers 4
              requests (16-token prompts, 32 new tokens), and a forward over
              prompt + answer must agree with the decode logits;
4g. MoE and Mamba-2 — qwen2-moe-a2.7b and mamba2-130m at full width and
              one layer period of jamba-v0.1-52b (8 of its 32 layers, every
              width kept; 32 do not fit one card) on the serving engine, each
              freed before the next: a 4096-token prefill that launches the
              flash kernel once an attention layer and nothing else, the same
              bits twice, held against plain full attention on the same MoE
              routing at 4b's bounds (the plain route's own routing differs
              only at near ties of the router, which are counted); MoE slots
              dropped at capacity by layer; the prefill profiled (device time
              in matrix products, flash, the MoE router, dispatch and
              combine, SSD and the rest); 4 requests decoded; then the bf16
              weights turned to float32 in place: the float32 decode held to
              a dropless float32 forward on the decode's routing and the
              float32 flash route to plain attention (within 1e-2), and the
              bf16 decode and prefill held to the float32 forward at 4b's
              bounds where the plain bf16 route is itself within them (at
              random weights the Mamba-2 models in bf16 are not: reported);
              parameters, init wall, prefill wall cold and warm, decode
              tok/s, peak memory;
4l. zoo     — (run after phase 5's profiles: with it before them the
              profiler recorded none of phase 5's flash backward launches)
              qwen2-7b, glm4-9b and qwen2-vl-2b at their published depth
              and width, deepseek-moe-16b (64 experts top-6, 2 shared) too,
              and nemotron-4-340b cut to 2 of its 96 layers, every width
              kept, each served as 4g serves its models and freed before
              the next: its parameter count the reference's
              (``ZOO_PARAMS``), a (1, 4096) prefill (qwen2-vl: 256 seeded
              patch embeddings in front of 3840 tokens) launching the flash
              kernel once a layer and nothing else, the same bits twice,
              held against plain attention, decode, then float32 (for
              deepseek at 14 layers and nemotron at 1: their float32
              weights would not fit beside a prefill); then qwen2-7b's
              sliding-window variant (window 4096): ``Engine.generate``
              for 8 prompts of 8192 tokens through the cache-filling
              prefill (28 flash launches with the window) and 32 decode
              steps through the ring of 4096 slots, its teacher-forced
              prefill and decode held against one windowed forward over
              prompt + answer on the plain route; and ``python
              -m repro_torch.launch.serve --arch qwen2-7b --variant full
              --sliding-window 4096`` in its own process, which must print
              its ``generated`` line;
4d. train   — llama3.2-1b at full width trained by the port's ``Trainer``
              at its published context (B = 1, S = 8192, the chunked
              attention route: the flash forward twice a layer under remat
              and the flash backward once; remat, AdamW with float32
              moments, data from ``batch_at`` with seed 0) in a one-rank
              NCCL group, ``TRAIN_STEPS`` steps of ``grad_sync="auto"``,
              then as many of ``"canary_fp"`` from the same initial state:
              every loss finite, the step-0 losses equal, the flash launches
              counted, quantize and dequantize launched once a gradient
              tensor a ``canary_fp`` step (146 a step) and one
              ``all_reduce(MAX)`` a step for the scales of the reference's
              11 stacked leaves; the first step's sync held against the
              plain versions with each leaf's scale (bit for bit on the
              embedding and a ``w_down``, within 0.5 / scale plus one
              rounding on every tensor); step walls, tokens/s, model-FLOP
              share of the bf16 peak, peak memory; one more step profiled
              (busy share, flash forward and backward device time, the
              sync's device time by part beside its bytes bound), and the
              two kernels timed at the embedding gradient's shape; then
              ``SHORT_STEPS`` ``auto`` steps at B = 4, S = 2048, the plain
              ``full_attention`` route below ``attn_chunk_threshold``;
4h. whisper — whisper-large-v3 at full width (32 encoder and 32 decoder
              layers, d 1280, bf16, random weights from seed 0, stub frames
              (4, 1500, 1280) drawn with std 0.02): ``Engine.generate`` for
              4 requests (16-token prompts, 32 new tokens), the same tokens
              twice, the decode's logits against one forward over the same
              tokens and frames at 4b's bounds where the bf16 model is
              itself within them of float32, and within 1e-2 in float32
              (the weights turned to float32 in place); then trained like
              4d at B = 8, S = 448 (Whisper's decoder context) beside the
              1500 frames, on the plain attention route: quantize and
              dequantize once a gradient tensor a ``canary_fp`` step (676),
              one ``all_reduce(MAX)`` a step for the 25 reference leaves,
              the first sync bit for bit on an encoder and a decoder
              tensor; then the workload compiler against the card: the
              gradient bytes ``canary_fp`` quantized in one step, for
              whisper and llama, equal to ``total_dp_grad_bytes`` plus the
              norms ``param_count()`` leaves out, exactly; the H100
              ``HostSpec``'s predicted forward + backward beside each
              measured step (reported); two registered scenarios
              predicted;
5. timing   — CUDA events over warm launches: each kernel beside its bound,
              its plain version and one PyTorch call for the same function
              (the gathered segment-sum: the levels of one replay summed;
              the standalone one also at a few shapes off the paths; flash
              attention also at the qwen2-7b, glm4-9b, qwen2-vl-2b and
              nemotron-4-340b heads and qwen2-7b's window, beside SDPA with
              the window as a boolean mask; the
              flash backward at the training shape beside the backward of
              ``scaled_dot_product_attention``, each of its three kernels
              beside its own bound, and the forward with and without its
              log-sum-exp store beside its plain version and SDPA's
              forward; the backward again at qwen2-moe's training shape,
              (1, 16, 4096, 128) MHA);
              then one replay and one prefill under ``torch.profiler``
              (device busy share, device time by kernel; every flash
              launch of the prefill must be the ``wgmma`` kernel);
4i. mesh    — (run after phase 5: once its processes have shared the
              card, this process's profiler drops records)
              qwen2-moe-a2.7b on (data, model) meshes of gloo processes
              that share the card (NCCL takes one rank a card): (a) one MoE
              layer at full width, tokens (B, 4096, 2048) bf16, forward and
              backward in ``ep`` at (1, 4) and (2, 2) and ``ep_a2a`` at
              (1, 4), each against ``_moe_dense`` on the same data shard
              (the same expert ids; under ``ep`` the same kept slots, y and
              every gradient within 1e-2 relative; under ``ep_a2a`` y on
              the tokens both kept whole), y and every gradient the same
              bits on each model rank, slots dropped, a rank's wall, device
              time and collectives' host wall; (b) training through the
              launcher's ``make_trainer``, depth cut to 2 layers, B 1, S
              4096, at (1, 2): ``PAR_STEPS`` steps of
              ``auto`` (EP) and of ``canary_fp`` (dense, the fixed-point
              sync over the data group) against the same steps at world 1;
              every step's loss and each gradient tensor's norm within
              ``PAR_LOSS_REL`` and ``PAR_GRAD_REL``, the weights the same
              bits on both model ranks after every step, the launches counted
              (flash forward twice and backward three times a layer, under
              remat; quantize and dequantize once a gradient tensor a
              ``canary_fp`` step), step walls, tokens/s, peak memory;
              4d and 4i each print their peaks by mode beside the
              parent's (``PARENT_PEAKS_GIB``), 4d's ``canary_fp`` also
              without its checked first step;
4j. dry run — (after 4h: it starts a fake process group, and a process
              has one default group) the dry run's pieces held to the card:
              (a) the flash custom ops against direct calls of the kernels
              at the llama prefill shape (the same bits, one forward and
              three backward launches each), 4b's and 4d's flash launches
              as before, and ``FlopCounterMode`` over one llama3.2-1b
              (1, 4096) prefill: 16 flash calls at ``flash_work``'s
              operations each, and the host time the operator layer adds
              to a ``quantize`` call; (b) ``build_dryrun`` on fake CUDA tensors
              at a one-rank fake mesh for phase 4d's ``auto`` step (B 1,
              S 8192): its FLOPs equal ``FlopCounterMode`` over one real
              step on the card, exactly, and its predicted peak lies within
              ``DRYRUN_PEAK`` of 4d's ``max_memory_allocated()`` and of
              the step's own peak (that less what the phases before it
              held); the gap attributed: the real step's blocks at its peak (the
              allocator's trace replayed) against the predicted storages
              at the dry run's, unmatched sizes by where they were made;
              its bytes accessed and the roofline's ``memory_s`` printed
              beside 4d's measured warm ``auto`` step;
              (c) (run after phase 5's profiles, before 4i: its processes
              share the card) the production rows of ``DRYRUN_ROWS``
              (``python -m repro_torch.launch.dryrun --arch <a> --shape
              <s> --mesh <m> --grad-sync <g>``: train_4k on (16, 16) of
              llama3.2-1b, jamba-v0.1-52b, qwen2-moe-a2.7b and
              mamba2-130m; llama3.2-1b's prefill_32k, decode_32k and
              long_500k on (16, 16), its train_4k on (2, 16, 16) and under
              canary_fp; decode_32k of deepseek-moe-16b and
              qwen2-moe-a2.7b), each in a subprocess of its own, all
              started together, each ``OK`` within ``DRYRUN_ROW_S``,
              printed, with its TFLOP a device, peak a device and useful
              share on a line of its own; every row's FLOPs, bytes
              accessed, link bytes, temporaries and peak must equal
              ``DRYRUN_CPU``, the CPU's integers
              (``tests/dryrun_rows.json``), exactly, whatever torch the
              card has, each printed beside the CPU's on a line;
4k. trees   — (run after 4i: its processes share the card too) the Canary
              trees' rounds on gloo ranks that share the card, each exchange
              staged through two pinned host buffers (gloo's transport sends
              host memory only; the sums stay on the card): (a)
              ``canary_allreduce_tree`` alone over n = 2, 3, 4 and 8 ranks
              (``TREE_RANKS``) on each rank's inputs drawn from ``--seed``
              and the rank (``TREE_INPUTS``: a bf16 gradient dict of
              (4096, 2048), (8192, 2048), (2048,) and (3, 5, 7), a float32
              (1000,), and the replay's (128, 1024, 256) float32), 16 blocks
              rooted by ``round_robin_roots`` and by its reverse: in fixed
              point every rank's result the same bits, under both root
              lists, and equal to the exact integer sum the CPU computes
              (``dequantize_ref`` of the ranks' summed ``quantize_ref``,
              the scale from their max), quantize and dequantize once a
              tensor a rank, one ``all_reduce(MAX)`` a call and
              2 ceil(log2 n) exchanges a tensor; in floating point the
              float32 results the bits of the same call on CPU copies over
              the same gloo group (bf16's differing elements reported);
              host walls and the bytes each rank sends; (b) llama3.2-1b at
              full width (all 16 layers) through the launcher's
              ``make_trainer`` at (data, model) = (2, 1), B 1 a rank, S
              4096: 3 steps of ``auto`` and of ``canary_fp`` held to the
              same steps at world 1 (B 2, one-rank NCCL) as 4i(b) holds
              its steps, and the first ``canary_fp`` step's sync of
              ``embed.tok`` and ``layers.0.mlp.w_down``, as AdamW gets it,
              bit for bit the two ranks' fixed-point sum (the scale from
              the reference leaf's max over both) halved; each rank's peak,
              step walls and the sync's host wall;
6. summary  — one ``{"kernels": [...]}`` JSON line (quantize and dequantize
              also give their launches by path and their times at the
              training shape), the card line, and last
              ``{"ok": true, "device": {...}}``.

It imports nothing of the JAX package. Where ``torch.cuda.is_available()``
is false, or outside a checkout of the repository, it exits non-zero.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import gc
import json
import os
import subprocess
import sys
import tempfile
import time
from collections import Counter
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
# H100 SXM, NVIDIA data sheet: HBM3 bytes/s and the dense bf16 tensor-core
# peak, the constants the workload compiler's HostSpec defaults to
from repro_torch.launch.mesh import HBM_BW as HBM_BYTES_PER_S  # noqa: E402
from repro_torch.launch.mesh import PEAK_FLOPS_BF16 as BF16_FLOPS  # noqa: E402

DEV = "cuda"
F32_FLOPS = 67e12                # FP32 outside the tensor cores, same sheet
HEAD_START_CYCLES = 40_000_000   # ~20 ms at the H100's boost clock
P, BLOCK_BYTES, MSG_BYTES = 128, 1024, 1 << 20
D = BLOCK_BYTES // 4             # float32 values per block (one packet)
BITS = 24
VARIANTS = {                     # two congestion worlds, distinct trees
    "seed3_t50": dict(seed=3, timeout_ns=50.0, noise_prob=0.2),
    "seed29_t500": dict(seed=29, timeout_ns=500.0, noise_prob=0.05),
}
# phase 4e: seed3_t50's world under loss, a spine crash and DCQCN; the
# messages cut from 1 MiB so the three recordings finish in the run's time
FAULT_WORLDS = {                 # label: (bytes a participant, SimConfig)
    "gbn_loss": (64 << 10, dict(transport="gbn", drop_prob=1e-3,
                                retx_timeout_ns=5e4)),
    "gbn_spine_crash": (256 << 10, dict(transport="gbn", faults=[
        {"kind": "switch_crash", "target": 21, "at_ns": 20000.0,
         "heal_ns": 120000.0}])),        # switch 21: spine 5 of 16
    "dcqcn": (64 << 10, dict(transport="dcqcn")),
}
# phase 4f: the sweep matrix (fig7 + fig8 + lb) at two paper-scale fabrics
FLOW_TOPOLOGIES = ("fat_tree_4096", "three_tier_4096")
FLOW_REPS = 8
ROUND_SHAPE = (128, 256, 8)      # (N, D, slots) of one reduce round
FIG6_SHAPE = (4096, 32, 1024)    # benchmarks/fig6_single_switch.py:35
SWITCH_CALLS = 3                 # fig6's timed repetitions (:41)
# (N, D, slots) off the repo's paths, timed beside zeros + index_add_: few
# slots of many rows each, up to one row a slot, and fig6 at 4x the packets
SWEEP_SHAPES = [(4096, 256, 8), (4096, 256, 64), (4096, 256, 256),
                (4096, 256, 4096), (16384, 32, 1024)]
# (name, B, H, KV, S, D, dtype, causal, window, tol, layout); the tolerances
# are those of tests/kernels/test_kernels.py:137; layout "bshd" hands the
# kernel the (B, H, S, D) transposes of (B, S, H, D) tensors, as
# layers.chunked_attention does
FLASH_CASES = [
    ("llama3.2-1b prefill", 1, 32, 8, 4096, 64, torch.bfloat16, True, 0,
     2e-2, "bhsd"),
    ("llama3.2-1b prefill, (B, S, H, D) transposed", 1, 32, 8, 4096, 64,
     torch.bfloat16, True, 0, 2e-2, "bshd"),
    ("qwen2-7b heads", 1, 28, 4, 4096, 128, torch.bfloat16, True, 0, 2e-2,
     "bhsd"),
    ("qwen2-7b heads, (B, S, H, D) transposed", 1, 28, 4, 4096, 128,
     torch.bfloat16, True, 0, 2e-2, "bshd"),
    ("qwen2-moe heads (MHA)", 1, 16, 16, 4096, 128, torch.bfloat16, True, 0,
     2e-2, "bhsd"),
    ("qwen2-moe heads (MHA), (B, S, H, D) transposed", 1, 16, 16, 4096, 128,
     torch.bfloat16, True, 0, 2e-2, "bshd"),
    ("glm4-9b heads", 1, 32, 2, 4096, 128, torch.bfloat16, True, 0, 2e-2,
     "bhsd"),
    ("glm4-9b heads, (B, S, H, D) transposed", 1, 32, 2, 4096, 128,
     torch.bfloat16, True, 0, 2e-2, "bshd"),
    ("qwen2-vl-2b heads", 1, 12, 2, 4096, 128, torch.bfloat16, True, 0, 2e-2,
     "bhsd"),
    ("qwen2-vl-2b heads, (B, S, H, D) transposed", 1, 12, 2, 4096, 128,
     torch.bfloat16, True, 0, 2e-2, "bshd"),
    ("nemotron-4-340b heads", 1, 96, 8, 4096, 192, torch.bfloat16, True, 0,
     2e-2, "bhsd"),
    ("nemotron-4-340b heads, (B, S, H, D) transposed", 1, 96, 8, 4096, 192,
     torch.bfloat16, True, 0, 2e-2, "bshd"),
    ("qwen2-7b window 4096", 1, 28, 4, 8192, 128, torch.bfloat16, True, 4096,
     2e-2, "bhsd"),
    ("qwen2-7b window 4096, (B, S, H, D) transposed", 1, 28, 4, 8192, 128,
     torch.bfloat16, True, 4096, 2e-2, "bshd"),
    ("ragged S", 2, 4, 2, 1000, 64, torch.float32, True, 0, 2e-5, "bhsd"),
    ("ragged S, bf16", 2, 4, 2, 1000, 64, torch.bfloat16, True, 0, 2e-2,
     "bhsd"),
    ("S = 1", 1, 32, 8, 1, 64, torch.bfloat16, True, 0, 2e-2, "bshd"),
    ("S = 65", 1, 32, 8, 65, 128, torch.bfloat16, True, 0, 2e-2, "bhsd"),
    ("non-causal", 1, 2, 2, 512, 64, torch.float32, False, 0, 2e-5, "bhsd"),
    ("sliding window", 1, 8, 2, 2048, 64, torch.bfloat16, True, 512, 2e-2,
     "bhsd"),
    ("window 300", 1, 8, 2, 2048, 64, torch.bfloat16, True, 300, 2e-2,
     "bshd"),
    ("non-causal, bf16, head_dim 128", 1, 4, 2, 768, 128, torch.bfloat16,
     False, 0, 2e-2, "bhsd"),
    ("window 200, head_dim 128", 1, 8, 2, 1536, 128, torch.bfloat16, True,
     200, 2e-2, "bshd"),
    ("head_dim 192", 1, 4, 2, 512, 192, torch.bfloat16, True, 0, 2e-2,
     "bhsd"),
    ("head_dim 192, f32", 1, 4, 2, 512, 192, torch.float32, True, 0, 2e-5,
     "bhsd"),
]
# timed in phase 5: the llama3.2-1b prefill (the summary's row), through
# its transpose, the head_dim 128 layouts of qwen2-7b and qwen2-moe, and
# phase 4l's (the summary's "layouts")
MHA_CASE = "qwen2-moe heads (MHA)"
# phase 4l's layouts are held forward only: phase 3's backward
# takes the other 17 cases
FORWARD_ONLY = ("glm4-9b heads", "qwen2-vl-2b heads", "nemotron-4-340b heads",
                "qwen2-7b window 4096")
ZOO_FLASH = ("qwen2-7b heads",) + FORWARD_ONLY
TIMED_FLASH = ("llama3.2-1b prefill",
               "llama3.2-1b prefill, (B, S, H, D) transposed",
               MHA_CASE) + ZOO_FLASH
# q and k are drawn at QK_SCALE and v at 1: the logits q.k/sqrt(D) then
# spread by QK_SCALE**2 = 4, the softmax is peaked and every output row is
# O(|v|). (At 0.5 the softmax is near uniform, late rows of a 4096-token
# causal case are ~0.01, and the elementwise tolerance checks almost nothing
# there.) Each row's ||got - want|| / ||want|| is held too: a fault in a few
# late tiles moves whole rows.
QK_SCALE = 2.0
# the bf16 backward's two wgmma kernels (csrc/flash_attention_bwd.cu), each
# built for head_dim 64, 128 and 192 with no spill, and the products each
# runs (the two recompute s and dp: seven where the operations bound counts
# five)
BWD_KERNELS = {"flash_bwd_dkdv_wgmma_kernel": 4, "flash_bwd_dq_wgmma_kernel": 3}
ROW_REL_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}
# the forward's log-sum-exp: s is float32 from the inputs' values in both
LSE_TOL = {torch.bfloat16: 1e-3, torch.float32: 1e-4}
GRAD_ROW_FLOOR = 1e-2
MODEL_ARCH = "llama3.2-1b"
PREFILL_LEN = 4096               # = attn_chunk_threshold: the chunked route
DECODE_BATCH, PROMPT_LEN, NEW_TOKENS, MAX_LEN = 4, 16, 32, 256
# bf16 logits of two routes through 16 random layers: the bounds are about
# twice the differences of the first card run (0.119, 94.9 %; PERF.md)
MAX_DLOGIT, MIN_ARGMAX_AGREE = 0.25, 0.90
# training at Llama 3.2's published context, 8192 tokens (the chunked
# route); B = 1 keeps the float32 cross-entropy over the 128,256-token
# vocabulary inside 80 GB. The plain full_attention route below
# attn_chunk_threshold runs a few steps at B = 4, S = 2048.
# phase 4g: (arch, layers kept or None for the published depth). Jamba's
# published 32 layers are ~52 B parameters, ~104 GB in bf16, past one 80 GB
# card: its depth is cut to one layer period (8 layers: 1 attention, 7
# Mamba-2, 4 MoE; ~13 B parameters), every width kept
MOE_SSM_MODELS = (("qwen2-moe-a2.7b", None), ("mamba2-130m", None),
                  ("jamba-v0.1-52b", 8))
# phase 4l: the zoo's other five decoders, (arch, layers kept or None for
# the published depth, layers the float32 checks keep or None for the
# same). Nemotron-4-340B's 96 layers are ~341 B parameters: cut to 2, every
# width kept (16.3 B, 32.7 GB in bf16; one layer is 3.45 B and the untied
# embedding and head 9.44 B). In float32 the weights are turned in place,
# and where that would not fit beside a prefill the float32 checks run at a
# further-cut depth: deepseek-moe-16b's 28 layers are 67.5 GB in float32
# (14 layers, 34.6 GB), nemotron's 2 are 65.4 GB (1 layer, 51.6 GB, beside
# its plain route's 6.4 GB of (1, 96, 4096, 4096) float32 logits)
ZOO_MODELS = (("qwen2-7b", None, None), ("glm4-9b", None, None),
              ("qwen2-vl-2b", None, None), ("deepseek-moe-16b", None, 14),
              ("nemotron-4-340b", 2, 1))
# phase 4l's sliding window: qwen2-7b's long_context_variant(WINDOW) (the
# reference's launch/serve.py --sliding-window) served WINDOW_BATCH
# sequences of a 2 * WINDOW-token prompt, through the cache-filling prefill
# and then decode steps through the ring of WINDOW slots, which wraps.
# WINDOW_BATCH is what the card holds beside the 15.2 GB of weights: the
# teacher-forced prefill's logits, kept for the check, are 2.49 GB a
# sequence, and the plain route's check forward over 8224 tokens holds
# ~19 GB of (1, 28, 8224, 8224) logits in bf16 and float32 besides
WINDOW_ARCH, WINDOW, WINDOW_BATCH = "qwen2-7b", 4096, 8
LAUNCHER_S = 300                 # the launcher's process, start to end
# the reference's init_params count at each (arch, depth) phase 4l runs
# (tests/test_torch_zoo_layouts.py holds them to jax.eval_shape)
ZOO_PARAMS = {("qwen2-7b", 28): 7_615_616_512,
              ("glm4-9b", 40): 9_399_767_040,
              ("qwen2-vl-2b", 28): 1_777_088_000,
              ("deepseek-moe-16b", 28): 16_879_568_896,
              ("deepseek-moe-16b", 14): 8_649_500_672,
              ("nemotron-4-340b", 2): 16_345_294_848,
              ("nemotron-4-340b", 1): 12_891_248_640}
# a routing choice that differs between two bf16 routes must be a near tie:
# its gap at the k-th choice within twice the probabilities' difference
FLIP_MARGIN_RATIO = 2.0
# float32 decode against a float32 forward, and the float32 flash route
# against plain attention, on the same routing: one function by two orders
# of sums (2e-5 for qwen2-moe-a2.7b's decode on the card)
F32_MAX_DLOGIT = 1e-2
TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_LR = 1, 8192, 4, 1e-4
SHORT_B, SHORT_S, SHORT_STEPS = 4, 2048, 2
TRAIN_MODES = ("auto", "canary_fp")
# phase 4h: whisper-large-v3 at full width. Its stub frames are drawn with
# std FRAME_STD; it trains at Whisper's published decoder context,
# max_target_positions = 448 in openai/whisper-large-v3's config, beside its
# 1500 encoder frames, at B = 8
WHISPER_ARCH = "whisper-large-v3"
WHISPER_B, WHISPER_S = 8, 448
FRAME_STD = 0.02
# the reference's init_params for whisper-large-v3: 25 leaves
WHISPER_PARAMS = 1_600_990_720
# each training run: its batch and length, the gradient tensors and the
# reference leaves reckoned from the architecture (llama: 9 a layer and 2;
# whisper: 13 a decoder layer, 8 an encoder layer and 4), the two tensors
# whose first sync is held bit for bit, the flash forward and backward
# launches a step (twice and three times a layer on the chunked route,
# under remat; none below attn_chunk_threshold), the label of its launch
# counts, and the parameters ModelConfig.param_count() leaves out
TRAIN_CASES = {
    MODEL_ARCH: dict(batch=TRAIN_B, seq=TRAIN_S, tensors=16 * 9 + 2,
                     leaves=11, checked=("embed.tok", "layers.0.mlp.w_down"),
                     flash=2 * 16, flash_bwd=3 * 16, label="train",
                     omitted=2048),
    WHISPER_ARCH: dict(batch=WHISPER_B, seq=WHISPER_S,
                       tensors=32 * 13 + 32 * 8 + 4, leaves=25,
                       checked=("encoder.0.mlp.w_down", "layers.0.mlp.w_down"),
                       flash=0, flash_bwd=0, label="train_whisper",
                       omitted=34 * 1280),
}
UNIT_ROUNDOFF = {torch.bfloat16: 2.0 ** -8, torch.float32: 2.0 ** -24}
# phase 4i: qwen2-moe-a2.7b on (data, model) meshes of gloo ranks that
# share the card (NCCL takes one rank a card). (a) One MoE layer at full
# width (d 2048, 60 experts top-4 of 1408, shared 5632), tokens (B, 4096,
# 2048) bf16, a forward and backward of sum(y^2)/n + coef * aux in each
# (form, (data, model), global batch), held against _moe_dense on one rank
# over the same data shard: ||got - want|| / ||want|| <= PAR_LAYER_REL,
# the bound phase 3 puts on bf16 rows (bf16 sums in another order)
PAR_ARCH, PAR_S, PAR_B = "qwen2-moe-a2.7b", 4096, 1
# phase 4j: the dry run's predicted peak over 4d's measured one must lie in
# DRYRUN_PEAK, set from the prediction written in PERF.md §6 before the
# first run (0-3 % below: the fake trace sees no allocator rounding and no
# cuBLAS workspace), with room either side; the production row's
# subprocess must end within DRYRUN_ROW_S
DRYRUN_PEAK = (0.90, 1.02)
DRYRUN_ROW_S = 600
# 4j(c)'s production rows, each in its own process: train_4k on (16, 16) of
# llama3.2-1b (the dense decoder), jamba-v0.1-52b (one row through Mamba-2,
# the `ep` MoE's shard_map boundary and attention), qwen2-moe-a2.7b (the
# dense MoE route: 60 experts do not split 16 ways, nor its capacity) and
# mamba2-130m (3352 projection columns, 24 heads and a vocabulary of 50280
# split unevenly); and llama3.2-1b's serving and two-pod rows, whose
# layouts the dry run gives itself: the query heads split over the model
# axis with each rank's key heads (a prefill's and a two-pod step's batch
# does not split 16 ways), and a decode's cache split along its slots,
# written and attended by each rank's share; llama3.2-1b's train_4k under
# --grad-sync canary_fp (the paper's sync on the model axis's shards); the
# decode_32k rows of the two MoE archs, whose peaks torch 2.11 and 2.13 once
# counted apart. (arch, shape, mesh, grad_sync)
DRYRUN_ROWS = tuple((a, "train_4k", "single", "auto") for a in (
    MODEL_ARCH, "jamba-v0.1-52b", "qwen2-moe-a2.7b", "mamba2-130m")) + (
    (MODEL_ARCH, "prefill_32k", "single", "auto"),
    (MODEL_ARCH, "decode_32k", "single", "auto"),
    (MODEL_ARCH, "long_500k", "single", "auto"),
    (MODEL_ARCH, "train_4k", "multi", "auto"),
    (MODEL_ARCH, "train_4k", "single", "canary_fp"),
    ("deepseek-moe-16b", "decode_32k", "single", "auto"),
    ("qwen2-moe-a2.7b", "decode_32k", "single", "auto"))
# the five integers every row must count on the card, whatever its torch:
# the CPU's, which scripts/dryrun_rows.py writes and the CPU tests
# (tests/test_torch_dryrun_moe_decode.py, tests/test_torch_dryrun_rows_*.py)
# hold; keyed (arch, shape, mesh, grad_sync)
DRYRUN_KEYS = ("flops", "bytes_accessed", "collective_link_bytes",
               "temp_bytes", "total_bytes")
DRYRUN_CPU = {tuple(k.split(":")): v for k, v in json.loads(
    (ROOT / "tests" / "dryrun_rows.json").read_text()).items()}
PAR_FORMS = (("ep", (1, 4), 1), ("ep", (2, 2), 2), ("ep_a2a", (1, 4), 1))
# the parent's peaks by mode (GiB; its chip run on an NVIDIA H100 80GB HBM3
# at 700.00 W), printed beside this run's: 4d's llama3.2-1b steps and 4i's
# largest rank at (1, 2)
PARENT_PEAKS_GIB = {("4d", MODEL_ARCH): {"auto": 34.26, "canary_fp": 34.75},
                    ("4i", PAR_ARCH): {"auto": 31.37, "canary_fp": 31.37}}
PAR_LAYER_REL, PAR_LAYER_REPS = 1e-2, 3
# (b) training through the launcher's code path at PAR_MESH, B 1, S 4096,
# depth cut from 24 to 2 layers: 1.76 B parameters, ~21 GB a rank in bf16
# weights and gradients with float32 moments (24 layers, 14.3 B, do not fit
# one rank). Held against the same steps at world 1 (dense): every step's
# loss within PAR_LOSS_REL relative and each gradient tensor's norm within
# PAR_GRAD_REL. On the H100 sound runs read at most 1.2e-4 and 3.1e-3; with
# the expert weights' gradient doubled or zeroed the norms read 1.0, while
# the losses stay within 5e-5 (at random weights they barely feel the
# experts, and AdamW's update hardly moves when a gradient is scaled), so
# the norms are what catch a wrong expert gradient
PAR_LAYERS, PAR_STEPS, PAR_MESH = 2, 3, (1, 2)
PAR_LOSS_REL, PAR_GRAD_REL = 5e-4, 1e-2
PAR_RUN = dict(arch=PAR_ARCH, layers=PAR_LAYERS, batch=PAR_B, seq=PAR_S,
               steps=PAR_STEPS, mesh=PAR_MESH)
# phase 4k: the Canary trees' rounds on gloo ranks sharing the card. (a)
# canary_allreduce_tree alone at each size of TREE_RANKS (3 is not a power
# of two), TREE_BLOCKS blocks a tensor, on each rank's TREE_INPUTS: a
# gradient dict shaped as test_one_rank_nccl_canary_fp_on_cuda's (bf16
# drawn at 1e-3, and float32) and the replay's input, each drawn on the CPU
# from --seed and the rank
TREE_RANKS, TREE_BLOCKS = (2, 3, 4, 8), 16
TREE_INPUTS = {"tok": ((4096, 2048), torch.bfloat16, 1e-3),
               "w_down": ((8192, 2048), torch.bfloat16, 1e-3),
               "scale": ((2048,), torch.bfloat16, 1e-3),
               "odd": ((3, 5, 7), torch.bfloat16, 1e-3),
               "f32": ((1000,), torch.float32, 1.0),
               "replay": ((P, MSG_BYTES // BLOCK_BYTES, D), torch.float32,
                          1.0)}
# (b) llama3.2-1b at full width, all 16 layers, through the launcher at
# (data, model) = (2, 1), B 1 a rank, S 4096, against world 1 at B 2; the
# step-0 canary_fp sync of TREE_CHECKED held bit for bit to the two ranks'
# fixed-point sum
TREE_RUN = dict(arch=MODEL_ARCH, layers=16, batch=2, seq=4096, steps=3,
                mesh=(2, 1))
TREE_CHECKED = ("embed.tok", "layers.0.mlp.w_down")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", flush=True)
    sys.exit(1)


def check(cond, msg: str) -> None:
    if not bool(cond):
        fail(msg)


def sync_wall(fn):
    """Host seconds of ``fn()`` up to a device synchronize, and its result."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def event_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn`` over ``reps`` warm launches. The
    card first spins for ``HEAD_START_CYCLES`` while the host queues the
    launches, so a call whose host side outlasts its kernels is timed on the
    card, not on the host (:func:`host_ms` times the host side)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(HEAD_START_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn, reps: int) -> float:
    """Mean host milliseconds a call of ``fn`` takes, up to a synchronize
    after ``reps`` warm calls: what a caller waits for."""
    fn()
    wall, _ = sync_wall(lambda: [fn() for _ in range(reps)])
    return wall * 1e3 / reps


def in_turns(plain, kernel, reps: int):
    """``(kernel_ms, plain_ms)``, timed plain, kernel, kernel, plain."""
    p1, k1 = event_ms(plain, reps), event_ms(kernel, reps)
    k2, p2 = event_ms(kernel, reps), event_ms(plain, reps)
    return (k1 + k2) / 2, (p1 + p2) / 2


def bound_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def flash_work(B, H, KV, S, D, dtype, causal, window):
    """``(flops, bytes)`` of one attention: 4 D operations per live
    (query, key) pair (q k^T and p v), and q, k, v, out each moved once."""
    q = np.arange(S, dtype=np.int64)
    hi = q if causal else np.full(S, S - 1)
    lo = np.maximum(q - window + 1, 0) if window > 0 else np.zeros(S, np.int64)
    pairs = int((hi - lo + 1).sum())
    esize = torch.tensor([], dtype=dtype).element_size()
    return 4 * B * H * D * pairs, esize * B * S * D * (2 * H + 2 * KV)


def flash_bound_ms(flops: int, nbytes: int, dtype) -> tuple:
    """The larger of the operations and the bytes bound, and which it is."""
    peak = BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, bound_ms(nbytes)
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def random_qkv(gen, B, H, KV, S, D, dtype, layout="bhsd"):
    """q (B, H, S, D) and k, v (B, KV, S, D); with ``layout="bshd"`` these
    are transposes of (B, S, H, D) tensors."""
    out = []
    for n, scale in ((H, QK_SCALE), (KV, QK_SCALE), (KV, 1.0)):
        shape = (B, n, S, D) if layout == "bhsd" else (B, S, n, D)
        t = (torch.randn(shape, generator=gen, device=DEV) * scale).to(dtype)
        out.append(t if layout == "bhsd" else t.transpose(1, 2))
    return out


def logit_agreement(a: torch.Tensor, b: torch.Tensor, rows: int = 1024):
    """Largest |a - b| and the share of positions whose argmax agrees,
    ``rows`` positions at a time (a float32 copy of a (4096, 256000) prefill
    is 4.2 GB); ``a`` may wait on the host, a chunk at a time going to
    ``b``'s device."""
    a, b = a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1])
    d, agree = 0.0, 0
    for i in range(0, a.shape[0], rows):
        x, y = a[i:i + rows].to(b.device), b[i:i + rows]
        d = max(d, float((x.float() - y.float()).abs().max()))
        agree += int((x.argmax(-1) == y.argmax(-1)).sum())
    return d, agree / a.shape[0]


def device_time_by_kernel(fn):
    """Host wall of ``fn`` under ``torch.profiler`` and ``{kernel name:
    (count, device us)}``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall, _ = sync_wall(fn)
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    return wall, by_name


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def max_row_rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest ``||got - want|| / ||want||`` over the rows of the last axis."""
    g, w = got.double(), want.double()
    return float(((g - w).norm(dim=-1) / w.norm(dim=-1)).max())


def phase_device():
    print("== phase 1: device", flush=True)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", flush=True)
        sys.exit(2)
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[0]
    print(f"device: {name} x{count}")
    print(f"nvidia-smi: {smi}")
    from repro_torch.kernels import _build
    nvcc = _build.find_nvcc()
    nvcc_ver = subprocess.run([nvcc, "--version"], capture_output=True,
                              text=True, check=True).stdout.strip()
    try:
        import triton
        triton_ver = triton.__version__
    except ImportError:
        triton_ver = "not installed"
    print(f"torch {torch.__version__}, torch.version.cuda {torch.version.cuda},"
          f" triton {triton_ver}")
    print(f"nvcc ({nvcc}): {nvcc_ver.splitlines()[-1]}", flush=True)
    return smi


def phase_build():
    print("== phase 2: build", flush=True)
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    b = _build.build()
    print(f"built {b.path.relative_to(ROOT)} in {b.seconds:.2f} s "
          f"(wall {time.perf_counter() - t0:.2f} s)")
    for line in b.log.splitlines():
        if ("ptxas info" in line or "spill" in line or "warning" in line
                or line.startswith("==")):
            print("  " + line.strip())
    wgmma = _build.ptxas_resources(b.log, "flash_attention_wgmma_kernel")
    for d, (regs, spills) in sorted(wgmma.items()):
        print(f"flash_attention_wgmma_kernel<{d}>: {regs} registers a thread "
              f"at launch, {spills} bytes of spill stores and loads")
    check(sorted(wgmma) == [64, 128, 192],
          f"the bf16 flash kernel was built for head sizes {sorted(wgmma)}")
    check(all(sp == 0 for _, sp in wgmma.values()),
          "a bf16 flash kernel spills registers")
    for kernel in BWD_KERNELS:
        res = _build.ptxas_resources(b.log, kernel)
        for d, (regs, spills) in sorted(res.items()):
            print(f"{kernel}<{d}>: {regs} registers a thread at launch, "
                  f"{spills} bytes of spill stores and loads")
        check(sorted(res) == [64, 128, 192],
              f"{kernel} was built for head sizes {sorted(res)}")
        check(all(sp == 0 for _, sp in res.values()),
              f"{kernel} spills registers")
    sys.stdout.flush()


def phase_kernels(x: torch.Tensor, rows: dict) -> None:
    """Each kernel against its plain version, exactly for int32 outputs."""
    print("== phase 3: kernels against their plain versions", flush=True)
    from repro_torch.kernels import (dequantize, fixed_point_scale,
                                     packet_accumulate, quantize)
    from repro_torch.kernels.ref import (dequantize_ref,
                                         packet_accumulate_ref, quantize_ref)
    gmax = x.abs().max()
    scale = fixed_point_scale(gmax, bits=BITS, world=P)
    g = np.float32(gmax.item())
    want = np.float32(2.0 ** BITS - 1.0) / (g * np.float32(P) + np.float32(1e-30))
    check(np.float32(scale.item()).view(np.int32) == want.view(np.int32),
          f"scale {scale.item()!r} != numpy float32 {want!r}")
    print(f"scale {scale.item()!r} == numpy float32 formula, bit for bit")

    err_q = 0.0
    for xin in (x, x.to(torch.bfloat16)):
        q, ref = quantize(xin, scale), quantize_ref(xin, scale)
        err_q = max(err_q, max_abs(q, ref))
        check(torch.equal(q, ref), f"quantize {xin.dtype} differs from plain")
        print(f"quantize {xin.dtype} {tuple(xin.shape)}: exact")
    q = quantize(x, scale)
    y, ref = dequantize(q, scale), dequantize_ref(q, scale)
    err_d = max_abs(y, ref)
    check(torch.equal(y, ref), "dequantize differs from plain")
    print(f"dequantize int32 {tuple(q.shape)}: exact")

    gen = torch.Generator(device=DEV).manual_seed(1)
    err_a = 0.0
    for n, d, slots in (ROUND_SHAPE, FIG6_SHAPE, (77, 200, 7), (300, 30, 50)):
        ids = torch.randint(0, slots, (n,), generator=gen, device=DEV,
                            dtype=torch.int32)
        ids[::7] = slots                         # these hit nothing
        ids[3::11] = -1
        pi = torch.randint(-1_000_000, 1_000_000, (n, d), generator=gen,
                           device=DEV, dtype=torch.int32)
        for id_t in (ids, ids.long()):
            before = packet_accumulate.launches
            got = packet_accumulate(id_t, pi, slots)
            check(packet_accumulate.launches == before + 1,
                  "packet_accumulate is not one launch a call")
            check(torch.equal(got, packet_accumulate_ref(id_t, pi, slots)),
                  f"packet_accumulate int32 {n, d, slots} ids {id_t.dtype}")
        pf = torch.randn((n, d), generator=gen, device=DEV)
        a, b = packet_accumulate(ids, pf, slots), packet_accumulate(ids, pf,
                                                                    slots)
        ref = packet_accumulate_ref(ids, pf, slots)
        check(torch.equal(a, b), f"packet_accumulate f32 not repeatable "
                                 f"{n, d, slots}")
        check(torch.allclose(a, ref, rtol=1e-5, atol=1e-5),
              f"packet_accumulate f32 {n, d, slots}: {max_abs(a, ref)}")
        err_a = max(err_a, max_abs(a, ref))
        print(f"packet_accumulate (N, D, slots)={n, d, slots}: int32 exact, "
              f"f32 max |diff| {max_abs(a, ref):.3g} (rtol=atol=1e-5), "
              f"repeatable")
    torch.cuda.synchronize()
    rows["quantize"]["max_abs_err"] = err_q
    rows["dequantize"]["max_abs_err"] = err_d
    rows["packet_accumulate"]["max_abs_err"] = err_a
    rows["packet_accumulate_gather"]["max_abs_err"] = phase_gather_kernel()
    rows["flash_attention"]["max_abs_err"] = phase_flash_kernel()
    rows["flash_attention_bwd"]["max_abs_err"] = phase_flash_bwd_kernel()


def phase_gather_kernel() -> float:
    """The gathered segment-sum against its plain version on a synthetic
    plan at the replay's width (P = 128, B = 1024, D = 256; fan-in 1 to
    128): int32 exact and equal to the sum over participants, float32
    within 1e-5 and the same bits twice."""
    from repro_torch.core.trace.executor import run_plan
    from repro_torch.core.trace.plan import lower_schedules
    from repro_torch.core.trace.synthetic import random_schedules
    from repro_torch.kernels.ref import packet_accumulate_gather_ref
    nb = MSG_BYTES // BLOCK_BYTES
    plan = lower_schedules(random_schedules(P, nb, seed=1))
    gen = torch.Generator(device=DEV).manual_seed(5)
    qi = torch.randint(-1_000_000, 1_000_000, (P, nb, D), generator=gen,
                       device=DEV, dtype=torch.int32)
    got = run_plan(plan, qi)
    check(torch.equal(got, run_plan(plan, qi,
                                    gather=packet_accumulate_gather_ref)),
          "packet_accumulate_gather int32 differs from plain")
    check(torch.equal(got, qi.sum(0, dtype=torch.int32).expand_as(qi)),
          "packet_accumulate_gather int32 is not the sum over participants")
    xf = torch.randn((P, nb, D), generator=gen, device=DEV)
    a, b = run_plan(plan, xf), run_plan(plan, xf)
    want = run_plan(plan, xf, gather=packet_accumulate_gather_ref)
    check(torch.equal(a, b), "packet_accumulate_gather f32 not repeatable")
    err = max_abs(a, want)
    check(torch.allclose(a, want, rtol=1e-5, atol=1e-5),
          f"packet_accumulate_gather f32: max |diff| {err}")
    fanin = [int(np.diff(lv.seg_offsets).max()) for lv in plan.levels]
    print(f"packet_accumulate_gather synthetic plan (P, B, D)={P, nb, D}, "
          f"{len(plan.levels)} levels, {plan.num_segments} segments, "
          f"{plan.num_sources} source rows, fan-in max by level {fanin}: "
          f"int32 exact, f32 max |diff| {err:.3g} (rtol=atol=1e-5), "
          f"repeatable", flush=True)
    return err


def phase_flash_kernel() -> float:
    """Flash attention against its plain version: every element within the
    reference test's tolerance, every row within ``ROW_REL_TOL``, the
    output in q's layout, and the same bits twice."""
    from repro_torch.kernels import flash_attention
    from repro_torch.kernels.ref import flash_attention_ref
    gen = torch.Generator(device=DEV).manual_seed(3)
    worst = 0.0
    for (name, B, H, KV, S, D, dtype, causal, window, tol,
         layout) in FLASH_CASES:
        q, k, v = random_qkv(gen, B, H, KV, S, D, dtype, layout)
        got = flash_attention(q, k, v, causal=causal, window=window)
        again = flash_attention(q, k, v, causal=causal, window=window)
        want = flash_attention_ref(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        err, rel = max_abs(got, want), max_row_rel(got, want)
        check(got.dtype == dtype and got.shape == q.shape
              and got.stride() == q.stride(),
              f"flash_attention {name}: {got.dtype} {tuple(got.shape)} "
              f"strides {got.stride()}, q's {q.stride()}")
        check(torch.equal(got, again), f"flash_attention {name}: not "
                                       f"repeatable")
        check(torch.allclose(got.float(), want.float(), rtol=tol, atol=tol),
              f"flash_attention {name}: max |diff| {err} (tol {tol})")
        check(rel <= ROW_REL_TOL[dtype], f"flash_attention {name}: a row's "
              f"relative error {rel} > {ROW_REL_TOL[dtype]}")
        worst = max(worst, err)
        print(f"flash_attention {name} q {(B, H, S, D)} kv {KV} "
              f"{str(dtype)[6:]} causal={causal} window={window}: max |diff| "
              f"{err:.3g} (rtol=atol={tol}; mean |want| "
              f"{float(want.float().abs().mean()):.3g}), max row relative "
              f"error {rel:.3g} (<= {ROW_REL_TOL[dtype]}), repeatable",
              flush=True)
        del q, k, v, got, again, want
    return worst


def grad_row_rel(got, want) -> list:
    """``max_row_rel`` of each of dq, dk and dv, a row's norm floored at
    ``GRAD_ROW_FLOOR`` of the largest row norm of the three: a row whose
    sum cancels below that (a causal q row 0 attends one key with p = 1,
    so its dq is exactly 0 in the plain version) is rounding noise of terms
    of the gradient's scale on both sides, and is held to the floor."""
    norms = [w.double().norm(dim=-1) for w in want]
    floor = GRAD_ROW_FLOOR * max(float(n.max()) for n in norms if n.numel())
    return [float(((g.double() - w.double()).norm(dim=-1)
                   / n.clamp_min(max(floor, 1e-30))).max()) if w.numel()
            else 0.0 for g, w, n in zip(got, want, norms)]


def phase_flash_bwd_kernel() -> float:
    """The flash backward against its plain version on the forward's cases,
    then at the training shape against autograd of full attention in
    float32: every row of dq, dk and dv within ``ROW_REL_TOL`` (see
    :func:`grad_row_rel`), the gradients in the inputs' dtypes and shapes,
    three launches a call and the same bits twice; the forward's
    log-sum-exp within ``LSE_TOL`` of the plain one."""
    from repro_torch.kernels import flash_attention, flash_attention_bwd
    from repro_torch.kernels.flash_attention import _forward
    from repro_torch.kernels.ref import (flash_attention_bwd_ref,
                                         flash_attention_ref)
    from repro_torch.models.layers import full_attention
    gen = torch.Generator(device=DEV).manual_seed(7)
    worst = 0.0
    for (name, B, H, KV, S, D, dtype, causal, window, _,
         layout) in FLASH_CASES:
        if name.startswith(FORWARD_ONLY):
            continue
        q, k, v = random_qkv(gen, B, H, KV, S, D, dtype, layout)
        g = torch.randn(q.shape, generator=gen, device=DEV).to(dtype)
        out, lse = _forward(q, k, v, causal, window, with_lse=True)
        want_out, want_lse = flash_attention_ref(
            q, k, v, causal=causal, window=window, return_lse=True)
        lse_err = max_abs(lse, want_lse)
        check(torch.allclose(lse, want_lse, rtol=LSE_TOL[dtype],
                             atol=LSE_TOL[dtype]),
              f"flash_attention {name}: lse max |diff| {lse_err}")
        before = flash_attention_bwd.launches
        got = flash_attention_bwd(q, k, v, out, lse, g, causal=causal,
                                  window=window)
        check(flash_attention_bwd.launches == before + 3,
              "flash_attention_bwd is not three launches a call")
        again = flash_attention_bwd(q, k, v, out, lse, g, causal=causal,
                                    window=window)
        want = flash_attention_bwd_ref(q, k, v, out, want_lse, g,
                                       causal=causal, window=window)
        torch.cuda.synchronize()
        rels = grad_row_rel(got, want)
        for t, a, b, c, rel in zip("qkv", got, want, again, rels):
            ref_in = {"q": q, "k": k, "v": v}[t]
            check(a.dtype == dtype and a.shape == ref_in.shape,
                  f"flash_attention_bwd {name}: d{t} {a.dtype} "
                  f"{tuple(a.shape)}")
            check(torch.equal(a, c), f"flash_attention_bwd {name}: d{t} not "
                                     f"repeatable")
            check(rel <= ROW_REL_TOL[dtype], f"flash_attention_bwd {name}: "
                  f"d{t} row relative error {rel} > {ROW_REL_TOL[dtype]}")
            worst = max(worst, max_abs(a, b))
        print(f"flash_attention_bwd {name} q {(B, H, S, D)} kv {KV} "
              f"{str(dtype)[6:]} causal={causal} window={window}: max row "
              f"relative error dq {rels[0]:.3g}, dk {rels[1]:.3g}, dv "
              f"{rels[2]:.3g} (<= {ROW_REL_TOL[dtype]}); lse max |diff| "
              f"{lse_err:.3g}; repeatable", flush=True)
        del q, k, v, g, out, lse, got, again, want, want_out, want_lse
    # the training shape, (B, S, H, D) as the model hands it over, against
    # the gradient of float32 full attention on the same bf16 values. The
    # backward takes delta = rowsum(dO o) from the bf16 output, as the plain
    # version does (and FlashAttention does): where p is peaked, a row of dq
    # that cancels carries that rounding of o, so the kernel is held to the
    # plain version's own distance from the float32 gradient: at most twice
    # it plus the bf16 row tolerance.
    B, H, KV, S, D = TRAIN_B, 32, 8, TRAIN_S, 64
    q, k, v = (t.transpose(1, 2) for t in random_qkv(
        gen, B, H, KV, S, D, torch.bfloat16, "bshd"))
    g = torch.randn(q.shape, generator=gen, device=DEV).to(torch.bfloat16)
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    out = flash_attention(*(t.transpose(1, 2) for t in leaves),
                          causal=True).transpose(1, 2)   # as the model calls
    got = torch.autograd.grad(out, leaves, g)
    leaves32 = [t.detach().float().requires_grad_(True) for t in (q, k, v)]
    out32 = full_attention(*leaves32, causal=True)
    want = torch.autograd.grad(out32, leaves32, g.float())
    del out32, leaves32
    tq, tk, tv, to, tg = (t.transpose(1, 2) for t in (q, k, v, out, g))
    _, lse = flash_attention_ref(tq, tk, tv, causal=True, return_lse=True)
    plain = [t.transpose(1, 2) for t in flash_attention_bwd_ref(
        tq, tk, tv, to.detach(), lse, tg, causal=True)]
    torch.cuda.synchronize()
    rels, plain_rels = grad_row_rel(got, want), grad_row_rel(plain, want)
    for t, rel, prel in zip("qkv", rels, plain_rels):
        check(rel <= 2 * prel + ROW_REL_TOL[torch.bfloat16],
              f"flash_attention_bwd at the training shape: d{t} row "
              f"relative error {rel} against float32 full attention, the "
              f"plain backward's {prel}")
    print(f"flash_attention_bwd at the training shape (B, S, H, D) "
          f"{(B, S, H, D)} kv {KV} bf16 causal, through the autograd "
          f"Function, against autograd of float32 full_attention: max row "
          f"relative error dq {rels[0]:.3g}, dk {rels[1]:.3g}, dv "
          f"{rels[2]:.3g}; the plain backward from the same bf16 output "
          f"{plain_rels[0]:.3g}, {plain_rels[1]:.3g}, {plain_rels[2]:.3g} "
          f"(held: at most twice the plain one + "
          f"{ROW_REL_TOL[torch.bfloat16]})", flush=True)
    del q, k, v, g, leaves, out, got, want, plain, lse
    torch.cuda.empty_cache()
    return worst


def phase_main_path(x: torch.Tensor, rows: dict) -> dict:
    """Record -> compile -> fixed-point replay, for both variants."""
    print("== phase 4: main path (record -> compile -> fixed-point replay)",
          flush=True)
    from repro_torch.core.canary import (Algo, AllreduceJob, Simulator,
                                         scaled_config)
    from repro_torch.core.trace import (compile_app, fixed_point_replay,
                                        lower_schedules, schedule_report)
    from repro_torch.kernels import (fixed_point_scale, launch_counts,
                                     reset_launch_counts)
    from repro_torch.kernels.ref import quantize_ref

    scale = fixed_point_scale(x.abs().max(), bits=BITS, world=P)
    exact = quantize_ref(x, scale).to(torch.int64).sum(dim=0)
    ref64 = x.double().sum(dim=0)
    replay_kernels = ("quantize", "dequantize", "packet_accumulate_gather")
    qs, plans, totals = [], [], dict.fromkeys(replay_kernels, 0)
    for label, kw in VARIANTS.items():
        cfg = scaled_config(16, trace=True, **kw)
        jobs = [AllreduceJob(app=0, participants=list(range(P)),
                             data_bytes=MSG_BYTES)]
        sim = Simulator(cfg, jobs, algo=Algo.CANARY,
                        noise_hosts=list(range(P, cfg.num_hosts)))
        t_rec, res = sync_wall(sim.run)
        check(res.correct, f"{label}: simulated allreduce incorrect")
        t_comp, scheds = sync_wall(lambda: compile_app(sim.trace, 0))
        rep = schedule_report(scheds, BLOCK_BYTES)
        check(len(scheds) == MSG_BYTES // BLOCK_BYTES == x.shape[1],
              f"{label}: {len(scheds)} schedules")

        t_low, plan = sync_wall(lambda: lower_schedules(scheds))

        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t_rep, (out, q) = sync_wall(lambda: fixed_point_replay(plan, x,
                                                               bits=BITS,
                                                               device=DEV))
        counts = launch_counts()
        depth = rep["depth_max"]
        levels = sum(lv.num_segments > 0 for lv in plan.levels)
        check(counts == {"quantize": 1, "dequantize": 1,
                         "packet_accumulate": 0,
                         "packet_accumulate_gather": levels,
                         "flash_attention": 0, "flash_attention_bwd": 0},
              f"{label}: launches {counts}, the plan has {levels} levels "
              f"with segments (depth {depth})")
        t_warm, _ = sync_wall(lambda: fixed_point_replay(plan, x, bits=BITS,
                                                         device=DEV))
        for k in replay_kernels:
            totals[k] += counts[k]
        check(q.dtype == torch.int32 and q.shape == x.shape, "q shape/type")
        check(torch.equal(q, q[:1].expand_as(q)), f"{label}: rows differ")
        check(torch.equal(q[0].to(torch.int64), exact),
              f"{label}: q is not the exact sum of the quantized inputs")
        err = float((out[0].double() - ref64).abs().max())
        tol = (P + 1) * 0.5 / scale.item()
        check(torch.isfinite(out).all() and err <= tol,
              f"{label}: |result - float64 sum| {err} > {tol}")
        qs.append(q)
        plans.append(plan)
        segs = [lv.num_segments for lv in plan.levels]
        print(f"{label}: record {t_rec:.2f} s, compile {t_comp:.2f} s, "
              f"lower {t_low * 1e3:.1f} ms ({segs} segments by level, "
              f"{plan.num_sources} source rows, {plan.scratch_rows} scratch "
              f"rows), replay {t_rep * 1e3:.2f} ms cold (plan copied to the "
              f"card), {t_warm * 1e3:.2f} ms warm, depth max "
              f"{rep['depth_max']} mean {rep['depth_mean']:.3f}, fan-in max "
              f"{rep['max_fanin']}, launches {counts}, |result - f64 sum| "
              f"{err:.3g} <= {tol:.3g}, peak "
              f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB",
              flush=True)
    check(torch.equal(qs[0], qs[1]), "q differs between the two traces")
    print(f"q bit-identical across {len(qs)} traces")
    for k, v in totals.items():
        rows[k]["launches"] = v
    return plans[0]


def phase_replay_faults(x: torch.Tensor, rows: dict) -> None:
    """Trees recorded under loss with go-back-N, under a spine crash and
    under DCQCN, each replayed in fixed point through its plan on the card:
    exact, and one launch of each kernel a level."""
    print("== phase 4e: replay of trees recorded under loss and failure",
          flush=True)
    from repro_torch.core.canary import (Algo, AllreduceJob, Simulator,
                                         scaled_config)
    from repro_torch.core.trace import (compile_app, fixed_point_replay,
                                        lower_schedules, schedule_report)
    from repro_torch.kernels import (fixed_point_scale, launch_counts,
                                     reset_launch_counts)
    from repro_torch.kernels.ref import quantize_ref

    replay_kernels = ("quantize", "dequantize", "packet_accumulate_gather")
    totals = dict.fromkeys(replay_kernels, 0)
    for label, (msg, kw) in FAULT_WORLDS.items():
        cfg = scaled_config(16, trace=True, **VARIANTS["seed3_t50"], **kw)
        jobs = [AllreduceJob(app=0, participants=list(range(P)),
                             data_bytes=msg)]
        sim = Simulator(cfg, jobs, algo=Algo.CANARY,
                        noise_hosts=list(range(P, cfg.num_hosts)))
        t_rec, res = sync_wall(sim.run)
        check(res.correct, f"{label}: simulated allreduce incorrect")
        scheds = compile_app(sim.trace, 0)
        nb = msg // BLOCK_BYTES
        check(len(scheds) == nb, f"{label}: {len(scheds)} schedules")
        rep = schedule_report(scheds, BLOCK_BYTES)
        plan = lower_schedules(scheds)
        xs = x[:, :nb].contiguous()
        scale = fixed_point_scale(xs.abs().max(), bits=BITS, world=P)
        exact = quantize_ref(xs, scale).to(torch.int64).sum(dim=0)

        reset_launch_counts()
        t_cold, (out, q) = sync_wall(lambda: fixed_point_replay(
            plan, xs, bits=BITS, device=DEV))
        counts = launch_counts()
        levels = sum(lv.num_segments > 0 for lv in plan.levels)
        check(counts == {"quantize": 1, "dequantize": 1,
                         "packet_accumulate": 0,
                         "packet_accumulate_gather": levels,
                         "flash_attention": 0, "flash_attention_bwd": 0},
              f"{label}: launches {counts}, the plan has {levels} levels "
              f"with segments")
        for k in replay_kernels:
            totals[k] += counts[k]
        t_warm = sorted(sync_wall(lambda: fixed_point_replay(
            plan, xs, bits=BITS, device=DEV))[0] for _ in range(5))[2]
        check(q.dtype == torch.int32 and q.shape == xs.shape, "q shape/type")
        check(torch.equal(q, q[:1].expand_as(q)), f"{label}: rows differ")
        check(torch.equal(q[0].to(torch.int64), exact),
              f"{label}: q is not the exact sum of the quantized inputs")
        err = float((out[0].double() - xs.double().sum(dim=0)).abs().max())
        tol = (P + 1) * 0.5 / scale.item()
        check(torch.isfinite(out).all() and err <= tol,
              f"{label}: |result - float64 sum| {err} > {tol}")
        drops = {k: v for k, v in res.drop_causes.items() if v}
        faults = [(e["phase"], e["target"], e["t_ns"])
                  for e in res.fault_events]
        print(f"{label}: {msg >> 10} KiB a participant, record {t_rec:.2f} s "
              f"(simulated {res.duration_ns / 1e3:.1f} us), correct "
              f"{res.correct}, {res.dropped_packets} drops {drops}, "
              f"transport {res.transport_stats}, fault events {faults}, "
              f"generations max "
              f"{max(s.gen for s in scheds)} ({sum(s.gen > 0 for s in scheds)}"
              f" of {nb} blocks re-issued), depth max {rep['depth_max']} "
              f"mean {rep['depth_mean']:.3f}, fan-in max {rep['max_fanin']}, "
              f"{[lv.num_segments for lv in plan.levels]} segments by level; "
              f"replay {t_cold * 1e3:.2f} ms cold, {t_warm * 1e3:.2f} ms warm "
              f"(median of 5), launches {counts}, exact, |result - f64 sum| "
              f"{err:.3g} <= {tol:.3g}", flush=True)
    for k, n in totals.items():
        rows[k].setdefault("paths", {})["replay_faults"] = n


def phase_flow() -> None:
    """The flow backend's batched solve on the card over the sweep matrix
    at two paper-scale fabrics, held to the same solve on the CPU and to
    the pure-Python model."""
    print("== phase 4f: the flow backend on the card", flush=True)
    import statistics

    from repro_torch.core.canary import get_backend
    from repro_torch.core.flow import batch, suites
    from repro_torch.core.flow.backend import FlowBackend
    from repro_torch.core.flow.model import lower_item, solve_cell

    def rel(a, b):
        return abs(a - b) / abs(b)

    for topo in FLOW_TOPOLOGIES:
        items = [it for s in suites.SUITES
                 for it in suites.expand_suite(s, topo, FLOW_REPS)]
        t_low, cells = sync_wall(lambda: [lower_item(it) for it in items])
        t_cold = sync_wall(lambda: batch.run_batch(cells))[0]
        bk = get_backend("flow")
        check(bk.device.type == "cuda", f"flow backend on {bk.device}")
        solves = batch.trace_count()
        t_cells, got = sync_wall(lambda: bk.run_cells(items))
        check(batch.trace_count() - solves == 1 and bk.jit_calls == 1
              and all(c["jit_traces"] == 1 for c in got),
              f"{topo}: {batch.trace_count() - solves} batched solves")
        cpu = FlowBackend(device="cpu").run_cells(items)
        worst_cpu = worst_py = 0.0
        for c, w, cell in zip(got, cpu, cells):
            t_py, gp_py = solve_cell(cell)
            worst_cpu = max(worst_cpu, rel(c["runtime_us"], w["runtime_us"]),
                            rel(c["goodput_gbps"], w["goodput_gbps"]))
            worst_py = max(worst_py, rel(c["runtime_us"] * 1e3, t_py),
                           rel(c["goodput_gbps"], gp_py))
            check(c["bound"] == w["bound"] and c["label"] == w["label"],
                  f"{topo}: cell {c['label']} differs from the CPU's")
        check(worst_cpu <= 1e-6, f"{topo}: card vs CPU {worst_cpu:.3g}")
        check(worst_py <= 1e-4, f"{topo}: card vs solve_cell {worst_py:.3g}")
        walls = sorted(sync_wall(lambda: batch.run_batch(cells))[0]
                       for _ in range(5))
        load, g, s = batch.pack(cells)
        solve_ms = event_ms(lambda: batch.solve(load, g, s), 100)
        bounds = {b: sum(c["bound"] == b for c in got) for b in ("bw", "mix")}

        def mean_gp(label):
            return statistics.mean(c["goodput_gbps"] for c in got
                                   if c["label"] == label)
        ratio = mean_gp("canary/cong=1") / mean_gp("static1/cong=1")
        print(f"flow {topo}: {len(items)} cells ({load.shape[1]} links "
              f"padded), lowering {t_low:.3f} s, run_batch host wall "
              f"{t_cold * 1e3:.3f} ms cold, {walls[2] * 1e3:.3f} ms warm "
              f"(median of 5), run_cells {t_cells * 1e3:.2f} ms (its lowering"
              f" and one batched solve), the solve "
              f"{solve_ms * 1e3:.2f} us of device time (CUDA events); bound "
              f"{bounds}; card vs CPU {worst_cpu:.3g}, vs solve_cell "
              f"{worst_py:.3g}; canary / static1 goodput under congestion "
              f"{ratio:.4f} ({mean_gp('canary/cong=1'):.2f} / "
              f"{mean_gp('static1/cong=1'):.2f} Gb/s)", flush=True)


def phase_switch(rows: dict) -> None:
    """fig6's software switch: 4096 packets of 32 float32 values summed
    into 1024 descriptor slots by ``packet_accumulate``, one launch a
    call, held against its plain version."""
    print("== phase 4c: single-switch aggregation (fig6's software switch)",
          flush=True)
    from repro_torch.kernels import (launch_counts, packet_accumulate,
                                     reset_launch_counts)
    from repro_torch.kernels.ref import packet_accumulate_ref
    n, d, slots = FIG6_SHAPE
    gen = torch.Generator(device=DEV).manual_seed(6)
    ids = torch.randint(0, slots, (n,), generator=gen, device=DEV,
                        dtype=torch.int32)
    pay = torch.randn((n, d), generator=gen, device=DEV)
    reset_launch_counts()
    outs = [packet_accumulate(ids, pay, slots) for _ in range(SWITCH_CALLS)]
    counts = launch_counts()
    check(counts == {"quantize": 0, "dequantize": 0,
                     "packet_accumulate": SWITCH_CALLS,
                     "packet_accumulate_gather": 0, "flash_attention": 0,
                     "flash_attention_bwd": 0},
          f"switch launches {counts}")
    want = packet_accumulate_ref(ids, pay, slots)
    for out in outs:
        check(out.shape == (slots, d) and torch.isfinite(out).all()
              and torch.equal(out, outs[0])
              and torch.allclose(out, want, rtol=1e-5, atol=1e-5),
              "switch aggregation differs from the plain version")
    rows["packet_accumulate"]["launches"] = counts["packet_accumulate"]
    print(f"switch: {SWITCH_CALLS} calls of (N, D, slots)={FIG6_SHAPE}, "
          f"launches {counts}, max |diff| {max_abs(outs[0], want):.3g} "
          f"(rtol=atol=1e-5), repeatable", flush=True)


def phase_model(rows: dict, seed: int):
    """llama3.2-1b at full width on the serving engine: a 4096-token
    prefill through the flash kernel, held against plain full attention;
    then greedy decode for 4 requests, held against a forward."""
    print("== phase 4b: model path (llama3.2-1b prefill and decode)",
          flush=True)
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import forward, get_config
    from repro_torch.serving import Engine, ServeConfig

    cfg = get_config(MODEL_ARCH, "full")
    sc = ServeConfig(model=cfg, batch=DECODE_BATCH, max_len=MAX_LEN)
    torch.cuda.reset_peak_memory_stats()
    t_init, engine = sync_wall(lambda: Engine(sc, seed=seed, device=DEV))
    n_params = sum(p.numel() for p in engine.params.parameters())
    print(f"{cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.num_heads}/{cfg.num_kv_heads} heads of {cfg.head_dim}, "
          f"{n_params / 1e9:.3f} B parameters ({cfg.dtype}), init "
          f"{t_init:.2f} s", flush=True)
    gen = torch.Generator(device=DEV).manual_seed(seed + 1)
    prompt = torch.randint(0, cfg.vocab_size, (1, PREFILL_LEN), generator=gen,
                           device=DEV, dtype=torch.int32)

    reset_launch_counts()
    t_cold, (logits, _) = sync_wall(
        lambda: engine.prefill_fn(engine.params, prompt, {}))
    counts = launch_counts()
    check(counts == {"quantize": 0, "dequantize": 0, "packet_accumulate": 0,
                     "packet_accumulate_gather": 0,
                     "flash_attention": cfg.num_layers,
                     "flash_attention_bwd": 0},
          f"prefill launches {counts}, want flash_attention x "
          f"{cfg.num_layers}")
    rows["flash_attention"]["launches"] = counts["flash_attention"]
    check(tuple(logits.shape) == (1, PREFILL_LEN, cfg.vocab_size)
          and logits.dtype == torch.bfloat16,
          f"prefill logits {logits.dtype} {tuple(logits.shape)}")
    check(torch.isfinite(logits).all(), "prefill logits not finite")
    t_warm, _ = sync_wall(lambda: engine.prefill_fn(engine.params, prompt,
                                                    {})[0].shape)
    full_cfg = cfg.with_(attn_chunk_threshold=1 << 30)
    with torch.inference_mode():
        full, _ = forward(engine.params, prompt, full_cfg)
    d, agree = logit_agreement(logits, full)
    print(f"prefill (1, {PREFILL_LEN}): launches {counts}, wall {t_cold:.3f} s"
          f" cold, {t_warm * 1e3:.1f} ms warm; against plain full attention:"
          f" max |dlogit| {d:.4g} (<= {MAX_DLOGIT}), argmax agrees on "
          f"{agree:.2%} (>= {MIN_ARGMAX_AGREE:.0%}) of positions", flush=True)
    check(d <= MAX_DLOGIT and agree >= MIN_ARGMAX_AGREE,
          f"chunked and full prefill routes differ: {d}, {agree}")
    # both bf16 routes against a float32 forward over the same weights
    params32 = copy.deepcopy(engine.params).to(torch.float32)
    with torch.inference_mode():
        truth, _ = forward(params32, prompt, cfg.with_(dtype="float32"))
    del params32
    for route, lg in (("chunked (flash kernel)", logits),
                      ("full (plain)", full)):
        d32, agree32 = logit_agreement(lg, truth)
        print(f"prefill {route} route against a float32 forward: max "
              f"|dlogit| {d32:.4g}, argmax agrees on {agree32:.2%}")
        check(d32 <= MAX_DLOGIT and agree32 >= MIN_ARGMAX_AGREE,
              f"the {route} route is far from the float32 forward: {d32}, "
              f"{agree32}")
    del logits, full, truth

    prompts = torch.randint(0, cfg.vocab_size, (DECODE_BATCH, PROMPT_LEN),
                            generator=gen, device=DEV, dtype=torch.int32)
    reset_launch_counts()
    tokens, stats = engine.generate(prompts, NEW_TOKENS)
    dcounts = launch_counts()
    check(tokens.dtype == torch.int32
          and tuple(tokens.shape) == (DECODE_BATCH, NEW_TOKENS)
          and int(tokens.min()) >= 0 and int(tokens.max()) < cfg.vocab_size,
          f"generated tokens {tokens.dtype} {tuple(tokens.shape)}")
    check(engine.cache["pos"] == PROMPT_LEN + NEW_TOKENS - 1,
          f"cache pos {engine.cache['pos']}")
    # decode consistency: teacher-force prompt + answer on a fresh cache as
    # generate runs them, against one forward over the same 48 tokens
    seq = torch.cat([prompts, tokens], dim=1)
    replay = Engine(sc, params=engine.params, device=DEV)
    dec = teacher_forced(replay, seq, PROMPT_LEN)
    check(torch.isfinite(dec).all(), "decode logits not finite")
    greedy = dec[:, PROMPT_LEN - 1:-1].argmax(-1).to(torch.int32)
    check(torch.equal(greedy, tokens),
          "generate's tokens are not the argmax of the same decode steps")
    fwd, _ = engine.prefill_fn(engine.params, seq, {})
    d2, agree2 = logit_agreement(dec, fwd)
    print(f"decode: {DECODE_BATCH} requests x {NEW_TOKENS} tokens "
          f"(prompts of {PROMPT_LEN}, max_len {MAX_LEN}), launches {dcounts},"
          f" prefill {stats['prefill_s'] * 1e3:.1f} ms ("
          f"{prefill_route(engine)}), decode "
          f"{stats['decode_s'] * 1e3:.1f} ms = "
          f"{stats['decode_tok_per_s']:.1f} tok/s; forward over the "
          f"{seq.shape[1]} tokens against the decode logits: max |dlogit| "
          f"{d2:.4g}, argmax agrees on {agree2:.2%}", flush=True)
    check(d2 <= MAX_DLOGIT and agree2 >= MIN_ARGMAX_AGREE,
          f"decode and forward logits differ: {d2}, {agree2}")
    print(f"model path: peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    del replay, dec, fwd
    return engine, prompt


class Routes:
    """Record the port's MoE routing decisions (``(top_w, top_e, aux,
    probs)`` of every ``moe._route`` call, on the device), or hand recorded
    ones back in order, by standing in for ``repro_torch.models.moe._route``.
    Two bf16 routes through a model (flash and plain attention, decode and
    forward) differ in the last bits of each MoE layer's input, so a token
    whose router probabilities nearly tie at the k-th choice may pick
    another expert in each; replaying one route's decisions in the other
    compares the two on the same routing."""

    def __init__(self):
        from repro_torch.models import moe
        self.moe, self.orig = moe, moe._route

    @contextlib.contextmanager
    def record(self):
        calls = []

        def route(p, x2d, cfg):
            out = self.orig(p, x2d, cfg)
            probs = torch.softmax(x2d.to(torch.float32) @ p.router, dim=-1)
            calls.append((*out, probs))
            return out
        self.moe._route = route
        try:
            yield calls
        finally:
            self.moe._route = self.orig

    @contextlib.contextmanager
    def replay(self, calls):
        it = iter(calls)

        def route(p, x2d, cfg):
            w, e, aux, _ = next(it)
            check(e.shape[0] == x2d.shape[0], f"replayed routing of "
                  f"{e.shape[0]} tokens where {x2d.shape[0]} are routed")
            return w.to(x2d.device), e, aux
        self.moe._route = route
        try:
            yield
        finally:
            self.moe._route = self.orig


def route_flips(ref_calls, calls) -> tuple:
    """``(tokens whose chosen experts differ, the largest ratio of the
    reference's k-th-choice gap to the two probabilities' difference at such
    a token)``."""
    check(len(ref_calls) == len(calls), f"{len(ref_calls)} and {len(calls)} "
          f"routing calls")
    flips, worst = 0, 0.0
    for (_, e1, _, p1), (_, e2, _, p2) in zip(ref_calls, calls):
        k = e1.shape[1]
        diff = (e1.sort(-1).values != e2.sort(-1).values).any(-1)
        n = int(diff.sum())
        if n:
            top = p1.topk(k + 1, dim=-1).values
            margin = (top[:, k - 1] - top[:, k])[diff]
            noise = (p1 - p2).abs().amax(-1)[diff]
            worst = max(worst, float((margin / noise.clamp_min(1e-30)).max()))
            flips += n
    return flips, worst


def flips_note(flips: int, ratio: float) -> str:
    if not flips:
        return "every token-layer choice the same"
    return (f"{flips} token-layer choices differ, each a near tie (its gap "
            f"at most {ratio:.3g} x the probabilities' difference)")


def dropped_slots(calls, cfg) -> list:
    """Slots each MoE layer drops at its capacity, from its routing."""
    from repro_torch.models.moe import _capacity, _dispatch_indices
    out = []
    for _, e, _, _ in calls:
        _, pos, _ = _dispatch_indices(e, cfg.moe_top_k, cfg.moe_experts)
        out.append(int((pos >= _capacity(e.shape[0], cfg)).sum()))
    return out


def decode_routes_as_forward(step_calls, n_moe: int, batch: int) -> list:
    """The routing of T decode steps (``n_moe`` calls a step, ``batch``
    tokens each) as one forward over the (batch, T) tokens routes them:
    per MoE layer, token ``b * T + t``."""
    if not n_moe:
        return []
    T = len(step_calls) // n_moe
    out = []
    for layer in range(n_moe):
        per = [step_calls[t * n_moe + layer] for t in range(T)]
        w, e, p = (torch.stack([c[i] for c in per], 1).reshape(
            batch * T, -1) for i in (0, 1, 3))
        out.append((w, e, per[0][2], p))
    return out


def teacher_forced(replay, seq: torch.Tensor, prompt_len: int
                   ) -> torch.Tensor:
    """The logits of every position of ``seq`` on ``replay``'s fresh cache,
    filled as ``Engine.generate`` fills it: the first ``prompt_len`` tokens
    in one forward that writes the cache where the engine prefills so
    (``prefills_in_one_forward``), else a decode step a token, and the rest
    a decode step a token. Generate's tokens are the argmax of these
    logits bit for bit."""
    steps, start = [], 0
    if replay.prefills_in_one_forward:
        pre, _ = replay.prefill_fn(replay.params, seq[:, :prompt_len],
                                   {"cache": replay.cache})
        steps, start = list(pre.unbind(1)), prompt_len
    for t in range(start, seq.shape[1]):
        _, lg, replay.cache = replay.step_fn(replay.params, replay.cache,
                                             seq[:, t:t + 1])
        steps.append(lg[:, 0])
    return torch.stack(steps, dim=1)


def prefill_route(engine) -> str:
    return ("one forward filling the cache"
            if engine.prefills_in_one_forward else "a decode step a token")


def held_beside(what: str, a, b, ref=None) -> str:
    """Hold ``a`` against ``b`` at phase 4b's bounds, unconditionally or,
    given ``ref`` (the ``(max |dlogit|, argmax agreement)`` of a plain bf16
    route against the float32 forward over the same weights), where that
    is itself within them: where the bf16 model is farther from its float32
    self, two of its bf16 routes that differ in every layer cannot be held
    to the bounds either, and the comparison is reported and left to the
    float32 checks."""
    d, agree = logit_agreement(a, b)
    text = f"max |dlogit| {d:.4g}, argmax agrees on {agree:.2%}"
    if ref is not None and (ref[0] > MAX_DLOGIT
                            or ref[1] < MIN_ARGMAX_AGREE):
        return (f"{text} (not held: the plain bf16 route is itself "
                f"{ref[0]:.4g} and {ref[1]:.2%} from float32)")
    check(d <= MAX_DLOGIT and agree >= MIN_ARGMAX_AGREE,
          f"{what}: max |dlogit| {d}, argmax agrees on {agree}")
    return f"{text} (<= {MAX_DLOGIT}, >= {MIN_ARGMAX_AGREE:.0%})"


def _kernels_under(ev) -> list:
    out = list(ev.kernels)
    for ch in ev.cpu_children:
        out.extend(_kernels_under(ch))
    return out


def _is_product(name: str) -> bool:
    low = name.lower()
    return ("gemm" in low or "sm90_xmma" in name or "cutlass" in low
            or "nvjet" in name)


def profile_split(fn) -> dict:
    """One call of ``fn`` under ``torch.profiler``, with each MoE and SSD
    function in a ``record_function`` range: device microseconds of the
    flash kernel, the matrix products outside the router and SSD, the MoE
    router, the MoE dispatch and combine (sort, search, scatter, gather and
    the weighted sum; ``_moe_dense`` less the router and the expert
    products), SSD (``ssd_chunked``) and the rest, and the wall; also the
    flash launches the trace holds beside those its wrapper counted in the
    call (the profiler has dropped records after a served model: a trace
    that holds fewer gives a split that is not verified)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import mamba2, moe
    names = {"moe._route": (moe, "_route"),
             "moe._expert_ffn": (moe, "_expert_ffn"),
             "moe._moe_dense": (moe, "_moe_dense"),
             "mamba2.ssd_chunked": (mamba2, "ssd_chunked")}

    def ranged(label, f):
        def call(*a, **kw):
            with record_function(label):
                return f(*a, **kw)
        return call
    saved = {label: getattr(m, n) for label, (m, n) in names.items()}
    for label, (m, n) in names.items():
        setattr(m, n, ranged(label, saved[label]))
    try:
        torch.cuda.synchronize()
        reset_launch_counts()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall, _ = sync_wall(fn)
        counted = launch_counts()["flash_attention"]
    finally:
        for label, (m, n) in names.items():
            setattr(m, n, saved[label])
    events = prof.events()
    # the ranges also appear on the device's timeline: leave them out
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and e.name not in names]
    busy = sum(e.time_range.elapsed_us() for e in device)
    by_name: dict = {}
    for e in device:
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    under = {label: [] for label in names}
    for e in events:
        if e.name in under and e.device_type == DeviceType.CPU:
            under[e.name].extend(_kernels_under(e))
    tot = {label: sum(k.duration for k in ks) for label, ks in under.items()}
    prod_in = sum(k.duration for label in ("moe._route", "mamba2.ssd_chunked")
                  for k in under[label] if _is_product(k.name))
    out = dict(
        wall_us=wall * 1e6, busy_us=busy, launches=len(device),
        flash=sum(e.time_range.elapsed_us() for e in device
                  if "flash_attention" in e.name),
        flash_launches=sum("flash_attention" in e.name for e in device),
        flash_counted=counted,
        products=sum(e.time_range.elapsed_us() for e in device
                     if _is_product(e.name)) - prod_in,
        moe_router=tot["moe._route"],
        moe_dispatch_combine=tot["moe._moe_dense"] - tot["moe._route"]
        - tot["moe._expert_ffn"],
        ssd=tot["mamba2.ssd_chunked"],
        top=sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8])
    out["rest"] = busy - sum(out[k] for k in (
        "flash", "products", "moe_router", "moe_dispatch_combine", "ssd"))
    return out


def serve_model(arch: str, layers, seed: int, f32_layers=None) -> int:
    """One configuration at full width on the serving engine (phases 4g
    and 4l).

    Returns the flash launches of its counted prefill.

    bf16: a prefill through the flash kernel (one launch an attention
    layer, nothing else launched, the same bits twice), plain full
    attention on the same MoE routing (held at phase 4b's bounds) and on
    its own (choices that differ counted, each a near tie), the prefill
    profiled, greedy decode for ``DECODE_BATCH`` requests (its tokens the
    argmax of the same steps replayed) and a dropless forward over prompt +
    answer on the decode's routing. Then the weights turned to float32 in
    place (two
    copies at full depth do not fit): the prompt forwarded on the prefill's
    routing through both attention routes, and the replayed steps decoded
    again against a dropless forward on their routing, each pair within
    ``F32_MAX_DLOGIT``; the bf16 decode and prefill against the float32
    ones as :func:`held_beside` says.

    With ``f32_layers`` below the depth (float32 weights of the whole
    depth would not fit beside a prefill), the bf16 decode and flash
    routes are held to their forward and plain attention at this depth
    unconditionally, and the float32 checks run on the first
    ``f32_layers`` layers, the rest freed, with the bf16 prefill, plain
    route, decode and forward recomputed there on the recorded routing.
    A VLM's prefill takes its ``num_patches`` patch embeddings (seeded,
    std 0.02) in front of ``PREFILL_LEN - num_patches`` tokens; it decodes
    text, as the engine serves it. Where ``ZOO_PARAMS`` names the
    configuration, its parameter count must be the reference's."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import forward, get_config
    from repro_torch.serving import Engine, ServeConfig

    cfg = get_config(arch, "full")
    if layers is not None:
        cfg = cfg.with_(num_layers=layers)
    n_attn = sum(cfg.layer_kind(i) == "attn" for i in range(cfg.num_layers))
    n_moe = sum(map(cfg.layer_is_moe, range(cfg.num_layers)))
    routes = Routes()
    sc = ServeConfig(model=cfg, batch=DECODE_BATCH, max_len=MAX_LEN)
    torch.cuda.reset_peak_memory_stats()
    t_init, engine = sync_wall(lambda: Engine(sc, seed=seed, device=DEV))
    n_params = sum(p.numel() for p in engine.params.parameters())
    want_params = ZOO_PARAMS.get((arch, cfg.num_layers))
    check(want_params in (None, n_params), f"{cfg.name}: {n_params} "
          f"parameters, the reference's init_params holds {want_params}")
    cut = "" if layers is None else f" (depth cut to {layers} layers)"
    heads = (f"{cfg.num_heads}/{cfg.num_kv_heads} heads of "
             f"{cfg.resolved_head_dim}, " if n_attn else "")
    print(f"{cfg.name}{cut}: {cfg.num_layers} layers ({n_attn} attention, "
          f"{cfg.num_layers - n_attn} Mamba-2, {n_moe} MoE), d_model "
          f"{cfg.d_model}, {heads}{n_params / 1e9:.3f} B parameters"
          + (" (the reference's count)" if want_params else "")
          + f" ({cfg.dtype}), init {t_init:.2f} s", flush=True)
    gen = torch.Generator(device=DEV).manual_seed(seed + 1)
    prompt = torch.randint(0, cfg.vocab_size,
                           (1, PREFILL_LEN - cfg.num_patches), generator=gen,
                           device=DEV, dtype=torch.int32)
    extra = {}
    if cfg.num_patches:
        extra["extra_embeds"] = (torch.randn(
            (1, cfg.num_patches, cfg.d_model), generator=gen, device=DEV)
            * 0.02).to(torch.bfloat16)

    def prefill():
        return engine.prefill_fn(engine.params, prompt, extra)[0]

    reset_launch_counts()
    t_cold, logits = sync_wall(prefill)
    counts = launch_counts()
    want = {k: 0 for k in counts}
    want["flash_attention"] = n_attn
    check(counts == want, f"{cfg.name} prefill launches {counts}, want "
          f"flash_attention x {n_attn} and nothing else")
    check(tuple(logits.shape) == (1, PREFILL_LEN, cfg.vocab_size)
          and logits.dtype == torch.bfloat16 and torch.isfinite(logits).all(),
          f"{cfg.name} prefill logits {logits.dtype} {tuple(logits.shape)}")
    t_warm, _ = sync_wall(lambda: prefill().shape)
    with routes.record() as flash_routes:
        again = prefill()
    check(torch.equal(again, logits), f"{cfg.name}: two prefills differ")
    del again
    drops = dropped_slots(flash_routes, cfg)
    slots = PREFILL_LEN * cfg.moe_top_k
    print(f"prefill (1, {PREFILL_LEN}): launches {counts}, wall {t_cold:.3f} "
          f"s cold, {t_warm * 1e3:.1f} ms warm, the same bits twice"
          + (f"; MoE slots dropped at capacity (factor "
             f"{cfg.moe_capacity_factor}, {slots} slots a layer) by layer "
             f"{drops}, {sum(drops) / (slots * n_moe):.1%} in all"
             if n_moe else ""), flush=True)
    full_cfg = cfg.with_(attn_chunk_threshold=1 << 30)
    plain, plain_note = None, ""
    if n_attn:
        with torch.inference_mode(), routes.replay(flash_routes):
            plain, _ = forward(engine.params, prompt, full_cfg, **extra)
        with torch.inference_mode(), routes.record() as own:
            plain_own, _ = forward(engine.params, prompt, full_cfg, **extra)
        flips, ratio = route_flips(flash_routes, own)
        check(ratio <= FLIP_MARGIN_RATIO, f"{cfg.name}: a routing choice "
              f"flipped with a gap {ratio} x the probabilities' difference")
        d_own, agree_own = logit_agreement(logits, plain_own)
        del plain_own, own
        plain_note = (f"; on its own routing {flips_note(flips, ratio)}, max "
                      f"|dlogit| {d_own:.4g}, argmax agrees on "
                      f"{agree_own:.2%}")
    split = profile_split(prefill)
    busy = split["busy_us"]
    check(busy > 0, f"{cfg.name}: the profiler saw no device activity")
    parts = ", ".join(f"{k.replace('_', ' ')} {split[k] / 1e3:.2f} ms "
                      f"({split[k] / busy:.1%})"
                      for k in ("products", "flash", "moe_router",
                                "moe_dispatch_combine", "ssd", "rest"))
    seen, counted = split["flash_launches"], split["flash_counted"]
    trace = (f"the trace holds the {counted} flash launches counted"
             if seen == counted else f"UNVERIFIED: the trace holds {seen} of "
             f"the {counted} flash launches counted")
    print(f"profiled prefill ({trace}): wall {split['wall_us'] / 1e3:.1f} "
          f"ms, device busy {busy / 1e3:.2f} ms "
          f"({busy / split['wall_us']:.1%} of the wall), {split['launches']} "
          f"launches ({seen} flash); {parts}", flush=True)
    for name, (n, us) in split["top"]:
        print(f"  {n:6d} x {us / n:9.2f} us = {us / 1e3:8.2f} ms  "
              f"{name[:90]}")

    # decode: generate, then the same tokens teacher-forced through decode
    # steps on a fresh cache (generate's tokens must be their argmax)
    prompts = torch.randint(0, cfg.vocab_size, (DECODE_BATCH, PROMPT_LEN),
                            generator=gen, device=DEV, dtype=torch.int32)
    tokens, stats = engine.generate(prompts, NEW_TOKENS)
    check(tokens.dtype == torch.int32
          and tuple(tokens.shape) == (DECODE_BATCH, NEW_TOKENS)
          and int(tokens.min()) >= 0 and int(tokens.max()) < cfg.vocab_size,
          f"{cfg.name}: generated {tokens.dtype} {tuple(tokens.shape)}")
    seq = torch.cat([prompts, tokens], dim=1)
    step_wall, by_name = device_time_by_kernel(
        lambda: engine.step_fn(engine.params, engine.cache, tokens[:, -1:]))
    step_busy = sum(us for _, us in by_name.values())
    step_note = (f"; one more step profiled: wall {step_wall * 1e3:.1f} ms, "
                 f"device busy {step_busy / 1e3:.2f} ms "
                 f"({step_busy / (step_wall * 1e6):.1%}), "
                 f"{sum(n for n, _ in by_name.values())} launches")
    del engine.cache

    def replayed(model_cfg):
        return teacher_forced(
            Engine(ServeConfig(model=model_cfg, batch=DECODE_BATCH,
                               max_len=MAX_LEN),
                   params=engine.params, device=DEV), seq, PROMPT_LEN)

    with routes.record() as step_routes:
        dec = replayed(cfg)
    check(torch.isfinite(dec).all(), f"{cfg.name}: decode logits not finite")
    check(torch.equal(dec[:, PROMPT_LEN - 1:-1].argmax(-1).to(torch.int32),
                      tokens), f"{cfg.name}: generate's tokens are not the "
          f"argmax of the same decode steps")
    fwd_routes = decode_routes_as_forward(step_routes, n_moe, DECODE_BATCH)
    dropless = cfg.with_(moe_capacity_factor=max(
        1.0, cfg.moe_experts / max(cfg.moe_top_k, 1)))
    with torch.inference_mode(), routes.replay(fwd_routes):
        fwd, _ = forward(engine.params, seq, dropless)
    decode_note = ""
    if n_moe:
        with torch.inference_mode(), routes.record() as own:
            fwd_own, _ = forward(engine.params, seq, dropless)
        flips, ratio = route_flips(fwd_routes, own)
        check(ratio <= FLIP_MARGIN_RATIO, f"{cfg.name}: a decode routing "
              f"choice flipped with a gap {ratio} x the difference")
        d_own, agree_own = logit_agreement(dec, fwd_own)
        with torch.inference_mode(), routes.record() as published:
            forward(engine.params, seq, cfg)
        pub = dropped_slots(published, cfg)
        decode_note = (f"; on its own routing {flips_note(flips, ratio)}, "
                       f"max |dlogit| {d_own:.4g}, argmax agrees on "
                       f"{agree_own:.2%}; the forward at the published "
                       f"factor {cfg.moe_capacity_factor} drops {sum(pub)} "
                       f"slots ({pub} by layer)")
        del fwd_own, own, published
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    depth = ""
    if f32_layers is not None and f32_layers < cfg.num_layers:
        # no float32 forward of this depth fits: the bf16 pairs held here
        # unconditionally, then the float32 checks on the first layers
        held_full = (held_beside(f"{cfg.name}: decode and forward (bf16)",
                                 dec, fwd),
                     held_beside(f"{cfg.name}: flash vs plain", logits,
                                 plain))
        print(f"at {cfg.num_layers} layers (no float32 forward of this "
              f"depth fits the card): the decode logits against the "
              f"forward over the {seq.shape[1]} tokens: {held_full[0]}; the "
              f"flash route against the plain one on the same routing: "
              f"{held_full[1]}; the float32 checks cut to {f32_layers} "
              f"layer{'s' * (f32_layers > 1)}", flush=True)
        per_step = n_moe
        n_moe = sum(map(cfg.layer_is_moe, range(f32_layers)))
        step_routes = [c for i, c in enumerate(step_routes)
                       if i % max(per_step, 1) < n_moe]
        flash_routes, fwd_routes = flash_routes[:n_moe], fwd_routes[:n_moe]
        del logits, plain, dec, fwd
        engine.params.layers = engine.params.layers[:f32_layers]
        gc.collect()
        torch.cuda.empty_cache()
        cfg, full_cfg, dropless = (c.with_(num_layers=f32_layers)
                                   for c in (cfg, full_cfg, dropless))
        with torch.inference_mode(), routes.replay(flash_routes):
            logits, _ = forward(engine.params, prompt, cfg, **extra)
        with torch.inference_mode(), routes.replay(flash_routes):
            plain, _ = forward(engine.params, prompt, full_cfg, **extra)
        with routes.replay(step_routes):
            dec = replayed(cfg)
        with torch.inference_mode(), routes.replay(fwd_routes):
            fwd, _ = forward(engine.params, seq, dropless)
        depth = f" (at {f32_layers} layer{'s' * (f32_layers > 1)})"

    # float32: the bf16 weights turned to float32 in place, bits kept
    with torch.no_grad():
        for prm in engine.params.parameters():
            prm.data = prm.data.to(torch.float32)
    gc.collect()
    torch.cuda.empty_cache()
    cfg32 = cfg.with_(dtype="float32")
    with torch.inference_mode(), routes.replay(flash_routes):
        truth, _ = forward(engine.params, prompt, cfg32, **extra)
    # the bf16 prefill's comparisons first; then its float32 logits wait
    # on the host while the plain route's float32 forward runs (at
    # nemotron's 96 heads it holds 2 x 6.4 GB of logits beside 51.6 GB of
    # weights)
    route = "chunked (flash kernel) route" if n_attn else "bf16 prefill"
    line = f"prefill{depth}: the {route} against a float32 forward over " \
           f"the same weights and routing: "
    if plain is not None:
        ref_plain = logit_agreement(plain, truth)
        flash_f32 = held_beside(f"{cfg.name}: flash vs float32", logits,
                                truth, ref_plain)
        # the routes differ in the attention layers only: held as in 4b
        flash_plain = held_beside(f"{cfg.name}: flash vs plain", logits,
                                  plain)
    else:
        d, agree = logit_agreement(logits, truth)
        line += f"max |dlogit| {d:.4g}, argmax agrees on {agree:.2%}"
    truth = truth.cpu()
    del logits, plain
    gc.collect()
    torch.cuda.empty_cache()
    with torch.inference_mode(), routes.replay(fwd_routes):
        fwd32, _ = forward(engine.params, seq, dropless.with_(
            dtype="float32"))
    with routes.replay(step_routes):
        dec32 = replayed(cfg32)
    d32, agree32 = logit_agreement(dec32, fwd32)
    check(d32 <= F32_MAX_DLOGIT, f"{cfg.name}: float32 decode and forward "
          f"differ by {d32}")
    ref_fwd = logit_agreement(fwd, fwd32)
    held_dec = held_beside(f"{cfg.name}: decode and forward (bf16)", dec, fwd,
                           ref_fwd)
    what = (f"a dropless forward (capacity factor "
            f"{dropless.moe_capacity_factor:g}) over the {seq.shape[1]} "
            f"tokens on the decode's routing" if n_moe
            else f"a forward over the {seq.shape[1]} tokens")
    print(f"decode: {DECODE_BATCH} requests x {NEW_TOKENS} tokens (prompts of "
          f"{PROMPT_LEN}), prefill {stats['prefill_s'] * 1e3:.1f} ms ("
          f"{prefill_route(engine)}), decode {stats['decode_s'] * 1e3:.1f} ms = "
          f"{stats['decode_tok_per_s']:.1f} tok/s{step_note}; {what}{depth} "
          f"against the decode "
          f"logits: {held_dec} (the bf16 forward from the float32 one: max "
          f"|dlogit| {ref_fwd[0]:.4g}, argmax {ref_fwd[1]:.2%}){decode_note}; "
          f"in float32, decode against the forward: max |dlogit| {d32:.3g} "
          f"(<= {F32_MAX_DLOGIT}), argmax agrees on {agree32:.2%}",
          flush=True)
    if n_attn:
        # the two attention routes in float32 (the flash kernel's f32 body)
        with torch.inference_mode(), routes.replay(flash_routes):
            plain32, _ = forward(engine.params, prompt,
                                 full_cfg.with_(dtype="float32"), **extra)
        d_f32, agree_f32 = logit_agreement(truth, plain32)
        del plain32
        check(d_f32 <= F32_MAX_DLOGIT, f"{cfg.name}: the float32 flash and "
              f"plain routes differ by {d_f32}")
        line += (f"{flash_f32}; the plain route: max |dlogit| "
                 f"{ref_plain[0]:.4g}, argmax agrees on {ref_plain[1]:.2%}; "
                 f"the flash route against the plain one on the same "
                 f"routing: {flash_plain}{plain_note}; in float32, the two "
                 f"routes: max |dlogit| {d_f32:.3g} (<= {F32_MAX_DLOGIT}), "
                 f"argmax agrees on {agree_f32:.2%}")
    print(line, flush=True)
    print(f"{cfg.name}: peak device memory {peak:.2f} GiB while serving in "
          f"bf16, {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB with "
          f"the float32 weights{depth}", flush=True)
    del truth, flash_routes, step_routes, fwd_routes, engine
    del dec, fwd, dec32, fwd32
    gc.collect()
    torch.cuda.empty_cache()
    return counts["flash_attention"]


def phase_moe_ssm(rows: dict, seed: int) -> None:
    """Phase 4g: qwen2-moe-a2.7b and mamba2-130m at full width and one
    layer period of jamba-v0.1-52b, each served, checked and freed before
    the next."""
    print("== phase 4g: MoE and Mamba-2 serving", flush=True)
    t0 = time.perf_counter()
    flash = 0
    for arch, layers in MOE_SSM_MODELS:
        flash += serve_model(arch, layers, seed)
    rows["flash_attention"].setdefault("paths", {})["prefill_4g"] = flash
    print(f"phase 4g: {time.perf_counter() - t0:.1f} s", flush=True)


def serve_window(seed: int) -> int:
    """qwen2-7b's sliding-window variant at full width: ``Engine.generate``
    for ``WINDOW_BATCH`` prompts of ``2 * WINDOW`` tokens through the
    cache-filling prefill (one flash launch a layer, ``window=WINDOW``, and
    nothing else in the whole generation) and ``NEW_TOKENS`` decode steps
    through the ring of ``WINDOW`` slots, which wraps. Then the same
    tokens teacher-forced (the prompt filled anew, the answer a decode
    step at a time): generate's tokens their argmax, the prefill's logits
    held against one windowed forward over prompt + answer on the plain
    route, and the decode's too, a sequence at a time, at phase 4b's
    bounds. Returns the counted flash launches."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import forward, get_config
    from repro_torch.serving import Engine, ServeConfig

    cfg = get_config(WINDOW_ARCH, "full").long_context_variant(WINDOW)
    S, Bw = 2 * WINDOW, WINDOW_BATCH
    sc = ServeConfig(model=cfg, batch=Bw, max_len=S + NEW_TOKENS)
    torch.cuda.reset_peak_memory_stats()
    t_init, engine = sync_wall(lambda: Engine(sc, seed=seed, device=DEV))
    ring = engine.cache["layers"][0]["k"].shape[1]
    check(ring == WINDOW, f"{cfg.name}: a ring of {ring} slots, want "
          f"{WINDOW}")
    gen = torch.Generator(device=DEV).manual_seed(seed + 2)
    prompts = torch.randint(0, cfg.vocab_size, (Bw, S), generator=gen,
                            device=DEV, dtype=torch.int32)
    held = torch.cuda.memory_allocated()
    reset_launch_counts()
    check(engine.prefills_in_one_forward, f"{cfg.name}: the engine would "
          f"step the prompt")
    tokens, stats = engine.generate(prompts, NEW_TOKENS)
    counts = launch_counts()
    gen_peak = torch.cuda.max_memory_allocated() - held
    want = {k: 0 for k in counts}
    want["flash_attention"] = cfg.num_layers
    check(counts == want, f"{cfg.name} generate launches {counts}, want "
          f"flash_attention x {cfg.num_layers} and nothing else")
    check(tokens.dtype == torch.int32
          and tuple(tokens.shape) == (Bw, NEW_TOKENS)
          and int(tokens.min()) >= 0 and int(tokens.max()) < cfg.vocab_size,
          f"{cfg.name}: generated {tokens.dtype} {tuple(tokens.shape)}")
    check(engine.cache["pos"] == S + NEW_TOKENS - 1,
          f"{cfg.name}: cache pos {engine.cache['pos']}")
    del engine.cache
    seq = torch.cat([prompts, tokens], dim=1)
    replay = Engine(sc, params=engine.params, device=DEV)
    t_pre, (pre, _) = sync_wall(lambda: replay.prefill_fn(
        replay.params, prompts, {"cache": replay.cache}))
    steps = [pre[:, -1]]
    for t in range(NEW_TOKENS):
        _, lg, replay.cache = replay.step_fn(replay.params, replay.cache,
                                             seq[:, S + t:S + t + 1])
        steps.append(lg[:, 0])
    dec = torch.stack(steps, dim=1)         # positions S - 1 .. S + 31
    after_pre = torch.cuda.memory_allocated()
    check(torch.isfinite(dec).all() and all(
        torch.isfinite(row).all() for row in pre), f"{cfg.name}: logits not "
          f"finite")
    check(torch.equal(dec[:, :-1].argmax(-1).to(torch.int32), tokens),
          f"{cfg.name}: generate's tokens are not the argmax of the same "
          f"prefill and decode steps")
    plain_cfg = cfg.with_(attn_chunk_threshold=1 << 30)
    d_pre, agree_pre, fwd = 0.0, 0.0, []
    for b in range(Bw):
        with torch.inference_mode():
            full, _ = forward(replay.params, seq[b:b + 1], plain_cfg)
        d, agree = logit_agreement(pre[b:b + 1], full[:, :S])
        d_pre, agree_pre = max(d_pre, d), agree_pre + agree / Bw
        fwd.append(full[:, S - 1:])
        del full
    fwd = torch.cat(fwd)
    print(f"{cfg.name} (window {WINDOW}): init {t_init:.2f} s; generate "
          f"for {Bw} prompts of {S} tokens (the batch the card holds beside "
          f"the weights) x {NEW_TOKENS} tokens: launches {counts}, prefill "
          f"{stats['prefill_s'] * 1e3:.1f} ms, decode "
          f"{stats['decode_s'] * 1e3:.1f} ms = "
          f"{stats['decode_tok_per_s']:.1f} tok/s through the ring of {ring} "
          f"slots (position p at slot p % {ring}), {gen_peak / 2 ** 30:.2f} "
          f"GiB at its peak beside the {held / 2 ** 30:.2f} held before it; "
          f"the teacher-forced prefill {t_pre * 1e3:.1f} ms, its logits "
          f"{pre.numel() * pre.element_size() / 2 ** 30:.2f} GiB of the "
          f"{after_pre / 2 ** 30:.2f} held after it", flush=True)
    check(d_pre <= MAX_DLOGIT and agree_pre >= MIN_ARGMAX_AGREE,
          f"{cfg.name}: the windowed flash prefill and the plain forward "
          f"differ: {d_pre}, {agree_pre}")
    held = held_beside(f"{cfg.name}: windowed decode and forward", dec, fwd)
    print(f"against one windowed forward over the {seq.shape[1]} tokens on "
          f"the plain route, a sequence at a time: the flash prefill's "
          f"{S} positions max |dlogit| {d_pre:.4g}, argmax agrees on "
          f"{agree_pre:.2%} (<= {MAX_DLOGIT}, >= {MIN_ARGMAX_AGREE:.0%}); "
          f"the last prefill position and the {NEW_TOKENS} decode steps "
          f"through the ring: {held}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB",
          flush=True)
    del engine, replay, pre, dec, fwd, steps
    gc.collect()
    torch.cuda.empty_cache()
    return counts["flash_attention"]


def serve_launcher() -> None:
    """Phase 4l's launcher: the reference's serving launcher as the port
    runs it, ``python -m repro_torch.launch.serve --arch WINDOW_ARCH
    --variant full --sliding-window WINDOW`` on one prompt of twice the
    window (its prefill masks half of what it sees, its decode wraps the
    ring), in a process of its own, which must print its ``generated``
    line: a check that the launcher starts and runs the route, whose
    values :func:`serve_window` holds. Run after phase 5's profiles, as
    4j(c)'s processes are."""
    print("== phase 4l (launcher)", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
           WINDOW_ARCH, "--variant", "full", "--sliding-window", str(WINDOW),
           "--batch", "1", "--prompt-len", str(2 * WINDOW),
           "--max-len", str(2 * WINDOW + NEW_TOKENS),
           "--new-tokens", str(NEW_TOKENS)]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                              timeout=LAUNCHER_S, env=dict(
                                  os.environ, PYTHONPATH=str(ROOT / "src")))
    except subprocess.TimeoutExpired:
        fail(f"{' '.join(cmd[1:])} ran past {LAUNCHER_S} s")
    out = proc.stdout.strip().splitlines()
    check(proc.returncode == 0 and any(ln.startswith("generated")
                                       for ln in out),
          f"{' '.join(cmd[1:])} failed (exit {proc.returncode}): "
          f"{proc.stdout[-2000:]}{proc.stderr[-2000:]}")
    print(f"{' '.join(cmd[1:])}: {' / '.join(out)} "
          f"({time.perf_counter() - t0:.1f} s with the process)", flush=True)


def allocator_settings(conf: str) -> None:
    """Set the caching allocator's options (``PYTORCH_CUDA_ALLOC_CONF``'s
    syntax) in this process, through the call its torch release has."""
    setter = getattr(torch._C, "_accelerator_setAllocatorSettings", None)
    (setter or torch.cuda.memory._set_allocator_settings)(conf)


def phase_zoo(rows: dict, seed: int) -> None:
    """Phase 4l (run after phase 5's profiles): the zoo's other five
    decoders (``ZOO_MODELS``) at full width, each served, checked and freed
    before the next, then qwen2-7b's sliding-window variant (its launcher
    is :func:`serve_launcher`)."""
    print("== phase 4l: glm4-9b, qwen2-7b (and its sliding window), "
          "qwen2-vl-2b, deepseek-moe-16b and nemotron-4-340b serving",
          flush=True)
    t0 = time.perf_counter()
    paths = rows["flash_attention"].setdefault("paths", {})
    # one float32 layer of nemotron (51.6 GB) beside its plain route's
    # (1, 96, 4096, 4096) float32 logits and probabilities (3 x 6.4 GB)
    # leaves no room for blocks the caching allocator has split (8.8 GiB
    # of them on the H100): in this phase its segments grow in place
    gc.collect()
    torch.cuda.empty_cache()
    allocator_settings("expandable_segments:True")
    try:
        paths["prefill_4l"] = 0
        for arch, layers, f32_layers in ZOO_MODELS:
            paths["prefill_4l"] += serve_model(arch, layers, seed, f32_layers)
            # the served model lives on in reference cycles until a
            # collection (on the H100: 37 GiB of nemotron's, which left the
            # next model short): collected before the next is built
            gc.collect()
            torch.cuda.empty_cache()
        paths["prefill_4l_window"] = serve_window(seed)
    finally:
        gc.collect()
        torch.cuda.empty_cache()
        allocator_settings("expandable_segments:False")
    print(f"phase 4l: {time.perf_counter() - t0:.1f} s", flush=True)


def serve_whisper(cfg, seed: int) -> None:
    """whisper-large-v3 at full width on the serving engine: the encoder
    and each layer's cross K/V over seeded frames, ``Engine.generate`` for
    ``DECODE_BATCH`` requests (no kernel of the port launched: its
    attention is below ``attn_chunk_threshold``), the same tokens from a
    second engine, one decode step profiled, and the decode's logits
    teacher-forced on a fresh cache held against one forward over the same
    tokens and frames (at phase 4b's bounds as :func:`held_beside` says);
    then the weights turned to float32 in place and the two held within
    ``F32_MAX_DLOGIT``."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import forward
    from repro_torch.serving import Engine, ServeConfig

    sc = ServeConfig(model=cfg, batch=DECODE_BATCH, max_len=MAX_LEN)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_init, engine = sync_wall(lambda: Engine(sc, seed=seed, device=DEV))
    named = dict(engine.params.named_parameters())
    n_params = sum(prm.numel() for prm in named.values())
    print(f"{cfg.name}: {cfg.encoder_layers} encoder and {cfg.num_layers} "
          f"decoder layers, d_model {cfg.d_model}, {cfg.num_heads} heads of "
          f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
          f"{cfg.encoder_seq} frames; {n_params} parameters in {len(named)} "
          f"tensors ({cfg.dtype}, {n_params * 2 / 1e9:.2f} GB), init "
          f"{t_init:.2f} s", flush=True)
    check(n_params == WHISPER_PARAMS, f"{n_params} parameters, the "
          f"reference's init_params holds {WHISPER_PARAMS}")
    gen = torch.Generator(device=DEV).manual_seed(seed + 2)
    frames = (torch.randn((DECODE_BATCH, cfg.encoder_seq, cfg.d_model),
                          generator=gen, device=DEV) * FRAME_STD).to(
        torch.bfloat16)
    prompts = torch.randint(0, cfg.vocab_size, (DECODE_BATCH, PROMPT_LEN),
                            generator=gen, device=DEV, dtype=torch.int32)

    def cross():
        return engine.cross_fn(engine.params, frames, cfg)
    reset_launch_counts()
    t_cold, kv = sync_wall(cross)
    t_warm, kv = sync_wall(cross)
    shape = (DECODE_BATCH, cfg.encoder_seq, cfg.num_kv_heads, cfg.head_dim)
    check(len(kv) == cfg.num_layers and all(
        tuple(t.shape) == shape and t.dtype == torch.bfloat16
        and bool(torch.isfinite(t).all()) for e in kv for t in e.values()),
        "the cross K/V cache")
    del kv
    tokens, stats = engine.generate(prompts, NEW_TOKENS, frames=frames)
    counts = launch_counts()
    check(not any(counts.values()), f"whisper serving launched {counts}")
    check(tokens.dtype == torch.int32
          and tuple(tokens.shape) == (DECODE_BATCH, NEW_TOKENS)
          and int(tokens.min()) >= 0 and int(tokens.max()) < cfg.vocab_size,
          f"generated {tokens.dtype} {tuple(tokens.shape)}")
    again, _ = Engine(sc, params=engine.params, device=DEV).generate(
        prompts, NEW_TOKENS, frames=frames)
    check(torch.equal(again, tokens), "two runs gave different tokens")
    del again
    step_wall, by_name = device_time_by_kernel(
        lambda: engine.step_fn(engine.params, engine.cache, tokens[:, -1:]))
    step_busy = sum(us for _, us in by_name.values())
    del engine.cache
    print(f"encoder + cross K/V over ({DECODE_BATCH}, {cfg.encoder_seq}, "
          f"{cfg.d_model}) frames: {t_cold * 1e3:.1f} ms cold, "
          f"{t_warm * 1e3:.1f} ms warm; generate: {DECODE_BATCH} requests x "
          f"{NEW_TOKENS} tokens (prompts of {PROMPT_LEN}), launches {counts},"
          f" to the first token {stats['prefill_s'] * 1e3:.1f} ms (encoder, "
          f"cross K/V and the prompt's {PROMPT_LEN} steps), decode "
          f"{stats['decode_s'] * 1e3:.1f} ms = "
          f"{stats['decode_tok_per_s']:.1f} tok/s, the same tokens from a "
          f"second engine; one more decode step profiled: wall "
          f"{step_wall * 1e3:.1f} ms, device busy {step_busy / 1e3:.2f} ms "
          f"({step_busy / (step_wall * 1e6):.1%}), "
          f"{sum(n for n, _ in by_name.values())} launches", flush=True)

    seq = torch.cat([prompts, tokens], dim=1)

    def teacher_forced(model_cfg, fr):
        replay = Engine(ServeConfig(model=model_cfg, batch=DECODE_BATCH,
                                    max_len=MAX_LEN),
                        params=engine.params, device=DEV)
        replay.cache["cross"] = replay.cross_fn(replay.params, fr, model_cfg)
        steps = []
        for t in range(seq.shape[1]):
            _, lg, replay.cache = replay.step_fn(replay.params, replay.cache,
                                                 seq[:, t:t + 1])
            steps.append(lg[:, 0])
        return torch.stack(steps, dim=1)

    dec = teacher_forced(cfg, frames)
    check(torch.isfinite(dec).all(), "decode logits not finite")
    check(torch.equal(dec[:, PROMPT_LEN - 1:-1].argmax(-1).to(torch.int32),
                      tokens), "generate's tokens are not the argmax of the "
          "same decode steps")
    fwd, _ = engine.prefill_fn(engine.params, seq, {"frames": frames})
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    # float32: the bf16 weights turned to float32 in place, bits kept
    with torch.no_grad():
        for prm in engine.params.parameters():
            prm.data = prm.data.to(torch.float32)
    cfg32 = cfg.with_(dtype="float32")
    frames32 = frames.float()
    with torch.inference_mode():
        fwd32, _ = forward(engine.params, seq, cfg32, frames=frames32)
    dec32 = teacher_forced(cfg32, frames32)
    d32, agree32 = logit_agreement(dec32, fwd32)
    check(d32 <= F32_MAX_DLOGIT, f"float32 decode and forward differ by "
          f"{d32}")
    ref_fwd = logit_agreement(fwd, fwd32)
    held = held_beside("whisper: decode and forward (bf16)", dec, fwd,
                       ref_fwd)
    dec_vs32 = logit_agreement(dec, dec32)
    print(f"decode logits teacher-forced over the {seq.shape[1]} tokens "
          f"against one forward over the same tokens and frames: {held}; "
          f"in float32: max |dlogit| {d32:.3g} (<= {F32_MAX_DLOGIT}), argmax "
          f"agrees on {agree32:.2%}; bf16 against float32: the forward max "
          f"|dlogit| {ref_fwd[0]:.4g}, argmax {ref_fwd[1]:.2%}, the decode "
          f"{dec_vs32[0]:.4g}, {dec_vs32[1]:.2%}; peak device memory "
          f"{peak:.2f} GiB serving in bf16, "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB with the "
          f"float32 weights", flush=True)
    del engine, dec, fwd, dec32, fwd32, frames, frames32
    gc.collect()
    torch.cuda.empty_cache()


def compiler_against_card(runs: dict) -> None:
    """The workload compiler (``repro_torch.core.workload``) beside the
    card: for each trained model, the bytes of the gradient tensors
    ``canary_fp`` quantized in one step, as float32, must equal
    ``total_dp_grad_bytes(cfg, grad_dtype="float32")`` plus 4 bytes for
    each parameter ``param_count()`` leaves out, named one by one; the
    default (H100) ``HostSpec``'s predicted forward + backward is printed
    beside each measured step (reported, not held); and two registered
    scenarios are predicted."""
    from repro_torch.core.workload import (HostSpec, build_timeline,
                                           pack_buckets, predict_scenario,
                                           total_dp_grad_bytes)
    from repro_torch.launch.analysis import model_flops_per_step
    from repro_torch.models import Transformer, get_config

    host = HostSpec()
    print(f"workload compiler: HostSpec() = {host.peak_flops / 1e12:.0f} "
          f"TFLOP/s bf16, {host.hbm_bw / 1e12:.2f} TB/s, mfu {host.mfu}",
          flush=True)
    for arch, arch_runs in runs.items():
        cfg, case = get_config(arch, "full"), TRAIN_CASES[arch]
        named = dict(Transformer(cfg, device="meta").named_parameters())
        omitted = [n for n in named if n in ("final_norm.scale",
                                             "enc_norm.scale")
                   or n.endswith(".norm_cross.scale")]
        extra = sum(named[n].numel() for n in omitted)
        sizes = arch_runs["canary_fp"]["quantized"]
        got = 4 * sum(sizes)
        want = total_dp_grad_bytes(cfg, grad_dtype="float32")
        check(len(sizes) == len(named) and extra == case["omitted"]
              and got == want + 4 * extra,
              f"{arch}: {len(sizes)} tensors quantized, {got} bytes; the "
              f"compiler's {want} + 4 x {extra}")
        shown = [n for n in omitted if ".norm_cross." not in n]
        cross = len(omitted) - len(shown)
        if cross:
            shown.append(f"layers.{{0..{cross - 1}}}.norm_cross.scale")
        print(f"{arch}: canary_fp quantized {len(sizes)} gradient tensors in "
              f"one step, {got} bytes as float32 = total_dp_grad_bytes "
              f"{want} + 4 x {extra} parameters param_count() leaves out "
              f"({', '.join(shown)}; {len(omitted)} tensors)", flush=True)
        shapes = [(case["batch"], case["seq"], arch_runs["auto"]["warm_s"],
                   "auto warm median")]
        if "short" in arch_runs:
            shapes.append((SHORT_B, SHORT_S, arch_runs["short"]["warm_s"],
                           "auto, last"))
        plan = pack_buckets(cfg, bucket_bytes=1 << 20)
        for batch, seq, measured, what in shapes:
            tl = build_timeline(cfg, plan, seq=seq, global_batch=batch,
                                dp_hosts=1)
            flops = model_flops_per_step(cfg, "train", seq, batch)
            print(f"  B {batch}, S {seq}: build_timeline predicts forward "
                  f"{tl.forward_ns / 1e6:.2f} ms + backward "
                  f"{tl.backward_ns / 1e6:.2f} ms = "
                  f"{tl.compute_ns / 1e6:.2f} ms; measured step ({what}) "
                  f"{measured * 1e3:.1f} ms, "
                  f"{measured * 1e9 / tl.compute_ns:.2f}x the prediction; "
                  f"model_flops_per_step {flops / 1e12:.3f} TFLOP "
                  f"({flops / measured / BF16_FLOPS:.1%} of the peak at the "
                  f"measured step)", flush=True)
    for name in ("whisper/fat_tree", "llama3-dense/fat_tree"):
        t, pred = sync_wall(lambda: predict_scenario(name))
        check(pred.correct, f"predict_scenario({name!r}) is not exact")
        print(f"predict_scenario({name!r}): {pred.summary()}, "
              f"exact={pred.correct}, {t:.2f} s of host simulation",
              flush=True)


def phase_whisper(rows: dict, seed: int, llama_runs: dict) -> None:
    """Phase 4h: whisper-large-v3 at full width served (freed after), then
    trained in a one-rank NCCL group; then the workload compiler against
    both trained models."""
    print("== phase 4h: whisper-large-v3 (encoder-decoder) at full width",
          flush=True)
    from repro_torch.models import get_config
    t0 = time.perf_counter()
    cfg = get_config(WHISPER_ARCH, "full")
    check(cfg.remat and cfg.dtype == "bfloat16"
          and max(WHISPER_S, cfg.encoder_seq) < cfg.attn_chunk_threshold,
          f"whisper config: remat {cfg.remat}, {cfg.dtype}, below "
          f"attn_chunk_threshold {cfg.attn_chunk_threshold}")
    serve_whisper(cfg, seed)
    with one_rank_nccl() as mesh:
        runs = train_both_modes(cfg, mesh, seed, rows)
    compiler_against_card({MODEL_ARCH: llama_runs, WHISPER_ARCH: runs})
    print(f"phase 4h: {time.perf_counter() - t0:.1f} s", flush=True)


# ------------------------------------------------------ phase 4j: dry run
def dryrun_ops_against_kernels(rows: dict, params, cfg) -> None:
    """4j(a): the flash custom ops give the direct kernel calls' bits and
    launches; 4b's and 4d's launch counts stand; ``FlopCounterMode``
    counts a prefill's flash calls by the ops' formula."""
    from importlib import import_module

    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import forward
    # the module (the package exports its function under the same name)
    fa = import_module("repro_torch.kernels.flash_attention")
    gen = torch.Generator(device=DEV).manual_seed(0)
    H, KV, D = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q, k, v = random_qkv(gen, 1, H, KV, PREFILL_LEN, D, torch.bfloat16,
                         layout="bshd")
    dout = torch.randn(q.shape, generator=gen, device=DEV).to(q.dtype)
    reset_launch_counts()
    direct = fa._forward(q, k, v, True, 0, True)
    after_direct = launch_counts()["flash_attention"]
    op = fa.flash_attention_fwd_op(q, k, v, 0, True, True)
    check(after_direct == 1 and launch_counts()["flash_attention"] == 2,
          f"flash forward launches {launch_counts()}, want 1 a call")
    check(torch.equal(direct[0], op[0]) and torch.equal(direct[1], op[1]),
          "the forward custom op's out or lse differs from the kernel's")
    grads = fa._backward(q, k, v, direct[0], direct[1], dout, True, 0)
    grads_op = fa.flash_attention_bwd_op(q, k, v, direct[0], direct[1],
                                         dout, 0, True)
    check(launch_counts()["flash_attention_bwd"] == 6,
          f"flash backward launches {launch_counts()}, want 3 a call")
    check(all(torch.equal(a, b) for a, b in zip(grads, grads_op)),
          "the backward custom op's gradients differ from the kernels'")
    want = {"prefill": 16, "train_auto": TRAIN_STEPS * 2 * 16,
            "train_canary_fp": TRAIN_STEPS * 2 * 16}
    got = {"prefill": rows["flash_attention"]["launches"],
           **{p: rows["flash_attention"]["paths"].get(p)
              for p in ("train_auto", "train_canary_fp")}}
    check(got == want, f"flash launches of 4b and 4d {got}, want {want}")
    check(rows["flash_attention_bwd"]["paths"].get("train_auto")
          == TRAIN_STEPS * 3 * 16, "flash backward launches of 4d")
    tokens = torch.randint(0, cfg.vocab_size, (1, PREFILL_LEN),
                           generator=gen, device=DEV, dtype=torch.int32)
    reset_launch_counts()
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        forward(params, tokens, cfg)
    calls = launch_counts()["flash_attention"]
    flash_ops = fc.get_flop_counts()["Global"].get(
        torch.ops.repro_torch.flash_attention_fwd, 0)
    one, _ = flash_work(1, H, KV, PREFILL_LEN, D, torch.bfloat16, True, 0)
    check(calls == 16 and flash_ops == 16 * one,
          f"FlopCounterMode over a prefill: {calls} flash calls, "
          f"{flash_ops} operations, want 16 x {one}")
    print(f"4j(a): the flash custom ops give the kernels' bits (forward out "
          f"and lse, dq, dk, dv at (1, {H} / {KV}, {PREFILL_LEN}, {D}) "
          f"bf16 through a (B, S, H, D) transpose), one forward and three "
          f"backward launches a call; 4b's and 4d's flash launches {got}; "
          f"FlopCounterMode over a (1, {PREFILL_LEN}) prefill: {calls} "
          f"flash calls, {flash_ops / 1e9:.3f} GFLOP = 16 x flash_work's "
          f"{one / 1e9:.3f}", flush=True)


def op_host_cost(calls: int = 2000) -> None:
    """4j(a): the host time the operator layer adds to a call: ``quantize``
    of a small tensor through ``repro_torch::quantize`` against its CUDA
    kernel function called directly, in turns, the median of 5 turns."""
    from repro_torch.kernels import fixedpoint as fp
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.kernels.ref import scale_tensor
    x = torch.randn(1024, device=DEV)
    s = scale_tensor(1024.0, x.device)
    routes = {"operator": fp.quantize_op, "kernel": fp._quantize_cuda}
    walls = {r: [] for r in routes}
    for _ in range(5):
        for name, fn in routes.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn(x, s)
            torch.cuda.synchronize()
            walls[name].append((time.perf_counter() - t0) / calls * 1e6)
    med = {r: float(np.median(w)) for r, w in walls.items()}
    reset_launch_counts()
    print(f"4j(a): a quantize call's host wall, {calls} calls a turn: "
          f"through the operator {med['operator']:.2f} us, the kernel "
          f"function directly {med['kernel']:.2f} us (the operator layer "
          f"{med['operator'] - med['kernel']:.2f} us a call)", flush=True)


def dryrun_against_step(cfg, params, opt, tc, llama_runs: dict,
                        held: int) -> None:
    """4j(b): the dry run of phase 4d's ``auto`` step on fake CUDA tensors
    at a one-rank fake mesh, against one real step on the card. The
    predicted peak is held to 4d's ``max_memory_allocated()`` and to the
    step's own peak: that less what the phases before it held (``held``
    here, 4d's ``held``), which the dry run has no tensor of."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch import dryrun
    from repro_torch.parallel import ParallelContext, parallel_context
    from repro_torch.train import make_train_step
    tokens = torch.randint(0, cfg.vocab_size, (TRAIN_B, TRAIN_S),
                           generator=torch.Generator(device=DEV)
                           .manual_seed(1), device=DEV, dtype=torch.int32)
    step = make_train_step(tc)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory._snapshot()
    with FlopCounterMode(display=False) as fc:
        step(params, opt, {"tokens": tokens, "labels": tokens})
    torch.cuda.synchronize()
    after = torch.cuda.memory._snapshot()
    torch.cuda.memory._record_memory_history(enabled=None)
    real_peak = torch.cuda.max_memory_allocated()
    real_flops = fc.get_total_flops()
    spec = dict(kind="train", seq_len=TRAIN_S, global_batch=TRAIN_B)
    t0 = time.perf_counter()
    with dryrun.fake_process_group(1):
        mesh = init_device_mesh(DEV, (1, 1), mesh_dim_names=("data", "model"))
        ctx = ParallelContext(mesh=mesh, data_axes=("data",),
                              model_axis="model")
        with parallel_context(ctx):
            fn, args, _ = dryrun.build_dryrun(MODEL_ARCH, spec, mesh,
                                              device=DEV)
            acc = dryrun.account(fn, args)
            del fn, args
    wall = time.perf_counter() - t0
    mem = acc["memory"]
    measured = llama_runs["auto"]["peak"]
    ratio = mem["total_bytes"] / measured
    own = {"4d": measured - llama_runs["auto"]["held"],
           "4j": real_peak - held}
    own_ratio = {k: mem["total_bytes"] / v for k, v in own.items()}
    print(f"4j(b): dry run of 4d's auto step (B {TRAIN_B}, S {TRAIN_S}) on "
          f"fake CUDA tensors at a one-rank fake mesh in {wall:.1f} s (trace "
          f"{acc['trace_s']:.1f} s): {acc['flops'] / 1e12:.4f} TFLOP, "
          f"FlopCounterMode over one real step {real_flops / 1e12:.4f}; "
          f"predicted peak {mem['total_bytes'] / 2**30:.2f} GiB (arguments "
          f"{mem['argument_bytes'] / 2**30:.2f}, temp "
          f"{mem['temp_bytes'] / 2**30:.2f}), 4d's measured "
          f"{measured / 2**30:.2f} GiB (ratio {ratio:.4f}), this step's "
          f"{real_peak / 2**30:.2f} GiB; less what the phases before held, "
          f"4d's step {own['4d'] / 2**30:.3f} GiB (ratio "
          f"{own_ratio['4d']:.4f}), this one {own['4j'] / 2**30:.3f} "
          f"(ratio {own_ratio['4j']:.4f}); flash {acc['attention']}",
          flush=True)
    warm = llama_runs["auto"]["warm_s"]
    print(f"4j(b): bytes accessed {acc['bytes_accessed']} "
          f"({acc['bytes_accessed'] / 1e9:.1f} GB, of them the flash calls' "
          f"{acc['attention_bytes'] / 1e9:.2f} GB): the roofline's memory_s "
          f"{acc['bytes_accessed'] / HBM_BYTES_PER_S * 1e3:.1f} ms at "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s, beside 4d's measured warm "
          f"auto step {warm * 1e3:.1f} ms (a comparison, not held)",
          flush=True)
    check(acc["flops"] == real_flops,
          f"the dry run counts {acc['flops']} FLOPs, the real step "
          f"{real_flops}")
    for r in (ratio, *own_ratio.values()):
        check(DRYRUN_PEAK[0] <= r <= DRYRUN_PEAK[1],
              f"predicted peak / measured {r:.4f} outside {DRYRUN_PEAK}")
    peak_gap(before, after, real_peak, acc["live_at_peak"])


def _block_size(n: int) -> int:
    """The caching allocator's size for a request of ``n`` bytes: a
    multiple of 512, at least 512."""
    return max(512, -(-n // 512) * 512)


def peak_gap(before, after, real_peak: int, predicted: list) -> None:
    """4j(b): what the real step holds at its peak that the dry run's live
    storages at its own peak do not match. The real step's blocks at its
    peak come from replaying the allocator's trace of the step (the blocks
    alive before it, then each allocation and free); each predicted
    storage is matched to a real block of its allocator size, and the
    unmatched on both sides are reported by where they were made."""
    from repro_torch.launch.memtrace import blocks_at_peak
    peak, live = blocks_at_peak(before, after, held="held before phase 4j")
    real = Counter()
    for n, where in live.values():
        real[n, where] += 1
    by_size = Counter()
    for (n, _), c in real.items():
        by_size[n] += c
    pred = Counter(_block_size(n) for n, *_ in predicted)
    matched = by_size & pred
    real_left, pred_left = Counter(), Counter()
    for (n, where), c in real.items():        # unmatched real blocks
        take = min(c, matched[n])
        matched[n] -= take
        if c > take:
            real_left[where] += (c - take) * n
    taken = by_size & pred
    for n, op, shape, dt in predicted:        # unmatched predicted storages
        b = _block_size(n)
        if taken[b]:
            taken[b] -= 1
        else:
            pred_left[f"{op} {tuple(shape)} {dt}"] += b
    rounding = sum(_block_size(n) - n for n, *_ in predicted)
    earlier = sum(n for (n, where), c in real.items()
                  if "held before phase 4j" in where for _ in range(c))
    gib = 2 ** 30
    print(f"4j(b) gap: the real step's peak replayed {peak / gib:.3f} GiB "
          f"(max_memory_allocated {real_peak / gib:.3f}), predicted "
          f"{sum(n for n, *_ in predicted) / gib:.3f} (allocator rounding of "
          f"its storages {rounding / 2**20:.1f} MiB); blocks the phases "
          f"before 4j hold {earlier / gib:.3f} GiB; unmatched real "
          f"{sum(real_left.values()) / gib:.3f} GiB, unmatched predicted "
          f"{sum(pred_left.values()) / gib:.3f} GiB", flush=True)
    print("4j(b) gap, real blocks with no predicted storage of their size: "
          + "; ".join(f"{w} {n / 2**20:.1f} MiB"
                      for w, n in real_left.most_common(8)), flush=True)
    print("4j(b) gap, predicted storages with no real block of their size: "
          + "; ".join(f"{w} {n / 2**20:.1f} MiB"
                      for w, n in pred_left.most_common(8)), flush=True)


def dryrun_production_row() -> None:
    """4j(c): the production rows of ``DRYRUN_ROWS`` through the CLI, each in
    a subprocess of its own (this process's phases start real process
    groups), all started together; each must print ``OK`` within
    ``DRYRUN_ROW_S`` and count the CPU's five integers (``DRYRUN_CPU``)
    exactly. Run after phase 5's profiles, as 4i: the row processes share
    the card."""
    print("== phase 4j(c): the dry run's production rows", flush=True)
    check(set(DRYRUN_ROWS) == set(DRYRUN_CPU), "tests/dryrun_rows.json "
          f"holds {sorted(DRYRUN_CPU)}, 4j(c) runs {sorted(DRYRUN_ROWS)}")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    parted = set()
    with tempfile.TemporaryDirectory() as out:
        procs = []
        for arch, shape, mesh, sync in DRYRUN_ROWS:
            d = os.path.join(out, f"{arch}__{shape}__{mesh}__{sync}")
            os.makedirs(d)
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape, "--mesh", mesh,
                   "--grad-sync", sync, "--out", d]
            procs.append(((arch, shape, mesh, sync), d, time.perf_counter(),
                          subprocess.Popen(cmd, cwd=ROOT, env=env,
                                           stdout=subprocess.PIPE,
                                           stderr=subprocess.PIPE,
                                           text=True)))
        for (arch, shape, mesh, sync), d, start, proc in procs:
            arch_row = f"{arch} {shape} {mesh} {sync}"
            try:
                stdout, stderr = proc.communicate(
                    timeout=max(1.0, DRYRUN_ROW_S - (time.perf_counter()
                                                     - start)))
            except subprocess.TimeoutExpired:
                for *_, other in procs:
                    other.kill()
                    other.communicate()
                check(False, f"the dry run's {arch_row} row ran past "
                      f"{DRYRUN_ROW_S} s")
            wall = time.perf_counter() - start
            lines = [ln for ln in stdout.splitlines()
                     if ln.startswith(("OK", "FAIL"))]
            check(proc.returncode == 0 and lines
                  and lines[0].startswith("OK"),
                  f"the dry run's {arch_row} row failed (exit "
                  f"{proc.returncode}): {stdout[-2000:]}{stderr[-2000:]}")
            files = os.listdir(d)
            check(len(files) == 1, f"the {arch_row} row's files: {files}")
            with open(os.path.join(d, files[0])) as f:
                row = json.load(f)
            print(f"4j(c): {lines[0]} ({wall:.1f} s with the process)",
                  flush=True)
            print("4j(c) row: " + json.dumps(row), flush=True)
            print(f"4j(c) {arch} {shape} {row['mesh']} {sync}: "
                  f"{row['per_device']['flops'] / 1e12:.1f} TFLOP/dev, peak "
                  f"{row['memory']['total_bytes'] / 2**30:.2f} GiB/dev, "
                  f"useful {row['roofline']['useful_flops_ratio']:.3f}",
                  flush=True)
            got = {k: row["per_device"][k] for k in DRYRUN_KEYS[:3]}
            got.update({"temp_bytes": row["memory"]["temp_bytes"],
                        "total_bytes": row["memory"]["total_bytes"]})
            want = DRYRUN_CPU[(arch, shape, mesh, sync)]
            for k in DRYRUN_KEYS:
                same = got[k] == want[k]
                print(f"4j(c) {arch_row} {k}: {got[k]} on the card, "
                      f"{want[k]} on the CPU"
                      + ("" if same else " (DIFFERS)"), flush=True)
                if not same:
                    parted.add((arch_row, k))
    print(f"phase 4j(c): {len(DRYRUN_ROWS)} rows, "
          f"{time.perf_counter() - t0:.1f} s (the rows run together)",
          flush=True)
    check(not parted, f"the dry run's rows count apart from the CPU's on "
          f"the card (torch {torch.__version__}): {sorted(parted)}")


def phase_dryrun(rows: dict, seed: int, llama_runs: dict) -> None:
    """Phase 4j (see the module's docstring)."""
    print("== phase 4j: the dry run (fake tensors, DTensor, the flash "
          "custom ops)", flush=True)
    from repro_torch.models import get_config
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig
    from repro_torch.train.train_step import init_train_state
    t0 = time.perf_counter()
    cfg = get_config(MODEL_ARCH, "full")
    tc = TrainConfig(model=cfg, optimizer=AdamWConfig(lr=TRAIN_LR))
    torch.cuda.empty_cache()
    op_host_cost()
    held = torch.cuda.memory_allocated()
    print(f"4j: {held / 2**20:.1f} MiB held by the phases before",
          flush=True)
    # from here on each block's stack is kept, for 4j(b)'s gap
    torch.cuda.memory._record_memory_history(context="alloc",
                                             stacks="python",
                                             max_entries=1_000_000)
    params, opt = init_train_state(tc, torch.Generator(device=DEV)
                                   .manual_seed(seed), device=DEV)
    dryrun_ops_against_kernels(rows, params, cfg)
    dryrun_against_step(cfg, params, opt, tc, llama_runs, held)
    del params, opt
    torch.cuda.empty_cache()
    print(f"phase 4j: {time.perf_counter() - t0:.1f} s", flush=True)


def phase_profile_prefill(engine, prompt) -> None:
    """One prefill under ``torch.profiler``: device time by kernel and the
    flash kernel's share."""
    print("== phase 5c: prefill profile (torch.profiler)", flush=True)
    wall, by_name = device_time_by_kernel(
        lambda: engine.prefill_fn(engine.params, prompt, {})[0].shape)
    busy_us = sum(us for _, us in by_name.values())
    check(busy_us > 0, "the profiler saw no device activity in the prefill")
    flash = {name: n for name, (n, _) in by_name.items()
             if "flash_attention" in name}
    check(sum(flash.values()) == engine.sc.model.num_layers
          and all("flash_attention_wgmma_kernel" in name for name in flash),
          f"the prefill's flash launches by kernel name: {flash} (the "
          f"profiler saw {sum(n for n, _ in by_name.values())} launches, "
          f"{busy_us / 1e3:.2f} ms busy, in {wall * 1e3:.1f} ms)")
    flash_us = sum(us for name, (_, us) in by_name.items()
                   if "flash_attention" in name)
    gemm_us = sum(us for name, (_, us) in by_name.items()
                  if "gemm" in name.lower() or "sm90_xmma" in name
                  or "cutlass" in name.lower() or "nvjet" in name)
    print(f"profiled prefill: wall {wall * 1e3:.1f} ms, device busy "
          f"{busy_us / 1e3:.2f} ms ({busy_us / (wall * 1e6):.1%} of the "
          f"wall); flash_attention {flash_us / 1e3:.2f} ms "
          f"({flash_us / busy_us:.1%} of busy), matrix products "
          f"{gemm_us / 1e3:.2f} ms ({gemm_us / busy_us:.1%}), the rest "
          f"{(busy_us - flash_us - gemm_us) / 1e3:.2f} ms; flash launches by "
          f"kernel name {flash}")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    for name, (n, us) in top:
        print(f"  {n:6d} x {us / n:9.2f} us = {us / 1e3:8.2f} ms  {name[:90]}")
    sys.stdout.flush()


def phase_profile(x: torch.Tensor, plan) -> None:
    """One more replay of the first trace under ``torch.profiler``: device
    busy share of the host wall, and device time by kernel name."""
    print("== phase 5b: replay profile (torch.profiler)", flush=True)
    from repro_torch.core.trace import fixed_point_replay

    def replay():
        return fixed_point_replay(plan, x, bits=BITS, device=DEV)

    plain_wall = sorted(sync_wall(replay)[0] for _ in range(5))[2]
    wall, by_name = device_time_by_kernel(replay)
    busy_us = sum(us for _, us in by_name.values())
    if busy_us:
        print(f"profiled replay: wall {wall * 1e3:.3f} ms, device busy "
              f"{busy_us / 1e3:.3f} ms ({busy_us / (wall * 1e6):.1%} of the "
              f"wall; estimate mixing runs: {busy_us / (plain_wall * 1e6):.1%}"
              f" of the median wall of 5 unprofiled replays, "
              f"{plain_wall * 1e3:.3f} ms)")
    else:
        print(f"profiled replay: wall {wall * 1e3:.3f} ms; the profiler saw "
              f"no device activity: busy share not measured")
    for name, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]:
        print(f"  {n:6d} x {us / n:8.2f} us = {us / 1e3:8.3f} ms  {name[:90]}")
    sys.stdout.flush()


def phase_timing(x: torch.Tensor, plan, rows: dict) -> None:
    print("== phase 5: timing (CUDA events, warm)", flush=True)
    from repro_torch.kernels import (dequantize, fixed_point_scale,
                                     packet_accumulate, quantize)
    from repro_torch.kernels.ref import (dequantize_ref,
                                         packet_accumulate_ref, quantize_ref)
    n = x.numel()
    scale = fixed_point_scale(x.abs().max(), bits=BITS, world=P)
    q = quantize(x, scale)

    k, p = in_turns(lambda: quantize_ref(x, scale),
                    lambda: quantize(x, scale), 30)
    rows["quantize"].update(ms=k, plain_ms=p, bound_ms=bound_ms(8 * n),
                            bound_by="bytes", library_ms=None)
    xb = x.to(torch.bfloat16)
    kb, pb = in_turns(lambda: quantize_ref(xb, scale),
                      lambda: quantize(xb, scale), 30)
    print(f"quantize bf16 {tuple(x.shape)}: {kb:.4f} ms (plain {pb:.4f}, "
          f"bound {bound_ms(6 * n):.4f})")

    k, p = in_turns(lambda: dequantize_ref(q, scale),
                    lambda: dequantize(q, scale), 30)
    lib = event_ms(lambda: torch.div(q, scale), 30)
    rows["dequantize"].update(ms=k, plain_ms=p, bound_ms=bound_ms(8 * n),
                              bound_by="bytes", library_ms=lib)

    gen = torch.Generator(device=DEV).manual_seed(2)
    for shape, dtype in ((ROUND_SHAPE, torch.int32), (FIG6_SHAPE, torch.int32),
                         (FIG6_SHAPE, torch.float32)):
        rn, d, slots = shape
        ids = torch.randint(0, slots, (rn,), generator=gen, device=DEV,
                            dtype=torch.int32)
        if dtype == torch.int32:
            pay = torch.randint(-1_000_000, 1_000_000, (rn, d), generator=gen,
                                device=DEV, dtype=torch.int32)
        else:
            pay = torch.randn((rn, d), generator=gen, device=DEV)
        k, p = in_turns(lambda: packet_accumulate_ref(ids, pay, slots),
                        lambda: packet_accumulate(ids, pay, slots), 200)
        lib = event_ms(lambda: torch.zeros((slots, d), dtype=dtype,
                                           device=DEV).index_add_(0, ids,
                                                                  pay), 200)
        host = host_ms(lambda: packet_accumulate(ids, pay, slots), 200)
        nbytes = 4 * (rn * d + rn + slots * d)
        print(f"packet_accumulate {str(dtype)[6:]} (N, D, slots)={shape}: "
              f"{k:.4f} ms (one launch; {host:.4f} ms a call with the host), "
              f"plain {p:.4f}, zeros + index_add_ {lib:.4f}, bound "
              f"{bound_ms(nbytes):.6f}")
        if shape == FIG6_SHAPE and dtype == torch.float32:   # phase 4c's
            rows["packet_accumulate"].update(
                ms=k, plain_ms=p, bound_ms=bound_ms(nbytes), bound_by="bytes",
                library_ms=lib)
    for rn, d, slots in SWEEP_SHAPES:
        ids = torch.randint(0, slots, (rn,), generator=gen, device=DEV,
                            dtype=torch.int32)
        pay = torch.randint(-1_000_000, 1_000_000, (rn, d), generator=gen,
                            device=DEV, dtype=torch.int32)
        k1 = event_ms(lambda: packet_accumulate(ids, pay, slots), 200)
        lib = event_ms(lambda: torch.zeros((slots, d), dtype=torch.int32,
                                           device=DEV).index_add_(0, ids,
                                                                  pay), 200)
        k2 = event_ms(lambda: packet_accumulate(ids, pay, slots), 200)
        print(f"  sweep packet_accumulate int32 (N, D, slots)="
              f"{(rn, d, slots)}: {(k1 + k2) / 2:.4f} ms, zeros + index_add_ "
              f"{lib:.4f} ms")
    time_gather(q, plan, rows)
    for name in ("quantize", "dequantize"):
        r = rows[name]
        print(f"{name} {tuple(x.shape)}: {r['ms']:.4f} ms (plain "
              f"{r['plain_ms']:.4f}, bound {r['bound_ms']:.4f}, library "
              f"{r['library_ms']})")
    sys.stdout.flush()
    time_flash(rows)
    time_flash_bwd(rows)
    time_flash_bwd_moe(rows)


def time_gather(q: torch.Tensor, plan, rows: dict) -> None:
    """The gathered segment-sum over the first trace's plan: the levels of
    one replay summed, each level alone, beside the bytes bound, the plain
    walk and ``torch.sum`` over participants with its result copied to
    every participant's row (the same function in PyTorch calls; printed
    beside it, the sum alone, which skips the broadcast the kernel
    writes). The bound is the function's own, the input
    read once and the result written once; the plan's, which also counts
    the switch-node rows written and read back, is printed beside it."""
    from repro_torch.core.trace.executor import run_plan
    from repro_torch.kernels import packet_accumulate_gather
    from repro_torch.kernels.ref import packet_accumulate_gather_ref
    levels = plan.on(DEV)
    k, p = in_turns(
        lambda: run_plan(plan, q, gather=packet_accumulate_gather_ref),
        lambda: run_plan(plan, q), 30)
    host = host_ms(lambda: run_plan(plan, q), 30)
    lib = event_ms(lambda: torch.sum(q, 0, dtype=torch.int32), 30)
    lib_b = event_ms(lambda: torch.sum(q, 0, dtype=torch.int32).expand_as(q)
                     .contiguous(), 30)
    pb, nb, d = q.shape
    index = sum(4 * t.numel() for lv in levels for t in lv)
    nbytes = 8 * d * pb * nb + index
    roots = sum(int((lv.dst < 0).sum()) for lv in plan.levels)
    plan_bytes = (4 * d * (plan.num_sources + plan.scratch_rows + roots * pb)
                  + index)
    rows["packet_accumulate_gather"].update(
        ms=k, plain_ms=p, bound_ms=bound_ms(nbytes), bound_by="bytes",
        library_ms=lib_b)
    print(f"packet_accumulate_gather, the {len(levels)} levels of one replay "
          f"(P, B, D)={tuple(q.shape)}: {k:.4f} ms, bound {bound_ms(nbytes):.4f}"
          f" ms ({nbytes / 1e6:.1f} MB: the input read once, the result "
          f"written once, {index / 1e6:.2f} MB of index) = "
          f"{bound_ms(nbytes) / k:.1%} of the bound; the plan's bound "
          f"{bound_ms(plan_bytes):.4f} ms ({plan_bytes / 1e6:.1f} MB: "
          f"{plan.num_sources} source rows, {plan.scratch_rows} switch-node "
          f"rows, {roots} roots x {pb}); {host:.4f} ms with the host; plain "
          f"{p:.4f} ms; torch.sum over participants with the broadcast "
          f"copied {lib_b:.4f} ms (library_ms), the sum alone {lib:.4f} ms")
    out = torch.empty_like(q)
    scratch = torch.empty((plan.scratch_rows, d), dtype=q.dtype, device=DEV)
    for i, (lv, t) in enumerate(zip(plan.levels, levels)):
        ms = event_ms(lambda: packet_accumulate_gather(
            q.view(pb * nb, d), scratch, out, *t), 30)
        r = int((lv.dst < 0).sum())
        lbytes = 4 * d * (len(lv.src) + lv.num_segments - r + r * pb)
        print(f"  level {i}: {ms:.4f} ms, {lv.num_segments} segments, "
              f"{len(lv.src)} source rows, {r} roots; bound "
              f"{bound_ms(lbytes):.4f} ms")
    sys.stdout.flush()


def time_flash(rows: dict) -> None:
    """Flash attention at the prefill head layouts, beside its bound, its
    plain version and ``scaled_dot_product_attention`` (timed only; the
    port never calls it)."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention
    from repro_torch.kernels.ref import flash_attention_ref
    gen = torch.Generator(device=DEV).manual_seed(4)
    timed = [c for c in FLASH_CASES if c[0] in TIMED_FLASH]
    for (name, B, H, KV, S, D, dtype, causal, window, _,
         layout) in timed + [
            ("llama3.2-1b heads, f32", 1, 32, 8, 4096, 64, torch.float32,
             True, 0, None, "bhsd")]:
        q, k, v = random_qkv(gen, B, H, KV, S, D, dtype, layout)
        k_ms, p_ms = in_turns(
            lambda: flash_attention_ref(q, k, v, causal=causal, window=window),
            lambda: flash_attention(q, k, v, causal=causal, window=window), 10)
        mask = None
        if window:                  # SDPA takes a window as a boolean mask
            pos = torch.arange(S, device=DEV)
            mask = (pos[None, :] <= pos[:, None]) \
                & (pos[None, :] > pos[:, None] - window)
        lib = event_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, is_causal=causal and mask is None,
            enable_gqa=True), 10)
        flops, nbytes = flash_work(B, H, KV, S, D, dtype, causal, window)
        b_ms, b_by = flash_bound_ms(flops, nbytes, dtype)
        print(f"flash_attention {name} q {(B, H, S, D)} kv {KV} "
              f"{str(dtype)[6:]}: {k_ms:.4f} ms = {flops / k_ms / 1e9:.1f} "
              f"TFLOP/s ({flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB); "
              f"bound {b_ms:.4f} ms ({b_by}); plain {p_ms:.4f} ms; "
              f"scaled_dot_product_attention {lib:.4f} ms", flush=True)
        if name == FLASH_CASES[0][0]:
            rows["flash_attention"].update(ms=k_ms, plain_ms=p_ms,
                                           bound_ms=b_ms, bound_by=b_by,
                                           library_ms=lib)
        elif name == MHA_CASE:
            rows["flash_attention"]["mha_head_dim_128"] = dict(
                shape=[B, H, S, D], ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib)
        elif name in ZOO_FLASH:
            rows["flash_attention"].setdefault("layouts", {})[name] = dict(
                q=[B, H, S, D], kv=KV, window=window, ms=k_ms, plain_ms=p_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib)
        del q, k, v, mask


def time_flash_bwd(rows: dict) -> None:
    """The flash backward at the training shape, (1, 32 / 8, 8192, 64) bf16
    causal as the model hands it over, beside its operations bound (five
    products: 2.5x the forward's), its plain version and the backward of
    ``scaled_dot_product_attention`` (timed only; the port never calls
    it); each of its three kernels under ``torch.profiler`` beside its own
    bound (dk/dv four products, dq three, delta its bytes); and the forward
    with and without its log-sum-exp store, in turns, beside its plain
    version and SDPA's forward."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention_bwd
    from repro_torch.kernels.flash_attention import _forward
    from repro_torch.kernels.ref import (flash_attention_bwd_ref,
                                         flash_attention_ref)
    B, H, KV, S, D = TRAIN_B, 32, 8, TRAIN_S, 64
    gen = torch.Generator(device=DEV).manual_seed(8)
    q, k, v = random_qkv(gen, B, H, KV, S, D, torch.bfloat16, "bshd")
    g = torch.randn(q.shape, generator=gen, device=DEV).to(torch.bfloat16)
    out, lse = _forward(q, k, v, True, 0, with_lse=True)
    k_ms, p_ms = in_turns(
        lambda: flash_attention_bwd_ref(q, k, v, out, lse, g),
        lambda: flash_attention_bwd(q, k, v, out, lse, g), 3)
    fwd_flops, fwd_bytes = flash_work(B, H, KV, S, D, torch.bfloat16, True, 0)
    product = fwd_flops / 2           # one (S, S) x D product, causal
    flops = 5 * product
    nbytes = 2 * B * S * D * (4 * H + 4 * KV) + 4 * B * H * S
    b_ms, b_by = flash_bound_ms(flops, nbytes, torch.bfloat16)
    # the yardstick: SDPA's own forward on the same (B, H, S, D) values,
    # then its backward alone
    qs, ks, vs = (t.contiguous().requires_grad_(True) for t in (q, k, v))
    o_sdpa = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                            enable_gqa=True)
    check(o_sdpa.shape == g.shape, f"SDPA output {tuple(o_sdpa.shape)}")
    lib = event_ms(lambda: torch.autograd.grad(o_sdpa, (qs, ks, vs), g,
                                               retain_graph=True), 10)
    del o_sdpa
    with torch.no_grad():
        lib_fwd = event_ms(lambda: F.scaled_dot_product_attention(
            qs, ks, vs, is_causal=True, enable_gqa=True), 10)
    del qs, ks, vs
    reps = 5
    _, by_name = device_time_by_kernel(
        lambda: [flash_attention_bwd(q, k, v, out, lse, g)
                 for _ in range(reps)])
    delta_bytes = 2 * B * H * S * D * 2 + 4 * B * H * S
    bounds = {name: (n * product / BF16_FLOPS * 1e3, "operations", n)
              for name, n in BWD_KERNELS.items()}
    bounds["flash_bwd_delta_kernel"] = (bound_ms(delta_bytes), "bytes", 0)
    by_kernel = {}
    for kernel, (kb_ms, kb_by, n) in bounds.items():
        # the profiler may drop the window's first launch: the mean is over
        # the launches it recorded
        seen = sum(c for name, (c, _) in by_name.items() if kernel in name)
        check(1 <= seen <= reps, f"the profiler recorded {seen} launches of "
                                 f"{kernel} in {reps} backward calls")
        ms = sum(us for name, (_, us) in by_name.items()
                 if kernel in name) / seen / 1e3
        by_kernel[kernel] = dict(ms=ms, bound_ms=kb_ms, bound_by=kb_by,
                                 products=n)
        print(f"  {kernel}: {ms:.4f} ms (profiler, mean of {seen}), bound "
              f"{kb_ms:.4f} ms ({kb_by}: "
              + (f"{n} products, {n * product / 1e9:.1f} GFLOP"
                 if n else f"{delta_bytes / 1e6:.1f} MB") + f") = "
              f"{kb_ms / ms:.1%} of it", flush=True)
    no_lse, with_lse = in_turns(
        lambda: _forward(q, k, v, True, 0, with_lse=False),
        lambda: _forward(q, k, v, True, 0, with_lse=True), 20)
    fwd_plain = event_ms(lambda: flash_attention_ref(
        q, k, v, causal=True, return_lse=True), 3)
    fb_ms, fb_by = flash_bound_ms(fwd_flops, fwd_bytes + 4 * B * H * S,
                                  torch.bfloat16)
    rows["flash_attention_bwd"].update(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                                       bound_by=b_by, library_ms=lib,
                                       by_kernel=by_kernel)
    rows["flash_attention"]["lse_store"] = dict(
        shape=[B, H, S, D], dtype="bfloat16", ms=with_lse, ms_without=no_lse,
        plain_ms=fwd_plain, bound_ms=fb_ms, bound_by=fb_by,
        library_ms=lib_fwd)
    print(f"flash_attention_bwd at the training shape q {(B, H, S, D)} kv "
          f"{KV} bf16 causal ((B, S, H, D) transposes): {k_ms:.4f} ms = "
          f"{flops / k_ms / 1e9:.1f} TFLOP/s ({flops / 1e9:.1f} GFLOP, five "
          f"products); bound {b_ms:.4f} ms ({b_by}) = {b_ms / k_ms:.1%} of "
          f"it; plain {p_ms:.4f} ms; scaled_dot_product_attention's backward "
          f"{lib:.4f} ms ({k_ms / lib:.2f}x)", flush=True)
    print(f"flash_attention forward at the same shape: {with_lse:.4f} ms "
          f"storing the log-sum-exp, {no_lse:.4f} ms without "
          f"({(with_lse - no_lse) * 1e3:+.1f} us); bound {fb_ms:.4f} ms "
          f"({fb_by}); plain (with the log-sum-exp) {fwd_plain:.4f} ms; "
          f"scaled_dot_product_attention's forward {lib_fwd:.4f} ms",
          flush=True)
    del q, k, v, g, out, lse
    torch.cuda.empty_cache()


def time_flash_bwd_moe(rows: dict) -> None:
    """The flash backward at qwen2-moe-a2.7b's training shape, (1, 16,
    4096, 128) MHA bf16 causal as the model hands it over (phase 4i's
    training path), beside its operations bound, its plain version and
    the backward of ``scaled_dot_product_attention``."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention_bwd
    from repro_torch.kernels.flash_attention import _forward
    from repro_torch.kernels.ref import flash_attention_bwd_ref
    B, H, KV, S, D = PAR_B, 16, 16, PAR_S, 128
    gen = torch.Generator(device=DEV).manual_seed(9)
    q, k, v = random_qkv(gen, B, H, KV, S, D, torch.bfloat16, "bshd")
    g = torch.randn(q.shape, generator=gen, device=DEV).to(torch.bfloat16)
    out, lse = _forward(q, k, v, True, 0, with_lse=True)
    k_ms, p_ms = in_turns(
        lambda: flash_attention_bwd_ref(q, k, v, out, lse, g),
        lambda: flash_attention_bwd(q, k, v, out, lse, g), 3)
    fwd_flops, _ = flash_work(B, H, KV, S, D, torch.bfloat16, True, 0)
    flops = 5 * fwd_flops / 2         # five (S, S) x D products, causal
    nbytes = 2 * B * S * D * (4 * H + 4 * KV) + 4 * B * H * S
    b_ms, b_by = flash_bound_ms(flops, nbytes, torch.bfloat16)
    qs, ks, vs = (t.contiguous().requires_grad_(True) for t in (q, k, v))
    o_sdpa = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
    lib = event_ms(lambda: torch.autograd.grad(o_sdpa, (qs, ks, vs), g,
                                               retain_graph=True), 10)
    rows["flash_attention_bwd"]["qwen2_moe_train"] = dict(
        shape=[B, H, S, D], kv_heads=KV, dtype="bfloat16", ms=k_ms,
        plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib)
    print(f"flash_attention_bwd at qwen2-moe's training shape q "
          f"{(B, H, S, D)} kv {KV} bf16 causal: {k_ms:.4f} ms = "
          f"{flops / k_ms / 1e9:.1f} TFLOP/s ({flops / 1e9:.1f} GFLOP); "
          f"bound {b_ms:.4f} ms ({b_by}) = {b_ms / k_ms:.1%} of it; plain "
          f"{p_ms:.4f} ms; scaled_dot_product_attention's backward "
          f"{lib:.4f} ms ({k_ms / lib:.2f}x)", flush=True)
    del q, k, v, g, out, lse, qs, ks, vs, o_sdpa
    torch.cuda.empty_cache()


def train_flops(cfg, batch: int, seq: int) -> float:
    """Model FLOPs of one training step (PaLM, Chowdhery et al. 2022, app.
    B): 6 N per token for the parameters' products, forward and backward,
    plus 12 L H hd S per token for attention's; remat's recomputation is
    not counted. In an encoder-decoder the encoder's parameters and the
    cross K and V projections meet the batch's ``encoder_seq`` frames, the
    rest its ``seq`` tokens; the encoder's attention pairs frames with
    frames, each decoder layer's self-attention tokens with tokens and its
    cross-attention tokens with frames."""
    width = 12 * cfg.num_heads * cfg.resolved_head_dim
    tokens = batch * seq
    if not cfg.is_encoder_decoder:
        return float(tokens * (6 * cfg.param_count()
                               + width * cfg.num_layers * seq))
    from repro_torch.models import Transformer
    T = cfg.encoder_seq
    named = Transformer(cfg, device="meta").named_parameters()
    on_frames = on_tokens = 0
    for name, prm in named:
        if name.startswith("encoder.") or name.endswith((".cross.wk",
                                                        ".cross.wv")):
            on_frames += prm.numel()
        else:
            on_tokens += prm.numel()
    return float(6 * (on_frames * batch * T + on_tokens * tokens)
                 + width * (cfg.encoder_layers * T * batch * T
                            + cfg.num_layers * (seq + T) * tokens))


def sync_bytes(grads: dict) -> dict:
    """Bytes each part of the fixed-point sync must move in one step, every
    input read once and every output written once: the max |g| (g read),
    quantize (g read, int32 written), dequantize (int32 read, float32
    written) and the cast back (float32 read, g's dtype written)."""
    out = dict.fromkeys(("max", "quantize", "dequantize", "cast"), 0)
    for g in grads.values():
        n, e = g.numel(), g.element_size()
        out["max"] += n * e
        out["quantize"] += n * (e + 4)
        out["dequantize"] += n * 8
        out["cast"] += n * (4 + e)
    return out


MAX_REDUCES = {"calls": 0}   # all_reduce(MAX) calls since the last reset


def count_max_all_reduces() -> None:
    """Count every ``torch.distributed.all_reduce`` with op MAX (the
    fixed-point scales') in ``MAX_REDUCES``, once installed."""
    import torch.distributed as dist
    if MAX_REDUCES.get("installed"):
        return
    real = dist.all_reduce

    def counting(tensor, op=dist.ReduceOp.SUM, group=None, async_op=False):
        if op == dist.ReduceOp.MAX:
            MAX_REDUCES["calls"] += 1
        return real(tensor, op=op, group=group, async_op=async_op)
    dist.all_reduce = counting
    MAX_REDUCES["installed"] = True


@contextlib.contextmanager
def quantized_sizes():
    """The ``numel`` of every tensor the collective quantizes meanwhile."""
    from repro_torch.core.collective import api
    real, sizes = api.quantize, []

    def recording(x, scale):
        sizes.append(x.numel())
        return real(x, scale)
    api.quantize = recording
    try:
        yield sizes
    finally:
        api.quantize = real


@contextlib.contextmanager
def one_rank_nccl():
    """A one-rank NCCL process group and the port's mesh over it."""
    import torch.distributed as dist

    from repro_torch.train import make_mesh
    count_max_all_reduces()
    with tempfile.TemporaryDirectory() as tmp:
        t_init, _ = sync_wall(lambda: dist.init_process_group(
            "nccl", init_method=f"file://{tmp}/rendezvous", world_size=1,
            rank=0))
        try:
            mesh = make_mesh()
            check(dist.get_backend(mesh.inner) == "nccl" and mesh.size == 1,
                  "the mesh is not a one-rank NCCL group")
            print(f"one-rank NCCL group up in {t_init:.2f} s", flush=True)
            yield mesh
        finally:
            dist.destroy_process_group()


def train_both_modes(cfg, mesh, seed: int, rows: dict) -> dict:
    """``TRAIN_STEPS`` steps of ``auto``, then as many of ``canary_fp``
    from the same initial state: ``{mode: train_mode's result}``, the
    step-0 losses held equal."""
    case = TRAIN_CASES[cfg.name]
    flops = train_flops(cfg, case["batch"], case["seq"])
    tokens = case["batch"] * case["seq"]
    route = ("the chunked attention route"
             if case["seq"] >= cfg.attn_chunk_threshold
             else "plain full_attention")
    frames = (f" and {case['batch'] * cfg.encoder_seq} encoder frames"
              if cfg.is_encoder_decoder else "")
    print(f"{cfg.name}: B {case['batch']}, S {case['seq']} ({tokens} tokens "
          f"a step{frames}, {route}), remat on, AdamW float32 moments, lr "
          f"{TRAIN_LR}; model FLOPs a step {flops / 1e12:.2f} T", flush=True)
    runs = {mode: train_mode(cfg, mode, mesh, seed, rows, flops)
            for mode in TRAIN_MODES}
    a, c = runs["auto"]["losses"], runs["canary_fp"]["losses"]
    check(abs(a[0] - c[0]) <= 1e-6 * abs(a[0]),
          f"step 0 losses differ between the modes: {a[0]} {c[0]}")
    print("losses by step, auto: " + ", ".join(f"{x:.6f}" for x in a)
          + "; canary_fp: " + ", ".join(f"{x:.6f}" for x in c)
          + " (step 0: the same weights and batch, before any sync)",
          flush=True)
    gib = 2 ** 30
    parent = PARENT_PEAKS_GIB.get(("4d", cfg.name), {})
    print(f"4d peaks by mode ({cfg.name}): auto "
          f"{runs['auto']['peak'] / gib:.2f} GiB (parent "
          f"{parent.get('auto', 'not measured')}), canary_fp "
          f"{runs['canary_fp']['peak'] / gib:.2f} GiB over its "
          f"{TRAIN_STEPS} steps (parent "
          f"{parent.get('canary_fp', 'not measured')}; the steps after "
          f"the checked first one {runs['canary_fp']['plain_peak'] / gib:.2f}"
          f" GiB)", flush=True)
    return runs


def phase_train(rows: dict, seed: int) -> dict:
    """llama3.2-1b at full width trained on the card through the port's
    trainer at its published context, ``TRAIN_STEPS`` steps of
    ``grad_sync="auto"`` and of ``"canary_fp"`` from the same initial
    state, in a one-rank NCCL group: every step runs the flash forward and
    backward kernels on every layer, and every ``canary_fp`` step quantizes
    and dequantizes every gradient tensor once through the kernels with one
    scale a reference leaf; the first one is held against the plain
    versions. Then a few steps of the plain route at S = 2048. Returns
    :func:`train_both_modes`' result and the short route's (``"short"``).
    """
    print("== phase 4d: training (llama3.2-1b, full width, one-rank NCCL "
          "group)", flush=True)
    from repro_torch.models import get_config

    cfg = get_config(MODEL_ARCH, "full")
    check(cfg.remat and cfg.dtype == "bfloat16"
          and TRAIN_S >= cfg.attn_chunk_threshold
          and TRAIN_S % cfg.attn_chunk == 0
          and SHORT_S < cfg.attn_chunk_threshold,
          f"training config: remat {cfg.remat}, {cfg.dtype}, S {TRAIN_S} "
          f"and {SHORT_S} against attn_chunk_threshold "
          f"{cfg.attn_chunk_threshold}")
    with one_rank_nccl() as mesh:
        runs = train_both_modes(cfg, mesh, seed, rows)
        runs["short"] = train_short_route(cfg, mesh, seed)
    return runs


def make_trainer(cfg, mode: str, mesh, seed: int, batch: int, seq: int,
                 steps: int):
    from repro_torch.data import DataConfig
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig, Trainer, TrainerConfig
    tc = TrainConfig(model=cfg, optimizer=AdamWConfig(lr=TRAIN_LR),
                     grad_sync=mode)
    data = DataConfig(vocab_size=cfg.vocab_size, global_batch=batch,
                      seq_len=seq, seed=0)
    return sync_wall(lambda: Trainer(TrainerConfig(
        train=tc, data=data, steps=steps, log_every=0), mesh=mesh,
        seed=seed, device=DEV))


def train_mode(cfg, mode: str, mesh, seed: int, rows: dict,
               flops: float) -> dict:
    """One mode's run of ``Trainer.run`` at the model's ``TRAIN_CASES``
    shape: ``{"losses", "warm_s"}`` (the warm median step wall) and for
    ``canary_fp`` ``"quantized"``, the sizes of the tensors its first step
    quantized. For ``canary_fp`` the first step's sync is checked, the
    launches and the scales' all-reduces of every step counted, one more
    step profiled and, for llama, the kernels timed at the largest
    tensor."""
    from repro_torch.convert import reference_leaves
    from repro_torch.kernels import (WRAPPERS, fixed_point_scale,
                                     launch_counts, reset_launch_counts)
    from repro_torch.kernels.ref import dequantize_ref, quantize_ref
    from repro_torch.train import make_train_step
    case = TRAIN_CASES[cfg.name]
    batch, seq = case["batch"], case["seq"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()     # by the phases before
    t_init, trainer = make_trainer(cfg, mode, mesh, seed, batch, seq,
                                   TRAIN_STEPS)
    leaves = dict(trainer.params.named_parameters())
    n_params = sum(p.numel() for p in leaves.values())
    check(len(leaves) == case["tensors"], f"{len(leaves)} parameter tensors,"
          f" reckoned {case['tensors']}")
    groups = [leaf.names for leaf in reference_leaves(cfg)]
    check(len(groups) == case["leaves"], f"{len(groups)} reference leaves")
    seen = {}

    def verify(raw, synced):
        """The sync against its own input, with the scale of each tensor's
        reference leaf: bit for bit on two tensors, within 0.5 / scale plus
        one rounding of the gradient on every tensor."""
        check(list(raw) == list(leaves) == list(synced), "sync tensors")
        worst = 0.0
        for names in groups:
            gmax = torch.stack([raw[n].abs().max().float() for n in names])
            s = fixed_point_scale(gmax.max(), bits=BITS, world=1)
            for name in names:
                g, y = raw[name], synced[name]
                check(y.dtype == g.dtype and y.shape == g.shape
                      and bool(torch.isfinite(y).all()), f"synced {name}")
                if name in case["checked"]:
                    want = dequantize_ref(quantize_ref(g, s), s).to(g.dtype)
                    check(torch.equal(y, want), f"synced {name} is not the "
                          f"plain quantize -> dequantize of its gradient "
                          f"with its leaf's scale")
                # 0.5 / s from the rounding to an integer, one rounding to
                # g's dtype, and 2**-22 for the float32 product and quotient
                gabs = g.float().abs()
                err = (y.float() - g.float()).abs()
                bound = 0.5 / s * (1 + 2.0 ** -22) \
                    + (UNIT_ROUNDOFF[g.dtype] + 2.0 ** -22) * gabs
                check(bool((err <= bound).all()), f"synced {name}: |synced "
                      f"- g| above 0.5 / scale + one rounding of g")
                worst = max(worst, float((err * s).max()))
        # the first checked gradient waits on the host for the kernels'
        # timing at its shape: on the card it would sit in every later
        # step's peak (0.49 GiB, llama's embedding)
        seen.update(raw=raw, first=raw[case["checked"][0]].cpu(),
                    worst=worst)

    if mode == "canary_fp":     # the run's first step is checked
        plain = trainer.step_fn
        checked = make_train_step(trainer.tc, mesh=mesh, on_sync=verify)

        def first_step(*args):
            trainer.step_fn = plain
            with quantized_sizes() as sizes:
                out = checked(*args)
            seen["quantized"] = sizes
            counted = launch_counts()    # the measurement's launches and
            reduces = MAX_REDUCES["calls"]  # all-reduces are not the path's
            profile_sync(seen.pop("raw"), trainer.tc, mesh, groups)
            for fn in WRAPPERS:
                fn.launches = counted[fn.__name__]
            MAX_REDUCES["calls"] = reduces
            # the checked step keeps every raw gradient for the check: its
            # peak apart from the plain steps'
            torch.cuda.synchronize()
            seen["peak_checked"] = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            return out
        trainer.step_fn = first_step
    reset_launch_counts()
    MAX_REDUCES["calls"] = 0
    hist = trainer.run()
    counts = launch_counts()
    max_reduces = MAX_REDUCES["calls"]
    losses = [h["loss"] for h in hist]
    check(all(np.isfinite(losses)), f"{mode}: a loss is not finite: {losses}")
    fp = TRAIN_STEPS * len(leaves) if mode == "canary_fp" else 0
    want = {"quantize": fp, "dequantize": fp, "packet_accumulate": 0,
            "packet_accumulate_gather": 0,
            "flash_attention": TRAIN_STEPS * case["flash"],
            "flash_attention_bwd": TRAIN_STEPS * case["flash_bwd"]}
    check(counts == want, f"{mode}: launches over {TRAIN_STEPS} steps "
                          f"{counts}, want {want} (quantize and dequantize "
                          f"once a gradient tensor a canary_fp step; on the "
                          f"chunked route the flash forward twice a layer "
                          f"under remat, three backward launches a layer)")
    want_reduces = TRAIN_STEPS if mode == "canary_fp" else 0
    check(max_reduces == want_reduces, f"{mode}: {max_reduces} "
          f"all_reduce(MAX) calls over {TRAIN_STEPS} steps, want "
          f"{want_reduces}")
    for k, n in counts.items():
        if n:
            rows[k].setdefault("paths", {})[f"{case['label']}_{mode}"] = n
    walls = [h["step_time_s"] for h in hist]
    warm = sorted(walls[1:])[len(walls[1:]) // 2]
    plain_peak = torch.cuda.max_memory_allocated()
    peak = max(plain_peak, seen.get("peak_checked", 0))
    print(f"{mode}: {n_params / 1e9:.3f} B parameters in {len(leaves)} "
          f"tensors ({len(groups)} reference leaves), init {t_init:.2f} s; "
          f"step walls " + ", ".join(f"{w * 1e3:.1f}" for w in walls)
          + f" ms (the first cold); warm median {warm * 1e3:.1f} ms = "
          f"{batch * seq / warm:.0f} tokens/s, model FLOPs "
          f"{flops / warm / BF16_FLOPS:.1%} of the bf16 dense peak "
          f"({BF16_FLOPS / 1e12:.0f} TFLOP/s, NVIDIA H100 SXM data sheet); "
          f"peak device memory {peak / 2**30:.2f} GiB; launches over the "
          f"{TRAIN_STEPS} steps {counts}; all_reduce(MAX) calls "
          f"{max_reduces}", flush=True)
    if mode == "canary_fp":
        print(f"canary_fp sync checked on step 0: {', '.join(case['checked'])}"
              f" bit for bit against dequantize_ref(quantize_ref(g, s), s) "
              f"with s the scale of the tensor's reference leaf; every "
              f"tensor within 0.5/s + one rounding of g (worst |synced - g| "
              f"* s {seen['worst']:.4g})", flush=True)
        profile_train_step(trainer, leaves)
        if cfg.name == MODEL_ARCH:
            time_train_shape(seen["first"].to(DEV), rows)
    return dict(losses=losses, warm_s=warm, quantized=seen.get("quantized"),
                peak=peak, plain_peak=plain_peak, held=held)


def train_short_route(cfg, mesh, seed: int) -> dict:
    """``SHORT_STEPS`` ``auto`` steps at B = SHORT_B, S = SHORT_S, below
    ``attn_chunk_threshold``: the reference's plain ``full_attention``
    route, which launches no flash kernel. Returns ``{"warm_s"}``, the
    last step's wall."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_init, trainer = make_trainer(cfg, "auto", mesh, seed, SHORT_B, SHORT_S,
                                   SHORT_STEPS)
    reset_launch_counts()
    hist = trainer.run()
    counts = launch_counts()
    losses = [h["loss"] for h in hist]
    check(all(np.isfinite(losses)), f"short route: a loss is not finite: "
                                    f"{losses}")
    check(not any(counts.values()), f"short route launches {counts}")
    walls = [h["step_time_s"] for h in hist]
    tokens = SHORT_B * SHORT_S
    print(f"auto at B {SHORT_B}, S {SHORT_S} (plain full_attention route): "
          f"init {t_init:.2f} s; step walls "
          + ", ".join(f"{w * 1e3:.1f}" for w in walls) + f" ms (the first "
          f"cold); last {tokens / walls[-1]:.0f} tokens/s, model FLOPs "
          f"{train_flops(cfg, SHORT_B, SHORT_S) / walls[-1] / BF16_FLOPS:.1%}"
          f" of the bf16 dense peak; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; losses "
          + ", ".join(f"{x:.6f}" for x in losses) + f"; launches {counts}",
          flush=True)
    del trainer
    return dict(warm_s=walls[-1])


def profile_sync(grads: dict, tc, mesh, groups) -> None:
    """The sync alone, inside the first step, on its raw gradients with one
    group a reference leaf: its host wall (median of 3) and, under
    ``torch.profiler``, its device busy time (within a step the host issues
    it while the card still runs the backward pass)."""
    from repro_torch.core.collective import canary_allreduce_tree

    def sync():
        return canary_allreduce_tree(
            dict(grads), group=mesh.inner, axis_size=mesh.inner_size,
            roots=tc.canary_roots, num_blocks=tc.canary_blocks,
            fixed_point=True, groups=groups)
    walls = sorted(sync_wall(sync)[0] for _ in range(3))
    wall, by_name = device_time_by_kernel(sync)
    busy_us = sum(us for _, us in by_name.values())
    launches = sum(n for n, _ in by_name.values())
    print(f"the sync alone on step 0's {len(grads)} gradients ({len(groups)} "
          f"scales): wall {walls[1] * 1e3:.2f} ms (median of 3); profiled, "
          f"wall {wall * 1e3:.2f} ms, {launches} device launches, busy "
          f"{busy_us / 1e3:.2f} ms ({busy_us / (wall * 1e6):.1%} of the "
          f"wall)", flush=True)


def profile_train_step(trainer, leaves: dict) -> None:
    """One more canary_fp step under ``torch.profiler``: the device busy
    share and the sync's device time by part beside its bytes bound."""
    batch = trainer.make_batch(TRAIN_STEPS)
    state = {}

    def step():
        state["out"] = trainer.step_fn(trainer.params, trainer.opt_state,
                                       batch)
    wall, by_name = device_time_by_kernel(step)
    trainer.params, trainer.opt_state, _ = state["out"]
    busy_us = sum(us for _, us in by_name.values())
    check(busy_us > 0, "the profiler saw no device activity in the step")
    parts = {
        "quantize": lambda n: ("quantize_bf16_kernel" in n
                               or "quantize_f32_kernel" in n),
        "dequantize": lambda n: "dequantize_kernel" in n,
        "max |g|": lambda n: "MinMax" in n,
        "all-reduce of the max (NCCL)": lambda n: "nccl" in n.lower(),
    }
    nbytes = sync_bytes(leaves)
    bound = {"quantize": nbytes["quantize"], "dequantize": nbytes["dequantize"],
             "max |g|": nbytes["max"], "all-reduce of the max (NCCL)": 0}
    print(f"profiled canary_fp step: wall {wall * 1e3:.1f} ms, device busy "
          f"{busy_us / 1e3:.2f} ms ({busy_us / (wall * 1e6):.1%} of the "
          f"wall)")
    launches = {}
    for part, match in parts.items():
        hits = [v for name, v in by_name.items() if match(name)]
        launches[part] = sum(n for n, _ in hits)
        us = sum(t for _, t in hits)
        print(f"  sync {part}: {launches[part]} launches, {us / 1e3:.3f} ms "
              f"of device time; bytes bound {bound_ms(bound[part]):.3f} ms "
              f"({bound[part] / 1e9:.2f} GB)")
    print(f"  sync cast back to the gradients' dtype: not told apart from "
          f"other copies; bytes bound {bound_ms(nbytes['cast']):.3f} ms "
          f"({nbytes['cast'] / 1e9:.2f} GB); the whole sync's bound "
          f"{bound_ms(sum(nbytes.values())):.3f} ms "
          f"({sum(nbytes.values()) / 1e9:.2f} GB)")
    check(launches["quantize"] == launches["dequantize"] == len(leaves),
          f"the profiled step's quantize and dequantize launches by kernel "
          f"name: {launches}")
    for part, match in (("flash forward", lambda n: "flash_attention_" in n),
                        ("flash backward", lambda n: "flash_bwd_" in n)):
        hits = [v for name, v in by_name.items() if match(name)]
        us = sum(t for _, t in hits)
        print(f"  {part}: {sum(n for n, _ in hits)} launches, "
              f"{us / 1e3:.2f} ms of device time ({us / busy_us:.1%} of "
              f"busy)")
    gemm_us = sum(us for name, (_, us) in by_name.items()
                  if "gemm" in name.lower() or "sm90_xmma" in name
                  or "cutlass" in name.lower() or "nvjet" in name)
    soft_us = sum(us for name, (_, us) in by_name.items()
                  if "softmax" in name.lower())
    rest_ms = (busy_us - gemm_us - soft_us) / 1e3
    print(f"  matrix products {gemm_us / 1e3:.2f} ms ({gemm_us / busy_us:.1%}"
          f" of busy), softmax forward and backward {soft_us / 1e3:.2f} ms "
          f"({soft_us / busy_us:.1%}), the rest {rest_ms:.2f} ms; by kernel:")
    for name, (n, us) in sorted(by_name.items(),
                                key=lambda kv: -kv[1][1])[:10]:
        print(f"  {n:6d} x {us / n:9.2f} us = {us / 1e3:8.2f} ms  {name[:90]}")
    sys.stdout.flush()


def time_train_shape(g: torch.Tensor, rows: dict) -> None:
    """quantize and dequantize at the training path's largest leaf, the
    tied embedding's bf16 gradient, beside their bound and plain versions."""
    from repro_torch.kernels import dequantize, fixed_point_scale, quantize
    from repro_torch.kernels.ref import dequantize_ref, quantize_ref
    n = g.numel()
    scale = fixed_point_scale(g.abs().max().float(), bits=BITS, world=1)
    q = quantize(g, scale)
    kq, pq = in_turns(lambda: quantize_ref(g, scale),
                      lambda: quantize(g, scale), 10)
    kd, pd = in_turns(lambda: dequantize_ref(q, scale),
                      lambda: dequantize(q, scale), 10)
    lib = event_ms(lambda: torch.div(q, scale), 10)
    for name, dtype, ms, plain, nb, library in (
            ("quantize", str(g.dtype).removeprefix("torch."), kq, pq,
             (g.element_size() + 4) * n, None),
            ("dequantize", "int32", kd, pd, 8 * n, lib)):
        rows[name]["train"] = dict(
            shape=list(g.shape), dtype=dtype,
            launches=rows[name]["paths"]["train_canary_fp"], ms=ms,
            plain_ms=plain,
            bound_ms=bound_ms(nb), bound_by="bytes", library_ms=library)
        print(f"{name} at the embedding gradient {tuple(g.shape)} {dtype}"
              f" ({n / 1e6:.1f} M elements): {ms:.4f} ms, bound "
              f"{bound_ms(nb):.4f} ms ({bound_ms(nb) / ms:.1%} of it), plain "
              f"{plain:.4f} ms, library {library}", flush=True)


# ------------------------------------------ phase 4i: the (data, model) mesh
def _rank_group(rank: int, world: int, init_file: str) -> None:
    """Join a gloo group of ``world`` processes that share the card (NCCL
    takes one rank a card; gloo carries CUDA tensors through the host)."""
    import datetime

    import torch.distributed as dist
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=600))


def _time_collectives() -> dict:
    """Wrap the collectives the port's regions call with host timers:
    ``{"calls", "s"}`` accumulate until reset."""
    import torch.distributed as dist
    acc = {"calls": 0, "s": 0.0}
    for name in ("all_reduce", "all_gather", "all_to_all_single"):
        real = getattr(dist, name)

        def timed(*a, _real=real, **k):
            t0 = time.perf_counter()
            out = _real(*a, **k)
            acc["s"] += time.perf_counter() - t0
            acc["calls"] += 1
            return out
        setattr(dist, name, timed)
    return acc


def checksums(tensors) -> torch.Tensor:
    """Two int64 sums of each tensor's bit patterns (plain and squared), on
    the device: equal bits give equal sums."""
    out = []
    for t in tensors:
        b = t.detach().contiguous().view(
            torch.int16 if t.element_size() == 2 else torch.int32).long()
        out += [b.sum(), (b * b).sum()]
    return torch.stack(out)


@contextlib.contextmanager
def recorded_slots(group):
    """Stand in for ``moe._route``, ``moe._positions`` and ``moe._experts``
    meanwhile, and record each routed call's slots: a list that gets one
    ``{"top_e": (N, k), "kept": (N, k) bool}`` a call over the tokens this
    rank routed; ``kept`` is whether a slot reached its expert, wherever
    that expert runs. Under ``ep_a2a`` (two sorts before the owner's
    dispatch) the owner's kept slots come back to their source over
    ``group`` in one all-to-all, which the layer itself does not run."""
    import torch.distributed as dist

    from repro_torch.models import moe
    calls, seen = [], {}
    route, positions, experts = moe._route, moe._positions, moe._experts

    def _route(p, x2d, cfg):
        out = route(p, x2d, cfg)
        seen.update(top_e=out[1], sorts=[])
        return out

    def _positions(keys):
        seen["sorts"].append(positions(keys))
        return seen["sorts"][-1]

    def _experts(ex, x2d, top_w, sorted_e, pos_in_e, order, ok, *rest):
        cap = rest[2]
        if len(seen["sorts"]) == 1:      # dense, ep: every slot's position
            src, kept = order, pos_in_e < cap
        else:                            # ep_a2a, at the owner
            src, sd, pos = seen["sorts"][0]
            tp = dist.get_world_size(group)
            cap1 = x2d.shape[0] // tp    # the send buffer's rows a rank
            owner = torch.empty_like(ok).index_copy_(0, order, ok)
            back = torch.empty(owner.shape, dtype=torch.int32,
                               device=owner.device)
            dist.all_to_all_single(back, owner.to(torch.int32), group=group)
            kept = (pos < cap1) & back.bool()[
                torch.clamp(sd, max=tp - 1) * cap1
                + torch.clamp(pos, max=cap1 - 1)]
        top_e = seen["top_e"]
        calls.append(dict(top_e=top_e, kept=torch.empty_like(kept).index_copy_(
            0, src, kept).view(top_e.shape)))
        return experts(ex, x2d, top_w, sorted_e, pos_in_e, order, ok, *rest)

    moe._route, moe._positions, moe._experts = _route, _positions, _experts
    try:
        yield calls
    finally:
        moe._route, moe._positions, moe._experts = route, positions, experts


def moe_layer_rank(rank: int, world: int, init_file: str, out_dir: str,
                   seed: int) -> None:
    """One rank of phase 4i(a): the full-width qwen2-moe MoE layer in each
    form of ``PAR_FORMS``, and ``_moe_dense`` on this rank's data shard;
    the results to ``out_dir/layer{rank}.pt``."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import get_config, moe
    from repro_torch.parallel import ParallelContext, parallel_context
    _rank_group(rank, world, init_file)
    try:
        coll = _time_collectives()
        cfg0 = get_config(PAR_ARCH, "full")
        layer = moe.MoE(cfg0, torch.bfloat16, device=DEV,
                        gen=torch.Generator(device=DEV).manual_seed(seed))
        layer.requires_grad_(True)
        params = list(layer.parameters())
        meshes = {s: make_host_mesh(*s, device_type="cuda")
                  for s in sorted({f[1] for f in PAR_FORMS})}
        out = {}
        for form, shape, batch in PAR_FORMS:
            ctx = ParallelContext(mesh=meshes[shape], data_axes=("data",),
                                  model_axis="model")
            gen = torch.Generator(device=DEV).manual_seed(seed + 1)
            x = torch.randn((batch, PAR_S, cfg0.d_model), generator=gen,
                            device=DEV).to(torch.bfloat16)
            x = x[ctx.data_index:ctx.data_index + 1]

            def run(c, impl, record=False):
                cfg = cfg0.with_(moe_impl=impl)
                xx = x.clone().requires_grad_(True)
                with (parallel_context(c) if c else contextlib.nullcontext()
                      ), (recorded_slots(c.model_group if c else None)
                          if record else contextlib.nullcontext([None])
                          ) as slots:
                    y, aux = moe.moe_forward(layer, xx, cfg)
                    loss = (y.float() ** 2).sum() / y.numel() \
                        + cfg.moe_aux_coef * aux
                    grads = torch.autograd.grad(loss, [xx] + params)
                return y.detach(), grads, slots[0]

            # the slots recorded outside the timed runs
            y, grads, rec = run(ctx, form, record=True)
            wall = []
            coll.update(calls=0, s=0.0)
            for _ in range(PAR_LAYER_REPS):
                dist.barrier()
                wall.append(sync_wall(lambda: run(ctx, form))[0])
            calls, coll_s = coll["calls"], coll["s"]
            dist.barrier()
            _, by_name = device_time_by_kernel(lambda: run(ctx, form))
            yd, gd, recd = run(None, "dense", record=True)
            res = dict(wall_s=sorted(wall)[len(wall) // 2],
                       coll_s=coll_s / PAR_LAYER_REPS,
                       coll_calls=calls // PAR_LAYER_REPS,
                       device_ms=sum(us for _, us in by_name.values()) / 1e3,
                       data_index=ctx.data_index, model_rank=ctx.model_rank,
                       sums=checksums([y, *grads]).cpu(),
                       dense_dropped=int((~recd["kept"]).sum()),
                       dropped=int((~rec["kept"]).sum()))
            if form == "ep_a2a":   # this rank's chunk of the sequence
                lo = ctx.model_rank * PAR_S // ctx.tp_size
                rows = slice(lo, lo + PAR_S // ctx.tp_size)
                both = rec["kept"].all(1) & recd["kept"][rows].all(1)
                res.update(
                    same_ids=bool(torch.equal(rec["top_e"],
                                              recd["top_e"][rows])),
                    rows_held=int(both.sum()),
                    y_rel=rel_err(y[0, rows][both], yd[0, rows][both]))
            else:
                res.update(
                    same_ids=bool(torch.equal(rec["top_e"], recd["top_e"])),
                    same_kept=bool(torch.equal(rec["kept"], recd["kept"])),
                    y_rel=rel_err(y, yd),
                    grad_rel=max(rel_err(g, w) for g, w in zip(grads, gd)))
            out[form + str(shape)] = res
            del y, grads, yd, gd
        torch.save(out, f"{out_dir}/layer{rank}.pt")
    finally:
        dist.destroy_process_group()


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """||got - want|| / ||want||, in float64."""
    want = want.double()
    return float((got.double() - want).norm() / want.norm().clamp(
        min=1e-300))


def train_argv(run: dict, mode: str, data: int, model: int) -> list:
    """The launcher's arguments of a run of ``run`` (``PAR_RUN``,
    ``TREE_RUN``) at ``(data, model)``."""
    return ["--arch", run["arch"], "--variant", "full", "--batch",
            str(run["batch"]), "--seq", str(run["seq"]), "--steps",
            str(run["steps"]), "--lr", str(TRAIN_LR), "--grad-sync", mode,
            "--data-parallel", str(data), "--model-parallel", str(model),
            "--log-every", "0"]


def train_on_mesh(world: int, mode: str, run: dict, checked=()) -> dict:
    """``run["steps"]`` steps of ``run`` through the launcher's
    ``make_trainer`` on this rank (the config's depth cut to
    ``run["layers"]``), the launches counted from 0 around ``Trainer.run``:
    losses, walls, launches, the norm of each gradient tensor the optimizer
    was handed and the weights' checksums after every step, the sync's
    host wall a step, the peak memory and the number of parameter tensors.
    ``checked`` (``canary_fp``): names of gradient tensors whose raw
    gradient, the max of their reference leaf's raw gradients and the
    gradient AdamW got are kept from the first step (``"first"``)."""
    from repro_torch.convert import reference_leaves
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import train as lt
    from repro_torch.models import get_config
    from repro_torch.parallel import parallel_context
    from repro_torch.train import make_train_step, train_step
    data, model = (1, 1) if world == 1 else run["mesh"]
    args = lt.parse_args(train_argv(run, mode, data, model))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(run["arch"], "full").with_(num_layers=run["layers"])
    trainer, ctx = lt.make_trainer(args, world, torch.device(DEV), cfg=cfg)
    step, update = trainer.step_fn, train_step.adamw_update
    sync = train_step.canary_allreduce_tree
    sums, norms, names, sync_s, first = [], [], [], [], {}

    def keep(raw, synced):
        leaf_of = {n: leaf.names for leaf in reference_leaves(cfg)
                   for n in leaf.names}
        first["raw"] = {n: raw[n].cpu() for n in checked}
        first["leaf_max"] = {n: float(torch.stack([
            raw[m].abs().max().float() for m in leaf_of[n]]).max())
            for n in checked}
    # the first step keeps its raw gradients for the check
    first_step = [make_train_step(trainer.tc, mesh=trainer.mesh,
                                  on_sync=keep)] if checked else []

    def stepped(*a):
        sync_s.append(0.0)
        out = (first_step.pop() if first_step else step)(*a)
        sums.append(checksums(trainer.params.parameters()))
        return out

    def timed_sync(*a, **k):
        t, out = sync_wall(lambda: sync(*a, **k))
        sync_s[-1] += t
        return out

    def updated(grads, *a, **k):   # the whole step's gradient, synced
        names[:] = list(grads)
        norms.append(torch.stack([torch.linalg.vector_norm(
            g, dtype=torch.float32) for g in grads.values()]))
        if "raw" in first and "synced" not in first:
            first["synced"] = {n: grads[n].cpu() for n in checked}
        return update(grads, *a, **k)

    trainer.step_fn, train_step.adamw_update = stepped, updated
    train_step.canary_allreduce_tree = timed_sync
    reset_launch_counts()
    try:
        with parallel_context(ctx):
            hist = trainer.run()
    finally:
        trainer.step_fn, train_step.adamw_update = step, update
        train_step.canary_allreduce_tree = sync
    counts = launch_counts()
    out = dict(losses=[h["loss"] for h in hist],
               walls=[h["step_time_s"] for h in hist], counts=counts,
               sums=[s.cpu() for s in sums],
               norms=[n.double().cpu() for n in norms],
               names=names, sync_s=sync_s, first=first,
               peak=torch.cuda.max_memory_allocated(),
               tensors=len(list(trainer.params.parameters())),
               tp=ctx.tp_size)
    del trainer
    gc.collect()
    return out


def train_parallel_rank(rank: int, world: int, init_file: str,
                        out_dir: str, run: dict, checked=()) -> None:
    """One rank of a run of ``run`` at ``run["mesh"]`` (phases 4i(b) and
    4k(b)): every mode of ``TRAIN_MODES``, ``checked`` kept in
    ``canary_fp``; the results to ``out_dir/train{rank}.pt``."""
    import torch.distributed as dist
    _rank_group(rank, world, init_file)
    try:
        out = {mode: train_on_mesh(world, mode, run, checked
                                   if mode == "canary_fp" else ())
               for mode in TRAIN_MODES}
        torch.save(out, f"{out_dir}/train{rank}.pt")
    finally:
        dist.destroy_process_group()


def phase_parallel(rows: dict, seed: int, smi: str) -> None:
    """Phase 4i: qwen2-moe-a2.7b on (data, model) meshes of gloo ranks
    that share the card. Each result line ends with ``smi``, the card's
    name and power limit."""
    print("== phase 4i: qwen2-moe-a2.7b on a (data, model) mesh of gloo "
          "ranks sharing the card", flush=True)
    t0 = time.perf_counter()
    parallel_layer(seed, smi)
    parallel_train(rows, smi)
    print(f"phase 4i: {time.perf_counter() - t0:.1f} s", flush=True)


def parallel_layer(seed: int, smi: str) -> None:
    """Phase 4i(a): one MoE layer at full width in each expert-parallel
    form against ``_moe_dense`` over the same shard."""
    import torch.multiprocessing as mp
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(moe_layer_rank, args=(4, f"{tmp}/rdv_layer", tmp, seed),
                 nprocs=4, join=True)
        layer = [torch.load(f"{tmp}/layer{r}.pt") for r in range(4)]
    for form, shape, batch in PAR_FORMS:
        key = form + str(shape)
        rs = [r[key] for r in layer]
        for r in rs:
            check(r["same_ids"], f"{key}: the expert ids differ from "
                                 f"_moe_dense's on the same tokens")
            check(r["y_rel"] <= PAR_LAYER_REL, f"{key}: y {r['y_rel']:.3g} "
                                              f"from _moe_dense's")
            if form == "ep":
                check(r["same_kept"], f"{key}: the kept slots differ from "
                                      f"_moe_dense's")
                check(r["grad_rel"] <= PAR_LAYER_REL,
                      f"{key}: a gradient {r['grad_rel']:.3g} from "
                      f"_moe_dense's")
        for a in rs:
            for b in rs:
                if a["data_index"] == b["data_index"]:
                    check(torch.equal(a["sums"], b["sums"]),
                          f"{key}: model ranks {a['model_rank']} and "
                          f"{b['model_rank']} hold different y or gradients")
        dropped = (sum(r["dropped"] for r in rs) if form == "ep_a2a"
                   else sum(r["dropped"] for r in rs if r["model_rank"] == 0))
        dense = sum(r["dense_dropped"] for r in rs if r["model_rank"] == 0)
        held = (f", y held on {sum(r['rows_held'] for r in rs)} of "
                f"{batch * PAR_S} tokens (every slot kept by both)"
                if form == "ep_a2a" else ", every gradient")
        print(f"{key} at x ({batch}, {PAR_S}, 2048) bf16: y within "
              f"{max(r['y_rel'] for r in rs):.3g}{held} (max "
              f"{max(r.get('grad_rel', 0.0) for r in rs):.3g}) of "
              f"_moe_dense's on the same shard; slots dropped {dropped} "
              f"(_moe_dense {dense}) of {batch * PAR_S * 4}; y and every "
              f"gradient the same bits on each model rank; a rank's "
              f"forward + backward: wall {max(r['wall_s'] for r in rs) * 1e3:.1f}"
              f" ms (median of {PAR_LAYER_REPS}), device "
              + ", ".join(f"{r['device_ms']:.2f}" for r in rs) + " ms by rank, "
              f"collectives' host wall "
              f"{max(r['coll_s'] for r in rs) * 1e3:.1f} ms in "
              f"{rs[0]['coll_calls']} calls [{smi}]", flush=True)


def rel_diffs(got: list, want: list) -> list:
    """Each step's largest |got - want| / want over the tensors, and the
    tensor's index: ``[(rel, index), ...]``."""
    out = []
    for g, w in zip(got, want):
        rel = (g - w).abs() / w.abs().clamp(min=1e-300)
        out.append((float(rel.max()), int(rel.argmax())))
    return out


def train_world_and_mesh(run: dict, checked=()):
    """``(one, ranks)``: each mode of ``TRAIN_MODES`` of ``run`` at world 1
    in a one-rank NCCL group, then on ``run["mesh"]``'s gloo ranks sharing
    the card (``train_on_mesh``'s results, by mode, a rank a dict)."""
    import torch.multiprocessing as mp
    with one_rank_nccl():   # the world-1 reference first
        one = {mode: train_on_mesh(1, mode, run) for mode in TRAIN_MODES}
    torch.cuda.empty_cache()
    world = run["mesh"][0] * run["mesh"][1]
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(train_parallel_rank, args=(world, f"{tmp}/rdv_train", tmp,
                                            run, checked),
                 nprocs=world, join=True)
        ranks = [torch.load(f"{tmp}/train{r}.pt") for r in range(world)]
    return one, ranks


def hold_steps(one: dict, ranks: list, run: dict, rows: dict, path: str,
               smi: str) -> dict:
    """Each mode's steps on ``run["mesh"]`` against world 1's: every
    step's loss within ``PAR_LOSS_REL``, each gradient tensor's norm
    within ``PAR_GRAD_REL``, the ranks' weights bit for bit after every
    step, the launches (flash twice and three times a layer under remat,
    quantize and dequantize once a tensor a ``canary_fp`` step); the
    launches summed over the ranks into ``rows`` under ``path_<mode>``.
    Returns each mode's largest peak a rank, GiB."""
    mesh, steps, layers = run["mesh"], run["steps"], run["layers"]
    tokens = run["batch"] * run["seq"]
    peaks = {}
    for mode in TRAIN_MODES:
        ref, rs = one[mode], [r[mode] for r in ranks]
        peaks[mode] = max(r["peak"] for r in rs) / 2 ** 30
        n = rs[0]["tensors"]
        fp = steps * n if mode == "canary_fp" else 0
        want = {"quantize": fp, "dequantize": fp, "packet_accumulate": 0,
                "packet_accumulate_gather": 0,
                "flash_attention": steps * 2 * layers,
                "flash_attention_bwd": steps * 3 * layers}
        loss_rel = [abs(a - b) / abs(b)
                    for a, b in zip(rs[0]["losses"], ref["losses"])]
        norm_rel = rel_diffs(rs[0]["norms"], ref["norms"])
        warm = [sorted(r["walls"][1:])[len(r["walls"][1:]) // 2]
                for r in (ref, rs[0])]
        print(f"{mode}: {layers} layers, {n} tensors, global B "
              f"{run['batch']}, S {run['seq']}; losses at {mesh} "
              + ", ".join(f"{x:.6f}" for x in rs[0]["losses"])
              + ", at world 1 "
              + ", ".join(f"{x:.6f}" for x in ref["losses"])
              + "; difference by step " + ", ".join(f"{x:.3g}"
                                                    for x in loss_rel)
              + " relative; each gradient tensor's norm, largest difference"
              " by step " + ", ".join(f"{x:.3g} ({ref['names'][i]})"
                                      for x, i in norm_rel)
              + f" relative; warm median step {warm[1] * 1e3:.1f} ms "
              f"({tokens / warm[1]:.0f} tokens/s; world 1: "
              f"{warm[0] * 1e3:.1f} ms, {tokens / warm[0]:.0f} tokens/s); "
              f"step walls by rank " + "; ".join(
                  ", ".join(f"{w * 1e3:.1f}" for w in r["walls"])
                  for r in rs) + " ms; the sync's host wall by step and rank "
              + "; ".join(", ".join(f"{w * 1e3:.1f}" for w in r["sync_s"])
                          for r in rs)
              + " ms; peak memory a rank "
              + ", ".join(f"{r['peak'] / 2**30:.2f}" for r in rs)
              + f" GiB (world 1: {ref['peak'] / 2**30:.2f}); launches a rank "
              f"over {steps} steps {rs[0]['counts']} [{smi}]",
              flush=True)
        for r in rs + [ref]:
            check(all(np.isfinite(r["losses"])), f"{mode}: a loss is not "
                                                 f"finite: {r['losses']}")
            check(r["counts"] == want, f"{mode}: launches over {steps} "
                                       f"steps {r['counts']}, want {want}")
        check(rs[0]["names"] == ref["names"], f"{mode}: the gradients' "
                                              f"names differ from world 1's")
        for step in range(steps):
            check(all(torch.equal(r["sums"][step], rs[0]["sums"][step])
                      for r in rs), f"{mode}: the ranks' weights differ"
                                    f" after step {step}")
            check(loss_rel[step] <= PAR_LOSS_REL,
                  f"{mode}: step-{step} loss {rs[0]['losses'][step]} at "
                  f"{mesh}, {ref['losses'][step]} at world 1")
            rel, i = norm_rel[step]
            check(rel <= PAR_GRAD_REL,
                  f"{mode}: step {step}: {ref['names'][i]}'s gradient norm "
                  f"{float(rs[0]['norms'][step][i])} at {mesh}, "
                  f"{float(ref['norms'][step][i])} at world 1")
        print(f"{mode}: weights the same bits on every rank after every "
              f"step", flush=True)
        for k, c in rs[0]["counts"].items():
            if c:
                rows[k].setdefault("paths", {})[f"{path}_{mode}"] = \
                    sum(r["counts"][k] for r in rs)
    return peaks


def parallel_train(rows: dict, smi: str) -> None:
    """Phase 4i(b): training through the launcher's code path, depth cut
    to ``PAR_LAYERS``, at ``PAR_MESH`` against the same steps at world 1
    (dense): ``hold_steps``."""
    one, ranks = train_world_and_mesh(PAR_RUN)
    peaks = hold_steps(one, ranks, PAR_RUN, rows, "train_parallel", smi)
    parent = PARENT_PEAKS_GIB[("4i", PAR_ARCH)]
    print("4i peaks by mode (the largest rank at "
          f"{PAR_MESH}): " + ", ".join(
              f"{m} {peaks[m]:.2f} GiB (parent {parent[m]})"
              for m in TRAIN_MODES) + f" [{smi}]", flush=True)


# ------------------------------------------ phase 4k: the trees' rounds
def tree_inputs(seed: int, rank: int) -> dict:
    """Rank ``rank``'s ``TREE_INPUTS``, drawn on the CPU."""
    gen = torch.Generator().manual_seed(seed * 1000 + rank)
    return {k: (torch.randn(shape, generator=gen) * std).to(dtype)
            for k, (shape, dtype, std) in TREE_INPUTS.items()}


def tree_reference(inputs: list) -> dict:
    """``dequantize_ref(sum_r quantize_ref(x_r, s), s)`` of each tensor over
    the ranks' ``inputs``, on the CPU, ``s`` the scale of the ranks' max
    |x| as ``fixed_point_scales`` takes it (its own a tensor)."""
    from repro_torch.kernels import fixed_point_scale
    from repro_torch.kernels.ref import dequantize_ref, quantize_ref
    out = {}
    for k in inputs[0]:
        xs = [x[k] for x in inputs]
        gmax = torch.stack([x.abs().max().float() for x in xs]).max()
        s = fixed_point_scale(gmax, bits=BITS, world=len(xs))
        q = torch.stack([quantize_ref(x, s) for x in xs]).sum(
            0, dtype=torch.int32)
        out[k] = dequantize_ref(q, s).to(xs[0].dtype)
    return out


def tree_exchanges() -> dict:
    """Count every ``batch_isend_irecv`` (one exchange of the trees)."""
    import torch.distributed as dist
    real, calls = dist.batch_isend_irecv, {"n": 0}

    def counting(ops):
        calls["n"] += 1
        return real(ops)
    dist.batch_isend_irecv = counting
    return calls


def trees_rank(rank: int, world: int, init_file: str, out_dir: str,
               seed: int) -> None:
    """One rank of phase 4k(a): ``canary_allreduce_tree`` over the first
    ``n`` ranks for each ``n`` of ``TREE_RANKS`` (the others wait), in
    fixed point under both root lists, each held on this rank to
    ``out_dir/ref{n}.pt``, and in floating point on the card and on
    CPU copies of the same inputs; its findings to
    ``out_dir/trees{rank}.pt``."""
    import torch.distributed as dist
    _rank_group(rank, world, init_file)
    count_max_all_reduces()
    exchanges = tree_exchanges()
    found = {}
    try:
        groups = {n: dist.group.WORLD if n == world
                  else dist.new_group(list(range(n))) for n in TREE_RANKS}
        cpu = tree_inputs(seed, rank)
        grads = {k: v.to(DEV) for k, v in cpu.items()}
        for n in TREE_RANKS:
            if rank < n:
                found[n] = trees_at(n, groups[n], grads, cpu, out_dir,
                                    exchanges)
            dist.barrier()
        torch.save(found, f"{out_dir}/trees{rank}.pt")
    finally:
        dist.destroy_process_group()


def bits_apart(a: torch.Tensor, b: torch.Tensor) -> int:
    """How many elements of ``a`` and ``b`` (2- or 4-byte) differ in bits."""
    view = torch.int16 if a.element_size() == 2 else torch.int32
    return int((a.view(view) != b.view(view)).sum())


def trees_at(n: int, group, grads: dict, cpu: dict, out_dir: str,
             exchanges: dict) -> dict:
    """:func:`trees_rank`'s calls at one group size ``n``: ``grads`` on the
    card, ``cpu`` the same on the host; ``exchanges`` counts the
    exchanges."""
    from repro_torch.core.collective import (canary_allreduce_tree,
                                             round_robin_roots)
    from repro_torch.kernels import launch_counts, reset_launch_counts
    roots = round_robin_roots(TREE_BLOCKS, n)
    ref = {k: v.to(DEV) for k, v in torch.load(f"{out_dir}/ref{n}.pt")
           .items()}
    out = dict(counts={}, reduces={}, exchanges={}, wall_s={})
    results = {}
    for tag, rr in (("fwd", roots), ("rev", roots[::-1])):
        reset_launch_counts()
        MAX_REDUCES["calls"], exchanges["n"] = 0, 0
        out["wall_s"][tag], results[tag] = sync_wall(
            lambda: canary_allreduce_tree(dict(grads), group=group,
                                          axis_size=n, roots=rr,
                                          fixed_point=True))
        out["counts"][tag] = launch_counts()
        out["reduces"][tag] = MAX_REDUCES["calls"]
        out["exchanges"][tag] = exchanges["n"]
    fwd = results["fwd"]
    out["fp"] = {k: dict(dtype=str(fwd[k].dtype),
                         same_roots=torch.equal(fwd[k], results["rev"][k]),
                         exact=torch.equal(fwd[k], ref[k]),
                         sums=checksums([fwd[k]]).cpu()) for k in grads}
    del results, fwd, ref
    out["wall_s"]["float"], on_card = sync_wall(
        lambda: canary_allreduce_tree(dict(grads), group=group, axis_size=n,
                                      roots=roots))
    out["wall_s"]["cpu"], on_cpu = sync_wall(
        lambda: canary_allreduce_tree(dict(cpu), group=group, axis_size=n,
                                      roots=roots))
    out["float"] = {k: bits_apart(on_card[k].cpu(), on_cpu[k])
                    for k in grads}
    return out


def phase_trees(rows: dict, seed: int, smi: str) -> None:
    """Phase 4k: the Canary trees' rounds on gloo ranks that share the card
    (gloo stages each exchange through host buffers): (a) the collective
    alone, (b) data-parallel training through the launcher."""
    print("== phase 4k: the Canary trees' rounds on gloo ranks sharing the "
          "card", flush=True)
    t0 = time.perf_counter()
    trees_alone(rows, seed, smi)
    t1 = time.perf_counter()
    trees_train(rows, smi)
    print(f"phase 4k: {time.perf_counter() - t0:.1f} s ((a) {t1 - t0:.1f} "
          f"s, (b) {time.perf_counter() - t1:.1f} s)", flush=True)


def trees_alone(rows: dict, seed: int, smi: str) -> None:
    """Phase 4k(a): ``canary_allreduce_tree`` at each size of
    ``TREE_RANKS``. Fixed point: every rank's result the same bits,
    under both root lists, and equal to the CPU's exact integer sum
    (:func:`tree_reference`); quantize and dequantize once a tensor a
    rank, one ``all_reduce(MAX)`` a call, ``2 ceil(log2 n)`` exchanges a
    tensor. Floating point: the float32 results the bits of the same call
    on CPU copies over the same gloo group (the same adds in the same
    order); bf16's differing elements reported."""
    import math

    import torch.multiprocessing as mp
    world = max(TREE_RANKS)
    inputs = [tree_inputs(seed, r) for r in range(world)]
    numel = {k: v.numel() for k, v in inputs[0].items()}
    launched = 0
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        for n in TREE_RANKS:
            torch.save(tree_reference(inputs[:n]), f"{tmp}/ref{n}.pt")
        t_ref = time.perf_counter() - t0
        del inputs
        t_ranks, _ = sync_wall(lambda: mp.spawn(
            trees_rank, args=(world, f"{tmp}/rdv_trees", tmp, seed),
            nprocs=world, join=True))
        found = [torch.load(f"{tmp}/trees{r}.pt") for r in range(world)]
    print(f"4k(a): the CPU's exact sums for n = {TREE_RANKS} in "
          f"{t_ref:.1f} s; the {world} ranks in {t_ranks:.1f} s", flush=True)
    for n in TREE_RANKS:
        rs = [found[r][n] for r in range(n)]
        rounds = 2 * math.ceil(math.log2(n))
        want = {"quantize": len(numel), "dequantize": len(numel),
                "packet_accumulate": 0, "packet_accumulate_gather": 0,
                "flash_attention": 0, "flash_attention_bwd": 0}
        for r, f in enumerate(rs):
            for tag in ("fwd", "rev"):
                check(f["counts"][tag] == want, f"4k(a) n={n} rank {r} "
                      f"{tag}: launches {f['counts'][tag]}, want {want}")
                check(f["reduces"][tag] == 1, f"4k(a) n={n} rank {r}: "
                      f"{f['reduces'][tag]} all_reduce(MAX) calls, want 1")
                check(f["exchanges"][tag] == rounds * len(numel),
                      f"4k(a) n={n} rank {r}: {f['exchanges'][tag]} "
                      f"exchanges, want {rounds} a tensor")
            for k, v in f["fp"].items():
                check(v["exact"], f"4k(a) n={n} rank {r}: {k} is not the "
                      f"exact fixed-point sum")
                check(v["same_roots"], f"4k(a) n={n} rank {r}: {k} differs "
                      f"between the two root lists")
                check(torch.equal(v["sums"], rs[0]["fp"][k]["sums"]),
                      f"4k(a) n={n}: ranks {r} and 0 hold different {k}")
                if v["dtype"] == "torch.float32":
                    check(f["float"][k] == 0, f"4k(a) n={n} rank {r}: "
                          f"float32 {k} differs from the CPU's gloo call "
                          f"in {f['float'][k]} elements")
            launched += f["counts"]["fwd"]["quantize"] \
                + f["counts"]["rev"]["quantize"]
        sent = sum(rounds * 4 * -(-m // TREE_BLOCKS) * TREE_BLOCKS
                   for m in numel.values())
        bf16 = {k: max(f["float"][k] for f in rs) for k, v in
                rs[0]["fp"].items() if v["dtype"] == "torch.bfloat16"}
        print(f"4k(a) n={n}: fixed point exact and the same bits on every "
              f"rank and under both root lists ({len(numel)} tensors, "
              f"{sum(numel.values())} values a rank); quantize and dequantize "
              f"once a tensor, one all_reduce(MAX), {rounds} exchanges a "
              f"tensor; float32 the CPU gloo call's bits, bf16 elements "
              f"differing from it {bf16}; host wall a fixed-point call "
              + ", ".join(f"{max(f['wall_s'][t] for f in rs) * 1e3:.1f}"
                          for t in ("fwd", "rev"))
              + f" ms (slowest rank, fwd and rev roots), floating point "
              f"{max(f['wall_s']['float'] for f in rs) * 1e3:.1f} ms, on "
              f"the CPU copies {max(f['wall_s']['cpu'] for f in rs) * 1e3:.1f}"
              f" ms; "
              f"{sent} int32 bytes sent (and received) a rank a "
              f"fixed-point call [{smi}]", flush=True)
    for k in ("quantize", "dequantize"):
        rows[k].setdefault("paths", {})["trees"] = launched


def trees_train(rows: dict, smi: str) -> None:
    """Phase 4k(b): ``TREE_RUN`` on two data ranks against world 1
    (:func:`hold_steps`), and the first ``canary_fp`` step's sync of
    ``TREE_CHECKED``, as AdamW got it, bit for bit the two ranks'
    fixed-point sum with their reference leaf's scale, halved (the mean
    over the data ranks)."""
    from repro_torch.kernels import fixed_point_scale
    from repro_torch.kernels.ref import dequantize_ref, quantize_ref
    one, ranks = train_world_and_mesh(TREE_RUN, TREE_CHECKED)
    peaks = hold_steps(one, ranks, TREE_RUN, rows, "train_trees", smi)
    firsts = [r["canary_fp"]["first"] for r in ranks]
    world = len(ranks)
    for name in TREE_CHECKED:
        gmax = torch.tensor(max(f["leaf_max"][name] for f in firsts),
                            dtype=torch.float32)
        s = fixed_point_scale(gmax, bits=BITS, world=world)
        raw = [f["raw"][name] for f in firsts]
        q = torch.stack([quantize_ref(g, s) for g in raw]).sum(
            0, dtype=torch.int32)
        want = dequantize_ref(q, s).to(raw[0].dtype) / world
        for r, f in enumerate(firsts):
            check(torch.equal(f["synced"][name], want), f"4k(b): rank {r}'s "
                  f"step-0 canary_fp {name} is not the two ranks' "
                  f"fixed-point sum over {world}")
    print(f"4k(b) canary_fp step 0: {', '.join(TREE_CHECKED)} as AdamW got "
          f"them on both ranks bit for bit dequantize_ref(sum of the ranks' "
          f"quantize_ref(g, s)) / {world}, s from the reference leaf's max "
          f"over both ranks; peaks by mode, the larger rank: "
          + ", ".join(f"{m} {peaks[m]:.2f} GiB" for m in TRAIN_MODES)
          + f" [{smi}]", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    t_start = time.perf_counter()

    smi = phase_device()
    # float32 references in full float32: no TF32 in matmuls or cuDNN
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    rows = {
        "quantize": dict(source="src/repro_torch/kernels/csrc/fixedpoint.cu",
                         replaces="src/repro/kernels/fixedpoint.py:25"),
        "dequantize": dict(source="src/repro_torch/kernels/csrc/fixedpoint.cu",
                           replaces="src/repro/kernels/fixedpoint.py:30"),
        "packet_accumulate": dict(
            source="src/repro_torch/kernels/csrc/packet_accum.cu",
            replaces="src/repro/kernels/packet_accum.py:31"),
        "packet_accumulate_gather": dict(
            source="src/repro_torch/kernels/csrc/packet_accum.cu",
            replaces="src/repro/kernels/packet_accum.py:31"),
        "flash_attention": dict(
            source="src/repro_torch/kernels/csrc/flash_attention.cu",
            replaces="src/repro/kernels/flash_attention.py:27"),
        # no Pallas kernel: the gradient of the jnp recurrence the reference
        # differentiates when it trains at S >= attn_chunk_threshold
        "flash_attention_bwd": dict(
            source="src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
            replaces="src/repro/models/layers.py:131", launches=0),
    }
    gen = torch.Generator(device=DEV).manual_seed(args.seed)
    x = torch.randn((P, MSG_BYTES // BLOCK_BYTES, D), generator=gen,
                    device=DEV)
    phase_kernels(x, rows)
    plan = phase_main_path(x, rows)
    phase_switch(rows)
    phase_replay_faults(x, rows)
    phase_flow()
    engine, prompt = phase_model(rows, args.seed)
    phase_moe_ssm(rows, args.seed)
    llama_runs = phase_train(rows, args.seed)
    phase_whisper(rows, args.seed, llama_runs)
    phase_dryrun(rows, args.seed, llama_runs)
    phase_timing(x, plan, rows)
    phase_profile(x, plan)
    phase_profile_prefill(engine, prompt)
    # last: after its processes have shared the card, this process's
    # profiler recorded fewer of phase 5's kernel launches (on the H100: 3
    # of 5 in one run, against 5 of 5 before it; 0 of 5 in another, and 0
    # of 5 after 4j(c)'s row processes ran before phase 5)
    del engine, prompt
    # after phase 5's profiles: with 4l's five models served before them,
    # the profiler recorded none of phase 5's flash backward launches (on
    # the H100, twice); its launcher's process shares the card, as 4j(c)'s
    phase_zoo(rows, args.seed)
    serve_launcher()
    dryrun_production_row()
    phase_parallel(rows, args.seed, smi)
    phase_trees(rows, args.seed, smi)

    # launches by path: the replay, switch or prefill run ("launches" so
    # far), then the replays of phase 4e and the training runs
    first_path = {"quantize": "replay", "dequantize": "replay",
                  "packet_accumulate": "switch",
                  "packet_accumulate_gather": "replay",
                  "flash_attention": "prefill"}
    for k in ("quantize", "dequantize", "flash_attention",
              "flash_attention_bwd"):
        check(rows[k].get("paths", {}).get("train_canary_fp", 0) > 0,
              f"{k} never launched on the training path")
    for k in ("quantize", "dequantize"):
        check(rows[k].get("paths", {}).get("train_whisper_canary_fp", 0) > 0,
              f"{k} never launched on whisper's training path")
    for k, modes in (("quantize", ("canary_fp",)),
                     ("dequantize", ("canary_fp",)),
                     ("flash_attention", TRAIN_MODES),
                     ("flash_attention_bwd", TRAIN_MODES)):
        for mode in modes:
            check(rows[k].get("paths", {}).get(f"train_parallel_{mode}", 0)
                  > 0, f"{k} never launched on the (data, model) mesh's "
                       f"{mode} training path")
    for k in ("quantize", "dequantize", "flash_attention",
              "flash_attention_bwd"):
        for path in (["trees"] if k in ("quantize", "dequantize") else []) \
                + [f"train_trees_{m}" for m in TRAIN_MODES
                   if m == "canary_fp" or k.startswith("flash")]:
            check(rows[k].get("paths", {}).get(path, 0) > 0,
                  f"{k} never launched on phase 4k's {path} path")
    for path in ("prefill_4g", "prefill_4l", "prefill_4l_window"):
        check(rows["flash_attention"].get("paths", {}).get(path, 0) > 0,
              f"flash_attention never launched on the {path} path")
    for k in ("quantize", "dequantize", "packet_accumulate_gather"):
        check(rows[k].get("paths", {}).get("replay_faults", 0) > 0,
              f"{k} never launched on phase 4e's replays")
    kernels = []
    for k, r in rows.items():
        paths = {first_path[k]: r["launches"]} if k in first_path else {}
        paths.update(r.get("paths", {}))
        check(all(n > 0 for n in paths.values()),
              f"{k}: a path never launched it: {paths}")
        row = dict(name=k, route="cuda", source=r["source"],
                   replaces=r["replaces"], launches=sum(paths.values()),
                   max_abs_err=r["max_abs_err"], ms=r["ms"],
                   plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                   bound_by=r["bound_by"], library_ms=r["library_ms"],
                   paths=paths)
        for extra in ("train", "lse_store", "by_kernel",    # other shapes
                      "mha_head_dim_128", "qwen2_moe_train", "layouts"):
            if extra in r:
                row[extra] = r[extra]
        kernels.append(row)
    print(f"every phase: {time.perf_counter() - t_start:.1f} s", flush=True)
    print("== phase 6: summary")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
