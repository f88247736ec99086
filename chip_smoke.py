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
              replay's width; flash attention: the llama3.2-1b, qwen2-7b
              and qwen2-moe-a2.7b (MHA) prefill head layouts, each also
              read through the
              strides of a (B, S, H, D) transpose as the prefill hands it
              over, S = 1, 65 and 1000, non-causal, windows of 512 and
              300, head_dim 128 non-causal and with a window of 200 in
              bf16, head_dim 192 in both dtypes; peaked softmax, each
              element and each row held to its tolerance), and the same
              bits twice; the flash backward (three kernels) on the same
              cases against its plain version (each row of dq, dk and dv
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
5. timing   — CUDA events over warm launches: each kernel beside its bound,
              its plain version and one PyTorch call for the same function
              (the gathered segment-sum: the levels of one replay summed;
              the standalone one also at a few shapes off the paths; the
              flash backward at the training shape beside the backward of
              ``scaled_dot_product_attention``, each of its three kernels
              beside its own bound, and the forward with and without its
              log-sum-exp store beside its plain version and SDPA's
              forward);
              then one replay and one prefill under ``torch.profiler``
              (device busy share, device time by kernel; every flash
              launch of the prefill must be the ``wgmma`` kernel);
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
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
DEV = "cuda"
HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12              # dense tensor-core peak, same sheet
F32_FLOPS = 67e12                # FP32 outside the tensor cores
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
# its transpose, and the head_dim 128 layouts of qwen2-7b and qwen2-moe
MHA_CASE = "qwen2-moe heads (MHA)"
TIMED_FLASH = ("llama3.2-1b prefill",
               "llama3.2-1b prefill, (B, S, H, D) transposed",
               "qwen2-7b heads", MHA_CASE)
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
CHECKED_LEAVES = ("embed.tok", "layers.0.mlp.w_down")
UNIT_ROUNDOFF = {torch.bfloat16: 2.0 ** -8, torch.float32: 2.0 ** -24}


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


def logit_agreement(a: torch.Tensor, b: torch.Tensor):
    """Largest |a - b| and the share of positions whose argmax agrees."""
    d = float((a.float() - b.float()).abs().max())
    agree = float((a.argmax(-1) == b.argmax(-1)).float().mean())
    return d, agree


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
    sys.path.insert(0, str(ROOT / "src"))
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
    # decode consistency: teacher-force prompt + answer through decode on a
    # fresh cache, against one forward over the same 48 tokens
    seq = torch.cat([prompts, tokens], dim=1)
    replay = Engine(sc, params=engine.params, device=DEV)
    steps = []
    for t in range(seq.shape[1]):
        _, lg, replay.cache = replay.step_fn(replay.params, replay.cache,
                                             seq[:, t:t + 1])
        steps.append(lg[:, 0])
    dec = torch.stack(steps, dim=1)
    check(torch.isfinite(dec).all(), "decode logits not finite")
    greedy = dec[:, PROMPT_LEN - 1:-1].argmax(-1).to(torch.int32)
    check(torch.equal(greedy, tokens),
          "generate's tokens are not the argmax of the same decode steps")
    fwd, _ = engine.prefill_fn(engine.params, seq, {})
    d2, agree2 = logit_agreement(dec, fwd)
    print(f"decode: {DECODE_BATCH} requests x {NEW_TOKENS} tokens "
          f"(prompts of {PROMPT_LEN}, max_len {MAX_LEN}), launches {dcounts},"
          f" prefill-by-steps {stats['prefill_s'] * 1e3:.1f} ms, decode "
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
    products), SSD (``ssd_chunked``) and the rest, and the wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

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
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall, _ = sync_wall(fn)
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


def serve_moe_ssm(arch: str, layers, seed: int) -> int:
    """One configuration at full width on the serving engine.

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
    ones as :func:`held_beside` says."""
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
    cut = "" if layers is None else f" (depth cut to {layers} layers)"
    print(f"{cfg.name}{cut}: {cfg.num_layers} layers ({n_attn} attention, "
          f"{cfg.num_layers - n_attn} Mamba-2, {n_moe} MoE), d_model "
          f"{cfg.d_model}, {n_params / 1e9:.3f} B parameters ({cfg.dtype}), "
          f"init {t_init:.2f} s", flush=True)
    gen = torch.Generator(device=DEV).manual_seed(seed + 1)
    prompt = torch.randint(0, cfg.vocab_size, (1, PREFILL_LEN), generator=gen,
                           device=DEV, dtype=torch.int32)

    def prefill():
        return engine.prefill_fn(engine.params, prompt, {})[0]

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
            plain, _ = forward(engine.params, prompt, full_cfg)
        with torch.inference_mode(), routes.record() as own:
            plain_own, _ = forward(engine.params, prompt, full_cfg)
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
    print(f"profiled prefill: wall {split['wall_us'] / 1e3:.1f} ms, device "
          f"busy {busy / 1e3:.2f} ms ({busy / split['wall_us']:.1%} of the "
          f"wall), {split['launches']} launches ({split['flash_launches']} "
          f"flash); {parts}", flush=True)
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

    def teacher_forced(model_cfg):
        replay = Engine(ServeConfig(model=model_cfg, batch=DECODE_BATCH,
                                    max_len=MAX_LEN),
                        params=engine.params, device=DEV)
        steps = []
        for t in range(seq.shape[1]):
            _, lg, replay.cache = replay.step_fn(replay.params, replay.cache,
                                                 seq[:, t:t + 1])
            steps.append(lg[:, 0])
        return torch.stack(steps, dim=1)

    with routes.record() as step_routes:
        dec = teacher_forced(cfg)
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

    # float32: the bf16 weights turned to float32 in place, bits kept
    with torch.no_grad():
        for prm in engine.params.parameters():
            prm.data = prm.data.to(torch.float32)
    cfg32 = cfg.with_(dtype="float32")
    with torch.inference_mode(), routes.replay(flash_routes):
        truth, _ = forward(engine.params, prompt, cfg32)
    with torch.inference_mode(), routes.replay(fwd_routes):
        fwd32, _ = forward(engine.params, seq, dropless.with_(
            dtype="float32"))
    with routes.replay(step_routes):
        dec32 = teacher_forced(cfg32)
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
          f"{PROMPT_LEN}), prefill-by-steps {stats['prefill_s'] * 1e3:.1f} "
          f"ms, decode {stats['decode_s'] * 1e3:.1f} ms = "
          f"{stats['decode_tok_per_s']:.1f} tok/s{step_note}; {what} against "
          f"the decode "
          f"logits: {held_dec} (the bf16 forward from the float32 one: max "
          f"|dlogit| {ref_fwd[0]:.4g}, argmax {ref_fwd[1]:.2%}){decode_note}; "
          f"in float32, decode against the forward: max |dlogit| {d32:.3g} "
          f"(<= {F32_MAX_DLOGIT}), argmax agrees on {agree32:.2%}",
          flush=True)
    route = "chunked (flash kernel) route" if n_attn else "bf16 prefill"
    line = f"prefill: the {route} against a float32 forward over the same " \
           f"weights and routing: "
    if plain is not None:
        ref_plain = logit_agreement(plain, truth)
        flash_f32 = held_beside(f"{cfg.name}: flash vs float32", logits,
                                truth, ref_plain)
        # the routes differ in the attention layers only: held as in 4b
        flash_plain = held_beside(f"{cfg.name}: flash vs plain", logits,
                                  plain)
        # the two attention routes in float32 (the flash kernel's f32 body)
        with torch.inference_mode(), routes.replay(flash_routes):
            plain32, _ = forward(engine.params, prompt,
                                 full_cfg.with_(dtype="float32"))
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
    else:
        d, agree = logit_agreement(logits, truth)
        line += f"max |dlogit| {d:.4g}, argmax agrees on {agree:.2%}"
    print(line, flush=True)
    print(f"{cfg.name}: peak device memory {peak:.2f} GiB while serving in "
          f"bf16, {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB with "
          f"the float32 weights", flush=True)
    del truth, plain, logits, flash_routes, step_routes, fwd_routes, engine
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
        flash += serve_moe_ssm(arch, layers, seed)
    rows["flash_attention"].setdefault("paths", {})["prefill_4g"] = flash
    print(f"phase 4g: {time.perf_counter() - t0:.1f} s", flush=True)


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
        lib = event_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=True), 10)
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
        del q, k, v


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


def train_flops(cfg, tokens: int, seq: int) -> float:
    """Model FLOPs of one training step (PaLM, Chowdhery et al. 2022, app.
    B): 6 N per token for the parameters' products, forward and backward,
    plus 12 L H hd S per token for attention's; remat's recomputation is
    not counted."""
    n = cfg.param_count()
    attn = 12 * cfg.num_layers * cfg.num_heads * cfg.resolved_head_dim * seq
    return float(tokens * (6 * n + attn))


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
    fixed-point scales') in ``MAX_REDUCES``."""
    import torch.distributed as dist
    real = dist.all_reduce

    def counting(tensor, op=dist.ReduceOp.SUM, group=None, async_op=False):
        if op == dist.ReduceOp.MAX:
            MAX_REDUCES["calls"] += 1
        return real(tensor, op=op, group=group, async_op=async_op)
    dist.all_reduce = counting


def phase_train(rows: dict, seed: int) -> None:
    """llama3.2-1b at full width trained on the card through the port's
    trainer at its published context, ``TRAIN_STEPS`` steps of
    ``grad_sync="auto"`` and of ``"canary_fp"`` from the same initial
    state, in a one-rank NCCL group: every step runs the flash forward and
    backward kernels on every layer, and every ``canary_fp`` step quantizes
    and dequantizes every gradient tensor once through the kernels with one
    scale a reference leaf; the first one is held against the plain
    versions. Then a few steps of the plain route at S = 2048."""
    print("== phase 4d: training (llama3.2-1b, full width, one-rank NCCL "
          "group)", flush=True)
    import torch.distributed as dist

    from repro_torch.models import get_config
    from repro_torch.train import make_mesh

    cfg = get_config(MODEL_ARCH, "full")
    check(cfg.remat and cfg.dtype == "bfloat16"
          and TRAIN_S >= cfg.attn_chunk_threshold
          and TRAIN_S % cfg.attn_chunk == 0
          and SHORT_S < cfg.attn_chunk_threshold,
          f"training config: remat {cfg.remat}, {cfg.dtype}, S {TRAIN_S} "
          f"and {SHORT_S} against attn_chunk_threshold "
          f"{cfg.attn_chunk_threshold}")
    tokens = TRAIN_B * TRAIN_S
    flops = train_flops(cfg, tokens, TRAIN_S)
    count_max_all_reduces()
    losses = {}
    with tempfile.TemporaryDirectory() as tmp:
        t_init, _ = sync_wall(lambda: dist.init_process_group(
            "nccl", init_method=f"file://{tmp}/rendezvous", world_size=1,
            rank=0))
        try:
            mesh = make_mesh()
            check(dist.get_backend(mesh.inner) == "nccl" and mesh.size == 1,
                  "the mesh is not a one-rank NCCL group")
            print(f"one-rank NCCL group up in {t_init:.2f} s; {cfg.name}: "
                  f"B {TRAIN_B}, S {TRAIN_S} ({tokens} tokens a step, the "
                  f"chunked attention route), remat on, AdamW float32 "
                  f"moments, lr {TRAIN_LR}; model FLOPs a step "
                  f"{flops / 1e12:.2f} T", flush=True)
            for mode in TRAIN_MODES:
                losses[mode] = train_mode(cfg, mode, mesh, seed, rows, flops)
            train_short_route(cfg, mesh, seed)
        finally:
            dist.destroy_process_group()
    a, c = losses["auto"], losses["canary_fp"]
    check(abs(a[0] - c[0]) <= 1e-6 * abs(a[0]),
          f"step 0 losses differ between the modes: {a[0]} {c[0]}")
    print("losses by step, auto: " + ", ".join(f"{x:.6f}" for x in a)
          + "; canary_fp: " + ", ".join(f"{x:.6f}" for x in c)
          + " (step 0: the same weights and batch, before any sync)",
          flush=True)


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
               flops: float) -> list:
    """One mode's run of ``Trainer.run``; returns its losses. For
    ``canary_fp`` the first step's sync is checked, the launches and the
    scales' all-reduces of every step counted, one more step profiled and
    the kernels timed at the largest tensor."""
    from repro_torch.convert import reference_leaves
    from repro_torch.kernels import (WRAPPERS, fixed_point_scale,
                                     launch_counts, reset_launch_counts)
    from repro_torch.kernels.ref import dequantize_ref, quantize_ref
    from repro_torch.train import make_train_step
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_init, trainer = make_trainer(cfg, mode, mesh, seed, TRAIN_B, TRAIN_S,
                                   TRAIN_STEPS)
    leaves = dict(trainer.params.named_parameters())
    n_params = sum(p.numel() for p in leaves.values())
    check(len(leaves) == 9 * cfg.num_layers + 2,
          f"{len(leaves)} parameter tensors")
    groups = [leaf.names for leaf in reference_leaves(cfg)]
    check(len(groups) == 11, f"{len(groups)} reference leaves")
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
                if name in CHECKED_LEAVES:
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
        seen.update(raw=raw, tok=raw["embed.tok"], worst=worst)

    if mode == "canary_fp":     # the run's first step is checked
        plain = trainer.step_fn
        checked = make_train_step(trainer.tc, mesh=mesh, on_sync=verify)

        def first_step(*args):
            trainer.step_fn = plain
            out = checked(*args)
            counted = launch_counts()    # the measurement's launches and
            reduces = MAX_REDUCES["calls"]  # all-reduces are not the path's
            profile_sync(seen.pop("raw"), trainer.tc, mesh, groups)
            for fn in WRAPPERS:
                fn.launches = counted[fn.__name__]
            MAX_REDUCES["calls"] = reduces
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
            "flash_attention": TRAIN_STEPS * 2 * cfg.num_layers,
            "flash_attention_bwd": TRAIN_STEPS * 3 * cfg.num_layers}
    check(counts == want, f"{mode}: launches over {TRAIN_STEPS} steps "
                          f"{counts}, want {want} (the flash forward twice a "
                          f"layer under remat, three backward launches a "
                          f"layer)")
    want_reduces = TRAIN_STEPS if mode == "canary_fp" else 0
    check(max_reduces == want_reduces, f"{mode}: {max_reduces} "
          f"all_reduce(MAX) calls over {TRAIN_STEPS} steps, want "
          f"{want_reduces}")
    for k, n in counts.items():
        if n:
            rows[k].setdefault("paths", {})[f"train_{mode}"] = n
    walls = [h["step_time_s"] for h in hist]
    warm = sorted(walls[1:])[len(walls[1:]) // 2]
    peak = torch.cuda.max_memory_allocated()
    print(f"{mode}: {n_params / 1e9:.3f} B parameters in {len(leaves)} "
          f"tensors ({len(groups)} reference leaves), init {t_init:.2f} s; "
          f"step walls " + ", ".join(f"{w * 1e3:.1f}" for w in walls)
          + f" ms (the first cold); warm median {warm * 1e3:.1f} ms = "
          f"{TRAIN_B * TRAIN_S / warm:.0f} tokens/s, model FLOPs "
          f"{flops / warm / BF16_FLOPS:.1%} of the bf16 dense peak "
          f"({BF16_FLOPS / 1e12:.0f} TFLOP/s, NVIDIA H100 SXM data sheet); "
          f"peak device memory {peak / 2**30:.2f} GiB; launches over the "
          f"{TRAIN_STEPS} steps {counts}; all_reduce(MAX) calls "
          f"{max_reduces}", flush=True)
    if mode == "canary_fp":
        print(f"canary_fp sync checked on step 0: {', '.join(CHECKED_LEAVES)}"
              f" bit for bit against dequantize_ref(quantize_ref(g, s), s) "
              f"with s the scale of the tensor's reference leaf; every "
              f"tensor within 0.5/s + one rounding of g (worst |synced - g| "
              f"* s {seen['worst']:.4g})", flush=True)
        profile_train_step(trainer, leaves)
        time_train_shape(seen["tok"], rows)
    return losses


def train_short_route(cfg, mesh, seed: int) -> None:
    """``SHORT_STEPS`` ``auto`` steps at B = SHORT_B, S = SHORT_S, below
    ``attn_chunk_threshold``: the reference's plain ``full_attention``
    route, which launches no flash kernel."""
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
          f"{train_flops(cfg, tokens, SHORT_S) / walls[-1] / BF16_FLOPS:.1%}"
          f" of the bf16 dense peak; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; losses "
          + ", ".join(f"{x:.6f}" for x in losses) + f"; launches {counts}",
          flush=True)
    del trainer


def profile_sync(grads: dict, tc, mesh, groups) -> None:
    """The sync alone, inside the first step, on its 146 raw gradients with
    the 11 reference-leaf groups: its host wall (median of 3) and, under
    ``torch.profiler``, its device busy time (within a step the host issues
    it while the card still runs the backward pass)."""
    from repro_torch.core.collective import canary_allreduce_tree

    def sync():
        return canary_allreduce_tree(
            grads, group=mesh.inner, axis_size=mesh.inner_size,
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

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
    phase_train(rows, args.seed)
    phase_timing(x, plan, rows)
    phase_profile(x, plan)
    phase_profile_prefill(engine, prompt)

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
                      "mha_head_dim_128"):
            if extra in r:
                row[extra] = r[extra]
        kernels.append(row)
    print("== phase 6: summary")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
