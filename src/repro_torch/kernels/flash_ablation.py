"""Ablations of the bf16 flash-attention kernel on the card: where its time
goes.

    PYTHONPATH=src python -m repro_torch.kernels.flash_ablation

Each variant is ``csrc/flash_attention.cu`` with one change made by text
substitution (a change whose anchor is missing fails the run), built with
the library's ``nvcc`` flags into ``build/flash_ablation/`` (all variants at
once) and timed beside the shipped kernel, first and last, with CUDA events
after a head start for the card: the llama3.2-1b prefill heads, causal and
full, and the qwen2-7b heads, causal, at 4096 tokens. A variant that changes
only tiles, stages or scheduling must give the shipped kernel's bits; one
that takes a part out times what is left. Prints one line a variant, then
one JSON line.

Nothing here runs at import; it needs a card and ``nvcc``.
"""
from __future__ import annotations

import ctypes
import json
import math
import subprocess
import sys

import torch

from . import _build

OUT = _build.BUILD_ROOT.parent / "flash_ablation"
HEAD_START_CYCLES = 40_000_000
REPS = 20
# (name, H, KV, D, causal) at B = 1, S = 4096
CASES = [("llama3.2-1b causal", 32, 8, 64, True),
         ("llama3.2-1b full", 32, 8, 64, False),
         ("qwen2-7b causal", 28, 4, 128, True)]
_TURN_SYNC = 'asm volatile("bar.sync %0, 256;\\n" ::"r"(1 + cw) : "memory");'
_TURN_ARRIVE = ('asm volatile("bar.arrive %0, 256;\\n" ::"r"(1 + (cw + 1) % '
                'T::kConsumers)\n                   : "memory");')
_SOFTMAX_HEAD = "    float& corr_lo, float& corr_hi) {\n"
_QK_HEAD = ("  using T = Bf16Tiles<D>;\n#pragma unroll\n"
            "  for (int kk = 0; kk < D / 16; ++kk) {")
_PV_HEAD = "  constexpr int BK = Bf16Tiles<D>::kBK;\n#pragma unroll\n"
_LOAD = "        mbar_expect_tx(full_bar + 8 * st, T::kStageBytes);\n"
# (anchor, replacement) pairs of each variant; "same bits" variants first
_NO_TURNS = [(_TURN_SYNC, ""), (_TURN_ARRIVE, "")]
_NO_SOFTMAX = [(_SOFTMAX_HEAD, _SOFTMAX_HEAD + (
    "  corr_lo = corr_hi = 1.f;\n#pragma unroll\n"
    "  for (int j = 0; j < BK / 2; ++j) s[j] *= scale_log2;\n  return;\n"))]
_NO_PRODUCTS = [(_QK_HEAD, "  wgmma_commit();\n  return;\n" + _QK_HEAD),
                (_PV_HEAD, _PV_HEAD.split("\n")[0] + "\n  wgmma_commit();\n"
                 "  return;\n" + "\n".join(_PV_HEAD.split("\n")[1:]))]
_NO_LOADS = [(_LOAD, "        mbar_arrive(full_bar + 8 * st);\n"
              "        continue;\n" + _LOAD)]
VARIANTS = {
    "stages 2 at D=64": ([("static constexpr int kStages = 3;",
                           "static constexpr int kStages = D == 64 ? 2 : 3;")],
                         True),
    "stages 4 at D=64": ([("static constexpr int kStages = 3;",
                           "static constexpr int kStages = D == 64 ? 4 : 3;")],
                         True),
    "2 consumers at D=64": ([("kConsumers = D == 64 ? 3 : 2;",
                              "kConsumers = 2;")], True),
    "no turns": (_NO_TURNS, True),
    "no softmax": (_NO_SOFTMAX, False),
    "no products": (_NO_PRODUCTS, False),
    "no loads": (_NO_LOADS, False),
    "no loads, softmax only": (_NO_LOADS + _NO_PRODUCTS, False),
    "no loads, no math": (_NO_LOADS + _NO_PRODUCTS + _NO_SOFTMAX, False),
}


def _source(changes) -> str:
    src = (_build.CSRC / "flash_attention.cu").read_text()
    for anchor, new in changes:
        if src.count(anchor) != 1:
            raise RuntimeError(f"ablation anchor not found once: {anchor!r}")
        src = src.replace(anchor, new)
    return src


def _build_all() -> dict:
    """Compile the shipped source and every variant at once; ``{name: (the
    entry point, registers and spills by head_dim)}``."""
    nvcc = _build.find_nvcc()
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, (changes, _)) in enumerate([("shipped", ([], True)),
                                             *VARIANTS.items()]):
        cu = OUT / f"v{i}.cu"
        cu.write_text(_source(changes))
        cmd = [nvcc, *_build.NVCC_FLAGS, "-shared", "-o", str(cu.with_suffix(
            ".so")), str(cu)]
        procs[name] = (cu.with_suffix(".so"), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the {name!r} variant:\n{log}")
        regs = _build.ptxas_resources(log, "flash_attention_wgmma_kernel")
        fn = ctypes.CDLL(str(so)).repro_flash_attention_bf16
        fn.argtypes = _build._SIGNATURES["repro_flash_attention_bf16"]
        fn.restype = ctypes.c_int
        out[name] = (fn, regs)
    return out


def _timed(fn, q, k, v, causal: bool):
    """Mean device ms of ``REPS`` launches and the output."""
    out = torch.empty_like(q)
    B, H, S, D = q.shape
    strides = (ctypes.c_int64 * 12)(*(s for t in (q, k, v, out)
                                      for s in t.stride()[:3]))
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), strides, B, H, k.shape[1], S, D,
                        int(causal), 0, 1.0 / math.sqrt(D), stream),
                     "flash_attention ablation")

    call()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(HEAD_START_CYCLES)
    start.record()
    for _ in range(REPS):
        call()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / REPS, out


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_ablation: needs a CUDA card", flush=True)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    built = _build_all()
    gen = torch.Generator(device="cuda").manual_seed(0)
    inputs = []
    for case, H, KV, D, causal in CASES:
        q, k, v = (torch.randn((1, n, 4096, D), generator=gen,
                               device="cuda").to(torch.bfloat16)
                   for n in (H, KV, KV))
        inputs.append((case, q, k, v, causal))
    rows, want = [], {}
    order = ["shipped", *VARIANTS, "shipped"]
    for name in order:
        fn, regs = built[name]
        same_bits = VARIANTS.get(name, ([], True))[1]
        row = {"variant": name, "registers_spills": regs, "ms": {}}
        for case, q, k, v, causal in inputs:
            ms, out = _timed(fn, q, k, v, causal)
            want.setdefault(case, out)
            row["ms"][case] = ms
            if same_bits and not torch.equal(out, want[case]):
                raise RuntimeError(f"{name!r} changed the bits at {case}")
        rows.append(row)
        print(f"{name:24s} " + " | ".join(f"{c} {ms:.4f} ms"
                                          for c, ms in row["ms"].items())
              + f"  (registers, spill bytes by head_dim: {regs})", flush=True)
    print(json.dumps({"card": smi, "reps": REPS, "rows": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
