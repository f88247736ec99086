#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) end to end on one card.

    python3 chip_smoke.py [--seed N]

Phases, in order; the first failed check exits non-zero and no result is
printed:

1. device   — the card's name and count, ``nvidia-smi``'s name and power
              limit, the CUDA, nvcc and Triton versions;
2. build    — builds the kernels from ``src/repro_torch/kernels/csrc``
              (seconds, and ``-Xptxas -v``: registers and spills);
3. kernels  — each kernel against its plain PyTorch version on the card, at
              the main path's shapes and at ragged ones;
4. main path — records two congested 256-host fat-tree runs (128
              participants allreducing 1 MiB each) with the port's
              simulator, compiles the dynamic trees, and replays both in
              fixed point on a seeded (128, 1024, 256) float32 input:
              the int32 results must be bit-identical and exact, and every
              kernel must have been launched as the schedules imply;
5. timing   — CUDA events over warm launches: each kernel beside its bound,
              its plain version and one PyTorch call for the same function;
              then one replay under ``torch.profiler`` (device busy share,
              device time by kernel);
6. summary  — one ``{"kernels": [...]}`` JSON line, the card line, and last
              ``{"ok": true, "device": {...}}``.

It imports nothing of the JAX package. Where ``torch.cuda.is_available()``
is false, or outside a checkout of the repository, it exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
DEV = "cuda"
HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
P, BLOCK_BYTES, MSG_BYTES = 128, 1024, 1 << 20
D = BLOCK_BYTES // 4             # float32 values per block (one packet)
BITS = 24
VARIANTS = {                     # two congestion worlds, distinct trees
    "seed3_t50": dict(seed=3, timeout_ns=50.0, noise_prob=0.2),
    "seed29_t500": dict(seed=29, timeout_ns=500.0, noise_prob=0.05),
}
ROUND_SHAPE = (128, 256, 8)      # (N, D, slots) of a replay reduce round
FIG6_SHAPE = (4096, 32, 1024)    # benchmarks/fig6_single_switch.py:35


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
    """Mean device milliseconds of ``fn`` over ``reps`` warm launches."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def in_turns(plain, kernel, reps: int):
    """``(kernel_ms, plain_ms)``, timed plain, kernel, kernel, plain."""
    p1, k1 = event_ms(plain, reps), event_ms(kernel, reps)
    k2, p2 = event_ms(kernel, reps), event_ms(plain, reps)
    return (k1 + k2) / 2, (p1 + p2) / 2


def bound_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


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
    return name, count, smi


def phase_build():
    print("== phase 2: build", flush=True)
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    b = _build.build()
    print(f"built {b.path.relative_to(ROOT)} in {b.seconds:.2f} s "
          f"(wall {time.perf_counter() - t0:.2f} s)")
    for line in b.log.splitlines():
        if "ptxas info" in line or "spill" in line or line.startswith("=="):
            print("  " + line.strip())
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
    for n, d, slots in (ROUND_SHAPE, FIG6_SHAPE, (77, 200, 7)):
        ids = torch.randint(0, slots, (n,), generator=gen, device=DEV,
                            dtype=torch.int32)
        ids[::7] = slots                         # these hit nothing
        pi = torch.randint(-1_000_000, 1_000_000, (n, d), generator=gen,
                           device=DEV, dtype=torch.int32)
        got, ref = packet_accumulate(ids, pi, slots), \
            packet_accumulate_ref(ids, pi, slots)
        check(torch.equal(got, ref), f"packet_accumulate int32 {n, d, slots}")
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


def phase_main_path(x: torch.Tensor, rows: dict) -> dict:
    """Record -> compile -> fixed-point replay, for both variants."""
    print("== phase 4: main path (record -> compile -> fixed-point replay)",
          flush=True)
    from repro_torch.core.canary import (Algo, AllreduceJob, Simulator,
                                         scaled_config)
    from repro_torch.core.trace import (compile_app, fixed_point_replay,
                                        schedule_report)
    from repro_torch.kernels import (fixed_point_scale, launch_counts,
                                     reset_launch_counts)
    from repro_torch.kernels.ref import quantize_ref

    scale = fixed_point_scale(x.abs().max(), bits=BITS, world=P)
    exact = quantize_ref(x, scale).to(torch.int64).sum(dim=0)
    ref64 = x.double().sum(dim=0)
    qs, schedules, totals = [], [], dict.fromkeys(rows, 0)
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

        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t_rep, (out, q) = sync_wall(lambda: fixed_point_replay(scheds, x,
                                                               bits=BITS,
                                                               device=DEV))
        counts = launch_counts()
        depth = sum(s.depth for s in scheds)
        check(counts == {"quantize": 1, "dequantize": 1,
                         "packet_accumulate": depth},
              f"{label}: launches {counts}, schedules imply depth {depth}")
        for k, v in counts.items():
            totals[k] += v
        check(q.dtype == torch.int32 and q.shape == x.shape, "q shape/type")
        check(torch.equal(q, q[:1].expand_as(q)), f"{label}: rows differ")
        check(torch.equal(q[0].to(torch.int64), exact),
              f"{label}: q is not the exact sum of the quantized inputs")
        err = float((out[0].double() - ref64).abs().max())
        tol = (P + 1) * 0.5 / scale.item()
        check(torch.isfinite(out).all() and err <= tol,
              f"{label}: |result - float64 sum| {err} > {tol}")
        qs.append(q)
        schedules.append(scheds)
        print(f"{label}: record {t_rec:.2f} s, compile {t_comp:.2f} s, "
              f"replay {t_rep:.3f} s, depth max {rep['depth_max']} mean "
              f"{rep['depth_mean']:.3f}, fan-in max {rep['max_fanin']}, "
              f"launches {counts}, |result - f64 sum| {err:.3g} <= {tol:.3g}, "
              f"peak {torch.cuda.max_memory_allocated() / 2**20:.0f} MiB",
              flush=True)
    check(torch.equal(qs[0], qs[1]), "q differs between the two traces")
    print(f"q bit-identical across {len(qs)} traces")
    for k, v in totals.items():
        rows[k]["launches"] = v
    return schedules[0]


def phase_profile(x: torch.Tensor, scheds) -> None:
    """One more replay of the first trace under ``torch.profiler``: device
    busy share of the host wall, and device time by kernel name."""
    print("== phase 5b: replay profile (torch.profiler)", flush=True)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.trace import fixed_point_replay
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall, _ = sync_wall(lambda: fixed_point_replay(scheds, x, bits=BITS,
                                                       device=DEV))
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    busy_us = sum(us for _, us in by_name.values())
    if busy_us:
        print(f"profiled replay: wall {wall:.3f} s, device busy "
              f"{busy_us / 1e3:.1f} ms ({busy_us / (wall * 1e6):.1%} of the "
              f"wall)")
    else:
        print(f"profiled replay: wall {wall:.3f} s; the profiler saw no "
              f"device activity: busy share not measured")
    for name, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]:
        print(f"  {n:6d} x {us / n:8.2f} us = {us / 1e3:8.2f} ms  {name[:90]}")
    sys.stdout.flush()


def phase_timing(x: torch.Tensor, rows: dict) -> None:
    print("== phase 5: timing (CUDA events, warm)", flush=True)
    from repro_torch.kernels import (_build, dequantize, fixed_point_scale,
                                     packet_accumulate, quantize)
    from repro_torch.kernels.packet_accum import csr_by_slot
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
    stream = torch.cuda.current_stream().cuda_stream
    for shape in (ROUND_SHAPE, FIG6_SHAPE):
        rn, d, slots = shape
        ids = torch.randint(0, slots, (rn,), generator=gen, device=DEV,
                            dtype=torch.int32)
        pay = torch.randint(-1_000_000, 1_000_000, (rn, d), generator=gen,
                            device=DEV, dtype=torch.int32)
        k, p = in_turns(lambda: packet_accumulate_ref(ids, pay, slots),
                        lambda: packet_accumulate(ids, pay, slots), 200)
        lib = event_ms(lambda: torch.zeros((slots, d), dtype=torch.int32,
                                           device=DEV).index_add_(0, ids,
                                                                     pay), 200)
        order, offsets = csr_by_slot(ids, slots)
        out = torch.empty((slots, d), dtype=torch.int32, device=DEV)
        fn = _build.library().repro_packet_accumulate_i32
        kern = event_ms(lambda: fn(pay.data_ptr(), order.data_ptr(),
                                   offsets.data_ptr(), out.data_ptr(), slots,
                                   d, stream), 200)
        nbytes = 4 * (rn * d + rn + slots * d)
        print(f"packet_accumulate int32 (N, D, slots)={shape}: wrapper "
              f"{k:.4f} ms, kernel alone {kern:.4f} ms, plain {p:.4f}, "
              f"index_add_ {lib:.4f}, bound {bound_ms(nbytes):.6f}")
        if shape == ROUND_SHAPE:
            rows["packet_accumulate"].update(
                ms=k, plain_ms=p, bound_ms=bound_ms(nbytes), bound_by="bytes",
                library_ms=lib)
    for name in ("quantize", "dequantize"):
        r = rows[name]
        print(f"{name} {tuple(x.shape)}: {r['ms']:.4f} ms (plain "
              f"{r['plain_ms']:.4f}, bound {r['bound_ms']:.4f}, library "
              f"{r['library_ms']})")
    sys.stdout.flush()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    name, count, smi = phase_device()
    phase_build()
    rows = {
        "quantize": dict(source="src/repro_torch/kernels/csrc/fixedpoint.cu",
                         replaces="src/repro/kernels/fixedpoint.py:25"),
        "dequantize": dict(source="src/repro_torch/kernels/csrc/fixedpoint.cu",
                           replaces="src/repro/kernels/fixedpoint.py:30"),
        "packet_accumulate": dict(
            source="src/repro_torch/kernels/csrc/packet_accum.cu",
            replaces="src/repro/kernels/packet_accum.py:31"),
    }
    gen = torch.Generator(device=DEV).manual_seed(args.seed)
    x = torch.randn((P, MSG_BYTES // BLOCK_BYTES, D), generator=gen,
                    device=DEV)
    phase_kernels(x, rows)
    scheds = phase_main_path(x, rows)
    phase_timing(x, rows)
    phase_profile(x, scheds)

    for r in rows.values():
        check(r["launches"] > 0, "a kernel of the main path never launched")
    kernels = [dict(name=k, route="cuda", source=r["source"],
                    replaces=r["replaces"], launches=r["launches"],
                    max_abs_err=r["max_abs_err"], ms=r["ms"],
                    plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                    bound_by=r["bound_by"], library_ms=r["library_ms"])
               for k, r in rows.items()]
    print("== phase 6: summary")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
