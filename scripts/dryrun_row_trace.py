"""The port's dry-run rows with their operation traces, to set one torch
release's count beside another's (or one device's beside another's).

Usage::

    PYTHONPATH=src python scripts/dryrun_row_trace.py --out rows_trace \\
        --devices cpu,cuda deepseek-moe-16b:decode_32k:single \\
        qwen2-7b:long_500k:multi

For each row (``arch:shape:mesh``, mesh ``single`` or ``multi``) and each
device of ``--devices`` it runs ``repro_torch.launch.dryrun.run_one`` and
records every operation the dry run counts: its name, its outputs' and
first inputs' local shapes and the live bytes after it. It prints a line a
row and device (peak bytes, FLOPs a device, useful share) and writes
``<out>/trace_<torch release>.json``; two such files, from two releases,
part where their rules do.
"""
import argparse
import json
import os
import time

import torch

from repro_torch.launch import dryrun as D


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("rows", nargs="+", help="arch:shape:mesh")
    ap.add_argument("--out", required=True)
    ap.add_argument("--devices", default="cpu",
                    help="comma-separated fake tensors' devices")
    args = ap.parse_args(argv)
    trace = []
    count = D.Accountant._count

    def traced(self, func, fargs, kwargs, out):
        count(self, func, fargs, kwargs, out)
        trace.append((str(func), [list(t.shape) for t in D._tensors(out)],
                      [list(t.shape) for t in D._tensors(list(fargs))][:4],
                      self.live))

    D.Accountant._count = traced
    result = {"torch": torch.__version__}
    try:
        for spec in args.rows:
            arch, shape, mesh = spec.split(":")
            for device in args.devices.split(","):
                trace.clear()
                t0 = time.perf_counter()
                r = D.run_one(arch, shape, mesh == "multi",
                              out_dir=os.path.join(args.out, "rows"),
                              device=device)
                row = dict(total=r["memory"]["total_bytes"],
                           flops=r["per_device"]["flops"],
                           link=r["per_device"]["collective_link_bytes"],
                           useful=r["roofline"]["useful_flops_ratio"],
                           at_peak=r["at_peak"], trace=list(trace))
                result[f"{spec}:{device}"] = row
                print(f"{spec} {device}: peak {row['total']} bytes, "
                      f"{row['flops']} FLOP/dev, useful {row['useful']:.4f} "
                      f"({time.perf_counter() - t0:.1f} s)", flush=True)
    finally:
        D.Accountant._count = count
    path = os.path.join(args.out, f"trace_{torch.__version__[:4]}.json")
    with open(path, "w") as f:
        json.dump(result, f)
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
