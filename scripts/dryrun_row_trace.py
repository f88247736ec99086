"""The port's dry-run rows with their operation traces, to set one torch
release's count beside another's (or one device's beside another's).

Usage::

    PYTHONPATH=src python scripts/dryrun_row_trace.py --out rows_trace \\
        --devices cpu,cuda deepseek-moe-16b:decode_32k:single \\
        qwen2-7b:long_500k:multi

For each row (``arch:shape:mesh``, mesh ``single`` or ``multi``) and each
device of ``--devices`` it runs ``repro_torch.launch.dryrun.run_one`` and
records every operation the dry run counts: its name, its outputs' and
first inputs' local shapes, the live bytes after it and the bytes it adds
to ``bytes_accessed``. It prints a line a row and device (peak bytes,
FLOPs a device, useful share, the bytes accessed and the operation that
accounts for most of them), then the ``TOP`` operations by the bytes
they add and every operation of ``Accountant``'s ``_UNREAD`` (those that
move no tensor data) with its calls and the bytes it adds, 0, and writes
``<out>/trace_<torch release>.json``; two such files, from two releases,
part where their rules do.
"""
import argparse
import json
import os
import time
from collections import Counter

import torch

from repro_torch.launch import dryrun as D

TOP = 10            # operations listed a row by the bytes they add


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
        before = self.bytes
        count(self, func, fargs, kwargs, out)
        trace.append((str(func), [list(t.shape) for t in D._tensors(out)],
                      [list(t.shape) for t in D._tensors(list(fargs))][:4],
                      self.live, self.bytes - before))

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
                           accessed=r["per_device"]["bytes_accessed"],
                           at_peak=r["at_peak"], trace=list(trace))
                result[f"{spec}:{device}"] = row
                by_op, calls = Counter(), Counter()
                for op, *_, accessed in trace:
                    by_op[op] += accessed
                    calls[op] += 1
                (top, top_bytes), = by_op.most_common(1)
                print(f"{spec} {device}: peak {row['total']} bytes, "
                      f"{row['flops']} FLOP/dev, useful {row['useful']:.4f}, "
                      f"{row['accessed']} bytes accessed, {top_bytes} of "
                      f"them by {top} ({time.perf_counter() - t0:.1f} s)",
                      flush=True)
                unread = [op for op in calls
                          if tuple(op.split(".")[:2]) in D._UNREAD]
                for op in [o for o, _ in by_op.most_common(TOP)
                           if o not in unread] + sorted(unread):
                    print(f"  {op}: {calls[op]} calls, {by_op[op]} bytes",
                          flush=True)
    finally:
        D.Accountant._count = count
    path = os.path.join(args.out, f"trace_{torch.__version__[:4]}.json")
    with open(path, "w") as f:
        json.dump(result, f)
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
