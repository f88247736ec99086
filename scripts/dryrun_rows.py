"""The five integers of each production row that ``chip_smoke.py``'s phase
4j(c) runs on the card, counted on this machine's fake CPU tensors:
``per_device.flops``, ``per_device.bytes_accessed``,
``per_device.collective_link_bytes``, ``memory.temp_bytes`` and
``memory.total_bytes``.

Usage::

    PYTHONPATH=src python scripts/dryrun_rows.py [--write] [--procs 4] \\
        [--device cpu|cuda] [arch:shape:mesh:grad_sync ...]

Without rows it counts every row of ``tests/dryrun_rows.json`` (a row is
``arch:shape:mesh:grad_sync``, mesh ``single`` or ``multi``), each in a
process of its own, ``--procs`` at a time, and prints a line a row with
each integer beside the file's. ``--write`` writes the counts into the
file (the rows given, or all of them), which the CPU tests
(``tests/test_torch_dryrun_moe_decode.py`` and
``tests/test_torch_dryrun_rows_*.py``) and 4j(c) hold the rows to.
"""
import argparse
import json
import multiprocessing as mp
import os
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor

FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir,
                    "tests", "dryrun_rows.json")
KEYS = ("flops", "bytes_accessed", "collective_link_bytes", "temp_bytes",
        "total_bytes")


def integers(row: dict) -> dict:
    """The five integers of a dry-run row (its JSON as ``run_one`` writes
    it); the link bytes, a float sum of whole bytes, as an int."""
    link = row["per_device"]["collective_link_bytes"]
    if link != int(link):
        raise ValueError(f"link bytes {link} are not whole")
    return {"flops": row["per_device"]["flops"],
            "bytes_accessed": row["per_device"]["bytes_accessed"],
            "collective_link_bytes": int(link),
            "temp_bytes": row["memory"]["temp_bytes"],
            "total_bytes": row["memory"]["total_bytes"]}


def count(key: str, device: str = "cpu") -> dict:
    """The integers of row ``key`` (``arch:shape:mesh:grad_sync``)."""
    from repro_torch.launch import dryrun as D
    arch, shape, mesh, sync = key.split(":")
    with tempfile.TemporaryDirectory() as out:
        return integers(D.run_one(arch, shape, mesh == "multi",
                                  grad_sync=sync, out_dir=out,
                                  device=device))


def _timed(key: str, device: str):
    t0 = time.perf_counter()
    return count(key, device), time.perf_counter() - t0


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("rows", nargs="*", help="arch:shape:mesh:grad_sync")
    ap.add_argument("--write", action="store_true")
    ap.add_argument("--procs", type=int, default=4)
    ap.add_argument("--device", default="cpu", choices=["cpu", "cuda"],
                    help="the fake tensors' device (cuda: the card's "
                    "torch, to set beside the file's CPU count)")
    args = ap.parse_args(argv)
    if args.write and args.device != "cpu":
        ap.error("--write takes the CPU's count")
    with open(FILE) as f:
        held = json.load(f)
    rows = args.rows or sorted(held)
    with ProcessPoolExecutor(args.procs,
                             mp_context=mp.get_context("spawn")) as pool:
        for key, (got, secs) in zip(rows, pool.map(
                _timed, rows, [args.device] * len(rows))):
            want = held.get(key, {})
            for k in KEYS:
                print(f"{key} {k}: {got[k]} (file {want.get(k)})"
                      f"{'' if got[k] == want.get(k) else ' DIFFERS'}",
                      flush=True)
            print(f"{key}: {secs:.1f} s", flush=True)
            held[key] = got
    if args.write:
        with open(FILE, "w") as f:
            json.dump(held, f, indent=1, sort_keys=True)
            f.write("\n")


if __name__ == "__main__":
    main()
