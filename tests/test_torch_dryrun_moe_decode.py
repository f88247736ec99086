"""The dry run's production rows that ``chip_smoke.py``'s phase 4j(c) runs
on the card, each held to the integers of ``dryrun_rows.json`` exactly:
FLOPs, bytes accessed and collective link bytes a device, temporaries and
the peak. 4j(c) holds the card's count of the same rows to the same
integers, so that a DTensor rule that differs between torch releases
(2.11 on the card, 2.13 here) fails there: torch 2.11 once counted each
MoE decode's peak about twice these (its ``view`` gathered the key and
value caches over the model axis to merge their split batch and key-head
dims; ``parallel.layouts.on_local_heads`` attends on each rank's own rows
and heads), and qwen2-moe's dense route 100,798,464 bytes and 100,614,144
link bytes apart (the dry run's ``_reduce_partials`` and
``_flatten_gathered`` now lay its routing weights' product and its
capacity's flattening out).

The rows are split over this file and ``test_torch_dryrun_rows_*.py``
(:data:`PARTS`), each file some 100 s on one worker; the integers are
``scripts/dryrun_rows.py --write``'s."""
import json
import os

import pytest

from repro_torch.launch import dryrun as D

with open(os.path.join(os.path.dirname(__file__), "dryrun_rows.json")) as f:
    ROWS = json.load(f)

# each file's rows (``arch:shape:mesh:grad_sync``)
PARTS = {
    "moe_decode": ("deepseek-moe-16b:decode_32k:single:auto",
                   "qwen2-moe-a2.7b:decode_32k:single:auto",
                   "jamba-v0.1-52b:train_4k:single:auto"),
    "rows_llama": ("llama3.2-1b:train_4k:single:auto",
                   "llama3.2-1b:train_4k:single:canary_fp",
                   "llama3.2-1b:train_4k:multi:auto",
                   "llama3.2-1b:prefill_32k:single:auto",
                   "llama3.2-1b:decode_32k:single:auto",
                   "llama3.2-1b:long_500k:single:auto"),
    "rows_moe_ssm": ("qwen2-moe-a2.7b:train_4k:single:auto",
                     "mamba2-130m:train_4k:single:auto")}


def hold_row(key: str, out_dir: str) -> None:
    """Row ``key`` counted on fake CPU tensors through ``run_one``: its
    five integers those of ``dryrun_rows.json``."""
    arch, shape, mesh, sync = key.split(":")
    row = D.run_one(arch, shape, mesh == "multi", grad_sync=sync,
                    out_dir=out_dir, device="cpu")
    got = {"flops": row["per_device"]["flops"],
           "bytes_accessed": row["per_device"]["bytes_accessed"],
           "collective_link_bytes": row["per_device"][
               "collective_link_bytes"],
           "temp_bytes": row["memory"]["temp_bytes"],
           "total_bytes": row["memory"]["total_bytes"]}
    assert got == ROWS[key], key


def test_rows_are_split_over_the_files():
    """Every row of the file is held by exactly one test file."""
    held = [k for part in PARTS.values() for k in part]
    assert sorted(held) == sorted(ROWS)
    here = os.path.dirname(__file__)
    assert all(os.path.exists(os.path.join(here, f"test_torch_dryrun_{p}.py"))
               for p in PARTS)


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "qwen2-moe-a2.7b"])
def test_moe_decode_peak_to_the_byte(arch, tmp_path):
    hold_row(f"{arch}:decode_32k:single:auto", str(tmp_path))


@pytest.mark.parametrize("key", PARTS["moe_decode"][2:])
def test_row_to_the_integer(key, tmp_path):
    hold_row(key, str(tmp_path))
