"""The peaks and bytes accessed of the two MoE archs' ``decode_32k`` rows on
(16, 16), to the byte (``dryrun_moe_decode_bytes.json``): the integers that
``chip_smoke.py``'s phase 4j(c) holds the same rows to on the card, where
torch 2.11 once counted each peak about twice these (DTensor 2.11 gathered
the key and value caches over the model axis to merge their split batch
and key-head dims for the attention's product;
``parallel.layouts.on_local_heads`` attends on each rank's own rows and
heads)."""
import json
import os

import pytest

from repro_torch.launch import dryrun as D

with open(os.path.join(os.path.dirname(__file__),
                       "dryrun_moe_decode_bytes.json")) as f:
    BYTES = json.load(f)


@pytest.mark.parametrize("arch", sorted(BYTES))
def test_moe_decode_peak_to_the_byte(arch, tmp_path):
    row = D.run_one(arch, "decode_32k", False, out_dir=str(tmp_path),
                    device="cpu")
    assert row["memory"]["total_bytes"] == BYTES[arch]["total_bytes"]
    assert row["per_device"]["bytes_accessed"] \
        == BYTES[arch]["bytes_accessed"]
