"""The dry run's production rows of ``PARTS["rows_llama"]`` held to the
integers of ``dryrun_rows.json`` exactly, as ``chip_smoke.py``'s phase
4j(c) holds them on the card (see ``test_torch_dryrun_moe_decode.py``)."""
import pytest
from test_torch_dryrun_moe_decode import PARTS, hold_row


@pytest.mark.parametrize("key", PARTS["rows_llama"])
def test_row_to_the_integer(key, tmp_path):
    hold_row(key, str(tmp_path))
