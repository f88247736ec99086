"""The dry run's rows in the CLI's modes against the reference's own: one
layer period of ``train_4k`` at full width on (16, 16) under ``--grad-sync
canary_fp`` (the Canary trees' sync, parameters replicated over the data
axis), ``--seq-parallel`` and ``--moe-impl`` ``ep`` and ``ep_a2a``. Each
case is held as ``test_torch_dryrun_production.py`` holds its own
(``hold``)."""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
from test_torch_dryrun_production import case, period_tests  # noqa

CASES = [case("llama3.2-1b", "train_4k", grad_sync="canary_fp"),
         case("qwen2-moe-a2.7b", "train_4k", grad_sync="canary_fp"),
         case("nemotron-4-340b", "train_4k", seq_parallel=True),
         case("llama3.2-1b", "train_4k", seq_parallel=True),
         case("deepseek-moe-16b", "train_4k", moe_impl="ep"),
         case("deepseek-moe-16b", "train_4k", moe_impl="ep_a2a")]


# canary_fp: the reference's compiled step, in its data-manual shard_map,
# all-gathers the (2052096, 128) float32 embedding table inside the
# quantizer's while loop, once an iteration (8016 of them, twice): 16.9 TB
# a device, which ``costs`` reads as the HLO runs it; the port's
# temporaries, 2.5-3.8 times the reference's, are not attributed yet.
# Port / reference after this PR (FLOPs, temporaries, link bytes):
OPEN = {
    case("llama3.2-1b", "train_4k", grad_sync="canary_fp"):
        "temporaries 3.786, link bytes 0.001 (FLOPs 1.0245)",
    case("qwen2-moe-a2.7b", "train_4k", grad_sync="canary_fp"):
        "temporaries 2.548, link bytes 0.002 (FLOPs 1.000)"}


reference, test_mode_period_against_reference = period_tests(CASES, OPEN)
