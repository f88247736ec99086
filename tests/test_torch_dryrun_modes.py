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


# canary_fp: the reference's quantizer and dequantizer, run as loops over
# their grids, all-gather each tensor the model axis splits once an
# iteration (``hold``): the iterations and bytes of those all-gathers
FINDINGS = {
    case("llama3.2-1b", "train_4k", grad_sync="canary_fp"):
        {"quantizer_gathers": (17312, 16917406416896)},
    case("qwen2-moe-a2.7b", "train_4k", grad_sync="canary_fp"):
        {"quantizer_gathers": (10456, 11856064282624)}}


reference, test_mode_period_against_reference = period_tests(CASES,
                                                             FINDINGS)
