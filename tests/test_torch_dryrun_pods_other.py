"""The dry run's two-pod rows against the reference's own: one layer
period of the ``train_4k`` step of the encoder-decoder, MoE, Mamba-2 and
hybrid archs at full width on (2, 16, 16), over ``("pod", "data",
"model")``, the batch split over ``("pod", "data")``.
Each case is held as ``test_torch_dryrun_production.py`` holds its own
(``hold``)."""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
from test_torch_dryrun_production import case, period_tests  # noqa

CASES = [case(a, "train_4k", mesh="multi") for a in (
    "whisper-large-v3", "deepseek-moe-16b", "qwen2-moe-a2.7b", "mamba2-130m",
    "jamba-v0.1-52b")]
# the bytes held by the float32 finding (``hold``)
FINDINGS = {case(a, "train_4k", mesh="multi"): {"float32": True} for a in (
    "deepseek-moe-16b", "qwen2-moe-a2.7b", "jamba-v0.1-52b")}


reference, test_two_pod_other_period_against_reference = period_tests(
    CASES, FINDINGS)
