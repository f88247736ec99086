"""The dry run's two-pod rows against the reference's own: one layer
period of each dense decoder's ``train_4k`` step at full width on
(2, 16, 16), over ``("pod", "data", "model")``, the batch split over
``("pod", "data")``.
Each case is held as ``test_torch_dryrun_production.py`` holds its own
(``hold``)."""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
from test_torch_dryrun_production import case, period_tests  # noqa

# the decoders whose every layer is attention and an MLP; the other archs
# are tests/test_torch_dryrun_pods_other.py's (the two files run on two
# workers)
DENSE = ("glm4-9b", "llama3.2-1b", "nemotron-4-340b", "qwen2-7b",
         "qwen2-vl-2b")
CASES = [case(a, "train_4k", mesh="multi") for a in DENSE]
# the bytes held by the float32 finding (``hold``)
FINDINGS = {c: {"float32": True} for c in CASES}


reference, test_two_pod_period_against_reference = period_tests(CASES,
                                                                FINDINGS)
