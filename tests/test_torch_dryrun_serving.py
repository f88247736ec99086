"""The dry run's serving rows against the reference's own: one layer period
of each arch at full width on (16, 16), at ``prefill_32k`` (the archs
``test_torch_dryrun_production.py`` does not hold there), ``decode_32k``
and ``long_500k`` (the archs that support it, each cut to the long-context
variant with an 8192-token window on both sides, as ``build_dryrun``
does). Each case is held as that file holds its own (``hold``)."""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
from test_torch_dryrun_production import (HYBRID, case,  # noqa
                                          period_tests)
from repro_torch.launch.dryrun import should_skip  # noqa: E402
from repro_torch.models import list_archs  # noqa: E402

HELD = ("qwen2-moe-a2.7b", "mamba2-130m")   # prefill_32k, held there
ARCHS = sorted(a for a in list_archs() if a != HYBRID) + [HYBRID]
CASES = [case(a, "prefill_32k") for a in ARCHS if a not in HELD] \
    + [case(a, "decode_32k") for a in ARCHS] \
    + [case(a, "long_500k") for a in ARCHS
       if not should_skip(a, "long_500k")]


# long_500k's one sequence leaves the data axes idle and its 8192-slot ring
# buffer split 512 slots a model rank: GSPMD spreads the step's few
# products over the idle data ranks as well (the logits' contraction, the
# probabilities' product), where the port's layouts leave them to the
# model axis; its temporaries hold the cache it writes anew, the port's
# write is in place. Port / reference after this PR (FLOPs, temporaries,
# link bytes):
OPEN = {
    case("glm4-9b", "long_500k"):
        "link bytes 0.351 (FLOPs 1.000, temporaries 0.165)",
    case("llama3.2-1b", "long_500k"):
        "FLOPs 1.393 (temporaries 0.123, link bytes 1.721)",
    case("mamba2-130m", "long_500k"):
        "FLOPs 1.060, temporaries 2.124 (link bytes 1.163)",
    case("nemotron-4-340b", "long_500k"):
        "FLOPs 1.195, temporaries 0.024 (link bytes 1.689)",
    case("qwen2-7b", "long_500k"):
        "temporaries 0.081 (FLOPs 1.032, link bytes 1.321)",
    case("qwen2-moe-a2.7b", "long_500k"):
        "temporaries 0.050, link bytes 2.571 (FLOPs 1.013)",
    case("qwen2-vl-2b", "long_500k"):
        "temporaries 0.097 (FLOPs 1.017, link bytes 0.730)"}


reference, test_serving_period_against_reference = period_tests(CASES, OPEN)
