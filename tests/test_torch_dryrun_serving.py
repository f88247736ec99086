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


# long_500k: the reference writes its cache anew, in float32, where the
# port writes the step's slot in place (``hold``); the cases whose
# temporaries (and bytes) are held by that
FINDINGS = {case(a, "long_500k"): {"new_cache": True}
            for a in ("nemotron-4-340b", "qwen2-7b", "qwen2-moe-a2.7b",
                      "qwen2-vl-2b")}
# the reference's dense MoE route at decode (``hold``): the routing
# weights, one float32 value a slot (128 tokens x 4), all-reduced over the
# data axis with the tokens' gather; each slot's row of the experts'
# output, (512, 2048 / 16), gathered on each model rank and all-reduced
# over the model axis
FINDINGS[case("qwen2-moe-a2.7b", "decode_32k")] = {"dense_combine": [
    ["all-reduce", [["f32", [512, 2048]], ["f32", [512]]], "data",
     'x2d[src_tok], mode="drop")'],
    ["all-reduce", [["f32", [512, 128]]], "model",
     "vals = out[sorted_e, jnp.minimum(pos_in_e, cap - 1)]"]]}
# the bytes held by the float32 finding (``hold``)
for c in [case(a, "decode_32k") for a in (
        "deepseek-moe-16b", "jamba-v0.1-52b", "llama3.2-1b",
        "qwen2-moe-a2.7b", "whisper-large-v3")] + [
        case(a, "long_500k") for a in (
            "deepseek-moe-16b", "jamba-v0.1-52b", "llama3.2-1b",
            "qwen2-moe-a2.7b")]:
    FINDINGS.setdefault(c, {})["float32"] = True


reference, test_serving_period_against_reference = period_tests(CASES,
                                                                FINDINGS)
