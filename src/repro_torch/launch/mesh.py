"""Hardware constants for one card's roofline: the NVIDIA H100 SXM5, from
NVIDIA's H100 Tensor Core GPU datasheet.

The workload compiler's ``HostSpec`` (:mod:`repro_torch.core.workload.timeline`)
takes its defaults from here, and ``chip_smoke.py`` its bounds. The
reference's mesh functions build JAX meshes over TPU pods; their
``torch.distributed`` counterparts are not ported yet.
"""
PEAK_FLOPS_BF16 = 989e12      # per card, dense bf16 tensor-core peak
HBM_BW = 3.35e12              # bytes/s per card (HBM3)
