"""repro_torch — the PyTorch/CUDA port of the Canary reproduction.

The JAX package ``repro`` beside it is the reference. This package imports
nothing of it (and never ``jax``): it keeps its own copies of the jax-free
simulator, trace recorder and schedule compiler, replays recorded trees
on an NVIDIA H100 through hand-written CUDA kernels
(``repro_torch.kernels``), serves the dense models, and trains them with
the Canary device collective (``repro_torch.core.collective``) syncing
the gradients.

Entry points run on the card unless the caller passes ``device="cpu"``.
"""
__version__ = "0.1.0"
