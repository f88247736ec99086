"""Architecture registry: name -> ModelConfig (full / smoke).

``repro_torch.configs`` modules import ``repro_torch.models.config``
(which triggers this package's ``__init__``), so the configs import lives
inside the functions — importing ``repro_torch.configs`` first must not
deadlock on a partially initialized module.
"""
from __future__ import annotations

from typing import List

from .config import ModelConfig


def list_archs() -> List[str]:
    from repro_torch.configs import ARCH_NAMES
    return list(ARCH_NAMES)


def get_config(name: str, variant: str = "full") -> ModelConfig:
    from repro_torch.configs import ARCH_MODULES, ARCH_NAMES
    key = name.lower()
    if key not in ARCH_MODULES:
        raise KeyError(f"unknown arch '{name}'; known: {ARCH_NAMES}")
    mod = ARCH_MODULES[key]
    if variant == "full":
        return mod.full()
    if variant == "smoke":
        return mod.smoke()
    raise ValueError(f"unknown variant '{variant}' (full|smoke)")
