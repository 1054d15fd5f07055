"""Architecture registry (ported so far: the oracle backbone and a
QKV-bias dense model).

``get_config(name)`` returns the full-scale config; ``smoke_config(name)``
a reduced same-family config that runs a real forward on the CPU.
"""
from __future__ import annotations

from repro_torch.configs.registry import (ARCHS, get_config, list_archs,
                                          smoke_config)
from repro_torch.models.config import (LayerSpec, ModelConfig, ShapeCell,
                                       SHAPES, uniform_pattern)
