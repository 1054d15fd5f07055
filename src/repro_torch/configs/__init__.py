"""Architecture registry: the reference's thirteen configs (the assigned
model zoo, the paper's oracle and proxy backbones and the embedding
encoder).

``get_config(name)`` returns the full-scale config; ``smoke_config(name)``
a reduced same-family config that runs a real forward on the CPU.
"""
from __future__ import annotations

from repro_torch.configs.registry import (ARCHS, LONG_CONTEXT_OK, get_config,
                                          input_logical_axes, input_specs,
                                          list_archs,
                                          long_context_skip_reason,
                                          smoke_config)
from repro_torch.models.config import (LayerSpec, ModelConfig, ShapeCell,
                                       SHAPES, uniform_pattern)
