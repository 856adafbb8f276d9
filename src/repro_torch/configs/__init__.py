"""Configurations of the port: copies of the JAX package's ``configs``
(the architecture registry and the paper's models). Import
``repro_torch.configs`` and use ``get_config(name)``."""
from .base import (ArchConfig, InputShape, INPUT_SHAPES, get_config,  # noqa
                   list_archs, reduced, register)
