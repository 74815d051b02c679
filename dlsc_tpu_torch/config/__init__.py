"""Config composition for the port's CLI scripts.

A copy of ``dlsc_tpu/config/core.py`` and ``compose.py`` (YAML composition,
``${...}`` interpolation, CLI overrides), so that the port reads the
repository's ``configs/`` without importing the JAX package. Needs only
``yaml`` and the standard library. The ``_target_`` instantiation table
(``dlsc_tpu/config/instantiate.py``) is not copied: the port has no trainer
that instantiates from config yet.
"""

from dlsc_tpu_torch.config.compose import compose, load_yaml, parse_overrides
from dlsc_tpu_torch.config.core import Config, flatten, merge

__all__ = ["Config", "compose", "flatten", "load_yaml", "merge", "parse_overrides"]
