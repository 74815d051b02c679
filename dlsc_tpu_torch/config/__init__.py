"""Config composition and instantiation for the port's CLI scripts.

A copy of ``dlsc_tpu/config/core.py`` and ``compose.py`` (YAML composition,
``${...}`` interpolation, CLI overrides), so that the port reads the
repository's ``configs/`` without importing the JAX package, and the port's
own ``_target_`` table (``instantiate.py``). Needs only ``yaml`` and the
standard library.
"""

from dlsc_tpu_torch.config.compose import compose, load_yaml, parse_overrides
from dlsc_tpu_torch.config.core import Config, flatten, merge
from dlsc_tpu_torch.config.instantiate import instantiate, resolve_target

__all__ = ["Config", "compose", "flatten", "instantiate", "load_yaml", "merge",
           "parse_overrides", "resolve_target"]
