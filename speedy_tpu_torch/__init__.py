"""speedy_tpu_torch: the PyTorch/CUDA port of speedy_tpu, the SPEEDY
intermediate-complexity atmospheric GCM. The JAX package ``speedy_tpu`` is
its reference; this package imports neither it nor JAX."""

__version__ = "0.1.0"

from .config import (ModelConfig, t30, t42, t63, t85, t170,  # noqa: F401
                     from_preset, PRESETS)
