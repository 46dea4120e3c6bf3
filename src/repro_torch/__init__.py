"""repro_torch -- the PyTorch/CUDA port of the JAX package ``repro``.

It keeps the JAX package's layout (``repro_torch.core``,
``repro_torch.kernels``, ``repro_torch.models``, ``repro_torch.configs``,
``repro_torch.launch``) and names.  The hot-spot ops of the solver (the
explicit and fused steps, events, and the stiff path's chord-Newton linear
algebra) and the LM's prefill attention run as hand-written CUDA kernels on
the card and as plain PyTorch on the CPU;
``repro_torch.convert`` carries weights and results between numpy and the
device.  It imports neither JAX nor anything of ``repro``.
"""

from . import convert
from .core import *  # noqa: F401,F403
from .core import __all__ as _core_all

__all__ = ["convert", *_core_all]
