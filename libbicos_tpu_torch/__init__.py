"""libbicos_tpu_torch — BInary COrrespondence Search on PyTorch and CUDA.

The port of ``libbicos_tpu`` to PyTorch with hand-written CUDA kernels for
NVIDIA Hopper (``csrc/``). It imports torch and numpy, never jax. Module
names follow the JAX package, so each counterpart is found by name.

Public surface::

    import libbicos_tpu_torch as bicos
    disp = bicos.match(stack0, stack1, bicos.Config(...))  # on the card
    disp, corr = bicos.match(stack0, stack1, cfg, corrmap=True)
    disp = bicos.match(stack0, stack1, cfg, device="cpu")  # plain, on the CPU

The entry points run on the current CUDA device unless ``device`` says
otherwise; without a card they raise rather than fall back to the CPU.
"""

from .config import (
    Config,
    Consistency,
    INVALID_DISP_FLOAT,
    INVALID_DISP_INT16,
    MAX_BITS,
    NoDuplicates,
    Precision,
    TransformMode,
    config_from_reference,
    invalid_disparity,
    is_invalid,
    max_stacksize,
    required_bits,
)
from .pipeline import match, match_batched, match_batched_folded

__version__ = "0.1.0"

__all__ = [
    "Config",
    "Consistency",
    "INVALID_DISP_FLOAT",
    "INVALID_DISP_INT16",
    "MAX_BITS",
    "NoDuplicates",
    "Precision",
    "TransformMode",
    "config_from_reference",
    "invalid_disparity",
    "is_invalid",
    "match",
    "match_batched",
    "match_batched_folded",
    "max_stacksize",
    "required_bits",
    "__version__",
]
