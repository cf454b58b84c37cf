"""Dtypes and device checks of the port.

Every tensor the port makes is float64 or complex128 and carries these
dtypes explicitly: the process-wide torch default dtype is never changed,
because test workers share the process with other code.
"""

from __future__ import annotations

import torch

real_dtype = torch.float64
complex_dtype = torch.complex128


def require_cuda() -> torch.device:
    """The first CUDA device; raises when torch sees no GPU."""
    if not torch.cuda.is_available():
        raise RuntimeError("ipde_tpu_torch: no CUDA device is available "
                           "(torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)
