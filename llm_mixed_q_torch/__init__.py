"""PyTorch/CUDA port of ``llm_mixed_q_tpu`` for NVIDIA Hopper (sm_90a).

The JAX package stays the reference; this package mirrors its layout and
names (``ops/``, ``kernels/``, ``models/llama/``, ``models/opt/``) so each
module has an obvious counterpart. It imports torch, numpy and the
standard library only.

Entry points (``generate``, ``ContinuousBatcher``, ``opt_generate``,
``init_llama_params``, ``init_opt_params``, ``pack_llama_params``,
``pack_opt_params``) run on ``cuda`` unless the caller passes
``device="cpu"``; without CUDA the default raises instead of silently
running on the CPU.

Matmul precision on the card: float32 products run in full float32
(TF32 off for matmuls and cuDNN), mirroring the reference tests' "highest"
precision. The packed kernels compute in float32 as well.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. Raises when CUDA is asked for but absent."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: pass device='cpu' to run the port on "
            "the CPU"
        )
    return device
