"""Device policy of the port.

`device=None` means the CUDA card and raises when there is none: a
solve never falls back to the CPU silently.  The CPU is used only when
a caller asks for it by name (`device="cpu"`, as the tests do); there
every kernel wrapper runs its plain PyTorch version.

The f32 inner solve must stay true f32 to match the JAX package's
`Precision.HIGHEST` contractions, so TF32 is switched off for both
matmuls and cuDNN whenever a device is resolved.
"""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """torch.device for the port's tensors (see module docstring)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "padne_tpu_torch needs a CUDA device; pass device='cpu' "
                "to run the plain PyTorch versions on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' requested but CUDA is absent")
    return dev
