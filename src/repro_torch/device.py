"""Device and dtype resolution shared by the port's entry points."""
from __future__ import annotations

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_device(device) -> torch.device:
    """``device`` as a :class:`torch.device`; a CUDA device must exist.

    Entry points default to ``"cuda"`` and call this, so on a machine
    without a card they fail loudly instead of silently running the
    plain CPU versions.  Pass ``device="cpu"`` to run those on purpose.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: device 'cuda' requested but torch.cuda is not "
            "available; pass device='cpu' to run the plain PyTorch "
            "versions of the kernels")
    return dev


def torch_dtype(name: str) -> torch.dtype:
    """``ModelConfig.dtype`` string -> torch dtype."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}; "
                         f"known: {sorted(_DTYPES)}") from None
