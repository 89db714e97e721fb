"""Device resolution shared by every entry point of the port.

Entry points run on ``cuda`` unless the caller asks for the CPU. Without a
GPU they raise: the port never drops to the CPU silently.

Matrix precision: TF32 is switched off for matmuls and cuDNN here, so the
centroid GEMMs of k-means and of the IVF filter run in full float32 on
the card, as the reference's do on its backend.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """Return the device an entry point runs on.

    Parameters
    ----------
    device : str or torch.device, optional
        ``None`` (default) selects ``cuda``; pass ``"cpu"`` to run the
        plain PyTorch versions on the CPU.

    Returns
    -------
    torch.device
        The resolved device.

    Raises
    ------
    RuntimeError
        When a CUDA device is requested (explicitly or by default) and
        none is available.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev
