"""Where the device work of a run goes."""

from __future__ import annotations


def resolve(device=None):
    """`device` as a torch.device.  None means the first CUDA card and raises
    when there is none: the CPU (where the kernels' plain versions run) is
    taken only when the caller names it, device="cpu" or `--device cpu`."""
    import torch
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA card found (torch.cuda.is_available() is false); to run "
            "on the CPU ask for it: device=\"cpu\", or --device cpu on the "
            "command line")
    return torch.device("cuda")
