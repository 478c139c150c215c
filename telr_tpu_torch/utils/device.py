"""Where the device work of a run goes."""

from __future__ import annotations


def resolve(device=None):
    """`device` as a torch.device.  None means a CUDA card and raises when
    there is none: the CPU (where the kernels' plain versions run) is taken
    only when the caller names it, device="cpu" or `--device cpu`.  In a
    process group of several ranks (dist/mesh.py::init_distributed), None and
    "cuda" mean card rank % cards, so ranks spread over the host's cards and
    share them when there are fewer cards than ranks."""
    import torch
    if device is not None:
        device = torch.device(device)
        if device.type != "cuda" or device.index is not None:
            return device
    elif not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA card found (torch.cuda.is_available() is false); to run "
            "on the CPU ask for it: device=\"cpu\", or --device cpu on the "
            "command line")
    from telr_tpu_torch.dist.mesh import process_count, process_index
    cards = torch.cuda.device_count()
    if process_count() > 1 and cards:
        return torch.device("cuda", process_index() % cards)
    return torch.device("cuda")
