"""The explicit device of an entry point.

An entry point runs where its caller says, ``"cuda"`` by default.  Asking
for ``"cuda"`` on a machine without a usable CUDA device is an error: the
port never moves work to the CPU on its own.
"""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device %r was asked for but torch.cuda.is_available() is "
            "false; pass device='cpu' to run on the CPU" % str(device))
    return dev
