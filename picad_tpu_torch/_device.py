"""The port's device rule: the card unless the caller asks for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """`None` means "cuda"; a CUDA device with no card raises.

    There is no silent CPU fallback: a CPU run is always asked for
    explicitly (`device="cpu"`), as the tests do.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "picad_tpu_torch runs on the CUDA card by default, but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "on the CPU"
        )
    return dev


def default_compute_dtype(device: torch.device) -> torch.dtype:
    """bf16 on the card (the production compute type), f32 on the CPU."""
    return torch.bfloat16 if device.type == "cuda" else torch.float32
