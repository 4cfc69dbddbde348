"""Device and dtype policy.

* The case entry points (`build_case`, `build_block_case`) run on the card
  by default (`device="cuda"`); the CPU is asked for explicitly
  (`device="cpu"`), as the tests do.  Below them the device comes from the
  caller; nothing guesses it from globals.
* Asking for CUDA where there is none raises — there is no silent CPU path.
* float32 is the production dtype; float64 runs the CPU oracle that the
  parity tests hold against the JAX package.
"""

from __future__ import annotations

import torch

PRODUCTION_DTYPE = torch.float32


def resolve_dtype(dtype) -> torch.dtype:
    """A torch.dtype or its name ("float32", "float64": the CLI's
    `--set dtype=float64`)."""
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype, None)
    if not isinstance(dtype, torch.dtype) or not dtype.is_floating_point:
        raise TypeError(f"not a floating dtype: {dtype!r}")
    return dtype


def resolve_device(device) -> torch.device:
    """`"cpu"`, `"cuda"`, `"cuda:N"` or a torch.device -> torch.device.
    Raises RuntimeError for CUDA when no card is visible."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but torch.cuda.is_available() "
                           "is False")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev
