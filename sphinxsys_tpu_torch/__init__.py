"""PyTorch / CUDA port of sphinxsys_tpu (the JAX package stays the reference).

The first slice runs the dual-criteria WCSPH dambreak (2D and 3D) on the
cell-block engine: case setup (`cases/`), the generic block runner
(`engine/scene.py`), the block physics (`physics/fluid_blocks.py`) and the
three pair sweeps of `ops/block_sweeps.py`, which launch hand-written CUDA
kernels (`csrc/block_sweeps.cu`) on CUDA tensors and use their plain
PyTorch versions on CPU tensors.

Module names mirror `sphinxsys_tpu/` so each counterpart is easy to find.
This package imports torch and numpy only — never jax, never sphinxsys_tpu.
"""

from sphinxsys_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
