"""Mesh-based fields: the narrow-band packaged level set (counterpart of
sphinxsys_tpu/meshes; reference src/shared/meshes and
mesh_dynamics/level_set_dynamics)."""

from sphinxsys_tpu_torch.meshes.levelset import (LevelSet, LevelSetShape,
                                                 build_levelset)
