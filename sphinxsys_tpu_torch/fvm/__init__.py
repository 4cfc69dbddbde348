"""Finite-volume (FVM) front end on unstructured meshes (counterpart of
sphinxsys_tpu/fvm/; reference unstructured_mesh.h (ANSYSMesh),
fvm_ghost_boundary.h and FVM_flow_around_cylinder_2d_def.h).

The mesh is compiled once on the host (numpy, `mesh.py`) into flat face
arrays and a dense padded cell -> face incidence table; every solver op
(`dynamics.py`) is then face gathers and a (C, K) incidence gather-sum in
torch, with no scatter and no ragged structure.
"""

from sphinxsys_tpu_torch.fvm.mesh import FVMesh, read_fluent_msh, compile_mesh
from sphinxsys_tpu_torch.fvm.meshgen import cylinder_ogrid, write_fluent_msh
