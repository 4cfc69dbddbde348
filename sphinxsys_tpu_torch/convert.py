"""State carried across from the JAX package: its state dicts (the
plastic and bar fields among them, the continuum's 3 x 3 stresses,
shear stresses, hourglass accelerations, hardening and penalty factors,
the muscles' Fiber and Sheet fields, and the Eulerian and compressible
states with their Momentum and TotalEnergy), tree networks,
BlockSim arrays, neighbour lists, articulated trees, rigid bodies and
case sims (the two-phase ones, the damping family's with their macro and
sub-step counts, the continuum family's, whose UL sims' sub-step count
JAX does not keep and starts at 0, and the Windkessel channel's with its
RCR state, the shell family's), frozen pairs (ReferencePairs, the
solid-shell CouplingPairs, the shell contacts' ShellContactPairs and
SurfacePairs), level sets (`levelset_from_jax`), porous states (plain
state dicts), voxel images (`image_from_numpy`), distributed carries
(`halo_shard_from_numpy`: a sharded state's per-device arrays split
into the ring's rank pieces) and plain arrays (a conductivity field, an
optimiser's parameters), handed over as numpy, become the port's CPU
tensors, and back.  The parity tests use these to feed
both sides identical inputs."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sphinxsys_tpu_torch.core.network import Branch, TreeNetwork
from sphinxsys_tpu_torch.neighbors.neighbor_list import NeighborList
from sphinxsys_tpu_torch.physics import rigid
from sphinxsys_tpu_torch.physics.articulated import ArticulatedTree
from sphinxsys_tpu_torch.physics.windkessel import WindkesselState


def _tensor(a):
    return torch.as_tensor(np.array(a))  # a private, writable copy


def tensor_from_numpy(a) -> torch.Tensor:
    """An array (a conductivity field, Adam's log-conductivity and
    moments) -> a CPU tensor of its dtype, a private copy."""
    return _tensor(a)


def windkessel_from_numpy(wk) -> WindkesselState:
    """A Windkessel state (p, q, flow_acc as numpy) -> the port's 0-d
    tensors."""
    return WindkesselState(p=_tensor(wk.p), q=_tensor(wk.q),
                           flow_acc=_tensor(wk.flow_acc))


def state_from_numpy(state: dict) -> dict:
    """Particle state dict (numpy values; "NReal" a scalar) -> tensors of
    the same dtypes."""
    return {k: int(np.asarray(v)) if k == "NReal" else _tensor(v)
            for k, v in state.items()}


def block_state_from_numpy(fb: dict) -> dict:
    """Block state dict ((C+1, cap, ...) numpy arrays incl. SlotMask and
    OriginalID) -> tensors of the same dtypes."""
    return {k: _tensor(v) for k, v in fb.items()}


def neighbor_list_from_numpy(nl) -> NeighborList:
    """A neighbour list (idx, count, overflow as numpy) -> the port's."""
    return NeighborList(idx=_tensor(nl.idx), count=_tensor(nl.count),
                        overflow=_tensor(nl.overflow))


def tree_from_numpy(tree) -> ArticulatedTree:
    """An articulated tree (its arrays as numpy; parent and joint_type
    static) -> the port's, its tensors in the arrays' dtype."""
    return ArticulatedTree(
        parent=np.asarray(tree.parent), axis=_tensor(tree.axis),
        r_parent=_tensor(tree.r_parent), r_child=_tensor(tree.r_child),
        mass=_tensor(tree.mass), inertia=_tensor(tree.inertia),
        com=_tensor(tree.com), joint_type=tuple(tree.joint_type))


def network_from_numpy(net) -> TreeNetwork:
    """A tree network (positions, branch ids, its branches) -> the port's
    TreeNetwork, every array a private float64 / int64 copy."""
    branches = [Branch(id=int(b.id), parent=int(b.parent),
                       particles=[int(i) for i in b.particles],
                       end_direction=np.array(b.end_direction, np.float64),
                       children=[int(c) for c in b.children],
                       is_terminated=bool(b.is_terminated))
                for b in net.branches]
    return TreeNetwork(positions=np.array(net.positions, np.float64),
                       branch_id=np.array(net.branch_id, np.int64),
                       branches=branches,
                       segment_length=float(net.segment_length))


def pairs_from_numpy(cls, pairs):
    """Frozen pairs (any named tuple of arrays with the port class `cls`'s
    field names: solid.ReferencePairs, solid_shell.CouplingPairs,
    shell_fluid.ShellContactPairs, surface_contact.SurfacePairs) -> `cls`,
    its fields tensors of the arrays' dtypes."""
    return cls(**{k: _tensor(getattr(pairs, k)) for k in cls._fields})


def rigid_from_numpy(body):
    """A rigid body or a pin joint (RigidBody2D, RigidBody3D, PinJoint2D:
    any named tuple of those names, numpy leaves) -> the port's, its
    fields tensors."""
    cls = getattr(rigid, type(body).__name__)
    return cls(**{k: _tensor(v) for k, v in body._asdict().items()})


_COUNTS = ("n_adv", "n_ac", "n_s", "n_steps", "n_macro", "n_sub")


def sim_from_numpy(cls, sim):
    """A case's sim (any object with the port sim class `cls`'s field
    names as attributes, numpy leaves; `cls` a dataclass or a named
    tuple) -> `cls`: its state dicts through
    `state_from_numpy`, its neighbour lists through
    `neighbor_list_from_numpy`, its Windkessel state through
    `windkessel_from_numpy`, its rigid bodies and pin joints through
    `rigid_from_numpy`, its step counts as ints (0 where the sim has
    none), its other arrays as tensors."""
    names = ([f.name for f in dataclasses.fields(cls)]
             if dataclasses.is_dataclass(cls) else cls._fields)
    out = {}
    for name in names:
        v = getattr(sim, name, None)
        if name in _COUNTS:
            out[name] = 0 if v is None else int(np.asarray(v))
        elif isinstance(v, dict):
            out[name] = state_from_numpy({k: np.asarray(x)
                                          for k, x in v.items()})
        elif hasattr(v, "idx") and hasattr(v, "count"):
            out[name] = neighbor_list_from_numpy(v)
        elif type(v).__name__ == "WindkesselState":
            out[name] = windkessel_from_numpy(v)
        elif hasattr(v, "_asdict"):
            out[name] = rigid_from_numpy(v)
        else:
            out[name] = _tensor(v)
    return cls(**out)


def levelset_from_jax(ls):
    """A JAX package LevelSet (its arrays read as numpy) -> the port's
    LevelSet on the CPU: the same field bit for bit, the integer tables
    as int64, the kernel integrals where it has them."""
    from sphinxsys_tpu_torch.meshes.levelset import LevelSet

    def arr(name, dtype=None):
        v = getattr(ls, name)
        if v is None:
            return None
        t = _tensor(np.asarray(v))
        return t if dtype is None else t.to(dtype)

    return LevelSet(spacing=float(ls.spacing), lower=arr("lower"),
                    n_pkg=tuple(int(x) for x in ls.n_pkg),
                    coarse_map=arr("coarse_map", torch.int64),
                    pkg_coord=arr("pkg_coord", torch.int64),
                    pkg_nbr=arr("pkg_nbr", torch.int64), phi=arr("phi"),
                    kernel_w=arr("kernel_w"), kernel_gw=arr("kernel_gw"),
                    kernel_g2w=arr("kernel_g2w"))


def image_from_numpy(image):
    """A voxel image shape (`data`, `spacing`, `origin` as numpy / tuples)
    -> the port's ImageShape (its data as float32 numpy, as both packages
    keep it)."""
    from sphinxsys_tpu_torch.core.image import ImageShape

    return ImageShape(data=np.asarray(image.data, np.float32),
                      spacing=tuple(float(x) for x in image.spacing),
                      origin=tuple(float(x) for x in image.origin))


def halo_shard_from_numpy(fluid: dict, n_dev: int, time=0.0, n_adv=0, n_ac=0,
                          overflow=False, aux=()):
    """A distributed carry: `fluid`, the (n_dev * n_loc, ...) arrays of a
    state sharded along its particle axis over n_dev devices (the JAX
    package's HaloShard leaves read as numpy), split into the n_dev rank
    pieces of a ThreadRing's HaloShard (CPU tensors); the counters as the
    port keeps them; `aux` passed on as it is."""
    from sphinxsys_tpu_torch.parallel.domain import HaloShard

    pieces = [dict() for _ in range(n_dev)]
    for k, v in fluid.items():
        v = np.asarray(v)
        if v.shape[0] % n_dev:
            raise ValueError(f"{k}: {v.shape[0]} rows over {n_dev} devices")
        for piece, part in zip(pieces, np.split(v, n_dev)):
            piece[k] = _tensor(part)
    t = _tensor(time)
    return HaloShard(fluid=pieces, time=t, n_adv=int(n_adv), n_ac=int(n_ac),
                     overflow=torch.as_tensor(bool(overflow)), aux=aux)


def to_numpy(x):
    """Tensors (also inside dicts, lists and tuples) -> numpy."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: to_numpy(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(to_numpy(v) for v in x)
    return x
