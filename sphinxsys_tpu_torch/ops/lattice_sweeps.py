"""The two tap sums of the lattice-stencil total-Lagrangian solid.

  lattice_force (L1) <- sphinxsys_tpu/physics/solid_lattice.py
                        decomposed_integration_1st_half_lattice, its tap
                        loop (:285-300)
  lattice_dfdt  (L2) <- integration_2nd_half_lattice, its tap loop
                        (:335-347)

No Pallas kernel stands behind them: in JAX these loops are jnp code that
XLA fuses into one pass over a padded halo buffer.  Eager PyTorch runs
the same loop as ~30 elementwise launches a tap (about 5,000 a step at 80
taps), each over a whole lattice plane, so each sum has a hand-written
CUDA kernel (csrc/lattice_sweeps.cu, built by ops/_build.py) and, beside
it, a plain PyTorch version that is JAX's loop written in torch ops.
Dispatch as in ops/block_sweeps.py: a CPU tensor runs the plain version; a
CUDA float32 tensor launches the kernel (or raises); anything else raises.
`LAUNCHES` counts kernel launches (plain runs do not count).

The kernels stage a brick of sites (6 x 32 of a (y, z) plane for L1, 4 x
32 for L2) with its halo of two sites once in shared memory, a ring of
five planes as the block marches along x, every value selected by
validity as it is staged (an invalid or out-of-box site stages zeros and
w = 0), and read each of the 80 taps there at a compile-time offset, its
in-box and valid_j tests replaced by JAX's multiply by w_j.  L1 reads
11.75 shared-memory wavefronts a pair and is held to 12 warps an SM by
its staged planes and registers; L2 reads one float4 a pair.
`occupancy` reports each design on the card.  Being compiled for the 80
offsets 0 < |o|^2 <= 6 (h = 1.3 dx, cutoff 2.6 dx, every caller of the
port), the wrappers take only that table (`KERNEL_OFFSETS`) and raise
ValueError on any other, on every device; the plain versions take any
table.

Inputs are flat (N, ...) per-site fields in C order of the lattice `shape`
(nx, ny, nz), with `valid` (N,) bool.  `taps` is a LatticeSolid's tap
table, ((ox, oy, oz), r0, e0, W0, dW0) per offset, and `vol0` = dx^3.
Invalid sites may hold NaN: both versions select zeros for them (JAX's
`_sanitize`), and a j outside the box or invalid adds nothing.  Every
site's sum is computed, invalid ones too, as JAX does.

  lattice_force(pos, S, jm2d, valid, shape, taps, vol0, cfg) -> (N, 3)
      f_a,i = sum_o dW0 V0 w_j [ (cfg/r0)(J_i + J_j)(x_a,i - x_a,j)
                                 + sum_b e_b (S_ab,i + S_ab,j) ],  e = -e0
      (before the caller's Mass / rho0 * valid scaling)
  lattice_dfdt(vel, valid, shape, taps, vol0) -> (N, 3, 3)
      dFdt_ab,i = -sum_o dW0 V0 e_b w_j (v_a,i - v_a,j)   (before @ B)
"""

from __future__ import annotations

import functools
import itertools

import numpy as np
import torch
import torch.nn.functional as F

from sphinxsys_tpu_torch.ops.block_sweeps import (
    _check, _ptr, _raise_on, _use_kernel,
)

LAUNCHES = {"lattice_force": 0, "lattice_dfdt": 0}
# the taps the kernels are compiled for (csrc/lattice_sweeps.cu kM, kR2):
# the offsets 0 < |o|^2 <= 6 of the 5^3 box in lattice_offsets' order
KERNEL_OFFSETS = tuple(o for o in itertools.product(range(-2, 3), repeat=3)
                       if 0 < sum(c * c for c in o) <= 6)


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# tap tables: constants formed in double, as JAX's trace-time Python floats
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=16)
def _force_table(taps, vol0: float, cfg: float):
    """(offsets (T, 3) int32, rows [cfg/r0, dW0 V0, -e0] as Python floats,
    the same rows as a (T, 5) float32 array for the kernel)."""
    rows = [(cfg / r0, dW0 * vol0, *(-float(c) for c in e0))
            for o, r0, e0, W0, dW0 in taps]
    return _offsets(taps), rows, np.asarray(rows, np.float32).reshape(-1, 5)


@functools.lru_cache(maxsize=16)
def _dfdt_table(taps, vol0: float):
    """(offsets, rows [dW0 V0 e_b for b] (e = -e0), the float32 copy)."""
    rows = [tuple(dW0 * vol0 * -float(c) for c in e0)
            for o, r0, e0, W0, dW0 in taps]
    return _offsets(taps), rows, np.asarray(rows, np.float32).reshape(-1, 3)


def _offsets(taps):
    off = np.asarray([o for o, *_ in taps], np.int32).reshape(-1, 3)
    if off.shape[1] != 3:
        raise ValueError("the lattice sweeps are 3D")
    return np.ascontiguousarray(off)


# ---------------------------------------------------------------------------
# plain PyTorch versions (JAX's pad-once tap loops, term for term)
# ---------------------------------------------------------------------------

def _halo(off) -> int:
    return int(np.abs(off).max()) if off.size else 0


def _pad(plane, m):
    return F.pad(plane, (m, m) * plane.dim())


def _tap(padded, o, m, shape):
    return padded[tuple(slice(m + k, m + k + n) for k, n in zip(o, shape))]


def _sanitize(v, a):
    """a (lattice dims + channels) with invalid sites selected to 0."""
    return torch.where(v.reshape(v.shape + (1,) * (a.dim() - v.dim())), a, 0.0)


def lattice_force_plain(pos, S, jm2d, valid, shape, taps, vol0: float,
                        cfg: float):
    off, rows, _ = _force_table(tuple(taps), vol0, cfg)
    shape = tuple(shape)
    m, dim = _halo(off), 3
    v = valid.reshape(shape)
    vmask = v.to(pos.dtype)
    pos = _sanitize(v, pos.reshape(shape + (dim,)))
    S = _sanitize(v, S.reshape(shape + (dim, dim)))
    J = _sanitize(v, jm2d.reshape(shape))
    posC = [pos[..., k] for k in range(dim)]
    posP = [_pad(c, m) for c in posC]
    SP = [[_pad(S[..., a, b], m) for b in range(dim)] for a in range(dim)]
    JP, mP = _pad(J, m), _pad(vmask, m)

    force = [pos.new_zeros(shape) for _ in range(dim)]
    for o, (sh, dwv, *e) in zip(off.tolist(), rows):
        wj = _tap(mP, o, m, shape)
        shj = sh * (J + _tap(JP, o, m, shape))
        for a in range(dim):
            acc = shj * (posC[a] - _tap(posP[a], o, m, shape))
            for b in range(dim):
                if e[b] == 0.0:
                    continue
                acc = acc + e[b] * (S[..., a, b] + _tap(SP[a][b], o, m, shape))
            force[a] = force[a] + dwv * wj * acc
    return torch.stack([f.reshape(-1) for f in force], dim=-1)


def lattice_dfdt_plain(vel, valid, shape, taps, vol0: float):
    off, rows, _ = _dfdt_table(tuple(taps), vol0)
    shape = tuple(shape)
    m, dim = _halo(off), 3
    v = valid.reshape(shape)
    vel = _sanitize(v, vel.reshape(shape + (dim,)))
    velC = [vel[..., k] for k in range(dim)]
    velP = [_pad(c, m) for c in velC]
    mP = _pad(v.to(vel.dtype), m)

    dfdt = [[vel.new_zeros(shape) for _ in range(dim)] for _ in range(dim)]
    for o, g in zip(off.tolist(), rows):
        wj = _tap(mP, o, m, shape)
        for b in range(dim):
            if g[b] == 0.0:
                continue
            for a in range(dim):
                dv = (velC[a] - _tap(velP[a], o, m, shape)) * wj
                dfdt[a][b] = dfdt[a][b] - g[b] * dv
    return torch.stack([torch.stack([dfdt[a][b].reshape(-1) for b in range(dim)],
                                    dim=-1) for a in range(dim)], dim=-2)


# ---------------------------------------------------------------------------
# dispatching wrappers
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=16)
def _check_taps(taps) -> None:
    """Raise ValueError unless `taps` is the table the kernels are compiled
    for (KERNEL_OFFSETS, in that order)."""
    got = tuple(tuple(int(c) for c in o) for o, *_ in taps)
    if got != KERNEL_OFFSETS:
        raise ValueError(
            f"a table of {len(got)} taps: the lattice kernels take only the "
            f"{len(KERNEL_OFFSETS)} offsets 0 < |o|^2 <= 6 (h = 1.3 dx) in "
            "lattice_offsets' order")


def _check_sites(pos, valid, shape):
    n = int(np.prod(shape))
    if len(shape) != 3:
        raise ValueError(f"lattice shape {tuple(shape)}: the sweeps are 3D")
    _check("valid", valid, torch.bool, (n,), pos.device)
    return n


def lattice_force(pos, S, jm2d, valid, shape, taps, vol0: float, cfg: float):
    """L1.  Returns (N, 3)."""
    kernel = _use_kernel(pos)
    taps = tuple(taps)      # hashable for the cached checks and tables
    _check_taps(taps)
    if not kernel:
        return lattice_force_plain(pos, S, jm2d, valid, shape, taps, vol0, cfg)
    from sphinxsys_tpu_torch.ops._build import library

    n = _check_sites(pos, valid, shape)
    dev, f32 = pos.device, torch.float32
    _check("pos", pos, f32, (n, 3), dev)
    _check("S", S, f32, (n, 3, 3), dev)
    _check("jm2d", jm2d, f32, (n,), dev)
    off, _, coef = _force_table(taps, float(vol0), float(cfg))
    out = torch.empty((n, 3), dtype=f32, device=dev)
    err = library().lattice_force_launch(
        _ptr(pos), _ptr(S), _ptr(jm2d), _ptr(valid), *shape,
        off.ctypes.data, coef.ctypes.data, len(off), _ptr(out),
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "lattice_force")
    LAUNCHES["lattice_force"] += 1
    return out


def lattice_dfdt(vel, valid, shape, taps, vol0: float):
    """L2.  Returns (N, 3, 3)."""
    kernel = _use_kernel(vel)
    taps = tuple(taps)      # hashable for the cached checks and tables
    _check_taps(taps)
    if not kernel:
        return lattice_dfdt_plain(vel, valid, shape, taps, vol0)
    from sphinxsys_tpu_torch.ops._build import library

    n = _check_sites(vel, valid, shape)
    dev, f32 = vel.device, torch.float32
    _check("vel", vel, f32, (n, 3), dev)
    off, _, coef = _dfdt_table(taps, float(vol0))
    out = torch.empty((n, 3, 3), dtype=f32, device=dev)
    err = library().lattice_dfdt_launch(
        _ptr(vel), _ptr(valid), *shape, off.ctypes.data, coef.ctypes.data,
        len(off), _ptr(out), torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "lattice_dfdt")
    LAUNCHES["lattice_dfdt"] += 1
    return out


def occupancy(name: str) -> dict:
    """The kernel's design on this card: blocks an SM
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor), threads a block and
    shared memory a block (bytes)."""
    import ctypes

    from sphinxsys_tpu_torch.ops._build import library

    res = (ctypes.c_int * 3)()
    err = library().lattice_occupancy(0 if name == "lattice_force" else 1, res)
    _raise_on(err, f"{name} occupancy")
    return {"blocks_per_sm": res[0], "threads": res[1], "smem_bytes": res[2]}
