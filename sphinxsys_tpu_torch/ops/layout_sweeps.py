"""Two alternative parallel layouts of B5a's function, the 2D inner
first-half acoustic sweep (cap 16, a mask channel, the self pair dropped):
counterparts of the JAX package's Pallas layout experiments, whose names,
arguments and return shapes they keep.

  ac1_flat_sweep <- benchmarks/exp_layout.py:_ac1_flat_kernel (ac1_flat_pallas)
  ac1_t_sweep    <- benchmarks/exp_layout2.py:_ac1_t_kernel   (ac1_t_pallas)

Each has a hand-written CUDA kernel (csrc/layout_sweeps.cu, built by
ops/_build.py) and, beside it, a plain PyTorch version (`*_plain`, the
counterparts of `ac1_flat_jnp` and `ac1_transposed_jnp`) that computes the
same sums with the same arithmetic (but for B6's r and 1/r, which its
kernel forms by rsqrt and its plain version, as JAX, by sqrt and a
division).  Dispatch as in ops/packed_sweeps.py: a
CPU tensor runs the plain version; a CUDA float32 tensor launches the
kernel (or raises); anything else raises.  `LAUNCHES` counts kernel
launches (plain runs do not count).

* `ac1_flat_sweep(packed (C+1, 16, 8), nbr (C, 9), ...)`: one 32-lane warp
  per cell; its live window rows are staged in shared memory and their
  real slots compacted, and the real (i, j) slot pairs are flattened onto
  the lanes, each lane keeping one real i-slot; the sums over j are folded
  per i in a fixed order (no atomics).  Neighbour rows are read through
  `nbr`, so JAX's pre-gathered packed[nbr] is never made.
* `ac1_t_sweep(xi_t (8, 16, C), xj_t (9, 8, 16, C), ...)`: the pre-gathered,
  channel-major input that `prep_t` builds, the cell on the fastest axis
  (every read coalesced, none indirect), one thread per (i-slot, cell) in
  tiles of 32 cells that vote on their masks and stage and sum only the
  slot rows holding a real slot; returns (16, C) sums, the transpose of
  the others'.  `prep_t` is plain torch (a gather and a permuting copy,
  each writing 295 MB at the 2D dambreak's bench width).

Both kernels are bound by bytes on the card (PERF.md, section 6); what
held their first designs above that bound was evaluating every slot pair,
padding included.  Both now skip slots of mask 0, which add exactly
nothing.  The CUDA source sets the designs out.  The TPU's `tile_c` has
no counterpart: the cell count need not be a multiple of any tile.
"""

from __future__ import annotations

import torch

from sphinxsys_tpu_torch.ops.block_sweeps import (
    _check, _ptr, _raise_on, _use_kernel,
)
from sphinxsys_tpu_torch.ops.packed_sweeps import (
    CAP, CENTRE, CH, CMASK, CP, CVOL, CX, CY, NW, _check_packed, _wendland_dw,
)

LAUNCHES = {"ac1_flat": 0, "ac1_t": 0}

# cells per chunk of the plain versions: bounds their (cells, 256)
# temporaries
_PLAIN_CELL_CHUNK = 8192


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _dw_scale(inv_h, factor_w):
    """The dW/dr scale factor_w/h * 0.625, in double as the TPU kernels'
    static floats are formed."""
    return factor_w * inv_h * 0.625


# ---------------------------------------------------------------------------
# plain PyTorch versions (exactly the kernels' sums)
# ---------------------------------------------------------------------------

def _expand_i(a):   # (n, 16) -> (n, 256), entry l = a[l // 16]
    return torch.repeat_interleave(a, CAP, dim=-1)


def _expand_j(a):   # (n, 16) -> (n, 256), entry l = a[l % 16]
    return a.repeat(1, CAP)


def ac1_flat_sweep_plain(packed, nbr, inv_h: float, factor_w: float,
                         inv_rho0c0: float):
    """The (C, 256) flattened-pair sums of `ac1_flat_jnp`, chunked over
    cells.  Returns (fx, fy, rd), each (C, 16)."""
    c = nbr.shape[0]
    dw_scale = _dw_scale(inv_h, factor_w)
    lane = torch.arange(CAP * CAP, device=packed.device)
    not_self = (lane // CAP != lane % CAP).to(packed.dtype)
    out = packed.new_zeros((3, c, CAP))
    for c0 in range(0, c, _PLAIN_CELL_CHUNK):
        c1 = min(c0 + _PLAIN_CELL_CHUNK, c)
        xi = packed[c0:c1]
        x_i, y_i = _expand_i(xi[:, :, CX]), _expand_i(xi[:, :, CY])
        p_i, m_i = _expand_i(xi[:, :, CP]), _expand_i(xi[:, :, CMASK])
        fx, fy, rd = (torch.zeros_like(x_i) for _ in range(3))
        for w in range(NW):
            xj = packed[nbr[c0:c1, w].long()]
            dx = x_i - _expand_j(xj[:, :, CX])
            dy = y_i - _expand_j(xj[:, :, CY])
            r = torch.sqrt(dx * dx + dy * dy + 1e-15)
            inv_r = 1.0 / r
            m = m_i * _expand_j(xj[:, :, CMASK])
            if w == CENTRE:
                m = m * not_self
            dwv = _wendland_dw(r * inv_h, dw_scale) * m \
                * _expand_j(xj[:, :, CVOL])
            p_j = _expand_j(xj[:, :, CP])
            psum = (p_i + p_j) * dwv * inv_r
            fx = fx - psum * dx
            fy = fy - psum * dy
            rd = rd + (p_i - p_j) * inv_rho0c0 * dwv
        for k, a in enumerate((fx, fy, rd)):
            out[k, c0:c1] = a.reshape(c1 - c0, CAP, CAP).sum(dim=2)
    return out[0], out[1], out[2]


def ac1_t_sweep_plain(xi_t, xj_t, inv_h: float, factor_w: float,
                      inv_rho0c0: float):
    """The (16_i, 16_j, C) transposed sums of `ac1_transposed_jnp` (rsqrt
    as jax.lax.rsqrt), chunked over cells.  Returns (fx, fy, rd), each
    (16, C)."""
    c = xi_t.shape[-1]
    dw_scale = _dw_scale(inv_h, factor_w)
    not_self = 1.0 - torch.eye(CAP, dtype=xi_t.dtype,
                               device=xi_t.device)[:, :, None]
    out = xi_t.new_zeros((3, CAP, c))
    for c0 in range(0, c, _PLAIN_CELL_CHUNK):
        c1 = min(c0 + _PLAIN_CELL_CHUNK, c)
        xi = xi_t[..., c0:c1]
        x_i, y_i = xi[CX][:, None, :], xi[CY][:, None, :]   # (16i, 1, n)
        p_i, m_i = xi[CP][:, None, :], xi[CMASK][:, None, :]
        fx, fy, rd = (xi.new_zeros((CAP, c1 - c0)) for _ in range(3))
        for w in range(NW):
            xj = xj_t[w, ..., c0:c1]
            dx = x_i - xj[CX][None, :, :]                     # (16i, 16j, n)
            dy = y_i - xj[CY][None, :, :]
            r2 = dx * dx + dy * dy + 1e-15
            inv_r = torch.rsqrt(r2)
            r = r2 * inv_r
            m = m_i * xj[CMASK][None, :, :]
            if w == CENTRE:
                m = m * not_self
            dwv = _wendland_dw(r * inv_h, dw_scale) * m * xj[CVOL][None, :, :]
            p_j = xj[CP][None, :, :]
            psum = (p_i + p_j) * dwv * inv_r
            fx = fx - torch.sum(psum * dx, dim=1)
            fy = fy - torch.sum(psum * dy, dim=1)
            rd = rd + torch.sum((p_i - p_j) * inv_rho0c0 * dwv, dim=1)
        out[:, :, c0:c1] = torch.stack([fx, fy, rd])
    return out[0], out[1], out[2]


def prep_t(packed, nbr):
    """B7's input from the packed state (exp_layout2.py's `prep`):
    xi_t = packed[:C] as (8, 16, C), xj_t = packed[nbr] as (9, 8, 16, C),
    both contiguous.  Plain torch: a gather and a permute."""
    c = nbr.shape[0]
    xi_t = packed[:c].permute(2, 1, 0).contiguous()
    xj_t = packed[nbr.long()].permute(1, 3, 2, 0).contiguous()
    return xi_t, xj_t


# ---------------------------------------------------------------------------
# wrappers: plain version on CPU, kernel on CUDA
# ---------------------------------------------------------------------------

def _launch(name, shape, dev, *args):
    """Allocate the (3, ...) output, launch `name`'s kernel with `args`
    (pointers, the cell count and the float constants), count."""
    from sphinxsys_tpu_torch.ops._build import library

    out = torch.empty((3,) + shape, dtype=torch.float32, device=dev)
    err = getattr(library(), f"{name}_launch")(
        *args, _ptr(out), torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, name)
    LAUNCHES[name] += 1
    return out[0], out[1], out[2]


def ac1_flat_sweep(packed, nbr, inv_h: float, factor_w: float,
                   inv_rho0c0: float):
    """B6.  packed: (C+1, 16, 8) [x, y, vx, vy, p, vol, mask, 0]; nbr:
    (C, 9), sentinel C.  Returns (fx, fy, rd), each (C, 16)."""
    if not _use_kernel(packed):
        return ac1_flat_sweep_plain(packed, nbr, inv_h, factor_w, inv_rho0c0)
    c, dev = nbr.shape[0], packed.device
    _check_packed("packed", packed, c + 1, dev)
    _check("nbr", nbr, torch.int32, (c, NW), dev)
    return _launch("ac1_flat", (c, CAP), dev, _ptr(packed), _ptr(nbr), c,
                   float(inv_h), _dw_scale(inv_h, factor_w), float(inv_rho0c0))


def ac1_t_sweep(xi_t, xj_t, inv_h: float, factor_w: float,
                inv_rho0c0: float):
    """B7.  xi_t: (8, 16, C); xj_t: (9, 8, 16, C) (`prep_t`).  Returns
    (fx, fy, rd), each (16, C)."""
    if not _use_kernel(xi_t):
        return ac1_t_sweep_plain(xi_t, xj_t, inv_h, factor_w, inv_rho0c0)
    c, dev = xi_t.shape[-1], xi_t.device
    _check("xi_t", xi_t, torch.float32, (CH, CAP, c), dev)
    _check("xj_t", xj_t, torch.float32, (NW, CH, CAP, c), dev)
    return _launch("ac1_t", (CAP, c), dev, _ptr(xi_t), _ptr(xj_t), c,
                   float(inv_h), _dw_scale(inv_h, factor_w), float(inv_rho0c0))
