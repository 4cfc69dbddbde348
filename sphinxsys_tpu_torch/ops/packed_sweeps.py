"""The first-generation packed acoustic sweeps (2D, Wendland C2, cap 16):
the inner and wall pair sums of both acoustic halves on one packed
(rows, 16, 8) block tensor per body (counterpart of
sphinxsys_tpu/ops/pallas_sweep.py, whose names and return shapes it keeps).

Each sweep has a hand-written CUDA kernel (csrc/packed_sweeps.cu, built by
ops/_build.py) and, beside it, a plain PyTorch version (`*_plain`) that
computes the same per-slot sums.  Dispatch: a CPU tensor runs the plain
version; a CUDA float32 tensor launches the kernel (or raises); anything
else raises.  `LAUNCHES` counts kernel launches per sweep (plain runs do
not count).

  ac1_inner_sweep <- sphinxsys_tpu/ops/pallas_sweep.py:_ac1_kernel
  ac2_inner_sweep <- sphinxsys_tpu/ops/pallas_sweep.py:_ac2_kernel
  ac1_wall_sweep  <- sphinxsys_tpu/ops/pallas_sweep.py:_ac1_wall_kernel
  ac2_wall_sweep  <- sphinxsys_tpu/ops/pallas_sweep.py:_ac2_wall_kernel

What bounds them on the card: counting each byte once and only the real
pairs' flops, a sweep's least time is its bytes over the HBM rate
(chip_smoke.py's bound).  The kernels run far above it: the dense sweep
evaluates 16 x 16 x 9 slot pairs per cell, about 10x the real pairs, ~40
flops each, on neighbour rows that stay in L1/L2 — they are compute- and
latency-bound.  The design reads neighbour rows through the window map
(the TPU's pre-gathered packed[nbr] is never made), one thread per
(cell, i-slot), and skips sentinel windows; shared-memory staging and a
per-particle cell walk are later work.

Padding slots are guarded by the mask channel alone (they may carry any
finite volume); the inner sweeps drop the self pair.  The TPU's `tile_c`
and `interpret` have no counterpart, and the block count need not be a
multiple of any tile.
"""

from __future__ import annotations

import torch

from sphinxsys_tpu_torch.ops.block_sweeps import (
    _check, _ptr, _raise_on, _use_kernel,
)

CAP = 16
CH = 8
NW = 9              # 3^2 windows
CENTRE = 4          # the (0, 0) window
# inner channels
CX, CY, CVX, CVY, CP, CVOL, CMASK = 0, 1, 2, 3, 4, 5, 6
# i-side channels for the ac1 wall sweep: [x, y, p, rho, accx, accy, mask, 0]
I1X, I1Y, I1P, I1RHO, I1AX, I1AY, I1M = 0, 1, 2, 3, 4, 5, 6
# wall channels for ac1: [x, y, vol, accx, accy, mask, 0, 0]
W1X, W1Y, W1VOL, W1AX, W1AY, W1M = 0, 1, 2, 3, 4, 5
# i-side channels for the ac2 wall sweep: [x, y, vx, vy, mask, 0, 0, 0]
I2X, I2Y, I2VX, I2VY, I2M = 0, 1, 2, 3, 4
# wall channels for ac2: [x, y, vol, vax, vay, nx, ny, mask]
W2X, W2Y, W2VOL, W2VAX, W2VAY, W2NX, W2NY, W2M = 0, 1, 2, 3, 4, 5, 6, 7

LAUNCHES = {"ac1_inner": 0, "ac2_inner": 0, "ac1_wall": 0, "ac2_wall": 0}

# cells per chunk of the plain versions: bounds their (cells, 16, 16)
# temporaries
_PLAIN_CELL_CHUNK = 8192


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def pack_state_2d(pos, vel, p, vol, mask):
    """Pack block fields into the (C+1, 16, 8) inner layout
    [x, y, vx, vy, p, vol, mask, 0]."""
    z = torch.zeros_like(p)
    return torch.stack([pos[..., 0], pos[..., 1], vel[..., 0], vel[..., 1],
                        p, vol, mask.to(p.dtype), z], dim=-1)


def _constants(kernel_h, factor_w):
    """(inv_h, S): 1/h and the dW/dr scale factor_w/h * 0.625, in double
    as the TPU kernels' static floats are formed."""
    inv_h = 1.0 / kernel_h
    return inv_h, factor_w * inv_h * 0.625


# ---------------------------------------------------------------------------
# plain PyTorch versions (exactly the kernels' sums)
# ---------------------------------------------------------------------------

def _wendland_dw(q, dw_scale):
    """Wendland C2 dW/dr at q = r/h, q clamped at 2, as the TPU kernels
    form it."""
    qc = torch.clamp(q, max=2.0)
    t = qc - 2.0
    return torch.where(q < 2.0, dw_scale * (t * t * t) * qc,
                       torch.zeros_like(q))


def _geom(xi, xj, ix, iy, im, jx, jy, jm, inv_h, dw_scale, drop_self):
    """Pair geometry of (n, 16, 8) i and j slot blocks: (r, ex, ey, dW)
    on (n, 16, 16), dW/dr masked by mask_i mask_j (and the self pair)."""
    dx = xi[:, :, None, ix] - xj[:, None, :, jx]
    dy = xi[:, :, None, iy] - xj[:, None, :, jy]
    r = torch.sqrt(dx * dx + dy * dy + 1e-15)
    inv_r = 1.0 / r
    m = xi[:, :, None, im] * xj[:, None, :, jm]
    if drop_self:
        m = m * (1.0 - torch.eye(CAP, dtype=m.dtype, device=m.device))
    dw = _wendland_dw(r * inv_h, dw_scale) * m
    return r, dx * inv_r, dy * inv_r, dw


def _sweep_plain(xi_all, xj_all, nbr, pair_fn, drop_self):
    """Run `pair_fn(xi, xj, drop_self_here, sums)` over chunks of cells and
    their live windows (the self pair dropped in the centre window when
    `drop_self`); returns the (C, 16, 3) sums."""
    c = nbr.shape[0]
    sentinel = xj_all.shape[0] - 1
    out = xi_all.new_zeros((c, CAP, 3))
    for c0 in range(0, c, _PLAIN_CELL_CHUNK):
        c1 = min(c0 + _PLAIN_CELL_CHUNK, c)
        xi = xi_all[c0:c1]
        sums = [xi.new_zeros((c1 - c0, CAP)) for _ in range(3)]
        for w in range(NW):
            rows = nbr[c0:c1, w].long()
            if not bool(torch.any(rows < sentinel)):
                continue
            pair_fn(xi, xj_all[rows], drop_self and w == CENTRE, sums)
        out[c0:c1] = torch.stack(sums, dim=-1)
    return out


def _ac1_inner_raw(packed, nbr, inv_h, dw_scale, inv_rho0c0):
    def pair(xi, xj, drop_self, s):
        _, ex, ey, dw = _geom(xi, xj, CX, CY, CMASK, CX, CY, CMASK, inv_h,
                              dw_scale, drop_self)
        dwv = dw * xj[:, None, :, CVOL]
        p_i, p_j = xi[:, :, None, CP], xj[:, None, :, CP]
        psum = (p_i + p_j) * dwv
        s[0] -= torch.sum(psum * ex, dim=2)
        s[1] -= torch.sum(psum * ey, dim=2)
        s[2] += torch.sum((p_i - p_j) * inv_rho0c0 * dwv, dim=2)

    return _sweep_plain(packed[:nbr.shape[0]], packed, nbr, pair, True)


def _ac2_pair(u, dwv, lim_scale, rho0c0_geo):
    lim = torch.clamp(lim_scale * torch.clamp(u, min=0.0), max=1.0)
    return rho0c0_geo * u * lim * dwv


def _ac2_inner_raw(packed, nbr, inv_h, dw_scale, rho0c0_geo, lim_scale):
    def pair(xi, xj, drop_self, s):
        _, ex, ey, dw = _geom(xi, xj, CX, CY, CMASK, CX, CY, CMASK, inv_h,
                              dw_scale, drop_self)
        dwv = dw * xj[:, None, :, CVOL]
        du = xi[:, :, None, CVX] - xj[:, None, :, CVX]
        dv = xi[:, :, None, CVY] - xj[:, None, :, CVY]
        u = du * ex + dv * ey
        s[0] += torch.sum(u * dwv, dim=2)
        pj = _ac2_pair(u, dwv, lim_scale, rho0c0_geo)
        s[1] += torch.sum(pj * ex, dim=2)
        s[2] += torch.sum(pj * ey, dim=2)

    return _sweep_plain(packed[:nbr.shape[0]], packed, nbr, pair, True)


def _ac1_wall_raw(packed_i, wall, nbr_wall, inv_h, dw_scale, inv_rho0c0):
    def pair(xi, xk, _, s):
        r, ex, ey, dw = _geom(xi, xk, I1X, I1Y, I1M, W1X, W1Y, W1M, inv_h,
                              dw_scale, False)
        dwv = dw * xk[:, None, :, W1VOL]
        p_i = xi[:, :, None, I1P]
        face_acc = (xi[:, :, None, I1AX] - xk[:, None, :, W1AX]) * (-ex) \
            + (xi[:, :, None, I1AY] - xk[:, None, :, W1AY]) * (-ey)
        p_w = p_i + xi[:, :, None, I1RHO] * r * torch.clamp(face_acc, min=0.0)
        psum = (p_i + p_w) * dwv
        s[0] -= torch.sum(psum * ex, dim=2)
        s[1] -= torch.sum(psum * ey, dim=2)
        s[2] += torch.sum((p_i - p_w) * inv_rho0c0 * dwv, dim=2)

    return _sweep_plain(packed_i[:nbr_wall.shape[0]], wall, nbr_wall, pair,
                        False)


def _ac2_wall_raw(packed_i, wall, nbr_wall, inv_h, dw_scale, rho0c0_geo,
                  lim_scale):
    def pair(xi, xk, _, s):
        _, ex, ey, dw = _geom(xi, xk, I2X, I2Y, I2M, W2X, W2Y, W2M, inv_h,
                              dw_scale, False)
        dwv = dw * xk[:, None, :, W2VOL]
        nx, ny = xk[:, None, :, W2NX], xk[:, None, :, W2NY]
        sgn = torch.sign(ex * nx + ey * ny)
        fnx, fny = sgn * nx, sgn * ny
        dvx = 2.0 * (xi[:, :, None, I2VX] - xk[:, None, :, W2VAX])
        dvy = 2.0 * (xi[:, :, None, I2VY] - xk[:, None, :, W2VAY])
        s[0] += torch.sum((dvx * ex + dvy * ey) * dwv, dim=2)
        pj = _ac2_pair(dvx * fnx + dvy * fny, dwv, lim_scale, rho0c0_geo)
        s[1] += torch.sum(pj * fnx, dim=2)
        s[2] += torch.sum(pj * fny, dim=2)

    return _sweep_plain(packed_i[:nbr_wall.shape[0]], wall, nbr_wall, pair,
                        False)


def ac1_inner_sweep_plain(packed, nbr, kernel_h: float, factor_w: float,
                          inv_rho0c0_ave: float):
    out = _ac1_inner_raw(packed, nbr, *_constants(kernel_h, factor_w),
                         inv_rho0c0_ave)
    return out[..., :2], out[..., 2]


def ac2_inner_sweep_plain(packed, nbr, kernel_h: float, factor_w: float,
                          rho0c0_geo: float, inv_c0: float,
                          limiter_coeff: float):
    out = _ac2_inner_raw(packed, nbr, *_constants(kernel_h, factor_w),
                         rho0c0_geo, limiter_coeff * inv_c0)
    return out[..., 0], out[..., 1:]


def ac1_wall_sweep_plain(packed_i, wall_packed, nbr_wall, kernel_h: float,
                         factor_w: float, inv_rho0c0_ave: float):
    out = _ac1_wall_raw(packed_i, wall_packed, nbr_wall,
                        *_constants(kernel_h, factor_w), inv_rho0c0_ave)
    return out[..., :2], out[..., 2]


def ac2_wall_sweep_plain(packed_i, wall_packed, nbr_wall, kernel_h: float,
                         factor_w: float, rho0c0_geo: float, inv_c0: float,
                         limiter_coeff: float):
    out = _ac2_wall_raw(packed_i, wall_packed, nbr_wall,
                        *_constants(kernel_h, factor_w), rho0c0_geo,
                        limiter_coeff * inv_c0)
    return out[..., 0], out[..., 1:]


# ---------------------------------------------------------------------------
# wrappers: plain version on CPU, kernel on CUDA
# ---------------------------------------------------------------------------

def _check_packed(name, t, n_rows, dev):
    _check(name, t, torch.float32, (n_rows, CAP, CH), dev)
    if t.data_ptr() % 16:
        raise ValueError(f"{name} is not 16-byte aligned (the kernel reads "
                         "each slot as two float4)")


def _launch(name, c, dev, *args):
    """Allocate the (C, 16, 3) output, launch `name`'s kernel with `args`
    (pointers, ints and the float constants), count."""
    from sphinxsys_tpu_torch.ops._build import library

    out = torch.empty((c, CAP, 3), dtype=torch.float32, device=dev)
    err = getattr(library(), f"{name}_launch")(
        *args, _ptr(out), torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, name)
    LAUNCHES[name] += 1
    return out


def _inner(name, packed, nbr, consts):
    c, dev = nbr.shape[0], packed.device
    _check_packed("packed", packed, c + 1, dev)
    _check("nbr", nbr, torch.int32, (c, NW), dev)
    return _launch(name, c, dev, _ptr(packed), _ptr(nbr), c,
                   *map(float, consts))


def _wall(name, packed_i, wall_packed, nbr_wall, consts):
    c, dev = nbr_wall.shape[0], packed_i.device
    packed_i = packed_i[:c]
    _check_packed("packed_i", packed_i, c, dev)
    cw = wall_packed.shape[0] - 1
    _check_packed("wall_packed", wall_packed, cw + 1, dev)
    _check("nbr_wall", nbr_wall, torch.int32, (c, NW), dev)
    return _launch(name, c, dev, _ptr(packed_i), _ptr(wall_packed),
                   _ptr(nbr_wall), c, cw, *map(float, consts))


def ac1_inner_sweep(packed, nbr, kernel_h: float, factor_w: float,
                    inv_rho0c0_ave: float):
    """B5a, 1st-half inner sweep.  packed: (C+1, 16, 8) with the inner
    channels; nbr: (C, 9).  Returns (force (C, 16, 2), rho_diss (C, 16))."""
    if not _use_kernel(packed):
        return ac1_inner_sweep_plain(packed, nbr, kernel_h, factor_w,
                                     inv_rho0c0_ave)
    out = _inner("ac1_inner", packed, nbr,
                 (*_constants(kernel_h, factor_w), inv_rho0c0_ave))
    return out[..., :2], out[..., 2]


def ac2_inner_sweep(packed, nbr, kernel_h: float, factor_w: float,
                    rho0c0_geo: float, inv_c0: float, limiter_coeff: float):
    """B5b, 2nd-half inner sweep.  Returns (dcr (C, 16), p_diss (C, 16, 2))."""
    if not _use_kernel(packed):
        return ac2_inner_sweep_plain(packed, nbr, kernel_h, factor_w,
                                     rho0c0_geo, inv_c0, limiter_coeff)
    out = _inner("ac2_inner", packed, nbr,
                 (*_constants(kernel_h, factor_w), rho0c0_geo,
                  limiter_coeff * inv_c0))
    return out[..., 0], out[..., 1:]


def ac1_wall_sweep(packed_i, wall_packed, nbr_wall, kernel_h: float,
                   factor_w: float, inv_rho0c0_ave: float):
    """B5c, 1st-half wall sweep.  packed_i: (C or C+1, 16, 8)
    [x, y, p, rho, ax, ay, mask, 0]; wall_packed: (Cw+1, 16, 8)
    [x, y, vol, ax, ay, mask, 0, 0]; nbr_wall: (C, 9), sentinel Cw.
    Returns (force (C, 16, 2), rho_diss (C, 16)) of the wall terms."""
    if not _use_kernel(packed_i):
        return ac1_wall_sweep_plain(packed_i, wall_packed, nbr_wall, kernel_h,
                                    factor_w, inv_rho0c0_ave)
    out = _wall("ac1_wall", packed_i, wall_packed, nbr_wall,
                (*_constants(kernel_h, factor_w), inv_rho0c0_ave))
    return out[..., :2], out[..., 2]


def ac2_wall_sweep(packed_i, wall_packed, nbr_wall, kernel_h: float,
                   factor_w: float, rho0c0_geo: float, inv_c0: float,
                   limiter_coeff: float):
    """B5d, 2nd-half wall sweep.  packed_i: (C or C+1, 16, 8)
    [x, y, vx, vy, mask, 0, 0, 0]; wall_packed: (Cw+1, 16, 8)
    [x, y, vol, vax, vay, nx, ny, mask].  Returns (dcr (C, 16),
    p_diss (C, 16, 2)) of the wall terms."""
    if not _use_kernel(packed_i):
        return ac2_wall_sweep_plain(packed_i, wall_packed, nbr_wall, kernel_h,
                                    factor_w, rho0c0_geo, inv_c0,
                                    limiter_coeff)
    out = _wall("ac2_wall", packed_i, wall_packed, nbr_wall,
                (*_constants(kernel_h, factor_w), rho0c0_geo,
                 limiter_coeff * inv_c0))
    return out[..., 0], out[..., 1:]
