"""The four cell-block pair sweeps of the WCSPH hot path.

Each sweep has a hand-written CUDA kernel (csrc/block_sweeps.cu, built by
ops/_build.py) and, beside it, a plain PyTorch version that computes the
same per-slot sums.  Dispatch: a CPU tensor runs the plain version; a CUDA
float32 tensor launches the kernel (or raises); anything else raises.
`LAUNCHES` counts kernel launches per sweep (plain runs do not count).

  density_sweep  <- sphinxsys_tpu/ops/pallas_block2.py:_dens_kernel
  ac1_sweep      <- sphinxsys_tpu/ops/pallas_block2.py:_ac1_kernel
  ac2_sweep      <- sphinxsys_tpu/ops/pallas_block2.py:_ac2_kernel
  visc_tvc_sweep <- sphinxsys_tpu/ops/pallas_block2.py:_visctvc_kernel

What bounds them on the card: counting each byte once and only the real
pairs' flops, every sweep's least time is its bytes over the HBM rate
(chip_smoke.py's bound; 3D B3's is its flops).  The kernels run far
above it because they issue work per slot pair, not per byte: each
neighbour row is read from L2 once per cell that has it in its windows,
and the lane x slot pairs outnumber the real pairs.

So all four are bound by slot-pair issue.  Their kernels put one lane group
on a cell (16 lanes for cap <= 16, else 32; lane l on i-slot l), skip
cells with no live window by a vote, stage each live window once for the
group in shared memory (runs of windows on consecutive block rows
together, the next run's cp.async copies in flight while one is summed),
compact the real j-slots to the front and sum only those, one to three
shared-memory loads per slot pair; when a cell's real i-slots fit in half
the group, the two halves split its real j-slots.  A real j-slot is one
with VOL > 0, or, in B1's fluid rows, mask > 0: every B2-B4 term carries
V_j and B1's carries mask_j (fluid) or V_k (wall), so skipping the others
changes no real slot's sum.  Padding i-slots (VOL 0; B1: mask 0) get
zeros, where the plain versions sum them like real slots.

Inputs are block arrays in their natural layout: fluid fields (C+1, cap, .),
wall fields (Cw+1, capw, .), window maps nbr (C, 3^dim) int32 with sentinel
C (fluid) / Cw (wall).  Padding slots are parked FAR_AWAY with volume 0 and
mask 0, so they add exactly zero.  Outputs are (C, cap, k) per-slot sums;
the callers in physics/fluid_blocks.py scale them.

`box` gives the periodic lengths (None, or 0 on an axis, for no wrap):
each pair displacement then takes the minimum image d - L rint(d / L),
rounding half to even as jnp.round does.  The wrap folds FAR-parked
padding back into range, so padding stays inert only through VOL = 0 and
B1's mask channel.
"""

from __future__ import annotations

import torch

from sphinxsys_tpu_torch.neighbors.cell_blocks import occupied_rows

LAUNCHES = {"density": 0, "ac1": 0, "ac2": 0, "visc_tvc": 0}

# cells per chunk of the plain versions: bounds their (cells, cap, cap, dim)
# temporaries (3D at 1M particles would need tens of GB unchunked)
_PLAIN_CELL_CHUNK = 8192


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# dispatch helpers
# ---------------------------------------------------------------------------

def _use_kernel(ref: torch.Tensor) -> bool:
    """False: plain version (CPU).  True: CUDA kernel.  Raises otherwise."""
    if ref.device.type == "cpu":
        return False
    if ref.device.type != "cuda":
        raise ValueError(f"block sweeps run on cpu or cuda tensors, got {ref.device}")
    return True


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, the kernel takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _box3(box, dim):
    """The kernels' (Lx, Ly, Lz) Python floats, 0 where an axis does not
    wrap (the launchers form 1/L in double, as JAX forms it)."""
    b = tuple(float(x) for x in box) if box is not None else (0.0,) * dim
    if len(b) != dim or any(x < 0.0 for x in b):
        raise ValueError(f"box {box} must give {dim} lengths >= 0")
    return b + (0.0,) * (3 - dim)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _raise_on(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def _wall_shapes(nbr, wall_pos, nbr_wall):
    c, nw = nbr.shape
    cw, capw = wall_pos.shape[0] - 1, wall_pos.shape[1]
    if tuple(nbr_wall.shape) != (c, nw):
        raise ValueError(f"nbr_wall shape {tuple(nbr_wall.shape)} != {(c, nw)}")
    return cw, capw


# ---------------------------------------------------------------------------
# plain PyTorch versions (exactly the kernels' sums)
# ---------------------------------------------------------------------------

def _wrap(disp, box):
    """The kernels' minimum image: d - L round(d * (1/L)) per periodic axis."""
    if box is None or not any(b > 0.0 for b in box):
        return disp
    cols = [disp[..., k] - L * torch.round(disp[..., k] * (1.0 / L))
            if L > 0.0 else disp[..., k] for k, L in enumerate(box)]
    return torch.stack(cols, dim=-1)


def _dwv(disp, vol_j, inv_h, dw_scale):
    """Clamped-q Wendland C2 dW/dr * V_j, plus (inv_r, r); r2 + 1e-15."""
    r2 = torch.sum(disp * disp, dim=-1) + 1e-15
    inv_r = torch.rsqrt(r2)
    r = r2 * inv_r
    qc = torch.clamp(r * inv_h, max=2.0)
    t = qc - 2.0
    return (dw_scale * (t * t * t) * qc) * vol_j, inv_r, r


def _w(disp, inv_h, factor_w):
    """Wendland C2 W from displacements (no epsilon; q clamped at 2)."""
    qc = torch.clamp(torch.sqrt(torch.sum(disp * disp, dim=-1)) * inv_h, max=2.0)
    t = 1.0 - 0.5 * qc
    return factor_w * (t * t * t * t) * (2.0 * qc + 1.0)


def _chunks(nbr):
    """Cell chunks over the occupied rows; later rows (padding only, all
    windows sentinel) keep their zero sums."""
    n = occupied_rows(nbr)
    for c0 in range(0, n, _PLAIN_CELL_CHUNK):
        yield c0, min(c0 + _PLAIN_CELL_CHUNK, n)


def _live(rows, sentinel):
    """Windows with at least one non-sentinel row in this chunk."""
    return bool(torch.any(rows < sentinel))


def density_sweep_plain(pos, mask, nbr, wall_pos, wall_vol, nbr_wall, *,
                        inv_h: float, factor_w: float, box=None):
    c, cap = nbr.shape[0], pos.shape[1]
    maskf = mask.to(pos.dtype)
    out = pos.new_zeros((c, cap, 2))
    for c0, c1 in _chunks(nbr):
        xi = pos[c0:c1, :, None, :]
        sig = pos.new_zeros((c1 - c0, cap))
        for w in range(nbr.shape[1]):
            rows = nbr[c0:c1, w].long()
            if not _live(rows, c):
                continue
            W = _w(_wrap(xi - pos[rows][:, None], box), inv_h, factor_w)
            sig = sig + torch.sum(W * maskf[rows][:, None, :], dim=-1)
        out[c0:c1, :, 0] = sig
        if nbr_wall is None:
            continue
        cw = wall_pos.shape[0] - 1
        sigw = pos.new_zeros((c1 - c0, cap))
        for w in range(nbr_wall.shape[1]):
            rows = nbr_wall[c0:c1, w].long()
            if not _live(rows, cw):
                continue
            W = _w(_wrap(xi - wall_pos[rows][:, None], box), inv_h, factor_w)
            sigw = sigw + torch.sum(W * wall_vol[rows][:, None, :], dim=-1)
        out[c0:c1, :, 1] = sigw
    return out


def ac1_sweep_plain(pos, p, rho, acc, vol, nbr, wall_pos, wall_vol, wall_acc,
                    nbr_wall, *, inv_h: float, dw_scale: float,
                    inv_rho0c0: float, box=None):
    c, cap, dim = nbr.shape[0], pos.shape[1], pos.shape[2]
    out = pos.new_zeros((c, cap, dim + 1))
    for c0, c1 in _chunks(nbr):
        xi = pos[c0:c1, :, None, :]
        p_i = p[c0:c1, :, None]
        f = pos.new_zeros((c1 - c0, cap, dim))
        rd = pos.new_zeros((c1 - c0, cap))
        for w in range(nbr.shape[1]):
            rows = nbr[c0:c1, w].long()
            if not _live(rows, c):
                continue
            d = _wrap(xi - pos[rows][:, None], box)
            dwv, inv_r, _ = _dwv(d, vol[rows][:, None, :], inv_h, dw_scale)
            p_j = p[rows][:, None, :]
            psum = (p_i + p_j) * dwv * inv_r
            f = f - torch.sum(psum[..., None] * d, dim=2)
            rd = rd + torch.sum((p_i - p_j) * dwv, dim=2)
        rd = rd * inv_rho0c0
        if nbr_wall is not None:
            cw = wall_pos.shape[0] - 1
            rho_i = rho[c0:c1, :, None]
            a_i = acc[c0:c1, :, None, :]
            fw = torch.zeros_like(f)
            rdw = torch.zeros_like(rd)
            for w in range(nbr_wall.shape[1]):
                rows = nbr_wall[c0:c1, w].long()
                if not _live(rows, cw):
                    continue
                d = _wrap(xi - wall_pos[rows][:, None], box)
                dwv, inv_r, r = _dwv(d, wall_vol[rows][:, None, :], inv_h,
                                     dw_scale)
                e = d * inv_r[..., None]
                da = a_i if wall_acc is None else a_i - wall_acc[rows][:, None]
                face_acc = torch.sum(da * (-e), dim=-1)
                p_w = p_i + rho_i * r * torch.clamp(face_acc, min=0.0)
                psum = (p_i + p_w) * dwv * inv_r
                fw = fw - torch.sum(psum[..., None] * d, dim=2)
                rdw = rdw + torch.sum((p_i - p_w) * dwv, dim=2)
            f = f + fw
            rd = rd + rdw * inv_rho0c0
        out[c0:c1, :, :dim] = f
        out[c0:c1, :, dim] = rd
    return out


def ac2_sweep_plain(pos, vel, vol, nbr, wall_pos, wall_vol, wall_vel, wall_n,
                    nbr_wall, *, inv_h: float, dw_scale: float,
                    rho0c0_geo: float, lim_scale: float, box=None):
    c, cap, dim = nbr.shape[0], pos.shape[1], pos.shape[2]
    out = pos.new_zeros((c, cap, dim + 1))
    for c0, c1 in _chunks(nbr):
        xi = pos[c0:c1, :, None, :]
        v_i = vel[c0:c1, :, None, :]
        dcr = pos.new_zeros((c1 - c0, cap))
        f = pos.new_zeros((c1 - c0, cap, dim))
        for w in range(nbr.shape[1]):
            rows = nbr[c0:c1, w].long()
            if not _live(rows, c):
                continue
            d = _wrap(xi - pos[rows][:, None], box)
            dwv, inv_r, _ = _dwv(d, vol[rows][:, None, :], inv_h, dw_scale)
            e = d * inv_r[..., None]
            u = torch.sum((v_i - vel[rows][:, None]) * e, dim=-1)
            dcr = dcr + torch.sum(u * dwv, dim=2)
            lim = torch.clamp(lim_scale * torch.clamp(u, min=0.0), max=1.0)
            pj = rho0c0_geo * u * lim * dwv
            f = f + torch.sum(pj[..., None] * e, dim=2)
        if nbr_wall is not None:
            cw = wall_pos.shape[0] - 1
            dcrw = torch.zeros_like(dcr)
            fw = torch.zeros_like(f)
            for w in range(nbr_wall.shape[1]):
                rows = nbr_wall[c0:c1, w].long()
                if not _live(rows, cw):
                    continue
                d = _wrap(xi - wall_pos[rows][:, None], box)
                dwv, inv_r, _ = _dwv(d, wall_vol[rows][:, None, :], inv_h,
                                     dw_scale)
                e = d * inv_r[..., None]
                n = wall_n[rows][:, None]
                fn = torch.sign(torch.sum(e * n, dim=-1))[..., None] * n
                dv = 2.0 * v_i if wall_vel is None \
                    else 2.0 * (v_i - wall_vel[rows][:, None])
                dcrw = dcrw + torch.sum(torch.sum(dv * e, dim=-1) * dwv, dim=2)
                u = torch.sum(dv * fn, dim=-1)
                lim = torch.clamp(lim_scale * torch.clamp(u, min=0.0), max=1.0)
                pj = rho0c0_geo * u * lim * dwv
                fw = fw + torch.sum(pj[..., None] * fn, dim=2)
            dcr = dcr + dcrw
            f = f + fw
        out[c0:c1, :, 0] = dcr
        out[c0:c1, :, 1:] = f
    return out


def visc_tvc_sweep_plain(pos, vel, vol, nbr, wall_pos, wall_vol, wall_vel,
                         nbr_wall, *, inv_h: float, dw_scale: float,
                         eps_r: float, box=None):
    c, cap, dim = nbr.shape[0], pos.shape[1], pos.shape[2]
    out = pos.new_zeros((c, cap, 2 * dim))
    for c0, c1 in _chunks(nbr):
        xi = pos[c0:c1, :, None, :]
        v_i = vel[c0:c1, :, None, :]
        fv = pos.new_zeros((c1 - c0, cap, dim))
        inc = pos.new_zeros((c1 - c0, cap, dim))
        for w in range(nbr.shape[1]):
            rows = nbr[c0:c1, w].long()
            if not _live(rows, c):
                continue
            d = _wrap(xi - pos[rows][:, None], box)
            dwv, inv_r, r = _dwv(d, vol[rows][:, None, :], inv_h, dw_scale)
            scale = dwv / (r + eps_r)
            fv = fv + torch.sum((v_i - vel[rows][:, None]) * scale[..., None],
                                dim=2)
            inc = inc - torch.sum((2.0 * dwv * inv_r)[..., None] * d, dim=2)
        if nbr_wall is not None:
            cw = wall_pos.shape[0] - 1
            fvw = torch.zeros_like(fv)
            incw = torch.zeros_like(inc)
            for w in range(nbr_wall.shape[1]):
                rows = nbr_wall[c0:c1, w].long()
                if not _live(rows, cw):
                    continue
                d = _wrap(xi - wall_pos[rows][:, None], box)
                dwv, inv_r, r = _dwv(d, wall_vol[rows][:, None, :], inv_h,
                                     dw_scale)
                scale = 2.0 * dwv / (r + eps_r)
                dv = v_i if wall_vel is None else v_i - wall_vel[rows][:, None]
                fvw = fvw + torch.sum(dv * scale[..., None], dim=2)
                incw = incw - torch.sum((2.0 * dwv * inv_r)[..., None] * d,
                                        dim=2)
            fv = fv + fvw
            inc = inc + incw
        out[c0:c1, :, :dim] = fv
        out[c0:c1, :, dim:] = inc
    return out


# ---------------------------------------------------------------------------
# wrappers: plain version on CPU, kernel on CUDA
# ---------------------------------------------------------------------------

def density_sweep(pos, mask, nbr, wall_pos=None, wall_vol=None, nbr_wall=None,
                  *, inv_h: float, factor_w: float, box=None):
    """B1.  Returns (C, cap, 2) = [sig, sigw]: the fluid sum of W * mask
    (self pair included, so W(0) is the seed) and the wall sum of W * V."""
    if not _use_kernel(pos):
        return density_sweep_plain(pos, mask, nbr, wall_pos, wall_vol, nbr_wall,
                                   inv_h=inv_h, factor_w=factor_w, box=box)
    from sphinxsys_tpu_torch.ops._build import library

    c, nw = nbr.shape
    cap, dim = pos.shape[1], pos.shape[2]
    dev, f32 = pos.device, torch.float32
    maskf = mask.to(f32).contiguous()
    _check("pos", pos, f32, (c + 1, cap, dim), dev)
    _check("mask", maskf, f32, (c + 1, cap), dev)
    _check("nbr", nbr, torch.int32, (c, nw), dev)
    cw = capw = 0
    if nbr_wall is not None:
        cw, capw = _wall_shapes(nbr, wall_pos, nbr_wall)
        _check("wall_pos", wall_pos, f32, (cw + 1, capw, dim), dev)
        _check("wall_vol", wall_vol, f32, (cw + 1, capw), dev)
        _check("nbr_wall", nbr_wall, torch.int32, (c, nw), dev)
    out = torch.empty((c, cap, 2), dtype=f32, device=dev)
    err = library().density_sweep_launch(
        dim, _ptr(pos), _ptr(maskf), _ptr(nbr), c, cap, _ptr(wall_pos),
        _ptr(wall_vol), _ptr(nbr_wall), cw, capw, float(inv_h),
        float(factor_w), *_box3(box, dim), _ptr(out),
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "density_sweep")
    LAUNCHES["density"] += 1
    return out


def ac1_sweep(pos, p, rho, acc, vol, nbr, wall_pos=None, wall_vol=None,
              wall_acc=None, nbr_wall=None, *, inv_h: float, dw_scale: float,
              inv_rho0c0: float, box=None):
    """B2.  Returns (C, cap, dim+1) = [f (dim), rd].  `wall_acc` None means
    a static wall (its acceleration channel dropped)."""
    if not _use_kernel(pos):
        return ac1_sweep_plain(pos, p, rho, acc, vol, nbr, wall_pos, wall_vol,
                               wall_acc, nbr_wall, inv_h=inv_h,
                               dw_scale=dw_scale, inv_rho0c0=inv_rho0c0,
                               box=box)
    from sphinxsys_tpu_torch.ops._build import library

    c, nw = nbr.shape
    cap, dim = pos.shape[1], pos.shape[2]
    dev, f32 = pos.device, torch.float32
    _check("pos", pos, f32, (c + 1, cap, dim), dev)
    _check("p", p, f32, (c + 1, cap), dev)
    _check("rho", rho, f32, (c + 1, cap), dev)
    _check("acc", acc, f32, (c + 1, cap, dim), dev)
    _check("vol", vol, f32, (c + 1, cap), dev)
    _check("nbr", nbr, torch.int32, (c, nw), dev)
    cw = capw = 0
    if nbr_wall is not None:
        cw, capw = _wall_shapes(nbr, wall_pos, nbr_wall)
        _check("wall_pos", wall_pos, f32, (cw + 1, capw, dim), dev)
        _check("wall_vol", wall_vol, f32, (cw + 1, capw), dev)
        if wall_acc is not None:
            _check("wall_acc", wall_acc, f32, (cw + 1, capw, dim), dev)
        _check("nbr_wall", nbr_wall, torch.int32, (c, nw), dev)
    out = torch.empty((c, cap, dim + 1), dtype=f32, device=dev)
    err = library().ac1_sweep_launch(
        dim, int(wall_acc is not None), _ptr(pos), _ptr(p), _ptr(rho),
        _ptr(acc), _ptr(vol), _ptr(nbr), c, cap, _ptr(wall_pos),
        _ptr(wall_vol), _ptr(wall_acc), _ptr(nbr_wall), cw, capw,
        float(inv_h), float(dw_scale), float(inv_rho0c0), *_box3(box, dim),
        _ptr(out), torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "ac1_sweep")
    LAUNCHES["ac1"] += 1
    return out


def ac2_sweep(pos, vel, vol, nbr, wall_pos=None, wall_vol=None, wall_vel=None,
              wall_n=None, nbr_wall=None, *, inv_h: float, dw_scale: float,
              rho0c0_geo: float, lim_scale: float, box=None):
    """B3.  Returns (C, cap, dim+1) = [dcr, f (dim)].  `wall_vel` None means
    a static wall (its velocity channel dropped)."""
    if not _use_kernel(pos):
        return ac2_sweep_plain(pos, vel, vol, nbr, wall_pos, wall_vol,
                               wall_vel, wall_n, nbr_wall, inv_h=inv_h,
                               dw_scale=dw_scale, rho0c0_geo=rho0c0_geo,
                               lim_scale=lim_scale, box=box)
    from sphinxsys_tpu_torch.ops._build import library

    c, nw = nbr.shape
    cap, dim = pos.shape[1], pos.shape[2]
    dev, f32 = pos.device, torch.float32
    _check("pos", pos, f32, (c + 1, cap, dim), dev)
    _check("vel", vel, f32, (c + 1, cap, dim), dev)
    _check("vol", vol, f32, (c + 1, cap), dev)
    _check("nbr", nbr, torch.int32, (c, nw), dev)
    cw = capw = 0
    if nbr_wall is not None:
        cw, capw = _wall_shapes(nbr, wall_pos, nbr_wall)
        _check("wall_pos", wall_pos, f32, (cw + 1, capw, dim), dev)
        _check("wall_vol", wall_vol, f32, (cw + 1, capw), dev)
        _check("wall_n", wall_n, f32, (cw + 1, capw, dim), dev)
        if wall_vel is not None:
            _check("wall_vel", wall_vel, f32, (cw + 1, capw, dim), dev)
        _check("nbr_wall", nbr_wall, torch.int32, (c, nw), dev)
    out = torch.empty((c, cap, dim + 1), dtype=f32, device=dev)
    err = library().ac2_sweep_launch(
        dim, int(wall_vel is not None), _ptr(pos), _ptr(vel), _ptr(vol),
        _ptr(nbr), c, cap, _ptr(wall_pos), _ptr(wall_vol), _ptr(wall_vel),
        _ptr(wall_n), _ptr(nbr_wall), cw, capw, float(inv_h), float(dw_scale),
        float(rho0c0_geo), float(lim_scale), *_box3(box, dim), _ptr(out),
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "ac2_sweep")
    LAUNCHES["ac2"] += 1
    return out


def visc_tvc_sweep(pos, vel, vol, nbr, wall_pos=None, wall_vol=None,
                   wall_vel=None, nbr_wall=None, *, inv_h: float,
                   dw_scale: float, eps_r: float, box=None):
    """B4.  Returns (C, cap, 2 dim) = [fv (dim), I (dim)]:
    fv = sum (v_i - v_j)/(r + eps_r) dW V_j (the wall term doubled, against
    the wall velocity) and I = -sum 2 dW V_j e_ij.  `wall_vel` None means a
    static wall (its velocity channel dropped)."""
    if not _use_kernel(pos):
        return visc_tvc_sweep_plain(pos, vel, vol, nbr, wall_pos, wall_vol,
                                    wall_vel, nbr_wall, inv_h=inv_h,
                                    dw_scale=dw_scale, eps_r=eps_r, box=box)
    from sphinxsys_tpu_torch.ops._build import library

    c, nw = nbr.shape
    cap, dim = pos.shape[1], pos.shape[2]
    dev, f32 = pos.device, torch.float32
    _check("pos", pos, f32, (c + 1, cap, dim), dev)
    _check("vel", vel, f32, (c + 1, cap, dim), dev)
    _check("vol", vol, f32, (c + 1, cap), dev)
    _check("nbr", nbr, torch.int32, (c, nw), dev)
    cw = capw = 0
    if nbr_wall is not None:
        cw, capw = _wall_shapes(nbr, wall_pos, nbr_wall)
        _check("wall_pos", wall_pos, f32, (cw + 1, capw, dim), dev)
        _check("wall_vol", wall_vol, f32, (cw + 1, capw), dev)
        if wall_vel is not None:
            _check("wall_vel", wall_vel, f32, (cw + 1, capw, dim), dev)
        _check("nbr_wall", nbr_wall, torch.int32, (c, nw), dev)
    out = torch.empty((c, cap, 2 * dim), dtype=f32, device=dev)
    err = library().visc_tvc_sweep_launch(
        dim, int(wall_vel is not None), _ptr(pos), _ptr(vel), _ptr(vol),
        _ptr(nbr), c, cap, _ptr(wall_pos), _ptr(wall_vol), _ptr(wall_vel),
        _ptr(nbr_wall), cw, capw, float(inv_h), float(dw_scale), float(eps_r),
        *_box3(box, dim), _ptr(out), torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "visc_tvc_sweep")
    LAUNCHES["visc_tvc"] += 1
    return out
