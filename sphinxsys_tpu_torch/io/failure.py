"""Failure detection: dump state to VTP when the solution explodes
(counterpart of sphinxsys_tpu/io/failure.py; reference io_vtk.h
WriteToVtpIfVelocityOutOfBound): a check that scans the bodies' velocity
magnitudes against a bound and, on the first violation, writes every
body's state to disk so the blow-up can be inspected.

The check is a masked max per body on the device and one host read a
call for all bodies together; the dump runs through the VTP writer.
"""

from __future__ import annotations

import os

import torch

from sphinxsys_tpu_torch.io.vtk import write_vtp


class WriteToVtpIfVelocityOutOfBound:
    """Check velocity bounds; dump every registered body on first failure.

        check = WriteToVtpIfVelocityOutOfBound(out_dir, bound=20.0)
        ...
        if check({"WaterBody": fluid, "Beam": solid}, time=t):
            raise RuntimeError("velocity out of bound; state dumped")
    """

    def __init__(self, output_dir: str, bound: float,
                 variables=("Velocity", "Pressure", "Density")):
        self.output_dir = output_dir
        self.bound = float(bound)
        self.variables = tuple(variables)
        self.out_of_bound = False

    def _body_exceeds(self, state: dict) -> torch.Tensor:
        """0-d bool on the state's device: a real (and alive) particle's
        |v| is beyond the bound or not a number (JAX's `>` lets a NaN
        pass; here it fires)."""
        vel = state["Velocity"]
        n = vel.shape[0]
        valid = torch.arange(n, device=vel.device) < int(state.get("NReal", n))
        if "Alive" in state:
            valid = valid & (state["Alive"] > 0)
        v2 = torch.sum(vel * vel, dim=-1)
        vmax2 = torch.max(torch.where(valid, v2, torch.zeros_like(v2)))
        return ~(vmax2 <= self.bound * self.bound)

    def __call__(self, bodies: dict, time: float = 0.0) -> bool:
        """Returns True (and writes one VTP per body) if any body has a
        particle beyond the velocity bound.  Idempotent after failure."""
        if self.out_of_bound:
            return True
        flags = torch.stack([self._body_exceeds(s) for s in bodies.values()])
        if not bool(flags.any()):
            return False
        self.out_of_bound = True
        os.makedirs(self.output_dir, exist_ok=True)
        for name, state in bodies.items():
            variables = [v for v in self.variables if v in state]
            path = os.path.join(
                self.output_dir, f"{name}_velocity_out_of_bound_{time:.6f}.vtp")
            write_vtp(path, state, variables)
        return True
