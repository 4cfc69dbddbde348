"""Prescribed-motion wavemakers and the wave tank's damping zone
(counterpart of sphinxsys_tpu/physics/wavemaker.py; the reference's
per-case `WaveMaking : BodyPartMotionConstraint` classes and
fluid_dynamics::DampingBoundaryCondition):

  * the single-frequency piston (owsc.h:261-334): Newton's iteration on
    om^2 = g k tanh(k h), Biesel's stroke;
  * the focused packet (nonlinear_wave_fsi.h:425-562): N equally spaced
    frequencies, strokes S_j = a (sinh kh cosh kh + kh) / sinh^2 kh,
    phases that focus the packet at x = xf, t = tf;
  * the damping zone (fluid_boundary.cpp:23-32): a quadratic ramp that
    relaxes the velocity toward zero across the zone.

The dispersion solves and the strokes are host floats, taken once at the
build.  The motions are evaluated on the device at every acoustic
sub-step from a 0-d time tensor; the packet's tables are tensors on the
device and in the dtype the build names.  The wavemaker rows are a fixed
boolean mask over the wall (the reference's BodyRegionByParticle), so the
update is a masked `where`.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


# ---------------------------------------------------------------------------
# The dispersion solves (at the build, on the host)
# ---------------------------------------------------------------------------

def dispersion_wavenumber(omega: float, depth: float, g: float,
                          iterations: int = 50, tol: float = 1e-12) -> float:
    """k of om^2 = g k tanh(k h) by Newton's iteration from the deep-water
    root (computeWaveStrokeAndFrequency, owsc.h:299-313)."""
    k = max(omega * omega / g, 1e-8)
    for _ in range(iterations):
        t = math.tanh(k * depth)
        f = k * t - omega * omega / g
        df = t + k * depth * (1.0 - t * t)
        k_new = k - f / df
        if abs(k_new - k) / abs(k_new) <= tol:
            return k_new
        k = k_new
    return k


def piston_stroke(wave_amp: float, k: float, depth: float, g: float,
                  omega: float) -> float:
    """Biesel's first-order piston transfer (owsc.h:315-319):
    stroke = 0.5 a k (g / om^2) (2 kh + sinh 2kh) / (cosh kh sinh kh)."""
    kh = k * depth
    return (0.5 * wave_amp * k * (g / omega / omega) *
            (2.0 * kh + math.sinh(2.0 * kh)) /
            (math.cosh(kh) * math.sinh(kh)))


@dataclasses.dataclass(frozen=True)
class PistonMotion:
    """The single-frequency piston, x(t) = 0.5 stroke sin(om t)
    (owsc.h WaveMaking::getDisplacement / Velocity / Acceleration); t a
    tensor."""

    stroke: float
    omega: float

    def displacement(self, t):
        return 0.5 * self.stroke * torch.sin(self.omega * t)

    def velocity(self, t):
        return 0.5 * self.stroke * self.omega * torch.cos(self.omega * t)

    def acceleration(self, t):
        return (-0.5 * self.stroke * self.omega * self.omega *
                torch.sin(self.omega * t))


def make_piston(wave_height: float, wave_period: float, depth: float,
                g: float, model_scale: float = 1.0) -> PistonMotion:
    """The OWSC piston (owsc.h:292-323): the target wave Froude-scaled,
    its wavenumber, Biesel's stroke."""
    h_s = wave_height / model_scale
    t_s = wave_period / math.sqrt(model_scale)
    omega = 2.0 * math.pi / t_s
    k = dispersion_wavenumber(omega, depth, g)
    return PistonMotion(stroke=piston_stroke(0.5 * h_s, k, depth, g, omega),
                        omega=omega)


@dataclasses.dataclass(frozen=True)
class FocusedPacketMotion:
    """The N-component focused packet (nonlinear_wave_fsi.h:439-474):
        x(t) = sum_j 0.5 S_j cos(-k_j xf - om_j (t - tf))
        v(t) = sum_j 0.5 om_j S_j sin(-k_j xf - om_j (t - tf))
        a(t) = -sum_j 0.5 om_j^2 S_j cos(-k_j xf - om_j (t - tf)).
    om, k, S: (N,) tensors; t a 0-d tensor on their device."""

    om: torch.Tensor
    k: torch.Tensor
    S: torch.Tensor
    tf: float
    xf: float

    def _phase(self, t):
        return -self.k * self.xf - self.om * (t - self.tf)

    def displacement(self, t):
        return torch.sum(0.5 * self.S * torch.cos(self._phase(t)))

    def velocity(self, t):
        return torch.sum(0.5 * self.om * self.S * torch.sin(self._phase(t)))

    def acceleration(self, t):
        return -torch.sum(0.5 * self.om * self.om * self.S *
                          torch.cos(self._phase(t)))


def make_focused_packet(depth: float, tf: float, xf: float, fmin: float,
                        fmax: float, amplitude: float, n_components: int,
                        g: float, dtype=torch.float32,
                        device="cpu") -> FocusedPacketMotion:
    """The (om, k, S) tables (nonlinear_wave_fsi.h:481-539): f_j = fmin +
    j (fmax - fmin) / N, S_j = a (sinh kh cosh kh + kh) / sinh^2 kh;
    solved in float64 on the host, then placed in `dtype` on `device`."""
    f = np.array([fmin + i * (fmax - fmin) / n_components
                  for i in range(n_components)])
    om = 2.0 * math.pi * f
    k = np.array([dispersion_wavenumber(o, depth, g) for o in om])
    kh = k * depth
    S = amplitude * (np.sinh(kh) * np.cosh(kh) + kh) / np.sinh(kh) ** 2
    put = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return FocusedPacketMotion(om=put(om), k=put(k), S=put(S), tf=tf, xf=xf)


# ---------------------------------------------------------------------------
# On the device
# ---------------------------------------------------------------------------

def apply_wavemaker(wall: dict, mask, motion, t, axis: int = 0) -> dict:
    """The prescribed motion imposed on the masked wall rows: Position =
    InitialPosition + d(t) e_axis, and the velocity and acceleration in
    the channels the fluid's wall terms read
    (BodyPartMotionConstraint::update).  `wall` carries
    "InitialPosition"."""
    out = dict(wall)
    pos0 = wall["InitialPosition"]
    zeros = torch.zeros_like(pos0)
    disp, vel, acc = zeros.clone(), zeros.clone(), zeros.clone()
    disp[:, axis] = motion.displacement(t)
    vel[:, axis] = motion.velocity(t)
    acc[:, axis] = motion.acceleration(t)
    m = mask[:, None]
    out["Position"] = torch.where(m, pos0 + disp, wall["Position"])
    for key, val in (("Velocity", vel), ("AverageVelocity", vel),
                     ("AverageAcceleration", acc)):
        out[key] = torch.where(m, val, wall.get(key, zeros))
    return out


def damping_zone(fluid: dict, mask, x_lo: float, x_hi: float, dt,
                 strength: float = 5.0, axis: int = 0) -> dict:
    """DampingBoundaryCondition (fluid_boundary.cpp:23-32): v *= 1 - dt
    strength ((x - x_lo) / (x_hi - x_lo))^2 on the masked rows."""
    out = dict(fluid)
    factor = (fluid["Position"][:, axis] - x_lo) / (x_hi - x_lo)
    scale = (1.0 - dt * strength * factor * factor)[:, None]
    out["Velocity"] = torch.where(mask[:, None], fluid["Velocity"] * scale,
                                  fluid["Velocity"])
    return out
