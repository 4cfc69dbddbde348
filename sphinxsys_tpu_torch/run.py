"""Case runner CLI — `python -m sphinxsys_tpu_torch.run <case> [flags]`
(counterpart of sphinxsys_tpu/run.py; reference per-case main() +
SPHSystem::handleCommandlineOptions): one entry point runs any registered
case of the port, writes ParaView VTP body states at the output interval,
and accepts the standard flags (RunConfig) plus per-case parameter
overrides (--set dx=0.05 --set t_end=2).

    python -m sphinxsys_tpu_torch.run dambreak_2d --set dx=0.05 --set t_end=2
    python -m sphinxsys_tpu_torch.run dambreak_3d_block --set dx=0.01 \\
        --set cap=32 --set c_max=125056 --set t_end=0.01 --set n_output=2
    python -m sphinxsys_tpu_torch.run twisting_column_3d --set engine=lattice
    python -m sphinxsys_tpu_torch.run fish_fsi_2d --set dx=0.01 --set t_end=0.1
    python -m sphinxsys_tpu_torch.run play_simbody_3d --set restart_step=5
    python -m sphinxsys_tpu_torch.run muscle_activation_3d --set dx=0.1
    python -m sphinxsys_tpu_torch.run square_droplet_2d --set dx=0.08
    python -m sphinxsys_tpu_torch.run floating_body_2d --set dx=0.05
    python -m sphinxsys_tpu_torch.run collision_2d --set dx=0.1 --set t_end=0.1
    python -m sphinxsys_tpu_torch.run column_collapse_2d --set t_end=0.1
    python -m sphinxsys_tpu_torch.run throat_2d --set dx=0.4 --set t_end=0.1
    python -m sphinxsys_tpu_torch.run vp_heat_flux_2d --set n_steps=5
    python -m sphinxsys_tpu_torch.run roof_3d --set t_end=0.01
    python -m sphinxsys_tpu_torch.run hydrostatic_fsi_2d --set dx=0.05
    python -m sphinxsys_tpu_torch.run double_mach_reflection_2d --set nx=240 \\
        --set ny=60
    python -m sphinxsys_tpu_torch.run taylor_green_mr_2d --set dx=0.05
    python -m sphinxsys_tpu_torch.run static_confinement_2d --set dx=0.05
    python -m sphinxsys_tpu_torch.run turbulent_channel_2d --set t_end=1
    python -m sphinxsys_tpu_torch.run shell_relaxation_2d \
        --set n_iterations=200
    python -m sphinxsys_tpu_torch.run implicit_relaxation_2d \
        --set blade_path=TurbineBlade.dat

The VTP writer writes a body's first NReal rows, as the JAX package's
does: for an open-boundary fluid these include dead slots parked at
FAR_AWAY (and, where NReal is below the capacity, leave out clones past
it).

A case runs on the card unless `--set device=cpu` asks for the CPU (the
case's own `device` argument).  The exit codes and log lines are the JAX
package's: 0, or 2 for an unknown case or bad case parameters;
implicit_relaxation_2d without its blade file exits 1 with the
FileNotFoundError's message.
"""

from __future__ import annotations

import importlib
import logging
import os
import time

from sphinxsys_tpu_torch.io.vtk import write_vtp
from sphinxsys_tpu_torch.utils.config import RunConfig

log = logging.getLogger("sphinxsys_tpu_torch.run")

VTP_VARS = ("Velocity", "Pressure", "Density")


def _write_bodies(cfg: RunConfig, step: int, bodies: dict):
    if not cfg.state_recording:
        return
    os.makedirs(cfg.output_dir, exist_ok=True)
    for name, state in bodies.items():
        variables = [v for v in VTP_VARS if v in state]
        write_vtp(os.path.join(cfg.output_dir, f"{name}_{step:06d}.vtp"),
                  state, variables)


def _run_single_fluid(module_name: str, bodies_of, t_end: float):
    """Adapter for cases exposing build_case / init_sim / make_run_chunk
    (the gather routes and the solids).  Each chunk's target is formed in
    the time's dtype by the case's run_chunk."""

    def runner(cfg: RunConfig):
        mod = importlib.import_module(f"sphinxsys_tpu_torch.cases.{module_name}")
        p = dict(cfg.parameters)
        end = float(p.pop("t_end", t_end))
        n_out = int(p.pop("n_output", 20))
        built = mod.build_case(**p)
        case, *states = built if isinstance(built, tuple) else (built,)
        if hasattr(mod, "init_sim"):
            s = mod.init_sim(case, *states)
        else:       # the solids that build their sim themselves
            (s,) = states
        run = mod.make_run_chunk(case)
        for i in range(1, n_out + 1):
            t0 = time.time()
            s = run(s, i * end / n_out)
            overflow = bool(getattr(s, "overflow", False))
            log.info("t=%.4f  (%.1fs)%s", float(s.time), time.time() - t0,
                     "  OVERFLOW" if overflow else "")
            _write_bodies(cfg, i, bodies_of(case, s))
        return s

    return runner


def _cells_body(module_name: str, body: str):
    """An FVM case's cell centroids and fields as one body (its module's
    `cells_as_body`), as the JAX package's entries write them."""
    def bodies_of(case, s):
        mod = importlib.import_module(f"sphinxsys_tpu_torch.cases.{module_name}")
        return {body: mod.cells_as_body(case, s)}

    return bodies_of


def _run_block(module_name: str, extra_bodies=None, t_end: float = 20.0,
               fsi: bool = False):
    """Adapter for the cell-block engine (engine/scene.py): cases expose
    build_block_case; the fluid is written from its blocks in OriginalID
    order, its real rows only."""

    def runner(cfg: RunConfig):
        from sphinxsys_tpu_torch.engine import scene as sc

        mod = importlib.import_module(f"sphinxsys_tpu_torch.cases.{module_name}")
        p = dict(cfg.parameters)
        end = float(p.pop("t_end", t_end))
        n_out = int(p.pop("n_output", 20))
        if fsi:
            scene, fluid, solid = mod.build_block_case(**p)
            s = mod.init_block_sim(scene, fluid, solid)
        else:
            scene, fluid = mod.build_block_case(**p)
            s = sc.init_sim(scene, fluid)
        run = sc.make_run_chunk(scene)
        for i in range(1, n_out + 1):
            t0 = time.time()
            s = run(s, i * end / n_out)
            log.info("t=%.4f  (%.1fs)%s", float(s.time), time.time() - t0,
                     "  OVERFLOW" if bool(s.overflow) else "")
            if cfg.state_recording:
                bodies = {"WaterBody": sc.blocks_to_particles(scene, s)}
                if extra_bodies is not None:
                    bodies.update(extra_bodies(scene, s))
                _write_bodies(cfg, i, bodies)
        return s

    return runner


# the JAX package's entries for the cases the port has, with its body names
# and t_end defaults; its other case names answer "unknown case"
CASES = {
    "dambreak_2d": _run_single_fluid(
        "dambreak_2d", lambda c, s: {"WaterBody": s.fluid, "Wall": c.wall},
        t_end=20.0),
    "taylor_green_2d": _run_single_fluid(
        "taylor_green_2d", lambda c, s: {"WaterBody": s.fluid}, t_end=5.0),
    "ball_shell_collision_3d": _run_single_fluid(
        "ball_shell_collision_3d",
        lambda c, s: {"BallBody": s.ball, "Shell": c.shell}, t_end=4.0),
    "fsi2": _run_single_fluid(
        "fsi2",
        lambda c, s: {"WaterBody": s.fluid, "InsertedBody": s.solid,
                      "Wall": c.wall}, t_end=20.0),
    "dambreak_3d": _run_single_fluid(
        "dambreak_3d", lambda c, s: {"WaterBody": s.fluid, "Wall": c.wall},
        t_end=2.0),
    "twisting_column_3d": _run_single_fluid(
        "twisting_column_3d", lambda c, s: {"Column": s.column}, t_end=0.5),
    "fish_undulation_2d": _run_single_fluid(
        "fish_undulation_2d", lambda c, s: {"FishBody": s.fish}, t_end=1.0),
    "fish_fsi_2d": _run_single_fluid(
        "fish_fsi_2d",
        lambda c, s: {"WaterBody": s.fluid, "FishBody": s.fish}, t_end=1.7),
    "t_pipe_2d": _run_single_fluid(
        "t_pipe_2d",
        lambda c, s: {"WaterBody": s.fluid, "WallBoundary": c.wall},
        t_end=100.0),
    "tethered_fish_2d": _run_single_fluid(
        "tethered_fish_2d",
        lambda c, s: {"WaterBody": s.fluid, "FishBody": s.fish,
                      "Wall": c.wall}, t_end=10.0),
    "stlw_2d": _run_single_fluid(
        "stlw_2d", lambda c, s: {"WaterBody": s.fluid, "Wall": c.wall},
        t_end=10.0),
    "filling_tank_2d": _run_single_fluid(
        "filling_tank_2d",
        lambda c, s: {"WaterBody": s.fluid, "Wall": c.wall}, t_end=30.0),
    "elastic_gate_2d": _run_single_fluid(
        "elastic_gate_2d",
        lambda c, s: {"WaterBody": s.fluid, "Gate": s.gate, "Wall": c.wall},
        t_end=400.0),
    "flow_around_cylinder_2d": _run_single_fluid(
        "flow_around_cylinder_2d",
        lambda c, s: {"WaterBody": s.fluid, "Cylinder": s.cyl}, t_end=200.0),
    "standing_wave_2d": _run_single_fluid(
        "standing_wave_2d",
        lambda c, s: {"WaterBody": s.fluid, "Wall": c.wall}, t_end=10.0),
    "poiseuille_flow_2d": _run_single_fluid(
        "poiseuille_flow_2d",
        lambda c, s: {"WaterBody": s.fluid, "Wall": c.wall}, t_end=100.0),
    "impact_patch_2d": _run_single_fluid(
        "impact_patch_2d", lambda c, s: {"WaterBody": s.fluid}, t_end=1.0),
    "rotation_patch_2d": _run_single_fluid(
        "rotation_patch_2d", lambda c, s: {"WaterBody": s.fluid}, t_end=8.0),
    "oscillating_beam_2d": _run_single_fluid(
        "oscillating_beam_2d", lambda c, s: {"BeamBody": s.solid}, t_end=1.0),
    "oscillating_beam_cauchy_2d": _run_single_fluid(
        "oscillating_beam_cauchy_2d", lambda c, s: {"BeamBody": s.solid},
        t_end=1.0),
    "self_contact_2d": _run_single_fluid(
        "self_contact_2d", lambda c, s: {"BeamBody": s.beam}, t_end=1.0),
    "passive_cantilever_3d": _run_single_fluid(
        "passive_cantilever_3d",
        lambda c, s: {"CantileverBody": s.body}, t_end=3.0),
    "muscle_activation_3d": _run_single_fluid(
        "muscle_activation_3d",
        lambda c, s: {"MyocardiumMuscleBody": s.body}, t_end=1.2),
    "anisotropic_beam_2d": _run_single_fluid(
        "anisotropic_beam_2d", lambda c, s: {"BeamBody": s.solid},
        t_end=1.0),
    "two_phase_dambreak_2d": _run_single_fluid(
        "two_phase_dambreak_2d",
        lambda c, s: {"WaterBody": s.water, "AirBody": s.air, "Wall": c.wall},
        t_end=10.0),
    "square_droplet_2d": _run_single_fluid(
        "square_droplet_2d",
        lambda c, s: {"WaterBody": s.water, "AirBody": s.air, "Wall": c.wall},
        t_end=2.0),
    "droplet_impact_2d": _run_single_fluid(
        "droplet_impact_2d",
        lambda c, s: {"WaterBody": s.water, "AirBody": s.air,
                      "WallBoundary": c.wall}, t_end=0.2),
    "cubic_droplet_3d": _run_single_fluid(
        "cubic_droplet_3d",
        lambda c, s: {"WaterBody": s.water, "AirBody": s.air, "Wall": c.wall},
        t_end=2.0),
    "floating_body_2d": _run_single_fluid(
        "floating_body_2d",
        lambda c, s: {"WaterBody": s.fluid, "Block": s.block, "Wall": c.wall},
        t_end=2.0),
    "stfb_2d": _run_single_fluid(
        "stfb_2d",
        lambda c, s: {"WaterBody": s.fluid, "Structure": s.block,
                      "Wall": c.wall}, t_end=10.0),
    "owsc_2d": _run_single_fluid(
        "owsc_2d",
        lambda c, s: {"WaterBody": s.fluid, "Flap": s.flap, "Wall": s.wall},
        t_end=12.0),
    "nonlinear_wave_fsi_2d": _run_single_fluid(
        "nonlinear_wave_fsi_2d",
        lambda c, s: {"WaterBody": s.fluid, "Structure": s.block,
                      "Wall": s.wall}, t_end=20.0),
    "slender_beam_3d": _run_single_fluid(
        "slender_beam_3d", lambda c, s: {"BarBody": s.bar}, t_end=0.8),
    "sliding_2d": _run_single_fluid(
        "sliding_2d",
        lambda c, s: {"FreeCube": s.cube, "WallBoundary": c.wall}, t_end=2.5),
    "collision_2d": _run_single_fluid(
        "collision_2d",
        lambda c, s: {"FreeBall": s.free_ball, "DampingBall": s.damping_ball,
                      "WallBoundary": c.wall}, t_end=10.0),
    "passive_cantilever_neohookean_3d": _run_single_fluid(
        "passive_cantilever_neohookean_3d",
        lambda c, s: {"CantileverBody": s.body}, t_end=1.0),
    "stretching_2d": _run_single_fluid(
        "stretching_2d", lambda c, s: {"StretchingBody": s.bar},
        t_end=100.0),
    "muscle_solid_contact_3d": _run_single_fluid(
        "muscle_solid_contact_3d",
        lambda c, s: {"MyocardiumBody": s.myo, "MovingPlate": s.plate},
        t_end=0.1),
    "twisting_rigid_elastic_bar_3d": _run_single_fluid(
        "twisting_rigid_elastic_bar_3d", lambda c, s: {"Bar": s.bar},
        t_end=5.0),
    "column_collapse_2d": _run_single_fluid(
        "column_collapse_2d",
        lambda c, s: {"SoilBody": s.soil, "Wall": c.wall}, t_end=1.0),
    "cohesive_soil_failure_2d": _run_single_fluid(
        "cohesive_soil_failure_2d",
        lambda c, s: {"GranularBody": s.soil, "WallBoundary": c.wall},
        t_end=2.0),
    "repose_angle_3d": _run_single_fluid(
        "repose_angle_3d",
        lambda c, s: {"GranularBody": s.soil, "Wall": c.wall}, t_end=1.0),
    "oscillating_beam_ul_2d": _run_single_fluid(
        "oscillating_beam_ul_2d", lambda c, s: {"BeamBody": s.beam},
        t_end=1.0),
    "spinning_plate_2d": _run_single_fluid(
        "spinning_plate_2d", lambda c, s: {"SquareBody": s.plate},
        t_end=0.5),
    "taylor_bar_ul_3d": _run_single_fluid(
        "taylor_bar_ul_3d",
        lambda c, s: {"Column": s.column, "Wall": c.wall}, t_end=1.0e-4),
    "lid_driven_cavity_2d": _run_single_fluid(
        "lid_driven_cavity_2d",
        lambda c, s: {"FluidBody": s.fluid, "Wall": c.wall}, t_end=10.0),
    "throat_2d": _run_single_fluid(
        "throat_2d",
        lambda c, s: {"FluidBody": s.fluid, "WallBoundary": c.wall},
        t_end=40.0),
    "channel_windkessel_2d": _run_single_fluid(
        "channel_windkessel_2d",
        lambda c, s: {"WaterBody": s.fluid, "Wall": c.wall}, t_end=5.0),
    "pulsatile_poiseuille_2d": _run_single_fluid(
        "pulsatile_poiseuille_2d",
        lambda c, s: {"WaterBody": s.fluid, "Wall": c.wall}, t_end=10.0),
    "diffusion_bcs_2d": _run_single_fluid(
        "diffusion_bcs_2d",
        lambda c, s: {"DiffusionBody": dict(s.body)}, t_end=1.0),
    "heat_transfer_2d": _run_single_fluid(
        "heat_transfer_2d",
        lambda c, s: {"ThermofluidBody": s.fluid, "ThermosolidBody": c.wall},
        t_end=10.0),
    "windows_frame_diffusion_2d": _run_single_fluid(
        "windows_frame_diffusion_2d",
        lambda c, s: {"DiffusionBody": s.body,
                      "InternalConvectionBoundary": c.air_in,
                      "ExternalConvectionBoundary": c.air_ex}, t_end=0.02),
    "depolarization_2d": _run_single_fluid(
        "depolarization_2d",
        lambda c, s: {"MuscleBlock": dict(s.body)}, t_end=16.0),
    "shell_cantilever_2d": _run_single_fluid(
        "shell_cantilever_2d", lambda c, s: {"Shell": s.shell}, t_end=1.0),
    "shell_plate_3d": _run_single_fluid(
        "shell_plate_3d", lambda c, s: {"Plate": s.shell}, t_end=0.02),
    "roof_3d": _run_single_fluid(
        "roof_3d", lambda c, s: {"CylinderBody": s.shell}, t_end=2.0),
    "shell_stability_half_sphere_3d": _run_single_fluid(
        "shell_stability_half_sphere_3d", lambda c, s: {"Shell": s.shell},
        t_end=0.5),
    "solid_shell_coupling_3d": _run_single_fluid(
        "solid_shell_coupling_3d",
        lambda c, s: {"Cube": s.cube, "Shell": s.shell}, t_end=40.0),
    "hydrostatic_fsi_2d": _run_single_fluid(
        "hydrostatic_fsi_2d",
        lambda c, s: {"WaterBody": s.fluid, "Gate": s.gate, "Wall": c.wall},
        t_end=0.2),
    "poiseuille_flow_shell_3d": _run_single_fluid(
        "poiseuille_flow_shell_3d",
        lambda c, s: {"WaterBody": s.fluid, "Shell": c.shell}, t_end=2.0),
    "three_ring_impact_2d": _run_single_fluid(
        "three_ring_impact_2d",
        lambda c, s: {"RingL": s.ring_l, "RingM": s.ring_m,
                      "RingS": s.ring_s}, t_end=0.2),
    "water_entry_exit_2d": _run_single_fluid(
        "water_entry_exit_2d",
        lambda c, s: {"WaterBody": s.fluid, "Cylinder": s.cyl,
                      "Wall": c.wall}, t_end=1.0),
    "pkj_lv_electrocontraction_3d": _run_single_fluid(
        "pkj_lv_electrocontraction_3d",
        lambda c, s: {"Myocardium": s.myo}, t_end=10.0),
    "heart_electromechanics_3d": _run_single_fluid(
        "heart_electromechanics_3d", lambda c, s: {"Myocardium": s.myo},
        t_end=8.0),
    "eulerian_taylor_green_2d": _run_single_fluid(
        "eulerian_taylor_green_2d",
        lambda c, s: {"WaterBody": s.fluid}, t_end=5.0),
    "dambreak_2d_block": _run_block(
        "dambreak_2d", lambda sc_, s: {"Wall": sc_.base.wall}, t_end=20.0),
    "dambreak_3d_block": _run_block("dambreak_3d", t_end=6.0),
    "taylor_green_2d_block": _run_block("taylor_green_2d", t_end=5.0),
    "fsi2_block": _run_block("fsi2", t_end=20.0, fsi=True),
    "fvm_cylinder_2d": _run_single_fluid(
        "fvm_cylinder_2d", _cells_body("fvm_cylinder_2d", "FluidCells"),
        t_end=200.0),
    "supersonic_cylinder_2d": _run_single_fluid(
        "supersonic_cylinder_2d",
        _cells_body("supersonic_cylinder_2d", "GasCells"), t_end=40.0),
    "double_mach_reflection_2d": _run_single_fluid(
        "double_mach_reflection_2d",
        _cells_body("double_mach_reflection_2d", "GasCells"), t_end=0.2),
    "fvm_channel_3d": _run_single_fluid(
        "fvm_channel_3d", lambda c, s: {}, t_end=2.0),
    "taylor_green_mr_2d": _run_single_fluid(
        "taylor_green_mr_2d", lambda c, s: {"WaterBody": s.fluid},
        t_end=2.0),
    "mr_cantilever_beam_2d": _run_single_fluid(
        "mr_cantilever_beam_2d", lambda c, s: {"BeamBody": s.solid},
        t_end=1.0),
    "mr_cylinder_2d": _run_single_fluid(
        "mr_cylinder_2d",
        lambda c, s: {"WaterBody": s.fluid, "Cylinder": c.cylinder},
        t_end=30.0),
    "static_confinement_2d": _run_single_fluid(
        "static_confinement_2d", lambda c, s: {"WaterBody": s.fluid},
        t_end=20.0),
    "turbulent_channel_2d": _run_single_fluid(
        "turbulent_channel_2d",
        lambda c, s: {"WaterBody": s.fluid, "Wall": c.wall}, t_end=100.0),
}


def _run_play_simbody(cfg: RunConfig):
    """The multibody-only case (no particles): the prescribed triple
    pendulum, stepped and written as step-indexed XML state snapshots
    (play_simbody.cpp:63-68); `--set restart_step=N` continues from the
    snapshot of step N in the output directory."""
    from sphinxsys_tpu_torch.cases import play_simbody_3d as ps

    p = dict(cfg.parameters)
    restart = int(p.pop("restart_step", 0))
    s = ps.run_case(cfg.output_dir, restart_step=restart, **p)
    log.info("t=%.4f  q=%s", float(s.t),
             [round(float(x), 6) for x in s.q.cpu()])
    return s


CASES["play_simbody_3d"] = _run_play_simbody


def _run_vp_optimization(cfg: RunConfig):
    """The target-driven thermal optimisation (tests/optimization/*): the
    steady solve at the uniform conductivity, the Adam optimisation
    through the solve, and the optimised layout written as one VTP
    (`--set config=same_sink`, `--set n_steps=N`)."""
    import torch

    from sphinxsys_tpu_torch.cases import vp_heat_flux_2d as vp
    p = dict(cfg.parameters)
    config = str(p.pop("config", "heat_flux"))
    n_steps = int(p.pop("n_steps", 150))
    case = vp.build_case(config, **p)
    pos = case.body["Position"]
    T0 = vp.steady_temperature(case, torch.full_like(pos[:, 0],
                                                     vp.DIFF_COEFF))
    log.info("steady (uniform k) mean T = %.2f", float(torch.mean(T0)))
    k, T, hist = vp.optimize_conductivity(case, n_steps=n_steps)
    log.info("optimized mean T = %.2f (after %d Adam steps)",
             float(torch.mean(T)), n_steps)
    if cfg.state_recording:
        os.makedirs(cfg.output_dir, exist_ok=True)
        body = dict(case.body, Phi=T, ThermalConductivity=k)
        write_vtp(os.path.join(cfg.output_dir, "DiffusionBody_opt.vtp"),
                  body, ["Phi", "ThermalConductivity"])
    return k, T, hist


CASES["vp_heat_flux_2d"] = _run_vp_optimization


def _write_relaxed(cfg: RunConfig, name: str, pos, extra=None):
    if cfg.state_recording:
        os.makedirs(cfg.output_dir, exist_ok=True)
        body = dict({"Position": pos, "NReal": pos.shape[0]}, **(extra or {}))
        write_vtp(os.path.join(cfg.output_dir, name), body,
                  list(extra or {}))


def _run_implicit_relaxation(cfg: RunConfig):
    """test_2d_implicit_relaxation: relax the turbine blade (`--set
    blade_path=...`, the vertex file) with the implicit level-set-corrected
    step; writes the relaxed distribution."""
    from sphinxsys_tpu_torch.cases import implicit_relaxation_2d as ir

    p = dict(cfg.parameters)
    n_it = int(p.pop("n_iterations", 1000))
    try:
        ir.load_blade(p.get("blade_path"))
    except FileNotFoundError as e:
        raise SystemExit(f"error: implicit_relaxation_2d: {e}") from None
    pos, curve, _ = ir.run_case(n_iterations=n_it, **p)
    for m, v in enumerate(curve.tolist()):
        log.info("ite %d: avg |residual| = %.6f",
                 (m + 1) * (n_it // len(curve)), v)
    _write_relaxed(cfg, "Body_relaxed.vtp", pos)
    return pos, curve


CASES["implicit_relaxation_2d"] = _run_implicit_relaxation


def _run_shell_relaxation(cfg: RunConfig):
    """test_2d_shell_particle_relaxation: relax the thin pipe's particles
    onto its mid-surface and predict consistent normals; writes the
    relaxed shell."""
    from sphinxsys_tpu_torch.cases import shell_relaxation_2d as sr

    p = dict(cfg.parameters)
    n_it = int(p.pop("n_iterations", 2000))
    pos, normals, updated = sr.run_case(n_iterations=n_it, **p)
    log.info("normal flood fill complete: %s", bool(updated.all()))
    _write_relaxed(cfg, "Shell_relaxed.vtp", pos,
                   {"NormalDirection": normals})
    return pos, normals


CASES["shell_relaxation_2d"] = _run_shell_relaxation


def main(argv=None):
    import sys

    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help", "list"):
        print("usage: python -m sphinxsys_tpu_torch.run <case> [flags]")
        print("cases:", ", ".join(sorted(CASES)))
        return 0
    name = argv.pop(0)
    if name not in CASES:
        print(f"unknown case '{name}'; available:", ", ".join(sorted(CASES)))
        return 2
    cfg = RunConfig.from_cli(argv)
    logging.basicConfig(level=cfg.log_level,
                        format="%(asctime)s %(name)s %(message)s")
    log.info("running %s  (output -> %s)", name, cfg.output_dir)
    try:
        CASES[name](cfg)
    except TypeError as e:
        print(f"error: bad case parameters for '{name}': {e}")
        return 2
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
