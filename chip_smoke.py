#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths — the dual-criteria WCSPH solver on the
cell-block engine — at full size:

  * 2D dambreak, dx=0.0025: 320,000 fluid particles (bench.py:311-318);
  * 3D dambreak, dx=0.01: 1,000,000 fluid particles, cap 32, c_max 125,000;
  * Taylor–Green 2D, dx=0.001: 1,000,000 fluid particles on a 384 x 384
    doubly periodic grid, cap 12, c_max 147,456 (viscous force and
    transport-velocity correction, no wall);
  * 2d16: the 2D dambreak at dx=0.0025 with cap 16, its acoustic sub-steps
    through the packed halves (B5a-d, csrc/packed_sweeps.cu), as
    benchmarks/micro_sweep.py composed them;
  * tc1m: the twisting column on the lattice-stencil solid at dx=0.0175
    (bench.py:330): 349 x 57 x 57 = 1,133,901 sites, 80 taps, its two tap
    sums through L1 / L2 (csrc/lattice_sweeps.cu), and on the gather
    engine (frozen neighbour lists, torch ops);
  * fsi2 at its reference resolution dx=0.1: 5,180 fluid, 1,104 wall and
    150 solid particles, the wall and the elastic beam one moving
    wall-type body on an x-periodic grid, through B1-B4's moving-wall,
    periodic variants;
  * the gather fluid routes (neighbour lists, torch ops): the 2D and 3D
    dambreaks at the widths above, Taylor–Green and fsi2;
  * the entry point, `python -m sphinxsys_tpu_torch.run`, at the widths
    above (the 3D dambreak's block route and the 1.13M column), with its
    VTP output; the ball–shell collision at dx=0.05 (4,224 ball and 6,120
    shell particles).
  * open boundaries, the free stream and the active-strain fish:
    fish_fsi_2d at the reference's dx=0.0025 (53,714 water particles in
    59,085 rows, 686 fish particles) and the T-pipe (1,460 in 2,190 rows)
    through the neighbour-list routes (torch ops, no hand kernel).
  * the articulated multibody: the tethered fish at its default dx =
    3.738 / 100 (65,282 water particles in 76,058 rows, 1,057 fish, the
    head a Planar mobilizer), play_simbody's triple pendulum; and the
    four fluid cases of ROADMAP A item 3a at their JAX default widths
    (stlw 2,400; the filling tank's 14,000 rows; the elastic gate 2,240 +
    480; the cylinder 4,546 + 172), through the neighbour-list routes.
  * the kernel-corrected fluid and the remaining solid laws (ROADMAP A
    items 3b-3c) at their JAX default widths: the standing wave, the
    Poiseuille channel, the impact and rotating patches (the correction
    matrix and the corrected first half), the oscillating beams (PK2 and
    Cauchy), the self-contacting beam, the passive cantilever and the
    activated cube (the muscle and its active stress), the anisotropic
    beam, on neighbour lists and frozen pairs.
  * the multi-phase fluid and the rigid bodies (ROADMAP A item 3d and
    the first family of item 4) at their JAX default widths: the
    two-phase dambreak (800 water, 3,440 air), the square droplet (625 +
    1,875), the droplet impact (1,264 + 10,736), the cubic droplet (3D,
    2,744 + 24,256), the floating block (1,250 + 50), stfb (2,120 + 400),
    OWSC (10,013 + a 67-particle flap) and the moored structure in the
    focused wave (16,865 + 400), on neighbour lists and torch ops.
  * the continuum family (ROADMAP A item 4, third family) at its JAX
    default widths: the granular column collapse (5,000 soil + 2,664
    wall), the cohesive soil (1,250 + 847), the 3D repose pile (3,140 +
    43,080), the updated-Lagrangian beam (1,612), the spinning plate
    (400) and the J2 Taylor bar (32,256 + a 20,736-particle holder), on
    neighbour lists and torch ops.
  * the small fluid modules and the plain diffusion family (ROADMAP A
    items 2 and 4a) at their JAX default widths: the Herschel-Bulkley
    lid cavity (2,500 + 864), the Oldroyd-B throat (7,200 + 4,320, the
    CG damping in each sub-step), the Windkessel channel (1,777 rows +
    696), the pulsatile channel's bidirectional buffers (2,560 rows +
    704), the heat channel (3,625 + 1,160), the diffusion square
    (10,000), the window frame (14,008 + 2,899 + 1,590), the
    depolarization block (2,500) and the thermal optimisation (2,500,
    the dense solve under autograd), on neighbour lists and torch ops.
  * the shell family (ROADMAP A item 3) at its JAX default widths and
    dtypes: the cantilever (53), the plate (189), the roof (425, float64),
    the half sphere (3,927, float64, its CVT), the solid-shell coupling
    (1,100 + 500, float64), the hydrostatic gate (3,200 + 48 + 168, its
    sub-step a CUDA graph), the shell pipe (6,000 rows + 7,540) and the
    three rings (2,812 + 138 + 113, float64), on neighbour lists, frozen
    pairs and torch ops.
  * the rest of the diffusion family and the Eulerian fluid (ROADMAP A
    item 4 and item 5's first half) at their JAX default widths: the
    water entry (9,600 water, 2,464 wall, a 1,252-particle wetted
    cylinder), the Purkinje-driven ventricle (1,570 and a 67-particle
    tree), the heart (1,570, its fibers, the adaptive mechanics
    sub-cycle) and the Eulerian Taylor-Green vortex (2,500, HLLC), on
    neighbour lists, the tree's list, frozen pairs and torch ops.
  * the level sets, the relaxations and the k-epsilon turbulence
    (ROADMAP A items 7 and 8) at their JAX default widths: the static
    confinement (3,200 water particles between two level sets), the
    turbulent channel (160 + 64), the shell annulus (315) and the implicit
    relaxation of a NACA 0012 section (820), on neighbour lists, packaged
    level-set probes and torch ops.

Phases:

  1. environment: torch / CUDA versions, the card's name and power limit;
  2. build: nvcc compiles sphinxsys_tpu_torch/csrc/*.cu, one process per
     source, all started together;
  3. kernels: each CUDA sweep of a path against its plain PyTorch version
     on the same CUDA inputs (the scene after one advection step; for
     Taylor–Green from the lattice with seeded noise), with times from
     CUDA events and each kernel's bound (the least time the card could
     take: the larger of the bytes it must move over 3.35 TB/s and its
     real pairs' flops over 67 TFLOP/s); the moving-wall variants, and B4
     with a static and a moving wall on the 2D dambreak; for B1-B4 the
     lane x slot pairs their lane groups evaluate, and, in 2D and 3D,
     padding where the first design never met it (holes: a real slot
     swapped with its row's last padding slot, B1's mask moved with it;
     near padding: padding moved into the support, VOL 0 and mask 0, real
     slots unchanged within 1e-6; B4 with a static and a moving wall);
     then B1-B4 at cap 40 (3D, dx=0.05: two i-chunks a cell, also with
     holes, so that the second chunk holds real slots);
  4. small references: the 2D dambreak (dx=0.1) and Taylor–Green (dx=0.05)
     slices on the card against the same runs on the CPU; Taylor–Green at
     dx=0.01 to t=0.1 against the analytic kinetic-energy decay;
  5. the main paths through build_block_case -> init_sim -> make_run_chunk
     -> solver.run_simulation, checking that every kernel of the path ran,
     no capacity overflowed, the fields stay finite and the energy behaves
     (dambreak: mechanical energy drifts < 1%; Taylor–Green: the kinetic
     energy falls); then the steady-state step time by part, and one
     advection step under torch.profiler (device busy and idle share;
     Chrome traces to build/traces/);
  6. 2d16: on the dambreak state after one advection step, B5a-d against
     their plain versions (and with a moving wall, the Dissipative
     solver's constants and padding of volume 1 moved into the support),
     timed and bounded, with the lane x slot pairs B5a/B5b evaluate, the
     B2/B3 times on the same state, a check that window 4 is each cell's
     own row (B5a/B5b drop the self pair by slot index), B5a/B5b with
     holes (real slots unchanged through the swap within 1e-6) and with
     coincident particles, and B5c/B5d with holes in the i-rows and the
     wall rows (the same criterion) and with every wall row made full,
     beside the slot pairs their lane groups evaluate and their first
     design's; then one advection step's
     acoustic sub-steps through the packed halves and through the *_p2
     halves from the same state (equal sub-step counts, positions within
     5e-5, every packed kernel launched), each route's sub-step time, and
     one packed sub-step under torch.profiler;
  7. layout: on the same state, packed once, B6 and B7
     (csrc/layout_sweeps.cu, two other decompositions of B5a's sweep)
     against their plain versions and both against the B5a kernel, and
     bounded, with the pairs each evaluates beside its first design's; both
     with holes (real slots unchanged through the swap within 1e-6), with
     coincident particles and with padding of volume 1 moved into the
     support, B7 always through `prep_t`, and B7 at C - 3 cells (4-byte
     copies, a ragged last tile); then the layout drivers
     (sphinxsys_tpu_torch/benchmarks/exp_layout*.py) on that state, launch
     counts reset just before them and read just after, their
     cross-checks, and B6's, B7's and `prep_t`'s (B7's gather) times from
     their runs;
  8. lattice solid: the plain path on the card (use_kernels=False, JAX's
     tap loops as torch ops): its step time and, from one profiled step,
     its device launches; the main path (build_case -> init_sim ->
     make_run_chunk, >= 40 steps, counts reset just before, L1 and L2
     once a step, fields finite, the holder at its initial positions), the
     step by part, one profiled step and pair_interaction_updates_per_sec
     counted as bench.py:239-242 counts it; L1 and L2 against their plain
     versions on that state and on it notched with NaN planted in the
     notch, timed and bounded beside each design's occupancy, L2 also
     beside its library yardstick (one grouped conv3d, never called by
     the port); L1 and L2 where their staged bricks could break: a ragged
     37 x 13 x 11 lattice with a notch and scattered NaN sites, lattices
     one site thick in x, y and z, a brick all invalid next to valid ones;
     the dx=0.1 column through the kernels against the plain versions to
     t=0.02 (equal step counts, positions within 5e-5 of max|x|) and to
     t=0.5 against the JAX package's own float32 tip curve (every one of
     its 140 snapshots) and the committed one (its first 99);
  9. fsi2 (between phases 5 and 6): B1-B4 against their plain versions on
     the state at t=0.5 (also with holes, padding near the real slots and
     coincident particles), timed and bounded; the kernels and the block
     forms on the card to t=0.1 (equal counts, states within
     FSI2_SHORT_TOL); the main path to t=2.5 (build_block_case ->
     init_block_sim -> make_run_chunk, counts reset just before it, the
     host reads of device values counted) held to the spread of the JAX
     package's own float32 runs (`fsi2_gates`: sub-step counts, tip
     excursion); the step by part and profiled, with the torch-op FSI
     couplings and solid sub-step on their own;
 10. gather solid (inside phase 8): at dx=0.0175 the frozen topology
     built on the card (time, peak memory), GATHER_STEPS steps from the
     lattice main path's state against that path's (positions within
     GATHER_POS_TOL of max|x|), its step profiled; the dx=0.1 column on
     the gather engine to t=0.5 against the JAX curve;
 11. gather fluid: the neighbour-list routes (`init_sim` /
     `make_run_chunk` of the dambreaks, Taylor–Green and fsi2: lists
     rebuilt every advection step, the pair sums torch ops over them, no
     hand kernel): the dambreak (dx=0.1, to t=0.08) and Taylor–Green
     (dx=0.05) on the card against the CPU; the third oracle, the gather
     route against the block route's kernels on the scenes of
     tests/test_scene_engines.py (equal counts, positions within 2e-3 of
     max|x|); Taylor–Green at dx=0.01 to t=0.1 against the analytic
     decay; the 2D dambreak at dx=0.0025 (at least 4 advection steps, the
     Morton resort every 2nd) and the 3D one at dx=0.01 (the case's
     capacities, at least 1 step) through solver.run_simulation, the
     block kernels' launch
     counts reset just before and read just after (the route launches
     none), no overflow, finite fields, energy drift < 1%, then the step
     by part (rebuild, density summation, acoustic sub-step, resort) with
     each part's peak device memory, one profiled step, each part
     profiled alone (its device time and launches: the pair sums against
     the rebuild) and the run's peak memory, beside phase 5's block-route
     figures; fsi2's gather route to t=0.1 against the CPU and to
     FSI2_GATHER_T_END, held to the JAX gather runs' count band and the tip
     envelope (`fsi2_gather_gates`), its step by part and profiled, and
     each part profiled alone;
 12. entry point and IO (last): the CLI as a subprocess at full width,
     `dambreak_3d_block` (dx=0.01, cap 32, c_max 125,056, 1,000,000 fluid
     particles, B1-B3) and `twisting_column_3d` with engine=lattice
     (dx=0.0175, 1,133,901 sites, L1/L2), two frames each: exit code 0,
     each kernel of the path launched, no chunk's state overflowed (the
     block route's flag false after each chunk; the lattice has none),
     each VTP well-formed with
     NumberOfPoints = NReal and its arrays finite and equal to the run's
     state at %.7g (the whole text, and sampled rows by Python's format),
     each frame's write time and size; then, in process, the ball–shell
     collision to t=2 held by the port's DTWRegressionTest to
     tests/golden/ball_shell_collision_3d (no particle past r = 2 + dx/2,
     no overflow; the step profiled, contact and solid parts alone), the
     2D gather dambreak at dx=0.05 to t=3.6 (its energy and wall-pressure
     probe held to tests/golden/dambreak_2d), a restart written at t=1.2,
     read back and continued to t=2.4 against the uninterrupted run, and
     a planted velocity violation that must dump one VTP a body and make
     solver.run_simulation raise.
 13. open boundaries and the fish: the T-pipe to t=1 (past the
     emitter's first clones), the fish in vacuum at dx=0.01 for 200
     steps and the fish FSI at dx=0.01 to t=0.02, float64, on the card
     against the CPU (equal counts, identical Alive and Indicator masks,
     positions within 1e-9 of max|x|); then, float32, through build_case -> init_sim ->
     make_run_chunk -> solver.run_simulation, every launch count reset
     just before and read just after (the routes launch no hand kernel):
     fish_fsi_2d at dx=0.0025 to t=0.05 (no overflow, finite fields, the
     fish inside the channel, the outlet columns deleted, the counts
     within 20% of the JAX package's own float32 counts,
     tests/golden_torch/fish_fsi/jax_f32_counts.json) and the T-pipe to
     t=2 (the emitter injected, no overflow); each step and each part
     (rebuild, surface indication, density, acoustic sub-step, solid
     sub-step, emitter and disposer) timed, profiled alone, its host
     reads counted and its bound computed from the run's lists and
     fields (`list_bound`, as for the torch-op pair sums of phases 11
     and 12).
 14. articulated and 3a: each new case at a small size in float32
     on the card against the port's float64 CPU run from the same build
     (equal counts after a fixed number of advection steps, positions
     within 1e-5 of max|x|, the tethered fish's (q, u) within 1e-3 of
     their max), and the filling tank through its injections in float64
     on both (1e-9); play_simbody's first 3 steps in float64 (its final
     q and u on the closed-form motions within 1e-12, the restart from
     step 2 bit for bit, one RK4 sub-step profiled); then, every launch
     count reset just before and read just after, the tethered fish at
     full width and the 3a cases at their default widths through
     build_case -> init_sim -> make_run_chunk -> solver.run_simulation
     (no overflow, finite fields,
     the fish in the channel, the tank injecting), and one advection step
     and each part alone (the fish: rebuild, indication and density,
     acoustic sub-step, solid sub-step, one articulated RK4 step, emitter
     and disposer; the 3a cases: an acoustic sub-step) timed, profiled,
     its host reads counted and its bound computed (`list_bound`).
 15. the kernel-corrected fluid and the remaining solid laws (last): the
     ten cases of ROADMAP A items 3b-3c (standing wave, Poiseuille, the
     impact and rotating patches, the oscillating beams with the PK2 and
     the Cauchy integrators, the self-contacting beam, the passive
     cantilever, the activated muscle cube, the anisotropic beam), each at
     its JAX default width: built in float64 on the card and the same
     state cast to float32, a few steps on each (equal counts, positions
     within 1e-5 of max|x|, the velocities' difference printed); then,
     float32, through build_case -> init_sim -> make_run_chunk ->
     solver.run_simulation with every launch count reset just before and
     read just after (no overflow, finite fields, the case's observable
     printed), and one step and, for the fluid, an acoustic sub-step, the
     correction matrix and the corrected first half alone, each timed,
     profiled, its host reads counted and its bound computed.
 16. the multi-phase fluid and the rigid bodies: the eight cases
     of ROADMAP A item 3d and the rigid-body family of item 4 (the
     two-phase dambreak, the square, impacting and cubic droplets, the
     floating block, stfb, OWSC, the focused wave on the moored
     structure), each at its JAX default width: built in float64 on the
     card and the same started state cast to float32 (the wave cases
     just before their release), A7D_F32's steps on each (equal counts,
     the displacement and the velocity within their tolerances of their
     float64 max); then, float32, through build_case -> init_sim ->
     make_run_chunk -> solver.run_simulation (stfb and the wave cases
     with a 0.004 s hold, so that the run crosses the release), every
     launch count reset just before and read just after, and one
     advection step, one acoustic sub-step and its parts (the contact
     first half, the surface tension, the rigid or pin update, the
     wavemaker, the tethers) alone, each timed, profiled, its host
     reads counted and its bound computed.
 17. the damping family (last): the seven cases of ROADMAP A item 4's
     second family (the colliding balls, the sliding cube, the damped
     neo-Hookean cantilever, the stretched plastic bar, the muscle and
     its sliding plate, the rigid-ended twisting bar, the slender beam),
     each at its JAX default width and dtype: the five float32 ones
     built in float64 and cast to float32, A7E_F32's steps on each;
     then through build_case -> init_sim -> make_run_chunk ->
     solver.run_simulation, every launch count reset just before and
     read just after, and one step and its parts (the damping, the
     plastic first half, stretching's macro step of 26 sub-steps, the bar
     sub-step) alone, each timed, profiled, its host reads counted and
     its bound computed; then damping_implicit_cg on
     the card against the CPU on tests/test_dissipation.py's lattice
     (equal iteration counts, the difference within A7E_CG_TOL, no host
     read in the solve).
 18. the continuum family (last): the six cases of ROADMAP A item 4's
     third family (the column collapse, the cohesive soil, the repose
     pile, the UL beam, the spinning plate, the Taylor bar), each at its
     JAX default width: built in float64 on the card and the same started
     state cast to float32, A7F_F32's advection steps on each (equal
     counts, the displacement x - x0 and the velocity within their
     tolerances of their float64 max); then, float32, through build_case
     -> init_sim -> make_run_chunk -> solver.run_simulation, every launch
     count reset just before and read just after (no overflow, finite
     fields, the case's observable printed), and one advection step and
     its parts (the stress diffusion and the plastic halves; the
     correction matrix and the hourglass halves) alone, each timed,
     profiled, its host reads counted and its bound computed.
 19. the small fluid modules and the plain diffusion family: the
     nine cases of ROADMAP A items 2 and 4a, each at its JAX default
     width: built in float32 on the card and in float64 on the CPU,
     A7G_F32's steps on each (equal counts, the displacement x - x0, the
     velocity and the case's species within their tolerances of their
     float64 max; the thermal optimisation's steady field and a few Adam
     steps); then, float32 (the optimisation float64, its default),
     through the public entry points (build_case -> init_sim ->
     make_run_chunk -> solver.run_simulation; the optimisation's
     optimize_conductivity), every launch count reset just before and
     read just after, and one step and its new parts (the variable
     viscosity, the CG damping and the Oldroyd-B halves, the Windkessel
     update, the buffer exchange and pressure conditions, the RK2
     diffusion, the reaction, the solve with its gradient) alone, each
     timed, profiled, its host reads counted and its bound computed.
 20. the shell family: the eight cases of ROADMAP A item 3, each at its
     JAX default width and dtype: the card against the CPU from the same
     built state (A7H_CPU's steps: the displacement x - x0 and the
     velocity of each body within their tolerances of its own max; the
     three rings from the main path's end, in contact); then through the
     public entry points, every launch count reset just before and read
     just after (no overflow, finite fields, the observable printed), and
     one step and its parts (the shell halves, the tie mappings, the
     dummy stacks, the surface contact, the gate's sub-step) alone, each
     timed, profiled, its host reads counted and its bound computed; the
     loaded gate's sub-step as a CUDA graph against eager and the card
     against the CPU; the CVT on the card against the CPU.
 21. the rest of the diffusion family and the Eulerian fluid: the
     four cases of ROADMAP A item 4 and item 5's first half, each at its
     JAX default width: built in float64 on the CPU and the same started
     state cast to float32 on the card, A7I_F32's steps on each (equal
     counts but the heart's mechanics sub-steps, which may differ by one
     a step at float64's roundoff; the quantities within their
     tolerances of their float64 max); then, float32, through
     build_case -> init_sim -> make_run_chunk -> solver.run_simulation,
     every launch count reset just before and read just after (no
     overflow, finite fields, the observable printed), and one step and
     its new parts (the water entry's prep, sub-step and wetting; the
     tree's electrophysiology and the mechanics sub-steps; the local
     directional rate and the cavity's flow rate; the HLLC halves and the
     viscous force) alone, each timed, profiled, its host reads counted
     and its bound computed.
 22. the FVM front end and the multi-resolution family: the seven
     cases of ROADMAP A items 5b and 6, each at its JAX default width
     (the 3D channel on a generated 64 x 40 x 2 hex channel, 5,120 cells,
     the ICEM mesh not being in the repository): the FVM cases built in
     float32 on the card and in float64 on the CPU, ten steps each, the
     change of each field within ten times the JAX package's own float32
     spread from its float64 (tests/golden_torch/fvm/jax_f32_spread.json);
     the MR cases as phase 21's, A7J_MR_F32's steps and tolerances; then,
     float32, through build_case -> init_sim -> make_run_chunk ->
     solver.run_simulation as phase 21's, and one step and its new parts
     (the face states with their Riemann or HLLC flux, `_cell_reduce`,
     the MUSCL reconstruction, the ghosts, the multi-level list build,
     the adaptive halves, the open boundaries) alone, each timed,
     profiled, its host reads counted and its bound computed.
 23. the level sets, the relaxations and the k-epsilon turbulence
     (last): the four cases of ROADMAP A items 7 and 8 at their JAX
     default widths (the static confinement's 3,200 water particles and
     two level sets, the channel's 160 + 64, the shell annulus's 315 on
     its 0.1-spaced level set, the implicit relaxation on a NACA 0012
     stand-in of chord 4, 820 particles, the turbine blade's file not
     being in the repository): float32 on the card against float64 on
     the CPU (phase 21's check; the relaxations from one jittered start),
     then through build_case -> init_sim -> make_run_chunk ->
     solver.run_simulation or run_case, and one step or iteration and its
     new parts (the level-set probes and the surface bounding, the
     wall-function correction, the K and Epsilon equations, the implicit
     update, the normal prediction) alone, each timed, profiled, its host
     reads counted and its bound computed.
 24. the block engine on a ring of ranks and the modules with no case
     caller (last): the 2D dambreak at dx = 0.0025 (~320k particles) on
     a ThreadRing of RING_RANKS ranks sharing the card, through
     parallel/block_domain.py's distribute_block_engine ->
     make_distributed_engine_step, RING_STEPS advection steps, every
     launch count reset just before and read just after (B1-B3 each
     launched), against the single-device block engine from the same
     start (equal acoustic sub-step counts, the time to rtol 1e-12, every
     OriginalID once, positions within RING_POS_TOL of the domain length,
     velocities within RING_VEL_TOL of their largest component); the
     same from the start with seeded noise, where a skipped ghost
     refresh shows (positions within RING_NOISY_DISP_TOL of the largest
     displacement, velocities within RING_NOISY_VEL_TOL);
     B1-B3 against their plain versions on the inputs the last ring step
     gave the rank with the most ghost slots (times, bound); one ring
     step and one
     single-device step profiled; then the porous solid, the
     optimisation's gradient, the image SDF and the PK2 lattice first
     half in float32 on the card against float64 on the CPU, within
     CALLER_FREE_FACTOR times the CPU's own float32 error.

Every kernel and plain-version time is taken by
sphinxsys_tpu_torch.benchmarks.median_ms, the layout drivers' timer.  Its last two lines are a JSON object of per-kernel
results and {"ok": true, "device": {...}}.  Any failed check exits
non-zero before printing them.  Imports no JAX.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
KERNELS = {  # wrapper name -> (TPU kernel it replaces, launch-counter key)
    "density_sweep": ("sphinxsys_tpu/ops/pallas_block2.py:493", "density"),
    "ac1_sweep": ("sphinxsys_tpu/ops/pallas_block2.py:98", "ac1"),
    "ac2_sweep": ("sphinxsys_tpu/ops/pallas_block2.py:177", "ac2"),
    "visc_tvc_sweep": ("sphinxsys_tpu/ops/pallas_block2.py:373", "visc_tvc"),
}
SOURCE = "sphinxsys_tpu_torch/csrc/block_sweeps.cu"
PACKED_KERNELS = {  # packed_sweeps wrapper -> (TPU kernel, launch-counter key)
    "ac1_inner_sweep": ("sphinxsys_tpu/ops/pallas_sweep.py:77", "ac1_inner"),
    "ac2_inner_sweep": ("sphinxsys_tpu/ops/pallas_sweep.py:98", "ac2_inner"),
    "ac1_wall_sweep": ("sphinxsys_tpu/ops/pallas_sweep.py:239", "ac1_wall"),
    "ac2_wall_sweep": ("sphinxsys_tpu/ops/pallas_sweep.py:267", "ac2_wall"),
}
PACKED_SOURCE = "sphinxsys_tpu_torch/csrc/packed_sweeps.cu"
# float operations per real pair, counted from csrc/packed_sweeps.cu (add,
# mul, compare, min/max, sqrt and division one each): the pair geometry and
# masked dW/dr 20, then each kernel's own terms
PACKED_PAIR_FLOPS = {"ac1_inner_sweep": 31, "ac2_inner_sweep": 38,
                     "ac1_wall_sweep": 42, "ac2_wall_sweep": 49}
PACKED_DX = 0.0025          # the 2D dambreak at its bench width, cap 16
LAYOUT_KERNELS = {  # layout_sweeps wrapper -> (TPU kernel, launch-counter key)
    "ac1_flat_sweep": ("benchmarks/exp_layout.py:93", "ac1_flat"),
    "ac1_t_sweep": ("benchmarks/exp_layout2.py:80", "ac1_t"),
}
LAYOUT_SOURCE = "sphinxsys_tpu_torch/csrc/layout_sweeps.cu"
# float operations per real pair, counted from csrc/layout_sweeps.cu as
# PACKED_PAIR_FLOPS: the pair geometry 8, the masked dW/dr * V_j 12, the
# force 7 and the density term 4 (B7's rsqrt and r2 * inv_r stand for B6's
# sqrt and division; B7's per-window sums are not per pair).  Kept as the
# first designs were bounded, so that the bounds of all designs compare.
LAYOUT_PAIR_FLOPS = 31
# the channel planes B7 reads (csrc/layout_sweeps.cu ac1_t_kernel; channels
# of ops/packed_sweeps): of xi_t x, y, p and mask, whole; of xj_t the mask,
# whole, and x, y, p and vol on the j-rows its tiles stage
B7_XI_CHANNELS = (0, 1, 4, 6)
B7_XJ_STAGED = (0, 1, 4, 5)
LATTICE_KERNELS = {  # lattice_sweeps wrapper -> (what it stands in for, counter key)
    "lattice_force": ("sphinxsys_tpu/physics/solid_lattice.py:285 (the tap loop "
                      "of decomposed_integration_1st_half_lattice :241; "
                      "XLA-fused, no Pallas kernel)", "lattice_force"),
    "lattice_dfdt": ("sphinxsys_tpu/physics/solid_lattice.py:335 (the tap loop "
                     "of integration_2nd_half_lattice :314; XLA-fused, no "
                     "Pallas kernel)", "lattice_dfdt"),
}
LATTICE_SOURCE = "sphinxsys_tpu_torch/csrc/lattice_sweeps.cu"
SOLID_DX = 0.0175          # the bench's lattice solid (bench.py:330)
SOLID_STEPS = 40           # bench.py's BENCH_STEPS
SOLID_GOLDEN = ("tests/golden/refdb/twisting_column_3d/"
                "MyObserver_Position_Run_0_result.xml")
# the leading snapshots of SOLID_GOLDEN that the JAX package's own float32
# run (CPU) reproduces within 0.1; it leaves the curve after them, and ends
# after 140 snapshots where the curve has 142
# (tests/test_torch_solid_lattice.py::test_golden_tip_curve_span)
GOLDEN_HELD = 99
# the JAX package's own float32 lattice run on the CPU, written by
# tests/test_torch_solid_lattice.py (140 snapshots), and how far the card's
# run may stray from it over all of them (measured gaps: PERF.md section 6)
JAX_CURVE = "tests/golden_torch/twisting_column_3d/tip_x.json"
JAX_CURVE_BOUND = 0.05
# the gather solid at the bench's dx (phase 10): steps from the lattice main
# path's state, and how far its positions may stray from that path's, of
# max|x| (float32 sums in other orders, B formed in float32 where the
# lattice forms it in float64 and rounds it)
GATHER_STEPS = 5
GATHER_POS_TOL = 1e-5
# fsi2 (phase 9) at its reference resolution: B1-B4 held on the state at
# FSI2_MID; the kernel and block-form routes to FSI2_SHORT, held to
# FSI2_SHORT_TOL (absolute, in positions and velocities: float32 sums in
# other orders, measured 3.1e-6 in velocity on the CPU); the kernels to
# FSI2_T_END, held to the spread of the JAX package's own float32 runs
# (FSI2_JAX_RUNS, `fsi2_gates`)
FSI2_DX = 0.1
FSI2_MID = 0.5
FSI2_SHORT = 0.1
FSI2_SHORT_TOL = 5e-5
FSI2_T_END = 2.5
FSI2_SAMPLE = 0.05
FSI2_JAX_RUNS = "tests/golden_torch/fsi2/jax_f32_runs.json"
FSI2_COUNT_BAND = 0.2
# the gather fluid (phase 11): the dambreaks at the block route's widths,
# the 2D one resorted every 2nd advection step; the third oracle's scenes
# (tests/test_scene_engines.py)
GATHER_CONFIGS = {
    "2d": dict(module="dambreak_2d", dx=0.0025, min_adv=4, sort_every=2),
    "3d": dict(module="dambreak_3d", dx=0.01, min_adv=1, sort_every=None),
}
# the gather step's parts: the timing repetitions of the advection step and
# of each other part
GATHER_REPS = (1, 2)
# fsi2's gather route runs to here (phase 9's block route to FSI2_T_END),
# held to the JAX gather runs' counts at their first sample past it
FSI2_GATHER_T_END = 1.25
GATHER_ORACLE_SCENES = (
    ("dambreak_2d", 0.1, 0.30, dict(cap=16)),
    ("dambreak_3d", 0.2, 0.20, dict(cap=48)),
    ("taylor_green_2d", 0.05, 0.05, {}),
)
DEVICE = "cuda"
# the host sleep at each end of a profiled window and the marker kernels
# that open it; (tag, launches, attempts, the markers held, leading markers
# recorded) of each profiled step (`profile_step`)
PROFILE_PAD_S = 0.02
PROFILE_GUARD = 256
PROFILED = []
DAMBREAK_KERNELS = ("density_sweep", "ac1_sweep", "ac2_sweep")
CONFIGS = {  # the bench configs (bench.py:311-318), Taylor–Green at 1M
    "2d": dict(module="dambreak_2d", dx=0.0025, kw={}, min_adv=5,
               kernels=DAMBREAK_KERNELS, energy="mechanical", noise=False),
    "3d": dict(module="dambreak_3d", dx=0.01, kw={"cap": 32, "c_max": 125_000},
               min_adv=2, kernels=DAMBREAK_KERNELS, energy="mechanical",
               noise=False),
    "tg": dict(module="taylor_green_2d", dx=0.001, kw={}, min_adv=10,
               kernels=tuple(KERNELS), energy="kinetic", noise=True),
}
# The arrays each kernel reads, by position in its wrapper's arguments:
# (fluid block arrays, wall block arrays, window maps, fluid arrays that
# only its wall branch reads).  A None argument (a static wall's velocity
# or acceleration channel) is not read.
READS = {
    "density_sweep": ((0, 1), (3, 4), (2, 5), ()),
    "ac1_sweep": ((0, 1, 2, 3, 4), (6, 7, 8), (5, 9), (2, 3)),
    "ac2_sweep": ((0, 1, 2), (4, 5, 6, 7), (3, 8), ()),
    "visc_tvc_sweep": ((0, 1, 2), (4, 5, 6), (3, 7), ()),
}
# published H100 SXM peaks (NVIDIA data sheet), at the 700 W limit
PEAK_F32_FLOPS = 67e12      # float32 outside the tensor cores
PEAK_HBM_BYTES = 3.35e12
# the CUDA kernels' names, for the profile's sweep share
SWEEP_KERNEL_NAMES = ("density_kernel", "ac1_kernel", "ac2_kernel",
                      "visc_tvc_kernel", "ac1_inner_kernel", "ac2_inner_kernel",
                      "ac1_wall_kernel", "ac2_wall_kernel", "ac1_flat_kernel",
                      "ac1_t_kernel", "lattice_force_kernel",
                      "lattice_dfdt_kernel")


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(f"[chip_smoke] {msg}", flush=True)


def wall_s(torch, fn, reps):
    """Median host wall time (s) of fn() ending in a device sync: `reps`
    runs after a warm-up one, or the first alone where it takes over 2 s
    (the tether's advection step)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if times[0] > 2.0:
            break
    return statistics.median(times)


def real_pairs(torch, pos, mask, nbr, box, cutoff, wall_pos=None,
               wall_mask=None, nbr_wall=None, chunk=8192):
    """(fluid-fluid, fluid-wall) ordered pairs of real particles closer
    than the cutoff (the self pair counted), from the block map."""
    c = nbr.shape[0]
    periodic = [(k, float(b)) for k, b in enumerate(box) if b > 0.0]

    def count(src_pos, src_mask, table):
        n = torch.zeros((), dtype=torch.int64, device=pos.device)
        for c0 in range(0, c, chunk):
            c1 = min(c0 + chunk, c)
            xi, mi = pos[c0:c1, :, None, :], mask[c0:c1, :, None]
            for w in range(table.shape[1]):
                rows = table[c0:c1, w].long()
                d = xi - src_pos[rows][:, None]
                for k, length in periodic:
                    d[..., k] -= length * torch.round(d[..., k] / length)
                near = torch.sum(d * d, dim=-1) < cutoff * cutoff
                n += torch.sum(near & mi & src_mask[rows][:, None, :])
        return int(n)

    inner = count(pos, mask, nbr)
    wall = count(wall_pos, wall_mask, nbr_wall) if nbr_wall is not None else 0
    return inner, wall


def pair_flops(name, dim, n_periodic, wall=False):
    """Float operations per real pair of a kernel, counted from its source
    (add, mul, compare, sqrt, rsqrt and division one each; the minimum image
    four per periodic axis; the Wendland dW/dr*V_j block 11)."""
    geom = 3 * dim + 4 * n_periodic
    if name == "density_sweep":
        return geom + 14
    if name == "ac1_sweep":
        return geom + 11 + ((5 * dim + 10) if wall else (2 * dim + 6))
    if name == "ac2_sweep":
        return geom + 11 + ((12 * dim + 10) if wall else (6 * dim + 8))
    return geom + 11 + ((4 * dim + 5) if wall else (5 * dim + 4))


def read_bytes(torch, name, args, out):
    """Bytes one call must move: the output written once, and once each
    array that the launched variant reads (READS) — of a block array the
    rows its window map reaches, of a window map all of it."""
    fluid, wall, maps, wall_only = READS[name]
    nbr, nbr_w = (args[i] for i in maps)

    def rows_reached(table, n_rows):
        return int(torch.unique(table[table < n_rows]).numel())

    def row_bytes(a):
        return a[0].numel() * a.element_size()

    total = out.numel() * out.element_size() + sum(
        t.numel() * t.element_size() for t in (nbr, nbr_w) if t is not None)
    n_f = rows_reached(nbr, nbr.shape[0])
    total += sum(n_f * row_bytes(args[i]) for i in fluid
                 if nbr_w is not None or i not in wall_only)
    if nbr_w is not None:
        n_w = rows_reached(nbr_w, args[wall[0]].shape[0] - 1)
        total += sum(n_w * row_bytes(args[i]) for i in wall
                     if args[i] is not None)
    return total


def bound(torch, name, args, out, scene, sim):
    """The least time the card could take for one call (ms): the larger of
    the bytes it must move (`read_bytes`) over the HBM rate and the flops
    of the real pairs it evaluates over the float32 rate.  Returns (ms,
    "bytes"|"operations", real pairs, flops, bytes)."""
    from sphinxsys_tpu_torch.benchmarks import wall_blocks

    eng, wb = scene.eng, wall_blocks(scene, sim)
    nbytes = read_bytes(torch, name, args, out)
    inner, wall = real_pairs(
        torch, args[0], sim.fluid_b["SlotMask"], sim.nbr_inner, eng.box,
        eng.kernel.cutoff, None if wb is None else wb["Position"],
        None if wb is None else wb["SlotMask"], sim.nbr_wall)
    n_per = sum(1 for b in eng.box if b > 0.0)
    flops = inner * pair_flops(name, eng.dim, n_per) + wall * pair_flops(
        name, eng.dim, n_per, wall=True)
    return (*bytes_or_flops(nbytes, flops), inner + wall, flops, nbytes)


def channels(torch, out):
    """A sweep's output as one (C, cap, k) tensor: the packed sweeps return
    (a, b) pairs of (C, cap) / (C, cap, 2) tensors."""
    if torch.is_tensor(out):
        return out
    return torch.cat([a if a.dim() == 3 else a[..., None] for a in out], dim=-1)


def hold(torch, what, got, ref32, ref64, real):
    """A kernel's output `got` against a float32 reference `ref32` and the
    float64 plain version `ref64` of the same function on the same inputs.

    Tolerance, per output channel over the real slots: the kernel's error
    against the float64 plain version must be at most twice the float32
    reference's own error against it, plus 1e-6 * max|ref| — both sum the
    same f32 pair terms in different orders, and the ac1 force cancels
    terms far larger than the sum, so only an error scale measured on the
    same data is meaningful.  As a gross-error guard the kernel must also
    agree with the f32 reference to 1e-3 * max|ref|.  Returns
    max|k - p32|."""
    max_abs = 0.0
    for ch in range(got.shape[-1]):
        k = got[..., ch][real].double()
        p32 = ref32[..., ch][real].double()
        p64 = ref64[..., ch][real]
        scale = float(p64.abs().max())
        err_k = float((k - p64).abs().max())
        err_p = float((p32 - p64).abs().max())
        err_kp = float((k - p32).abs().max())
        max_abs = max(max_abs, err_kp)
        log(f"{what} ch{ch}: max|ref|={scale:.6e} |k-p32|={err_kp:.3e} "
            f"|k-p64|={err_k:.3e} |p32-p64|={err_p:.3e}")
        check(bool(torch.isfinite(k).all()), f"{what} ch{ch}: non-finite")
        check(err_k <= 2.0 * err_p + 1e-6 * scale,
              f"{what} ch{ch}: kernel error {err_k:.3e} vs f64 exceeds "
              f"2x the f32 reference's error {err_p:.3e} + 1e-6 max|ref|")
        limit = 1e-3 * max(scale, 1e-30)
        check(err_kp <= limit,
              f"{what} ch{ch}: kernel vs f32 reference {err_kp:.3e} > {limit:.3e}")
    return max_abs


def compare(torch, what, name, args, kw, real, module=None):
    """One kernel against its plain version on the same inputs, under
    `hold`'s criterion (the f32 reference is the plain version run in
    float32).  Returns (kernel output, max|k - p32|)."""
    from sphinxsys_tpu_torch.ops import block_sweeps as bs

    module = bs if module is None else module
    wrapper, plain = getattr(module, name), getattr(module, name + "_plain")
    got = channels(torch, wrapper(*args, **kw))
    torch.cuda.synchronize()
    ref32 = channels(torch, plain(*args, **kw))
    args64 = [a.double() if torch.is_tensor(a) and a.is_floating_point()
              else a for a in args]
    ref64 = channels(torch, plain(*args64, **kw))
    return got, hold(torch, f"{what} {name}", got, ref32, ref64, real)


def compare_kernels(torch, tag, cfg, scene, sim, results):
    """Phase 3: every kernel of the path against its plain version on the
    same inputs, its times and its bound."""
    from sphinxsys_tpu_torch.benchmarks import median_ms, sweep_inputs
    from sphinxsys_tpu_torch.ops import block_sweeps as bs

    c = sim.nbr_inner.shape[0]
    real = sim.fluid_b["SlotMask"][:c]
    inputs = sweep_inputs(scene, sim, cfg["kernels"])
    for name, (args, kw) in inputs.items():
        wrapper, plain = getattr(bs, name), getattr(bs, name + "_plain")
        got, max_abs = compare(torch, tag, name, args, kw, real)
        ms = median_ms(lambda: wrapper(*args, **kw), 20, DEVICE)
        plain_ms = median_ms(lambda: plain(*args, **kw), 3, DEVICE)
        bound_ms, bound_by, pairs, flops, nbytes = bound(
            torch, name, args, got, scene, sim)
        log(f"{tag} {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by}: {pairs} real pairs, "
            f"{flops:.4e} flop, {nbytes} B), max_abs_err {max_abs:.3e}")
        results[f"{name}[{tag}]"] = dict(
            max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by, real_pairs=pairs)
        evaluated, split = slot_pairs_evaluated(torch, name, args,
                                                sim.fluid_b["SlotMask"])
        log(f"{tag} {name}: {evaluated} lane x slot pairs evaluated "
            f"(G={lane_group(args[0].shape[1])}; {pairs} real pairs; "
            f"{split:.3f} of the cells split), "
            f"{ms * 1e9 / evaluated:.4f} ps each")


def moving_wall_check(torch, tag, scene, sim):
    """The moving-wall kernel variants (wall velocity / acceleration
    channels present) against their plain versions on the same inputs
    with seeded non-zero wall kinematics; and B4, which the dambreak does
    not run, with the static and the moving wall on the same inputs."""
    from sphinxsys_tpu_torch.benchmarks import sweep_inputs

    g = torch.Generator(device=DEVICE).manual_seed(7)
    wb = scene.wall_b
    wvel = torch.randn(wb["Position"].shape, generator=g, device=DEVICE) * 0.1
    wacc = torch.randn(wb["Position"].shape, generator=g, device=DEVICE)
    c = sim.nbr_inner.shape[0]
    real = sim.fluid_b["SlotMask"][:c]
    inputs = sweep_inputs(scene, sim, tuple(KERNELS))
    cases = [("ac1_sweep", 8, wacc), ("ac2_sweep", 6, wvel)]
    if tag == "2d":
        cases += [("visc_tvc_sweep", None, None), ("visc_tvc_sweep", 6, wvel)]
    for name, slot, extra in cases:
        args, kw = inputs[name]
        args = list(args)
        what = f"{tag} static-wall" if slot is None else f"{tag} moving-wall"
        if slot is not None:
            args[slot] = extra
        compare(torch, what, name, args, kw, real)
        log(f"{what} {name}: agrees with its plain version")


def lane_group(cap):
    """Lanes per cell of the block-sweep kernels (csrc/block_sweeps.cu)."""
    return 16 if cap <= 16 else 32


def slot_pairs_evaluated(torch, name, args, real):
    """(lane x slot pairs a block sweep evaluates, share of split cells)
    from the block map: for every cell and i-chunk of G lanes holding a
    real slot, G times the real j-slots (VOL > 0; B1's fluid rows: mask)
    of its live windows, fluid and wall; a cell whose real i-slots fit in
    half the group splits them between its halves (evaluating about half
    as many per lane)."""
    fluid, wall, maps, _ = READS[name]
    nbr, nbr_w = (args[i] for i in maps)
    vol = args[fluid[-1]]
    c, cap = nbr.shape[0], vol.shape[1]
    g = lane_group(cap)
    n_j = (vol > 0).sum(dim=1)
    per_cell = n_j[nbr.long()].sum(dim=1)
    if nbr_w is not None:
        per_cell = per_cell + (args[wall[1]] > 0).sum(dim=1)[nbr_w.long()].sum(dim=1)
    chunks = torch.stack([real[:c, i0:i0 + g].any(dim=1)
                          for i0 in range(0, cap, g)], dim=1)
    live = chunks.sum(dim=1)
    split = ~real[:c, g // 2:].any(dim=1) & (live > 0)
    return (int((per_cell * live).sum()) * g,
            float(split.sum()) / max(int((live > 0).sum()), 1))


def swap_holes(torch, name, args, mask, wall_mask):
    """Block-sweep arguments with, in every row whose first slot is real
    and last slot padding, the two slots' data swapped (fluid and wall
    blocks; every array in READS, B1's mask too): padding then sits
    mid-row and a real slot in the last i-chunk.  Returns (args, the fluid
    slot mask after the swap)."""
    fluid, wall, _, _ = READS[name]
    args = list(args)

    def perm(m):
        cap = m.shape[1]
        idx = torch.arange(cap, device=m.device).repeat(m.shape[0], 1)
        swap = m[:, 0] & ~m[:, -1]
        idx[swap, 0] = cap - 1
        idx[swap, -1] = 0
        return idx

    for ids, m in ((fluid, mask), (wall, wall_mask)):
        idx = perm(m)
        for i in ids:
            a = args[i]
            if a is not None:
                ix = idx if a.dim() == 2 else idx[..., None].expand_as(a)
                args[i] = torch.gather(a, 1, ix).contiguous()
    return args, torch.gather(mask, 1, perm(mask))


def padding_checks(torch, tag, scene, sim, g):
    """B1-B4 with padding where the first design never met it, each against
    its plain version on the same inputs (B2/B3 with a moving wall, B4 with
    a static and a moving one): `holes`, a real slot swapped with its row's
    last padding slot, fluid and wall (padding mid-row); `near padding`,
    every padding position moved into the support of its row's first slot
    (jitter up to h/2), VOL and mask kept 0, whose real slots must stay
    within 1e-6 max|out| of the run without the move."""
    from sphinxsys_tpu_torch.benchmarks import sweep_inputs, wall_blocks
    from sphinxsys_tpu_torch.ops import block_sweeps as bs

    wb, fb = wall_blocks(scene, sim), sim.fluid_b
    c = sim.nbr_inner.shape[0]
    real = fb["SlotMask"][:c]
    h = scene.eng.kernel.h
    shape = wb["Position"].shape
    wacc = torch.randn(shape, generator=g, device=DEVICE)
    wvel = 0.1 * torch.randn(shape, generator=g, device=DEVICE)
    inputs = sweep_inputs(scene, sim, tuple(KERNELS))
    cases = (("density_sweep", "", None, None),
             ("ac1_sweep", "", 8, wacc), ("ac2_sweep", "", 6, wvel),
             ("visc_tvc_sweep", " static-wall", 6, None),
             ("visc_tvc_sweep", " moving-wall", 6, wvel))
    for name, wall_kind, slot, extra in cases:
        args, kw = inputs[name]
        args = list(args)
        if slot is not None:
            args[slot] = extra
        what = f"{tag}{wall_kind}"
        holed, mask = swap_holes(torch, name, args, fb["SlotMask"],
                                 wb["SlotMask"])
        compare(torch, f"{what} holes", name, holed, kw, mask[:c])
        log(f"{what} holes {name}: agrees with its plain version")

        near = list(args)
        for i, m in ((0, fb["SlotMask"]), (READS[name][1][0], wb["SlotMask"])):
            p = near[i]
            jitter = (torch.rand(p.shape, generator=g, device=DEVICE) - 0.5) * h
            near[i] = torch.where(m[..., None], p, p[:, :1] + jitter)
        got, _ = compare(torch, f"{what} near-padding", name, near, kw, real)
        ref = getattr(bs, name)(*args, **kw)
        diff = float((got - ref)[real].abs().max())
        scale = float(ref[real].abs().max())
        log(f"{what} near-padding {name}: max |out - out without it| "
            f"{diff:.3e} (max|out| {scale:.3e})")
        check(diff <= 1e-6 * scale,
              f"{what} near-padding {name}: padding leaks into real slots")


def cap40_check(torch):
    """B1-B4 at cap 40 (the 3D dambreak's default, dx=0.05), where the
    lane group sweeps a cell in two i-chunks: against their plain versions
    after one advection step (B4 with the static wall), and with holes
    (`swap_holes`) so that the second chunk holds real slots."""
    from sphinxsys_tpu_torch.benchmarks import sweep_inputs
    from sphinxsys_tpu_torch.cases import dambreak_3d as db
    from sphinxsys_tpu_torch.engine import scene as sc

    t0 = time.perf_counter()
    scene, fluid = db.build_block_case(dx=0.05, device=DEVICE)
    sim = sc.make_advection_step(scene)(sc.init_sim(scene, fluid))
    c, cap = sim.nbr_inner.shape[0], scene.eng.cap
    check(cap > lane_group(cap), f"cap40: cap {cap} fits one i-chunk")
    fb, wb = sim.fluid_b, scene.wall_b
    for name, (args, kw) in sweep_inputs(scene, sim, tuple(KERNELS)).items():
        compare(torch, "3d cap40", name, args, kw, fb["SlotMask"][:c])
        holed, mask = swap_holes(torch, name, args, fb["SlotMask"],
                                 wb["SlotMask"])
        check(bool(mask[:c, lane_group(cap):].any()),
              "cap40: no real slot in the second i-chunk")
        compare(torch, "3d cap40 holes", name, holed, kw, mask[:c])
        log(f"3d cap40 {name}: agrees with its plain version, also with "
            f"real slots in its second i-chunk")
    log(f"cap40: n_fluid={scene.n_fluid} cap={cap} c_max={scene.eng.c_max} "
        f"in {time.perf_counter() - t0:.1f} s")


def tg_dissipative_ac2_check(torch, scene, sim):
    """The Taylor–Green path passes B3 no dissipation (the No solver); B3's
    force channel with the box is held here with the 1st-half acoustic
    solver's constants instead, on the same inputs."""
    from sphinxsys_tpu_torch.benchmarks import sweep_inputs
    from sphinxsys_tpu_torch.physics import fluid_blocks as fbops

    args, kw = sweep_inputs(scene, sim, ("ac2_sweep",))["ac2_sweep"]
    geo, lim_scale = fbops.ac2_dissipation(scene.eng.riemann1)
    kw = dict(kw, rho0c0_geo=geo, lim_scale=lim_scale)
    c = sim.nbr_inner.shape[0]
    compare(torch, "tg acoustic-solver", "ac2_sweep", args, kw,
            sim.fluid_b["SlotMask"][:c])
    log("tg acoustic-solver ac2_sweep: agrees with its plain version")


def energy(gd, cfg, scene, part):
    if cfg["energy"] == "kinetic":
        return float(gd.total_kinetic_energy(part))
    return float(gd.total_mechanical_energy(part, scene.base.gravity))


def run_main_path(torch, tag, cfg, results):
    """Phase 5: the port's main path at full size."""
    from sphinxsys_tpu_torch import solver
    from sphinxsys_tpu_torch.engine import block_fluid as eng_mod
    from sphinxsys_tpu_torch.engine import scene as sc
    from sphinxsys_tpu_torch.ops import block_sweeps as bs
    from sphinxsys_tpu_torch.physics import general as gd

    db = importlib.import_module(f"sphinxsys_tpu_torch.cases.{cfg['module']}")
    t0 = time.perf_counter()
    scene, fluid = db.build_block_case(dx=cfg["dx"], device=DEVICE, **cfg["kw"])
    sim = sc.init_sim(scene, fluid)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    e0 = energy(gd, cfg, scene, sc.blocks_to_particles(scene, sim))
    dt0 = float(eng_mod.advection_dt(scene.eng, sim.fluid_b))
    end_time = (cfg["min_adv"] + 0.5) * dt0
    bs.reset_launch_counts()
    sim, timer = solver.run_simulation(sc.make_run_chunk(scene), sim, end_time,
                                       end_time, verbose=False)
    counts = dict(bs.LAUNCHES)
    torch.cuda.synchronize()

    part = sc.blocks_to_particles(scene, sim)
    e1 = energy(gd, cfg, scene, part)
    drift = abs(e1 - e0) / abs(e0)
    wall_n = scene.base.n_wall if scene.wall_b is not None else 0
    log(f"{tag} main path: n_fluid={scene.n_fluid} n_wall={wall_n} "
        f"grid={scene.eng.grid.shape} c_max={scene.eng.c_max} "
        f"cap={scene.eng.cap} setup {setup_s:.2f} s")
    check(sim.n_adv >= cfg["min_adv"], f"{tag}: only {sim.n_adv} advection steps")
    check(not bool(sim.overflow), f"{tag}: block capacity overflow")
    for k in ("Position", "Velocity", "Density", "Pressure"):
        check(bool(torch.isfinite(part[k]).all()), f"{tag}: non-finite {k}")
    if cfg["energy"] == "kinetic":
        check(e1 < e0, f"{tag}: kinetic energy did not fall ({e0} -> {e1})")
    else:
        check(drift < 0.01, f"{tag}: energy drift {drift:.3e} >= 1%")
    for name in cfg["kernels"]:
        key = KERNELS[name][1]
        check(counts[key] > 0, f"{tag}: kernel {name} never launched")
        results[f"{name}[{tag}]"]["launches"] = counts[key]
    integ = timer.totals["integrate"]
    log(f"{tag} main path: n_adv={sim.n_adv} n_ac={sim.n_ac} t={float(sim.time):.6e} "
        f"energy {e0:.9e} -> {e1:.9e} (change {drift:.3e}) launches {counts}")
    log(f"{tag} main path: {integ / sim.n_adv * 1e3:.3f} ms per advection step "
        f"({sim.n_ac / sim.n_adv:.2f} acoustic sub-steps each), wall clock")

    # where an advection step's time goes (host wall clock, synchronised)
    wc = eng_mod.WallCtx(scene.wall_b, sim.nbr_wall)
    eng, fb, nbr = scene.eng, sim.fluid_b, sim.nbr_inner
    dt_adv = eng_mod.advection_dt(eng, fb)

    def acoustic_substep():
        dt = eng_mod.acoustic_dt(eng, fb, dt_adv)
        f = eng_mod.acoustic_first_half(eng, fb, nbr, wc, dt)
        eng_mod.acoustic_second_half(eng, f, nbr, wc, dt)

    flat = {k: fb[k].reshape((-1,) + tuple(fb[k].shape[2:])) for k in scene.fields}
    valid = fb["SlotMask"].reshape(-1)
    parts = {
        "advection_step": wall_s(torch, lambda: sc.make_advection_step(scene)(sim), 3),
        "advection_dt": wall_s(torch, lambda: eng_mod.advection_dt(eng, fb), 5),
        "prep": wall_s(torch, lambda: eng_mod.advection_prep(eng, fb, nbr, wc), 5),
        "acoustic_substep": wall_s(torch, acoustic_substep, 5),
        "reslot": wall_s(torch, lambda: sc._slot(scene, flat, valid, sim.aux), 5),
    }
    log(f"{tag} step parts (ms, wall clock): "
        + ", ".join(f"{k} {v * 1e3:.3f}" for k, v in parts.items()))
    results[f"_{tag}_main"] = dict(
        n_adv=sim.n_adv, n_ac=sim.n_ac, ms_per_adv=integ / sim.n_adv * 1e3,
        parts_ms={k: v * 1e3 for k, v in parts.items()}, energy_change=drift)
    return scene, sim


def small_reference_check(torch, module, dx, t_end):
    """A whole slice at a small size on the card (the CUDA kernels) against
    the same run on the CPU (the sweeps' plain versions, which the CPU tests
    hold to the JAX package's Pallas path within 5e-5): equal step counts,
    positions by particle within 5e-5."""
    from sphinxsys_tpu_torch.engine import scene as sc

    case = importlib.import_module(f"sphinxsys_tpu_torch.cases.{module}")
    runs = {}
    for dev in (DEVICE, "cpu"):
        scene, fluid = case.build_block_case(dx=dx, device=dev)
        sim = sc.make_run_chunk(scene)(sc.init_sim(scene, fluid), t_end)
        runs[dev] = (sim, sc.blocks_to_particles(scene, sim)["Position"].cpu())
    (gs, gp), (cs, cp) = runs[DEVICE], runs["cpu"]
    err = float((gp - cp).abs().max())
    log(f"small reference: {module} dx={dx} to t={t_end} card n_adv={gs.n_adv} "
        f"n_ac={gs.n_ac}, cpu n_adv={cs.n_adv} n_ac={cs.n_ac}, "
        f"max |dpos| {err:.3e}")
    check((gs.n_adv, gs.n_ac) == (cs.n_adv, cs.n_ac),
          f"small reference {module}: step counts differ")
    check(err <= 5e-5, f"small reference {module}: positions differ by {err:.3e}")


def tg_decay_check(torch):
    """Taylor–Green at the reference case's size (dx=0.01, 10,000
    particles) to t=0.1: the kinetic energy within 8% of
    KE0 exp(-16 pi^2 nu t) (the criterion of tests/test_block_engine.py)."""
    from sphinxsys_tpu_torch.cases import taylor_green_2d as tg
    from sphinxsys_tpu_torch.engine import scene as sc
    from sphinxsys_tpu_torch.physics import general as gd

    scene, fluid = tg.build_block_case(dx=0.01, device=DEVICE)
    sim = sc.init_sim(scene, fluid)
    ke0 = float(gd.total_kinetic_energy(sc.blocks_to_particles(scene, sim)))
    sim = sc.make_run_chunk(scene)(sim, 0.1)
    ke = float(gd.total_kinetic_energy(sc.blocks_to_particles(scene, sim)))
    nu = tg.MU_F / tg.RHO0_F
    expected = ke0 * math.exp(-16.0 * math.pi ** 2 * nu * float(sim.time))
    rel = abs(ke - expected) / expected
    log(f"tg decay: dx=0.01 t={float(sim.time):.6f} n_adv={sim.n_adv} "
        f"n_ac={sim.n_ac} KE0={ke0:.9f} KE={ke:.9f} analytic {expected:.9f} "
        f"(rel {rel:.4f})")
    check(not bool(sim.overflow), "tg decay: block capacity overflow")
    check(rel < 0.08, f"tg decay: KE off the analytic decay by {rel:.4f}")


def profile_step(torch, tag, step, what="advection step", trace=True):
    """One step (`step()`) under torch.profiler: device time by kernel, the
    sweeps' share and the device idle share of the profiled step's wall
    time.  The profiler slows the host side, so the same step is also
    timed unprofiled (`wall_s`) and an idle-share estimate is printed
    that divides the profiled device busy by that wall time — two different
    executions, labelled as such.  A session can drop the device events
    of its first few ms (`benchmarks/profiler_check.py`) or, after many
    sessions in one process, its first ~23 records, so the recorded
    window opens with a PROFILE_PAD_S host sleep and PROFILE_GUARD marker
    kernels (`torch.cuda._sleep`'s spin_kernel) and closes with a marker
    and a pad.  A session whose first and last recorded device events are
    markers held the whole step; else it runs again (at most 3 times;
    `PROFILED` keeps each step's launches, attempts, whether the markers
    held and how many leading markers were recorded).  Writes a Chrome
    trace to build/traces/ unless `trace` is False; then only the device
    is traced (phase 14: steps of ~10^4-10^5 launches, whose host ops take
    tens of seconds to record and sum).  Returns (device busy us,
    profiled wall us, unprofiled wall us, device launches: kernels,
    copies and sets, the markers not counted)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    plain_wall_us = wall_s(torch, step, 3) * 1e6
    activities = [ProfilerActivity.CUDA]
    on_card = torch.cuda.is_available()
    if trace or not on_card:   # a CPU rehearsal: host ops
        activities.append(ProfilerActivity.CPU)
    for attempt in range(1, 4):
        with profile(activities=activities) as prof:
            time.sleep(PROFILE_PAD_S)
            for _ in range(PROFILE_GUARD if on_card else 0):
                torch.cuda._sleep(100)
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
            if on_card:
                torch.cuda._sleep(100)
                torch.cuda.synchronize()
            time.sleep(PROFILE_PAD_S)
        mark = ["spin_kernel" in e.name for e in sorted(
            (e for e in prof.events() if e.device_type == DeviceType.CUDA),
            key=lambda e: e.time_range.start)]
        lead = next((i for i, m in enumerate(mark) if not m), len(mark))
        held = not on_card or (bool(mark) and mark[0] and mark[-1])
        if held:
            break
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and "spin_kernel" not in e.key]
    launches = sum(e.count for e in kern)
    PROFILED.append((tag, launches, attempt, held, lead))
    if trace:
        out = ROOT / "build" / "traces"
        out.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(out / f"trace_{tag}_step.json"))
    # device-side events only (kernels, copies); the aten ops that launched
    # them report the same time again
    dev_us = sum(e.self_device_time_total for e in kern)
    sweeps_us = sum(e.self_device_time_total for e in kern
                    if any(n in e.key for n in SWEEP_KERNEL_NAMES))
    log(f"{tag} profile: profiled {what} wall {wall_us / 1e3:.3f} ms, device busy "
        f"{dev_us / 1e3:.3f} ms (idle share of the profiled step "
        f"{1 - dev_us / wall_us:.3f}), sweep kernels {sweeps_us / 1e3:.3f} ms, "
        f"{len(kern)} kernel kinds")
    log(f"{tag} profile: unprofiled {what} wall {plain_wall_us / 1e3:.3f} ms; "
        f"estimated idle share {1 - dev_us / plain_wall_us:.3f} (profiled "
        f"device busy over unprofiled wall: two executions)")
    log(f"{tag} profile: {launches} device launches (kernels, copies, sets); "
        f"attempt {attempt}, the markers held: {held} ({lead} of "
        f"{PROFILE_GUARD} leading ones recorded)")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"{tag} profile:   {e.self_device_time_total / 1e3:9.3f} ms "
            f"x{e.count:<4d} {e.key[:90]}")
    return dev_us, wall_us, plain_wall_us, launches


# ---------------------------------------------------------------------------
# 2d16: the first-generation packed acoustic halves (B5a-d)
# ---------------------------------------------------------------------------

def bytes_or_flops(nbytes, flops):
    """(ms, "bytes"|"operations"): the larger of nbytes over the HBM rate
    and flops over the float32 rate."""
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def packed_bound(torch, args, out, pairs, pair_flops, wall=False):
    """The least time the card could take for one packed sweep (ms), as
    `bound` counts it: bytes = the output written once, the window map,
    and once each packed row (16 slots x 8 channels x 4 B = 512 B) the
    sweep needs — for an inner sweep the rows its map reaches, for a wall
    sweep the wall rows its map reaches and the fluid rows that have a wall
    window; flops = the real pairs times `pair_flops`.  Returns (ms,
    "bytes"|"operations", flops, bytes)."""
    table = args[-1]
    src = args[1] if wall else args[0]
    live = table < src.shape[0] - 1
    row_bytes = src[0].numel() * src.element_size()
    nbytes = out.numel() * out.element_size() \
        + table.numel() * table.element_size() \
        + int(torch.unique(table[live]).numel()) * row_bytes
    if wall:
        nbytes += int(torch.any(live, dim=1).sum()) * row_bytes
    flops = pairs * pair_flops
    return (*bytes_or_flops(nbytes, flops), flops, nbytes)


def own_row_check(torch, nbr):
    """B5a/B5b drop the self pair by slot index; that is JAX's (window 4,
    j == i) test where window 4 of every live cell is its own block row
    and no other window repeats it (no periodic box)."""
    c = nbr.shape[0]
    own = nbr[:, 4] == torch.arange(c, device=nbr.device, dtype=nbr.dtype)
    empty = (nbr == c).all(dim=1)
    others = torch.cat([nbr[:, :4], nbr[:, 5:]], dim=1)
    check(bool((own | empty).all()),
          "2d16: window 4 of a live cell is not its own block row")
    check(not bool(((others == nbr[:, 4:5]) & own[:, None]).any()),
          "2d16: another window repeats a cell's own block row")
    log(f"2d16: nbr[:, 4] is the own row of each of the {int(own.sum())} "
        f"live cells and no other window repeats it ({int(empty.sum())} "
        f"empty rows)")


def packed_slot_pairs(torch, ps, packed, nbr):
    """(slot pairs B5a/B5b's first design evaluated, lane x slot pairs its
    lane groups evaluate, share of split cells), from the packed map: the
    first design 16 x 16 per live window of every cell; a lane group 16
    lanes times the real j-slots (mask != 0) of its live windows, for every
    cell with a real slot (a split cell's lanes each take about half)."""
    c = nbr.shape[0]
    real = packed[..., ps.CMASK] != 0          # the sentinel row: none
    before = int((nbr < c).sum()) * ps.CAP ** 2
    per_cell = real.sum(dim=1)[nbr.long()].sum(dim=1)
    has = real[:c].any(dim=1)
    after = int((per_cell * has).sum()) * ps.CAP
    split = has & ~real[:c, ps.CAP // 2:].any(dim=1)
    return before, after, float(split.sum()) / max(int(has.sum()), 1)


def packed_holes(torch, ps, packed, mask_ch=None):
    """`packed` with, in every row whose first slot is real and last slot
    padding (mask channel `mask_ch`, default the inner layout's), the two
    slots swapped (padding mid-row, a real slot in the upper half); and the
    swap, new[r, k] = old[r, idx[r, k]]."""
    m = packed[..., ps.CMASK if mask_ch is None else mask_ch] != 0
    idx = torch.arange(ps.CAP, device=packed.device).repeat(packed.shape[0], 1)
    swap = m[:, 0] & ~m[:, -1]
    idx[swap, 0] = ps.CAP - 1
    idx[swap, -1] = 0
    return torch.gather(packed, 1, idx[..., None].expand_as(packed)), idx


def lane_group_checks(torch, ps, module, inputs, base, c, tag="2d16",
                      prep=None, transposed=()):
    """`module`'s packed sweeps where their first designs never met it,
    each against its plain version on the same inputs: `holes`
    (packed_holes; every real slot's sums must stay within 1e-6 max|out|
    of the run without the swap), and `coincident`, slot 1's particle
    moved onto slot 0's position in every row where both are real (a real
    pair at r = 0 that is not the self pair).  `inputs`: {name: ((packed,
    nbr), kw)}; `base`: each sweep's output on them as (C, 16, 3).
    `prep(name, packed, nbr)`, if given, makes a sweep's arguments (B7's
    `prep_t`); a sweep named in `transposed` returns (16, C) sums."""
    prep = prep or (lambda name, pk, nbr: (pk, nbr))
    for name, ((pk, nbr), kw) in inputs.items():
        t = name in transposed
        holed, idx = packed_holes(torch, ps, pk)
        real_h = (holed[..., ps.CMASK] != 0)[:c]
        got, _ = compare(torch, f"{tag} holes", name, prep(name, holed, nbr),
                         kw, real_h.t() if t else real_h, module=module)
        got = got.transpose(0, 1) if t else got
        back = torch.gather(got, 1, idx[:c, :, None].expand_as(got))
        m = pk[..., ps.CMASK] != 0
        real = m[:c]
        diff = float((back - base[name])[real].abs().max())
        scale = float(base[name][real].abs().max())
        log(f"{tag} holes {name}: agrees with its plain version; max |out - "
            f"out without the swap| {diff:.3e} (max|out| {scale:.3e})")
        check(diff <= 1e-6 * scale,
              f"{tag} holes {name}: real slots moved through the swap")
        both = m[:, 0] & m[:, 1]
        co = pk.clone()
        co[both, 1, :2] = co[both, 0, :2]
        compare(torch, f"{tag} coincident", name, prep(name, co, nbr), kw,
                real.t() if t else real, module=module)
        log(f"{tag} coincident {name}: agrees with its plain version "
            f"({int(both.sum())} coincident pairs)")


def wall_slot_pairs(torch, ps, packed_i, wall, nbr_w, i_ch, w_ch):
    """(slot pairs B5c/B5d's first design evaluated, lane x slot pairs its
    lane groups evaluate, cells with a live wall window, of them those with
    a real i-slot), from the wall map: the first design 16 x 16 per live
    wall window of every cell; a lane group 16 lanes times the real wall
    slots (mask != 0) of its live windows, for every cell with a live
    window and a real i-slot."""
    c, cw = nbr_w.shape[0], wall.shape[0] - 1
    live = nbr_w < cw                     # the sentinel row holds no real slot
    real_w = (wall[..., w_ch] != 0).sum(dim=1)
    windowed = live.any(dim=1)
    working = windowed & (packed_i[:c, :, i_ch] != 0).any(dim=1)
    per_cell = real_w[nbr_w.long()].sum(dim=1)
    before = int(live.sum()) * ps.CAP ** 2
    after = int((per_cell * working).sum()) * ps.CAP
    return before, after, int(windowed.sum()), int(working.sum())


def full_wall_rows(torch, wall, w_ch, h, g):
    """`wall` with every padding slot of a row that holds a real slot made
    real: its row's first slot copied there, mask 1, its position moved by
    up to h/2 (into the support of the fluid beside that slot)."""
    m = wall[..., w_ch] != 0
    fill = ~m & m.any(dim=1, keepdim=True)
    full = torch.where(fill[..., None], wall[:, :1, :].expand_as(wall), wall)
    jitter = (torch.rand(wall.shape[:2] + (2,), generator=g, device=DEVICE)
              - 0.5) * h
    full[..., :2] = torch.where(fill[..., None], full[..., :2] + jitter,
                                full[..., :2])
    full[..., w_ch] = torch.where(fill, torch.ones_like(full[..., w_ch]),
                                  full[..., w_ch])
    return full


def wall_checks(torch, ps, inputs, c, h, g):
    """B5c/B5d where their first design never met them, each against its
    plain version on the same inputs (`inputs`: packed_inputs with a
    moving wall, so that every output channel is live): holes on both
    sides (packed_holes on the i-rows and on the wall rows; every real
    slot's sums within 1e-6 max|out| of the run without the swap) and full
    wall rows (full_wall_rows: the compaction meets whole rows, the
    unsplit cells long lists); and the slot pairs each design evaluates."""
    masks = {"ac1_wall_sweep": (ps.I1M, ps.W1M),   # (i-side, wall) masks
             "ac2_wall_sweep": (ps.I2M, ps.W2M)}
    for name, (i_ch, w_ch) in masks.items():
        (pk_i, wall, nbr_w), kw = inputs[name]
        before, after, windowed, working = wall_slot_pairs(
            torch, ps, pk_i, wall, nbr_w, i_ch, w_ch)
        log(f"2d16 {name}: {after} lane x slot pairs evaluated (first "
            f"design: {before} slot pairs) in {working} cells with a wall "
            f"window and a real slot ({windowed} with a wall window, of "
            f"{c} cells)")
        base = channels(torch, getattr(ps, name)(pk_i, wall, nbr_w, **kw))
        holed_i, idx = packed_holes(torch, ps, pk_i, i_ch)
        holed_w, _ = packed_holes(torch, ps, wall, w_ch)
        real_h = (holed_i[..., i_ch] != 0)[:c]
        got, _ = compare(torch, "2d16 holes", name, (holed_i, holed_w, nbr_w),
                         kw, real_h, module=ps)
        back = torch.gather(got, 1, idx[:c, :, None].expand_as(got))
        real = (pk_i[..., i_ch] != 0)[:c]
        diff = float((back - base)[real].abs().max())
        scale = float(base[real].abs().max())
        log(f"2d16 holes {name}: agrees with its plain version, i-rows and "
            f"wall rows swapped; max |out - out without the swap| "
            f"{diff:.3e} (max|out| {scale:.3e})")
        check(diff <= 1e-6 * scale,
              f"2d16 holes {name}: real slots moved through the swap")
        full = full_wall_rows(torch, wall, w_ch, h, g)
        compare(torch, "2d16 full-wall-rows", name, (pk_i, full, nbr_w), kw,
                real, module=ps)
        _, after_full, _, _ = wall_slot_pairs(torch, ps, pk_i, full, nbr_w,
                                              i_ch, w_ch)
        unsplit = int(((pk_i[:c, ps.CAP // 2:, i_ch] != 0).any(dim=1)
                       & (nbr_w < wall.shape[0] - 1).any(dim=1)).sum())
        log(f"2d16 full-wall-rows {name}: agrees with its plain version "
            f"({after_full} lane x slot pairs; {unsplit} cells with a wall "
            f"window do not split)")


def packed_kernel_phase(torch, scene, sim, results):
    """B5a-d against their plain versions on the same inputs, their times
    and bounds; the lane × slot pairs B5a/B5b evaluate and the B2/B3 times
    on the same state; then the wall sweeps with seeded non-zero wall
    kinematics (the static dambreak wall packs zeros there), the 2nd-half
    sweeps with the Dissipative solver's constants (limiter 1e30), padding
    moved into the support with volume 1 (the mask its only guard),
    B5a/B5b with holes and coincident particles, and B5c/B5d with holes on
    both sides and full wall rows (`wall_checks`)."""
    from sphinxsys_tpu_torch.benchmarks import (
        median_ms, packed_inputs, sweep_inputs,
    )
    from sphinxsys_tpu_torch.ops import block_sweeps as bs
    from sphinxsys_tpu_torch.ops import packed_sweeps as ps
    from sphinxsys_tpu_torch.physics import riemann as rs

    eng, fb, wb = scene.eng, sim.fluid_b, scene.wall_b
    c = sim.nbr_inner.shape[0]
    real = fb["SlotMask"][:c]
    own_row_check(torch, sim.nbr_inner)
    inputs = packed_inputs(scene, sim)
    pos = inputs["ac1_inner_sweep"][0][0][..., :2]
    inner, wall = real_pairs(torch, pos, fb["SlotMask"], sim.nbr_inner,
                             (0.0, 0.0), eng.kernel.cutoff, wb["Position"],
                             wb["SlotMask"], sim.nbr_wall)
    self_pairs = int(real.sum())
    base = {}
    for name, (args, kw) in inputs.items():
        wrapper, plain = getattr(ps, name), getattr(ps, name + "_plain")
        got, max_abs = compare(torch, "2d16", name, args, kw, real, module=ps)
        base[name] = got
        ms = median_ms(lambda: wrapper(*args, **kw), 20, DEVICE)
        plain_ms = median_ms(lambda: plain(*args, **kw), 3, DEVICE)
        pairs = inner - self_pairs if name.endswith("inner_sweep") else wall
        bound_ms, bound_by, flops, nbytes = packed_bound(
            torch, args, got, pairs, PACKED_PAIR_FLOPS[name],
            wall=name.endswith("wall_sweep"))
        log(f"2d16 {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by}: {pairs} real pairs, "
            f"{flops:.4e} flop, {nbytes} B), max_abs_err {max_abs:.3e}")
        results[f"{name}[2d16]"] = dict(
            max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by, real_pairs=pairs)
        if name.endswith("inner_sweep"):
            before, after, split = packed_slot_pairs(torch, ps, args[0],
                                                     args[1])
            log(f"2d16 {name}: {after} lane x slot pairs evaluated (first "
                f"design: {before} slot pairs; {pairs} real pairs; "
                f"{split:.3f} of the cells split), "
                f"{ms * 1e9 / after:.4f} ps each")
    # the *_p2 route's sweeps (B2/B3) on the same state, for comparison
    b2b3 = {}
    for name, (args, kw) in sweep_inputs(scene, sim,
                                         ("ac1_sweep", "ac2_sweep")).items():
        wrapper = getattr(bs, name)
        b2b3[name] = median_ms(lambda: wrapper(*args, **kw), 20, DEVICE)
        log(f"2d16 {name} (B2/B3 on the same state): kernel "
            f"{b2b3[name]:.4f} ms")
    results["_2d16_b2b3_main"] = b2b3

    g = torch.Generator(device=DEVICE).manual_seed(7)
    shape = wb["Position"].shape
    moving = dict(wb, AverageVelocity=0.1 * torch.randn(
        shape, generator=g, device=DEVICE), AverageAcceleration=torch.randn(
        shape, generator=g, device=DEVICE))
    moving_inputs = packed_inputs(scene, sim, wall_b=moving)
    variants = (("moving-wall", moving_inputs,
                 ("ac1_wall_sweep", "ac2_wall_sweep")),
                ("dissipative", packed_inputs(
                    scene, sim, riemann2=rs.dissipative_riemann(eng.eos)),
                 ("ac2_inner_sweep", "ac2_wall_sweep")))
    for what, inp, names in variants:
        for name in names:
            args, kw = inp[name]
            compare(torch, f"2d16 {what}", name, args, kw, real, module=ps)
            log(f"2d16 {what} {name}: agrees with its plain version")

    # the mask channel as the only guard: padding slots of the neighbour
    # tensor moved into the support of their row's first slot, volume 1
    for name, (args, kw) in inputs.items():
        j = 0 if name.endswith("inner_sweep") else 1
        mask_ch, vol_ch = {"ac1_inner_sweep": (ps.CMASK, ps.CVOL),
                           "ac2_inner_sweep": (ps.CMASK, ps.CVOL),
                           "ac1_wall_sweep": (ps.W1M, ps.W1VOL),
                           "ac2_wall_sweep": (ps.W2M, ps.W2VOL)}[name]
        near_padding_check(torch, ps, name, args, kw, j, mask_ch, vol_ch,
                           eng.kernel.h, real, g)
    lane_group_checks(torch, ps, ps, {n: inputs[n] for n in (
        "ac1_inner_sweep", "ac2_inner_sweep")}, base, c)
    wall_checks(torch, ps, moving_inputs, c, eng.kernel.h, g)


def near_padding_check(torch, module, name, args, kw, j, mask_ch, vol_ch, h,
                       real, g, prep=None):
    """`module.name` with the padding slots of its packed argument `j`
    moved into the support of their row's first slot (jitter of up to h/2),
    volume 1: it must agree with its plain version there, and every real
    slot's sums must stay within 1e-6 max|out| of the run without it.
    `prep`, if given, makes the sweep's arguments from these (B7's
    `prep_t`)."""
    prep = (lambda a: a) if prep is None else prep
    pk = args[j]
    pad = pk[..., mask_ch] == 0
    jitter = (torch.rand(pk.shape[:2] + (2,), generator=g, device=DEVICE)
              - 0.5) * h
    near = pk.clone()
    near[..., :2] = torch.where(pad[..., None], pk[:, :1, :2] + jitter,
                                pk[..., :2])
    near[..., vol_ch] = torch.where(pad, torch.ones_like(pad, dtype=pk.dtype),
                                    pk[..., vol_ch])
    near_args = prep(args[:j] + (near,) + args[j + 1:])
    got, _ = compare(torch, "2d16 near-padding", name, near_args, kw, real,
                     module=module)
    ref = channels(torch, getattr(module, name)(*prep(args), **kw))
    diff = float((got - ref)[real].abs().max())
    scale = float(ref[real].abs().max())
    log(f"2d16 near-padding {name}: max |out - out without it| {diff:.3e} "
        f"(max|out| {scale:.3e})")
    check(diff <= 1e-6 * scale,
          f"2d16 near-padding {name}: padding leaks into real slots")


def packed_path(torch, scene, sim, results):
    """One advection step's acoustic sub-steps from `sim` (after its
    density prep, B1) twice: through the packed halves (B5a-d, the main
    path of this configuration, launch counts reset just before it and
    read just after) and through the *_p2 halves (B2/B3).  Equal sub-step
    counts, real-slot positions within 5e-5 (small_reference_check's
    limit), velocity and density within 1e-3 max|ref|, finite fields; then
    each route's sub-step wall time in turns, and one packed sub-step
    under torch.profiler."""
    from sphinxsys_tpu_torch.engine import block_fluid as eng_mod
    from sphinxsys_tpu_torch.ops import packed_sweeps as ps
    from sphinxsys_tpu_torch.physics import fluid_blocks as fbops

    eng, nbr, nbr_w = scene.eng, sim.nbr_inner, sim.nbr_wall
    wc = eng_mod.WallCtx(scene.wall_b, nbr_w)
    dt_adv = eng_mod.advection_dt(eng, sim.fluid_b)
    fb0 = eng_mod.advection_prep(eng, sim.fluid_b, nbr, wc)
    w1 = fbops.pack_wall_ac1(scene.wall_b)
    w2 = fbops.pack_wall_ac2(scene.wall_b)

    def packed_substep(fb, dt):
        fb = fbops.acoustic_step_1st_half_packed(
            fb, nbr, eng.kernel, eng.eos, eng.riemann1, dt, wall_packed=w1,
            nbr_wall=nbr_w)
        return fbops.acoustic_step_2nd_half_packed(
            fb, nbr, eng.kernel, eng.riemann2, dt, wall_packed=w2,
            nbr_wall=nbr_w)

    def p2_substep(fb, dt):
        fb = eng_mod.acoustic_first_half(eng, fb, nbr, wc, dt)
        return eng_mod.acoustic_second_half(eng, fb, nbr, wc, dt)

    def relax(substep):
        fb, t, n = fb0, torch.zeros_like(dt_adv), 0
        while bool(t < dt_adv):
            dt = eng_mod.acoustic_dt(eng, fb, dt_adv)
            fb = substep(fb, dt)
            t = t + dt
            n += 1
        return fb, n

    ps.reset_launch_counts()
    got, n_got = relax(packed_substep)
    counts = dict(ps.LAUNCHES)
    torch.cuda.synchronize()
    ref, n_ref = relax(p2_substep)
    real = fb0["SlotMask"]
    check(n_got == n_ref, f"2d16: {n_got} packed sub-steps, {n_ref} p2 ones")
    for k in ("Position", "Velocity", "Density", "Pressure"):
        check(bool(torch.isfinite(got[k][real]).all()), f"2d16: non-finite {k}")
    dpos = float((got["Position"][real] - ref["Position"][real]).abs().max())
    errs = {}
    for k in ("Velocity", "Density"):
        scale = float(ref[k][real].abs().max())
        errs[k] = float((got[k][real] - ref[k][real]).abs().max())
        check(errs[k] <= 1e-3 * scale,
              f"2d16: {k} differs by {errs[k]:.3e} > 1e-3 max|ref| {scale:.3e}")
    log(f"2d16 path: {n_got} acoustic sub-steps on each route, max |dpos| "
        f"{dpos:.3e}, max |dvel| {errs['Velocity']:.3e}, max |drho| "
        f"{errs['Density']:.3e}, packed launches {counts}")
    check(dpos <= 5e-5, f"2d16: positions differ by {dpos:.3e}")
    for name, (_, key) in PACKED_KERNELS.items():
        check(counts[key] > 0, f"2d16: kernel {name} never launched")
        results[f"{name}[2d16]"]["launches"] = counts[key]

    dt = eng_mod.acoustic_dt(eng, fb0, dt_adv)
    routes = {"p2": p2_substep, "packed": packed_substep}
    turns = [(r, wall_s(torch, lambda: routes[r](fb0, dt), 5) * 1e3)
             for r in ("p2", "packed", "packed", "p2")]
    log("2d16 acoustic sub-step wall clock (ms, median of 5, in turns): "
        + ", ".join(f"{r} {ms:.3f}" for r, ms in turns))
    results["_2d16_main"] = dict(
        n_ac=n_got, dpos=dpos, substep_ms={
            r: [ms for q, ms in turns if q == r] for r in routes})
    profile_step(torch, "2d16", lambda: packed_substep(fb0, dt),
                 what="packed acoustic sub-step")


# ---------------------------------------------------------------------------
# layout: B6 and B7, two other decompositions of B5a's sweep
# ---------------------------------------------------------------------------

def b7_vote(torch, ps, xi_t, xj_t):
    """B7's tile vote, from its inputs' masks (csrc/layout_sweeps.cu): per
    32-cell tile, which i-rows hold a real slot (16, tiles), which j-rows of
    each window hold one (9, 16, tiles), and the tile's cells (tiles,)."""
    c = xi_t.shape[-1]
    tiles = -(-c // 32)

    def rows(m):   # (..., 16, C) masks -> (..., 16, tiles): row has a real slot
        m = torch.nn.functional.pad(m != 0, (0, tiles * 32 - c))
        return m.reshape(*m.shape[:-1], tiles, 32).any(dim=-1)

    cells = (c - 32 * torch.arange(tiles, device=xi_t.device)).clamp(max=32)
    return rows(xi_t[ps.CMASK]), rows(xj_t[:, ps.CMASK]), cells


def b7_bytes(xi_t, out, vote):
    """(bytes B7 must move, bytes of its first design's count) for one
    sweep.  Each array once: the output; xi_t's x, y, p and mask planes and
    xj_t's 9 mask planes, whole (the tile vote reads them); xj_t's x, y, p
    and vol only on the j-rows that the vote keeps, a j-row with a real
    slot of a window in a tile with a real i-slot (the rows the kernel
    stages).  The first design's count took those 4 planes whole too."""
    i_rows, j_rows, cells = vote
    plane = xi_t[0].numel() * xi_t.element_size()
    fixed = out.numel() * out.element_size() \
        + (len(B7_XI_CHANNELS) + j_rows.shape[0]) * plane
    kept = (j_rows & i_rows.any(dim=0)).sum(dim=(0, 1))       # (tiles,)
    staged = int((kept * cells).sum()) * xi_t.element_size()
    whole = j_rows.shape[0] * plane
    return (fixed + len(B7_XJ_STAGED) * staged,
            fixed + len(B7_XJ_STAGED) * whole)


def layout_pairs_evaluated(torch, ps, pk, nbr, vote):
    """{name: (slot pairs the first design evaluated, pairs the current
    design evaluates)} from the inputs' masks.  First designs: B6 16 x 16
    per live window, B7 16 x 16 per window of every cell.  B6 now: for each
    cell with a real slot, its real i-slots times the real j-slots of its
    live windows.  B7 now (`vote`, b7_vote's): for each 32-cell tile, per
    window, its i-rows with a real slot times its j-rows with one, times
    the 32 cells (csrc/layout_sweeps.cu)."""
    c = nbr.shape[0]
    real = pk[..., ps.CMASK] != 0              # the sentinel row: none
    n_i = real[:c].sum(dim=1)
    n_j = real.sum(dim=1)[nbr.long()].sum(dim=1)
    b6 = int((n_i * n_j).sum())
    i_rows, j_rows, _ = vote
    b7 = int((i_rows.sum(dim=0) * j_rows.sum(dim=(0, 1))).sum()) * 32
    return {"ac1_flat_sweep": (int((nbr < c).sum()) * ps.CAP ** 2, b6),
            "ac1_t_sweep": (c * ps.NW * ps.CAP ** 2, b7)}


def layout_inputs(ls, name, pk, nbr):
    """B6's or B7's arguments from a packed state (B7: `prep_t`)."""
    return (pk, nbr) if name == "ac1_flat_sweep" else ls.prep_t(pk, nbr)


def layout_lane_checks(torch, ls, ps, pk, nbr, consts, real, base, h, g):
    """B6 and B7 where their first designs never met it, each against its
    plain version (B7 on `prep_t` of the same packed tensor): lane_group_
    checks' holes and coincident particles, near padding (padding of
    volume 1 moved into the support: the mask the only guard, which B7's
    tile vote now rests on), and B7 at C - 3 cells (4-byte copies, a
    ragged last tile).  `base`: each sweep's output on `pk` as (C, 16, 3)."""
    c = nbr.shape[0]
    lane_group_checks(torch, ps, ls, {n: ((pk, nbr), consts)
                                      for n in LAYOUT_KERNELS},
                      base, c, tag="2d16 layout",
                      prep=lambda n, p, m: layout_inputs(ls, n, p, m),
                      transposed=("ac1_t_sweep",))
    for name in LAYOUT_KERNELS:
        t = name == "ac1_t_sweep"
        near_padding_check(torch, ls, name, (pk, nbr), consts, 0, ps.CMASK,
                           ps.CVOL, h, real.t() if t else real, g,
                           prep=lambda a, n=name: layout_inputs(ls, n, *a))
    ragged = ls.prep_t(pk, nbr[:c - 3])
    compare(torch, "2d16 layout ragged", "ac1_t_sweep", ragged, consts,
            real[:c - 3].t(), module=ls)
    log(f"2d16 layout ragged ac1_t_sweep: agrees with its plain version at "
        f"C = {c - 3} (4-byte copies, a ragged last tile)")


def layout_phase(torch, scene, sim, results):
    """On the 2d16 state (the engine's fields after one advection step,
    packed once by `pack_layout_state` and shared with the drivers): B6
    and B7 against their plain versions and both against the B5a kernel
    on the same packed tensor (three kernels, one function), the pairs
    each evaluates, then `layout_lane_checks`; then both layout drivers at
    PACKED_DX on that state, launch counts reset just before them and read
    just after, their cross-checks, and from their timings each kernel's
    ms and plain ms beside its bound."""
    from sphinxsys_tpu_torch.benchmarks import (
        b5a_channels, exp_layout, exp_layout2, pack_layout_state,
    )
    from sphinxsys_tpu_torch.ops import layout_sweeps as ls
    from sphinxsys_tpu_torch.ops import packed_sweeps as ps

    t0 = time.perf_counter()
    st = pack_layout_state(scene, sim)
    pk, nbr, mask = st["packed"], st["nbr"], sim.fluid_b["SlotMask"]
    c = nbr.shape[0]
    real = mask[:c]
    consts = dict(inv_h=st["inv_h"], factor_w=st["factor_w"],
                  inv_rho0c0=st["inv_rho0c0"])
    inner, _ = real_pairs(torch, pk[..., :2], mask, nbr, (0.0, 0.0),
                          scene.eng.kernel.cutoff)
    pairs = inner - int(real.sum())
    xi_t, xj_t = ls.prep_t(pk, nbr)
    vote = b7_vote(torch, ps, xi_t, xj_t)
    evaluated = layout_pairs_evaluated(torch, ps, pk, nbr, vote)
    b5a32 = torch.stack(b5a_channels(ps.ac1_inner_sweep, st), dim=-1)
    b5a64 = torch.stack(b5a_channels(ps.ac1_inner_sweep_plain,
                                     dict(st, packed=pk.double())), dim=-1)
    checked, base = {}, {}
    for name, args, transposed in (("ac1_flat_sweep", (pk, nbr), False),
                                   ("ac1_t_sweep", (xi_t, xj_t), True)):
        got, max_abs = compare(torch, "2d16 layout", name, args, consts,
                               real.t() if transposed else real, module=ls)
        base[name] = got.transpose(0, 1) if transposed else got
        hold(torch, f"2d16 layout {name} vs the B5a kernel", base[name],
             b5a32, b5a64, real)
        log(f"2d16 layout {name}: agrees with its plain version and with B5a")
        if transposed:    # the planes and rows it reads, and its output
            nbytes, whole = b7_bytes(xi_t, got, vote)
            flops = pairs * LAYOUT_PAIR_FLOPS
            bound_ms, bound_by = bytes_or_flops(nbytes, flops)
            log(f"2d16 layout {name}: bound {bound_ms:.4f} ms from {nbytes} B "
                f"(the first design's count, every staged plane whole: "
                f"{whole} B, {bytes_or_flops(whole, flops)[0]:.4f} ms)")
        else:             # the same bytes as B5a
            bound_ms, bound_by, flops, nbytes = packed_bound(
                torch, args, got, pairs, LAYOUT_PAIR_FLOPS)
        checked[name] = (max_abs, bound_ms, bound_by, flops, nbytes)
    del xi_t, xj_t, vote, b5a32, b5a64
    layout_lane_checks(torch, ls, ps, pk, nbr, consts, real, base,
                       scene.eng.kernel.h,
                       torch.Generator(device=DEVICE).manual_seed(9))
    del base
    torch.cuda.empty_cache()

    ls.reset_launch_counts()
    ps.reset_launch_counts()
    drivers = {m.__name__.rsplit(".", 1)[-1]:
               m.run(dx=PACKED_DX, device=DEVICE, state=st)
               for m in (exp_layout, exp_layout2)}
    counts = dict(ls.LAUNCHES, ac1_inner=ps.LAUNCHES["ac1_inner"])
    torch.cuda.synchronize()
    log(f"layout drivers: launches {counts}")
    for tag, out in drivers.items():
        check(out["agree"], f"{tag}: cross-checks disagree {out['cross_check']}")
    for key in counts:
        check(counts[key] > 0, f"layout drivers: kernel {key} never launched")
    t1, t2 = drivers["exp_layout"]["ms"], drivers["exp_layout2"]["ms"]
    timed = {  # (kernel ms, plain ms) from the drivers' runs
        "ac1_flat_sweep": (t1[exp_layout.B6_KERNEL],
                           t1["b) plain (C,256) flat"]),
        "ac1_t_sweep": (t2[exp_layout2.B7_KERNEL],
                        t2["b2) plain (16,16,C) transposed alone"])}
    prep_ms = t2["g) prep_t (gather + transpose)"]
    for name, (_, key) in LAYOUT_KERNELS.items():
        ms, plain_ms = timed[name]
        max_abs, bound_ms, bound_by, flops, nbytes = checked[name]
        first, now = evaluated[name]
        log(f"2d16 {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by}: {pairs} real pairs, "
            f"{flops:.4e} flop, {nbytes} B), max_abs_err {max_abs:.3e}; "
            f"{now} pairs evaluated (first design: {first} slot pairs), "
            f"{ms * 1e9 / now:.4f} ps each")
        results[f"{name}[2d16]"] = dict(
            max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by, real_pairs=pairs, launches=counts[key],
            pairs_evaluated=now)
    log(f"2d16 layout: B5a {t1['c) B5a kernel (16-lane groups)']:.4f} ms, "
        f"prep_t {prep_ms:.4f} ms in the same drivers' runs")
    results["_layout_main"] = dict(prep_t_ms=prep_ms, drivers={
        tag: dict(ms=out["ms"], cross_check=out["cross_check"])
        for tag, out in drivers.items()})
    del st
    torch.cuda.empty_cache()
    log(f"layout phase: {time.perf_counter() - t0:.1f} s")


def packed_phase(torch, results):
    """The 2d16 configuration: the 2D dambreak at its bench width with
    cap 16, after one advection step of the engine."""
    from sphinxsys_tpu_torch.cases import dambreak_2d as db
    from sphinxsys_tpu_torch.engine import scene as sc
    from sphinxsys_tpu_torch.ops import packed_sweeps as ps

    scene, fluid = db.build_block_case(dx=PACKED_DX, device=DEVICE, cap=ps.CAP)
    sim = sc.make_advection_step(scene)(sc.init_sim(scene, fluid))
    check(not bool(sim.overflow), "2d16: block capacity overflow")
    log(f"2d16: n_fluid={scene.n_fluid} n_wall={scene.base.n_wall} "
        f"grid={scene.eng.grid.shape} c_max={scene.eng.c_max} "
        f"cap={scene.eng.cap} wall c_max={scene.bm_wall.c_max}")
    packed_kernel_phase(torch, scene, sim, results)
    packed_path(torch, scene, sim, results)
    layout_phase(torch, scene, sim, results)


# ---------------------------------------------------------------------------
# 8. the lattice solid: the twisting column on L1 / L2
# ---------------------------------------------------------------------------

def lattice_pairs(torch, lat, valid):
    """Real pairs per tap: sites i (every one is computed) whose j = i + o
    lies in the box and is valid, from this run's mask."""
    from sphinxsys_tpu_torch.ops import lattice_sweeps as ls

    m = max(abs(c) for o, *_ in lat.taps for c in o)
    mP = ls._pad(valid.reshape(lat.shape).to(torch.int32), m)
    return [int(ls._tap(mP, o, m, lat.shape).sum()) for o, *_ in lat.taps]


def lattice_bound(torch, name, lat, args, out):
    """The least time the card could take for one L1 / L2 call (ms): the
    larger of its bytes (each input once, the output once) over the HBM
    rate and its real pairs' flops over the float32 rate.  Flops per real
    pair of tap o, counted from the tap sums (add, mul, sub one each; e_b
    = 0 terms skipped; the kernels' multiply by w_j, which stands for the
    skip of an invalid j, is not counted): L1 14 + 9 nnz(e_o), L2 3 + 6
    nnz(e_o).  Returns (ms, by, real pairs, flops, bytes)."""
    pairs = lattice_pairs(torch, lat, args[3] if name == "lattice_force"
                          else args[1])
    nnz = [sum(1 for c in e0 if c != 0.0) for o, r0, e0, W0, dW0 in lat.taps]
    per = [(14 + 9 * k) if name == "lattice_force" else (3 + 6 * k)
           for k in nnz]
    flops = sum(p * f for p, f in zip(pairs, per))
    nbytes = out.numel() * out.element_size() + sum(
        a.numel() * a.element_size() for a in args if torch.is_tensor(a))
    return (*bytes_or_flops(nbytes, flops), sum(pairs), flops, nbytes)


def lattice_hold(torch, what, name, args):
    """One lattice kernel against its plain version on the same CUDA inputs
    (float32, and float64 for `hold`'s error scale), every site held, the
    invalid ones too (the kernel computes them as JAX does).  Returns
    (kernel output, max|k - p32|)."""
    from sphinxsys_tpu_torch.ops import lattice_sweeps as ls

    wrapper, plain = getattr(ls, name), getattr(ls, name + "_plain")
    got = wrapper(*args)
    torch.cuda.synchronize()
    ref32 = plain(*args)
    ref64 = plain(*[a.double() if torch.is_tensor(a) and a.is_floating_point()
                    else a for a in args])
    n = got.shape[0]
    flat = [t.reshape(n, -1) for t in (got, ref32, ref64)]
    real = torch.ones(n, dtype=torch.bool, device=got.device)
    return got, hold(torch, f"{what} {name}", *flat, real)


def golden_tip_x():
    """Tip x of the JAX twisting-column curve (snapshot order)."""
    import xml.etree.ElementTree as ET

    part = ET.parse(ROOT / SOLID_GOLDEN).getroot().find(
        "Result_Element/Particle_0")
    snaps = sorted(part.attrib.items(), key=lambda kv: int(kv[0].split("_")[1]))
    return [json.loads(v.lstrip("~"))[0] for _, v in snaps]


def jax_tip_x():
    """Tip x of the port-owned JAX curve (JAX_CURVE), snapshot order."""
    return json.loads((ROOT / JAX_CURVE).read_text())["tip_x"]


def solid_plain_path(torch, case, col, results):
    """The plain path on the card (`use_kernels=False`: JAX's tap loops as
    torch ops): its steady step time and, from one profiled step, its
    device launches — what a hand kernel has to beat."""
    import dataclasses

    from sphinxsys_tpu_torch.cases import twisting_column_3d as tc

    pcase = dataclasses.replace(case, use_kernels=False)
    s = tc.init_sim(pcase, col)
    for _ in range(2):
        s = tc._step(pcase, s)
    ms = wall_s(torch, lambda: tc._step(pcase, s), 3) * 1e3
    dev_us, wall_us, _, launches = profile_step(
        torch, "tc1m_plain", lambda: tc._step(pcase, s), "plain step")
    log(f"tc1m plain path: steady step {ms:.3f} ms (wall clock, median of 3), "
        f"{launches} device launches a step, device busy {dev_us / 1e3:.3f} ms "
        f"of a profiled {wall_us / 1e3:.3f} ms")
    results["_tc1m_plain_main"] = dict(ms_per_step=ms, launches_per_step=launches,
                                  device_busy_ms=dev_us / 1e3)


def solid_main_path(torch, results):
    """The bench's lattice solid (dx = 0.0175: 349 x 57 x 57 = 1,133,901
    sites, the holder 6 layers deep) through
    build_case -> init_sim -> make_run_chunk for >= SOLID_STEPS steps, L1 and
    L2 once a step; then the step by part, one profiled step, and the
    pair-update rate counted as bench.py counts it."""
    from sphinxsys_tpu_torch.benchmarks import lattice_inputs
    from sphinxsys_tpu_torch.cases import twisting_column_3d as tc
    from sphinxsys_tpu_torch.ops import lattice_sweeps as ls
    from sphinxsys_tpu_torch.physics import solid as sd
    from sphinxsys_tpu_torch.physics import solid_lattice as sl

    t0 = time.perf_counter()
    case, col = tc.build_case(dx=SOLID_DX, engine="lattice", device=DEVICE)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    lat = case.lat
    log(f"tc1m: lattice {lat.shape} = {case.n_column} sites, {len(lat.taps)} "
        f"taps, setup {setup_s:.2f} s")
    solid_plain_path(torch, case, col, results)

    run = tc.make_run_chunk(case)
    ls.reset_launch_counts()
    t0 = time.perf_counter()
    s = run(tc.init_sim(case, col), 1e-9)           # one step: learn dt
    dt0 = float(s.time) / s.n_steps
    while s.n_steps < SOLID_STEPS:
        s = run(s, float(s.time) + (SOLID_STEPS - s.n_steps + 0.5) * dt0)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    counts = dict(ls.LAUNCHES)
    c = s.column
    for k in ("Position", "Velocity", "DeformationGradient", "DeformationRate",
              "Force", "Density"):
        check(bool(torch.isfinite(c[k]).all()), f"tc1m: non-finite {k}")
    hm = case.holder_mask
    held = float((c["Position"][hm] - c["InitialPosition"][hm]).abs().max())
    check(held < 1e-3, f"tc1m: the holder moved by {held:.3e}")
    for name, (_, key) in LATTICE_KERNELS.items():
        check(counts[key] == s.n_steps,
              f"tc1m: {name} launched {counts[key]} times in {s.n_steps} steps")
    pairs = sum((lat.shape[0] - abs(o[0])) * (lat.shape[1] - abs(o[1]))
                * (lat.shape[2] - abs(o[2])) for o, *_ in lat.taps)
    rate = 2 * s.n_steps * pairs / elapsed
    log(f"tc1m main path: {s.n_steps} steps to t={float(s.time):.6e} in "
        f"{elapsed:.3f} s ({elapsed / s.n_steps * 1e3:.3f} ms a step, wall "
        f"clock, first step included), launches {counts}, holder |dx| "
        f"{held:.3e}; pairs a sweep {pairs}, pair_interaction_updates_per_sec "
        f"{rate:.6e}")

    # the steady step by part (host wall clock, synchronised)
    dt = sd.solid_acoustic_time_step(c, case.material.sound_speed,
                                     case.adaptation.h, cfl=0.5)
    args = lattice_inputs(case, c, dt)
    half1 = sl.decomposed_integration_1st_half_lattice(
        c, lat, case.material, dt, case.adaptation.h)
    fixed = sd.fix_constraint(half1, case.holder_mask)
    parts = {
        "step": wall_s(torch, lambda: tc._step(case, s), 5),
        "dt": wall_s(torch, lambda: sd.solid_acoustic_time_step(
            c, case.material.sound_speed, case.adaptation.h, cfl=0.5), 5),
        "prelude": wall_s(torch, lambda: sl.decomposed_stress(
            c, case.material, dt, case.adaptation.h), 5),
        "L1": wall_s(torch, lambda: ls.lattice_force(*args["lattice_force"]), 5),
        "half1": wall_s(torch, lambda: sl.decomposed_integration_1st_half_lattice(
            c, lat, case.material, dt, case.adaptation.h), 5),
        "constraint": wall_s(torch, lambda: sd.fix_constraint(
            half1, case.holder_mask), 5),
        "L2": wall_s(torch, lambda: ls.lattice_dfdt(*args["lattice_dfdt"]), 5),
        "half2": wall_s(torch, lambda: sl.integration_2nd_half_lattice(
            fixed, lat, dt), 5),
    }
    parts = {k: v * 1e3 for k, v in parts.items()}
    parts["epilogue1"] = parts["half1"] - parts["prelude"] - parts["L1"]
    parts["epilogue2"] = parts["half2"] - parts["L2"]
    log("tc1m step parts (ms, wall clock): "
        + ", ".join(f"{k} {v:.3f}" for k, v in parts.items()))
    dev_us, wall_us, plain_us, launches = profile_step(
        torch, "tc1m", lambda: tc._step(case, s), "step")
    results["_tc1m_main"] = dict(
        steps=s.n_steps, ms_per_step=elapsed / s.n_steps * 1e3, parts_ms=parts,
        device_busy_ms=dev_us / 1e3, launches_per_step=launches,
        pairs_per_sweep=pairs, pair_interaction_updates_per_sec=rate)
    for name, (_, key) in LATTICE_KERNELS.items():
        results[f"{name}[tc1m]"] = dict(launches=counts[key])
    return case, s


def solid_kernel_checks(torch, case, s, results):
    """L1 and L2 against their plain versions on the 1.13M state after the
    main path, timed and bounded, each beside its design's occupancy (L2
    also beside its library yardstick, `dfdt_conv3d`); then on the same
    state notched, with NaN planted in the notch."""
    from sphinxsys_tpu_torch.benchmarks import lattice_inputs, median_ms, notched
    from sphinxsys_tpu_torch.ops import lattice_sweeps as ls
    from sphinxsys_tpu_torch.physics import solid as sd

    c = s.column
    dt = sd.solid_acoustic_time_step(c, case.material.sound_speed,
                                     case.adaptation.h, cfl=0.5)
    for name, args in lattice_inputs(case, c, dt).items():
        wrapper, plain = getattr(ls, name), getattr(ls, name + "_plain")
        got, max_abs = lattice_hold(torch, "tc1m", name, args)
        ms = median_ms(lambda: wrapper(*args), 20, DEVICE)
        plain_ms = median_ms(lambda: plain(*args), 3, DEVICE)
        bound_ms, bound_by, pairs, flops, nbytes = lattice_bound(
            torch, name, case.lat, args, got)
        occ = ls.occupancy(name)
        library_ms = dfdt_conv3d(torch, args) if name == "lattice_dfdt" \
            else None
        log(f"tc1m {name}: kernel {ms:.4f} ms ({occ['blocks_per_sm']} blocks "
            f"an SM of {occ['threads']} threads, {occ['smem_bytes']} B of "
            f"shared memory a block), plain {plain_ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by}: {pairs} real pairs, {flops:.4e} "
            f"flop, {nbytes} B), library {library_ms} ms, max_abs_err "
            f"{max_abs:.3e}")
        results[f"{name}[tc1m]"].update(
            max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by, real_pairs=pairs, library_ms=library_ms,
            occupancy=occ)
    cut_col, n_cut = notched(c)
    for name, args in lattice_inputs(case, cut_col, dt).items():
        got, _ = lattice_hold(torch, f"tc1m notched ({n_cut} NaN sites)", name,
                              args)


def dfdt_conv3d(torch, args):
    """L2's library yardstick: one grouped torch.nn.functional.conv3d of the
    channels [sel(valid, v_x), sel(valid, v_y), sel(valid, v_z), valid]
    (padding 2, groups 4) with the weights g_b,o = dW0 V0 e_b,o at o + 2,
    which gives Gv_ab = sum_o g_b,o w_j v_a,j and Gw_b = sum_o g_b,o w_j;
    then dFdt_ab = Gv_ab - v_a,i Gw_b.  The port never calls it.  Timed
    (the conv3d call alone) with cuDNN's TF32 off, set and then restored,
    and held to the float64 plain version: the expanded form cancels
    across |v| / |v_i - v_j|, so its float32 error is bounded by the
    rounding of the expansion itself, 2e-5 max|v| max_b sum_o |g_b,o|
    (~125 terms at 6e-8 each), not by the result's own size.  Returns ms."""
    from sphinxsys_tpu_torch.benchmarks import median_ms
    from sphinxsys_tpu_torch.ops import lattice_sweeps as ls

    vel, valid, shape, taps, vol0 = args
    off, rows, _ = ls._dfdt_table(taps, float(vol0))
    m = ls._halo(off)
    k = 2 * m + 1
    weight = torch.zeros((4, 3, k, k, k), dtype=torch.float64)
    for (ox, oy, oz), g in zip(off.tolist(), rows):
        for b in range(3):
            weight[:, b, ox + m, oy + m, oz + m] = g[b]
    weight = weight.reshape(12, 1, k, k, k).to(vel.device, torch.float32)
    v = torch.where(valid[:, None], vel, 0.0)
    x = torch.cat([v, valid[:, None].to(vel.dtype)], dim=1).T.reshape(
        1, 4, *shape).contiguous()
    conv = torch.nn.functional.conv3d
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        ms = median_ms(lambda: conv(x, weight, padding=m, groups=4), 20, DEVICE)
        y = conv(x, weight, padding=m, groups=4).reshape(4, 3, -1)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    got = y[:3].permute(2, 0, 1) - v[:, :, None] * y[3].T[:, None, :]
    ref = ls.lattice_dfdt_plain(vel.double(), valid, shape, taps, vol0)
    err = float((got.double() - ref).abs().max())
    gsum = max(sum(abs(g[b]) for g in rows) for b in range(3))
    limit = 2e-5 * float(v.abs().max()) * gsum
    log(f"L2 library yardstick (conv3d, groups 4, TF32 off): {ms:.4f} ms, "
        f"|conv - p64| {err:.3e} (bound {limit:.3e}, max|ref| "
        f"{float(ref.abs().max()):.3e})")
    check(err <= limit, f"L2 conv3d yardstick off by {err:.3e} > {limit:.3e}")
    return ms


def edge_lattice(torch, shape, cut, seed):
    """L1's and L2's arguments on a synthetic lattice of `shape` (dx = 0.1,
    h = 1.3 dx): positions on the lattice with seeded noise, S ~ 1e5 N(0, 1),
    J ~ 1 + 0.01 N(0, 1), v ~ N(0, 1); the sites of `cut` (a function of
    the site indices (ix, iy, iz)) invalid with NaN planted in every field.
    Returns (inputs by wrapper name, sites cut)."""
    from sphinxsys_tpu_torch.core.adaptation import SPHAdaptation
    from sphinxsys_tpu_torch.physics import solid_lattice as sl

    dx = 0.1
    lat = sl.make_lattice(SPHAdaptation(spacing=dx, dim=3).kernel, dx, shape)
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    idx = torch.stack(torch.meshgrid(
        *[torch.arange(n, device=DEVICE) for n in shape], indexing="ij"),
        dim=-1).reshape(-1, 3)
    n = idx.shape[0]
    rand = lambda *sz: torch.randn(*sz, generator=g, device=DEVICE)
    pos = idx.float() * dx + 0.01 * dx * rand(n, 3)
    S, J, vel = 1e5 * rand(n, 3, 3), 1.0 + 0.01 * rand(n), rand(n, 3)
    valid = ~cut(idx[:, 0], idx[:, 1], idx[:, 2])
    for t in (pos, S, J, vel):
        t[~valid] = float("nan")
    return ({"lattice_force": (pos, S, J, valid, shape, lat.taps, dx ** 3,
                               4.2e6),
             "lattice_dfdt": (vel, valid, shape, lat.taps, dx ** 3)},
            int((~valid).sum()))


def solid_edge_checks(torch):
    """Where the staged design could break, L1 and L2 against their plain
    versions at every site: a ragged lattice smaller than a brick in y and
    z (37 x 13 x 11) with a notch and 5% of its sites scattered invalid,
    NaN planted in them; lattices one site thick in x, y and z; a lattice
    whose first brick of each kernel (x < 8, y < 8, z < 32) is all invalid,
    NaN inside, next to valid ones."""
    none = lambda ix, iy, iz: torch.zeros_like(ix, dtype=torch.bool)
    g = torch.Generator(device=DEVICE).manual_seed(17)

    def notch_and_scatter(ix, iy, iz):
        r = torch.rand(ix.shape, generator=g, device=DEVICE)
        return ((ix > 10) & (ix < 16) & (iy > 6)) | (r < 0.05)

    cases = (
        ("ragged 37x13x11, notch and scatter", (37, 13, 11), notch_and_scatter),
        ("one thick in x 1x13x40", (1, 13, 40), none),
        ("one thick in y 13x1x40", (13, 1, 40), none),
        ("one thick in z 13x40x1", (13, 40, 1), none),
        ("dead brick 20x14x40", (20, 14, 40),
         lambda ix, iy, iz: (ix < 8) & (iy < 8) & (iz < 32)),
    )
    for k, (tag, shape, cut) in enumerate(cases):
        inputs, n_cut = edge_lattice(torch, shape, cut, 100 + k)
        for name, args in inputs.items():
            lattice_hold(torch, f"{tag} ({n_cut} NaN sites)", name, args)


def solid_golden_check(torch, engine="lattice"):
    """The twisting column at dx = 0.1 on `engine` (the lattice one through
    the kernels) to t = 0.5, the tip sampled every 20 steps as
    benchmarks/run_refdb_parity.py:544-553 did: the envelope of
    tests/test_twisting_column.py:33-34; the tip x within JAX_CURVE_BOUND
    of the JAX package's own float32 run (JAX_CURVE) at every one of its
    140 snapshots; and within 0.1 (one dx) of the committed curve
    (SOLID_GOLDEN) at each of the GOLDEN_HELD leading snapshots, the span
    over which the JAX package's own run reproduces it; beyond it only the
    largest gap is printed."""
    from sphinxsys_tpu_torch.cases import twisting_column_3d as tc

    case, col = tc.build_case(dx=0.1, engine=engine, device=DEVICE)
    s = tc.init_sim(case, col)
    idx, w = tc.tip_observer(case, col)
    xs = [float(tc.observe_tip(s, idx, w)[0])]
    t0 = time.perf_counter()
    while float(s.time) < 0.5:
        for _ in range(20):
            s = tc._step(case, s)
        xs.append(float(tc.observe_tip(s, idx, w)[0]))
    run_s = time.perf_counter() - t0
    gold = golden_tip_x()
    gaps = [abs(a - b) for a, b in zip(xs, gold)]
    held = max(gaps[:GOLDEN_HELD])
    own = jax_tip_x()
    own_gap = max(abs(a - b) for a, b in zip(xs, own))
    log(f"tc golden ({engine}): dx=0.1 {s.n_steps} steps to t={float(s.time):.6f} in "
        f"{run_s:.2f} s, {len(xs)} snapshots (the curve {len(gold)}), tip x "
        f"in [{min(xs):.4f}, {max(xs):.4f}] (the curve [{min(gold):.4f}, "
        f"{max(gold):.4f}]), max |x - curve| {held:.4e} over the first "
        f"{GOLDEN_HELD} snapshots, {max(gaps):.4e} over all {len(gaps)}; "
        f"max |x - JAX curve| {own_gap:.4e} over its {len(own)} snapshots "
        f"(bound {JAX_CURVE_BOUND})")
    check(9.0 < max(xs) < 10.2 and 2.8 < min(xs) < 3.8,
          f"tc golden: tip envelope [{min(xs)}, {max(xs)}]")
    check(len(xs) >= GOLDEN_HELD, f"tc golden: only {len(xs)} snapshots")
    check(held <= 0.1, f"tc golden: tip x off the curve by {held:.4e}")
    check(len(xs) == len(own),
          f"tc golden: {len(xs)} snapshots, the JAX curve {len(own)}")
    check(own_gap <= JAX_CURVE_BOUND,
          f"tc golden: tip x off the JAX curve by {own_gap:.4e}")
    return dict(snapshots=len(xs), max_gap_held=held, max_gap=max(gaps),
                max_gap_jax_curve=own_gap, tip_min=min(xs), tip_max=max(xs))


def solid_small_reference(torch, t_end=0.02):
    """The dx = 0.1 column on the card through the kernels against the same
    run through the plain versions: equal step counts, positions within
    5e-5 of max|x|."""
    from sphinxsys_tpu_torch.cases import twisting_column_3d as tc

    runs = []
    for use_kernels in (True, False):
        case, col = tc.build_case(dx=0.1, engine="lattice", device=DEVICE,
                                  use_kernels=use_kernels)
        runs.append(tc.make_run_chunk(case)(tc.init_sim(case, col), t_end))
    (k, p) = runs
    err = float((k.column["Position"] - p.column["Position"]).abs().max())
    scale = float(p.column["Position"].abs().max())
    log(f"tc small reference: dx=0.1 to t={t_end} kernels {k.n_steps} steps, "
        f"plain {p.n_steps} steps, max |dpos| {err:.3e} (max|x| {scale:.3f})")
    check(k.n_steps == p.n_steps, "tc small reference: step counts differ")
    check(err <= 5e-5 * scale,
          f"tc small reference: positions differ by {err:.3e}")


def gather_solid_check(torch, lcase, ls_state, results):
    """Phase 10, at the bench's dx: the gather engine's frozen topology
    (cell table, row-chunked neighbour lists, frozen pairs, B) built on the
    card, timed, with its peak device memory; then, from the lattice main
    path's state, GATHER_STEPS steps of each engine (the lattice one
    through L1 / L2): equal step counts and positions within
    GATHER_POS_TOL of max|x|.  The gather engine's pair sums are torch ops
    over the frozen (N, K) lists, no hand kernel: an independent oracle for
    L1 / L2 at full size."""
    from sphinxsys_tpu_torch.cases import twisting_column_3d as tc
    from sphinxsys_tpu_torch.physics import solid as sd

    torch.cuda.synchronize()
    base_mem = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gcase, gcol = tc.build_case(dx=SOLID_DX, engine="gather", device=DEVICE)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base_mem
    rp = gcase.rp
    pairs = int(rp.mask.sum())
    rp_bytes = sum(t.numel() * t.element_size() for t in rp)
    log(f"tc1m gather: topology of {gcase.n_column} sites, K={rp.idx.shape[1]}, "
        f"{pairs} frozen pairs ({rp_bytes / 1e9:.3f} GB frozen) built in "
        f"{build_s:.2f} s, peak device memory {peak / 1e9:.3f} GB over the "
        f"{base_mem / 1e9:.3f} GB already held")
    check(pairs == results["_tc1m_main"]["pairs_per_sweep"],
          f"tc1m gather: {pairs} frozen pairs, the lattice sweeps "
          f"{results['_tc1m_main']['pairs_per_sweep']}")

    start = {k: v for k, v in ls_state.column.items() if k != "LatticeValid"}
    start["LinearGradientCorrectionMatrix"] = gcol["LinearGradientCorrectionMatrix"]
    g = tc.SimState(column=start, time=ls_state.time, n_steps=0)
    lat = tc.SimState(column=ls_state.column, time=ls_state.time, n_steps=0)
    for _ in range(GATHER_STEPS):
        g, lat = tc._step(gcase, g), tc._step(lcase, lat)
    err = float((g.column["Position"] - lat.column["Position"]).abs().max())
    scale = float(lat.column["Position"].abs().max())
    dt_gap = abs(float(g.time) - float(lat.time))
    log(f"tc1m gather vs lattice: {GATHER_STEPS} steps from the main path's "
        f"state, max |dpos| {err:.3e} (max|x| {scale:.3f}), |dt sum gap| "
        f"{dt_gap:.3e}")
    for k in ("Position", "Velocity", "DeformationGradient"):
        check(bool(torch.isfinite(g.column[k]).all()), f"tc1m gather: non-finite {k}")
    check(err <= GATHER_POS_TOL * scale,
          f"tc1m gather: positions off the lattice path's by {err:.3e}")

    step_ms = wall_s(torch, lambda: tc._step(gcase, g), 3) * 1e3
    dev_us, wall_us, _, launches = profile_step(
        torch, "tc1m_gather", lambda: tc._step(gcase, g), "gather step")
    peak_step = torch.cuda.max_memory_allocated() - base_mem
    bound = frozen_bound(torch, rp, g.column)
    log(f"tc1m gather step bound (its frozen pairs and fields): "
        f"{bound[0]:.4f} ms ({bound[1]}, {bound[2]} pairs)")
    log(f"tc1m gather path: steady step {step_ms:.3f} ms (wall clock, median "
        f"of 3; the lattice path's {results['_tc1m_main']['parts_ms']['step']:.3f}"
        f" ms), {launches} device launches a step, device busy "
        f"{dev_us / 1e3:.3f} ms; peak device memory with a step "
        f"{peak_step / 1e9:.3f} GB")
    results["_tc_gather"] = dict(
        build_s=build_s, build_peak_gb=peak / 1e9, frozen_gb=rp_bytes / 1e9,
        step_peak_gb=peak_step / 1e9, ms_per_step=step_ms,
        launches_per_step=launches, device_busy_ms=dev_us / 1e3,
        pos_gap=err, steps=GATHER_STEPS, bound=bound)
    del gcase, gcol, g, lat, rp, start


def solid_phase(torch, results):
    """Phases 8 and 10: the lattice solid, then the gather solid."""
    t0 = time.perf_counter()
    case, s = solid_main_path(torch, results)
    solid_kernel_checks(torch, case, s, results)
    gather_solid_check(torch, case, s, results)
    del case, s
    torch.cuda.empty_cache()
    solid_edge_checks(torch)
    solid_small_reference(torch)
    results["_tc1m_main"]["golden"] = solid_golden_check(torch)
    results["_tc_gather"]["golden"] = solid_golden_check(torch, "gather")
    log(f"solid phases: {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# 9. fsi2: the moving-wall, x-periodic path through B1-B4
# ---------------------------------------------------------------------------

def fsi2_gates():
    """What the card's fsi2 run to FSI2_T_END is held to, from the JAX
    package's own float32 runs at dx = 0.1 (FSI2_JAX_RUNS: its block and
    gather routes, x64 on and off, to t = 5; tests/test_torch_fsi2.py
    writes them).  Counts: the acoustic (n_ac) and solid (n_s) sub-steps
    within FSI2_COUNT_BAND of the block route's with x64 on at its first
    sample past FSI2_T_END (391 / 782 at t = 2.5; the four runs span
    389-418 / 778-835 there, 785-815 / 1,570-1,629 at t = 5, so a 20%
    band holds them all and a broken coupling, which shrinks the time
    steps, still falls out).  Tip: the beam tip's
    displacement from its start, |d| at every sample, within the largest
    any of the four runs reaches (0.548, the block route with x64 off, at
    t < 1: the start-up pressure pulse at the tip, which the float32 runs
    resolve each their own way)."""
    runs = json.loads((ROOT / FSI2_JAX_RUNS).read_text())["runs"]
    ref = next(r for r in runs if r["route"] == "block" and r["x64"])
    n_ac, n_s = next(row for row in ref["rows"]
                     if row[0] >= FSI2_T_END)[2:4]
    band = lambda n: ((1 - FSI2_COUNT_BAND) * n, (1 + FSI2_COUNT_BAND) * n)
    radius = max(math.hypot(row[4], row[5]) for r in runs for row in r["rows"])
    return dict(n_ac=band(n_ac), n_s=band(n_s), tip_radius=radius)


def coincident_check(torch, tag, scene, sim):
    """B1-B4 with coincident particles: in every row whose first two slots
    are real, slot 1 moved onto slot 0 (r = 0 within the cell), each
    against its plain version on the same inputs."""
    from sphinxsys_tpu_torch.benchmarks import sweep_inputs

    c = sim.nbr_inner.shape[0]
    real = sim.fluid_b["SlotMask"][:c]
    both = sim.fluid_b["SlotMask"][:, 0] & sim.fluid_b["SlotMask"][:, 1]
    for name, (args, kw) in sweep_inputs(scene, sim, tuple(KERNELS)).items():
        args = list(args)
        pos = args[0].clone()
        pos[both, 1] = pos[both, 0]
        args[0] = pos
        compare(torch, f"{tag} coincident", name, args, kw, real)
        log(f"{tag} coincident {name}: agrees with its plain version "
            f"({int(both.sum())} rows)")


class SyncCounter:
    """Counts the host reads of device values (`bool`, `float`, `int`,
    `item` of a tensor) inside a `with` block."""

    NAMES = ("__bool__", "__float__", "__int__", "item")

    def __init__(self, torch):
        self.cls, self.n = torch.Tensor, 0
        self.device = torch.device(DEVICE).type

    def __enter__(self):
        self.saved = {k: getattr(self.cls, k) for k in self.NAMES}

        def counted(fn):
            def wrapper(t, *a):
                if t.device.type == self.device:
                    self.n += 1
                return fn(t, *a)
            return wrapper

        for k, fn in self.saved.items():
            setattr(self.cls, k, counted(fn))
        return self

    def __exit__(self, *exc):
        for k, fn in self.saved.items():
            setattr(self.cls, k, fn)


def fsi2_short_check(torch):
    """fsi2 on the card to FSI2_SHORT through the kernels and through the
    block forms (`use_kernels=False`: torch ops, no hand kernel): equal
    counts, the fluid's positions and velocities by particle and the
    solid's positions within FSI2_SHORT_TOL."""
    from sphinxsys_tpu_torch.cases import fsi2 as fc
    from sphinxsys_tpu_torch.engine import scene as sc

    runs = {}
    for use_kernels in (True, False):
        scene, fluid, solid = fc.build_block_case(dx=FSI2_DX, device=DEVICE,
                                                  use_kernels=use_kernels)
        sim = sc.make_run_chunk(scene)(fc.init_block_sim(scene, fluid, solid),
                                       FSI2_SHORT)
        runs[use_kernels] = (sim, sc.blocks_to_particles(scene, sim))
    (k, pk), (b, pb) = runs[True], runs[False]
    counts = lambda s: (s.n_adv, s.n_ac, s.aux["n_s"])
    gaps = {f: float((pk[f] - pb[f]).abs().max()) for f in ("Position", "Velocity")}
    gaps["solid"] = float((k.aux["solid"]["Position"]
                           - b.aux["solid"]["Position"]).abs().max())
    log(f"fsi2 short: to t={FSI2_SHORT} kernels {counts(k)}, block forms "
        f"{counts(b)}; max gaps {gaps} (tolerance {FSI2_SHORT_TOL}; max|v| "
        f"{float(pb['Velocity'].abs().max()):.4e})")
    check(counts(k) == counts(b), "fsi2 short: the two routes' counts differ")
    check(not bool(k.overflow) and not bool(b.overflow), "fsi2 short: overflow")
    for f, gap in gaps.items():
        check(gap <= FSI2_SHORT_TOL, f"fsi2 short: {f} differ by {gap:.3e}")


def fsi2_phase(torch, results):
    """Phase 9: fsi2 at dx = 0.1 (5,180 fluid, 1,104 wall, 150 solid
    particles; the wall and the solid one moving wall-type body, x-periodic)
    on the card: B1-B4 against their plain versions on the state at
    FSI2_MID (also with holes, padding near the real slots and coincident
    particles), timed and bounded; the short two-route check; then the main
    path to FSI2_T_END through build_block_case -> init_block_sim ->
    make_run_chunk, launch counts reset just before it, the host reads of
    device values counted, the tip sampled every FSI2_SAMPLE and held to
    `fsi2_gates`; the step by part and profiled (the advection step, and
    the torch-op FSI couplings and solid sub-step on their own)."""
    from sphinxsys_tpu_torch.cases import fsi2 as fc
    from sphinxsys_tpu_torch.engine import block_fluid as eng_mod
    from sphinxsys_tpu_torch.engine import scene as sc
    from sphinxsys_tpu_torch.ops import block_sweeps as bs
    from sphinxsys_tpu_torch.physics import fsi, fsi_blocks as fsb
    from sphinxsys_tpu_torch.physics import solid as sd

    t0 = time.perf_counter()
    scene, fluid, solid = fc.build_block_case(dx=FSI2_DX, device=DEVICE)
    base, eng = scene.base, scene.eng
    run = sc.make_run_chunk(scene)
    mid = run(fc.init_block_sim(scene, fluid, solid), FSI2_MID)
    log(f"fsi2: n_fluid={base.n_fluid} n_wall={base.n_wall} "
        f"n_solid={base.n_solid} grid={eng.grid.shape} c_max={eng.c_max} "
        f"cap={eng.cap}; the state at t={float(mid.time):.4f} (n_adv "
        f"{mid.n_adv}) in {time.perf_counter() - t0:.1f} s")
    compare_kernels(torch, "fsi2", dict(kernels=tuple(KERNELS)), scene, mid,
                    results)
    padding_checks(torch, "fsi2", scene, mid,
                   torch.Generator(device=DEVICE).manual_seed(19))
    coincident_check(torch, "fsi2", scene, mid)
    fsi2_short_check(torch)

    gates = fsi2_gates()
    sim = fc.init_block_sim(scene, fluid, solid)
    idx, w = fc.tip_observer(base, solid)
    tip0 = fc.observe_tip(solid, idx, w)
    tip_max, samples = 0.0, 0
    bs.reset_launch_counts()
    t1 = time.perf_counter()
    with SyncCounter(torch) as syncs:
        while float(sim.time) < FSI2_T_END:
            samples += 1
            sim = run(sim, samples * FSI2_SAMPLE)
            d = fc.observe_tip(sim.aux["solid"], idx, w) - tip0
            tip_max = max(tip_max, float(torch.linalg.vector_norm(d)))
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t1
    counts = dict(bs.LAUNCHES)
    so = sim.aux["solid"]
    n_adv, n_ac, n_s = sim.n_adv, sim.n_ac, sim.aux["n_s"]
    part = sc.blocks_to_particles(scene, sim)
    n_sync = syncs.n - 2 * samples - 1   # the loop's own time tests, tip reads
    log(f"fsi2 main path: to t={float(sim.time):.6f} n_adv={n_adv} n_ac={n_ac} "
        f"n_s={n_s} (band n_ac {gates['n_ac']}, n_s {gates['n_s']}) in "
        f"{elapsed:.2f} s: {elapsed / n_adv * 1e3:.3f} ms an advection step "
        f"(wall clock, mean), launches {counts}, {n_sync} host reads of device "
        f"values ({n_sync / n_adv:.2f} an advection step); tip max|d| "
        f"{tip_max:.4f} (bound {gates['tip_radius']:.4f}), d at the end "
        f"{(fc.observe_tip(so, idx, w) - tip0).tolist()}")
    check(not bool(sim.overflow), "fsi2: block capacity overflow")
    for k in ("Position", "Velocity", "Density", "Pressure"):
        check(bool(torch.isfinite(part[k]).all()), f"fsi2: non-finite fluid {k}")
    for k in ("Position", "Velocity", "DeformationGradient"):
        check(bool(torch.isfinite(so[k]).all()), f"fsi2: non-finite solid {k}")
    check(counts["density"] == counts["visc_tvc"] == n_adv
          and counts["ac1"] == counts["ac2"] == n_ac,
          f"fsi2: launches {counts} for {n_adv} steps and {n_ac} sub-steps")
    check(gates["n_ac"][0] <= n_ac <= gates["n_ac"][1]
          and gates["n_s"][0] <= n_s <= gates["n_s"][1],
          f"fsi2: counts {n_ac} / {n_s} off the band")
    check(tip_max <= gates["tip_radius"],
          f"fsi2: tip displaced {tip_max:.4f} > {gates['tip_radius']:.4f}")
    for name, (_, key) in KERNELS.items():
        results[f"{name}[fsi2]"]["launches"] = counts[key]

    # the step by part (host wall clock, synchronised) and profiled
    h, kern, w0 = base.adaptation.h, base.kernel, base.kernel.w0(2)
    fb, aux = sim.fluid_b, sim.aux
    c0s = base.material_s.sound_speed
    hooks = scene.hooks
    wc = eng_mod.WallCtx(eng_mod.refresh_wall_blocks(
        sim.wall_bm, scene.wall_state_fn(aux), sim.wall_b0), sim.nbr_wall)
    dt = eng_mod.acoustic_dt(eng, fb, eng_mod.advection_dt(eng, fb))
    dt_s = torch.minimum(sd.solid_acoustic_time_step(so, c0s, h), dt)

    def acoustic_substep():
        w_ = eng_mod.WallCtx(eng_mod.refresh_wall_blocks(
            sim.wall_bm, scene.wall_state_fn(aux), sim.wall_b0), sim.nbr_wall)
        f = eng_mod.acoustic_first_half(eng, fb, sim.nbr_inner, w_, dt)
        f, a = hooks.after_first_half(f, aux, dt, sim.time)
        f = eng_mod.acoustic_second_half(eng, f, sim.nbr_inner, w_, dt)
        hooks.post_acoustic(f, a, dt, sim.time + dt)

    def solid_substep():
        d = torch.minimum(sd.solid_acoustic_time_step(so, c0s, h), dt)
        x = sd.integration_1st_half_pk2(so, base.rp, base.material_s, d, h, w0)
        sd.integration_2nd_half(sd.fix_constraint(x, base.base_mask), base.rp, d)

    pressure = lambda: fsb.pressure_force_from_fluid_b(
        so, fb, aux["sol_win"], kern, 2, base.riemann, box=eng.box)
    viscous = lambda: fsi.update_elastic_normal_direction(
        fsb.viscous_force_from_fluid_b(so, fb, aux["sol_win"], kern, 2,
                                       fc.MU_F, h, box=eng.box))
    step = sc.make_advection_step(scene)
    flat = {k: fb[k].reshape((-1,) + tuple(fb[k].shape[2:])) for k in scene.fields}
    parts = {
        "advection_step": wall_s(torch, lambda: step(sim), 3),
        "prep": wall_s(torch, lambda: eng_mod.advection_prep(
            eng, fb, sim.nbr_inner, wc), 5),
        "acoustic_substep": wall_s(torch, acoustic_substep, 5),
        "fluid_halves": wall_s(torch, lambda: eng_mod.acoustic_second_half(
            eng, eng_mod.acoustic_first_half(eng, fb, sim.nbr_inner, wc, dt),
            sim.nbr_inner, wc, dt), 5),
        "solid_substep": wall_s(torch, solid_substep, 5),
        "pressure_force": wall_s(torch, pressure, 5),
        "viscous_force": wall_s(torch, viscous, 5),
        "reslot": wall_s(torch, lambda: sc._slot(scene, flat, fb["SlotMask"].reshape(-1),
                                                 aux), 5),
    }
    parts = {k: v * 1e3 for k, v in parts.items()}
    log("fsi2 step parts (ms, wall clock): "
        + ", ".join(f"{k} {v:.3f}" for k, v in parts.items()))
    dev_us, wall_us, plain_us, launches = profile_step(torch, "fsi2",
                                                       lambda: step(sim))
    coupling = {}
    for tag, fn in (("solid_substep", solid_substep),
                    ("pressure_force", pressure), ("viscous_force", viscous)):
        c_us, _, _, c_n = profile_step(torch, f"fsi2_{tag}", fn, tag)
        coupling[tag] = dict(device_ms=c_us / 1e3, launches=c_n)
    results["_fsi2_main"] = dict(
        t_end=float(sim.time), n_adv=n_adv, n_ac=n_ac, n_s=n_s,
        ms_per_adv=elapsed / n_adv * 1e3, host_reads_per_adv=n_sync / n_adv,
        parts_ms=parts, device_busy_ms=dev_us / 1e3,
        launches_per_adv=launches, idle_share_est=1 - dev_us / plain_us,
        tip_max=tip_max, coupling=coupling)
    log(f"fsi2 phase: {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# 11. gather fluid: the neighbour-list WCSPH routes (torch ops, no kernel)
# ---------------------------------------------------------------------------

def gather_small_reference(torch, module, dx, t_end):
    """A gather route at a small size on the card against the same run on
    the CPU, both float32: equal step counts, positions by particle within
    5e-5 (sums over the same slots in other orders)."""
    case_mod = importlib.import_module(f"sphinxsys_tpu_torch.cases.{module}")
    runs = {}
    for dev in (DEVICE, "cpu"):
        case, fluid = case_mod.build_case(dx=dx, device=dev)
        sim = case_mod.make_run_chunk(case)(case_mod.init_sim(case, fluid),
                                            t_end)
        runs[dev] = (sim, sim.fluid["Position"].cpu())
    (gs, gp), (cs, cp) = runs[DEVICE], runs["cpu"]
    err = float((gp - cp).abs().max())
    log(f"gather small reference: {module} dx={dx} to t={t_end} card "
        f"n_adv={gs.n_adv} n_ac={gs.n_ac}, cpu n_adv={cs.n_adv} "
        f"n_ac={cs.n_ac}, max |dpos| {err:.3e}")
    check((gs.n_adv, gs.n_ac) == (cs.n_adv, cs.n_ac),
          f"gather small reference {module}: step counts differ")
    check(not bool(gs.overflow), f"gather small reference {module}: overflow")
    check(err <= 5e-5, f"gather small reference {module}: positions differ "
          f"by {err:.3e}")


def gather_block_oracle(torch):
    """The third oracle on the card: the gather route against the block
    route through the CUDA kernels, on the scenes of
    tests/test_scene_engines.py: equal counts, positions within 2e-3 of
    max|x| (minimum image where the box wraps)."""
    from sphinxsys_tpu_torch.engine import scene as sc

    for module, dx, t_end, block_kw in GATHER_ORACLE_SCENES:
        cm = importlib.import_module(f"sphinxsys_tpu_torch.cases.{module}")
        case, fluid = cm.build_case(dx=dx, device=DEVICE)
        g = cm.make_run_chunk(case)(cm.init_sim(case, fluid), t_end)
        scene, fluid_b = cm.build_block_case(dx=dx, device=DEVICE, **block_kw)
        b = sc.make_run_chunk(scene)(sc.init_sim(scene, fluid_b), t_end)
        n = scene.n_fluid
        d = g.fluid["Position"][:n] - sc.blocks_to_particles(scene, b)["Position"][:n]
        if scene.wrap:
            from sphinxsys_tpu_torch.neighbors.cell_list import min_image
            d = min_image(d, case.grid.periodic_lengths)
        err = float(d.abs().max())
        scale = float(g.fluid["Position"][:n].abs().max())
        log(f"gather vs block: {module} dx={dx} to t={t_end}: gather "
            f"{g.n_adv}/{g.n_ac}, block (kernels) {b.n_adv}/{b.n_ac}, max "
            f"|dpos| {err:.3e} (bound {2e-3 * scale:.3e})")
        check(not bool(g.overflow) and not bool(b.overflow),
              f"gather vs block {module}: overflow")
        check((g.n_adv, g.n_ac) == (b.n_adv, b.n_ac),
              f"gather vs block {module}: step counts differ")
        check(err < 2e-3 * scale, f"gather vs block {module}: positions "
              f"differ by {err:.3e}")


def peak_gb(torch):
    return torch.cuda.max_memory_allocated() / 1e9


def profile_parts(torch, tag, fns):
    """Each part of a step (name -> fn) profiled alone, as `profile_step`
    profiles a step: {name: device busy ms, device launches, unprofiled
    wall ms and the estimated idle share of that wall}."""
    out = {}
    for name, fn in fns.items():
        dev_us, _, plain_us, n = profile_step(torch, f"{tag}_{name}", fn, name)
        out[name] = dict(device_ms=dev_us / 1e3, launches=n,
                         wall_ms=plain_us / 1e3,
                         idle_share_est=1 - dev_us / plain_us)
    return out


# float32 operations a real pair costs in the torch-op pair sums over
# neighbour lists, counted from their formulas (2D; 3D adds ~20%): the
# pair geometry (displacement, r, e, the kernel's polynomial) ~20, then
# the sum's own terms
LIST_PAIR_FLOPS = {
    "density": 22,            # W and its sum (+ the contact's m / rho0)
    "surface_indication": 26,  # dW V r, the neighbours' flags
    "acoustic_substep": 75,   # both halves: p, u jumps, Riemann, forces
    "coupling": 40,           # the FSI pressure or viscous force a pair
    "contact": 60,            # the shell factor, repulsion and friction
    "solid_substep": 60,      # the frozen pairs' stress and dF/dt sums
    "correction": 30,         # r e outer dW V e, both sums of A
    "corrected_1st_half": 50,  # B_i e, B_j e, the pressure and Riemann terms
    "contact_1st_half": 60,   # the inner and wall terms, the phases' p*
    # the surface tension's stress (a contact pair: ~30) and stress force
    # (the (d, d) products M M, T mismatch, S e a pair: ~110 in 2D, ~280
    # in 3D), a pair of both lists on average
    "surface_tension_2d": 110,
    "surface_tension_3d": 280,
}


def list_bound(torch, part, lists, reads, writes):
    """The least time (ms) the card could take for one torch-op pass over
    (N, K) neighbour lists, from this run's tensors: each list's index
    table and each per-particle array in `reads` read once, each array in
    `writes` written once, over 3.35 TB/s; the real pairs (the lists'
    counts, at most K a row) times LIST_PAIR_FLOPS[part] over 67 TFLOP/s.
    Returns (ms, "bytes"|"operations", real pairs)."""
    nbytes = sum(t.numel() * t.element_size()
                 for t in (*(nl.idx for nl in lists), *reads, *writes))
    pairs = sum(int(torch.clamp(nl.count, max=nl.idx.shape[1]).sum())
                for nl in lists)
    ms, by = bytes_or_flops(nbytes, pairs * LIST_PAIR_FLOPS.get(part, 0))
    return ms, by, pairs


def fields(state, *names):
    return [state[k] for k in names if k in state]


FLUID_AC_READS = ("Position", "Velocity", "Density", "VolumetricMeasure",
                  "Mass", "Force", "ForcePrior", "DensityChangeRate")
FLUID_AC_WRITES = ("Position", "Velocity", "Density", "Pressure", "Force",
                   "DensityChangeRate")
WALL_READS = ("Position", "VolumetricMeasure", "NormalDirection",
              "AverageVelocity", "AverageAcceleration")
# a total-Lagrangian solid step's per-particle arrays (those a state lacks
# are skipped: the fish's composite fields, the column's holder)
SOLID_READS = ("Position", "Velocity", "DeformationGradient",
               "DeformationRate", "LinearGradientCorrectionMatrix",
               "VolumetricMeasure", "Mass", "ForcePrior", "InitialPosition",
               "MaterialID", "Lambda0", "ShearModulus",
               "ActiveContractionStress", "Fiber")
SOLID_WRITES = ("Position", "Velocity", "DeformationGradient",
                "DeformationRate", "Density", "StressPK1OnParticle", "Force",
                "ActiveStrain")


def frozen_bound(torch, rp, solid):
    """`list_bound` of one solid step (both halves) over the frozen pairs
    `rp`: their index table, W, dW, r, e and mask read once."""
    import types

    frozen = types.SimpleNamespace(idx=rp.idx, count=rp.mask.sum(1))
    return list_bound(torch, "solid_substep", [frozen],
                      [rp.W, rp.dW, rp.r, rp.e, rp.mask]
                      + fields(solid, *SOLID_READS),
                      fields(solid, *SOLID_WRITES))


def gather_main_path(torch, tag, cfg, results):
    """The gather dambreak at full width through build_case -> init_sim ->
    make_run_chunk -> solver.run_simulation, the block kernels' launch
    counts reset just before and read just after (the route launches
    none); then the step by part, one profiled step, each part profiled
    alone and the peak device memory, beside the block route's figures for
    the same config from phase 5 of this run."""
    from sphinxsys_tpu_torch import solver
    from sphinxsys_tpu_torch.neighbors.cell_list import morton_resort
    from sphinxsys_tpu_torch.ops import block_sweeps as bs
    from sphinxsys_tpu_torch.physics import fluid as fd
    from sphinxsys_tpu_torch.physics import general as gd

    db = importlib.import_module(f"sphinxsys_tpu_torch.cases.{cfg['module']}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    case, fluid = db.build_case(dx=cfg["dx"], device=DEVICE)
    if cfg["sort_every"]:
        case = dataclasses.replace(case, sort_every=cfg["sort_every"])
    sim = db.init_sim(case, fluid)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    e0 = float(gd.total_mechanical_energy(sim.fluid, case.gravity))
    h = case.adaptation.h
    dt0 = float(fd.advection_time_step(sim.fluid, h, db.U_REF))
    end_time = (cfg["min_adv"] + 0.5) * dt0
    bs.reset_launch_counts()
    sim, timer = solver.run_simulation(db.make_run_chunk(case), sim, end_time,
                                       end_time, verbose=False)
    counts = dict(bs.LAUNCHES)
    torch.cuda.synchronize()
    peak_run = peak_gb(torch)
    e1 = float(gd.total_mechanical_energy(sim.fluid, case.gravity))
    drift = abs(e1 - e0) / abs(e0)
    sorts = sim.n_adv // case.sort_every if case.sort_every else 0
    integ = timer.totals["integrate"]
    log(f"gather {tag} main path: n_fluid={case.n_fluid} n_wall={case.n_wall} "
        f"grid={case.grid.shape} cell_cap={case.cell_cap} K={case.k_inner}/"
        f"{case.k_wall} sort_every={case.sort_every}; setup {setup_s:.2f} s; "
        f"n_adv={sim.n_adv} n_ac={sim.n_ac} ({sorts} resorts) energy "
        f"{e0:.9e} -> {e1:.9e} (change {drift:.3e}); {integ / sim.n_adv * 1e3:.3f}"
        f" ms an advection step (wall clock, mean, the first included); block "
        f"kernel launches {counts}; peak device memory {peak_run:.3f} GB")
    check(sim.n_adv >= cfg["min_adv"], f"gather {tag}: only {sim.n_adv} steps")
    check(cfg["sort_every"] is None or sorts >= 2,
          f"gather {tag}: the resort ran {sorts} times")
    check(not bool(sim.overflow), f"gather {tag}: neighbour-list overflow")
    for k in ("Position", "Velocity", "Density", "Pressure"):
        check(bool(torch.isfinite(sim.fluid[k]).all()),
              f"gather {tag}: non-finite {k}")
    check(drift < 0.01, f"gather {tag}: energy drift {drift:.3e} >= 1%")
    check(not any(counts.values()), f"gather {tag}: the route launched a "
          f"block kernel {counts}")

    # the step by part (host wall clock, synchronised), peak memory of each
    step = db.make_advection_step(case)
    f = sim.fluid
    parts, peaks = {}, {}
    reps_step, reps = GATHER_REPS
    timed = [
        ("advection_step", lambda: step(sim), reps_step),
        ("rebuild", lambda: db.rebuild_relations(case, f), reps),
        ("density", lambda: fd.density_summation(
            f, sim.nl_inner, case.kernel, case.dim, db.RHO0_F,
            case.adaptation.sigma0,
            contacts=[(case.wall, sim.nl_wall, db.RHO0_F)]), reps),
        ("acoustic_substep", lambda: db.acoustic_substep(case, sim, f),
         reps)]
    if case.sort_every:
        timed.append(("resort", lambda: morton_resort(f, case.grid), reps))
    for name, fn, reps in timed:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        parts[name] = wall_s(torch, fn, reps) * 1e3
        peaks[name] = (torch.cuda.max_memory_allocated() - base) / 1e9
    dt_adv = fd.advection_time_step(f, h, db.U_REF)
    dt_ac = fd.acoustic_time_step(f, case.eos, h)
    substeps = float(dt_adv / dt_ac)
    block = results.get(f"_{tag}_main", {})
    log(f"gather {tag} step parts (ms, wall clock): "
        + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
        + f"; ~{substeps:.2f} acoustic sub-steps a step; the block route's "
        f"(phase 5): {json.dumps(block.get('parts_ms'))}")
    log(f"gather {tag} peak device memory above the state, by part (GB): "
        + ", ".join(f"{k} {v:.3f}" for k, v in peaks.items()))
    dev_us, wall_us, plain_us, launches = profile_step(
        torch, f"gather_{tag}", lambda: step(sim))
    # the device time of each part, which decides what the step needs
    # first: the pair sums (the density and the run's sub-steps a step)
    # against the rebuild
    prof = profile_parts(torch, f"gather_{tag}",
                         {k: fn for k, fn, _ in timed if k != "advection_step"})
    per_adv = sim.n_ac / sim.n_adv
    pair_ms = (prof["density"]["device_ms"]
               + per_adv * prof["acoustic_substep"]["device_ms"])
    bound_den = list_bound(
        torch, "density", [sim.nl_inner, sim.nl_wall],
        fields(f, "Position", "Mass") + fields(case.wall, "Position", "Mass"),
        fields(f, "DensitySummation", "Density"))
    bound_ac = list_bound(
        torch, "acoustic_substep", [sim.nl_inner, sim.nl_wall],
        fields(f, *FLUID_AC_READS) + fields(case.wall, *WALL_READS),
        fields(f, *FLUID_AC_WRITES))
    pair_bound = bound_den[0] + per_adv * bound_ac[0]
    log(f"gather {tag} bounds (from this run's lists and fields): density "
        f"{bound_den[0]:.4f} ms ({bound_den[1]}), an acoustic sub-step "
        f"{bound_ac[0]:.4f} ms ({bound_ac[1]}), {bound_den[2]} real pairs a "
        f"pass; the pair sums a step {pair_bound:.4f} ms against their "
        f"device {pair_ms:.3f}")
    log(f"gather {tag} device ms by part (each profiled alone): "
        + ", ".join(f"{k} {v['device_ms']:.3f} in {v['launches']} launches "
                    f"(idle share {v['idle_share_est']:.3f})"
                    for k, v in prof.items())
        + f"; pair sums a step (density + {per_adv:.2f} sub-steps) "
        f"{pair_ms:.3f} against the rebuild's "
        f"{prof['rebuild']['device_ms']:.3f}, of the step's device busy "
        f"{dev_us / 1e3:.3f}")
    results[f"_gather_{tag}"] = dict(
        n_fluid=case.n_fluid, n_adv=sim.n_adv, n_ac=sim.n_ac, resorts=sorts,
        ms_per_adv=integ / sim.n_adv * 1e3, parts_ms=parts,
        part_device=prof, pair_sum_device_ms=pair_ms,
        pair_sum_bound_ms=pair_bound, density_bound=bound_den,
        substep_bound=bound_ac,
        part_peak_gb=peaks, run_peak_gb=peak_run, device_busy_ms=dev_us / 1e3,
        launches_per_adv=launches, idle_share_est=1 - dev_us / plain_us,
        energy_change=drift, block_ms_per_adv=block.get("ms_per_adv"))
    del case, fluid, sim, f, step
    torch.cuda.empty_cache()


def gather_tg_decay(torch, results):
    """Taylor–Green on the gather route at dx=0.01 to t=0.1: the kinetic
    energy within 8% of KE0 exp(-16 pi^2 nu t), as `tg_decay_check`
    holds the block route; then its step by part, one profiled step and
    each part profiled alone."""
    from sphinxsys_tpu_torch.cases import taylor_green_2d as tg
    from sphinxsys_tpu_torch.physics import fluid as fd
    from sphinxsys_tpu_torch.physics import general as gd

    torch.cuda.reset_peak_memory_stats()
    case, fluid = tg.build_case(dx=0.01, device=DEVICE)
    sim = tg.init_sim(case, fluid)
    ke0 = float(gd.total_kinetic_energy(sim.fluid))
    t0 = time.perf_counter()
    sim = tg.make_run_chunk(case)(sim, 0.1)
    elapsed = time.perf_counter() - t0
    ke = float(gd.total_kinetic_energy(sim.fluid))
    nu = tg.MU_F / tg.RHO0_F
    expected = ke0 * math.exp(-16.0 * math.pi ** 2 * nu * float(sim.time))
    rel = abs(ke - expected) / expected
    log(f"gather tg decay: dx=0.01 t={float(sim.time):.6f} n_adv={sim.n_adv} "
        f"n_ac={sim.n_ac} KE0={ke0:.9f} KE={ke:.9f} analytic {expected:.9f} "
        f"(rel {rel:.4f}); {elapsed / sim.n_adv * 1e3:.3f} ms an advection "
        f"step (wall clock, mean)")
    check(not bool(sim.overflow), "gather tg decay: overflow")
    check(rel < 0.08, f"gather tg decay: KE off the analytic decay by {rel:.4f}")

    step = tg.make_advection_step(case)
    f = sim.fluid
    dt_adv = fd.advection_viscous_time_step(f, case.adaptation.h, tg.U_F,
                                            tg.RHO0_F, tg.MU_F)
    fns = {"rebuild": lambda: tg.rebuild_inner(case, f),
           "prep": lambda: tg.advection_prep(case, sim, f),
           "acoustic_substep": lambda: tg.acoustic_substep(case, sim, f,
                                                           dt_adv)}
    parts = {"advection_step": wall_s(torch, lambda: step(sim), 3) * 1e3}
    parts.update({k: wall_s(torch, fn, 5) * 1e3 for k, fn in fns.items()})
    log("gather tg step parts (ms, wall clock): "
        + ", ".join(f"{k} {v:.3f}" for k, v in parts.items()))
    dev_us, _, plain_us, launches = profile_step(torch, "gather_tg",
                                                 lambda: step(sim))
    prof = profile_parts(torch, "gather_tg", fns)
    results["_gather_tg"] = dict(
        n_fluid=case.n_fluid, n_adv=sim.n_adv, n_ac=sim.n_ac,
        ms_per_adv=elapsed / sim.n_adv * 1e3, parts_ms=parts, part_device=prof,
        device_busy_ms=dev_us / 1e3, launches_per_adv=launches,
        idle_share_est=1 - dev_us / plain_us, ke_rel=rel,
        run_peak_gb=peak_gb(torch))


def fsi2_gather_gates():
    """What the card's fsi2 gather run to FSI2_GATHER_T_END is held to: the
    acoustic and solid sub-step counts within FSI2_COUNT_BAND of the JAX
    package's float32 gather runs at their first sample past that time
    (x64 on and off), outside the span of both widened by the band; the
    tip's excursion within the largest of all four JAX float32 runs
    (`fsi2_gates`: the start-up pulse, which each float32 run resolves
    its own way)."""
    runs = json.loads((ROOT / FSI2_JAX_RUNS).read_text())["runs"]
    gather = [r for r in runs if r["route"] == "gather"]
    rows = [next(row for row in r["rows"] if row[0] >= FSI2_GATHER_T_END)
            for r in gather]
    n_ac = [row[2] for row in rows]
    n_s = [row[3] for row in rows]
    band = lambda ns: ((1 - FSI2_COUNT_BAND) * min(ns),
                       (1 + FSI2_COUNT_BAND) * max(ns))
    gather_tip = max(math.hypot(row[4], row[5]) for r in gather
                     for row in r["rows"])
    return dict(n_ac=band(n_ac), n_s=band(n_s),
                tip_radius=fsi2_gates()["tip_radius"], gather_tip=gather_tip)


def fsi2_gather_path(torch, results):
    """fsi2's gather route on the card: to FSI2_SHORT against the same run
    on the CPU (float32: equal counts, the fluid's positions within
    FSI2_SHORT_TOL); then to FSI2_GATHER_T_END through build_case ->
    init_sim -> make_run_chunk, the tip sampled every FSI2_SAMPLE and the
    host reads of device values counted, held to `fsi2_gather_gates`; its
    step by part,
    one profiled step, and each part (the couplings over the insert's
    list among them) profiled alone."""
    from sphinxsys_tpu_torch.cases import fsi2 as fc
    from sphinxsys_tpu_torch.ops import block_sweeps as bs
    from sphinxsys_tpu_torch.physics import fluid as fd
    from sphinxsys_tpu_torch.physics import fsi

    runs = {}
    for dev in (DEVICE, "cpu"):
        case, fluid, solid = fc.build_case(dx=FSI2_DX, device=dev)
        s = fc.make_run_chunk(case)(fc.init_sim(case, fluid, solid), FSI2_SHORT)
        runs[dev] = (s.n_adv, s.n_ac, s.n_s), s.fluid["Position"].cpu(), \
            s.solid["Position"].cpu()
    (kc, pc, so_c), (kh, ph, so_h) = runs[DEVICE], runs["cpu"]
    gap = float((pc - ph).abs().max())
    gap_s = float((so_c - so_h).abs().max())
    log(f"fsi2 gather short: to t={FSI2_SHORT} card {kc}, cpu {kh}; max "
        f"|dpos| fluid {gap:.3e}, solid {gap_s:.3e} (tolerance {FSI2_SHORT_TOL})")
    check(kc == kh, "fsi2 gather short: counts differ")
    check(gap <= FSI2_SHORT_TOL and gap_s <= FSI2_SHORT_TOL,
          "fsi2 gather short: positions differ")

    gates = fsi2_gather_gates()
    torch.cuda.reset_peak_memory_stats()
    case, fluid, solid = fc.build_case(dx=FSI2_DX, device=DEVICE)
    run = fc.make_run_chunk(case)
    sim = fc.init_sim(case, fluid, solid)
    idx, w = fc.tip_observer(case, solid)
    tip0 = fc.observe_tip(solid, idx, w)
    tip_max, samples = 0.0, 0
    bs.reset_launch_counts()
    t1 = time.perf_counter()
    with SyncCounter(torch) as syncs:
        while float(sim.time) < FSI2_GATHER_T_END:
            samples += 1
            sim = run(sim, samples * FSI2_SAMPLE)
            d = fc.observe_tip(sim.solid, idx, w) - tip0
            tip_max = max(tip_max, float(torch.linalg.vector_norm(d)))
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t1
    counts = dict(bs.LAUNCHES)
    n_sync = syncs.n - 2 * samples - 1
    log(f"fsi2 gather main path: to t={float(sim.time):.6f} n_adv={sim.n_adv} "
        f"n_ac={sim.n_ac} n_s={sim.n_s} (band n_ac {gates['n_ac']}, n_s "
        f"{gates['n_s']}) in {elapsed:.2f} s: {elapsed / sim.n_adv * 1e3:.3f} "
        f"ms an advection step (wall clock, mean), {n_sync} host reads of "
        f"device values ({n_sync / sim.n_adv:.2f} an advection step); tip "
        f"max|d| {tip_max:.4f} (bound {gates['tip_radius']:.4f}; JAX's gather "
        f"runs reach {gates['gather_tip']:.4f}); block kernel launches "
        f"{counts}; peak device memory {peak_gb(torch):.3f} GB")
    check(not bool(sim.overflow), "fsi2 gather: neighbour-list overflow")
    for k in ("Position", "Velocity", "Density", "Pressure"):
        check(bool(torch.isfinite(sim.fluid[k]).all()),
              f"fsi2 gather: non-finite fluid {k}")
    for k in ("Position", "Velocity", "DeformationGradient"):
        check(bool(torch.isfinite(sim.solid[k]).all()),
              f"fsi2 gather: non-finite solid {k}")
    check(gates["n_ac"][0] <= sim.n_ac <= gates["n_ac"][1]
          and gates["n_s"][0] <= sim.n_s <= gates["n_s"][1],
          f"fsi2 gather: counts {sim.n_ac} / {sim.n_s} off the band")
    check(tip_max <= gates["tip_radius"],
          f"fsi2 gather: tip displaced {tip_max:.4f} > {gates['tip_radius']:.4f}")
    check(not any(counts.values()), f"fsi2 gather: a block kernel ran {counts}")

    step = fc.make_advection_step(case)
    h, kern = case.adaptation.h, case.kernel
    dt_adv = fd.advection_viscous_time_step(sim.fluid, h, fc.U_F, fc.RHO0_F,
                                            fc.MU_F)
    dt = torch.minimum(fd.acoustic_time_step(sim.fluid, case.eos, h), dt_adv)
    pressure = lambda: fsi.pressure_force_from_fluid(
        sim.solid, sim.fluid, sim.nl_sf, kern, 2, case.riemann, box=case.box)
    viscous = lambda: fsi.update_elastic_normal_direction(
        fsi.viscous_force_from_fluid(sim.solid, sim.fluid, sim.nl_sf, kern, 2,
                                     fc.MU_F, h, box=case.box))
    fns = {"rebuild": lambda: fc.rebuild_relations(case, sim.fluid, sim.solid),
           "prep": lambda: fc.advection_prep(case, sim),
           "acoustic_substep": lambda: fc.acoustic_substep(
               case, sim, sim.fluid, sim.solid, dt_adv, sim.time),
           "solid_substeps": lambda: fc.solid_substeps(case, sim.solid, dt),
           "pressure_force": pressure, "viscous_force": viscous}
    parts = {"advection_step": wall_s(torch, lambda: step(sim), 3) * 1e3}
    parts.update({k: wall_s(torch, fn, 5) * 1e3 for k, fn in fns.items()})
    log("fsi2 gather step parts (ms, wall clock): "
        + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
        + f"; the block route's (phase 9): "
        f"{json.dumps(results.get('_fsi2_main', {}).get('parts_ms'))}")
    dev_us, _, plain_us, launches = profile_step(torch, "fsi2_gather",
                                                 lambda: step(sim))
    prof = profile_parts(torch, "fsi2_gather", fns)
    so, fl = sim.solid, sim.fluid
    bounds = {
        "pressure_force": list_bound(
            torch, "coupling", [sim.nl_sf],
            fields(so, "Position", "VolumetricMeasure", "NormalDirection",
                   "AverageVelocity", "ForcePrior")
            + fields(fl, "Position", "Pressure", "Density",
                     "VolumetricMeasure", "Velocity"),
            fields(so, "PressureForceFromFluid", "ForcePrior")),
        "viscous_force": list_bound(
            torch, "coupling", [sim.nl_sf],
            fields(so, "Position", "VolumetricMeasure", "AverageVelocity",
                   "ForcePrior")
            + fields(fl, "Position", "VolumetricMeasure", "Velocity"),
            fields(so, "ViscousForceFromFluid", "ForcePrior"))}
    bounds["solid_substep"] = frozen_bound(torch, case.rp, so)
    log("fsi2 gather coupling and solid sub-step bounds (this run's lists "
        "and fields): "
        + ", ".join(f"{k} {v[0]:.5f} ms ({v[1]}, {v[2]} pairs)"
                    for k, v in bounds.items()))
    results["_gather_fsi2"] = dict(
        coupling_bounds=bounds,
        t_end=float(sim.time), n_adv=sim.n_adv, n_ac=sim.n_ac, n_s=sim.n_s,
        ms_per_adv=elapsed / sim.n_adv * 1e3,
        host_reads_per_adv=n_sync / sim.n_adv, parts_ms=parts,
        device_busy_ms=dev_us / 1e3, launches_per_adv=launches,
        idle_share_est=1 - dev_us / plain_us, tip_max=tip_max,
        part_device=prof)


def gather_phase(torch, results):
    """Phase 11: the gather fluid routes (neighbour lists rebuilt every
    advection step, the pair sums as torch ops over them, no hand kernel)
    on the card: small references against the CPU, the third oracle
    against the block route's kernels, the 2D and 3D dambreaks at full
    width (the 2D one with the Morton resort), Taylor–Green's decay, and
    fsi2 to FSI2_GATHER_T_END."""
    t0 = time.perf_counter()
    gather_small_reference(torch, "dambreak_2d", 0.1, 0.08)
    gather_small_reference(torch, "taylor_green_2d", 0.05, 0.08)
    gather_block_oracle(torch)
    gather_tg_decay(torch, results)
    for tag, cfg in GATHER_CONFIGS.items():
        gather_main_path(torch, tag, cfg, results)
    fsi2_gather_path(torch, results)
    log(f"gather phase: {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase 12: the entry point and its IO
# ---------------------------------------------------------------------------

# The CLI (`python -m sphinxsys_tpu_torch.run`) run as a subprocess at the
# bench's widths, depth cut to a few steps, two output frames each, through
# its hand kernels (the counters' keys); the real rows each body's VTP must
# hold (JAX's dambreak_3d_block entry writes the fluid only).  The
# frames go to build/io_phase/ (ASCII VTP of 2.2M points runs to
# hundreds of MB) and are deleted after the checks.
IO_CLI_RUNS = {
    "3d": dict(case="dambreak_3d_block",
               sets=("dx=0.01", "cap=32", "c_max=125056", "t_end=0.008",
                     "n_output=2"),
               kernels=("density", "ac1", "ac2"),
               n_real={"WaterBody": 1_000_000}, overflow_flag=True),
    "tc1m": dict(case="twisting_column_3d",
                 sets=("dx=0.0175", "engine=lattice", "t_end=0.0002",
                       "n_output=2"),
                 kernels=("lattice_force", "lattice_dfdt"),
                 # the lattice has no capacity, so no overflow flag
                 n_real={"Column": 1_133_901}, overflow_flag=False),
}
IO_DIR = ROOT / "build" / "io_phase"
IO_SAMPLE = 2000            # rows of each array held against Python's "%.7g"
# the subprocess: `python -m sphinxsys_tpu_torch.run` (runpy, as -m runs it)
# with the VTP writer wrapped to time each body's write and keep the arrays
# it was handed, each chunk's `overflow` flag kept (None where the route has
# none), and the kernels' launch counts read after the run
CLI_WRAPPER = r"""
import importlib, json, os, runpy, sys, time
import numpy as np
from sphinxsys_tpu_torch.engine import scene
from sphinxsys_tpu_torch.io import vtk
from sphinxsys_tpu_torch.ops import block_sweeps, lattice_sweeps
args = json.loads(sys.argv[1])
overflows = []
def watch(mod):
    make_run_chunk = mod.make_run_chunk
    def watched_make_run_chunk(*a, **k):
        run = make_run_chunk(*a, **k)
        def watched(s, t):
            s = run(s, t)
            flag = getattr(s, "overflow", None)
            overflows.append(None if flag is None else bool(flag))
            return s
        return watched
    mod.make_run_chunk = watched_make_run_chunk
watch(scene)
watch(importlib.import_module(
    "sphinxsys_tpu_torch.cases." + args[0].removesuffix("_block")))
writes = []
write_vtp = vtk.write_vtp
def timed_write_vtp(path, state, variables=(), native=True):
    t0 = time.perf_counter()
    write_vtp(path, state, variables, native)
    secs = time.perf_counter() - t0
    n = int(state["NReal"])
    for k in ("Position", *variables):
        np.save(f"{path}.{k}.npy", vtk.host_rows(state[k], n))
    writes.append(dict(path=path, s=secs, bytes=os.path.getsize(path),
                       n_real=n, variables=list(variables)))
vtk.write_vtp = timed_write_vtp
block_sweeps.reset_launch_counts()
lattice_sweeps.reset_launch_counts()
sys.argv = ["run", *args]
try:
    runpy.run_module("sphinxsys_tpu_torch.run", run_name="__main__",
                     alter_sys=True)
    rc = 0
except SystemExit as exc:
    rc = exc.code
print("CLI_RESULT " + json.dumps(dict(
    rc=rc, writes=writes, overflow=overflows,
    launches={**block_sweeps.LAUNCHES, **lattice_sweeps.LAUNCHES})),
    flush=True)
sys.exit(rc)
"""
BALL_DX = 0.05              # the JAX case's default (4,224 + 6,120 particles)
BALL_T_END = 2.0
BALL_SAMPLE = 0.1
DAMBREAK_GOLDEN_DX = 0.05   # tests/test_golden_regression.py:20-34, :98-131
RESTART_T = (1.2, 2.4)      # the restart written at t1, continued to t2
PLANTED_BOUND = 10.0


def vtp_data_arrays(text):
    """{array name ("Points" for the positions): its text} of a VTP."""
    out, pos = {}, 0
    while True:
        i = text.find("<DataArray", pos)
        if i < 0:
            return out
        j = text.find(">", i)
        k = text.find("</DataArray>", j)
        name = re.search(r'Name="([^"]+)"', text[i:j])
        out[name.group(1) if name else "Points"] = text[j + 1:k]
        pos = k


def vtp_check(path, n_expected):
    """A frame's VTP against the arrays the writer was handed (saved
    beside it): well-formed XML, NumberOfPoints = NReal = the body's real
    rows, every array finite and its text the "%.7g" rows of those values
    (the whole text through the native formatter, IO_SAMPLE rows through
    Python's format, independent of it).  Returns the arrays' names."""
    from xml.parsers import expat

    import numpy as np
    from sphinxsys_tpu_torch.io import vtk

    text = Path(path).read_text()
    expat.ParserCreate().Parse(text, True)
    n = int(re.search(r'NumberOfPoints="(\d+)"', text).group(1))
    check(n == n_expected, f"{path}: NumberOfPoints {n}, NReal {n_expected}")
    blocks = vtp_data_arrays(text)
    rng = np.random.default_rng(n)
    for name, block in blocks.items():
        key = "Position" if name == "Points" else name
        ref = np.load(f"{path}.{key}.npy")
        check(ref.shape[0] == n and bool(np.isfinite(ref).all()),
              f"{path}: {key} rows {ref.shape[0]} or not finite")
        rows = ref[:, None] if ref.ndim == 1 else vtk._as3d(ref)
        full = vtk._format_rows(rows, True)
        want = full.replace("\n", " ") if ref.ndim == 1 else full
        check(block.strip() == want.strip(),
              f"{path}: {name} is not its state's %.7g text")
        lines = block.strip().split("\n") if ref.ndim > 1 else None
        tokens = block.split() if ref.ndim == 1 else None
        for r in rng.choice(n, size=min(n, IO_SAMPLE), replace=False):
            got = lines[r].split(" ") if lines is not None else [tokens[r]]
            check(got == [f"{float(x):.7g}" for x in np.atleast_1d(rows[r])],
                  f"{path}: {name} row {r} {got} is not Python's %.7g")
    return sorted(blocks)


def cli_run(torch, tag, cfg):
    """The CLI on `cfg` as a subprocess: exit code 0, every kernel of its
    path launched, no chunk's state overflowed, each frame's VTP checked (`vtp_check`), the seconds each
    frame took to write and its bytes on disk; the files are deleted."""
    import shutil

    out = IO_DIR / tag
    shutil.rmtree(out, ignore_errors=True)
    argv = [cfg["case"], *(x for kv in cfg["sets"] for x in ("--set", kv)),
            "--output_dir", str(out)]
    if DEVICE != "cuda":
        argv += ["--set", f"device={DEVICE}"]
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", CLI_WRAPPER, json.dumps(argv)],
                          cwd=ROOT, capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t0
    for line in proc.stderr.splitlines()[-20:]:
        log(f"cli {tag}: {line}")
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("CLI_RESULT ")]
    check(proc.returncode == 0 and lines,
          f"cli {tag}: exit code {proc.returncode}\n{proc.stdout[-2000:]}")
    res = json.loads(lines[-1][len("CLI_RESULT "):])
    log(f"cli {tag}: `python -m sphinxsys_tpu_torch.run {' '.join(argv)}` "
        f"exit {res['rc']} in {wall:.1f} s (process start, build of the case, "
        f"run and writes); kernel launches {res['launches']}")
    for k in cfg["kernels"]:
        check(res["launches"][k] > 0, f"cli {tag}: kernel {k} never launched")
    want = [False, False] if cfg["overflow_flag"] else [None, None]
    log(f"cli {tag}: overflow after each chunk {res['overflow']} (limit: "
        f"{want}{'' if cfg['overflow_flag'] else ', the route has no flag'})")
    check(res["overflow"] == want,
          f"cli {tag}: overflow after each chunk {res['overflow']}")
    frames = {}
    for w in res["writes"]:
        body, step = Path(w["path"]).stem.rsplit("_", 1)
        t1 = time.perf_counter()
        names = vtp_check(w["path"], cfg["n_real"][body])
        log(f"cli {tag}: {Path(w['path']).name}: well-formed, NumberOfPoints "
            f"{w['n_real']} = NReal {cfg['n_real'][body]} (limit: equal), "
            f"{names} finite and equal to the state at %.7g (limit: the whole "
            f"text byte-equal, {IO_SAMPLE} rows by Python's format); written in "
            f"{w['s']:.3f} s, {w['bytes'] / 1e6:.1f} MB; checked in "
            f"{time.perf_counter() - t1:.1f} s")
        f = frames.setdefault(int(step), dict(s=0.0, bytes=0, points=0))
        f["s"] += w["s"]
        f["bytes"] += w["bytes"]
        f["points"] += w["n_real"]
    check(sorted(frames) == [1, 2], f"cli {tag}: frames {sorted(frames)}")
    check(len(res["writes"]) == 2 * len(cfg["n_real"]),
          f"cli {tag}: {len(res['writes'])} files")
    shutil.rmtree(out)
    log(f"cli {tag}: frames (s to write, MB, points): " + ", ".join(
        f"{k}: {v['s']:.3f} s, {v['bytes'] / 1e6:.1f} MB, {v['points']}"
        for k, v in sorted(frames.items())))
    return dict(case=cfg["case"], sets=list(cfg["sets"]), wall_s=wall,
                launches=res["launches"], frames=frames)


def ball_com_z(s):
    m = s.ball["Mass"].double()
    return float((m * s.ball["Position"][:, 2].double()).sum() / m.sum())


def ball_shell_phase(torch, results):
    """The ball–shell collision at BALL_DX to BALL_T_END on the card: its
    mass-weighted centre-of-mass z every BALL_SAMPLE held by the port's
    DTWRegressionTest to tests/golden/ball_shell_collision_3d, no ball
    particle past r = 2 + dx/2 (JAX's test_no_penetration_through_shell),
    no contact-list overflow; the step's wall time and host reads, one
    profiled step and its contact and solid parts profiled alone."""
    import numpy as np
    from sphinxsys_tpu_torch.cases import ball_shell_collision_3d as bs
    from sphinxsys_tpu_torch.io.regression import DTWRegressionTest
    from sphinxsys_tpu_torch.physics import contact as ct
    from sphinxsys_tpu_torch.physics import solid as sd

    case, ball = bs.build_case(dx=BALL_DX, device=DEVICE)
    s = bs.init_sim(case, ball)
    run = bs.make_run_chunk(case)
    zs, rmax, reads, run_s = [ball_com_z(s)], [bs.max_radial_extent(s)], 0, 0.0
    n_samples = round(BALL_T_END / BALL_SAMPLE)
    for i in range(1, n_samples + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with SyncCounter(torch) as sync:
            s = run(s, i * BALL_SAMPLE)
        torch.cuda.synchronize()
        run_s += time.perf_counter() - t0
        reads += sync.n
        zs.append(ball_com_z(s))
        rmax.append(bs.max_radial_extent(s))
    limit = 2.0 + case.dx / 2
    ok, report = DTWRegressionTest(
        str(ROOT / "tests" / "golden" / "ball_shell_collision_3d"), "BallBody",
        "CenterOfMassZ").test(np.asarray(zs))
    log(f"ball-shell: dx={case.dx} n_ball={case.n_ball} n_shell="
        f"{case.shell['NReal']} {s.n_steps} steps to t={float(s.time):.6f} "
        f"(JAX on the CPU: 631), {run_s / s.n_steps * 1e3:.3f} ms a step (wall, "
        f"mean), {reads / s.n_steps:.2f} host reads a step; CoM z "
        f"{zs[0]:.6f} -> min {min(zs):.6f} -> {zs[-1]:.6f}")
    log(f"ball-shell: CoM z against the golden curve by DTW: {report}")
    log(f"ball-shell: max radial extent {max(rmax):.6f} (limit < {limit}); "
        f"overflow {bool(s.overflow)} (limit: False)")
    check(ok, f"ball-shell: CoM z off the golden curve:\n{report}")
    check(max(rmax) < limit, f"ball-shell: a particle at r = {max(rmax):.6f}")
    check(not bool(s.overflow), "ball-shell: contact-list overflow")

    b, nl = s.ball, s.nl_contact
    h, k = case.adaptation.h, case.kernel
    dt = sd.solid_acoustic_time_step(b, case.material.sound_speed, h, cfl=0.45)

    def contact():
        nl2 = bs.contact_list(case, b)
        f = ct.shell_contact_factor(b, case.shell, nl2, k, 3, case.dx)
        b2 = ct.repulsion_force_wall(b, case.shell, nl2, k, 3, f,
                                     ct.contact_stiffness(case.material))
        return ct.pairwise_friction_from_wall(b2, case.shell, nl2, k, 3,
                                              bs.PHYSICAL_VISCOSITY, dt)

    def solid():
        b1 = sd.integration_1st_half_pk2(b, case.rp, case.material, dt, h,
                                         k.w0(3))
        return sd.integration_2nd_half(b1, case.rp, dt)

    dev_us, _, plain_us, launches = profile_step(
        torch, "ball_shell", lambda: bs._step(case, s), "ball-shell step")
    prof = profile_parts(torch, "ball_shell", {
        "contact": contact, "contact_list": lambda: bs.contact_list(case, b),
        "solid": solid})
    pairs = int(nl.count.sum())
    contact_bound = list_bound(
        torch, "contact", [nl],
        fields(b, "Position", "Velocity", "VolumetricMeasure", "Mass",
               "ForcePrior")
        + fields(case.shell, "Position", "VolumetricMeasure",
                 "NormalDirection", "Velocity"),
        fields(b, "ForcePrior", "Velocity"))
    log(f"ball-shell contact bound (this run's list and fields): "
        f"{contact_bound[0]:.5f} ms ({contact_bound[1]}), against its "
        f"{prof['contact']['device_ms']:.3f} device ms")
    log(f"ball-shell device ms by part (each profiled alone): "
        + ", ".join(f"{n} {v['device_ms']:.3f} in {v['launches']} launches "
                    f"(idle share {v['idle_share_est']:.3f})"
                    for n, v in prof.items())
        + f"; the step {dev_us / 1e3:.3f} in {launches}; {pairs} contact pairs")
    results["_ball_shell"] = dict(
        n_ball=case.n_ball, n_shell=case.shell["NReal"], n_steps=s.n_steps,
        ms_per_step=run_s / s.n_steps * 1e3, host_reads_per_step=reads / s.n_steps,
        device_busy_ms=dev_us / 1e3, launches_per_step=launches,
        idle_share_est=1 - dev_us / plain_us, part_device=prof,
        contact_pairs=pairs, contact_bound=contact_bound, dtw=report,
        max_radial=max(rmax))


def dambreak_golden_phase(torch, results):
    """The 2D gather dambreak at DAMBREAK_GOLDEN_DX on the card, one run to
    t = 3.6: its mechanical energy every 0.1 to t = 2.5 and its wall
    pressure probe at (DL - dx/2, 0.2) (observe_quantity) every 0.12,
    each held by DTW to tests/golden/dambreak_2d; a restart written at
    RESTART_T[0] (write_restart), read back (read_restart) and continued
    to RESTART_T[1] against the uninterrupted run (equal counts,
    positions)."""
    import shutil

    import numpy as np
    from sphinxsys_tpu_torch.cases import dambreak_2d as db
    from sphinxsys_tpu_torch.io import restart as rst
    from sphinxsys_tpu_torch.io.observation import observe_quantity
    from sphinxsys_tpu_torch.io.regression import DTWRegressionTest
    from sphinxsys_tpu_torch.neighbors.cell_list import build_cell_table
    from sphinxsys_tpu_torch.neighbors.neighbor_list import build_neighbor_list
    from sphinxsys_tpu_torch.physics import general as gd

    case, fluid = db.build_case(dx=DAMBREAK_GOLDEN_DX, device=DEVICE)
    s = db.init_sim(case, fluid)
    run = db.make_run_chunk(case)
    obs = torch.tensor([[db.DL - 0.5 * case.dx, 0.2]],
                       dtype=fluid["Position"].dtype, device=DEVICE)

    def probe(f):
        table = build_cell_table(f["Position"], f["NReal"], case.grid,
                                 case.cell_cap)
        nl = build_neighbor_list(obs, 1, f["Position"], f["NReal"], table,
                                 case.grid, case.adaptation.cutoff, k_max=64,
                                 include_self=True)
        return float(observe_quantity(obs, f, "Pressure", nl, case.kernel,
                                      2)[0])

    def energy(f):
        return float(gd.total_mechanical_energy(f, case.gravity))

    events = sorted([(i * 0.1, "energy") for i in range(1, 26)]
                    + [(j * 0.12, "probe") for j in range(1, 31)]
                    + [(RESTART_T[0], "write"), (RESTART_T[1], "hold")])
    energies, pressures = [energy(s.fluid)], [probe(s.fluid)]
    rdir = IO_DIR / "restart"
    shutil.rmtree(rdir, ignore_errors=True)
    t0 = time.perf_counter()
    for t, what in events:
        s = run(s, t)
        if what == "energy":
            energies.append(energy(s.fluid))
        elif what == "probe":
            pressures.append(probe(s.fluid))
        elif what == "write":
            rst.write_restart(str(rdir), s.n_adv, {"WaterBody": s.fluid},
                              physical_time=float(s.time), n_adv=s.n_adv,
                              n_ac=s.n_ac)
            written, template = s.n_adv, s.fluid
        else:
            held = s
    run_s = time.perf_counter() - t0
    golden = str(ROOT / "tests" / "golden" / "dambreak_2d")
    e_ok, e_rep = DTWRegressionTest(golden, "WaterBody",
                                    "TotalMechanicalEnergy").test(
        np.asarray(energies))
    p_ok, p_rep = DTWRegressionTest(golden, "FluidObserver", "Pressure").test(
        np.asarray(pressures))
    log(f"dambreak golden: dx={case.dx} n_fluid={case.n_fluid} to "
        f"t={float(s.time):.6f} in {s.n_adv} / {s.n_ac} steps, {run_s:.1f} s "
        f"with the samples; overflow {bool(s.overflow)} (limit: False)")
    log(f"dambreak golden: mechanical energy ({len(energies)} samples) "
        f"against the golden curve by DTW: {e_rep}")
    log(f"dambreak golden: wall pressure probe ({len(pressures)} samples, "
        f"max {max(pressures):.4f}) against the golden curve by DTW: {p_rep}")
    check(not bool(s.overflow), "dambreak golden: neighbour-list overflow")
    check(e_ok, f"dambreak golden: energy off the golden curve:\n{e_rep}")
    check(p_ok, f"dambreak golden: probe off the golden curve:\n{p_rep}")

    loaded, meta = rst.read_restart(str(rdir), written, {"WaterBody": template})
    fluid_b = loaded["WaterBody"]
    check(all(torch.equal(fluid_b[k], template[k]) for k in template
              if torch.is_tensor(template[k])),
          "restart: the snapshot read back differs from the state written")
    nl_inner, nl_wall = db.rebuild_relations(case, fluid_b)
    resumed = db.SimState(
        fluid=fluid_b, nl_inner=nl_inner, nl_wall=nl_wall,
        time=torch.as_tensor(meta["physical_time"], dtype=s.time.dtype,
                             device=s.time.device),
        n_adv=meta["n_adv"], n_ac=meta["n_ac"],
        overflow=nl_inner.overflow | nl_wall.overflow)
    resumed = run(resumed, RESTART_T[1])
    dpos = float((resumed.fluid["Position"] - held.fluid["Position"]).abs().max())
    scale = float(held.fluid["Position"].abs().max())
    bitwise = all(torch.equal(resumed.fluid[k], held.fluid[k])
                  for k in ("Position", "Velocity", "Density", "Pressure"))
    log(f"restart: written at step {written} (t={meta['physical_time']:.6f}), "
        f"read back and continued to t={float(resumed.time):.6f}: counts "
        f"{resumed.n_adv} / {resumed.n_ac} against the uninterrupted "
        f"{held.n_adv} / {held.n_ac} (limit: equal); max|dpos| {dpos:.3e} of "
        f"max|x| {scale:.3f} (limit {1e-6 * scale:.3e}); bitwise {bitwise}")
    check((resumed.n_adv, resumed.n_ac) == (held.n_adv, held.n_ac),
          "restart: the continuation's counts differ")
    check(dpos <= 1e-6 * scale, f"restart: positions differ by {dpos:.3e}")
    shutil.rmtree(rdir)
    results["_dambreak_golden"] = dict(
        n_fluid=case.n_fluid, n_adv=s.n_adv, n_ac=s.n_ac, run_s=run_s,
        energy_dtw=e_rep, probe_dtw=p_rep, restart_bitwise=bitwise,
        restart_dpos=dpos)
    return case, fluid


def planted_violation_check(torch, case, fluid):
    """A velocity beyond the bound planted in the dambreak's state after
    the first output chunk: WriteToVtpIfVelocityOutOfBound dumps one VTP a
    body and solver.run_simulation raises."""
    import shutil
    from xml.parsers import expat

    from sphinxsys_tpu_torch import solver
    from sphinxsys_tpu_torch.cases import dambreak_2d as db
    from sphinxsys_tpu_torch.io.failure import WriteToVtpIfVelocityOutOfBound

    out = IO_DIR / "failure"
    shutil.rmtree(out, ignore_errors=True)
    bound_check = WriteToVtpIfVelocityOutOfBound(str(out), PLANTED_BOUND)
    run = db.make_run_chunk(case)

    def planted(s, t):
        s = run(s, t)
        s.fluid["Velocity"][7, 1] = 2.5 * PLANTED_BOUND
        return s

    try:
        solver.run_simulation(
            planted, db.init_sim(case, fluid), 0.3, 0.1, verbose=False,
            failure_check=lambda s: bound_check(
                {"WaterBody": s.fluid, "Wall": case.wall}, float(s.time)))
        raised = None
    except RuntimeError as exc:
        raised = str(exc)
    files = sorted(p.name for p in out.glob("*.vtp"))
    log(f"planted violation: |v| = {2.5 * PLANTED_BOUND} against the bound "
        f"{PLANTED_BOUND}: run_simulation raised {raised!r} (limit: raises); "
        f"dumped {files} (limit: one VTP a body)")
    check(raised is not None and "failure check fired" in raised,
          "planted violation: run_simulation did not raise")
    check(len(files) == 2 and files[0].startswith("Wall_velocity_out_of_bound_")
          and files[1].startswith("WaterBody_velocity_out_of_bound_"),
          f"planted violation: dumped {files}")
    for name, n in zip(files, (case.n_wall, case.n_fluid)):
        text = (out / name).read_text()
        expat.ParserCreate().Parse(text, True)
        check(f'NumberOfPoints="{n}"' in text, f"planted violation: {name}")
    check(f" {2.5 * PLANTED_BOUND:g} " in (out / files[1]).read_text(),
          "planted violation: the planted velocity is not in the dump")
    shutil.rmtree(out)


def io_phase(torch, results):
    """Phase 12: the entry point and its IO — the CLI at full width as a
    subprocess (`cli_run`), the ball–shell collision and the 2D dambreak
    held to their golden curves, the restart round trip and the planted
    velocity violation.  The native VTP formatter is built first, so that
    no frame's time holds its build."""
    from sphinxsys_tpu_torch.io import vtk

    t0 = time.perf_counter()
    built = vtk.library_path().exists()
    vtk.fastio()
    log(f"build: {vtk.library_path().name} (g++) "
        + ("cached" if built else f"in {time.perf_counter() - t0:.1f} s"))
    cli = {tag: cli_run(torch, tag, cfg) for tag, cfg in IO_CLI_RUNS.items()}
    ball_shell_phase(torch, results)
    case, fluid = dambreak_golden_phase(torch, results)
    planted_violation_check(torch, case, fluid)
    results["_io"] = cli
    log(f"io phase: {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase 13: open boundaries, the free stream and the self-propelled fish
# ---------------------------------------------------------------------------

# the float64 card-against-CPU references: (case, dx, end); fish_undulation
# runs to the time at which its dx = 0.01 run takes exactly 200 steps
OB_REFS = (("t_pipe_2d", None, 1.0), ("fish_undulation_2d", 0.01, 0.0088508),
           ("fish_fsi_2d", 0.01, 0.02))
OB_POS_TOL = 1e-9
OB_FISH_DX = 0.0025         # the reference's (53,714 + 686 particles)
OB_FISH_T_END = 0.05
OB_FISH_SAMPLE = 0.01
OB_PIPE_T_END = 2.0
OB_PIPE_SAMPLE = 0.5
# JAX's own float32 counts at the same widths and times
# (`python tests/test_torch_fish.py`); the card's within OB_COUNT_BAND
OB_JAX_COUNTS = "tests/golden_torch/fish_fsi/jax_f32_counts.json"
OB_COUNT_BAND = 0.2


def reset_all_launch_counts():
    from sphinxsys_tpu_torch.ops import (block_sweeps, lattice_sweeps,
                                         layout_sweeps, packed_sweeps)

    mods = (block_sweeps, lattice_sweeps, layout_sweeps, packed_sweeps)
    for m in mods:
        m.reset_launch_counts()
    return lambda: {k: v for m in mods for k, v in m.LAUNCHES.items()}


def ob_reference_run(torch, name, dx, t_end, device):
    """One float64 reference run: (counts, fluid or None, solid)."""
    cm = importlib.import_module(f"sphinxsys_tpu_torch.cases.{name}")
    kw = dict(dtype=torch.float64, device=device)
    if dx is not None:
        kw["dx"] = dx
    if name == "fish_undulation_2d":
        case, s = cm.build_case(**kw)
        s = cm.make_run_chunk(case)(s, t_end)
        return (s.n_steps,), None, s.fish
    if name == "t_pipe_2d":
        case, fluid = cm.build_case(**kw)
        s = cm.make_run_chunk(case)(cm.init_sim(case, fluid), t_end)
        return (s.n_adv, s.n_ac), s.fluid, None
    case, fluid, fish = cm.build_case(**kw)
    s = cm.make_run_chunk(case)(cm.init_sim(case, fluid, fish), t_end)
    return (s.n_adv, s.n_ac, s.n_s), s.fluid, s.fish


def ob_small_references(torch):
    """The three cases at small sizes in float64 on the card against the
    CPU: equal counts, identical Alive and Indicator, positions (live
    rows; the dead ones equal) within OB_POS_TOL of max|x|.  float64,
    because the emitter's and the indicator's integer decisions would flip
    at float32 roundoff: a mismatch here is a fault, not noise."""
    for name, dx, t_end in OB_REFS:
        (kc, fc, sc_), (kh, fh, sh) = (ob_reference_run(torch, name, dx,
                                                        t_end, dev)
                                       for dev in (DEVICE, "cpu"))
        errs = {}
        if fc is not None:
            for k in ("Alive", "Indicator"):
                check(torch.equal(fc[k].cpu(), fh[k]),
                      f"ob reference {name}: {k} differs")
            alive = fh["Alive"]
            pc, ph = fc["Position"].cpu(), fh["Position"]
            check(torch.equal(pc[~alive], ph[~alive]),
                  f"ob reference {name}: dead rows differ")
            errs["fluid"] = (float((pc - ph)[alive].abs().max()),
                             float(ph[alive].abs().max()))
        if sh is not None:
            errs["solid"] = (float((sc_["Position"].cpu()
                                    - sh["Position"]).abs().max()),
                             float(sh["Position"].abs().max()))
        log(f"ob reference {name} (float64, dx={dx}, to t={t_end}): card "
            f"counts {kc}, cpu {kh}; max |dpos| / max|x| "
            + ", ".join(f"{b} {e:.3e} / {m:.3f}" for b, (e, m) in errs.items())
            + (f"; alive {int(fh['Alive'].sum())}" if fh is not None else ""))
        check(kc == kh, f"ob reference {name}: counts {kc} != {kh}")
        for b, (e, m) in errs.items():
            check(e <= OB_POS_TOL * m,
                  f"ob reference {name}: {b} positions differ by {e:.3e}")


def ob_parts(torch, tag, fns, step, bounds, trace=True):
    """The step (unless None) and each part alone: wall ms (synchronised
    median), host
    reads of device values in one call, device busy ms and launches
    (profiled; `trace` as `profile_step`'s), the idle share of the
    unprofiled wall, and the part's bound where `bounds` has one (ms, by,
    real pairs: `list_bound`)."""
    table = {}
    steps = {} if step is None else {"advection_step": step}
    for name, fn in {**steps, **fns}.items():
        with SyncCounter(torch) as reads:
            fn()
        torch.cuda.synchronize()
        dev_us, _, plain_us, launches = profile_step(torch, f"{tag}_{name}",
                                                     fn, name, trace)
        table[name] = dict(wall_ms=plain_us / 1e3, device_ms=dev_us / 1e3,
                           launches=launches, host_reads=reads.n,
                           idle_share_est=1 - dev_us / plain_us)
        if name in bounds:
            table[name].update(bound_ms=bounds[name][0],
                               bound_by=bounds[name][1],
                               pairs=bounds[name][2])
    log(f"{tag} parts: " + "; ".join(
        f"{k} wall {v['wall_ms']:.3f} ms, device {v['device_ms']:.3f} ms in "
        f"{v['launches']} launches, {v['host_reads']} host reads, idle share "
        f"{v['idle_share_est']:.3f}"
        + (f", bound {v['bound_ms']:.5f} ms ({v['bound_by']}, {v['pairs']} "
           f"pairs)" if "bound_ms" in v else "")
        for k, v in table.items()))
    return table


def ob_main_run(torch, tag, build, t_end, sample):
    """build() -> (case, module, sim); the case through init_sim ->
    make_run_chunk -> solver.run_simulation to t_end, every launch count
    reset just before and read just after (the route has no hand kernel),
    the host reads of device values counted.  Returns (case, sim, record)."""
    from sphinxsys_tpu_torch import solver

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    case, mod, sim = build()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    outputs = []
    read_counts = reset_all_launch_counts()
    with SyncCounter(torch) as syncs:
        t1 = time.perf_counter()
        sim, _ = solver.run_simulation(mod.make_run_chunk(case), sim, t_end,
                                       sample, verbose=False,
                                       on_output=outputs.append)
        elapsed = time.perf_counter() - t1
    counts = read_counts()
    # run_simulation's own reads: the start time, then the time and the
    # overflow flag after each chunk
    reads = syncs.n - (1 + 2 * len(outputs))
    # a solid case's steps (a stretching bar's macro steps) stand for the
    # advection steps
    n_adv = (getattr(sim, "n_adv", None) or getattr(sim, "n_steps", None)
             or sim.n_macro)
    rec = dict(setup_s=setup_s, run_s=elapsed, t_end=float(sim.time),
               ms_per_adv=elapsed / n_adv * 1e3,
               host_reads_per_adv=reads / n_adv,
               peak_gb=peak_gb(torch), kernel_launches=counts)
    check(not any(counts.values()), f"{tag}: a hand kernel ran {counts}")
    return case, sim, rec


def ob_open_boundary_bound(torch, f):
    """The emitter and disposer's least time: the Alive mask, the positions
    before the step and the hinted fields read once, each written once."""
    from sphinxsys_tpu_torch.physics.boundary import _PARTICLE_FIELDS_HINT

    hinted = fields(f, *_PARTICLE_FIELDS_HINT)
    return list_bound(torch, None, [], [f["Alive"], f["Position"], *hinted],
                      [f["Alive"], *hinted])


def ob_fish_bounds(torch, case, sim, f, fi):
    """Each part's least time from this run's lists and fields
    (`list_bound`); the acoustic sub-step's holds its fluid halves, the
    pressure force and its solid sub-steps (their mean count)."""
    lists = [sim.nl_ff, sim.nl_fs]
    solid = frozen_bound(torch, case.rp, fi)
    fluid = list_bound(torch, "acoustic_substep", lists,
                       fields(f, *FLUID_AC_READS) + fields(fi, *WALL_READS),
                       fields(f, *FLUID_AC_WRITES))
    coupling = list_bound(
        torch, "coupling", [sim.nl_sf],
        fields(fi, "Position", "VolumetricMeasure", "NormalDirection",
               "AverageVelocity", "ForcePrior")
        + fields(f, "Position", "Pressure", "Density", "VolumetricMeasure",
                 "Velocity"),
        fields(fi, "PressureForceFromFluid", "ForcePrior"))
    per_ac = sim.n_s / sim.n_ac
    ac_ms = fluid[0] + coupling[0] + per_ac * solid[0]
    return {
        "surface_indication": list_bound(
            torch, "surface_indication", lists,
            fields(f, "Position", "VolumetricMeasure",
                   "PreviousSurfaceIndicator") + fields(fi, "Position",
                                                        "VolumetricMeasure"),
            fields(f, "Indicator", "PositionDivergence",
                   "PreviousSurfaceIndicator")),
        "density": list_bound(
            torch, "density", lists,
            fields(f, "Position", "Mass", "Density", "Indicator")
            + fields(fi, "Position", "Mass"),
            fields(f, "DensitySummation", "Density", "VolumetricMeasure")),
        "acoustic_substep": (ac_ms, fluid[1], fluid[2] + coupling[2]
                             + round(per_ac * solid[2])),
        "solid_substep": solid,
        "emitter_disposer": ob_open_boundary_bound(torch, f)}


def ob_fish_path(torch, results):
    """fish_fsi_2d at the reference's dx through the public entry points
    to OB_FISH_T_END, float32: no overflow, finite fields, the fish inside
    the channel, the outlet columns deleted, the counts within
    OB_COUNT_BAND of JAX's own float32 counts; then the step by part."""
    from sphinxsys_tpu_torch.cases import fish_fsi_2d as ff
    from sphinxsys_tpu_torch.physics import fluid as fd
    from sphinxsys_tpu_torch.physics import solid as sd

    def build():
        case, fluid, fish = ff.build_case(dx=OB_FISH_DX, device=DEVICE)
        return case, ff, ff.init_sim(case, fluid, fish)

    case, sim, rec = ob_main_run(torch, "ob fish", build, OB_FISH_T_END,
                                 OB_FISH_SAMPLE)
    f, fi = sim.fluid, sim.fish
    alive = f["Alive"]
    jax_rows = json.loads((ROOT / OB_JAX_COUNTS).read_text())["fish_fsi"]
    jrow = min(jax_rows["rows"], key=lambda r: abs(r[0] - float(sim.time)))
    n0 = jax_rows["n_alive0"]
    pos0 = f["Position"]
    dl_sponge = case.dl_sponge
    outlet_cols = n0 - int(alive.sum())    # net of the (few) clones
    ps = fi["Position"]
    inside = bool(((ps[:, 0] > -dl_sponge) & (ps[:, 0] < ff.DL)
                   & (ps[:, 1] > 0.0) & (ps[:, 1] < ff.DH)).all())
    in_disposer = int((case.disposer.contains(pos0) & alive).sum())
    counts = (sim.n_adv, sim.n_ac, sim.n_s)
    band = [((1 - OB_COUNT_BAND) * j, (1 + OB_COUNT_BAND) * j)
            for j in jrow[1:4]]
    log(f"ob fish main path: n_fluid={case.n_fluid} rows ({n0} alive at "
        f"t=0) n_fish={case.n_fish}; setup {rec['setup_s']:.2f} s; to "
        f"t={float(sim.time):.6f} counts (n_adv, n_ac, n_s) {counts} against "
        f"JAX's float32 {tuple(jrow[1:4])} at t={jrow[0]:.6f} (band "
        f"{OB_COUNT_BAND}); alive {int(alive.sum())} (JAX {jrow[4]}), "
        f"deleted {outlet_cols}; {rec['run_s']:.2f} s: {rec['ms_per_adv']:.3f} "
        f"ms an advection step (wall clock, mean), "
        f"{rec['host_reads_per_adv']:.1f} host reads an advection step; "
        f"peak device memory {rec['peak_gb']:.3f} GB")
    for k in ("Position", "Velocity", "Density", "Pressure"):
        v = f[k][alive]
        check(bool(torch.isfinite(v).all()), f"ob fish: non-finite fluid {k}")
    for k in ("Position", "Velocity", "DeformationGradient"):
        check(bool(torch.isfinite(fi[k]).all()), f"ob fish: non-finite fish {k}")
    check(inside, "ob fish: a fish particle left the channel")
    check(in_disposer == 0 and outlet_cols >= 4 * int(ff.DH / OB_FISH_DX),
          f"ob fish: the disposer left {in_disposer} alive in its region, "
          f"deleted {outlet_cols}")
    for name, c, (lo, hi) in zip(("n_adv", "n_ac", "n_s"), counts, band):
        check(lo <= c <= hi, f"ob fish: {name} {c} off JAX's band "
              f"[{lo:.1f}, {hi:.1f}]")

    kernel, h = case.kernel, case.adaptation.h
    dt_adv = fd.advection_viscous_time_step(f, h, ff.U_F, ff.RHO0_F, ff.MU_F)
    dt = torch.minimum(fd.acoustic_time_step(f, case.eos, h), dt_adv)
    dt_s = torch.minimum(sd.solid_acoustic_time_step(
        fi, case.material_s.sound_speed, h), dt)
    step = ff.make_advection_step(case)
    fns = {
        "rebuild": lambda: ff.rebuild_relations(case, f, fi),
        "surface_indication": lambda: fd.free_surface_indication(
            f, sim.nl_ff, kernel, 2, contacts=[(fi, sim.nl_fs, None)],
            spatial_temporal=True),
        "density": lambda: fd.density_summation_freestream(
            f, sim.nl_ff, kernel, 2, ff.RHO0_F, case.adaptation.sigma0,
            contacts=[(fi, sim.nl_fs, 1050.0)]),
        "acoustic_substep": lambda: ff.acoustic_substep(
            case, sim, f, fi, dt_adv, sim.time),
        "solid_substep": lambda: ff.solid_substep(case, fi, dt_s, sim.time),
        "emitter_disposer": lambda: ff.open_boundaries(case, f, pos0),
    }
    bounds = ob_fish_bounds(torch, case, sim, f, fi)
    parts = ob_parts(torch, "ob_fish", fns, lambda: step(sim), bounds)
    per_ac = sim.n_s / sim.n_ac
    log(f"ob fish: {sim.n_ac / sim.n_adv:.2f} acoustic sub-steps an "
        f"advection step, {per_ac:.2f} solid sub-steps an acoustic one; the "
        f"solid sub-steps of one acoustic sub-step {per_ac:.2f} x "
        f"{parts['solid_substep']['wall_ms']:.3f} ms wall against its "
        f"{parts['acoustic_substep']['wall_ms']:.3f} ms")
    results["_ob_fish"] = dict(rec, n_fluid=case.n_fluid, n_fish=case.n_fish,
                               n_adv=sim.n_adv, n_ac=sim.n_ac, n_s=sim.n_s,
                               jax_f32=jrow, alive=int(alive.sum()),
                               outlet_deleted=outlet_cols, parts=parts)
    del case, sim, f, fi, step
    torch.cuda.empty_cache()


def ob_pipe_path(torch, results):
    """t_pipe_2d through the public entry points to OB_PIPE_T_END, float32:
    the emitter injected (the live count rose above its start), no
    overflow (the lists' and the emitter's), finite fields; the step by
    part."""
    from sphinxsys_tpu_torch.cases import t_pipe_2d as tp
    from sphinxsys_tpu_torch.physics import fluid as fd

    def build():
        case, fluid = tp.build_case(device=DEVICE)
        return case, tp, tp.init_sim(case, fluid)

    case, sim, rec = ob_main_run(torch, "ob t_pipe", build, OB_PIPE_T_END,
                                 OB_PIPE_SAMPLE)
    f = sim.fluid
    n1 = tp.n_alive(sim)
    jrow = json.loads((ROOT / OB_JAX_COUNTS).read_text())["t_pipe"]["rows"][-1]
    log(f"ob t_pipe main path: {case.n_fluid} alive at t=0 in "
        f"{f['Position'].shape[0]} rows; to t={float(sim.time):.6f} n_adv="
        f"{sim.n_adv} n_ac={sim.n_ac} alive {n1} (JAX float32 at "
        f"t={jrow[0]:.6f}: n_adv {jrow[1]}, alive {jrow[2]}); "
        f"{rec['ms_per_adv']:.3f} ms an advection step (wall clock, mean), "
        f"{rec['host_reads_per_adv']:.1f} host reads an advection step")
    check(n1 > case.n_fluid, f"ob t_pipe: no injection ({n1} alive)")
    check(not bool(sim.overflow), "ob t_pipe: overflow")
    for k in ("Position", "Velocity", "Density", "Pressure"):
        check(bool(torch.isfinite(f[k][f["Alive"]]).all()),
              f"ob t_pipe: non-finite {k}")
    kernel = case.kernel
    dt_adv = fd.advection_viscous_time_step(f, case.adaptation.h, tp.U_F,
                                            tp.RHO0_F, tp.MU_F)
    step = tp.make_advection_step(case)
    fns = {
        "rebuild": lambda: tp.rebuild_relations(case, f),
        "surface_indication": lambda: fd.free_surface_indication(
            f, sim.nl_inner, kernel, 2,
            contacts=[(case.wall, sim.nl_wall, None)], spatial_temporal=True),
        "density": lambda: fd.density_summation_freestream(
            f, sim.nl_inner, kernel, 2, tp.RHO0_F, case.adaptation.sigma0,
            contacts=[(case.wall, sim.nl_wall, tp.RHO0_F)]),
        "acoustic_substep": lambda: tp.acoustic_substep(case, sim, f, dt_adv,
                                                        sim.time),
        "emitter_disposer": lambda: tp.open_boundaries(case, f,
                                                       f["Position"]),
    }
    w = case.wall
    lists = [sim.nl_inner, sim.nl_wall]
    ac = list_bound(torch, "acoustic_substep", lists,
                    fields(f, *FLUID_AC_READS) + fields(w, *WALL_READS),
                    fields(f, *FLUID_AC_WRITES))
    bounds = {
        "surface_indication": list_bound(
            torch, "surface_indication", lists,
            fields(f, "Position", "VolumetricMeasure",
                   "PreviousSurfaceIndicator") + fields(w, "Position",
                                                        "VolumetricMeasure"),
            fields(f, "Indicator", "PositionDivergence",
                   "PreviousSurfaceIndicator")),
        "density": list_bound(
            torch, "density", lists,
            fields(f, "Position", "Mass", "Density", "Indicator")
            + fields(w, "Position", "Mass"),
            fields(f, "DensitySummation", "Density", "VolumetricMeasure")),
        "acoustic_substep": ac,
        "emitter_disposer": ob_open_boundary_bound(torch, f)}
    parts = ob_parts(torch, "ob_t_pipe", fns, lambda: step(sim), bounds)
    results["_ob_t_pipe"] = dict(rec, n_alive0=case.n_fluid, alive=n1,
                                 n_adv=sim.n_adv, n_ac=sim.n_ac, jax_f32=jrow,
                                 parts=parts)


def open_boundary_phase(torch, results):
    """Phase 13: the T-pipe, the fish in vacuum and the fish in the channel
    (open boundaries, the free stream, the active-strain solid; neighbour
    lists and torch ops, no hand kernel): the float64 references against
    the CPU, then the fish at the reference's width and the T-pipe through
    the public entry points, each step by part."""
    t0 = time.perf_counter()
    ob_small_references(torch)
    t1 = time.perf_counter()
    ob_fish_path(torch, results)
    ob_pipe_path(torch, results)
    log(f"open boundary phase: {time.perf_counter() - t0:.1f} s (references "
        f"{t1 - t0:.1f} s)")


# ---------------------------------------------------------------------------
# Phase 14: the articulated multibody (the tethered fish, play_simbody) and
# the four fluid cases of ROADMAP A item 3a (neighbour lists, torch ops)
# ---------------------------------------------------------------------------

# the float32 card-against-float64 CPU references: (case, build keywords,
# advection steps); the filling tank's stop before its first injection
A7_REFS = (("tethered_fish_2d", dict(dx=0.15), 1),
           ("stlw_2d", dict(dx=0.1), 3),
           ("filling_tank_2d", dict(dx=0.05), 2),
           ("elastic_gate_2d", dict(dx=5.0), 1),
           ("flow_around_cylinder_2d", dict(dx=0.4, relax_cyl=0), 2))
# float32 against float64: positions within this share of max|x|; the
# tethered fish's (q, u), small displacements of the head, within
# A7_F32_Q_TOL of their own max
A7_F32_TOL = 1e-5
A7_F32_Q_TOL = 1e-3
# the filling tank through its injections, float64 on both sides: its jet
# parts float32 from float64 by 3e-4 of max|x| in three steps, the JAX
# package's own runs alike (a clone's first step), so its emitter is held
# in float64
A7_F64_REF = ("filling_tank_2d", dict(dx=0.05), 8)
A7_POS_TOL = 1e-9
A7_TETHER_T_END = 0.01      # the full-width tethered fish's main path
A7_TETHER_SAMPLE = 0.01
# play_simbody's steps (of the case's 10, each 20 RK4 sub-steps of ~0.11
# s) and the step its restart starts from
A7_SIMBODY_STEPS = 3
A7_SIMBODY_RESTART = 2
A7_MAIN = {  # the 3a cases at their JAX default widths: (kw, t_end, sample)
    "stlw_2d": (dict(), 0.05, 0.025),
    "filling_tank_2d": (dict(), 0.1, 0.05),
    "elastic_gate_2d": (dict(), 1.0, 0.5),
    "flow_around_cylinder_2d": (dict(), 0.25, 0.125),
}
A7_BODIES = {"tethered_fish_2d": ("fluid", "fish"), "stlw_2d": ("fluid",),
             "filling_tank_2d": ("fluid",),
             "elastic_gate_2d": ("fluid", "gate"),
             "flow_around_cylinder_2d": ("fluid", "cyl")}
A7_COUNTS = ("n_adv", "n_ac", "n_s")


def a7_steps(torch, name, kw, n_steps, device, dtype):
    """`n_steps` advection steps of a case from its build: (counts, the
    sim)."""
    cm = importlib.import_module(f"sphinxsys_tpu_torch.cases.{name}")
    case, *states = cm.build_case(dtype=dtype, device=device, **kw)
    s = cm.init_sim(case, *states)
    step = cm.make_advection_step(case)
    for _ in range(n_steps):
        s = step(s)
    return tuple(getattr(s, k) for k in A7_COUNTS if hasattr(s, k)), s


def a7_hold(torch, name, card, host, tol, what, q_tol=None):
    """The card's sim against the host's: equal Alive masks, positions
    (the live rows) within tol of max|x| for every body, the tethered
    fish's (q, u) within q_tol (default tol) of their max.  Returns
    {body: (err, max)}."""
    errs = {}
    for body in A7_BODIES[name]:
        bc, bh = getattr(card, body), getattr(host, body)
        rows = bh.get("Alive", torch.ones(bh["Position"].shape[0],
                                          dtype=torch.bool))
        if "Alive" in bh:
            check(torch.equal(bc["Alive"].cpu(), rows),
                  f"{what} {name}: Alive differs")
        pc = bc["Position"].cpu().double()[rows]
        ph = bh["Position"].double()[rows]
        errs[body] = (float((pc - ph).abs().max()), float(ph.abs().max()))
    if hasattr(host, "q"):
        for k in ("q", "u"):
            a, b = getattr(card, k).cpu().double(), getattr(host, k).double()
            errs[k] = (float((a - b).abs().max()), float(b.abs().max()))
    for b, (e, m) in errs.items():
        t = q_tol if q_tol is not None and b in ("q", "u") else tol
        check(e <= t * m, f"{what} {name}: {b} differs by {e:.3e} "
              f"(max {m:.3e}, tolerance {t})")
    return errs


def a7_small_references(torch):
    """Each new case at a small size: float32 on the card against the
    port's float64 run on the CPU from the same build (equal counts,
    positions within A7_F32_TOL of max|x|, the tethered fish's (q, u)
    within A7_F32_Q_TOL); the filling tank through its injections in
    float64 on both (A7_POS_TOL)."""
    for name, kw, n in A7_REFS:
        kc, sc_ = a7_steps(torch, name, kw, n, DEVICE, torch.float32)
        kh, sh = a7_steps(torch, name, kw, n, "cpu", torch.float64)
        check(kc == kh, f"a7 reference {name}: counts {kc} != {kh}")
        errs = a7_hold(torch, name, sc_, sh, A7_F32_TOL, "a7 reference",
                       A7_F32_Q_TOL)
        log(f"a7 reference {name} (float32 card against float64 cpu, {kw}, "
            f"{n} advection steps): counts {kc}; max |d| / max "
            + ", ".join(f"{b} {e:.3e} / {m:.3e}" for b, (e, m) in errs.items())
            + f" (tolerance {A7_F32_TOL}; q, u {A7_F32_Q_TOL})")
    name, kw, n = A7_F64_REF
    (kc, sc_), (kh, sh) = (a7_steps(torch, name, kw, n, dev, torch.float64)
                           for dev in (DEVICE, "cpu"))
    check(kc == kh, f"a7 reference {name} float64: counts {kc} != {kh}")
    check(int(sh.fluid["Alive"].sum()) > 12,
          f"a7 reference {name} float64: no injection")
    errs = a7_hold(torch, name, sc_, sh, A7_POS_TOL, "a7 reference float64")
    log(f"a7 reference {name} (float64 card against cpu, {n} steps, "
        f"{int(sh.fluid['Alive'].sum())} alive): counts {kc}; max |d| / max "
        + ", ".join(f"{b} {e:.3e} / {m:.3f}" for b, (e, m) in errs.items()))


def a7_simbody_run(torch, ps, out, restart_step=0):
    """play_simbody_3d.run_case's loop to A7_SIMBODY_STEPS: from the rest
    state, or from the snapshot of `restart_step`, one make_run_step step
    to each integer time, each written by write_state_xml."""
    from sphinxsys_tpu_torch.physics import articulated as art

    tree = ps.build_tree(device=DEVICE)
    run = ps.make_run_step(tree, ps.build_motions())
    s = ps.init_sim(tree)
    if restart_step:
        t, q, u = (torch.as_tensor(v, dtype=s.q.dtype, device=s.q.device)
                   for v in art.read_state_xml(str(out), restart_step))
        s = ps.SimState(t=t, q=q, u=u)
    for step_i in range(restart_step + 1, A7_SIMBODY_STEPS + 1):
        s = run(s)
        art.write_state_xml(str(out), step_i, s.t, s.q, s.u)
    return s


def a7_play_simbody(torch, results):
    """play_simbody_3d's first A7_SIMBODY_STEPS steps (of the case's 10,
    `a7_simbody_run`) on the card in float64: the final q and u on the
    closed-form motions within 1e-12, the restart from A7_SIMBODY_RESTART
    bit for bit; the RK4 sub-step's launches profiled."""
    import shutil

    from sphinxsys_tpu_torch.cases import play_simbody_3d as ps

    out = ROOT / "build" / "a7_play_simbody"
    shutil.rmtree(out, ignore_errors=True)
    read_counts = reset_all_launch_counts()
    with SyncCounter(torch) as syncs:
        t0 = time.perf_counter()
        s = a7_simbody_run(torch, ps, out)
        run_s = time.perf_counter() - t0
    counts = read_counts()
    check(not any(counts.values()), f"a7 play_simbody: a hand kernel ran "
          f"{counts}")
    names = [f"multibody_state_{i:06d}.xml"
             for i in range(A7_SIMBODY_RESTART + 1, A7_SIMBODY_STEPS + 1)]
    first = [(out / n).read_bytes() for n in names]
    r = a7_simbody_run(torch, ps, out, A7_SIMBODY_RESTART)
    same = [(out / n).read_bytes() for n in names] == first
    q, u, _ = ps.build_motions().q_u_udot(s.t, torch.float64)
    eq = float((s.q - q).abs().max() / q.abs().max())
    eu = float((s.u - u).abs().max() / u.abs().max())
    from sphinxsys_tpu_torch.physics import articulated as art

    step = art.make_articulated_step(ps.build_tree(device=DEVICE),
                                     (0.0, 0.0, 0.0), ps.build_motions())
    dt = torch.tensor(ps.DT, dtype=torch.float64, device=DEVICE)
    dev_us, _, plain_us, launches = profile_step(
        torch, "a7_play_simbody_rk4",
        lambda: step(s.t, s.q, s.u, dt, torch.zeros_like(s.q)),
        "RK4 sub-step", trace=False)
    log(f"a7 play_simbody (float64, {A7_SIMBODY_STEPS} steps of "
        f"{round(1 / ps.DT)} RK4 sub-steps): {run_s:.2f} s, "
        f"{syncs.n} host reads; final q {s.q.tolist()} u {s.u.tolist()}, "
        f"relative error to the closed-form motions q {eq:.2e} u {eu:.2e} "
        f"(bound 1e-12); restart from step {A7_SIMBODY_RESTART} bit for bit: "
        f"{same}; one RK4 "
        f"sub-step {plain_us / 1e3:.3f} ms wall, {dev_us / 1e3:.3f} ms "
        f"device in {launches} launches")
    check(eq <= 1e-12 and eu <= 1e-12,
          f"a7 play_simbody: off the closed form (q {eq:.2e}, u {eu:.2e})")
    check(same and torch.equal(r.q, s.q) and torch.equal(r.u, s.u),
          "a7 play_simbody: the restart differs")
    results["_a7_play_simbody"] = dict(
        run_s=run_s, host_reads=syncs.n, err_q=eq, err_u=eu, restart=same,
        kernel_launches=counts, rk4_substep=dict(
            wall_ms=plain_us / 1e3, device_ms=dev_us / 1e3,
            launches=launches))


def a7_tether_bounds(torch, case, sim, f, fi):
    """Each part's least time from this run's lists and fields
    (`list_bound`)."""
    lists = [sim.nl_ff, sim.nl_fs, sim.nl_fw]
    w = case.wall
    solid = frozen_bound(torch, case.rp, fi)
    articulated = list_bound(torch, None, [], fields(fi, "Position", "Force",
                                                     "ForcePrior")
                             + [case.head_mask, sim.q, sim.u],
                             [sim.q, sim.u])
    constrain = list_bound(torch, None, [], fields(fi, "Position", "Velocity")
                           + [case.head_mask, case.head_station],
                           fields(fi, "Position", "Velocity"))
    fluid = list_bound(torch, "acoustic_substep", lists,
                       fields(f, *FLUID_AC_READS) + fields(fi, *WALL_READS)
                       + fields(w, *WALL_READS), fields(f, *FLUID_AC_WRITES))
    coupling = list_bound(
        torch, "coupling", [sim.nl_sf],
        fields(fi, "Position", "VolumetricMeasure", "NormalDirection",
               "AverageVelocity", "ForcePrior")
        + fields(f, "Position", "Pressure", "Density", "VolumetricMeasure",
                 "Velocity"),
        fields(fi, "PressureForceFromFluid", "ForcePrior"))
    sub = (solid[0] + articulated[0] + constrain[0], solid[1], solid[2])
    per_ac = sim.n_s / sim.n_ac
    return {
        "indication_density": list_bound(
            torch, "density", lists,
            fields(f, "Position", "Mass", "Density", "VolumetricMeasure",
                   "PreviousSurfaceIndicator")
            + fields(fi, "Position", "Mass", "VolumetricMeasure")
            + fields(w, "Position", "Mass", "VolumetricMeasure"),
            fields(f, "Indicator", "PositionDivergence", "DensitySummation",
                   "Density", "VolumetricMeasure")),
        "acoustic_substep": (fluid[0] + coupling[0] + per_ac * sub[0],
                             fluid[1], fluid[2] + coupling[2]
                             + round(per_ac * sub[2])),
        "solid_substep": sub,
        "articulated_step": articulated,
        "emitter_disposer": ob_open_boundary_bound(torch, f)}


def a7_tether_path(torch, results):
    """tethered_fish_2d at its full width (dx = FISH_L / 100) through the
    public entry points to A7_TETHER_T_END, float32: no overflow, finite
    fields, the fish inside the channel, (q, u) finite; then one advection
    step and each part alone (`ob_parts`)."""
    from sphinxsys_tpu_torch.cases import tethered_fish_2d as tf
    from sphinxsys_tpu_torch.physics import fluid as fd
    from sphinxsys_tpu_torch.physics import solid as sd

    def build():
        case, fluid, fish = tf.build_case(device=DEVICE)
        return case, tf, tf.init_sim(case, fluid, fish)

    case, sim, rec = ob_main_run(torch, "a7 tether", build, A7_TETHER_T_END,
                                 A7_TETHER_SAMPLE)
    f, fi = sim.fluid, sim.fish
    alive = f["Alive"]
    ps_ = fi["Position"]
    inside = bool(((ps_[:, 0] > -case.dl_sponge) & (ps_[:, 0] < tf.DL)
                   & (ps_[:, 1] > 0.0) & (ps_[:, 1] < tf.DH)).all())
    log(f"a7 tether main path: n_fluid={case.n_fluid} rows "
        f"({int(alive.sum())} alive) n_fish={case.n_fish} (head "
        f"{int(case.head_mask.sum())}); setup {rec['setup_s']:.2f} s; to "
        f"t={float(sim.time):.6f} counts (n_adv, n_ac, n_s) "
        f"{(sim.n_adv, sim.n_ac, sim.n_s)}; q {sim.q.tolist()}, tension "
        f"{tf.cable_tension(case, sim):.4f}; {rec['run_s']:.2f} s: "
        f"{rec['ms_per_adv']:.3f} ms an advection step (wall clock, mean), "
        f"{rec['host_reads_per_adv']:.1f} host reads an advection step; "
        f"peak device memory {rec['peak_gb']:.3f} GB")
    check(not bool(sim.overflow), "a7 tether: overflow")
    for k in ("Position", "Velocity", "Density", "Pressure"):
        check(bool(torch.isfinite(f[k][alive]).all()),
              f"a7 tether: non-finite fluid {k}")
    for k in ("Position", "Velocity", "DeformationGradient"):
        check(bool(torch.isfinite(fi[k]).all()), f"a7 tether: non-finite fish {k}")
    check(bool(torch.isfinite(sim.q).all() and torch.isfinite(sim.u).all()),
          "a7 tether: non-finite (q, u)")
    check(inside, "a7 tether: a fish particle left the channel")

    kernel, h = case.kernel, case.adaptation.h
    dt_adv = fd.advection_viscous_time_step(f, h, tf.U_F, tf.RHO0_F, tf.MU_F)
    dt = torch.minimum(fd.acoustic_time_step(f, case.eos, h), dt_adv)
    dt_s = torch.minimum(sd.solid_acoustic_time_step(
        fi, case.material_s.sound_speed, h), dt)
    pos0 = f["Position"]
    q, u = sim.q, sim.u
    step = tf.make_advection_step(case)

    def indication_density():
        g = fd.free_surface_indication(
            f, sim.nl_ff, kernel, 2, contacts=[(fi, sim.nl_fs, None),
                                               (case.wall, sim.nl_fw, None)],
            spatial_temporal=True)
        return fd.density_summation_freestream(
            g, sim.nl_ff, kernel, 2, tf.RHO0_F, case.adaptation.sigma0,
            contacts=[(fi, sim.nl_fs, tf.RHO0_S),
                      (case.wall, sim.nl_fw, tf.RHO0_F)])

    fns = {
        "rebuild": lambda: tf.rebuild_relations(case, f, fi),
        "indication_density": indication_density,
        "acoustic_substep": lambda: tf.acoustic_substep(
            case, sim, f, fi, q, u, dt_adv, sim.time),
        "solid_substep": lambda: tf.solid_substep(case, fi, q, u, dt_s,
                                                  sim.time),
        "articulated_step": lambda: tf.articulated_step(case, fi, q, u, dt_s,
                                                        sim.time),
        "emitter_disposer": lambda: tf.open_boundaries(case, f, pos0),
    }
    bounds = a7_tether_bounds(torch, case, sim, f, fi)
    parts = ob_parts(torch, "a7_tether", fns, lambda: step(sim), bounds,
                     trace=False)
    per_ac = sim.n_s / sim.n_ac
    log(f"a7 tether: {sim.n_ac / sim.n_adv:.2f} acoustic sub-steps an "
        f"advection step, {per_ac:.2f} solid sub-steps an acoustic one; the "
        f"articulated RK4 step {parts['articulated_step']['wall_ms']:.3f} ms "
        f"wall of the solid sub-step's "
        f"{parts['solid_substep']['wall_ms']:.3f} ms")
    results["_a7_tether"] = dict(rec, n_fluid=case.n_fluid,
                                 n_fish=case.n_fish, n_adv=sim.n_adv,
                                 n_ac=sim.n_ac, n_s=sim.n_s,
                                 q=sim.q.tolist(), parts=parts)
    del case, sim, f, fi, step
    torch.cuda.empty_cache()


def a7_case_bounds(torch, name, case, sim):
    """(advection step, acoustic sub-step) least times of a 3a case from
    this run's lists and fields: the step is its prep (the density
    summation's pass, and the viscous force's and the transport
    correction's where the case has them) plus its mean acoustic sub-steps
    (and the gate's sub-steps)."""
    f = sim.fluid
    lists = [nl for nl in (getattr(sim, k, None) for k in
                           ("nl_inner", "nl_wall", "nl_ff", "nl_fw", "nl_fg"))
             if nl is not None]
    walls = [b for b in (getattr(case, "wall", None), getattr(sim, "gate", None),
                         getattr(sim, "cyl", None)) if b is not None]
    wall_reads = [t for b in walls for t in fields(b, *WALL_READS)]
    ac = list_bound(torch, "acoustic_substep", lists,
                    fields(f, *FLUID_AC_READS) + wall_reads,
                    fields(f, *FLUID_AC_WRITES))
    prep = list_bound(torch, "density", lists,
                      fields(f, "Position", "Mass", "Density") + wall_reads,
                      fields(f, "DensitySummation", "Density",
                             "VolumetricMeasure"))
    extra = 0.0
    if name in ("stlw_2d", "flow_around_cylinder_2d"):
        visc = list_bound(torch, "coupling", lists,
                          fields(f, "Position", "Velocity",
                                 "VolumetricMeasure") + wall_reads,
                          fields(f, "ViscousForce", "ForcePrior"))
        extra += visc[0] * (2 if name == "flow_around_cylinder_2d" else 1)
    per_ac = sim.n_ac / sim.n_adv
    if name == "elastic_gate_2d":
        solid = frozen_bound(torch, case.rp, sim.gate)
        ac = (ac[0] + sim.n_s / sim.n_ac * solid[0], ac[1],
              ac[2] + round(sim.n_s / sim.n_ac * solid[2]))
    step = (prep[0] + extra + per_ac * ac[0], ac[1],
            prep[2] + round(per_ac * ac[2]))
    return {"acoustic_substep": ac}, step


def a7_case_path(torch, name, results):
    """A 3a case at its JAX default width through the public entry points
    (A7_MAIN's end time), float32: no overflow, finite fields; then one
    advection step and one acoustic sub-step alone (`ob_parts`)."""
    from sphinxsys_tpu_torch.physics import fluid as fd

    cm = importlib.import_module(f"sphinxsys_tpu_torch.cases.{name}")
    kw, t_end, sample = A7_MAIN[name]

    def build():
        case, *states = cm.build_case(device=DEVICE, **kw)
        return case, cm, cm.init_sim(case, *states)

    case, sim, rec = ob_main_run(torch, f"a7 {name}", build, t_end, sample)
    f = sim.fluid
    rows = f.get("Alive", torch.ones(f["Position"].shape[0], dtype=torch.bool,
                                     device=f["Position"].device))
    check(not bool(sim.overflow), f"a7 {name}: overflow")
    for body in A7_BODIES[name]:
        b = getattr(sim, body)
        r = rows if body == "fluid" else slice(None)
        for k in ("Position", "Velocity"):
            check(bool(torch.isfinite(b[k][r]).all()),
                  f"a7 {name}: non-finite {body} {k}")
    obs = {"stlw_2d": lambda: float(cm.free_surface_height(case, f)),
           "filling_tank_2d": lambda: [cm.n_alive(sim),
                                       cm.mechanical_energy(case, sim)],
           "elastic_gate_2d": lambda: cm.tip_position(case, sim).tolist(),
           "flow_around_cylinder_2d":
               lambda: cm.total_viscous_force(sim).tolist()}[name]()
    counts = tuple(getattr(sim, k) for k in A7_COUNTS if hasattr(sim, k))
    n_rows = f["Position"].shape[0]
    log(f"a7 {name} main path: {n_rows} fluid rows ({int(rows.sum())} real); "
        f"setup {rec['setup_s']:.2f} s; to t={float(sim.time):.6f} counts "
        f"{counts}; observable {obs}; {rec['ms_per_adv']:.3f} ms an "
        f"advection step (wall clock, mean), {rec['host_reads_per_adv']:.1f} "
        f"host reads an advection step")
    if name == "filling_tank_2d":
        check(cm.n_alive(sim) > case.n_seed, "a7 filling_tank: no injection")
    h = case.adaptation.h
    if name in ("filling_tank_2d", "elastic_gate_2d"):    # inviscid
        dt_adv = fd.advection_time_step(f, h, cm.U_F)
    else:
        dt_adv = fd.advection_viscous_time_step(f, h, cm.U_F, cm.RHO0_F,
                                                cm.MU_F)
    ac = {"stlw_2d": lambda: cm.acoustic_substep(case, sim, f, dt_adv),
          "filling_tank_2d": lambda: cm.acoustic_substep(case, sim, f,
                                                         dt_adv),
          "elastic_gate_2d": lambda: cm.acoustic_substep(case, sim, f,
                                                         sim.gate, dt_adv),
          "flow_around_cylinder_2d": lambda: cm.acoustic_substep(
              case, sim, f, sim.cyl, dt_adv, sim.time)}[name]
    bounds, step_bound = a7_case_bounds(torch, name, case, sim)
    bounds["advection_step"] = step_bound
    step = cm.make_advection_step(case)
    parts = ob_parts(torch, f"a7_{name}", {"acoustic_substep": ac},
                     lambda: step(sim), bounds, trace=False)
    results[f"_a7_{name}"] = dict(rec, counts=counts, observable=obs,
                                  n_rows=n_rows, parts=parts)
    del case, sim, f, step
    torch.cuda.empty_cache()


def a7_phase(torch, results):
    """Phase 14: the articulated multibody and the 3a fluid cases
    (neighbour lists and torch ops, no hand kernel): the small references
    (float32 card against float64 CPU), play_simbody in float64, the
    tethered fish at full width and the four 3a cases at their default
    widths through the public entry points, each step by part."""
    t0 = time.perf_counter()
    a7_small_references(torch)
    t1 = time.perf_counter()
    a7_play_simbody(torch, results)
    a7_tether_path(torch, results)
    for name in A7_MAIN:
        a7_case_path(torch, name, results)
    log(f"a7 phase: {time.perf_counter() - t0:.1f} s (references "
        f"{t1 - t0:.1f} s)")


# ---------------------------------------------------------------------------
# Phase 15: the kernel-corrected fluid and the remaining elastic-solid laws
# (ROADMAP A items 3b-3c: neighbour lists and frozen pairs, torch ops)
# ---------------------------------------------------------------------------

# case -> (the main path's end time, its output interval), each at its JAX
# default width
A7BC_MAIN = {
    "standing_wave_2d": (0.005, 0.0025),
    "poiseuille_flow_2d": (0.03, 0.015),
    "impact_patch_2d": (0.005, 0.0025),
    "rotation_patch_2d": (0.01, 0.005),
    "oscillating_beam_2d": (2e-4, 1e-4),
    "oscillating_beam_cauchy_2d": (2e-4, 1e-4),
    "self_contact_2d": (2e-4, 1e-4),
    "passive_cantilever_3d": (2e-3, 1e-3),
    "muscle_activation_3d": (0.01, 0.005),
    "anisotropic_beam_2d": (2e-4, 1e-4),
}
A7BC_BODY = {"oscillating_beam_2d": "solid",
             "oscillating_beam_cauchy_2d": "solid",
             "anisotropic_beam_2d": "solid", "self_contact_2d": "beam",
             "passive_cantilever_3d": "body", "muscle_activation_3d": "body"}
# float32 against float64 from the same state: case -> (steps, tolerance of
# the displacement x - x0, tolerance of the velocity), each a share of the
# float64 run's max.  The steps are enough that the displacement stands at
# least A7BC_F32_SEEN times above float32's rounding of the positions over
# the run (steps * 2^-24 * max|x0|; the muscle cube starts at rest under a
# ramp from Ta = 0 and needs ~100 steps).  Each tolerance is ten times the
# larger reading of this check on the CPU (DEVICE = "cpu") and on an H100,
# rounded up to one significant digit.  The standing wave starts at
# rest, so its velocity is acoustic noise from the density's float32
# rounding (~0.5% of max|v|).
A7BC_F32 = {
    "standing_wave_2d": (50, 2e-2, 6e-2),
    "poiseuille_flow_2d": (20, 8e-4, 8e-4),
    "impact_patch_2d": (20, 2e-4, 7e-5),
    "rotation_patch_2d": (20, 3e-4, 3e-4),
    "oscillating_beam_2d": (200, 3e-4, 2e-4),
    "oscillating_beam_cauchy_2d": (200, 3e-4, 2e-4),
    "self_contact_2d": (100, 4e-4, 5e-3),
    "passive_cantilever_3d": (100, 3e-4, 2e-4),
    "muscle_activation_3d": (100, 2e-3, 6e-4),
    "anisotropic_beam_2d": (200, 3e-4, 2e-4),
}
A7BC_F32_SEEN = 100.0


def minimum_image(torch, d, box):
    """Differences of positions taken to their nearest periodic image on
    the axes where `box` (the case's periodic lengths, 0 off them) is
    positive; `d` as it is where the case has no box."""
    if box is None:
        return d
    L = torch.as_tensor([float(b) for b in box], dtype=d.dtype,
                        device=d.device)
    safe = torch.where(L > 0, L, torch.ones_like(L))
    return torch.where(L > 0, d - safe * torch.round(d / safe), d)


def cast_tree(torch, obj, dtype, device=None):
    """A sim or a case with every floating tensor cast to `dtype` (dicts,
    named tuples and dataclasses walked; integer and bool tensors kept),
    and every tensor moved to `device` where one is given."""
    if torch.is_tensor(obj):
        obj = obj.to(dtype) if obj.is_floating_point() else obj
        return obj if device is None else obj.to(device)
    if isinstance(obj, dict):
        return {k: cast_tree(torch, v, dtype, device) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(cast_tree(torch, v, dtype, device) for v in obj))
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: cast_tree(torch, getattr(obj, f.name), dtype, device)
            for f in dataclasses.fields(obj) if f.init})
    return obj


def a7bc_stepper(cm, case):
    return (cm.make_advection_step(case) if hasattr(cm, "make_advection_step")
            else cm.make_step(case))


def a7bc_start(cm, case, states):
    return cm.init_sim(case, *states) if hasattr(cm, "init_sim") \
        else states[0]


def a7bc_f32_check(torch, name):
    """The case at its default width built in float64 on the card, and the
    same state cast to float32: A7BC_F32's steps on each, equal counts, the
    displacement x - x0 and the velocity each within its tolerance of its
    float64 max, the displacement at least A7BC_F32_SEEN times float32's
    rounding of the positions.  Returns the errors."""
    cm = importlib.import_module(f"sphinxsys_tpu_torch.cases.{name}")
    n, tol_d, tol_v = A7BC_F32[name]
    case64, *states = cm.build_case(dtype=torch.float64, device=DEVICE)
    s64 = a7bc_start(cm, case64, states)
    case32, s32 = cast_tree(torch, case64, torch.float32), \
        cast_tree(torch, s64, torch.float32)
    body = A7BC_BODY.get(name, "fluid")
    box = getattr(case64, "box", None)
    runs, x0 = [], []
    for case, s in ((case64, s64), (case32, s32)):
        x0.append(getattr(s, body)["Position"].double())
        step = a7bc_stepper(cm, case)
        for _ in range(n):
            s = step(s)
        runs.append(s)
    s64, s32 = runs
    counts = [tuple(getattr(s, k) for k in ("n_adv", "n_ac", "n_steps")
                    if hasattr(s, k)) for s in runs]
    check(counts[0] == counts[1], f"a7bc {name}: float32 counts {counts[1]} "
          f"!= float64 {counts[0]}")
    b64, b32 = getattr(s64, body), getattr(s32, body)
    for b in (b32, b64):
        for k in ("Position", "Velocity"):
            check(bool(torch.isfinite(b[k]).all()),
                  f"a7bc {name}: non-finite {k}")
    d64 = minimum_image(torch, b64["Position"] - x0[0], box)
    d32 = minimum_image(torch, b32["Position"].double() - x0[1], box)
    errs = {"displacement": (minimum_image(torch, d32 - d64, box), d64,
                             tol_d),
            "velocity": (b32["Velocity"].double() - b64["Velocity"],
                         b64["Velocity"], tol_v)}
    errs = {k: (float(e.abs().max()), float(r.abs().max()), tol)
            for k, (e, r, tol) in errs.items()}
    rounding = n * 2.0 ** -24 * float(x0[0].abs().max())
    seen = errs["displacement"][1] / rounding
    log(f"a7bc {name} float32 against float64 on the card (the same built "
        f"state, {n} steps): counts {counts[0]}; max |d| / max, tolerance "
        + ", ".join(f"{k} {e:.3e} / {m:.3e} = {e / m:.3e}, {tol:g}"
                    for k, (e, m, tol) in errs.items())
        + f"; displacement {seen:.1f} x float32's position rounding "
        f"(at least {A7BC_F32_SEEN:g})")
    check(seen >= A7BC_F32_SEEN, f"a7bc {name}: after {n} steps the "
          f"displacement {errs['displacement'][1]:.3e} is only {seen:.1f} x "
          f"float32's position rounding {rounding:.3e}")
    for k, (e, m, tol) in errs.items():
        check(e <= tol * m, f"a7bc {name}: float32 {k} off float64 by "
              f"{e:.3e} (max {m:.3e}, tolerance {tol:g})")
    del case64, case32, s64, s32, runs, b64, b32, d64, d32
    return dict(counts=counts[0], **{k: e for k, (e, _, _) in errs.items()})


def a7bc_observable(name, cm, case, sim, built):
    if name == "standing_wave_2d":
        return float(cm.free_surface_height(case, sim.fluid))
    if name in ("poiseuille_flow_2d", "impact_patch_2d", "rotation_patch_2d"):
        return cm.kinetic_energy(sim)
    if name == "self_contact_2d":
        return cm.observe_tip(sim, *cm.tip_observer(case, built)).tolist()
    if name == "passive_cantilever_3d":
        return cm.observe_corner(sim, *cm.corner_observer(case, built)
                                 ).tolist()
    if name == "muscle_activation_3d":
        return cm.free_end_x(sim)
    return cm.tip_displacement(case, sim)


def a7bc_bounds(torch, name, cm, case, sim):
    """Each profiled part's least time from this run's lists, frozen pairs
    and fields (`list_bound`): a fluid step is its prep (density, the
    correction matrix, and the indication, viscous force or transport
    correction where the case has them) plus its mean acoustic sub-steps;
    a solid step its frozen pairs' pass (plus the self-contact list's)."""
    if name in A7BC_BODY:
        body = getattr(sim, A7BC_BODY[name])
        step = frozen_bound(torch, case.rp, body)
        if name == "self_contact_2d":
            nl, _ = cm.self_contact_list(case, body)
            contact = list_bound(torch, "contact", [nl],
                                 fields(body, "Position", "Velocity",
                                        "VolumetricMeasure",
                                        "InitialPosition"),
                                 fields(body, "RepulsionForce", "ForcePrior"))
            step = (step[0] + contact[0], step[1], step[2] + contact[2])
        return {"advection_step": step}
    f = sim.fluid
    lists = [nl for nl in (sim.nl_inner, getattr(sim, "nl_wall", None))
             if nl is not None]
    wall = getattr(case, "wall", None)
    wall_reads = fields(wall, *WALL_READS) if wall is not None else []
    B = fields(f, "LinearGradientCorrectionMatrix")
    ac = list_bound(torch, "acoustic_substep", lists,
                    fields(f, *FLUID_AC_READS) + B + wall_reads,
                    fields(f, *FLUID_AC_WRITES))
    first = list_bound(torch, "corrected_1st_half", lists,
                       fields(f, *FLUID_AC_READS) + B + wall_reads,
                       fields(f, *FLUID_AC_WRITES))
    corr = list_bound(torch, "correction", lists,
                      fields(f, "Position", "VolumetricMeasure") + wall_reads,
                      B)
    prep = list_bound(torch, "density", lists,
                      fields(f, "Position", "Mass", "Density") + wall_reads,
                      fields(f, "DensitySummation", "Density",
                             "VolumetricMeasure"))
    extra = 0.0
    if name == "poiseuille_flow_2d":          # viscous force, TVC
        extra = 2 * list_bound(torch, "coupling", lists,
                               fields(f, "Position", "Velocity",
                                      "VolumetricMeasure") + wall_reads,
                               fields(f, "ViscousForce", "ForcePrior"))[0]
    elif name in ("impact_patch_2d", "rotation_patch_2d"):  # indication, TVC
        extra = list_bound(torch, "surface_indication", lists,
                           fields(f, "Position", "VolumetricMeasure",
                                  "PreviousSurfaceIndicator"),
                           fields(f, "Indicator", "PositionDivergence"))[0] \
            + list_bound(torch, "coupling", lists,
                         fields(f, "Position", "VolumetricMeasure"),
                         fields(f, "Position"))[0]
    per_ac = sim.n_ac / sim.n_adv
    step = (prep[0] + corr[0] + extra + per_ac * ac[0], ac[1],
            prep[2] + round(per_ac * ac[2]))
    return {"advection_step": step, "acoustic_substep": ac,
            "correction_matrix": corr, "corrected_1st_half": first}


def a7bc_case_path(torch, name, results):
    """A case at its JAX default width through build_case -> init_sim ->
    make_run_chunk -> solver.run_simulation (A7BC_MAIN's end time),
    float32, every launch count reset just before and read just after: no
    overflow, finite fields; then one step (and, for the fluid, an
    acoustic sub-step, the correction matrix and the corrected first half)
    alone (`ob_parts`)."""
    from sphinxsys_tpu_torch.physics import fluid as fd

    cm = importlib.import_module(f"sphinxsys_tpu_torch.cases.{name}")
    t_end, sample = A7BC_MAIN[name]
    built = {}

    def build():
        case, *states = cm.build_case(device=DEVICE)
        sim = a7bc_start(cm, case, states)
        built["body"] = states[0] if isinstance(states[0], dict) \
            else states[0].solid
        return case, cm, sim

    case, sim, rec = ob_main_run(torch, f"a7bc {name}", build, t_end, sample)
    body = getattr(sim, A7BC_BODY.get(name, "fluid"))
    check(not bool(getattr(sim, "overflow", False)), f"a7bc {name}: overflow")
    for k in ("Position", "Velocity", "Density"):
        check(bool(torch.isfinite(body[k]).all()),
              f"a7bc {name}: non-finite {k}")
    counts = tuple(getattr(sim, k) for k in ("n_adv", "n_ac", "n_steps")
                   if hasattr(sim, k))
    obs = a7bc_observable(name, cm, case, sim, built["body"])
    log(f"a7bc {name} main path: {body['Position'].shape[0]} particles; "
        f"setup {rec['setup_s']:.2f} s; to t={float(sim.time):.6f} counts "
        f"{counts}; observable {obs}; {rec['ms_per_adv']:.3f} ms a step "
        f"(wall clock, mean), {rec['host_reads_per_adv']:.1f} host reads a "
        f"step; peak device memory {rec['peak_gb']:.3f} GB")
    fns = {}
    if name not in A7BC_BODY:
        f, kernel, h = sim.fluid, case.kernel, case.adaptation.h
        dt_adv = fd.advection_time_step(f, h, cm.U_MAX if hasattr(cm, "U_MAX")
                                        else cm.U_REF)
        wall_kw = dict(wall=case.wall, nl_wall=sim.nl_wall) \
            if hasattr(case, "wall") else {}
        box = getattr(case, "box", None)
        dt = torch.minimum(fd.acoustic_time_step(f, case.eos, h), dt_adv)
        args = (f, sim.nl_inner, kernel, 2)
        # the standing wave's sub-step is not capped by the advection dt
        ac_args = (case, sim, f) if name == "standing_wave_2d" \
            else (case, sim, f, dt_adv)
        fns = {"acoustic_substep": lambda: cm.acoustic_substep(*ac_args),
               "correction_matrix": lambda: fd.kernel_correction_matrix(
                   *args, alpha=0.5, box=box, **wall_kw),
               "corrected_1st_half": lambda: fd.acoustic_step_1st_half(
                   *args, case.eos, case.riemann, dt, box=box,
                   correction=True, **wall_kw)}
    parts = ob_parts(torch, f"a7bc_{name}", fns,
                     lambda: a7bc_stepper(cm, case)(sim),
                     a7bc_bounds(torch, name, cm, case, sim), trace=False)
    results[f"_a7bc_{name}"] = dict(rec, counts=counts, observable=obs,
                                    n_particles=body["Position"].shape[0],
                                    parts=parts)
    del case, sim, body, built, fns
    torch.cuda.empty_cache()


def a7bc_phase(torch, results):
    """Phase 15: the ten cases of ROADMAP A items 3b-3c (no hand kernel),
    each at its JAX default width: float32 against float64 on the card from
    the same state, then through the public entry points, its step by
    part."""
    t0 = time.perf_counter()
    for name in A7BC_MAIN:
        f32 = a7bc_f32_check(torch, name)
        a7bc_case_path(torch, name, results)
        results[f"_a7bc_{name}"]["f32_vs_f64"] = f32
    log(f"a7bc phase: {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# Phase 16: the multi-phase fluid and the rigid bodies (ROADMAP A item 3d
# and the rigid-body family of item 4: neighbour lists, torch ops)
# ---------------------------------------------------------------------------

# case -> (the hold left at the start, the main path's end time, its output
# interval).  stfb and the wave cases hold their body (and wavemaker) for
# the first RELAX_TIME = 1 s; the main path (and the float32 check) takes
# A7D_HOLD of it, stfb as init_sim's settle_time, the wave cases by starting
# at a total time of RELAX_TIME - A7D_HOLD, so that its steps run both the
# held and the released sub-steps.
A7D_HOLD = 0.004
A7D_MAIN = {
    "two_phase_dambreak_2d": (None, 0.04, 0.02),
    "square_droplet_2d": (None, 0.002, 0.001),
    "droplet_impact_2d": (None, 0.003, 0.0015),
    "cubic_droplet_3d": (None, 0.003, 0.0015),
    "floating_body_2d": (None, 0.008, 0.004),
    "stfb_2d": (A7D_HOLD, 0.006, 0.003),
    "owsc_2d": (A7D_HOLD, 0.004, 0.002),
    "nonlinear_wave_fsi_2d": (A7D_HOLD, 0.004, 0.002),
}
A7D_PHASES = ("two_phase_dambreak_2d", "square_droplet_2d",
              "droplet_impact_2d", "cubic_droplet_3d")
A7D_BODY = {name: "water" for name in A7D_PHASES}
A7D_RIGID = {"floating_body_2d": ("block", "rb"), "stfb_2d": ("block", "rb"),
             "owsc_2d": ("flap", "pj"),
             "nonlinear_wave_fsi_2d": ("block", "rb")}
# float32 against float64 from the same built state: case -> (advection
# steps, tolerance of the displacement x - x0, tolerance of the velocity),
# each a share of the float64 run's max (the form of A7BC_F32; the main
# body: the water, or the fluid around the rigid body).  It starts as the
# main path does (A7D_MAIN's hold), so that the wave cases' steps cross the
# release.  Each tolerance is ten times the larger
# reading of this check on the CPU (DEVICE = "cpu") and on an H100,
# rounded up to one significant digit.  The wave tanks are 18 m and 35 m
# long: float32's rounding of the positions there (~2e-6) is ~30 ulps of
# the water's displacement after these steps.
A7D_F32 = {
    "two_phase_dambreak_2d": (10, 2e-3, 8e-4),
    "square_droplet_2d": (10, 1e-3, 2e-4),
    "droplet_impact_2d": (10, 8e-4, 5e-4),
    "cubic_droplet_3d": (4, 2e-3, 2e-4),
    "floating_body_2d": (10, 9e-3, 7e-3),
    "stfb_2d": (10, 2e-3, 3e-3),
    "owsc_2d": (10, 4e-2, 5e-2),
    "nonlinear_wave_fsi_2d": (10, 7e-2, 7e-2),
}
A7D_F32_SEEN = 100.0


def a7d_main_body(name, sim):
    return getattr(sim, A7D_BODY.get(name, "fluid"))


def a7d_start(torch, name, cm, case, states):
    """init_sim with A7D_MAIN's hold left: stfb's settling window, or the
    wave cases' total time that far before their release."""
    hold = A7D_MAIN[name][0]
    if name == "stfb_2d":
        return cm.init_sim(case, *states, settle_time=hold)
    sim = cm.init_sim(case, *states)
    if hold is not None:
        sim.total_time = torch.full_like(sim.total_time,
                                         cm.RELAX_TIME - hold)
    return sim


def a7d_f32_check(torch, name):
    """The case at its default width built in float64 on the card, started
    (init_sim), and the same state cast to float32: A7D_F32's advection
    steps on each, equal counts, the main body's displacement and velocity
    each within its tolerance of its float64 max, the displacement at
    least A7D_F32_SEEN times float32's rounding of the positions; the
    rigid body's COM (or the pin's angle) beside them.  Returns the
    errors."""
    cm = importlib.import_module(f"sphinxsys_tpu_torch.cases.{name}")
    n, tol_d, tol_v = A7D_F32[name]
    case64, *states = cm.build_case(dtype=torch.float64, device=DEVICE)
    s64 = a7d_start(torch, name, cm, case64, states)
    case32, s32 = cast_tree(torch, case64, torch.float32), \
        cast_tree(torch, s64, torch.float32)
    runs, x0 = [], []
    for case, s in ((case64, s64), (case32, s32)):
        x0.append(a7d_main_body(name, s)["Position"].double())
        step = cm.make_advection_step(case)
        for _ in range(n):
            s = step(s)
        runs.append(s)
    s64, s32 = runs
    counts = [(s.n_adv, s.n_ac) for s in runs]
    check(counts[0] == counts[1], f"a7d {name}: float32 counts {counts[1]} "
          f"!= float64 {counts[0]}")
    b64, b32 = a7d_main_body(name, s64), a7d_main_body(name, s32)
    for b in (b32, b64):
        for k in ("Position", "Velocity", "Density"):
            check(bool(torch.isfinite(b[k]).all()),
                  f"a7d {name}: non-finite {k}")
    d64 = b64["Position"] - x0[0]
    d32 = b32["Position"].double() - x0[1]
    errs = {"displacement": (d32 - d64, d64, tol_d),
            "velocity": (b32["Velocity"].double() - b64["Velocity"],
                         b64["Velocity"], tol_v)}
    errs = {k: (float(e.abs().max()), float(r.abs().max()), tol)
            for k, (e, r, tol) in errs.items()}
    rounding = n * 2.0 ** -24 * float(x0[0].abs().max())
    seen = errs["displacement"][1] / rounding
    rigid = ""
    if name in A7D_RIGID:
        r64, r32 = (getattr(s, A7D_RIGID[name][1]) for s in runs)
        f = "theta" if name == "owsc_2d" else "com"
        rigid = (f"; the rigid {f} {getattr(r32, f).double().tolist()} "
                 f"(float32) against {getattr(r64, f).tolist()}")
    log(f"a7d {name} float32 against float64 on the card (the same started "
        f"state, {n} steps): counts {counts[0]}; max |d| / max, tolerance "
        + ", ".join(f"{k} {e:.3e} / {m:.3e} = {e / m:.3e}, {tol:g}"
                    for k, (e, m, tol) in errs.items())
        + f"; displacement {seen:.1f} x float32's position rounding "
        f"(at least {A7D_F32_SEEN:g})" + rigid)
    check(seen >= A7D_F32_SEEN, f"a7d {name}: after {n} steps the "
          f"displacement {errs['displacement'][1]:.3e} is only {seen:.1f} x "
          f"float32's position rounding {rounding:.3e}")
    for k, (e, m, tol) in errs.items():
        check(e <= tol * m, f"a7d {name}: float32 {k} off float64 by "
              f"{e:.3e} (max {m:.3e}, tolerance {tol:g})")
    del case64, case32, s64, s32, runs, b64, b32, d64, d32
    return dict(counts=counts[0], **{k: e for k, (e, _, _) in errs.items()})


A7D_FLUID_READS = FLUID_AC_READS + ("Pressure",)
A7D_ST = ("ColorGradient", "NormDirection", "SurfaceTensionStress",
          "SurfaceTensionForce", "SurfaceTensionForcePrev", "Mass",
          "Density", "VolumetricMeasure", "Position", "ForcePrior")
A7D_RIGID_READS = ("Position", "Velocity", "AverageVelocity", "ForcePrior",
                   "InitialPosition", "InitialNormalDirection",
                   "NormalDirection")
A7D_RIGID_WRITES = ("Position", "Velocity", "AverageVelocity",
                    "NormalDirection", "AverageAcceleration")


def a7d_bounds(torch, name, case, sim):
    """Each profiled part's least time from this run's lists and fields
    (`list_bound`): the acoustic sub-step over every list it sums, the
    contact first half (the two-phase cases), the surface tension (the
    droplets: its stress and stress force over both phases' lists, at
    LIST_PAIR_FLOPS' per-pair count for its (N, K, d, d) tensors), the
    rigid update (its body's rows read and written once), and the
    advection step (its prep plus its mean sub-steps)."""
    out = {}
    if name in A7D_PHASES:
        w, a, wall = sim.water, sim.air, case.wall
        lists = [sim.nl_ww, sim.nl_wa, sim.nl_wb, sim.nl_aa, sim.nl_aw,
                 sim.nl_ab]
        reads = (fields(w, *A7D_FLUID_READS) + fields(a, *A7D_FLUID_READS)
                 + fields(wall, *WALL_READS))
        writes = fields(w, *FLUID_AC_WRITES) + fields(a, *FLUID_AC_WRITES)
        ac = list_bound(torch, "acoustic_substep", lists, reads, writes)
        out["contact_1st_half"] = list_bound(
            torch, "contact_1st_half", [sim.nl_ww, sim.nl_wa, sim.nl_wb],
            fields(w, *A7D_FLUID_READS)
            + fields(a, "Position", "VolumetricMeasure", "Pressure")
            + fields(wall, *WALL_READS), fields(w, *FLUID_AC_WRITES))
        prep = list_bound(torch, "coupling", lists, reads,
                          fields(w, "Density", "VolumetricMeasure",
                                 "ForcePrior", "Position")
                          + fields(a, "Density", "VolumetricMeasure",
                                   "ForcePrior", "Position"))
        if name != "two_phase_dambreak_2d":
            st = list_bound(torch, f"surface_tension_{case.dim}d",
                            [sim.nl_ww, sim.nl_wa, sim.nl_aa, sim.nl_aw],
                            fields(w, *A7D_ST) + fields(a, *A7D_ST),
                            fields(w, *A7D_ST[:5]) + fields(a, *A7D_ST[:5]))
            out["surface_tension"] = st
            ac = (ac[0] + st[0], ac[1], ac[2] + st[2])
    else:
        body_name, _ = A7D_RIGID[name]
        f, b = sim.fluid, getattr(sim, body_name)
        wall = getattr(sim, "wall", None) or case.wall
        nl_fb = getattr(sim, "nl_fb", None) or sim.nl_ff
        lists = [sim.nl_inner, sim.nl_fw, nl_fb, sim.nl_bf]
        B = fields(f, "LinearGradientCorrectionMatrix")
        reads = (fields(f, *A7D_FLUID_READS) + B + fields(wall, *WALL_READS)
                 + fields(b, *WALL_READS))
        ac = list_bound(torch, "acoustic_substep", lists, reads,
                        fields(f, *FLUID_AC_WRITES)
                        + fields(b, "PressureForceFromFluid", "ForcePrior"))
        rig = list_bound(torch, "rigid", [], fields(b, *A7D_RIGID_READS),
                         fields(b, *A7D_RIGID_WRITES))
        out["rigid_update"] = rig
        ac = (ac[0] + rig[0], ac[1], ac[2])
        prep = list_bound(torch, "density", lists, reads,
                          fields(f, "DensitySummation", "Density",
                                 "VolumetricMeasure", "ForcePrior")
                          + B)
    out["acoustic_substep"] = ac
    per_ac = sim.n_ac / sim.n_adv
    out["advection_step"] = (prep[0] + per_ac * ac[0], ac[1],
                             prep[2] + round(per_ac * ac[2]))
    return out


def a7d_parts(torch, name, cm, case, sim):
    """One acoustic sub-step of the case alone, and its contact first
    half, surface tension or rigid update alone, on the main path's end
    state."""
    from sphinxsys_tpu_torch.cases import floating_body_2d as fb
    from sphinxsys_tpu_torch.cases import owsc_2d as ow
    from sphinxsys_tpu_torch.cases import square_droplet_2d as sq
    from sphinxsys_tpu_torch.cases import two_phase_dambreak_2d as tp
    from sphinxsys_tpu_torch.physics import fluid as fd
    from sphinxsys_tpu_torch.physics import rigid as rg

    h = case.adaptation.h
    if name in A7D_PHASES:
        w, a = sim.water, sim.air
        dt = torch.minimum(fd.acoustic_time_step(w, case.eos_w, h),
                           fd.acoustic_time_step(a, case.eos_a, h))
        fns = {"contact_1st_half": lambda: fd.acoustic_step_1st_half(
            w, sim.nl_ww, case.kernel, case.dim, case.eos_w, case.rs_w, dt,
            walls=[(case.wall, sim.nl_wb)],
            contacts=[(a, sim.nl_wa, case.rs_wa)])}
        if name == "two_phase_dambreak_2d":
            fns["acoustic_substep"] = lambda: tp.acoustic_substep(
                case, sim, w, a, dt)
        else:
            def substep():
                w1, a1 = sq.surface_tension(case, sim, w, a)
                return tp.acoustic_substep(
                    case, sim, w1, a1, sq.capillary_dt(case, w1, a1, dt))
            fns["surface_tension"] = lambda: sq.surface_tension(case, sim,
                                                                w, a)
            fns["acoustic_substep"] = substep
        return fns
    f = sim.fluid
    dt_adv = fd.advection_viscous_time_step(
        f, h, getattr(cm, "U_REF", None) or cm.U_F, cm.RHO0_F,
        getattr(cm, "MU_F", 0.0))
    dt = torch.minimum(fd.acoustic_time_step(f, case.eos, h), dt_adv)
    if name == "owsc_2d":
        def pin():
            pj = rg.pin_joint_step(sim.pj, rg.pin_torque(
                sim.flap, case.mask_b, sim.pj, force_keys=("ForcePrior",)),
                dt, damping=cm.PTO_DAMPING, gravity=case.g_vec)
            return rg.constrain_by_pin_joint(sim.flap, case.mask_b, pj,
                                             case.flap0["InitialPosition"])
        return {"acoustic_substep": lambda: cm.acoustic_substep(
                    case, sim, f, sim.wall, sim.flap, sim.pj, sim.pto_energy,
                    sim.total_time, dt_adv),
                "rigid_update": pin,
                "wavemaker": lambda: ow.move_wavemaker(
                    case, sim.wall, case.piston, sim.total_time,
                    sim.total_time >= cm.RELAX_TIME, cm.RELAX_TIME)}
    if name == "nonlinear_wave_fsi_2d":
        released = sim.total_time >= cm.RELAX_TIME
        return {"acoustic_substep": lambda: cm.acoustic_substep(
                    case, sim, f, sim.wall, sim.block, sim.rb, sim.tension,
                    sim.total_time, dt_adv),
                "rigid_update": lambda: cm.rigid_update(
                    case, dict(sim.block), sim.rb, sim.tension, dt,
                    released),
                "wavemaker": lambda: ow.move_wavemaker(
                    case, sim.wall, case.packet, sim.total_time, released,
                    cm.RELAX_TIME),
                "cable_forces": lambda: cm._cable_forces(sim.rb,
                                                         case.rb0.com)}
    # the floating body and stfb share the sub-step and the rigid update
    return {"acoustic_substep": lambda: fb.acoustic_substep(
                case, sim, f, sim.block, sim.rb, dt_adv),
            "rigid_update": lambda: fb.rigid_update(case, dict(sim.block),
                                                    sim.rb, dt)}


def a7d_observable(name, cm, case, sim):
    if name == "two_phase_dambreak_2d":
        return float(cm.water_front(sim))
    if name in A7D_PHASES:
        return cm.water_kinetic_energy(sim)
    if name == "owsc_2d":
        return [float(sim.pj.theta), float(sim.pto_energy)]
    out = sim.rb.com.tolist()
    if name == "nonlinear_wave_fsi_2d":
        out += sim.tension.tolist()
    return out


def a7d_case_path(torch, name, results):
    """A case at its JAX default width through build_case -> init_sim ->
    make_run_chunk -> solver.run_simulation (A7D_MAIN's end time),
    float32, every launch count reset just before and read just after:
    no overflow, finite fields, the observable printed; then one advection
    step, one acoustic sub-step and the parts of `a7d_parts` alone
    (`ob_parts`: wall and device time, launches, host reads, bound)."""
    cm = importlib.import_module(f"sphinxsys_tpu_torch.cases.{name}")
    _, t_end, sample = A7D_MAIN[name]

    def build():
        case, *states = cm.build_case(device=DEVICE)
        return case, cm, a7d_start(torch, name, cm, case, states)

    case, sim, rec = ob_main_run(torch, f"a7d {name}", build, t_end, sample)
    check(not bool(sim.overflow), f"a7d {name}: overflow")
    bodies = ("water", "air") if name in A7D_PHASES \
        else ("fluid", A7D_RIGID[name][0])
    for body in bodies:
        for k in ("Position", "Velocity"):
            check(bool(torch.isfinite(getattr(sim, body)[k]).all()),
                  f"a7d {name}: non-finite {body} {k}")
    if name in A7D_RIGID:
        rigid = getattr(sim, A7D_RIGID[name][1])
        check(all(bool(torch.isfinite(v).all()) for v in rigid),
              f"a7d {name}: non-finite rigid state")
    if hasattr(sim, "total_time"):
        check(float(sim.total_time) > cm.RELAX_TIME,
              f"a7d {name}: the main path never released the body")
    counts = (sim.n_adv, sim.n_ac)
    obs = a7d_observable(name, cm, case, sim)
    n_rows = {b: getattr(sim, b)["Position"].shape[0] for b in bodies}
    log(f"a7d {name} main path: {n_rows} particles; setup "
        f"{rec['setup_s']:.2f} s; to t={float(sim.time):.6f} counts "
        f"{counts}; observable {obs}; {rec['ms_per_adv']:.3f} ms an "
        f"advection step (wall clock, mean), {rec['host_reads_per_adv']:.1f}"
        f" host reads an advection step; peak device memory "
        f"{rec['peak_gb']:.3f} GB")
    fns = a7d_parts(torch, name, cm, case, sim)
    step = cm.make_advection_step(case)
    parts = ob_parts(torch, f"a7d_{name}", fns, lambda: step(sim),
                     a7d_bounds(torch, name, case, sim), trace=False)
    results[f"_a7d_{name}"] = dict(rec, counts=counts, observable=obs,
                                   n_particles=n_rows, parts=parts)
    del case, sim, fns, step
    torch.cuda.empty_cache()


def a7d_phase(torch, results):
    """Phase 16: the eight cases of ROADMAP A item 3d and the rigid-body
    family of item 4 (no hand kernel), each at its JAX default width:
    float32 against float64 on the card from the same state, then through
    the public entry points, its step by part."""
    t0 = time.perf_counter()
    for name in A7D_MAIN:
        f32 = a7d_f32_check(torch, name)
        a7d_case_path(torch, name, results)
        results[f"_a7d_{name}"]["f32_vs_f64"] = f32
    log(f"a7d phase: {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# Phase 17: the damping family (ROADMAP A item 4, second family: frozen
# pairs and neighbour lists, torch ops; the CG solve)
# ---------------------------------------------------------------------------

# case -> (the main path's end time, its output interval), each at its JAX
# default width and dtype (float64 for the muscle and the twisting bar);
# stretching_2d's three macro steps take 1, 1 and 26 sub-steps (its end
# time is not a multiple of the macro step's 0.01: float32's sum of three
# of them falls short of 0.03, and run_simulation would ask again for a
# target that run_chunk already holds met)
A7E_MAIN = {
    "collision_2d": (0.006, 0.003),
    "sliding_2d": (0.006, 0.003),
    "passive_cantilever_neohookean_3d": (0.002, 0.001),
    "stretching_2d": (0.025, 0.0125),
    "muscle_solid_contact_3d": (1e-3, 5e-4),
    "twisting_rigid_elastic_bar_3d": (0.003, 0.0015),
    "slender_beam_3d": (5e-4, 2.5e-4),
}
# the sim's body of each case (the collision's damping ball: its free ball
# has no damping)
A7E_BODY = {"collision_2d": "damping_ball", "sliding_2d": "cube",
            "passive_cantilever_neohookean_3d": "body",
            "stretching_2d": "bar", "muscle_solid_contact_3d": "myo",
            "twisting_rigid_elastic_bar_3d": "bar", "slender_beam_3d": "bar"}
# float32 against float64 from the same built state, for the five float32
# cases: case -> (steps, tolerance of the displacement x - x0, tolerance of
# the velocity), each a share of the float64 run's max (the form of
# A7BC_F32; stretching_2d's steps are macro steps).  Each tolerance is ten
# times the larger reading of this check on the CPU (DEVICE = "cpu") and
# on an H100, rounded up to one significant digit.
A7E_F32 = {
    "collision_2d": (100, 9e-4, 3e-6),
    "sliding_2d": (100, 2e-3, 7e-4),
    "passive_cantilever_neohookean_3d": (100, 1e-4, 4e-5),
    "stretching_2d": (4, 2e-1, 2e-1),
    "slender_beam_3d": (150, 2e-3, 3e-4),
}
A7E_F32_SEEN = 100.0
# the slender beam's damped fields (cases/slender_beam_3d.py DAMPED)
A7E_BAR_DAMPED = ("Velocity", "AngularVelocity", "BinormalAngularVelocity")
# damping_implicit_cg on tests/test_dissipation.py's lattice (dx 0.1, 20 x
# 20, seeded velocities, float64): the deep regime's eta and dt, and the
# card's largest difference from the CPU's solve over max |v|
A7E_CG = dict(dx=0.1, eta=50.0, dt=1.0e-3, tol=1.0e-6, max_iter=60)
A7E_CG_TOL = 1e-12
# the pair operations of the parts whose bound counts them: a damping
# sweep's pair weight (r, dW, the implicit coefficient and its limiter,
# ~30) plus its two sweeps (~4 d each); a CG iteration's matvec (~3 d + 2
# a pair); the plastic first half's pair terms (the mean inverse F
# times the pair vector, the limiter, the shear and the stress terms,
# ~70 in 2D); a bar step's pairs (three (3, 3) x 3 products and the
# three rate outer products of the second half, ~150)
LIST_PAIR_FLOPS.update({"damping_pairwise": 55, "cg_iteration": 8,
                        "plastic_1st_half": 70, "bar_substep": 150})


def a7e_start(cm, case, states):
    return cm.init_sim(case, *states) if hasattr(cm, "init_sim") \
        else states[0]


def a7e_f32_check(torch, name):
    """The case at its default width built in float64 on the card, and the
    same state cast to float32: A7E_F32's steps on each, equal counts,
    the displacement x - x0 and the velocity within their tolerances of
    their float64 max, the displacement at least A7E_F32_SEEN times
    float32's rounding of the positions.  Returns the errors."""
    cm = importlib.import_module(f"sphinxsys_tpu_torch.cases.{name}")
    n, tol_d, tol_v = A7E_F32[name]
    case64, *states = cm.build_case(dtype=torch.float64, device=DEVICE)
    s64 = a7e_start(cm, case64, states)
    case32, s32 = cast_tree(torch, case64, torch.float32), \
        cast_tree(torch, s64, torch.float32)
    body = A7E_BODY[name]
    runs, x0 = [], []
    for case, s in ((case64, s64), (case32, s32)):
        x0.append(getattr(s, body)["Position"].double())
        step = cm.make_step(case)
        for _ in range(n):
            s = step(s)
        runs.append(s)
    s64, s32 = runs
    counts = [tuple(getattr(s, k) for k in ("n_steps", "n_macro", "n_sub")
                    if hasattr(s, k)) for s in runs]
    check(counts[0] == counts[1], f"a7e {name}: float32 counts {counts[1]} "
          f"!= float64 {counts[0]}")
    b64, b32 = getattr(s64, body), getattr(s32, body)
    for b in (b32, b64):
        for k in ("Position", "Velocity"):
            check(bool(torch.isfinite(b[k]).all()),
                  f"a7e {name}: non-finite {k}")
    d64 = b64["Position"] - x0[0]
    d32 = b32["Position"].double() - x0[1]
    errs = {"displacement": (d32 - d64, d64, tol_d),
            "velocity": (b32["Velocity"].double() - b64["Velocity"],
                         b64["Velocity"], tol_v)}
    errs = {k: (float(e.abs().max()), float(r.abs().max()), tol)
            for k, (e, r, tol) in errs.items()}
    rounding = n * 2.0 ** -24 * float(x0[0].abs().max())
    seen = errs["displacement"][1] / rounding
    log(f"a7e {name} float32 against float64 on the card (the same built "
        f"state, {n} steps): counts {counts[0]}; max |d| / max, tolerance "
        + ", ".join(f"{k} {e:.3e} / {m:.3e} = {e / m:.3e}, {tol:g}"
                    for k, (e, m, tol) in errs.items())
        + f"; displacement {seen:.1f} x float32's position rounding "
        f"(at least {A7E_F32_SEEN:g})")
    check(seen >= A7E_F32_SEEN, f"a7e {name}: after {n} steps the "
          f"displacement {errs['displacement'][1]:.3e} is only {seen:.1f} x "
          f"float32's position rounding {rounding:.3e}")
    for k, (e, m, tol) in errs.items():
        check(e <= tol * m, f"a7e {name}: float32 {k} off float64 by "
              f"{e:.3e} (max {m:.3e}, tolerance {tol:g})")
    del case64, case32, s64, s32, runs, b64, b32, d64, d32
    return dict(counts=counts[0], **{k: e for k, (e, _, _) in errs.items()})


def a7e_cg_lattice(torch, device):
    """tests/test_dissipation.py's lattice (:55-87) on `device` in float64:
    (state, inner list, kernel)."""
    from sphinxsys_tpu_torch.core.adaptation import SPHAdaptation
    from sphinxsys_tpu_torch.core.state import make_fluid_state
    from sphinxsys_tpu_torch.neighbors.cell_list import (build_cell_table,
                                                        grid_from_bounds)
    from sphinxsys_tpu_torch.neighbors.neighbor_list import \
        build_neighbor_list
    import numpy as np

    dx = A7E_CG["dx"]
    ad = SPHAdaptation(spacing=dx, dim=2)
    xs = np.arange(dx / 2, 2.0, dx)
    pos = np.stack(np.meshgrid(xs, xs, indexing="ij"), -1).reshape(-1, 2)
    st = make_fluid_state(pos, dx * dx, 1.0, torch.float64, device)
    st["Velocity"] = torch.as_tensor(
        np.random.default_rng(0).normal(size=pos.shape), device=device)
    grid = grid_from_bounds((-4 * dx, -4 * dx), (2.4, 2.4), ad.cutoff)
    table = build_cell_table(st["Position"], st["NReal"], grid, 24)
    nl = build_neighbor_list(st["Position"], st["NReal"], st["Position"],
                             st["NReal"], table, grid, ad.cutoff, k_max=32,
                             include_self=False)
    return st, nl, ad.kernel


def a7e_cg_check(torch, results):
    """damping_implicit_cg on the card against the port's float64 CPU solve
    on the same lattice: equal iteration counts, the largest difference
    within A7E_CG_TOL of max |v|; the card's solve reads nothing back
    (SyncCounter), its wall and device time, launches and bound."""
    from sphinxsys_tpu_torch.physics import dissipation as dp

    cfg = {k: A7E_CG[k] for k in ("eta", "dt")}
    out = {}
    for dev in (DEVICE, "cpu"):
        st, nl, kernel = a7e_cg_lattice(torch, dev)
        matvec, rhs, pre = dp.implicit_cg_system(st, "Velocity", nl, kernel,
                                                 2, **cfg)
        x, k = dp.conjugate_gradient(matvec, rhs, st["Velocity"], pre,
                                     A7E_CG["tol"], A7E_CG["max_iter"])
        out[dev] = (x.cpu(), int(k))
    (xc, kc), (xh, kh) = out[DEVICE], out["cpu"]
    err = float((xc - xh).abs().max())
    vmax = float(xh.abs().max())
    st, nl, kernel = a7e_cg_lattice(torch, DEVICE)

    def solve():
        return dp.damping_implicit_cg(st, "Velocity", nl, kernel, 2,
                                      tol=A7E_CG["tol"],
                                      max_iter=A7E_CG["max_iter"], **cfg)

    with SyncCounter(torch) as reads:
        solve()
    n_pairs = int(torch.clamp(nl.count, max=nl.idx.shape[1]).sum())
    nbytes = sum(t.numel() * t.element_size() for t in (
        nl.idx, st["Position"], st["VolumetricMeasure"], st["Mass"],
        st["Velocity"], st["Velocity"]))
    bound = (*bytes_or_flops(nbytes, kc * n_pairs
                             * LIST_PAIR_FLOPS["cg_iteration"]), n_pairs)
    parts = ob_parts(torch, "a7e_cg", {}, solve,
                     {"advection_step": bound}, trace=False)
    part = parts.pop("advection_step")
    log(f"a7e cg on the card (float64, {st['Position'].shape[0]} particles, "
        f"eta {cfg['eta']:g}, dt {cfg['dt']:g}, tol {A7E_CG['tol']:g}): "
        f"{kc} iterations (cpu {kh}) of at most {A7E_CG['max_iter']}; max "
        f"|card - cpu| {err:.3e} of max |v| {vmax:.3f} (tolerance "
        f"{A7E_CG_TOL:g}); {reads.n} host reads in the solve")
    check(kc == kh, f"a7e cg: the card took {kc} iterations, the CPU {kh}")
    check(err <= A7E_CG_TOL * vmax, f"a7e cg: the card's solve is off the "
          f"CPU's by {err:.3e}")
    check(reads.n == 0, f"a7e cg: the solve read the device {reads.n} times")
    check(1 < kc < A7E_CG["max_iter"], f"a7e cg: {kc} iterations")
    results["_a7e_cg"] = dict(part, iterations=kc, max_abs_err=err,
                              host_reads_in_solve=reads.n,
                              n_particles=st["Position"].shape[0])


def a7e_bounds(torch, name, case, sim):
    """The parts' least times from this run's lists and fields
    (`list_bound`): a step is its frozen pairs' pass (`frozen_bound`) plus
    its damping (the bar's: three fields; the collision's free ball's
    pass too); the damping, the plastic first half and the bar step
    alone."""
    import types

    body = getattr(sim, A7E_BODY[name])
    out = {}
    if name == "slender_beam_3d":
        rp = case.rp
        frozen = types.SimpleNamespace(idx=rp.idx, count=rp.mask.sum(1))
        bar_keys = [k for k, v in body.items()
                    if torch.is_tensor(v) and v.is_floating_point()]
        step = list_bound(torch, "bar_substep", [frozen],
                          [rp.W, rp.dW, rp.r, rp.e, rp.mask]
                          + fields(body, *bar_keys), fields(body, *bar_keys))
        damp = list_bound(torch, "damping_pairwise", [case.nl],
                          fields(body, "Position", "VolumetricMeasure",
                                 "Mass", *A7E_BAR_DAMPED),
                          fields(body, *A7E_BAR_DAMPED))
        damp = (3 * damp[0], damp[1], 3 * damp[2])
        out["bar_substep"] = step
    else:
        if name == "collision_2d":
            free = frozen_bound(torch, case.rp_free, sim.free_ball)
            damp_ball = frozen_bound(torch, case.rp_damp, body)
            step = (free[0] + damp_ball[0], free[1], free[2] + damp_ball[2])
        else:
            step = frozen_bound(torch, case.rp, body)
        nl = {"collision_2d": "nl_damp_inner", "sliding_2d": "nl_inner",
              "passive_cantilever_neohookean_3d": "nl",
              "stretching_2d": "nl_inner", "muscle_solid_contact_3d":
              "nl_inner", "twisting_rigid_elastic_bar_3d": "nl_damp"}[name]
        damp = list_bound(torch, "damping_pairwise", [getattr(case, nl)],
                          fields(body, "Position", "VolumetricMeasure",
                                 "Mass", "Velocity"),
                          fields(body, "Velocity"))
    out["damping"] = damp
    if name == "stretching_2d":
        plastic = list_bound(
            torch, "plastic_1st_half", [types.SimpleNamespace(
                idx=case.rp.idx, count=case.rp.mask.sum(1))],
            [case.rp.dW, case.rp.r, case.rp.e, case.rp.mask]
            + fields(body, *SOLID_READS, "InversePlasticStrain",
                     "HardeningParameter"),
            fields(body, *SOLID_WRITES, "InversePlasticStrain",
                   "HardeningParameter"))
        out["plastic_1st_half"] = plastic
        per = sim.n_sub / sim.n_macro
        out["advection_step"] = (per * (step[0] + damp[0]), step[1],
                                 round(per * (step[2] + damp[2])))
    else:
        out["advection_step"] = (step[0] + damp[0], step[1],
                                 step[2] + damp[2])
    return out



def a7e_parts(torch, name, cm, case, sim, states):
    """The damping alone on the main path's end state (the collision's on
    its damping ball); the slender beam's stress relaxation halves alone;
    stretching's plastic first half, and its third macro step from the
    build (26 sub-steps, the gate read once a sub-step)."""
    from sphinxsys_tpu_torch.physics import bar as bd
    from sphinxsys_tpu_torch.physics import solid as sd

    body = getattr(sim, A7E_BODY[name])
    h = case.adaptation.h
    if name == "slender_beam_3d":
        dt = sim.dt
        return {"damping": lambda: cm.damping(case, body, dt),
                "bar_substep": lambda: bd.bar_stress_relaxation_2nd_half(
                    bd.bar_stress_relaxation_1st_half(
                        body, case.rp, case.material, dt, h), case.rp, dt)}
    dt = sd.solid_acoustic_time_step(body, case.material.sound_speed, h)
    fns = {"damping": lambda: cm.damping(case, body, dt)}
    if name == "stretching_2d":
        step = cm.make_step(case)
        s2 = step(step(cm.init_sim(case, *states)))
        fns.update({"plastic_1st_half": lambda:
                    sd.decomposed_plastic_integration_1st_half(
                        body, case.rp, case.material, dt, h),
                    "macro_step_3": lambda: step(s2)})
    return fns


def a7e_case_path(torch, name, results):
    """A case at its JAX default width and dtype through build_case ->
    init_sim -> make_run_chunk -> solver.run_simulation (A7E_MAIN's end
    time), every launch count reset just before and read just after: no
    overflow, finite fields, the counts and the observable printed; then
    one step (for stretching a macro step) and its parts alone
    (`ob_parts`: wall and device time, launches, host reads, idle share,
    bound)."""
    cm = importlib.import_module(f"sphinxsys_tpu_torch.cases.{name}")
    t_end, sample = A7E_MAIN[name]
    built = {}

    def build():
        case, *states = cm.build_case(device=DEVICE)
        built["states"] = states
        return case, cm, a7e_start(cm, case, states)

    case, sim, rec = ob_main_run(torch, f"a7e {name}", build, t_end, sample)
    check(not bool(getattr(sim, "overflow", False)), f"a7e {name}: overflow")
    body = getattr(sim, A7E_BODY[name])
    for k in ("Position", "Velocity"):
        check(bool(torch.isfinite(body[k]).all()),
              f"a7e {name}: non-finite {k}")
    counts = tuple(getattr(sim, k) for k in ("n_steps", "n_macro", "n_sub")
                   if hasattr(sim, k))
    obs = a7e_observable(name, cm, case, sim, built["states"])
    log(f"a7e {name} main path: {body['Position'].shape[0]} particles "
        f"({body['Position'].dtype}); setup {rec['setup_s']:.2f} s; to "
        f"t={float(sim.time):.6f} counts {counts}; observable {obs}; "
        f"{rec['ms_per_adv']:.3f} ms a step (wall clock, mean), "
        f"{rec['host_reads_per_adv']:.1f} host reads a step; peak device "
        f"memory {rec['peak_gb']:.3f} GB")
    step = cm.make_step(case)
    parts = ob_parts(torch, f"a7e_{name}",
                     a7e_parts(torch, name, cm, case, sim, built["states"]),
                     lambda: step(sim), a7e_bounds(torch, name, case, sim),
                     trace=False)
    results[f"_a7e_{name}"] = dict(rec, counts=counts, observable=obs,
                                   n_particles=body["Position"].shape[0],
                                   parts=parts)
    del case, sim, body, built, step
    torch.cuda.empty_cache()


def a7e_observable(name, cm, case, sim, states):
    if name == "collision_2d":
        return [cm.ball_center(sim.free_ball).tolist(),
                cm.ball_center(sim.damping_ball).tolist()]
    if name == "sliding_2d":
        return cm.observe_position(sim, *cm.cube_observer(case, states[0])
                                   ).tolist()
    if name == "passive_cantilever_neohookean_3d":
        return cm.observe_corner(sim, *cm.corner_observer(case, states[0])
                                 ).tolist()
    if name == "stretching_2d":
        return float(sim.bar["HardeningParameter"].max())
    if name == "muscle_solid_contact_3d":
        return [cm.kinetic_energy(sim), float(sim.q)]
    if name == "twisting_rigid_elastic_bar_3d":
        return cm.observer_displacements(case, sim)[0].tolist()
    return cm.midspan_displacement(case, sim)


def a7e_phase(torch, results):
    """Phase 17: the seven cases of the damping family (ROADMAP A item 4,
    no hand kernel), each at its JAX default width and dtype: float32
    against float64 on the card from the same state (the float32 cases),
    then through the public entry points, its step by part; then the CG
    solve against the CPU's."""
    t0 = time.perf_counter()
    for name in A7E_MAIN:
        f32 = a7e_f32_check(torch, name) if name in A7E_F32 else None
        a7e_case_path(torch, name, results)
        results[f"_a7e_{name}"]["f32_vs_f64"] = f32
    a7e_cg_check(torch, results)
    log(f"a7e phase: {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# Phase 18: the continuum family (ROADMAP A item 4, third family: the
# Drucker-Prager soils and the updated-Lagrangian solids on neighbour
# lists, torch ops)
# ---------------------------------------------------------------------------

# case -> (the main path's end time, its output interval), each at its JAX
# default width, float32
A7F_MAIN = {
    "column_collapse_2d": (0.0025, 0.00125),
    "cohesive_soil_failure_2d": (0.02, 0.01),
    "repose_angle_3d": (0.004, 0.002),
    "oscillating_beam_ul_2d": (3e-4, 1.5e-4),
    "spinning_plate_2d": (0.0012, 0.0006),
    "taylor_bar_ul_3d": (6e-7, 3e-7),
}
A7F_BODY = {"oscillating_beam_ul_2d": "beam", "spinning_plate_2d": "plate",
            "taylor_bar_ul_3d": "column"}
A7F_SOILS = ("column_collapse_2d", "cohesive_soil_failure_2d",
             "repose_angle_3d")
# float32 against float64 from the same built state: case -> (advection
# steps, tolerance of the displacement x - x0, tolerance of the velocity),
# each a share of the float64 run's max (the form of A7E_F32).  Each
# tolerance is ten times the larger reading of this check on the CPU
# (DEVICE = "cpu") and on an H100, rounded up to one significant digit.
# The plastic cases' readings are those of the yield branch's float32
# roundoff (tests/test_torch_continuum_cases.py: a particle left on the
# yield surface takes either branch at roundoff).
A7F_F32 = {
    "column_collapse_2d": (6, 2e-1, 1e-2),
    "cohesive_soil_failure_2d": (4, 1e-1, 6e-1),
    "repose_angle_3d": (2, 2e-1, 3e-2),
    "oscillating_beam_ul_2d": (10, 5e-4, 5e-5),
    "spinning_plate_2d": (6, 2e-4, 4e-5),
    "taylor_bar_ul_3d": (3, 4e-1, 6e-1),
}
A7F_F32_SEEN = 100.0
# the pair operations of the parts whose bound counts them: the stress
# diffusion's jump of a 3 x 3 stress less its geostatic part (~30 past
# the pair geometry); a plastic first half's stress force (the (d, d)
# pair stress over rho_i rho_j, times grad W) and pressure dissipation,
# and its wall terms (~50 in 2D); a plastic second half's velocity jumps,
# dissipation and the velocity gradient's outer product (~45); an
# hourglass first half's B e and velocity-gradient outer product (~40);
# its second half's shear acceleration, the predicted pair velocity and
# the penalty (~60)
LIST_PAIR_FLOPS.update({"stress_diffusion": 50, "dp_1st_half": 50,
                        "dp_2nd_half": 45, "hourglass_1st_half": 40,
                        "hourglass_2nd_half": 60})


def a7f_f32_check(torch, name):
    """The case at its default width built in float64 on the card, started
    (init_sim), and the same state cast to float32: A7F_F32's advection
    steps on each, equal counts, the body's displacement x - x0 and
    velocity within their tolerances of their float64 max, the
    displacement at least A7F_F32_SEEN times float32's rounding of the
    positions.  Returns the errors."""
    cm = importlib.import_module(f"sphinxsys_tpu_torch.cases.{name}")
    n, tol_d, tol_v = A7F_F32[name]
    case64, body0 = cm.build_case(dtype=torch.float64, device=DEVICE)
    s64 = cm.init_sim(case64, body0)
    case32, s32 = cast_tree(torch, case64, torch.float32), \
        cast_tree(torch, s64, torch.float32)
    body = A7F_BODY.get(name, "soil")
    runs, x0 = [], []
    for case, s in ((case64, s64), (case32, s32)):
        x0.append(getattr(s, body)["Position"].double())
        step = cm.make_advection_step(case)
        for _ in range(n):
            s = step(s)
        runs.append(s)
    s64, s32 = runs
    counts = [tuple(getattr(s, k) for k in ("n_adv", "n_steps", "n_ac")
                    if hasattr(s, k)) for s in runs]
    b64, b32 = getattr(s64, body), getattr(s32, body)
    for s, b in ((s64, b64), (s32, b32)):
        check(not bool(s.overflow), f"a7f {name}: overflow")
        for k in ("Position", "Velocity"):
            check(bool(torch.isfinite(b[k]).all()),
                  f"a7f {name}: non-finite {k}")
    d64 = b64["Position"] - x0[0]
    d32 = b32["Position"].double() - x0[1]
    errs = {"displacement": (d32 - d64, d64, tol_d),
            "velocity": (b32["Velocity"].double() - b64["Velocity"],
                         b64["Velocity"], tol_v)}
    errs = {k: (float(e.abs().max()), float(r.abs().max()), tol)
            for k, (e, r, tol) in errs.items()}
    rounding = n * 2.0 ** -24 * float(x0[0].abs().max())
    seen = errs["displacement"][1] / rounding
    log(f"a7f {name} float32 against float64 on the card (the same built "
        f"state, {n} advection steps): counts float64 {counts[0]}, float32 "
        f"{counts[1]}; max |d| / max, tolerance "
        + ", ".join(f"{k} {e:.3e} / {m:.3e} = {e / m:.3e}, {tol:g}"
                    for k, (e, m, tol) in errs.items())
        + f"; displacement {seen:.1f} x float32's position rounding "
        f"(at least {A7F_F32_SEEN:g})")
    check(counts[0][0] == counts[1][0], f"a7f {name}: float32 advection "
          f"steps {counts[1]} != float64 {counts[0]}")
    check(seen >= A7F_F32_SEEN, f"a7f {name}: after {n} steps the "
          f"displacement {errs['displacement'][1]:.3e} is only {seen:.1f} x "
          f"float32's position rounding {rounding:.3e}")
    for k, (e, m, tol) in errs.items():
        check(e <= tol * m, f"a7f {name}: float32 {k} off float64 by "
              f"{e:.3e} (max {m:.3e}, tolerance {tol:g})")
    del case64, case32, s64, s32, runs, b64, b32, d64, d32
    return dict(counts=counts, **{k: e for k, (e, _, _) in errs.items()})


def a7f_parts(torch, name, case, sim):
    """A step's parts alone on the main path's end state: the stress
    diffusion and the plastic halves (the soils), the correction matrix
    and the hourglass halves (the UL solids)."""
    from sphinxsys_tpu_torch.cases import oscillating_beam_ul_2d as ob
    from sphinxsys_tpu_torch.physics import continuum as cn
    from sphinxsys_tpu_torch.physics import fluid as fd

    kernel, dim, h, m = case.kernel, case.dim, case.adaptation.h, \
        case.material
    if name in A7F_SOILS:
        so = sim.soil
        dt_adv = fd.advection_time_step(so, h, case.u_ref)
        dt = torch.minimum(fd.acoustic_time_step(so, m, h, cfl=0.4), dt_adv)
        wall = dict(wall=case.wall, nl_wall=sim.nl_wall)
        so1 = cn.plastic_integration_1st_half(so, sim.nl_inner, kernel, dim,
                                              m, case.riemann, dt, **wall)
        return {
            "stress_diffusion": lambda: cn.stress_diffusion(
                so, sim.nl_inner, kernel, dim, m, h),
            "dp_1st_half": lambda: cn.plastic_integration_1st_half(
                so, sim.nl_inner, kernel, dim, m, case.riemann, dt, **wall),
            "dp_2nd_half": lambda: cn.plastic_integration_2nd_half(
                so1, sim.nl_inner, kernel, dim, m, case.riemann, dt,
                **wall)}
    body = getattr(sim, A7F_BODY[name])
    nl = ob.inner_relation(case, body)
    dt = fd.acoustic_time_step(body, case.eos, h, cfl=0.4)
    plasticity = m if name == "taylor_bar_ul_3d" else None
    b1 = cn.shear_stress_hourglass_1st_half(body, nl, kernel, dim, m, dt,
                                            plasticity=plasticity)
    return {"correction_matrix": lambda: cn.correction_matrix_current(
                body, nl, kernel, dim),
            "hourglass_1st_half": lambda: cn.shear_stress_hourglass_1st_half(
                body, nl, kernel, dim, m, dt, plasticity=plasticity),
            "hourglass_2nd_half": lambda:
                cn.shear_acceleration_hourglass_2nd_half(b1, nl, kernel, dim,
                                                         m, dt)}


def a7f_bounds(torch, name, cm, case, sim):
    """Each profiled part's least time from this run's lists and fields
    (`list_bound`): a soil sub-step is its stress diffusion and both
    plastic halves, its advection step the density summation (and the
    cohesive soil's indication and transport correction) plus its mean
    sub-steps; a UL sub-step is both fluid halves and both hourglass
    halves (and the bar's wall contact), its advection step the
    correction matrix plus its mean sub-steps."""
    from sphinxsys_tpu_torch.cases import oscillating_beam_ul_2d as ob

    per_ac = sim.n_ac / (sim.n_adv if name in A7F_SOILS else sim.n_steps)
    if name in A7F_SOILS:
        so = sim.soil
        lists = [sim.nl_inner, sim.nl_wall]
        wall = fields(case.wall, *WALL_READS)
        stress = fields(so, "StressTensor3D", "StressRate3D",
                        "StrainTensor3D", "VelocityGradient3D")
        sd = list_bound(torch, "stress_diffusion", [sim.nl_inner],
                        fields(so, "Position", "ForcePrior", "Mass",
                               "VolumetricMeasure", "StressTensor3D"),
                        fields(so, "StressRate3D"))
        first = list_bound(torch, "dp_1st_half", lists,
                           fields(so, *FLUID_AC_READS, "StressTensor3D")
                           + wall, fields(so, *FLUID_AC_WRITES))
        second = list_bound(torch, "dp_2nd_half", lists,
                            fields(so, *FLUID_AC_READS) + stress + wall,
                            fields(so, "Position", "Density", "Force",
                                   "DensityChangeRate", "VolumetricMeasure")
                            + stress)
        sub = (sd[0] + first[0] + second[0], first[1], first[2])
        prep = list_bound(torch, "density", lists,
                          fields(so, "Position", "Mass", "Density") + wall,
                          fields(so, "DensitySummation", "Density"))
        prep_ms = prep[0]
        if name == "cohesive_soil_failure_2d":
            prep_ms += list_bound(
                torch, "surface_indication", lists,
                fields(so, "Position", "VolumetricMeasure",
                       "PreviousSurfaceIndicator"),
                fields(so, "Indicator", "PositionDivergence"))[0] \
                + list_bound(torch, "coupling", lists,
                             fields(so, "Position", "VolumetricMeasure",
                                    "Indicator", "PositionDivergence"),
                             fields(so, "Position"))[0]
        return {"advection_step": (prep_ms + per_ac * sub[0], sub[1],
                                   prep[2] + round(per_ac * sub[2])),
                "stress_diffusion": sd,
                "dp_1st_half": first, "dp_2nd_half": second}
    body = getattr(sim, A7F_BODY[name])
    nl = ob.inner_relation(case, body)
    ul = ("ShearStress", "StrainTensor", "VelocityGradient", "AccHourglass",
          "AccShear", "LinearGradientCorrectionMatrix", "HardeningFactor",
          "ScalePenaltyForce")
    corr = list_bound(torch, "correction", [nl],
                      fields(body, "Position", "VolumetricMeasure"),
                      fields(body, "LinearGradientCorrectionMatrix"))
    h1 = list_bound(torch, "hourglass_1st_half", [nl],
                    fields(body, "Position", "Velocity", "VolumetricMeasure",
                           *ul), fields(body, *ul))
    h2 = list_bound(torch, "hourglass_2nd_half", [nl],
                    fields(body, "Position", "Velocity", "VolumetricMeasure",
                           "Density", *ul), fields(body, "AccHourglass",
                                                   "AccShear"))
    fluid = list_bound(torch, "acoustic_substep", [nl],
                       fields(body, *FLUID_AC_READS, "AccShear"),
                       fields(body, *FLUID_AC_WRITES))
    sub_ms = fluid[0] + h1[0] + h2[0]
    pairs = fluid[2]
    if name == "taylor_bar_ul_3d":
        contact = list_bound(torch, "contact", [cm.wall_relation(case, body)],
                             fields(body, "Position", "Velocity")
                             + fields(case.wall, "Position", "Velocity",
                                      "VolumetricMeasure",
                                      "NormalDirection"),
                             fields(body, "ForcePrior"))
        sub_ms += contact[0]
        pairs += contact[2]
    sub = (sub_ms, fluid[1], pairs)
    return {"advection_step": (corr[0] + per_ac * sub[0], sub[1],
                               corr[2] + round(per_ac * sub[2])),
            "correction_matrix": corr,
            "hourglass_1st_half": h1, "hourglass_2nd_half": h2}


def a7f_observable(name, cm, case, sim, built):
    if name == "repose_angle_3d":
        return cm.mechanical_energy(case, sim)
    if name in A7F_SOILS:
        from sphinxsys_tpu_torch.physics import general as gd

        return [float(gd.total_mechanical_energy(sim.soil, case.gravity)),
                float(sim.soil["Position"][:case.n_soil, 0].max())]
    if name == "oscillating_beam_ul_2d":
        return [cm.kinetic_energy(sim),
                cm.observe_tip(sim, *cm.tip_observer(case, built)).tolist()]
    if name == "taylor_bar_ul_3d":
        return [cm.kinetic_energy(sim), cm.mushroom_radius(case, sim)]
    return cm.kinetic_energy(sim)


def a7f_case_path(torch, name, results):
    """A case at its JAX default width through build_case -> init_sim ->
    make_run_chunk -> solver.run_simulation (A7F_MAIN's end time),
    float32, every launch count reset just before and read just after:
    no overflow, finite fields, the observable printed; then one advection
    step and its parts alone (`ob_parts`: wall and device time, launches,
    host reads, idle share, bound)."""
    cm = importlib.import_module(f"sphinxsys_tpu_torch.cases.{name}")
    t_end, sample = A7F_MAIN[name]
    built = {}

    def build():
        case, body = cm.build_case(device=DEVICE)
        built["body"] = body
        return case, cm, cm.init_sim(case, body)

    case, sim, rec = ob_main_run(torch, f"a7f {name}", build, t_end, sample)
    check(not bool(sim.overflow), f"a7f {name}: overflow")
    body = getattr(sim, A7F_BODY.get(name, "soil"))
    for k in ("Position", "Velocity", "Density"):
        check(bool(torch.isfinite(body[k]).all()),
              f"a7f {name}: non-finite {k}")
    counts = tuple(getattr(sim, k) for k in ("n_adv", "n_steps", "n_ac")
                   if hasattr(sim, k))
    obs = a7f_observable(name, cm, case, sim, built["body"])
    n_rows = body["Position"].shape[0]
    n_wall = case.wall["NReal"] if hasattr(case, "wall") else 0
    log(f"a7f {name} main path: {n_rows} particles, {n_wall} wall; setup "
        f"{rec['setup_s']:.2f} s; to t={float(sim.time):.7f} counts "
        f"{counts}; observable {obs}; {rec['ms_per_adv']:.3f} ms an "
        f"advection step (wall clock, mean), {rec['host_reads_per_adv']:.1f}"
        f" host reads an advection step; peak device memory "
        f"{rec['peak_gb']:.3f} GB")
    fns = a7f_parts(torch, name, case, sim)
    step = cm.make_advection_step(case)
    parts = ob_parts(torch, f"a7f_{name}", fns, lambda: step(sim),
                     a7f_bounds(torch, name, cm, case, sim), trace=False)
    results[f"_a7f_{name}"] = dict(rec, counts=counts, observable=obs,
                                   n_particles=n_rows, n_wall=n_wall,
                                   parts=parts)
    del case, sim, body, built, fns, step
    torch.cuda.empty_cache()


def a7f_phase(torch, results):
    """Phase 18: the six cases of the continuum family (ROADMAP A item 4,
    no hand kernel), each at its JAX default width: float32 against
    float64 on the card from the same state, then through the public
    entry points, its step by part."""
    t0 = time.perf_counter()
    for name in A7F_MAIN:
        f32 = a7f_f32_check(torch, name)
        a7f_case_path(torch, name, results)
        results[f"_a7f_{name}"]["f32_vs_f64"] = f32
    log(f"a7f phase: {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# Phase 19: the small fluid modules and the plain diffusion family (ROADMAP
# A items 2 and 4a: neighbour lists and torch ops; the thermal
# optimisation's dense solve)
# ---------------------------------------------------------------------------

# case -> (the main path's end time, its output interval), float32 at the
# JAX default width: a few advection (or diffusion) steps each
A7G_MAIN = {
    "lid_driven_cavity_2d": (0.02, 0.01),
    "throat_2d": (0.03, 0.03),
    "channel_windkessel_2d": (0.0008, 0.0004),
    "pulsatile_poiseuille_2d": (0.004, 0.002),
    "heat_transfer_2d": (0.02, 0.01),
    "diffusion_bcs_2d": (2e-4, 1e-4),
    "windows_frame_diffusion_2d": (1e-5, 5e-6),
    "depolarization_2d": (2e-3, 1e-3),
}
A7G_DIFFUSION = {"diffusion_bcs_2d": "Phi", "windows_frame_diffusion_2d": "Phi",
                 "depolarization_2d": "Voltage"}
# float32 on the card against float64 on the CPU from the same lattice:
# case -> (steps, tolerance of x - x0, of the velocity, of the species'
# change), each a share of the float64 run's max (A7F_F32's form); each
# ten times the larger reading of this check on the CPU (DEVICE = "cpu")
# and on an H100, rounded up to one significant digit
A7G_F32 = {
    "lid_driven_cavity_2d": (3, 6e-4, 6e-4, None),
    "throat_2d": (1, 7e-2, 8e-3, None),
    "channel_windkessel_2d": (4, 4e-4, 7e-3, None),
    "pulsatile_poiseuille_2d": (4, 6e-4, 2e-3, None),
    "heat_transfer_2d": (3, 5e-4, 8e-4, 7e-5),
    "diffusion_bcs_2d": (5, None, None, 3e-5),
    "windows_frame_diffusion_2d": (5, None, None, 8e-5),
    "depolarization_2d": (12, None, None, 4e-4),
}
A7G_F32_SEEN = 100.0
# the thermal optimisation: its Adam steps in the main path and in the
# float32 check; the float32 steady field and losses against float64
A7G_VP_STEPS = 3
A7G_VP_TOL = 7e-3
# the pair operations of the new parts whose bounds count them: the
# velocity gradient's outer product and the harmonic-viscosity force
# (~35 past the pair geometry); an Oldroyd-B first half (the acoustic
# first half and the (d, d) stress force) and second half (the second
# half and the gradient with the wall's distance factor); an RK2
# diffusion step (two Euler steps, ~15 a pair each), the corrected one of
# the muscle (its 0.5 (B_i + B_j) e); the pressure condition's kernel
# gradient sum
LIST_PAIR_FLOPS.update({"variable_viscosity": 55, "oldroyd_1st_half": 60,
                        "oldroyd_2nd_half": 55, "diffusion_rk2": 70,
                        "electrophysiology": 90, "pressure_conditions": 25})


def a7g_body(sim):
    return sim.fluid if hasattr(sim, "fluid") else sim.body


def a7g_steps(torch, cm, case, s, n):
    """n steps of the case's advection step from s: (the start's body, the
    sim)."""
    b0 = {k: v.clone() for k, v in a7g_body(s).items() if torch.is_tensor(v)}
    step = cm.make_advection_step(case)
    for _ in range(n):
        s = step(s)
    return b0, s


def a7g_f32_check(torch, name):
    """The case built and started in float64 on the CPU and the same state
    cast to float32 on the card, A7G_F32's steps on each: equal counts, the live
    masks equal, the displacement x - x0, the velocity and the species'
    change within their tolerances of their float64 max (on the live
    rows), the displacement (or the change) at least A7G_F32_SEEN times
    float32's rounding of the positions (or the species).  Returns the
    errors."""
    cm = importlib.import_module(f"sphinxsys_tpu_torch.cases.{name}")
    n, tol_d, tol_v, tol_c = A7G_F32[name]
    built = cm.build_case(dtype=torch.float64, device="cpu")
    case, *states = built if isinstance(built, tuple) else (built,)
    s64 = cm.init_sim(case, *states)
    b0h, sh = a7g_steps(torch, cm, case, s64, n)
    b0c, sc_ = a7g_steps(torch, cm,
                         cast_tree(torch, case, torch.float32, DEVICE),
                         cast_tree(torch, s64, torch.float32, DEVICE), n)
    counts = [tuple(getattr(s, k) for k in ("n_adv", "n_ac", "n_steps")
                    if hasattr(s, k)) for s in (sh, sc_)]
    bh, bc = a7g_body(sh), a7g_body(sc_)
    live = bh.get("Alive")
    if live is not None:
        check(bool((bc["Alive"].cpu() == live).all()),
              f"a7g {name}: the live masks part")
    rows = slice(None) if live is None else live
    species = A7G_DIFFUSION.get(name, "Phi")
    pairs = {}
    if tol_d is not None:
        pairs["displacement"] = (bc["Position"].double().cpu() - b0c[
            "Position"].double().cpu(), bh["Position"] - b0h["Position"],
            tol_d)
        pairs["velocity"] = (bc["Velocity"].double().cpu(), bh["Velocity"],
                             tol_v)
    if tol_c is not None:
        pairs["species"] = (bc[species].double().cpu() - b0c[species]
                            .double().cpu(), bh[species] - b0h[species],
                            tol_c)
    errs = {k: (float((c[rows] - h[rows]).abs().max()),
                float(h[rows].abs().max()), tol)
            for k, (c, h, tol) in pairs.items()}
    first = "displacement" if tol_d is not None else "species"
    ref = b0h["Position"] if tol_d is not None else b0h[species]
    if "Alive" in b0h:          # the parked rows sit at FAR_AWAY
        ref = ref[b0h["Alive"]]
    rounding = n * 2.0 ** -24 * float(ref.abs().max())
    seen = errs[first][1] / rounding
    log(f"a7g {name} float32 card against float64 cpu ({n} steps): counts "
        f"float64 {counts[0]}, float32 {counts[1]}; max |d| / max, "
        "tolerance " + ", ".join(f"{k} {e:.3e} / {m:.3e} = {e / m:.3e}, "
                                 f"{tol:g}" for k, (e, m, tol) in
                                 errs.items())
        + f"; {first} {seen:.1f} x float32's rounding (at least "
        f"{A7G_F32_SEEN:g})")
    check(counts[0] == counts[1], f"a7g {name}: float32 counts {counts[1]} "
          f"!= float64 {counts[0]}")
    check(seen >= A7G_F32_SEEN, f"a7g {name}: the {first} after {n} steps "
          f"is only {seen:.1f} x float32's rounding")
    for k, (e, m, tol) in errs.items():
        check(bool(e <= tol * m), f"a7g {name}: float32 {k} off float64 by "
              f"{e:.3e} (max {m:.3e}, tolerance {tol:g})")
    return dict(counts=counts, **{k: e for k, (e, _, _) in errs.items()})


def a7g_dt_adv(torch, name, cm, case, f):
    """The case's advection dt on the fluid `f` (its `_advection_step`'s)."""
    from sphinxsys_tpu_torch.physics import fluid as fd
    from sphinxsys_tpu_torch.physics import viscosity as vc

    h = case.adaptation.h
    if name == "lid_driven_cavity_2d":
        return torch.minimum(fd.advection_time_step(f, h, cm.U_LID),
                             vc.srd_viscous_time_step(f, h))
    if name == "throat_2d":
        return fd.advection_time_step(f, h, cm.U_F)
    if name == "channel_windkessel_2d":
        return fd.advection_time_step(f, h, cm.U_MAX)
    if name == "pulsatile_poiseuille_2d":
        return fd.advection_viscous_time_step(f, h, 2.0 * case.u_ref,
                                              case.rho0, case.mu)
    return fd.advection_viscous_time_step(f, h, cm.U_F, cm.RHO0_F, cm.MU_F)


def a7g_parts(torch, name, cm, case, sim):
    """The new parts alone on the main path's end state (the step itself
    is profiled beside them)."""
    from sphinxsys_tpu_torch.physics import fluid as fd
    from sphinxsys_tpu_torch.physics import viscosity as vc

    if name in A7G_DIFFUSION:
        if name != "depolarization_2d":
            return {}
        from sphinxsys_tpu_torch.physics import diffusion as df

        dt = df.diffusion_time_step(case.adaptation.h, cm.DIFFUSION, 2)
        return {"reaction": lambda: df.reaction_step(sim.body, cm.MODEL,
                                                     0.5 * dt),
                "diffusion_rk2": lambda: df.diffusion_step_rk2(
                    sim.body, "Voltage", case.nl, case.kernel, 2,
                    cm.DIFFUSION, dt, correction=True)}
    f = sim.fluid
    dt_adv = a7g_dt_adv(torch, name, cm, case, f)
    dt = torch.minimum(fd.acoustic_time_step(f, case.eos, case.adaptation.h),
                       dt_adv)
    t_now = sim.time
    if name == "lid_driven_cavity_2d":
        walls = [(case.wall, sim.nl_fw)]

        def variable():
            g = vc.update_variable_viscosity(f, sim.nl_inner, case.kernel, 2,
                                             case.model)
            return vc.viscous_force_variable(g, sim.nl_inner, case.kernel, 2,
                                             case.adaptation.h, walls=walls)
        return {"variable_viscosity": variable,
                "acoustic_substep": lambda: cm.acoustic_substep(
                    case, sim, f, dt_adv)}
    if name == "throat_2d":
        dfw = cm.distance_from_wall(case, f["Position"])
        f1 = cm.oldroyd_first_half(case, sim, f, dt)
        return {"acoustic_substep": lambda: cm.acoustic_substep(
                    case, sim, f, dt_adv, dfw),
                "cg_damping": lambda: cm.implicit_damping(case, sim, f, dt),
                "oldroyd_1st_half": lambda: cm.oldroyd_first_half(
                    case, sim, f, dt),
                "oldroyd_2nd_half": lambda: cm.oldroyd_second_half(
                    case, sim, f1, dt, dfw)}
    if name == "channel_windkessel_2d":
        def windkessel():
            wkst = cm.wk.accumulate_flow(sim.wkstate, f, case.outlet, 0, dt)
            # the update taken (the next update time reached)
            return cm.windkessel_step(wkst, sim.next_update,
                                      sim.next_update + dt)
        return {"acoustic_substep": lambda: cm.acoustic_substep(
                    case, sim, f, dt_adv, t_now, sim.wkstate,
                    sim.next_update),
                "windkessel_update": windkessel,
                "open_boundaries": lambda: cm.open_boundaries(
                    case, f, f["Position"])}
    if name == "pulsatile_poiseuille_2d":
        prev = f["Position"] - 0.5 * case.dx * torch.sign(f["Velocity"])
        return {"acoustic_substep": lambda: cm.acoustic_substep(
                    case, sim, f, dt_adv, t_now),
                "pressure_conditions": lambda: cm.pressure_conditions(
                    case, sim, f, t_now, dt),
                "buffer_exchange": lambda: cm.buffer_exchange(case, f, prev)}
    return {"acoustic_substep": lambda: cm.acoustic_substep(
                case, sim, f, dt_adv, t_now),
            "diffusion_rk2": lambda: cm.thermal_relaxation(case, sim, f, dt)}


def a7g_bounds(torch, name, cm, case, sim, parts):
    """Each profiled part's least time from this run's lists and fields
    (`list_bound`); a step is its parts' sum (the advection prep counted
    as one more pass of the acoustic sub-step's reads) times its mean
    sub-steps."""
    from sphinxsys_tpu_torch.physics import dissipation as dp
    from sphinxsys_tpu_torch.physics import fluid as fd

    out = {}
    body = a7g_body(sim)
    if name in A7G_DIFFUSION:
        sp = A7G_DIFFUSION[name]
        if name == "depolarization_2d":
            lists = [case.nl]
            extra = fields(body, "LinearGradientCorrectionMatrix")
            part = "electrophysiology"
        elif name == "diffusion_bcs_2d":
            lists = [case.nl_inner, case.nl_d, case.nl_n]
            extra = fields(case.wall_d, "Position", "Phi") + fields(
                case.wall_n, "Position", "NormalDirection", "PhiFlux")
            part = "diffusion_rk2"
        else:
            lists = [case.nl_inner, case.nl_in, case.nl_ex]
            extra = fields(body, "ThermalConductivity", "NormalDirection") \
                + [t for a in (case.air_in, case.air_ex) for t in fields(
                    a, "Position", "NormalDirection", "PhiConvection")]
            part = "diffusion_rk2"
        step = list_bound(torch, part, lists,
                          fields(body, "Position", "VolumetricMeasure", sp,
                                 "GateVariable") + extra,
                          fields(body, sp, "GateVariable"))
        out["advection_step"] = step
        if "diffusion_rk2" in parts:
            out["diffusion_rk2"] = list_bound(
                torch, "diffusion_rk2", lists,
                fields(body, "Position", "VolumetricMeasure", sp) + extra,
                fields(body, sp))
        if "reaction" in parts:
            out["reaction"] = list_bound(torch, "reaction", [],
                                         fields(body, sp, "GateVariable"),
                                         fields(body, sp, "GateVariable"))
        return out
    wall_list = getattr(sim, "nl_wall", None) or sim.nl_fw
    lists = [sim.nl_inner, wall_list]
    wall = fields(case.wall, *WALL_READS)
    reads = fields(body, *FLUID_AC_READS) + wall
    writes = fields(body, *FLUID_AC_WRITES)
    sub = list_bound(torch, "acoustic_substep", lists, reads, writes)
    # the advection prep: the density summation and the transport
    # correction (and the viscous force where the case has one)
    prep = list_bound(torch, "density", lists,
                      fields(body, "Position", "Mass", "Density",
                             "VolumetricMeasure") + wall,
                      fields(body, "DensitySummation", "Density",
                             "Position"))[0]
    bodies = fields(body, *bdy_fields(body))
    if name == "lid_driven_cavity_2d":
        out["variable_viscosity"] = list_bound(
            torch, "variable_viscosity", lists,
            fields(body, "Position", "Velocity", "VolumetricMeasure",
                   "Density", "ForcePrior", "ViscousForcePrev") + wall,
            fields(body, "VelocityGradient", "VariableViscosity",
                   "ViscousForce", "ForcePrior"))
        prep += out["variable_viscosity"][0]
    elif name == "throat_2d":
        st = ("ElasticStress", "ElasticStressChangeRate", "VelocityGradient")
        o1 = list_bound(torch, "oldroyd_1st_half", lists,
                        reads + fields(body, *st),
                        writes + fields(body, "ElasticStress"))
        o2 = list_bound(torch, "oldroyd_2nd_half", lists,
                        reads + fields(body, *st), writes + fields(body, *st))
        # the CG's iterations on this state, each a pass over the inner
        # list (its matvec) at LIST_PAIR_FLOPS["cg_iteration"] a pair
        dt = float(torch.minimum(fd.acoustic_time_step(
            body, case.eos, case.adaptation.h),
            a7g_dt_adv(torch, name, cm, case, body)))
        matvec, rhs, pre = dp.implicit_cg_system(
            body, "Velocity", sim.nl_inner, case.kernel, 2, cm.MU_F, dt,
            [(case.wall, sim.nl_wall, None)], box=case.box)
        _, k = dp.conjugate_gradient(matvec, rhs, body["Velocity"], pre,
                                     1.0e-6, 60)
        n_pairs = sub[2]
        nbytes = sum(t.numel() * t.element_size() for t in (
            *(nl.idx for nl in lists), *fields(
                body, "Position", "VolumetricMeasure", "Mass", "Velocity",
                "Velocity")))
        cg = (*bytes_or_flops(nbytes, int(k) * n_pairs
                              * LIST_PAIR_FLOPS["cg_iteration"]), n_pairs)
        out.update(cg_damping=cg, oldroyd_1st_half=o1, oldroyd_2nd_half=o2)
        sub = (cg[0] + o1[0] + o2[0], o1[1], n_pairs)
    elif name == "channel_windkessel_2d":
        out["windkessel_update"] = list_bound(
            torch, "windkessel", [],
            fields(body, "Position", "Velocity", "VolumetricMeasure"), [])
        out["open_boundaries"] = list_bound(torch, "open_boundaries", [],
                                            bodies, bodies)
        sub = (sub[0] + out["windkessel_update"][0], sub[1], sub[2])
    elif name == "pulsatile_poiseuille_2d":
        out["pressure_conditions"] = list_bound(
            torch, "pressure_conditions", lists,
            fields(body, "Position", "VolumetricMeasure", "Velocity",
                   "Density") + wall, fields(body, "Velocity"))
        out["buffer_exchange"] = list_bound(torch, "buffer_exchange", [],
                                            bodies, bodies)
        sub = (sub[0] + out["pressure_conditions"][0], sub[1], sub[2])
    else:
        out["diffusion_rk2"] = list_bound(
            torch, "diffusion_rk2", lists,
            fields(body, "Position", "VolumetricMeasure", "Phi")
            + fields(case.wall, "Position", "VolumetricMeasure", "Phi"),
            fields(body, "Phi"))
        sub = (sub[0] + out["diffusion_rk2"][0], sub[1], sub[2])
    out["acoustic_substep"] = sub
    per_ac = sim.n_ac / max(sim.n_adv, 1)
    out["advection_step"] = (prep + per_ac * sub[0], sub[1],
                             round((1 + per_ac) * sub[2]))
    return out


def bdy_fields(body):
    from sphinxsys_tpu_torch.physics.boundary import _PARTICLE_FIELDS_HINT

    return [k for k in (*_PARTICLE_FIELDS_HINT, "Alive") if k in body]
def a7g_observable(name, cm, case, sim):
    if name == "lid_driven_cavity_2d":
        return cm.kinetic_energy(sim)
    if name == "throat_2d":
        return [cm.kinetic_energy(sim),
                float(sim.fluid["ElasticStress"].abs().max())]
    if name == "channel_windkessel_2d":
        return [cm.outlet_pressure_mmhg(sim), cm.n_alive(sim)]
    if name == "pulsatile_poiseuille_2d":
        return [cm.centerline_velocity(case, sim), cm.n_alive(sim)]
    if name == "heat_transfer_2d":
        return cm.observe_phi(case, sim)
    if name == "depolarization_2d":
        return cm.observe_voltage(sim, *cm.voltage_observer(case, sim.body))
    return cm.observe_phi(case, sim).tolist()


def a7g_case_path(torch, name, results):
    """A case at its JAX default width through build_case -> init_sim ->
    make_run_chunk -> solver.run_simulation (A7G_MAIN's end time),
    float32, every launch count reset just before and read just after: no
    overflow, finite fields, the observable printed; then one step and
    its new parts alone (`ob_parts`: wall and device time, launches, host
    reads, idle share, bound)."""
    cm = importlib.import_module(f"sphinxsys_tpu_torch.cases.{name}")
    t_end, sample = A7G_MAIN[name]

    def build():
        built = cm.build_case(dtype=torch.float32, device=DEVICE)
        case, *states = built if isinstance(built, tuple) else (built,)
        return case, cm, cm.init_sim(case, *states)

    case, sim, rec = ob_main_run(torch, f"a7g {name}", build, t_end, sample)
    body = a7g_body(sim)
    check(not bool(getattr(sim, "overflow", False)), f"a7g {name}: overflow")
    rows = body.get("Alive", slice(None))
    for k in ("Position", "Velocity", "Density", "Phi", "Voltage"):
        if k in body:
            check(bool(torch.isfinite(body[k][rows]).all()),
                  f"a7g {name}: non-finite {k}")
    counts = tuple(getattr(sim, k) for k in ("n_adv", "n_ac", "n_steps")
                   if hasattr(sim, k))
    obs = a7g_observable(name, cm, case, sim)
    n_rows = body["Position"].shape[0]
    log(f"a7g {name} main path: {n_rows} rows; setup {rec['setup_s']:.2f} s;"
        f" to t={float(sim.time):.7f} counts {counts}; observable {obs}; "
        f"{rec['ms_per_adv']:.3f} ms a step (wall clock, mean), "
        f"{rec['host_reads_per_adv']:.1f} host reads a step; peak device "
        f"memory {rec['peak_gb']:.3f} GB")
    fns = a7g_parts(torch, name, cm, case, sim)
    step = cm.make_advection_step(case)
    parts = ob_parts(torch, f"a7g_{name}", fns, lambda: step(sim),
                     a7g_bounds(torch, name, cm, case, sim, fns),
                     trace=False)
    results[f"_a7g_{name}"] = dict(rec, counts=counts, observable=obs,
                                   n_rows=n_rows, parts=parts)
    del case, sim, body, fns, step
    torch.cuda.empty_cache()


def a7g_vp(torch, results):
    """The thermal optimisation at its default width (2,500, float64, its
    default): the steady field and A7G_VP_STEPS Adam steps in float32 on
    the card against float64 on the CPU from the same start (the field and
    the losses within A7G_VP_TOL of their max); then float64 through
    build_case -> optimize_conductivity, every launch count reset just
    before and read just after; its solve and one optimisation step (the
    loss, its gradient through the solve, Adam and the smoothing) alone.
    The bounds: the LU's 2/3 n^3 operations and the two solves' 4 n^2 at
    67 TFLOP/s (the data sheet's float64 tensor-core rate), or the dense
    matrix's bytes, read and written once, over 3.35 TB/s."""
    from sphinxsys_tpu_torch.cases import vp_heat_flux_2d as vp

    runs = {}
    for dt, dev in ((torch.float64, "cpu"), (torch.float32, DEVICE)):
        case = vp.build_case(dtype=dt, device=dev)
        n = case.body["NReal"]
        gen = torch.Generator(device="cpu").manual_seed(0)
        k0 = 0.5 + torch.rand(n, generator=gen, dtype=torch.float64)
        T = vp.steady_temperature(case, k0.to(dt).to(dev))
        _, _, hist = vp.optimize_conductivity(case, n_steps=A7G_VP_STEPS,
                                              k_init=k0.to(dt).to(dev))
        runs[dt] = (T.double().cpu(), torch.as_tensor(hist))
    (Th, hh), (Tc, hc) = runs[torch.float64], runs[torch.float32]
    errs = {"steady_field": (float((Tc - Th).abs().max()),
                             float(Th.abs().max())),
            "losses": (float((hc - hh).abs().max()), float(hh.abs().max()))}
    log(f"a7g vp_heat_flux_2d float32 card against float64 cpu (the steady "
        f"field, {A7G_VP_STEPS} Adam steps): max |d| / max, tolerance "
        + ", ".join(f"{k} {e:.3e} / {m:.3e} = {e / m:.3e}, {A7G_VP_TOL:g}"
                    for k, (e, m) in errs.items()))
    for k, (e, m) in errs.items():
        check(e <= A7G_VP_TOL * m, f"a7g vp: float32 {k} off float64 by "
              f"{e:.3e} (max {m:.3e})")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    case = vp.build_case(device=DEVICE)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    read_counts = reset_all_launch_counts()
    with SyncCounter(torch) as syncs:
        t1 = time.perf_counter()
        k, T, hist = vp.optimize_conductivity(case, n_steps=A7G_VP_STEPS)
        mean_T = float(T.mean())
        run_s = time.perf_counter() - t1
    launched = read_counts()
    check(not any(launched.values()), f"a7g vp: a hand kernel ran {launched}")
    check(bool(torch.isfinite(T).all()) and hist[-1] < hist[0],
          f"a7g vp: the optimisation did not lower the loss {hist}")
    n = case.body["NReal"]
    rec = dict(setup_s=setup_s, run_s=run_s,
               ms_per_step=run_s / A7G_VP_STEPS * 1e3,
               host_reads=syncs.n - 1, peak_gb=peak_gb(torch),
               kernel_launches=launched)
    log(f"a7g vp_heat_flux_2d main path (float64, {n} particles, "
        f"{A7G_VP_STEPS} Adam steps): setup {setup_s:.2f} s; losses "
        f"{[round(float(h), 4) for h in hist]}, mean T {mean_T:.3f}; "
        f"{rec['ms_per_step']:.3f} ms a step (wall clock, mean), "
        f"{rec['host_reads']} host reads in the optimisation; peak device "
        f"memory {rec['peak_gb']:.3f} GB")
    theta = torch.log(k)
    zero = torch.zeros_like(theta)
    nbytes = (n * n + 4 * n) * 8
    solve = bytes_or_flops(nbytes, 2 * n ** 3 / 3 + 2 * n * n)
    grad = bytes_or_flops(2 * nbytes, 2 * n ** 3 / 3 + 4 * n * n)
    bounds = {"steady_solve": (*solve, 0), "advection_step": (*grad, 0)}
    parts = ob_parts(torch, "a7g_vp_heat_flux_2d",
                     {"steady_solve": lambda: vp.steady_temperature(case, k)},
                     lambda: vp.optimization_step(case, theta, zero, zero, 1,
                                                  0.1, 0.05),
                     bounds, trace=False)
    results["_a7g_vp_heat_flux_2d"] = dict(rec, f32_vs_f64=errs,
                                           losses=hist.tolist(), parts=parts)
    del case, k, T, theta
    torch.cuda.empty_cache()


def a7g_phase(torch, results):
    """Phase 19: the nine cases of ROADMAP A items 2 and 4a (no hand
    kernel), each at its JAX default width: float32 on the card against
    float64 on the CPU, then through the public entry points, its step by
    part."""
    t0 = time.perf_counter()
    for name in A7G_MAIN:
        f32 = a7g_f32_check(torch, name)
        a7g_case_path(torch, name, results)
        results[f"_a7g_{name}"]["f32_vs_f64"] = f32
    a7g_vp(torch, results)
    log(f"a7g phase: {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# Phase 20: the shell family (ROADMAP A item 3: the shells' stress
# relaxation, the tie coupling, the CVT, the shell contacts and the
# surface contact on neighbour lists, torch ops)
# ---------------------------------------------------------------------------

# case -> (the main path's end time, its output interval), each at its JAX
# default width and dtype (the roof, the half sphere, the coupling and the
# three rings float64, the others float32): a few steps each
A7H_MAIN = {
    "shell_cantilever_2d": (5e-4, 2.5e-4),
    "shell_plate_3d": (1e-3, 5e-4),
    "roof_3d": (2e-4, 1e-4),
    "shell_stability_half_sphere_3d": (3e-4, 1.5e-4),
    "solid_shell_coupling_3d": (3e-3, 1.5e-3),
    "hydrostatic_fsi_2d": (1e-3, 1e-3),
    "poiseuille_flow_shell_3d": (3e-3, 1.5e-3),
    "three_ring_impact_2d": (2.2e-2, 1.1e-2),   # the rings in contact
}
# the card against the CPU from the same built state in the case's dtype:
# case -> (steps, tolerance of x - x0, tolerance of the velocity), each a
# share of the body's own max in the CPU run (A7G_F32's form), ten times
# the larger reading over the bodies of this check on the CPU (DEVICE =
# "cpu": 0) and on an H100, rounded up to one significant digit; 1e-12
# where that reading is 0 in float64
A7H_CPU = {
    "shell_cantilever_2d": (10, 3e-8, 9e-7),
    "shell_plate_3d": (10, 3e-7, 1e-6),
    "roof_3d": (6, 1e-12, 3e-15),
    "shell_stability_half_sphere_3d": (4, 1e-12, 7e-13),
    "solid_shell_coupling_3d": (4, 5e-11, 8e-12),
    "hydrostatic_fsi_2d": (1, 2e-1, 2e-2),
    "poiseuille_flow_shell_3d": (1, 2e-4, 3e-5),
    "three_ring_impact_2d": (6, 1e-12, 2e-14),
}
# the bodies the card-against-CPU check holds, each against its own max:
# the gate, which after one advection step from rest carries only the
# first pressure, is held by `a7h_gate_check` from a loaded state
A7H_CPU_BODIES = {"hydrostatic_fsi_2d": ("fluid",)}
# bodies that may be at rest in the compared steps, then held to be
# exactly so on both: the large ring (F = I, no load) until the medium
# ring reaches it; once moving, held as the others
A7H_AT_REST = {"three_ring_impact_2d": ("ring_l",)}
# the gate under the hydrostatic load (`a7h_gate_check`): its two
# sub-cycles on the card against the CPU (x - x0 above its float32 floor,
# velocity, the pressure force, each a share of its own max: ten times
# the larger reading on an H100, 1.9e-7), and its graph against its eager
# sub-cycle on the card (every field, a share of its max)
A7H_GATE_CPU = (2e-6, 2e-6, 2e-6)
A7H_GRAPH_TOL = 1e-6
A7H_ULPS = 4           # the float32 displacement floor, in rounding steps
A7H_BODIES = {"solid_shell_coupling_3d": ("cube", "shell"),
              "hydrostatic_fsi_2d": ("fluid", "gate"),
              "poiseuille_flow_shell_3d": ("fluid",),
              "three_ring_impact_2d": ("ring_l", "ring_m", "ring_s")}
# the CVT's card-against-CPU check at a reduced width (the full width's
# dense N x N sweeps take minutes on the host): dp_ratio, its tolerance as
# a share of the radius
A7H_CVT_DP = 8.0
A7H_CVT_TOL = 2e-14       # ten times an H100's reading (1.35e-15 R)
# the pair operations of the shell parts: a first half's pair exchange
# (the stress and moment gathers, two (d, d) e products: ~50; the Gauss
# integration is per particle and not counted), a second half's two outer
# products (~40), a projection damping (~40), a tie mapping (~10), a
# shell-contact pair build (the pair and n_dummy_static = 12 dummies,
# ~30 a dummy: ~400), the surface contact (five builds with their stacks,
# the factors and forces: ~450 a pair of its five contact lists), a CVT
# sweep's dense pair (~25)
LIST_PAIR_FLOPS.update({"shell_1st_half": 50, "shell_2nd_half": 40,
                        "damping_projection": 40, "tie_mapping": 10,
                        "shell_contact_pairs": 400, "surface_contact": 450,
                        "cvt_sweep": 25})
SHELL_READS = ("Position", "Velocity", "Rotation", "AngularVelocity",
               "DeformationGradient", "DeformationRate",
               "BendingDeformationGradient", "BendingDeformationRate",
               "TransformationMatrix0", "Thickness", "Mass",
               "VolumetricMeasure", "ForcePrior")
SHELL_WRITES = ("Position", "Velocity", "Rotation", "AngularVelocity",
                "AngularAcceleration", "DeformationGradient",
                "BendingDeformationGradient", "GlobalStress", "GlobalMoment",
                "GlobalShearStress", "Force", "Density", "PseudoNormal")


def frozen_list(torch, rp):
    """Frozen pairs (a ReferencePairs, a CouplingPairs) as list_bound's
    list (idx, count)."""
    import types

    return types.SimpleNamespace(idx=rp.idx, count=rp.mask.sum(dim=1))


def a7h_bodies(name):
    return A7H_BODIES.get(name, ("shell",))


def a7h_cpu_check(torch, name, start=None):
    """The case built on the CPU in its dtype and the same state moved to
    the card (the half sphere built on the card, its CVT there, and moved
    to the CPU; the three rings from `start`, the main path's end on the
    card, in contact, and moved to the CPU), A7H_CPU's steps on each:
    equal counts, the live masks equal, each held body's x - x0 and
    velocity within their tolerances of that body's max on the CPU (a body
    of A7H_AT_REST may instead be exactly at rest on both).  Returns the
    errors."""
    cm = importlib.import_module(f"sphinxsys_tpu_torch.cases.{name}")
    n, tol_d, tol_v = A7H_CPU[name]
    if start is not None:
        case, s0 = start
        dtype = s0.time.dtype
        pair = [(cast_tree(torch, case, dtype, "cpu"),
                 cast_tree(torch, s0, dtype, "cpu")), (case, s0)]
    else:
        on_card = name == "shell_stability_half_sphere_3d"
        case, *states = cm.build_case(device=DEVICE if on_card else "cpu")
        s0 = cm.init_sim(case, *states) if hasattr(cm, "init_sim") \
            else states[0]
        dtype = s0.time.dtype
        other = "cpu" if on_card else DEVICE
        pair = [(case, s0), (cast_tree(torch, case, dtype, other),
                             cast_tree(torch, s0, dtype, other))]
        if on_card:
            pair.reverse()
    bodies = A7H_CPU_BODIES.get(name, a7h_bodies(name))
    runs = []
    for c, s in pair:
        x0 = {b: getattr(s, b)["Position"].clone() for b in bodies}
        step = a7bc_stepper(cm, c)
        for _ in range(n):
            s = step(s)
        runs.append((s, x0))
    (sh, xh), (sc_, xc) = runs
    counts = [tuple(getattr(s, k) for k in ("n_steps", "n_adv", "n_ac", "n_s")
                    if hasattr(s, k)) for s in (sh, sc_)]
    tols = {"displacement": tol_d, "velocity": tol_v}
    errs, parts, held = {}, [], []
    for b in bodies:
        bh, bc = getattr(sh, b), getattr(sc_, b)
        rows = bh.get("Alive", slice(None))
        if "Alive" in bh:
            check(bool((bc["Alive"].cpu() == bh["Alive"]).all()),
                  f"a7h {name}: the {b} live masks part")
        # a float32 displacement of a few rounding steps of the positions
        # is held to that rounding: A7H_ULPS of the body's largest |x|
        floor = (A7H_ULPS * 2.0 ** -24 * float(bh["Position"][rows].abs()
                                               .max())
                 if dtype == torch.float32 else 0.0)
        for k, c_, h_ in (("displacement", bc["Position"].cpu() - xc[b].cpu(),
                           bh["Position"] - xh[b]),
                          ("velocity", bc["Velocity"].cpu(), bh["Velocity"])):
            e = float((c_[rows] - h_[rows]).abs().max())
            m = float(h_[rows].abs().max())
            errs[f"{b}_{k}"] = e
            parts.append(f"{b} {k} {e:.3e} / {m:.3e} = "
                         f"{e / max(m, 1e-300):.3e}, {tols[k]:g}"
                         + (f" (float32 floor {floor:.3e})"
                            if floor and k == "displacement" else ""))
            held.append((b, k, e, m, max(tols[k] * m, floor if
                                         k == "displacement" else 0.0)))
    log(f"a7h {name} card against cpu ({str(dtype)[6:]}, {n} steps"
        + (f" from t={float(pair[1][1].time):.7f}" if start is not None
           else "") + f"): counts cpu {counts[0]}, card {counts[1]}; max "
        "|d| / max, tolerance: " + "; ".join(parts))
    check(counts[0] == counts[1], f"a7h {name}: card counts {counts[1]} != "
          f"cpu {counts[0]}")
    at_rest = A7H_AT_REST.get(name, ())
    for b, k, e, m, bound in held:
        if b in at_rest and m == 0.0:
            check(e == 0.0, f"a7h {name}: the {b} {k} at rest on the cpu "
                  f"and not on the card ({e:.3e})")
            continue
        check(m > 0.0 and e <= bound, f"a7h {name}: the card's {b} {k} off "
              f"the cpu's by {e:.3e} (max {m:.3e}, bound {bound:.3e})")
    return dict(counts=counts, **errs)


def a7h_cvt_check(torch, results):
    """The CVT (200 sweeps, float64) on the card against the CPU at
    A7H_CVT_DP: positions within A7H_CVT_TOL of the radius, the
    generator's own gates (the minimum pair distance above dp / 2)."""
    import numpy as np

    from sphinxsys_tpu_torch.cases import shell_stability_half_sphere_3d as hs
    from sphinxsys_tpu_torch.core.surface_cvt import min_pair_distance

    dp = A7H_CVT_DP * hs.THICKNESS
    t0 = time.perf_counter()
    card = hs.generate_particles(dp, 200, torch.float64, DEVICE)
    t1 = time.perf_counter()
    host = hs.generate_particles(dp, 200, torch.float64, "cpu")
    t2 = time.perf_counter()
    err = float(np.abs(card[0] - host[0]).max()) / hs.RADIUS
    dmin = min_pair_distance(card[0])
    log(f"a7h cvt card against cpu ({len(card[0])} points, 200 sweeps, "
        f"float64): max |dx| / R {err:.3e} (tolerance {A7H_CVT_TOL:g}); min "
        f"pair distance {dmin:.4f} (at least dp / 2 = {dp / 2:g}); card "
        f"{t1 - t0:.3f} s, cpu {t2 - t1:.3f} s")
    check(err <= A7H_CVT_TOL, f"a7h cvt: card off cpu by {err:.3e} R")
    check(dmin > dp / 2, f"a7h cvt: min pair distance {dmin} <= dp / 2")
    results["_a7h_cvt"] = dict(n=len(card[0]), err=err, min_pair=dmin,
                               card_s=t1 - t0, cpu_s=t2 - t1)


def a7h_parts(torch, name, cm, case, sim):
    """The new parts alone on the main path's end state."""
    from sphinxsys_tpu_torch.physics import shell as sh

    h = case.adaptation.h
    if name == "hydrostatic_fsi_2d":
        from sphinxsys_tpu_torch.physics import fluid as fd

        dt = torch.minimum(fd.acoustic_time_step(sim.fluid, case.eos, h),
                           fd.advection_time_step(sim.fluid, h, cm.U_REF))
        dt_s = torch.minimum(sh.shell_acoustic_time_step(
            sim.gate, case.material_s, h), dt)
        return {"contact_pairs": lambda: cm.contact_pairs(
                    case, sim, sim.fluid, sim.gate),
                "gate_substep": lambda: cm.gate_substep(case, sim.gate,
                                                        dt_s)}
    if name == "poiseuille_flow_shell_3d":
        from sphinxsys_tpu_torch.physics import fluid as fd

        pairs = cm.shell_pairs(case, sim, sim.fluid)
        dt_adv = fd.advection_viscous_time_step(sim.fluid, h, cm.U_MAX,
                                                cm.RHO0_F, cm.MU_F)
        return {"contact_pairs": lambda: cm.shell_pairs(case, sim,
                                                        sim.fluid),
                "acoustic_substep": lambda: cm.acoustic_substep(
                    case, sim, sim.fluid, dt_adv, torch.zeros_like(dt_adv),
                    pairs)}
    if name == "three_ring_impact_2d":
        return {"surface_contact": lambda: cm.contact_forces(
                    case, sim.ring_l, sim.ring_m, sim.ring_s),
                "shell_1st_half": lambda: sh.shell_stress_relaxation_1st_half(
                    sim.ring_m, case.rp_m, case.mat_m, sim.dt, h),
                "shell_2nd_half": lambda: sh.shell_stress_relaxation_2nd_half(
                    sim.ring_m, case.rp_m, sim.dt)}
    if name == "solid_shell_coupling_3d":
        from sphinxsys_tpu_torch.physics import solid_shell as ss

        def ties():
            v = ss.consistent_mapping(case.cp_shell, sim.cube["Velocity"],
                                      sim.shell["Velocity"],
                                      part_mask=case.shell_tied_part)
            return v, cm.cube_force_prior(case, sim.cube, sim.shell)
        return {"tie_mapping": ties,
                "shell_1st_half": lambda: sh.shell_stress_relaxation_1st_half(
                    sim.shell, case.rp_shell, case.material, sim.dt, h),
                "shell_2nd_half": lambda: sh.shell_stress_relaxation_2nd_half(
                    sim.shell, case.rp_shell, sim.dt)}
    out = {"shell_1st_half": lambda: sh.shell_stress_relaxation_1st_half(
               sim.shell, case.rp, case.material, sim.dt, h),
           "shell_2nd_half": lambda: sh.shell_stress_relaxation_2nd_half(
               sim.shell, case.rp, sim.dt)}
    if name in ("roof_3d", "shell_stability_half_sphere_3d"):
        if name == "roof_3d":
            eta = cm.PHYSICAL_VISCOSITY / cm.DAMPING_RATIO
            out["damping_projection"] = lambda: cm.damping(case, sim.shell,
                                                           sim.dt, eta)
        else:
            out["damping_projection"] = lambda: cm.damping(case, sim.shell,
                                                           sim.dt)
            out["cvt"] = lambda: cm.generate_particles(case.dp, 200,
                                                       torch.float64, DEVICE)
    return out


def a7h_bounds(torch, name, cm, case, sim, parts):
    """Each profiled part's least time from this run's lists and fields
    (`list_bound`); a step is its parts' sum (times the acoustic and the
    gate's sub-steps for the fluid cases)."""
    out = {}

    def shell_halves(shell, rp):
        lst = [frozen_list(torch, rp)]
        first = list_bound(torch, "shell_1st_half", lst,
                           fields(shell, *SHELL_READS),
                           fields(shell, *SHELL_WRITES))
        second = list_bound(torch, "shell_2nd_half", lst,
                            fields(shell, *SHELL_READS,
                                   "LinearGradientCorrectionMatrix"),
                            fields(shell, "Position", "Rotation",
                                   "PseudoNormal", "PseudoNormalRate",
                                   "DeformationRate",
                                   "BendingDeformationRate",
                                   "DeformationGradient",
                                   "BendingDeformationGradient"))
        return first, second

    if name == "hydrostatic_fsi_2d":
        g, f = sim.gate, sim.fluid
        lists = [sim.nl_ff, sim.nl_fw, sim.nl_fg]
        pairs = list_bound(torch, "shell_contact_pairs",
                           [sim.nl_fw, sim.nl_fg, sim.nl_gf],
                           fields(f, "Position") + fields(
                               g, "Position", "NormalDirection", "Thickness")
                           + fields(case.wall, "Position", "NormalDirection"),
                           [])
        first, second = shell_halves(g, case.gate_rp)
        gsub = (first[0] + second[0], first[1], first[2] + second[2])
        ac = list_bound(torch, "acoustic_substep", lists,
                        fields(f, *FLUID_AC_READS) + fields(
                            g, "Position", "VolumetricMeasure",
                            "AverageVelocity", "AverageAcceleration"),
                        fields(f, *FLUID_AC_WRITES))
        per_s = sim.n_s / max(sim.n_ac, 1)
        sub = (ac[0] + per_s * gsub[0], ac[1], ac[2] + round(per_s * gsub[2]))
        per_ac = sim.n_ac / max(sim.n_adv, 1)
        out.update(contact_pairs=pairs, acoustic_substep=sub,
                   gate_substep=gsub,
                   advection_step=(pairs[0] + per_ac * sub[0], sub[1],
                                   pairs[2] + round(per_ac * sub[2])))
        return out
    if name == "poiseuille_flow_shell_3d":
        f = sim.fluid
        lists = [sim.nl_ff, sim.nl_fs]
        pairs = list_bound(torch, "shell_contact_pairs", [sim.nl_fs],
                           fields(f, "Position") + [case.shell_k1,
                                                    case.shell_k2]
                           + fields(case.shell, "Position",
                                    "NormalDirection", "Thickness"), [])
        sub = list_bound(torch, "acoustic_substep", lists,
                         fields(f, *FLUID_AC_READS) + fields(
                             case.shell, "VolumetricMeasure"),
                         fields(f, *FLUID_AC_WRITES))
        prep = list_bound(torch, "density", lists,
                          fields(f, "Position", "Mass", "Density",
                                 "VolumetricMeasure", "Velocity"),
                          fields(f, "DensitySummation", "Density",
                                 "Position", "ViscousForce"))
        per_ac = sim.n_ac / max(sim.n_adv, 1)
        out.update(contact_pairs=pairs, acoustic_substep=sub,
                   advection_step=(pairs[0] + prep[0] + per_ac * sub[0],
                                   sub[1], pairs[2] + prep[2]
                                   + round(per_ac * sub[2])))
        return out
    if name == "three_ring_impact_2d":
        rings = (sim.ring_l, sim.ring_m, sim.ring_s)
        rl, rm, rs = rings
        n_l, n_m, n_s = case.n_l, case.n_m, case.n_s
        contact_lists = [
            cm._contact_nl(case, rs["Position"], n_s, rm, n_m),
            cm._contact_nl(case, rm["Position"], n_m, rs, n_s),
            cm._contact_nl(case, rm["Position"], n_m, rl, n_l),
            cm._contact_nl(case, rl["Position"], n_l, rm, n_m),
            cm._contact_nl(case, rm["Position"], n_m, rm, n_m)]
        contact = list_bound(torch, "surface_contact", contact_lists,
                             [t for r in rings for t in fields(
                                 r, "Position", "Velocity", "NormalDirection",
                                 "VolumetricMeasure", "Thickness")],
                             [t for r in rings for t in fields(
                                 r, "ForcePrior")])
        first, second = shell_halves(sim.ring_m, case.rp_m)
        solid = list_bound(torch, "solid_substep",
                           [frozen_list(torch, case.rp_l)],
                           fields(sim.ring_l, *SOLID_READS),
                           fields(sim.ring_l, *SOLID_WRITES))
        s_s = shell_halves(sim.ring_s, case.rp_s)
        step = contact[0] + first[0] + second[0] + s_s[0][0] + s_s[1][0] \
            + solid[0]
        out.update(surface_contact=contact, shell_1st_half=first,
                   shell_2nd_half=second,
                   advection_step=(step, contact[1],
                                   contact[2] + first[2] + s_s[0][2]
                                   + solid[2]))
        return out
    if name == "solid_shell_coupling_3d":
        first, second = shell_halves(sim.shell, case.rp_shell)
        ties = list_bound(torch, "tie_mapping",
                          [frozen_list(torch, case.cp_shell),
                           frozen_list(torch, case.cp_cube)],
                          fields(sim.cube, "Velocity", "VolumetricMeasure",
                                 "Mass") + fields(sim.shell, "Velocity",
                                                  "Force"),
                          fields(sim.shell, "Velocity")
                          + fields(sim.cube, "ForcePrior"))
        solid = list_bound(torch, "solid_substep",
                           [frozen_list(torch, case.rp_cube)],
                           fields(sim.cube, *SOLID_READS),
                           fields(sim.cube, *SOLID_WRITES))
        out.update(shell_1st_half=first, shell_2nd_half=second,
                   tie_mapping=ties,
                   advection_step=(first[0] + second[0] + ties[0] + solid[0],
                                   first[1], first[2] + second[2]
                                   + solid[2]))
        return out
    first, second = shell_halves(sim.shell, case.rp)
    out.update(shell_1st_half=first, shell_2nd_half=second)
    step = first[0] + second[0]
    if "damping_projection" in parts:
        damp = list_bound(torch, "damping_projection", [case.nl],
                          fields(sim.shell, "Position", "VolumetricMeasure",
                                 "Mass", "Velocity", "AngularVelocity"),
                          fields(sim.shell, "Velocity", "AngularVelocity"))
        out["damping_projection"] = damp
        step += damp[0]
    if "cvt" in parts:
        n = case.n_shell
        out["cvt"] = (*bytes_or_flops(2 * 3 * 8 * n * 200, n * n * 200
                                      * LIST_PAIR_FLOPS["cvt_sweep"]),
                      n * n * 200)
    out["advection_step"] = (step, first[1], first[2] + second[2])
    return out


def a7h_observable(name, cm, case, sim):
    if name in ("shell_cantilever_2d", "shell_plate_3d"):
        return cm.tip_displacement(case, sim)
    if name == "roof_3d":
        return cm.observer_position(case, sim).tolist()
    if name == "shell_stability_half_sphere_3d":
        return cm.max_displacement(sim)
    if name == "solid_shell_coupling_3d":
        return [cm.center_deflection(case, sim), cm.u_max(sim)]
    if name == "hydrostatic_fsi_2d":
        return cm.center_displacement(case, sim)
    if name == "poiseuille_flow_shell_3d":
        return [cm.n_alive(sim), float(cm.observed_velocity(
            case, sim, cm.radial_observation_points()[:1])[0, 1])]
    return cm.observer_point(case, sim).tolist()


def a7h_case_path(torch, name, results):
    """A case at its JAX default width and dtype through build_case ->
    init_sim -> make_run_chunk -> solver.run_simulation (A7H_MAIN's end
    time), every launch count reset just before and read just after: no
    overflow, finite fields, the observable printed; then one step and its
    parts alone (`ob_parts`).  Returns the end (case, sim)."""
    cm = importlib.import_module(f"sphinxsys_tpu_torch.cases.{name}")
    t_end, sample = A7H_MAIN[name]

    def build():
        case, *states = cm.build_case(device=DEVICE)
        sim = cm.init_sim(case, *states) if hasattr(cm, "init_sim") \
            else states[0]
        return case, cm, sim

    case, sim, rec = ob_main_run(torch, f"a7h {name}", build, t_end, sample)
    check(not bool(getattr(sim, "overflow", False)), f"a7h {name}: overflow")
    for b in a7h_bodies(name):
        body = getattr(sim, b)
        rows = body.get("Alive", slice(None))
        for k in ("Position", "Velocity", "Density"):
            if k in body:
                check(bool(torch.isfinite(body[k][rows]).all()),
                      f"a7h {name}: non-finite {b} {k}")
    counts = tuple(getattr(sim, k) for k in ("n_steps", "n_adv", "n_ac",
                                             "n_s") if hasattr(sim, k))
    obs = a7h_observable(name, cm, case, sim)
    n_rows = {b: getattr(sim, b)["Position"].shape[0]
              for b in a7h_bodies(name)}
    log(f"a7h {name} main path: rows {n_rows}; setup {rec['setup_s']:.2f} s;"
        f" to t={float(sim.time):.7f} counts {counts}; observable {obs}; "
        f"{rec['ms_per_adv']:.3f} ms a step (wall clock, mean), "
        f"{rec['host_reads_per_adv']:.1f} host reads a step; peak device "
        f"memory {rec['peak_gb']:.3f} GB")
    fns = a7h_parts(torch, name, cm, case, sim)
    step = a7bc_stepper(cm, case)
    # the gate's advection step (~1,600 sub-steps of ~620 launches) is
    # timed by its main path and `a7h_gate_check`, not profiled
    parts = ob_parts(torch, f"a7h_{name}", fns,
                     None if name == "hydrostatic_fsi_2d"
                     else lambda: step(sim),
                     a7h_bounds(torch, name, cm, case, sim, fns),
                     trace=False)
    results[f"_a7h_{name}"] = dict(rec, counts=counts, observable=obs,
                                   n_rows=n_rows, parts=parts)
    return case, sim


def a7h_loaded_gate(torch, hf, case, s):
    """The gate under the water column at rest: the fluid's pressure rho g
    (H - y) and its density from the equation of state, the pressure force
    over the corrected pairs folded into ForcePrior as an acoustic
    sub-step folds it.  Returns (gate, the acoustic dt)."""
    from sphinxsys_tpu_torch.physics import fluid as fd
    from sphinxsys_tpu_torch.physics import fsi
    from sphinxsys_tpu_torch.physics import shell_fluid as sf

    f = dict(s.fluid)
    f["Pressure"] = hf.RHO0_F * hf.GRAVITY_G * (hf.DAM_H - f["Position"][:, 1])
    f["Density"] = case.eos.density_from_pressure(f["Pressure"])
    _, _, pairs_gf = hf.contact_pairs(case, s, f, s.gate)
    g = fsi.force_prior_update(s.gate, "PressureForceFromFluid",
                               sf.pressure_force_from_fluid_on_shell(
                                   s.gate, f, pairs_gf, s.nl_gf,
                                   case.no_riemann))
    h = case.adaptation.h
    dt = torch.minimum(fd.acoustic_time_step(f, case.eos, h),
                       fd.advection_time_step(f, h, hf.U_REF))
    return g, dt


def a7h_gate_check(torch, results):
    """The gate at its default width from a loaded, moving state: the
    loaded gate (`a7h_loaded_gate`) built on the CPU and moved to the
    card, two sub-cycles on each (the card's a replayed CUDA graph, the
    CPU's the eager loop): equal sub-step counts, the gate's x - x0,
    velocity and pressure force within A7H_GATE_CPU of their own max on
    the CPU; then from the card's state after its first sub-cycle (moving,
    loaded) the graph against the eager loop on the card: equal counts,
    every field within A7H_GRAPH_TOL of its max."""
    from sphinxsys_tpu_torch.cases import hydrostatic_fsi_2d as hf
    from sphinxsys_tpu_torch.physics import fsi

    case_h, fluid, gate = hf.build_case(device="cpu")
    s_h = hf.init_sim(case_h, fluid, gate)
    dtype = s_h.time.dtype
    runs = {}
    for where, case, s in (("cpu", case_h, s_h),
                           ("card", cast_tree(torch, case_h, dtype, DEVICE),
                            cast_tree(torch, s_h, dtype, DEVICE))):
        g, dt = a7h_loaded_gate(torch, hf, case, s)
        x0 = g["Position"].clone()
        g1, k1 = hf.gate_substeps(case, g, dt)
        g2, k2 = hf.gate_substeps(case, g1, dt)
        runs[where] = dict(case=case, g=g, g1=g1, g2=g2, k=(k1, k2), x0=x0,
                           dt=dt)
    rh, rc = runs["cpu"], runs["card"]
    floor = (A7H_ULPS * 2.0 ** -24 * float(rh["g2"]["Position"].abs().max())
             if dtype == torch.float32 else 0.0)
    errs, parts = {}, []
    for k, c_, h_, tol in (
            ("displacement", rc["g2"]["Position"] - rc["x0"],
             rh["g2"]["Position"] - rh["x0"], A7H_GATE_CPU[0]),
            ("velocity", rc["g2"]["Velocity"], rh["g2"]["Velocity"],
             A7H_GATE_CPU[1]),
            ("pressure force", rc["g"]["PressureForceFromFluid"],
             rh["g"]["PressureForceFromFluid"], A7H_GATE_CPU[2])):
        e, m = float((c_.cpu() - h_).abs().max()), float(h_.abs().max())
        bound = max(tol * m, floor if k == "displacement" else 0.0)
        errs[k] = (e, m, bound)
        parts.append(f"{k} {e:.3e} / {m:.3e} = {e / max(m, 1e-300):.3e}, "
                     f"{tol:g}" + (f" (float32 floor {floor:.3e})"
                                   if floor and k == "displacement" else ""))
    log(f"a7h gate card against cpu (loaded, {str(dtype)[6:]}, two "
        f"sub-cycles): sub-steps cpu {rh['k']}, card {rc['k']}; max |d| / "
        "max, tolerance: " + "; ".join(parts))
    check(rh["k"] == rc["k"], f"a7h gate: card sub-steps {rc['k']} != cpu "
          f"{rh['k']}")
    for k, (e, m, bound) in errs.items():
        check(m > 0.0 and e <= bound, f"a7h gate: the card's {k} off the "
              f"cpu's by {e:.3e} (max {m:.3e}, bound {bound:.3e})")

    case, dt = rc["case"], rc["dt"]
    g0 = fsi.initialize_displacement(rc["g1"])
    out, walls = {}, {}
    for mode, fn in (("eager", hf._eager_substeps),
                     ("graph", case.subcycle.run)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[mode] = fn(case, g0, dt)
        torch.cuda.synchronize()
        walls[mode] = time.perf_counter() - t0
    (ge, ke), (gg, kg) = out["eager"], out["graph"]
    err = max(float((gg[k] - ge[k]).abs().max())
              / max(float(ge[k].abs().max()), 1e-300)
              for k in ge if torch.is_tensor(ge[k])
              and ge[k].is_floating_point())
    v_max = float(g0["Velocity"].abs().max())
    log(f"a7h gate sub-cycle, graph against eager on the card (loaded, max "
        f"|v| {v_max:.3e} at the start): {kg} / {ke} sub-steps, max |d| / "
        f"max {err:.3e} (tolerance {A7H_GRAPH_TOL:g}); wall "
        f"{walls['graph'] * 1e3:.1f} ms against {walls['eager'] * 1e3:.1f} "
        f"ms ({walls['graph'] / kg * 1e3:.3f} / "
        f"{walls['eager'] / ke * 1e3:.3f} ms a sub-step)")
    check(v_max > 0.0, "a7h gate: the gate does not move")
    check(kg == ke, f"a7h gate: graph sub-steps {kg} != eager {ke}")
    check(err <= A7H_GRAPH_TOL, f"a7h gate: graph off eager by {err:.3e}")
    results["_a7h_gate"] = dict(
        substeps=kg, graph_err=err, graph_s=walls["graph"],
        eager_s=walls["eager"], **{f"cpu_{k.replace(' ', '_')}": e
                                   for k, (e, _, _) in errs.items()})


def a7h_phase(torch, results):
    """Phase 20: the eight cases of the shell family (ROADMAP A item 3, no
    hand kernel), each at its JAX default width and dtype: the card
    against the CPU from the same state (the three rings from the main
    path's end, in contact), through the public entry points, its step by
    part; the loaded gate's sub-cycles; the CVT on the card against the
    CPU."""
    t0 = time.perf_counter()
    for name in A7H_MAIN:
        if name == "three_ring_impact_2d":
            end = a7h_case_path(torch, name, results)
            cpu = a7h_cpu_check(torch, name, start=end)
        else:
            cpu = a7h_cpu_check(torch, name)
            end = a7h_case_path(torch, name, results)
        results[f"_a7h_{name}"]["card_vs_cpu"] = cpu
        del end
        torch.cuda.empty_cache()
    a7h_gate_check(torch, results)
    a7h_cvt_check(torch, results)
    log(f"a7h phase: {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# Phase 21: the rest of the diffusion family and the Eulerian SPH fluid
# (ROADMAP A item 4 and the Eulerian half of item 5: neighbour lists, the
# tree's list, frozen pairs, torch ops)
# ---------------------------------------------------------------------------

# case -> (the main path's end time, its output interval), float32 at the
# JAX default width: a few steps each
A7I_MAIN = {
    "water_entry_exit_2d": (0.004, 0.002),
    "pkj_lv_electrocontraction_3d": (0.25, 0.125),
    "heart_electromechanics_3d": (0.1, 0.05),
    "eulerian_taylor_green_2d": (0.02, 0.01),
}
# float32 on the card against float64 on the CPU from the same started
# state: case -> (steps, ((what, the quantity of a sim, a change from the
# start?, tolerance as a share of the float64 max), ...)); the first
# quantity's float64 max at least A7I_F32_SEEN times float32's rounding of
# its start.  Each tolerance ten times the larger reading of this check on
# the CPU (DEVICE = "cpu") and on an H100, rounded up to one significant
# digit.  The water entry's fluid starts at rest under its hydrostatic
# pressure: its velocities after 8 steps are float32's acoustic noise
# (1.3e-2 of their max on both), so the cylinder's fall leads.  The
# Purkinje muscle's velocity is not held: before its leaves fire it is
# roundoff of F ~ I (1.4e-6 in float64, float32 2.7 x that).
A7I_F32 = {
    "water_entry_exit_2d": (8, (
        ("cylinder", lambda s: s.cyl["Position"], True, 2e-2),
        ("displacement", lambda s: s.fluid["Position"], True, 9e-2),
        ("velocity", lambda s: s.fluid["Velocity"], False, 2e-1))),
    "pkj_lv_electrocontraction_3d": (2, (
        ("tree_voltage", lambda s: s.pkj_v, True, 9e-6),
        ("voltage", lambda s: s.myo["Voltage"], True, 2e-5))),
    "heart_electromechanics_3d": (3, (
        ("voltage", lambda s: s.myo["Voltage"], True, 3e-5),
        ("velocity", lambda s: s.myo["Velocity"], False, 4e-4),
        ("displacement", lambda s: s.myo["Position"], True, 3e-3))),
    "eulerian_taylor_green_2d": (20, (
        ("velocity_change", lambda s: s.fluid["Velocity"], True, 7e-3),
        ("density_change", lambda s: s.fluid["Density"], True, 2e-2))),
}
A7I_F32_SEEN = 100.0
A7I_COUNTS = ("n_adv", "n_ac", "n_steps", "n_sub")
# the pair operations of the new parts whose bounds count them: the local
# directional rate (the pair geometry, T_j gathered, 0.5 (T_i + T_j) e
# and its square, the area); an HLLC half (the pair geometry, two sound
# speeds, the wave speeds, the contact speed, both star states and the
# four selects, the flux); the viscous force
LIST_PAIR_FLOPS.update({"local_directional_rate": 70, "hllc_1st_half": 190,
                        "hllc_2nd_half": 200, "viscous_force": 35})


def a7i_start(cm, case, states):
    """The started sim: init_sim's, or the build's own (the two hearts)."""
    return cm.init_sim(case, *states) if hasattr(cm, "init_sim") \
        else states[0]


def a7i_f32_check(torch, name, table=None, tag="a7i"):
    """The case built and started in float64 on the CPU and the same state
    cast to float32 on the card, A7I_F32's (or `table`'s) steps on each:
    equal counts, each quantity (or its change from the start) within its
    tolerance of its float64 max, the first at least A7I_F32_SEEN times
    float32's rounding.  Returns the errors."""
    cm = importlib.import_module(f"sphinxsys_tpu_torch.cases.{name}")
    n, quantities = (table or A7I_F32)[name]
    case, *states = cm.build_case(dtype=torch.float64, device="cpu")
    s64 = a7i_start(cm, case, states)
    runs = []
    for c, s in ((case, s64),
                 (cast_tree(torch, case, torch.float32, DEVICE),
                  cast_tree(torch, s64, torch.float32, DEVICE))):
        starts = [get(s).double().cpu() for _, get, _, _ in quantities]
        step = cm.make_advection_step(c)
        for _ in range(n):
            s = step(s)
        runs.append((s, starts))
    (sh, starts_h), (sc_, starts_c) = runs
    counts = [tuple(getattr(s, k) for k in A7I_COUNTS if hasattr(s, k))
              for s in (sh, sc_)]
    errs = {}
    for (what, get, change, tol), h0, c0 in zip(quantities, starts_h,
                                                 starts_c):
        h, c = get(sh).double().cpu(), get(sc_).double().cpu()
        if change:
            h, c = h - h0, c - c0
        errs[what] = (float((c - h).abs().max()), float(h.abs().max()), tol)
    first = quantities[0][0]
    # float32's rounding of the first quantity at its start's scale (at
    # the change's own where it starts from zero, the hearts' voltage)
    rounding = n * 2.0 ** -24 * max(float(starts_h[0].abs().max()),
                                    errs[first][1])
    seen = errs[first][1] / rounding
    log(f"{tag} {name} float32 card against float64 cpu ({n} steps): counts "
        f"float64 {counts[0]}, float32 {counts[1]}; max |d| / max, "
        "tolerance " + ", ".join(f"{k} {e:.3e} / {m:.3e} = "
                                 f"{e / max(m, 1e-300):.3e}, {tol:g}"
                                 for k, (e, m, tol) in errs.items())
        + f"; {first} {seen:.1f} x float32's rounding (at least "
        f"{A7I_F32_SEEN:g})")
    # the heart's adaptive mechanics loop ends when the summed sub-steps
    # reach dt: float64's sum of the capped steps can fall an ulp short and
    # take one more sub-step of ~1e-17 (the JAX package's loop too), so
    # n_sub may differ by at most one a step; the other counts are equal
    n_sub = [getattr(s, "n_sub", 0) for s in (sh, sc_)]
    equal = [tuple(getattr(s, k) for k in A7I_COUNTS[:3] if hasattr(s, k))
             for s in (sh, sc_)]
    check(equal[0] == equal[1], f"{tag} {name}: float32 counts {counts[1]} "
          f"!= float64 {counts[0]}")
    check(abs(n_sub[0] - n_sub[1]) <= n, f"{tag} {name}: float32 mechanics "
          f"sub-steps {n_sub[1]} part from float64's {n_sub[0]} by more than "
          f"one a step")
    check(seen >= A7I_F32_SEEN, f"{tag} {name}: the {first} after {n} steps "
          f"is only {seen:.1f} x float32's rounding")
    for k, (e, m, tol) in errs.items():
        check(bool(e <= tol * m), f"{tag} {name}: float32 {k} off float64 by "
              f"{e:.3e} (max {m:.3e}, tolerance {tol:g})")
    return dict(counts=counts, **{k: e for k, (e, _, _) in errs.items()})


def a7i_parts(torch, name, cm, case, sim):
    """The new parts alone on the main path's end state (the step itself
    is profiled beside them)."""
    from sphinxsys_tpu_torch.physics import diffusion as df
    from sphinxsys_tpu_torch.physics import eulerian as eu
    from sphinxsys_tpu_torch.physics import fluid as fd

    kernel = case.adaptation.kernel
    if name == "water_entry_exit_2d":
        f = sim.fluid
        dt_adv = fd.advection_time_step(f, case.adaptation.h, cm.U_MAX)
        dt = torch.minimum(fd.acoustic_time_step(f, case.eos,
                                                 case.adaptation.h), dt_adv)
        return {"advection_prep": lambda: cm.advection_prep(case, sim),
                "acoustic_substep": lambda: cm.acoustic_substep(
                    case, sim, f, sim.cyl, sim.rb, dt_adv),
                "wetting_rk2": lambda: df.diffusion_step_rk2(
                    sim.cyl, "Phi", sim.nl_cc, kernel, 2, case.diffusion, dt,
                    dirichlet_contacts=[(f, sim.nl_cf)])}
    if name == "pkj_lv_electrocontraction_3d":
        dt = cm.step_dt(case, sim)
        pk = cm._pkj_state(case, sim.pkj_v, sim.pkj_w)
        return {"tree_electrophysiology": lambda: df.electrophysiology_step(
                    pk, case.nl_pkj, case.line_kernel, 3,
                    df.IsotropicDiffusion(cm.D_PKJ), case.model_pkj,
                    dt / case.n_pkj_sub),
                "tree_substeps": lambda: cm.tree_substeps(case, sim, dt),
                "myo_electrophysiology": lambda: df.electrophysiology_step(
                    sim.myo, case.nl_myo, kernel, 3,
                    df.IsotropicDiffusion(cm.D_MYO), case.model_myo, dt),
                "mechanics_substep": lambda: cm.mechanics_substep(
                    case, sim.myo, dt / case.n_mech_sub)}
    if name == "heart_electromechanics_3d":
        dt = cm.step_dt(case, sim)
        m = sim.myo
        dt_i = cm.mechanics_dt(case, m, dt, torch.zeros_like(dt))
        return {"local_directional_rate": lambda: df.diffusion_rate(
                    m["Position"], m["Voltage"], m["VolumetricMeasure"],
                    m["Position"], m["Voltage"], case.nl, kernel, 3,
                    case.diffusion, B_q=m["LinearGradientCorrectionMatrix"],
                    fiber_q=m["Fiber"]),
                "electrophysiology": lambda: df.electrophysiology_step(
                    m, case.nl, kernel, 3, case.diffusion, case.model, dt),
                "mechanics_substep": lambda: cm.mechanics_substep(case, m,
                                                                  dt_i),
                "cavity_flow_rate": lambda: cm.cavity_flow_rate(case, m)}
    f = sim.fluid
    dt = cm.time_step(case, f)
    box = case.box
    return {"viscous_force": lambda: fd.viscous_force(
                f, case.nl, kernel, 2, cm.MU_F, case.adaptation.h, box=box),
            "hllc_1st_half": lambda: eu.compressible_integration_1st_half(
                f, case.nl, kernel, 2, case.gas, dt, box=box,
                limiter=cm.LIMITER),
            "hllc_2nd_half": lambda: eu.compressible_integration_2nd_half(
                f, case.nl, kernel, 2, case.gas, dt, box=box,
                limiter=cm.LIMITER)}


EP_FIELDS = ("Position", "VolumetricMeasure", "Voltage", "GateVariable",
             "ActiveContractionStress")
EP_WRITES = ("Voltage", "GateVariable", "ActiveContractionStress")
GAS_READS = ("Position", "VolumetricMeasure", "Density", "Velocity",
             "Pressure", "TotalEnergy", "Momentum", "Mass", "ForcePrior")


def a7i_bounds(torch, name, cm, case, sim):
    """Each profiled part's least time from this run's lists and fields
    (`list_bound`); a step is its parts' sum (the water entry's: the prep
    and its mean sub-steps; the Purkinje case's: its tree sub-steps, the
    muscle's electrophysiology and its mechanics sub-steps; the heart's:
    its electrophysiology and its mean mechanics sub-steps)."""
    out = {}
    if name == "water_entry_exit_2d":
        f, c = sim.fluid, sim.cyl
        lists = [sim.nl_ff, sim.nl_fw, sim.nl_fc, sim.nl_cf]
        wall = fields(case.wall, *WALL_READS) + fields(c, *WALL_READS)
        sub = list_bound(torch, "acoustic_substep", lists,
                         fields(f, *FLUID_AC_READS) + wall,
                         fields(f, *FLUID_AC_WRITES)
                         + fields(c, "Position", "Velocity", "ForcePrior"))
        wet = list_bound(torch, "diffusion_rk2", [sim.nl_cc, sim.nl_cf],
                         fields(c, "Position", "VolumetricMeasure", "Phi")
                         + fields(f, "Position", "VolumetricMeasure", "Phi"),
                         fields(c, "Phi"))
        prep = list_bound(torch, "density", lists[:3],
                          fields(f, "Position", "Mass", "Density",
                                 "VolumetricMeasure", "Velocity") + wall,
                          fields(f, "Density", "Indicator", "ViscousForce",
                                 "ForcePrior", "Position"))
        sub = (sub[0] + wet[0], sub[1], sub[2] + wet[2])
        per_ac = sim.n_ac / max(sim.n_adv, 1)
        out.update(advection_prep=prep, acoustic_substep=sub,
                   wetting_rk2=wet, advection_step=(
                       prep[0] + per_ac * sub[0], sub[1],
                       round(prep[2] + per_ac * sub[2])))
        return out
    if name in ("pkj_lv_electrocontraction_3d", "heart_electromechanics_3d"):
        m = sim.myo
        nl = case.nl_myo if hasattr(case, "nl_myo") else case.nl
        ep = list_bound(torch, "electrophysiology", [nl],
                        fields(m, *EP_FIELDS, "LinearGradientCorrectionMatrix",
                               "Fiber"), fields(m, *EP_WRITES))
        mech = frozen_bound(torch, case.rp, m)
        if name == "pkj_lv_electrocontraction_3d":
            pk = cm._pkj_state(case, sim.pkj_v, sim.pkj_w)
            tree = list_bound(torch, "electrophysiology", [case.nl_pkj],
                              fields(pk, *EP_FIELDS), fields(pk, *EP_WRITES))
            subs = (case.n_pkj_sub * tree[0], tree[1],
                    case.n_pkj_sub * tree[2])
            out.update(tree_electrophysiology=tree, tree_substeps=subs,
                       myo_electrophysiology=ep, mechanics_substep=mech)
            n_mech = case.n_mech_sub
        else:
            out.update(local_directional_rate=list_bound(
                torch, "local_directional_rate", [nl],
                fields(m, "Position", "VolumetricMeasure", "Voltage",
                       "Fiber", "LinearGradientCorrectionMatrix"),
                fields(m, "Voltage")), electrophysiology=ep,
                mechanics_substep=mech)
            subs = (0.0, ep[1], 0)
            n_mech = sim.n_sub / max(sim.n_steps, 1)
        out["advection_step"] = (subs[0] + ep[0] + n_mech * mech[0], ep[1],
                                 round(subs[2] + ep[2] + n_mech * mech[2]))
        return out
    f = sim.fluid
    h1 = list_bound(torch, "hllc_1st_half", [case.nl], fields(f, *GAS_READS),
                    fields(f, "Momentum", "Velocity"))
    h2 = list_bound(torch, "hllc_2nd_half", [case.nl], fields(f, *GAS_READS),
                    fields(f, "Mass", "TotalEnergy", "Density", "Pressure"))
    vf = list_bound(torch, "viscous_force", [case.nl],
                    fields(f, "Position", "Velocity", "VolumetricMeasure",
                           "ViscousForcePrev", "ForcePrior"),
                    fields(f, "ViscousForce", "ViscousForcePrev",
                           "ForcePrior"))
    out.update(hllc_1st_half=h1, hllc_2nd_half=h2, viscous_force=vf,
               advection_step=(h1[0] + h2[0] + vf[0], h1[1],
                               h1[2] + h2[2] + vf[2]))
    return out


def a7i_observable(name, cm, case, sim):
    if name == "water_entry_exit_2d":
        return [*cm.center_position(sim).tolist(),
                cm.bottom_wetting(case, sim)]
    if name == "pkj_lv_electrocontraction_3d":
        return [cm.apex_voltage(case, sim), float(sim.pkj_v.max()),
                cm.midwall_ring_radius(case, sim)]
    if name == "heart_electromechanics_3d":
        return [float(sim.myo["Voltage"].max()), float(sim.dv),
                float(sim.q)]
    return cm.kinetic_energy(sim)


def a7i_case_path(torch, name, results):
    """A case at its JAX default width through build_case -> init_sim ->
    make_run_chunk -> solver.run_simulation (A7I_MAIN's end time),
    float32, every launch count reset just before and read just after: no
    overflow, finite fields, the observable printed; then one step and
    its new parts alone (`ob_parts`: wall and device time, launches, host
    reads, idle share, bound)."""
    cm = importlib.import_module(f"sphinxsys_tpu_torch.cases.{name}")
    t_end, sample = A7I_MAIN[name]

    def build():
        case, *states = cm.build_case(device=DEVICE)
        return case, cm, a7i_start(cm, case, states)

    case, sim, rec = ob_main_run(torch, f"a7i {name}", build, t_end, sample)
    check(not bool(getattr(sim, "overflow", False)), f"a7i {name}: overflow")
    bodies = {"water_entry_exit_2d": ("fluid", "cyl"),
              "eulerian_taylor_green_2d": ("fluid",)}.get(name, ("myo",))
    for b in bodies:
        body = getattr(sim, b)
        for k in ("Position", "Velocity", "Density", "Phi", "Voltage",
                  "TotalEnergy"):
            if k in body:
                check(bool(torch.isfinite(body[k]).all()),
                      f"a7i {name}: non-finite {b} {k}")
    counts = tuple(getattr(sim, k) for k in A7I_COUNTS if hasattr(sim, k))
    obs = a7i_observable(name, cm, case, sim)
    n_rows = {b: getattr(sim, b)["Position"].shape[0] for b in bodies}
    log(f"a7i {name} main path: rows {n_rows}; setup {rec['setup_s']:.2f} s;"
        f" to t={float(sim.time):.7f} counts {counts}; observable {obs}; "
        f"{rec['ms_per_adv']:.3f} ms a step (wall clock, mean), "
        f"{rec['host_reads_per_adv']:.1f} host reads a step; peak device "
        f"memory {rec['peak_gb']:.3f} GB")
    fns = a7i_parts(torch, name, cm, case, sim)
    step = cm.make_advection_step(case)
    parts = ob_parts(torch, f"a7i_{name}", fns, lambda: step(sim),
                     a7i_bounds(torch, name, cm, case, sim), trace=False)
    results[f"_a7i_{name}"] = dict(rec, counts=counts, observable=obs,
                                   n_rows=n_rows, parts=parts)
    del case, sim, fns, step
    torch.cuda.empty_cache()


def a7i_phase(torch, results):
    """Phase 21: the four cases of ROADMAP A item 4's rest and item 5's
    Eulerian half (no hand kernel), each at its JAX default width:
    float32 on the card against float64 on the CPU, then through the
    public entry points, its step by part."""
    t0 = time.perf_counter()
    for name in A7I_MAIN:
        f32 = a7i_f32_check(torch, name)
        a7i_case_path(torch, name, results)
        results[f"_a7i_{name}"]["f32_vs_f64"] = f32
    log(f"a7i phase: {time.perf_counter() - t0:.1f} s")



# ---------------------------------------------------------------------------
# Phase 22: the FVM front end and the multi-resolution family (ROADMAP A
# items 5b and 6: face gathers and (C, K) incidence sums, multi-level
# neighbour lists, frozen pairs, torch ops)
# ---------------------------------------------------------------------------

# case -> (the main path's end time, its output interval), float32 at the
# JAX default width: a few steps each
A7J_MAIN = {
    "fvm_cylinder_2d": (0.02, 0.01),
    "supersonic_cylinder_2d": (0.04, 0.02),
    "double_mach_reflection_2d": (0.001, 0.0005),
    "fvm_channel_3d": (4.0e-5, 2.0e-5),
    "taylor_green_mr_2d": (0.01, 0.005),
    "mr_cantilever_beam_2d": (1.0e-4, 5.0e-5),
    "mr_cylinder_2d": (0.2, 0.1),
}
A7J_FVM = ("fvm_cylinder_2d", "supersonic_cylinder_2d",
           "double_mach_reflection_2d", "fvm_channel_3d")
# the generated channel (tests/test_torch_fvm_cases.py CHANNEL_CELLS /
# CHANNEL_LENGTHS: the JAX spread was read on this mesh)
A7J_CHANNEL = ((64, 40, 2), (0.77, 0.5, 0.03))
A7J_JAX_SPREAD = "tests/golden_torch/fvm/jax_f32_spread.json"
A7J_FVM_FIELDS = ("Density", "Velocity", "Pressure", "TotalEnergyDensity")
A7J_SPREAD_FACTOR = 10.0


def torch_where_rows(f, key):
    """A fluid field with its dead rows zeroed (the MR cylinder's clones
    land in dead slots parked far away)."""
    v = f[key]
    m = f["Alive"].view(-1, *([1] * (v.dim() - 1)))
    return v * m.to(v.dtype)


# the MR cases' float32 check, phase 21's method: case -> (steps, ((what,
# the quantity of a sim, a change from the start?, tolerance as a share of
# the float64 max), ...)), each tolerance ten times the larger reading of
# this check on the CPU and on an H100, rounded up to one significant digit
A7J_MR_F32 = {
    "taylor_green_mr_2d": (3, (
        ("velocity_change", lambda s: s.fluid["Velocity"], True, 5e-4),
        ("density_change", lambda s: s.fluid["Density"], True, 6e-4))),
    "mr_cantilever_beam_2d": (20, (
        ("displacement", lambda s: s.solid["Position"], True, 2e-3),
        ("velocity", lambda s: s.solid["Velocity"], False, 2e-4))),
    "mr_cylinder_2d": (2, (
        ("velocity_change", lambda s: torch_where_rows(s.fluid, "Velocity"),
         True, 6e-4),
        ("displacement", lambda s: torch_where_rows(s.fluid, "Position"),
         True, 9e-4))),
}
A7J_COUNTS = ("n_adv", "n_ac", "n_steps")
# float32 operations of the new parts, counted from their formulas: a
# face's acoustic interface state and WC fluxes; its HLLC star state
# (sound speeds, wave and contact speeds, both star states, the selects)
# and fluxes; a MUSCL face value (the gradient's face term, the limiter's
# two quotients, the two reconstructions) of one field; a ghost select; a
# boundary face's force; an adaptive pair (`list_bound`): the multi-level
# build's distance and cut, the adaptive density, both acoustic halves,
# the viscous force with the TVC, the surface indication
FVM_FACE_FLOPS = {"face_states_flux": 70, "wc_step": 110,
                  "face_states_hllc": 210, "hllc_step": 260,
                  "muscl_reconstruction": 4 * 60, "muscl_step": 4 * 60 + 260,
                  "ghosts": 40, "boundary_force": 30}
# the mesh arrays each part reads (`fvm_bound` counts only these): the face
# states read the incidence, the tags and the normals; a cell reduction
# the slots and their signs; a step adds the areas and volumes (and r_eff
# where the fluid is viscous); MUSCL the midpoints and centroids
_FVM_FACES = ("owner", "neigh", "interior", "btype", "normal")
_FVM_CELLS = ("cell_faces", "cell_sign", "volumes")
_FVM_MUSCL = ("owner", "neigh", "interior", "area", "normal", "midpoint",
              "centroids") + _FVM_CELLS
FVM_MESH_READS = {"cell_reduce": ("cell_faces", "cell_sign"),
                  "face_states_flux": _FVM_FACES,
                  "face_states_hllc": _FVM_FACES,
                  "boundary_force": _FVM_FACES + ("area", "r_eff"),
                  "wc_step": _FVM_FACES + ("area",) + _FVM_CELLS,
                  "hllc_step": _FVM_FACES + ("area",) + _FVM_CELLS,
                  "muscl_reconstruction": _FVM_MUSCL,
                  "muscl_step": _FVM_MUSCL + ("btype",),
                  "ghosts": ("interior", "midpoint", "normal")}
LIST_PAIR_FLOPS.update({"multilevel_build": 12, "adaptive_density": 26,
                        "adaptive_substep": 85, "adaptive_viscous_tvc": 60,
                        "adaptive_surface": 30})


def a7j_build(cm, name, dtype, device, **kw):
    """(case, started sim) at the JAX default width; the channel on the
    generated hex channel."""
    if name == "fvm_channel_3d":
        from sphinxsys_tpu_torch.fvm.meshgen import hex_box

        kw["raw"] = hex_box(*A7J_CHANNEL[0], A7J_CHANNEL[1],
                            cm.CHANNEL_SIDES)
    case, *states = cm.build_case(dtype=dtype, device=device, **kw)
    return case, a7i_start(cm, case, states)


def a7j_fields(name, sim):
    return sim.state if name == "fvm_channel_3d" else sim.fluid


def a7j_fvm_f32_check(torch, name):
    """The FVM case built in float32 on the card and in float64 on the CPU,
    the JAX spread's steps on each: equal counts, each field's change from
    the start within A7J_SPREAD_FACTOR times the JAX package's own float32
    spread (max |f32 change - f64 change| / max |f64 change|).  Returns the
    spreads."""
    cm = importlib.import_module(f"sphinxsys_tpu_torch.cases.{name}")
    with open(ROOT / A7J_JAX_SPREAD) as f:
        jax_ref = json.load(f)["cases"][name]
    n = jax_ref["steps"]
    changes = []
    for dtype, device in ((torch.float64, "cpu"), (torch.float32, DEVICE)):
        case, s = a7j_build(cm, name, dtype, device)
        start = {k: v.double().cpu() for k, v in a7j_fields(name, s).items()}
        step = cm.make_advection_step(case)
        for _ in range(n):
            s = step(s)
        changes.append((s.n_steps, {k: v.double().cpu() - start[k]
                                    for k, v in a7j_fields(name, s).items()}))
    (n64, c64), (n32, c32) = changes
    spread = {k: float((c32[k] - c64[k]).abs().max()
                       / c64[k].abs().max().clamp(min=1e-300))
              for k in A7J_FVM_FIELDS if k in c64}
    log(f"a7j {name} float32 card against float64 cpu ({n} steps): counts "
        f"{n64} / {n32}; spread (JAX's own) " + ", ".join(
            f"{k} {v:.3e} ({jax_ref['spread'][k]:.3e})"
            for k, v in spread.items()))
    check(n64 == n32 == n, f"a7j {name}: counts {n64} / {n32} != {n}")
    for k, v in spread.items():
        check(v <= A7J_SPREAD_FACTOR * jax_ref["spread"][k],
              f"a7j {name}: float32 {k} spread {v:.3e} over "
              f"{A7J_SPREAD_FACTOR:g} x JAX's own {jax_ref['spread'][k]:.3e}")
    return dict(counts=(n64, n32), spread=spread,
                jax_spread=jax_ref["spread"])


def a7j_mr_f32_check(torch, name):
    """Phase 21's check with A7J_MR_F32: built and started in float64 on
    the CPU (the MR cylinder from its lattice, unrelaxed), the state cast
    to float32 on the card."""
    cm = importlib.import_module(f"sphinxsys_tpu_torch.cases.{name}")
    n, quantities = A7J_MR_F32[name]
    # the cylinder's lattice start: its relaxation runs on the main path
    kw = dict(relax_ic=False) if name == "mr_cylinder_2d" else {}
    case, s64 = a7j_build(cm, name, torch.float64, "cpu", **kw)
    runs = []
    for c, s in ((case, s64),
                 (cast_tree(torch, case, torch.float32, DEVICE),
                  cast_tree(torch, s64, torch.float32, DEVICE))):
        starts = [get(s).double().cpu() for _, get, _, _ in quantities]
        step = (cm.make_advection_step(c) if hasattr(cm, "make_advection_step")
                else cm.make_step(c))
        for _ in range(n):
            s = step(s)
        runs.append((s, starts))
    (sh, starts_h), (sc_, starts_c) = runs
    counts = [tuple(getattr(s, k) for k in A7J_COUNTS if hasattr(s, k))
              for s in (sh, sc_)]
    errs = {}
    for (what, get, change, tol), h0, c0 in zip(quantities, starts_h,
                                                 starts_c):
        h, c = get(sh).double().cpu(), get(sc_).double().cpu()
        if change:
            h, c = h - h0, c - c0
        errs[what] = (float((c - h).abs().max()), float(h.abs().max()), tol)
    log(f"a7j {name} float32 card against float64 cpu ({n} steps): counts "
        f"float64 {counts[0]}, float32 {counts[1]}; max |d| / max, "
        "tolerance " + ", ".join(f"{k} {e:.3e} / {m:.3e} = "
                                 f"{e / max(m, 1e-300):.3e}, {tol:g}"
                                 for k, (e, m, tol) in errs.items()))
    check(counts[0] == counts[1], f"a7j {name}: float32 counts {counts[1]} "
          f"!= float64 {counts[0]}")
    for k, (e, m, tol) in errs.items():
        check(bool(e <= tol * m), f"a7j {name}: float32 {k} off float64 by "
              f"{e:.3e} (max {m:.3e}, tolerance {tol:g})")
    return dict(counts=counts, **{k: e / max(m, 1e-300)
                                  for k, (e, m, _) in errs.items()})


def a7j_parts(torch, name, cm, case, sim):
    """The new parts alone on the main path's end state (the step itself
    is profiled beside them)."""
    from sphinxsys_tpu_torch.fvm import dynamics as fv
    from sphinxsys_tpu_torch.physics import eulerian as eu
    from sphinxsys_tpu_torch.physics import fluid_adaptive as fa
    from sphinxsys_tpu_torch.physics import solid as sd

    if name in A7J_FVM:
        f, dm = a7j_fields(name, sim), case.dm
        flux = torch.ones((dm.area.shape[0], dm.dim), dtype=dm.area.dtype,
                          device=dm.area.device)
        step = cm.make_advection_step(case)
        out = {"cell_reduce": lambda: fv._cell_reduce(dm, flux)}
        if name in ("fvm_cylinder_2d", "fvm_channel_3d"):
            bc = getattr(case, "bc", fv.BCSpec())

            def wc_faces():
                l, r = fv.face_states(f, dm, case.far, bc)
                return eu.interface_state(case.riemann, *l, *r, -dm.normal)
            out["face_states_flux"] = wc_faces
            if name == "fvm_cylinder_2d":
                out["boundary_force"] = lambda: cm.cylinder_force(case, sim)
            return out
        gas = case.gas
        if name == "supersonic_cylinder_2d":
            def hllc_faces():
                l, r = fv.compressible_face_states(f, dm, case.far, gas)
                return eu.hllc_interface_state(gas, *l, *r, -dm.normal)
            out["face_states_hllc"] = hllc_faces
            return out

        def muscl():
            vel = f["Velocity"]
            return [fv.muscl_face_values(q, dm) for q in (
                f["Density"], f["Pressure"], vel[:, 0], vel[:, 1])]
        left, right = fv.compressible_face_states(f, dm, cm.FAR, gas)
        out.update(muscl_reconstruction=muscl,
                   ghosts=lambda: cm._ghosts(left, right, dm, sim.time))
        return out
    if name == "taylor_green_mr_2d":
        dt_adv, f = cm.advection_prep(case, sim)
        dt = torch.minimum(fd_acoustic_dt(case, f), dt_adv)
        kernel, box = case.kernel, case.box
        f1 = fa.acoustic_step_1st_half_adaptive(f, sim.nl_inner, kernel, 2,
                                                case.eos, case.riemann, dt,
                                                box=box)
        return {"multilevel_build": lambda: cm.rebuild_inner(case, sim.fluid),
                "advection_prep": lambda: cm.advection_prep(case, sim),
                "adaptive_1st_half": lambda: fa.acoustic_step_1st_half_adaptive(
                    f, sim.nl_inner, kernel, 2, case.eos, case.riemann, dt,
                    box=box),
                "adaptive_2nd_half": lambda: fa.acoustic_step_2nd_half_adaptive(
                    f1, sim.nl_inner, kernel, 2, case.no_riemann, dt, box=box)}
    if name == "mr_cantilever_beam_2d":
        s0 = sim.solid
        hr = s0["SmoothingLengthRatio"]
        return {"adaptive_freeze": lambda: sd.freeze_adaptive_reference_pairs(
                    s0["InitialPosition"], hr, a7j_frozen_list(case),
                    case.kernel, 2)}
    dt_adv, f = cm.advection_prep(case, sim)
    return {"rebuild_relations": lambda: cm.rebuild_relations(case, sim.fluid),
            "advection_prep": lambda: cm.advection_prep(case, sim),
            "acoustic_substep": lambda: cm.acoustic_substep(
                case, sim, f, dt_adv, sim.time),
            "open_boundaries": lambda: cm.open_boundaries(
                case, sim.fluid, sim.fluid["Position"])}


def fd_acoustic_dt(case, f):
    from sphinxsys_tpu_torch.physics import fluid as fd

    return fd.acoustic_time_step(f, case.eos, case.adaptation.h / 2.0)


def a7j_frozen_list(case):
    """The MR beam's frozen list as a NeighborList (its idx and counts)."""
    from sphinxsys_tpu_torch.neighbors.neighbor_list import NeighborList

    rp = case.rp
    return NeighborList(idx=rp.idx, count=rp.mask.sum(1).to(rp.idx.dtype),
                        overflow=rp.mask.new_zeros(()))


def fvm_bound(torch, part, dm, reads, writes, cell_fields=0, extra=()):
    """The least time (ms) of one FVM pass: the mesh arrays the part reads
    (FVM_MESH_READS[part], and `extra`) read once, each array in `reads`
    read once and each in `writes` written once, over 3.35 TB/s;
    FVM_FACE_FLOPS[part] a real face, plus a signed add a slot for each of
    `cell_fields` reduced components, over 67 TFLOP/s.  Returns (ms, by,
    faces)."""
    mesh = tuple(getattr(dm, k) for k in FVM_MESH_READS[part] + extra)
    nbytes = sum(t.numel() * t.element_size()
                 for t in (*mesh, *reads, *writes))
    faces = dm.n_faces
    flops = faces * FVM_FACE_FLOPS.get(part, 0) \
        + 2 * dm.cell_faces.numel() * cell_fields
    ms, by = bytes_or_flops(nbytes, flops)
    return ms, by, faces


def a7j_bounds(torch, name, cm, case, sim):
    """Each profiled part's least time from this run's mesh, lists and
    fields; a step is its parts' sum."""
    out = {}
    if name in A7J_FVM:
        f, dm = a7j_fields(name, sim), case.dm
        state = list(f.values())
        ncomp = 2 + dm.dim if "TotalEnergyDensity" in f else 1 + dm.dim
        part = {"fvm_cylinder_2d": "wc_step", "fvm_channel_3d": "wc_step",
                "supersonic_cylinder_2d": "hllc_step",
                "double_mach_reflection_2d": "muscl_step"}[name]
        out["advection_step"] = fvm_bound(
            torch, part, dm, state, state, ncomp,
            ("r_eff",) if name == "fvm_cylinder_2d" else ())
        out["cell_reduce"] = fvm_bound(
            torch, "cell_reduce", dm,
            [torch.empty((dm.area.shape[0], dm.dim), device=dm.area.device)],
            [f["Velocity"]], dm.dim)
        faces_out = [torch.empty((dm.area.shape[0], 2 + dm.dim),
                                 device=dm.area.device)]
        if part == "wc_step":
            out["face_states_flux"] = fvm_bound(torch, "face_states_flux",
                                                dm, state, faces_out)
            if name == "fvm_cylinder_2d":
                out["boundary_force"] = fvm_bound(torch, "boundary_force", dm,
                                                  state, [])
        elif part == "hllc_step":
            out["face_states_hllc"] = fvm_bound(torch, "face_states_hllc",
                                                dm, state, faces_out)
        else:
            out["muscl_reconstruction"] = fvm_bound(
                torch, "muscl_reconstruction", dm, state, faces_out * 2)
            out["ghosts"] = fvm_bound(torch, "ghosts", dm, faces_out,
                                      faces_out)
        return out
    if name == "mr_cantilever_beam_2d":
        out["advection_step"] = frozen_bound(torch, case.rp, sim.solid)
        s0 = sim.solid
        out["adaptive_freeze"] = list_bound(
            torch, "multilevel_build", [a7j_frozen_list(case)],
            [s0["InitialPosition"], s0["SmoothingLengthRatio"]],
            [case.rp.W, case.rp.dW, case.rp.r, case.rp.e])
        return out
    f = sim.fluid
    lists = ([sim.nl_inner] if name == "taylor_green_mr_2d"
             else [sim.nl_ff, sim.nl_fw])
    ac_reads = fields(f, *FLUID_AC_READS, "SmoothingLengthRatio")
    wall = [] if name == "taylor_green_mr_2d" else fields(
        case.cylinder, *WALL_READS, "SmoothingLengthRatio")
    sub = list_bound(torch, "adaptive_substep", lists, ac_reads + wall,
                     fields(f, *FLUID_AC_WRITES))
    half = (sub[0] / 2, sub[1], sub[2])
    build_lists = lists if name == "taylor_green_mr_2d" \
        else [sim.nl_ff, sim.nl_fw, sim.nl_wf]
    build = list_bound(torch, "multilevel_build", build_lists,
                       fields(f, "Position", "SmoothingLengthRatio",
                              "Alive"), [])
    prep_parts = [list_bound(torch, p, lists,
                             fields(f, "Position", "Mass", "Velocity",
                                    "VolumetricMeasure",
                                    "SmoothingLengthRatio") + wall,
                             fields(f, "Density", "VolumetricMeasure",
                                    "ViscousForce", "ForcePrior",
                                    "Position"))
                  for p in ("adaptive_density", "adaptive_viscous_tvc")
                  + (("adaptive_surface",)
                     if name == "mr_cylinder_2d" else ())]
    prep = (sum(p[0] for p in prep_parts), prep_parts[0][1],
            sum(p[2] for p in prep_parts))
    per_ac = sim.n_ac / max(sim.n_adv, 1)
    out["advection_step"] = (prep[0] + per_ac * sub[0] + build[0], sub[1],
                             round(prep[2] + per_ac * sub[2] + build[2]))
    out["advection_prep"] = prep
    if name == "taylor_green_mr_2d":
        out.update(multilevel_build=build, adaptive_1st_half=half,
                   adaptive_2nd_half=half)
    else:
        from sphinxsys_tpu_torch.physics.boundary import _PARTICLE_FIELDS_HINT

        out.update(rebuild_relations=build, acoustic_substep=sub,
                   open_boundaries=list_bound(
                       torch, None, [], fields(f, "Alive", "Position",
                                               *cm.CLONE_FIELDS),
                       fields(f, "Alive", *cm.CLONE_FIELDS)))
    return out


def a7j_observable(name, cm, case, sim):
    if name == "fvm_cylinder_2d":
        return cm.drag_coefficient(case, sim)
    if name == "supersonic_cylinder_2d":
        return list(cm.stagnation_state(case, sim))
    if name == "double_mach_reflection_2d":
        return [cm.wall_shock_position(case, sim),
                float(sim.fluid["Density"].max())]
    if name == "fvm_channel_3d":
        return [cm.boundary_flux(case, sim, 10), cm.boundary_flux(case, sim, 5),
                cm.max_speed(sim)]
    if name == "taylor_green_mr_2d":
        return cm.max_speed(sim)
    if name == "mr_cantilever_beam_2d":
        return cm.tip_displacement(case, sim)
    fv, fp = cm.cylinder_forces(case, sim)
    return [*fv.tolist(), *fp.tolist(), cm.n_alive(sim)]


def a7j_case_path(torch, name, results):
    """A case at its JAX default width through build_case -> init_sim ->
    make_run_chunk -> solver.run_simulation (A7J_MAIN's end time),
    float32, every launch count reset just before and read just after: no
    overflow, finite fields, the observable printed; then one step and
    its new parts alone (`ob_parts`)."""
    cm = importlib.import_module(f"sphinxsys_tpu_torch.cases.{name}")
    t_end, sample = A7J_MAIN[name]

    def build():
        case, sim = a7j_build(cm, name, torch.float32, DEVICE)
        return case, cm, sim

    case, sim, rec = ob_main_run(torch, f"a7j {name}", build, t_end, sample)
    check(not bool(getattr(sim, "overflow", False)), f"a7j {name}: overflow")
    body = (sim.solid if name == "mr_cantilever_beam_2d"
            else a7j_fields(name, sim))
    for k in ("Position", "Velocity", "Density", "Pressure",
              "TotalEnergyDensity"):
        if k in body:
            check(bool(torch.isfinite(body[k]).all()),
                  f"a7j {name}: non-finite {k}")
    counts = tuple(getattr(sim, k) for k in A7J_COUNTS if hasattr(sim, k))
    obs = a7j_observable(name, cm, case, sim)
    rows = (case.dm.n_cells if name in A7J_FVM
            else body["Position"].shape[0])
    log(f"a7j {name} main path: {rows} cells or rows; setup "
        f"{rec['setup_s']:.2f} s; to t={float(sim.time):.7g} counts {counts};"
        f" observable {obs}; {rec['ms_per_adv']:.3f} ms a step (wall clock, "
        f"mean), {rec['host_reads_per_adv']:.1f} host reads a step; peak "
        f"device memory {rec['peak_gb']:.3f} GB")
    fns = a7j_parts(torch, name, cm, case, sim)
    step = (cm.make_advection_step(case) if hasattr(cm, "make_advection_step")
            else cm.make_step(case))
    parts = ob_parts(torch, f"a7j_{name}", fns, lambda: step(sim),
                     a7j_bounds(torch, name, cm, case, sim), trace=False)
    results[f"_a7j_{name}"] = dict(rec, counts=counts, observable=obs,
                                   rows=rows, parts=parts)
    del case, sim, fns, step
    torch.cuda.empty_cache()


def a7j_phase(torch, results):
    """Phase 22: the seven cases of ROADMAP A items 5b and 6 (no hand
    kernel), each at its JAX default width: float32 on the card against
    float64 on the CPU, then through the public entry points, its step by
    part."""
    t0 = time.perf_counter()
    for name in A7J_MAIN:
        f32 = (a7j_fvm_f32_check(torch, name) if name in A7J_FVM
               else a7j_mr_f32_check(torch, name))
        a7j_case_path(torch, name, results)
        results[f"_a7j_{name}"]["f32_vs_f64"] = f32
    log(f"a7j phase: {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# Phase 23: the level sets, the shell and implicit relaxations and the
# k-epsilon turbulence (ROADMAP A items 7 and 8: packaged level-set probes,
# (N, K) list sums and d x d closed-form solves, torch ops)
# ---------------------------------------------------------------------------

# the time-stepping cases: (the main path's end time, its output
# interval), float32 at the JAX default width: a few steps each
A7K_MAIN = {
    "static_confinement_2d": (0.02, 0.01),
    "turbulent_channel_2d": (0.05, 0.025),
}
# the relaxations through run_case: iterations (and the curve's interval)
A7K_RELAX = {
    "shell_relaxation_2d": dict(n_iterations=100),
    "implicit_relaxation_2d": dict(n_iterations=50, record_every=25),
}
# float32 on the card against float64 on the CPU from the same started
# state (phase 21's check and form), each tolerance ten times the larger
# reading of this check on the CPU (DEVICE = "cpu") and on an H100,
# rounded up to one significant digit
A7K_F32 = {
    "static_confinement_2d": (10, (
        ("displacement", lambda s: s.fluid["Position"], True, 6e-3),
        ("velocity", lambda s: s.fluid["Velocity"], False, 6e-3))),
    "turbulent_channel_2d": (10, (
        ("velocity_change", lambda s: s.fluid["Velocity"], True, 5e-4),
        ("k_change", lambda s: s.fluid["TurbulenceKineticEnergy"], True,
         1e-4))),
}
# the relaxations' check: iterations, the tolerance of the displacement
# from the jittered start (and of the implicit curve) as a share of the
# float64 max, the same rule
A7K_RELAX_F32 = {"shell_relaxation_2d": (40, dict(displacement=3e-4)),
                 "implicit_relaxation_2d": (20, dict(displacement=7e-4,
                                                     curve=3e-5))}
A7K_BLADE_CHORD = 4.0       # the NACA 0012 stand-in for the turbine blade
# the pair operations of the new parts whose bounds count them: the
# channel's outer half (the density, both correction matrices, the
# turbulent viscous force, the transport correction); its acoustic
# sub-step (both halves, the TKE force, the wall-function correction, the
# velocity gradient, the K and Epsilon equations); a relaxation residual;
# the implicit update (dW, d2W, e e^T, B, B B, the push); the smoothing
LIST_PAIR_FLOPS.update({"turbulence_prep": 150, "turbulence_substep": 270,
                        "relax_residual": 15, "implicit_update": 60,
                        "normal_smoothing": 15})


def levelset_arrays(shape, *names):
    """A LevelSetShape's (or LevelSet's) tables and the named fields."""
    ls = getattr(shape, "levelset", shape)
    return [ls.coarse_map, ls.pkg_nbr] + [getattr(ls, k) for k in names]


def a7k_relax_start(torch, name, device, dtype):
    """(run one relaxation from the jittered start: fn(pos, n), the start
    (float64 on the CPU, cast to `dtype` on `device`), the spacing)."""
    from sphinxsys_tpu_torch.physics import relax as rx
    from sphinxsys_tpu_torch.physics import relax_shell as rs

    cm = importlib.import_module(f"sphinxsys_tpu_torch.cases.{name}")
    f64 = dict(dtype=torch.float64, device="cpu")
    if name == "shell_relaxation_2d":
        _, ls, pos0, area, ad, grid = cm.build_case(**f64)
        start = rs.mid_surface_bounding(
            rx.randomize_positions(pos0, ad.spacing), ls, ad.spacing)
        ls = cast_tree(torch, ls, dtype, device)
        return (lambda p, n: (rs.shell_relax_iterations(
            ls, p, area * cm.THICKNESS, ad, grid, n_iterations=n), None),
            start.to(device, dtype), ad.spacing)
    blade = cm.naca0012(A7K_BLADE_CHORD)
    pos0, vol, ad, grid, ls = cm.build_case(blade, **f64)
    start = rx.surface_bounding(rx.randomize_positions(pos0, ad.spacing),
                                blade, ad.spacing)
    ls = cast_tree(torch, ls, dtype, device)
    return (lambda p, n: rx.relax_shape_implicit_iterations(
        blade, p, vol, ad, grid, n_iterations=n, record_every=5,
        levelset=ls), start.to(device, dtype), ad.spacing)


def a7k_relax_f32_check(torch, name):
    """A relaxation from one jittered start (float64 on the CPU) run in
    float64 there and in float32 on the card: the displacement from the
    start (and the implicit curve) within A7K_RELAX_F32's tolerance of
    the float64 max."""
    n, tols = A7K_RELAX_F32[name]
    runs = []
    for dtype, device in ((torch.float64, "cpu"), (torch.float32, DEVICE)):
        run, start, _ = a7k_relax_start(torch, name, device, dtype)
        p, curve = run(start, n)
        runs.append((p.double().cpu() - start.double().cpu(),
                     None if curve is None else curve.double().cpu()))
    (d64, c64), (d32, c32) = runs
    errs = {"displacement": (float((d32 - d64).abs().max()),
                             float(d64.abs().max()))}
    if c64 is not None:
        errs["curve"] = (float((c32 - c64).abs().max()),
                         float(c64.abs().max()))
    log(f"a7k {name} float32 card against float64 cpu ({n} iterations): "
        "max |d| / max, tolerance " + ", ".join(
            f"{k} {e:.3e} / {m:.3e} = {e / max(m, 1e-300):.3e}, {tols[k]:g}"
            for k, (e, m) in errs.items()))
    for k, (e, m) in errs.items():
        check(m > 0 and e <= tols[k] * m, f"a7k {name}: float32 {k} off "
              f"float64 by {e:.3e} (max {m:.3e}, tolerance {tols[k]:g})")
    return {k: e / max(m, 1e-300) for k, (e, m) in errs.items()}


def a7k_parts(torch, name, cm, case, sim):
    """The new parts alone on the main path's end state."""
    from sphinxsys_tpu_torch.physics import relax as rx
    from sphinxsys_tpu_torch.physics import turbulence as tb

    if name == "static_confinement_2d":
        dt_adv, f = cm.advection_prep(case, sim)
        pos = f["Position"]
        return {"advection_prep": lambda: cm.advection_prep(case, sim),
                "acoustic_substep": lambda: cm.acoustic_substep(case, sim, f),
                "surface_bounding": lambda: rx.surface_bounding(
                    pos, case.ls_wall, case.dx),
                "kernel_gradient_probe": lambda: case.ls_wall
                .compute_kernel_gradient_integral(pos),
                "rebuild_relations": lambda: cm.rebuild_relations(case, f)}
    dt_adv, f = cm.advection_prep(case, sim)
    kernel, wall, nlw = case.kernel, case.wall, sim.nl_wall

    def wall_function():
        g = tb.judge_is_near_wall(f, wall, nlw, kernel, 2, case.dx, case.dx)
        return tb.standard_wall_function_correction(
            g, wall, nlw, kernel, 2, cm.MU_F, sim.time, case.closure)

    def k_epsilon():
        g = tb.k_equation(f, sim.nl_inner, kernel, 2, cm.MU_F,
                          case.adaptation.h, dt_adv, case.closure, stl=False)
        return tb.epsilon_equation(g, sim.nl_inner, kernel, 2, cm.MU_F,
                                   case.adaptation.h, dt_adv, case.closure,
                                   stl=False)

    return {"advection_prep": lambda: cm.advection_prep(case, sim),
            "acoustic_substep": lambda: cm.acoustic_substep(
                case, sim, f, dt_adv, sim.time),
            "wall_function": wall_function, "k_epsilon": k_epsilon,
            "rebuild_lists": lambda: cm.rebuild_lists(case, f)}


TURB_READS = ("TurbulenceKineticEnergy", "TurbulentDissipation",
              "TurbulentViscosity", "TurbulentVelocityGradient",
              "IsNearWallP1", "IsNearWallP2", "K_Production", "Y_P",
              "WallNearestNormal", "TurbulentCorrectionMatrix")


def a7k_bounds(torch, name, cm, case, sim):
    """Each profiled part's least time from this run's lists, fields and
    level sets (`list_bound`); a step is its parts' sum."""
    f = sim.fluid
    per_ac = sim.n_ac / max(sim.n_adv, 1)
    if name == "static_confinement_2d":
        lists = [sim.nl_inner]
        ls = levelset_arrays(case.ls_wall, "kernel_gw", "phi") \
            + levelset_arrays(case.ls_triangle, "kernel_gw", "phi")
        prep = list_bound(torch, "density", lists,
                          fields(f, "Position", "Mass", "Velocity", "Force",
                                 "ForcePrior") + levelset_arrays(
                              case.ls_wall, "kernel_w")
                          + levelset_arrays(case.ls_triangle, "kernel_w"),
                          fields(f, "DensitySummation", "Density"))
        sub = list_bound(torch, "acoustic_substep", lists,
                         fields(f, *FLUID_AC_READS) + ls,
                         fields(f, *FLUID_AC_WRITES))
        build = list_bound(torch, "multilevel_build", lists,
                           fields(f, "Position"), [])
        return {"advection_prep": prep, "acoustic_substep": sub,
                "surface_bounding": list_bound(
                    torch, None, [], [f["Position"]]
                    + levelset_arrays(case.ls_wall, "phi"), [f["Position"]]),
                "kernel_gradient_probe": list_bound(
                    torch, None, [], [f["Position"]] + levelset_arrays(
                        case.ls_wall, "kernel_gw"), [f["Position"]]),
                "rebuild_relations": build,
                "advection_step": (prep[0] + per_ac * sub[0] + build[0],
                                   sub[1], round(prep[2] + per_ac * sub[2]
                                                 + build[2]))}
    lists = [sim.nl_inner, sim.nl_wall]
    wall = fields(case.wall, *WALL_READS)
    prep = list_bound(torch, "turbulence_prep", lists,
                      fields(f, "Position", "Mass", "Velocity",
                             "VolumetricMeasure", *TURB_READS) + wall,
                      fields(f, "Density", "Pressure", "VolumetricMeasure",
                             "LinearGradientCorrectionMatrix",
                             "TurbulentCorrectionMatrix", "TurbulentViscosity",
                             "ViscousForce", "ForcePrior", "Position"))
    sub = list_bound(torch, "turbulence_substep", lists,
                     fields(f, *FLUID_AC_READS, *TURB_READS) + wall,
                     fields(f, *FLUID_AC_WRITES, *TURB_READS))
    build = list_bound(torch, "multilevel_build", lists,
                       fields(f, "Position"), [])
    return {"advection_prep": prep, "acoustic_substep": sub,
            "wall_function": list_bound(
                torch, "density", [sim.nl_wall],
                fields(f, "Position", "Velocity", "Density", *TURB_READS)
                + wall, fields(f, "WallYstar", "WallYplus",
                               "FrictionVelocity", "TurbulentDissipation",
                               "TurbulentVelocityGradient", "K_Production")),
            "k_epsilon": list_bound(
                torch, "relax_residual", [sim.nl_inner],
                fields(f, "Position", "VolumetricMeasure", "Density",
                       *TURB_READS), fields(f, "TurbulenceKineticEnergy",
                                            "TurbulentDissipation",
                                            "TurbulentStrainRate")),
            "rebuild_lists": build,
            "advection_step": (prep[0] + per_ac * sub[0] + build[0], sub[1],
                               round(prep[2] + per_ac * sub[2] + build[2]))}


def a7k_observable(name, cm, case, sim):
    if name == "static_confinement_2d":
        pos = sim.fluid["Position"]
        return [cm.mechanical_energy(case, sim), float(pos[:, 1].min()),
                float(pos[:, 0].max())]
    return [float(sim.fluid["TurbulentViscosity"].max()),
            float(sim.fluid["TurbulenceKineticEnergy"].mean()),
            int(sim.fluid["IsNearWallP1"].sum())]


def a7k_case_path(torch, name, results):
    """A time-stepping case at its JAX default width through build_case ->
    init_sim -> make_run_chunk -> solver.run_simulation (A7K_MAIN's end
    time), float32, every launch count reset just before and read just
    after: no overflow, finite fields, the observable printed; then one
    step and its new parts alone (`ob_parts`)."""
    cm = importlib.import_module(f"sphinxsys_tpu_torch.cases.{name}")
    t_end, sample = A7K_MAIN[name]

    def build():
        case, fluid = cm.build_case(device=DEVICE)
        return case, cm, cm.init_sim(case, fluid)

    case, sim, rec = ob_main_run(torch, f"a7k {name}", build, t_end, sample)
    check(not bool(sim.overflow), f"a7k {name}: overflow")
    for k in ("Position", "Velocity", "Density", "Pressure",
              "TurbulenceKineticEnergy", "TurbulentDissipation"):
        if k in sim.fluid:
            check(bool(torch.isfinite(sim.fluid[k]).all()),
                  f"a7k {name}: non-finite {k}")
    counts = (sim.n_adv, sim.n_ac)
    obs = a7k_observable(name, cm, case, sim)
    log(f"a7k {name} main path: {sim.fluid['Position'].shape[0]} fluid rows;"
        f" setup {rec['setup_s']:.2f} s; to t={float(sim.time):.7f} counts "
        f"{counts}; observable {obs}; {rec['ms_per_adv']:.3f} ms a step "
        f"(wall clock, mean), {rec['host_reads_per_adv']:.1f} host reads a "
        f"step; peak device memory {rec['peak_gb']:.3f} GB")
    if name == "static_confinement_2d":
        check(obs[1] > -case.dx, f"a7k {name}: a particle below the floor")
    step = cm.make_advection_step(case)
    parts = ob_parts(torch, f"a7k_{name}", a7k_parts(torch, name, cm, case,
                                                     sim), lambda: step(sim),
                     a7k_bounds(torch, name, cm, case, sim), trace=False)
    results[f"_a7k_{name}"] = dict(rec, counts=counts, observable=obs,
                                   rows=sim.fluid["Position"].shape[0],
                                   parts=parts)
    del case, sim, step
    torch.cuda.empty_cache()


def a7k_relax_path(torch, name, results):
    """A relaxation through its run_case at the JAX default width
    (A7K_RELAX's iterations), float32, the launch counts reset just
    before and read just after (no hand kernel), the host reads counted:
    finite output, the shell on its mid circle and its normals unit, the
    implicit residual curve falling; then one iteration and its parts
    alone (`ob_parts`)."""
    from sphinxsys_tpu_torch.physics import relax as rx
    from sphinxsys_tpu_torch.physics import relax_shell as rs

    cm = importlib.import_module(f"sphinxsys_tpu_torch.cases.{name}")
    kw = dict(A7K_RELAX[name])
    n_it = kw["n_iterations"]
    if name == "implicit_relaxation_2d":
        kw["blade"] = cm.naca0012(A7K_BLADE_CHORD)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    read_counts = reset_all_launch_counts()
    with SyncCounter(torch) as syncs:
        t0 = time.perf_counter()
        out = cm.run_case(device=DEVICE, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = read_counts()
    check(not any(counts.values()), f"a7k {name}: a hand kernel ran {counts}")
    pos = out[0]
    check(bool(torch.isfinite(pos).all()), f"a7k {name}: non-finite positions")
    rec = dict(run_s=wall, ms_per_iteration=wall / n_it * 1e3,
               host_reads_per_iteration=syncs.n / n_it, peak_gb=peak_gb(torch),
               rows=pos.shape[0], iterations=n_it, kernel_launches=counts)
    if name == "shell_relaxation_2d":
        normals, updated = out[1], out[2]
        r = torch.linalg.vector_norm(pos.double(), dim=1)
        off = float((r - cm.R_MID).abs().max())
        unit = float((torch.linalg.vector_norm(normals.double(), dim=1)
                      - 1).abs().max())
        rec.update(max_off_mid=off, normals_unit_err=unit,
                   all_updated=bool(updated.all()))
        obs = [off, unit, int(updated.sum())]
        check(off < cm.DX and unit < 1e-5, f"a7k {name}: off the mid circle "
              f"by {off:.3e} or normals not unit ({unit:.3e})")
    else:
        curve = out[1].double().cpu()
        rec["curve"] = curve.tolist()
        obs = curve.tolist()
        check(bool(torch.isfinite(curve).all()) and bool(curve[-1] < curve[0]),
              f"a7k {name}: residual curve {curve.tolist()}")
    log(f"a7k {name} main path (run_case): {pos.shape[0]} particles, {n_it} "
        f"iterations in {wall:.2f} s (setup included): "
        f"{rec['ms_per_iteration']:.3f} ms an iteration, "
        f"{rec['host_reads_per_iteration']:.2f} host reads an iteration; "
        f"observable {obs}; peak device memory {rec['peak_gb']:.3f} GB")

    p = pos        # the parts on the main path's relaxed particles
    if name == "shell_relaxation_2d":
        _, ls, _, area, ad, grid = cm.build_case(device=DEVICE)
        nl = rx._inner_list(p, grid, ad.cutoff, 32, 48)
        vol = torch.full((p.shape[0],), area * cm.THICKNESS, device=p.device)
        fns = {"relax_iteration": lambda: rs.shell_relax_iterations(
                   ls, p, area * cm.THICKNESS, ad, grid, n_iterations=1),
               "mid_surface_bounding": lambda: rs.mid_surface_bounding(
                   p, ls, ad.spacing),
               "normal_prediction": lambda: rs.shell_normal_prediction(
                   p, ls, cm.THICKNESS, ad, grid)}
        bounds = {"relax_iteration": list_bound(
                      torch, "relax_residual", [nl], [p, vol]
                      + levelset_arrays(ls, "phi"), [p]),
                  "mid_surface_bounding": list_bound(
                      torch, None, [], [p] + levelset_arrays(ls, "phi"), [p]),
                  "normal_prediction": list_bound(
                      torch, "normal_smoothing", [nl],
                      [p] + levelset_arrays(ls, "phi"), [p])}
    else:
        blade = cm.naca0012(A7K_BLADE_CHORD)
        _, vol, ad, grid, ls = cm.build_case(blade, device=DEVICE)
        nl = rx._inner_list(p, grid, ad.cutoff, 32, 48)
        vols = torch.full((p.shape[0],), vol, device=p.device)
        fns = {"implicit_iteration": lambda: rx.relax_shape_implicit_iterations(
                   blade, p, vol, ad, grid, n_iterations=1, record_every=1,
                   levelset=ls),
               "implicit_update": lambda: rx.implicit_relaxation_update(
                   p, vols, nl, ad.kernel, 2, 1e-4, levelset=ls),
               "levelset_probes": lambda: (
                   ls.probe_kernel_integral(p),
                   ls.probe_kernel_gradient_integral(p),
                   ls.probe_kernel_second_gradient_integral(p))}
        ls_reads = levelset_arrays(ls, "kernel_w", "kernel_gw", "kernel_g2w")
        bounds = {"implicit_iteration": list_bound(
                      torch, "implicit_update", [nl], [p, vols] + ls_reads,
                      [p]),
                  "implicit_update": list_bound(
                      torch, "implicit_update", [nl], [p, vols] + ls_reads,
                      [p, p]),
                  "levelset_probes": list_bound(
                      torch, None, [], [p] + ls_reads, [p, p, p, p])}
    parts = ob_parts(torch, f"a7k_{name}", fns, None, bounds, trace=False)
    results[f"_a7k_{name}"] = dict(rec, observable=obs, parts=parts)
    torch.cuda.empty_cache()


def a7k_phase(torch, results):
    """Phase 23: the four cases of ROADMAP A items 7 and 8 (no hand
    kernel), each at its JAX default width (the implicit relaxation on
    the NACA 0012 stand-in): float32 on the card against float64 on the
    CPU, then through the public entry points, its step or iteration by
    part."""
    t0 = time.perf_counter()
    for name in A7K_MAIN:
        f32 = a7i_f32_check(torch, name, A7K_F32, "a7k")
        a7k_case_path(torch, name, results)
        results[f"_a7k_{name}"]["f32_vs_f64"] = f32
    for name in A7K_RELAX:
        f32 = a7k_relax_f32_check(torch, name)
        a7k_relax_path(torch, name, results)
        results[f"_a7k_{name}"]["f32_vs_f64"] = f32
    log(f"a7k phase: {time.perf_counter() - t0:.1f} s")

# ---------------------------------------------------------------------------
# phase 24: the block engine on a ring of ranks and the modules with no
# case caller
# ---------------------------------------------------------------------------

# the 2D dambreak at the bench's width on a ThreadRing of RING_RANKS ranks
# sharing the card, RING_STEPS advection steps, against the single-device
# block engine from the same start; by OriginalID, positions within
# RING_POS_TOL of the domain length (tests/test_block_domain.py:69-71)
# and velocities within RING_VEL_TOL of their largest component.  From
# rest these few steps move particles ~1e-6 m at ~2e-3 m/s, with float32
# summation-order differences ~1e-3 of that velocity, so these bounds see
# a ring that drops its ghosts but not one that skips a refresh: the
# ghosts' values barely change in a sub-step.  The same ring and steps
# from the start with seeded noise (benchmarks.perturbed: 0.1 dx, 0.1
# m/s) do see it: positions within RING_NOISY_DISP_TOL of the largest
# displacement and velocities within RING_NOISY_VEL_TOL of their largest
# component (float32 on the CPU at dx 0.05: 1e-5 of each; without the
# mid-sub-step or the post-half refresh 1e-2 and 1.6-2.6e-2).
RING_DX = 0.0025
RING_RANKS = 4
RING_STEPS = 3
RING_HALO_CAP = 2048
RING_MIGRATE_CAP = 1024
RING_POS_TOL = 1e-3
RING_VEL_TOL = 1e-2
RING_NOISY_DISP_TOL = 2e-3
RING_NOISY_VEL_TOL = 1e-3
RING_TAG = f"ring{RING_RANKS}"
# a module's float32 result on the card against its float64 one on the
# CPU: within CALLER_FREE_FACTOR times the CPU's own float32 error, and at
# least float32's epsilon of max|ref|
CALLER_FREE_FACTOR = 10.0
F32_EPS = 1.1920929e-07


def ring_kernel_checks(torch, scene, probes, results):
    """B1-B3 against their plain versions on one rank's slab plus its ghost
    slots (the rank holding the most ghosts), as phase 3 holds them on
    the single-device scene: times, bound, max error."""
    import types

    from sphinxsys_tpu_torch.benchmarks import median_ms, sweep_inputs
    from sphinxsys_tpu_torch.ops import block_sweeps as bs

    def ghosts(item):
        fb = item[1][1]
        return int((fb["SlotMask"] & (fb["IsGhost"] > 0.5)).sum())

    rank, (eng_loc, fb, nbr, wc) = max(probes.items(), key=ghosts)
    n_ghost = ghosts((rank, (eng_loc, fb, nbr, wc)))
    n_own = int((fb["SlotMask"] & (fb["IsGhost"] < 0.5)).sum())
    r_scene = types.SimpleNamespace(eng=eng_loc, wall_state_fn=None,
                                    wall_b=scene.wall_b)
    r_sim = types.SimpleNamespace(fluid_b=fb, nbr_inner=nbr,
                                  nbr_wall=wc.nbr_wall, aux=None)
    real = fb["SlotMask"][:nbr.shape[0]]
    log(f"{RING_TAG} rank {rank}: {n_own} owned slots, {n_ghost} ghost "
        f"slots, c_max {eng_loc.c_max}")
    for name, (args, kw) in sweep_inputs(r_scene, r_sim,
                                         DAMBREAK_KERNELS).items():
        wrapper, plain = getattr(bs, name), getattr(bs, name + "_plain")
        got, max_abs = compare(torch, f"{RING_TAG} rank {rank}", name, args,
                               kw, real)
        ms = median_ms(lambda: wrapper(*args, **kw), 20, DEVICE)
        plain_ms = median_ms(lambda: plain(*args, **kw), 3, DEVICE)
        bound_ms, bound_by, pairs, flops, nbytes = bound(
            torch, name, args, got, r_scene, r_sim)
        log(f"{RING_TAG} rank {rank} {name}: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
            f"{pairs} real pairs, {flops:.4e} flop, {nbytes} B), "
            f"max_abs_err {max_abs:.3e}")
        results[f"{name}[{RING_TAG}]"].update(
            max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by, real_pairs=pairs, rank=rank)


def ring_match(tag, h, sim, ref, start, n):
    """The ring's state `h` against the single device's `sim` (`ref` its
    particles) after the same steps from `start`: no overflow, equal
    acoustic sub-step counts, the time to rtol 1e-12, every OriginalID
    once, finite values; returns the largest position and velocity
    errors by ID, displacement from the start and velocity component."""
    from sphinxsys_tpu_torch.parallel import domain as dm

    check(not bool(sim.overflow), f"{tag}: single-device overflow")
    check(not bool(h.overflow), f"{tag}: overflow")
    check(h.n_ac == sim.n_ac, f"{tag}: {h.n_ac} acoustic sub-steps, the "
          f"single device {sim.n_ac}")
    dt_rel = abs(float(h.time) - float(sim.time)) / float(sim.time)
    check(dt_rel <= 1e-12, f"{tag}: time {float(h.time)!r} vs "
          f"{float(sim.time)!r} (rel {dt_rel:.3e})")
    got = dm.gather_by_id(h, n)
    check(sorted(got["ids"].tolist()) == list(range(n)),
          f"{tag}: OriginalIDs not each present once")
    for k in ("Position", "Velocity"):
        check(bool((abs(got[k]) < 1e30).all()), f"{tag}: non-finite {k}")
    want_pos = ref["Position"][:n].cpu().numpy()
    want_vel = ref["Velocity"][:n].cpu().numpy()
    p0 = start["Position"][:n].cpu().numpy()
    return dict(pos_err=float(abs(got["Position"] - want_pos).max()),
                vel_err=float(abs(got["Velocity"] - want_vel).max()),
                max_disp=float(abs(want_pos - p0).max()),
                max_v=float(abs(want_vel).max()))


def ring_path(torch, results):
    """The 4-rank dambreak at full width through the port's distributed
    entry points, every launch count reset just before and read just
    after; matched against the single-device block engine; then B1-B3 on
    one rank's inputs and a step of each profiled."""
    from sphinxsys_tpu_torch.benchmarks import perturbed
    from sphinxsys_tpu_torch.cases import dambreak_2d as db
    from sphinxsys_tpu_torch.engine import scene as sc
    from sphinxsys_tpu_torch.ops import block_sweeps as bs
    from sphinxsys_tpu_torch.parallel import block_domain as bd
    from sphinxsys_tpu_torch.parallel.mesh import make_particle_mesh

    scene, fluid = db.build_block_case(dx=RING_DX, device=DEVICE)
    n = int(fluid["NReal"])
    sim = sc.init_sim(scene, fluid)
    step_s = sc.make_advection_step(scene)
    t0 = time.perf_counter()
    for _ in range(RING_STEPS):
        sim = step_s(sim)
    torch.cuda.synchronize()
    single_s = time.perf_counter() - t0

    ring = make_particle_mesh(RING_RANKS, device=DEVICE)
    h0 = bd.distribute_block_engine(scene.eng, fluid, ring)
    # each rank's first acoustic sub-step inputs, kept from the last step
    # for the kernel checks (the probe only keeps references)
    probes = {}
    step_d = bd.make_distributed_engine_step(
        scene.eng, ring, wall_b=scene.wall_b, bm_wall=scene.bm_wall,
        wall_dense_map=scene.wall_dense_map, halo_cap=RING_HALO_CAP,
        migrate_cap=RING_MIGRATE_CAP, c_max_loc=scene.eng.c_max,
        probe=lambda r, eng_loc, fb, nbr, wc: probes.__setitem__(
            r, (eng_loc, fb, nbr, wc)))
    h = h0
    torch.cuda.synchronize()
    bs.reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(RING_STEPS):
        h = step_d(h)
    torch.cuda.synchronize()
    ring_s = time.perf_counter() - t0
    counts = dict(bs.LAUNCHES)

    length = scene.eng.grid.spacing[0] * scene.eng.grid.shape[0]
    e = ring_match(RING_TAG, h, sim, sc.blocks_to_particles(scene, sim), fluid,
                   n)
    check(e["pos_err"] <= RING_POS_TOL * length,
          f"{RING_TAG}: position error {e['pos_err']:.3e} > {RING_POS_TOL} x "
          f"{length:.4f}")
    check(e["vel_err"] <= RING_VEL_TOL * e["max_v"],
          f"{RING_TAG}: velocity error {e['vel_err']:.3e} > {RING_VEL_TOL} x "
          f"the largest component {e['max_v']:.3e}")
    pos_err, vel_err = e["pos_err"], e["vel_err"]
    for name in DAMBREAK_KERNELS:
        key = KERNELS[name][1]
        check(counts[key] > 0, f"{RING_TAG}: kernel {name} never launched")
        results[f"{name}[{RING_TAG}]"] = dict(launches=counts[key])
    occupancy = [int(p["Alive"].sum()) for p in h.fluid]
    log(f"{RING_TAG} main path: n_fluid={n} ranks={RING_RANKS} live rows "
        f"{occupancy} n_loc={h.fluid[0]['Alive'].shape[0]} "
        f"n_adv={h.n_adv} n_ac={h.n_ac} t={float(h.time)!r} (single device "
        f"{float(sim.time)!r}) position error {pos_err:.3e} (limit "
        f"{RING_POS_TOL * length:.3e}; largest displacement "
        f"{e['max_disp']:.3e}) velocity error {vel_err:.3e} (limit "
        f"{RING_VEL_TOL * e['max_v']:.3e} of {e['max_v']:.3e}) "
        f"launches {counts}")
    log(f"{RING_TAG} main path: {ring_s / RING_STEPS * 1e3:.3f} ms per "
        f"advection step on the ring, {single_s / RING_STEPS * 1e3:.3f} ms on "
        f"one device (wall clock, {RING_STEPS} steps each)")

    ring_kernel_checks(torch, scene, probes, results)
    probes.clear()

    # the refresh check: the same ring and steps from the noisy start
    noisy = perturbed(fluid, RING_DX)
    sim_n = sc.init_sim(scene, noisy)
    h_n = bd.distribute_block_engine(scene.eng, noisy, ring)
    for _ in range(RING_STEPS):
        sim_n, h_n = step_s(sim_n), step_d(h_n)
    tag = f"{RING_TAG} noisy start"
    en = ring_match(tag, h_n, sim_n, sc.blocks_to_particles(scene, sim_n),
                    noisy, n)
    check(en["pos_err"] <= RING_NOISY_DISP_TOL * en["max_disp"],
          f"{tag}: position error {en['pos_err']:.3e} > {RING_NOISY_DISP_TOL}"
          f" x the largest displacement {en['max_disp']:.3e}")
    check(en["vel_err"] <= RING_NOISY_VEL_TOL * en["max_v"],
          f"{tag}: velocity error {en['vel_err']:.3e} > {RING_NOISY_VEL_TOL} "
          f"x the largest component {en['max_v']:.3e}")
    log(f"{tag}: n_ac={h_n.n_ac} t={float(h_n.time)!r}, position error "
        f"{en['pos_err']:.3e} (limit "
        f"{RING_NOISY_DISP_TOL * en['max_disp']:.3e} of the largest "
        f"displacement {en['max_disp']:.3e}), velocity error "
        f"{en['vel_err']:.3e} (limit {RING_NOISY_VEL_TOL * en['max_v']:.3e} "
        f"of {en['max_v']:.3e})")
    del sim_n, h_n, noisy
    probes.clear()

    dev_d, wall_d, plain_d, launches_d = profile_step(
        torch, RING_TAG, lambda: step_d(h), trace=False)
    dev_s, wall_s_, plain_s, launches_s = profile_step(
        torch, f"{RING_TAG}_single", lambda: step_s(sim), trace=False)
    results[f"_{RING_TAG}"] = dict(
        n_fluid=n, ranks=RING_RANKS, n_adv=h.n_adv, n_ac=h.n_ac,
        position_error=pos_err, velocity_error=vel_err,
        max_displacement=e["max_disp"], max_velocity=e["max_v"],
        noisy=en,
        ms_per_adv=ring_s / RING_STEPS * 1e3,
        single_ms_per_adv=single_s / RING_STEPS * 1e3,
        step_wall_ms=plain_d / 1e3, step_device_ms=dev_d / 1e3,
        step_launches=launches_d, step_idle=1 - dev_d / plain_d,
        single_step_wall_ms=plain_s / 1e3, single_step_device_ms=dev_s / 1e3,
        single_step_launches=launches_s, single_step_idle=1 - dev_s / plain_s,
        launches=counts)


def _to(torch, tree, device, dtype):
    """Tensors of a state dict / named tuple to (device, dtype): floating
    ones to dtype, the others moved."""
    if torch.is_tensor(tree):
        return tree.to(device=device, dtype=dtype) \
            if tree.is_floating_point() else tree.to(device)
    if isinstance(tree, dict):
        return {k: _to(torch, v, device, dtype) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_to(torch, v, device, dtype) for v in tree))
    return tree


def card_vs_cpu(torch, what, fn):
    """fn(device, dtype) -> {name: tensor}, run in float64 and float32 on
    the CPU and float32 on the card: each output on the card within
    CALLER_FREE_FACTOR x the CPU's float32 error from float64 (at least
    F32_EPS of max|ref|).  Returns {name: (card error, CPU f32 error)}."""
    ref = fn("cpu", torch.float64)
    cpu32 = fn("cpu", torch.float32)
    card = fn(DEVICE, torch.float32)
    out = {}
    for k, r in ref.items():
        r = r.double()
        scale = float(r.abs().max())
        e32 = float((cpu32[k].double() - r).abs().max())
        ec = float((card[k].detach().double().cpu() - r).abs().max())
        limit = max(CALLER_FREE_FACTOR * e32, F32_EPS * scale)
        log(f"caller-free {what} {k}: max|ref| {scale:.6e}, card f32 "
            f"{ec:.3e}, CPU f32 {e32:.3e} (limit {limit:.3e})")
        check(bool(torch.isfinite(card[k]).all()), f"{what} {k}: non-finite")
        check(ec <= limit, f"caller-free {what} {k}: card error {ec:.3e} > "
              f"{limit:.3e}")
        out[k] = (ec, e32)
    return out


def _frozen_block(torch, nx, ny, dx=0.05):
    """tests/test_porous.py's block: positions, and its frozen pairs and
    B in float64 on the CPU."""
    import numpy as np

    from sphinxsys_tpu_torch.core.adaptation import SPHAdaptation
    from sphinxsys_tpu_torch.neighbors.cell_list import (
        build_cell_table, grid_from_bounds)
    from sphinxsys_tpu_torch.neighbors.neighbor_list import build_neighbor_list
    from sphinxsys_tpu_torch.physics import solid as sd

    xs, ys = (np.arange(nx) + 0.5) * dx, (np.arange(ny) + 0.5) * dx
    pos = np.stack(np.meshgrid(xs, ys, indexing="ij"), -1).reshape(-1, 2)
    n = len(pos)
    ad = SPHAdaptation(spacing=dx, dim=2)
    grid = grid_from_bounds((-0.2, -0.2), (nx * dx + 0.2, ny * dx + 0.2),
                            ad.cutoff)
    p = torch.as_tensor(pos)
    nl = build_neighbor_list(p, n, p, n, build_cell_table(p, n, grid, 24),
                             grid, ad.cutoff, k_max=32, include_self=False)
    rp = sd.freeze_reference_pairs(p, nl, ad.kernel, 2)
    return pos, ad, rp, sd.linear_gradient_correction_matrix(
        rp, torch.full((n,), dx * dx, dtype=torch.float64))


def caller_free_checks(torch, results):
    """The modules with no case caller, once each on the card against their
    float64 results on the CPU (`card_vs_cpu`): the porous solid's stress
    and saturation steps, the optimisation's gradient through the
    relaxation, the image shape's SDF and normals, the PK2 lattice first
    half."""
    import numpy as np

    from sphinxsys_tpu_torch.core import image as im
    from sphinxsys_tpu_torch.core.adaptation import SPHAdaptation
    from sphinxsys_tpu_torch.core.materials import NeoHookeanSolid
    from sphinxsys_tpu_torch.neighbors.cell_list import (
        build_cell_table, grid_from_bounds)
    from sphinxsys_tpu_torch.neighbors.neighbor_list import build_neighbor_list
    from sphinxsys_tpu_torch.physics import optimization as op
    from sphinxsys_tpu_torch.physics import porous as pm
    from sphinxsys_tpu_torch.physics import solid_lattice as sl

    t0 = time.perf_counter()
    mat = pm.PorousMediaSolid(rho0=2.0, youngs_modulus=8.242e6,
                              poisson_ratio=0.26316, diffusivity_constant=1e-4,
                              fluid_initial_density=1.0,
                              water_pressure_constant=3.0e6)
    blocks = {"swell": _frozen_block(torch, 12, 12),
              "spread": _frozen_block(torch, 20, 8)}

    def porous(device, dtype):
        out = {}
        for tag, (pos, ad, rp, B) in blocks.items():
            st = pm.make_porous_state(pos, 0.05 ** 2, mat, torch.float64, "cpu")
            st["LinearGradientCorrectionMatrix"] = B
            part = (np.ones(len(pos), bool) if tag == "swell" else
                    (pos[:, 0] > 0.3) & (pos[:, 0] < 0.7))
            st = pm.set_initial_saturation(st, torch.as_tensor(part),
                                           0.05 if tag == "swell" else 0.4, mat)
            st, rpd = _to(torch, st, device, dtype), _to(torch, rp, device, dtype)
            if tag == "swell":
                dt = torch.tensor(0.1 * ad.h / mat.sound_speed, dtype=dtype,
                                  device=device)
                for _ in range(20):
                    st = pm.porous_stress_relaxation_1st_half(
                        st, rpd, mat, dt, ad.h, ad.kernel.w0(2))
                    st = pm.porous_stress_relaxation_2nd_half(st, rpd, mat, dt)
                out.update({"F": st["DeformationGradient"],
                            "momentum": st["TotalMomentum"]})
            else:
                Dt = torch.tensor(pm.saturation_time_step(mat, ad.h, 2),
                                  dtype=dtype, device=device)
                for _ in range(20):
                    st = pm.saturation_relaxation(st, rpd, mat, Dt)
                out["saturation"] = st["FluidSaturation"]
        return out

    dxo = 0.0625
    xs = (np.arange(16) + 0.5) * dxo
    opos = np.stack(np.meshgrid(xs, xs, indexing="ij"), -1).reshape(-1, 2)
    oad = SPHAdaptation(spacing=dxo, dim=2)
    ogrid = grid_from_bounds((0, 0), (1, 1), oad.cutoff)
    op64 = torch.as_tensor(opos)
    onl = build_neighbor_list(op64, 256, op64, 256,
                              build_cell_table(op64, 256, ogrid, 32), ogrid,
                              oad.cutoff, k_max=48, include_self=False)

    def gradient(device, dtype):
        p = op64.to(device=device, dtype=dtype)
        nl = _to(torch, onl, device, dtype)
        dirichlet = (p[:, 0] < 0.08) | (p[:, 0] > 0.92)
        values = (p[:, 0] < 0.08).to(dtype)
        x = (0.3 * torch.sin(7.0 * p[:, 1])).requires_grad_(True)
        T = op.solve_steady_temperature(
            torch.exp(x), p, torch.full_like(p[:, 0], dxo * dxo), nl,
            oad.kernel, 2, dirichlet, values, torch.zeros_like(p[:, 0]),
            1e-4, 50)
        loss = torch.mean((T - (1.0 - p[:, 0])) ** 2)
        (g,) = torch.autograd.grad(loss, x)
        return {"gradient": g, "temperature": T.detach()}

    img = im.sphere_distance_image(radius=20.0)
    pts = np.random.default_rng(0).uniform(-24.0, 24.0, (500, 3))

    def image(device, dtype):
        q = torch.as_tensor(pts).to(device=device, dtype=dtype)
        surf = q / torch.linalg.vector_norm(q, dim=1, keepdim=True) * 20.0
        return {"sdf": img.signed_distance(q),
                "normal": img.find_normal_direction(surf)}

    shape, dxl = (14, 6, 6), 0.1
    lpos = np.stack(np.meshgrid(*(np.arange(k) * dxl for k in shape),
                                indexing="ij"), -1).reshape(-1, 3)
    lvalid = ~((lpos[:, 0] > 0.55) & (lpos[:, 0] < 0.95) & (lpos[:, 1] > 0.25))
    lad = SPHAdaptation(spacing=dxl, dim=3)
    lat = sl.make_lattice(lad.kernel, dxl, shape)
    lB = sl.lattice_correction_matrix(lat, torch.as_tensor(lvalid),
                                      torch.float64)
    ln = len(lpos)
    lstate = {
        "Position": lpos, "LinearGradientCorrectionMatrix": lB.numpy(),
        "Velocity": np.stack([0.3 * np.sin(2 * lpos[:, 1]),
                              0.2 * np.cos(3 * lpos[:, 0]) * lpos[:, 2],
                              0.1 * lpos[:, 0] * lpos[:, 1]], -1),
        "DeformationGradient": np.eye(3)[None] + 0.02 * np.stack(
            [np.sin(lpos * 1.7), np.cos(lpos * 1.1), np.sin(lpos * 0.7 + 1.0)],
            -2),
        "DeformationRate": 0.01 * np.sin(lpos)[..., None] * np.eye(3),
        "Mass": np.full(ln, 1100.0 * dxl ** 3),
        "ForcePrior": 1e-2 * np.sin(lpos)}
    lmat = NeoHookeanSolid(rho0=1100.0, youngs_modulus=1.7e7,
                           poisson_ratio=0.45)

    def lattice(device, dtype):
        st = _to(torch, {k: torch.as_tensor(v) for k, v in lstate.items()},
                 device, dtype)
        st["LatticeValid"] = torch.as_tensor(lvalid, device=device)
        out = sl.integration_1st_half_pk2_lattice(
            st, lat, lmat, torch.tensor(1e-5, dtype=dtype, device=device),
            lad.h)
        return {"force": out["Force"], "velocity": out["Velocity"],
                "stress": out["StressPK1OnParticle"]}

    errs = {}
    for what, fn in (("porous", porous), ("optimization", gradient),
                     ("image", image), ("pk2 lattice", lattice)):
        errs[what] = card_vs_cpu(torch, what, fn)
    log(f"caller-free checks: {time.perf_counter() - t0:.1f} s")
    results["_caller_free"] = errs


def ring_phase(torch, results):
    """Phase 24: the block engine on a ring of ranks at full width, B1-B3
    on a rank's slab, and the modules with no case caller on the card."""
    t0 = time.perf_counter()
    ring_path(torch, results)
    torch.cuda.empty_cache()
    caller_free_checks(torch, results)
    log(f"ring phase: {time.perf_counter() - t0:.1f} s")


def main() -> int:
    t_start = time.perf_counter()
    if not (ROOT / "sphinxsys_tpu_torch").is_dir():
        log("FAIL: the sphinxsys_tpu_torch package is not beside this script")
        return 1
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        log("FAIL: torch.cuda.is_available() is False")
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    print(smi, flush=True)

    from sphinxsys_tpu_torch.benchmarks import perturbed
    from sphinxsys_tpu_torch.engine import scene as sc
    from sphinxsys_tpu_torch.ops import _build

    libs, build_log, build_s = _build.build()
    log(f"build: {', '.join(so.name for so in libs)} in {build_s:.1f} s")
    for line in build_log.splitlines():
        if "registers" in line or "Compiling entry" in line or "spill" in line:
            log(f"ptxas: {line.strip()}")
    _build.library()

    results = {}
    for tag, cfg in CONFIGS.items():
        db = importlib.import_module(f"sphinxsys_tpu_torch.cases.{cfg['module']}")
        scene, fluid = db.build_block_case(dx=cfg["dx"], device=DEVICE, **cfg["kw"])
        if cfg["noise"]:
            fluid = perturbed(fluid, cfg["dx"])
        sim = sc.make_advection_step(scene)(sc.init_sim(scene, fluid))
        compare_kernels(torch, tag, cfg, scene, sim, results)
        if scene.wall_b is not None:
            moving_wall_check(torch, tag, scene, sim)
            padding_checks(torch, tag, scene, sim,
                           torch.Generator(device=DEVICE).manual_seed(13))
        else:
            tg_dissipative_ac2_check(torch, scene, sim)
        del scene, fluid, sim
        torch.cuda.empty_cache()
    cap40_check(torch)
    small_reference_check(torch, "dambreak_2d", 0.1, 0.08)
    small_reference_check(torch, "taylor_green_2d", 0.05, 0.08)
    tg_decay_check(torch)

    for tag, cfg in CONFIGS.items():
        scene, sim = run_main_path(torch, tag, cfg, results)
        step = sc.make_advection_step(scene)
        profile_step(torch, tag, lambda: step(sim))
        del scene, sim, step
        torch.cuda.empty_cache()
    fsi2_phase(torch, results)
    packed_phase(torch, results)
    solid_phase(torch, results)
    gather_phase(torch, results)
    io_phase(torch, results)
    open_boundary_phase(torch, results)
    a7_phase(torch, results)
    a7bc_phase(torch, results)
    a7d_phase(torch, results)
    a7e_phase(torch, results)
    a7f_phase(torch, results)
    a7g_phase(torch, results)
    a7h_phase(torch, results)
    a7i_phase(torch, results)
    a7j_phase(torch, results)
    a7k_phase(torch, results)
    ring_phase(torch, results)

    kernels = []
    for tag, names in [*((t, c["kernels"]) for t, c in CONFIGS.items()),
                       ("fsi2", tuple(KERNELS)), (RING_TAG, DAMBREAK_KERNELS)]:
        for name in names:
            r = results[f"{name}[{tag}]"]
            kernels.append({"name": f"{name}[{tag}]", "route": "cuda",
                            "source": SOURCE, "replaces": KERNELS[name][0],
                            "launches": r["launches"],
                            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                            "bound_by": r["bound_by"], "library_ms": None})
    for table, source, tag in ((PACKED_KERNELS, PACKED_SOURCE, "2d16"),
                               (LAYOUT_KERNELS, LAYOUT_SOURCE, "2d16"),
                               (LATTICE_KERNELS, LATTICE_SOURCE, "tc1m")):
        for name, (replaces, _) in table.items():
            r = results[f"{name}[{tag}]"]
            kernels.append({"name": f"{name}[{tag}]", "route": "cuda",
                            "source": source, "replaces": replaces,
                            "launches": r["launches"],
                            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                            "plain_ms": r["plain_ms"],
                            "bound_ms": r["bound_ms"],
                            "bound_by": r["bound_by"],
                            "library_ms": r.get("library_ms")})
    main_paths = {tag: results[f"_{tag}_main"]
                  for tag in (*CONFIGS, "fsi2", "2d16", "2d16_b2b3", "layout",
                              "tc1m", "tc1m_plain")}
    main_paths["tc_gather"] = results["_tc_gather"]
    for tag in (*GATHER_CONFIGS, "tg", "fsi2"):
        main_paths[f"gather_{tag}"] = results[f"_gather_{tag}"]
    for tag in ("io", "ball_shell", "dambreak_golden", "ob_fish",
                "ob_t_pipe", "a7_play_simbody", "a7_tether",
                *(f"a7_{name}" for name in A7_MAIN),
                *(f"a7bc_{name}" for name in A7BC_MAIN),
                *(f"a7d_{name}" for name in A7D_MAIN),
                *(f"a7e_{name}" for name in A7E_MAIN), "a7e_cg",
                *(f"a7f_{name}" for name in A7F_MAIN),
                *(f"a7g_{name}" for name in A7G_MAIN),
                "a7g_vp_heat_flux_2d",
                *(f"a7h_{name}" for name in A7H_MAIN), "a7h_gate",
                "a7h_cvt", *(f"a7i_{name}" for name in A7I_MAIN),
                *(f"a7j_{name}" for name in A7J_MAIN),
                *(f"a7k_{name}" for name in (*A7K_MAIN, *A7K_RELAX)),
                RING_TAG):
        main_paths[tag] = results[f"_{tag}"]
    log("main paths: " + json.dumps(main_paths))
    lost = sorted({PROFILE_GUARD - p[4] for p in PROFILED})
    log(f"profiler: {len(PROFILED)} profiled steps, "
        f"{sum(not p[3] for p in PROFILED)} whose markers did not hold after "
        f"3 attempts, {sum(p[2] > 1 for p in PROFILED)} profiled again; "
        f"leading markers lost: {lost}; "
        f"{[p for p in PROFILED if p[2] > 1 or p[4] < PROFILE_GUARD]}")
    log(f"all phases: {time.perf_counter() - t_start:.1f} s, the build "
        f"{build_s:.1f} s of it")
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        log(f"FAIL: {exc}")
        sys.exit(1)
