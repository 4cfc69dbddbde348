"""The port's case runner, `python -m sphinxsys_tpu_torch.run`, held to the
JAX package's `python -m sphinxsys_tpu.run`, on the CPU:

* JAX's `run.main` against the port's (`--set device=cpu`) at dx = 0.1,
  float32, for dambreak_2d (the gather route), dambreak_2d_block (the
  block engine) and twisting_column_3d (gather and lattice engines): the
  same file names, the same log lines' times and frame counts, and every
  VTP array (points and point data, NumberOfPoints rows) within 2e-5 of
  its scale: max|JAX| of the frame for positions, density and the
  column's velocity; for the dambreak's velocity the run's largest speed
  over its frames, and for its pressure rho0 c0^2 = 400.  Both spreads
  are set by the density's float32 roundoff through p = c0^2 (rho - rho0)
  (a density change of 1e-6 moves the pressure by 4e-4), not by the
  frame's own values: on the CPU the velocity differs by 4.9e-6 at
  t = 0.1, where max|v| is 0.195 (2.5e-5 of it), and by 5.7e-6 at
  t = 0.3 (max|v| 0.512); the pressure by 2.4e-4.  The pressure is held
  through the density, at 2e-5 of its max, as well;
* the exit codes of `list`, an unknown case, bad parameters and a flag
  for an unported path, and the default device (the card) raising on a
  machine without one;
* the module run as a subprocess, as a user runs it.
"""

import logging
import os
import re
import subprocess
import sys
import xml.etree.ElementTree as ET

import numpy as np
import pytest
import torch

from sphinxsys_tpu import run as jrun
from sphinxsys_tpu_torch import run as trun

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 2e-5
RUN_MAX = None      # scale: the array's largest |value| over the run's frames
# the dambreak's pressure scale, rho0 c0^2 (sphinxsys_tpu_torch/cases/
# dambreak_2d.py), and its speed scale
DAMBREAK_SCALES = {"Pressure": 400.0, "Velocity": RUN_MAX}


def read_vtp(path):
    """(NumberOfPoints, {"Points": (n, 3), name: (n,) or (n, 3)})."""
    piece = ET.parse(path).getroot()[0][0]
    n = int(piece.attrib["NumberOfPoints"])
    arrays = {}
    for parent, key in (("Points", None), ("PointData", "Name")):
        for da in piece.find(parent):
            vals = np.asarray(da.text.split(), dtype=np.float64)
            comps = int(da.attrib.get("NumberOfComponents", 1))
            name = da.attrib[key] if key else "Points"
            arrays[name] = vals.reshape(n, comps) if comps > 1 else vals
    return n, arrays


def _times(records, logger):
    return [re.match(r"t=(\S+)", r.getMessage()).group(1) for r in records
            if r.name == logger and r.getMessage().startswith("t=")]


def _run_both(tmp_path, caplog, case, params):
    sets = [x for kv in params for x in ("--set", kv)]
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    with caplog.at_level(logging.INFO):
        assert jrun.main([case, *sets, "--output_dir", jdir]) == 0
        assert trun.main([case, *sets, "--set", "device=cpu",
                          "--output_dir", tdir]) == 0
    jt = _times(caplog.records, "sphinxsys_tpu.run")
    tt = _times(caplog.records, "sphinxsys_tpu_torch.run")
    assert tt == jt and len(tt) >= 2
    return jdir, tdir


def _hold_outputs(jdir, tdir, scales=None):
    names = sorted(os.listdir(jdir))
    assert names == sorted(os.listdir(tdir)) and names
    frames = {name: (read_vtp(os.path.join(jdir, name)),
                     read_vtp(os.path.join(tdir, name))) for name in names}
    run_max = {}
    for name, ((_, ja), _) in frames.items():
        body = name.rsplit("_", 1)[0]
        for k, ref in ja.items():
            run_max[body, k] = max(run_max.get((body, k), 0.0),
                                   np.abs(ref).max())
    for name, ((jn, ja), (tn, ta)) in frames.items():
        assert tn == jn and tn > 0 and sorted(ta) == sorted(ja), name
        for k, ref in ja.items():
            err = np.abs(ta[k] - ref).max()
            scale = (scales or {}).get(k, np.abs(ref).max())
            if scale is RUN_MAX:
                scale = run_max[name.rsplit("_", 1)[0], k]
            assert err <= TOL * max(scale, 1e-30), (name, k, err)
    return names


def test_dambreak_2d_matches_jax_cli(tmp_path, caplog):
    jdir, tdir = _run_both(tmp_path, caplog, "dambreak_2d",
                           ["dx=0.1", "t_end=0.3", "n_output=3"])
    names = _hold_outputs(jdir, tdir, DAMBREAK_SCALES)
    assert names == [f"{b}_{i:06d}.vtp" for b in ("Wall", "WaterBody")
                     for i in (1, 2, 3)]
    n, arrays = read_vtp(os.path.join(tdir, "WaterBody_000003.vtp"))
    assert n == 200 and sorted(arrays) == ["Density", "Points", "Pressure",
                                           "Velocity"]


def test_dambreak_2d_block_matches_jax_cli(tmp_path, caplog):
    jdir, tdir = _run_both(tmp_path, caplog, "dambreak_2d_block",
                           ["dx=0.1", "t_end=0.2", "n_output=2"])
    names = _hold_outputs(jdir, tdir, DAMBREAK_SCALES)
    assert "WaterBody_000002.vtp" in names and "Wall_000001.vtp" in names


@pytest.mark.parametrize("engine", ["gather", "lattice"])
def test_twisting_column_matches_jax_cli(tmp_path, caplog, engine):
    jdir, tdir = _run_both(tmp_path, caplog, "twisting_column_3d",
                           ["dx=0.1", "t_end=0.004", "n_output=2",
                            f"engine={engine}"])
    names = _hold_outputs(jdir, tdir)
    assert names == ["Column_000001.vtp", "Column_000002.vtp"]
    n, _ = read_vtp(os.path.join(tdir, names[-1]))
    assert n == 61 * 10 * 10


def test_cli_lists_cases(capsys):
    assert trun.main([]) == 0 and trun.main(["list"]) == 0
    out = capsys.readouterr().out
    for case in ("dambreak_2d", "dambreak_3d_block", "twisting_column_3d",
                 "ball_shell_collision_3d", "fsi2_block", "t_pipe_2d",
                 "fish_undulation_2d", "fish_fsi_2d", "play_simbody_3d",
                 "tethered_fish_2d", "stlw_2d", "filling_tank_2d",
                 "elastic_gate_2d", "flow_around_cylinder_2d",
                 "standing_wave_2d", "poiseuille_flow_2d", "impact_patch_2d",
                 "rotation_patch_2d", "oscillating_beam_2d",
                 "oscillating_beam_cauchy_2d", "self_contact_2d",
                 "passive_cantilever_3d", "muscle_activation_3d",
                 "anisotropic_beam_2d", "two_phase_dambreak_2d",
                 "square_droplet_2d", "droplet_impact_2d",
                 "cubic_droplet_3d", "floating_body_2d", "stfb_2d",
                 "owsc_2d", "nonlinear_wave_fsi_2d", "collision_2d",
                 "sliding_2d", "passive_cantilever_neohookean_3d",
                 "stretching_2d", "muscle_solid_contact_3d",
                 "twisting_rigid_elastic_bar_3d", "slender_beam_3d",
                 "column_collapse_2d", "cohesive_soil_failure_2d",
                 "repose_angle_3d", "oscillating_beam_ul_2d",
                 "spinning_plate_2d", "taylor_bar_ul_3d",
                 "lid_driven_cavity_2d", "throat_2d", "channel_windkessel_2d",
                 "pulsatile_poiseuille_2d", "vp_heat_flux_2d",
                 "diffusion_bcs_2d", "heat_transfer_2d",
                 "windows_frame_diffusion_2d", "depolarization_2d",
                 "shell_cantilever_2d", "shell_plate_3d", "roof_3d",
                 "shell_stability_half_sphere_3d", "solid_shell_coupling_3d",
                 "hydrostatic_fsi_2d", "poiseuille_flow_shell_3d",
                 "three_ring_impact_2d", "water_entry_exit_2d",
                 "pkj_lv_electrocontraction_3d", "heart_electromechanics_3d",
                 "eulerian_taylor_green_2d", "fvm_cylinder_2d",
                 "supersonic_cylinder_2d", "double_mach_reflection_2d",
                 "fvm_channel_3d", "taylor_green_mr_2d",
                 "mr_cantilever_beam_2d", "mr_cylinder_2d",
                 "static_confinement_2d", "implicit_relaxation_2d",
                 "shell_relaxation_2d", "turbulent_channel_2d"):
        assert case in out


def test_cli_cases_are_jax_entries():
    """Every entry is one of the JAX runner's, named alike, and every one
    of the JAX runner's 82 entries is the port's."""
    assert set(trun.CASES) == set(jrun.CASES)
    assert len(trun.CASES) == 82


@pytest.mark.parametrize("case", ["nope", "turbulent_channel_3d"])
def test_cli_rejects_unknown_case(case, capsys):
    assert trun.main([case]) == 2
    assert f"unknown case '{case}'" in capsys.readouterr().out


def test_cli_rejects_bad_parameters(tmp_path, capsys):
    assert trun.main(["dambreak_2d", "--set", "bogus=1", "--set",
                      "device=cpu", "--output_dir", str(tmp_path)]) == 2
    assert "bad case parameters for 'dambreak_2d'" in capsys.readouterr().out
    assert not os.listdir(tmp_path)


def test_cli_defaults_to_the_card(tmp_path):
    """Without `--set device=cpu` a case asks for the card: on a machine
    without one, the case's resolve_device raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        trun.main(["dambreak_2d", "--set", "dx=0.1", "--output_dir",
                   str(tmp_path)])


@pytest.mark.parametrize("flag", [["--restart_step", "3"], ["--relax"]])
def test_cli_rejects_unported_flags(tmp_path, flag):
    """A flag for a path the port has not got exits with code 2 before
    anything runs."""
    with pytest.raises(SystemExit) as e:
        trun.main(["dambreak_2d", *flag, "--set", "device=cpu",
                   "--output_dir", str(tmp_path / "out")])
    assert e.value.code == 2 and not (tmp_path / "out").exists()


def test_cli_no_state_recording_writes_nothing(tmp_path):
    out = tmp_path / "out"
    assert trun.main(["twisting_column_3d", "--set", "dx=0.1", "--set",
                      "t_end=0.001", "--set", "n_output=1", "--set",
                      "device=cpu", "--no-state-recording", "--output_dir",
                      str(out)]) == 0
    assert not out.exists()


def test_cli_as_subprocess(tmp_path):
    out = tmp_path / "out"
    proc = subprocess.run(
        [sys.executable, "-m", "sphinxsys_tpu_torch.run", "dambreak_2d",
         "--set", "dx=0.1", "--set", "t_end=0.3", "--set", "n_output=3",
         "--set", "device=cpu", "--output_dir", str(out)],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": ROOT})
    assert proc.returncode == 0, proc.stderr
    assert "running dambreak_2d" in proc.stderr
    assert sorted(os.listdir(out)) == [f"{b}_{i:06d}.vtp"
                                       for b in ("Wall", "WaterBody")
                                       for i in (1, 2, 3)]
    assert read_vtp(str(out / "WaterBody_000003.vtp"))[0] == 200
