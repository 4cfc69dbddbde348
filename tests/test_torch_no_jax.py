"""The PyTorch port must not depend on JAX: no module under
sphinxsys_tpu_torch/ (and not chip_smoke.py) imports
jax or the JAX package sphinxsys_tpu.  The machine with the card has no JAX at all."""

import ast
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "sphinxsys_tpu_torch").rglob("*.py"))
FORBIDDEN = ("jax", "jaxlib", "sphinxsys_tpu")


def _imported_packages(path: Path):
    """Top-level package of every import in the file (relative imports
    resolve inside the port, so they are skipped)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_port_has_modules():
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    for must in ("sphinxsys_tpu_torch/ops/block_sweeps.py",
                 "sphinxsys_tpu_torch/ops/packed_sweeps.py",
                 "sphinxsys_tpu_torch/ops/layout_sweeps.py",
                 "sphinxsys_tpu_torch/benchmarks/exp_layout.py",
                 "sphinxsys_tpu_torch/benchmarks/exp_layout2.py",
                 "sphinxsys_tpu_torch/benchmarks/ab_sweeps.py",
                 "sphinxsys_tpu_torch/engine/scene.py",
                 "sphinxsys_tpu_torch/cases/dambreak_2d.py",
                 "sphinxsys_tpu_torch/cases/dambreak_3d.py",
                 "sphinxsys_tpu_torch/cases/taylor_green_2d.py",
                 "sphinxsys_tpu_torch/cases/fsi2.py",
                 "sphinxsys_tpu_torch/neighbors/neighbor_list.py",
                 "sphinxsys_tpu_torch/neighbors/cell_list.py",
                 "sphinxsys_tpu_torch/physics/fluid.py",
                 "sphinxsys_tpu_torch/physics/fsi.py",
                 "sphinxsys_tpu_torch/physics/relax.py"):
        assert must in names


@pytest.mark.parametrize("path", PORT_FILES + [ROOT / "chip_smoke.py"],
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_imports(path):
    # exact package match: "sphinxsys_tpu_torch" is allowed, "sphinxsys_tpu"
    # (the JAX package) is not
    bad = sorted(set(_imported_packages(path)) & set(FORBIDDEN))
    assert not bad, f"{path.name} imports {bad}"


def test_scan_catches_forbidden_import(tmp_path):
    """The scan itself: an import of the JAX package is found, the port's
    own package name (which has it as a prefix) is not."""
    f = tmp_path / "m.py"
    f.write_text("import sphinxsys_tpu_torch.core\nfrom sphinxsys_tpu.core import state\n")
    assert sorted(set(_imported_packages(f)) & set(FORBIDDEN)) == ["sphinxsys_tpu"]
