"""The port imports no JAX: every module of shwd_torch, its tools (the
registration-row harness among them), the examples written for it,
chip_smoke.py, and the helper that the parallel tests' spawned processes
import."""

import torch_cpu  # noqa: F401  (first: one intra-op thread)

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "optax", "flax", "shwd_tpu"}
FILES = (sorted((ROOT / "shwd_torch").rglob("*.py"))
         + sorted((ROOT / "tools").glob("*.py"))
         + sorted((ROOT / "examples").glob("*_torch.py"))
         + [ROOT / "chip_smoke.py", ROOT / "tests" / "torch_dist.py"])


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_every_module_is_checked():
    names = {p.name for p in FILES}
    assert {"chip_smoke.py", "auction.py", "sinkhorn_kernels.py",
            "flow_driver.py", "shwd.py"} <= names
    assert {"sinkhorn_fused.py", "chamfer.py", "quaternion.py", "pcrnet.py",
            "pointnet.py", "synthetic.py", "modelnet.py", "transforms.py",
            "dataset.py", "trainer.py", "config.py", "checkpoint.py",
            "baselines.py", "profile_torch_train.py"} <= names
    assert {"ot1d.py", "spherical.py", "chart.py", "planar.py", "actnorm.py",
            "pseudo.py", "ssw_loss.py", "evaluate.py"} <= names
    assert {"sliced_zoo.py", "pose_refine.py", "comparison.py", "flops.py",
            "profiling.py"} <= names
    assert {"runner.py", "hpo.py", "mesh.py", "sharded_ops.py", "dist_sort.py",
            "scaling.py", "flow_cube_torch.py", "train_registration_torch.py",
            "metric_sweep_torch.py", "torch_dist.py"} <= names
    assert "registration_rows_torch.py" in names
    dirs = {p.parent.name for p in FILES}
    assert {"models", "data", "train", "ops", "losses", "utils", "flows",
            "parallel", "examples"} <= dirs
