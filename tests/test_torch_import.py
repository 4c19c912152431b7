"""The port stands alone: importing it pulls in neither JAX nor flax, builds
no kernel and no native library, creates no process group, and
chip_smoke.py refuses to run without a GPU."""
import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
MODULES = ["hygrid_tpu_torch", "hygrid_tpu_torch.kernels.resample",
           "hygrid_tpu_torch.kernels.conv_stack",
           "hygrid_tpu_torch.kernels._build", "hygrid_tpu_torch.utils.params",
           "hygrid_tpu_torch.models.train",
           "hygrid_tpu_torch.kernels.resample_shift",
           "hygrid_tpu_torch.nn.filters", "hygrid_tpu_torch.models.video",
           "hygrid_tpu_torch.viz", "hygrid_tpu_torch.viz.render",
           "hygrid_tpu_torch.kernels.conv_single",
           "hygrid_tpu_torch.nn.layers", "hygrid_tpu_torch.nn.modules",
           "hygrid_tpu_torch.models.hexcnn", "hygrid_tpu_torch.ops.convert",
           "hygrid_tpu_torch.nn.experimental",
           "hygrid_tpu_torch.models.hexunet", "hygrid_tpu_torch.image",
           "hygrid_tpu_torch.image.window", "hygrid_tpu_torch.viz.pixelart",
           "hygrid_tpu_torch.ops.tiled", "hygrid_tpu_torch.ops.pad",
           "hygrid_tpu_torch.ops.hexrot", "hygrid_tpu_torch.ops.augment",
           "hygrid_tpu_torch.utils.native_loader",
           "hygrid_tpu_torch.parallel", "hygrid_tpu_torch.parallel.mesh",
           "hygrid_tpu_torch.parallel.distributed",
           "hygrid_tpu_torch.parallel.spatial",
           "hygrid_tpu_torch.parallel.pipeline",
           "hygrid_tpu_torch.utils.checkpoint",
           "hygrid_tpu_torch.utils.profiling", "hygrid_tpu_torch.utils.export",
           "hygrid_tpu_torch.compat",
           "hygrid_tpu_torch.HexFrames", "hygrid_tpu_torch.HexModules",
           "hygrid_tpu_torch.HexImage", "hygrid_tpu_torch.Image",
           "hygrid_tpu_torch.geometry", "hygrid_tpu_torch.geometry_np",
           "hygrid_tpu_torch.geometry_torch", "hygrid_tpu_torch.HexPixelArt",
           "hygrid_tpu_torch.HexPixelArt.hexagon_mosaic_shader",
           "hygrid_tpu_torch.HexPixelArt.texture",
           "hygrid_tpu_torch.HexPixelArt.window"]


def _run(code, cwd=ROOT):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_import_pulls_in_no_jax_and_builds_nothing():
    code = ("import sys, importlib\n"
            f"for m in {MODULES!r}: importlib.import_module(m)\n"
            "from hygrid_tpu_torch.kernels import _build\n"
            "bad = [m for m in ('jax', 'flax', 'triton', 'hygrid_tpu') "
            "if m in sys.modules]\n"
            "assert not bad, bad\n"
            "assert _build._lib is None\n"
            "from hygrid_tpu_torch.utils import native_loader\n"
            "assert not native_loader._lib_tried\n")
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in [*ROOT.glob("hygrid_tpu_torch/**/*.py"),
                                       ROOT / "chip_smoke.py"]))
def test_sources_import_no_jax(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in ("jax", "flax", "hygrid_tpu"), \
                f"{path} imports {name}"


def test_import_creates_no_process_group():
    """Importing the package (``parallel`` included) initialises no
    ``torch.distributed`` group and builds nothing."""
    code = ("import hygrid_tpu_torch, torch.distributed as dist\n"
            "from hygrid_tpu_torch import parallel\n"
            "from hygrid_tpu_torch.kernels import _build\n"
            "assert not dist.is_initialized()\n"
            "assert _build._lib is None\n")
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr


def test_chip_smoke_fails_without_gpu(tmp_path):
    """Here there is no CUDA device: the script exits non-zero and prints
    no result, in the checkout and alone in an empty directory."""
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"),
                        (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd == tmp_path:
            script.write_text((ROOT / "chip_smoke.py").read_text())
        proc = subprocess.run([sys.executable, str(script)], cwd=cwd,
                              capture_output=True, text=True, timeout=120,
                              env=dict(os.environ, PYTHONPATH=""))
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in ROOT.glob("hygrid_tpu_torch/csrc/*.cu")))
def test_c_entry_points_match_the_loader(path):
    """Every extern "C" function of a CUDA source is declared to ctypes in
    kernels/_build.py with as many arguments as it takes (a missing or
    short declaration would pass pointers as 32-bit ints)."""
    from hygrid_tpu_torch.kernels import _build
    src = (ROOT / path).read_text()
    entries = re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src)
    assert entries, f"{path} has no extern \"C\" entry point"
    for name, params in entries:
        assert name in _build._SIGNATURES, name
        assert len(_build._SIGNATURES[name]) == len(params.split(",")), name
