"""The port stands alone: no module of it -- the sampling slice's
included -- imports jax, PIL or the JAX package, and its entry points never
fall back to the CPU silently."""

import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

import chip_smoke
from rewriting_torch.models.stylegan2 import SeqStyleGAN2
from rewriting_torch.rewrite import SeqStyleGanRewriter
from rewriting_torch.utils.zdataset import z_dataset_for_model

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "rewriting_torch"
BLOCKED = ("jax", "jaxlib", "PIL", "rewriting_tpu")

_IMPORT_ALL = f"""
import sys
for name in {BLOCKED!r}:
    sys.modules[name] = None   # any import of these now raises ImportError
import importlib, pkgutil
import rewriting_torch
names = [m.name for m in pkgutil.walk_packages(rewriting_torch.__path__,
                                               "rewriting_torch.")]
for name in names:
    importlib.import_module(name)
loaded = sorted(n for n, m in sys.modules.items()
                if m is not None and n.split(".")[0] in {BLOCKED!r})
print(len(names), loaded)
print(" ".join(names))
"""

# the modules of the sampling slice, which the walk must reach
SLICE2 = ("ops.upconv_blur", "ops.upsample2x", "metrics.sample",
          "metrics.sample_edited", "metrics.load_mask", "utils.imgsave",
          "utils.workerpool", "utils.pidfile", "utils.pbar")


def test_every_module_imports_without_jax_pil_or_the_jax_package():
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    first, names = proc.stdout.splitlines()
    count, loaded = first.split(" ", 1)
    assert int(count) >= 29 and loaded.strip() == "[]"
    for name in SLICE2:
        assert f"rewriting_torch.{name}" in names.split(), name


def test_package_data_ships_the_sources_and_the_gallery():
    """The CUDA sources and the lightbox page the samplers copy are in the
    package, and pyproject.toml ships them."""
    text = (ROOT / "pyproject.toml").read_text()
    for pattern in ("csrc/*.cu", "utils/lightbox.html"):
        assert pattern in text
    for name in ("blur2d", "upconv_blur", "upsample2x"):
        assert (PORT / "csrc" / f"{name}.cu").is_file()
    assert (PORT / "utils" / "lightbox.html").is_file()


def test_no_source_names_the_jax_package():
    """No file of the port names the JAX package or imports jax or PIL."""
    imports = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|PIL|rewriting_tpu)"
                         r"\b", re.M)
    files = [p for p in PORT.rglob("*")
             if p.is_file() and p.suffix in (".py", ".cu", ".cuh", ".h")]
    assert len(files) >= 20
    for path in files:
        text = path.read_text()
        assert "rewriting_tpu" not in text, path
        assert not imports.search(text), path
        assert "__import__" not in text and "import_module" not in text, path


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("device", [None, "cuda"], ids=["default", "cuda"])
def test_entry_points_raise_without_cuda(no_cuda, device):
    kw = {} if device is None else {"device": device}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SeqStyleGAN2(8, style_dim=16, n_mlp=1, **kw)
    model = SeqStyleGAN2(8, style_dim=16, n_mlp=1, device="cpu")
    params = model.init_params(seed=0)
    assert params["input"]["input"].device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SeqStyleGanRewriter(model, params, z_dataset_for_model(model, 4),
                            layernum=2, **kw)


def test_chip_smoke_fails_without_cuda(no_cuda, capsys):
    """chip_smoke.py exits non-zero and prints no result without CUDA."""
    assert chip_smoke.main() != 0
    assert '"ok"' not in capsys.readouterr().out


def test_chip_smoke_fails_alone(tmp_path):
    """...and in a directory that holds chip_smoke.py and nothing else."""
    (tmp_path / "chip_smoke.py").write_text(
        (ROOT / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300,
                          env=env)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "No module named 'rewriting_torch'" in proc.stderr
