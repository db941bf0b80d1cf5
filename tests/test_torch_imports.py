"""The port stands alone: no module of it -- the sampling slice's
included -- imports jax or the JAX package, none imports PIL when it is
imported (``native`` alone imports it, inside the one function that hands
PIL the files the port's decoders do not read), and its entry points
never fall back to the CPU silently."""

import ast
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

import chip_smoke
from rewriting_torch.dissect import dissect
from rewriting_torch.metrics import (distances, fid, inception, load_seg,
                                     lpips, num_smiles, slimnet)
from rewriting_torch.models import ProgressiveGenerator, zoo
from rewriting_torch.models.stylegan2 import SeqStyleGAN2
from rewriting_torch.rewrite import ProgressiveGanRewriter, SeqStyleGanRewriter
from rewriting_torch.segment import UnifiedParsingSegmenter, load_segmenter
from rewriting_torch.segment.faceparse import BiSeNet, FaceSegmenter
from rewriting_torch.segment.semantic import SemanticSegmenter
from rewriting_torch.segment.upernet import UPerNet
from rewriting_torch.stats import RunningQuantile
from rewriting_torch.utils import paramio
from rewriting_torch.utils.zdataset import z_dataset_for_model

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "rewriting_torch"
BLOCKED = ("jax", "jaxlib", "PIL", "rewriting_tpu")
# imported only where a plot is drawn or a widget displayed
LAZY = ("matplotlib", "IPython")

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
                if m is not None and n.split(".")[0] in {BLOCKED + LAZY!r})
print(len(names), loaded)
print(" ".join(names))
"""

# the modules of the sampling slice and of slices 7, 8 and 9, which the
# walk must reach
SLICE2 = ("ops.upconv_blur", "ops.upsample2x", "metrics.sample",
          "metrics.sample_edited", "metrics.load_mask", "utils.imgsave",
          "utils.workerpool", "utils.pidfile", "utils.pbar")
SLICE7 = ("models.proggan", "rewrite.multi", "core.instrument",
          "metrics.watermark", "ops.grouped", "utils.paramio",
          "utils.easydict", "utils.profiling", "utils.show")
SLICE8 = ("stats.quantile", "stats.running", "stats.tally", "dissect",
          "utils.upsample", "metrics.lpips", "metrics.distances",
          "metrics.segio", "metrics.load_seg")
SLICE9 = ("native", "metrics.inception", "metrics.fid", "metrics.get_fid",
          "metrics.slimnet", "metrics.num_smiles", "segment", "segment.nn",
          "segment.prroi", "segment.resnet", "segment.upernet",
          "segment.segmenter", "segment.semantic", "segment.faceparse")
SLICE10 = ("serve", "metrics.seg_stats", "metrics.seg_correct_mod",
           "metrics.fused_pipeline", "metrics.experiments",
           "metrics.samples", "metrics.patch_fid", "metrics.plot_patch_fids",
           "utils.parallelfolder", "utils.sampler", "utils.segdata",
           "utils.segviz", "utils.hostshard", "ui", "ui.labwidget",
           "ui.paintwidget", "ui.rewriteapp")
SLICE11 = ("parallel", "parallel.comm", "parallel.mesh", "parallel.tensor",
           "parallel.pipeline", "parallel.dryrun")
SLICE12 = ("ops.quant", "ops.precision", "models.stylegan2",
           "models.proggan", "segment.semantic")
SLICE14 = ("baselines", "baselines.nbb", "baselines.nbbviz")


def test_every_module_imports_without_jax_pil_or_the_jax_package():
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    first, names = proc.stdout.splitlines()
    count, loaded = first.split(" ", 1)
    assert int(count) >= 29 and loaded.strip() == "[]"
    for name in (SLICE2 + SLICE7 + SLICE8 + SLICE9 + SLICE10 + SLICE11
                 + SLICE12 + SLICE14):
        assert f"rewriting_torch.{name}" in names.split(), name


def test_package_data_ships_the_sources_and_the_gallery():
    """The CUDA sources, the JPEG decoder's host source and the lightbox
    page the samplers copy are in the package, and pyproject.toml ships
    them."""
    text = (ROOT / "pyproject.toml").read_text()
    for pattern in ("csrc/*.cu", "csrc/*.cpp", "utils/lightbox.html"):
        assert pattern in text
    for name in ("blur2d", "upconv_blur", "upsample2x"):
        assert (PORT / "csrc" / f"{name}.cu").is_file()
    assert (PORT / "csrc" / "jpegdec.cpp").is_file()
    assert (PORT / "utils" / "lightbox.html").is_file()


NATIVE = PORT / "native" / "__init__.py"
# PIL's one import in the port: indented, so inside a function of NATIVE
LAZY_PIL = re.compile(r"^[ \t]+import PIL\.Image$", re.M)


def test_no_source_names_the_jax_package():
    """No file of the port names the JAX package or imports jax or PIL,
    but for ``native``'s one indented ``import PIL.Image``."""
    imports = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|PIL|rewriting_tpu)"
                         r"\b", re.M)
    files = [p for p in PORT.rglob("*")
             if p.is_file() and p.suffix in (".py", ".cu", ".cuh", ".h",
                                             ".cpp")]
    assert len(files) >= 20 and NATIVE in files
    for path in files:
        text = path.read_text()
        if path == NATIVE:
            assert len(LAZY_PIL.findall(text)) == 1
            text = LAZY_PIL.sub("", text)
        assert "rewriting_tpu" not in text, path
        assert not imports.search(text), path
        assert "__import__" not in text and "import_module" not in text, path


def test_native_imports_pil_inside_one_function():
    """``native`` has no top-level PIL import: its one import of PIL is in
    the body of ``_pil_decode``, run only for a file the port's decoders do
    not read."""
    def pil_imports(tree):
        return [node for node in ast.walk(tree)
                if isinstance(node, ast.Import) and any(
                    a.name.split(".")[0] == "PIL" for a in node.names)
                or isinstance(node, ast.ImportFrom)
                and (node.module or "").split(".")[0] == "PIL"]

    module = ast.parse(NATIVE.read_text())
    functions = {f.name: len(pil_imports(f)) for f in ast.walk(module)
                 if isinstance(f, (ast.FunctionDef, ast.AsyncFunctionDef))}
    assert {k: v for k, v in functions.items() if v} == {"_pil_decode": 1}
    assert len(pil_imports(module)) == 1    # none at the top level


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("device", [None, "cuda"], ids=["default", "cuda"])
def test_entry_points_raise_without_cuda(no_cuda, device, tmp_path):
    kw = {} if device is None else {"device": device}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SeqStyleGAN2(8, style_dim=16, n_mlp=1, **kw)
    model = SeqStyleGAN2(8, style_dim=16, n_mlp=1, device="cpu")
    params = model.init_params(seed=0)
    assert params["input"]["input"].device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SeqStyleGanRewriter(model, params, z_dataset_for_model(model, 4),
                            layernum=2, **kw)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ProgressiveGenerator(sizes=[8, 8, 4], **kw)
    pg = ProgressiveGenerator(sizes=[8, 8, 4], device="cpu")
    pg_params = pg.init_params(seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ProgressiveGanRewriter(pg, pg_params, z_dataset_for_model(pg, 4),
                               layernum=2, **kw)
    path = tmp_path / "proggan_churchoutdoor.pth"
    torch.save({f"{k}.{'weight' if 'conv' in k else 'b'}": v
                for k, sub in pg_params.items() for v in sub.values()}, path)
    assert zoo.load_proggan("church", path=str(path),
                            device="cpu")[0].sizes == [8, 8, 4]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        zoo.load_proggan("church", path=str(path), **kw)
    paramio.save_params(str(tmp_path / "p.npz"), pg_params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        paramio.load_params(str(tmp_path / "p.npz"), **kw)
    params = lpips.init_params(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lpips.LPIPS(params, **kw)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distances.PerceptualLoss(params=params, **kw)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dissect(pg, pg_params, "layer2", None, ["-"], str(tmp_path / "d"),
                **kw)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        inception.InceptionV3Features(**kw)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fid.FeatureExtractor(allow_random=True, **kw)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        slimnet.SlimNetClassifier(slimnet.init_random_state_dict(0), **kw)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FaceSegmenter(BiSeNet().init_params(0), **kw)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        num_smiles.mouth_heuristic_classifier(BiSeNet().init_params(0),
                                              **kw)
    labeldata = {"object": ["-", "a"], "part": ["-", "p"],
                 "material": ["-", "m"], "scene": ["-"],
                 "object_part": {"a": ["p"]}}
    upp = UPerNet({"object": 2, "part": 1, "material": 2, "scene": 1}, [1],
                  {1: [1]}).init_params(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        UnifiedParsingSegmenter(upp, labeldata, **kw)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_segmenter("netp", params=upp, labeldata=labeldata, **kw)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SemanticSegmenter(None, ["a", "b"], arch="resnet18dilated", **kw)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_seg.load_seg_model("faces_clean", **kw)
    # the quantile sketch follows its batches unless given a device
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RunningQuantile(device="cuda")
    rq = RunningQuantile()
    rq.add(torch.ones(4, 2))
    assert rq.levels[0].device.type == "cpu"


def test_slice10_entry_points_raise_without_cuda(no_cuda, tmp_path,
                                                 monkeypatch):
    """The server, the drivers and the UI run on the card by default: their
    command lines and default feature and segmenter loaders raise without
    CUDA; over CPU objects they run there."""
    from rewriting_torch import serve
    from rewriting_torch.metrics import (fused_pipeline, patch_fid, samples,
                                         seg_stats)
    from rewriting_torch.ui import GanRewriteApp
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--toy", "--port", "0"])
    weights = tmp_path / "weights"
    weights.mkdir()
    torch.save({}, weights / "stylegan2_church.pt")
    monkeypatch.setenv("REWRITING_TPU_WEIGHTS", str(weights))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--dataset", "church", "--port", "0"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fused_pipeline.main(["--n", "2", "--results", str(tmp_path / "f")])
    (tmp_path / "r" / "church_clean").mkdir(parents=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        seg_stats.main(["church_clean", "--n", "2", "--results",
                        str(tmp_path / "r")])
    (tmp_path / "gt").mkdir()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        samples.gt_stats(str(tmp_path / "gt"), 8, 2)
    model = ProgressiveGenerator(sizes=[8, 8, 4], device="cpu")
    gw = ProgressiveGanRewriter(model, model.init_params(seed=0),
                                z_dataset_for_model(model, 4), layernum=2,
                                device="cpu")
    assert gw.device.type == "cpu"
    assert len(GanRewriteApp(gw, size=8, num_canvases=2).canvases) == 2
    seq = SeqStyleGAN2(8, style_dim=16, n_mlp=1, device="cpu")
    sgw = SeqStyleGanRewriter(seq, seq.init_params(seed=0),
                              z_dataset_for_model(seq, 4), layernum=3,
                              device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        patch_fid.patch_fid_sweep(sgw, sgw, [1], n=2)


def test_slice11_entry_points_raise_without_cuda(no_cuda, tmp_path,
                                                 monkeypatch):
    """The meshes, the process group, the dry run and the multi-rank
    command lines default to the card and raise without CUDA, before
    joining any job."""
    import torch.distributed as dist
    from rewriting_torch import parallel, serve
    from rewriting_torch.metrics import sample
    from rewriting_torch.parallel import comm, dryrun
    with pytest.raises(RuntimeError, match="no CUDA device"):
        parallel.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        parallel.make_mesh_2d(1, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        comm.init_process_group()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.main(["--ranks", "2"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sample.main(["--dataset", "church", "--mesh", "--results",
                     str(tmp_path / "s")])
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--toy", "--port", "0"])
    assert not dist.is_initialized()


@pytest.mark.parametrize("device", [None, "cuda"], ids=["default", "cuda"])
def test_slice12_entry_points_raise_without_cuda(no_cuda, device, tmp_path):
    """The segmenter's other encoders and decoders and the 1024 models of
    the zoo default to the card and raise without CUDA; so does the
    smoke script of phases 34-36."""
    kw = {} if device is None else {"device": device}
    for arch, decoder in chip_smoke.SEG_ARCHS:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            SemanticSegmenter(None, ["a", "b"], arch=arch, decoder=decoder,
                              **kw)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SeqStyleGAN2(1024, style_dim=16, n_mlp=1, s2d_tail_max_c=16, **kw)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ProgressiveGenerator(resolution=1024, **kw)
    path = tmp_path / "stylegan2_faces.pt"
    torch.save({}, path)     # the model raises before it reads a key
    with pytest.raises(RuntimeError, match="no CUDA device"):
        zoo.load_seq_stylegan("faces", path=str(path), **kw)


@pytest.mark.parametrize("device", [None, "cuda"], ids=["default", "cuda"])
def test_slice14_entry_points_raise_without_cuda(no_cuda, device):
    """The NBB baseline's entry points run on the card by default and
    raise without CUDA; with ``device="cpu"`` they run there."""
    import numpy as np
    from rewriting_torch.baselines import nbb
    kw = {} if device is None else {"device": device}
    img = np.zeros((16, 16, 3), np.float32)
    rng = np.random.RandomState(0)
    pyr = [rng.rand(16 >> i, 16 >> i, 4).astype(np.float32)
           for i in range(5)]
    feats = np.eye(4, dtype=np.float32).reshape(2, 2, 4)
    for call in (lambda: nbb.default_feature_pyramid(img[None], **kw),
                 lambda: nbb.mutual_nearest_neighbors(feats, feats, **kw),
                 lambda: nbb.sparse_correspondence(pyr, pyr, **kw),
                 lambda: nbb.neural_best_buddies(img[None], img[None], **kw),
                 lambda: nbb.nbb_paste(img, img, img[..., 0], **kw)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert len(nbb.mutual_nearest_neighbors(feats, feats,
                                            device="cpu")) == 4
    assert len(nbb.sparse_correspondence(pyr, pyr, tau=0.0, border=0,
                                         device="cpu")[0]) > 0


def test_smoke_slice12_fails_without_cuda(no_cuda, capsys):
    sys.path.insert(0, str(ROOT / "scripts"))
    try:
        import smoke_slice12
    finally:
        sys.path.remove(str(ROOT / "scripts"))
    assert smoke_slice12.main() != 0
    assert "no CUDA device" in capsys.readouterr().err


_IMPORT_SHARDED = f"""
import sys
for name in {BLOCKED!r}:
    sys.modules[name] = None
import rewriting_torch.ops.quant
import rewriting_torch.parallel
from rewriting_torch.parallel import comm, dryrun, mesh, pipeline, tensor
print(sorted(n for n, m in sys.modules.items()
             if m is not None and n.split(".")[0] in {BLOCKED!r}))
"""


def test_the_sharded_paths_import_no_jax():
    """``parallel/`` and ``ops/quant.py``, which slice 15 extends, import
    nothing of jax or the JAX package."""
    proc = subprocess.run([sys.executable, "-c", _IMPORT_SHARDED], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


_IMPORT_FILES = """
import importlib.util, os, sys
for name in ("jax", "jaxlib", "rewriting_tpu"):
    sys.modules[name] = None   # any import of these now raises ImportError
for path in sys.argv[1:]:
    name = os.path.splitext(os.path.basename(path))[0]
    spec = importlib.util.spec_from_file_location(name, path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
print(sorted(n for n, m in sys.modules.items()
             if m is not None and n.split(".")[0] in ("jax", "jaxlib",
                                                      "rewriting_tpu")))
"""


def test_fetch_script_runbook_and_real_weights_suite_import_no_jax():
    """``scripts/torch_fetch_weights.py``, ``scripts/
    torch_real_weights_report.py`` and ``tests/test_torch_real_weights.py``
    import nothing of jax or the JAX package: they run where jax is
    absent."""
    files = [ROOT / "scripts" / "torch_fetch_weights.py",
             ROOT / "scripts" / "torch_real_weights_report.py",
             ROOT / "tests" / "test_torch_real_weights.py"]
    proc = subprocess.run([sys.executable, "-c", _IMPORT_FILES,
                           *map(str, files)], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"
    for path in files:
        assert "rewriting_tpu" not in path.read_text(), path


def test_slice15_helpers_raise_without_cuda(no_cuda, capsys):
    """Phase 38's helpers run on the card unless given ``device="cpu"``:
    without CUDA they raise before starting a job, and
    ``scripts/smoke_slice15.py`` and ``scripts/time_tp_tiers.py`` exit
    non-zero."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        chip_smoke.check_sharded_faces(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        chip_smoke.check_sharded_faces(None, device="cuda")
    sys.path.insert(0, str(ROOT / "scripts"))
    try:
        import smoke_slice15
        import time_tp_tiers
    finally:
        sys.path.remove(str(ROOT / "scripts"))
    assert smoke_slice15.main([]) != 0
    assert "no CUDA device" in capsys.readouterr().err
    assert time_tp_tiers.main([]) != 0
    assert "no CUDA device" in capsys.readouterr().err


def test_slice15_helpers_run_on_the_cpu_when_asked():
    """``device="cpu"`` runs phase 38's checks end to end on a 16-px model
    (512 channels: K1's gate passes at 8 and 16 px) in a job of 4 CPU
    ranks, the kernels their plain versions: the bands, then int8 on dp,
    tp and the bands, every check held."""
    out = chip_smoke.check_sharded_faces(
        None, device="cpu", model={"size": 16, "style_dim": 32, "n_mlp": 2},
        default_from=8, int8_from=8, timeout_s=300)
    runs = out["ranks"][0]
    assert sorted(runs) == sorted(
        [f"sp_{k}_{d}x{s}" for k in ("k1", "k1_default")
         for d, s in chip_smoke.SHARDED_LAYOUTS]
        + ["int8_dp", "int8_tp", "int8_sp_1x4"])
    assert all(r["int8_values"] for name, r in runs.items()
               if name.startswith("int8"))
    assert out["kernels"]["rows"]


def test_smoke_slice14_fails_without_cuda(no_cuda, capsys):
    sys.path.insert(0, str(ROOT / "scripts"))
    try:
        import smoke_slice14
    finally:
        sys.path.remove(str(ROOT / "scripts"))
    assert smoke_slice14.main() != 0
    assert "no CUDA device" in capsys.readouterr().err


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


_READ_WITHOUT_PIL = """
import sys
for name in ("PIL", "jax", "rewriting_tpu"):
    sys.modules[name] = None   # any import of these now raises ImportError
from rewriting_torch import native
base = "tests/data/jpeg/baseline_420_q75_256"
jpeg, png = native.read_image_rgb(base + ".jpg"), native.read_image_rgb(
    base + ".png")
assert (jpeg == png).all()
print(sorted(n for n, m in sys.modules.items()
             if m is not None and n.split(".")[0] in ("PIL", "jax", "torch")))
"""


def test_native_reads_jpeg_and_png_without_pil():
    """``native`` imports no PIL: with PIL, jax and the JAX package
    blocked, it reads a JPEG (building its decoder) and the PNG twin, and
    imports no torch on the way."""
    proc = subprocess.run([sys.executable, "-c", _READ_WITHOUT_PIL],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def test_slice16_helpers_raise_without_cuda(no_cuda, capsys, tmp_path):
    """Phase 39's helper runs on the card unless given ``device="cpu"``,
    and ``scripts/smoke_slice16.py`` exits non-zero without CUDA."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        chip_smoke.check_jpeg(str(tmp_path), chip_smoke.slice12_counts)
    sys.path.insert(0, str(ROOT / "scripts"))
    try:
        import smoke_slice16
    finally:
        sys.path.remove(str(ROOT / "scripts"))
    assert smoke_slice16.main([]) != 0
    assert "no CUDA device" in capsys.readouterr().err


def test_slice16_helper_runs_on_the_cpu_when_asked(tmp_path):
    """``device="cpu"`` runs phase 39's checks end to end with a seeded
    Inception at 4 images: the fixtures at 0 LSB, both rates, equal FID
    statistics and real samples, no launch, the truncated file refused,
    the CMYK one and every file of ``tests/data/images`` read as PIL reads
    them, alone and through ``read_batches``."""
    fe = fid.FeatureExtractor(params=inception.init_params(0), batch_size=2,
                              device="cpu")
    out = chip_smoke.check_jpeg(str(tmp_path), chip_smoke.slice12_counts,
                                feature_fn=fe, n_decode=8, n_fid=4,
                                batch_size=2, device="cpu")
    assert len(out["fixtures"]) >= 9
    assert out["mean_rel"] == out["covariance_rel"] == 0.0
    assert out["gt_values_apart"] == 0 and not any(out["launches"].values())
    assert set(out["refused"]) == set(chip_smoke.JPEG_REFUSED)
    assert set(out["by_pil"]) == set(chip_smoke.JPEG_BY_PIL)
    assert all(r["equal"] and r["rgb"]["shape"] == [32, 32, 3]
               for r in out["by_pil"].values())
    files = out["images"]["files"]
    assert len(files) >= 28 and all(r["equal"] for r in files.values())
    assert files["palette_4bit.png"]["own_mode"]["shape"] == [24, 40]
    assert files["grey_16bit.png"]["own_mode"]["dtype"] == "uint16"
    assert out["images"]["read_batches_values_apart"] == 0
    assert min(out["decode_images_per_s"].values()) > 0
    kernels = {name: {} for name in ("blur2d", "upconv_blur",
                                     "upconv_blur_bf16", "upsample2x")}
    chip_smoke.add_slice16(kernels, out)
    assert all(k["jpeg_launches"] == 0 for k in kernels.values())
