"""The port's dissection and its upsampling against the JAX package's.

- The conv-stack geometry and the sizing-transform crawl equal the JAX
  module's.
- ``upsampler`` of numpy data equals the JAX module's; of a tensor (B,
  H, W[, C]), resized where it lies in float32, within 1e-6 of the
  largest entry of the numpy path (measured 3e-7).
- ``dissect`` on ``ProgressiveGenerator(sizes=[8, 8, 8])`` with the toy
  segmenter of tests/test_dissect.py, against the JAX ``dissect`` on the
  same params: the same units, labels and classes in ``labels.json``,
  ``seglabels.json`` equal, ``iou.npy`` within 1e-2 (measured 9.3e-10:
  the activations differ by rounding, the indicators and sketches not at
  these sizes), the unit strips of the same size, and ``DissectVis``
  reading them back.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from rewriting_tpu import dissect as jax_dissect
from rewriting_tpu.models import ProgressiveGenerator as JaxProgGAN
from rewriting_tpu.utils import upsample as jax_upsample
from rewriting_torch import dissect as dissect_mod
from rewriting_torch.convert import params_from_jax
from rewriting_torch.models import ProgressiveGenerator
from rewriting_torch.utils import upsample
from rewriting_torch.utils.renormalize import decode_png

torch.set_num_threads(1)

CONVS = ([(4, 2, 1)], [(4, 2, 1), (4, 2, 1)], [(3, 1, 1), (3, 2, 0)],
         [(7, 2, 3), (3, 2, 1), (1, 1, 0)])


@pytest.mark.parametrize("convs", CONVS, ids=range(len(CONVS)))
def test_geometry_matches_jax(convs):
    for fn in ("convconfig_scale_offset", "sequence_scale_offset"):
        assert getattr(upsample, fn)(convs) == \
            getattr(jax_upsample, fn)(convs)
    for size in ((64, 64), (33, 20)):
        assert upsample.convconfig_data_size(convs, size) == \
            jax_upsample.convconfig_data_size(convs, size)


def test_find_sizer_matches_jax():
    class Resize:
        def __init__(self, size):
            self.size = size

    class CenterCrop(Resize):
        pass

    class DS:
        def __init__(self, transforms=None, transform=None):
            if transforms is not None:
                self.transforms = transforms
            if transform is not None:
                self.transform = transform

    class Model:
        resolution = 256

    class Config:
        image_size = (48, 40)

    sources = [DS(transforms=[Resize(64), CenterCrop(32)]),
               DS(transform=Resize((48, 24))), Model(), Config(),
               DS(transforms=[CenterCrop(16), object()])]
    for src in sources:
        assert upsample.image_size_from_source(src) == \
            jax_upsample.image_size_from_source(src)
        got, want = upsample.find_sizer(src), jax_upsample.find_sizer(src)
        assert got is want
    assert upsample.find_sizer(None) is None
    with pytest.raises(ValueError):
        upsample.image_size_from_source(object())


UPS = [((12, 13), None, None), ((16, 16), (2.0, 0.5), None),
       ((32, 24), (4.0, 1.5), (64, 64)), ((8, 8), None, None)]


@pytest.mark.parametrize("target,so,image_size", UPS,
                         ids=["stretch", "aligned", "via_image", "same"])
def test_upsampler_numpy_and_tensor_paths(target, so, image_size):
    """numpy: the JAX module's result; a tensor batch: within 1e-6 of the
    numpy path's largest entry, with or without a channel axis."""
    rng = np.random.RandomState(0)
    data = rng.randn(3, 8, 8, 5).astype(np.float32)
    up = upsample.upsampler(target, data.shape[1:3], image_size=image_size,
                            scale_offset=so)
    jup = jax_upsample.upsampler(target, data.shape[1:3],
                                 image_size=image_size, scale_offset=so)
    want = up(data)
    np.testing.assert_array_equal(want, jup(data))
    np.testing.assert_array_equal(up(data[0]), jup(data[0]))
    got = up(torch.as_tensor(data))
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    assert got.shape == (3,) + tuple(target) + (5,)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6 * scale, rtol=0)
    flat = up(torch.as_tensor(data[..., 0]))
    np.testing.assert_allclose(flat.numpy(), want[..., 0],
                               atol=1e-6 * scale, rtol=0)


class JaxToySegmenter:
    """tests/test_dissect.py's: class 1 where red > 0 else 2."""

    def segment_batch(self, imgs, downsample=1):
        imgs = np.asarray(imgs)
        return np.where(imgs[..., 0] > 0, 1, 2).astype(np.int64)[:, None]


class ToySegmenter:
    """The same on the device's tensors."""

    def segment_batch(self, imgs):
        return torch.where(imgs[..., 0] > 0, 1, 2)[:, None]


LABELS = ["-", "red", "notred"]


@pytest.fixture(scope="module")
def dissected(tmp_path_factory):
    jm = JaxProgGAN(sizes=[8, 8, 8])
    jp = jm.init_params(jax.random.PRNGKey(0))
    tm = ProgressiveGenerator(sizes=[8, 8, 8], device="cpu")
    tp = params_from_jax(tm, jax.tree_util.tree_map(np.asarray, jp))
    root = tmp_path_factory.mktemp("dissect")
    dirs = {}
    for name, fn, model, params, seg in (
            ("jax", jax_dissect.dissect, jm, jp, JaxToySegmenter()),
            ("torch", dissect_mod.dissect, tm, tp, ToySegmenter())):
        dirs[name] = str(root / name / "church" / "layer2" / "toy" / "40")
        kw = {"device": "cpu"} if name == "torch" else {}
        records = fn(model, params, "layer2", seg, LABELS, dirs[name],
                     sample_size=40, batch_size=10, upsample_to=(8, 8),
                     save_unit_images=True, topk_k=3, **kw)
        dirs[name + "_records"] = records
    dirs["root"] = str(root)
    return dirs


def test_dissect_matches_jax(dissected):
    got, want = dissected["torch_records"], dissected["jax_records"]
    assert len(got["units"]) == len(want["units"]) == 8
    for g, w in zip(got["units"], want["units"]):
        assert (g["unit"], g["label"], g["cls"]) == \
            (w["unit"], w["label"], w["cls"])
        assert abs(g["iou"] - w["iou"]) <= 1e-2
    t, j = dissected["torch"], dissected["jax"]
    with open(os.path.join(t, "labels.json")) as f:
        assert json.load(f) == got
    for name in ("seglabels.json",):
        with open(os.path.join(t, name)) as f, \
                open(os.path.join(j, name)) as g:
            assert json.load(f) == json.load(g) == LABELS
    iou, jiou = (np.load(os.path.join(d, "iou.npy")) for d in (t, j))
    assert iou.shape == jiou.shape and iou.shape[0] == 8
    assert np.isfinite(iou).all() and 0.0 <= iou.min() <= iou.max() <= 1.0
    np.testing.assert_allclose(iou, jiou, atol=1e-2, rtol=0)
    for name in ("rq.npz", "cmv.npz", "topk.npz"):
        assert os.path.isfile(os.path.join(t, name)), name
    for u in range(8):
        with open(os.path.join(t, f"imgs/unit_{u}.png"), "rb") as f:
            strip = decode_png(f.read())
        with open(os.path.join(j, f"imgs/unit_{u}.png"), "rb") as f:
            jstrip = decode_png(f.read())
        assert strip.shape == jstrip.shape == (128, 3 * 128 + 2 * 5, 3)


def test_dissect_reuses_its_caches(dissected, monkeypatch):
    """A second run reads rq, cmv and topk from outdir: no conditional
    pass (the segmenter is never called) and the same records."""
    tm = ProgressiveGenerator(sizes=[8, 8, 8], device="cpu")
    params = tm.init_params(seed=5)      # ignored: the caches decide

    class Refuses:
        def segment_batch(self, imgs):
            raise AssertionError("the conditional pass ran again")
    records = dissect_mod.dissect(
        tm, params, "layer2", Refuses(), LABELS, dissected["torch"],
        sample_size=40, batch_size=10, upsample_to=(8, 8),
        save_unit_images=False, topk_k=3, device="cpu")
    assert records == dissected["torch_records"]


def test_dissect_vis_reads_the_outputs(dissected):
    vis = dissect_mod.DissectVis(outdir=os.path.join(dissected["root"],
                                                     "torch"),
                                 model="church", layers=["layer2"],
                                 seg="toy", sample_size=40)
    jvis = jax_dissect.DissectVis(outdir=os.path.join(dissected["root"],
                                                      "torch"),
                                  model="church", layers=["layer2"],
                                  seg="toy", sample_size=40)
    assert vis.seglabels == LABELS
    for u in range(8):
        assert vis.label("layer2", u) == jvis.label("layer2", u)
        assert vis.iou("layer2", u) == jvis.iou("layer2", u)
    assert vis.top_units("layer2", "red", k=3) == \
        jvis.top_units("layer2", "red", k=3)
    img = vis.image("layer2", 0)
    assert img.dtype == np.uint8 and img.shape == (128, 394, 3)
    np.testing.assert_array_equal(img, np.asarray(jvis.image("layer2", 0)))
    assert vis.image("layer2", 0) is img         # read once


def test_dissect_refuses_a_model_on_another_device():
    tm = ProgressiveGenerator(sizes=[8, 8, 8], device="cpu")
    with pytest.raises(ValueError, match="model is on cpu"):
        dissect_mod.dissect(tm, tm.init_params(seed=0), "layer2",
                            ToySegmenter(), LABELS, "unused",
                            device=torch.device("meta"))


def test_main_matches_jax(tmp_path, monkeypatch):
    """The command line, with the zoo's ProgGAN and the segmenter patched
    to the tiny model and the toy segmenter, against the JAX package's
    command line on the same params: the same labels, ``iou.npy`` within
    1e-2, the job marked done; a checkpoint path names the model by its
    file."""
    import rewriting_tpu.models.zoo as jax_zoo
    import rewriting_tpu.segment as jax_segment
    import rewriting_torch.models.zoo as zoo
    import rewriting_torch.segment as segment
    jm = JaxProgGAN(sizes=[8, 8, 8])
    jp = jm.init_params(jax.random.PRNGKey(0))
    tm = ProgressiveGenerator(sizes=[8, 8, 8], device="cpu")
    tp = params_from_jax(tm, jax.tree_util.tree_map(np.asarray, jp))
    loads = []

    def load_proggan(name, path=None):
        loads.append((name, path))
        return tm, tp
    monkeypatch.setattr(zoo, "load_proggan", load_proggan)
    monkeypatch.setattr(segment, "load_segmenter",
                        lambda name: (ToySegmenter(), LABELS))
    monkeypatch.setattr(jax_zoo, "load_proggan", lambda name: (jm, jp))
    monkeypatch.setattr(jax_segment, "load_segmenter",
                        lambda name: (JaxToySegmenter(), LABELS))
    args = ["--layer", "layer2", "--seg", "toy", "--sample_size", "40"]
    dissect_mod.main(["--outdir", str(tmp_path / "torch")] + args)
    monkeypatch.setattr("sys.argv", ["dissect", "--outdir",
                                     str(tmp_path / "jax")] + args)
    jax_dissect.main()
    t, j = (str(tmp_path / name / "church" / "layer2" / "toy" / "40")
            for name in ("torch", "jax"))
    assert loads == [("church", None)]
    for d in (t, j):
        assert os.path.isfile(os.path.join(d, "done.txt"))
    with open(os.path.join(t, "labels.json")) as f, \
            open(os.path.join(j, "labels.json")) as g:
        got, want = json.load(f)["units"], json.load(g)["units"]
    assert [(u["unit"], u["label"]) for u in got] == \
        [(u["unit"], u["label"]) for u in want]
    np.testing.assert_allclose(np.load(os.path.join(t, "iou.npy")),
                               np.load(os.path.join(j, "iou.npy")),
                               atol=1e-2, rtol=0)
    path = tmp_path / "proggan_mine.pth"
    path.write_bytes(b"")
    dissect_mod.main(["--outdir", str(tmp_path / "torch"), "--model",
                      str(path)] + args)
    assert loads[-1] == ("proggan_mine", str(path))
    assert os.path.isfile(str(tmp_path / "torch" / "proggan_mine" / "layer2"
                              / "toy" / "40" / "done.txt"))


def test_main_from_files_matches_jax(tmp_path, monkeypatch):
    """The command line from files on the CPU (the entry points' default
    device made the CPU): ProgGAN from a checkpoint path, ``--seg netpqc``
    from a weights directory of seeded files at small head widths
    (``chip_smoke.write_seeded_weights``); against the JAX package's
    command line, which reads the same checkpoint under the zoo's name and
    the same segmenter files: the same seglabels, ``iou.npy`` within 1e-2,
    a strip per unit."""
    import shutil

    import chip_smoke
    import rewriting_torch.models.proggan as proggan_mod
    import rewriting_torch.segment.segmenter as segmenter_mod
    import rewriting_torch.segment.semantic as semantic_mod
    from rewriting_torch.models import zoo
    from rewriting_torch.utils.device import resolve_device

    def on_cpu(device=None):
        return resolve_device("cpu" if device is None else device)
    for mod in (proggan_mod, segmenter_mod, semantic_mod):
        monkeypatch.setattr(mod, "resolve_device", on_cpu)
    weights = tmp_path / "weights"
    labeldata = chip_smoke.upp_labeldata({"object": 8, "material": 3,
                                          "scene": 2, "owners": 3,
                                          "parts": 5})
    chip_smoke.write_seeded_weights(str(weights), labeldata,
                                    which=("upp", "color"),
                                    colour_segsizes=[32])
    tm = ProgressiveGenerator(sizes=[8, 8, 8], device="cpu")
    path = tmp_path / "mine.pth"
    torch.save(chip_smoke.proggan_checkpoint(tm, tm.init_params(seed=3)),
               path)
    shutil.copy(path, weights / zoo.PROGGAN_ZOO["church"])
    monkeypatch.setenv("REWRITING_TPU_WEIGHTS", str(weights))
    args = ["--layer", "layer2", "--seg", "netpqc", "--sample_size", "6"]
    dissect_mod.main(["--outdir", str(tmp_path / "torch"), "--model",
                      str(path)] + args)
    monkeypatch.setattr("sys.argv", ["dissect", "--outdir",
                                     str(tmp_path / "jax")] + args)
    jax_dissect.main()
    t = str(tmp_path / "torch" / "mine" / "layer2" / "netpqc" / "6")
    j = str(tmp_path / "jax" / "church" / "layer2" / "netpqc" / "6")
    for name in ("seglabels.json",):
        with open(os.path.join(t, name)) as f, \
                open(os.path.join(j, name)) as g:
            assert json.load(f) == json.load(g)
    iou, jiou = (np.load(os.path.join(d, "iou.npy")) for d in (t, j))
    assert iou.shape == jiou.shape and iou.shape[0] == 8
    np.testing.assert_allclose(iou, jiou, atol=1e-2, rtol=0)
    assert len(os.listdir(os.path.join(t, "imgs"))) >= 8
    assert os.path.isfile(os.path.join(t, "done.txt"))
