"""The publishers' checkpoint layouts, as files, read by the JAX package's
loaders and by the port's: the params are equal (0 difference).

Each file is written by ``torch.save`` as its publisher saved it, with
numpy-seeded tensors under the publisher's names and shapes (those the
port's inverse converters give), in the legacy (pre-1.6) serialization
where the published file predates torch 1.6:
- gandissect's ProgGAN ``.pth``: a bare ``OrderedDict``, in the
  ``layerN`` names and in the old ``features.N`` names (legacy);
- rosinality's ``{"g_ema": ..., "latent_avg": ...}`` (both
  serializations); the JAX converter refuses rosinality's flat names
  (ROADMAP queue 3), so the state dicts the two loaders read are compared;
- pytorch-fid's ``pt_inception-2015-12-05.pth`` (legacy);
- torchvision's VGG16 as ``vgg16_features.pth`` and LPIPS's lin heads as
  ``lpips_vgg_lins.pth`` (legacy);
- the face parser's ``face-parsing-02dd3f6f.pth`` (legacy);
- unified parsing's ``upp/encoder_epoch_40.pth`` and
  ``decoder_epoch_40.pth`` (legacy);
- pytorch-slim-cnn's training checkpoint ``celeba_20.pth`` (``epoch``,
  ``model_state_dict``, ``optimizer_state_dict``, ``loss``), its scalars
  Python's or numpy's, and numpy's under the numpy 1 module name
  (legacy).
The port reads with ``torch.load(weights_only=True)``; a file holding an
object outside its ``SAFE_GLOBALS`` (here a ``pathlib`` path in a
training checkpoint's options), which the JAX package reads, is refused
naming the file.
"""

import collections
import json
import pathlib
import pickle

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from rewriting_torch.convert import params_from_jax, tree_from_jax
from rewriting_torch.core import leaves
from rewriting_torch.metrics import distances, inception, slimnet
from rewriting_torch.models import zoo
from rewriting_torch.models.proggan import ProgressiveGenerator
from rewriting_torch.segment import faceparse, segmenter
from rewriting_torch.segment.segmenter import upernet_for
from rewriting_tpu.metrics import distances as jax_distances
from rewriting_tpu.metrics import inception as jax_inception
from rewriting_tpu.metrics import slimnet as jax_slimnet
from rewriting_tpu.models import zoo as jax_zoo
from rewriting_tpu.segment import faceparse as jax_faceparse
from rewriting_tpu.segment import segmenter as jax_segmenter

torch.set_num_threads(1)

LEGACY = {"_use_new_zipfile_serialization": False}
UPP_TINY = {"object": 6, "material": 4, "scene": 3, "owners": 2, "parts": 5}


def seeded(template, seed):
    """`template`'s names, order and shapes with numpy-seeded float32
    values (BatchNorm variances positive), integers kept; an
    OrderedDict of tensors, as ``state_dict()`` gives."""
    rng = np.random.RandomState(seed)
    out = collections.OrderedDict()
    for k, v in template.items():
        v = torch.as_tensor(np.asarray(v))
        if not v.is_floating_point():
            out[k] = v.clone()
            continue
        a = rng.standard_normal(tuple(v.shape)).astype(np.float32)
        if k.endswith("running_var"):
            a = np.abs(a) + 0.5
        out[k] = torch.from_numpy(a)
    return out


def carried_equal(port_tree, jax_tree):
    """The port's params equal the JAX package's tree leaf for leaf, 0
    difference (``convert.tree_from_jax`` keeps layouts)."""
    got = dict(leaves(port_tree))
    want = dict(leaves(tree_from_jax(jax.tree_util.tree_map(np.asarray,
                                                            jax_tree))))
    assert got.keys() == want.keys()
    for k in got:
        assert torch.equal(got[k].cpu(), want[k]), k
    return len(got)


@pytest.mark.parametrize("names", ["layerN", "features.N"])
def test_gandissect_proggan(tmp_path, names):
    model = ProgressiveGenerator(sizes=[32, 16, 16, 8, 8, 4], device="cpu")
    params = {stage: dict(seeded(sub, i))
              for i, (stage, sub) in enumerate(model.init_params(seed=0)
                                               .items())}
    sd = chip_smoke.proggan_checkpoint(model, params)
    if names == "layerN":     # layer1.conv.weight, layer1.wscale.b, ...
        sd = collections.OrderedDict(
            (f"{stage}.{'b' if k == 'bias' else k}", t)
            for stage, sub in params.items() for k, t in sub.items())
    path = tmp_path / zoo.PROGGAN_ZOO["church"]
    torch.save(sd, path, **LEGACY)
    got_model, got = zoo.load_proggan("church", path=str(path), device="cpu")
    jm, jp = jax_zoo.load_proggan("church", path=str(path))
    assert got_model.sizes == jm.sizes == model.sizes
    want = params_from_jax(got_model, jax.tree_util.tree_map(np.asarray, jp))
    for stage in params:
        for k in params[stage]:
            assert torch.equal(got[stage][k], want[stage][k])
            assert torch.equal(got[stage][k], params[stage][k])


@pytest.mark.parametrize("serialization", ["zip", "legacy"])
def test_rosinality_g_ema(tmp_path, serialization):
    """The state dicts the two loaders read (the JAX package's
    ``_torch_load_numpy`` and the port's ``load_state``) are the same
    arrays under the same names."""
    from rewriting_torch.models.stylegan2 import SeqStyleGAN2
    model = SeqStyleGAN2(16, style_dim=32, n_mlp=2, device="cpu")
    params = model.init_params(seed=0)
    params["latents"] = {"latent_avg": torch.zeros(32)}
    ckpt = chip_smoke.rosinality_checkpoint(model, params)
    ckpt = {"g_ema": seeded(ckpt["g_ema"], 1),
            "latent_avg": seeded({"l": ckpt["latent_avg"]}, 2)["l"]}
    path = tmp_path / "stylegan2_church.pt"
    torch.save(ckpt, path, **({} if serialization == "zip" else LEGACY))
    got = zoo.load_state(str(path))
    want = jax_zoo._torch_load_numpy(str(path))
    assert got.keys() == want.keys() == {"g_ema", "latent_avg"}
    assert list(got["g_ema"]) == list(want["g_ema"]) == list(ckpt["g_ema"])
    for k, v in got["g_ema"].items():
        np.testing.assert_array_equal(v.numpy(), want["g_ema"][k], err_msg=k)
    np.testing.assert_array_equal(got["latent_avg"].numpy(),
                                  want["latent_avg"])


def test_pytorch_fid_inception(tmp_path):
    template = inception.state_dict_from_params(inception.init_params(0))
    path = tmp_path / "pt_inception-2015-12-05.pth"
    torch.save(seeded(template, 3), path, **LEGACY)
    got = inception.params_from_torch_state_dict(zoo.load_state(str(path)))
    want = jax_inception.params_from_torch_state_dict(
        jax_zoo._torch_load_numpy(str(path)))
    assert carried_equal(got, want) == 2 * 94


def test_torchvision_vgg16_and_lpips_heads(tmp_path, monkeypatch):
    """torchvision's ``vgg16-397923af.pth`` (``features.N`` and
    ``classifier.N``; the classifier at a stand-in size: neither reader
    takes it) saved as ``vgg16_features.pth``, and the official LPIPS heads
    (``lin{i}.model.1.weight``), read by both ``default_lpips_params``."""
    rng = np.random.RandomState(4)
    vgg = collections.OrderedDict()
    width = 3
    for idx, out in zip((0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28),
                        (64, 64, 128, 128, 256, 256, 256, 512, 512, 512,
                         512, 512, 512)):
        vgg[f"features.{idx}.weight"] = torch.from_numpy(rng.standard_normal(
            (out, width, 3, 3)).astype(np.float32))
        vgg[f"features.{idx}.bias"] = torch.from_numpy(rng.standard_normal(
            out).astype(np.float32))
        width = out
    for idx in (0, 3, 6):
        vgg[f"classifier.{idx}.weight"] = torch.ones(4, 4)
        vgg[f"classifier.{idx}.bias"] = torch.ones(4)
    lins = collections.OrderedDict(
        (f"lin{i}.model.1.weight", torch.from_numpy(np.abs(rng.standard_normal(
            (1, c, 1, 1))).astype(np.float32)))
        for i, c in enumerate((64, 128, 256, 512, 512)))
    torch.save(vgg, tmp_path / "vgg16_features.pth", **LEGACY)
    torch.save(lins, tmp_path / "lpips_vgg_lins.pth", **LEGACY)
    monkeypatch.setenv("REWRITING_TPU_WEIGHTS", str(tmp_path))
    assert carried_equal(distances.default_lpips_params(),
                         jax_distances.default_lpips_params()) == 2 * 13 + 5


def test_face_parser(tmp_path):
    net = faceparse.BiSeNet()
    path = tmp_path / faceparse.WEIGHTS_FILENAME
    torch.save(seeded(net.params_to_torch(net.init_params(0)), 5), path,
               **LEGACY)
    got = faceparse.FaceSegmenter(weights_path=str(path), device="cpu")
    want = jax_faceparse.FaceSegmenter(weights_path=str(path))
    assert carried_equal(got.params, want.params) == 64


def test_unified_parsing(tmp_path, monkeypatch):
    labeldata = chip_smoke.upp_labeldata(UPP_TINY)
    enc, dec = upernet_for(labeldata).params_to_torch(
        upernet_for(labeldata).init_params(0))
    (tmp_path / "upp").mkdir()
    torch.save(seeded(enc, 6), tmp_path / "upp" / "encoder_epoch_40.pth",
               **LEGACY)
    torch.save(seeded(dec, 7), tmp_path / "upp" / "decoder_epoch_40.pth",
               **LEGACY)
    (tmp_path / "upp" / "labels.json").write_text(json.dumps(labeldata))
    monkeypatch.setenv("REWRITING_TPU_WEIGHTS", str(tmp_path))
    got, got_labels = segmenter._load_released_upp()
    want, want_labels = jax_segmenter._load_released_upp()
    assert got_labels == want_labels == labeldata
    assert carried_equal(got, want) == 150


def slimnet_training_checkpoint(scalars):
    """pytorch-slim-cnn's ``celeba_20.pth``: a training checkpoint with
    an Adam state, its epoch and loss Python's or numpy's scalars."""
    sd = seeded(slimnet.init_random_state_dict(0), 8)
    names = [k for k in sd if not k.endswith(("running_mean",
                                              "running_var"))]
    epoch, loss = (20, 0.2291) if scalars == "python" else \
        (np.int64(20), np.float32(0.2291))
    return {"epoch": epoch, "model_state_dict": sd,
            "optimizer_state_dict": {
                "state": {i: {"step": 20 * 1583, "exp_avg": torch.zeros_like(
                    sd[k]), "exp_avg_sq": torch.zeros_like(sd[k])}
                          for i, k in enumerate(names[:4])},
                "param_groups": [{"lr": 0.001, "betas": (0.9, 0.999),
                                  "eps": 1e-08, "weight_decay": 0,
                                  "amsgrad": False,
                                  "params": list(range(len(names)))}]},
            "loss": loss}


@pytest.mark.parametrize("scalars", ["python", "numpy", "numpy1"])
def test_slimnet_training_checkpoint(tmp_path, scalars):
    """Read by both SlimNetClassifiers; numpy's scalars through the
    ``SAFE_GLOBALS`` of their type, also under the module name numpy 1
    pickles them by (``numpy.core.multiarray``)."""
    ckpt = slimnet_training_checkpoint("python" if scalars == "python"
                                       else "numpy")
    path = tmp_path / slimnet.WEIGHTS_FILENAME
    torch.save(ckpt, path, **LEGACY)
    if scalars == "numpy1":
        data = path.read_bytes()
        assert b"numpy._core.multiarray" in data
        path.write_bytes(data.replace(b"numpy._core.multiarray",
                                      b"numpy.core.multiarray"))
    loaded = zoo.load_state(str(path))
    assert loaded["epoch"] == 20 and type(loaded["epoch"]) is \
        type(ckpt["epoch"])
    assert loaded["loss"] == ckpt["loss"]
    got = slimnet.SlimNetClassifier(checkpoint=str(path), device="cpu")
    want = jax_slimnet.SlimNetClassifier(checkpoint=str(path))
    got, carried = dict(leaves(got.params)), dict(leaves(
        slimnet.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                       want.params))))
    assert got.keys() == carried.keys() and len(got) > 50
    for k in got:
        assert torch.equal(got[k], carried[k]), k


def test_object_outside_safe_globals_is_refused_by_name(tmp_path):
    """A training checkpoint whose options hold a ``pathlib`` path: the
    JAX package reads it (``weights_only=False``); the port's
    ``weights_only`` unpickler refuses it, naming the file, and runs no
    code from it."""
    ckpt = slimnet_training_checkpoint("python")
    ckpt["options"] = {"checkpoint_dir": pathlib.PurePosixPath("runs/x")}
    path = tmp_path / slimnet.WEIGHTS_FILENAME
    torch.save(ckpt, path, **LEGACY)
    want = jax_slimnet.SlimNetClassifier(checkpoint=str(path))
    assert want.params
    with pytest.raises(pickle.UnpicklingError, match=str(path)):
        zoo.load_state(str(path))
    with pytest.raises(pickle.UnpicklingError, match="SAFE_GLOBALS"):
        slimnet.SlimNetClassifier(checkpoint=str(path), device="cpu")
