"""The port's checkpoint path and the samplers' command lines against the
JAX package's.

- The converter (``models/stylegan2.params_from_state_dict``) on the
  golden's state dict (tests/goldens/stylegan2_tiny.npz, made by the
  reference torch code) equals, bit for bit, the JAX converter's params
  carried across with ``params_from_jax``; the golden's output through it
  is within 1e-4 abs, as in tests/test_torch_stylegan2.py::test_golden.
- ``chip_smoke.rosinality_checkpoint``, the inverse rename, rebuilds the
  golden's keys and arrays exactly, and a rosinality-named dict (flat or
  ``g_ema``-wrapped) converts as the JAX converter converts its seq-named
  rename.
- The zoo loads a ``.pt`` from ``path=`` or ``$REWRITING_TPU_WEIGHTS``; a
  file missing there is downloaded, and a failed download (here from a
  loopback port nothing listens on) raises ``FileNotFoundError`` naming
  the file and its URL; a missing ``path=`` raises without touching the
  network.  A training checkpoint with an
  ``argparse.Namespace`` under ``args`` loads through ``weights_only``,
  bit for bit as the JAX zoo loads it.
- ``sample.main()`` and ``sample_edited.main()`` run on the CPU with the
  loader patched to a tiny model; their PNGs are within 1 LSB of the JAX
  package's ``sample_clean`` on the same weights (the limit of
  tests/test_torch_sample.py).
"""

import argparse
import functools
import io
import json
import os
import pickle
import socket
import sys
import urllib.request

import jax
import numpy as np
import PIL.Image
import pytest
import torch

import chip_smoke
from rewriting_tpu.metrics import sample as jax_sample
from rewriting_tpu.models import zoo as jax_zoo
from rewriting_tpu.models.stylegan2 import SeqStyleGAN2 as JaxSeqStyleGAN2
from rewriting_tpu.models.stylegan2 import \
    _seq_names_from_rosinality as jax_rename
from rewriting_tpu.models.stylegan2 import \
    params_from_state_dict as jax_params_from_state_dict
from rewriting_torch.convert import params_from_jax, params_to_numpy
from rewriting_torch.metrics import sample, sample_edited
from rewriting_torch.models import zoo
from rewriting_torch.models.stylegan2 import (SeqStyleGAN2,
                                              _seq_names_from_rosinality,
                                              params_from_state_dict)

torch.set_num_threads(1)

SIZE, STYLE_DIM, N_MLP = 16, 64, 2
MASKS = os.path.join(os.path.dirname(__file__), "..", "notebooks", "masks",
                     "stylegan")


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        name = f"{prefix}/{k}"
        if isinstance(v, dict):
            yield from _leaves(v, name)
        else:
            yield name, v


def _assert_params_equal(got, want):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


@pytest.fixture(scope="module")
def golden(goldens):
    g = goldens("stylegan2_tiny")
    sd = {k[len("sd."):]: g[k] for k in g.files if k.startswith("sd.")}
    tm = SeqStyleGAN2(SIZE, style_dim=STYLE_DIM, n_mlp=N_MLP, device="cpu")
    jm = JaxSeqStyleGAN2(SIZE, style_dim=STYLE_DIM, n_mlp=N_MLP)
    want = params_from_jax(tm, jax.tree_util.tree_map(
        np.asarray, jax_params_from_state_dict(jm, sd)))
    return {"sd": sd, "z": g["z"], "out": g["out"], "tm": tm, "jm": jm,
            "want": want}


@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_converter_is_bit_exact_on_the_golden(golden, kind):
    sd = golden["sd"]
    if kind == "torch":
        sd = {k: torch.from_numpy(v) for k, v in sd.items()}
    got = params_from_state_dict(golden["tm"], sd)
    _assert_params_equal(got, golden["want"])


def test_golden_output_through_the_converter(golden):
    """No JAX in the path: the reference's own output, atol 1e-4."""
    tm = golden["tm"]
    params = params_from_state_dict(tm, golden["sd"])
    got = tm(params, golden["z"], fast=False).numpy().transpose(0, 3, 1, 2)
    np.testing.assert_allclose(got, golden["out"], atol=1e-4, rtol=0)


def test_inverse_rename_rebuilds_the_golden(golden):
    """chip_smoke's rosinality writer, renamed back, is the golden's state
    dict: the same keys and the same arrays, FIR buffers included."""
    tm = golden["tm"]
    ckpt = chip_smoke.rosinality_checkpoint(
        tm, params_from_state_dict(tm, golden["sd"]))
    assert set(ckpt) == {"g_ema", "latent_avg"}
    assert not any(k.startswith(("layer", "to_rgb1.rgb", "up_rgb"))
                   for k in ckpt["g_ema"])
    back = _seq_names_from_rosinality(ckpt)
    assert set(back) == set(golden["sd"])
    for k, v in golden["sd"].items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)


@pytest.mark.parametrize("form", ["wrapped", "flat"])
def test_rosinality_names_convert_as_the_jax_rename(golden, form):
    """A rosinality-named dict converts to the params that the JAX
    converter gives for its seq-named rename.  (The JAX converter takes a
    flat rosinality dict for seq-named, because rosinality's mapping
    network has ``style.`` keys too, and raises; see ROADMAP.md queue 3.)
    """
    tm = golden["tm"]
    params = params_from_state_dict(tm, golden["sd"])
    ckpt = chip_smoke.rosinality_checkpoint(tm, params)
    if form == "flat":
        got = params_from_state_dict(tm, ckpt["g_ema"],
                                     latent_avg=ckpt["latent_avg"])
    else:
        got = params_from_state_dict(tm, ckpt)
    jax_sd = {k: v.numpy() for k, v in jax_rename(ckpt).items()}
    want = params_from_jax(tm, jax.tree_util.tree_map(
        np.asarray, jax_params_from_state_dict(golden["jm"], jax_sd)))
    _assert_params_equal(got, want)
    _assert_params_equal(got, params)
    if form == "flat":
        with pytest.raises(ValueError, match="unrecognized"):
            jax_params_from_state_dict(golden["jm"], {
                k: v.numpy() for k, v in ckpt["g_ema"].items()})


def test_converter_refuses_a_wrong_shape_and_a_partial_load(golden):
    tm, sd = golden["tm"], golden["sd"]
    bad = dict(sd)
    bad["style.1.weight"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError, match="shape"):
        params_from_state_dict(tm, bad)
    partial = {k: v for k, v in sd.items()
               if not k.startswith("layer4.")}
    with pytest.raises(ValueError, match="missing"):
        params_from_state_dict(tm, partial)
    with pytest.raises(ValueError, match="unrecognized"):
        params_from_state_dict(tm, {**sd, "layer4.sconv.bogus": sd[
            "layer2.conv.noise.weight"]})
    # the noise buffers and latent_avg may be absent, as in the reference
    lean = {k: v for k, v in sd.items()
            if not k.startswith(("noises.", "latents."))}
    got = params_from_state_dict(tm, lean)
    init = tm.init_params(seed=0)
    for name, buf in got["noises"].items():
        assert torch.equal(buf, init["noises"][name])


@pytest.mark.parametrize("key,axes", [
    ("to_rgb2.rgb.conv.modulation.weight", (1, 0)),
    ("to_rgb2.rgb.conv.weight", (0, 2, 1, 3, 4))])
def test_converter_refuses_a_transposed_to_rgb_weight(golden, key, axes):
    """Only the noise strength and the to_rgb bias may come in another
    shape of the same size; a transposed to_rgb weight is refused, as the
    JAX converter refuses it, and never loads scrambled."""
    tm, jm, sd = golden["tm"], golden["jm"], golden["sd"]
    bad = dict(sd)
    bad[key] = np.ascontiguousarray(sd[key].transpose(axes))
    assert bad[key].shape != sd[key].shape
    with pytest.raises(ValueError, match="shape"):
        params_from_state_dict(tm, bad)
    with pytest.raises(ValueError, match="shape"):
        jax_params_from_state_dict(jm, bad)


def test_pt_round_trip_under_tmp_path(golden, tmp_path):
    """The golden saved as a torch .pt and read back by the zoo's loader
    (as tests/test_instrument_viz.py does for the JAX zoo)."""
    path = tmp_path / "tiny.pt"
    torch.save({k: torch.from_numpy(v) for k, v in golden["sd"].items()},
               path)
    tm = golden["tm"]
    params = params_from_state_dict(tm, zoo.load_state(str(path)))
    _assert_params_equal(params, golden["want"])
    out = tm(params, golden["z"], fast=False).numpy().transpose(0, 3, 1, 2)
    np.testing.assert_allclose(out, golden["out"], atol=1e-4, rtol=0)


@pytest.fixture
def no_network(monkeypatch):
    """Any attempt to open a connection or fetch a URL fails the test."""
    def refuse(*args, **kwargs):
        raise AssertionError("the zoo tried the network")
    monkeypatch.setattr(socket.socket, "connect", refuse)
    monkeypatch.setattr(urllib.request, "urlopen", refuse)
    monkeypatch.setattr(urllib.request, "urlretrieve", refuse)


@pytest.fixture(scope="module")
def church8(tmp_path_factory):
    """A church-named rosinality file of full-width weights at 8 px (the
    zoo's 512-d mapping network), written by chip_smoke's writer."""
    model = SeqStyleGAN2(8, style_dim=512, n_mlp=8, device="cpu")
    params = model.init_params(seed=4)
    params["latents"] = {"latent_avg": torch.from_numpy(
        np.random.RandomState(5).randn(512).astype(np.float32))}
    root = tmp_path_factory.mktemp("weights")
    torch.save(chip_smoke.rosinality_checkpoint(model, params),
               root / "stylegan2_church.pt")
    return root, params


@pytest.mark.parametrize("how", ["env", "path"])
def test_zoo_loads_a_rosinality_file(church8, monkeypatch, no_network, how):
    root, params = church8
    if how == "env":
        monkeypatch.setenv("REWRITING_TPU_WEIGHTS", str(root))
        model, got = zoo.load_seq_stylegan("church", truncation=0.5, size=8,
                                           device="cpu")
    else:
        monkeypatch.setenv("REWRITING_TPU_WEIGHTS", str(root / "elsewhere"))
        model, got = zoo.load_seq_stylegan(
            "church", path=str(root / "stylegan2_church.pt"),
            truncation=0.5, size=8, device="cpu")
    assert (model.size, model.style_dim, model.n_mlp, model.truncation) == \
        (8, 512, 8, 0.5)
    _assert_params_equal(got, params)


@pytest.mark.parametrize("names", ["seq", "rosinality"])
def test_zoo_reads_a_training_checkpoint_with_args(church8, tmp_path,
                                                  no_network, names):
    """A checkpoint that keeps its ``argparse.Namespace`` under ``args``
    beside ``g_ema`` (as rosinality's training script saves it) loads
    through the port's ``weights_only`` unpickler by ``path=``: with
    seq-named weights equal bit for bit to the JAX zoo's result; with
    rosinality's names (which the JAX converter refuses, ROADMAP.md queue
    3) equal to the weights written."""
    root, params = church8
    ckpt = torch.load(root / "stylegan2_church.pt", weights_only=True)
    if names == "seq":
        ckpt = {"g_ema": jax_rename(ckpt), "latent_avg": ckpt["latent_avg"]}
    ckpt["args"] = argparse.Namespace(size=8, latent=512, n_mlp=8, lr=0.002,
                                      ckpt=None, wandb=False)
    path = str(tmp_path / "stylegan2_church.pt")
    torch.save(ckpt, path)
    with pytest.raises(pickle.UnpicklingError):
        torch.load(path, weights_only=True)
    model, got = zoo.load_seq_stylegan("church", path=path, truncation=0.5,
                                       size=8, device="cpu")
    _assert_params_equal(got, params)
    if names == "seq":
        jm, jp = jax_zoo.load_seq_stylegan("church", path=path,
                                           truncation=0.5, size=8)
        _assert_params_equal(got, params_from_jax(
            model, jax.tree_util.tree_map(np.asarray, jp)))


def test_zoo_missing_file_names_the_file_and_its_url(tmp_path, monkeypatch):
    """A file missing from the weights directory is downloaded, as the JAX
    zoo does; when the download fails (the zoo's URL here a loopback port
    nothing listens on) the error names the file, the directory, the URL
    and the download's own error, and nothing is left behind.  A missing
    ``path=`` raises without trying the network."""
    closed = chip_smoke.closed_url()
    monkeypatch.setattr(zoo, "STYLEGAN2_URL", closed)
    monkeypatch.setenv("REWRITING_TPU_WEIGHTS", str(tmp_path))
    with pytest.raises(FileNotFoundError) as err:
        zoo.load_seq_stylegan("church", device="cpu")
    msg = str(err.value)
    assert "stylegan2_church.pt" in msg and str(tmp_path) in msg
    assert closed + "stylegan2_church.pt" in msg
    assert "Connection refused" in msg
    assert "REWRITING_TPU_WEIGHTS" in msg

    def refuse(*args, **kwargs):
        raise AssertionError("a missing path= tried the network")
    monkeypatch.setattr(urllib.request, "urlopen", refuse)
    with pytest.raises(FileNotFoundError, match="stylegan2_faces.pt"):
        zoo.load_seq_stylegan("faces", path=str(tmp_path / "none.pt"),
                              device="cpu")
    assert os.listdir(tmp_path) == []


def test_weights_dir(monkeypatch, tmp_path):
    monkeypatch.delenv("REWRITING_TPU_WEIGHTS", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    assert zoo.weights_dir() == str(tmp_path / ".cache" / "rewriting_torch")
    monkeypatch.setenv("REWRITING_TPU_WEIGHTS", "/some/dir")
    assert zoo.weights_dir() == "/some/dir"
    assert zoo.STYLEGAN2_ZOO["church"] == ("stylegan2_church.pt", 256)
    assert len(zoo.STYLEGAN2_ZOO) == 8


# ---------------------------------------------------------------------------
# The command lines, on the CPU with a tiny model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    jm = JaxSeqStyleGAN2(SIZE, style_dim=STYLE_DIM, n_mlp=N_MLP,
                         truncation=0.5)
    jp = jm.init_params(jax.random.PRNGKey(6))
    jp = dict(jp)
    jp["latents"] = {"latent_avg": np.random.RandomState(7).randn(
        STYLE_DIM).astype(np.float32)}
    jp = jax.tree_util.tree_map(np.asarray, jp)
    return jm, jp


def _patch_loader(monkeypatch, tiny, seen):
    """zoo.load_seq_stylegan -> the tiny model on the CPU."""
    jm, jp = tiny

    def load(category, truncation=1.0, **kwargs):
        seen.append((category, truncation))
        tm = SeqStyleGAN2(SIZE, style_dim=STYLE_DIM, n_mlp=N_MLP,
                          truncation=truncation, device="cpu")
        return tm, params_from_jax(tm, jp)
    monkeypatch.setattr(zoo, "load_seq_stylegan", load)


def _png(path):
    with open(path, "rb") as f:
        return np.asarray(PIL.Image.open(io.BytesIO(f.read())))


def _assert_within_1_lsb(outdir, jax_dir, n):
    for i in range(n):
        got = _png(os.path.join(outdir, f"{i}.png")).astype(np.int16)
        want = _png(os.path.join(jax_dir, f"{i}.png")).astype(np.int16)
        assert got.shape == want.shape == (SIZE, SIZE, 3)
        assert np.abs(got - want).max() <= 1, i


@pytest.mark.parametrize("fid", [False, True], ids=["clean", "fid"])
def test_sample_main(tiny, tmp_path, monkeypatch, fid):
    seen = []
    _patch_loader(monkeypatch, tiny, seen)
    results = tmp_path / "results"
    argv = ["sample", "--dataset", "church", "--n", "5", "--batch_size",
            "2", "--results", str(results)] + (["--fid_samples"] if fid
                                                else [])
    monkeypatch.setattr(sys, "argv", argv)
    sample.main()
    assert seen == [("church", 0.5)]
    outdir = results / ("church_clean_fid" if fid else "church_clean")
    # (and the job's lockfile, removed when the process exits)
    assert set(os.listdir(outdir)) - {"lockfile.pid"} == set(
        ["+lightbox.html", "done.txt"] + [f"{i}.png" for i in range(5)])
    jm, jp = tiny
    jax_dir = tmp_path / "jax"
    jax_sample.sample_clean(jm, jp, str(jax_dir), n=5, batch_size=2,
                            offset=sample.FID_OFFSET if fid else 0)
    _assert_within_1_lsb(outdir, jax_dir, 5)
    # a finished directory is skipped, as in the JAX package
    with pytest.raises(SystemExit) as done:
        sample.main()
    assert done.value.code == 0 and len(seen) == 1


def test_sample_edited_main(tiny, tmp_path, monkeypatch):
    """The dome2tree request at layer 4 (the registry patched: the tiny
    model has no layer 8) with a 61-step solve (the command line's 2001
    take 90 s on one CPU thread); the files match the JAX sampler's on the
    port's edited weights, and the statistics are cached under
    results/rewrite/stylegan of the working directory."""
    seen, sampled = [], []
    _patch_loader(monkeypatch, tiny, seen)
    mask = os.path.join(MASKS, "church", "dome2tree.json")
    monkeypatch.setattr(sample_edited, "load_mask_info",
                        lambda name: (mask, "church", 4))
    monkeypatch.setattr(sample_edited, "sample_edited", functools.partial(
        sample_edited.sample_edited, niter=61))
    real = sample_edited.sample_clean

    def spy(model, params, outdir, **kwargs):
        sampled.append(params)
        return real(model, params, outdir, **kwargs)
    monkeypatch.setattr(sample_edited, "sample_clean", spy)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "argv", ["sample_edited", "--mask", "dome2tree",
                                      "--single_context", "0", "--n", "4",
                                      "--results", "out"])
    sample_edited.main()
    assert seen == [("church", 0.5)]
    outdir = tmp_path / "out" / "dome2tree_context0"
    assert (outdir / "done.txt").is_file()
    assert (tmp_path / "results" / "rewrite" / "stylegan" / "church" /
            "layer4" / "r2m.npz").is_file()
    jm, jp = tiny
    edited = params_to_numpy(sampled[0])
    changed = np.abs(edited["layer4.sconv.mconv.dconv"]["weight"]
                     - jp["layer4.sconv.mconv.dconv"]["weight"]).max()
    assert changed > 0.1
    jax_dir = tmp_path / "jax"
    jax_sample.sample_clean(jm, edited, str(jax_dir), n=4, batch_size=16)
    _assert_within_1_lsb(outdir, jax_dir, 4)
    with open(mask) as f:
        assert json.load(f)["key"]


def test_sample_fn_is_used(tiny, tmp_path):
    """sample_clean(..., sample_fn=): the images come from sample_fn."""
    jm, jp = tiny
    tm = SeqStyleGAN2(SIZE, style_dim=STYLE_DIM, n_mlp=N_MLP, device="cpu")
    calls = []

    def flat(p, z):
        calls.append(z.shape)
        return torch.full((z.shape[0], SIZE, SIZE, 3), -1.0)
    sample.sample_clean(tm, params_from_jax(tm, jp), str(tmp_path), n=3,
                        batch_size=2, sample_fn=flat)
    assert calls == [(2, STYLE_DIM), (2, STYLE_DIM)]
    assert (_png(tmp_path / "2.png") == 0).all()
