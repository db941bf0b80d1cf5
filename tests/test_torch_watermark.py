"""The port's §5.2 watermark erase against the JAX package's, on a tiny
SeqStyleGAN2 with the same weights, at layer 6 (the command line's
default), with the published ``multikey_markandbottom`` request's masks
on images 0-23 of 24 seeded z (its image numbers modulo 24: they name
images of the published model, and the weights here are random).

- ``erasemethod="none"``: the same images; every PNG within 1 LSB of the
  JAX package's.
- ``"ours"`` (two repetitions of ``apply_erase``): each repetition's
  losses held as tests/test_torch_rewriter_ops.py holds the erase (the
  first within 1e-5 abs, every one within 5e-4 abs) and the change in
  span(D) (1e-4 relative).  The erased weights differ between the
  packages by the L1 ties of that file's docstring, so the images are
  held on the same weights: every PNG within 1 LSB of the JAX package's
  ``save_zds_images`` of the port's erased weights, and of a direct
  render.
- The statistics pass of the covariance model fills the cache that the
  erase's rewriter reads.
- ``"gandissect"`` zeroes the weight along its units (held against the
  JAX package in tests/test_torch_rewriter_quantiles.py); an unknown
  method raises ``ValueError``.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from rewriting_tpu.metrics import watermark as jax_watermark
from rewriting_tpu.models import SeqStyleGAN2 as JaxSeqStyleGAN2
from rewriting_tpu.rewrite import SeqStyleGanRewriter as JaxRewriter
from rewriting_torch.convert import params_from_jax, params_to_numpy
from rewriting_torch.metrics import watermark
from rewriting_torch.models import SeqStyleGAN2
from rewriting_torch.rewrite import SeqStyleGanRewriter, projected_conv
from rewriting_torch.utils.renormalize import decode_png, renormalize

torch.set_num_threads(1)

REQUEST = os.path.join(os.path.dirname(__file__), "..", "notebooks", "masks",
                       "stylegan", "church", "multikey_markandbottom.json")
LAYER, NITERS, NREPS, SAMPLES = 6, 21, 2, 24


@pytest.fixture(scope="module")
def setup():
    with open(REQUEST) as f:
        request = json.load(f)
    request = {k: ([[i % SAMPLES, m] for i, m in v] if k == "key"
                   else [v[0] % SAMPLES, v[1]])
               for k, v in request.items()}
    jm = JaxSeqStyleGAN2(16, style_dim=32, n_mlp=2)
    jp = jax.tree_util.tree_map(np.asarray,
                                jm.init_params(jax.random.PRNGKey(7)))
    tm = SeqStyleGAN2(16, style_dim=32, n_mlp=2, device="cpu")
    return {"request": request, "jm": jm, "jp": jp, "tm": tm,
            "tp": params_from_jax(tm, jp)}


def _record(monkeypatch, cls, jax_side, log):
    """Keep each apply_erase's per-step losses in `log`."""
    original = cls.apply_erase

    def apply_erase(self, request, **kwargs):
        if not jax_side:
            out = original(self, request, **kwargs)
            log.append(np.asarray(out))
            return out
        seen = []
        out = original(self, request,
                       update_callback=lambda i, l: seen.append(float(l)),
                       **kwargs)
        log.append(np.asarray(seen))
        return out
    monkeypatch.setattr(cls, "apply_erase", apply_erase)


def _pngs(directory):
    names = sorted(n for n in os.listdir(directory) if n.endswith(".png"))
    images = {}
    for name in names:
        with open(os.path.join(directory, name), "rb") as f:
            images[name] = decode_png(f.read()).astype(np.int16)
    return images


def _run_both(setup, tmp_path, monkeypatch, method):
    logs = {"t": [], "j": []}
    _record(monkeypatch, SeqStyleGanRewriter, False, logs["t"])
    _record(monkeypatch, JaxRewriter, True, logs["j"])
    kw = dict(niters=NITERS, nreps=NREPS, erasemethod=method,
              sample_size=SAMPLES)
    gw = watermark.erase_watermark(
        setup["tm"], setup["tp"], setup["tp"], setup["request"], LAYER,
        str(tmp_path / "port"), **kw)
    jax_watermark.erase_watermark(
        setup["jm"], setup["jp"], setup["jp"], setup["request"], LAYER,
        str(tmp_path / "jax"), save_images=method == "none", **kw)
    got = _pngs(str(tmp_path / "port" / "images"))
    assert sorted(got) == sorted(f"image_{i}.png" for i in range(SAMPLES))
    assert os.path.isfile(str(tmp_path / "port" / "images" /
                              "+lightbox.html"))
    return gw, got, logs


def _assert_within_1_lsb(got, want):
    assert sorted(got) == sorted(want)
    for name in want:
        assert np.abs(got[name] - want[name]).max() <= 1, name


def test_none_matches_jax(setup, tmp_path, monkeypatch):
    gw, got, logs = _run_both(setup, tmp_path, monkeypatch, "none")
    _assert_within_1_lsb(got, _pngs(str(tmp_path / "jax" / "images")))
    assert logs["t"] == logs["j"] == []
    assert torch.equal(gw.target_weight(),
                       gw.original_params[gw.weight_stage()]["weight"])
    assert os.path.isfile(str(tmp_path / "port" / "r2m.npz"))


def test_ours_matches_jax(setup, tmp_path, monkeypatch):
    gw, got, logs = _run_both(setup, tmp_path, monkeypatch, "ours")
    assert len(logs["t"]) == len(logs["j"]) == NREPS
    for losses, jlosses in zip(logs["t"], logs["j"]):
        assert losses.shape == jlosses.shape == (NITERS,)
        np.testing.assert_allclose(losses[0], jlosses[0], atol=1e-5, rtol=0)
        np.testing.assert_allclose(losses, jlosses, atol=5e-4, rtol=0)
    w0 = gw.original_params[gw.weight_stage()]["weight"]
    delta = gw.target_weight() - w0
    d = gw.multi_key_from_selection(setup["request"]["key"], rank=1)
    assert float(delta.abs().max()) > 1e-3
    assert (delta - projected_conv(delta, d)).norm() <= 1e-4 * delta.norm()
    # the images of the erased weights, as the JAX package saves them
    jdir = str(tmp_path / "jax_of_port")
    jax_watermark.save_zds_images(jdir, setup["jm"],
                                  params_to_numpy(gw.params), gw.zds)
    _assert_within_1_lsb(got, _pngs(jdir))
    img = setup["tm"](gw.params, gw.zds.zs[5:6])[0].numpy()
    direct = renormalize(np.clip(img, -1, 1), "zc", "byte").astype(np.int16)
    assert np.abs(got["image_5.png"] - direct).max() <= 1


def test_gandissect_raises(setup, tmp_path):
    """gandissect no longer raises: it zeroes the weight's component along
    its `drank` one-hot units; an unknown method raises ValueError."""
    gw = watermark.erase_watermark(
        setup["tm"], setup["tp"], None, setup["request"], LAYER,
        str(tmp_path), erasemethod="gandissect", drank=2,
        sample_size=SAMPLES, save_images=False)
    units = gw.multi_key_from_selection(setup["request"]["key"],
                                        rank=2).argmax(1)
    w = gw.target_weight()
    assert float(w[..., units, :, :].abs().max()) == 0.0
    assert float(gw.original_params[gw.weight_stage()]["weight"][
        ..., units, :, :].abs().max()) > 0
    with pytest.raises(ValueError, match="erasemethod"):
        watermark.erase_watermark(
            setup["tm"], setup["tp"], None, setup["request"], LAYER,
            str(tmp_path), erasemethod="nope", sample_size=4)


def test_covariance_model_fills_the_cache(setup, tmp_path):
    """The statistics come from the covariance model's pass: the erase's
    rewriter reads them from the cache (a changed params tree for the
    erase leaves the moment as the covariance model's)."""
    cov = watermark.erase_watermark(
        setup["tm"], setup["tp"], setup["tp"], setup["request"], LAYER,
        str(tmp_path), erasemethod="none", sample_size=SAMPLES,
        save_images=False)
    other = {k: dict(v) for k, v in setup["tp"].items()}
    other["style.1"]["bias"] = other["style.1"]["bias"] + 1.0
    gw = watermark.erase_watermark(
        setup["tm"], other, None, setup["request"], LAYER, str(tmp_path),
        erasemethod="none", sample_size=SAMPLES, save_images=False)
    assert torch.equal(gw.c_matrix, cov.c_matrix)


def test_main(setup, tmp_path, monkeypatch):
    """The command line with the zoo's loader patched to the tiny model:
    two loads (truncation 1.0 for the statistics, 0.5 for the erase), the
    output directory named as the JAX package names it, the images of the
    erased model and the done marker."""
    from rewriting_torch.models import zoo
    loads = []

    def load(category, truncation=1.0, **kwargs):
        loads.append((category, truncation))
        model = SeqStyleGAN2(16, style_dim=32, n_mlp=2,
                             truncation=truncation, device="cpu")
        return model, setup["tp"]
    monkeypatch.setattr(zoo, "load_seq_stylegan", load)
    masks = os.path.join(os.path.dirname(__file__), "..", "notebooks",
                         "masks")
    outdir = tmp_path / "results"
    watermark.main(["--request", "building2sky", "--requestdir", masks,
                    "--sample_size", "8", "--niters", "5", "--outdir",
                    str(outdir)])
    assert loads == [("church", 1.0), ("church", 0.5)]
    done = outdir / "erase-stylegan-church-building2sky-6-1-5-0.05-ours-1-2"
    assert (done / "done.txt").is_file()
    assert sorted(os.listdir(done / "images")) == sorted(
        ["+lightbox.html"] + [f"image_{i}.png" for i in range(8)])
