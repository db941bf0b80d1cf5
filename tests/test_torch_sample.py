"""The port's samplers (rewriting_torch/metrics, utils/imgsave)
against the JAX package's.

Same weights in both packages (``params_from_jax``), tiny models, the CPU.
Limits: z, quantisation and masks are exact; images within 1 LSB of a
direct render and of the JAX package's files (tests/test_metrics.py:
235-255 holds its own sampler to the same: the uint8 cast of an fp32 value
that the two forwards compute in other orders may differ by one).
"""

import io
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import PIL.Image
import pytest
import torch

import chip_smoke
from rewriting_tpu.metrics import load_mask as jax_load_mask
from rewriting_tpu.metrics import sample as jax_sample
from rewriting_tpu.models.stylegan2 import SeqStyleGAN2 as JaxSeqStyleGAN2
from rewriting_torch.convert import params_from_jax
from rewriting_torch.metrics import load_mask
from rewriting_torch.metrics.sample import (pad_batch, per_image_z,
                                            quantize_uint8, sample_clean)
from rewriting_torch.metrics.sample_edited import sample_edited
from rewriting_torch.models.stylegan2 import SeqStyleGAN2
from rewriting_torch.utils import imgsave, pidfile
from rewriting_torch.utils.renormalize import (decode_png, encode_png,
                                               renormalize)

torch.set_num_threads(1)

MASKS = os.path.join(os.path.dirname(__file__), "..", "notebooks", "masks",
                     "stylegan")
SIZE, STYLE_DIM, N_MLP = 16, 64, 2


@pytest.fixture(scope="module")
def pair():
    jm = JaxSeqStyleGAN2(SIZE, style_dim=STYLE_DIM, n_mlp=N_MLP)
    jp = jm.init_params(jax.random.PRNGKey(1))
    tm = SeqStyleGAN2(SIZE, style_dim=STYLE_DIM, n_mlp=N_MLP, device="cpu")
    tp = params_from_jax(tm, jax.tree_util.tree_map(np.asarray, jp))
    return jm, jp, tm, tp


def _lsb(a, b):
    return int(np.abs(a.astype(np.int16) - b.astype(np.int16)).max())


def _read(path, decoder="port"):
    with open(path, "rb") as f:
        data = f.read()
    if decoder == "pil":
        return np.asarray(PIL.Image.open(io.BytesIO(data)))
    return decode_png(data)


def test_per_image_z_contract(pair):
    """Image i uses the first z of seed i, as in the JAX package."""
    _, _, tm, _ = pair
    nums = [0, 1, 5, 1000007]
    np.testing.assert_array_equal(per_image_z(tm, nums),
                                  jax_sample.per_image_z(tm, nums))


def test_pad_batch_matches_jax():
    arr = np.arange(12, dtype=np.float32).reshape(3, 4)
    for size in (2, 3, 5):
        np.testing.assert_array_equal(pad_batch(arr, size),
                                      jax_sample.pad_batch(arr, size))


def test_quantize_uint8_matches_jax_and_renormalize():
    """Bit for bit against renormalize's "byte" target (two roundings, then
    the truncating cast), on random values, the clip edges and the integer
    boundaries; against the JAX quantize_uint8 bit for bit on the random
    values and within 1 LSB at the boundaries, where XLA on the CPU fuses
    the multiply-add into one rounding (its docstring, sample.py:64-71)."""
    rng = np.random.RandomState(3)
    random = rng.uniform(-1.3, 1.3, 4000)
    edges = np.concatenate([np.arange(256) / 127.5 - 1.0,
                            [-1.0, 1.0, -2.0, 2.0, 0.0]])
    for values, lsb in ((random, 0), (edges, 1)):
        x = values.astype(np.float32).reshape(1, -1, 1, 1) * np.ones(
            (1, 1, 1, 3), np.float32)
        got = quantize_uint8(torch.from_numpy(x)).numpy()
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, renormalize(np.clip(x, -1, 1),
                                                       "zc", "byte"))
        want = np.asarray(jax_sample.quantize_uint8(jnp.asarray(x)))
        assert _lsb(got, want) <= lsb


@pytest.mark.parametrize("shape", [(7, 5), (6, 9, 1), (4, 3, 2), (9, 6, 3),
                                   (5, 5, 4), (1, 1, 3)])
def test_png_round_trip(shape):
    """encode_png -> the port's decoder and PIL give back the array."""
    img = np.random.RandomState(len(shape)).randint(0, 256, shape).astype(
        np.uint8)
    data = encode_png(img)
    want = img.reshape(img.shape[:2] + (-1,))
    np.testing.assert_array_equal(decode_png(data), want)
    pil = np.asarray(PIL.Image.open(io.BytesIO(data)))
    np.testing.assert_array_equal(pil.reshape(want.shape), want)


def test_encode_png_refuses_what_it_cannot_write():
    with pytest.raises(TypeError):
        encode_png(np.zeros((2, 2, 3), np.float32))
    with pytest.raises(ValueError):
        encode_png(np.zeros((2, 2, 5), np.uint8))


def test_sample_clean_writes_images(pair, tmp_path):
    """+lightbox.html and n PNGs; image 3, read by the port's decoder and by
    PIL, within 1 LSB of a direct render of its z (tests/test_metrics.py:
    235-255)."""
    _, _, tm, tp = pair
    out = str(tmp_path / "clean")
    sample_clean(tm, tp, out, n=5, batch_size=2)
    assert sorted(os.listdir(out)) == ["+lightbox.html"] + [
        f"{i}.png" for i in range(5)]
    direct = renormalize(np.clip(tm(tp, per_image_z(tm, [3]))[0].numpy(),
                                 -1, 1), "zc", "byte")
    for decoder in ("port", "pil"):
        img = _read(os.path.join(out, "3.png"), decoder)
        assert img.shape == (SIZE, SIZE, 3)
        assert _lsb(img, direct) <= 1


def test_sample_clean_matches_jax_files(pair, tmp_path):
    """The same weights sampled by both packages' samplers (offset seeds, a
    padded tail batch) give PNGs within 1 LSB of each other."""
    jm, jp, tm, tp = pair
    sample_clean(tm, tp, str(tmp_path / "port"), n=5, batch_size=4,
                 offset=7)
    jax_sample.sample_clean(jm, jp, str(tmp_path / "jax"), n=5,
                            batch_size=4, offset=7)
    for i in range(5):
        got = _read(str(tmp_path / "port" / f"{i}.png"))
        want = _read(str(tmp_path / "jax" / f"{i}.png"), "pil")
        assert _lsb(got, want) <= 1, i


def test_sample_edited_writes_edited_images(pair, tmp_path, monkeypatch):
    """The dome2tree request at layer 4 (a 61-step solve on the tiny
    model), then 4 samples: they differ from the clean ones and match a
    direct render of the edited weights."""
    _, _, tm, tp = pair
    monkeypatch.setenv("REWRITING_TPU_MASKS", MASKS)
    request = load_mask.load_mask_request("dome2tree")
    gw = sample_edited(tm, tp, request, 4, str(tmp_path / "edited"), n=4,
                       batch_size=4, niter=61)
    sample_clean(tm, tp, str(tmp_path / "clean"), n=4, batch_size=4)
    assert not torch.equal(gw.target_weight(),
                           tp["layer4.sconv.mconv.dconv"]["weight"])
    changed = [_lsb(_read(str(tmp_path / "edited" / f"{i}.png")),
                    _read(str(tmp_path / "clean" / f"{i}.png")))
               for i in range(4)]
    assert max(changed) > 1
    direct = renormalize(np.clip(tm(gw.params, per_image_z(tm, [2]))[0]
                                 .numpy(), -1, 1), "zc", "byte")
    assert _lsb(_read(str(tmp_path / "edited" / "2.png")), direct) <= 1


def test_load_mask_info_matches_jax(monkeypatch, tmp_path):
    """Every published edit present in the masks directory (a copy of the
    repo's) resolves as in the JAX package; a missing one raises naming
    the file, its URL and $REWRITING_TPU_MASKS once its download fails (the
    registry's URL at a loopback port nothing listens on)."""
    closed = chip_smoke.closed_url()
    monkeypatch.setattr(load_mask, "MASK_URLS", closed)
    masks = str(tmp_path / "masks")
    shutil.copytree(MASKS, masks)
    monkeypatch.setenv("REWRITING_TPU_MASKS", masks)
    for name, (dataset, fname, layer) in load_mask.name2info.items():
        assert jax_load_mask.name2info[name] == [dataset, fname, layer]
        if not os.path.exists(os.path.join(MASKS, dataset, fname)):
            with pytest.raises(FileNotFoundError, match=fname) as e:
                load_mask.load_mask_info(name)
            assert closed + fname in str(e.value)
            continue
        assert load_mask.load_mask_info(name) == \
            jax_load_mask.load_mask_info(name)
        with open(os.path.join(MASKS, dataset, fname)) as f:
            assert load_mask.load_mask_request(name) == json.load(f)
    monkeypatch.setenv("REWRITING_TPU_MASKS", str(tmp_path / "none"))
    with pytest.raises(FileNotFoundError, match="REWRITING_TPU_MASKS"):
        load_mask.load_mask_info("dome2tree")


def test_save_image_set_and_pidfile(tmp_path):
    """Nested image arrays with a %d pattern, skipped when newer than the
    source; a reserved directory and its done marker."""
    imgs = np.random.RandomState(2).randint(0, 256, (2, 3, 4, 5, 3)).astype(
        np.uint8)
    pattern = str(tmp_path / "set" / "img_%d_%d.png")
    imgsave.save_image_set(imgs, pattern)
    for i in range(2):
        for j in range(3):
            np.testing.assert_array_equal(_read(pattern % (i, j)), imgs[i, j])
    source = tmp_path / "source"
    source.write_text("x")
    os.utime(source, (0, 0))
    os.remove(pattern % (0, 0))
    imgsave.save_image_set(imgs, pattern, sourcefile=str(source))
    assert not os.path.exists(pattern % (0, 0))   # last file is newer
    with pytest.raises(ValueError, match="png"):
        imgsave.save_png(imgs[0, 0], str(tmp_path / "x.jpg"))
    job = pidfile.reserve_dir(str(tmp_path / "job"))
    pidfile.mark_job_done(job)
    assert os.path.isfile(os.path.join(job, "done.txt"))
