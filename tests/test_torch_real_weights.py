"""The port's gated real-weights suite: one counterpart for each test of
``tests/test_real_weights.py``, with its parametrisation, assertions and
tolerances, on the CPU.

Runs only for the published files present under ``$REWRITING_TPU_WEIGHTS``
(``scripts/torch_fetch_weights.py`` fills it where a network is at hand;
``scripts/torch_real_weights_report.py`` runs this suite and counts its
outcomes a file); every test skips naming its missing file, so without the
files the suite passes nothing and fails nothing.  A test never downloads:
it checks the file before calling a loader that would fetch it.  It
imports only the port, numpy and pytest, so it also runs where jax is
absent.  What each test verifies when it can run:

- all 8 + 8 published zoo checkpoints load and render sane, deterministic
  images (reference utils/stylegan2/__init__.py:17-47, utils/proggan.py:
  8-30);
- StyleGAN2-church and ProgGAN-church match the reference torch code's
  outputs on the same checkpoint (``$REWRITING_TPU_WEIGHTS/goldens/*.npz``,
  written by ``scripts/make_goldens.py`` where the reference is at hand)
  to 3e-4 of their scale;
- FID with the real Inception is self-consistent and matches pytorch-fid's
  value on the same pixels to 0.1;
- UPerNet with the released unified-parsing weights labels a church render
  as building, sky or tree;
- LPIPS's official lin heads load and re-weight the distance; LPIPS with
  the real VGG16 is 0 at identity and grows with noise;
- a published edit request drives a visible edit;
- SlimNet's CelebA checkpoint loads and classifies.
"""

import json
import os

import numpy as np
import pytest
import torch

from rewriting_torch.metrics.load_mask import masks_dir
from rewriting_torch.models.zoo import (PROGGAN_ZOO, STYLEGAN2_ZOO,
                                        load_proggan, load_seq_stylegan,
                                        load_state, weights_dir)
from rewriting_torch.utils.zdataset import standard_z_sample

torch.set_num_threads(1)

WD = weights_dir()
DEVICE = "cpu"


def _have(*rel):
    return os.path.isfile(os.path.join(WD, *rel))


def requires(*rel):
    return pytest.mark.skipif(
        not _have(*rel),
        reason=f"{os.path.join(*rel)} not in $REWRITING_TPU_WEIGHTS ({WD})")


def _z(model, seed=0, n=1):
    return standard_z_sample(n, model.z_dim, seed=seed)


def _render(model, params, z) -> np.ndarray:
    with torch.no_grad():
        return model(params, z).cpu().numpy()


# ---------------------------------------------------------------------------
# zoo loaders render
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("category", sorted(STYLEGAN2_ZOO))
def test_stylegan2_zoo_loads_and_renders(category):
    filename, size = STYLEGAN2_ZOO[category]
    if not _have(filename):
        pytest.skip(f"{filename} not in $REWRITING_TPU_WEIGHTS ({WD})")
    model, params = load_seq_stylegan(category, truncation=0.5,
                                      device=DEVICE)
    img = _render(model, params, _z(model))
    assert img.shape == (1, size, size, 3)
    assert np.isfinite(img).all()
    # real generators produce structured images in roughly [-1, 1]
    assert 0.05 < img.std() < 1.5, img.std()
    assert np.abs(img).max() < 4.0
    np.testing.assert_array_equal(img, _render(model, params, _z(model)))


@pytest.mark.parametrize("domain", sorted(PROGGAN_ZOO))
def test_proggan_zoo_loads_and_renders(domain):
    filename = PROGGAN_ZOO[domain]
    if not _have(filename):
        pytest.skip(f"{filename} not in $REWRITING_TPU_WEIGHTS ({WD})")
    model, params = load_proggan(domain, device=DEVICE)
    img = _render(model, params, _z(model))
    assert img.shape[0] == 1 and img.shape[-1] == 3
    assert np.isfinite(img).all()
    assert 0.05 < img.std() < 1.5, img.std()


# ---------------------------------------------------------------------------
# output fidelity against the reference torch code on the same checkpoint
# ---------------------------------------------------------------------------

def _forward_fixture(name):
    path = os.path.join(WD, "goldens", name)
    if not os.path.isfile(path):
        pytest.skip(f"goldens/{name} not in $REWRITING_TPU_WEIGHTS ({WD}); "
                    "scripts/make_goldens.py writes it where the reference "
                    "is at hand")
    return np.load(path)


def _matches_reference(model, params, fx):
    z, want = fx["z"], fx["out"]
    np.testing.assert_array_equal(z, _z(model))     # the same contract
    from rewriting_torch.ops.precision import apply_parity_tier
    apply_parity_tier()
    got = np.transpose(_render(model, params, z), (0, 3, 1, 2))
    scale = max(np.abs(want).max(), 1.0)
    np.testing.assert_allclose(got / scale, want / scale, atol=3e-4)


@requires("stylegan2_church.pt")
def test_stylegan2_church_matches_reference_torch():
    fx = _forward_fixture("stylegan2_church_forward.npz")
    model, params = load_seq_stylegan("church", truncation=0.5,
                                      device=DEVICE)
    _matches_reference(model, params, fx)


@requires(PROGGAN_ZOO["church"])
def test_proggan_church_matches_reference_torch():
    fx = _forward_fixture("proggan_church_forward.npz")
    model, params = load_proggan("church", device=DEVICE)
    _matches_reference(model, params, fx)


# ---------------------------------------------------------------------------
# FID with the real Inception checkpoint
# ---------------------------------------------------------------------------

@requires("pt_inception-2015-12-05.pth")
def test_fid_real_inception_self_consistency():
    from rewriting_torch.metrics.fid import (FeatureExtractor,
                                             calculate_frechet_distance,
                                             compute_feature_stats)
    fe = FeatureExtractor(batch_size=16, device=DEVICE)
    rng = np.random.RandomState(0)
    imgs = rng.uniform(-1, 1, (48, 64, 64, 3)).astype(np.float32)
    feats = fe(imgs[:16])
    assert feats.shape == (16, 2048) and np.isfinite(feats).all()
    np.testing.assert_allclose(fe(imgs[:16]), feats, atol=1e-4)
    mu_a, s_a = compute_feature_stats([imgs[:24], imgs[24:]], fe)
    fid_aa = calculate_frechet_distance(mu_a, s_a, mu_a, s_a)
    assert abs(fid_aa) < 1e-3, fid_aa
    shifted = np.clip(imgs + 0.5, -1, 1)
    mu_b, s_b = compute_feature_stats([shifted[:24], shifted[24:]], fe)
    fid_ab = calculate_frechet_distance(mu_a, s_a, mu_b, s_b)
    assert fid_ab > 1.0, fid_ab


@requires("pt_inception-2015-12-05.pth")
@requires("goldens", "fid_parity.json")
def test_fid_matches_pytorch_fid_reference():
    """FID between two fixed image sets within 0.1 of pytorch-fid's value
    on the same pixels (``scripts/make_goldens.py::make_fid_parity_golden``;
    reference metrics/fid.py:137-187): the Inception conversion, the
    bilinear 299 resize, the uint8 normalization and the Frechet solve end
    to end."""
    from rewriting_torch.metrics.fid import (FeatureExtractor,
                                             calculate_frechet_distance,
                                             compute_feature_stats,
                                             parity_images)
    with open(os.path.join(WD, "goldens", "fid_parity.json")) as f:
        spec = json.load(f)
    fe = FeatureExtractor(batch_size=16, device=DEVICE)

    def stats(seed):
        imgs = parity_images(seed, spec["n"], spec["size"])
        bs = fe.batch_size
        return compute_feature_stats(
            [imgs[i:i + bs] for i in range(0, len(imgs), bs)], fe)

    ours = calculate_frechet_distance(*stats(spec["seed_a"]),
                                      *stats(spec["seed_b"]))
    assert abs(ours - spec["fid"]) <= 0.1, (ours, spec["fid"])


# ---------------------------------------------------------------------------
# the segmenter with the released unified-parsing weights
# ---------------------------------------------------------------------------

@requires("upp", "encoder_epoch_40.pth")
@requires("stylegan2_church.pt")
def test_upernet_real_weights_labels_church():
    from rewriting_torch.segment import load_segmenter
    seg, labels = load_segmenter("netp", device=DEVICE)
    model, params = load_seq_stylegan("church", truncation=0.5,
                                      device=DEVICE)
    img = _render(model, params, _z(model, seed=1))
    out = seg.segment_batch(torch.from_numpy(np.clip(img, -1, 1)))
    objmap = out.cpu().numpy()[0, 0]
    areas = np.bincount(objmap.reshape(-1), minlength=len(labels))
    top = [labels[i] for i in np.argsort(-areas)[:5]]
    assert any(name in top for name in ("building", "sky", "tree")), top


# ---------------------------------------------------------------------------
# LPIPS with the real VGG16 features
# ---------------------------------------------------------------------------

def _nchw(images: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(images.transpose(0, 3, 1,
                                                                  2)))


@requires("vgg16_features.pth")
@requires("lpips_vgg_lins.pth")
def test_lpips_real_lin_heads_convert_and_rescale():
    """The official lin heads load through the validating converter, and
    the calibrated distances differ from the uniform heads' (the heads
    re-weight channels)."""
    from rewriting_torch.metrics.lpips import LPIPS, params_from_torch
    vgg_sd = load_state(os.path.join(WD, "vgg16_features.pth"))
    lin_sd = load_state(os.path.join(WD, "lpips_vgg_lins.pth"))
    calibrated = params_from_torch(vgg_sd, lin_sd)
    uniform = params_from_torch(vgg_sd, None)
    for lin, c in zip(calibrated["lins"], (64, 128, 256, 512, 512)):
        w = lin["weight"].numpy()
        assert w.shape == (c,) and np.isfinite(w).all()
        assert (w >= 0).all(), "official heads are non-negative"
    rng = np.random.RandomState(0)
    a = rng.uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)
    b = np.clip(a + 0.3 * rng.randn(*a.shape).astype(np.float32), -1, 1)
    with torch.no_grad():
        d_cal = float(LPIPS(calibrated, spatial=True, device=DEVICE)(
            _nchw(a), _nchw(b))[0])
        d_uni = float(LPIPS(uniform, spatial=True, device=DEVICE)(
            _nchw(a), _nchw(b))[0])
    assert d_cal > 0 and d_uni > 0
    assert abs(d_cal - d_uni) / max(d_cal, d_uni) > 1e-3


@requires("vgg16_features.pth")
def test_lpips_real_vgg_monotone():
    from rewriting_torch.metrics.distances import PerceptualLoss
    loss = PerceptualLoss(device=DEVICE)
    rng = np.random.RandomState(0)
    a = rng.uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)
    d0 = float(loss(_nchw(a), _nchw(a)).mean())
    assert abs(d0) < 1e-5, d0
    prev = d0
    for amp in (0.05, 0.2, 0.6):
        b = np.clip(a + amp * rng.randn(*a.shape).astype(np.float32),
                    -1, 1)
        d = float(loss(_nchw(a), _nchw(b)).mean())
        assert d > prev, (amp, d, prev)
        prev = d


# ---------------------------------------------------------------------------
# a published edit request drives an edit end to end
# ---------------------------------------------------------------------------

@requires("stylegan2_church.pt")
def test_published_mask_drives_edit():
    path = os.path.join(masks_dir(), "church", "dome2spire.json")
    ref_path = os.path.join(os.path.dirname(__file__), "..", "notebooks",
                            "masks", "stylegan", "church", "snt.json")
    for candidate in (path, ref_path):
        if os.path.isfile(candidate):
            path = candidate
            break
    else:
        pytest.skip(f"no published church edit request: neither {path} "
                    f"nor {ref_path}")
    with open(path) as f:
        request = json.load(f)
    from rewriting_torch.rewrite import SeqStyleGanRewriter
    from rewriting_torch.utils.zdataset import z_dataset_for_model
    model, params = load_seq_stylegan("church", truncation=0.5,
                                      device=DEVICE)
    # the JAX test's 100 z stop short of the images a published request
    # names (dome2spire pastes from image 960): as many z as it needs
    named = [request[k][0] for k in ("query", "object", "paste")
             if k in request] + [key[0] for key in request.get("key", [])]
    zds = z_dataset_for_model(model, max(100, max(named) + 1))
    gw = SeqStyleGanRewriter(model, params, zds, layernum=8,
                             stats_batch_size=10, device=DEVICE)
    imgnum = request["paste"][0]
    before = gw.render_image(imgnum).astype(np.float32)
    gw.apply_edit(request, rank=1, niter=101, piter=10, lr=0.05)
    after = gw.render_image(imgnum).astype(np.float32)
    assert np.abs(after - before).max() > 8.0     # a visible change


# ---------------------------------------------------------------------------
# the SlimNet attribute classifier with the real celeba_20.pth
# ---------------------------------------------------------------------------

@requires("celeba_20.pth")
def test_slimnet_real_checkpoint_loads_and_classifies():
    """pytorch-slim-cnn's CelebA training checkpoint loads through the
    validating converter and classifies a rendered face batch with finite,
    non-degenerate attribute logits."""
    from rewriting_torch.metrics.slimnet import slimnet_classifier
    clf = slimnet_classifier(os.path.join(WD, "celeba_20.pth"),
                             device=DEVICE)
    if _have("stylegan2_faces.pt"):
        model, params = load_seq_stylegan("faces", truncation=0.5,
                                          device=DEVICE)
        imgs = _render(model, params, _z(model, n=4))
    else:
        rng = np.random.RandomState(0)
        imgs = rng.uniform(-1, 1, (4, 128, 128, 3)).astype(np.float32)
    logits = clf.logits(np.clip(imgs, -1, 1)).cpu().numpy()
    assert logits.shape == (4, 40) and np.isfinite(logits).all()
    assert logits.std() > 1e-4     # not a collapsed or garbage load
    flags = clf(np.clip(imgs, -1, 1)).cpu().numpy()
    assert flags.shape == (4,) and flags.dtype == bool
