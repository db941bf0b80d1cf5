"""The port's LPIPS, its damage metric and the all-weights "overfit"
baseline against the JAX package's.

- VGG16's taps against tests/goldens/vgg16_taps.npz (made by torchvision;
  atol 1e-4, rtol 1e-3, as tests/test_vgg_overfit.py holds the JAX
  package) and against the JAX function (1e-5 of the largest entry).
- LPIPS, masked and unmasked, and its spatial map against the JAX
  package's on the same seeded VGG16 weights (1e-5 relative; measured
  5e-7); ``PerceptualLoss`` likewise; ``lins_from_state_dict`` in its
  three key layouts and its refusals; ``default_lpips_params`` from files.
- ``compute_dl`` with l1, lpips and lpips_unmasked on PNGs and npz
  segmentations written by the test (one at another size, one as a
  ``.pth``), against the JAX package's (1e-5 relative), and its command
  line.
- The overfit baseline on a tiny ProgGAN against the JAX package's:
  ``all_weights_insert`` towards the request's pasted image plus seeded
  noise of 1e-2, the first step's gradient of every leaf within 1e-4 of
  the leaf's largest entry and 8 steps' losses within 1e-4 relative (the
  JAX package's read from inside its jitted step), with a VGG16 relu3_3
  feature term too; every leaf moved, and ``revert`` restores every
  leaf.  On the pasted image itself the residual is exactly 0 outside
  the object inside the box, where L1 has no gradient: torch.abs takes
  0, the JAX package's jitted step the sign of its own rounding (jnp.abs
  takes +1 at 0), so there the first gradients differ by the order of
  their size (its eager gradient differs from its jitted one likewise);
  ``apply_overfit`` on it is held by its first loss (1e-5), the callback
  and revert.
- The solves (their precomputed terms too) and the overfit baseline run
  with cuDNN's deterministic algorithms, and put the flags back after.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import blob
from rewriting_tpu.metrics import distances as jax_distances
from rewriting_tpu.metrics import lpips as jax_lpips
from rewriting_tpu.models import ProgressiveGenerator as JaxProgGAN
from rewriting_tpu.rewrite import ProgressiveGanRewriter as JaxRewriter
from rewriting_tpu.utils.zdataset import z_dataset_for_model as jax_zds
from rewriting_torch.convert import params_from_jax
from rewriting_torch.metrics import distances, load_seg, lpips, segio
from rewriting_torch.models import ProgressiveGenerator
from rewriting_torch.rewrite import ProgressiveGanRewriter
from rewriting_torch.rewrite import solve
from rewriting_torch.utils.imgsave import save_png
from rewriting_torch.utils.renormalize import mask_to_url
from rewriting_torch.utils.zdataset import z_dataset_for_model

torch.set_num_threads(1)

TAPS = ["relu1_2", "relu2_2", "relu3_3", "relu4_3", "relu5_3"]


def _close(got, want, rel=1e-5):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-12)
    np.testing.assert_allclose(got, want, atol=rel * scale, rtol=0)


def _nchw(x):
    return torch.as_tensor(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def _jax_tree(params):
    return jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), params)


@pytest.fixture(scope="module")
def vgg(goldens):
    g = goldens("vgg16_taps")
    sd = {k[3:]: g[k] for k in g.files if k.startswith("sd.")}
    return g, sd


def test_vgg16_taps_match_golden_and_jax(vgg):
    g, sd = vgg
    params = lpips.params_from_torch(sd)
    taps = lpips.vgg16_taps(params, torch.as_tensor(g["x"]))
    jtaps = jax_lpips.vgg16_taps(jax_lpips.params_from_torch(sd),
                                 jnp.asarray(np.transpose(g["x"],
                                                          (0, 2, 3, 1))))
    assert len(taps) == 5
    for tap, jtap, name in zip(taps, jtaps, TAPS):
        np.testing.assert_allclose(tap.numpy(), g[f"tap.{name}"], atol=1e-4,
                                   rtol=1e-3, err_msg=name)
        _close(tap.numpy(), np.transpose(np.asarray(jtap), (0, 3, 1, 2)))


@pytest.fixture(scope="module")
def images():
    rng = np.random.RandomState(0)
    a = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.3, a.shape), -1, 1).astype(np.float32)
    mask = (rng.rand(2, 32, 32) > 0.4).astype(np.float32)
    return a, b, mask


@pytest.mark.parametrize("spatial", [True, False])
@pytest.mark.parametrize("masked", [False, True])
def test_lpips_matches_jax(images, spatial, masked):
    a, b, mask = images
    params = lpips.init_params(0)
    model = lpips.LPIPS(params, spatial=spatial, device="cpu")
    got = model(_nchw(a), _nchw(b),
                torch.as_tensor(mask) if masked else None)
    want = jax_lpips.LPIPS(spatial=spatial)(_jax_tree(params), a, b,
                                            mask if masked else None)
    assert got.shape == (2,)
    _close(got, want)
    assert not any(p.requires_grad for p in model.parameters())


def test_distance_map_and_perceptual_loss_match_jax(images):
    a, b, mask = images
    params = lpips.init_params(0)
    got = lpips.LPIPS(params, device="cpu").distance_map(_nchw(a), _nchw(b))
    want = jax_lpips.LPIPS().distance_map(_jax_tree(params), a, b)
    assert got.shape == (2, 32, 32)
    _close(got, want)
    loss = distances.PerceptualLoss(params=params, device="cpu")
    jloss = jax_distances.PerceptualLoss(params=_jax_tree(params))
    raw = loss(_nchw(a), _nchw(b))
    assert raw.shape == (2, 1, 32, 32)
    _close(raw, np.transpose(np.asarray(jloss(a, b)), (0, 1, 2, 3)))
    _close(loss(_nchw(a), _nchw(b), torch.as_tensor(mask[:, None])),
           jloss(a, b, mask))
    with pytest.raises(NotImplementedError):
        distances.PerceptualLoss(net="alex", params=params, device="cpu")
    with pytest.raises(ValueError):
        distances.PerceptualLoss(precision="fp8", params=params,
                                 device="cpu")


@pytest.mark.parametrize("layout", ["lin{}.model.1.weight", "lin{}.1.weight",
                                    "lin{}.weight"])
def test_lins_from_state_dict_layouts(layout):
    rng = np.random.RandomState(1)
    sd = {layout.format(i): rng.rand(1, c, 1, 1).astype(np.float32)
          for i, c in enumerate((64, 128, 256, 512, 512))}
    lins = lpips.lins_from_state_dict(sd)
    jlins = jax_lpips.lins_from_state_dict(sd)
    for got, want in zip(lins, jlins):
        np.testing.assert_array_equal(got["weight"].numpy(),
                                      np.asarray(want["weight"]))
    with pytest.raises(KeyError, match="lin0"):
        lpips.lins_from_state_dict({k: v for k, v in sd.items()
                                    if not k.startswith("lin0")})
    bad = dict(sd)
    bad[layout.format(2)] = np.ones((1, 7, 1, 1), np.float32)
    with pytest.raises(ValueError, match="lin2"):
        lpips.lins_from_state_dict(bad)
    with pytest.raises(ValueError, match="unconsumed"):
        lpips.lins_from_state_dict({**sd, "extra": np.ones(3)})
    for got, c in zip(lpips.uniform_lins(), (64, 128, 256, 512, 512)):
        assert got["weight"].shape == (c,)
        np.testing.assert_allclose(float(got["weight"].sum()), 1.0,
                                   rtol=1e-6)


def test_default_lpips_params_from_files(vgg, tmp_path, monkeypatch):
    _, sd = vgg
    monkeypatch.setenv("REWRITING_TPU_WEIGHTS", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="vgg16_features.pth"):
        distances.default_lpips_params()
    seeded = distances.default_lpips_params(allow_random=True)
    assert sum(p["weight"].numel() + p["bias"].numel()
               for p in seeded["convs"]) == 14714688     # VGG16's features
    torch.save({k: torch.as_tensor(v) for k, v in sd.items()},
               tmp_path / "vgg16_features.pth")
    uniform = distances.default_lpips_params()
    np.testing.assert_array_equal(uniform["convs"][3]["weight"].numpy(),
                                  sd["features.7.weight"])
    assert float(uniform["lins"][0]["weight"][0]) == 1.0 / 64
    lins = {f"lin{i}.model.1.weight": torch.full((1, c, 1, 1), 0.5)
            for i, c in enumerate((64, 128, 256, 512, 512))}
    torch.save(lins, tmp_path / "lpips_vgg_lins.pth")
    assert float(distances.default_lpips_params()["lins"][4]["weight"][0]) \
        == 0.5


def test_segio_and_registry(tmp_path):
    seg = np.random.RandomState(2).randint(0, 9, (3, 8, 8))
    np.savez(tmp_path / "a.npz", seg=seg)
    torch.save(torch.as_tensor(seg), tmp_path / "b.pth")
    np.testing.assert_array_equal(segio.load_seg(str(tmp_path / "a")), seg)
    np.testing.assert_array_equal(segio.load_seg(str(tmp_path / "b")), seg)
    with pytest.raises(FileNotFoundError):
        segio.load_seg(str(tmp_path / "c"))
    from rewriting_tpu.metrics import load_seg as jax_load_seg
    assert load_seg.face_atts == jax_load_seg.face_atts
    assert load_seg.smile_src == jax_load_seg.smile_src
    for name in jax_load_seg.info:
        assert load_seg.load_seg_info_from_exp_name(name) == \
            jax_load_seg.load_seg_info_from_exp_name(name)
    load_seg.register_experiment("dome2tree", "netpqc", 2, 0, [1708], [4])
    try:
        assert load_seg.load_seg_info_from_exp_name("dome2tree") == \
            ("netpqc", 2, 0, [1708], [4])
    finally:
        del load_seg.info["dome2tree"]


@pytest.fixture(scope="module")
def dl_dirs(tmp_path_factory):
    """clean and edited PNGs of 5 images, and the clean images' segmentations
    (channel 2 holds label 1708 on a patch; one at half size, one as
    .pth)."""
    root = tmp_path_factory.mktemp("dl")
    rng = np.random.RandomState(3)
    for i in range(5):
        clean = rng.randint(0, 256, (32, 32, 3)).astype(np.uint8)
        edited = clean.copy()
        edited[8:20, 10:24] = rng.randint(0, 256, (12, 14, 3))
        edited[0:3] = np.clip(edited[0:3].astype(int) + 9, 0, 255)
        save_png(clean, str(root / "clean" / f"{i}.png"))
        save_png(edited, str(root / "edited" / f"{i}.png"))
        size = 16 if i == 1 else 32
        seg = np.zeros((3, size, size), np.int64)
        f = size / 32
        seg[2, int(8 * f):int(20 * f), int(10 * f):int(24 * f)] = 1708
        seg[0] = 5
        os.makedirs(root / "seg", exist_ok=True)
        if i == 4:
            torch.save(torch.as_tensor(seg), root / "seg" / f"{i}.pth")
        else:
            np.savez(root / "seg" / f"{i}.npz", seg=seg)
    return root


@pytest.mark.parametrize("metric", ["l1", "lpips", "lpips_unmasked"])
def test_compute_dl_matches_jax(dl_dirs, metric):
    params = lpips.init_params(0)
    args = (str(dl_dirs / "clean"), str(dl_dirs / "seg"),
            str(dl_dirs / "edited"), range(5))
    got = distances.compute_dl(*args, metric=metric, batch_size=2,
                               lpips_params=params, device="cpu")
    want = jax_distances.compute_dl(*args, metric=metric, batch_size=2,
                                    lpips_params=_jax_tree(params))
    assert got[1] == want[1]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    if metric == "l1":
        assert got[1] < 5 * 32 * 32 and got[0] > 0   # the patch is masked


def test_distances_command_line(dl_dirs, monkeypatch, capsys, tmp_path):
    """``main`` on a results tree (dome2spire: church, channel 2, label
    1708), l1."""
    results = tmp_path / "results"
    os.makedirs(results / "seg")
    os.symlink(dl_dirs / "clean", results / "church_clean")
    os.symlink(dl_dirs / "seg", results / "seg" / "church_clean")
    os.symlink(dl_dirs / "edited", results / "dome2spire")
    masks = tmp_path / "masks" / "church"
    os.makedirs(masks)
    (masks / "dome2spire.json").write_text("{}")
    monkeypatch.setenv("REWRITING_TPU_MASKS", str(tmp_path / "masks"))
    distances.main(["--exp_name", "dome2spire", "--results", str(results),
                    "--num", "5"])
    out = capsys.readouterr().out
    total, count = distances.compute_dl(
        str(dl_dirs / "clean"), str(dl_dirs / "seg"),
        str(dl_dirs / "edited"), range(5), src=[1708], srcc=2)
    assert f"total={total} count={count}" in out


# ---------------------------------------------------------------------------
# The all-weights "overfit" baseline
# ---------------------------------------------------------------------------

def _named(tree, prefix=""):
    """(path, leaf) of a params tree, in the port's leaf order."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _named(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.fixture(scope="module")
def overfit_pair():
    """tests/test_vgg_overfit.py's setting: a ProgGAN of sizes [16, 16, 8,
    8] at layer 3, 10 z, and a request painted on its image."""
    jm = JaxProgGAN(sizes=[16, 16, 8, 8])
    jp = jax.tree_util.tree_map(np.asarray,
                                jm.init_params(jax.random.PRNGKey(3)))
    tm = ProgressiveGenerator(sizes=[16, 16, 8, 8], device="cpu")
    tp = params_from_jax(tm, jp)
    jr = JaxRewriter(jm, jp, jax_zds(jm, 10), layernum=3, stats_batch_size=5)
    tr = ProgressiveGanRewriter(tm, tp, z_dataset_for_model(tm, 10),
                                layernum=3, stats_batch_size=5,
                                device="cpu")
    xh, xw = tr.x_shape[1:3]
    req = {"object": [0, mask_to_url(blob(xh, xw, 4, 4, 3))],
           "paste": [1, mask_to_url(blob(xh, xw, 10, 10, 3))]}
    return jr, tr, req


def _jax_insert(jr, *args, **kw):
    """The JAX package's all_weights_insert; its per-step losses and first
    gradients read from inside its jitted step."""
    seen = {"losses": [], "grads": []}
    value_and_grad = jax.value_and_grad

    def recording(fn):
        inner = value_and_grad(fn)

        def run(params):
            loss, grads = inner(params)
            jax.debug.callback(
                lambda l, g: (seen["losses"].append(float(l)),
                              seen["grads"].append(g)), loss, grads)
            return loss, grads
        return run
    with pytest.MonkeyPatch.context() as m:
        m.setattr(jax, "value_and_grad", recording)
        jr.all_weights_insert(*args, **kw)
    jr.revert()
    return seen


def _port_insert(tr, *args, **kw):
    """The port's all_weights_insert, with each leaf's first gradient."""
    first = {}
    step = torch.optim.Adam.step

    def recording(self, *a, **k):
        if not first:
            first.update(
                (name, p.grad.clone())
                for (name, _), p in zip(_named(tr.params),
                                        self.param_groups[0]["params"]))
        return step(self, *a, **k)
    with pytest.MonkeyPatch.context() as m:
        m.setattr(torch.optim.Adam, "step", recording)
        losses = tr.all_weights_insert(*args, **kw)
    return losses, first


def _noisy_target(tr, req):
    """The request's pasted image (z, image, bounds) plus seeded noise of
    1e-2 (see the module docstring)."""
    rgb, _, area, _ = tr.rgb_from_selection(*req["object"])
    z, changed, bounds = tr.rgbpaste_from_selection(*req["paste"], rgb, area)
    noise = np.random.RandomState(9).normal(0, 1e-2, changed.shape)
    return z.numpy(), (changed + noise).astype(np.float32), bounds


def _check_insert(jr, tr, req, port_feats=None, jax_feats=None, **kw):
    """Both packages' all_weights_insert towards the noisy target: the
    losses, the first step's gradients, every leaf moved, revert."""
    z, target, bounds = _noisy_target(tr, req)
    w0 = dict(_named(tr.params))
    losses, grads = _port_insert(tr, target, z, bounds=bounds,
                                 feature_loss_fn=port_feats, **kw)
    seen = _jax_insert(jr, jnp.asarray(target), jnp.asarray(z),
                       bounds=bounds, feature_loss_fn=jax_feats, **kw)
    assert losses.shape == (kw["niter"],)
    np.testing.assert_allclose(losses, seen["losses"], rtol=1e-4)
    jgrads = dict(_named(params_from_jax(
        tr.model, jax.tree_util.tree_map(np.asarray, seen["grads"][0]))))
    assert sorted(grads) == sorted(jgrads) == sorted(w0)
    for name, g in grads.items():
        want = jgrads[name].numpy()
        scale = max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(g.numpy(), want, atol=1e-4 * scale,
                                   rtol=0, err_msg=name)
    after = dict(_named(tr.params))
    assert all(not torch.equal(after[n], w0[n]) for n in w0)  # all moved
    tr.revert()
    for name, t in _named(tr.params):
        assert torch.equal(t, w0[name]), name
    return losses


def test_all_weights_insert_matches_jax(overfit_pair):
    jr, tr, req = overfit_pair
    losses = _check_insert(jr, tr, req, niter=8, lr=0.01)
    assert losses[-1] < losses[0]


def test_all_weights_insert_with_a_feature_term_matches_jax(overfit_pair,
                                                           vgg):
    """The reference's perceptual term: VGG16's relu3_3 features of the
    NHWC crops (the port's net runs NCHW)."""
    _, sd = vgg
    jr, tr, req = overfit_pair
    net = lpips.LPIPS(lpips.params_from_torch(sd), device="cpu")
    jparams = jax_lpips.params_from_torch(sd)
    losses = _check_insert(
        jr, tr, req, niter=4, lr=0.01,
        port_feats=lambda img: net.taps(img.permute(0, 3, 1, 2))[2],
        jax_feats=lambda img: jax_lpips.vgg16_taps(jparams, img)[2])
    assert np.isfinite(losses).all()


def test_apply_overfit_on_the_request(overfit_pair):
    """apply_overfit on the request's own pasted image: the first loss
    the JAX package's, update_callback every 50 steps, every leaf moved,
    and revert restores every leaf."""
    jr, tr, req = overfit_pair
    w0 = dict(_named(tr.params))
    seen, jseen = [], []
    losses = tr.apply_overfit(req, niter=8, lr=0.01,
                              update_callback=lambda i, l: seen.append(
                                  (i, float(l))))
    jr.apply_overfit(req, niter=1, lr=0.01,
                     update_callback=lambda i, l: jseen.append(float(l)))
    jr.revert()
    np.testing.assert_allclose(losses[0], jseen[0], rtol=1e-5)
    assert seen == [(0, float(losses[0]))] and np.isfinite(losses).all()
    after = dict(_named(tr.params))
    assert all(not torch.equal(after[n], w0[n]) for n in w0)
    tr.revert()
    for name, t in _named(tr.params):
        assert torch.equal(t, w0[name]), name


def test_solves_run_with_deterministic_algorithms(monkeypatch):
    """A solve runs _adam_loop's loss with cuDNN's deterministic
    algorithms and no autotuning, and puts the flags back after, also
    when the loss raises; so does all_weights_insert."""
    seen = []
    x = torch.randn(1, 3, 5, 5)
    d = torch.eye(3)[:1]
    w0 = torch.randn(2, 3, 3, 3)
    goal = torch.randn(1, 2, 5, 5)

    def window_fn(w, x):
        seen.append((torch.backends.cudnn.deterministic,
                     torch.backends.cudnn.benchmark))
        return torch.nn.functional.conv2d(x, w, padding=1)

    def fails(w, x):
        raise RuntimeError("stop")
    for before in ((False, True), (True, False)):
        monkeypatch.setattr(torch.backends.cudnn, "deterministic", before[0])
        monkeypatch.setattr(torch.backends.cudnn, "benchmark", before[1])
        w, losses = solve.insert_solve(window_fn, w0, x, goal, d, niter=3)
        assert len(losses) == 3 and seen[-3:] == [(True, False)] * 3
        assert (torch.backends.cudnn.deterministic,
                torch.backends.cudnn.benchmark) == before
        with pytest.raises(RuntimeError, match="stop"):
            solve.insert_solve(fails, w0, x, goal, d, niter=1)
        assert (torch.backends.cudnn.deterministic,
                torch.backends.cudnn.benchmark) == before


def test_whole_solve_runs_deterministic(monkeypatch):
    """A solve's precomputed terms (the fast solve's base convolution)
    run with the deterministic algorithms too: on the card the default
    forward algorithms also vary run to run."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", False)
    seen = []

    def conv_fn(x, w):
        seen.append(torch.backends.cudnn.deterministic)
        return torch.nn.functional.conv2d(x, w, padding=1)
    x = torch.randn(1, 3, 5, 5)
    d = torch.eye(3)[:1]
    w, losses = solve.fast_linear_insert_solve(
        conv_fn, lambda params, bag: bag, {"fmap": x}, None,
        torch.randn(1, 2, 5, 5), torch.randn(2, 3, 3, 3), d, 1.0, niter=2)
    assert len(losses) == 2 and seen == [True] * 3   # the base, 1 a step
    assert torch.backends.cudnn.deterministic is False


def test_all_weights_insert_runs_deterministic(overfit_pair, monkeypatch):
    _, tr, _ = overfit_pair
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", False)
    seen = []
    pipeline = tr.model.pipeline

    class Spy:
        def __call__(self, params, bag):
            seen.append(torch.backends.cudnn.deterministic)
            return pipeline(params, bag)

        def __getattr__(self, name):
            return getattr(pipeline, name)
    monkeypatch.setattr(tr.model, "pipeline", Spy())
    x = tr.sample_image_from_latent(tr.get_z(2)).numpy()
    losses = tr.all_weights_insert(x, tr.get_z(2), niter=2, lr=1e-3)
    tr.revert()
    assert seen == [True, True] and losses.shape == (2,)
    assert torch.backends.cudnn.deterministic is False
