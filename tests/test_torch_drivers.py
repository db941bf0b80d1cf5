"""The port's pipeline drivers and their utilities against the JAX
package's: ``utils/{parallelfolder,segdata,sampler,segviz,hostshard}.py``
and ``metrics/{samples,patch_fid,plot_patch_fids,experiments}.py``.

Held:
- ``ParallelImageFolders`` and ``MultiSegmentDataset``: the port's uint8
  arrays equal ``numpy.asarray`` of the JAX package's PIL images (RGB and
  greyscale, PNG and JPEG, and a WebP and a CMYK JPEG, which the port
  hands to PIL), labels and histograms equal;
- the samplers' index sequences and ``subsample_folder``'s copies equal;
- ``segviz``: palette, visualizations and legend swatches equal;
- ``samples``: ``load_image`` equal to the JAX package's PIL resize and
  crop, shrinking (antialiased) and growing, on odd and even sizes; the
  real-image sets and crops equal; ``get_fake_samples`` of the same
  params within 1e-5 abs (two forwards);
- ``patch_fid`` on stylegan2_tiny.npz's weights: the patches within 1e-5
  abs of the JAX package's, the sweep's FIDs within 1e-4 relative with a
  cheap feature function (the Fréchet distance of the same patches); a
  set with itself 0 and an edited model's patches far from it;
- ``plot_patch_fids`` writes its PNG (matplotlib, on the host) as the JAX
  package's does;
- ``hostshard``: strided shares, the environment pairs in order, a
  ``torch.distributed`` group's rank first, done-markers on restart;
- ``experiments``: the DAG over two simulated hosts with a fake runner,
  a failure, stealing an orphaned stage, a dry run; the default runner
  starts this interpreter; every ``STAGES`` command names a module of the
  port whose ``main`` accepts its flags, and the stages are the JAX
  package's but for the damage stages' dependency on the clean labels.
"""

import argparse
import io
import json
import os
import shlex
import subprocess
import sys
from contextlib import redirect_stdout

import jax
import numpy as np
import PIL.Image
import pytest
import torch

from rewriting_tpu.metrics import experiments as jax_experiments
from rewriting_tpu.metrics import patch_fid as jax_patch_fid
from rewriting_tpu.metrics import plot_patch_fids as jax_plot
from rewriting_tpu.metrics import samples as jax_samples
from rewriting_tpu.models.stylegan2 import SeqStyleGAN2 as JaxSeqStyleGAN2
from rewriting_tpu.models.stylegan2 import params_from_state_dict
from rewriting_tpu.rewrite import SeqStyleGanRewriter as JaxRewriter
from rewriting_tpu.utils import sampler as jax_sampler
from rewriting_tpu.utils import segviz as jax_segviz
from rewriting_tpu.utils.parallelfolder import \
    ParallelImageFolders as JaxFolders
from rewriting_tpu.utils.segdata import MultiSegmentDataset as JaxSegData
from rewriting_tpu.utils.zdataset import z_dataset_for_model as jax_zds
from rewriting_torch.convert import params_from_jax
from rewriting_torch.metrics import (experiments, patch_fid,
                                     plot_patch_fids, samples)
from rewriting_torch.models.stylegan2 import SeqStyleGAN2
from rewriting_torch.rewrite import SeqStyleGanRewriter
from rewriting_torch.utils import hostshard, sampler, segviz
from rewriting_torch.utils.parallelfolder import ParallelImageFolders
from rewriting_torch.utils.segdata import MultiSegmentDataset
from rewriting_torch.utils.zdataset import z_dataset_for_model

torch.set_num_threads(1)


def _write_png(path, arr):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    PIL.Image.fromarray(np.asarray(arr, np.uint8)).save(path)


@pytest.fixture()
def image_dir(tmp_path):
    rng = np.random.RandomState(0)
    root = tmp_path / "imgs"
    for i in range(8):
        _write_png(str(root / f"sub{i % 2}" / f"im_{i}.png"),
                   rng.randint(0, 255, (12 + 2 * i, 10 + i, 3)))
    return str(root)


# -- parallelfolder and segdata ----------------------------------------------

def _make_segdataset(tmp_path, n=8):
    rng = np.random.RandomState(1)
    labels = [{"field": "object", "index": 0, "bitshift": 0,
               "bitmask": 0x3, "label": ["-", "sky", "tree", "dome"]},
              {"field": "part", "index": 1, "bitshift": 2,
               "bitmask": 0x1, "label": ["-", "window"]}]
    root = tmp_path / "segds"
    for i in range(n):
        _write_png(str(root / "img" / f"s_{i}.png"),
                   rng.randint(0, 255, (6, 6, 3)))
        seg = np.zeros((6, 6, 3), np.uint8)
        seg[..., 0] = rng.randint(0, 4, (6, 6))
        seg[..., 1] = rng.randint(0, 2, (6, 6)) << 2
        _write_png(str(root / "seg" / f"s_{i}.png"), seg)
    with open(root / "labelnames.json", "w") as f:
        json.dump(labels, f)
    return str(root)


def test_parallel_image_folders_match_jax(tmp_path):
    root = _make_segdataset(tmp_path)
    grey = tmp_path / "segds" / "grey"
    for i in range(8):
        _write_png(str(grey / f"s_{i}.png"),
                   np.full((5, 7), 10 * i, np.uint8))
    roots = [os.path.join(root, d) for d in ("img", "seg", "grey")]
    ds, jds = ParallelImageFolders(roots), JaxFolders(roots)
    assert len(ds) == len(jds) == 8 and ds.images == jds.images
    for i in range(8):
        got, want = ds[i], jds[i]
        for a, b in zip(got, want):
            assert a.dtype == np.uint8
            np.testing.assert_array_equal(a, np.asarray(b))
    assert ds[3][2].shape == (5, 7)
    flip = ParallelImageFolders(roots[0], transform=lambda a: a[::-1])
    np.testing.assert_array_equal(flip[0][0], ds[0][0][::-1])
    _write_png(str(tmp_path / "segds" / "img" / "extra.png"),
               np.zeros((4, 4, 3)))
    with pytest.raises(ValueError, match="unmatched"):
        ParallelImageFolders(roots[:2])
    PIL.Image.fromarray(np.zeros((4, 4, 3), np.uint8)).save(
        str(tmp_path / "segds" / "img" / "extra.jpg"))
    with pytest.raises(ValueError, match="ambiguous stem"):
        ParallelImageFolders([roots[0]])
    jpg = tmp_path / "jpg"
    jpg.mkdir()
    rng = np.random.RandomState(1)
    PIL.Image.fromarray(rng.randint(0, 256, (13, 22, 3), np.uint8)).save(
        str(jpg / "a.jpg"))
    PIL.Image.fromarray(rng.randint(0, 256, (13, 22), np.uint8)).save(
        str(jpg / "b.jpg"))
    ds, jds = ParallelImageFolders([str(jpg)]), JaxFolders([str(jpg)])
    assert len(ds) == len(jds) == 2 and ds.images == jds.images
    for i in range(2):
        (got,), (want,) = ds[i], jds[i]
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, np.asarray(want))
    assert ds[1][0].shape == (13, 22)
    odd = tmp_path / "odd"
    odd.mkdir()
    PIL.Image.fromarray(np.zeros((4, 4, 3), np.uint8)).save(
        str(odd / "a.webp"))
    PIL.Image.fromarray(np.zeros((4, 4, 3), np.uint8)).convert("CMYK").save(
        str(odd / "b.jpg"))
    ds, jds = ParallelImageFolders([str(odd)]), JaxFolders([str(odd)])
    assert ds.images == jds.images
    for i, shape in enumerate(((4, 4, 3), (4, 4, 4))):   # RGB, CMYK
        (got,), (want,) = ds[i], jds[i]
        assert got.shape == shape
        np.testing.assert_array_equal(got, np.asarray(want))


def test_multisegment_dataset_matches_jax(tmp_path):
    root = _make_segdataset(tmp_path)
    for kw in ({}, {"val": True}, {"size": 2}):
        ds, jds = MultiSegmentDataset(root, **kw), JaxSegData(root, **kw)
        assert len(ds) == len(jds)
        assert (ds.labels, ds.categories, ds.label_category) == \
            (jds.labels, jds.categories, jds.label_category)
        for i in range(len(ds)):
            (img, segout, bc), (jimg, jsegout, jbc) = ds[i], jds[i]
            np.testing.assert_array_equal(img, np.asarray(jimg))
            assert segout.dtype == np.int64
            np.testing.assert_array_equal(segout, jsegout)
            np.testing.assert_array_equal(bc, jbc)
    # the fix for fields after the first: an unlabelled part pixel is 0
    _, segout, _ = MultiSegmentDataset(root)[0]
    assert set(np.unique(segout[1])) <= {0, 4}


# -- sampler and segviz -----------------------------------------------------

def test_samplers_match_jax(tmp_path, image_dir):
    data = list(range(37))
    for kw in ({}, {"start": 3, "end": 20}, {"seed": 5}):
        s = sampler.FixedRandomSubsetSampler(data, **kw)
        j = jax_sampler.FixedRandomSubsetSampler(data, **kw)
        assert list(s) == list(j) and len(s) == len(j)
        assert s.class_subset(lambda d: d % 3 == 0).samples == \
            j.class_subset(lambda d: d % 3 == 0).samples
    assert sampler.FixedSubsetSampler([4, 5, 6]).subset([2, 0]).samples == \
        [6, 4]
    for shape, flat in (((7, 9), False), ((5, 5), True), ((4, 6, 3), True)):
        np.testing.assert_array_equal(
            sampler.coordinate_sample(shape, 10, [0, 1, 7], flat=flat),
            jax_sampler.coordinate_sample(shape, 10, [0, 1, 7], flat=flat))
    got = sampler.subsample_folder(image_dir, str(tmp_path / "a"), size=5)
    want = jax_sampler.subsample_folder(image_dir, str(tmp_path / "b"),
                                        size=5)
    assert got == want
    for name in got:
        with open(tmp_path / "a" / name, "rb") as f, \
                open(tmp_path / "b" / name, "rb") as g:
            assert f.read() == g.read()
    with pytest.raises(FileExistsError):
        sampler.subsample_folder(image_dir, str(tmp_path / "a"), size=5)


class _Labels:
    def get_label_and_category_names(self):
        return [("-", "-")] + [(f"l{i}", "object") for i in range(1, 40)], \
            ["object"]


def test_segviz_matches_jax():
    np.testing.assert_array_equal(segviz.high_contrast_palette(),
                                  jax_segviz.high_contrast_palette())
    seg = np.random.RandomState(2).randint(0, 40, (3, 9, 11))
    seg[0, :4] = 0
    for s, size in ((seg[1], None), (seg, None), (seg[2], (18, 22))):
        np.testing.assert_array_equal(
            segviz.segment_visualization(s, size),
            jax_segviz.segment_visualization(s, size))
    swatch = segviz.swatch_image(7, size=5)
    assert swatch.shape == (5, 5, 3) and swatch.dtype == np.uint8
    np.testing.assert_array_equal(swatch,
                                  np.asarray(jax_segviz.swatch_image(7, 5)))
    got = segviz.segment_key(seg[1], _Labels(), max_labels=4)
    want = jax_segviz.segment_key(seg[1], _Labels(), max_labels=4)
    assert [n for _, n in got] == [n for _, n in want] and len(got) == 4
    for (a, _), (b, _) in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))


# -- samples ------------------------------------------------------------------

@pytest.mark.parametrize("shape,size", [((100, 61), 32), ((12, 10), 16),
                                        ((33, 47), 16), ((64, 64), 64),
                                        ((9, 300), 8)])
def test_load_image_matches_pil(tmp_path, shape, size):
    img = np.random.RandomState(sum(shape)).randint(0, 256, shape + (3,))
    path = str(tmp_path / "x.png")
    _write_png(path, img)
    got = samples.load_image(path, size)
    assert got.shape == (size, size, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, jax_samples.load_image(path, size))


def test_real_samples_match_jax(image_dir, tmp_path):
    assert samples.get_image_paths(image_dir, 5, seed=1) == \
        jax_samples.get_image_paths(image_dir, 5, seed=1)
    np.testing.assert_array_equal(
        samples.get_gt_samples(image_dir, 8, 4),
        jax_samples.get_gt_samples(image_dir, 8, 4))
    for a, b in zip(samples.gt_sample_batches(image_dir, 8, 5, 3),
                    jax_samples.gt_sample_batches(image_dir, 8, 5, 3)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(samples.get_cropped_gt_samples(image_dir, 8, 3, (2, 4),
                                                   seed=3),
                    jax_samples.get_cropped_gt_samples(image_dir, 8, 3,
                                                       (2, 4), seed=3)):
        np.testing.assert_array_equal(a, b)

    def toy(images):
        return np.asarray(images).reshape(len(images), -1)[:, :7]
    for a, b in zip(samples.gt_stats(image_dir, 8, 4, 2, feature_fn=toy),
                    jax_samples.gt_stats(image_dir, 8, 4, 2,
                                         feature_fn=toy)):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
    listed = sorted(os.path.relpath(p, image_dir)
                    for p in samples.get_image_paths(image_dir))[:3]
    with open(image_dir + ".txt", "w") as f:
        f.write("\n".join(listed) + "\n")
    assert samples.get_image_paths(image_dir, 10) == \
        jax_samples.get_image_paths(image_dir, 10)


@pytest.fixture(scope="module")
def tiny(goldens):
    g = goldens("stylegan2_tiny")
    sd = {k[len("sd."):]: g[k] for k in g.files if k.startswith("sd.")}
    jm = JaxSeqStyleGAN2(16, style_dim=64, n_mlp=2)
    jp = jax.tree_util.tree_map(np.asarray, params_from_state_dict(jm, sd))
    tm = SeqStyleGAN2(16, style_dim=64, n_mlp=2, device="cpu")
    return jm, jp, tm, params_from_jax(tm, jp)


def test_fake_samples_match_jax(tiny):
    jm, jp, tm, tp = tiny
    got = samples.get_fake_samples(tm, tp, 5, batch_size=2)
    assert got.shape == (5, 16, 16, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, jax_samples.get_fake_samples(
        jm, jp, 5, batch_size=2), atol=1e-5, rtol=0)
    np.testing.assert_allclose(samples.get_fake_samples(tm, tp, 5, 5), got,
                               atol=1e-5, rtol=0)
    crops = samples.get_cropped_fake_samples(tm, tp, 3, (4, 8), 2, seed=2)
    jcrops = jax_samples.get_cropped_fake_samples(jm, jp, 3, (4, 8), 2,
                                                  seed=2)
    for a, b in zip(crops, jcrops):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)


# -- patch FID ------------------------------------------------------------------

def cheap(x):
    return np.asarray(x).reshape(len(x), -1)[:, ::7][:, :10]


def test_patch_fid_matches_jax(tiny):
    jm, jp, tm, tp = tiny
    gw = SeqStyleGanRewriter(tm, tp, z_dataset_for_model(tm, 24), 4,
                             stats_batch_size=8, device="cpu")
    jgw = JaxRewriter(jm, jp, jax_zds(jm, 24), 4, stats_batch_size=8)
    edited = SeqStyleGanRewriter(tm, tp, z_dataset_for_model(tm, 24), 4,
                                 stats_batch_size=8, device="cpu")
    w = edited.target_weight()
    edited.set_target_weight(w + 0.5 * w.abs().max() * torch.sign(w))
    jedited = JaxRewriter(jm, jp, jax_zds(jm, 24), 4, stats_batch_size=8)
    jedited.set_target_weight(jax.numpy.asarray(edited.target_weight()
                                                .numpy()))
    for crop in (2, 4):
        a = patch_fid.sample_patches(gw, crop, 16, seed=1)
        b = jax_patch_fid.sample_patches(jgw, crop, 16, seed=1)
        assert a.shape == b.shape and a.shape[0] == 16
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)
    got = patch_fid.patch_fid_sweep(gw, edited, [4], n=16, feature_fn=cheap)
    want = jax_patch_fid.patch_fid_sweep(jgw, jedited, [4], n=16,
                                         feature_fn=cheap)
    assert abs(got[4] - want[4]) <= 1e-4 * abs(want[4])
    same = patch_fid.patch_fid_sweep(gw, gw, [4], n=16, feature_fn=cheap)
    assert abs(same[4]) < 1e-6 * got[4] and got[4] > 0


def test_patch_fid_main(tiny, tmp_path, monkeypatch):
    _, _, tm, tp = tiny
    from rewriting_torch.metrics import load_mask
    from rewriting_torch.models import zoo
    mask = tmp_path / "church" / "dome2tree.json"
    mask.parent.mkdir()
    gw = SeqStyleGanRewriter(tm, tp, z_dataset_for_model(tm, 4), 4,
                             device="cpu")
    from conftest import blob
    from rewriting_torch.utils.renormalize import mask_to_url
    h, w = gw.v_shape[1:3]
    mask.write_text(json.dumps(
        {"object": [0, mask_to_url(blob(h, w, 2, 2, 2))],
         "paste": [1, mask_to_url(blob(h, w, 5, 5, 2))]}))
    monkeypatch.setenv("REWRITING_TPU_MASKS", str(tmp_path))
    monkeypatch.setitem(load_mask.name2info, "dome2tree",
                        ["church", "dome2tree.json", 4])
    monkeypatch.setattr(zoo, "load_seq_stylegan",
                        lambda *a, **k: (tm, tp))
    made = []

    from rewriting_torch import rewrite

    class OnCpu(SeqStyleGanRewriter):
        def __init__(self, *a, **k):
            super().__init__(*a, stats_batch_size=8, device="cpu", **k)
            made.append(self)

        def apply_edit(self, request, rank=1, **k):
            return super().apply_edit(request, rank=rank, niter=11)

    monkeypatch.setattr(rewrite, "SeqStyleGanRewriter", OnCpu)
    from rewriting_torch.utils import zdataset
    monkeypatch.setattr(zdataset, "z_dataset_for_model",
                        lambda m, n: z_dataset_for_model(m, 16))
    from rewriting_torch.metrics import fid
    monkeypatch.setattr(fid, "FeatureExtractor",
                        lambda *a, **k: cheap)
    out = tmp_path / "pf.json"
    buf = io.StringIO()
    with redirect_stdout(buf):
        patch_fid.main(["--mask", "dome2tree", "--crops", "2", "4", "--n",
                        "16", "--out", str(out)])
    saved = json.loads(out.read_text())
    assert sorted(saved) == ["2", "4"] and len(made) == 2
    assert all(v > 0 for v in saved.values())


def test_plot_patch_fids_writes_its_png(tmp_path):
    results = {"church": {1: 5.0, 4: 3.0, 16: 1.0},
               "kitchen": {1: 6.0, 4: 2.5}}
    out = plot_patch_fids.plot_patch_fids(results,
                                          str(tmp_path / "p" / "fids.png"))
    want = jax_plot.plot_patch_fids(results, str(tmp_path / "j.png"))
    assert os.path.getsize(out) > 500
    with open(out, "rb") as f, open(want, "rb") as g:
        assert PIL.Image.open(f).size == PIL.Image.open(g).size
    assert os.path.exists(plot_patch_fids.plot_patch_fids(
        {"layer6": {16: 4.0}, "8": {16: 2.0}}, str(tmp_path / "l.png"),
        by_layer=True))
    with pytest.raises(ValueError):
        plot_patch_fids.plot_patch_fids({"church": {16: 4.0}},
                                        str(tmp_path / "bad.png"),
                                        by_layer=True)
    p = tmp_path / "r.json"
    p.write_text(json.dumps({"16": 4.0}))
    assert plot_patch_fids._load([str(p)], ["l8"]) == {"l8": {16: 4.0}}
    plot_patch_fids.main([str(p), "--out", str(tmp_path / "m.png")])
    assert os.path.getsize(tmp_path / "m.png") > 500


# -- hostshard ------------------------------------------------------------------

def test_hostshard_shares_and_environment(monkeypatch, tmp_path):
    units = list(range(10))
    assert hostshard.shard_units(units, 0, 3) == [0, 3, 6, 9]
    assert hostshard.shard_units(units, 2, 3) == [2, 5, 8]
    assert sorted(sum((hostshard.shard_units(units, i, 3)
                       for i in range(3)), [])) == units
    for name in ("REWRITING_TPU_SHARD", "REWRITING_TPU_NUM_SHARDS", "RANK",
                 "WORLD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    assert hostshard.process_identity() == (0, 1)
    monkeypatch.setenv("RANK", "1")
    assert hostshard.process_identity() == (0, 1)   # half a pair: ignored
    monkeypatch.setenv("WORLD_SIZE", "2")
    assert hostshard.process_identity() == (1, 2)
    monkeypatch.setenv("REWRITING_TPU_SHARD", "2")
    monkeypatch.setenv("REWRITING_TPU_NUM_SHARDS", "5")
    assert hostshard.process_identity() == (2, 5)   # the first pair wins
    assert hostshard.process_identity(1, 3) == (1, 3)
    import rewriting_tpu.utils.hostshard as jax_hostshard
    assert jax_hostshard.process_identity() == (2, 5)
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        assert hostshard.process_identity() == (0, 1)
    finally:
        dist.destroy_process_group()
    assert hostshard.process_identity() == (2, 5)


def test_claim_units_done_markers(tmp_path):
    ran = []
    for unit, mark in hostshard.claim_units(["a", "b", "c"], str(tmp_path)):
        ran.append(unit)
        if unit != "b":
            mark()
    assert ran == ["a", "b", "c"]
    assert [u for u, _ in hostshard.claim_units(["a", "b", "c"],
                                                str(tmp_path))] == ["b"]
    assert [u for u, _ in hostshard.claim_units(["a"], str(tmp_path),
                                                redo=True)] == ["a"]


# -- experiments ----------------------------------------------------------------

def test_dag_two_hosts_failure_and_dry_run(tmp_path):
    statedir = str(tmp_path / "exp")
    log = {0: [], 1: []}

    def make_runner(host):
        def runner(cmd):
            log[host].append(cmd)
            return 0
        return runner
    for _ in range(8):
        for host in (0, 1):
            experiments.run_pipeline(statedir, runner=make_runner(host),
                                     process_index=host, process_count=2,
                                     max_rounds=1)
    ran = log[0] + log[1]
    assert sorted(ran) == sorted(c for _, c, _ in experiments.STAGES)
    assert log[0] and log[1]
    assert experiments.run_pipeline(statedir, runner=make_runner(0)) == {}

    status = experiments.run_pipeline(
        str(tmp_path / "fail"), runner=lambda c: 1 if "seg_stats" in c else 0)
    failed = [k for k, v in status.items() if v.startswith("failed")]
    assert failed and not os.path.isfile(
        os.path.join(tmp_path, "fail", failed[0], "done.txt"))
    dry = experiments.run_pipeline(str(tmp_path / "dry"), dry_run=True)
    assert set(dry) == {n for n, _, _ in experiments.STAGES}
    assert set(dry.values()) == {"dry_run"}


def test_dependencies_run_first(tmp_path):
    order = []
    experiments.run_pipeline(str(tmp_path / "exp"),
                             runner=lambda c: order.append(c) or 0)
    pos = {c: i for i, c in enumerate(order)}
    cmds = {n: c for n, c, _ in experiments.STAGES}
    for name, cmd, deps in experiments.STAGES:
        assert all(pos[cmds[d]] < pos[cmd] for d in deps), name


def test_orphan_stage_is_stolen(tmp_path):
    stages = [("a", "cmd_a", ()), ("b", "cmd_b", ("a",)),
              ("c", "cmd_c", ("a", "b"))]
    ran = []
    status = experiments.run_pipeline(
        str(tmp_path / "exp"), stages=stages,
        runner=lambda c: ran.append(c) or 0, process_index=1,
        process_count=2)
    assert ran == ["cmd_a", "cmd_b", "cmd_c"]
    assert all(v == "done" for v in status.values())


def test_default_runner_starts_this_interpreter(monkeypatch, tmp_path):
    calls = []
    monkeypatch.setattr(subprocess, "call",
                        lambda argv, env=None: calls.append(argv) or 0)
    stages = [("a", "python -m rewriting_torch.metrics.sample --n 2", ())]
    status = experiments.run_pipeline(str(tmp_path / "exp"), stages=stages)
    assert status == {"a": "done"}
    assert calls == [[sys.executable, "-m", "rewriting_torch.metrics.sample",
                      "--n", "2"]]
    assert experiments.run_command("true") == 0
    assert calls[-1] == ["true"]


class _Parsed(Exception):
    pass


def test_every_stage_is_a_port_command_line(monkeypatch):
    """Each command names a module of the port whose main parses its
    flags, as they stand and with the image count and results directory
    that chip_smoke.py adds (parsing stops the main right after)."""
    import importlib

    import chip_smoke
    parse = argparse.ArgumentParser.parse_args

    def parse_then_stop(self, args=None, namespace=None):
        parse(self, args, namespace)
        raise _Parsed
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args",
                        parse_then_stop)
    sized = chip_smoke.sized_stages(experiments.STAGES, 32, "/tmp/r")
    assert [(n, d) for n, _, d in sized] == \
        [(n, d) for n, _, d in experiments.STAGES]
    for (name, cmd, _), (_, scmd, _) in zip(experiments.STAGES, sized):
        for line in (cmd, scmd):
            argv = shlex.split(line)
            assert argv[:2] == ["python", "-m"], name
            assert argv[2].startswith("rewriting_torch.metrics."), name
            module = importlib.import_module(argv[2])
            with pytest.raises(_Parsed):
                module.main(argv[3:])
        assert "--results /tmp/r" in scmd and " 32" in scmd


def test_stages_are_the_jax_packages():
    jax_stages = {n: (c, d) for n, c, d in jax_experiments.STAGES}
    assert [n for n, _, _ in experiments.STAGES] == \
        [n for n, _, _ in jax_experiments.STAGES]
    for name, cmd, deps in experiments.STAGES:
        jcmd, jdeps = jax_stages[name]
        assert cmd == jcmd.replace(".".join(["rewriting_tpu", ""]),
                                   "rewriting_torch.")
        extra = set(deps) - set(jdeps)
        assert set(jdeps) <= set(deps)
        assert extra == ({"seg_church_clean"} if name == "dist_dome2spire"
                         else {"seg_faces_clean"} if name == "dist_smile"
                         else set()), name


def test_main_prints_and_fails(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(experiments, "run_command",
                        lambda c: 3 if "seg_stats" in c else 0)
    with pytest.raises(SystemExit) as e:
        experiments.main(["--statedir", str(tmp_path / "s")])
    assert e.value.code == 1
    out = capsys.readouterr().out
    assert "sample_church: done" in out and "failed(3)" in out
    experiments.main(["--statedir", str(tmp_path / "d"), "--dry_run"])
    assert "dist_smile: dry_run" in capsys.readouterr().out
