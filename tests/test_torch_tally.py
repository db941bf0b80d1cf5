"""The port's tallies against the JAX package's: each tally of a compute
closure over a z dataset, ``gather_topk``, ``conditional_samples``, the
concatenations, the conditional tallies, and the IoU, mutual-information
and information-quality statistics on tests/test_dissect.py's synthetic
cases.

Both packages get the same numpy-seeded z and the same compute (numpy
weights).  Tolerances: states 1e-5 of the largest entry; top-k indices,
bincounts, the conditions and their order exact; the statistics of the
conditional sketches 1e-5 (the sketches equal, the host math the same).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rewriting_tpu.stats import running as jax_running
from rewriting_tpu.stats import tally as jax_tally
from rewriting_tpu.utils.zdataset import ZDataset as JaxZDataset
from rewriting_torch.stats import running, tally
from rewriting_torch.utils.zdataset import ZDataset

torch.set_num_threads(1)

W = np.random.RandomState(7).randn(8, 6).astype(np.float32)


def _close(got, want, rel=1e-5):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-12)
    np.testing.assert_allclose(got, want, atol=rel * scale, rtol=0)


def _rows(z):
    """(B, 6) rows of a z batch in either package."""
    if isinstance(z, torch.Tensor):
        return torch.tanh(z @ torch.as_tensor(W))
    return jnp.tanh(z @ jnp.asarray(W))


@pytest.fixture(scope="module")
def zs():
    return np.random.RandomState(0).randn(95, 8).astype(np.float32)


TALLIES = {
    "variance": ("tally_variance", {}, _rows,
                 lambda r: [r.mean(), r.variance()]),
    "covariance": ("tally_covariance", {}, _rows,
                   lambda r: [r.covariance(), r.correlation()]),
    "cross_covariance": ("tally_cross_covariance", {},
                         lambda z: (_rows(z)[:, :2], _rows(z)[:, 2:]),
                         lambda r: [r.cross_covariance()]),
    "mean": ("tally_mean", {}, _rows, lambda r: [r.mean()]),
    "bincount": ("tally_bincount", {"size": 16},
                 lambda z: ((_rows(z) + 1) * 7).long()
                 if isinstance(z, torch.Tensor)
                 else ((_rows(z) + 1) * 7).astype(jnp.int32),
                 lambda r: [r.result()]),
    "topk": ("tally_topk", {"k": 4}, _rows,
             lambda r: [r.result()[0], r.result()[1]]),
    "quantile": ("tally_quantile", {"resolution": 64}, _rows,
                 lambda r: [r.quantiles([0.0, 0.25, 0.5, 1.0])]),
    "intersection_and_union": (
        "tally_all_intersection_and_union", {},
        lambda z: (_rows(z)[:, :3] > 0, _rows(z)[:, 3:] > 0.2),
        lambda r: [r.iou()]),
}


@pytest.mark.parametrize("name", sorted(TALLIES))
def test_tally_matches_jax_and_its_cache(zs, name, tmp_path):
    """The tally over 95 z in batches of 10 (a short last batch), against
    the JAX package's; its cache, keyed on the tally's own arguments,
    read back by a second call and by the JAX package's tally."""
    fn, kw, compute, outputs = TALLIES[name]
    path = str(tmp_path / "c.npz")
    got = getattr(tally, fn)(compute, ZDataset(zs), batch_size=10,
                             cachefile=path, **kw)
    want = getattr(jax_tally, fn)(compute, JaxZDataset(zs), batch_size=10,
                                  **kw)
    for g, w in zip(outputs(got), outputs(want)):
        _close(g, w)
    with np.load(path) as f:
        saved = dict(f)
    assert int(saved["sample_size"]) == 95 and int(saved["batch_size"]) == 10
    for k, v in kw.items():
        assert int(saved[k]) == v
    again = getattr(tally, fn)(
        lambda z: (_ for _ in ()).throw(AssertionError("recomputed")),
        ZDataset(zs), batch_size=10, cachefile=path, **kw)
    for g, w in zip(outputs(again), outputs(got)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    if name != "quantile":   # the JAX tally_quantile reads no cache back
        back = getattr(jax_tally, fn)(
            lambda z: (_ for _ in ()).throw(AssertionError("recomputed")),
            JaxZDataset(zs), batch_size=10, cachefile=path, **kw)
        for g, w in zip(outputs(back), outputs(got)):
            _close(g, w)


def test_gather_topk_matches_jax(zs):
    topk = tally.tally_topk(_rows, ZDataset(zs), k=3, batch_size=10)
    jtopk = jax_tally.tally_topk(_rows, JaxZDataset(zs), k=3, batch_size=10)
    calls = []

    def crop(z):
        calls.append(len(z))
        return z[:, :5] * 2.0
    got = tally.gather_topk(crop, ZDataset(zs), topk, batch_size=10)
    needed = {int(i) // 10 for i in topk.result()[1].numpy().ravel()}
    assert len(calls) == len(needed)      # only batches holding a top image
    want = jax_tally.gather_topk(crop, JaxZDataset(zs), jtopk,
                                 batch_size=10)
    assert got.result().shape == (6, 3, 5)
    np.testing.assert_array_equal(got.result(), np.asarray(want.result()))


def test_cat_and_cat_dict_match_jax(zs, tmp_path):
    got = tally.tally_cat(_rows, ZDataset(zs), batch_size=10,
                          cachefile=str(tmp_path / "cat.npz"))
    want = jax_tally.tally_cat(_rows, JaxZDataset(zs), batch_size=10)
    _close(got, want)
    back = jax_tally.tally_cat(None, JaxZDataset(zs), batch_size=10,
                               cachefile=str(tmp_path / "cat.npz"))
    _close(back, want)

    def both(z):
        return {"a": _rows(z), "b": z[:, :1] * 3.0}
    path = str(tmp_path / "cd.npz")
    got = tally.tally_cat_dict(both, ZDataset(zs), batch_size=10,
                               cachefile=path)
    want = jax_tally.tally_cat_dict(both, JaxZDataset(zs), batch_size=10)
    assert sorted(got) == sorted(want) == ["a", "b"]
    for k in want:
        _close(got[k], want[k])
    again = tally.tally_cat_dict(None, ZDataset(zs), batch_size=10,
                                 cachefile=path)
    for k in want:
        np.testing.assert_array_equal(again[k].numpy(), got[k].numpy())


def _segs(b, h, w, seed):
    rng = np.random.RandomState(seed)
    segs = rng.randint(0, 4, size=(b, 2, h, w)).astype(np.int64)
    segs[:, 1] = np.where(segs[:, 1] == 3, 9, 0)   # a second label channel
    return segs


@pytest.mark.parametrize("seg_hw", [(4, 4), (8, 8), (3, 5)],
                         ids=["same", "larger", "other"])
def test_conditional_samples_match_jax(seg_hw):
    """The same pairs in the same order (condition 0, then the labels
    ascending), segmentations at the activations' size or aligned by
    nearest neighbour."""
    acts = np.random.RandomState(1).randn(2, 4, 4, 3).astype(np.float32)
    segs = _segs(2, *seg_hw, seed=2)
    got = tally.conditional_samples(torch.as_tensor(acts),
                                    torch.as_tensor(segs))
    want = jax_tally.conditional_samples(acts, segs)
    assert [c for c, _ in got] == [c for c, _ in want]
    assert got[0][0] == 0 and got[0][1].shape == (32, 3)
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _cond_compute(z):
    """[(condition, rows)] of a z batch: rows of _rows, conditions by the
    sign of z's first two entries."""
    rows = _rows(z)
    if isinstance(z, torch.Tensor):
        acts = rows[:, None, None, :]
        segs = torch.stack([(z[:, 0] > 0).long() * 1,
                            (z[:, 1] > 0).long() * 2], 1)[:, :, None, None]
        return tally.conditional_samples(acts, segs)
    acts = np.asarray(rows)[:, None, None, :]
    z = np.asarray(z)
    segs = np.stack([(z[:, 0] > 0) * 1, (z[:, 1] > 0) * 2],
                    1)[:, :, None, None]
    return jax_tally.conditional_samples(acts, segs)


CONDITIONAL_TALLIES = {
    "mean": ("tally_conditional_mean", {}, lambda r: r.mean()),
    "topk": ("tally_conditional_topk", {"k": 3}, lambda r: r.result()[0]),
    "quantile": ("tally_conditional_quantile", {"resolution": 64},
                 lambda r: r.quantiles([0.1, 0.5, 0.9])),
}


@pytest.mark.parametrize("name", sorted(CONDITIONAL_TALLIES))
def test_conditional_tallies_match_jax(zs, name, tmp_path):
    fn, kw, result = CONDITIONAL_TALLIES[name]
    path = str(tmp_path / "cond.npz")
    got = getattr(tally, fn)(_cond_compute, ZDataset(zs), batch_size=10,
                             cachefile=path, **kw)
    want = getattr(jax_tally, fn)(_cond_compute, JaxZDataset(zs),
                                  batch_size=10, **kw)
    assert sorted(got.keys()) == sorted(want.keys()) == [0, 1, 2]
    for c in want.keys():
        _close(np.asarray(result(got.conditional(c))),
               np.asarray(result(want.conditional(c))))
        assert got.conditional(c).count == want.conditional(c).count
    back = getattr(jax_tally, fn)(None, JaxZDataset(zs), batch_size=10,
                                  cachefile=path, **kw)
    for c in want.keys():
        _close(np.asarray(result(back.conditional(c))),
               np.asarray(result(want.conditional(c))))


def test_iou_from_conditional_indicator_mean_synthetic():
    """tests/test_dissect.py's case: unit 0 fires exactly on condition 1
    (IoU 1), unit 1 never fires."""
    rng = np.random.RandomState(0)
    n = 1000
    cond = rng.randint(1, 3, size=n)
    ind = np.zeros((n, 2), np.float32)
    ind[:, 0] = (cond == 1)
    cmv, jcmv = running.RunningConditionalMean(), \
        jax_running.RunningConditionalMean()
    for c, rows in ((0, ind), (1, ind[cond == 1]), (2, ind[cond == 2])):
        cmv.add(c, torch.as_tensor(rows))
        jcmv.add(c, jnp.asarray(rows))
    iou = tally.iou_from_conditional_indicator_mean(cmv)
    assert isinstance(iou, np.ndarray) and iou.shape == (3, 2)
    _close(iou, jax_tally.iou_from_conditional_indicator_mean(jcmv))
    np.testing.assert_allclose(iou[1, 0], 1.0, atol=1e-5)
    np.testing.assert_allclose(iou[2, 0], 0.0, atol=1e-5)
    np.testing.assert_allclose(iou[:, 1], 0.0, atol=1e-5)


@pytest.fixture(scope="module")
def condq_pair():
    """tests/test_dissect.py's case: condition 1 holds the top 5% of unit
    0's values; both packages' conditional sketches."""
    rng = np.random.RandomState(1)
    n = 20000
    vals = rng.rand(n, 2).astype(np.float32)
    cond1 = vals[:, 0] > 0.95
    cq = running.RunningConditionalQuantile(resolution=1024)
    jcq = jax_running.RunningConditionalQuantile(resolution=1024)
    for lo in range(0, n, 2048):
        sel = slice(lo, lo + 2048)
        cq.add(0, torch.as_tensor(vals[sel]))
        jcq.add(0, jnp.asarray(vals[sel]))
        if cond1[sel].any():
            cq.add(1, torch.as_tensor(vals[sel][cond1[sel]]))
            jcq.add(1, jnp.asarray(vals[sel][cond1[sel]]))
    return cq, jcq


@pytest.mark.parametrize("stat", ["iou", "mi", "iqr"])
@pytest.mark.parametrize("cutoff", [0.95, (0.9, 0.95, 0.99)],
                         ids=["one", "three"])
def test_quantile_statistics_match_jax(condq_pair, stat, cutoff):
    cq, jcq = condq_pair
    got = getattr(tally, f"{stat}_from_conditional_quantile")(cq,
                                                               cutoff=cutoff)
    want = getattr(jax_tally, f"{stat}_from_conditional_quantile")(
        jcq, cutoff=cutoff)
    assert isinstance(got, np.ndarray)
    _close(got, want)
    if stat == "iou" and cutoff == 0.95:
        assert got[0, 1] > 0.7 and got[1, 1] < 0.3
    if stat == "mi" and cutoff == 0.95:
        assert got[0, 1] > got[1, 1]


def test_information_statistics_match_jax():
    arr = np.random.RandomState(3).dirichlet(np.ones(4), size=5).T.reshape(
        2, 2, 5)
    arr[:, :, 0] = [[0.5, 0.0], [0.0, 0.5]]       # zero cells
    for fn in ("mutual_information", "joint_entropy",
               "information_quality_ratio", "intersection_over_union"):
        np.testing.assert_allclose(getattr(tally, fn)(arr),
                                   np.asarray(getattr(jax_tally, fn)(arr)),
                                   rtol=1e-12)
