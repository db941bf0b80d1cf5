"""The port's reducers and quantile sketch against the JAX package's.

Both packages get the same numpy-seeded batches.  Tolerances: reducer
states and merges 1e-5 of the largest entry (fp32 sums in another order);
bincounts and top-k values exact (top-k indices compared where the values
are finite: the -inf fill of an unfilled slot ties); the quantile sketch
fed the same float32 stream with the same seed holds the same level
buffers (``np.array_equal``) and extremes, and its queries agree to 1e-6
of the range.  The adversarial stream of tests/test_stats.py holds the
0.001 rank bound at the default resolution on the port alone.  Caches
written by one package load in the other, the constructor tag ignored.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rewriting_tpu.stats import quantile as jax_quantile
from rewriting_tpu.stats import running as jax_running
from rewriting_tpu.stats import tally as jax_tally
from rewriting_tpu.utils.zdataset import ZDataset as JaxZDataset
from rewriting_torch import stats
from rewriting_torch.stats import RunningQuantile, running, tally
from rewriting_torch.utils.zdataset import ZDataset

torch.set_num_threads(1)


def _close(got, want, rel=1e-5):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-12)
    np.testing.assert_allclose(got, want, atol=rel * scale, rtol=0)


def _batches(data, bs):
    return [data[i:i + bs] for i in range(0, len(data), bs)]


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(0)
    return (rng.randn(500, 16) * rng.gamma(2, 2, 16)[None]
            + rng.randn(16)[None]).astype(np.float32)


def _feed(obj, batches, as_array):
    for b in batches:
        if isinstance(b, tuple):
            obj.add(*(as_array(x) for x in b))
        else:
            obj.add(as_array(b))
    return obj


REDUCERS = {
    "mean": ("RunningMean", {}, lambda r: [r.mean()]),
    "second_moment": ("RunningSecondMoment", {}, lambda r: [r.moment()]),
    "variance": ("RunningVariance", {},
                 lambda r: [r.mean(), r.variance(), r.stdev(),
                            r.variance(unbiased=False)]),
    "covariance": ("RunningCovariance", {},
                   lambda r: [r.mean(), r.covariance(), r.correlation(),
                              r.variance()]),
}


@pytest.mark.parametrize("name", sorted(REDUCERS))
def test_reducer_matches_jax(data, name):
    cls, kw, outputs = REDUCERS[name]
    got = _feed(getattr(running, cls)(**kw), _batches(data, 64),
                torch.as_tensor)
    want = _feed(getattr(jax_running, cls)(**kw), _batches(data, 64),
                 jnp.asarray)
    for g, w in zip(outputs(got), outputs(want)):
        _close(g, w)
    assert got.count == want.count == 500
    sd, jsd = got.state_dict(), want.state_dict()
    assert sorted(sd) == sorted(jsd)
    assert str(sd["constructor"]) == f"rewriting_torch.stats.{cls}"


def test_cross_covariance_matches_jax(data):
    pairs = [(b[:, :10], b[:, 10:]) for b in _batches(data, 64)]
    got = _feed(running.RunningCrossCovariance(), pairs, torch.as_tensor)
    want = _feed(jax_running.RunningCrossCovariance(), pairs, jnp.asarray)
    _close(got.cross_covariance(), want.cross_covariance())
    for g, w in zip(got.mean(), want.mean()):
        _close(g, w)


MERGES = {
    "mean": ("mean_init", "mean_update", "mean_merge", lambda d: (16,)),
    "second_moment": ("second_moment_init", "second_moment_update",
                      "second_moment_merge", lambda d: 16),
    "variance": ("variance_init", "variance_update", "variance_merge",
                 lambda d: (16,)),
    "covariance": ("covariance_init", "covariance_update",
                   "covariance_merge", lambda d: 16),
}


@pytest.mark.parametrize("name", sorted(MERGES))
def test_merge_matches_jax_and_one_stream(data, name):
    """Two shards merged equal the JAX package's merge, and one stream."""
    init, update, merge, shape = MERGES[name]

    def run(mod, arr):
        a = getattr(mod, update)(getattr(mod, init)(shape(data)),
                                 arr(data[:200]))
        b = getattr(mod, update)(getattr(mod, init)(shape(data)),
                                 arr(data[200:]))
        one = getattr(mod, update)(getattr(mod, init)(shape(data)),
                                   arr(data))
        return getattr(mod, merge)(a, b), one

    (got, one), (want, _) = run(running, torch.as_tensor), \
        run(jax_running, jnp.asarray)
    for k in want:
        _close(got[k], want[k])
        _close(got[k], one[k], rel=1e-4)
    empty = getattr(running, merge)(getattr(running, init)(shape(data)),
                                    getattr(running, init)(shape(data)))
    assert float(empty["count"]) == 0 and all(
        bool(torch.isfinite(v).all()) for v in empty.values())


def test_bincount_topk_and_iou_match_jax():
    rng = np.random.RandomState(2)
    ints = rng.randint(0, 70, size=(300, 7))     # some beyond size 64
    got = _feed(running.RunningBincount(size=64), _batches(ints, 100),
                torch.as_tensor)
    want = _feed(jax_running.RunningBincount(size=64), _batches(ints, 100),
                 jnp.asarray)
    np.testing.assert_array_equal(got.result().numpy(),
                                  np.asarray(want.result()))
    assert got.count == want.count == 300

    scores = rng.randn(1000, 8).astype(np.float32)
    got = _feed(running.RunningTopK(k=10), _batches(scores, 128),
                torch.as_tensor)
    want = _feed(jax_running.RunningTopK(k=10), _batches(scores, 128),
                 jnp.asarray)
    np.testing.assert_array_equal(got.result()[0].numpy(),
                                  np.asarray(want.result()[0]))
    np.testing.assert_array_equal(got.result()[1].numpy(),
                                  np.asarray(want.result()[1]))
    assert got.count == 1000 and got.result()[1].dtype == torch.int32
    # fewer samples than k: the unfilled slots hold -inf; indices compared
    # where the values are finite
    few = running.RunningTopK(k=10)
    few.add(torch.as_tensor(scores[:4]))
    jfew = jax_running.RunningTopK(k=10)
    jfew.add(jnp.asarray(scores[:4]))
    vals = few.result()[0].numpy()
    np.testing.assert_array_equal(vals, np.asarray(jfew.result()[0]))
    fin = np.isfinite(vals)
    assert fin.sum() == 4 * 8
    np.testing.assert_array_equal(few.result()[1].numpy()[fin],
                                  np.asarray(jfew.result()[1])[fin])

    a = rng.rand(400, 5) > 0.5
    b = rng.rand(400, 6) > 0.7
    pairs = [(a[i:i + 128], b[i:i + 128]) for i in range(0, 400, 128)]
    got = _feed(running.RunningAllIntersectionAndUnion(), pairs,
                torch.as_tensor)
    want = _feed(jax_running.RunningAllIntersectionAndUnion(), pairs,
                 jnp.asarray)
    _close(got.iou(), want.iou())
    _close(got.intersection(), want.intersection())


def test_gather_tensor_matches_jax():
    rng = np.random.RandomState(3)
    scores = rng.randn(40, 3).astype(np.float32)
    topk = running.RunningTopK(k=2)
    topk.add(torch.as_tensor(scores))
    jtopk = jax_running.RunningTopK(k=2)
    jtopk.add(jnp.asarray(scores))
    gt, jgt = running.GatherTensor(topk=topk), \
        jax_running.GatherTensor(topk=jtopk)
    for u in range(3):
        for r in range(2):
            row = rng.randn(4).astype(np.float32)
            gt.add(u, r, row)
            jgt.add(u, r, row)
    gt.add(4, 1, np.ones(4, np.float32))        # grows past the units
    jgt.add(4, 1, np.ones(4, np.float32))
    np.testing.assert_array_equal(gt.result(), jgt.result())
    back = running.GatherTensor()
    back.set_state_dict(jgt.state_dict())
    np.testing.assert_array_equal(back.result(), gt.result())
    assert back.k == 2


CONDITIONALS = {
    "mean": ("RunningConditionalMean", {}, lambda r: r.mean()),
    "variance": ("RunningConditionalVariance", {}, lambda r: r.variance()),
    "topk": ("RunningConditionalTopK", {"k": 3}, lambda r: r.result()[0]),
    "quantile": ("RunningConditionalQuantile", {"resolution": 64},
                 lambda r: r.quantiles([0.1, 0.5, 0.9])),
}


@pytest.mark.parametrize("name", sorted(CONDITIONALS))
def test_conditional_state_dicts_match_jax(data, name, tmp_path):
    """The same keys (``conditions``, ``c.{repr}.{key}``), the same
    arrays, and each package's npz loaded by the other."""
    cls, kw, result = CONDITIONALS[name]
    got, want = getattr(running, cls)(**kw), getattr(jax_running, cls)(**kw)
    labels = np.arange(500) % 3
    for lo in range(0, 500, 100):
        for cond in (0, 1, 2):
            rows = data[lo:lo + 100][labels[lo:lo + 100] == cond] \
                if cond else data[lo:lo + 100]
            got.add(cond, torch.as_tensor(rows))
            want.add(cond, jnp.asarray(rows))
    sd, jsd = got.state_dict(), want.state_dict()
    assert sorted(sd) == sorted(jsd)
    assert list(sd["conditions"]) == list(jsd["conditions"]) == \
        ["0", "1", "2"]
    for k in jsd:
        if k.endswith("constructor"):
            continue
        _close(np.asarray(sd[k], np.float64), np.asarray(jsd[k], np.float64))
    assert got.most_common_conditions(1) == [0]
    for writer, reader_mod, sdict in (("torch", jax_running, sd),
                                      ("jax", running, jsd)):
        path = str(tmp_path / f"{writer}.npz")
        np.savez(path, **sdict)
        back = getattr(reader_mod, cls)(**kw)
        with np.load(path) as f:
            back.set_state_dict(dict(f))
        assert sorted(back.keys()) == [0, 1, 2]
        for c in (0, 1, 2):
            _close(np.asarray(result(back.conditional(c))),
                   np.asarray(result(want.conditional(c))))


def _stream(n=30000, units=4, seed=5):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, units) * np.array([1, 10, 0.1, 3])[None]
            ).astype(np.float32)


@pytest.mark.parametrize("resolution,bs", [(6 * 1024, 1999), (256, 333)])
def test_quantile_sketch_equals_jax(resolution, bs):
    """The same stream and seed: the same level buffers, extremes and
    fills; the queries within 1e-6 of the range."""
    x = _stream()
    got = RunningQuantile(resolution=resolution, seed=3)
    want = jax_quantile.RunningQuantile(resolution=resolution, seed=3)
    for b in _batches(x, bs):
        got.add(torch.as_tensor(b))
        want.add(jnp.asarray(b))
    sd, jsd = got.state_dict(), want.state_dict()
    assert sorted(sd) == sorted(jsd) and len(got.fill) > 2
    for k in jsd:
        if k != "constructor":
            assert np.array_equal(sd[k], jsd[k]), k
    span = x.max(0) - x.min(0)
    qs = np.linspace(0, 1, 41)
    for g, w in ((got.quantiles(qs), want.quantiles(qs)),
                 (got.integrate(lambda v: v), want.integrate(lambda v: v)),
                 (got.mean(), want.mean())):
        assert isinstance(g, np.ndarray)
        np.testing.assert_allclose(g.reshape(4, -1),
                                   np.asarray(w).reshape(4, -1),
                                   atol=1e-6 * span.max(), rtol=1e-6)
    # normalize through both searches: the flat one (few values a unit)
    # and the per-row loop (more than _FLAT_SEARCH_MAX_N)
    for n in (5, 300):
        probe = x[:n].T
        np.testing.assert_allclose(got.normalize(probe),
                                   np.asarray(want.normalize(probe)),
                                   atol=1e-6)
    np.testing.assert_array_equal(got.normalize(probe[:, 0]),
                                  np.asarray(want.normalize(probe[:, 0])))
    np.testing.assert_array_equal(got.min(), x.min(0))
    np.testing.assert_array_equal(got.max(), x.max(0))
    assert got.size == want.size == len(x)


def test_quantile_adversarial():
    """The adversarial stream of tests/test_stats.py (interleaved, ragged
    batches): exact extremes, rank error under 0.001 of the range at the
    default resolution, normalize the inverse map, the state dict round
    trip and the integral."""
    n = 50000
    base = np.arange(n, dtype=np.float32)
    stream = base[np.argsort((np.arange(n) * 37) % n, kind="stable")]
    scales = np.array([1.0, 0.01, 100.0], np.float32)
    x = stream[:, None] * scales[None, :]
    rq = RunningQuantile()
    for b in _batches(x, 1999):
        rq.add(torch.as_tensor(b))
    assert rq.count == n
    np.testing.assert_allclose(rq.min(), 0.0)
    np.testing.assert_allclose(rq.max(), (n - 1) * scales)
    qs = np.linspace(0, 1, 101)
    est = rq.quantiles(qs)
    want = qs[None, :] * (n - 1) * scales[:, None]
    rank_err = np.abs(est - want) / ((n - 1) * scales[:, None])
    assert rank_err.max() < 0.001, rank_err.max()
    probe = np.array([0.25, 0.5, 0.75], np.float32)[None, :] * (
        (n - 1) * scales[:, None])
    np.testing.assert_allclose(rq.normalize(probe), [[0.25, 0.5, 0.75]] * 3,
                               atol=0.02)
    back = RunningQuantile(state=rq.state_dict())
    np.testing.assert_allclose(back.quantiles(qs), est)
    assert back.count == n
    np.testing.assert_allclose(rq.integrate(lambda v: v),
                               stream.sum() * scales, rtol=0.02)


def test_quantile_small_and_one_unit():
    rng = np.random.RandomState(0)
    x = rng.randn(500, 4).astype(np.float32)
    rq = RunningQuantile(resolution=4096)
    rq.add(torch.as_tensor(x))
    est = rq.quantiles([0.0, 0.5, 1.0])
    np.testing.assert_allclose(est[:, 0], x.min(0), rtol=1e-5)
    np.testing.assert_allclose(est[:, 2], x.max(0), rtol=1e-5)
    np.testing.assert_allclose(est[:, 1], np.median(x, axis=0), atol=0.02)
    one = RunningQuantile()
    one.add(x[:, 0])            # (N,) is one unit
    assert one.units == 1 and one.quantiles([0.5]).shape == (1, 1)
    with pytest.raises(ValueError):
        one.add(x)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_quantile_cache_loads_in_both_packages(tmp_path, writer):
    """tally_quantile's npz cache, written by either package, loads in
    the other (its constructor tag ignored) and gives the same
    quantiles; a changed resolution recomputes.  The JAX package's
    ``tally_quantile`` cannot read back any cache of its own (its
    ``load_cached_state`` takes out ``resolution``, which its sketch's
    state needs: ROADMAP.md queue 3), so it reads the port's file through
    the sketch's state dict, as that tally would."""
    x = _stream(6000)
    zds, jzds = ZDataset(x), JaxZDataset(x)
    path = str(tmp_path / "rq.npz")
    calls = []

    def compute(z):
        calls.append(1)
        return z * 2.0
    if writer == "jax":
        first = jax_tally.tally_quantile(compute, jzds, resolution=512,
                                         batch_size=1000, cachefile=path)
        back = tally.tally_quantile(compute, zds, resolution=512,
                                    batch_size=1000, cachefile=path)
        assert str(np.load(path)["constructor"]).startswith("rewriting_tpu")
    else:
        first = tally.tally_quantile(compute, zds, resolution=512,
                                     batch_size=1000, cachefile=path)
        back = jax_quantile.RunningQuantile(
            resolution=512, state=jax_tally.load_cached_state(
                path, {"sample_size": 6000, "batch_size": 1000}))
        tally.tally_quantile(compute, zds, resolution=512, batch_size=1000,
                             cachefile=path)
    assert len(calls) == 6          # the second read the cache
    qs = np.linspace(0, 1, 11)
    np.testing.assert_array_equal(np.asarray(back.quantiles(qs)),
                                  np.asarray(first.quantiles(qs)))
    tally.tally_quantile(compute, zds, resolution=256, batch_size=1000,
                         cachefile=path)
    assert len(calls) == 12


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_topk_and_quantile_cache_loads_in_both_packages(data, tmp_path,
                                                        writer):
    """One npz holding both reducers under ``topk.`` and ``rq.``."""
    w = np.ones((16, 4), np.float32)

    def compute(z):
        s = z @ (torch.as_tensor(w) if isinstance(z, torch.Tensor)
                 else jnp.asarray(w))
        return s, s
    path = str(tmp_path / "tq.npz")
    mods = [(jax_tally, JaxZDataset(data)), (tally, ZDataset(data))]
    if writer == "torch":
        mods.reverse()
    (wmod, wzds), (rmod, rzds) = mods
    topk, rq = wmod.tally_topk_and_quantile(compute, wzds, k=5,
                                            resolution=256, batch_size=64,
                                            cachefile=path)
    with np.load(path) as f:
        keys = set(f.files)
    assert {"topk.values", "topk.indices", "rq.level_0", "k",
            "resolution"} <= keys
    rtopk, rrq = rmod.tally_topk_and_quantile(
        lambda z: (_ for _ in ()).throw(AssertionError("recomputed")), rzds,
        k=5, resolution=256, batch_size=64, cachefile=path)
    for a, b in zip(rtopk.result(), topk.result()):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(np.asarray(rrq.quantiles([0.3])),
                                  np.asarray(rq.quantiles([0.3])))


def test_stats_exports_every_name_of_the_jax_package():
    from rewriting_tpu import stats as jax_stats
    assert set(jax_stats.__all__) <= set(stats.__all__)
    for name in jax_stats.__all__:
        assert hasattr(stats, name), name
