"""The rewriter's statistic caches under a mesh
(``rewriting_torch/rewrite/rewriter.py::GanRewriter._rank0_tally``), in a
4-rank gloo job on the CPU.

``unit_rs.npz`` (the units' mean squares), ``unit_rq.npz`` (their
quantile sketch) and ``unit_cad.npz`` (the covariance-adjusted keys'
sketch) are rank 0's: it tallies each and writes its file, and after a
collective that orders that write before the read every other rank reads
the file.  Counted in the job, each rank's rows passes and cache writes:
- the first rewriter (no files yet): rank 0 tallies each statistic and
  writes its file once; ranks 1-3 tally nothing and write nothing; every
  rank holds the same mean squares and the same quantiles (bit for bit),
  and rank 0's equal those of a rewriter without a mesh (the adjusted
  keys' within 1e-5 of their largest: they read the key moment, which the
  mesh all-reduces, tests/test_torch_parallel.py's bound);
- a second rewriter on the same cache dir: no rank tallies, every rank
  reads the files to the same numbers;
- ``statistics_alone`` (the server's rank-0 requests): rank 0 alone
  tallies and writes a new dir's cache while the others never call it,
  with no collective to wait in;
- a served mesh whose rewriter takes ``gandissect`` keys: an ``/edit``
  that rank 0 serves alone reads the units' quantiles there, and the next
  ``/edit_batch`` reads them on every rank; every rank enters the same
  collectives (a statistic that rank 0 kept from the alone edit would
  leave it out of the other ranks' read, and the job would hang), and the
  batch equals one device's after the same edit.
"""

import numpy as np
import pytest
import torch

from conftest import blob
from test_torch_parallel import run_job

torch.set_num_threads(1)

STATS = ("unit_rs", "unit_rq", "unit_cad")

JOB = """
from rewriting_torch.convert import params_from_jax
from rewriting_torch.models import ProgressiveGenerator
from rewriting_torch.parallel import make_mesh
from rewriting_torch.rewrite import ProgressiveGanRewriter
from rewriting_torch.stats import tally
from rewriting_torch.utils.zdataset import ZDataset

mesh = make_mesh(device="cpu")
pg = ProgressiveGenerator(sizes=[8, 8, 8], device="cpu")
params = params_from_jax(pg, load("params"))
zds = ZDataset(load("z"))
QS = torch.tensor([0.0, 0.1, 0.5, 0.9, 1.0])
writes = []
save = tally.save_cached_state


def counted_save(cachefile, obj, args):
    if cachefile is not None and "unit_" in os.path.basename(cachefile):
        writes.append(os.path.basename(cachefile))
    return save(cachefile, obj, args)


tally.save_cached_state = counted_save


def statistics(gw):
    passes = {}

    def counted(name, fn):
        def run(*args):
            passes[name] = passes.get(name, 0) + 1
            return fn(*args)
        return run
    # the rows functions of the three statistics read these two
    key_rows, context = gw._key_rows, gw._context
    out = {}
    for name, method in (
            ("unit_rs", gw.square_scales_for_units),
            ("unit_rq", gw.quantiles_for_units),
            ("unit_cad", gw.quantiles_for_covariance_adjusted_directions)):
        passes.clear()
        del writes[:]
        gw._key_rows = counted(name, key_rows)
        gw._context = counted(name, context)
        got = method()
        out[name] = {"passes": passes.get(name, 0), "writes": list(writes),
                     "value": got.clone() if torch.is_tensor(got)
                     else got.quantiles(QS)}
    gw._key_rows, gw._context = key_rows, context
    return out


cache = os.path.join(WORK, "cache")
first = ProgressiveGanRewriter(pg, params, zds, layernum=2, cachedir=cache,
                               stats_batch_size=8, mesh=mesh, device="cpu")
results["first"] = statistics(first)
results["files"] = sorted(f for f in os.listdir(cache)
                          if f.startswith("unit_"))
second = ProgressiveGanRewriter(pg, params, zds, layernum=2, cachedir=cache,
                                stats_batch_size=8, mesh=mesh, device="cpu")
results["second"] = statistics(second)
if RANK == 0:
    alone = ProgressiveGanRewriter(pg, params, zds, layernum=2,
                                   stats_batch_size=8, device="cpu")
    results["no_mesh"] = statistics(alone)
    third = ProgressiveGanRewriter.__new__(ProgressiveGanRewriter)
    third.__dict__.update(first.__dict__)
    third.cachedir = os.path.join(WORK, "alone")
    third.unit_rs = None
    with third.statistics_alone():
        third.square_scales_for_units()
    results["alone_files"] = sorted(os.listdir(third.cachedir))
"""


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    import jax

    from rewriting_tpu.models import ProgressiveGenerator as JaxProgGAN
    from rewriting_tpu.utils.zdataset import z_dataset_for_model
    pm = JaxProgGAN(sizes=[8, 8, 8])
    params = jax.tree_util.tree_map(np.asarray,
                                    pm.init_params(jax.random.PRNGKey(0)))
    return run_job(tmp_path_factory.mktemp("caches"), 4, JOB, {
        "params": params, "z": z_dataset_for_model(pm, 24).zs})


SERVE_JOB = """
import json
import threading
import urllib.request

from rewriting_torch import serve
from rewriting_torch.convert import params_from_jax
from rewriting_torch.models import ProgressiveGenerator
from rewriting_torch.parallel import make_mesh
from rewriting_torch.rewrite import ProgressiveGanRewriter, multi
from rewriting_torch.utils.zdataset import ZDataset

mesh = make_mesh(device="cpu")
pe = ProgressiveGenerator(sizes=[16, 16, 8, 8], device="cpu")
params = params_from_jax(pe, load("params"))
zds = ZDataset(load("z"))
requests = load("requests")
kw = dict(layernum=3, stats_batch_size=20, key_method="gandissect",
          device="cpu")
gw = ProgressiveGanRewriter(pe, params, zds, mesh=mesh,
                            cachedir=os.path.join(WORK, "cache"), **kw)
if RANK != 0:
    serve.serve_workers(gw)
else:
    httpd = serve.serve(gw, port=0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"

    def post(path, body):
        req = urllib.request.Request(url + path, json.dumps(body).encode(),
                                     {"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as r:
            return json.loads(r.read())
    try:
        results["edit"] = post("/edit", {"request": requests[0], "niter": 11,
                                         "method": "fast"})
        results["batch"] = post("/edit_batch", {"requests": requests[1:],
                                                "niter": 15})
        results["batch_weights"] = httpd.service._batch_weights
    finally:
        httpd.shutdown()
        httpd.server_close()
        httpd.service.stop_workers()
    alone = serve.EditingService(ProgressiveGanRewriter(pe, params, zds,
                                                        **kw))
    alone.edit(requests[0], niter=11, method="fast")
    results["alone"] = multi.batch_apply_edits(alone.gw, requests[1:],
                                               niter=15)
results["cache"] = sorted(os.listdir(os.path.join(WORK, "cache")))
"""


@pytest.fixture(scope="module")
def serve_job(tmp_path_factory):
    import jax

    from rewriting_tpu.models import ProgressiveGenerator as JaxProgGAN
    from rewriting_tpu.utils.zdataset import z_dataset_for_model
    from rewriting_torch.utils.renormalize import mask_to_url
    pm = JaxProgGAN(sizes=[16, 16, 8, 8])
    params = jax.tree_util.tree_map(np.asarray,
                                    pm.init_params(jax.random.PRNGKey(3)))
    vh = vw = 8                 # layer 3's map
    requests = [{"object": [i, mask_to_url(blob(vh, vw, 2 + i % 3, 2, 2))],
                 "paste": [i + 4, mask_to_url(blob(vh, vw, 5, 5 - i % 2, 2))]}
                for i in range(3)]
    return run_job(tmp_path_factory.mktemp("serve"), 4, SERVE_JOB, {
        "params": params, "z": z_dataset_for_model(pm, 20).zs,
        "requests": requests}, timeout=240.0)


def test_served_gandissect_edit_then_batch_on_four_ranks(serve_job):
    """An ``/edit`` served on rank 0 alone, then an ``/edit_batch`` over the
    4 ranks: the job ends (no rank waits in a collective the others
    skipped), rank 0 wrote the quantiles' cache, and the batch equals one
    device's after the same edit."""
    got = serve_job[0]
    assert got["edit"]["ok"] and got["batch"]["ok"]
    assert "unit_rq.npz" in got["cache"]
    want_w, want_l = got["alone"]
    assert got["batch"]["n"] == len(want_w) == 2
    np.testing.assert_allclose(got["batch"]["final_losses"], want_l, rtol=0,
                               atol=1e-6)
    for w, v in zip(got["batch_weights"], want_w):
        np.testing.assert_allclose(w.numpy(), v.numpy(), rtol=0, atol=2e-2)


def _same(a, b) -> bool:
    return torch.equal(torch.as_tensor(a), torch.as_tensor(b))


@pytest.mark.parametrize("stat", STATS)
def test_rank_0_tallies_and_writes_each_cache_once(job, stat):
    assert job[0]["files"] == [f"{s}.npz" for s in sorted(STATS)]
    first0 = job[0]["first"][stat]
    assert first0["passes"] > 0 and first0["writes"] == [f"{stat}.npz"]
    for rank, got in enumerate(job[1:], 1):
        mine = got["first"][stat]
        assert mine["passes"] == 0 and mine["writes"] == [], (rank, mine)
        assert _same(mine["value"], first0["value"]), rank
    alone = np.asarray(job[0]["no_mesh"][stat]["value"])
    if stat == "unit_cad":      # C^-1 k of the sharded key moment
        np.testing.assert_allclose(np.asarray(first0["value"]), alone,
                                   rtol=0, atol=1e-5 * np.abs(alone).max())
    else:
        assert _same(first0["value"], alone)


@pytest.mark.parametrize("stat", STATS)
def test_a_second_rewriter_reads_the_caches_on_every_rank(job, stat):
    want = job[0]["first"][stat]["value"]
    for rank, got in enumerate(job):
        mine = got["second"][stat]
        assert mine["passes"] == 0 and mine["writes"] == [], (rank, mine)
        assert _same(mine["value"], want), rank


def test_statistics_alone_take_no_collective(job):
    """Rank 0 alone tallied a new dir's mean squares (the other ranks
    never called it) and wrote its file."""
    assert job[0]["alone_files"] == ["unit_rs.npz"]
