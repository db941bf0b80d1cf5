"""The port's data-parallel paths (``rewriting_torch/parallel/mesh.py`` and
its callers) in real gloo jobs on the CPU, against the single-device port
and the JAX package's mesh functions on the 8 virtual CPU devices of
tests/conftest.py.

Each job is 2 or 4 fresh Python processes (importing only the port) that
join a process group through a file store and save what they computed;
the checks read it.  Spec: tests/test_sharded_stats.py, plus the port's
own: the noise of each rank's global image positions, the statistics
cache, ``batch_apply_edits(mesh=)`` (uneven splits too), the server's
``/edit_batch`` over a 2-rank job, and the dry run.

Tolerances:
- dp sampling: the port's ranks render batches of B/n, whose convolutions
  round otherwise than at B on the CPU: 1e-5 of the largest value against
  the single-device port and the JAX package (the JAX test holds the
  spatial sampler to 1e-5 abs);
- the second moments: rtol 1e-5, atol 1e-5 (tests/test_sharded_stats.py);
- ``sample_clean(mesh=)``: byte-identical PNGs on the CPU against the
  single-device port and the JAX package (the JAX test's own contract);
- batched edits, held by their losses and span(D) (the verify notes):
  the ranks solve sub-batches, whose grouped convolutions round
  otherwise, and L1 + Adam turn such rounding into whole steps of lr
  where a gradient is near 0; so the losses within 1e-6 abs of the
  unsharded batch, every change in span(D) within 1e-4 of its norm
  (chip_smoke.SPAN_TOL; measured 1.8e-5, float32 rounding of the
  low-rank update), the
  weights within 2e-2 abs (tests/test_torch_multi_edit.py's bound where
  the batch rounds otherwise than the single solve; measured 1.7e-3), and
  the JAX mesh batch's losses within 1% (that file's cross-package bound
  on a request's own goal).
"""

import os
import pathlib
import pickle
import subprocess
import sys
import textwrap
import time

import jax
import numpy as np
import pytest
import torch

from conftest import blob
from rewriting_tpu.metrics.sample import sample_clean as jax_sample_clean
from rewriting_tpu.models import ProgressiveGenerator as JaxProgGAN
from rewriting_tpu.models import SeqStyleGAN2 as JaxSeqStyleGAN2
from rewriting_tpu.parallel import make_mesh as jax_make_mesh
from rewriting_tpu.parallel import sharded_sampler as jax_sharded_sampler
from rewriting_tpu.rewrite import ProgressiveGanRewriter as JaxProgRewriter
from rewriting_tpu.rewrite import multi as jax_multi
from rewriting_tpu.stats import tally as jax_tally
from rewriting_tpu.utils.zdataset import z_dataset_for_model as jax_zds
from rewriting_torch.utils.renormalize import mask_to_url

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]

_PREAMBLE = """
import os, pickle, sys
sys.path.insert(0, {repo!r})
import numpy as np
import torch
torch.set_num_threads(1)
from rewriting_torch.parallel import comm
RANK, WORLD, WORK = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
comm.init_process_group(RANK, WORLD,
                        "file://" + os.path.join(WORK, "store"),
                        device="cpu")


def load(name):
    with open(os.path.join(WORK, name + ".pkl"), "rb") as f:
        return pickle.load(f)


results = {{}}
"""

_POST = """
comm.barrier()
torch.save(results, os.path.join(WORK, f"rank{RANK}.pt"))
comm.destroy_process_group()
"""


def run_job(workdir, world: int, body: str, inputs=None,
            timeout: float = 300.0):
    """`body` on `world` gloo ranks on the CPU, each a fresh Python that
    imports only the port, with `inputs` (name -> picklable object, read
    by ``load(name)``); returns each rank's ``results`` dict.  Raises with
    the ranks' output if any fails."""
    workdir = pathlib.Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    for name, obj in (inputs or {}).items():
        with open(workdir / f"{name}.pkl", "wb") as f:
            pickle.dump(obj, f)
    code = (_PREAMBLE.format(repo=str(REPO)) + textwrap.dedent(body)
            + _POST)
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    logs = [open(workdir / f"log{r}.txt", "w+") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r),
                               str(world), str(workdir)], stdout=logs[r],
                              stderr=subprocess.STDOUT, env=env, cwd=REPO)
             for r in range(world)]
    deadline = time.time() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.time()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    outputs = []
    for log in logs:
        log.seek(0)
        outputs.append(log.read())
        log.close()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} of {world}:\n{outputs[r]}"
    return [torch.load(workdir / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


def with_noise(tree: dict, seed: int = 0) -> dict:
    """A StyleGAN2 params tree (numpy) with nonzero noise strengths, so
    that the noise each image reads shows in its render."""
    rng = np.random.RandomState(seed)
    out = dict(tree)
    for name in tree:
        if name.endswith(".noise"):
            out[name] = {"weight": rng.uniform(0.2, 0.8, (1,))
                         .astype(np.float32)}
    return out


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, rel=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-12)
    np.testing.assert_allclose(got, want, atol=rel * scale, rtol=0)


# -- the jobs -------------------------------------------------------------------

DP_JOB = """
from rewriting_torch.convert import params_from_jax
from rewriting_torch.metrics.sample import sample_clean
from rewriting_torch.models import ProgressiveGenerator, SeqStyleGAN2
from rewriting_torch.parallel import (make_mesh, sharded_sampler,
                                      sharded_second_moment)
from rewriting_torch.rewrite import (ProgressiveGanRewriter, multi,
                                     projected_conv)
from rewriting_torch.stats import tally
from rewriting_torch.utils.zdataset import ZDataset

mesh = make_mesh(device="cpu")
group = mesh.group("data")

# dp sampling, the noise of the global positions
sg = SeqStyleGAN2(16, style_dim=64, n_mlp=2, device="cpu")
sgp = params_from_jax(sg, load("sg_params"))
z = load("sg_z")
local = sharded_sampler(sg, mesh)(sgp, z)
results["dp"] = comm.all_gather(local, group)
results["dp_single"] = sg(sgp, z)
lo = RANK * (len(z) // WORLD)
zl = torch.as_tensor(z[lo:lo + len(z) // WORLD])
prefix = {k: v[:len(zl)] for k, v in sg.prepare_noise(len(zl)).items()}
results["dp_prefix_noise"] = comm.all_gather(sg(sgp, zl, prefix), group)

# the second moments
zs = load("moment_z")
rows = lambda zb: zb * 2.0 + 1.0
results["moment"] = tally.tally_second_moment(rows, zs, 16, "cpu",
                                              mesh=mesh).moment()
results["moment_single"] = tally.tally_second_moment(rows, zs, 16,
                                                     "cpu").moment()
xtx, n = sharded_second_moment(rows, mesh)(zs[:16])
results["xtx"], results["xtx_n"] = xtx, float(n)
cache = os.path.join(WORK, "r2m.npz")
first = tally.cached_second_moment(rows, zs, 16, "cpu", cache,
                                   {"sample_size": len(zs)}, mesh=mesh)


def no_rows(zb):
    raise AssertionError("the cached moment was computed again")


# the call's opening barrier orders rank 0's write before every rank's read
again = tally.cached_second_moment(no_rows, zs, 16, "cpu", cache,
                                   {"sample_size": len(zs)}, mesh=mesh)
results["cache_written"] = os.path.exists(cache)
results["cached_moment"] = (first.moment(), again.moment())

# the rewriter with a mesh, and the edits over it
pg = ProgressiveGenerator(sizes=[8, 8, 8], device="cpu")
pgp = params_from_jax(pg, load("pg_params"))
zds = ZDataset(load("pg_z"))
gw = ProgressiveGanRewriter(pg, pgp, zds, layernum=2, stats_batch_size=8,
                            mesh=mesh, cachedir=os.path.join(WORK, "rw"),
                            device="cpu")
single = ProgressiveGanRewriter(pg, pgp, zds, layernum=2, stats_batch_size=8,
                                device="cpu")
results["c_matrix"] = (gw.c_matrix, single.c_matrix)
results["caches"] = (gw.rf("unit_rs.npz"),
                     os.path.exists(os.path.join(WORK, "rw", "r2m.npz")))
pe = ProgressiveGenerator(sizes=[16, 16, 8, 8], device="cpu")
pep = params_from_jax(pe, load("pe_params"))
ezds = ZDataset(load("pe_z"))
requests = load("requests")
# the last request lacks its paste: it fails on the rank that holds it
# (rank 1 of 2, rank 2 of 4), and every rank must raise
bad = requests[:2] + [{"object": requests[2]["object"]}]
gwe = ProgressiveGanRewriter(pe, pep, ezds, layernum=3, stats_batch_size=20,
                             mesh=mesh, device="cpu")
alone = ProgressiveGanRewriter(pe, pep, ezds, layernum=3, stats_batch_size=20,
                               device="cpu")
try:
    multi.batch_apply_edits(gwe, bad, niter=15, lr=0.05, mesh=mesh)
    results["bad_batch"] = None
except Exception as e:
    results["bad_batch"] = (type(e).__name__, str(e))
results["edits"] = multi.batch_apply_edits(gwe, requests, niter=15, lr=0.05,
                                           mesh=mesh)
results["edits_single"] = multi.batch_apply_edits(alone, requests, niter=15,
                                                  lr=0.05)
w0 = alone.target_weight()
results["span"] = []
for w, (_, _, d) in zip(results["edits"][0], multi.build_goals(alone,
                                                              requests)):
    delta = w - w0
    outside = delta - projected_conv(delta, d)
    results["span"].append(float(outside.norm() / delta.norm()))

# sample_clean over the mesh
sample_clean(pg, pgp, os.path.join(WORK, "mesh"), n=10, batch_size=8,
             mesh=mesh)
if RANK == 0:
    sample_clean(pg, pgp, os.path.join(WORK, "single"), n=10, batch_size=8)
results["rank_files"] = sorted(os.listdir(os.path.join(WORK, "mesh")))
"""


@pytest.fixture(scope="module")
def inputs():
    jm = JaxSeqStyleGAN2(16, style_dim=64, n_mlp=2)
    jp = with_noise(_numpy(jm.init_params(jax.random.PRNGKey(3))))
    z = np.random.RandomState(4).randn(8, 64).astype(np.float32)
    pm = JaxProgGAN(sizes=[8, 8, 8])
    pp = _numpy(pm.init_params(jax.random.PRNGKey(0)))
    gw = JaxProgRewriter(pm, pp, jax_zds(pm, 32), layernum=2,
                         stats_batch_size=8)
    em = JaxProgGAN(sizes=[16, 16, 8, 8])
    ep = _numpy(em.init_params(jax.random.PRNGKey(3)))
    egw = JaxProgRewriter(em, ep, jax_zds(em, 20), layernum=3,
                          stats_batch_size=20)
    vh, vw = egw.v_shape[1:3]
    requests = [{"object": [i, mask_to_url(blob(vh, vw, 2 + i % 3, 2, 2))],
                 "paste": [i + 4, mask_to_url(blob(vh, vw, 5, 5 - i % 2, 2))]}
                for i in range(3)]
    return {"sg_params": jp, "sg_z": z, "sg": jm,
            "moment_z": np.random.RandomState(0).randn(96, 12).astype(
                np.float32),
            "pg_params": pp, "pg": pm, "pg_z": jax_zds(pm, 32).zs,
            "pe_params": ep, "pe_z": jax_zds(em, 20).zs,
            "requests": requests, "jax_gw": gw, "jax_edit_gw": egw}


@pytest.fixture(scope="module", params=[2, 4], ids=["2ranks", "4ranks"])
def dp_job(request, inputs, tmp_path_factory):
    work = tmp_path_factory.mktemp(f"dp{request.param}")
    names = ("sg_params", "sg_z", "moment_z", "pg_params", "pg_z",
             "pe_params", "pe_z", "requests")
    ranks = run_job(work, request.param, DP_JOB,
                    {k: inputs[k] for k in names})
    return {"world": request.param, "ranks": ranks, "work": work}


def test_dp_sampling_draws_the_noise_of_global_positions(dp_job, inputs):
    """Each rank renders its rows of the global batch with the noise rows
    of their global positions: the gathered images equal one device's and
    the JAX package's sharded sampler; a rank that drew its local prefix
    of the noise (rank 0's rows) would not."""
    for got in dp_job["ranks"]:
        _close(got["dp"], got["dp_single"])
        assert float((got["dp_prefix_noise"] - got["dp_single"]).abs()
                     .max()) > 1e-2
    jm, jp, z = inputs["sg"], inputs["sg_params"], inputs["sg_z"]
    want = jax_sharded_sampler(jm, jax_make_mesh(dp_job["world"]))(
        jp, z, jm.prepare_noise(len(z)))
    _close(dp_job["ranks"][0]["dp"], np.asarray(want), rel=1e-5)


def test_sharded_second_moment_matches(dp_job, inputs):
    zs = inputs["moment_z"]

    def rows(z):
        return z * 2.0 + 1.0
    want = np.asarray(jax_tally.tally_second_moment_scan(
        rows, zs, batch_size=16, mesh=jax_make_mesh(8)).moment())
    for got in dp_job["ranks"]:
        np.testing.assert_allclose(got["moment"].numpy(), want, rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(got["moment"].numpy(),
                                   got["moment_single"].numpy(), rtol=1e-5,
                                   atol=1e-5)
        x = rows(zs[:16])
        np.testing.assert_allclose(got["xtx"].numpy(), x.T @ x, rtol=1e-5,
                                   atol=1e-5)
        assert got["xtx_n"] == 16.0


def test_moment_cache_written_by_rank_0_and_read_by_all(dp_job):
    """Rank 0 alone writes the cache; every rank holds the all-reduced
    moment, and the next call on every rank reads the file back (its
    rows function would raise) to the same bits."""
    ranks = dp_job["ranks"]
    assert all(r["cache_written"] for r in ranks)
    first0, again0 = ranks[0]["cached_moment"]
    assert torch.equal(first0, again0)
    for r in ranks[1:]:
        assert all(torch.equal(m, first0) for m in r["cached_moment"])


def test_rewriter_with_mesh(dp_job, inputs):
    want = np.asarray(inputs["jax_gw"].c_matrix)
    for got in dp_job["ranks"]:
        mesh_c, single_c = got["c_matrix"]
        np.testing.assert_allclose(mesh_c.numpy(), single_c.numpy(),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(mesh_c.numpy(), want, rtol=1e-5,
                                   atol=1e-5)


def test_rewriter_caches_under_a_mesh_are_rank_0s(dp_job):
    """Under a mesh the key moment's cache is shared (rank 0 wrote it), and
    every rank names rank 0's file of each other cache, which rank 0 alone
    writes and the others read (tests/test_torch_rewriter_mesh_caches.py
    counts their tallies)."""
    for got in dp_job["ranks"]:
        path, moment_cached = got["caches"]
        assert moment_cached
        assert path == str(dp_job["work"] / "rw" / "unit_rs.npz")


def test_batch_apply_edits_over_the_mesh(dp_job, inputs):
    """3 edits over 2 ranks (2 + 1) and over 4 (1 + 1 + 1 + none): every
    rank gets every weight and loss in request order, as the unsharded
    batch has them and near the JAX package's mesh batch."""
    for got in dp_job["ranks"]:
        weights, losses = got["edits"]
        want_w, want_l = got["edits_single"]
        assert len(weights) == 3 and losses.shape == (3,)
        np.testing.assert_allclose(losses, want_l, rtol=0, atol=1e-6)
        for w, v in zip(weights, want_w):
            np.testing.assert_allclose(w.numpy(), v.numpy(), rtol=0,
                                       atol=2e-2)
        assert max(got["span"]) <= 1e-4, got["span"]
    jw, jl = jax_multi.batch_apply_edits(
        inputs["jax_edit_gw"], inputs["requests"], niter=15, lr=0.05,
        mesh=jax_make_mesh(3))
    np.testing.assert_allclose(dp_job["ranks"][0]["edits"][1],
                               np.asarray(jl), rtol=1e-2)


def test_batch_apply_edits_failing_on_one_rank_raises_on_all(dp_job):
    """A request that fails on the rank holding it (rank 1 of 2, rank 2 of
    4) raises on every rank: that rank its own KeyError, the others a
    RuntimeError naming it; the next batch then runs (the test above)."""
    world = dp_job["world"]
    bad_rank = 1 if world == 2 else 2
    for rank, got in enumerate(dp_job["ranks"]):
        kind, message = got["bad_batch"]
        if rank == bad_rank:
            assert kind == "KeyError" and "paste" in message
        else:
            assert kind == "RuntimeError"
            assert f"rank {bad_rank} failed: KeyError" in message


def test_sample_clean_on_mesh_writes_the_single_device_files(
        dp_job, inputs, tmp_path):
    """Names, the lightbox and every PNG byte equal the single-device
    run's and the JAX package's on its mesh."""
    work = dp_job["work"]
    names = sorted(os.listdir(work / "single"))
    assert names == sorted(os.listdir(work / "mesh"))
    assert names == sorted([f"{i}.png" for i in range(10)] +
                           ["+lightbox.html"])
    jax_dir = tmp_path / "jax"
    jax_sample_clean(inputs["pg"], inputs["pg_params"], str(jax_dir), n=10,
                     batch_size=8, mesh=jax_make_mesh(4))
    for name in names:
        data = (work / "mesh" / name).read_bytes()
        assert data == (work / "single" / name).read_bytes(), name
        if name.endswith(".png"):
            assert data == (jax_dir / name).read_bytes(), name


# -- the server over a 2-rank job -------------------------------------------------

SERVE_JOB = """
import json, threading, urllib.error, urllib.request
from rewriting_torch import serve
from rewriting_torch.convert import params_from_jax
from rewriting_torch.models import ProgressiveGenerator
from rewriting_torch.parallel import make_mesh
from rewriting_torch.rewrite import ProgressiveGanRewriter, multi
from rewriting_torch.utils.zdataset import ZDataset

mesh = make_mesh(device="cpu")
pg = ProgressiveGenerator(sizes=[16, 16, 8, 8], device="cpu")
pgp = params_from_jax(pg, load("pe_params"))
zds = ZDataset(load("pe_z"))
gw = ProgressiveGanRewriter(pg, pgp, zds, layernum=3, stats_batch_size=20,
                            mesh=mesh, device="cpu")
requests = load("requests")
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

    def post_error(path, body):
        try:
            post(path, body)
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())["error"]
        return None
    try:
        # bad on rank 1 alone (its share lacks a paste), then bad on both
        results["bad"] = [
            post_error("/edit_batch", {"requests": [
                requests[0], {"object": requests[1]["object"]}],
                "niter": 15}),
            post_error("/edit_batch", {"requests": 5, "niter": 15})]
        results["batch"] = post("/edit_batch", {"requests": requests,
                                                "niter": 15})
        results["batch_weights"] = httpd.service._batch_weights
        # an edit served on rank 0 alone, then a batch on the edited weight
        post("/edit", {"request": requests[0], "niter": 11,
                       "method": "fast"})
        results["edited"] = gw.target_weight().clone()
        results["batch2"] = post("/edit_batch", {"requests": requests[1:],
                                                 "niter": 15})
        results["batch2_weights"] = httpd.service._batch_weights
    finally:
        httpd.shutdown()
        httpd.server_close()
        httpd.service.stop_workers()
    alone = ProgressiveGanRewriter(pg, pgp, zds, layernum=3,
                                   stats_batch_size=20, device="cpu")
    results["alone"] = multi.batch_apply_edits(alone, requests, niter=15)
    alone.set_target_weight(results["edited"])
    results["alone2"] = multi.batch_apply_edits(alone, requests[1:],
                                                niter=15)
"""


@pytest.fixture(scope="module")
def serve_job(inputs, tmp_path_factory):
    names = ("pe_params", "pe_z", "requests")
    return run_job(tmp_path_factory.mktemp("serve"), 2, SERVE_JOB,
                   {k: inputs[k] for k in names})


def test_served_edit_batch_over_two_ranks(serve_job):
    """Rank 0 serves HTTP, rank 1 works the collective requests: a served
    ``/edit_batch`` equals the batch solved on one device, and after an
    ``/edit`` that changed the weight on rank 0 alone, the next batch
    starts from the edited weight on both ranks."""
    got = serve_job[0]
    for served, weights, (want_w, want_l) in (
            (got["batch"], got["batch_weights"], got["alone"]),
            (got["batch2"], got["batch2_weights"], got["alone2"])):
        assert served["ok"] and served["n"] == len(want_w)
        np.testing.assert_allclose(served["final_losses"], want_l, rtol=0,
                                   atol=1e-6)
        for w, v in zip(weights, want_w):
            np.testing.assert_allclose(w.numpy(), v.numpy(), rtol=0,
                                       atol=2e-2)


def test_served_edit_batch_failing_on_a_worker_is_a_500(serve_job):
    """A batch whose bad request lies in rank 1's share, and one bad on
    both ranks, are each answered with a 500 naming the fault; both ranks
    then serve the good batches of the test above."""
    (code1, error1), (code2, error2) = serve_job[0]["bad"]
    assert code1 == 500 and "rank 1 failed: KeyError" in error1
    assert code2 == 500 and "int" in error2
    assert serve_job[0]["batch"]["ok"]


def test_dry_run_in_four_ranks():
    """``python -m rewriting_torch.parallel.dryrun --ranks 4 --device
    cpu``: the six steps, one line of the JAX dry run's form."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    proc = subprocess.run(
        [sys.executable, "-m", "rewriting_torch.parallel.dryrun", "--ranks",
         "4", "--device", "cpu"], cwd=REPO, capture_output=True, text=True,
        timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == (
        "dryrun_multichip(4): sampling (8, 16, 16, 3), sharded stats "
        "C(16, 16), 4 mesh-sharded edits + previews, 2x2 dp x sp sampling "
        "OK, tp sampling over 4-way model axis OK, 4-stage GPipe style MLP "
        "OK")
