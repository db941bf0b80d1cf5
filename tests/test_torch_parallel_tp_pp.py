"""Tensor parallelism (``rewriting_torch/parallel/tensor.py``) and the GPipe
executor (``parallel/pipeline.py``) in a 4-rank gloo job on the CPU,
against the JAX package's on the 8 virtual CPU devices (spec:
tests/test_parallel_tp_pp.py) and the single-device port.

Held:
- gpipe (S = 4 tanh-affine stages; 4, 8 and 16 microbatches) equals the
  stages applied in order: 1e-6 abs (the JAX test's), and the JAX gpipe;
- the pipelined style mapper (4 stages, and 2 on a 2 x 2 data x stage
  mesh) bit for bit the seq ``style.*`` stages run on the same
  microbatches (a float32 product on the CPU rounds by its batch size, so
  against the whole batch it is 1e-6 abs, the JAX test's bound), and the
  JAX mapper within 1e-6 of the largest value (its matmuls round
  otherwise);
- the tp specs equal the JAX package's leaf for leaf, and every rank holds
  exactly its 1/4 slice of each split weight;
- the tp sampler (fast and seq) against the replicated forward: 2e-5 abs
  (the JAX test's), against both packages; with dp on a 2 x 2 data x model
  mesh too;
- K1's gate on: the row-parallel up-convs run K1's plain version WITHOUT
  its epilogue, on a quarter of the input channels, and the epilogue after
  the all-reduce gives the single-device K1 render (epilogue in the
  kernel) within 2e-5 abs.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from rewriting_tpu.models import SeqStyleGAN2 as JaxSeqStyleGAN2
from rewriting_tpu.parallel.pipeline import gpipe as jax_gpipe
from rewriting_tpu.parallel.pipeline import \
    pipelined_style_mapper as jax_mapper
from rewriting_tpu.parallel.tensor import tp_param_sharding as jax_tp_specs
from test_torch_parallel import run_job, with_noise

torch.set_num_threads(1)

JOB = """
from rewriting_torch.convert import params_from_jax
from rewriting_torch.core import leaves
from rewriting_torch.models import SeqStyleGAN2
from rewriting_torch.ops import upconv_blur as kup
from rewriting_torch.parallel import (gpipe, make_mesh, make_mesh_2d,
                                      pipelined_style_mapper,
                                      tensor_shard_params,
                                      tensor_sharded_sampler,
                                      tp_param_sharding)

# gpipe over 4 stages
mesh = make_mesh(axis="stage", device="cpu")
g = load("gpipe")
stack = {"w": torch.tensor(g["ws"]), "b": torch.tensor(g["bs"])}


def stage_fn(p, h):
    return torch.tanh(h @ p["w"] + p["b"])


x = torch.tensor(g["x"])
results["gpipe"] = {m: gpipe(stage_fn, stack, x, mesh, axis="stage",
                             n_micro=m) for m in (None, 8, 16)}

# the style mapper on 4 and on 2 stages, and the seq stages on the same
# microbatches
sm = SeqStyleGAN2(16, style_dim=16, n_mlp=8, device="cpu")
smp = params_from_jax(sm, load("style_params"))
zs = torch.tensor(load("style_z"))
seq = sm.pipeline.subsequence(upto_layer="latents")
results["mapper4"] = pipelined_style_mapper(sm, mesh)(smp, zs)
mesh22 = make_mesh_2d(2, 2, axes=("data", "stage"), device="cpu")
results["mapper2"] = pipelined_style_mapper(sm, mesh22)(smp, zs)
with torch.no_grad():
    results["seq_micro"] = {
        m: torch.cat([seq(smp, sm.make_bag(zs[i:i + len(zs) // m]))["latent"]
                      for i in range(0, len(zs), len(zs) // m)])
        for m in (2, 4)}
    results["seq_whole"] = seq(smp, sm.make_bag(zs))["latent"]

# tensor parallelism over 4 ranks, and over a 2 x 2 data x model mesh
tm = SeqStyleGAN2(16, style_dim=16, n_mlp=2, device="cpu")
tpp = params_from_jax(tm, load("tp_params"))
mt = make_mesh(axis="model", device="cpu")
results["specs"] = tp_param_sharding(tm, tpp, mt, axis="model")
local = tensor_shard_params(tm, tpp, mt, axis="model")
results["local"] = dict(leaves(local))
z = load("tp_z")
results["tp_fast"] = tensor_sharded_sampler(tm, mt)(local, z)
results["tp_seq"] = tensor_sharded_sampler(tm, mt, fast=False)(local, z)
results["single"] = tm(tpp, z, fast=False)
m22 = make_mesh_2d(2, 2, axes=("data", "model"), device="cpu")
local22 = tensor_shard_params(tm, tpp, m22, axis="model")
z4 = load("tp_z4")
results["tp_dp"] = comm.all_gather(tensor_sharded_sampler(
    tm, m22, axis_model="model", axis_data="data")(local22, z4),
    m22.group("data"))
results["single4"] = tm(tpp, z4, fast=False)

# K1's gate on: the row layers' K1 runs without its epilogue
calls = []
plain = kup.upconv_blur_reference


def recorded(x, wf, kf, demod=None, noise=None, bias=None, tier="highest"):
    calls.append((x.shape[1], demod is not None))
    return plain(x, wf, kf, demod, noise, bias, tier)


kup.upconv_blur_reference = recorded
kup.set_fused_upconv("on", min_res=0)
try:
    results["k1_single"] = tm(tpp, z)
    results["k1_single_calls"] = list(calls)
    calls.clear()
    results["k1_tp"] = tensor_sharded_sampler(tm, mt)(local, z)
    results["k1_tp_calls"] = list(calls)
finally:
    kup.set_fused_upconv("off", min_res=256)
    kup.upconv_blur_reference = plain
"""


def _jax_mesh(n, axes, shape=None):
    devs = np.array(jax.devices()[:n])
    return JaxMesh(devs.reshape(shape or (n,)), axes)


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    rng = np.random.RandomState(0)
    gp = {"ws": (rng.randn(4, 6, 6) / np.sqrt(6)).astype(np.float32),
          "bs": rng.randn(4, 6).astype(np.float32),
          "x": rng.randn(16, 6).astype(np.float32)}
    sm = JaxSeqStyleGAN2(size=16, style_dim=16, n_mlp=8)
    smp = _numpy(sm.init_params(jax.random.PRNGKey(2)))
    tm = JaxSeqStyleGAN2(size=16, style_dim=16, n_mlp=2)
    tpp = with_noise(_numpy(tm.init_params(jax.random.PRNGKey(5))))
    inputs = {"gpipe": gp, "style_params": smp,
              "style_z": rng.randn(8, 16).astype(np.float32),
              "tp_params": tpp, "tp_z": rng.randn(3, 16).astype(np.float32),
              "tp_z4": rng.randn(4, 16).astype(np.float32)}
    ranks = run_job(tmp_path_factory.mktemp("tp_pp"), 4, JOB, inputs)
    return {"ranks": ranks, "inputs": inputs, "sm": sm, "tm": tm}


@pytest.mark.parametrize("n_micro", [None, 8, 16])
def test_gpipe_matches_sequential(job, n_micro):
    g = job["inputs"]["gpipe"]
    ref = g["x"]
    for s in range(4):
        ref = np.tanh(ref @ g["ws"][s] + g["bs"][s])

    def stage_fn(p, h):
        return jax.numpy.tanh(h @ p["w"] + p["b"])
    want = jax_gpipe(stage_fn, {"w": g["ws"], "b": g["bs"]}, g["x"],
                     _jax_mesh(4, ("stage",)), axis="stage",
                     n_micro=n_micro)
    for got in job["ranks"]:
        out = got["gpipe"][n_micro].numpy()
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)
        np.testing.assert_allclose(out, np.asarray(want), rtol=0, atol=1e-6)


@pytest.mark.parametrize("stages", [4, 2])
def test_pipelined_style_mapper_matches_seq(job, stages):
    """Bit for bit the seq stages on the same microbatches (S of them),
    1e-6 of the whole batch's and of the JAX mapper's."""
    inputs = job["inputs"]
    mesh = (_jax_mesh(4, ("stage",)) if stages == 4
            else _jax_mesh(2, ("stage",)))
    want = np.asarray(jax_mapper(job["sm"], mesh, axis="stage")(
        inputs["style_params"], inputs["style_z"]))
    for got in job["ranks"]:
        w = got[f"mapper{stages}"]
        assert torch.equal(w, got["seq_micro"][stages])
        np.testing.assert_allclose(w.numpy(), got["seq_whole"].numpy(),
                                   rtol=0, atol=1e-6)
        scale = float(np.abs(want).max())
        err = float(np.abs(w.numpy() - want).max())
        assert err <= 1e-6 * scale, (err, scale)


def test_tp_sharding_splits_the_big_weights(job):
    """The specs are the JAX package's leaf for leaf (layer2 column: O
    split; layer3 row: I split), and each rank holds its 1/4 slice of
    every split leaf."""
    tm, tpp = job["tm"], job["inputs"]["tp_params"]
    jspecs = jax_tp_specs(tm, tpp, _jax_mesh(4, ("model",)), axis="model")
    flat = jax.tree_util.tree_leaves_with_path(
        jspecs, is_leaf=lambda x: hasattr(x, "spec"))
    assert flat
    for r, got in enumerate(job["ranks"]):
        specs = got["specs"]
        assert specs["layer2.conv.mconv.dconv"]["weight"] == (
            None, "model", None, None, None)
        assert specs["layer3.sconv.mconv.dconv"]["weight"] == (
            None, None, "model", None, None)
        for path, sharding in flat:
            keys = [p.key for p in path]
            spec = specs
            for k in keys:
                spec = spec[k]
            assert spec == tuple(sharding.spec), (keys, spec, sharding.spec)
            full = tpp
            for k in keys:
                full = full[k]
            local = got["local"][".".join(keys)].numpy()
            if keys[0] in ("input", "noises"):      # NCHW in the port
                continue
            if spec:
                dim = spec.index("model")
                size = full.shape[dim] // 4
                want = np.take(full, range(r * size, (r + 1) * size),
                               axis=dim)
            else:
                want = full
            np.testing.assert_array_equal(local, want)
        n_split = sum(1 for name, s in specs.items()
                      if name.endswith(".mconv.dconv") and s["weight"])
        assert n_split == 5


def test_tp_sampler_matches_replicated(job):
    tm = job["tm"]
    inputs = job["inputs"]
    z = inputs["tp_z"]
    want = np.asarray(tm(inputs["tp_params"], z, tm.prepare_noise(len(z)),
                         fast=False))
    for got in job["ranks"]:
        np.testing.assert_allclose(got["single"].numpy(), want, rtol=0,
                                   atol=2e-5)
        for key in ("tp_fast", "tp_seq"):
            np.testing.assert_allclose(got[key].numpy(), want, rtol=0,
                                       atol=2e-5)
            np.testing.assert_allclose(got[key].numpy(),
                                       got["single"].numpy(), rtol=0,
                                       atol=2e-5)


def test_tp_composes_with_dp(job):
    tm = job["tm"]
    inputs = job["inputs"]
    z4 = inputs["tp_z4"]
    want = np.asarray(tm(inputs["tp_params"], z4, tm.prepare_noise(4),
                         fast=False))
    for got in job["ranks"]:
        assert tuple(got["tp_dp"].shape) == (4, 16, 16, 3)
        np.testing.assert_allclose(got["tp_dp"].numpy(), want, rtol=0,
                                   atol=2e-5)
        np.testing.assert_allclose(got["tp_dp"].numpy(),
                                   got["single4"].numpy(), rtol=0,
                                   atol=2e-5)


def test_tp_row_layers_run_k1_without_its_epilogue(job):
    """Single device: K1 with its epilogue on the whole 512 input
    channels, at both up-convs.  Under 4-way tp: K1 on each rank's 128
    channels, never with the epilogue (partial sums); noise, bias and
    activation after the all-reduce give the same render."""
    for got in job["ranks"]:
        assert got["k1_single_calls"] == [(512, True), (512, True)]
        assert got["k1_tp_calls"] == [(128, False), (128, False)]
        np.testing.assert_allclose(got["k1_tp"].numpy(),
                                   got["k1_single"].numpy(), rtol=0,
                                   atol=2e-5)
        np.testing.assert_allclose(got["k1_single"].numpy(),
                                   got["single"].numpy(), rtol=0, atol=2e-5)
