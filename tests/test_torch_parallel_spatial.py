"""dp x sp sampling (``rewriting_torch/parallel/mesh.py::
spatial_sharded_sampler``) in gloo jobs of 4 and 8 ranks on the CPU,
against the single-device port and the JAX package's spatial sampler on
the 8 virtual CPU devices (spec: tests/test_sharded_stats.py).

Each rank of the spatial axis holds a band of image rows; the bands take
one halo row from each neighbour before each 3x3 conv, up-conv and RGB
upsample.  Held, with nonzero noise strengths (each band must read its own
rows of the noise):
- 2 x 2 and 1 x 4 meshes on a 32-px model: each rank's block is (B/dp,
  H/sp, W, 3), and the assembled images equal the single-device port's
  bit for bit on the CPU (the band convolutions sum each output in the
  same order), and the JAX package's within 1e-5 of the largest value
  (the JAX test's 1e-5 abs, made relative across the packages: the port's
  single-device forward is 1.1e-5 abs from the JAX one at 8 of 12288
  values here);
- 1 x 8 on a 16-px model: at 4x4 a band would be shorter than its halo,
  so that stage runs replicated and the 8x8 stage slices its one-row
  bands from the whole map; equal to one device's too;
- with K1's gate on the spatial sampler raises, naming the gate;
- the 8-stage GPipe style MLP of the same job (the JAX test's 8-stage
  ring), bit for bit the seq stages on the same microbatches.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from rewriting_tpu.models import SeqStyleGAN2 as JaxSeqStyleGAN2
from rewriting_tpu.parallel import make_mesh_2d as jax_make_mesh_2d
from rewriting_tpu.parallel import \
    spatial_sharded_sampler as jax_spatial_sampler
from test_torch_parallel import _close, run_job, with_noise

torch.set_num_threads(1)

JOB = """
from rewriting_torch.convert import params_from_jax
from rewriting_torch.models import SeqStyleGAN2
from rewriting_torch.ops import upconv_blur as kup
from rewriting_torch.parallel import (make_mesh, make_mesh_2d,
                                      pipelined_style_mapper,
                                      spatial_sharded_sampler)

size = load("size")
model = SeqStyleGAN2(size, style_dim=32, n_mlp=2, device="cpu")
params = params_from_jax(model, load("params"))
z = load("z")
results["single"] = model(params, z)
for n_data in load("n_data"):
    mesh = make_mesh_2d(n_data, WORLD // n_data, device="cpu")
    block = spatial_sharded_sampler(model, mesh)(params, z)
    rows = comm.all_gather(block, mesh.group("spatial"), dim=1)
    results[f"{n_data}x{WORLD // n_data}"] = (
        tuple(block.shape), comm.all_gather(rows, mesh.group("data")))
kup.set_fused_upconv("on", min_res=0)
try:
    spatial_sharded_sampler(model, mesh)(params, z)
except RuntimeError as e:
    results["k1_gate"] = str(e)
finally:
    kup.set_fused_upconv("off", min_res=256)
if WORLD == 8:
    sm = SeqStyleGAN2(16, style_dim=16, n_mlp=8, device="cpu")
    smp = params_from_jax(sm, load("style_params"))
    zs = torch.tensor(load("style_z"))
    results["mapper8"] = pipelined_style_mapper(
        sm, make_mesh(axis="stage", device="cpu"))(smp, zs)
    seq = sm.pipeline.subsequence(upto_layer="latents")
    with torch.no_grad():
        results["seq_micro"] = torch.cat([
            seq(smp, sm.make_bag(zs[i:i + 2]))["latent"]
            for i in range(0, len(zs), 2)])
"""


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _job(tmp_path_factory, world, size, n_data):
    jm = JaxSeqStyleGAN2(size=size, style_dim=32, n_mlp=2)
    jp = with_noise(_numpy(jm.init_params(jax.random.PRNGKey(0))))
    z = np.random.RandomState(1).randn(4, 32).astype(np.float32)
    inputs = {"size": size, "params": jp, "z": z, "n_data": n_data}
    if world == 8:
        sm = JaxSeqStyleGAN2(size=16, style_dim=16, n_mlp=8)
        inputs["style_params"] = _numpy(sm.init_params(
            jax.random.PRNGKey(2)))
        inputs["style_z"] = np.random.RandomState(3).randn(16, 16).astype(
            np.float32)
    ranks = run_job(tmp_path_factory.mktemp(f"sp{world}"), world, JOB,
                    inputs)
    want = np.asarray(jm(jp, z, jm.prepare_noise(len(z))))
    return {"ranks": ranks, "jm": jm, "jp": jp, "z": z, "want": want,
            "world": world}


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    return _job(tmp_path_factory, 4, 32, (2, 1))


@pytest.fixture(scope="module")
def eight(tmp_path_factory):
    return _job(tmp_path_factory, 8, 16, (1,))


@pytest.mark.parametrize("layout,block", [("2x2", (2, 16, 32, 3)),
                                          ("1x4", (4, 8, 32, 3))])
def test_spatial_sampler_matches_single_device(four, layout, block):
    for got in four["ranks"]:
        shape, images = got[layout]
        assert shape == block
        assert torch.equal(images, got["single"])
        _close(images.numpy(), four["want"])


def test_spatial_sampler_matches_the_jax_package(four):
    jm, jp, z = four["jm"], four["jp"], four["z"]
    mesh = jax_make_mesh_2d(2, 4)
    zs = jax.device_put(z, NamedSharding(mesh, P("data")))
    got = np.asarray(jax_spatial_sampler(jm, mesh)(
        jp, zs, jm.prepare_noise(len(z))))
    _close(four["ranks"][0]["2x2"][1].numpy(), got)


def test_band_shorter_than_its_halo_runs_replicated(eight):
    """1 x 8 on 16 px: the 4x4 stages run replicated (half a row a rank),
    8x8 in one-row bands, 16x16 in two-row bands."""
    for got in eight["ranks"]:
        shape, images = got["1x8"]
        assert shape == (4, 2, 16, 3)
        assert torch.equal(images, got["single"])
        _close(images.numpy(), eight["want"])


def test_spatial_sampler_refuses_k1(four):
    for got in four["ranks"]:
        assert "set_fused_upconv" in got["k1_gate"]


def test_pipelined_style_mapper_on_eight_stages(eight):
    for got in eight["ranks"]:
        assert torch.equal(got["mapper8"], got["seq_micro"])
