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
- K1's gate on at every layer (``set_fused_upconv("on", min_res=0)``),
  with and without its epilogue, and under a "default" schedule from 16
  px (its one-pass mode): K1 (its plain version on the CPU) runs on each
  band's slab of input rows, one more on each side, whose output rows
  its zero padding reaches are dropped.  On 2 x 2, 1 x 4 and 1 x 8 the
  blocks equal the single-device ``pipeline_fast`` under the same gate
  bit for bit (the band's transposed convolution and blur sum each
  output as the whole map's do), and the JAX package's spatial sampler
  (its gate off: K1 computes the seq stages' function) within 1e-5 of
  the largest value; each rank's K1 calls are the slabs' (recorded);
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
from rewriting_torch.models.stylegan2 import mixed_precision_schedule
from rewriting_torch.ops import precision
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
# K1's gate on at every layer: its plain version, recorded, on the slabs
calls = []
plain = kup.upconv_blur_reference


def recorded(x, wf, kf, demod=None, noise=None, bias=None, tier="highest"):
    calls.append((tuple(x.shape), demod is not None, tier))
    return plain(x, wf, kf, demod, noise, bias, tier)


kup.upconv_blur_reference = recorded
kup.set_fused_upconv("on", min_res=0)
try:
    for run, epilogue, schedule in (("k1", True, None),
                                    ("k1_bare", False, None),
                                    ("k1_default", True, 16)):
        kup.set_fused_epilogue(epilogue)
        precision.set_precision_schedule(
            None if schedule is None else mixed_precision_schedule(schedule))
        calls.clear()
        results[f"{run}_single"] = (model(params, z), list(calls))
        for n_data in load("n_data"):
            calls.clear()
            mesh = make_mesh_2d(n_data, WORLD // n_data, device="cpu")
            block = spatial_sharded_sampler(model, mesh)(params, z)
            rows = comm.all_gather(block, mesh.group("spatial"), dim=1)
            results[f"{run}_{n_data}x{WORLD // n_data}"] = (
                comm.all_gather(rows, mesh.group("data")), list(calls))
finally:
    kup.set_fused_upconv("off", min_res=256)
    kup.set_fused_epilogue(True)
    kup.upconv_blur_reference = plain
    precision.set_precision_schedule(None)
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


@pytest.fixture(scope="module")
def jax_2x2(four):
    jm, jp, z = four["jm"], four["jp"], four["z"]
    mesh = jax_make_mesh_2d(2, 4)
    zs = jax.device_put(z, NamedSharding(mesh, P("data")))
    return np.asarray(jax_spatial_sampler(jm, mesh)(
        jp, zs, jm.prepare_noise(len(z))))


def test_spatial_sampler_matches_the_jax_package(four, jax_2x2):
    _close(four["ranks"][0]["2x2"][1].numpy(), jax_2x2)


def _slab_rows(res: int, n: int, index: int) -> int:
    """Input rows of K1's slab for band `index` of `n` of a `res`-row
    output: [(a-2)//2, (b+1)//2]; the whole map where res/n < 1."""
    if res % n or res // n < 1:
        return res // 2
    a, b = index * res // n, (index + 1) * res // n
    return (b + 1) // 2 - (a - 2) // 2 + 1


def _hold_k1_bands(job, sizes, layouts):
    """Every rank's K1 calls are its slabs' at each up-conv, with the
    run's epilogue and tier; its gathered images equal one device's under
    the same gate bit for bit."""
    world = job["world"]
    for run, epilogue, tier in (("k1", True, "highest"),
                                ("k1_bare", False, "highest"),
                                ("k1_default", True, None)):
        for rank, got in enumerate(job["ranks"]):
            single, single_calls = got[f"{run}_single"]
            assert [c[0][2] for c in single_calls] == [r // 2 for r in sizes]
            for layout in layouts:
                images, calls = got[f"{run}_{layout}"]
                assert torch.equal(images, single), (run, layout)
                n_data = int(layout.split("x")[0])
                n_sp = world // n_data
                index = rank % n_sp
                assert [c[0][2] for c in calls] == [
                    _slab_rows(r, n_sp, index) for r in sizes], (run, layout)
                for (shape, epi, t), res in zip(calls, sizes):
                    assert shape[0] == 4 // n_data and epi == epilogue
                    # "default" from 16 px: the one-pass mode at 16 and 32
                    want = tier or ("default" if res >= 16 else "highest")
                    assert t == want, (run, res, t)


def test_k1_on_bands_matches_single_device(four, jax_2x2):
    """2 x 2 and 1 x 4 on 32 px: K1 at the 8, 16 and 32 px up-convs, on
    the slabs of the bands; the JAX spatial sampler (gate off) within
    1e-5 of max."""
    _hold_k1_bands(four, (8, 16, 32), ("2x2", "1x4"))
    for run in ("k1", "k1_bare"):
        _close(four["ranks"][0][f"{run}_2x2"][0].numpy(), jax_2x2)


def test_k1_on_bands_shorter_than_its_halo(eight):
    """1 x 8 on 16 px: the 8 px up-conv's one-row bands take their slabs
    from the replicated 4x4 map, the 16 px one's two-row bands theirs
    from one-row bands and their halo."""
    _hold_k1_bands(eight, (8, 16), ("1x8",))
    _close(eight["ranks"][0]["k1_1x8"][0].numpy(), eight["want"])


def test_band_shorter_than_its_halo_runs_replicated(eight):
    """1 x 8 on 16 px: the 4x4 stages run replicated (half a row a rank),
    8x8 in one-row bands, 16x16 in two-row bands."""
    for got in eight["ranks"]:
        shape, images = got["1x8"]
        assert shape == (4, 2, 16, 3)
        assert torch.equal(images, got["single"])
        _close(images.numpy(), eight["want"])


def test_pipelined_style_mapper_on_eight_stages(eight):
    for got in eight["ranks"]:
        assert torch.equal(got["mapper8"], got["seq_micro"])
