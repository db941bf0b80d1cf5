"""``pipeline_fast``'s s2d tail on the sharded samplers, in a 4-rank gloo
job on the CPU, against the single-device port and the JAX package's
samplers on the 8 virtual CPU devices (spec: tests/test_parallel_tp_pp.py
``test_tp_composes_with_fast_tail``).

A 32-px StyleGAN2 at 512 channels whose tail engages at 16 px
(``s2d_tail_min_res`` 16, ``s2d_tail_max_c`` 512 in both packages): the
16 and 32 px layers run blur-folded in the space-to-depth layout, the
second up-conv reading the first's s2d map.  Noise strengths are nonzero.
Held:
- the spatial bands (1 x 4, 2 x 2) and tensor parallelism (4-way) with
  ``fast=True`` run the tail's seq stages on their shares (the tail's
  2.2x layer-compute win is the TPU's; on an H100 the tail gains nothing,
  PERF.md §7): within 1e-5 of the largest value
  (tests/test_torch_parallel_spatial.py's bound) of the single-device
  ``pipeline_fast``, which runs the tail, and of the JAX package's
  spatial and ``tensor_sharded_sampler(fast=True)``, which run it too;
- both under an int8 schedule from 8 px: the tail's convs have no int8
  core, so the int8 stages of the tail compute at "default" on one
  device, on the bands and under tp alike; the ranks quantize exactly the
  maps one device does (the records' stages).  The seq stages run in
  bf16 where one device runs the s2d convs in bf16, which round otherwise
  (68.4 dB apart under tp here), held at
  tests/test_torch_parallel_int8.py's 40 dB.
"""

import jax
import numpy as np
import pytest
import torch

from rewriting_tpu.models import SeqStyleGAN2 as JaxSeqStyleGAN2
from rewriting_tpu.parallel import make_mesh as jax_make_mesh
from rewriting_tpu.parallel import make_mesh_2d as jax_make_mesh_2d
from rewriting_tpu.parallel import \
    spatial_sharded_sampler as jax_spatial_sampler
from rewriting_tpu.parallel.tensor import \
    tensor_shard_params as jax_tensor_shard_params
from rewriting_tpu.parallel.tensor import \
    tensor_sharded_sampler as jax_tensor_sampler
from test_torch_parallel import _close, run_job, with_noise
from test_torch_parallel_int8 import FLIPPED_PSNR, _psnr

torch.set_num_threads(1)

TAIL = {"s2d_tail_min_res": 16}

JOB = """
from rewriting_torch.convert import params_from_jax
from rewriting_torch.models import stylegan2 as sg
from rewriting_torch.ops import precision, quant
from rewriting_torch.parallel import (make_mesh, make_mesh_2d,
                                      spatial_sharded_sampler,
                                      tensor_shard_params,
                                      tensor_sharded_sampler)

TailGAN = type("TailGAN", (sg.SeqStyleGAN2,), load("tail"))
model = TailGAN(32, style_dim=32, n_mlp=2, s2d_tail_max_c=512, device="cpu")
results["tail"] = sorted(model._s2d_names)
params = params_from_jax(model, load("params"))
z = load("z")
stages = []
plain = quant.quantize_activation


def recorded(x):
    stages.append(precision._CURRENT_STAGE.get())
    return plain(x)


quant.quantize_activation = recorded
mt = make_mesh(axis="model", device="cpu")
local = tensor_shard_params(model, params, mt, axis="model")
for tier in (None, "int8"):
    precision.set_precision_schedule(
        None if tier is None else sg.mixed_precision_schedule(8, tier=tier))
    stages.clear()
    out = {"single": model(params, z), "single_stages": list(stages)}
    for n_data in (1, 2):
        m2 = make_mesh_2d(n_data, 4 // n_data, device="cpu")
        stages.clear()
        block = spatial_sharded_sampler(model, m2)(params, z)
        rows = comm.all_gather(block, m2.group("spatial"), dim=1)
        out[f"sp_{n_data}x{4 // n_data}"] = (
            comm.all_gather(rows, m2.group("data")), list(stages))
    stages.clear()
    out["tp"] = (tensor_sharded_sampler(model, mt, fast=True)(local, z),
                 list(stages))
    results[tier or "highest"] = out
precision.set_precision_schedule(None)
"""


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    tail_gan = type("TailGAN", (JaxSeqStyleGAN2,), TAIL)
    jm = tail_gan(size=32, style_dim=32, n_mlp=2, s2d_tail_max_c=512)
    jp = with_noise(_numpy(jm.init_params(jax.random.PRNGKey(7))))
    z = np.random.RandomState(8).randn(4, 32).astype(np.float32)
    noise = jm.prepare_noise(len(z))
    mesh = jax_make_mesh(4, axis="model")
    want = {
        "single": np.asarray(jm(jp, z, noise)),
        "sp": np.asarray(jax_spatial_sampler(jm, jax_make_mesh_2d(2, 2))(
            jp, z, noise)),
        "tp": np.asarray(jax_tensor_sampler(jm, mesh, fast=True)(
            jax_tensor_shard_params(jm, jp, mesh), z, noise))}
    ranks = run_job(tmp_path_factory.mktemp("tail"), 4, JOB, {
        "tail": TAIL, "params": jp, "z": z})
    return {"ranks": ranks, "want": want}


def test_the_tail_engages(job):
    """The 16 and 32 px layers and their to_rgb run the s2d stages."""
    names = job["ranks"][0]["tail"]
    for prefix in ("layer5.sconv", "layer6.sconv", "layer7.sconv",
                   "layer8.sconv", "to_rgb3.rgb", "to_rgb4.rgb"):
        assert any(n.startswith(prefix) for n in names), prefix


@pytest.mark.parametrize("layout", ["sp_1x4", "sp_2x2"])
def test_s2d_tail_on_bands(job, layout):
    """The bands run the tail's seq stages, one device and the JAX spatial
    sampler the tail's s2d convs; the renders agree."""
    for got in job["ranks"]:
        images, _ = got["highest"][layout]
        _close(images.numpy(), got["highest"]["single"].numpy())
        _close(images.numpy(), job["want"]["sp"])


def test_tp_fast_with_the_tail_matches_the_jax_package(job):
    """The closed gap G2: the port's tp runs the tail's seq stages, the
    JAX package shards the tail's convs; the renders agree."""
    for got in job["ranks"]:
        images, _ = got["highest"]["tp"]
        _close(images.numpy(), job["want"]["tp"])
        _close(images.numpy(), got["highest"]["single"].numpy())
    _close(job["want"]["tp"], job["want"]["single"])


@pytest.mark.parametrize("case", ["sp_1x4", "sp_2x2", "tp"])
def test_the_tails_int8_stages_compute_at_default(job, case):
    """Under int8 from 8 px the 8 px layers quantize and the tail's (16 and
    32 px) do not: the ranks make one device's quantizations, stage for
    stage."""
    for got in job["ranks"]:
        out = got["int8"]
        images, stages = out[case]
        assert stages == out["single_stages"]
        assert stages and all(s.startswith(("layer3", "layer4"))
                              for s in stages), stages
        single = out["single"].numpy()
        psnr = _psnr(images.numpy(), single)
        print(f"{case}: {psnr:.1f} dB from one device")
        assert psnr >= FLIPPED_PSNR
