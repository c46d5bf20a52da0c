"""facedet_tpu_torch/tools/profile_stages.py against
facedet_tpu/tools/profile_stages.py on the CPU: each stage's scalar (the
float32 sum of every tensor the prefix returns, padding rows and the
``classes`` / ``valid`` fields too, as JAX's ``tree_sum`` takes it) from the
port's ``build_stage_fn`` against JAX's, jitted, on the same ``dct420s`` wire
of two photo-like 240x256 images with faces; golden yolo11n in float32 at
slice 160 (4 tiles, one 256 bucket), the JAX model with ``s2d_early=False``
so both run the standard stack.

Tolerance: 1e-5 relative. The prefixes are the same functions in float32;
their sums add up to 4e7 (the IDCT planes) over other orders of summation.
A port-only check: the ``full`` row equals the sum of ``batch_core``'s own
output on the same wire exactly, so the tool cannot drift from the engine.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facedet_tpu.engine import predict as JP
from facedet_tpu.engine.detector import YoloV11PoseDetectionModel as JaxModel
from facedet_tpu.ops.jpeg_dct import encode_dct420 as jax_encode_dct420
from facedet_tpu.tools import profile_stages as jps
from facedet_tpu_torch.engine.detector import YoloV11PoseDetectionModel
from facedet_tpu_torch.engine.predict import batch_core
from facedet_tpu_torch.ops.jpeg_dct import encode_dct420
from facedet_tpu_torch.tools import profile_stages as tps
from facedet_tpu_torch.utils.synth import synthetic_faces

torch.set_num_threads(1)

CKPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "facedet_tpu", "eval", "assets", "yolo11n_golden.npz")
HW, N, SLICE = (240, 256), 2, 160
SLICED = dict(tps.SERVING, slice_height=SLICE, slice_width=SLICE)


@pytest.fixture(scope="module")
def setup():
    kw = dict(model_path=CKPT, scale="n", dtype="float32", confidence_threshold=0.15, image_size=SLICE)
    jax_model = JaxModel(s2d_early=False, **kw)
    port = YoloV11PoseDetectionModel(device="cpu", **kw)
    images = [synthetic_faces(*HW, seed=s, n=5, size=(30, 60)) for s in (1, 3)]
    plan, wire, consts = tps.stage_inputs(port, [encode_dct420(im, quality=90) for im in images], **SLICED)
    jplanes = [jax_encode_dct420(im, quality=90) for im in images]
    key = JP.pipeline_key(jax_model, plan["bucket_h"], plan["bucket_w"], SLICE, SLICE, True, "GREEDYNMM", "IOS",
                          0.5, True, 1024, False, "dct420s")
    jwire = JP._stage_batch_host(jplanes, "dct420s", plan["bucket_h"], plan["bucket_w"])
    np.testing.assert_array_equal(np.asarray(jwire), wire.numpy().view(np.asarray(jwire).dtype))
    jargs = (JP._resident_variables(jax_model), jnp.asarray(jwire), jnp.asarray(plan["offsets"]),
             jnp.asarray(plan["tile_valid"]), jnp.tile(jnp.asarray([HW], jnp.float32), (N, 1)))
    return port, plan, wire, consts, jax_model, key, jargs


@pytest.mark.parametrize("stage", ["idct", "tiles", "tile_nms", "full"])
def test_stage_scalar_matches_jax(setup, stage):
    port, plan, wire, consts, jax_model, key, jargs = setup
    with torch.inference_mode():
        got = float(tps.build_stage_fn(port, plan, stage, N)(wire, consts))
    want = float(jax.jit(jps.build_stage_fn(jax_model, key, stage, N))(*jargs))
    assert got == pytest.approx(want, rel=1e-5)


def test_full_row_is_batch_core_summed(setup):
    port, plan, wire, consts, *_ = setup
    with torch.inference_mode():
        got = tps.build_stage_fn(port, plan, "full", N)(wire, consts)
        want = tps.tree_sum(batch_core(port, plan, wire, consts))
    assert float(got) == float(want)
    assert int(batch_core(port, plan, wire, consts).valid.sum()) > 0


def test_every_stage_runs_and_cuts_the_pipeline(setup):
    """Every row runs; the stages before the detector do not depend on the
    weights, the later ones do."""
    port, plan, wire, consts, *_ = setup
    with torch.inference_mode():
        vals = {s: float(tps.build_stage_fn(port, plan, s, N)(wire, consts)) for s in tps.STAGES}
        for p in port.model.parameters():
            p.mul_(0.5)
        halved = {s: float(tps.build_stage_fn(port, plan, s, N)(wire, consts)) for s in ("tiles", "convs")}
        for p in port.model.parameters():
            p.mul_(2.0)
    assert all(np.isfinite(v) for v in vals.values())
    assert halved["tiles"] == vals["tiles"] and halved["convs"] != vals["convs"]
