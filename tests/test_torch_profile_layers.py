"""facedet_tpu_torch/tools/profile_layers.py against
facedet_tpu/tools/profile_layers.py on the CPU: one prefix per section, the
port's ``truncated_forward`` (the model's own submodules) against JAX's
``TruncatedYolo(cfg, stop).apply`` with the golden yolo11n weights carried
across, float32, two random 64x64 tiles. Tolerance: atol 1e-3, as
tests/test_torch_yolo.py holds the raw maps (convs sum in other orders).

In float32 the two agree; in bfloat16 they time different forwards: JAX's
``TruncatedYolo`` drops ``bn_dtype`` and the space-to-depth stem, the port's
prefix is the served forward. That is held here: every step runs, and the
last one gives ``forward_nchw``'s maps exactly, in float32 and in bfloat16.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facedet_tpu.engine.detector import YoloV11PoseDetectionModel as JaxModel
from facedet_tpu.tools.profile_layers import TruncatedYolo
from facedet_tpu_torch.engine.detector import YoloV11PoseDetectionModel
from facedet_tpu_torch.tools import profile_layers as tpl

torch.set_num_threads(1)

CKPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "facedet_tpu", "eval", "assets", "yolo11n_golden.npz")
KW = dict(model_path=CKPT, scale="n", confidence_threshold=0.25, image_size=64)


@pytest.fixture(scope="module")
def setup():
    jax_model = JaxModel(dtype="float32", s2d_early=False, **KW)
    ports = {dt: YoloV11PoseDetectionModel(dtype=dt, device="cpu", **KW).model for dt in ("float32", "bfloat16")}
    x = np.random.default_rng(0).random((2, 64, 64, 3), np.float32)
    return jax_model, ports, x


@pytest.mark.parametrize("stop", ["backbone/c3k2_0", "backbone/c2psa", "neck/pan_down1", "head_cls", "head_kpt"])
def test_prefix_matches_jax_truncated_yolo(setup, stop):
    jax_model, ports, x = setup
    want = TruncatedYolo(jax_model.model.cfg, stop).apply(jax_model.variables, jnp.asarray(x), train=False)
    want = [np.asarray(w) for w in (want if isinstance(want, list) else [want])]
    with torch.inference_mode():
        got = tpl.truncated_forward(ports["float32"], torch.from_numpy(x).permute(0, 3, 1, 2), stop)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g.numpy() if g.shape == w.shape else g.permute(0, 2, 3, 1).numpy()
        np.testing.assert_allclose(g, w, atol=1e-3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_every_step_runs_and_the_last_is_the_served_forward(setup, dtype):
    _, ports, x = setup
    model = ports[dtype]
    tiles = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.inference_mode():
        outs = {s: tpl.truncated_forward(model, tiles, s) for s in tpl.STEPS}
        served = model.forward_nchw(tiles)
    assert all(torch.isfinite(t.float()).all() for o in outs.values() for t in o)
    assert outs["backbone/stem"][0].dtype == model.cfg.compute_dtype
    want = [level[b] for level in served for b in ("box", "cls", "kpt")]
    assert len(outs["head_kpt"]) == len(want) == 9
    for g, w in zip(outs["head_kpt"], want):
        assert torch.equal(g, w)
    assert [tuple(t.shape) for t in outs["head_box"]] == [tuple(level["box"].shape) for level in served]


def test_an_unknown_step_raises(setup):
    with pytest.raises(ValueError, match="unknown step"):
        tpl.truncated_forward(setup[1]["float32"], torch.zeros(1, 3, 64, 64), "neck/down0")
