"""facedet_tpu_torch/tools/profile_modules.py against
facedet_tpu/tools/profile_modules.py on the CPU.

``DenseClsHead`` (bfloat16 convs and BatchNorm output, as both tools build
it) against JAX's class with its flax init carried across, on seeded
bfloat16 features of three levels. Tolerance: 2e-2 of the largest output:
both compute in bfloat16, which rounds each conv's output to 8 bits of
mantissa, and XLA and torch round at different points of the two convs.
The pose-off head gives JAX's shapes and no ``kpt`` map.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facedet_tpu.models.yolov11 import DetectHead as JaxDetectHead
from facedet_tpu.models.yolov11 import YoloConfig as JaxYoloConfig
from facedet_tpu.tools.profile_modules import DenseClsHead as JaxDenseClsHead
from facedet_tpu_torch.models import from_jax
from facedet_tpu_torch.models.yolov11 import YoloConfig, YoloV11
from facedet_tpu_torch.tools.profile_modules import DenseClsHead

torch.set_num_threads(1)

CHANS = (64, 128, 256)  # yolo11n's three levels


@pytest.fixture(scope="module")
def feats():
    rng = np.random.default_rng(0)
    return [np.asarray(jnp.asarray(rng.standard_normal((2, s, s, c)), jnp.bfloat16)) for s, c in zip((8, 4, 2), CHANS)]


def test_dense_cls_head_matches_jax(feats):
    jax_head = JaxDenseClsHead(CHANS)
    jf = [jnp.asarray(f) for f in feats]
    variables = jax.tree.map(np.asarray, jax_head.init(jax.random.PRNGKey(1), jf))
    want = jax_head.apply(variables, jf)
    head = DenseClsHead(CHANS)
    head.load_state_dict(from_jax.from_jax_variables(variables))
    head.set_dtypes().eval()
    with torch.inference_mode():
        got = head([torch.from_numpy(f.astype(np.float32)).to(torch.bfloat16).permute(0, 3, 1, 2) for f in feats])
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == torch.float32 and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, atol=2e-2 * np.abs(w).max())


def test_pose_off_head_shapes_match_jax(feats):
    cfg = JaxYoloConfig(scale="n", with_pose=False)
    jf = [jnp.asarray(f, jnp.float32) for f in feats]
    want = jax.eval_shape(lambda: JaxDetectHead(cfg).init_with_output(jax.random.PRNGKey(0), jf, train=False)[0])
    net = YoloV11(YoloConfig(scale="n", with_pose=False)).eval()
    with torch.inference_mode():
        got = net.head([torch.from_numpy(f.astype(np.float32)).permute(0, 3, 1, 2) for f in feats])
    assert [set(level) for level in got] == [{"box", "cls"}] * 3
    assert [{k: tuple(v.shape) for k, v in level.items()} for level in got] == \
        [{k: tuple(v.shape) for k, v in level.items()} for level in want]
