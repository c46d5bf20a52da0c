"""The public functions the port took last from the JAX package, against
it on the CPU: ``core/boxes.py`` (the four conversions, ``shift_boxes``,
``scale_boxes``, ``union_boxes``), ``Detections.from_arrays``,
``batched_empty``, ``ops/tiler.pad_image``,
``engine/detector.attach_keypoints_to_predictions`` (the function and the
detector's method) and ``models/yolov11.create_yolo``.

Tolerances: boxes within 1e-6 (float32 on both sides, the same formulas);
``from_arrays``, ``batched_empty`` and ``pad_image`` exactly; the attached
keypoints equal JAX's; JAX's ``create_yolo`` variables load into the port's
``create_yolo`` module with every key used, and the raw maps then agree
within tests/test_torch_yolo.py's atol 1e-3.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facedet_tpu.core import boxes as JB
from facedet_tpu.core import detections as JD
from facedet_tpu.engine import detector as JDET
from facedet_tpu.engine.prediction import ObjectPrediction as JaxObjectPrediction
from facedet_tpu.models import yolov11 as JY
from facedet_tpu.ops import tiler as JT
from facedet_tpu_torch.core import boxes as TB
from facedet_tpu_torch.core import detections as TD
from facedet_tpu_torch.engine import detector as TDET
from facedet_tpu_torch.engine.prediction import ObjectPrediction
from facedet_tpu_torch.models import from_jax
from facedet_tpu_torch.models import yolov11 as TY
from facedet_tpu_torch.ops import tiler as TT

torch.set_num_threads(1)


def _boxes(seed, n=7):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-20, 300, (n, 2)).astype(np.float32)
    wh = rng.uniform(0, 80, (n, 2)).astype(np.float32)
    return np.concatenate([xy, xy + wh], 1)


@pytest.mark.parametrize("name", ["xyxy_to_xywh", "xywh_to_xyxy", "xyxy_to_cxcywh", "cxcywh_to_xyxy"])
def test_box_conversions_against_jax(name):
    b = _boxes(1).reshape(1, 7, 4)  # a leading axis too
    got = getattr(TB, name)(torch.from_numpy(b))
    want = np.asarray(getattr(JB, name)(jnp.asarray(b)))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


@pytest.mark.parametrize("shift", [(12.5, -3.0), "arrays"])
def test_shift_scale_union_against_jax(shift):
    b, c = _boxes(2), _boxes(3)
    if shift == "arrays":  # one shift per box, as tensors
        rng = np.random.default_rng(4)
        shift = (rng.uniform(0, 600, 7).astype(np.float32), rng.uniform(0, 600, 7).astype(np.float32))
        tshift = tuple(torch.from_numpy(s) for s in shift)
    else:
        tshift = shift
    tb = torch.from_numpy(b)
    np.testing.assert_allclose(TB.shift_boxes(tb, *tshift).numpy(),
                               np.asarray(JB.shift_boxes(jnp.asarray(b), *shift)), atol=1e-6)
    np.testing.assert_allclose(TB.scale_boxes(tb, 0.5).numpy(), np.asarray(JB.scale_boxes(jnp.asarray(b), 0.5)),
                               atol=1e-6)
    np.testing.assert_allclose(TB.union_boxes(tb, torch.from_numpy(c)).numpy(),
                               np.asarray(JB.union_boxes(jnp.asarray(b), jnp.asarray(c))), atol=1e-6)
    assert set(TB.__all__) == set(JB.__all__)


def _equal_dets(got: TD.Detections, want: JD.Detections):
    for f in ("boxes", "scores", "classes", "kpts", "valid"):
        g, w = getattr(got, f), np.asarray(getattr(want, f))
        assert g.shape == w.shape and g.numpy().dtype == w.dtype and np.array_equal(g.numpy(), w), f


@pytest.mark.parametrize("n, capacity, with_kpts", [(5, 8, True), (5, 3, True), (4, None, False), (0, None, False),
                                                     (0, 4, False)])
def test_from_arrays_against_jax(n, capacity, with_kpts):
    rng = np.random.default_rng(n + (capacity or 0))
    boxes = _boxes(5, n) if n else np.zeros((0, 4), np.float32)
    scores = rng.random(n).astype(np.float32)
    classes = rng.integers(0, 3, n) if with_kpts else None
    kpts = rng.random((n, 5, 3)).astype(np.float32) if with_kpts else None
    want = JD.Detections.from_arrays(boxes, scores, classes, kpts, capacity=capacity)
    got = TD.Detections.from_arrays(boxes, scores, classes, kpts, capacity=capacity)
    _equal_dets(got, want)
    # tensors in: the device of the boxes
    again = TD.Detections.from_arrays(torch.from_numpy(boxes), torch.from_numpy(scores), capacity=capacity)
    assert again.boxes.device.type == "cpu" and np.array_equal(again.boxes.numpy(), got.boxes.numpy())


def test_batched_empty_against_jax():
    _equal_dets(TD.batched_empty(3, 6), JD.batched_empty(3, 6))
    _equal_dets(TD.batched_empty(2, 4, num_keypoints=0), JD.batched_empty(2, 4, num_keypoints=0))


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_pad_image_against_jax(dtype):
    img = (np.random.default_rng(6).random((37, 53, 3)) * 255).astype(dtype)
    for ph, pw in ((37, 53), (64, 53), (40, 96)):
        got = TT.pad_image(torch.from_numpy(img), ph, pw)
        want = np.asarray(JT.pad_image(jnp.asarray(img), ph, pw))
        assert got.shape == want.shape and np.array_equal(got.numpy(), want)


def _predictions(cls):
    # the first matches a key exactly after rounding, the second by IoU, the
    # third nothing; the fourth keeps its own keypoints
    return [cls([10.04, 20.0, 50.0, 70.0], 0.9), cls([101.0, 99.0, 151.0, 160.0], 0.8),
            cls([300.0, 300.0, 310.0, 310.0], 0.7), cls([10.0, 20.0, 50.0, 70.0], 0.6, keypoints=np.ones((5, 3)))]


def test_attach_keypoints_against_jax():
    rng = np.random.default_rng(7)
    cache = {(10.0, 20.0, 50.0, 70.0): rng.random((5, 3)), (100.0, 100.0, 150.0, 160.0): rng.random((5, 3)),
             (500.0, 500.0, 540.0, 560.0): rng.random((5, 3))}
    got = TDET.attach_keypoints_to_predictions(_predictions(ObjectPrediction), cache)
    want = JDET.attach_keypoints_to_predictions(_predictions(JaxObjectPrediction), cache)
    for g, w in zip(got, want):
        assert (g.keypoints is None) == (w.keypoints is None)
        if w.keypoints is not None:
            assert g.keypoints.dtype == np.float32 and np.array_equal(g.keypoints, w.keypoints)
    assert np.array_equal(got[0].keypoints, cache[(10.0, 20.0, 50.0, 70.0)].astype(np.float32))
    assert np.array_equal(got[1].keypoints, cache[(100.0, 100.0, 150.0, 160.0)].astype(np.float32))
    assert got[2].keypoints is None and np.array_equal(got[3].keypoints, np.ones((5, 3)))
    # the detector's method passes no cache, as JAX's
    det = TDET.YoloV11PoseDetectionModel(scale="n", device="cpu", load_at_init=False)
    preds = _predictions(ObjectPrediction)
    assert det.attach_keypoints_to_predictions(preds) is preds and preds[0].keypoints is None


def test_create_yolo_holds_jax_variables():
    cfg = dict(scale="n", with_pose=True)
    # JAX's create_yolo under jit: flax's eager init of yolo11n takes half a minute here
    variables = jax.jit(lambda key: JY.create_yolo(JY.YoloConfig(**cfg), key, image_size=64)[1])(jax.random.PRNGKey(0))
    jm = JY.YoloV11(JY.YoloConfig(**cfg))
    tm = TY.create_yolo(TY.YoloConfig(**cfg), seed=0, image_size=64, device="cpu")
    assert isinstance(tm, TY.YoloV11) and not tm.training
    seeded = {k: v.clone() for k, v in tm.state_dict().items()}
    assert np.array_equal(TY.create_yolo(TY.YoloConfig(**cfg), seed=0, device="cpu").backbone.stem.conv.weight.detach().numpy(),
                          seeded["backbone.stem.conv.weight"].numpy())
    from_jax.load_jax_variables(tm, jax.device_get(variables))  # raises on a missing or an extra key
    assert not torch.equal(tm.state_dict()["backbone.stem.conv.weight"], seeded["backbone.stem.conv.weight"])
    x = np.random.default_rng(8).random((2, 64, 64, 3)).astype(np.float32)
    want = jax.jit(lambda v, x: jm.apply(v, x, train=False))(variables, jnp.asarray(x))
    with torch.inference_mode():
        got = tm(torch.from_numpy(x))
    for level_w, level_g in zip(want, got):
        assert set(level_g) == set(level_w)
        for k in level_w:
            np.testing.assert_allclose(level_g[k].numpy(), np.asarray(level_w[k]), atol=1e-3, err_msg=k)


def test_create_yolo_raises_without_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TY.create_yolo(TY.YoloConfig(scale="n"), seed=0)
