"""The port's YOLOv11-pose (models/) against the flax model on the CPU, with
the committed golden yolo11n weights carried across by
``models/from_jax.py``.

Tolerances: raw per-level maps within atol 1e-3 (float32 on both sides;
convs and attention sum in another order); decoded boxes within 1e-2 px,
scores within 1e-4, keypoints within 1e-2 px, and the same keep mask.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facedet_tpu.engine.detector import load_params_npz as jax_load_params_npz
from facedet_tpu.models.yolo_decode import decode_predictions as jax_decode
from facedet_tpu.models.yolo_decode import decode_to_detections as jax_to_detections
from facedet_tpu.models.yolov11 import YoloConfig as JaxYoloConfig
from facedet_tpu.models.yolov11 import YoloV11 as JaxYoloV11
from facedet_tpu_torch.engine.detector import YoloV11PoseDetectionModel
from facedet_tpu_torch.models import from_jax
from facedet_tpu_torch.models.yolo_decode import decode_predictions, decode_to_detections
from facedet_tpu_torch.models.yolov11 import YoloConfig, YoloV11
from facedet_tpu_torch.utils.synth import synthetic_faces

torch.set_num_threads(1)

CKPT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "facedet_tpu", "eval", "assets", "yolo11n_golden.npz",
)


@pytest.fixture(scope="module")
def outputs():
    """The same 2x128x128 tiles (a synthetic face and noise) through both
    forwards: (flax maps, torch maps)."""
    tiles = np.stack([
        synthetic_faces(128, 128, seed=1, n=1, size=(50, 64)),
        np.random.default_rng(2).integers(0, 256, (128, 128, 3)),
    ]).astype(np.float32) / 255.0
    jm = JaxYoloV11(JaxYoloConfig(scale="n"))
    want = jax.jit(lambda v, x: jm.apply(v, x, train=False))(jax_load_params_npz(CKPT), jnp.asarray(tiles))
    tm = YoloV11(YoloConfig(scale="n"))
    from_jax.load_jax_variables(tm, from_jax.load_params_npz(CKPT))
    with torch.inference_mode():
        got = tm.set_dtypes().eval()(torch.from_numpy(tiles))
    return want, got


def test_raw_maps_match_flax(outputs):
    want, got = outputs
    assert len(got) == len(want) == 3
    for level_w, level_g in zip(want, got):
        assert set(level_g) == set(level_w) == {"box", "cls", "kpt"}
        for k in level_w:
            assert level_g[k].dtype == torch.float32
            np.testing.assert_allclose(level_g[k].numpy(), np.asarray(level_w[k]), atol=1e-3, err_msg=k)


def test_decoded_detections_match_flax(outputs):
    want, got = outputs
    kw = dict(conf_threshold=0.05, max_detections=400, nms_iou=0.7)  # 400 > 336 anchors: no top-k cut
    jd = jax_to_detections(jax_decode([{k: jnp.asarray(v) for k, v in lv.items()} for lv in want]), **kw)
    td = decode_to_detections(decode_predictions(got), **kw)
    np.testing.assert_array_equal(td.valid.numpy(), np.asarray(jd.valid))
    assert int(td.valid[0].sum()) > 0  # the face tile has detections
    v = td.valid.numpy()
    np.testing.assert_allclose(td.boxes.numpy()[v], np.asarray(jd.boxes)[v], atol=1e-2)
    np.testing.assert_allclose(td.scores.numpy()[v], np.asarray(jd.scores)[v], atol=1e-4)
    np.testing.assert_allclose(td.kpts.numpy()[v], np.asarray(jd.kpts)[v], atol=1e-2)
    np.testing.assert_array_equal(td.classes.numpy()[v], np.asarray(jd.classes)[v])


def test_golden_checkpoint_maps_onto_the_flax_names():
    tree = from_jax.load_params_npz(CKPT)
    state = from_jax.from_jax_variables(tree)
    assert len(state) == 453
    assert state["backbone.c2psa.m0.attn.pe.conv.weight"].shape == (128, 1, 3, 3)  # grouped OIHW
    assert "backbone.stem.bn.running_var" in state


def test_loader_fails_loudly_on_missing_extra_or_int8_keys():
    tree = from_jax.load_params_npz(CKPT)
    model = YoloV11(YoloConfig(scale="n"))
    del tree["params"]["head"]["box0_2"]["bias"]
    with pytest.raises(KeyError, match="missing"):
        from_jax.load_jax_variables(model, tree)
    tree = from_jax.load_params_npz(CKPT)
    tree["params"]["head"]["extra"] = {"kernel": np.zeros((1, 1, 1, 1), np.float32)}
    with pytest.raises(KeyError, match="extra"):
        from_jax.load_jax_variables(model, tree)
    tree = from_jax.load_params_npz(CKPT)
    # an int8 leaf planted beside the float conv: the scope becomes an int8
    # module, and the float leaves left over are extra
    tree["params"]["backbone"]["stem"]["qkernel"] = np.zeros((3, 3, 3, 16), np.int8)
    with pytest.raises(KeyError, match="extra"):
        from_jax.load_jax_variables(YoloV11(YoloConfig(scale="n")), tree)


def test_detection_model_random_init_and_dtypes():
    """Seeded random init is reproducible; bfloat16 (the serving default)
    runs convs in bfloat16 and keeps float32 BatchNorm statistics."""
    a = YoloV11PoseDetectionModel(scale="n", seed=3, device="cpu")
    b = YoloV11PoseDetectionModel(scale="n", seed=3, device="cpu")
    assert a.dtype == "bfloat16" and a.bn_dtype == "bfloat16"
    wa = a.model.backbone.stem.conv.weight
    assert wa.dtype == torch.bfloat16 and a.model.backbone.stem.bn.running_mean.dtype == torch.float32
    assert torch.equal(wa, b.model.backbone.stem.conv.weight)
    tiles = torch.from_numpy(synthetic_faces(64, 64, seed=4, n=1, size=(24, 31))).float()[None] / 255
    det = a.forward_tiles(tiles)
    assert det.boxes.shape == (1, 84, 4) and det.boxes.dtype == torch.float32
    assert bool(torch.isfinite(det.boxes).all())
    with pytest.raises(FileNotFoundError):  # .pt converts (tests/test_torch_convert.py); this one is missing
        YoloV11PoseDetectionModel(model_path="x.pt", scale="n", device="cpu")
