"""The int8 probes of facedet_tpu_torch/tools/ (probe_int8_conv.py,
probe_int8_yolo.py) against the JAX package on the CPU.

Tolerances, each with its reason:
- the int8 route (``models/layers.int8_conv``, what ``Int8ConvBnAct``
  serves) equals ``lax.conv_general_dilated(int8, int8,
  preferred_element_type=int32)`` exactly: integer sums;
- the bfloat16 arm (``F.conv2d`` on bfloat16, a bfloat16 result) is within
  bfloat16 rounding of JAX's float32-accumulated conv of the same bfloat16
  values: half an ulp of the result (2^-9 relative) plus the float32
  accumulation order, held at 2^-8 of each value plus 2^-12 of the largest;
- the calibration tiles equal an inline copy of the JAX tool's recipe
  exactly; the calibrated scopes and the quantized count equal JAX's, the
  absmax within 2^-5 relative (both calibrate in bfloat16:
  tests/test_torch_quantize_bf16.py measured the spread), and given JAX's
  absmax every ``ascale`` is bit-equal;
- the float32 arm's recall and precision equal JAX's ``parity_on_split``
  exactly (float32 detectors on both sides, counts of matched faces);
- the report's keys equal JAX's, with the wall ms the port adds.
``Int8ConvBnAct`` against its JAX layer stays in tests/test_torch_quantize.py.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from facedet_tpu.engine.detector import YoloV11PoseDetectionModel as JaxModel
from facedet_tpu.models import quantize as JQ
from facedet_tpu.tools import golden_finetune as jgf
from facedet_tpu_torch.engine.detector import YoloV11PoseDetectionModel
from facedet_tpu_torch.models import quantize as Q
from facedet_tpu_torch.tools import golden_finetune as tgf
from facedet_tpu_torch.tools import probe_int8_conv as pic
from facedet_tpu_torch.tools import probe_int8_yolo as piy
from facedet_tpu_torch.tools import reference_goldens as trg
from facedet_tpu_torch.utils.synth import synthetic_reference_tree

torch.set_num_threads(1)

CKPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "facedet_tpu", "eval", "assets", "yolo11n_golden.npz")
SIZE = 256  # _natural_tile's octaves need a multiple of 128
SHAPES = [(2, 12, 16, 8, 16), (1, 9, 7, 24, 8)]
DN = jax.lax.conv_dimension_numbers((1, 1, 1, 1), (1, 1, 1, 1), ("NHWC", "HWIO", "NHWC"))


def _jax_conv(x, k, out_t):
    return jax.lax.conv_general_dilated(x, k, (1, 1), ((1, 1), (1, 1)), dimension_numbers=DN,
                                        preferred_element_type=out_t)


@pytest.mark.parametrize("shape", SHAPES)
def test_int8_route_equals_jax_int32_conv_exactly(shape):
    _xf, _kf, xi, ki = pic.make_inputs(np.random.default_rng(1), *shape)
    xq, gw = pic.int8_operands(xi, ki, "cpu")
    got = pic.conv_int8(xq, gw, shape[-1])
    want = np.asarray(_jax_conv(jnp.asarray(xi), jnp.asarray(ki), jnp.int32))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    # the probe's two parts compose to the whole
    cols = pic.int8_im2col(xq, 3, 1)
    assert np.array_equal(pic.int8_cols_matmul(cols, gw, shape[-1]).numpy().reshape(want.shape), want)


@pytest.mark.parametrize("shape", SHAPES)
def test_bf16_arm_within_bf16_rounding_of_jax_f32_accumulation(shape):
    xf, kf, _xi, _ki = pic.make_inputs(np.random.default_rng(2), *shape)
    xb, kb = pic.bf16_operands(xf, kf, "cpu")
    got = pic.conv_bf16(xb, kb)
    assert got.dtype == torch.bfloat16
    got = got.float().permute(0, 2, 3, 1).numpy()
    want = np.asarray(_jax_conv(jnp.asarray(xf, jnp.bfloat16), jnp.asarray(kf, jnp.bfloat16), jnp.float32))
    assert np.all(np.abs(got - want) <= 2**-8 * np.abs(want) + 2**-12 * np.abs(want).max())
    assert np.abs(got - want).max() > 0  # the bfloat16 result is rounded


def test_int8_conv_main_rows_on_the_cpu(capsys):
    out = pic.main(["--device", "cpu", "--iters", "1", "--shape", ",".join(map(str, SHAPES[0]))])
    tag = "[2x12x16x8->16]"
    assert set(out["rows"][tag]) == set(pic.ARMS) and out["ops"][tag] == 2.0 * 2 * 12 * 16 * 9 * 8 * 16
    assert all(r["device_ms"] is None for r in out["rows"][tag].values())
    assert "not a device number" in capsys.readouterr().out
    assert pic.SHAPES == ((42, 80, 80, 128, 128), (42, 40, 40, 256, 256), (42, 160, 160, 64, 64))


def _jax_letterbox(image, size):
    """The JAX tool's calibration lines (facedet_tpu/tools/probe_int8_yolo.py),
    at ``size`` where it has 640."""
    s = float(size) / max(image.shape[:2])
    h, w = int(image.shape[0] * s), int(image.shape[1] * s)
    small = np.asarray(Image.fromarray(image).resize((w, h), Image.BILINEAR), np.float32) / 255.0
    tile = np.zeros((size, size, 3), np.float32)
    tile[:h, :w] = small
    return tile[None]


def _tree(root, n, hw, seed):
    synthetic_reference_tree(root, n_images=n, hw=hw, n_faces=4, size=(30, 60), seed=seed)
    gp = os.path.join(root, "goldens.json")
    with open(gp, "w") as f:
        json.dump(trg.extract_goldens(root), f)
    return gp


@pytest.fixture(scope="module")
def six(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("six"))
    gp = _tree(root, 7, (192, 256), 21)
    return root, gp, tgf.load_golden_dataset(gp, root, None, min_conf=0.2)


def _node(params, path):
    for p in path:
        params = params[p]
    return params


def test_calibration_tiles_quantize_as_jax(six):
    """Six letterboxed golden photos (of seven: the first six) at a tile of
    256: the port's count and absmax against JAX's ``calibrate`` and
    ``quantize_variables`` on the same tiles, both in bfloat16."""
    root, _gp, records = six
    assert len(records) == 7
    batches = piy.calibration_batches(records, SIZE)
    assert len(batches) == piy.CALIB_IMAGES == 6
    for b, r in zip(batches, records):
        assert np.array_equal(b, _jax_letterbox(r["image"], SIZE))
    kw = dict(model_path=CKPT, scale="n", dtype="bfloat16", confidence_threshold=0.25, image_size=SIZE,
              max_detections_per_tile=300)
    jm = JaxModel(**kw)
    jm.load_model()
    want_absmax = JQ.calibrate(jm.model, jm.variables, batches)
    jq = JQ.quantize_variables(jm.variables, want_absmax)
    n_jax = sum(x.dtype == np.int8 for x in jax.tree.leaves(jq["params"]) if hasattr(x, "dtype"))
    det = YoloV11PoseDetectionModel(device="cpu", **kw)
    q_model, got_absmax = piy.int8_copy(det, batches)
    assert piy.count_int8(q_model) == n_jax == 56
    assert set(got_absmax) == set(want_absmax)
    assert all(abs(got_absmax[k] - want_absmax[k]) <= 2**-5 * want_absmax[k] for k in want_absmax)
    # given JAX's absmax, every ascale is JAX's bit for bit
    same = Q.quantize_model(det.model, want_absmax, float_model=det.float32_model())
    assert same == n_jax
    for path in JQ._iter_q(jq["params"]):
        got = det.model.get_submodule(".".join(path)).ascale
        assert np.float32(got.item()) == np.asarray(_node(jq["params"], path)["ascale"], np.float32), path


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("two"))
    gp = _tree(root, 2, (256, 384), 23)
    return root, gp


def test_float32_parity_arm_equals_jax_and_keys(two, tmp_path, monkeypatch):
    root, gp = two
    out = str(tmp_path / "port.json")
    report = piy.main(["--goldens", gp, "--ref-dir", root, "--keypoints", "", "--device", "cpu", "--dtype", "float32",
                       "--size", str(SIZE), "--tiles", "1", "--iters", "1", "--out", out])
    assert json.load(open(out)) == json.loads(json.dumps(report))
    jdet = JaxModel(model_path=CKPT, scale="n", dtype="float32", confidence_threshold=0.25, image_size=SIZE,
                    max_detections_per_tile=300)
    jrecords = jgf.load_golden_dataset(gp, root, None, min_conf=0.2)
    want = jgf.parity_on_split(jdet, json.load(open(gp)), jrecords, root, 0.35, 0.5)
    assert want["recall"] > 0
    assert report["parity"]["bf16"] == {"recall": want["recall"], "precision": want["precision"]}
    assert report["quantized_convs"] == 56
    assert report["device"]["bf16_ms_per_batch"] is None and report["device"]["speedup"] is None

    # the JAX tool's report keys, from its own main with its expensive parts stubbed
    from facedet_tpu.tools import probe_int8_yolo as jpy

    monkeypatch.setattr(jgf, "load_golden_dataset", lambda min_conf=0.2: jrecords)
    monkeypatch.setattr(jgf, "parity_on_split", lambda *a: {"recall": 1.0, "precision": 1.0})
    absmax = {k: 1.0 for k in Q.calibrate(YoloV11PoseDetectionModel(
        model_path=CKPT, scale="n", dtype="float32", image_size=SIZE, device="cpu").model,
        piy.calibration_batches(jrecords[:1], SIZE))}
    monkeypatch.setattr(JQ, "calibrate", lambda *a: absmax)
    monkeypatch.setattr(jpy, "device_time_tile_forward", lambda det, n: 0.01)
    jout = str(tmp_path / "jax.json")
    jpy.main(["--out", jout])
    jrep = json.load(open(jout))
    assert set(report) == set(jrep)
    assert {k: set(v) for k, v in report["parity"].items()} == {k: set(v) for k, v in jrep["parity"].items()}
    assert set(report["device"]) == set(jrep["device"]) | {"bf16_wall_ms_per_batch", "int8_wall_ms_per_batch"}


def test_main_raises_without_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pic.main(["--iters", "1", "--shape", ",".join(map(str, SHAPES[0]))])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        piy.main(["--skip-parity"])
