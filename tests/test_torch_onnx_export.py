"""The port's ONNX export (facedet_tpu_torch/models/onnx_export.py) against
facedet_tpu/models/onnx_export.py: the protobuf encoder byte for byte, the
parse / save / parse round trip, and full-scale exports re-imported through
the port's parser and executor (no ``onnx`` package here).

Tolerances, tests/test_onnx_export.py's: the encoder and ``serialize_model``
equal to the JAX helpers' bytes exactly (given one producer string); the
round trip equal field for field, initializers bit for bit; ``scrfd_2.5g``
(golden) at 640x640 with that test's structural asserts, its nine outputs
within atol 2e-4 / rtol 1e-3 of the port's native forward and of the flax
forward on the same weights; yolo11n-pose (golden) at 320 against the
native decode: boxes 1e-3, scores 1e-4, keypoints 1e-3; the wrapper route,
native against ONNX ``tile_forward``: equal keep masks, boxes 0.05, scores
1e-3, keypoints 0.05.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facedet_tpu.models import onnx_export as jexp
from facedet_tpu.models import scrfd as jax_scrfd
from facedet_tpu_torch.engine.detector import YoloV11PoseDetectionModel
from facedet_tpu_torch.engine.onnx_wrapper import OnnxDetectionModel
from facedet_tpu_torch.models import from_jax
from facedet_tpu_torch.models import onnx_export as texp
from facedet_tpu_torch.models.onnx_import import OnnxGraph, OnnxNode, import_onnx, parse_onnx
from facedet_tpu_torch.models.scrfd import SCRFD_VARIANTS, Scrfd
from facedet_tpu_torch.models.yolo_decode import decode_predictions

torch.set_num_threads(1)

ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "facedet_tpu", "eval", "assets")
SCRFD_CKPT = os.path.join(ASSETS, "scrfd_2_5g_golden.npz")
YOLO_CKPT = os.path.join(ASSETS, "yolo11n_golden.npz")
NAMES = [f"{k}_{s}" for k in ("score", "bbox", "kps") for s in (8, 16, 32)]


def hand_graph() -> OnnxGraph:
    """One node per attribute type (int, bool, float, string, tensor,
    floats, ints), float32 and int64 initializers, a named graph."""
    nodes = [
        OnnxNode("Conv", ["input.1", "w"], ["c"], {"group": 1, "strides": [1, 1], "pads": [1, 1, 1, 1]}, "conv0"),
        OnnxNode("LeakyRelu", ["c"], ["r"], {"alpha": 0.125}, "act"),
        OnnxNode("Resize", ["r", "", "scales"], ["u"], {"mode": "nearest", "coordinate_transformation_mode": "asymmetric"}),
        OnnxNode("Constant", [], ["k"], {"value": np.arange(6, dtype=np.int64).reshape(2, 3)}),
        OnnxNode("Custom", ["u", "k"], ["y"], {"weights": [0.5, -1.25, 3.0], "negative": -7, "flag": True}),
        OnnxNode("Reshape", ["y", "shape"], ["out"], {}),
    ]
    inits = {
        "w": np.random.default_rng(0).standard_normal((4, 3, 3, 3)).astype(np.float32),
        "scales": np.array([1, 1, 2, 2], np.float32),
        "shape": np.array([1, -1], np.int64),
    }
    return OnnxGraph(nodes, inits, ["input.1"], ["out"], {"input.1": [1, 3, 8, 8]}, name="hand")


def test_encoder_bytes_equal_the_jax_helpers():
    g = hand_graph()
    assert texp._varint(-3) == jexp._varint(-3) and texp._varint(300) == jexp._varint(300)
    for name, arr in g.initializers.items():
        assert texp.encode_tensor(name, arr) == jexp.encode_tensor(name, arr)
    for n in g.nodes:
        assert texp.encode_node(n.op_type, n.inputs, n.outputs, n.attrs, n.name) == \
            jexp.encode_node(n.op_type, n.inputs, n.outputs, n.attrs, n.name)
        for k, v in n.attrs.items():
            assert texp.encode_attribute(k, v) == jexp.encode_attribute(k, v)
    assert texp.encode_value_info("input.1", [1, 3, 8, 8]) == jexp.encode_value_info("input.1", [1, 3, 8, 8])
    for opset in (16, 17):
        assert texp.serialize_model(g, opset=opset, producer="facedet_tpu") == jexp.serialize_model(g, opset=opset)


def test_a_scalar_tensor_keeps_no_dims(tmp_path):
    """The one place the bytes differ, on purpose: a 0-d tensor (torch's
    exporter writes scalar Constants) is written without dims and re-parses
    0-d; the JAX helper writes dims [1] (ROADMAP.md §3)."""
    scalar = np.array(1, np.int64)
    assert texp.encode_tensor("", scalar) != jexp.encode_tensor("", scalar)
    assert texp.encode_tensor("", scalar) == jexp.encode_tensor("", scalar[None])[2:]
    g = OnnxGraph([OnnxNode("Constant", [], ["k"], {"value": scalar})], {"s": np.array(2.5, np.float32)},
                  [], ["k"], {}, name="scalars")
    texp.save_onnx(g, str(tmp_path / "s.onnx"))
    back = parse_onnx(str(tmp_path / "s.onnx"))
    assert back.nodes[0].attrs["value"].shape == () and back.initializers["s"].shape == ()
    jexp.save_onnx(g, str(tmp_path / "j.onnx"))
    assert parse_onnx(str(tmp_path / "j.onnx")).nodes[0].attrs["value"].shape == (1,)


def graphs_equal(a: OnnxGraph, b: OnnxGraph) -> None:
    assert (a.name, a.input_names, a.output_names, a.input_shapes) == (b.name, b.input_names, b.output_names, b.input_shapes)
    assert len(a.nodes) == len(b.nodes)
    for x, y in zip(a.nodes, b.nodes):
        assert (x.op_type, x.inputs, x.outputs, x.name) == (y.op_type, y.inputs, y.outputs, y.name)
        assert x.attrs.keys() == y.attrs.keys()
        for k in x.attrs:
            if isinstance(x.attrs[k], np.ndarray):
                np.testing.assert_array_equal(x.attrs[k], y.attrs[k])
                assert x.attrs[k].dtype == y.attrs[k].dtype
            else:
                assert x.attrs[k] == y.attrs[k], k
    assert a.initializers.keys() == b.initializers.keys()
    for k, v in a.initializers.items():
        assert v.dtype == b.initializers[k].dtype and v.shape == b.initializers[k].shape
        np.testing.assert_array_equal(v, b.initializers[k])


def test_parse_save_parse_round_trip(tmp_path):
    first = tmp_path / "a.onnx"
    texp.save_onnx(hand_graph(), str(first))
    once = parse_onnx(str(first))
    graphs_equal(once, hand_graph())
    second = tmp_path / "b.onnx"
    texp.save_onnx(once, str(second))
    graphs_equal(parse_onnx(str(second)), once)
    assert first.read_bytes() == second.read_bytes()


@pytest.fixture(scope="module")
def scrfd_full(tmp_path_factory):
    """The golden scrfd_2.5g exported at 640 through the generic entry."""
    tree = from_jax.load_params_npz(SCRFD_CKPT)
    model = Scrfd(SCRFD_VARIANTS["scrfd_2.5g"])
    from_jax.load_jax_variables(model, tree)
    model.eval()
    path = str(tmp_path_factory.mktemp("onnx") / "scrfd_2.5g.onnx")
    graph = texp.export_scrfd_onnx(model, image_size=640, path=path)
    return tree, model, path, graph


def test_scrfd_full_scale_export_is_real(scrfd_full):
    _, _, path, graph = scrfd_full
    assert len(graph.nodes) > 300
    assert len(graph.initializers) > 200
    reparsed = parse_onnx(path)
    assert reparsed.input_names == ["input.1"]
    assert reparsed.input_shapes["input.1"] == [1, 3, 640, 640]
    assert reparsed.output_names == NAMES
    four_d = [a for a in reparsed.initializers.values() if a.ndim == 4]
    assert four_d and all(a.shape[2] == a.shape[3] for a in four_d if a.shape[2] <= 7)
    graphs_equal(reparsed, graph)
    resaved = path + ".resaved"
    texp.save_onnx(reparsed, resaved)
    graphs_equal(parse_onnx(resaved), reparsed)


def test_scrfd_full_scale_roundtrip_parity(scrfd_full):
    tree, model, path, _ = scrfd_full
    mod = import_onnx(path)
    rng = np.random.default_rng(1)
    img = rng.random((1, 640, 640, 3), np.float32)
    blob = np.transpose((img * 255.0 - 127.5) / 128.0, (0, 3, 1, 2)).astype(np.float32)
    with torch.no_grad():
        got = [g.numpy() for g in mod(mod.params, torch.from_numpy(blob))]
        native = [n.numpy() for n in texp._ScrfdExport(model)(torch.from_numpy(blob))]

    cfg = jax_scrfd.SCRFD_VARIANTS["scrfd_2.5g"]
    levels = jax.jit(lambda v, x: jax_scrfd.Scrfd(cfg).apply(v, x, train=False))(tree, jnp.asarray(img))
    flax = []
    for key in ("cls", "box", "kps"):
        for lvl in levels:
            c = {"cls": 1, "box": 4, "kps": 2 * cfg.num_keypoints}[key]
            flat = lvl[key].reshape(1, -1, c)
            flax.append(np.asarray(jax.nn.sigmoid(flat) if key == "cls" else flat))
    assert len(got) == len(native) == len(flax) == 9
    for name, g, n, f in zip(NAMES, got, native, flax):
        np.testing.assert_allclose(g, n, atol=2e-4, rtol=1e-3, err_msg=name)
        np.testing.assert_allclose(g, f, atol=2e-4, rtol=1e-3, err_msg=name)


@pytest.fixture(scope="module")
def yolo_full(tmp_path_factory):
    native = YoloV11PoseDetectionModel(model_path=YOLO_CKPT, scale="n", dtype="float32",
                                       confidence_threshold=0.01, device="cpu")
    path = str(tmp_path_factory.mktemp("onnx") / "yolo11n-pose.onnx")
    graph = texp.export_yolo_onnx(native.model, image_size=320, path=path)
    return native, path, graph


def test_yolo_export_layout_and_scale(yolo_full):
    _, path, graph = yolo_full
    assert len(graph.nodes) > 400
    reparsed = parse_onnx(path)
    assert reparsed.input_names == ["images"]
    assert reparsed.output_names == ["output0"]


def test_yolo_roundtrip_matches_native_decode(yolo_full):
    native, path, _ = yolo_full
    mod = import_onnx(path)
    rng = np.random.default_rng(4)
    img = torch.from_numpy(rng.random((1, 3, 320, 320), np.float32))
    with torch.no_grad():
        out = mod(mod.params, img)[0].numpy()
        preds = {k: v.numpy() for k, v in decode_predictions(native.model.forward_nchw(img)).items()}
    a = out.shape[-1]
    assert out.shape == (1, 4 + 1 + 5 * 3, a)
    cx, cy, w, h = out[0, 0], out[0, 1], out[0, 2], out[0, 3]
    want = preds["boxes"][0]
    np.testing.assert_allclose(np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1), want, atol=1e-3)
    np.testing.assert_allclose(out[0, 4:5].T, preds["scores"][0], atol=1e-4)
    np.testing.assert_allclose(out[0, 5:].T.reshape(a, 5, 3), preds["kpts"][0], atol=1e-3)


def test_yolo_wrapper_parity_native_vs_onnx(yolo_full):
    native, path, _ = yolo_full
    onnx_m = OnnxDetectionModel(model_path=path, confidence_threshold=0.01, num_keypoints=5, device="cpu")
    rng = np.random.default_rng(5)
    tiles = torch.from_numpy(rng.random((2, 320, 320, 3), np.float32))
    det_a = native.tile_forward(tiles, 0.01)
    det_b = onnx_m.tile_forward(tiles, 0.01)
    va, vb = det_a.valid.numpy(), det_b.valid.numpy()
    np.testing.assert_array_equal(va, vb)
    assert va.sum() > 0
    np.testing.assert_allclose(det_a.boxes.numpy()[va], det_b.boxes.numpy()[vb], atol=0.05)
    np.testing.assert_allclose(det_a.scores.numpy()[va], det_b.scores.numpy()[vb], atol=1e-3)
    np.testing.assert_allclose(det_a.kpts.numpy()[va], det_b.kpts.numpy()[vb], atol=0.05)
