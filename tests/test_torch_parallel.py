"""The port's multi-device inference (facedet_tpu_torch/parallel/ and the
``mesh=`` / ``devices=`` paths of engine/predict.py) against
facedet_tpu/parallel/ and the JAX engine on the 8-device CPU mesh.

``get_sliced_prediction(mesh=)`` runs in a gloo world of 2 on a (1, 2) CPU
mesh, in spawned workers (tests/test_torch_dist_workers.py, which import no jax),
while the JAX references are computed here. ``predict_stream_batched
(devices=)`` and ``predict_stream_multidevice`` run in this process over
``["cpu", "cpu"]``.

Tolerances: every rank's sliced result against the port's single-process
result and against JAX's ``get_sliced_prediction(mesh=create_mesh(8))``
under PERF.md §2's gates (``eval.gates.section2_gate``: equal counts, boxes
0.05 px, scores 1e-3, keypoints 0.1 px); the fake detector exactly one
detection, equal to the unsharded one; the tile-sharded forward of an odd
tile count equal to the direct forward exactly; the round-robin stream in
order, equal counts, scores within 1e-5 and boxes within 1e-3 of
``devices=None`` and of JAX's stream with ``devices=mesh``; the FSDP plan
of yolo11n sharding the same physical axis as JAX's, leaf for leaf.
"""
import os

import jax
import numpy as np
import pytest
import torch

import test_torch_dist_workers as W
from facedet_tpu.engine.detector import YoloV11PoseDetectionModel as JaxYolo
from facedet_tpu.engine.fake import FakeBlobDetectionModel as JaxFake
from facedet_tpu.engine.predict import get_sliced_prediction as jax_get_sliced_prediction
from facedet_tpu.engine.predict import predict_stream_batched as jax_predict_stream_batched
from facedet_tpu.models.yolov11 import YoloConfig as JaxYoloConfig
from facedet_tpu.models.yolov11 import YoloV11 as JaxYoloV11
from facedet_tpu.parallel.eval_parallel import predict_stream_multidevice as jax_predict_stream_multidevice
from facedet_tpu.parallel.mesh import create_mesh as jax_create_mesh
from facedet_tpu.parallel.mesh import mesh_shape_for as jax_mesh_shape_for
from facedet_tpu.parallel.sharding import fsdp_param_shardings as jax_fsdp_param_shardings
from facedet_tpu_torch.engine.fake import FakeBlobDetectionModel
from facedet_tpu_torch.engine.predict import predict_stream_batched
from facedet_tpu_torch.eval.gates import section2_gate
from facedet_tpu_torch.models import from_jax
from facedet_tpu_torch.parallel import create_mesh
from facedet_tpu_torch.parallel.eval_parallel import predict_stream_multidevice
from facedet_tpu_torch.parallel.mesh import mesh_shape_for
from facedet_tpu_torch.utils.synth import synthetic_faces

torch.set_num_threads(1)


def photo():
    """A 512x768 photo of six synthetic faces (the 640 bucket; the block
    photo of tests/test_parallel.py holds no face the golden model finds)."""
    return synthetic_faces(512, 768, seed=2)


def dots(h, w, centres):
    img = np.zeros((h, w, 3), np.uint8)
    for y, x in centres:
        img[y - 1 : y + 2, x - 1 : x + 2] = 255
    return img


def stream_images():
    """tests/test_parallel.py's six one-dot images."""
    rng = np.random.default_rng(0)
    out = []
    for _ in range(6):
        y, x = int(rng.integers(10, 140)), int(rng.integers(10, 190))
        out.append(dots(150, 200, [(y, x)]))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One spawn of the port's world of 2, with the JAX references of the
    sliced runs computed here while it runs."""
    workdir = str(tmp_path_factory.mktemp("pinfer"))
    rng = np.random.default_rng(3)
    np.savez(os.path.join(workdir, "inputs.npz"), photo=photo(), blob=dots(150, 200, [(60, 90)]),
             odd_tiles=rng.uniform(0, 1, (3, 3, 64, 64)).astype(np.float32))
    ctx = W.spawn(W.parallel_inference_worker, 2, workdir)

    mesh = jax_create_mesh(8)
    yolo = JaxYolo(model_path=W.YOLO_CKPT, scale="n", dtype="float32", confidence_threshold=0.25, image_size=640)
    jax_yolo = jax_get_sliced_prediction(photo(), yolo, mesh=mesh, **W.SLICED_640)
    fake = JaxFake(confidence_threshold=0.5)
    jax_fake = jax_get_sliced_prediction(dots(150, 200, [(60, 90)]), fake, mesh=mesh, **W.SLICED_FAKE)
    jax_model = JaxYoloV11(JaxYoloConfig(scale="n"))
    params = jax.eval_shape(lambda: jax_model.init(jax.random.PRNGKey(0), jax.numpy.zeros((1, 64, 64, 3))))["params"]
    jax_plan = jax_fsdp_param_shardings(params, mesh, axis="tile", min_size=1024)

    W.join(ctx)
    load = lambda rank, tag: dict(np.load(os.path.join(workdir, f"rank{rank}_{tag}.npz")))  # noqa: E731
    return {
        "jax_yolo": W.detections_arrays(jax_yolo.detections),
        "jax_fake": W.detections_arrays(jax_fake.detections),
        "jax_plan": (params, jax_plan),
        "load": load,
    }


def test_mesh_shape_for_equals_jax():
    for n in range(1, 17):
        assert mesh_shape_for(n) == jax_mesh_shape_for(n), n


def test_create_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="process group"):
        create_mesh(1)


def test_a_mesh_of_the_wrong_size_raises(runs):
    assert bool(runs["load"](0, "plan")["wrong_size_raised"])


def _physical(ndim: int, dim: int, layout4: str, layout2: str) -> str:
    if dim < 0:
        return "-"
    return {4: layout4, 2: layout2}.get(ndim, "C" * ndim)[dim]


def test_fsdp_plan_shards_the_same_physical_axis_as_jax(runs):
    """yolo11n, min_size 1024, a tile axis of 2: each flax leaf's sharded
    dimension (HWIO / [in, out]) names the same physical axis as the port's
    (OIHW / [out, in]), leaf for leaf. Some 3x3 kernels have I == O; there
    the tie must go JAX's way."""
    params, jax_plan = runs["jax_plan"]
    leaves = list(from_jax._walk({"params": params}))
    specs = [spec for _, spec in from_jax._walk({"params": jax_plan})]
    names = list(from_jax.from_jax_variables(
        {"params": jax.tree.map(lambda a: np.zeros(a.shape, np.float32), params)}).keys())
    want = {}
    for name, (_, leaf), spec in zip(names, leaves, specs):
        dim = next((i for i, a in enumerate(spec.spec) if a == "tile"), -1)
        want[name] = _physical(leaf.ndim, dim, "HWIO", "IO")
    got_arrays = runs["load"](0, "plan")
    shapes = {k: tuple(v.shape) for k, v in from_jax.from_jax_variables(
        {"params": jax.tree.map(lambda a: np.zeros(a.shape, np.float32), params)}).items()}
    got = {str(n): _physical(len(shapes[str(n)]), int(d), "OIHW", "OI")
           for n, d in zip(got_arrays["names"], got_arrays["dims"])}
    assert got == want
    ties = [n for n, s in shapes.items() if len(s) == 4 and s[0] == s[1] and want[n] == "I"]
    assert ties  # the hazard is exercised
    assert sum(v != "-" for v in want.values()) > 50


def test_sharded_golden_yolo_at_the_640_bucket(runs):
    """The golden yolo11n on every rank of the world of 2 against the port
    without a mesh and against JAX's 8-device mesh run."""
    plain = runs["load"](0, "yolo_plain")
    assert len(plain["scores"]) >= 3
    for rank in range(2):
        got = runs["load"](rank, "yolo_mesh")
        for want in (plain, runs["jax_yolo"]):
            held, err = section2_gate(got, want)
            assert held, (rank, err)


def test_sharded_fake_detector_finds_the_one_blob(runs):
    for rank in range(2):
        got = runs["load"](rank, "fake_mesh")
        assert len(got["scores"]) == 1
        for want in (runs["load"](0, "fake_plain"), runs["jax_fake"]):
            held, err = section2_gate(got, want)
            assert held, (rank, err)


def test_odd_tile_count_pads_and_drops(runs):
    for rank in range(2):
        odd = runs["load"](rank, "odd")
        for k in ("boxes", "scores", "valid"):
            np.testing.assert_array_equal(odd[f"got_{k}"], odd[f"want_{k}"])


def _stream_checks(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g_valid, w_valid = np.asarray(g.valid), np.asarray(w.valid)
        np.testing.assert_array_equal(g_valid, w_valid)
        np.testing.assert_allclose(np.asarray(g.scores)[g_valid], np.asarray(w.scores)[w_valid], atol=1e-5)
        np.testing.assert_allclose(np.asarray(g.boxes)[g_valid], np.asarray(w.boxes)[w_valid], atol=1e-3)


def test_round_robin_stream_equals_one_device_and_jax():
    imgs = stream_images()
    kw = dict(W.SLICED_FAKE, batch_size=2, raw=True)
    port = FakeBlobDetectionModel(confidence_threshold=0.5, device="cpu")
    single = list(predict_stream_batched(imgs, port, **kw))
    multi = list(predict_stream_batched(imgs, port, devices=["cpu", "cpu"], **kw))
    jax_multi = list(jax_predict_stream_batched(imgs, JaxFake(confidence_threshold=0.5),
                                                devices=jax_create_mesh(8), **kw))
    assert len(multi) == 3
    _stream_checks(multi, single)
    _stream_checks(multi, jax_multi)


def test_multidevice_eval_stream_order_and_results():
    """tests/test_eval_parallel.py's case: ten images, one dot each, found
    in submission order; against JAX's stream too."""
    imgs = [dots(100, 120, [(20 + 7 * i, 30 + 9 * i)]) for i in range(10)]
    kw = dict(slice_height=64, slice_width=64, perform_standard_pred=False)
    port = FakeBlobDetectionModel(confidence_threshold=0.5, device="cpu")
    outs = list(predict_stream_multidevice(imgs, port, devices=["cpu", "cpu"], raw=False, **kw))
    jax_outs = list(jax_predict_stream_multidevice(imgs, JaxFake(confidence_threshold=0.5), raw=False, **kw))
    assert len(outs) == len(jax_outs) == 10
    for i, (r, j) in enumerate(zip(outs, jax_outs)):
        assert len(r.object_prediction_list) == len(j.object_prediction_list) == 1
        p = r.object_prediction_list[0]
        cy, cx = (p.bbox.miny + p.bbox.maxy) / 2, (p.bbox.minx + p.bbox.maxx) / 2
        assert abs(cy - (20 + 7 * i)) <= 1.5 and abs(cx - (30 + 9 * i)) <= 1.5
        np.testing.assert_allclose(p.bbox.to_xyxy(), j.object_prediction_list[0].bbox.to_xyxy(), atol=1e-3)
        np.testing.assert_allclose(p.score.value, j.object_prediction_list[0].score.value, atol=1e-5)


def test_replica_moves_the_weights_of_the_native_and_the_onnx_route(tmp_path):
    """A detector on another device than its own: the native route's module
    and the ONNX route's ``variables`` both land there (the ``meta`` device
    stands in for a second card), the original stays, and the replica is
    cached until the weights are replaced."""
    from facedet_tpu_torch.engine.detector import YoloV11PoseDetectionModel
    from facedet_tpu_torch.engine.onnx_wrapper import OnnxDetectionModel
    from facedet_tpu_torch.engine.predict import _replica
    from facedet_tpu_torch.models.onnx_export import export_yolo_onnx

    native = YoloV11PoseDetectionModel(scale="n", dtype="float32", seed=1, device="cpu")
    path = str(tmp_path / "yolo11n.onnx")
    export_yolo_onnx(native.model, 64, path)
    onnx = OnnxDetectionModel(model_path=path, num_keypoints=5, device="cpu")
    assert _replica(onnx, "cpu") is onnx
    for det, tensors in ((native, lambda d: list(d.model.parameters()) + list(d.model.buffers())),
                         (onnx, lambda d: list(d.variables["params"].values()))):
        rep = _replica(det, "meta")
        assert rep is not det and rep.device.type == "meta" and _replica(det, "meta") is rep
        assert tensors(rep) and all(t.device.type == "meta" for t in tensors(rep))
        assert all(t.device.type == "cpu" for t in tensors(det))
    onnx.variables = {"params": dict(onnx.variables["params"])}
    rebuilt = _replica(onnx, "meta")
    assert rebuilt is not rep and all(t.device.type == "meta" for t in rebuilt.variables["params"].values())
