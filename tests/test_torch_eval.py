"""The port's WIDERFACE evaluation layer (facedet_tpu_torch/eval/,
data/widerface.py, the two eval CLIs) against the JAX package on the CPU.

Tolerances:
  * host protocol code (float64 numpy in both packages): bit-identical —
    APs, PR curves, IoU matrices, subcategories, COCO mAP, files written;
  * the evaluators with each package's fake detector: identical APs and
    curves;
  * yolo11n with the golden weights, float32, on two 320x480 images at slice
    160: equal prediction counts, APs within 1e-3 (convs sum in another
    order in the two frameworks).
"""
import importlib
import json
import os

import numpy as np
import pytest
import torch

from facedet_tpu.data import widerface as jwf
from facedet_tpu.engine.fake import FakeBlobDetectionModel as JaxFake
from facedet_tpu.eval import dual as jdual
from facedet_tpu.eval import reference_parity as jparity
from facedet_tpu.eval import subcategory as jsub
from facedet_tpu.eval import submission as jsubm
from facedet_tpu.eval import tuning as jtuning
from facedet_tpu.eval import widerface_official as jwo
from facedet_tpu_torch.data import widerface as twf
from facedet_tpu_torch.engine.fake import FakeBlobDetectionModel
from facedet_tpu_torch.eval import dual as tdual
from facedet_tpu_torch.eval import reference_parity as tparity
from facedet_tpu_torch.eval import subcategory as tsub
from facedet_tpu_torch.eval import submission as tsubm
from facedet_tpu_torch.eval import tuning as ttuning
from facedet_tpu_torch.eval import widerface_official as two
from facedet_tpu_torch.utils.synth import synthetic_faces_with_boxes
from facedet_tpu_torch.utils.viz import save_image

# the packages' __init__ re-export the function under the module's name
jbo = importlib.import_module("facedet_tpu.eval.bbox_overlaps")
tbo = importlib.import_module("facedet_tpu_torch.eval.bbox_overlaps")
jcoco = importlib.import_module("facedet_tpu.eval.coco_map")
tcoco = importlib.import_module("facedet_tpu_torch.eval.coco_map")

torch.set_num_threads(1)

CKPT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "facedet_tpu", "eval", "assets", "yolo11n_golden.npz",
)
GT_TXT = """0--Parade/0_Parade_1.jpg
2
10 10 20 20 0 0 0 0 0 0
100 100 200 180 1 0 1 0 2 1
1--Other/1_Other_1.jpg
0
0 0 0 0 0 0 0 0 0 0
2--More/2_More_1.jpg
1
5 5 60 60 0 0 0 1 0 0
3--Mixed/3_Mixed_1.jpg
3
40 30 45 50 0 0 0 0 0 0
120 90 170 160 0 0 2 0 0 0
7 200 30 12 2 1 0 0 1 0
"""


def _scene(rng, n_gt, n_pred):
    """xywh GT boxes and xywh+score predictions, half of them near a GT."""
    mk = lambda n: np.concatenate([rng.uniform(0, 300, (n, 2)), rng.uniform(4, 80, (n, 2))], 1)  # noqa: E731
    gt, pred = mk(n_gt), mk(n_pred)
    for i in range(min(n_pred // 2, n_gt)):
        pred[i] = gt[int(rng.integers(n_gt))] + rng.normal(0, 3, 4)
    scores = np.round(rng.uniform(0.0, 1.0, (n_pred, 1)), 3)  # ties included
    return gt, np.concatenate([pred, scores], 1)


@pytest.fixture(scope="module")
def dataset():
    """{event: {image: (gt [G,4], pred [P,5], keep)}} over 3 events."""
    rng = np.random.default_rng(0)
    out = {}
    for e in range(3):
        for i in range(4):
            gt, pred = _scene(rng, int(rng.integers(0, 9)), int(rng.integers(0, 14)))
            keep = np.flatnonzero(rng.random(len(gt)) < 0.7) + 1
            out.setdefault(f"{e}--Ev", {})[f"img_{i}"] = (gt, pred, keep)
    return out


def test_bbox_overlaps_equal_jax():
    rng = np.random.default_rng(3)
    a = rng.uniform(0, 100, (23, 2))
    a = np.concatenate([a, a + rng.uniform(-2, 40, (23, 2))], -1)  # some empty boxes
    b = rng.uniform(0, 100, (9, 2))
    b = np.concatenate([b, b + rng.uniform(0, 40, (9, 2))], -1)
    assert tbo.native_library() is not None  # g++ builds it into build/native/
    np.testing.assert_array_equal(tbo.bbox_overlaps(a, b), jbo.bbox_overlaps(a, b))
    np.testing.assert_array_equal(tbo.bbox_overlaps_numpy(a, b), jbo.bbox_overlaps_numpy(a, b))
    np.testing.assert_allclose(tbo.bbox_overlaps(a, b), tbo.bbox_overlaps_numpy(a, b), atol=1e-12)
    assert tbo.bbox_overlaps(a[:0], b).shape == (0, 9)


def test_protocol_functions_bit_identical(dataset):
    rng = np.random.default_rng(1)
    for event in dataset.values():
        for gt, pred, keep in event.values():
            if not len(gt) or not len(pred):
                continue
            pred = pred[np.argsort(-pred[:, 4], kind="stable")]
            ignore = np.zeros(len(gt))
            ignore[keep - 1] = 1
            got = two.image_eval(pred, gt, ignore, 0.5)
            want = jwo.image_eval(pred, gt, ignore, 0.5)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(two.img_pr_info(pred, got[1], got[0]), jwo.img_pr_info(pred, want[1], want[0]))
    curve = rng.integers(0, 20, (1000, 2)).astype(float)
    np.testing.assert_array_equal(two.dataset_pr_info(curve, 37), jwo.dataset_pr_info(curve, 37))
    rec, prec = np.sort(rng.random(50)), rng.random(50)
    assert two.voc_ap(rec, prec) == jwo.voc_ap(rec, prec)


@pytest.mark.parametrize("keep", [True, False])
def test_evaluate_setting_bit_identical(dataset, keep):
    preds = {e: {i: v[1] for i, v in imgs.items()} for e, imgs in dataset.items()}
    boxes = {e: {i: v[0] for i, v in imgs.items()} for e, imgs in dataset.items()}
    keeps = {e: {i: v[2] for i, v in imgs.items()} for e, imgs in dataset.items()} if keep else None
    got = two.evaluate_setting(preds, boxes, keeps)
    want = jwo.evaluate_setting(preds, boxes, keeps)
    assert got[0] == want[0] and 0.0 < got[0] < 1.0
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])


def _write_mat_gt(d, dataset):
    from scipy.io import savemat

    events = list(dataset)
    cell = lambda n: np.empty((n, 1), object)  # noqa: E731
    ev, files, boxes = cell(len(events)), cell(len(events)), cell(len(events))
    settings = {s: cell(len(events)) for s in ("easy", "medium", "hard")}
    rng = np.random.default_rng(5)
    for i, e in enumerate(events):
        names = list(dataset[e])
        ev[i, 0] = e
        files[i, 0], boxes[i, 0] = cell(len(names)), cell(len(names))
        for s in settings:
            settings[s][i, 0] = cell(len(names))
        for j, name in enumerate(names):
            gt = dataset[e][name][0]
            files[i, 0][j, 0] = name
            boxes[i, 0][j, 0] = np.round(gt)
            for s, frac in (("easy", 0.3), ("medium", 0.6), ("hard", 1.0)):
                settings[s][i, 0][j, 0] = (np.flatnonzero(rng.random(len(gt)) < frac) + 1).reshape(-1, 1).astype(float)
    savemat(os.path.join(d, "wider_face_val.mat"), {"event_list": ev, "file_list": files, "face_bbx_list": boxes})
    for s, gl in settings.items():
        savemat(os.path.join(d, f"wider_{s}_val.mat"), {"gt_list": gl})


def test_mat_gt_and_official_run_bit_identical(tmp_path, dataset):
    _write_mat_gt(str(tmp_path), dataset)
    preds = {e: {i: v[1] for i, v in imgs.items()} for e, imgs in dataset.items()}
    kw = dict(images_path="", gt_path=str(tmp_path), output_dir=str(tmp_path / "out"))
    got = two.OfficialWiderFaceEvaluator(None, **kw)
    want = jwo.OfficialWiderFaceEvaluator(None, **kw)
    for s in ("easy", "medium", "hard"):
        for e in dataset:
            for name in dataset[e]:
                np.testing.assert_array_equal(got.gt["setting_gts"][s][e][name], want.gt["setting_gts"][s][e][name])
    r_got, r_want = got.run(predictions=preds, save=False), want.run(predictions=preds, save=False)
    assert r_got["aps"] == r_want["aps"] and r_got["mode"] == r_want["mode"]
    assert r_got["curves"] == r_want["curves"]
    assert r_got["aps"]["easy"] != r_got["aps"]["hard"]


def test_gt_txt_parsing_and_converters_equal_jax(tmp_path):
    gt = tmp_path / "gt.txt"
    gt.write_text(GT_TXT)
    ann_t, ann_j = twf.parse_wider_gt_txt(str(gt)), jwf.parse_wider_gt_txt(str(gt))
    assert {k: [vars(f) for f in v] for k, v in ann_t.items()} == {k: [vars(f) for f in v] for k, v in ann_j.items()}
    for fn in ("gt_txt_to_prediction_structures", "gt_txt_to_keep_lists"):
        got, want = getattr(twf, fn)(ann_t), getattr(jwf, fn)(ann_j)
        assert got.keys() == want.keys()
        for e in got:
            for name in got[e]:
                np.testing.assert_array_equal(got[e][name], want[e][name])
    sizes = {"0--Parade/0_Parade_1.jpg": (400, 400), "1--Other/1_Other_1.jpg": (100, 100),
             "2--More/2_More_1.jpg": (80, 80), "3--Mixed/3_Mixed_1.jpg": (240, 300)}
    stats = {}
    for pkg, d in ((twf, "t"), (jwf, "j")):
        stats[d] = (pkg.convert_widerface_to_yolo(str(gt), str(tmp_path), str(tmp_path / d / "labels"), image_sizes=sizes),
                    pkg.convert_widerface_to_coco(str(gt), str(tmp_path), str(tmp_path / d / "coco.json"), image_sizes=sizes))
        pkg.create_dataset_yaml(str(tmp_path / d / "data.yaml"), "/data/widerface")
        (tmp_path / d / "pred.txt").write_text("img_1\n1 2 3 4 0.9\n5 6 7 8 0.8\n")
        assert pkg.fix_prediction_file(str(tmp_path / d / "pred.txt")) is True
    assert stats["t"] == stats["j"] and stats["t"][0]["skipped_faces"] == 1
    for rel in sorted(os.listdir(tmp_path / "j" / "labels")):
        assert (tmp_path / "t" / "labels" / rel).read_text() == (tmp_path / "j" / "labels" / rel).read_text()
    for rel in ("coco.json", "data.yaml", "pred.txt"):
        assert (tmp_path / "t" / rel).read_text() == (tmp_path / "j" / rel).read_text()


def test_subcategories_equal_jax(tmp_path):
    gt = tmp_path / "gt.txt"
    gt.write_text(GT_TXT)
    got = tsub.build_subcategory_gt(str(gt), str(tmp_path / "t.json"))
    want = jsub.build_subcategory_gt(str(gt), str(tmp_path / "j.json"))
    assert got == want and got["statistics"]["invalid_faces"] == 1
    assert (tmp_path / "t.json").read_text() == (tmp_path / "j.json").read_text()
    data = got["data"]
    for img in list(data) + ["Parade", "nowhere"]:
        assert tsub.check_image_category(data, img) == jsub.check_image_category(data, img)
    for cat in tsub.CATEGORIES:
        assert tsub.find_images_by_category(data, cat) == jsub.find_images_by_category(data, cat)
    with pytest.raises(ValueError):
        tsub.find_images_by_category(data, "tiny_clear")


def test_coco_map_bit_identical():
    rng = np.random.default_rng(2)
    preds, gts = [], []
    for img in range(6):
        gt, pred = _scene(rng, int(rng.integers(0, 8)), int(rng.integers(0, 120)))
        gts += [{"image_id": img, "bbox": list(g)} for g in gt]
        preds += [{"image_id": img, "bbox": list(p[:4]), "score": float(p[4])} for p in pred]
    got, want = tcoco.coco_map(preds, gts), jcoco.coco_map(preds, gts)
    assert got == want and 0.0 < got["map50"] < 1.0
    assert tcoco.coco_map([], gts) == jcoco.coco_map([], gts)


def test_submission_round_trip_equal_jax(tmp_path, dataset):
    preds = {e: {i: v[1] for i, v in imgs.items()} for e, imgs in dataset.items()}
    assert tsubm.write_submission(preds, str(tmp_path / "t")) == jsubm.write_submission(preds, str(tmp_path / "j")) == 12
    for e in preds:
        for name in preds[e]:
            rel = os.path.join(e, f"{name}.txt")
            assert (tmp_path / "t" / rel).read_text() == (tmp_path / "j" / rel).read_text()
    (tmp_path / "t" / "0--Ev" / "img_0.txt").write_text("img_0\n1 2 3 4 0.5\n")  # the missing-count malformation
    got, want = tsubm.read_submission(str(tmp_path / "t")), jsubm.read_submission(str(tmp_path / "t"))
    assert got.keys() == want.keys()
    for e in got:
        for name in got[e]:
            np.testing.assert_array_equal(got[e][name], want[e][name])


def test_dual_functions_and_evaluator_bit_identical():
    rng = np.random.default_rng(7)
    a, b = _scene(rng, 12, 9)
    a[0, 2:] = 0.0
    np.testing.assert_array_equal(tdual.iou_matrix_xywh(a, b[:, :4]), jdual.iou_matrix_xywh(a, b[:, :4]))
    assert tdual.calculate_iou(a[1], b[1, :4]) == jdual.calculate_iou(a[1], b[1, :4])
    sub_gt, preds = {}, {}
    cats = tsub.CATEGORIES + [None]
    for k in range(8):
        gt, pred = _scene(rng, int(rng.integers(0, 10)), int(rng.integers(0, 16)))
        faces = [{"bbox": list(g), "category": cats[int(rng.integers(len(cats)))]} for g in gt]
        sub_gt[f"ev/im{k}.jpg"] = {"all_faces": faces}
        preds[os.path.join("root", f"ev/im{k}.jpg")] = pred
    kw = dict(images_path="root", output_dir="unused", global_confidence=0.25)
    got = tdual.DualWiderFaceEvaluator(preds.__getitem__, sub_gt, **kw).run(save=False)
    want = jdual.DualWiderFaceEvaluator(preds.__getitem__, sub_gt, **kw).run(save=False)
    for part in ("subcategory_results", "difficulty_results"):
        assert got[part] == want[part]
    assert any(0.0 < r["ap"] < 1.0 for r in got["difficulty_results"])
    dets = [{"confidence": float(c), "is_tp": bool(t)} for c, t in zip(rng.random(30), rng.random(30) < 0.6)]
    assert tdual.average_precision_11pt(dets, 25) == jdual.average_precision_11pt(dets, 25)


def test_reference_parity_matching_equal_jax():
    rng = np.random.default_rng(4)
    gt, pred = _scene(rng, 9, 12)
    to_xyxy = lambda b: np.concatenate([b[:, :2], b[:, :2] + b[:, 2:4]], 1).astype(np.float32)  # noqa: E731
    g, p = to_xyxy(gt), to_xyxy(pred)
    assert tparity.match_detections(g, p) == jparity.match_detections(g, p)
    golden = {"faces": [{"bbox": list(map(float, b)), "conf_lo": float(lo), "conf_hi": float(lo) + 0.2}
                        for b, lo in zip(g, rng.uniform(0, 0.8, len(g)))]}
    kpts = [rng.uniform(0, 300, (5, 3)).round() for _ in g]
    dets = [(list(b), float(s), rng.uniform(0, 300, (5, 3))) for b, s in zip(p, pred[:, 4])]
    for min_conf in (0.0, 0.5):
        got = tparity.compare_image(golden, dets, golden_kpts=kpts, min_golden_conf=min_conf)
        want = jparity.compare_image(golden, dets, golden_kpts=kpts, min_golden_conf=min_conf)
        assert got.keys() == want.keys() and got["matched"] == want["matched"] > 0
        for k in got:
            assert got[k] == pytest.approx(want[k], abs=1e-6), k


def test_run_parity_with_fake_detector_equal_jax(tmp_path):
    """``run_parity`` over a reference layout (``<name>/temp_sahi_input.jpg``)
    with each package's fake detector: the same report."""
    goldens = {"images": {}}
    for k, dots in enumerate(([(30, 40), (70, 100)], [(50, 60)])):
        os.makedirs(tmp_path / f"scene{k}")
        save_image(str(tmp_path / f"scene{k}" / "temp_sahi_input.jpg"), _dot_image(100, 120, dots), quality=95)
        goldens["images"][f"scene{k}"] = {"faces": [{"bbox": [x - 5, y - 5, x + 5, y + 5], "conf_lo": 0.6,
                                                     "conf_hi": 0.9} for y, x in dots]}
    goldens["images"]["absent"] = {"faces": []}  # no source image: skipped
    got = tparity.run_parity(goldens, str(tmp_path), FakeBlobDetectionModel(confidence_threshold=0.3, image_size=None,
                                                                            device="cpu"), conf=0.3)
    want = jparity.run_parity(goldens, str(tmp_path), JaxFake(confidence_threshold=0.3, image_size=None), conf=0.3)
    assert got == want and set(got["images"]) == {"scene0", "scene1"} and got["recall"] > 0


def _dot_image(h, w, dots):
    img = np.zeros((h, w, 3), np.uint8)
    for y, x in dots:
        img[y - 1 : y + 2, x - 1 : x + 2] = 255
    return img


@pytest.fixture()
def dot_dataset(tmp_path):
    """The two-image layout of tests/test_official_evaluator.py, as JPEG files."""
    dots = {"ev_a/img1": [(30, 40)], "ev_a/img2": [(60, 80)]}
    lines = []
    for key, ds in dots.items():
        lines += [key + ".jpg", str(len(ds))] + [f"{x - 5} {y - 5} 10 10 0 0 0 0 0 0" for y, x in ds]
        os.makedirs(tmp_path / "imgs" / "ev_a", exist_ok=True)
        save_image(str(tmp_path / "imgs" / f"{key}.jpg"), _dot_image(100, 120, ds), quality=95)
    (tmp_path / "gt.txt").write_text("\n".join(lines) + "\n")
    return tmp_path


@pytest.mark.parametrize("mode", [
    dict(use_sahi=True, slicing_strategy="uniform"),
    dict(use_sahi=True, slicing_strategy="adaptive"),
    dict(use_sahi=False),
    dict(use_sahi=True, slicing_strategy="uniform", ingest="dct420s"),
])
def test_official_evaluator_fake_detector_equal_jax(dot_dataset, mode):
    image_size = 64 if mode.get("slicing_strategy") == "uniform" else None
    kw = dict(images_path=str(dot_dataset / "imgs"), gt_txt=str(dot_dataset / "gt.txt"),
              sahi_config={"slice_height": 64, "slice_width": 64, "overlap_ratio": 0.2},
              inference_confidence=0.4, output_dir=str(dot_dataset / "out"), perform_standard_pred=False, **mode)
    got_ev = two.OfficialWiderFaceEvaluator(FakeBlobDetectionModel(confidence_threshold=0.5, image_size=image_size,
                                                                   device="cpu"), **kw)
    want_ev = jwo.OfficialWiderFaceEvaluator(JaxFake(confidence_threshold=0.5, image_size=image_size), **kw)
    got, want = got_ev.run(save=False), want_ev.run(save=False)
    assert got["mode"] == want["mode"] and got["aps"] == want["aps"] and got["curves"] == want["curves"]
    assert got["aps"]["all"] > 0.99 and got["images_per_second"] > 0
    assert got_ev.timings["images"] == 2


def test_official_evaluator_refuses_pixel_modes_with_compressed_ingest(dot_dataset):
    with pytest.raises(ValueError):
        two.OfficialWiderFaceEvaluator(None, images_path="", gt_txt=str(dot_dataset / "gt.txt"), use_sahi=False,
                                       ingest="dct420s")
    with pytest.raises(RuntimeError, match="no ground truth"):
        two.OfficialWiderFaceEvaluator(None, images_path="").run()


def test_tuning_grid_with_fake_detector_equal_jax(dot_dataset):
    from facedet_tpu_torch.utils.viz import load_image

    assert ttuning.grid_configs("comprehensive") == jtuning.grid_configs("comprehensive")
    data = [{"file_name": str(dot_dataset / "imgs" / "ev_a" / f"img{k}.jpg"), "image_id": k,
             "gt": [[35, 25, 10, 10]] if k == 1 else [[75, 55, 10, 10]]} for k in (1, 2)]
    # letterboxed at native size: the standard pass gives the tiles' box
    got = ttuning.run_grid_search(FakeBlobDetectionModel(confidence_threshold=0.3, image_size=None, device="cpu"),
                                  data, load_image, grid_name="quick", output_dir=str(dot_dataset / "t"))
    want = jtuning.run_grid_search(JaxFake(confidence_threshold=0.3, image_size=None), data, load_image,
                                   grid_name="quick", output_dir=str(dot_dataset / "j"))
    strip = lambda rs: [{k: v for k, v in r.items() if k != "seconds"} for r in rs]  # noqa: E731
    assert strip(got["results"]) == strip(want["results"]) and got["num_configs"] == 4
    assert all(r["errors"] == 0 for r in got["results"]) and got["best"]["map50"] > 0.9
    for f in ("best_sahi_config.json",):
        assert (dot_dataset / "t" / f).read_text() == (dot_dataset / "j" / f).read_text()


def test_eval_clis_cpu_equal_jax(dot_dataset, tmp_path):
    from facedet_tpu.apps import eval_dual_cli as jdual_cli
    from facedet_tpu.apps import eval_official as jofficial_cli
    from facedet_tpu_torch.apps import eval_dual_cli, eval_official

    args = ["--images", str(dot_dataset / "imgs"), "--gt-txt", str(dot_dataset / "gt.txt"), "--family", "fake",
            "--conf", "0.4", "--slice", "64", "--no-standard-pred"]
    got = eval_official.main(args + ["--output", str(tmp_path / "t"), "--device", "cpu"])
    want = jofficial_cli.main(args + ["--output", str(tmp_path / "j")])
    assert got["aps"] == want["aps"] == {"all": 1.0}
    saved = json.loads((tmp_path / "t" / "official_eval_results.json").read_text())
    assert saved["aps"] == got["aps"] and saved["mode"] == "SAHI (uniform)"
    got = eval_dual_cli.main(args + ["--output", str(tmp_path / "td"), "--device", "cpu"])
    want = jdual_cli.main(args + ["--output", str(tmp_path / "jd")])
    for part in ("subcategory_results", "difficulty_results"):
        assert got[part] == want[part]
    by_cat = {r["category"]: r for r in got["subcategory_results"]}
    assert by_cat["small_clear"]["total_gt"] == 2 and by_cat["small_clear"]["ap"] == pytest.approx(1.0, abs=1e-6)
    assert (tmp_path / "td" / "dual_eval_results.json").exists()
    with pytest.raises(SystemExit, match="need --subcategory-gt"):
        eval_dual_cli.main(["--images", "x", "--device", "cpu"])


@pytest.fixture(scope="module")
def face_dataset(tmp_path_factory):
    """Two 320x480 synthetic images with their face boxes, as a WIDERFACE
    layout (``event/name.jpg`` and ``gt.txt``) and in memory."""
    d = tmp_path_factory.mktemp("faces")
    images, lines = {}, []
    for k in range(2):
        img, boxes = synthetic_faces_with_boxes(320, 480, seed=60 + k, n=4, size=(40, 80))
        key = f"0--Synth/face_{k}"
        images[key] = img
        os.makedirs(d / "images" / "0--Synth", exist_ok=True)
        save_image(str(d / "images" / f"{key}.jpg"), img, quality=95)
        lines += [f"{key}.jpg", str(len(boxes))]
        lines += [f"{x1:.2f} {y1:.2f} {x2 - x1:.2f} {y2 - y1:.2f} 0 0 0 0 0 0" for x1, y1, x2, y2 in boxes]
    (d / "gt.txt").write_text("\n".join(lines) + "\n")
    return d, images


@pytest.fixture(scope="module")
def yolo_pair():
    from facedet_tpu.engine.detector import YoloV11PoseDetectionModel as JaxYolo
    from facedet_tpu_torch import YoloV11PoseDetectionModel

    kw = dict(model_path=CKPT, scale="n", dtype="float32", confidence_threshold=0.25, image_size=320)
    return JaxYolo(**kw), YoloV11PoseDetectionModel(device="cpu", **kw)


def test_golden_yolo_through_both_evaluators_matches_jax(face_dataset, yolo_pair):
    from facedet_tpu.engine.predict import get_sliced_prediction as jax_sliced
    from facedet_tpu_torch.apps.eval_dual_cli import make_predict_fn

    d, images = face_dataset
    jm, tm = yolo_pair
    loader = lambda path: images["/".join(path.split(os.sep)[-2:])[:-4]]  # noqa: E731
    kw = dict(images_path=str(d / "images"), gt_txt=str(d / "gt.txt"),
              sahi_config={"slice_height": 160, "slice_width": 160, "overlap_ratio": 0.2},
              inference_confidence=0.01, image_loader=loader)
    got_ev, want_ev = two.OfficialWiderFaceEvaluator(tm, **kw), jwo.OfficialWiderFaceEvaluator(jm, **kw)
    got_p, want_p = got_ev.run_inference_on_all_images(), want_ev.run_inference_on_all_images()
    for name in images:
        e, n = name.split("/")
        assert len(got_p[e][n]) == len(want_p[e][n]) >= 3
    got, want = got_ev.run(got_p, save=False), want_ev.run(want_p, save=False)
    assert abs(got["aps"]["all"] - want["aps"]["all"]) <= 1e-3 and got["aps"]["all"] > 0.1
    assert tm.confidence_threshold == 0.25  # restored after the run

    # the dual evaluator over the same files: the port CLI's predict_fn, and
    # the JAX pipeline with the same options
    sub_gt = tsub.build_subcategory_gt(str(d / "gt.txt"))["data"]
    predict = make_predict_fn(tm, slice_size=160)

    def jax_predict(path):
        from facedet_tpu.utils.viz import load_image

        res = jax_sliced(load_image(path), jm, slice_height=160, slice_width=160, overlap_height_ratio=0.2,
                         overlap_width_ratio=0.2, postprocess_type="NMS", postprocess_match_metric="IOU",
                         postprocess_match_threshold=0.5, postprocess_class_agnostic=True)
        return np.array([[*p.bbox.to_xywh(), p.score.value] for p in res.object_prediction_list]).reshape(-1, 5)

    got = tdual.DualWiderFaceEvaluator(predict, sub_gt, images_path=str(d / "images")).run(save=False)
    want = jdual.DualWiderFaceEvaluator(jax_predict, sub_gt, images_path=str(d / "images")).run(save=False)
    for g, w in zip(got["subcategory_results"] + got["difficulty_results"],
                    want["subcategory_results"] + want["difficulty_results"]):
        assert g["category"] == w["category"] and g["total_gt"] == w["total_gt"]
        assert g["total_pred"] == w["total_pred"] and abs(g["ap"] - w["ap"]) <= 1e-3
    assert max(r["ap"] for r in got["difficulty_results"]) > 0.1
