"""The published RT-DETR-l (facedet_tpu_torch/models/rtdetr_l.py, the
``rtdetr-l-hgnetv2`` variants of engine/rtdetr_wrapper.py) against the plain
float32 reference of tests/plain_rtdetr_l.py, on the CPU, on the narrow
``rtdetr-l-hgnetv2-tiny`` (the published layout at a few channels) with
weights drawn by the benchmark's family (port_bench/families/rtdetr.py).

Tolerances, each with its reason:
- float32: ``top_idx`` equal; logits within 2e-4 and boxes within 5e-6 (in
  [0, 1] units): float32 round-off only, the same functions summed in other
  orders (the program's attention and sampling reshape where the reference
  loops), through about sixty layers to logits of order one (read: at most
  1.8e-5 and 2.4e-7 over four seeds and two inputs);
- bfloat16, ``top_idx`` forced to the reference's: logits within 0.6 and
  boxes within 0.005: bfloat16 keeps 8 bits of mantissa, and every
  convolution and linear rounds its inputs and outputs to it through the
  same sixty layers of a net only 8 to 64 channels wide (read: 0.17 to 0.29
  and at most 0.0017 on logits of deviation 1.0 to 1.8, over the same four
  seeds and two inputs; float32 reads 10,000 times less);
- the sliced path in float32: the same detections, scores within 1e-4 and
  boxes within 0.05 px (float32 round-off through the merge's union boxes).

The tests marked ``cuda`` skip where torch sees no card (``python -m pytest
--noconftest -p no:cacheprovider tests/test_torch_rtdetr_l.py`` on the
card). There, on the benchmark cell's seeded weights at 640: replay must be
bitwise equal to the eager chain; and bfloat16, given the float32
reference's selection, must keep its logits within 0.6 (largest), 0.18 (RMS)
and its boxes within 0.006 of the reference's, where the program's int8
path, one precision below, must not (on the NVIDIA H100, bfloat16 read 0.27,
0.078 and 0.0030 and int8 1.13, 0.30 and 0.0079 at batch 6; 0.28, 0.083,
0.0024 and 0.90, 0.30, 0.0084 at batch 1: the rounding of sixty bfloat16
layers of a random net, logits of deviation 1.4).
"""
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from facedet_tpu_torch import get_sliced_prediction
from facedet_tpu_torch.engine.detector import ForwardGraphs, graph_key
from facedet_tpu_torch.engine.rtdetr_wrapper import RtDetrDetectionModel
from facedet_tpu_torch.models import quantize as Q
from facedet_tpu_torch.models.layers import ConvBnAct, Int8ConvBnAct
from facedet_tpu_torch.models.rtdetr_l import (RTDETR_L_VARIANTS, ProjBn, RtDetrL, generate_anchors,
                                               load_state, sincos_2d)
from facedet_tpu_torch.utils.profiling import SPANS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import plain_rtdetr_l as plain  # noqa: E402
from port_bench import harness, inputs, weights  # noqa: E402
from port_bench.reference import rtdetr_l as bench_plain  # noqa: E402
from port_bench.reference import sahi  # noqa: E402
from port_bench.reference.expected import exact_float32  # noqa: E402

torch.set_num_threads(2)

TINY = "rtdetr-l-hgnetv2-tiny"
WIDTHS = dict(stem=(8, 12), stage_mid=(8, 12, 16, 24), stage_out=(16, 32, 48, 64), block_layers=2, hidden_dim=32,
              ffn_dim=64, repc3_depth=1, num_decoder_layers=2, num_heads=4)
SEED = 2**33 + 19
SIZE = 416  # the stride-8 map is 52 wide: its border anchors are invalid
FIELDS = ("boxes", "scores", "classes", "kpts", "valid")


def _draw(seed):
    return harness.family("rtdetr").drawn(seed, plain.state_shapes(**WIDTHS), heads=4, score_bias=-0.5)


@pytest.fixture(scope="module")
def tiny_path(tmp_path_factory):
    return weights.path({"seed": SEED}, str(tmp_path_factory.mktemp("rtdetr_l")), _draw)


@pytest.fixture(scope="module")
def tiny_params(tiny_path):
    with np.load(tiny_path) as flat:
        return {k: torch.from_numpy(flat[k]) for k in flat.files}


def _photos(n, size=SIZE, seed=3):
    arr = np.stack([inputs.photo(seed, i, (size, size), 3, (size // 10, size // 5)) for i in range(n)])
    return torch.from_numpy(arr).permute(0, 3, 1, 2).float() / 255.0


def _epilogues(model) -> int:
    """The BatchNorm epilogues of one forward: every ``ConvBnAct`` and
    ``ProjBn``."""
    return sum(isinstance(m, (ConvBnAct, ProjBn)) for m in model.modules())


def _detector(path, dtype="float32", **kw):
    return RtDetrDetectionModel(model_path=path, variant=TINY, dtype=dtype, device="cpu", **kw)


# --- the layout ------------------------------------------------------------------------


@pytest.mark.parametrize("variant", sorted(RTDETR_L_VARIANTS))
def test_state_dict_is_ultralytics_layout(variant):
    """Every tensor under Ultralytics' name and shape, as the reference's
    written-out layout has it; the published model at 80 classes has
    Ultralytics' 32,970,476 parameters."""
    cfg = RTDETR_L_VARIANTS[variant]
    with torch.device("meta"):
        model = RtDetrL(cfg)
        coco = RtDetrL(dataclasses.replace(cfg, num_classes=80))
    got = {k: tuple(v.shape) for k, v in model.state_dict().items() if not k.endswith("num_batches_tracked")}
    widths = {} if variant == "rtdetr-l-hgnetv2" else WIDTHS
    assert got == plain.state_shapes(**widths)
    if variant == "rtdetr-l-hgnetv2":
        assert sum(p.numel() for p in coco.parameters()) == 32_970_476
        assert got["model.0.stem1.conv.weight"] == (32, 3, 3, 3)
        assert got["model.9.m.5.conv2.conv.weight"] == (384, 1, 5, 5)
        assert got["model.28.dec_bbox_head.5.layers.2.bias"] == (4,)
        assert got["model.28.decoder.layers.5.cross_attn.value_proj.weight"] == (256, 256)


def test_the_sincos_embedding_keeps_ultralytics_order():
    """At the 20x20 map the tokens are h-major, the embedding's rows w-major:
    token (y, x) gets the "w" half of y and the "h" half of x, as published."""
    pos = sincos_2d(20, 20, 256)
    omega = 1.0 / (10000.0 ** (torch.arange(64, dtype=torch.float32) / 64))
    y, x = 3, 5
    row = pos[y * 20 + x]
    assert torch.allclose(row[:64], torch.sin(y * omega)) and torch.allclose(row[128:192], torch.sin(x * omega))
    rect = sincos_2d(4, 2, 8)  # w 4, h 2: row i is w = i // 2, h = i % 2
    assert torch.equal(rect[5, 0:2], torch.sin(torch.tensor([2.0, 2.0]) * torch.tensor([1.0, 0.01])))


def test_anchors_mask_the_border_of_a_wide_map():
    anchors, valid = generate_anchors([(80, 80), (40, 40), (20, 20)])
    assert anchors.shape == (8400, 4) and valid.shape == (8400, 1)
    assert int((~valid[:6400]).sum()) == 4 * 80 - 4 and bool(valid[6400:].all())
    assert torch.isinf(anchors[~valid[:, 0]]).all() and torch.isfinite(anchors[valid[:, 0]]).all()
    side = torch.sigmoid(anchors[6400:, 2])
    assert torch.allclose(side[:1600], torch.full((1600,), 0.1)) and torch.allclose(side[1600:], torch.full((400,), 0.2))


# --- against the plain reference -------------------------------------------------------


def test_float32_matches_the_plain_reference(tiny_path, tiny_params):
    x = _photos(2)
    det = _detector(tiny_path)
    net = plain.RtDetrL(tiny_params, num_heads=4, num_queries=30)
    with torch.inference_mode():
        want, got = net(x), det.model.forward_nchw(x)
    assert torch.equal(got["top_idx"], want["top_idx"])
    assert (got["logits"][0] - want["logits"]).abs().max() < 2e-4
    assert (got["boxes"][0] - want["boxes"]).abs().max() < 5e-6
    assert want["logits"].std() > 0.1 and (want["boxes"][..., 2:] > 0).all()


def test_bfloat16_with_the_references_selection(tiny_path, tiny_params):
    x = _photos(2)
    det = _detector(tiny_path, "bfloat16")
    assert det.model.model[1].m[0].conv.weight.dtype == torch.bfloat16
    assert det.model.model[28].decoder.layers[0].norm1.weight.dtype == torch.float32
    net = plain.RtDetrL(tiny_params, num_heads=4, num_queries=30)
    with torch.inference_mode():
        want = net(x)
        got = det.model.forward_nchw(x, top_idx=want["top_idx"])
    assert torch.equal(got["top_idx"], want["top_idx"])
    assert got["logits"][0].dtype == torch.float32 and got["boxes"][0].dtype == torch.float32
    logit_gap = (got["logits"][0] - want["logits"]).abs().max()
    box_gap = (got["boxes"][0] - want["boxes"]).abs().max()
    assert 1e-3 < logit_gap < 0.6 and box_gap < 0.005


def test_the_two_copies_of_the_reference_agree_bitwise(tiny_params):
    x = _photos(1, 256)
    with torch.inference_mode():
        a = plain.RtDetrL(tiny_params, num_heads=4, num_queries=30)(x)
        b = bench_plain.RtDetrL(tiny_params, num_heads=4, num_queries=30)(x)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert plain.state_shapes() == bench_plain.state_shapes()
    ta = plain.tile_detections(plain.RtDetrL(tiny_params, 4, 30), x, 0.3)
    tb = bench_plain.tile_detections(bench_plain.RtDetrL(tiny_params, 4, 30), x, 0.3)
    assert all(np.array_equal(p[k], q[k]) for p, q in zip(ta, tb) for k in p)


@pytest.mark.parametrize("side", ["program", "plain", "bench_plain"])
def test_the_deformable_value_is_the_projected_tokens(tiny_path, tiny_params, side):
    """As in Ultralytics' ``RTDETRDecoder.forward``, every decoder layer's
    ``value_proj`` reads the ``input_proj`` tokens themselves: other
    ``enc_output`` weights, with the selection held, change the queries and
    the answer but not one bit of what any layer's ``value_proj`` reads."""
    x = _photos(1, 256)
    n_layers = WIDTHS["num_decoder_layers"]
    names = [f"model.28.decoder.layers.{i}.cross_attn.value_proj.weight" for i in range(n_layers)]

    def run(moved, top_idx=None):
        seen = []
        if side == "program":
            det = _detector(tiny_path)
            dec = det.model.model[28]
            if moved:
                with torch.no_grad():
                    dec.enc_output[0].weight.mul_(-1.5)
                    dec.enc_output[1].bias.add_(0.3)
            for layer in dec.decoder.layers:
                layer.cross_attn.value_proj.register_forward_pre_hook(lambda m, a: seen.append(a[0].clone()))
            with torch.inference_mode():
                out = det.model.forward_nchw(x, top_idx)
            return seen, out["logits"][0], out["top_idx"]
        params = dict(tiny_params)
        if moved:
            params["model.28.enc_output.0.weight"] = -1.5 * params["model.28.enc_output.0.weight"]
            params["model.28.enc_output.1.bias"] = params["model.28.enc_output.1.bias"] + 0.3
        net = (plain if side == "plain" else bench_plain).RtDetrL(params, num_heads=4, num_queries=30)
        watched = {id(params[k]) for k in names}

        def linear(t, w, b=None):
            if id(w) in watched:
                seen.append(t.clone())
            return F.linear(t, w, b)

        net.linear = linear
        with torch.inference_mode():
            out = net(x, top_idx)
        return seen, out["logits"], out["top_idx"]

    base, logits, top_idx = run(False)
    moved, moved_logits, _ = run(True, top_idx)
    assert len(base) == len(moved) == n_layers
    assert all(torch.equal(a, b) for a, b in zip(base, moved))
    assert all(torch.equal(base[0], v) for v in base[1:])
    assert base[0].shape == (1, 32 * 32 + 16 * 16 + 8 * 8, 32)
    assert (moved_logits - logits).abs().max() > 1e-3


def test_sliced_prediction_matches_the_references_sliced_answer(tiny_path, tiny_params):
    det = _detector(tiny_path, image_size=256, confidence_threshold=0.3)
    rgb = inputs.photo(5, 0, (320, 480), 4, (40, 80))
    SPANS.ring.clear()
    res = get_sliced_prediction(rgb, det, slice_height=256, slice_width=256, overlap_height_ratio=0.2,
                                overlap_width_ratio=0.2, perform_standard_pred=True, postprocess_type="GREEDYNMM",
                                postprocess_match_metric="IOS", postprocess_match_threshold=0.5)
    spans = SPANS.spans()
    detector = [s.counts for s in spans if s.name == "detector"]
    # six tiles of 256 and the standard pass: queries x heads x levels x points x layers each; every
    # BatchNorm epilogue through PyTorch ops on the CPU
    e = _epilogues(det.model)
    assert detector == [{"deform_samples": 6 * 30 * 4 * 3 * 4 * 2, "graph_eager": 1, "epilogue_plain": e},
                        {"deform_samples": 30 * 4 * 3 * 4 * 2, "graph_eager": 1, "epilogue_plain": e}]
    # no per-tile NMS: the one nms span is the merge's
    assert [s.parent.name for s in spans if s.name == "nms"] == ["merge"]
    v = res.detections.valid.numpy().astype(bool)
    got = {k: getattr(res.detections, k).float().numpy()[v] for k in ("boxes", "scores")}
    net = plain.RtDetrL(tiny_params, num_heads=4, num_queries=30)
    _, _, hw = sahi.slice_grid(320, 480, 256, 256, 0.2)
    canvas = torch.zeros((3, *hw))
    canvas[:, :320, :480] = torch.from_numpy(rgb).permute(2, 0, 1).float() / 255.0
    with torch.inference_mode():
        want = sahi.sliced_detect(lambda t, c: plain.tile_detections(net, t, c), canvas, 320, 480, 256, 256, conf=0.3,
                                  img_size=256)
    order = np.argsort(-got["scores"], kind="stable")
    assert len(want["scores"]) > 5 and len(got["scores"]) == len(want["scores"])
    assert np.abs(got["scores"][order] - want["scores"]).max() < 1e-4
    assert np.abs(got["boxes"][order] - want["boxes"]).max() < 0.05


# --- loading -----------------------------------------------------------------------------


@pytest.mark.parametrize("form", ["npz", "pt", "pickled_prefix", "state_dict"])
def test_ultralytics_state_dicts_load_by_name(tiny_path, tiny_params, tmp_path, form):
    if form == "npz":
        path = tiny_path
    else:
        sd = dict(tiny_params)
        if form == "pickled_prefix":  # a pickled DetectionModel's own keys
            sd = {f"model.{k}": v for k, v in sd.items()}
        sd["model.0.stem1.bn.num_batches_tracked"] = torch.tensor(7)
        path = str(tmp_path / ("m.pth" if form == "state_dict" else "m.pt"))
        torch.save({"state_dict": sd} if form == "state_dict" else sd, path)
    det = _detector(path)
    state = det.model.state_dict()
    assert all(torch.equal(state[k], tiny_params[k]) for k in tiny_params)


def test_a_missing_tensor_raises_key_error(tiny_params, tmp_path):
    sd = {k: v for k, v in tiny_params.items() if k != "model.28.dec_bbox_head.1.layers.2.bias"}
    path = str(tmp_path / "missing.pt")
    torch.save(sd, path)
    with pytest.raises(KeyError, match=r"model\.28\.dec_bbox_head\.1\.layers\.2\.bias"):
        _detector(path)
    with pytest.raises(KeyError):
        load_state(RtDetrL(RTDETR_L_VARIANTS[TINY]), sd)


def test_a_wrong_shape_raises_value_error(tiny_params, tmp_path):
    sd = dict(tiny_params)
    sd["model.28.enc_score_head.weight"] = torch.zeros(80, 32)  # the COCO head
    path = str(tmp_path / "coco.npz")
    np.savez(path, **{k: v.numpy() for k, v in sd.items()})
    with pytest.raises(ValueError, match="enc_score_head"):
        _detector(path)


def test_variants_are_reached_by_name():
    from facedet_tpu_torch.apps.common import base_parser, build_detector
    from facedet_tpu_torch.utils.config import DetectorConfig

    m = build_detector(DetectorConfig(family="rtdetr", variant=TINY, dtype="float32"), device="cpu")
    assert type(m) is RtDetrDetectionModel and isinstance(m.model, RtDetrL) and m.published
    assert m.model.model[28].num_queries == 30
    assert build_detector(DetectorConfig(family="rtdetr"), device="cpu").variant == "rtdetr-l"
    assert base_parser("x").parse_args(["--family", "rtdetr", "--variant", "rtdetr-l-hgnetv2"]).variant == \
        "rtdetr-l-hgnetv2"
    with pytest.raises(ValueError, match="unknown RT-DETR variant"):
        RtDetrDetectionModel(variant="rtdetr-x-hgnetv2", device="cpu")


# --- int8 --------------------------------------------------------------------------------


@pytest.mark.parametrize("act", ["relu", True, False])
def test_int8_shell_keeps_the_activation(act):
    torch.manual_seed(0)
    m = ConvBnAct(8, 16, 3, act=act).eval()
    with torch.no_grad():
        m.bn.running_mean.uniform_(-0.2, 0.2)
        m.bn.running_var.uniform_(0.5, 1.5)
    x = torch.randn(2, 8, 12, 12)
    q = Q.quantize_layer(m, float(x.abs().max()))
    assert isinstance(q, Int8ConvBnAct) and q.act == act
    with torch.no_grad():
        got, want = q(x), m(x)
    assert (got - want).abs().max() < 0.05 * want.abs().max()
    if act == "relu":
        assert (got >= 0).all() and (got == 0).float().mean() > 0.2
        shell = Int8ConvBnAct(8, 16, 3, act=False)
        shell.load_state_dict(q.state_dict())
        with torch.no_grad():
            assert torch.equal(got, F.relu(shell(x)))


def test_quantize_detector_takes_the_relu_conv_stack(tiny_path):
    det = _detector(tiny_path, image_size=128)
    n = Q.quantize_detector(det, n_calib=1)
    int8 = {name: m for name, m in det.model.named_modules() if isinstance(m, Int8ConvBnAct)}
    assert n == len(int8) > 20
    assert not any(name.startswith(("model.0.", "model.28.")) for name in int8)  # the stem and the decoder kept
    assert {m.act for m in int8.values()} == {"relu", True, False}
    assert all(m.groups == 1 for m in int8.values())  # depthwise convs kept
    with torch.inference_mode():
        out = det.tile_forward_nchw(_photos(1, 128), 0.3)
    assert torch.isfinite(out.scores).all() and out.boxes.shape == (1, 30, 4)


# --- the CUDA graph's counters -----------------------------------------------------------


def test_forward_graphs_add_the_callers_counts():
    graphs = ForwardGraphs(capture=lambda pre, tiles: (_ for _ in ()).throw(RuntimeError("no capture")))
    SPANS.ring.clear()
    graphs(object(), lambda x: 2 * x, torch.ones(2), graph_key(torch.ones(1, 3, 8, 8), 0.3, 300), lambda o: o.clone(),
           counts={"deform_samples": 12})
    graphs(object(), lambda x: 2 * x, torch.ones(2), None, lambda o: o.clone())
    assert [s.counts for s in SPANS.spans() if s.name == "detector"] == [
        {"deform_samples": 12, "graph_eager": 1}, {"graph_eager": 1}]


# --- the card ----------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [6, 1])
def test_replay_is_bitwise_the_eager_chain(cuda, batch, monkeypatch):
    """The published RT-DETR-l on its benchmark weights, bfloat16, at 640:
    captured once, replayed twice, each equal to the eager chain."""
    cell = harness.cell("rtdetr-l.single_rgb")
    det = harness.family("rtdetr").program(cell.config, cuda)
    x = [_photos(batch, 640, seed=s).to(cuda, torch.bfloat16) for s in (1, 50)]
    SPANS.ring.clear()
    got = [det.tile_forward_nchw(t, 0.05).map(torch.clone) for t in (x[0], x[1], x[0])]
    torch.cuda.synchronize()
    counts = [s.counts for s in SPANS.spans() if s.name == "detector"]
    samples, e = batch * 300 * 8 * 3 * 4 * 6, _epilogues(det.model)
    assert e == 119 + 3  # every ConvBnAct and ProjBn of the published model, through the kernel
    assert counts == [{"deform_samples": samples, "graph_captures": 1, "epilogue_kernel": e}] + [
        {"deform_samples": samples, "graph_replays": 1, "epilogue_kernel": e}] * 2
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    want = [det.tile_forward_nchw(t, 0.05) for t in x]
    for g, w in zip(got, want + want[:1]):
        assert all(torch.equal(getattr(g, f), getattr(w, f)) for f in FIELDS)
    assert int(want[0].valid.sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [6, 1])
def test_bfloat16_on_the_card_against_the_float32_reference(cuda, batch):
    cell = harness.cell("rtdetr-l.single_rgb")
    fam = harness.family("rtdetr")
    net = bench_plain.RtDetrL(weights.tensors(weights.arrays(cell.config["detector"]["weights"], ROOT, fam.draw), cuda))
    x = _photos(batch, 640, seed=7).to(cuda)
    with torch.inference_mode(), exact_float32():
        want = net(x)
    gaps = {}
    for kind in ("bfloat16", "int8"):
        det = fam.program(cell.config, cuda, int8=kind == "int8")
        with torch.inference_mode():
            got = det.model.forward_nchw(x.to(torch.bfloat16), top_idx=want["top_idx"])
        d = got["logits"][0] - want["logits"]
        gaps[kind] = (float(d.abs().max()), float(d.square().mean().sqrt()),
                      float((got["boxes"][0] - want["boxes"]).abs().max()))
        del det
    limits = (0.6, 0.18, 0.006)
    assert all(g < lim for g, lim in zip(gaps["bfloat16"], limits)), gaps
    assert any(g >= lim for g, lim in zip(gaps["int8"], limits)), gaps
    assert float(want["logits"].std()) > 0.5
