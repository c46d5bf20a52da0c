"""ConvBnAct's inference epilogue (ops/kernels/bn_act.py, csrc/bn_act.cu): the
float32 BatchNorm, the cast and the activation in one CUDA pass, and the
counters that say how often the detector's forward took it.

On the CPU: ``ConvBnAct`` and ``ProjBn`` run the chain they ran before the
kernel, bit for bit, in eval and in train mode; ``SPANS.add`` and
``SPANS.tally``; the ``detector`` span's ``epilogue_kernel`` /
``epilogue_plain`` counts, eager and through a capture and its replays, with a
stub in place of the kernel; the kernel's closed-form backward against the
chain's autograd, with the launch stubbed; a CPU trace records the chain. The
tests marked ``cuda`` skip where torch sees no card; on the card the kernel is
held against its plain version at the main path's shapes, and its backward
against the chain's, also through the perceptual loss's frozen backbone. This file imports neither jax nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_bn_act.py

The kernel's tolerance against the plain version: none for NCHW input, which
is what the convs hand back. The kernel rounds the affine as cuDNN's float32
NCHW BatchNorm does (``fma((x - mean) * weight, rsqrt(var + eps), bias)``),
and the cast and activations as PyTorch's CUDA kernels do, so the two agree bit
for bit. For channels-last input cuDNN runs another kernel, which rounds the
affine in another order (no order of float32 operations tried on the card
matched it): the kernel then equals the plain version of the same values in
NCHW bit for bit, and the channels-last plain version within 2^-20 of the
affine's terms in float32 and, after the cast to bfloat16, within one bfloat16
ulp on at most 1% of the elements. The main path meets one channels-last conv
output: RT-DETR-l's ``model.12`` at a batch of tiles.

The backward's tolerance against the chain's autograd: each gradient within
2^-20 of its largest magnitude. The closed form multiplies ``weight * inv``
once per channel and sums ``dweight`` and ``dbias`` in float32 in another
order than PyTorch's BatchNorm backward; a gradient cast to bfloat16 mostly
comes out equal.
"""
import copy
import os
import threading

import numpy as np
import pytest
import torch

from facedet_tpu_torch import YoloV11PoseDetectionModel
from facedet_tpu_torch.engine.detector import ForwardGraphs, graph_key
from facedet_tpu_torch.engine.rtdetr_wrapper import RtDetrDetectionModel
from facedet_tpu_torch.models import layers
from facedet_tpu_torch.models import quantize as Q
from facedet_tpu_torch.models import rtdetr_l
from facedet_tpu_torch.models.layers import ConvBnAct, Int8ConvBnAct
from facedet_tpu_torch.models.rtdetr_l import ProjBn
from facedet_tpu_torch.ops.kernels import bn_act as K
from facedet_tpu_torch.utils.profiling import SPANS, SpanRecorder
from facedet_tpu_torch.utils.synth import synthetic_faces

torch.set_num_threads(1)

CKPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "facedet_tpu", "eval", "assets", "yolo11n_golden.npz")
ACTS = [True, "relu", False]
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _randomize_bn(bn, seed):
    """BatchNorm statistics and affine drawn wide: variances over six orders of
    magnitude, so the rsqrt and the cancellation in the affine both matter."""
    g = torch.Generator().manual_seed(seed)
    c = bn.num_features
    with torch.no_grad():
        bn.weight.copy_(1 + 0.3 * torch.randn(c, generator=g))
        bn.bias.copy_(0.5 * torch.randn(c, generator=g))
        bn.running_mean.copy_(torch.randn(c, generator=g))
        bn.running_var.copy_(torch.exp(2 * torch.randn(c, generator=g)))
    return bn


def _conv_bn_act(conv_dtype, bn_dtype, act, cin=8, cout=16, seed=0):
    m = ConvBnAct(cin, cout, 3, act=act)
    torch.manual_seed(seed)
    _randomize_bn(m.bn, seed)
    m.conv.to(conv_dtype)
    m.bn_dtype = bn_dtype
    return m


def _chain(m, x):
    """ConvBnAct's forward as it was before the kernel."""
    y = m.conv(x.to(m.conv.weight.dtype))
    return K.activate(m.bn(y.float()).to(m.bn_dtype), m.act)


def _input(n, c, h, w, layout="nchw", seed=1):
    x = torch.randn(n, c, h, w, generator=torch.Generator().manual_seed(seed)) * 2
    return x.contiguous(memory_format=torch.channels_last) if layout == "channels_last" else x


# --- CPU: the plain chain --------------------------------------------------------------


@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("bn_dtype", sorted(DTYPES))
@pytest.mark.parametrize("conv_dtype", sorted(DTYPES))
def test_cpu_eval_epilogue_is_the_chain_bitwise(conv_dtype, bn_dtype, act, layout):
    m = _conv_bn_act(DTYPES[conv_dtype], DTYPES[bn_dtype], act).eval()
    x = _input(2, 8, 12, 10, layout)
    launches = K.LAUNCHES["bn_act"]
    with torch.inference_mode():
        got, want = m(x), _chain(m, x)
    assert got.dtype == DTYPES[bn_dtype] and torch.equal(got, want)
    assert K.LAUNCHES["bn_act"] == launches


@pytest.mark.parametrize("act", ACTS)
def test_cpu_train_epilogue_is_the_chain_bitwise(act):
    """Train mode keeps flax's batch statistics and moves the running ones as
    before, on any device; the gradient flows as before."""
    m = _conv_bn_act(torch.float32, torch.float32, act).train()
    twin = copy.deepcopy(m)
    x = _input(2, 8, 12, 10)
    got, want = m(x), _chain(twin, x)
    assert torch.equal(got, want)
    assert torch.equal(m.bn.running_mean, twin.bn.running_mean)
    assert torch.equal(m.bn.running_var, twin.bn.running_var)
    got.square().sum().backward()
    want.square().sum().backward()
    assert torch.equal(m.conv.weight.grad, twin.conv.weight.grad)
    assert torch.equal(m.bn.weight.grad, twin.bn.weight.grad)


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_cpu_projbn_is_the_chain_bitwise(mode):
    m = ProjBn(8, 16)
    _randomize_bn(m[1], 3)
    m[0].to(torch.bfloat16)
    m.train(mode == "train")
    twin = copy.deepcopy(m)
    x = _input(2, 8, 12, 10)
    got = m(x)
    want = twin[1](twin[0](x.to(torch.bfloat16)).float())
    assert got.dtype == torch.float32 and torch.equal(got, want)


def test_the_wrapper_takes_the_plain_version_off_the_card():
    bn = _randomize_bn(layers.FlaxBatchNorm2d(16, eps=1e-3), 4).eval()
    x = _input(2, 16, 6, 6).to(torch.bfloat16)
    launches = K.LAUNCHES["bn_act"]
    with SPANS.tally() as counts:
        got = K.bn_act(x, bn, torch.bfloat16, True)
    assert torch.equal(got, K.bn_act_ref(x, bn, torch.bfloat16, True))
    assert counts == {"epilogue_plain": 1} and K.LAUNCHES["bn_act"] == launches


def _chain_launch(x, weight, bias, mean, var, eps, out_dtype, act):
    """``_launch``'s stand-in on the CPU: the chain's values."""
    t = torch.nn.functional.batch_norm(x.float(), mean, var, weight, bias, False, 0.0, eps)
    return K.activate(t.to(out_dtype), act)


def _assert_grads_close(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert bool(((g.float() - w.float()).abs() <= 2.0 ** -20 * w.float().abs().max()).all())


def _grads(run, x, bn, g):
    """Gradients of ``sum(run() * g)`` by x and the BatchNorm's affine."""
    x, y = x.detach().requires_grad_(), None
    bn.zero_grad(set_to_none=True)
    y = run(x)
    y.backward(g)
    return y, (x.grad, bn.weight.grad, bn.bias.grad)


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_the_backward_is_the_chains(dtype, act, monkeypatch):
    """``_BnAct``'s closed form against the chain's autograd, x and affine."""
    monkeypatch.setattr(K, "_launch", _chain_launch)
    dt = DTYPES[dtype]
    bn = _randomize_bn(layers.FlaxBatchNorm2d(16, eps=1e-3), 11).eval()
    x = _input(2, 16, 6, 7, seed=12).to(dt)
    g = _input(2, 16, 6, 7, seed=13).to(dt)
    args = (bn.weight, bn.bias, bn.running_mean, bn.running_var, bn.eps, dt, act)
    y, got = _grads(lambda v: K._BnAct.apply(v, *args), x, bn, g)
    y_ref, want = _grads(lambda v: K.bn_act_ref(v, bn, dt, act), x, bn, g)
    assert torch.equal(y, y_ref)
    assert torch.equal(got[0], want[0]) or dt == torch.float32
    _assert_grads_close(got, want)


def test_the_backward_gives_only_what_is_asked(monkeypatch):
    """A frozen BatchNorm (the perceptual loss's) gets no gradient, and an
    input that needs none gets none."""
    monkeypatch.setattr(K, "_launch", _chain_launch)
    bn = _randomize_bn(layers.FlaxBatchNorm2d(8, eps=1e-3), 14).eval().requires_grad_(False)
    x = _input(1, 8, 4, 4).requires_grad_()
    K._BnAct.apply(x, bn.weight, bn.bias, bn.running_mean, bn.running_var, bn.eps, torch.float32, True).sum().backward()
    assert x.grad is not None and bn.weight.grad is None and bn.bias.grad is None
    bn.requires_grad_(True)
    x = _input(1, 8, 4, 4)
    K._BnAct.apply(x, bn.weight, bn.bias, bn.running_mean, bn.running_var, bn.eps, torch.float32, "relu").sum().backward()
    assert x.grad is None and bn.weight.grad is not None and bn.bias.grad is not None


def test_a_cpu_trace_records_the_plain_chain():
    """The ONNX export traces on the CPU, where ``ConvBnAct`` runs PyTorch
    ops: the trace holds the BatchNorm and answers as the module does."""
    m = _conv_bn_act(torch.float32, torch.float32, True).eval()
    x = _input(2, 8, 12, 10)
    with torch.no_grad():
        traced = torch.jit.trace(m, x)
        assert "aten::batch_norm" in str(traced.inlined_graph)
        assert torch.equal(traced(x), m(x))


# --- CPU: the counters -----------------------------------------------------------------


def test_add_counts_into_the_innermost_span_or_tally():
    rec = SpanRecorder()
    rec.add("lost")  # no span open: nothing
    with rec.span("request") as root:
        rec.add("a")
        with rec.span("detector") as det:
            rec.add("a", 2)
            with rec.tally() as outer:
                rec.add("b")
                with rec.tally() as inner:
                    rec.add("b", 5)
                rec.add("c")
            rec.add("d")
        seen = []
        worker = threading.Thread(target=lambda: (rec.add("other"), seen.append(rec._tallies.get(threading.get_ident()))))
        with rec.tally() as mine:
            worker.start()
            worker.join(timeout=30)
    assert not worker.is_alive() and seen == [None]
    assert root.counts == {"a": 1} and det.counts == {"a": 2, "d": 1}
    assert outer == {"b": 1, "c": 1} and inner == {"b": 5} and mine == {}
    assert rec._tallies == {} and [s.name for s in rec.spans()] == ["detector", "request"]


def _fake_kernel(x, bn, out_dtype, act):
    """The wrapper's stand-in on the CPU: the plain version's values, counted
    as the kernel counts."""
    with SPANS.tally():
        y = K.bn_act_ref(x, bn, out_dtype, act)
    SPANS.add("epilogue_kernel")
    return y


class _ReplayGraph:
    """A capture's stand-in that counts as a CUDA graph does: the counts of
    the captured run are the graph's; a replay recomputes the output with no
    count of its own, for no Python runs in a real replay."""

    def __init__(self, pre, tiles):
        self.pre, self.tiles = pre, tiles.clone()
        pre(self.tiles)  # the warm-up
        with SPANS.tally() as self.counts:
            self.out = pre(self.tiles)

    def __call__(self, tiles):
        self.tiles.copy_(tiles)
        with SPANS.tally():
            self.out = self.pre(self.tiles)
        return self.out


def _detector(family):
    if family == "yolo11n":
        return YoloV11PoseDetectionModel(model_path=CKPT, scale="n", dtype="float32", confidence_threshold=0.25,
                                         image_size=128, device="cpu")
    return RtDetrDetectionModel(variant="rtdetr-l-hgnetv2-tiny", dtype="float32", confidence_threshold=0.3,
                                image_size=128, device="cpu")


def _epilogues(model):
    return sum(isinstance(m, (ConvBnAct, ProjBn)) for m in model.modules())


def _tiles(n, size=128, seed=0):
    arr = np.stack([synthetic_faces(size, size, seed=seed + i, n=1, size=(40, 60)) for i in range(n)])
    return torch.from_numpy(arr).permute(0, 3, 1, 2).contiguous().float() / 255.0


@pytest.mark.parametrize("family", ["yolo11n", "rtdetr-l-tiny"])
def test_the_detector_span_counts_each_epilogue_once(family, monkeypatch):
    det = _detector(family)
    n = _epilogues(det.model)
    assert n == (87 if family == "yolo11n" else 3 + sum(isinstance(m, ConvBnAct) for m in det.model.modules()))
    tiles = _tiles(2)
    SPANS.ring.clear()
    det.tile_forward_nchw(tiles, 0.25)  # the plain version on the CPU
    monkeypatch.setattr(layers, "bn_act", _fake_kernel)
    monkeypatch.setattr(rtdetr_l, "bn_act", _fake_kernel)
    det.tile_forward_nchw(tiles, 0.25)  # eager, through the stand-in
    # a capture and two replays of the same chain
    graphs = ForwardGraphs(capture=_ReplayGraph)
    key = graph_key(tiles, 0.25, 300)
    with torch.inference_mode():
        for _ in range(3):
            graphs(det.model, det.model.forward_nchw, tiles, key, lambda out: out)
    counts = [s.counts for s in SPANS.spans() if s.name == "detector"]
    extra = {"deform_samples": det.deform_samples(2)} if family != "yolo11n" else {}
    assert counts == [{"graph_eager": 1, "epilogue_plain": n, **extra}, {"graph_eager": 1, "epilogue_kernel": n, **extra},
                      {"graph_captures": 1, "epilogue_kernel": n}, {"graph_replays": 1, "epilogue_kernel": n},
                      {"graph_replays": 1, "epilogue_kernel": n}]


def test_int8_layers_count_their_epilogues_as_plain(monkeypatch):
    """The check's control: ``quantize_detector``'s ``Int8ConvBnAct`` run
    their folded BatchNorm through PyTorch ops; the ``ConvBnAct`` it keeps
    take the kernel."""
    det = _detector("yolo11n")
    Q.quantize_detector(det, n_calib=1)
    int8 = sum(isinstance(m, Int8ConvBnAct) for m in det.model.modules())
    kept = sum(isinstance(m, ConvBnAct) for m in det.model.modules())
    assert int8 > 10 and int8 + kept == 87
    monkeypatch.setattr(layers, "bn_act", _fake_kernel)
    SPANS.ring.clear()
    det.tile_forward_nchw(_tiles(1), 0.25)
    counts = [s.counts for s in SPANS.spans() if s.name == "detector"]
    assert counts == [{"graph_eager": 1, "epilogue_plain": int8, **({"epilogue_kernel": kept} if kept else {})}]


# --- the card --------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _bits(t):
    return t.contiguous().view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def _assert_within_a_bf16_ulp(got, want):
    """At most one bfloat16 ulp apart, on at most 1% of the elements."""
    assert got.dtype == want.dtype == torch.bfloat16 and got.shape == want.shape
    g, w = got.float(), want.float()
    ulp = torch.where(w == 0, torch.full_like(w, 2.0 ** -133), 2.0 ** (torch.floor(torch.log2(w.abs())) - 7))
    assert bool(((g - w).abs() <= ulp).all())
    assert float((_bits(got) != _bits(want)).float().mean()) <= 0.01


def _assert_bitwise(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    same = _bits(got) == _bits(want)
    assert bool(same.all()), f"{int((~same).sum())} of {same.numel()} elements differ"


def _conv_outputs(det, batch, seed):
    """(name, module, its conv's output) of every ``ConvBnAct`` and ``ProjBn``
    of ``det``'s model, in forward order, on ``batch`` 640² tiles of a
    synthetic photo."""
    model, found = det.model, []

    def hook(name, owner):
        return lambda _m, _args, out: found.append((name, owner, out.clone()))

    handles = [(m.conv if isinstance(m, ConvBnAct) else m[0]).register_forward_hook(hook(name, m))
               for name, m in model.named_modules() if isinstance(m, (ConvBnAct, ProjBn))]
    arr = np.stack([synthetic_faces(640, 640, seed=seed + i, n=3, size=(50, 140)) for i in range(batch)])
    # NCHW-contiguous, as the tile gather hands the tiles over
    x = torch.from_numpy(arr).permute(0, 3, 1, 2).contiguous().to(det.device, torch.bfloat16) / 255.0
    try:
        with torch.inference_mode():
            model.forward_nchw(x)
    finally:
        for h in handles:
            h.remove()
    return found


def _main_path_detector(family, device):
    if family == "yolo11n":
        return YoloV11PoseDetectionModel(model_path=CKPT, scale="n", image_size=640, confidence_threshold=0.3,
                                         dtype="bfloat16", device=device)
    from port_bench import harness

    cell = harness.cell("rtdetr-l.single_rgb")
    return harness.family("rtdetr").program(cell.config, device)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [6, 1])
@pytest.mark.parametrize("family", ["yolo11n", "rtdetr-l"])
def test_kernel_is_the_plain_version_at_the_main_paths_shapes(cuda, family, batch):
    """Every epilogue of the benchmark's detector (YOLO11n: 87 ``ConvBnAct``;
    RT-DETR-l: the stem, the light and plain HGBlocks, the neck's, the three
    ``ProjBn``), on its own conv's output, bfloat16 in. One conv output is
    channels-last: RT-DETR-l's ``model.12`` at a batch of tiles, fed by AIFI's
    transposed tokens; there the kernel gives the NCHW answer and differs from
    cuDNN's channels-last BatchNorm as the module docstring states."""
    det = _main_path_detector(family, cuda)
    found = _conv_outputs(det, batch, seed=7)
    assert len(found) == (87 if family == "yolo11n" else 122)
    shapes, channels_last = set(), []
    with torch.inference_mode():
        for name, m, y in found:
            assert y.dtype == torch.bfloat16
            bn, out_dtype, act = (m.bn, m.bn_dtype, m.act) if isinstance(m, ConvBnAct) else (m[1], torch.float32, False)
            got = K.bn_act(y, bn, out_dtype, act)
            if y.is_contiguous():
                _assert_bitwise(got, K.bn_act_ref(y, bn, out_dtype, act))
            else:
                channels_last.append(name)
                _assert_bitwise(got, K.bn_act_ref(y.contiguous(), bn, out_dtype, act))
                _assert_within_a_bf16_ulp(got, K.bn_act_ref(y, bn, out_dtype, act))
            shapes.add(tuple(y.shape[1:]))
    assert len(shapes) > 10
    assert channels_last == (["model.12"] if family == "rtdetr-l" and batch > 1 else [])


SHAPES = {
    "packed": (6, 64, 40, 40),  # 16-byte packs, one channel each
    "odd_plane": (2, 24, 7, 9),  # a plane of 63: single elements in NCHW, packs of 8 channels channels-last
    "odd_all": (3, 13, 5, 5),
    "one_pixel": (4, 32, 1, 1),
}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("out_dtype", sorted(DTYPES))
@pytest.mark.parametrize("in_dtype", sorted(DTYPES))
def test_kernel_is_the_plain_version_in_every_dtype(cuda, in_dtype, out_dtype, act, shape):
    bn = _randomize_bn(layers.FlaxBatchNorm2d(SHAPES[shape][1], eps=1e-3), 5).to(cuda).eval()
    x = _input(*SHAPES[shape], seed=9).to(cuda, DTYPES[in_dtype])
    with torch.inference_mode():
        got = K.bn_act(x, bn, DTYPES[out_dtype], act)
        want = K.bn_act_ref(x, bn, DTYPES[out_dtype], act)
        # a contiguous view that starts off a pack's alignment
        flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda)
        shifted = flat[1:].view(x.shape).copy_(x)
        off = K.bn_act(shifted, bn, DTYPES[out_dtype], act)
    _assert_bitwise(got, want)
    _assert_bitwise(off, want)
    assert got.is_contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("dtypes", ["bfloat16-bfloat16", "float32-float32", "bfloat16-float32"])
@pytest.mark.parametrize("shape", ["packed", "odd_plane", "odd_all"])
def test_channels_last_kernel_is_its_nchw_answer(cuda, dtypes, act, shape):
    in_dtype, out_dtype = (DTYPES[d] for d in dtypes.split("-"))
    bn = _randomize_bn(layers.FlaxBatchNorm2d(SHAPES[shape][1], eps=1e-3), 6).to(cuda).eval()
    x = _input(*SHAPES[shape], seed=10).to(cuda, in_dtype)
    xl = x.contiguous(memory_format=torch.channels_last)
    with torch.inference_mode():
        got = K.bn_act(xl, bn, out_dtype, act)
        nchw = K.bn_act_ref(x, bn, out_dtype, act)
        cudnn_nhwc = K.bn_act_ref(xl, bn, out_dtype, act)
    assert got.is_contiguous(memory_format=torch.channels_last)
    _assert_bitwise(got, nchw)
    # cuDNN's own channels-last kernel: the affine's float32 rounding apart
    if out_dtype == torch.bfloat16:
        _assert_within_a_bf16_ulp(got, cudnn_nhwc)
    else:
        # (|x| + |mean|) |weight| / sqrt(var + eps) + |bias| bounds the terms either order rounds (x * scale and
        # mean * scale apart in cuDNN's), each reciprocal square root within 2 ulp; SiLU's slope is at most 1.1
        scale = (bn.weight.abs() * torch.rsqrt(bn.running_var + bn.eps))[None, :, None, None]
        terms = (x.float().abs() + bn.running_mean.abs()[None, :, None, None]) * scale + bn.bias.abs()[None, :, None, None]
        assert bool(((got - cudnn_nhwc).abs() <= 2.0 ** -20 * terms).all())


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda):
    bn = layers.FlaxBatchNorm2d(16, eps=1e-3).to(cuda).eval()
    x = torch.randn(2, 16, 8, 8, device=cuda, dtype=torch.bfloat16)
    with torch.inference_mode():
        with pytest.raises(ValueError, match="contiguous"):
            K.bn_act(x[:, :, ::2], bn, torch.bfloat16, True)
        with pytest.raises(ValueError, match="contiguous"):
            K.bn_act(x.transpose(2, 3), bn, torch.bfloat16, True)
        with pytest.raises(ValueError, match="rank 4"):
            K.bn_act(x[0], bn, torch.bfloat16, True)
        with pytest.raises(TypeError):
            K.bn_act(x.half(), bn, torch.bfloat16, True)
        with pytest.raises(TypeError):
            K.bn_act(x, bn, torch.float16, True)
        with pytest.raises(ValueError, match="float32"):
            K.bn_act(torch.randn(2, 8, 8, 8, device=cuda), bn, torch.float32, True)
    with pytest.raises(ValueError, match="eval-mode"):
        K.bn_act(x, bn.train(), torch.bfloat16, True)


@pytest.mark.cuda
def test_a_trace_on_the_card_is_refused(cuda):
    """A trace cannot see inside the kernel, so it is refused, with the way
    out in the message, rather than recording other ops than the module runs."""
    m = _conv_bn_act(torch.bfloat16, torch.bfloat16, True).to(cuda).eval()
    x = _input(2, 8, 32, 32).to(cuda)
    launches = K.LAUNCHES["bn_act"]
    with torch.no_grad(), pytest.raises(RuntimeError, match="trace the model on the CPU"):
        torch.jit.trace(m, x, check_trace=False)
    assert K.LAUNCHES["bn_act"] == launches


@pytest.mark.cuda
def test_launches_are_counted_and_the_module_takes_the_kernel(cuda):
    m = _conv_bn_act(torch.bfloat16, torch.bfloat16, True).to(cuda).eval()
    x = _input(2, 8, 32, 32).to(cuda)
    launches = K.LAUNCHES["bn_act"]
    with torch.inference_mode(), SPANS.tally() as counts:
        got = m(x)
    want = _chain(m, x)
    torch.cuda.synchronize()
    _assert_bitwise(got, want)
    assert K.LAUNCHES["bn_act"] == launches + 1 and counts == {"epilogue_kernel": 1}
    # a gradient to record: the kernel, with the closed-form backward
    with SPANS.tally() as counts:
        got = m(x)
    got.float().sum().backward()
    assert type(got.grad_fn).__name__ == "_BnActBackward" and m.conv.weight.grad is not None
    assert K.LAUNCHES["bn_act"] == launches + 2 and counts == {"epilogue_kernel": 1}
    m.train()
    with torch.no_grad(), SPANS.tally() as counts:
        m(x)
    assert K.LAUNCHES["bn_act"] == launches + 2 and counts == {"epilogue_plain": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_the_backward_on_the_card_is_the_chains(cuda, dtype, act, layout):
    dt = DTYPES[dtype]
    bn = _randomize_bn(layers.FlaxBatchNorm2d(32, eps=1e-3), 15).to(cuda).eval()
    x = _input(3, 32, 20, 20, layout, seed=16).to(cuda, dt)
    g = _input(3, 32, 20, 20, layout, seed=17).to(cuda, dt)
    launches = K.LAUNCHES["bn_act"]
    y, got = _grads(lambda v: K.bn_act(v, bn, dt, act), x, bn, g)
    assert K.LAUNCHES["bn_act"] == launches + 1
    # the chain on the same values in NCHW, which the kernel answers bit for bit
    y_ref, want = _grads(lambda v: K.bn_act_ref(v, bn, dt, act), x.contiguous(), bn, g.contiguous())
    _assert_bitwise(y, y_ref)
    _assert_grads_close(got, want)


@pytest.mark.cuda
def test_the_perceptual_loss_takes_the_kernel(cuda, monkeypatch):
    """The SR GAN's perceptual loss differentiates the frozen eval-mode YOLO
    backbone on generator outputs: every ``ConvBnAct`` of it launches the
    kernel, and the image's gradient is the chain's."""
    from facedet_tpu_torch.train.perceptual import make_yolo_feature_loss

    loss = make_yolo_feature_loss(device=cuda)
    gen = torch.Generator().manual_seed(18)
    a = torch.rand(2, 128, 128, 3, generator=gen).to(cuda)
    b = torch.rand(2, 128, 128, 3, generator=gen).to(cuda)

    def grad():
        x = a.clone().requires_grad_()
        loss(x, b).backward()
        return x.grad

    # the convs' own backward fixed, so that the epilogues alone differ
    with torch.backends.cudnn.flags(enabled=True, deterministic=True, allow_tf32=False):
        launches = K.LAUNCHES["bn_act"]
        got = grad()
        assert K.LAUNCHES["bn_act"] - launches == 2 * 21  # the 21 epilogues up to c3k2_2, for a and for b
        launches = K.LAUNCHES["bn_act"]
        monkeypatch.setattr(layers, "bn_act", K.bn_act_ref)
        want = grad()
    assert K.LAUNCHES["bn_act"] == launches
    err = float((got - want).norm() / want.norm())
    assert err <= 1e-5, err


@pytest.mark.cuda
def test_a_call_on_another_card_leaves_the_current_device(cuda):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs")
    other = torch.device("cuda", 1)
    bn = _randomize_bn(layers.FlaxBatchNorm2d(16, eps=1e-3), 19).to(other).eval()
    x = _input(2, 16, 8, 8, seed=20).to(other, torch.bfloat16)
    torch.cuda.set_device(0)
    with torch.inference_mode():
        got = K.bn_act(x, bn, torch.bfloat16, True)
        want = K.bn_act_ref(x, bn, torch.bfloat16, True)
    assert torch.cuda.current_device() == 0 and got.device == other
    _assert_bitwise(got, want)
