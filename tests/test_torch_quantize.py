"""The port's int8 post-training quantization (facedet_tpu_torch/models/
quantize.py, ``Int8ConvBnAct`` in models/layers.py) against the JAX
package's (facedet_tpu/models/quantize.py, ``ConvBnAct._int8_forward``) on
the CPU: the counterparts of tests/test_quantize.py's cases, and the
quantized golden yolo11n.

Tolerances, each with its reason:
- ``qkernel``, ``ascale``, ``oscale``, ``obias`` bit-equal given one absmax
  dict (the same numpy float32 expressions); the quantized-conv count and
  the calibrated scopes equal; calibrated absmax within 1e-5 relative (the
  float convs before each layer sum in another order);
- int32 accumulators equal to an int64 product, exactly;
- one int8 layer given the same input: every activation level equal (0
  differ), outputs within 1e-5 of the layer's largest (the float32
  epilogue and SiLU round alike up to an ulp);
- the whole quantized detector: see test_golden_int8_sliced_prediction.
"""
import os

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facedet_tpu.engine.detector import YoloV11PoseDetectionModel as JaxModel
from facedet_tpu.engine.detector import load_params_npz as jax_load_params_npz
from facedet_tpu.engine.predict import get_sliced_prediction as jax_get_sliced_prediction
from facedet_tpu.models import quantize as JQ
from facedet_tpu.models.layers import ConvBnAct as JaxConvBnAct
from facedet_tpu.models.yolov11 import YoloConfig as JaxYoloConfig
from facedet_tpu.models.yolov11 import YoloV11 as JaxYoloV11
from facedet_tpu_torch import YoloV11PoseDetectionModel, get_sliced_prediction
from facedet_tpu_torch.engine.detector import save_params_npz
from facedet_tpu_torch.eval.gates import int8_gate, section2_gate
from facedet_tpu_torch.models import quantize as Q
from facedet_tpu_torch.models.from_jax import from_jax_variables, load_jax_variables, to_jax_variables
from facedet_tpu_torch.models.layers import ConvBnAct, Int8ConvBnAct, int8_matmul
from facedet_tpu_torch.models.yolov11 import YoloConfig, YoloV11
from facedet_tpu_torch.utils.synth import synthetic_faces

torch.set_num_threads(1)

CKPT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "facedet_tpu", "eval", "assets", "yolo11n_golden.npz",
)
SIZE = 256  # _natural_tile's octaves need a multiple of 128
SLICED = dict(
    slice_height=SIZE, slice_width=SIZE, overlap_height_ratio=0.2, overlap_width_ratio=0.2,
    perform_standard_pred=True, postprocess_type="GREEDYNMM", postprocess_match_metric="IOS",
    postprocess_match_threshold=0.5,
)


def _trained_ish_cba(seed, cin=16, cout=24, kernel=3, groups=1):
    """A ConvBnAct variables tree with non-trivial BN stats (as if trained),
    numpy float32."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {
        "params": {
            "conv": {"kernel": f(kernel, kernel, cin // groups, cout) * np.float32(0.2)},
            "bn": {"scale": 1 + np.float32(0.3) * f(cout), "bias": np.float32(0.2) * f(cout)},
        },
        "batch_stats": {"bn": {"mean": np.float32(0.3) * f(cout), "var": np.exp(np.float32(0.5) * f(cout))}},
    }


def _port_cba(variables, cin, cout, kernel, stride=1, groups=1):
    m = ConvBnAct(cin, cout, kernel, stride, groups)
    load_jax_variables(m, variables)
    return m.eval()


def _levels_jax(x_nhwc, ascale):
    """The reference's quantization of a layer input (layers.py:99-101),
    jitted with ``ascale`` a runtime argument as in the layer."""
    return np.asarray(jax.jit(lambda x, a: jnp.clip(jnp.round(x.astype(jnp.float32) / a), -127.0, 127.0))(
        jnp.asarray(x_nhwc), jnp.float32(ascale)))


def _levels_port(x_nchw, layer):
    q = torch.clamp(torch.round(x_nchw.float() / layer.ascale), -127, 127)
    return q.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("kernel,stride,groups", [(3, 1, 1), (3, 2, 1), (1, 1, 1), (3, 1, 2)])
def test_single_cba_int8_matches_manual_math_and_jax(kernel, stride, groups):
    """The int8 layer computes exactly round/clip -> int conv -> affine ->
    SiLU, and JAX's int8 layer on the same input and tree (a grouped conv
    that is not depthwise is quantized too, as in the reference)."""
    variables = _trained_ish_cba(0, kernel=kernel, groups=groups)
    x = (np.random.default_rng(1).standard_normal((2, 8, 8, 16)) * 1.7).astype(np.float32)
    absmax = float(np.abs(x).max())
    qvars = JQ.quantize_variables(variables, {(): absmax}, exclude=())
    layer = Q.quantize_layer(_port_cba(variables, 16, 24, kernel, stride, groups), absmax)
    got = layer(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()

    p = qvars["params"]
    xq = np.clip(np.round(x / p["ascale"]), -127, 127).astype(np.int64)
    pad = kernel // 2
    xp = np.pad(xq, ((0, 0), (pad, pad), (pad, pad), (0, 0)))
    ho = (8 + 2 * pad - kernel) // stride + 1
    acc = np.zeros((2, ho, ho, 24), np.int64)
    cg, ng = 16 // groups, 24 // groups
    for dy in range(kernel):
        for dx in range(kernel):
            win = xp[:, dy : dy + stride * (ho - 1) + 1 : stride, dx : dx + stride * (ho - 1) + 1 : stride]
            for g in range(groups):
                acc[..., g * ng : (g + 1) * ng] += (
                    win[..., g * cg : (g + 1) * cg] @ p["qkernel"][dy, dx, :, g * ng : (g + 1) * ng].astype(np.int64))
    want = acc.astype(np.float32) * p["oscale"] + p["obias"]
    want = want * (1.0 / (1.0 + np.exp(-want)))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    reference = np.asarray(
        JaxConvBnAct(features=24, kernel=kernel, stride=stride, groups=groups).apply(qvars, jnp.asarray(x)))
    assert np.abs(got - reference).max() <= 1e-5 * np.abs(reference).max()
    assert (_levels_port(torch.from_numpy(x).permute(0, 3, 1, 2), layer) != _levels_jax(x, p["ascale"])).sum() == 0


def test_single_cba_int8_close_to_f32():
    variables = _trained_ish_cba(2)
    x = np.random.default_rng(3).standard_normal((2, 16, 16, 16)).astype(np.float32)
    m = _port_cba(variables, 16, 24, 3)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        ref = m(xt).numpy().ravel()
    got = Q.quantize_layer(m, float(np.abs(x).max()))(xt).numpy().ravel()
    cos = np.dot(ref, got) / (np.linalg.norm(ref) * np.linalg.norm(got))
    assert cos > 0.999, cos
    assert np.abs(ref - got).max() < 0.05 * np.abs(ref).max()


@pytest.mark.parametrize("m,k,n", [(37, 72, 24), (5, 20, 13), (16, 8, 8), (300, 1152, 64)])
def test_int8_matmul_is_exact_and_pads(m, k, n):
    """int32 accumulation equals the int64 product exactly, at the largest
    |acc| the data allows (127^2 * K > 2^24 at K = 1,152: float32 could not
    hold it), and where torch._int_mm's CUDA shape rules need padding:
    rows <= 16, K or N not a multiple of 8."""
    rng = np.random.default_rng(m + k + n)
    a = rng.integers(-127, 128, (m, k)).astype(np.int8)
    w = rng.integers(-127, 128, (n, k)).astype(np.int8)
    a[0], w[0] = 127, 127  # one output at 127^2 * K
    kp, np_ = -(-k // 8) * 8, -(-n // 8) * 8
    w_pad = np.zeros((np_, kp), np.int8)
    w_pad[:n, :k] = w
    got = int8_matmul(torch.from_numpy(a), torch.from_numpy(w_pad), n)
    assert got.dtype == torch.int32 and tuple(got.shape) == (m, n)
    want = a.astype(np.int64) @ w.astype(np.int64).T
    np.testing.assert_array_equal(got.numpy().astype(np.int64), want)
    assert want[0, 0] == 127 * 127 * k


def test_quantize_requires_calibration():
    variables = _trained_ish_cba(4)
    with pytest.raises(ValueError):
        JQ.quantize_variables(variables, {}, exclude=())
    with pytest.raises(ValueError):
        Q.quantize_model(_port_cba(variables, 16, 24, 3), {}, exclude=())


@pytest.fixture(scope="module")
def golden_float():
    """The golden yolo11n as both packages hold it (float32), and one
    calibration batch."""
    tree = jax_load_params_npz(CKPT)
    jm = JaxYoloV11(JaxYoloConfig(scale="n"))
    tm = YoloV11(YoloConfig(scale="n"))
    load_jax_variables(tm, tree)
    x = (JQ._natural_tile(SIZE, seed=0)[None] / np.float32(255.0)).astype(np.float32)
    return jm, tree, tm.set_dtypes().eval(), x


def test_calibrate_and_quantize_match_jax_bit_for_bit(golden_float):
    """calibrate's scopes are JAX's flax paths, its absmax within 1e-5
    relative; given JAX's absmax dict, the port's int8 buffers equal
    quantize_variables' bit for bit, with the same exclusions and count."""
    jm, tree, tm, x = golden_float
    want = JQ.calibrate(jm, tree, [x])
    got = Q.calibrate(tm, [x])
    assert set(got) == set(want) and ("backbone", "down2") in got
    assert all(abs(got[k] - want[k]) <= 1e-5 * want[k] for k in want)
    assert not Q.CALIBRATING and not any(m._forward_pre_hooks for m in tm.modules() if isinstance(m, ConvBnAct))

    qvars = JQ.quantize_variables(tree, want)
    n = Q.quantize_model(tm, want)
    assert n == sum(1 for _ in JQ._iter_q(qvars["params"])) == len(list(Q._iter_q(tm)))
    qpaths = set(Q._iter_q(tm))
    assert qpaths == set(JQ._iter_q(qvars["params"]))
    assert ("backbone", "down2") in qpaths and ("backbone", "stem") not in qpaths
    assert not any(p[0] == "head" for p in qpaths) and not any(p[-1] == "pe" for p in qpaths)
    back = to_jax_variables(tm.state_dict())
    flat_want = dict(jax.tree_util.tree_flatten_with_path(qvars["params"])[0])
    flat_got = dict(jax.tree_util.tree_flatten_with_path(back["params"])[0])
    assert set(map(str, flat_got)) == set(map(str, flat_want))
    by_name = {str(k): v for k, v in flat_got.items()}
    for k, v in flat_want.items():
        g, w = by_name[str(k)], np.asarray(v)
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=str(k))


@pytest.fixture(scope="module")
def golden_int8():
    """The JAX package's quantize_detector on golden yolo11n (float32,
    image_size 256, one calibration tile), and the port's detector given the
    same int8 tree through from_jax."""
    kw = dict(model_path=CKPT, scale="n", dtype="float32", confidence_threshold=0.25, image_size=SIZE)
    jm = JaxModel(**kw)
    n = JQ.quantize_detector(jm, n_calib=1)
    tm = YoloV11PoseDetectionModel(device="cpu", **kw)
    load_jax_variables(tm.model, jm.variables)
    return jm, tm, n


def test_int8_tree_carried_across_and_back(golden_int8, tmp_path):
    """from_jax carries the int8 tree (qkernel int8 HWIO -> OIHW, the scales
    by name, no batch_stats at quantized scopes); to_jax_variables and
    save_params_npz give it back, and the JAX package loads the file."""
    jm, tm, n = golden_int8
    assert len(list(Q._iter_q(tm.model))) == n
    state = from_jax_variables(jm.variables)
    own = {k: v for k, v in tm.model.state_dict().items() if not k.endswith("num_batches_tracked")}
    assert set(own) == set(state)
    for k, v in state.items():
        assert own[k].dtype == v.dtype and torch.equal(own[k], v), k
    assert state["backbone.down2.qkernel"].dtype == torch.int8
    path = str(tmp_path / "int8.npz")
    save_params_npz(path, to_jax_variables(tm.model.state_dict()))
    reloaded = jax_load_params_npz(path)
    flat_a = jax.tree_util.tree_flatten_with_path(reloaded)[0]
    flat_b = dict((str(k), v) for k, v in jax.tree_util.tree_flatten_with_path(jm.variables)[0])
    assert len(flat_a) == len(flat_b)
    for k, v in flat_a:
        np.testing.assert_array_equal(np.asarray(v), np.asarray(flat_b[str(k)]), err_msg=str(k))
    again = YoloV11PoseDetectionModel(device="cpu", model_path=path, scale="n", dtype="float32", image_size=SIZE)
    assert set(Q._iter_q(again.model)) == set(Q._iter_q(tm.model))


def _int8_layer_io(jm, tiles):
    """Every int8 ConvBnAct of the JAX model: {path: (input, output)} of one
    eager forward over ``tiles``."""
    rec = {}

    def interceptor(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        mod = context.module
        if isinstance(mod, JaxConvBnAct) and context.method_name == "__call__" and mod.has_variable("params", "qkernel"):
            rec[tuple(mod.path)] = (np.asarray(args[0]), np.asarray(out))
        return out

    with flax_nn.intercept_methods(interceptor):
        jm.model.apply(jm.variables, jnp.asarray(tiles), train=False)
    return rec


def test_every_int8_layer_matches_jax_on_its_own_inputs(golden_int8):
    """Each of the quantized layers of golden yolo11n, fed the input JAX's
    layer got on photo tiles: the same activation levels (0 differ) and
    JAX's output within 1e-5 of the layer's largest."""
    jm, tm, n = golden_int8
    photo = synthetic_faces(512, 768, seed=0)
    tiles = (np.stack([photo[200:456, 300:556], photo[256:512, 0:256]]) / np.float32(255.0)).astype(np.float32)
    io = _int8_layer_io(jm, tiles)
    assert len(io) == n
    differ = 0
    for path, (x, want) in io.items():
        layer = tm.model.get_submodule(".".join(path))
        assert isinstance(layer, Int8ConvBnAct)
        xt = torch.from_numpy(x).permute(0, 3, 1, 2)
        with torch.inference_mode():
            got = layer(xt).permute(0, 2, 3, 1).numpy()
        differ += int((_levels_port(xt, layer) != _levels_jax(x, float(layer.ascale))).sum())
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max(), path
    assert differ == 0


def _arrays(result):
    preds = result.object_prediction_list
    return {"boxes": np.array([p.bbox.to_xyxy() for p in preds], np.float32).reshape(-1, 4),
            "scores": np.array([p.score.value for p in preds], np.float32)}


def test_golden_int8_sliced_prediction(golden_int8):
    """Golden yolo11n int8, get_sliced_prediction, the port against the
    JAX int8 pipeline on three synthetic photos.

    The int8 function is discontinuous: a float input within an ulp of a
    half level rounds either way, and one level moved early moves later
    layers' inputs by a whole step. So §2's float gates hold for no two
    float paths of it: the JAX package against itself with its own
    space-to-depth early stack switched off (the same math, another XLA
    graph) fails them on these photos, which this test asserts. Each layer
    is exact given its input (the test above); the whole detector is held
    to eval/gates.int8_gate, which that JAX control passes and
    the float32 detector (no quantization) fails. Measured on this CPU:
    the JAX control moved a score by up to 0.027 and a box edge by up to
    2.3 px, the port by up to 0.035 and 6 px (IoU >= 0.88); the float32
    detector changes the counts and scores by 0.1 to 0.4."""
    jm, tm, _ = golden_int8
    floats = YoloV11PoseDetectionModel(device="cpu", model_path=CKPT, scale="n", dtype="float32",
                                       confidence_threshold=0.25, image_size=SIZE)
    control_broke_section2 = float_failed = False
    for seed in (0, 1, 2):
        photo = synthetic_faces(512, 768, seed=seed)
        jm.s2d_early = True
        want = _arrays(jax_get_sliced_prediction(photo, jm, **SLICED))
        got = _arrays(get_sliced_prediction(photo, tm, **SLICED))
        assert len(want["boxes"]) > 0
        passed, worst_iou, worst_ds = int8_gate(got, want)
        assert passed, (seed, worst_iou, worst_ds)
        jm.s2d_early = False
        control = _arrays(jax_get_sliced_prediction(photo, jm, **SLICED))
        jm.s2d_early = True
        assert int8_gate(control, want)[0], seed
        control_broke_section2 |= not section2_gate(control, want)[0]
        float_failed |= not int8_gate(_arrays(get_sliced_prediction(photo, floats, **SLICED)), want)[0]
    assert control_broke_section2 and float_failed


def test_quantize_detector_roundtrip():
    """quantize_detector swaps the layers in place on the detector's device
    (random weights), counts what JAX's counts, and tile_forward runs."""
    kw = dict(scale="n", dtype="float32", confidence_threshold=0.25, image_size=128)
    det = YoloV11PoseDetectionModel(device="cpu", **kw)
    n = Q.quantize_detector(det, n_calib=1)
    jdet = JaxModel(load_at_init=False, **kw)
    jdet.load_model()
    assert n > 10 and n == JQ.quantize_detector(jdet, n_calib=1)
    out = det.tile_forward(torch.zeros((1, 128, 128, 3)), 0.25)
    assert all(torch.isfinite(v.float()).all() for v in (out.boxes, out.scores, out.kpts))


def test_int8_bfloat16_model_runs_close_to_float(golden_float):
    """The serving dtype: int8 layers emit bfloat16 (bn_dtype), the float
    layers around them stay bfloat16; outputs stay close to float32's
    (cosine > 0.98 on every map, as the JAX end-to-end test holds). The
    kernels are quantized from the float32 twin; without it, quantizing the
    bfloat16-rounded kernels raises."""
    _, tree, _, x = golden_float
    ref = YoloV11(YoloConfig(scale="n"))
    load_jax_variables(ref, tree)
    ref.set_dtypes().eval()
    tm = YoloV11(YoloConfig(scale="n", dtype="bfloat16", bn_dtype="bfloat16"))
    load_jax_variables(tm, tree)
    tm.set_dtypes().eval()
    absmax = Q.calibrate(tm, [x])
    with pytest.raises(ValueError):
        Q.quantize_model(tm, absmax)
    n = Q.quantize_model(tm, absmax, float_model=ref)
    assert n > 10
    assert all(m.bn_dtype == torch.bfloat16 for m in tm.modules() if isinstance(m, Int8ConvBnAct))
    with torch.inference_mode():
        want, got = ref(torch.from_numpy(x)), tm(torch.from_numpy(x))
    for lw, lg in zip(want, got):
        for k in lw:
            r, g = lw[k].numpy().ravel(), lg[k].float().numpy().ravel()
            assert np.dot(r, g) / (np.linalg.norm(r) * np.linalg.norm(g)) > 0.98, k

