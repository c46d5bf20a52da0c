"""The port's checkpoint conversion (facedet_tpu_torch/models/convert.py)
against the JAX package's (facedet_tpu/models/convert.py), the counterparts
of tests/test_convert.py's cases, plus the ``.pt`` branch of the port's
detector and tools/model_setup.py.

Tolerances: converted state dicts equal ``from_jax_variables`` of the JAX
conversion exactly (the same float32 numbers, transposed twice); block
forwards against the torch reference (tests/torch_yolo_ref.py) within the
JAX test's bounds (atol 2e-5, C2PSA 5e-5, rtol 1e-4; the full model's nine
head maps 1e-4, as are the two detectors' maps from one ``.pt``), float32
on both sides.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from facedet_tpu.models import convert as JC
from facedet_tpu.models.rrdbnet import RRDBConfig as JaxRRDBConfig
from facedet_tpu.models.rrdbnet import RRDBNet as JaxRRDBNet
from facedet_tpu.models.yolov11 import YoloConfig as JaxYoloConfig
from facedet_tpu.models.yolov11 import YoloV11 as JaxYoloV11
from facedet_tpu_torch.models import convert as C
from facedet_tpu_torch.models.from_jax import _load_strict, from_jax_variables
from facedet_tpu_torch.models.layers import C2PSA, C3k2, SPPF, ConvBnAct
from facedet_tpu_torch.models.rrdbnet import RRDBConfig, RRDBNet, pixel_unshuffle_nchw
from facedet_tpu_torch.models.yolov11 import YoloConfig, YoloV11
from test_convert import _torch_key_yolo
from torch_yolo_ref import C2PSA as TC2PSA
from torch_yolo_ref import SPPF as TSPPF
from torch_yolo_ref import C3k2 as TC3k2
from torch_yolo_ref import Conv as TConv
from torch_yolo_ref import TorchYolo11Pose, randomize_

torch.set_num_threads(1)


def _assert_equal_states(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == torch.float32, k
        assert torch.equal(got[k], want[k]), k


def _basicsr_state(cfg: JaxRRDBConfig, seed: int):
    """A basicsr-named RRDB state dict (OIHW) with the flax net's shapes."""
    variables = JaxRRDBNet(cfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 3)))
    rng = np.random.default_rng(seed)
    sd = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(variables["params"])[0]:
        names = [k.key for k in path]
        scope = ".".join(f"body.{p[4:]}" if p.startswith("body") else p for p in names[:-1])
        arr = rng.normal(size=leaf.shape).astype(np.float32)
        if names[-1] == "kernel":
            sd[f"{scope}.weight"] = np.transpose(arr, (3, 2, 0, 1))
        else:
            sd[f"{scope}.bias"] = arr
    return sd


def test_rrdb_converter_roundtrip():
    cfg = dict(num_feat=8, num_block=2, num_grow_ch=4, scale=4)
    sd = _basicsr_state(JaxRRDBConfig(**cfg), seed=0)
    got = C.convert_rrdbnet_checkpoint(sd, RRDBConfig(**cfg))
    _assert_equal_states(got, from_jax_variables(JC.convert_rrdbnet_checkpoint(sd, JaxRRDBConfig(**cfg))))
    for k, v in sd.items():  # basicsr names, planted values: body.0.rdb1... -> body0.rdb1...
        np.testing.assert_array_equal(got[f"body{k[5:]}" if k.startswith("body.") else k].numpy(), v)
    net = RRDBNet(RRDBConfig(**cfg))
    _load_strict(net, got)  # every parameter found


@pytest.mark.parametrize("scale", [2, 1])
def test_rrdb_unshuffled_nets_read_basicsr_planes(scale):
    """basicsr's x2 / x1 nets unshuffle with F.pixel_unshuffle (channel
    c*f*f + fy*f + fx); the port's conv_first reads its own order, so the
    converter permutes conv_first's input channels: the port's planes are
    basicsr's permuted, exactly, and the port's first conv on them equals
    basicsr's within 1e-5 (the same products summed in another order). The
    JAX route carries conv_first unpermuted, which reads other planes: its
    state equals the port's everywhere else, and conv_first up to the
    permutation."""
    cfg = dict(num_feat=8, num_block=1, num_grow_ch=4, scale=scale)
    sd = _basicsr_state(JaxRRDBConfig(**cfg), seed=3)
    got = C.convert_rrdbnet_checkpoint(sd, RRDBConfig(**cfg))
    want = from_jax_variables(JC.convert_rrdbnet_checkpoint(sd, JaxRRDBConfig(**cfg)))
    factor = {2: 2, 1: 4}[scale]
    _assert_equal_states({k: v for k, v in got.items() if k != "conv_first.weight"},
                         {k: v for k, v in want.items() if k != "conv_first.weight"})
    perm = C._unshuffle_permutation(3, factor)
    assert torch.equal(got["conv_first.weight"], want["conv_first.weight"][:, perm])
    assert not torch.equal(got["conv_first.weight"], want["conv_first.weight"])
    x = torch.from_numpy(np.random.default_rng(4).random((1, 3, 16, 16), np.float32))
    assert torch.equal(pixel_unshuffle_nchw(x, factor), F.pixel_unshuffle(x, factor)[:, perm])
    basicsr = F.conv2d(F.pixel_unshuffle(x, factor), torch.from_numpy(sd["conv_first.weight"]), padding=1)
    port = F.conv2d(pixel_unshuffle_nchw(x, factor), got["conv_first.weight"], padding=1)
    torch.testing.assert_close(port, basicsr, rtol=0, atol=1e-5)


def _yolo_state(seed: int):
    """A yolo11n-pose state dict in the ultralytics namespace, built from
    the flax tree with tests/test_convert.py's independent inverse map."""
    variables = JaxYoloV11(JaxYoloConfig(scale="n", num_classes=1, with_pose=True)).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False
    )
    rng = np.random.default_rng(seed)
    sd = {}
    for collection in ("params", "batch_stats"):
        for path, leaf in jax.tree_util.tree_flatten_with_path(variables[collection])[0]:
            names = [k.key for k in path]
            arr = rng.normal(size=leaf.shape).astype(np.float32)
            if collection == "batch_stats" and names[-1] == "var":
                arr = np.abs(arr) + 0.5
            key = _torch_key_yolo(names[:-1], names[-1], collection)
            sd[key] = np.transpose(arr, (3, 2, 0, 1)) if names[-1] == "kernel" else arr
    return sd


def test_yolo_converter_roundtrip():
    cfg = dict(scale="n", num_classes=1, with_pose=True)
    sd = _yolo_state(seed=1)
    got, scale = C.convert_ultralytics_checkpoint(sd, YoloConfig(**cfg))
    want, jscale = JC.convert_ultralytics_checkpoint(sd, JaxYoloConfig(**cfg))
    assert scale == jscale == "n"
    _assert_equal_states(got, from_jax_variables(want))
    # a pickled DetectionModel's own dict ("model.model.N") converts alike
    again, _ = C.convert_ultralytics_checkpoint({f"model.{k}": v for k, v in sd.items()}, YoloConfig(**cfg))
    _assert_equal_states(again, got)
    _load_strict(YoloV11(YoloConfig(**cfg)), got)


def test_converter_rejects_bad_shapes():
    bad = {"conv_first.weight": np.zeros((1, 1, 1, 1))}
    rcfg = dict(num_feat=8, num_block=1, num_grow_ch=4, scale=4)
    for convert, cfg in ((JC.convert_rrdbnet_checkpoint, JaxRRDBConfig(**rcfg)), (C.convert_rrdbnet_checkpoint, RRDBConfig(**rcfg))):
        with pytest.raises(ValueError):
            convert(bad, cfg)
    sd = _basicsr_state(JaxRRDBConfig(**rcfg), seed=0)
    del sd["body.0.rdb2.conv3.bias"]
    for convert, cfg in ((JC.convert_rrdbnet_checkpoint, JaxRRDBConfig(**rcfg)), (C.convert_rrdbnet_checkpoint, RRDBConfig(**rcfg))):
        with pytest.raises(KeyError):
            convert(sd, cfg)

    ycfg = dict(scale="n", num_classes=1, with_pose=True)
    sd = _yolo_state(seed=2)
    for drop, error in (("model.23.cv4.2.2.bias", KeyError), ("model.23.cv2.0.0.conv.weight", KeyError)):
        broken = {k: v for k, v in sd.items() if k != drop}
        for convert, cfg in ((JC.convert_ultralytics_checkpoint, JaxYoloConfig(**ycfg)), (C.convert_ultralytics_checkpoint, YoloConfig(**ycfg))):
            with pytest.raises(error):
                convert(broken, cfg)
    wrong = dict(sd, **{"model.4.cv1.conv.weight": np.zeros((64, 65, 1, 1), np.float32)})
    for convert, cfg in ((JC.convert_ultralytics_checkpoint, JaxYoloConfig(**ycfg)), (C.convert_ultralytics_checkpoint, YoloConfig(**ycfg))):
        with pytest.raises(ValueError):
            convert(wrong, cfg)
    # a yolo11n checkpoint under a yolo11s config: both raise ValueError
    # (the port names the scales, the JAX route a shape)
    for convert, cfg in ((JC.convert_ultralytics_checkpoint, JaxYoloConfig(scale="s")), (C.convert_ultralytics_checkpoint, YoloConfig(scale="s"))):
        with pytest.raises(ValueError):
            convert(sd, cfg)


def test_detect_yolo_scale_reads_published_widths():
    for scale in ("n", "s", "m", "l", "x"):
        with torch.device("meta"):
            net = TorchYolo11Pose(YoloConfig(scale=scale))
        assert C.detect_yolo_scale(net.state_dict()) == scale


def _golden_block(make_port, torch_block, c_in, flax_block, jax_convert, hw=16, atol=2e-5):
    """The torch reference block (randomized) converted by the port's name
    map into the port's block (``make_port()``): forward within ``atol`` of
    the reference, and the state equal to the JAX block conversion carried
    across."""
    randomize_(torch_block, seed=11)
    sd = {f"blk.{k}": v.detach().numpy() for k, v in torch_block.state_dict().items()}
    with torch.device("meta"):
        target = make_port().state_dict()
    state = C._fill(target, sd, lambda key: "blk." + C._inner_name(key.split(".")))
    port_block = make_port()
    _load_strict(port_block, dict(state))
    x = np.random.default_rng(3).standard_normal((2, c_in, hw, hw)).astype(np.float32)
    with torch.no_grad():
        want = torch_block.eval()(torch.as_tensor(x)).numpy()
        got = port_block.eval()(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, atol=atol, rtol=1e-4)

    variables = flax_block.init(jax.random.PRNGKey(0), jnp.zeros((2, hw, hw, c_in)), train=False)
    params = jax.tree.map(np.asarray, variables["params"])
    bstats = jax.tree.map(np.asarray, variables["batch_stats"])
    jax_convert(params, bstats, [], sd, "blk")
    _assert_equal_states(state, from_jax_variables({"params": params, "batch_stats": bstats}))


def test_golden_convbnact():
    from facedet_tpu.models.layers import ConvBnAct as JaxConvBnAct

    _golden_block(lambda: ConvBnAct(5, 12, 3, 2), TConv(5, 12, 3, 2), 5, JaxConvBnAct(12, kernel=3, stride=2),
                  JC._convert_convbn)


def test_golden_c3k2_bottleneck_and_c3k():
    from facedet_tpu.models.layers import C3k2 as JaxC3k2

    _golden_block(lambda: C3k2(8, 16, 2, False, 0.25), TC3k2(8, 16, n=2, c3k=False, e=0.25), 8,
                  JaxC3k2(16, n=2, c3k=False, expansion=0.25), JC._convert_c3k2)
    _golden_block(lambda: C3k2(16, 16, 1, True), TC3k2(16, 16, n=1, c3k=True), 16,
                  JaxC3k2(16, n=1, c3k=True), JC._convert_c3k2)


def test_golden_sppf():
    from facedet_tpu.models.layers import SPPF as JaxSPPF

    _golden_block(lambda: SPPF(16, 16), TSPPF(16, 16), 16, JaxSPPF(16), JC._convert_sppf)


def test_golden_c2psa():
    from facedet_tpu.models.layers import C2PSA as JaxC2PSA

    _golden_block(lambda: C2PSA(128, 128, 1), TC2PSA(128, 128, n=1), 128, JaxC2PSA(128, n=1), JC._convert_c2psa,
                  hw=8, atol=5e-5)


@pytest.fixture(scope="module")
def torch_yolo():
    """A randomized yolo11n-pose in the ultralytics namespace."""
    cfg = YoloConfig(scale="n", num_classes=1, with_pose=True, dtype="float32")
    return cfg, randomize_(TorchYolo11Pose(cfg), seed=5).eval()


def test_golden_full_model_and_head(torch_yolo):
    """End-to-end: the torch yolo11n-pose -> convert_ultralytics_checkpoint
    -> the port's YoloV11 gives the reference's nine raw head maps within
    1e-4, and the converted state equals the JAX route's."""
    cfg, tnet = torch_yolo
    sd = {k: v.detach().numpy() for k, v in tnet.state_dict().items()}
    state, scale = C.convert_ultralytics_checkpoint(sd, cfg)
    assert scale == "n"
    jvars, _ = JC.convert_ultralytics_checkpoint(sd, JaxYoloConfig(scale="n", num_classes=1, with_pose=True))
    _assert_equal_states(state, from_jax_variables(jvars))
    model = YoloV11(cfg)
    _load_strict(model, state)
    x = np.random.default_rng(9).standard_normal((1, 3, 64, 64)).astype(np.float32)
    with torch.no_grad():
        want = tnet(torch.as_tensor(x))
        got = model.set_dtypes().eval().forward_nchw(torch.as_tensor(x))
    for lvl, maps in enumerate(want):
        for name, w in zip(("box", "cls", "kpt"), maps):
            np.testing.assert_allclose(got[lvl][name].permute(0, 3, 1, 2).numpy(), w.numpy(),
                                       atol=1e-4, rtol=1e-4, err_msg=f"{name} level {lvl}")


def test_detector_loads_a_pt_checkpoint_like_jax(torch_yolo, tmp_path):
    """YoloV11PoseDetectionModel(model_path=<.pt>) in both packages, on the
    same file (a ``state_dict`` entry, unwrapped as the JAX package does):
    the two detectors' nine raw maps within 1e-4 on the same tiles. (The
    randomized net's detections are degenerate full-tile boxes with tied
    scores, so maps, not detections, are compared.)"""
    from facedet_tpu.engine.detector import YoloV11PoseDetectionModel as JaxModel
    from facedet_tpu_torch import YoloV11PoseDetectionModel

    _, tnet = torch_yolo
    path = str(tmp_path / "yolo11n-pose.pt")
    torch.save({"state_dict": tnet.state_dict()}, path)
    kw = dict(model_path=path, scale="n", dtype="float32", image_size=64)
    port = YoloV11PoseDetectionModel(device="cpu", **kw)
    jm = JaxModel(**kw)
    tiles = np.random.default_rng(10).random((2, 64, 64, 3), np.float32)
    want = jm.model.apply(jm.variables, jnp.asarray(tiles), train=False)
    with torch.inference_mode():
        got = port.model(torch.from_numpy(tiles))
    for lvl in range(3):
        for name in ("box", "cls", "kpt"):
            np.testing.assert_allclose(got[lvl][name].numpy(), np.asarray(want[lvl][name]), atol=1e-4, rtol=1e-4,
                                       err_msg=f"{name} level {lvl}")


def test_rrdb_pth_unwraps_params_ema(tmp_path):
    cfg = dict(num_feat=8, num_block=1, num_grow_ch=4, scale=4)
    sd = _basicsr_state(JaxRRDBConfig(**cfg), seed=6)
    path = str(tmp_path / "RealESRGAN.pth")
    torch.save({"params_ema": {k: torch.from_numpy(v) for k, v in sd.items()}, "params": {}}, path)
    _assert_equal_states(C.convert_rrdbnet_checkpoint(path, RRDBConfig(**cfg)),
                         C.convert_rrdbnet_checkpoint(sd, RRDBConfig(**cfg)))
    _assert_equal_states(C.convert_rrdbnet_checkpoint(path, RRDBConfig(**cfg)),
                         from_jax_variables(JC.convert_rrdbnet_checkpoint(path, JaxRRDBConfig(**cfg))))


def test_model_setup_matches_the_jax_tools(tmp_path):
    from facedet_tpu.tools import model_setup as jax_setup
    from facedet_tpu_torch import YoloV11PoseDetectionModel
    from facedet_tpu_torch.tools import model_setup

    assert set(model_setup.WEIGHT_SOURCES) == set(jax_setup.WEIGHT_SOURCES)
    assert model_setup.ensure_weights("yolo11s-pose", None) is None
    with pytest.raises(FileNotFoundError, match="convert_ultralytics_checkpoint"):
        model_setup.ensure_weights("yolo11s-pose", str(tmp_path / "missing.pt"))
    ours = model_setup.generate_sample_images(str(tmp_path / "a"), n=2, size=(96, 128), seed=3)
    theirs = jax_setup.generate_sample_images(str(tmp_path / "b"), n=2, size=(96, 128), seed=3)
    for a, b in zip(ours, theirs):
        assert open(a, "rb").read() == open(b, "rb").read()
    assert model_setup.ensure_weights("x", ours[0]) == ours[0]
    det = YoloV11PoseDetectionModel(scale="n", dtype="float32", device="cpu", image_size=64)
    assert model_setup.smoke_test_model(det, size=(48, 64))
