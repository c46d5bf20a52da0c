"""The port's int8 quantization of a bfloat16 detector (the serving
configuration) against the JAX package's quantize_detector in bfloat16, on
the CPU. The reference quantizes its float32 params whatever the compute
dtype; the port's bfloat16 model holds bfloat16-rounded convs, so it
quantizes from the float32 twin its detector rebuilds (``float32_model``).

Tolerances, each with its reason, in the test's docstring: the int8
buffers bit-equal given one absmax dict; calibration within 2^-5 relative;
detections under the bfloat16 form of the int8 gate (``BF16_GATE``).
"""
import functools

import numpy as np
import torch

from facedet_tpu.engine.detector import YoloV11PoseDetectionModel as JaxModel
from facedet_tpu.engine.predict import get_sliced_prediction as jax_get_sliced_prediction
from facedet_tpu.models import quantize as JQ
from facedet_tpu_torch import YoloV11PoseDetectionModel, get_sliced_prediction
from facedet_tpu_torch.eval.gates import int8_gate
from facedet_tpu_torch.models import quantize as Q
from facedet_tpu_torch.models.from_jax import to_jax_variables
from facedet_tpu_torch.models.layers import ConvBnAct
from facedet_tpu_torch.utils.synth import synthetic_faces
from test_torch_quantize import CKPT, SIZE, SLICED, _arrays

torch.set_num_threads(1)


BF16_GATE = dict(max_dscore=0.1, free_below=0.35)


def _int8_leaves(params: dict) -> dict:
    return {(path, leaf): np.asarray(node[leaf]) for path in JQ._iter_q(params)
            for node in [functools.reduce(dict.__getitem__, path, params)]
            for leaf in ("qkernel", "ascale", "oscale", "obias")}


def test_bfloat16_detector_quantizes_float32_kernels_as_jax(monkeypatch):
    """The bfloat16 serving detector through quantize_detector, against the
    JAX package's quantize_detector in bfloat16. Both calibrate in
    bfloat16: the same scopes, absmax within 2^-5 relative (XLA on the CPU
    keeps float32 between fused bfloat16 ops where torch rounds each layer's
    output to bfloat16, an ulp of 2^-8 that compounds down the stack:
    measured up to 0.02 on golden yolo11n). Given JAX's absmax dict, every
    int8 buffer is bit-equal:
    the kernels are quantized from the float32 checkpoint, as the reference
    quantizes its float32 params. A control shows it matters: from the
    bfloat16-rounded kernels, ``qkernel`` differs. The sliced detections of
    the two int8 pipelines pass the int8 gate in its bfloat16 form
    (``BF16_GATE``) on four synthetic photos. The float32 gate holds no
    two bfloat16 paths: the JAX package against itself with its
    space-to-depth early stack off moved a score by up to 0.044 and lost a
    detection scoring 0.254, the port moved one by up to 0.083 (0.363 to
    0.446) on these photos, with the same buffers. So scores are held within
    0.1, and a detection under 0.35 (the threshold 0.25 plus 0.1) may go
    unmatched. That JAX control passes this gate, and the bfloat16 detector
    without quantization fails it (scores off by 0.26 to 0.59)."""
    kw = dict(model_path=CKPT, scale="n", dtype="bfloat16", confidence_threshold=0.25, image_size=SIZE)
    jm = JaxModel(**kw)
    want_absmax = {}
    jax_calibrate = JQ.calibrate
    monkeypatch.setattr(JQ, "calibrate", lambda *a: want_absmax.update(jax_calibrate(*a)) or dict(want_absmax))
    n = JQ.quantize_detector(jm, n_calib=1)
    tm = YoloV11PoseDetectionModel(device="cpu", **kw)
    port_calibrate = Q.calibrate
    got_absmax = {}
    monkeypatch.setattr(Q, "calibrate", lambda *a: got_absmax.update(port_calibrate(*a)) or dict(want_absmax))
    assert Q.quantize_detector(tm, n_calib=1) == n
    assert set(got_absmax) == set(want_absmax)
    assert all(abs(got_absmax[k] - want_absmax[k]) <= 2**-5 * want_absmax[k] for k in want_absmax)
    assert all(m.conv.weight.dtype == torch.bfloat16 for m in tm.model.modules() if isinstance(m, ConvBnAct))

    want = _int8_leaves(jm.variables["params"])
    got = _int8_leaves(to_jax_variables(tm.model.state_dict())["params"])
    assert len(want) == 4 * n and set(got) == set(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype, k
        np.testing.assert_array_equal(got[k], w, err_msg=str(k))
    twin, rounded = tm.float32_model(), 0
    for (path, leaf), w in want.items():
        if leaf == "qkernel":
            bf = twin.get_submodule(".".join(path)).conv.weight.detach().to(torch.bfloat16).float().numpy()
            bf = bf.transpose(2, 3, 1, 0)
            wscale = np.maximum(np.abs(bf).max(axis=(0, 1, 2)), 1e-12) / 127.0
            rounded += int((np.clip(np.round(bf / wscale), -127, 127).astype(np.int8) != w).sum())
    assert rounded > 0

    floats = YoloV11PoseDetectionModel(device="cpu", **kw)
    float_failed = False
    for seed in range(4):
        photo = synthetic_faces(512, 768, seed=seed)
        ref = _arrays(jax_get_sliced_prediction(photo, jm, **SLICED))
        mine = _arrays(get_sliced_prediction(photo, tm, **SLICED))
        assert len(ref["boxes"]) > 0
        passed, worst_iou, worst_ds = int8_gate(mine, ref, **BF16_GATE)
        assert passed, (seed, worst_iou, worst_ds)
        jm.s2d_early = False
        control = _arrays(jax_get_sliced_prediction(photo, jm, **SLICED))
        jm.s2d_early = True
        assert int8_gate(control, ref, **BF16_GATE)[0], seed
        float_failed |= not int8_gate(_arrays(get_sliced_prediction(photo, floats, **SLICED)), ref, **BF16_GATE)[0]
    assert float_failed
