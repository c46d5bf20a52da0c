"""facedet_tpu_torch/tools/probe_upload_pack.py against the JAX package's
probe on the CPU.

Exact throughout: the image equals the root ``bench.py``'s ``_make_image``
byte for byte; the port's staged dct420s wire (engine/predict
``_stage_batch_host``) and its six arrays (``wire_unpack_dct420s_np``) equal
JAX's byte for byte, dtype and shape, at bsz 2 and the JAX tool's bucket;
``main`` runs with ``--device cpu`` and reads back every arm's bytes equal;
by default it runs on the card and raises without one.
"""
import numpy as np
import pytest
import torch

import bench
from facedet_tpu.engine import predict as JP
from facedet_tpu.ops.jpeg_dct import encode_dct420 as jax_encode_dct420
from facedet_tpu.ops.jpeg_dct import wire_unpack_dct420s_np as jax_wire_unpack
from facedet_tpu_torch.tools import probe_upload_pack as pup
from facedet_tpu_torch.utils.synth import bench_image

H, W = 1024, 1536


def test_staged_arrays_and_wire_equal_jax_byte_for_byte():
    assert np.array_equal(bench_image(H, W), bench._make_image(H, W))
    wire, staged = pup.staged_arrays(2, H, W)
    jwire = JP._stage_batch_host([jax_encode_dct420(bench._make_image(H, W))] * 2, "dct420s", *pup.BUCKET)
    jstaged = jax_wire_unpack(jwire, 2, *pup.BUCKET)
    assert wire.dtype == jwire.dtype == np.uint8 and np.array_equal(wire, jwire)
    assert len(staged) == len(jstaged) == len(pup.NAMES) == 6
    for name, a, b in zip(pup.NAMES, staged, jstaged):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert a.tobytes() == b.tobytes(), name
    # the probe's concatenated wire is the staged wire: the six arrays tile it
    cat = np.concatenate([np.ascontiguousarray(a).view(np.uint8).ravel() for a in staged])
    assert np.array_equal(cat, wire[: cat.size]) and not wire[cat.size:].any()


def test_main_on_the_cpu(capsys):
    out = pup.main(["--bsz", "2", "--rounds", "2", "--device", "cpu"])
    assert out["memory"] == "pageable" and list(out["arrays"]) == list(pup.NAMES)
    assert set(out["median_s"]) == set(out["readback_equal"]) and len(out["median_s"]) == 3
    assert all(out["readback_equal"].values())
    assert all(out["min_s"][k] <= out["median_s"][k] for k in out["median_s"])
    assert out["wire_bytes"] == sum(b for _dt, _shape, b in out["arrays"].values())
    assert "from pageable memory" in capsys.readouterr().out


def test_main_raises_without_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pup.main(["--bsz", "2", "--rounds", "1"])
