"""The port's image-quality metrics (facedet_tpu_torch/eval/iqa.py,
iqa_train.py) against the JAX package on the CPU.

Tolerances: the NIQE / BRISQUE features, scores, the distortion bank and the
regressor are float64 numpy in both packages: equal bit for bit
(``assert_array_equal``). ``topiq_face`` through a network: within 2e-5 of
the JAX route (float32, another summation order); the proxy exactly.
"""
import importlib

import os

import numpy as np
import pytest
import torch

from facedet_tpu.eval import iqa as jiqa
from facedet_tpu.eval import iqa_train as jtrain
from facedet_tpu_torch.eval import iqa as tiqa
from facedet_tpu_torch.eval import iqa_train as ttrain
from facedet_tpu_torch.utils.viz import save_image
from test_onnx_import import export_onnx
from test_torch_rtdetr import save_flat_npz
from test_torch_topiq import TINY, flax_variables

torch.set_num_threads(1)


def natural_image(size=160, seed=1):
    rng = np.random.default_rng(seed)
    img = np.zeros((size, size))
    for octave, amp in ((4, 1.0), (16, 0.5), (32, 0.25)):
        img += amp * np.kron(rng.standard_normal((octave, octave)), np.ones((size // octave, size // octave)))
    return (img - img.min()) / (img.max() - img.min()) * 255


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(0)
    clean = natural_image(seed=2)
    return {
        "gray": clean,
        "noisy": np.clip(clean + rng.standard_normal(clean.shape) * 40, 0, 255),
        "rgb": np.stack([natural_image(seed=6)] * 3, -1).astype(np.uint8),
        "crop": rng.integers(0, 256, (40, 31, 3)).astype(np.uint8),  # below the NIQE patch size
        "unit": clean / 255.0,  # the [0, 1] range heuristic
    }


def test_committed_artifacts_are_the_ones_read():
    assert tiqa._ASSETS_DIR == jiqa._ASSETS_DIR
    with np.load(f"{tiqa._ASSETS_DIR}/niqe_pristine.npz") as f:
        mu, cov = tiqa._default_model()
        np.testing.assert_array_equal(mu, f["mu"])
        np.testing.assert_array_equal(cov, f["cov"])
    svr = tiqa._brisque_svr()
    assert svr is not None and set(svr) == {"sv", "alpha", "gamma", "feat_mu", "feat_sd"}


def test_features_bit_identical(images):
    x = np.random.default_rng(0).standard_normal(20_000)
    assert tiqa.fit_ggd(x) == jiqa.fit_ggd(x)
    assert tiqa.fit_aggd(x * 0.7 + 0.1) == jiqa.fit_aggd(x * 0.7 + 0.1)
    for name in ("gray", "noisy"):
        img = images[name]
        for a, b in zip(tiqa.mscn_coefficients(img, return_sigma=True), jiqa.mscn_coefficients(img, return_sigma=True)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(tiqa.brisque_features(img), jiqa.brisque_features(img))
        np.testing.assert_array_equal(tiqa.niqe_features(img), jiqa.niqe_features(img))


def test_scores_bit_identical(images):
    for name, img in images.items():
        assert tiqa.niqe(img) == jiqa.niqe(img), name
        assert tiqa.brisque(img) == jiqa.brisque(img), name
        assert tiqa.topiq_face(img) == jiqa.topiq_face(img), name  # the proxy
    assert tiqa.niqe(images["noisy"]) > tiqa.niqe(images["gray"])
    model = tiqa.fit_niqe_model([images["gray"], images["noisy"]], sharpness_fraction=0.5)
    want = jiqa.fit_niqe_model([images["gray"], images["noisy"]], sharpness_fraction=0.5)
    np.testing.assert_array_equal(model["mu"], want["mu"])
    np.testing.assert_array_equal(model["cov"], want["cov"])
    assert tiqa.niqe(images["rgb"], model) == jiqa.niqe(images["rgb"], model)
    assert tiqa.brisque(images["rgb"], model) == jiqa.brisque(images["rgb"], model)  # the Mahalanobis route
    assert tiqa.calculate_iqa_scores(images["rgb"], device="cpu") == jiqa.calculate_iqa_scores(images["rgb"])


def test_bank_regressor_and_svr_predict_bit_identical():
    feats, targets = ttrain.build_distortion_bank(n_pristine=2, size=128, seed=3)
    want_f, want_t = jtrain.build_distortion_bank(n_pristine=2, size=128, seed=3)
    np.testing.assert_array_equal(feats, want_f)
    np.testing.assert_array_equal(targets, want_t)
    svr, want_svr = ttrain.train_brisque_svr(feats, targets), jtrain.train_brisque_svr(feats, targets)
    for k in want_svr:
        np.testing.assert_array_equal(svr[k], want_svr[k])
    np.testing.assert_array_equal(ttrain.svr_predict(svr, feats[:5]), jtrain.svr_predict(want_svr, feats[:5]))
    committed = tiqa._brisque_svr()
    np.testing.assert_array_equal(ttrain.svr_predict(committed, feats), jtrain.svr_predict(committed, feats))
    # main and real_photo_corpus against JAX: tests/test_torch_sr_golden.py;
    # without a reference checkout the goldens name no photo and the
    # corpus is empty, as JAX's is
    from facedet_tpu_torch.tools.golden_finetune import REF_DIR

    if not os.path.isdir(REF_DIR):
        assert ttrain.real_photo_corpus() == []


def test_face_crop_quality_equal_jax(tmp_path, images):
    for k, name in enumerate(("rgb", "crop")):
        save_image(str(tmp_path / f"face{k}.png"), images[name])
    (tmp_path / "notes.txt").write_text("not an image")
    got = tiqa.calculate_face_crop_quality(str(tmp_path))
    assert got == jiqa.calculate_face_crop_quality(str(tmp_path)) and set(got) == {"face0.png", "face1.png"}
    assert tiqa.calculate_face_crop_quality(str(tmp_path / "nowhere")) == {}


@pytest.fixture()
def tiny_config(monkeypatch):
    """Both packages' ``topiq_face`` build ``CFANet(TopiqConfig())``: the tiny
    config keeps the routing tests cheap."""
    jtopiq = importlib.import_module("facedet_tpu.models.topiq")
    ttopiq = importlib.import_module("facedet_tpu_torch.models.topiq")
    monkeypatch.setattr(jtopiq, "TopiqConfig", lambda: TINY_J)
    monkeypatch.setattr(ttopiq, "TopiqConfig", lambda: TINY_T)
    for mod in (jiqa, tiqa):
        monkeypatch.setattr(mod, "brisque", lambda *a, **k: pytest.fail("a model path must not take the proxy"))


TINY_J = importlib.import_module("facedet_tpu.models.topiq").TopiqConfig(**TINY)
TINY_T = importlib.import_module("facedet_tpu_torch.models.topiq").TopiqConfig(**TINY)


def test_topiq_face_npz_route_matches_jax(tmp_path, images, tiny_config):
    path = str(tmp_path / "topiq_tiny.npz")
    save_flat_npz(path, flax_variables(TINY_J))
    for name in ("rgb", "crop"):
        got = tiqa.topiq_face(images[name], model_path=path, device="cpu")
        assert abs(got - jiqa.topiq_face(images[name], model_path=path)) <= 2e-5 and 0.0 < got < 1.0


def test_topiq_face_pth_route_matches_jax(tmp_path, images, tiny_config):
    from tests.torch_topiq_ref import TorchCFANet

    torch.manual_seed(0)
    mirror = TorchCFANet(embed_dim=32, heads=2, num_attn_blocks=1, mlp_ratio=2.0, stage_channels=(8, 16, 32, 64),
                         stage_depths=(1, 1, 1, 1))
    path = str(tmp_path / "topiq_tiny.pth")
    torch.save(mirror.state_dict(), path)
    got = tiqa.topiq_face(images["rgb"], model_path=path, device="cpu")
    assert abs(got - jiqa.topiq_face(images["rgb"], model_path=path)) <= 2e-5

    # a state dict of another layout fails to load: it raises, no proxy
    sd = mirror.state_dict()
    sd["extra.weight"] = torch.zeros(1)
    torch.save(sd, str(tmp_path / "bad.pth"))
    with pytest.raises(RuntimeError, match="Unexpected key"):
        tiqa.topiq_face(images["rgb"], model_path=str(tmp_path / "bad.pth"), device="cpu")


class TinyIqa(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.c = torch.nn.Conv2d(3, 4, 3, stride=8, padding=1)
        self.fc = torch.nn.Linear(4, 1)

    def forward(self, x):
        return torch.sigmoid(self.fc(torch.relu(self.c(x)).mean((2, 3))))


def test_topiq_face_onnx_route_matches_jax(tmp_path, images):
    torch.manual_seed(0)
    path = str(tmp_path / "topiq.onnx")
    export_onnx(TinyIqa(), torch.randn(1, 3, 224, 224), path)
    for name in ("rgb", "gray", "unit"):
        got = tiqa.topiq_face(images[name], model_path=path, device="cpu")
        assert abs(got - jiqa.topiq_face(images[name], model_path=path)) <= 2e-5 and 0.0 < got < 1.0


def test_topiq_face_bad_paths_raise(tmp_path, images):
    with pytest.raises(FileNotFoundError):
        tiqa.topiq_face(images["rgb"], model_path=str(tmp_path / "missing.pth"), device="cpu")
    with pytest.raises(FileNotFoundError):
        tiqa.topiq_face(images["rgb"], model_path=str(tmp_path / "missing.npz"), device="cpu")
    (tmp_path / "garbage.onnx").write_bytes(b"\x00\x01 not a graph")
    with pytest.raises(Exception):  # noqa: B017 - any parse error, never the proxy's float
        tiqa.topiq_face(images["rgb"], model_path=str(tmp_path / "garbage.onnx"), device="cpu")
    torch.manual_seed(0)
    export_onnx(TinyIqa(), torch.randn(1, 3, 224, 224), str(tmp_path / "topiq.onnx"))
    with pytest.raises(RuntimeError, match="no CUDA device"):  # the default device is the card
        tiqa.topiq_face(images["rgb"], model_path=str(tmp_path / "topiq.onnx"))
