"""The port's SR golden training (facedet_tpu_torch/tools/sr_golden_train.main)
against facedet_tpu/tools/sr_golden_train.main on the CPU, on a synthetic
reference tree: a tiny x2 RRDB (8 features, one block) at HR 32, batch 2,
two L1 dispatches of one step (the warmup's first steps), then two GAN
dispatches with the PatchDiscriminator (base 64) and the golden-YOLO
perceptual term, and the EMA checkpoint.

Both start from one generator (``--init-from``, JAX's init saved as
``.npz``) and one discriminator (the JAX tool's own init); the port takes
the flip draws of each dispatch from the key the JAX tool hands that
dispatch. Tolerances, stated per check:
  * the three optimizers (L1: clip 5, Adam, warmup 200 steps then cosine
    to lr * 0.05 at step 201; G and D of the GAN: clip 5, Adam at the
    constant ``--gan-lr``) equal to the JAX tool's, the schedules within
    float32 rounding (1e-6 of its peak) over 0-400;
  * the L1 losses within 1e-4 relative (phase 24's gate: the first step's
    rate is 0, so neither dispatch follows a move), the first GAN
    dispatch's four metrics within 1e-4 relative, the second's within 1e-2
    (after the first Adam update at the GAN rate);
  * G and its EMA after each phase, and D after the GAN, within 4 * r of
    JAX's with at most 1% of the elements more than r / 2 apart, where r is
    the summed rate of the phase's steps (phase 24's gates after two steps,
    scaled to the rates taken: a wrong warmup or rate moves every element
    by about r);
  * the checkpoint: the same float16 keys and shapes, each value within
    those gates plus float16's rounding (2^-11 relative);
  * the report: the same keys and configuration, the same hold-out images
    and bicubic PSNR, the same number of crops in the IQA table.
"""
import functools
import json

import jax
import numpy as np
import pytest
import torch

from facedet_tpu.engine.detector import load_params_npz as jax_load_params_npz
from facedet_tpu.engine.detector import save_params_npz
from facedet_tpu.models.rrdbnet import RRDBConfig as JaxRRDBConfig
from facedet_tpu.models.rrdbnet import RRDBNet as JaxRRDBNet
from facedet_tpu.tools import golden_finetune as jgf
from facedet_tpu.tools import sr_golden_train as jsr
from facedet_tpu.train import sr_gan as jgan
from facedet_tpu.train import sr_train as jst
from facedet_tpu_torch.models import from_jax
from facedet_tpu_torch.tools import sr_golden_train as tsr
from facedet_tpu_torch.train import sr_gan as tgan
from facedet_tpu_torch.train import sr_train as tst
from test_torch_golden_finetune_staged import record_clipped_adamw, record_optax, same_optimizers
from test_torch_sr_golden import tree  # noqa: F401  (the fixture)

torch.set_num_threads(1)

LR, GAN_LR = 2e-4, 1e-4


def _argv(tmp_path, package, init):
    return ["--blocks", "1", "--feat", "8", "--steps", "2", "--staged", "1", "--batch", "2", "--hr-size", "32",
            "--patches", "4", "--holdout", "1", "--lr", str(LR), "--gan-steps", "2", "--gan-lr", str(GAN_LR),
            "--gan-percep-weight", "0.1", "--max-crops", "2", "--init-from", init,
            "--out", str(tmp_path / f"{package}.npz"), "--report", str(tmp_path / f"{package}_report.json")]


def _flips(key, steps, batch):
    return np.stack([np.asarray(jax.random.bernoulli(jax.random.fold_in(key, i), shape=(batch,)))
                     for i in range(steps)])


def _jax_recorder(module, name, calls):
    """Wrap a JAX SR staged-loop factory: each dispatch records its inputs
    and outputs (numpy) and its key."""
    real = getattr(module, name)

    def factory(*a, **k):
        run = real(*a, **k)

        def wrapped(*args):
            inputs = jax.tree.map(np.asarray, args[:-3])
            out = run(*args)
            calls.append({"inputs": inputs, "key": args[-1], "out": jax.tree.map(np.asarray, out)})
            return out

        return wrapped

    return factory


def _port_recorder(module, name, jax_calls, seen, n_models):
    """Wrap a port SR staged-loop factory (its first ``n_models`` arguments
    are modules): dispatch j takes the flips of JAX's dispatch j, and
    records its result and the parameters of the models and of the EMA."""
    real = getattr(module, name)

    def factory(*a, **k):
        run = real(*a, **k)
        models = a[:n_models]

        def wrapped(ema, lr_u8, hr_u8, start=0):
            key = jax_calls[len(seen)]["key"]
            out = run(ema, lr_u8, hr_u8, start=start, flips=_flips(key, k["steps_per_dispatch"], lr_u8.shape[1]))
            seen.append({"out": out, "nets": [{n: p.detach().clone() for n, p in m.named_parameters()}
                                              for m in (*models, ema)]})
            return out

        return wrapped

    return factory


def _within(got: dict, want: dict, rate: float, what: str):
    """Phase 24's gates scaled to the summed rate ``rate``."""
    moved = total = 0
    for name, v in want.items():
        diff = (got[name] - v).abs()
        assert float(diff.max()) <= 4 * rate * (1 + 1e-3), (what, name, float(diff.max()) / rate)
        moved += int((diff > rate / 2).sum())
        total += v.numel()
    assert moved <= 0.01 * total, (what, moved, total)


def _g_state(tree):
    return from_jax.from_jax_variables(tree)


def _d_state(params):
    return from_jax.from_jax_variables({"params": params})


@pytest.fixture(scope="module")
def init_npz(tmp_path_factory):
    variables = JaxRRDBNet(JaxRRDBConfig(scale=2, num_block=1, num_feat=8)).init(
        jax.random.PRNGKey(5), np.zeros((1, 16, 16, 3), np.float32))
    path = str(tmp_path_factory.mktemp("init") / "g.npz")
    save_params_npz(path, jax.device_get(variables))
    return path


def test_sr_golden_train_against_the_jax_main(tree, init_npz, tmp_path, monkeypatch):
    root, gp = tree
    l1, gan, jax_opts = [], [], []
    record_optax(monkeypatch, jax_opts)
    monkeypatch.setattr(jgf, "load_golden_dataset", functools.partial(jgf.load_golden_dataset, gp, root))
    monkeypatch.setattr(jst, "make_sr_staged_loop", _jax_recorder(jst, "make_sr_staged_loop", l1))
    monkeypatch.setattr(jgan, "make_sr_gan_staged_loop", _jax_recorder(jgan, "make_sr_gan_staged_loop", gan))
    jsr.main(_argv(tmp_path, "jax", init_npz))
    want = json.load(open(tmp_path / "jax_report.json"))
    assert len(l1) == len(gan) == 2

    port_opts, seen_l1, seen_gan = [], [], []
    record_clipped_adamw(monkeypatch, port_opts)
    monkeypatch.setattr(tst, "make_sr_staged_loop", _port_recorder(tst, "make_sr_staged_loop", l1, seen_l1, 1))
    monkeypatch.setattr(tgan, "make_sr_gan_staged_loop",
                        _port_recorder(tgan, "make_sr_gan_staged_loop", gan, seen_gan, 2))
    d_params, d_stats = gan[0]["inputs"][3], gan[0]["inputs"][4]

    def jax_discriminator(base, seed):
        d = tgan.PatchDiscriminator(base)
        from_jax.load_discriminator_variables(d, {"params": d_params, "batch_stats": d_stats})
        return d

    monkeypatch.setattr(tgan, "create_discriminator", jax_discriminator)
    got = tsr.main(_argv(tmp_path, "port", init_npz) + ["--goldens", gp, "--ref-dir", root, "--device", "cpu"])
    assert len(seen_l1) == len(seen_gan) == 2

    same_optimizers(port_opts, jax_opts, range(0, 401))
    l1_rate = sum(jax_opts[0]["schedule"](c) for c in range(2))
    assert 0 < l1_rate < LR / 100  # the warmup's first steps
    for s, c in zip(seen_l1, l1):
        np.testing.assert_allclose(float(s["out"]), float(c["out"][-1]), rtol=1e-4)
    g, ema = seen_l1[-1]["nets"]
    _within(g, _g_state(l1[-1]["out"][0]), l1_rate, "G after L1")
    _within(ema, _g_state(l1[-1]["out"][1]), l1_rate, "EMA after L1")

    for i, (s, c) in enumerate(zip(seen_gan, gan)):
        assert set(s["out"]) == set(c["out"][-1]) == {"pixel", "adv", "percep", "d"}
        for name, v in c["out"][-1].items():
            np.testing.assert_allclose(float(s["out"][name]), float(v), rtol=1e-4 if i == 0 else 1e-2,
                                       err_msg=f"GAN dispatch {i} {name}")
    assert float(seen_gan[0]["out"]["percep"]) > 0
    rate = l1_rate + 2 * GAN_LR
    g, d, ema = seen_gan[-1]["nets"]
    out = gan[-1]["out"]
    _within(g, _g_state(out[0]), rate, "G after the GAN")
    _within(ema, _g_state(out[1]), rate, "EMA after the GAN")
    _within(d, _d_state(out[3]), 2 * GAN_LR, "D after the GAN")

    mine, theirs = (np.load(tmp_path / f"{p}.npz") for p in ("port", "jax"))
    assert sorted(mine.files) == sorted(theirs.files)
    for name in theirs.files:
        a, b = mine[name], theirs[name]
        assert a.dtype == b.dtype == np.float16 and a.shape == b.shape, name
        bound = 4 * rate + 2.0**-10 * np.abs(b.astype(np.float32))
        assert (np.abs(a.astype(np.float32) - b.astype(np.float32)) <= bound + 1e-7).all(), name
    assert set(jax_load_params_npz(str(tmp_path / "port.npz"))) == {"params"}
    assert set(got) == set(want) | {"loss_history"}
    assert got["config"] == want["config"]
    assert [h[0] for h in got["loss_history"]] == [1, 2]
    for r, w in zip(got["fidelity_holdout"], want["fidelity_holdout"]):
        assert (r["image"], r["psnr_bicubic"]) == (w["image"], w["psnr_bicubic"])
    assert got["iqa_face_crops"]["overall"]["n"] == want["iqa_face_crops"]["overall"]["n"] == 2
