"""The parts of the port's RT-DETR training (facedet_tpu_torch/train/
rtdetr_train.py, ``dn_attention_mask`` of models/rtdetr.py) against
facedet_tpu/train/rtdetr_train.py on the CPU, float32.

Tolerances, stated per check: ``dn_attention_mask``, ``build_cdn`` fed
JAX's own ``part`` / ``sign`` draws (labels, positive mask and the noised
references) and the Hungarian and greedy matchers exactly; Sinkhorn exactly
on the separated and square cases of tests/test_rtdetr.py; the losses on
the same raw outputs within 1e-5 relative, their gradients on those outputs
within 1e-5 of each output's largest |g|; the schedules within 1e-9 of
optax's (its float32 against a double); the clip at 0.1 and three AdamW
steps on the same given gradients within 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from facedet_tpu.models import rtdetr as jax_rtdetr
from facedet_tpu.train import rtdetr_train as jrt
from facedet_tpu_torch.models import rtdetr as trt_model
from facedet_tpu_torch.train import rtdetr_train as trt
from facedet_tpu_torch.train.yolo_train import ClippedAdamW, WarmupCosineDecay

torch.set_num_threads(1)


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("n_dn,groups,k", [(30, 5, 60), (12, 2, 7), (0, 1, 5)])
def test_dn_attention_mask_matches_jax(n_dn, groups, k):
    want = np.asarray(jax_rtdetr.dn_attention_mask(n_dn, groups, k))
    got = trt_model.dn_attention_mask(n_dn, groups, k).numpy()
    np.testing.assert_array_equal(got, want)


def _gt(b=2, m=3, seed=0):
    """Normalised cxcywh GT with the last slot of each image dead (zeros)."""
    rng = np.random.default_rng(seed)
    boxes = np.concatenate([rng.uniform(0.2, 0.8, (b, m, 2)), rng.uniform(0.05, 0.3, (b, m, 2))], -1).astype(np.float32)
    mask = np.ones((b, m), bool)
    mask[:, -1] = False
    boxes[~mask] = 0.0
    return boxes, mask


def jax_cdn_draws(key, b, groups, m):
    """The ``part`` and ``sign`` that JAX's ``build_cdn`` draws from ``key``."""
    k_part, k_sign = jax.random.split(key)
    shape = (b, groups, 2, m, 4)
    return (np.asarray(jax.random.uniform(k_part, shape)),
            np.asarray(jax.random.rademacher(k_sign, shape).astype(jnp.float32)))


@pytest.mark.parametrize("groups,scale", [(5, 1.0), (2, 0.5)])
def test_build_cdn_with_jax_draws_matches_jax(groups, scale):
    boxes, mask = _gt(b=3, m=4, seed=1)
    key = jax.random.PRNGKey(11)
    want = [np.asarray(a) for a in jrt.build_cdn(key, jnp.asarray(boxes), jnp.asarray(mask), groups, scale, 1)]
    part, sign = jax_cdn_draws(key, 3, groups, 4)
    got = [a.numpy() for a in trt.build_cdn(t(boxes), t(mask), groups, scale, 1, part=t(part), sign=t(sign))]
    assert got[0].shape == (3, 2 * groups * 4) and got[1].shape == (3, 2 * groups * 4, 4)
    for g, w, what in zip(got, want, ("dn_labels", "dn_ref", "positive mask")):
        np.testing.assert_array_equal(g, w, err_msg=what)
    # the default draws come from the generator: the same labels, references inside [0, 1]
    labels, ref, pos = trt.build_cdn(t(boxes), t(mask), groups, scale, generator=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(labels.numpy(), want[0])
    assert float(ref[..., :2].min()) >= 0 and float(ref.max()) <= 1 and float(ref[..., 2:].min()) >= np.float32(1e-4)


def _costs(b, q, m, seed, dead=0):
    rng = np.random.default_rng(seed)
    cost = rng.random((b, q, m)).astype(np.float32)
    if dead:
        cost[:, :, -dead:] = 1e6
    return cost


def _separated(b, q, m, seed):
    """DETR-like structure: spatial distance minus a confidence."""
    rng = np.random.default_rng(seed)
    gt, qr = rng.random((b, m, 2)), rng.random((b, q, 2))
    dist = np.linalg.norm(qr[:, :, None] - gt[:, None], axis=-1)
    return (dist - 0.3 * rng.random((b, q, 1))).astype(np.float32)


@pytest.mark.parametrize("matcher", ["hungarian", "greedy"])
@pytest.mark.parametrize("case", ["random", "random-dead-columns", "separated", "fewer-queries"])
def test_matchers_equal_jax(matcher, case):
    cost = {
        "random": lambda: _costs(3, 20, 6, 2),
        "random-dead-columns": lambda: _costs(3, 20, 6, 3, dead=2),
        "separated": lambda: _separated(3, 60, 30, 4),
        "fewer-queries": lambda: _costs(2, 4, 6, 5, dead=1),
    }[case]()
    want = np.asarray(getattr(jrt, f"{matcher}_match")(jnp.asarray(cost)))
    got = getattr(trt, f"{matcher}_match")(t(cost))
    assert got.dtype == torch.long
    np.testing.assert_array_equal(got.numpy(), want)
    if case == "fewer-queries":
        assert (want == -1).sum() == 2 * 2  # two GT slots per image stay unmatched


def test_sinkhorn_equals_jax_on_separated_and_square_cases():
    """The cases of tests/test_rtdetr.py: the separable 3x3 permutation, eight
    DETR-like 60x30 instances, and the dead-GT sentinel layout (120x48 with
    10 or 30 real columns and ``col_mask``)."""
    square = np.full((1, 3, 3), 10.0, np.float32)
    square[0, 0, 1] = square[0, 1, 2] = square[0, 2, 0] = 0.0
    got = trt.sinkhorn_match(t(square)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jrt.sinkhorn_match(jnp.asarray(square))))
    assert got[0].tolist() == [2, 0, 1]
    sep = _separated(8, 60, 30, 1)
    np.testing.assert_array_equal(trt.sinkhorn_match(t(sep)).numpy(), np.asarray(jrt.sinkhorn_match(jnp.asarray(sep))))
    rng = np.random.default_rng(2)
    for n_real in (10, 30):
        real = _separated(1, 120, n_real, int(rng.integers(100)))
        cost = np.full((1, 120, 48), 1e6, np.float32)
        cost[..., :n_real] = real
        mask = np.zeros((1, 48), bool)
        mask[:, :n_real] = True
        want = np.asarray(jrt.sinkhorn_match(jnp.asarray(cost), col_mask=jnp.asarray(mask)))
        got = trt.sinkhorn_match(t(cost), col_mask=t(mask)).numpy()
        np.testing.assert_array_equal(got, want)
        assert len(set(got[0, :n_real].tolist())) == n_real


def test_match_assignments_auto_is_hungarian_on_the_cpu():
    """'auto' on a CPU cost, an unknown name, and given assignments (a callable)."""
    cost = _costs(2, 12, 5, 6)
    np.testing.assert_array_equal(trt.match_assignments(t(cost)).numpy(), trt.hungarian_match(t(cost)).numpy())
    with pytest.raises(ValueError, match="unknown matcher"):
        trt.match_assignments(t(cost), "nearest")
    given = torch.tensor([[3, 1, 0, 2, 4], [0, 1, 2, 3, 4]])
    np.testing.assert_array_equal(trt.match_assignments(t(cost), lambda c: given).numpy(), given.numpy())


def _raw_outputs(b, q, m, n_layers=2, groups=2, seed=0):
    """Per-layer logits and sigmoid boxes, and the CDN outputs, as numpy."""
    rng = np.random.default_rng(seed)
    n_dn = 2 * groups * m

    def boxes(n):
        return (1 / (1 + np.exp(-rng.standard_normal((b, n, 4)) * 1.5))).astype(np.float32)

    return {
        "logits": [rng.standard_normal((b, q, 1)).astype(np.float32) for _ in range(n_layers)],
        "boxes": [boxes(q) for _ in range(n_layers)],
        "dn_logits": [rng.standard_normal((b, n_dn, 1)).astype(np.float32) for _ in range(n_layers)],
        "dn_boxes": [boxes(n_dn) for _ in range(n_layers)],
    }


def _loss_fns(kind, matcher, groups):
    if kind == "layer":
        return (lambda o, g, k: jrt._layer_loss(o["logits"][0], o["boxes"][0], g, k, 1.0, 5.0, 2.0, matcher),
                lambda o, g, k: trt._layer_loss(o["logits"][0], o["boxes"][0], g, k, 1.0, 5.0, 2.0, matcher))
    if kind == "dn":
        return (lambda o, g, k: (jrt._dn_layer_loss(o["dn_logits"][0], o["dn_boxes"][0], g, k, groups, 1.0, 5.0, 2.0), {}),
                lambda o, g, k: (trt._dn_layer_loss(o["dn_logits"][0], o["dn_boxes"][0], g, k, groups, 1.0, 5.0, 2.0), {}))
    return (lambda o, g, k: jrt.rtdetr_loss(o, g, k, dn_groups=groups, matcher=matcher),
            lambda o, g, k: trt.rtdetr_loss(o, g, k, dn_groups=groups, matcher=matcher))


@pytest.mark.parametrize("kind,matcher,q", [
    ("layer", "hungarian", 12), ("layer", "greedy", 12), ("layer", "hungarian", 4),
    ("dn", "hungarian", 12), ("rtdetr", "hungarian", 12), ("rtdetr", "greedy", 12),
])
def test_losses_and_gradients_on_raw_outputs_match_jax(kind, matcher, q):
    """q=4 < M=6: GT slots stay unmatched (assign -1), their padded target
    points at query 0 and must not clear a real match there."""
    m, groups = 6, 2
    boxes, mask = _gt(b=2, m=m, seed=7)
    mask[0, 2] = False
    boxes[0, 2] = 0.0
    outs = _raw_outputs(2, q, m, groups=groups, seed=8)
    jfn, tfn = _loss_fns(kind, matcher, groups)

    def jax_total(o):
        total, parts = jfn(o, jnp.asarray(boxes), jnp.asarray(mask))
        return total, parts

    (want, want_parts), want_g = jax.value_and_grad(jax_total, has_aux=True)(jax.tree.map(jnp.asarray, outs))
    tout = {k: [t(a).requires_grad_() for a in v] for k, v in outs.items()}
    got, parts = tfn(tout, t(boxes), t(mask))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    assert set(parts) == set(want_parts)
    for k in parts:
        np.testing.assert_allclose(float(parts[k]), float(want_parts[k]), rtol=1e-5, err_msg=k)
    for k, leaves in tout.items():
        for i, leaf in enumerate(leaves):
            w = np.asarray(want_g[k][i])
            g = np.zeros_like(w) if leaf.grad is None else leaf.grad.numpy()
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * max(np.abs(w).max(), 1e-12), err_msg=f"{k}[{i}]")


def test_warmup_constant_schedule_matches_optax():
    want = optax.join_schedules([optax.linear_schedule(0.0, 4e-4, 5), optax.constant_schedule(4e-4)], [5])
    sched = trt.WarmupConstant(4e-4, 5)
    for count in range(12):
        assert abs(sched(count) - float(want(count))) <= 1e-9, count
    assert sched(0) == 0.0 and trt.WarmupConstant(1e-4, 0)(0) == 1e-4
    # the demo's rule: warmup min(100, steps // 10), cosine to 0.05 lr
    cos = optax.warmup_cosine_decay_schedule(0.0, 4e-4, 3, 30, end_value=2e-5)
    mine = WarmupCosineDecay(4e-4, 3, 30, 2e-5)
    for count in range(35):
        assert abs(mine(count) - float(cos(count))) <= 1e-9, count


def test_clip_and_adamw_steps_match_optax_on_given_gradients():
    """RtDetrTrainer's optimizer: clip at 0.1, AdamW weight decay 1e-4 on
    every leaf, warmup 2 then constant; gradients above and below the clip."""
    rng = np.random.default_rng(9)
    params = [rng.standard_normal(s).astype(np.float32) for s in ((4, 3), (5,), (2, 2, 3))]
    grads = [[(rng.standard_normal(p.shape) * s).astype(np.float32) for p in params] for s in (1.0, 0.01, 0.3)]
    sched = optax.join_schedules([optax.linear_schedule(0.0, 1e-2, 2), optax.constant_schedule(1e-2)], [2])
    tx = optax.chain(optax.clip_by_global_norm(0.1), optax.adamw(sched, weight_decay=1e-4))
    jp, state = [jnp.asarray(p) for p in params], None
    state = tx.init(jp)
    tp = [torch.nn.Parameter(t(p)) for p in params]
    opt = ClippedAdamW(tp, trt.WarmupConstant(1e-2, 2), weight_decay=1e-4, max_norm=0.1)
    for g in grads:
        updates, state = tx.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, updates)
        for p, x in zip(tp, g):
            p.grad = t(x.copy())
        opt.step()
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=0, atol=1e-6)
    assert max(float(np.abs(a.detach().numpy() - p).max()) for a, p in zip(tp, params)) > 1e-3
