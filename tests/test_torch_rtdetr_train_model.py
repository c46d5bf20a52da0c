"""The port's RT-DETR training step through the whole model: ``rtdetr-tiny``
in train mode with contrastive denoising (5 groups) against
``jax.value_and_grad`` of the flax model and facedet_tpu's ``rtdetr_loss``
on the CPU, float32, with seeded weights carried across by
``models/from_jax.py``, and the staged loop against the JAX loop.

Tolerances: ``_bilinear_sample``'s value within 1e-5 and its gradients on
the features and on the sampling coordinates within 1e-4 of their largest
(``grid_sample`` works in normalised coordinates). Through the whole model
at 256x256, batch 2 (the deepest BatchNorms see 128 values per channel),
matcher Hungarian on both sides, the same query selection and assignments
first: logits within 5e-4 (train-mode BatchNorm), the loss parts within 1e-4 relative, gradients
within 3e-4 of each leaf's largest |g| or 1e-6 of the largest over all
leaves, whichever is larger, the BatchNorm statistics after the step within
1e-5 (relative to 1). The gradient bound is three times
tests/test_torch_train.py's: the deformable sampling's gradient jumps where a
sampling point crosses a pixel and the train-mode BatchNorms amplify
rounding, so float32 runs of either package lie up to 2.3e-3 of a leaf's
largest from a float64 run of the port at this size, and agree with each
other to 1.6e-4. The test holds JAX against itself with the images moved by
about one ulp first (within the same bound): at inputs near such a jump, which moves
some leaves by 5%, and no bound would compare the packages there. Two staged
SGD steps (lr 1e-2) fed JAX's flip and CDN draws: the mean loss within 2e-4
relative, the parameter update over all leaves within 1e-2 of its norm.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from facedet_tpu.models import rtdetr as jax_rtdetr
from facedet_tpu.train import rtdetr_train as jrt
from facedet_tpu_torch.models import from_jax
from facedet_tpu_torch.models import rtdetr as trt_model
from facedet_tpu_torch.train import rtdetr_train as trt
from test_torch_rtdetr_train import jax_cdn_draws
from test_torch_scrfd import seeded_variables

torch.set_num_threads(1)

CFG = "rtdetr-tiny"
SIZE, GROUPS = 256, 5


def test_bilinear_sample_gradients_match_jax():
    """JAX's hand-written bilinear gather against ``grid_sample``: the value
    and the gradients on the features and on the coordinates (points
    inside, on the border and outside the map)."""
    rng = np.random.default_rng(40)
    feat = rng.standard_normal((7, 9, 6)).astype(np.float32)
    coords = np.concatenate([rng.uniform([-1.5, -1.5], [9.5, 7.5], (80, 2)),
                             [[-0.7, 3.2], [8.3, 6.4], [0.25, 0.75], [4.5, -0.6]]]).astype(np.float32)
    cot = rng.standard_normal((coords.shape[0], 6)).astype(np.float32)

    def f(feat, coords):
        return jnp.sum(jax_rtdetr._bilinear_sample(feat, coords) * cot)

    want, (g_feat, g_coords) = jax.value_and_grad(f, argnums=(0, 1))(jnp.asarray(feat), jnp.asarray(coords))
    tf, tc = torch.from_numpy(feat).requires_grad_(), torch.from_numpy(coords).requires_grad_()
    got = (trt_model._bilinear_sample(tf, tc) * torch.from_numpy(cot)).sum()
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    for g, w in ((tf.grad, g_feat), (tc.grad, g_coords)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max())


def _batch(seed=0, b=2, m=4):
    rng = np.random.default_rng(seed)
    images = rng.random((b, SIZE, SIZE, 3), np.float32)
    boxes = np.concatenate([rng.uniform(0.25, 0.75, (b, m, 2)), rng.uniform(0.08, 0.3, (b, m, 2))], -1).astype(np.float32)
    mask = np.ones((b, m), bool)
    mask[0, -1] = mask[1, -2:] = False
    boxes[~mask] = 0.0
    return images, boxes, mask


@pytest.fixture(scope="module")
def pair():
    """(flax model, seeded flax variables as numpy) at 256x256: shapes from
    ``eval_shape`` (flax's eager init takes tens of seconds)."""
    jm = jax_rtdetr.RtDetr(jax_rtdetr.RTDETR_VARIANTS[CFG])
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3))))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    return jm, seeded_variables(zeros, 30, gain=1.0)


def port_model(variables):
    model = trt_model.RtDetr(trt_model.RTDETR_VARIANTS[CFG])
    from_jax.load_jax_variables(model, variables)
    return model


@pytest.fixture(scope="module")
def jax_step(pair):
    """jitted value_and_grad of the flax train-mode CDN loss (Hungarian),
    returning the outputs too."""
    jm = pair[0]

    def loss_fn(params, batch_stats, images, boxes, mask, key):
        dn_labels, dn_ref, _ = jrt.build_cdn(key, boxes, mask, GROUPS, 1.0, 1)
        outs, mutated = jm.apply({"params": params, "batch_stats": batch_stats}, images, train=True,
                                 mutable=["batch_stats"], dn_labels=dn_labels, dn_ref=dn_ref, dn_groups=GROUPS)
        total, parts = jrt.rtdetr_loss(outs, boxes, mask, dn_groups=GROUPS, matcher="hungarian")
        return total, (parts, mutated["batch_stats"], outs)

    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


def test_whole_model_cdn_step_matches_jax(pair, jax_step):
    _, variables = pair
    images, boxes, mask = _batch()
    key = jax.random.PRNGKey(5)
    (want, (want_parts, want_stats, want_outs)), want_g = jax_step(
        variables["params"], variables["batch_stats"], images, boxes, mask, key)
    want_grads = from_jax.from_jax_variables({"params": jax.tree.map(np.asarray, want_g)})
    top = max(float(g.abs().max()) for g in want_grads.values())

    def bound(w, rel):
        return max(rel * float(np.abs(w).max()), 1e-6 * top)

    nudged = (images * (1 + np.random.default_rng(1).standard_normal(images.shape) * 6e-8)).astype(np.float32)
    nudged_g = from_jax.from_jax_variables({"params": jax.tree.map(
        np.asarray, jax_step(variables["params"], variables["batch_stats"], nudged, boxes, mask, key)[1])})
    for name, w in want_grads.items():
        assert float((nudged_g[name] - w).abs().max()) <= bound(w.numpy(), 3e-4), f"{name}: JAX moves at one ulp"
    part, sign = jax_cdn_draws(key, 2, GROUPS, boxes.shape[1])

    model = port_model(variables)
    total, parts, outs = trt.train_loss(model, torch.from_numpy(images), torch.from_numpy(boxes),
                                        torch.from_numpy(mask), GROUPS, part=torch.from_numpy(part),
                                        sign=torch.from_numpy(sign), matcher="hungarian")
    total.backward()
    # the query selection and every layer's assignments first
    score = np.asarray(want_outs["enc_logits"]).max(-1)
    np.testing.assert_array_equal(outs["top_idx"].numpy(), np.asarray(jax.lax.top_k(jnp.asarray(score), 60)[1]))
    for li, (lg, bx) in enumerate(zip(outs["logits"], outs["boxes"])):
        got_a = trt.layer_assignments(lg, bx, torch.from_numpy(boxes), torch.from_numpy(mask), "hungarian")
        w_lg, w_bx = want_outs["logits"][li], want_outs["boxes"][li]
        np.testing.assert_allclose(lg.detach().numpy(), np.asarray(w_lg), atol=5e-4)
        got_w = trt.layer_assignments(torch.from_numpy(np.asarray(w_lg)), torch.from_numpy(np.asarray(w_bx)),
                                      torch.from_numpy(boxes), torch.from_numpy(mask), "hungarian")
        np.testing.assert_array_equal(got_a.numpy(), got_w.numpy(), err_msg=f"layer {li}")
    assert len(outs["dn_logits"]) == 2 and outs["dn_logits"][0].shape == (2, 2 * GROUPS * 4, 1)

    np.testing.assert_allclose(float(total.detach()), float(want), rtol=1e-4)
    assert set(parts) == set(want_parts) == {"cls", "l1", "giou", "dn"}
    for k in parts:
        np.testing.assert_allclose(float(parts[k].detach()), float(want_parts[k]), rtol=1e-4, err_msg=k)
    checked = 0
    for name, p in model.named_parameters():
        w = want_grads[name].numpy()
        g = np.zeros_like(w) if p.grad is None else p.grad.numpy()
        np.testing.assert_allclose(g, w, rtol=0, atol=bound(w, 3e-4), err_msg=name)
        checked += 1
    assert checked == len(want_grads)
    # the hazards: layer 0's reference carries gradient into enc_bbox; enc_score gets none
    assert model.enc_score.weight.grad is None and not np.abs(want_grads["enc_score.weight"].numpy()).any()
    assert float(model.enc_bbox.weight.grad.abs().max()) > 0
    stats = from_jax.from_jax_variables({"batch_stats": jax.tree.map(np.asarray, want_stats)})
    own = model.state_dict()
    for name, s in stats.items():
        err = ((own[name] - s).abs() / s.abs().clamp(min=1.0)).max()
        assert float(err) <= 1e-5, (name, float(err))


def test_staged_loop_with_jax_draws_matches_the_jax_loop(pair):
    """Two SGD steps of the staged loop with flip and CDN, the flips and the
    noise drawn as the JAX loop draws them from its key; the staged images
    are ``_batch``'s, quantised."""
    jm, variables = pair
    n_staged, b, m, steps, lr = 2, 2, 3, 2, 1e-2
    staged = [_batch(seed=s, m=m) for s in range(n_staged)]
    images_u8 = np.stack([np.round(x[0] * 255).astype(np.uint8) for x in staged])
    boxes, mask = np.stack([x[1] for x in staged]), np.stack([x[2] for x in staged])
    key = jax.random.PRNGKey(9)
    tx = optax.sgd(lr)
    run = jrt.make_staged_rtdetr_loop(jm, tx, steps_per_dispatch=steps, dn_groups=GROUPS, flip=True)
    params, _, _, want_loss = run(variables["params"], variables["batch_stats"], tx.init(variables["params"]),
                                  images_u8, boxes, mask, 1, key)
    flips, parts, signs = [], [], []
    for i in range(steps):
        kf, k = jax.random.split(jax.random.fold_in(key, i))
        flips.append(np.asarray(jax.random.bernoulli(kf, shape=(b,))))
        part, sign = jax_cdn_draws(k, b, GROUPS, m)
        parts.append(part)
        signs.append(sign)
    assert np.concatenate(flips).any() and not np.concatenate(flips).all()

    model = port_model(variables)
    loop = trt.make_staged_rtdetr_loop(model, torch.optim.SGD(model.parameters(), lr=lr), steps_per_dispatch=steps,
                                       dn_groups=GROUPS, flip=True)
    got_loss = loop(torch.from_numpy(images_u8), torch.from_numpy(boxes), torch.from_numpy(mask), start=1,
                    flips=np.stack(flips), parts=torch.from_numpy(np.stack(parts)),
                    signs=torch.from_numpy(np.stack(signs)))
    np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=2e-4)
    want = from_jax.from_jax_variables({"params": jax.tree.map(np.asarray, params)})
    init = from_jax.from_jax_variables({"params": variables["params"]})
    err = den = 0.0
    for name, p in model.named_parameters():
        du = want[name] - init[name]
        err += float(((p.detach() - init[name]) - du).square().sum())
        den += float(du.square().sum())
    assert den > 0 and (err / den) ** 0.5 <= 1e-2, (err / den) ** 0.5
