"""The port's YOLO training (facedet_tpu_torch/train/yolo_train.py and the
train-mode ``FlaxBatchNorm2d``) against facedet_tpu/train/yolo_train.py on
the CPU, float32 on both sides.

Tolerances, stated per check: BatchNorm running statistics within 1e-6 of
flax's; ``tal_assign``'s fg and best_gt equal, norm_align within 1e-6;
``yolo_loss`` total and parts within 1e-5 relative, gradients on the level
maps within 1e-5 of each map's largest; through the whole model (yolo11n,
128x128, batch 2, golden weights; the convs sum in another order, which
moves the maps by about 2e-4; at 64x64 the deepest BatchNorm sees 8 values
per channel and that noise reached 1.3e-4 of one leaf's gradient) the loss
parts within 1e-4 relative, gradients within 1e-4 of each leaf's largest |g|
or 1e-6 of the largest over all leaves, whichever is larger (a leaf whose
gradient is 0 in exact arithmetic, such as a bias shifted away by the
train-mode BatchNorm after it, holds rounding noise only), the
running statistics after that step within 1e-5 (relative to 1); the
schedule within 1e-9 of optax's; the clip and three AdamW steps on the same
given gradients within 1e-6; one SGD step and one staged step with flip
within 5e-5 (tests/test_train.py's tolerance for a step); the flipped
batch equal bit for bit; bfloat16 against float32 loss within 5e-2
relative.
"""
import copy
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from facedet_tpu.engine.detector import load_params_npz as jax_load_params_npz
from facedet_tpu.models.yolov11 import YoloConfig as JaxYoloConfig
from facedet_tpu.models.yolov11 import YoloV11 as JaxYoloV11
from facedet_tpu.train import yolo_train as jyt
from facedet_tpu_torch.models import from_jax
from facedet_tpu_torch.models.layers import FlaxBatchNorm2d
from facedet_tpu_torch.models.yolov11 import YoloConfig, YoloV11
from facedet_tpu_torch.train import yolo_train as tyt

torch.set_num_threads(1)

CKPT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "facedet_tpu", "eval", "assets", "yolo11n_golden.npz",
)


def make_batch(b=2, m=3, size=64, seed=0):
    """tests/test_train.py's batch: random boxes, one dead row per image,
    keypoints at the box centres."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(4, size - 24, (b, m, 2))
    wh = rng.uniform(8, 20, (b, m, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    mask = np.ones((b, m), bool)
    mask[:, -1] = False
    kpts = np.zeros((b, m, 5, 3), np.float32)
    kpts[..., 0] = boxes[..., None, 0] + wh[..., None, 0] / 2
    kpts[..., 1] = boxes[..., None, 1] + wh[..., None, 1] / 2
    kpts[..., 2] = 1.0
    images = rng.uniform(0, 1, (b, size, size, 3)).astype(np.float32)
    return images, boxes, mask, kpts


def t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def leaf_state(tree):
    """flax tree (params or grads) -> the port's names, as torch tensors."""
    return from_jax.from_jax_variables(jax.tree.map(np.array, tree))


@pytest.fixture(scope="module")
def golden():
    """(flax model, flax variables, a function making the port's model with
    the same weights)."""
    variables = jax_load_params_npz(CKPT)
    tree = from_jax.load_params_npz(CKPT)

    def port(cfg=YoloConfig(scale="n")):
        m = YoloV11(cfg)
        from_jax.load_jax_variables(m, tree)
        return m

    return JaxYoloV11(JaxYoloConfig(scale="n")), variables, port


@pytest.fixture(scope="module")
def jax_grad(golden):
    """jitted value_and_grad of the flax train-mode loss: (loss, (parts,
    batch_stats)), grads. One compile, shared by the tests below."""
    model = golden[0]

    def loss_fn(params, batch_stats, images, boxes, mask, kpts):
        outs, mutated = model.apply(
            {"params": params, "batch_stats": batch_stats}, images, train=True, mutable=["batch_stats"]
        )
        total, parts = jyt.yolo_loss(outs, boxes, mask, kpts)
        return total, (parts, mutated["batch_stats"])

    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


# --- the train-mode BatchNorm (the port's fault 1) ---------------------------

@pytest.mark.parametrize("momentum,eps", [(0.97, 1e-3), (0.99, 1e-5)], ids=["yolo-0.97", "flax-default-0.99"])
def test_batchnorm_train_statistics_match_flax(momentum, eps):
    """The roadmap's 2x3x3x4 case (NHWC): one train forward, then the running
    statistics within 1e-6 of flax's ``mutated["batch_stats"]``, the output
    and the input / scale / bias gradients within 1e-5."""
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((2, 3, 3, 4)) * 1.5 + 0.3).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 4).astype(np.float32)
    bias = rng.standard_normal(4).astype(np.float32)
    mean0 = (rng.standard_normal(4) * 0.2).astype(np.float32)
    var0 = rng.uniform(0.5, 2.0, 4).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, momentum=momentum, epsilon=eps)
    variables = {"params": {"scale": scale, "bias": bias}, "batch_stats": {"mean": mean0, "var": var0}}

    def f(params, x):
        y, mutated = bn.apply({"params": params, "batch_stats": variables["batch_stats"]}, x,
                              mutable=["batch_stats"])
        return (y * y).sum(), (y, mutated["batch_stats"])

    (_, (want_y, stats)), (g_params, g_x) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        variables["params"], jnp.asarray(x)
    )

    m = FlaxBatchNorm2d(4, eps=eps, flax_momentum=momentum)
    from_jax.load_jax_variables(m, variables)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    y = m.train()(xt)
    (y * y).sum().backward()
    np.testing.assert_allclose(m.running_mean.numpy(), np.asarray(stats["mean"]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(m.running_var.numpy(), np.asarray(stats["var"]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(y.detach().permute(0, 2, 3, 1).numpy(), np.asarray(want_y), atol=1e-5)
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(), np.asarray(g_x), atol=1e-5)
    np.testing.assert_allclose(m.weight.grad.numpy(), np.asarray(g_params["scale"]), atol=1e-5)
    np.testing.assert_allclose(m.bias.grad.numpy(), np.asarray(g_params["bias"]), atol=1e-5)
    # torch's own update (momentum 1 - m, unbiased variance) is what this replaces
    stock = torch.nn.BatchNorm2d(4, eps=eps, momentum=1 - momentum)
    from_jax.load_jax_variables(stock, variables)
    stock.train()(xt.detach())
    assert np.abs(stock.running_var.numpy() - np.asarray(stats["var"])).max() > 1e-4


def test_batchnorm_eval_mode_is_nn_batchnorm():
    rng = np.random.default_rng(8)
    m = FlaxBatchNorm2d(6, eps=1e-3, flax_momentum=0.97)
    stock = torch.nn.BatchNorm2d(6, eps=1e-3)
    for mod in (m, stock):
        with torch.no_grad():
            mod.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, 6).astype(np.float32)))
    stock.load_state_dict(m.state_dict())
    x = torch.from_numpy(rng.standard_normal((3, 6, 5, 5)).astype(np.float32))
    assert torch.equal(m.eval()(x), stock.eval()(x))
    assert list(m.state_dict()) == list(stock.state_dict())


# --- assigner and loss --------------------------------------------------------

def test_tal_assign_matches_jax():
    """The 8x8 grid of tests/test_train.py:77, random predictions and GT
    (one dead row), per image and batched."""
    rng = np.random.default_rng(3)
    ys = (np.arange(8) + 0.5) * 8
    anchors = np.stack(np.meshgrid(ys, ys, indexing="ij"), -1).reshape(-1, 2)[:, ::-1].astype(np.float32)
    b, m = 3, 4
    half = rng.uniform(3, 14, (b, 64, 2))
    pred = np.concatenate([anchors - half, anchors + half], -1).astype(np.float32)
    scores = rng.uniform(0.05, 0.95, (b, 64, 1)).astype(np.float32)
    xy = rng.uniform(0, 40, (b, m, 2))
    gt = np.concatenate([xy, xy + rng.uniform(10, 30, (b, m, 2))], -1).astype(np.float32)
    mask = np.ones((b, m), bool)
    mask[:, -1] = False
    batched = tyt.tal_assign(*t(anchors, pred, scores, gt, mask))
    for i in range(b):
        want = [np.asarray(v) for v in jyt.tal_assign(*(jnp.asarray(a) for a in (anchors, pred[i], scores[i], gt[i], mask[i])))]
        got = [v.numpy() for v in tyt.tal_assign(*t(anchors, pred[i], scores[i], gt[i], mask[i]))]
        assert want[0].sum() > 0
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1][want[0]], want[1][want[0]])
        np.testing.assert_allclose(got[2], want[2], rtol=0, atol=1e-6)
        for g, bt in zip(got, batched):
            np.testing.assert_array_equal(g, bt[i].numpy())


def _level_maps(seed, b=2, size=64, kpt=True):
    rng = np.random.default_rng(seed)
    maps = []
    for s in (8, 16, 32):
        h = size // s
        lvl = {"box": rng.standard_normal((b, h, h, 64)).astype(np.float32),
               "cls": (rng.standard_normal((b, h, h, 1)) - 2).astype(np.float32)}
        if kpt:
            lvl["kpt"] = (rng.standard_normal((b, h, h, 15)) * 0.5).astype(np.float32)
        maps.append(lvl)
    return maps


@pytest.mark.parametrize("use_tal", [True, False], ids=["tal", "nearest"])
@pytest.mark.parametrize("with_kpts", [True, False], ids=["kpts", "no-kpts"])
def test_yolo_loss_and_its_gradients_match_jax(use_tal, with_kpts):
    """The same raw level maps (numpy) into both losses: total and parts
    within 1e-5 relative, d total / d map within 1e-5 of each map's largest."""
    maps = _level_maps(11, kpt=with_kpts)
    _, boxes, mask, kpts = make_batch(m=4, seed=12)
    kp = kpts if with_kpts else None

    def jf(lv):
        return jyt.yolo_loss(lv, jnp.asarray(boxes), jnp.asarray(mask), None if kp is None else jnp.asarray(kp),
                             use_tal=use_tal)

    (want, want_parts), want_g = jax.value_and_grad(jf, has_aux=True)(jax.tree.map(jnp.asarray, maps))
    tmaps = [{k: torch.from_numpy(v).requires_grad_() for k, v in lv.items()} for lv in maps]
    got, parts = tyt.yolo_loss(tmaps, *t(boxes, mask), None if kp is None else torch.from_numpy(kp), use_tal=use_tal)
    got.backward()
    got, parts = got.detach(), {k: v.detach() for k, v in parts.items()}
    assert set(parts) == set(want_parts) == ({"box", "cls", "dfl", "kpt", "kobj"} if with_kpts else {"box", "cls", "dfl"})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    for k in want_parts:
        np.testing.assert_allclose(float(parts[k]), float(want_parts[k]), rtol=1e-5, err_msg=k)
    for lv_t, lv_j in zip(tmaps, want_g):
        for k, g in lv_j.items():
            g = np.asarray(g)
            np.testing.assert_allclose(lv_t[k].grad.numpy(), g, rtol=0, atol=1e-5 * np.abs(g).max(), err_msg=k)


# --- whole model --------------------------------------------------------------

@pytest.fixture(scope="module")
def model_step(golden, jax_grad):
    """One train-mode loss and backward through yolo11n on both sides."""
    _, variables, port = golden
    batch = make_batch(size=128)
    (loss, (parts, stats)), grads = jax_grad(variables["params"], variables["batch_stats"],
                                             *(jnp.asarray(a) for a in batch))
    model = port()
    total, tparts = tyt.compute_loss(model, *t(*batch))
    total.backward()
    total, tparts = total.detach(), {k: v.detach() for k, v in tparts.items()}
    return {"jax": (loss, parts, stats, grads), "port": (model, total, tparts), "batch": batch}


def test_whole_model_gradients_match_jax(model_step):
    loss, parts, _, grads = model_step["jax"]
    model, total, tparts = model_step["port"]
    np.testing.assert_allclose(float(total), float(loss), rtol=1e-4)
    for k in parts:
        np.testing.assert_allclose(float(tparts[k]), float(parts[k]), rtol=1e-4, err_msg=k)
    want = leaf_state({"params": grads})
    got = dict(model.named_parameters())
    assert set(want) == set(got)
    top = max(float(np.abs(np.asarray(g)).max()) for g in jax.tree.leaves(grads))
    for name, g in want.items():
        g = g.numpy()
        np.testing.assert_allclose(got[name].grad.numpy(), g, rtol=0, atol=max(1e-4 * np.abs(g).max(), 1e-6 * top),
                                   err_msg=name)


def test_whole_model_batchnorm_statistics_after_the_step(model_step):
    stats = model_step["jax"][2]
    model = model_step["port"][0]
    want = leaf_state({"batch_stats": stats})
    buffers = dict(model.named_buffers())
    assert len(want) == 2 * sum(isinstance(m, FlaxBatchNorm2d) for m in model.modules())
    for name, v in want.items():
        np.testing.assert_allclose(buffers[name].numpy(), v.numpy(), rtol=1e-5, atol=1e-5, err_msg=name)


def test_sgd_train_step_matches_jax(golden, model_step):
    """One ``make_train_step`` with SGD(1e-3): the parameters equal flax's
    ``p - 1e-3 g`` (optax.sgd's update) within 5e-5, the statistics flax's."""
    _, variables, port = golden
    model = port()
    step = tyt.make_train_step(model, torch.optim.SGD(model.parameters(), lr=1e-3))
    loss, parts = step(*t(*model_step["batch"]))
    jloss, _, stats, grads = model_step["jax"]
    assert abs(float(loss) - float(jloss)) < 1e-3
    new = jax.tree.map(lambda p, g: np.asarray(p) - np.float32(1e-3) * np.asarray(g), variables["params"], grads)
    want = leaf_state({"params": new, "batch_stats": stats})
    got = model.state_dict()
    for name, v in want.items():
        np.testing.assert_allclose(got[name].numpy(), v.numpy(), atol=5e-5, err_msg=name)


def test_six_adamw_steps_lower_the_loss(golden):
    model = golden[2]()
    tx = tyt.make_optimizer(model.parameters(), lr=5e-3, warmup_steps=1)
    step = tyt.make_train_step(model, tx)
    batch = t(*make_batch(seed=5))
    losses = [float(step(*batch)[0]) for _ in range(6)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


def test_bfloat16_config_trains_float32_master_weights(golden):
    """A bfloat16 config: the forward runs bfloat16 convs, the parameters
    and their gradients stay float32; its loss within 5e-2 of float32's."""
    batch = t(*make_batch(seed=2))
    losses = {}
    for dtype in ("float32", "bfloat16"):
        model = golden[2](YoloConfig(scale="n", dtype=dtype))
        step = tyt.make_train_step(model, torch.optim.SGD(model.parameters(), lr=1e-3))
        losses[dtype] = float(step(*batch)[0])
        assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32 for p in model.parameters())
        assert model.backbone.stem.conv.weight.dtype == torch.float32
    assert np.isfinite(losses["bfloat16"])
    np.testing.assert_allclose(losses["bfloat16"], losses["float32"], rtol=5e-2)


# --- optimizer ----------------------------------------------------------------

@pytest.mark.parametrize("warmup", [100, 0])
def test_schedule_matches_optax(warmup):
    want = optax.warmup_cosine_decay_schedule(0.0, 1e-3, warmup, 10_000, 1e-5)
    got = tyt.WarmupCosineDecay(1e-3, warmup, 10_000, 1e-5)
    for count in range(121):
        assert abs(got(count) - float(want(count))) <= 1e-9, count
    if warmup:
        assert got(0) == 0.0 and float(want(0)) == 0.0
    # and the rate AdamW is stepped with, count by count
    p = torch.nn.Parameter(torch.zeros(3))
    tx = tyt.make_optimizer([p], lr=1e-3, warmup_steps=warmup)
    for count in range(5):
        assert abs(tx.optimizer.param_groups[0]["lr"] - float(want(count))) <= 1e-9
        p.grad = torch.ones(3)
        tx.step()


@pytest.mark.parametrize("scale", [0.1, 30.0], ids=["below", "above"])
def test_clip_by_global_norm_matches_optax(scale):
    rng = np.random.default_rng(4)
    grads = [rng.standard_normal(s).astype(np.float32) * scale for s in ((4, 5), (7,), (2, 3, 3))]
    want, _ = optax.clip_by_global_norm(10.0).update([jnp.asarray(g) for g in grads], optax.EmptyState())
    got = t(*grads)
    norm = tyt.clip_by_global_norm_(got, 10.0)
    assert (float(norm) < 10.0) == (scale < 1)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)


def test_adamw_on_given_gradients_matches_optax():
    """Three steps of ``make_optimizer`` against optax's chain on the same
    given gradients (the first one clipped; the first step at lr 0):
    parameters within 1e-6. Adam's first step is about lr * sign(g), so
    the comparison goes through given gradients, not through a model."""
    rng = np.random.default_rng(9)
    shapes = ((6, 3, 3, 3), (6,), (6,))
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) * (20.0 if i == 0 else 0.3) for s in shapes] for i in range(3)]
    tx = jyt.make_optimizer(lr=1e-2, weight_decay=5e-4, warmup_steps=2)
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = tyt.make_optimizer(tp, lr=1e-2, weight_decay=5e-4, warmup_steps=2)
    for i, g in enumerate(grads):
        updates, state = tx.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, updates)
        for p, x in zip(tp, g):
            p.grad = torch.from_numpy(x.copy())
        opt.step()
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=0, atol=1e-6, err_msg=f"step {i}")
    assert np.abs(tp[0].detach().numpy() - params[0]).max() > 1e-3  # it moved


# --- the staged loop ----------------------------------------------------------

def staged_data(n=3, b=2, m=3, size=64, seed=5):
    """uint8 staged batches with zeroed dead GT rows (tests/test_train.py's)."""
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 255, (n, b, size, size, 3), dtype=np.uint8)
    xy = rng.uniform(4, size - 24, (n, b, m, 2))
    wh = rng.uniform(8, 20, (n, b, m, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    mask = np.ones((n, b, m), bool)
    mask[:, :, -1] = False
    boxes[~mask] = 0.0
    kpts = np.zeros((n, b, m, 5, 3), np.float32)
    kpts[..., 0] = rng.uniform(boxes[..., None, 0], boxes[..., None, 2])
    kpts[..., 1] = rng.uniform(boxes[..., None, 1], boxes[..., None, 3])
    kpts[..., 2] = mask[..., None]
    return images, boxes, mask, kpts


def test_staged_loop_without_flip_is_the_stepwise_run(golden):
    """Four steps over three staged batches (wrapping round): the same
    parameters, statistics and mean loss as ``make_train_step`` on the
    same batches."""
    data = t(*staged_data())
    a, b = golden[2](), golden[2]()
    run = tyt.make_staged_train_loop(a, torch.optim.SGD(a.parameters(), lr=1e-3), steps_per_dispatch=4, flip=False)
    mean = run(*data, start=1)
    step = tyt.make_train_step(b, torch.optim.SGD(b.parameters(), lr=1e-3))
    losses = []
    for i in range(4):
        j = (1 + i) % 3
        losses.append(float(step(data[0][j].float() * (1.0 / 255.0), data[1][j], data[2][j], data[3][j])[0]))
    np.testing.assert_allclose(float(mean), np.mean(losses), rtol=1e-6)
    for (name, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        np.testing.assert_array_equal(x.numpy(), y.numpy(), err_msg=name)


class _Probe(fnn.Module):
    """A flax 'model' that hands its input on (and owns one parameter)."""

    @fnn.compact
    def __call__(self, x, train=False):
        return {"img": x + self.param("w", fnn.initializers.zeros_init(), ())}


class _TorchProbe(torch.nn.Module):
    cfg = YoloConfig(scale="n")  # float32

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(()))

    def forward(self, x):
        return {"img": x + self.w}


def _flips(key, steps, b):
    return np.stack([np.asarray(jax.random.bernoulli(jax.random.fold_in(key, i), shape=(b,))) for i in range(steps)])


def test_staged_flip_equals_the_jax_loop_bit_for_bit():
    """The JAX staged loop's own flipped batches (seen through its ``loss``
    hook) against the port's, given the JAX draws: images, boxes, mask and
    keypoints equal bit for bit, five-landmark permutation included."""
    images, boxes, mask, kpts = staged_data(n=2, b=3, seed=6)
    key, steps = jax.random.PRNGKey(4), 3
    flips = _flips(key, steps, 3)
    assert flips.any() and not flips.all()
    seen = {"jax": [], "port": []}

    def jax_hook(outs, bx, mk, kp):
        jax.debug.callback(lambda *a: seen["jax"].append([np.asarray(x) for x in a]),
                           outs["img"], bx, mk, kp, ordered=True)
        return jnp.mean(outs["img"]), {}

    def port_hook(outs, bx, mk, kp):
        seen["port"].append([x.detach().numpy().copy() for x in (outs["img"], bx, mk, kp)])
        return outs["img"].mean(), {}

    probe = _Probe()
    params = probe.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))["params"]
    tx = optax.sgd(0.0)
    run = jax.jit(jyt._staged_run_fn(probe, tx, steps, True, loss=jax_hook))
    out = run(params, {}, tx.init(params), *(jnp.asarray(a) for a in (images, boxes, mask, kpts)), 1, key)
    jax.block_until_ready(out)
    jax.effects_barrier()
    tp = _TorchProbe()
    port_run = tyt.make_staged_train_loop(tp, torch.optim.SGD(tp.parameters(), lr=0.0), steps, True, loss=port_hook)
    port_run(*t(images, boxes, mask, kpts), start=1, flips=torch.from_numpy(flips))
    assert len(seen["jax"]) == len(seen["port"]) == steps
    for i, (want, got) in enumerate(zip(seen["jax"], seen["port"])):
        for name, w, g in zip(("image", "boxes", "mask", "kpts"), want, got):
            np.testing.assert_array_equal(g, w, err_msg=f"step {i} {name}")


def test_staged_flip_step_matches_jax(golden):
    """One staged step with flip through yolo11n, SGD(1e-3), the JAX draws
    given: parameters within 5e-5 of the JAX staged loop's."""
    model_j, variables, port = golden
    images, boxes, mask, kpts = staged_data(n=2, b=2, seed=8)
    key = jax.random.PRNGKey(1)
    flips = _flips(key, 1, 2)
    assert flips.any() and not flips.all()
    tx = optax.sgd(1e-3)
    run = jax.jit(jyt._staged_run_fn(model_j, tx, 1, True))
    p, bs, _, loss = run(variables["params"], variables["batch_stats"], tx.init(variables["params"]),
                         *(jnp.asarray(a) for a in (images, boxes, mask, kpts)), 1, key)
    model = port()
    port_run = tyt.make_staged_train_loop(model, torch.optim.SGD(model.parameters(), lr=1e-3), 1, True)
    got_loss = port_run(*t(images, boxes, mask, kpts), start=1, flips=torch.from_numpy(flips))
    assert abs(float(got_loss) - float(loss)) < 1e-3
    want = leaf_state({"params": p, "batch_stats": bs})
    got = model.state_dict()
    for name, v in want.items():
        np.testing.assert_allclose(got[name].numpy(), v.numpy(), atol=5e-5, err_msg=name)


def test_staged_loop_default_draws_are_seeded(golden):
    """Without given draws the flips come from the loop's seeded generator:
    two loops with one seed train the same parameters."""
    data = t(*staged_data(n=2, b=2, seed=9))
    states = []
    for _ in range(2):
        m = copy.deepcopy(golden[2]())
        run = tyt.make_staged_train_loop(m, torch.optim.SGD(m.parameters(), lr=1e-3), 2, True, seed=3)
        assert np.isfinite(float(run(*data)))
        states.append(m.state_dict())
    for name in states[0]:
        assert torch.equal(states[0][name], states[1][name]), name
