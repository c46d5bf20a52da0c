"""Worker processes for the port's multi-device tests: a gloo process group
on the CPU, one process per rank. This module holds no test of its own.

The test files (tests/test_torch_parallel.py, test_torch_parallel_train.py)
compute the JAX references in their own process and hand arrays to these
workers through files in a scratch directory; this module imports torch,
numpy and facedet_tpu_torch only, never jax, so the spawned interpreters
start without it. Each worker writes ``rank{r}_{tag}.npz`` files that the
test reads back.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YOLO_CKPT = os.path.join(ROOT, "facedet_tpu", "eval", "assets", "yolo11n_golden.npz")
SLICED_640 = dict(slice_height=640, slice_width=640, overlap_height_ratio=0.25,
                  overlap_width_ratio=0.25, perform_standard_pred=True)
SLICED_FAKE = dict(slice_height=64, slice_width=64, overlap_height_ratio=0.25,
                   overlap_width_ratio=0.25, perform_standard_pred=False)
TRAIN_LR = 2e-5
TRAIN_WD = 5e-4
SGD_LR = 1e-3


def spawn(fn, world: int, workdir: str, *args):
    """Start ``world`` processes running ``fn(rank, world, workdir, *args)``
    inside a gloo group initialised through a file in ``workdir`` (no TCP
    port, so concurrent test workers cannot collide). Returns the context:
    ``join(ctx)`` waits and re-raises a worker's exception."""
    return mp.start_processes(_entry, args=(fn, world, workdir, args), nprocs=world,
                              join=False, start_method="spawn")


def join(ctx) -> None:
    while not ctx.join():
        pass


def _entry(rank, fn, world, workdir, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{workdir}/pg", rank=rank, world_size=world)
    try:
        fn(rank, world, workdir, *args)
    finally:
        dist.destroy_process_group()


def _save(workdir: str, rank: int, tag: str, **arrays) -> None:
    np.savez(os.path.join(workdir, f"rank{rank}_{tag}.npz"), **arrays)


def detections_arrays(det) -> dict:
    """The valid rows of merged ``Detections`` (either package's) as numpy,
    in descending score order (``Detections.to_numpy``)."""
    d = det.to_numpy()
    return {k: np.asarray(d[k]) for k in ("boxes", "scores", "kpts")}


# --- tests/test_torch_parallel.py ------------------------------------------------


def parallel_inference_worker(rank: int, world: int, workdir: str) -> None:
    """On a (1, world) CPU mesh: the FSDP plan of yolo11n; the golden yolo11n
    and the fake detector through ``get_sliced_prediction(mesh=)`` on every
    rank, and without a mesh on rank 0; a mesh of the wrong size raises."""
    from facedet_tpu_torch.engine.detector import YoloV11PoseDetectionModel
    from facedet_tpu_torch.engine.fake import FakeBlobDetectionModel
    from facedet_tpu_torch.engine.predict import get_sliced_prediction
    from facedet_tpu_torch.models.yolov11 import YoloConfig, YoloV11
    from facedet_tpu_torch.parallel import create_mesh, fsdp_param_shardings
    from torch.distributed.tensor import Shard

    try:
        create_mesh(world + 1)
        raised = False
    except ValueError:
        raised = True
    mesh = create_mesh(world, shape=(1, world))
    plan = fsdp_param_shardings(YoloV11(YoloConfig(scale="n")), mesh, axis="tile", min_size=1024)
    if rank == 0:
        names = sorted(plan)
        dims = [p[1].dim if isinstance(p[1], Shard) else -1 for p in (plan[n] for n in names)]
        _save(workdir, rank, "plan", names=np.array(names), dims=np.array(dims), wrong_size_raised=raised)

    data = np.load(os.path.join(workdir, "inputs.npz"))
    yolo = YoloV11PoseDetectionModel(model_path=YOLO_CKPT, scale="n", dtype="float32",
                                     confidence_threshold=0.25, image_size=640, device="cpu")
    sharded = get_sliced_prediction(data["photo"], yolo, mesh=mesh, **SLICED_640)
    _save(workdir, rank, "yolo_mesh", **detections_arrays(sharded.detections))
    fake = FakeBlobDetectionModel(confidence_threshold=0.5, device="cpu")
    fake_sharded = get_sliced_prediction(data["blob"], fake, mesh=mesh, **SLICED_FAKE)
    _save(workdir, rank, "fake_mesh", **detections_arrays(fake_sharded.detections))
    # an odd tile count: padded with zero tiles, their rows dropped
    from facedet_tpu_torch.parallel.sharding import shard_tile_batch_forward

    tiles = torch.from_numpy(data["odd_tiles"])
    odd = shard_tile_batch_forward(fake.tile_forward_nchw, mesh)(tiles, 0.5)
    want = fake.tile_forward_nchw(tiles, 0.5)
    _save(workdir, rank, "odd", **{f"got_{k}": getattr(odd, k).numpy() for k in ("boxes", "scores", "valid")},
          **{f"want_{k}": getattr(want, k).numpy() for k in ("boxes", "scores", "valid")})
    if rank == 0:
        plain = get_sliced_prediction(data["photo"], yolo, **SLICED_640)
        _save(workdir, rank, "yolo_plain", **detections_arrays(plain.detections))
        fake_plain = get_sliced_prediction(data["blob"], fake, **SLICED_FAKE)
        _save(workdir, rank, "fake_plain", **detections_arrays(fake_plain.detections))


# --- tests/test_torch_parallel_train.py --------------------------------------------


def _tx(params):
    from facedet_tpu_torch.train.yolo_train import ClippedAdamW

    return ClippedAdamW(params, lambda count: TRAIN_LR, TRAIN_WD)


def _sgd(params):
    return torch.optim.SGD(params, lr=SGD_LR)


def _model(workdir: str, dtype: str = "float32"):
    from facedet_tpu_torch.models.yolov11 import YoloConfig, YoloV11

    model = YoloV11(YoloConfig(scale="n", dtype=dtype))
    model.load_state_dict(torch.load(os.path.join(workdir, "state.pt")))
    return model


def _full(x: torch.Tensor) -> np.ndarray:
    from torch.distributed.tensor import DTensor

    return (x.full_tensor() if isinstance(x, DTensor) else x).detach().cpu().numpy()


def _train_state(model, opt) -> dict:
    """Every parameter, both AdamW moments and the BatchNorm buffers, whole
    (a collective for the sharded ones: every rank calls it)."""
    out = {**_params(model), **_moments(model, opt)}
    for name, b in model.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            out[f"stat/{name}"] = b.detach().cpu().numpy()
    return out


def _step_arrays(loss, parts, state: dict) -> dict:
    return {"loss": np.float32(loss), **{f"part/{k}": np.float32(v) for k, v in parts.items()}, **state}


def _params(model) -> dict:
    return {f"param/{n}": _full(p) for n, p in model.named_parameters()}


def _moments(model, opt) -> dict:
    out = {}
    for name, p in model.named_parameters():
        st = opt.optimizer.state[p]
        out[f"mu/{name}"], out[f"nu/{name}"] = _full(st["exp_avg"]), _full(st["exp_avg_sq"])
    return out


def parallel_train_worker(rank: int, world: int, workdir: str) -> None:
    """On a (2, 2) CPU mesh: one sharded AdamW step (every rank saves its
    view), the same step with per-rank BatchNorm statistics (the control),
    one sharded SGD step, the single-process AdamW and SGD steps and staged
    loop on rank 0,
    the clip of FSDP-sharded gradients, and two staged sharded steps fed
    JAX's flips and, as a control, the flips reversed."""
    from facedet_tpu_torch.models.layers import GroupBatchNorm2d
    from facedet_tpu_torch.parallel import create_mesh
    from facedet_tpu_torch.train import yolo_train as tyt

    mesh = create_mesh(world)
    data = {k: torch.from_numpy(v) for k, v in np.load(os.path.join(workdir, "batch.npz")).items()}
    batch = (data["images"], data["boxes"], data["mask"], data["kpts"])

    if rank == 0:
        model = _model(workdir)
        opt = _tx(list(model.parameters()))
        loss, parts = tyt.make_train_step(model, opt)(*batch)
        _save(workdir, rank, "single", **_step_arrays(loss, parts, _train_state(model, opt)))
        model = _model(workdir)
        tyt.make_train_step(model, _sgd(model.parameters()))(*batch)
        _save(workdir, rank, "single_sgd", **_params(model))
        model = _model(workdir)
        opt = _tx(list(model.parameters()))
        mean = tyt.make_staged_train_loop(model, opt, steps_per_dispatch=2, flip=True)(
            data["staged_images"], data["staged_boxes"], data["staged_mask"], data["staged_kpts"],
            start=0, flips=data["flips"])
        _save(workdir, rank, "single_staged", loss=np.float32(mean), **_params(model), **_moments(model, opt))

    model = _model(workdir)
    step, shard_state = tyt.make_sharded_train_step(model, _tx, mesh)
    opt = shard_state()
    loss, parts = step(*batch)
    _save(workdir, rank, "sharded", **_step_arrays(loss, parts, _train_state(model, opt)))

    # the control: the same step with each BatchNorm's group this rank alone
    own_group, _ = dist.new_subgroups(1)
    model = _model(workdir)
    step, shard_state = tyt.make_sharded_train_step(model, _tx, mesh)
    opt = shard_state()
    for m in model.modules():
        if isinstance(m, GroupBatchNorm2d):
            m.group = own_group
    loss, parts = step(*batch)
    state = _train_state(model, opt)
    if rank == 0:
        _save(workdir, rank, "per_rank_stats", **_step_arrays(loss, parts, state))

    model = _model(workdir)
    step, shard_state = tyt.make_sharded_train_step(model, _sgd, mesh)
    shard_state()
    step(*batch)
    _save(workdir, rank, "sharded_sgd", **_params(model))

    _clip_case(rank, workdir, mesh)

    staged = (data["staged_images"], data["staged_boxes"], data["staged_mask"], data["staged_kpts"])
    for tag, flips in (("staged", data["flips"]), ("staged_flipped", ~data["flips"])):
        model = _model(workdir)
        run, shard_state = tyt.make_sharded_staged_train_loop(model, _tx, mesh, steps_per_dispatch=2, flip=True)
        opt = shard_state()
        mean = run(*staged, start=0, flips=flips)
        arrays = {**_params(model), **_moments(model, opt)}  # collectives: every rank
        if rank == 0 or tag == "staged":
            _save(workdir, rank, tag, loss=np.float32(mean), **arrays)


class _Weighted(torch.nn.Module):
    """loss = sum(w * c) + sum(b * d): the gradients are c and d."""

    def __init__(self, c: torch.Tensor, d: torch.Tensor):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros_like(c))
        self.b = torch.nn.Parameter(torch.zeros_like(d))
        self.register_buffer("c", c)
        self.register_buffer("d", d)

    def forward(self):
        return (self.w * self.c).sum() + (self.b * self.d).sum()


def _clip_case(rank: int, workdir: str, mesh) -> None:
    """Gradients whose global norm exceeds 10 while each tile shard's does
    not: ``w`` sharded by ``fully_shard`` over ``tile``, ``b`` left
    replicated; clipped by ``clip_by_global_norm_`` against the same
    gradients unsharded."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    from facedet_tpu_torch.train.yolo_train import _average_replicated_grads, clip_by_global_norm_

    gen = torch.Generator().manual_seed(3)
    c = torch.randn(64, 48, generator=gen)
    d = torch.randn(5, generator=gen)
    scale = 12.0 / float(torch.cat([c.reshape(-1), d]).norm())
    c, d = c * scale, d * scale
    ref = [c.clone(), d.clone()]
    ref_norm = clip_by_global_norm_(ref, 10.0)
    m = _Weighted(c, d)
    fully_shard(m, mesh=mesh, shard_placement_fn=lambda p: Shard(0), ignored_params={m.b})
    m.set_force_sum_reduction_for_comms(True)
    m.set_gradient_divide_factor(float(mesh.size()))
    m().backward()
    _average_replicated_grads([m.b], mesh.size())
    shard_norm = float(m.w.grad.to_local().norm())
    norm = clip_by_global_norm_([m.w.grad, m.b.grad], 10.0)
    _save(workdir, rank, "clip", norm=np.float32(norm), ref_norm=np.float32(ref_norm),
          shard_norm=np.float32(shard_norm), w=_full(m.w.grad), b=_full(m.b.grad),
          ref_w=ref[0].numpy(), ref_b=ref[1].numpy())


# --- tests/test_torch_parallel_train_bf16.py ---------------------------------------


def parallel_train_bf16_worker(rank: int, world: int, workdir: str) -> None:
    """On a (1, world) CPU mesh with a bfloat16 config: one sharded AdamW
    step and two staged sharded steps fed JAX's flips on every rank; on rank
    0 the same single-process step and staged loop, and the single-process
    float32 step (the control)."""
    from facedet_tpu_torch.parallel import create_mesh
    from facedet_tpu_torch.train import yolo_train as tyt

    mesh = create_mesh(world, shape=(1, world))
    data = {k: torch.from_numpy(v) for k, v in np.load(os.path.join(workdir, "batch.npz")).items()}
    batch = (data["images"], data["boxes"], data["mask"], data["kpts"])
    staged = (data["staged_images"], data["staged_boxes"], data["staged_mask"], data["staged_kpts"])
    if rank == 0:
        for tag, dtype in (("single", "bfloat16"), ("single_float32", "float32")):
            model = _model(workdir, dtype)
            opt = _tx(list(model.parameters()))
            loss, parts = tyt.make_train_step(model, opt)(*batch)
            _save(workdir, rank, tag, **_step_arrays(loss, parts, _train_state(model, opt)))
        model = _model(workdir, "bfloat16")
        opt = _tx(list(model.parameters()))
        mean = tyt.make_staged_train_loop(model, opt, steps_per_dispatch=2, flip=True)(
            *staged, start=0, flips=data["flips"])
        _save(workdir, rank, "single_staged", loss=np.float32(mean), **_params(model), **_moments(model, opt))

    model = _model(workdir, "bfloat16")
    step, shard_state = tyt.make_sharded_train_step(model, _tx, mesh)
    opt = shard_state()
    loss, parts = step(*batch)
    _save(workdir, rank, "sharded", **_step_arrays(loss, parts, _train_state(model, opt)))

    model = _model(workdir, "bfloat16")
    run, shard_state = tyt.make_sharded_staged_train_loop(model, _tx, mesh, steps_per_dispatch=2, flip=True)
    opt = shard_state()
    mean = run(*staged, start=0, flips=data["flips"])
    _save(workdir, rank, "staged", loss=np.float32(mean), **_params(model), **_moments(model, opt))
