#!/usr/bin/env python3
"""Smoke run of facedet_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout

Phases, in order; any failure ends the run with a non-zero exit code:

1. device: the card's name and power limit, torch and CUDA versions;
2. build: every CUDA source of the port, compiled with nvcc for sm_90a;
3. kernels: each kernel held bit-exactly against its plain PyTorch version
   on the card (production grid, unaligned, out-of-range and T=1 offsets;
   uint8, float32, bfloat16; the batched CHW gather for B in 1, 3, 16) and
   timed with CUDA events beside its byte bound, its plain version and one
   PyTorch advanced-indexing call;
4. single-image main path, with the launch counts set to 0 first:
   get_sliced_prediction with the golden yolo11n weights in float32 (TF32
   off) held against the same call on the CPU, get_prediction likewise, the
   tile API (ops.tiler.gather_tiles + DetectionModel.forward_tiles) on the
   bfloat16 serving model, that model and the float32 one timed over 10
   images each, a profile of the bfloat16 run;
5. the app_yolo_sahi CLI; the counts are read after it;
6. ingest (float32, TF32 off): get_sliced_prediction with yuv420, dct420 and
   dct420s input on the card against the same call on the CPU, and the
   dct420s canvas against the dct420 canvas bit for bit;
7. batch (float32): get_sliced_prediction_batch of 8 same-size images
   against 8 single calls, and the batched gather's launch count;
8. serving main path at full width, with the launch counts set to 0 first:
   predict_stream_batched over dct420s input, batch 64, window 3, bfloat16,
   raw results: every image answered, in order, finite and inside the
   image; images per second (median of 3 passes), the same stream with rgb
   input, predict_stream per image, a profile of one batch and the host
   time of the staging;
9. folder run and CLI: predict() over a folder with ingest="dct420s", the CLI with
   --ingest yuv420, and one JPEG through the native coefficient reader where
   libjpeg's headers exist;
10. report: a ``kernels`` JSON line, the nvidia-smi line, and last the
   ``{"ok": true, "device": ...}`` line.

It imports nothing of jax or facedet_tpu and needs the checkout: run alone
it fails.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
CKPT = os.path.join(REPO, "facedet_tpu", "eval", "assets", "yolo11n_golden.npz")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
SLICE = 640
CANVAS = (1024, 1536)  # the production grid: 6 tiles of 640 at overlap 0.2

# Parity with the CPU run (the precedent of tests/test_parallel.py:116-127):
# float32 on both sides, TF32 off; convs sum in another order on the card.
BOX_ATOL, SCORE_ATOL, KPT_ATOL = 0.05, 1e-3, 0.1

# device kernels by what they do, matched on the lower-cased kernel name in order
PROFILE_GROUPS = [
    ("tile gather", ("tile_gather",)),
    ("gather, scatter and scan (row takes, sparse unpack)", ("scan", "scatter")),
    ("layout transposes inside cuDNN", ("nchwtonhwc", "nhwctonchw")),
    ("batch norm", ("bn_fw", "batch_norm")),
    ("convolution and matmul", ("conv", "xmma", "gemm", "implicit", "sm80_", "sm90_", "cutlass")),
    ("copies and casts", ("copy",)),
    ("host-device copies", ("memcpy", "memset")),
    ("sort and top-k", ("sort", "radix")),
    ("elementwise", ("elementwise", "silu")),
    ("reductions", ("reduce",)),
]

KERNELS = [
    {
        "name": "gather_hwc",
        "route": "cuda",
        "source": "facedet_tpu_torch/csrc/tile_gather.cu",
        "replaces": "facedet_tpu/ops/pallas/tile_gather.py:70",
    },
    {
        "name": "gather_chw",
        "route": "cuda",
        "source": "facedet_tpu_torch/csrc/tile_gather.cu",
        "replaces": "facedet_tpu/ops/pallas/tile_gather.py:114",
    },
    {
        # the same TPU kernel under jax.vmap (facedet_tpu/engine/predict.py:357-361)
        "name": "gather_chw_batched",
        "route": "cuda",
        "source": "facedet_tpu_torch/csrc/tile_gather.cu",
        "replaces": "facedet_tpu/ops/pallas/tile_gather.py:114",
    },
]
SERVING_BATCH = 64
SERVING_KW = dict(
    slice_height=SLICE, slice_width=SLICE, overlap_height_ratio=0.2, overlap_width_ratio=0.2,
    perform_standard_pred=True, postprocess_type="GREEDYNMM", postprocess_match_metric="IOS",
    postprocess_match_threshold=0.5, postprocess_class_agnostic=True, fetch_capacity=300,
)


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def phase(name):
    print(f"== {name}", flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def device_phase(torch):
    phase("1 device")
    check(torch.cuda.is_available(), "torch sees no CUDA device")
    count = torch.cuda.device_count()
    check(count >= 1, "no CUDA device")
    smi = nvidia_smi_line()
    print(f"nvidia-smi: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} sm_{''.join(map(str, torch.cuda.get_device_capability(0)))}, "
          f"{count} device(s)")
    return smi, count


def build_phase():
    phase("2 build")
    from facedet_tpu_torch.ops.kernels import build

    t0 = time.perf_counter()
    libs = build.build_all()
    print(f"built {sorted(libs)} in {time.perf_counter() - t0:.2f} s "
          f"(nvcc per source: {build.BUILD_SECONDS})")


def event_ms(torch, fn, reps=25, busy=True):
    """Median device time of one ``fn()`` over ``reps`` runs, after warm-up.
    With ``busy`` the stream is held by a sleep kernel while the host
    enqueues, so the span between the events is device time alone."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        if busy:
            torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def production_offsets():
    from facedet_tpu_torch.ops.tiler import bucket_tile_count, compute_slice_grid, pad_grid_offsets

    grid = compute_slice_grid(*CANVAS, SLICE, SLICE, 0.2, 0.2)
    offsets, _ = pad_grid_offsets(grid, bucket_tile_count(grid.num_tiles))
    return offsets


def kernel_phase(torch):
    """Returns {name: {max_abs_err, ms, plain_ms, bound_ms, bound_by, library_ms}}."""
    phase("3 kernels against their plain versions")
    import numpy as np

    from facedet_tpu_torch.ops.kernels import tile_gather as tg

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    h, w = CANVAS
    base = torch.randint(0, 256, (h, w, 3), generator=gen, device=dev, dtype=torch.uint8)
    prod = production_offsets()
    cases = {
        "production": prod,
        "unaligned": np.array([[3, 5], [51, 153], [383, 895], [1, 1]], np.int32),
        "out_of_range": np.array([[-5, 2000], [1000, -3], [-2000, 7], [0, 896]], np.int32),
        "T=1": np.array([[17, 33]], np.int32),
    }
    max_err = {"gather_hwc": 0.0, "gather_chw": 0.0}
    for dtype in (torch.uint8, torch.float32, torch.bfloat16):
        img = base.to(dtype)
        chw = img.permute(2, 0, 1).contiguous()
        for case, offs in cases.items():
            o = torch.from_numpy(offs).to(dev)
            for name, fn, ref, src in (
                ("gather_hwc", tg.gather_tiles_hwc, tg.gather_tiles_hwc_ref, img),
                ("gather_chw", tg.gather_tiles_chw, tg.gather_tiles_chw_ref, chw),
            ):
                got = fn(src, o, SLICE, SLICE)
                torch.cuda.synchronize()
                want = ref(src, o, SLICE, SLICE)
                check(got.shape == want.shape, f"{name} {dtype} {case}: shape {tuple(got.shape)}")
                err = float((got.float() - want.float()).abs().max())
                max_err[name] = max(max_err[name], err)
                check(torch.equal(got, want), f"{name} {dtype} {case}: differs from the plain version by {err}")
        print(f"{dtype}: both kernels bit-exact on {list(cases)}")
    # the batched CHW gather: B canvases of one size, one launch
    max_err["gather_chw_batched"] = 0.0
    for b in (1, 3, 16):
        batch = torch.randint(0, 256, (b, 3, h, w), generator=gen, device=dev, dtype=torch.uint8)
        for dtype in (torch.uint8, torch.float32, torch.bfloat16):
            src = batch.to(dtype)
            for case, offs in cases.items():
                o = torch.from_numpy(offs).to(dev)
                got = tg.gather_tiles_chw(src, o, SLICE, SLICE)
                torch.cuda.synchronize()
                want = tg.gather_tiles_chw_ref(src, o, SLICE, SLICE)
                check(got.shape == want.shape == (b * len(offs), 3, SLICE, SLICE),
                      f"gather_chw_batched B={b} {dtype} {case}: shape {tuple(got.shape)}")
                err = float((got.float() - want.float()).abs().max())
                max_err["gather_chw_batched"] = max(max_err["gather_chw_batched"], err)
                check(torch.equal(got, want),
                      f"gather_chw_batched B={b} {dtype} {case}: differs from the plain version by {err}")
            del src
        print(f"B={b}: batched CHW gather bit-exact on {list(cases)} in uint8, float32, bfloat16")
        del batch

    # timing at the main path's shapes: the bfloat16 serving canvas, 6 tiles
    t = prod.shape[0]
    covered = np.zeros(CANVAS, bool)
    for y, x in prod:
        covered[y : y + SLICE, x : x + SLICE] = True
    o = torch.from_numpy(prod).to(dev)
    ys = (o[:, 0, None] + torch.arange(SLICE, device=dev)).long()  # [T, S]
    xs = (o[:, 1, None] + torch.arange(SLICE, device=dev)).long()
    ch = torch.arange(3, device=dev)
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        img = base.to(dtype)
        chw = img.permute(2, 0, 1).contiguous()
        elem = img.element_size()
        # least traffic: the union of the windows read once, the tiles
        # written once, the offsets read once
        nbytes = int(covered.sum()) * 3 * elem + t * SLICE * SLICE * 3 * elem + prod.nbytes
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        forms = {
            "gather_hwc": (
                lambda: tg.gather_tiles_hwc(img, o, SLICE, SLICE),
                lambda: tg.gather_tiles_hwc_ref(img, o, SLICE, SLICE),
                lambda: img[ys[:, :, None, None], xs[:, None, :, None], ch],
            ),
            "gather_chw": (
                lambda: tg.gather_tiles_chw(chw, o, SLICE, SLICE),
                lambda: tg.gather_tiles_chw_ref(chw, o, SLICE, SLICE),
                lambda: chw[ch[None, :, None, None], ys[:, None, :, None], xs[:, None, None, :]],
            ),
        }
        for name, (kernel, plain, library) in forms.items():
            check(torch.equal(library(), plain()), f"{name}: the indexing yardstick differs")
            ms = event_ms(torch, kernel)
            plain_ms = event_ms(torch, plain, busy=False)  # it reads offsets on the host
            library_ms = event_ms(torch, library)
            print(f"{name} {str(dtype).split('.')[-1]} T={t} S={SLICE}: kernel {ms:.4f} ms, "
                  f"bound {bound_ms:.4f} ms ({nbytes / 1e6:.2f} MB), plain {plain_ms:.4f} ms, "
                  f"indexing {library_ms:.4f} ms, {nbytes / ms / 1e6:.0f} GB/s")
            if dtype == torch.bfloat16:  # the serving canvas goes in the report
                results[name] = {
                    "max_abs_err": max_err[name], "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": "bytes", "library_ms": library_ms,
                }
    # the batched form at the serving chunk: B=16 bfloat16 canvases, T=6
    bsz = 16
    batch = torch.randint(0, 256, (bsz, 3, h, w), generator=gen, device=dev, dtype=torch.uint8).to(torch.bfloat16)
    bidx = torch.arange(bsz, device=dev)
    nbytes = bsz * (int(covered.sum()) * 3 * 2 + t * SLICE * SLICE * 3 * 2) + prod.nbytes  # B x one image's traffic
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3

    def library():  # one advanced-indexing call: [B,T,3,S,S], flattened image-major
        return batch[bidx[:, None, None, None, None], ch[None, None, :, None, None],
                     ys[None, :, None, :, None], xs[None, :, None, None, :]].flatten(0, 1)

    check(torch.equal(library(), tg.gather_tiles_chw_ref(batch, o, SLICE, SLICE)),
          "gather_chw_batched: the indexing yardstick differs")
    ms = event_ms(torch, lambda: tg.gather_tiles_chw(batch, o, SLICE, SLICE))
    plain_ms = event_ms(torch, lambda: tg.gather_tiles_chw_ref(batch, o, SLICE, SLICE), busy=False)
    library_ms = event_ms(torch, library)
    print(f"gather_chw_batched bfloat16 B={bsz} T={t} S={SLICE}: kernel {ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({nbytes / 1e6:.2f} MB), plain {plain_ms:.4f} ms, indexing {library_ms:.4f} ms, "
          f"{nbytes / ms / 1e6:.0f} GB/s")
    results["gather_chw_batched"] = {
        "max_abs_err": max_err["gather_chw_batched"], "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "bytes", "library_ms": library_ms,
    }
    return results


def _compare(a, b, what):
    """Detections dicts (to_numpy) of the card and the CPU."""
    import numpy as np

    check(a["boxes"].shape == b["boxes"].shape,
          f"{what}: {len(a['boxes'])} detections on the card, {len(b['boxes'])} on the CPU")
    if len(a["boxes"]):
        err = {
            "boxes": float(np.abs(a["boxes"] - b["boxes"]).max()),
            "scores": float(np.abs(a["scores"] - b["scores"]).max()),
            "kpts": float(np.abs(a["kpts"][..., :2] - b["kpts"][..., :2]).max()),
        }
        check(err["boxes"] <= BOX_ATOL and err["scores"] <= SCORE_ATOL and err["kpts"] <= KPT_ATOL,
              f"{what}: card vs CPU {err}")
        print(f"{what}: {len(a['boxes'])} detections, card vs CPU max errors {err}")


def _serve(model, images, kw, label):
    """Wall ms of get_sliced_prediction per image (result on the host),
    after two images of warm-up, and the detections per image."""
    import numpy as np

    from facedet_tpu_torch import get_sliced_prediction

    times, found = [], []
    for i, im in enumerate(images):
        t0 = time.perf_counter()
        det = get_sliced_prediction(im, model, **kw).detections.to_numpy()
        dt = (time.perf_counter() - t0) * 1e3
        check(np.isfinite(det["boxes"]).all() and np.isfinite(det["kpts"]).all(), f"{label}: non-finite output")
        x, y = det["boxes"][:, 0::2], det["boxes"][:, 1::2]
        check((x >= 0).all() and (x <= CANVAS[1]).all() and (y >= 0).all() and (y <= CANVAS[0]).all(),
              f"{label}: boxes outside the image")
        found.append(len(det["boxes"]))
        if i >= 2:
            times.append(dt)
    check(sum(found) > 0, f"{label}: no detections on {len(images)} synthetic images")
    return times, found


def _profile(torch, run, wall_ms, n=3, images=1, label="bfloat16"):
    """Device time per image from torch.profiler over ``n`` runs of
    ``images`` images each, its share of the unprofiled wall time per image,
    and the kernels that take most of it."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            run()
        torch.cuda.synchronize()
    n *= images
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / n
    launches = sum(e.count for e in kernels) / n
    check(device_ms > 0, f"profile {label}: the profiler saw no device time")
    print(f"profile {label}: device busy {device_ms:.3f} ms/image in {launches:.0f} kernel launches, "
          f"{100 * device_ms / wall_ms:.1f}% of the {wall_ms:.3f} ms wall time")
    groups: dict[str, list] = {}
    for e in kernels:
        name = e.key.lower()
        group = next((g for g, keys in PROFILE_GROUPS if any(k in name for k in keys)), "other")
        acc = groups.setdefault(group, [0.0, 0])
        acc[0] += e.self_device_time_total / 1e3 / n
        acc[1] += e.count / n
    for group, (ms, count) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f"  {ms:8.3f} ms/image {count:8.1f} launches  {group}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.self_device_time_total / 1e3 / n:8.3f} ms/image  {e.count / n:8.1f}x  {e.key[:90]}")


def _reset_launches():
    from facedet_tpu_torch.ops.kernels import tile_gather as tg

    for k in tg.LAUNCHES:
        tg.LAUNCHES[k] = 0
    return tg.LAUNCHES


def load_models():
    """The golden yolo11n: float32 on the CPU and on the card (the parity
    pair) and the bfloat16 serving model on the card."""
    from facedet_tpu_torch import YoloV11PoseDetectionModel

    check(os.path.exists(CKPT), f"missing checkpoint {CKPT}")
    kw = dict(model_path=CKPT, scale="n", image_size=SLICE)
    return {
        "cpu": YoloV11PoseDetectionModel(dtype="float32", device="cpu", **kw),
        "cuda": YoloV11PoseDetectionModel(dtype="float32", device="cuda", **kw),
        "serving": YoloV11PoseDetectionModel(device="cuda", **kw),
    }


def main_path_phase(torch, models):
    """Drives the single-image entry points; returns the launch counts."""
    import numpy as np

    from facedet_tpu_torch import get_prediction, get_sliced_prediction
    from facedet_tpu_torch.apps import app_yolo_sahi
    from facedet_tpu_torch.ops.tiler import gather_tiles
    from facedet_tpu_torch.utils.synth import synthetic_faces
    from facedet_tpu_torch.utils.viz import save_image

    image = synthetic_faces(*CANVAS, seed=0, n=12)
    kw = dict(
        slice_height=SLICE, slice_width=SLICE, overlap_height_ratio=0.2, overlap_width_ratio=0.2,
        perform_standard_pred=True, postprocess_type="GREEDYNMM", postprocess_match_metric="IOS",
        postprocess_match_threshold=0.5,
    )
    want = get_sliced_prediction(image, models["cpu"], **kw).detections.to_numpy()
    want_single = get_prediction(image, models["cpu"]).object_prediction_list

    phase("4 single-image main path (launch counts from 0)")
    launches = _reset_launches()

    got = get_sliced_prediction(image, models["cuda"], **kw)
    check(launches["gather_chw"] > 0, "get_sliced_prediction did not launch the CHW gather")
    _compare(got.detections.to_numpy(), want, "get_sliced_prediction float32")
    check(len(want["boxes"]) > 0, "the golden model found nothing on the synthetic image")

    single = get_prediction(image, models["cuda"]).object_prediction_list
    to_np = lambda preds: {  # noqa: E731
        "boxes": np.array([p.bbox.to_xyxy() for p in preds], np.float32).reshape(-1, 4),
        "scores": np.array([p.score.value for p in preds], np.float32),
        "kpts": np.array([p.keypoints for p in preds], np.float32).reshape(-1, 5, 3),
    }
    _compare(to_np(single), to_np(want_single), "get_prediction float32")
    on_card = get_prediction(torch.from_numpy(image).cuda(), models["cuda"])
    _compare(to_np(on_card.object_prediction_list), to_np(want_single), "get_prediction float32, tensor on the card")
    check(np.array_equal(on_card.image, image), "get_prediction did not return the tensor input as the display image")

    serving = models["serving"]

    # the tile API, on the bfloat16 serving canvas: gather NHWC tiles and run
    # the detector on them
    canvas = (torch.from_numpy(image).cuda().float() / 255.0).to(torch.bfloat16)
    offsets = torch.from_numpy(production_offsets()).cuda()
    tiles = gather_tiles(canvas, offsets, SLICE, SLICE)
    per_tile = serving.forward_tiles(tiles)
    check(per_tile.boxes.shape[0] == offsets.shape[0] and bool(torch.isfinite(per_tile.boxes).all()),
          "forward_tiles on gathered tiles")
    check(launches["gather_hwc"] > 0, "gather_tiles did not launch the HWC gather")
    print(f"tile API: {int(per_tile.valid.sum())} per-tile detections over {offsets.shape[0]} tiles")
    images = [synthetic_faces(*CANVAS, seed=s, n=12) for s in range(1, 13)]
    per_image = {}
    for label, model in (("bfloat16", serving), ("float32", models["cuda"])):
        times, found = _serve(model, images, kw, label)
        per_image[label] = statistics.median(times)
        print(f"get_sliced_prediction {label}, 1024x1536, 6+1 tiles of 640: median "
              f"{per_image[label]:.3f} ms/image over {len(times)} images (min {min(times):.3f}, "
              f"max {max(times):.3f}); detections per image {found}")
    _profile(torch, lambda: get_sliced_prediction(images[0], serving, **kw), per_image["bfloat16"])

    phase("5 CLI")
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as tmp:
        inp, out = os.path.join(tmp, "in"), os.path.join(tmp, "out")
        os.makedirs(inp)
        for s in (21, 22):
            save_image(os.path.join(inp, f"img{s}.png"), synthetic_faces(720, 1280, seed=s, n=8))
        stats = app_yolo_sahi.main([
            "--input", inp, "--output", out, "--model-path", CKPT, "--scale", "n", "--device", "cuda",
        ])
        check(len(stats) == 2, "the CLI did not process both images")
        for s in (21, 22):
            folder = os.path.join(out, f"img{s}")
            for f in (f"img{s}_summary.txt", f"img{s}_detections.jpg"):
                check(os.path.exists(os.path.join(folder, f)), f"the CLI wrote no {f}")
    counts = {k: launches[k] for k in ("gather_hwc", "gather_chw")}
    print(f"launches on the single-image main path: {counts}")
    return counts


def _photo(seed, hw=CANVAS, n=12):
    """A seeded synthetic photo: faces on a background whose DCT planes are
    as sparse as a photograph's."""
    from facedet_tpu_torch.utils.synth import natural_background, synthetic_faces

    return synthetic_faces(*hw, seed=seed, n=n, background=natural_background(*hw, seed=seed))


def ingest_phase(torch, models):
    phase("6 ingest formats (float32, TF32 off): card against CPU")
    from facedet_tpu_torch import get_sliced_prediction
    from facedet_tpu_torch.engine import predict as P
    from facedet_tpu_torch.ops.color import rgb_to_yuv420
    from facedet_tpu_torch.ops.jpeg_dct import encode_dct420

    image = _photo(100)
    kw = {k: v for k, v in SERVING_KW.items() if k != "fetch_capacity"}
    coded = encode_dct420(image)
    for fmt, src in (("yuv420", rgb_to_yuv420(image)), ("dct420", coded), ("dct420s", coded)):
        want = get_sliced_prediction(src, models["cpu"], input_format=fmt, **kw).detections.to_numpy()
        got = get_sliced_prediction(src, models["cuda"], input_format=fmt, **kw)
        check(len(want["boxes"]) > 0, f"{fmt}: the golden model found nothing")
        check(got.detections.boxes.device.type == "cpu" and got.image.shape == image.shape,
              f"{fmt}: result not on the host or display image of the wrong shape")
        _compare(got.detections.to_numpy(), want, f"get_sliced_prediction float32 {fmt}")
    # the sparse wire is lossless: it rebuilds the planes the dense format uploads
    dev = torch.device("cuda")
    canvases = {}
    for fmt in ("dct420", "dct420s"):
        staged = P._stage_single_host(coded, fmt, *CANVAS)
        canvases[fmt] = P.decode_canvas(tuple(P._to_device(a, dev) for a in staged), fmt, *CANVAS, torch.float32)
    check(canvases["dct420"].is_cuda and torch.equal(canvases["dct420"], canvases["dct420s"]),
          "dct420s and dct420 decode to different canvases on the card")
    print(f"dct420s canvas equals the dct420 canvas bit for bit: {tuple(canvases['dct420'].shape)} float32")


def batch_phase(torch, models):
    phase("7 batch of 8 (float32) against 8 single calls")
    from facedet_tpu_torch import get_sliced_prediction, get_sliced_prediction_batch
    from facedet_tpu_torch.ops.jpeg_dct import encode_dct420
    from facedet_tpu_torch.ops.kernels import tile_gather as tg

    kw = {k: v for k, v in SERVING_KW.items() if k != "fetch_capacity"}
    coded = [encode_dct420(_photo(200 + s)) for s in range(8)]
    before = dict(tg.LAUNCHES)
    batch = get_sliced_prediction_batch(coded, models["cuda"], input_format="dct420s", **kw)
    batched_launches = tg.LAUNCHES["gather_chw_batched"] - before["gather_chw_batched"]
    check(batched_launches == 1 and tg.LAUNCHES["gather_chw"] == before["gather_chw"],
          f"a batch of 8 (one chunk) launched the batched gather {batched_launches} times, "
          f"the single one {tg.LAUNCHES['gather_chw'] - before['gather_chw']} times")
    check(len(batch) == 8, f"{len(batch)} results for 8 images")
    found = 0
    for i, (res, im) in enumerate(zip(batch, coded)):
        single = get_sliced_prediction(im, models["cuda"], input_format="dct420s", **kw)
        _compare(res.detections.to_numpy(), single.detections.to_numpy(), f"batch image {i} against its single call")
        found += len(res.object_prediction_list)
    check(found > 0, "the batch found nothing")
    print(f"batched gather launches for the batch of 8: {batched_launches}")


def _iou(a, b):
    import numpy as np

    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.clip(rb - lt, 0, None).prod(-1)
    area = lambda x: (x[:, 2] - x[:, 0]) * (x[:, 3] - x[:, 1])  # noqa: E731
    return inter / np.maximum(area(a)[:, None] + area(b)[None, :] - inter, 1e-9)


def serving_phase(torch, models):
    """The serving configuration at full width; returns the launch counts."""
    import numpy as np

    from facedet_tpu_torch import get_sliced_prediction, get_sliced_prediction_batch, predict_stream
    from facedet_tpu_torch import predict_stream_batched
    from facedet_tpu_torch.engine import predict as P
    from facedet_tpu_torch.ops.jpeg_dct import encode_dct420

    phase("8 serving main path: predict_stream_batched, dct420s, batch 64, window 3, bfloat16")
    model = models["serving"]
    n_distinct, n_batches = 16, 5
    rgb = [_photo(300 + s) for s in range(n_distinct)]
    t0 = time.perf_counter()
    coded = [encode_dct420(im) for im in rgb]
    print(f"encoded {n_distinct} distinct 1024x1536 images once in {time.perf_counter() - t0:.2f} s (not timed below)")
    nnz = sum(int(np.count_nonzero(d.y_ac)) + int(np.count_nonzero(d.uv_ac)) for d in coded)
    print(f"AC density of the inputs: {nnz / sum(d.y_ac.size + d.uv_ac.size for d in coded):.4f}")
    # what each distinct image holds, from the single-image path of the same model
    refs = []
    for d in coded:
        det = get_sliced_prediction(d, model, input_format="dct420s", return_image=False, **SERVING_KW)
        refs.append(det.detections.to_numpy())
    check(all(len(r["boxes"]) > 0 for r in refs), "an input image holds no detection")

    def stream(pool, fmt, batches):
        """Wall seconds and the per-image results of one pass."""
        n = SERVING_BATCH * batches
        out = []
        t0 = time.perf_counter()
        for raw in predict_stream_batched((pool[i % n_distinct] for i in range(n)), model, batch_size=SERVING_BATCH,
                                          window=3, raw=True, input_format=fmt, **SERVING_KW):
            out.append(raw)
        return time.perf_counter() - t0, out

    print("launch counts set to 0; the stream starts")
    launches = _reset_launches()
    stream(coded, "dct420s", 2)  # warm-up: cuDNN plans, pinned buffers, the allocator
    passes = []
    for p in range(3):
        seconds, out = stream(coded, "dct420s", n_batches)
        passes.append(SERVING_BATCH * n_batches / seconds)
        if p == 0:
            first = out
    counts = {"gather_chw_batched": launches["gather_chw_batched"]}
    chunks = (2 + 3 * n_batches) * (SERVING_BATCH * 6 // 96)
    check(counts["gather_chw_batched"] == chunks and launches["gather_chw"] == 0,
          f"the stream launched the batched gather {counts['gather_chw_batched']} times for {chunks} chunks "
          f"and the single-image gather {launches['gather_chw']} times")
    print(f"launches on the serving main path: {counts} ({chunks} chunks of 16 images)")

    # every image answered, in order, finite, inside the image, with its faces
    check([tuple(r.boxes.shape) for r in first] == [(SERVING_BATCH, 300, 4)] * n_batches,
          f"result shapes {[tuple(r.boxes.shape) for r in first]}")
    answered = total = matched = wanted = 0
    for b, raw in enumerate(first):
        check(raw.boxes.device.type == "cpu", "raw results are not on the host")
        for i in range(SERVING_BATCH):
            det = raw.map(lambda x: x[i]).to_numpy()  # noqa: B023
            check(np.isfinite(det["boxes"]).all() and np.isfinite(det["kpts"]).all() and np.isfinite(det["scores"]).all(),
                  f"batch {b} image {i}: non-finite output")
            x, y = det["boxes"][:, 0::2], det["boxes"][:, 1::2]
            check((x >= 0).all() and (x <= CANVAS[1]).all() and (y >= 0).all() and (y <= CANVAS[0]).all(),
                  f"batch {b} image {i}: boxes outside the image")
            ref = refs[(b * SERVING_BATCH + i) % n_distinct]
            strong = ref["boxes"][ref["scores"] >= 0.5]
            if len(strong) and len(det["boxes"]):
                matched += int((_iou(strong, det["boxes"]).max(1) >= 0.8).sum())
            wanted += len(strong)
            answered += 1
            total += len(det["boxes"])
    check(answered == SERVING_BATCH * n_batches, f"{answered} images answered")
    check(total > 0, "the stream found no detection")
    check(wanted > 0 and matched >= 0.98 * wanted,
          f"results out of order or wrong: {matched} of {wanted} confident faces of each input found in its result")
    print(f"{answered} images answered in order: {matched}/{wanted} confident faces found where expected, "
          f"{total / answered:.2f} detections per image")
    print(f"serving dct420s: {statistics.median(passes):.2f} images/s median of 3 passes of {n_batches} batches "
          f"(min {min(passes):.2f}, max {max(passes):.2f})")

    rgb_passes = [SERVING_BATCH * n_batches / stream(rgb, "rgb", n_batches)[0] for _ in range(4)][1:]
    print(f"serving rgb (same stream, same images): {statistics.median(rgb_passes):.2f} images/s median of 3 passes "
          f"after one of warm-up (min {min(rgb_passes):.2f}, max {max(rgb_passes):.2f})")

    n_single = 40
    t_first = None
    for k, _ in enumerate(predict_stream((coded[i % n_distinct] for i in range(n_single)), model, window=3, raw=True,
                                         input_format="dct420s", **SERVING_KW)):
        if k == 7:
            t_first = time.perf_counter()
    per_image_s = (time.perf_counter() - t_first) / (n_single - 8)
    print(f"predict_stream(window=3) dct420s, per image: {1 / per_image_s:.2f} images/s over {n_single - 8} images "
          f"after 8 of warm-up")

    # where a batch's time goes: the staging on the host, then one batch
    # through the non-streamed batch call, unprofiled and profiled
    batch = [coded[i % n_distinct] for i in range(SERVING_BATCH)]
    stage = []
    for _ in range(3):
        t0 = time.perf_counter()
        wire = P._stage_batch_host(batch, "dct420s", *CANVAS)
        stage.append((time.perf_counter() - t0) * 1e3)
    print(f"_stage_batch_host dct420s, batch {SERVING_BATCH}: {statistics.median(stage):.1f} ms host time per batch "
          f"(min {min(stage):.1f}, max {max(stage):.1f}), wire {wire.nbytes / 1e6:.2f} MB "
          f"({wire.nbytes / SERVING_BATCH / 1e6:.3f} MB/image; rgb canvas {CANVAS[0] * CANVAS[1] * 3 / 1e6:.3f})")
    plan = P._plan_sliced_batch(batch, model, P._stream_opts(dict(SERVING_KW, input_format="dct420s")))
    device_leg = []
    for _ in range(4):
        t0 = time.perf_counter()
        P._dispatch_staged_batch(plan, wire, model).result()
        device_leg.append((time.perf_counter() - t0) * 1e3)
    device_leg = device_leg[1:]
    print(f"upload + enqueue + device + fetch of one staged batch, on one thread: {statistics.median(device_leg):.1f} ms "
          f"(min {min(device_leg):.1f}, max {max(device_leg):.1f})")
    run = lambda: get_sliced_prediction_batch(batch, model, raw=True, input_format="dct420s", **SERVING_KW)  # noqa: E731
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        run()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall = statistics.median(walls)
    print(f"one batch of {SERVING_BATCH} through get_sliced_prediction_batch (stage + upload + device + fetch, "
          f"nothing overlapped): {wall:.1f} ms, {wall / SERVING_BATCH:.3f} ms/image")
    torch.cuda.reset_peak_memory_stats()
    _profile(torch, run, wall / SERVING_BATCH, n=1, images=SERVING_BATCH, label="serving batch, bfloat16")
    print(f"peak device memory of one batch: {torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    return counts


def folder_phase(torch, models):
    phase("9 folder run and CLI: predict() with ingest=dct420s, the CLI with --ingest yuv420")
    import numpy as np
    from PIL import Image

    from facedet_tpu_torch import get_sliced_prediction, predict
    from facedet_tpu_torch.apps import app_yolo_sahi
    from facedet_tpu_torch.data import native_loader
    from facedet_tpu_torch.ops.jpeg_dct import quality_tables
    from facedet_tpu_torch.utils.viz import save_image

    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as tmp:
        inp = os.path.join(tmp, "in")
        os.makedirs(inp)
        for s in (31, 32):
            save_image(os.path.join(inp, f"img{s}.png"), _photo(s, hw=(720, 1280), n=8))
        out = predict(
            detection_model=models["cuda"], source=inp, slice_height=SLICE, slice_width=SLICE, export_pickle=True,
            project=os.path.join(tmp, "runs"), name="exp", verbose=0, ingest="dct420s",
        )
        check(out["num_images"] == 2, f"predict() saw {out['num_images']} images")
        for s in (31, 32):
            for f in (os.path.join("visuals", f"img{s}.png"), os.path.join("pickles", f"img{s}.pickle")):
                check(os.path.exists(os.path.join(out["export_dir"], f)), f"predict() wrote no {f}")
        print(f"predict(ingest='dct420s'): 2 images, {out['durations_in_seconds']['prediction']:.3f} s of prediction")

        stats = app_yolo_sahi.main([
            "--input", inp, "--output", os.path.join(tmp, "out"), "--model-path", CKPT, "--scale", "n",
            "--device", "cuda", "--ingest", "yuv420",
        ])
        check(len(stats) == 2 and sum(s["faces"] for s in stats) > 0, f"the CLI with --ingest yuv420: {stats}")
        for s in (31, 32):
            check(os.path.exists(os.path.join(tmp, "out", f"img{s}", f"img{s}_detections.jpg")),
                  f"the CLI wrote no drawing for img{s}")

        # a real 4:2:0 JPEG through the native coefficient reader, where it builds
        if native_loader._load_native() is None:
            print("native jpeg reader: not built on this host (no libjpeg headers or no g++); "
                  "the loaders' PIL path served the runs above")
        else:
            path = os.path.join(tmp, "photo.jpg")
            Image.fromarray(_photo(33, hw=(720, 1280), n=8)).save(path, quality=92, subsampling=2)
            coded = native_loader.load_image_dct420(path)
            check(coded is not None and tuple(coded.hw) == (720, 1280), "load_image_dct420 on a 4:2:0 JPEG")
            check(not np.array_equal(coded.qy, quality_tables(90)[0]),
                  "load_image_dct420 re-encoded the file at quality 90 instead of reading its stored coefficients")
            res = get_sliced_prediction(coded, models["cuda"], slice_height=SLICE, slice_width=SLICE,
                                        input_format="dct420s")
            check(len(res.object_prediction_list) > 0 and res.image.shape == (720, 1280, 3),
                  "a JPEG's stored coefficients through the dct420s path")
            print(f"native jpeg reader: built; one JPEG's stored coefficients -> "
                  f"{len(res.object_prediction_list)} faces through dct420s")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: FAIL: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: FAIL: torch sees no CUDA device", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(REPO, "facedet_tpu_torch")):
        print("chip_smoke: FAIL: run from a checkout of the repo (facedet_tpu_torch/ is missing)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    t_start = time.perf_counter()
    try:
        smi, count = device_phase(torch)
        build_phase()
        timings = kernel_phase(torch)
        models = load_models()
        counts = main_path_phase(torch, models)
        ingest_phase(torch, models)
        batch_phase(torch, models)
        counts.update(serving_phase(torch, models))
        folder_phase(torch, models)
        for k in KERNELS:
            check(counts[k["name"]] > 0, f"{k['name']} was not launched on its main path")
        check("jax" not in sys.modules and "facedet_tpu" not in sys.modules, "jax or facedet_tpu was imported")
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    report = [{**k, "launches": counts[k["name"]], **timings[k["name"]]} for k in KERNELS]
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": report}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
