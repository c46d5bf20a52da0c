#!/usr/bin/env python3
"""Smoke run of facedet_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout

Phases, in order; any failure ends the run with a non-zero exit code:

1. device: the card's name and power limit, torch and CUDA versions;
2. build: every CUDA source of the port, compiled with nvcc for sm_90a;
3. kernels: each kernel held bit-exactly against its plain PyTorch version
   on the card (production grid, unaligned, out-of-range and T=1 offsets;
   uint8, float32, bfloat16) and timed with CUDA events beside its byte
   bound, its plain version and one PyTorch advanced-indexing call;
4. main path, with the launch counts set to 0 first: get_sliced_prediction
   with the golden yolo11n weights in float32 (TF32 off) held against the
   same call on the CPU, get_prediction likewise, the tile API
   (ops.tiler.gather_tiles + DetectionModel.forward_tiles) on the bfloat16
   serving model, that model and the float32 one timed over 10 images each,
   a profile of the bfloat16 run, and the app_yolo_sahi CLI;
5. report: a ``kernels`` JSON line, the nvidia-smi line, and last the
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
]


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


def _profile(torch, run, wall_ms, n=3):
    """Device time per image from torch.profiler over ``n`` runs, its share
    of the unprofiled wall time, and the kernels that take most of it."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            run()
        torch.cuda.synchronize()
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / n
    launches = sum(e.count for e in kernels) / n
    print(f"profile bfloat16: device busy {device_ms:.3f} ms/image in {launches:.0f} kernel launches, "
          f"{100 * device_ms / wall_ms:.1f}% of the {wall_ms:.3f} ms wall time")
    groups: dict[str, list] = {}
    for e in kernels:
        name = e.key.lower()
        group = next((g for g, keys in PROFILE_GROUPS if any(k in name for k in keys)), "other")
        acc = groups.setdefault(group, [0.0, 0])
        acc[0] += e.self_device_time_total / 1e3 / n
        acc[1] += e.count / n
    for group, (ms, count) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f"  {ms:8.3f} ms/image {count:6.0f} launches  {group}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.self_device_time_total / 1e3 / n:8.3f} ms/image  {e.count // n:4d}x  {e.key[:90]}")


def main_path_phase(torch):
    """Drives the port's entry points; returns the launch counts."""
    import numpy as np

    from facedet_tpu_torch import YoloV11PoseDetectionModel, get_prediction, get_sliced_prediction
    from facedet_tpu_torch.apps import app_yolo_sahi
    from facedet_tpu_torch.ops.kernels import tile_gather as tg
    from facedet_tpu_torch.ops.tiler import gather_tiles
    from facedet_tpu_torch.utils.synth import synthetic_faces
    from facedet_tpu_torch.utils.viz import save_image

    check(os.path.exists(CKPT), f"missing checkpoint {CKPT}")
    image = synthetic_faces(*CANVAS, seed=0, n=12)
    kw = dict(
        slice_height=SLICE, slice_width=SLICE, overlap_height_ratio=0.2, overlap_width_ratio=0.2,
        perform_standard_pred=True, postprocess_type="GREEDYNMM", postprocess_match_metric="IOS",
        postprocess_match_threshold=0.5,
    )
    models = {
        dev: YoloV11PoseDetectionModel(model_path=CKPT, scale="n", image_size=SLICE, dtype="float32", device=dev)
        for dev in ("cpu", "cuda")
    }
    want = get_sliced_prediction(image, models["cpu"], **kw).detections.to_numpy()
    want_single = get_prediction(image, models["cpu"]).object_prediction_list

    phase("4 main path (launch counts from 0)")
    for k in tg.LAUNCHES:
        tg.LAUNCHES[k] = 0

    got = get_sliced_prediction(image, models["cuda"], **kw)
    check(tg.LAUNCHES["gather_chw"] > 0, "get_sliced_prediction did not launch the CHW gather")
    _compare(got.detections.to_numpy(), want, "get_sliced_prediction float32")
    check(len(want["boxes"]) > 0, "the golden model found nothing on the synthetic image")

    single = get_prediction(image, models["cuda"]).object_prediction_list
    to_np = lambda preds: {  # noqa: E731
        "boxes": np.array([p.bbox.to_xyxy() for p in preds], np.float32).reshape(-1, 4),
        "scores": np.array([p.score.value for p in preds], np.float32),
        "kpts": np.array([p.keypoints for p in preds], np.float32).reshape(-1, 5, 3),
    }
    _compare(to_np(single), to_np(want_single), "get_prediction float32")

    serving = YoloV11PoseDetectionModel(model_path=CKPT, scale="n", image_size=SLICE, device="cuda")

    # the tile API, on the bfloat16 serving canvas: gather NHWC tiles and run
    # the detector on them
    canvas = (torch.from_numpy(image).cuda().float() / 255.0).to(torch.bfloat16)
    offsets = torch.from_numpy(production_offsets()).cuda()
    tiles = gather_tiles(canvas, offsets, SLICE, SLICE)
    per_tile = serving.forward_tiles(tiles)
    check(per_tile.boxes.shape[0] == offsets.shape[0] and bool(torch.isfinite(per_tile.boxes).all()),
          "forward_tiles on gathered tiles")
    check(tg.LAUNCHES["gather_hwc"] > 0, "gather_tiles did not launch the HWC gather")
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
    counts = dict(tg.LAUNCHES)
    print(f"launches on the main path: {counts}")
    return counts


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
        counts = main_path_phase(torch)
        for k in KERNELS:
            check(counts[k["name"]] > 0, f"{k['name']} was not launched on the main path")
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
