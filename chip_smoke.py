#!/usr/bin/env python3
"""Smoke run of facedet_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout

Phases, in order; any failure ends the run with a non-zero exit code:

1. device: the card's name and power limit, torch and CUDA versions;
2. build: every CUDA source of the port, compiled with nvcc for sm_90a;
3. kernels: each kernel held bit-exactly against its plain PyTorch version
   on the card (production grid, unaligned, out-of-range and T=1 offsets;
   uint8, float32, bfloat16; the batched CHW gather for B in 1, 3, 16; the
   CHW gather also on the enhance-first pipeline's 2048x3072 canvas, on an
   odd width whose rows are not 16-byte aligned and on halo windows that
   are not square) and timed with CUDA events beside its byte bound, its
   plain version and one PyTorch advanced-indexing call; ConvBnAct's
   epilogue kernel (bn_act) on the output of every conv that a BatchNorm
   follows in YOLO11n-pose (golden weights) and the benchmark's RT-DETR-l, at
   6 and 1 tiles of 640, held bit for bit against the PyTorch / cuDNN chain
   it replaces with the module's statistics and with statistics drawn wide
   (channels-last input, RT-DETR-l's model.12 at 6 tiles, within one
   bfloat16 ulp on at most 1% of elements), and timed per forward, kernel
   and chain each replayed from a CUDA graph, beside the byte bound;
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
   image; images per second (median of 3 passes of 3 batches), the same
   stream with rgb input, predict_stream per image, a profile of one batch and the host
   time of the staging;
9. folder run and CLI: predict() over a folder with ingest="dct420s", the CLI with
   --ingest yuv420, and one JPEG through the native coefficient reader where
   libjpeg's headers exist;
10. SR fidelity: RealESRGAN_x2plus and x4plus with the golden weights in
   float32 (TF32 off) on a 96x128 image, the card against this host's CPU;
11. SR main path at full width, with the launch counts set to 0 first:
   FaceEnhancer.enhance_image, x2plus on 1024x1536 and x4plus on 512x768 in
   bfloat16: the tile plan, ms per image, a profile, peak memory, achieved
   TFLOP/s, PSNR against float32 on the card; the cascade alias and
   outscale 2 on the x4 net once each;
12. pipeline v2 (enhance_first_pipeline, x2, fixed_grid, 1024x1536): the
   enhanced tensor goes into the sliced detection on the device; the card
   against the CPU in float32 on 256x384; ms per image, enhance and detect;
13. pipeline v1 and the fetch wire: detect_first_pipeline with crops
   written and enhanced, enhance_detections, the DCT fetch pipeline dense
   and sparse on the card against the CPU, enhance_to_jpeg's branch and
   the bytes each fetch format moves;
14. the app_v2, app_v1, app_enhancer and app_yolo_full CLIs as
   subprocesses; the counts are read after them. Phase 19's processes start
   with them and are collected right after them, before phase 15. Before
   them a seeded synthetic WIDERFACE layout is written for phases 19 and
   21-23: 8 photo-like 1024x1536 images of 12 faces as event/name.jpg and a
   gt.txt with each face's box (utils/synth.synthetic_faces_with_boxes);
15. SCRFD fidelity: the golden scrfd_2.5g in float32 (TF32 off) through
   get_sliced_prediction, the card against the CPU; a batch of 4 through
   get_sliced_prediction_batch against 4 single calls; the checkpoint and
   one loaded leaf held against the file;
16. SCRFD main path at full width, with the launch counts set to 0 first:
   bfloat16, ms per image, a profile by kernel group, FaceAnalysis.get;
17. RT-DETR: rtdetr-l (hidden 256, 300 queries, 6 decoder layers) from the
   seeded init. float32, the card against the CPU on two 640x640 tiles: the
   query selection's top_idx, then logits and boxes of the last layer given
   the same selection. bfloat16 main path, with the launch counts set to 0
   first: ms per image, a profile with the deformable-attention sampling as
   a group of its own, the 8,400-token selection timed alone, peak memory;
   then the benchmark's RT-DETR-l (the published layout, whose convs end in
   ConvBnAct; port_bench's seeded weights) through get_sliced_prediction on
   two photos, its epilogue kernel launches counted from 0;
18. ONNX: the golden SCRFD exported in insightface's nine-output layout
   at batch 1 (run as a loop over tiles) through ScrfdDetectionModel against the .npz route, the golden yolo11n exported
   with the ultralytics head through OnnxDetectionModel against
   YoloV11PoseDetectionModel; ms per image and kernel launches of each;
19. the other families' CLIs as subprocesses: app_yolo_sahi with --family
   scrfd, rtdetr and fake, app_retinaface, inference_direct,
   app_yolo_inference; and the evaluators' CLIs, eval_official and
   eval_dual_cli, on the synthetic layout (their JSON results are held
   against phases 21 and 22);
20. TOPIQ: CFANet at full width (ResNet50 3/4/6/3, embed 256, 4 heads) from a
   seeded init; float32 (TF32 off) card against CPU on three 224x224 crops
   and one 100x100; a batch of 64 crops at 224x224 in float32 and bfloat16:
   ms per batch, images per second, TFLOP/s from the counted FLOPs, peak
   memory, a profile, and bfloat16 against float32 as the largest |dscore|;
21. the official WIDERFACE evaluator: the SAHI-uniform mode in float32 on two
   images, card against CPU (counts, boxes, scores, AP); then, with the
   launch counts set to 0, the detector the eval CLIs build (yolo11n golden,
   bfloat16, letterbox 1024, conf 0.01) in six modes: BASELINE, SAHI
   uniform 640/0.2, SAHI adaptive, SAHI with dct420s ingest, FULL-ENHANCE x2
   and BOUNDED-ENHANCE x2 before SAHI; AP and images per second of each;
   the eval_official CLI's AP against the SAHI-uniform mode's;
22. the dual evaluator (six subcategories and easy/medium/hard rebuilt from
   them) with the eval_dual_cli predict function, against that CLI's nine
   APs, and the 'quick' SAHI tuning grid on two images with no image
   skipped for an error; the counts are read after it;
23. IQA: NIQE and BRISQUE on four face crops, the committed
   niqe_pristine.npz and brisque_svr.npz loaded (no self-fit), the native
   bbox_overlaps built and equal to its numpy version;
24. training fidelity (float32, TF32 off): one train-mode loss and backward
   of the golden yolo11n and scrfd_2.5g at 320x320, batch 2, on seeded
   synthetic faces with boxes and landmarks, the card against the CPU: loss
   parts, every parameter's gradient, the BatchNorm running statistics;
25. training main path at full width: yolo11n-pose from the golden weights,
   640x640, batch 8, 12 faces per image, float32, make_optimizer's AdamW:
   make_train_step's ms per step (median of 20 after 3), images per second,
   peak memory, kernel launches and device busy per step (a profile of 3
   steps), TFLOP/s from the FLOPs counted from shapes (forward x3); the same
   with TF32 on; the staged loop with flip, 20 steps per dispatch; the
   scrfd_2.5g step at the same size;
26. learning proof and export: tools/selftrain_demo (yolo, 300 steps of
   batch 16 at 96x96 from a seeded init) must reach mAP50 >= 0.5 and rise;
   a YoloTrainer run of 2 epochs on 8 staged images, its last.npz loaded
   through YoloV11PoseDetectionModel gives the in-memory model's detections;
   .chiprunignore must not list the golden checkpoints;
27. RT-DETR and SR training fidelity (float32, TF32 off), the card against
   the CPU, each beside a TF32 run on the card that its gradient gate must
   catch: one CDN step (5 groups) of rtdetr-tiny from the seeded init at
   256x256, batch 2, greedy matcher, the card given the CPU's query
   selection: its own greedy assignments equal the CPU's at every GT slot,
   then given the CPU's, loss parts, gradients and BatchNorm statistics
   under phase 24's fixed gates (the seeded rtdetr-l is chaotic in float32:
   one ulp of input moves its gradients by a fifth of a leaf's largest);
   one G and one D step of RealESRGAN_x2plus (golden) with
   PatchDiscriminator(64) and the perceptual term on two 64x64 patches: the
   four metrics, G's and D's gradients (error norm over norm), the
   spectral-norm u and sigma;
28. RT-DETR and SR training at full width: rtdetr-l, 640x640, batch 8, 12
   faces per image, CDN, AdamW lr 1e-4 (clip 0.1), greedy matcher, float32:
   ms per step (median of 10 after 3), images per second, peak memory,
   launches and device busy per step (a profile by kernel group), TFLOP/s
   from FLOPs counted from shapes; the staged loop with flip; the greedy
   matcher alone; RealESRGAN_x2plus (golden) through the staged loop, HR
   128, batch 16, Adam with clip 5, EMA 0.999, then its GAN step with the
   perceptual term, each with ms (median of 10 after 2), patches per
   second, a profile, TFLOP/s and peak memory;
29. learning proof: selftrain_demo --model rtdetr (rtdetr-tiny, 300 steps of
   batch 16 at 96x96, CDN) must raise mAP50 and bring the mean loss of its
   last 20 steps under 70% of its first 20; an RtDetrTrainer run of 2
   epochs whose last.npz gives the in-memory model's detections; a narrow
   SR net whose loss falls under 70% of its first in 40 steps;
30. checkpoint conversion: a randomized yolo11n-pose in the ultralytics
   namespace (tests/torch_yolo_ref.py, torch only) through
   convert_ultralytics_checkpoint: the scale read back, the nine head maps
   on the card within 1e-4 of the reference module (float32, TF32 off);
   the same state dict saved as a .pt and loaded by
   YoloV11PoseDetectionModel(model_path=...), one get_sliced_prediction;
   a seeded x2plus renamed to basicsr's names and unshuffle order and
   converted back bit for bit, its forward equal;
31. int8 serving, with the launch counts set to 0 first: golden yolo11n
   quantized by quantize_detector on the card (the count against the JAX
   package's); the same int8 buffers on the CPU: each int8 layer given the
   CPU's input (levels and outputs), then get_sliced_prediction in float32
   card against CPU under PERF.md §2's gates, or under the int8 gate beside
   two controls (the CPU against itself one ulp up, which breaks §2's gates
   too; the float32 detector, which the int8 gate must fail); bfloat16
   single image int8 beside float in turns (ms per image, a profile each,
   the aten::_int_mm and aten::convolution counts of one image run without
   CUDA graphs, whose replays run no aten op), the int8 GEMMs alone
   (ms, TOPS, share of the int8 peak), detection agreement with float
   bfloat16 at IoU 0.5, and the serving stream (batch 64, window 3,
   dct420s) int8 against bfloat16 in images per second;
32. video, with the launch counts set to 0 first: an MJPEG AVI of 8 frames
   of 1024x1536 written by write_video; predict() on it with the golden
   yolo11n in float32, ingest rgb and dct420, every frame's detections
   against get_sliced_prediction on the decoded frame, the annotated AVI
   and the COCO json; FaceDetector.detect_video with the seeded rtdetr-l;
   frames per second of each; detect_webcam without a camera raises;
33. ONNX export: the golden scrfd_2.5g at 640x640 through the generic entry
   (export_torch_to_onnx), re-parsed by the port's parser (node and
   initializer counts, names, the input shape); save_onnx of the parsed
   graph re-parses to the same graph; the exported graph on the card
   through ScrfdDetectionModel against the native route under PERF.md §2's
   gates, its gather launches counted in a window of their own;
34. multi-device inference at world 1 over NCCL (the card is one GPU, and
   NCCL takes one rank per device): an in-process group and a (1, 1) mesh;
   golden yolo11n in float32: get_sliced_prediction(mesh=) against the
   plain call under §2's gates, ms per image of both;
   predict_stream_batched(devices=["cuda:0", "cuda:0"]) in the serving
   configuration against devices=None (equal counts, scores within 1e-5,
   boxes within 1e-3, order), images per second of both;
   predict_stream_multidevice on 8 images against single calls, in order;
   the gather launches of each run counted in a window of its own;
35. sharded training at world 1: make_sharded_train_step on yolo11n-pose
   (golden), 640x640, batch 8, float32, TF32 off, against make_train_step
   from the same state with SGD: loss parts within 1e-4 relative, every
   parameter's update within 1e-3 of its leaf's largest (phase 24's
   gradient gate; an SGD update is the gradient scaled), the BatchNorm
   running statistics within 1e-5; then with make_optimizer's AdamW, plain,
   sharded, and sharded with every BatchNorm all-reducing over the one-rank
   dp group (the step itself skips that at world 1): ms per step, kernel
   launches and device busy per step; two steps of
   make_sharded_staged_train_loop with flip, a finite loss; the process
   group is destroyed after it;
36. goldens recovery (host): a synthetic reference tree of 6 photos of
   1024x1536 with 12 faces each (utils/synth.synthetic_reference_tree: the
   reference's run-artifact layout, crops named by confidence, detail
   images with the landmark dots), tools/reference_goldens.extract_goldens
   and tools/golden_keypoints.recover_all on it: every face at IoU >= 0.9
   with its exact confidence, every landmark within 3 px of its dot;
37. golden fine-tune, with the launch counts set to 0 first:
   tools/golden_finetune.main on the tree for yolo11n-pose (640x640, batch
   8, float32, staged, 200 steps; the mean loss must fall across
   dispatches), scrfd_2.5g, rtdetr-l with the golden yolo11n as teacher and
   a 2-fold CV: ms per step, the parity report per split, each checkpoint
   loaded back (yolo: the same parity), launches and device busy per step
   from a dispatch of 5 more steps on the yolo run's last batches under the
   profiler, the state put back after it (the ms per step from the
   dispatches before the last), the CHW gather launches of parity_on_split;
38. golden evaluation with the committed yolo11n: the parts of
   golden_official_eval (build_widerface_layout, the official evaluator in
   both modes), golden_dual_eval (run_dual, baseline and SAHI) and
   golden_conf_sweep (collect_detections, score_split) on a float32
   detector (TF32 off) and 2 images, card against CPU (APs within 0.005,
   the sweep's rows equal in counts), then the three tools as a user runs
   them (bfloat16) on the 6 images (the dual evaluator's four
   modes with the x2 enhancer and the 'quick' grid): seconds per tool,
   images per second, the CHW launches in a window of their own;
39. SR golden loop and UI: tools/sr_golden_train.main at x2plus full width
   (HR 128, batch 16: 100 L1 steps, then 20 GAN steps with the perceptual
   term; the L1 loss must fall), its held-out PSNR against bicubic and IQA
   table; tools/sr_cascade_eval in both arms from that checkpoint;
   eval/iqa_train.main fitting NIQE on the tree's photos;
   apps/streamlit_app.process_single_image with the golden detector (SAHI,
   its CHW launches counted); utils/viz_mpl.FaceVisualizer (drawing only
   where matplotlib imports);
40. sharded training with a bfloat16 config at world 1 (an in-process NCCL
   group again): one SGD step of make_sharded_train_step on yolo11n-pose
   (golden, float32 parameters, bfloat16 convs), 640x640, batch 8, against
   make_train_step's bfloat16 step under the bfloat16 gates of
   tests/test_torch_parallel_train_bf16.py (the loss 5e-3 and the parts
   5e-2 relative, the gradient 0.8 of its norm); then AdamW, plain and
   sharded in turns: ms per step, launches, device busy;
41. tools/profile_stages.main(), with the launch counts set to 0 first
   (yolo11s-pose seeded, bfloat16, batch 8 of 1024x1536 dct420s): every
   stage's wall ms, device ms, launches and busy per image; the cumulative
   device ms may fall from row to row by no more than 5% + 0.05 ms; the
   full row within 15% of a profile of batch_core on the same wire; the
   batched gather launched;
42. tools/profile_layers.main() (42 tiles): every prefix's row per tile;
   the last prefix within 15% of a profile of forward_nchw;
43. tools/profile_modules.main() (48 tiles): backbone, neck, both heads,
   DenseClsHead;
44. tools/profile_sr_layers.main() (512x768, bfloat16): every conv and block
   with TFLOP/s under the 989 TFLOP/s bfloat16 peak;
45. the six probes at their defaults, with the launch counts set to 0
   first: rgb stage (planar_fma within 0.02 of current in bfloat16,
   nearest_fma not), idct layout (separable within 0.01 gray levels,
   bf16_matmul within 4), unpack fusion (every variant's planes exact),
   stream window (the windows' results equal), SR tiling (planned against
   whole within 1/255), SR end to end (the same JPEG bytes, the stages
   within 10% of the cycle); the CHW gather launched;
46. tools/probe_int8_conv.main() at the JAX tool's three shapes (42 tiles of
   80x80x128->128, 40x40x256->256, 160x160x64->64): one tile of each first,
   the card's int32 output equal to the CPU's int8 route and the bfloat16
   arm within bfloat16 rounding of a float32 conv (TF32 off); ms, TOP/s and
   the shares of the 989 TFLOP/s bfloat16 and 1,979 TOPS int8 peaks of the
   bfloat16 conv, the int8 conv, its im2col and its GEMM;
47. tools/probe_int8_yolo.main() on phase 36's tree, with the launch counts
   set to 0 first: 56 quantized convs (the JAX package's count), both
   parity arms scored every image, the bfloat16 arm's recall and precision
   within 0.05 of a float32 detector's; the int8 arm's parity printed (no
   float gate); tile_forward_nchw on 42 tiles, bfloat16 against int8;
48. tools/probe_upload_pack.main() (64 images of 1024x1536, dct420s): each
   arm's uploaded bytes read back equal to the host's, the three medians;
   no gather launched;
49. the public API ported last on CUDA tensors against the CPU, exactly:
   the box functions, Detections.from_arrays, batched_empty,
   attach_keypoints_to_predictions on the card's boxes, create_yolo's
   weights; pad_image's output through the HWC gather (one launch, counted);
50. report: the wall seconds of every phase, a ``kernels`` JSON line (bn_act's launches
   are those of the single-image main path, phases 4-5, and of RT-DETR's
   bfloat16 main path, phase 17), the nvidia-smi line, and last the
   ``{"ok": true, "device": ...}`` line.

Every profile of phases 4-49 is one guarded window of
utils/profiling.profile_kernels (an empty window first, 64 marker kernels
each side, taken again when no marker came on one side of the calls or one
is extra, at most three times); each window taken again is printed.

It imports nothing of jax or facedet_tpu and needs the checkout: run alone
it fails.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
CKPT = os.path.join(REPO, "facedet_tpu", "eval", "assets", "yolo11n_golden.npz")
SCRFD_CKPT = os.path.join(REPO, "facedet_tpu", "eval", "assets", "scrfd_2_5g_golden.npz")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
SLICE = 640
CANVAS = (1024, 1536)  # the production grid: 6 tiles of 640 at overlap 0.2

# Parity with the CPU run (the precedent of tests/test_parallel.py:116-127):
# float32 on both sides, TF32 off; convs sum in another order on the card.
BOX_ATOL, SCORE_ATOL, KPT_ATOL = 0.05, 1e-3, 0.1

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
KERNELS.append({
    # the single-image CHW gather at the shape the enhance-first pipeline
    # gives it: a 3x2048x3072 canvas, a 4x4 plan bucketed to 32 tiles of 512x768
    "name": "gather_chw@2048x3072",
    "route": "cuda",
    "source": "facedet_tpu_torch/csrc/tile_gather.cu",
    "replaces": "facedet_tpu/ops/pallas/tile_gather.py:114",
})
KERNELS += [
    {
        # no Pallas kernel: the JAX package leaves the chain to XLA, which
        # fuses it into the conv; its timings are per detector forward at 6
        # tiles of 640, and plain_ms = library_ms is the chain
        "name": f"bn_act@{detector}",
        "route": "cuda",
        "source": "facedet_tpu_torch/csrc/bn_act.cu",
        "replaces": "facedet_tpu_torch/models/layers.py ConvBnAct.forward: x.float(), cuDNN's BatchNorm, "
                    ".to(bn_dtype), SiLU / ReLU",
    }
    for detector in ("yolo11n", "rtdetr-l")
]
ENHANCED = (2048, 3072)  # x2 of the production image
BF16_FLOPS_PER_S = 989e12  # H100 SXM dense bfloat16, NVIDIA data sheet
SERVING_BATCH = 64
SERVING_KW = dict(
    slice_height=SLICE, slice_width=SLICE, overlap_height_ratio=0.2, overlap_width_ratio=0.2,
    perform_standard_pred=True, postprocess_type="GREEDYNMM", postprocess_match_metric="IOS",
    postprocess_match_threshold=0.5, postprocess_class_agnostic=True, fetch_capacity=300,
)


# the single-image calls: the standard pass, GREEDYNMM/IOS 0.5, results on the host
SLICED_KW = dict(
    slice_height=SLICE, slice_width=SLICE, overlap_height_ratio=0.2, overlap_width_ratio=0.2,
    perform_standard_pred=True, postprocess_type="GREEDYNMM", postprocess_match_metric="IOS",
    postprocess_match_threshold=0.5,
)


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


PHASE_SECONDS: dict[str, float] = {}
_OPEN_PHASE: list = []


def phase(name=None):
    """Open phase ``name``; the phase open before it (or, with no name, the
    last one) is closed and its wall seconds are printed and kept."""
    now = time.perf_counter()
    if _OPEN_PHASE:
        prev, t0 = _OPEN_PHASE.pop()
        PHASE_SECONDS[prev.split(" ", 1)[0]] = round(now - t0, 1)
        print(f"-- phase {prev.split(' ', 1)[0]} took {now - t0:.1f} s", flush=True)
    if name is not None:
        _OPEN_PHASE.append((name, now))
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


def enhance_first_offsets():
    """(offsets bucketed to 32 tiles, slice h, slice w) of the enhance-first
    pipeline's detection on its 2048x3072 canvas (fixed_grid: a 4x4 plan)."""
    from facedet_tpu_torch.ops.tiler import (bucket_tile_count, compute_slice_grid, fixed_grid_slice_params,
                                             pad_grid_offsets)

    sh, sw, ov = fixed_grid_slice_params(*ENHANCED)
    grid = compute_slice_grid(*ENHANCED, sh, sw, ov, ov)
    offsets, _ = pad_grid_offsets(grid, bucket_tile_count(grid.num_tiles))
    return offsets, sh, sw


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

    # the CHW gather's other shapes: the enhance-first canvas (odd x offsets:
    # the shifted-load path), an odd width (rows that are not 16-byte
    # aligned: 8-, 4-, 2- and 1-byte vectors by dtype), and the enhancer's
    # halo windows on its padded image (not square, static offsets)
    from facedet_tpu_torch.engine.enhancer import plan_tile_grid

    ef_offs, ef_sh, ef_sw = enhance_first_offsets()
    gh, gw, th, tw = plan_tile_grid(*CANVAS)
    check(gh > 1 and gw > 1, f"the production image is planned as {gh}x{gw} windows")
    chw_cases = {
        "enhance_first": (ENHANCED, ef_sh, ef_sw, ef_offs),
        "odd_width": ((333, 1531), 77, 637, np.array([[0, 0], [5, 3], [256, 894], [100, 1], [-9, 4000]], np.int32)),
        "halo_windows": ((gh * th + 20, gw * tw + 20), th + 20, tw + 20,
                         np.array([(i * th, j * tw) for i in range(gh) for j in range(gw)], np.int32)),
    }
    for case, ((ch_, cw_), sh_, sw_, offs) in chw_cases.items():
        src8 = torch.randint(0, 256, (3, 3, ch_, cw_), generator=gen, device=dev, dtype=torch.uint8)
        o = torch.from_numpy(offs).to(dev)
        for dtype in (torch.uint8, torch.float32, torch.bfloat16):
            batch = src8.to(dtype)
            for name, src in (("gather_chw", batch[0]), ("gather_chw_batched", batch)):
                got = tg.gather_tiles_chw(src, o, sh_, sw_)
                torch.cuda.synchronize()
                want = tg.gather_tiles_chw_ref(src, o, sh_, sw_)
                err = float((got.float() - want.float()).abs().max())
                max_err[name] = max(max_err[name], err)
                check(torch.equal(got, want), f"{name} {dtype} {case}: differs from the plain version by {err}")
            del batch
        print(f"CHW gather bit-exact on {case}: canvas {ch_}x{cw_}, {len(offs)} windows of {sh_}x{sw_}, "
              f"single and B=3, uint8, float32, bfloat16")
        del src8

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
    del batch

    # the single-image CHW gather at the enhance-first pipeline's shape
    covered = np.zeros(ENHANCED, bool)
    for y, x in ef_offs:
        covered[y : y + ef_sh, x : x + ef_sw] = True
    o = torch.from_numpy(ef_offs).to(dev)
    ys = (o[:, 0, None] + torch.arange(ef_sh, device=dev)).long()
    xs = (o[:, 1, None] + torch.arange(ef_sw, device=dev)).long()
    for dtype in (torch.float32, torch.bfloat16):
        chw = torch.randint(0, 256, (3, *ENHANCED), generator=gen, device=dev, dtype=torch.uint8).to(dtype)
        elem = chw.element_size()
        nbytes = (int(covered.sum()) + len(ef_offs) * ef_sh * ef_sw) * 3 * elem + ef_offs.nbytes
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        library = lambda: chw[ch[None, :, None, None], ys[:, None, :, None], xs[:, None, None, :]]  # noqa: E731, B023
        check(torch.equal(library(), tg.gather_tiles_chw_ref(chw, o, ef_sh, ef_sw)),
              "gather_chw@2048x3072: the indexing yardstick differs")
        ms = event_ms(torch, lambda: tg.gather_tiles_chw(chw, o, ef_sh, ef_sw))  # noqa: B023
        plain_ms = event_ms(torch, lambda: tg.gather_tiles_chw_ref(chw, o, ef_sh, ef_sw), busy=False)  # noqa: B023
        library_ms = event_ms(torch, library)
        print(f"gather_chw {str(dtype).split('.')[-1]} canvas {ENHANCED[0]}x{ENHANCED[1]} T={len(ef_offs)} "
              f"S={ef_sh}x{ef_sw}: kernel {ms:.4f} ms, bound {bound_ms:.4f} ms ({nbytes / 1e6:.2f} MB), "
              f"plain {plain_ms:.4f} ms, indexing {library_ms:.4f} ms, {nbytes / ms / 1e6:.0f} GB/s")
        if dtype == torch.bfloat16:  # the serving detector's canvas goes in the report
            results["gather_chw@2048x3072"] = {
                "max_abs_err": max_err["gather_chw"], "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": "bytes", "library_ms": library_ms,
            }
        del chw
    results.update(bn_act_kernel_phase(torch))
    return results


def _epilogue_inputs(torch, model, batch):
    """(module name, BatchNorm, output dtype, activation, the conv's output)
    of every BatchNorm epilogue of one bfloat16 forward of ``batch`` 640x640
    tiles of a synthetic photo, in forward order."""
    import numpy as np

    from facedet_tpu_torch.models.layers import ConvBnAct
    from facedet_tpu_torch.models.rtdetr_l import ProjBn
    from facedet_tpu_torch.utils.synth import synthetic_faces

    found = []

    def hook(name, owner):
        def record(_m, _args, out):
            if isinstance(owner, ConvBnAct):
                found.append((name, owner.bn, owner.bn_dtype, owner.act, out.clone()))
            else:
                found.append((name, owner[1], torch.float32, False, out.clone()))

        return record

    handles = [(m.conv if isinstance(m, ConvBnAct) else m[0]).register_forward_hook(hook(name, m))
               for name, m in model.named_modules() if isinstance(m, (ConvBnAct, ProjBn))]
    arr = np.stack([synthetic_faces(SLICE, SLICE, seed=40 + i, n=3, size=(50, 140)) for i in range(batch)])
    x = torch.from_numpy(arr).permute(0, 3, 1, 2).contiguous().to("cuda", torch.bfloat16) / 255.0
    try:
        with torch.inference_mode():
            model.forward_nchw(x)
    finally:
        for h in handles:
            h.remove()
    return found


def _wide_bn(torch, bn, seed):
    """A copy of ``bn`` with statistics and affine drawn wide (variances over
    six orders of magnitude), on its device."""
    import copy

    g = torch.Generator().manual_seed(seed)
    c = bn.num_features
    wide = copy.deepcopy(bn)
    with torch.no_grad():
        wide.weight.copy_(1 + 0.3 * torch.randn(c, generator=g))
        wide.bias.copy_(0.5 * torch.randn(c, generator=g))
        wide.running_mean.copy_(torch.randn(c, generator=g))
        wide.running_var.copy_(torch.exp(2 * torch.randn(c, generator=g)))
    return wide


def _graph_ms(torch, fn, reps=10):
    """ms of one ``fn()`` from a CUDA graph of ``reps`` calls, the median of
    five timed replays: no host time between launches."""
    with torch.inference_mode():
        fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
        graph.replay()
        times = []
        for _ in range(5):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end) / reps)
    del graph
    return statistics.median(times)


def published_rtdetr(torch):
    """The benchmark's RT-DETR-l on the card: the published layout in
    bfloat16, with port_bench's seeded weights, which keep its bfloat16 run
    near float32 (port_bench/families/rtdetr.py)."""
    from port_bench import harness

    return harness.family("rtdetr").program(harness.cell("rtdetr-l.single_rgb").config, torch.device("cuda"))


def bn_act_kernel_phase(torch):
    """ConvBnAct's epilogue kernel at the main paths' shapes, against the
    chain it replaces; returns the ``bn_act@<detector>`` entries (6 tiles)."""
    from facedet_tpu_torch import YoloV11PoseDetectionModel
    from facedet_tpu_torch.ops.kernels.bn_act import bn_act, bn_act_ref

    def same(a, b):
        return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
            a.contiguous().view(torch.int16 if a.dtype == torch.bfloat16 else torch.int32),
            b.contiguous().view(torch.int16 if b.dtype == torch.bfloat16 else torch.int32))

    def within_a_bf16_ulp(a, b):  # cuDNN's channels-last BatchNorm rounds the affine in another order
        w = b.float()
        ulp = torch.where(w == 0, torch.full_like(w, 2.0 ** -133), 2.0 ** (torch.floor(torch.log2(w.abs())) - 7))
        differ = float((a.contiguous().view(torch.int16) != b.contiguous().view(torch.int16)).float().mean())
        return a.dtype == b.dtype == torch.bfloat16 and bool(((a.float() - w).abs() <= ulp).all()) and differ <= 0.01

    detectors = {
        "yolo11n": lambda: YoloV11PoseDetectionModel(model_path=CKPT, scale="n", image_size=SLICE,
                                                     dtype="bfloat16", device="cuda").model,
        "rtdetr-l": lambda: published_rtdetr(torch).model,
    }
    results = {}
    for name, make in detectors.items():
        model = make()
        for batch in (6, 1):
            found = _epilogue_inputs(torch, model, batch)
            check(len(found) == {"yolo11n": 87, "rtdetr-l": 122}[name],
                  f"bn_act: {len(found)} epilogues in one {name} forward")
            shapes, channels_last = set(), []
            with torch.inference_mode():
                for i, (mod, bn, out_dtype, act, x) in enumerate(found):
                    shapes.add(tuple(x.shape[1:]))
                    for stats in (bn, _wide_bn(torch, bn, i)):
                        got = bn_act(x, stats, out_dtype, act)
                        if x.is_contiguous():
                            check(same(got, bn_act_ref(x, stats, out_dtype, act)),
                                  f"bn_act differs from the chain at {name} {mod} {tuple(x.shape)}")
                        else:
                            check(same(got, bn_act_ref(x.contiguous(), stats, out_dtype, act)) and
                                  within_a_bf16_ulp(got, bn_act_ref(x, stats, out_dtype, act)),
                                  f"bn_act (channels-last) at {name} {mod} {tuple(x.shape)}")
                    if not x.is_contiguous():
                        channels_last.append(mod)
            check(channels_last == (["model.12"] if name == "rtdetr-l" and batch > 1 else []),
                  f"bn_act: channels-last conv outputs at {name} batch {batch}: {channels_last}")
            elements = sum(x.numel() for *_, x in found)
            nbytes = sum(x.numel() * (x.element_size() + torch.empty((), dtype=dt).element_size())
                         for _, _, dt, _, x in found)
            bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ms = _graph_ms(torch, lambda: [bn_act(x, bn, dt, act) for _, bn, dt, act, x in found])  # noqa: B023
            plain_ms = _graph_ms(torch, lambda: [bn_act_ref(x, bn, dt, act) for _, bn, dt, act, x in found])  # noqa: B023
            print(f"bn_act {name} batch {batch}: {len(found)} epilogues of {len(shapes)} shapes, bit for bit the "
                  f"chain (channels-last: {channels_last}); per forward: kernel {ms:.4f} ms, bound {bound_ms:.4f} ms "
                  f"({nbytes / 1e6:.1f} MB, {elements / 1e6:.1f} M elements), chain {plain_ms:.4f} ms, "
                  f"{nbytes / ms / 1e6:.0f} GB/s")
            if batch == 6:
                results[f"bn_act@{name}"] = {
                    "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
                    "library_ms": plain_ms,
                }
            del found
        del model
    torch.cuda.empty_cache()
    return results


def _compare(a, b, what, sides="card vs CPU"):
    """Detections dicts (to_numpy) of two runs: the card and the CPU unless
    ``sides`` names others."""
    import numpy as np

    check(a["boxes"].shape == b["boxes"].shape,
          f"{what}: {len(a['boxes'])} detections against {len(b['boxes'])} ({sides})")
    if len(a["boxes"]):
        err = {
            "boxes": float(np.abs(a["boxes"] - b["boxes"]).max()),
            "scores": float(np.abs(a["scores"] - b["scores"]).max()),
            "kpts": float(np.abs(a["kpts"][..., :2] - b["kpts"][..., :2]).max()),
        }
        check(err["boxes"] <= BOX_ATOL and err["scores"] <= SCORE_ATOL and err["kpts"] <= KPT_ATOL,
              f"{what}: {sides} {err}")
        print(f"{what}: {len(a['boxes'])} detections, {sides} max errors {err}")


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
    from facedet_tpu_torch.utils.profiling import kernel_groups, profile_kernels

    kernels = profile_kernels(run, n=n)
    n *= images
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / n
    launches = sum(e.count for e in kernels) / n
    check(device_ms > 0, f"profile {label}: the profiler saw no device time")
    print(f"profile {label}: device busy {device_ms:.3f} ms/image in {launches:.0f} kernel launches, "
          f"{100 * device_ms / wall_ms:.1f}% of the {wall_ms:.3f} ms wall time")
    for group, (ms, count) in kernel_groups(kernels, n).items():
        print(f"  {ms:8.3f} ms/image {count:8.1f} launches  {group}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.self_device_time_total / 1e3 / n:8.3f} ms/image  {e.count / n:8.1f}x  {e.key[:90]}")


def _reset_launches():
    """Sets the launch counts of the gathers and of bn_act to 0; returns the
    gathers' (bn_act's are ops.kernels.bn_act.LAUNCHES)."""
    from facedet_tpu_torch.ops.kernels import bn_act
    from facedet_tpu_torch.ops.kernels import tile_gather as tg

    for k in tg.LAUNCHES:
        tg.LAUNCHES[k] = 0
    bn_act.LAUNCHES["bn_act"] = 0
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
    kw = SLICED_KW
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
    from facedet_tpu_torch.ops.kernels import bn_act

    counts = {k: launches[k] for k in ("gather_hwc", "gather_chw")}
    counts["bn_act@yolo11n"] = bn_act.LAUNCHES["bn_act"]
    check(counts["bn_act@yolo11n"] > 0, "the single-image main path did not launch bn_act")
    print(f"launches on the single-image main path: {counts} (bn_act: eager forwards and graph captures; "
          f"a replay launches without Python)")
    return counts


def _photo(seed, hw=CANVAS, n=12, size=(50, 140)):
    """A seeded synthetic photo: ``n`` faces of ``size`` px on a background
    whose DCT planes are as sparse as a photograph's."""
    from facedet_tpu_torch.utils.synth import natural_background, synthetic_faces

    return synthetic_faces(*hw, seed=seed, n=n, size=size, background=natural_background(*hw, seed=seed))


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


_CODED: dict = {}


def _coded_photo(seed):
    """``_photo(seed)`` and its DCT coefficients, encoded once for the phases that share it."""
    from facedet_tpu_torch.ops.jpeg_dct import encode_dct420

    if seed not in _CODED:
        image = _photo(seed)
        _CODED[seed] = (image, encode_dct420(image))
    return _CODED[seed]


def batch_phase(torch, models):
    phase("7 batch of 8 (float32) against 8 single calls")
    from facedet_tpu_torch import get_sliced_prediction, get_sliced_prediction_batch
    from facedet_tpu_torch.ops.kernels import tile_gather as tg

    kw = {k: v for k, v in SERVING_KW.items() if k != "fetch_capacity"}
    coded = [_coded_photo(300 + s)[1] for s in range(8)]  # the serving phase's first eight
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

    phase("8 serving main path: predict_stream_batched, dct420s, batch 64, window 3, bfloat16")
    model = models["serving"]
    n_distinct, n_batches = 16, 3
    t0 = time.perf_counter()
    rgb, coded = map(list, zip(*(_coded_photo(300 + s) for s in range(n_distinct))))
    print(f"encoded {n_distinct} distinct 1024x1536 images once (8 of them in phase 7), the rest in "
          f"{time.perf_counter() - t0:.2f} s (not timed below)")
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

    rgb_passes = [SERVING_BATCH * n_batches / stream(rgb, "rgb", n_batches)[0] for _ in range(3)][1:]
    print(f"serving rgb (same stream, same images): {statistics.median(rgb_passes):.2f} images/s median of 2 passes "
          f"after one of warm-up (min {min(rgb_passes):.2f}, max {max(rgb_passes):.2f})")

    n_single = 24
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


def rrdb_conv_flops(cfg, h: int, w: int) -> float:
    """Multiply-adds times two of the RRDB net's convs on one h x w input:
    every conv is 3x3, so 2 * 9 * C_in * C_out per output pixel. The body
    (conv_first, num_block * 3 dense blocks of 5 convs, conv_body) runs at
    the input's size divided by the pixel-unshuffle factor, conv_up1 at twice
    that size, conv_up2, conv_hr and conv_last at four times."""
    nf, gc = cfg.num_feat, cfg.num_grow_ch
    m = {2: 2, 1: 4}.get(cfg.scale, 1)
    px = (h // m) * (w // m)
    dense = sum((nf + i * gc) * gc for i in range(4)) + (nf + 4 * gc) * nf
    per_px = cfg.num_in_ch * m * m * nf + cfg.num_block * 3 * dense + nf * nf  # conv_first, body, conv_body
    per_px += 4 * nf * nf + 16 * (2 * nf * nf + nf * cfg.num_out_ch)  # conv_up1; conv_up2, conv_hr, conv_last
    return 2.0 * 9.0 * per_px * px


def sr_plan_flops(enh, h: int, w: int):
    """(plan, window, conv FLOPs) of one enhance_array call on an h x w
    image: the windows of plan_tile_grid, halos included."""
    from facedet_tpu_torch.engine.enhancer import plan_tile_grid

    m = {2: 2, 1: 4}.get(enh.cfg.scale, 1)
    h, w = h + (-h) % m, w + (-w) % m
    gh, gw, th, tw = plan_tile_grid(h, w, enh.tile, enh.tile_pad, enh.max_tiles_per_batch)
    win = (th + (2 * enh.tile_pad if gh > 1 else 0), tw + (2 * enh.tile_pad if gw > 1 else 0))
    return (gh, gw, th, tw), win, gh * gw * rrdb_conv_flops(enh.cfg, *win)


def _psnr(a, b) -> float:
    import numpy as np

    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0 else 10.0 * np.log10(1.0 / mse)


def sr_fidelity_phase(torch):
    """Returns the float32 enhancers {name: (cpu, cuda)} for later phases."""
    phase("10 SR fidelity (float32, TF32 off): card against CPU, golden weights, 96x128")
    import numpy as np

    from facedet_tpu_torch import FaceEnhancer
    from facedet_tpu_torch.engine.enhancer import _golden_ckpt_path

    for name in ("RealESRGAN_x2plus", "RealESRGAN_x4plus", "RealESRGAN_x4cascade"):
        # without its checkpoint a catalog name falls back to a random init, as in the JAX package
        check(_golden_ckpt_path(name) is not None, f"the golden checkpoint of {name} is missing from the checkout")
    image = _photo(400, hw=(96, 128), n=2, size=(20, 40))
    x = image.astype(np.float32) / 255.0
    pairs = {}
    for name, scale in (("RealESRGAN_x2plus", 2), ("RealESRGAN_x4plus", 4)):
        cpu = FaceEnhancer(name, outscale=scale, half=False, device="cpu")
        card = FaceEnhancer(name, outscale=scale, half=False, device="cuda")
        check(card.cfg.num_block == 23 and card.cfg.num_feat == 64 and card.cfg.num_grow_ch == 32 and
              card.get_model_info()["num_params"] > 16_000_000, f"{name} is not the full-width net")
        with np.load(_golden_ckpt_path(name)) as flat:
            kernel = torch.from_numpy(flat["params/conv_last/kernel"].astype(np.float32)).permute(3, 2, 0, 1)
        check(torch.equal(card.model.conv_last.weight.cpu(), kernel), f"{name} does not hold its golden weights")
        t0 = time.perf_counter()
        want = cpu.enhance_array(torch.from_numpy(x)).numpy()
        cpu_s = time.perf_counter() - t0
        got_t = card.enhance_array(torch.from_numpy(x))
        check(got_t.is_cuda and got_t.dtype == torch.float32, f"{name}: enhance_array left the card")
        got = got_t.cpu().numpy()
        check(got.shape == want.shape == (96 * scale, 128 * scale, 3) and np.isfinite(got).all(),
              f"{name}: output shape {got.shape}")
        err = float(np.abs(got - want).max())
        want8, _ = cpu.enhance_image(image)
        got8, _ = card.enhance_image(image)
        diff = np.abs(got8.astype(int) - want8.astype(int))
        share = float((diff != 0).mean())
        check(err <= 1e-3 and diff.max() <= 1 and share <= 1e-3,
              f"{name}: card vs CPU max abs {err}, uint8 differences {share:.5f} of values, largest {diff.max()}")
        check(float(got.std()) > 0.02, f"{name}: the output is flat")
        print(f"{name} float32: card vs CPU max abs err {err:.3g} on [0, 1]; uint8 outputs differ on "
              f"{share * 100:.4f}% of values by at most {diff.max()} level; CPU run {cpu_s:.1f} s")
        pairs[name] = (cpu, card)
    return pairs


def sr_main_path_phase(torch, f32):
    """FaceEnhancer.enhance_image at full width in bfloat16. Returns the
    bfloat16 enhancers for the pipelines and the launch counts, set to 0 here."""
    phase("11 SR main path: FaceEnhancer.enhance_image, bfloat16, golden weights (launch counts from 0)")
    import numpy as np

    from facedet_tpu_torch import FaceEnhancer

    launches = _reset_launches()
    served = {}
    for name, scale, hw in (("RealESRGAN_x2plus", 2, CANVAS), ("RealESRGAN_x4plus", 4, (512, 768))):
        enh = FaceEnhancer(name, outscale=scale)
        check(enh.device.type == "cuda" and enh.cfg.dtype == "bfloat16" and enh.tile == 400,
              f"{name}: default FaceEnhancer is {enh.device}, {enh.cfg.dtype}, tile {enh.tile}")
        images = [_photo(410 + i, hw=hw) for i in range(7)]
        plan, win, flops = sr_plan_flops(enh, *hw)
        before = launches["gather_chw"]
        torch.cuda.reset_peak_memory_stats()
        times = []
        for i, im in enumerate(images):
            out, dt = enh.enhance_image(im)  # fetches the uint8 result: the call ends synchronised
            check(out.shape == (hw[0] * scale, hw[1] * scale, 3) and out.dtype == np.uint8, f"{name}: output {out.shape}")
            if i >= 2:
                times.append(dt)
        peak = torch.cuda.max_memory_allocated() / 1e9
        windows = plan[0] * plan[1]
        gathers = (launches["gather_chw"] - before) // len(images)
        check(gathers == (1 if windows > 1 else 0), f"{name}: {gathers} window gathers per image for {windows} windows")
        ms = statistics.median(times) * 1e3
        print(f"{name} bfloat16 {hw[0]}x{hw[1]} -> x{scale}: plan {plan[0]}x{plan[1]} windows of {win[0]}x{win[1]} "
              f"(tile {plan[2]}x{plan[3]}), chunks of {enh.max_tiles_per_batch}; median {ms:.2f} ms/image over "
              f"{len(times)} images after 2 of warm-up (min {min(times) * 1e3:.2f}, max {max(times) * 1e3:.2f}); "
              f"{flops / 1e12:.3f} TFLOP of convs, {flops / ms / 1e9:.1f} TFLOP/s achieved "
              f"({100 * flops / ms / 1e9 / (BF16_FLOPS_PER_S / 1e12):.1f}% of the bfloat16 peak); "
              f"peak memory {peak:.2f} GB; window gathers per image {gathers}")
        _profile(torch, lambda: enh.enhance_image(images[2]), ms, n=1, label=f"{name} bfloat16")  # noqa: B023
        # bfloat16 against float32 on the card, by PSNR
        x = torch.from_numpy(images[2].astype(np.float32) / 255.0)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        ref = f32[name][1].enhance_array(x).cpu().numpy()
        f32_ms = (time.perf_counter() - t0) * 1e3
        f32_peak = torch.cuda.max_memory_allocated() / 1e9
        half = enh.enhance_array(x).cpu().numpy()
        psnr = _psnr(half, ref)
        check(np.isfinite(half).all() and psnr >= 30.0, f"{name}: bfloat16 against float32 PSNR {psnr:.2f} dB")
        print(f"{name}: bfloat16 against float32 (TF32 off) on the card: PSNR {psnr:.2f} dB, max abs "
              f"{float(np.abs(half - ref).max()):.4f}; the float32 run {f32_ms:.1f} ms, peak memory {f32_peak:.2f} GB")
        served[name] = enh
    # the cascade alias (the x2 net twice) and outscale 2 on the x4 net (lanczos3 down)
    small = _photo(420, hw=(256, 384), n=4, size=(30, 70))
    cascade = FaceEnhancer("RealESRGAN_x4cascade", outscale=4)
    check(cascade.cascade and cascade.cfg.scale == 2, "the cascade alias did not resolve to the x2 net")
    out, dt = cascade.enhance_image(small)
    out, dt = cascade.enhance_image(small)
    check(out.shape == (1024, 1536, 3) and float(out.std()) > 5, f"cascade output {out.shape}")
    print(f"RealESRGAN_x4cascade 256x384 -> 1024x1536: {dt * 1e3:.1f} ms (second call)")
    out, dt = served["RealESRGAN_x4plus"].enhance_image(small, outscale=2)
    out, dt = served["RealESRGAN_x4plus"].enhance_image(small, outscale=2)
    ref = f32["RealESRGAN_x4plus"][1].enhance_image(small, outscale=2)[0]
    check(out.shape == (512, 768, 3), f"outscale 2 on the x4 net: {out.shape}")
    psnr = _psnr(out / 255.0, ref / 255.0)
    check(psnr >= 30.0, f"outscale 2 on the x4 net: bfloat16 against float32 PSNR {psnr:.2f} dB")
    print(f"RealESRGAN_x4plus outscale=2 (lanczos3 down) 256x384 -> 512x768: {dt * 1e3:.1f} ms (second call), "
          f"PSNR against float32 {psnr:.2f} dB")
    return served, launches


def pipeline_v2_phase(torch, models, f32, served):
    """enhance_first_pipeline; returns the gather launches on the enhanced canvas."""
    phase("12 pipeline v2: enhance_first_pipeline (x2, fixed_grid) with yolo11n")
    import numpy as np

    from facedet_tpu_torch.engine import pipelines, predict
    from facedet_tpu_torch.ops.kernels import tile_gather as tg

    # fidelity, float32: the card against the CPU on 256x384
    small = _photo(430, hw=(256, 384), n=4, size=(30, 70))
    cpu_enh, card_enh = f32["RealESRGAN_x2plus"]
    want = pipelines.enhance_first_pipeline(small, models["cpu"], cpu_enh)
    got = pipelines.enhance_first_pipeline(small, models["cuda"], card_enh)
    check(len(want.object_prediction_list) > 0, "v2 on the CPU found nothing on the small image")
    _compare(got.detections.to_numpy(), want.detections.to_numpy(), "enhance_first_pipeline float32, 256x384")
    diff = np.abs(got.enhanced_image.astype(int) - want.enhanced_image.astype(int))
    check(got.enhanced_image.dtype == np.uint8 and got.enhanced_image.shape == (512, 768, 3) and diff.max() <= 1,
          f"v2 enhanced image: {got.enhanced_image.dtype} {got.enhanced_image.shape}, max diff {diff.max()}")

    # the main path: 1024x1536, bfloat16 enhancer and detector. Recording
    # wrappers show where the enhanced image lies when detection takes it
    # and which canvas the gather is launched on.
    enh, det = served["RealESRGAN_x2plus"], models["serving"]
    seen = {"inputs": [], "canvases": []}
    real_sliced, real_gather = pipelines.get_sliced_prediction, predict.gather_tiles_chw

    def sliced(image, *a, **k):
        seen["inputs"].append((type(image).__name__, getattr(image, "device", None), tuple(image.shape),
                               getattr(image, "dtype", None)))
        return real_sliced(image, *a, **k)

    def gather(canvas, offsets, sh, sw):
        before = tg.LAUNCHES["gather_chw"]
        out = real_gather(canvas, offsets, sh, sw)
        seen["canvases"].append((tuple(canvas.shape), canvas.device.type, len(offsets), sh, sw,
                                 tg.LAUNCHES["gather_chw"] - before))
        return out

    pipelines.get_sliced_prediction, predict.gather_tiles_chw = sliced, gather
    try:
        images = [_photo(440 + i) for i in range(7)]
        enhance_ms, total_ms = [], []
        for i, im in enumerate(images):
            t0 = time.perf_counter()
            res = pipelines.enhance_first_pipeline(im, det, enh)
            dt = (time.perf_counter() - t0) * 1e3
            if i >= 2:
                total_ms.append(dt)
                enhance_ms.append(res.durations_in_seconds["enhance"] * 1e3)
    finally:
        pipelines.get_sliced_prediction, predict.gather_tiles_chw = real_sliced, real_gather
    offs, sh, sw = enhance_first_offsets()
    for kind, device, shape, dtype in seen["inputs"]:
        check(kind == "Tensor" and device.type == "cuda" and shape == (*ENHANCED, 3) and dtype == torch.float32,
              f"detection took the enhanced image as {kind} on {device}, {shape}, {dtype}")
    want_canvas = ((3, *ENHANCED), "cuda", len(offs), sh, sw, 1)
    check(len(seen["canvases"]) == len(images) and all(c == want_canvas for c in seen["canvases"]),
          f"the gather ran on {seen['canvases'][:2]}, expected {want_canvas} once per image")
    n_launches = sum(c[-1] for c in seen["canvases"])
    det_np = res.detections.to_numpy()
    check(len(res.object_prediction_list) > 0 and np.isfinite(det_np["boxes"]).all(), "v2 found nothing at 1024x1536")
    x, y = det_np["boxes"][:, 0::2], det_np["boxes"][:, 1::2]
    check((x >= 0).all() and (x <= CANVAS[1]).all() and (y >= 0).all() and (y <= CANVAS[0]).all(),
          "v2 boxes are not in the original image's coordinates")
    check(res.image.shape == (*CANVAS, 3) and res.enhanced_image.shape == (*ENHANCED, 3) and
          res.enhanced_image.dtype == np.uint8, f"v2 images: {res.image.shape}, {res.enhanced_image.shape}")
    print(f"the enhanced {ENHANCED[0]}x{ENHANCED[1]} tensor went into get_sliced_prediction on the card (float32, "
          f"never on the host before the uint8 display fetch); gather_chw launched {n_launches} times on a "
          f"3x{ENHANCED[0]}x{ENHANCED[1]} canvas, {len(offs)} tiles of {sh}x{sw}")
    e, t = statistics.median(enhance_ms), statistics.median(total_ms)
    print(f"enhance_first_pipeline bfloat16 1024x1536: median {t:.2f} ms/image over {len(total_ms)} images after 2 "
          f"of warm-up (min {min(total_ms):.2f}, max {max(total_ms):.2f}): enhance {e:.2f} ms, detection, mapping "
          f"and the display fetch {t - e:.2f} ms; {len(res.object_prediction_list)} faces on the last image")
    return n_launches


def pipeline_v1_phase(torch, models, f32, served):
    phase("13 pipeline v1 and the fetch wire")
    import numpy as np
    from PIL import Image

    from facedet_tpu_torch.core.detections import Detections
    from facedet_tpu_torch.engine import pipelines
    from facedet_tpu_torch.utils.viz import save_image

    enh = served["RealESRGAN_x4plus"]
    image = _photo(450)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as tmp:
        crops_dir = os.path.join(tmp, "crops")
        t0 = time.perf_counter()
        result, stats = pipelines.detect_first_pipeline(image, models["serving"], enhancer=enh, crops_dir=crops_dir)
        dt = time.perf_counter() - t0
        n = len(result.object_prediction_list)
        check(n > 0, "v1 found nothing")
        # enhance_face_crops_batch swallows a crop's exception: a broken
        # enhancer shows only here
        check(stats["failed"] == 0 and stats["enhanced"] == stats["total"] == n,
              f"v1 enhanced {stats['enhanced']} of {stats['total']} crops for {n} faces, failed {stats['failed_files']}")
        for name in sorted(os.listdir(crops_dir)):
            a = Image.open(os.path.join(crops_dir, name)).size
            b = Image.open(os.path.join(crops_dir + "_enhanced", name)).size
            check(b == (a[0] * 4, a[1] * 4), f"crop {name}: {a} -> {b}")
        print(f"detect_first_pipeline 1024x1536: {n} faces, {stats['enhanced']} crops enhanced x4, failed 0; "
              f"{dt * 1e3:.1f} ms in all, {result.durations_in_seconds['enhance'] * 1e3:.1f} ms of crops and enhancement")

        # detect -> crop -> enhance on the device, for the detected faces
        det = result.detections
        keep = det.valid.nonzero().flatten()
        faces = Detections(*(getattr(det, f)[keep] for f in ("boxes", "scores", "classes", "kpts", "valid")))
        x = torch.from_numpy(image).cuda().float() / 255.0
        crops = enh.enhance_detections(x, faces, crop_size=128)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        crops = enh.enhance_detections(x, faces, crop_size=128)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) * 1e3
        check(crops.shape == (n, 512, 512, 3) and crops.is_cuda and bool(torch.isfinite(crops).all()) and
              float(crops.std()) > 0.02, f"enhance_detections: {tuple(crops.shape)}")
        print(f"enhance_detections crop_size=128: {n} faces -> {tuple(crops.shape)} on the card in {dt:.1f} ms")

        # the DCT fetch pipeline, float32: the card against the CPU
        crop = _photo(451, hw=(90, 84), n=1, size=(25, 38))
        src = os.path.join(tmp, "crop.png")
        save_image(src, crop)
        cpu_enh, card_enh = f32["RealESRGAN_x4plus"]
        for sparse in (False, True):
            outs = []
            for e in (cpu_enh, card_enh):
                xb, _, _ = e._load_bucketed(src)
                pipeline, qy, qc, thw = e._enhance_dct_pipeline(xb.shape[0], xb.shape[1], 4.0, 95, sparse=sparse)
                outs.append([t.cpu().numpy() for t in pipeline(xb)])
            want, got = outs
            names = ("y_dc", "uv_dc", "bitmap", "vals", "nnz", "n_clipped") if sparse else \
                ("y_dc", "y_ac", "uv_dc", "uv_ac", "n_clipped")
            report = []
            for name, g, w in zip(names, got, want):
                check(g.shape == w.shape and g.dtype == w.dtype, f"fetch planes {name}: {g.shape} {g.dtype}")
                if name in ("bitmap", "vals"):
                    continue  # one coefficient more or less shifts every later value: compared unpacked below
                d = np.abs(g.astype(np.int64) - w.astype(np.int64))
                report.append(f"{name} {int((d != 0).sum())}/{d.size} differ (max {int(d.max()) if d.size else 0})")
            if sparse:
                from facedet_tpu_torch.ops.jpeg_dct import unpack_sparse_bitmap_np

                n_ac = got[2].size * 8
                cap = got[3].shape[0]
                check(int(got[4]) <= cap, f"sparse fetch: nnz {int(got[4])} above the cap {cap}")
                d = np.abs(unpack_sparse_bitmap_np(got[2], got[3], n_ac).astype(int) -
                           unpack_sparse_bitmap_np(want[2], want[3], n_ac).astype(int))
                check(d.max() <= 1 and (d != 0).mean() <= 1e-3, f"sparse AC: {(d != 0).sum()} differ, max {d.max()}")
                report.append(f"unpacked AC {int((d != 0).sum())}/{d.size} differ (max {int(d.max())}); "
                              f"nnz {int(got[4])} of cap {cap}")
            else:
                for g, w in zip(got[:4], want[:4]):
                    d = np.abs(g.astype(int) - w.astype(int))
                    check(d.max() <= 1 and (d != 0).mean() <= 1e-3, f"dense planes: {(d != 0).sum()} differ, max {d.max()}")
            check(int(got[-1]) == int(want[-1]), f"n_clipped {int(got[-1])} on the card, {int(want[-1])} on the CPU")
            print(f"_enhance_dct_pipeline {'sparse' if sparse else 'dense'}, x4 of a 90x84 crop in its 96x96 bucket, "
                  f"quality 95, card vs CPU: " + "; ".join(report) + f"; n_clipped {int(got[-1])}")

        # enhance_to_jpeg on the serving enhancer: which branch runs, and the bytes of each fetch format
        rgb_bytes = 90 * 4 * 84 * 4 * 3
        for sparse in (False, True):
            dst = os.path.join(tmp, f"crop_{'sparse' if sparse else 'dense'}.jpg")
            check(enh.enhance_to_jpeg(src, dst, sparse=sparse), "enhance_to_jpeg returned False")
            info = enh.last_fetch
            check(Image.open(dst).size == (84 * 4, 90 * 4), f"enhance_to_jpeg wrote {Image.open(dst).size}")
            counted = "" if "natively" in info["branch"] else \
                " (not the native coefficient writer: this run is no measurement of the coefficient fetch)"
            print(f"enhance_to_jpeg sparse={sparse}: branch: {info['branch']}{counted}; {info}; "
                  f"uint8 RGB fetch of the cropped result would move {rgb_bytes} bytes")


def _start_clis(runs, extra=()):
    """{key: Popen} of ``python -m facedet_tpu_torch.apps.<app> <args>`` for runs {key: (app, args, files)}."""
    return {
        key: subprocess.Popen([sys.executable, "-m", f"facedet_tpu_torch.apps.{app}", *args, *extra], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for key, (app, args, _) in runs.items()
    }


def _collect_clis(procs, runs, tmp) -> dict:
    """Waits for each process: exit code 0 and its files present. Returns each one's output."""
    outs = {}
    for key, proc in procs.items():
        out, _ = proc.communicate(timeout=600)
        check(proc.returncode == 0, f"{key} exited with {proc.returncode}:\n{out[-2000:]}")
        for f in runs[key][2]:
            check(os.path.exists(os.path.join(tmp, f)), f"{key} wrote no {f}")
        last = [line for line in out.strip().splitlines() if line][-1]
        print(f"{key}: exit 0, {len(runs[key][2])} output files present; last line: {last}")
        outs[key] = out
    return outs


def cli_phase(ev):
    """Phases 14 and 19. All twelve processes start together, so that the
    eight of phase 19 load torch while the four of phase 14 run; nothing else
    runs on the card meanwhile, and no timed phase overlaps them. Returns the
    JSON results of the two evaluation CLIs, run on the layout ``ev``."""
    from facedet_tpu_torch.utils.viz import save_image

    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as tmp:
        inp, crops, inp2 = os.path.join(tmp, "in"), os.path.join(tmp, "crops"), os.path.join(tmp, "in2")
        for d in (inp, crops, inp2):
            os.makedirs(d)
        for s in (41, 42):
            save_image(os.path.join(inp, f"img{s}.png"), _photo(s, hw=(256, 384), n=4, size=(30, 70)))
            save_image(os.path.join(crops, f"face{s}.jpg"), _photo(s, hw=(70, 60), n=1, size=(20, 28)))
        for s in (61, 62):
            save_image(os.path.join(inp2, f"img{s}.png"), _photo(s, hw=(512, 768), n=5, size=(40, 110)))
        det = ["--model-path", CKPT, "--scale", "n"]
        runs = {
            "app_v2": ("app_v2", ["--input", inp, "--output", os.path.join(tmp, "v2"), "--outscale", "2", *det],
                       [os.path.join("v2", f"img{s}", f"img{s}_{k}.jpg") for s in (41, 42) for k in ("detections", "enhanced")]),
            "app_v1": ("app_v1", ["--input", inp, "--output", os.path.join(tmp, "v1"), "--outscale", "4", *det],
                       [os.path.join("v1", f"img{s}", f) for s in (41, 42)
                        for f in (f"img{s}_detections.jpg", "enhancement_summary.txt")]),
            "app_enhancer": ("app_enhancer", ["--input", crops, "--output", os.path.join(tmp, "enh"), "--model",
                                              "RealESRGAN_x2plus", "--outscale", "2", "--fetch", "dct420s"],
                             [os.path.join("enh", f) for f in ("face41.jpg", "face42.jpg", "enhancement_summary.txt")]),
            "app_yolo_full": ("app_yolo_full", ["--input", inp, "--output", os.path.join(tmp, "full"), *det],
                              [os.path.join("full", f"img{s}", f) for s in (41, 42)
                               for f in (f"img{s}_enhanced_detections.jpg", f"img{s}_summary.txt")]),
        }
        one = os.path.join(inp2, "img61.png")
        sahi_files = lambda d: [os.path.join(d, f"img{s}", f"img{s}_{k}") for s in (61, 62)  # noqa: E731
                                for k in ("detections.jpg", "summary.txt")]
        family_runs = {
            "scrfd": ("app_yolo_sahi", ["--input", inp2, "--output", os.path.join(tmp, "scrfd"), "--family", "scrfd",
                                        "--model-path", SCRFD_CKPT], sahi_files("scrfd")),
            # random weights: a high threshold keeps the number of drawings and crops small
            "rtdetr": ("app_yolo_sahi", ["--input", inp2, "--output", os.path.join(tmp, "rtdetr"), "--family", "rtdetr",
                                         "--conf", "0.9"], sahi_files("rtdetr")),
            "fake": ("app_yolo_sahi", ["--input", inp2, "--output", os.path.join(tmp, "fake"), "--family", "fake"],
                     sahi_files("fake")),
            "app_retinaface": ("app_retinaface", ["--input", inp2, "--output", os.path.join(tmp, "rf"), "--model-path",
                                                  SCRFD_CKPT, "--det-thresh", "0.3"],
                               [os.path.join("rf", f"img{s}_retinaface.jpg") for s in (61, 62)]),
            "inference_direct": ("inference_direct", ["--input", one, *det], []),
            "app_yolo_inference": ("app_yolo_inference", ["--input", one, "--output", os.path.join(tmp, "inf"), *det,
                                                          "--conf", "0.3"],
                                   [os.path.join("inf", f) for f in ("img61_detections.jpg", "img61_summary.txt")]),
        }
        # the evaluators with what their CLIs build: yolo11n, bfloat16, letterbox 1024, conf 0.01
        eval_out = {k: os.path.join(ev["root"], k) for k in ("eval_official", "eval_dual_cli")}
        eval_files = {"eval_official": "official_eval_results.json", "eval_dual_cli": "dual_eval_results.json"}
        family_runs.update({
            k: (k, ["--images", ev["images"], "--gt-txt", ev["gt"], *det, "--output", eval_out[k]],
                [os.path.join(eval_out[k], eval_files[k])])
            for k in eval_out
        })
        phase("14 CLIs as subprocesses: app_v2, app_v1, app_enhancer --fetch dct420s, app_yolo_full")
        t0 = time.perf_counter()
        procs = _start_clis({**runs, **family_runs}, extra=("--device", "cuda"))
        try:
            outs = _collect_clis({k: procs[k] for k in runs}, runs, tmp)
            check("Enhanced: 2" in outs["app_enhancer"] and "Failed: 0" in outs["app_enhancer"],
                  f"app_enhancer's summary:\n{outs['app_enhancer'][-1000:]}")
            phase("19 the other families' and the evaluators' CLIs as subprocesses (started with phase 14's)")
            outs = _collect_clis({k: procs[k] for k in family_runs}, family_runs, tmp)
            for key in ("scrfd", "fake", "inference_direct", "app_yolo_inference"):
                last = [line for line in outs[key].strip().splitlines() if line][-1]
                check(" 0 faces" not in last, f"{key} found nothing: {last}")
            per_image = [int(m) for m in re.findall(r"^img6[12]: (\d+) faces$", outs["app_retinaface"], re.M)]
            check(len(per_image) == 2 and sum(per_image) > 0,
                  f"app_retinaface found {per_image} faces:\n{outs['app_retinaface'][-1000:]}")
            print(f"app_retinaface: faces per image {per_image}")
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        print(f"twelve CLI runs, started together: {time.perf_counter() - t0:.1f} s")
    results = {}
    for k, f in eval_files.items():
        with open(os.path.join(eval_out[k], f)) as fh:
            results[k] = json.load(fh)
    print(f"eval_official CLI: {results['eval_official']}")
    return results


def _kernel_launches(torch, run) -> int:
    """Device kernels launched by one ``run()``, counted by the profiler
    (a guarded window, after one unprofiled run)."""
    from facedet_tpu_torch.utils.profiling import profile_kernels

    run()
    return sum(e.count for e in profile_kernels(run))


def scrfd_fidelity_phase(torch):
    """Returns the float32 SCRFD pair {"cpu", "cuda"}."""
    phase("15 SCRFD fidelity (float32, TF32 off): golden scrfd_2.5g, card against CPU")
    import numpy as np

    from facedet_tpu_torch import get_sliced_prediction, get_sliced_prediction_batch
    from facedet_tpu_torch.engine.scrfd_wrapper import ScrfdDetectionModel
    from facedet_tpu_torch.ops.kernels import tile_gather as tg

    check(os.path.exists(SCRFD_CKPT), f"missing checkpoint {SCRFD_CKPT}")
    kw = dict(model_path=SCRFD_CKPT, variant="scrfd_2.5g", dtype="float32", image_size=SLICE, confidence_threshold=0.3)
    pair = {"cpu": ScrfdDetectionModel(device="cpu", **kw), "cuda": ScrfdDetectionModel(device="cuda", **kw)}
    with np.load(SCRFD_CKPT) as flat:
        check(len(flat.files) == 203, f"the SCRFD checkpoint holds {len(flat.files)} leaves")
        kernel = torch.from_numpy(flat["params/head/l2_kps/kernel"].astype(np.float32)).permute(3, 2, 0, 1)
    check(torch.equal(pair["cuda"].model.head.l2_kps.weight.cpu(), kernel), "SCRFD does not hold its golden weights")
    image = _photo(500)
    want = get_sliced_prediction(image, pair["cpu"], **SLICED_KW).detections.to_numpy()
    before = tg.LAUNCHES["gather_chw"]
    got = get_sliced_prediction(image, pair["cuda"], **SLICED_KW)
    check(tg.LAUNCHES["gather_chw"] == before + 1, "SCRFD's get_sliced_prediction did not launch the CHW gather once")
    check(len(want["boxes"]) > 0, "the golden SCRFD found nothing on the synthetic image")
    _compare(got.detections.to_numpy(), want, "SCRFD get_sliced_prediction float32")

    images = [_photo(501 + i) for i in range(4)]
    before = dict(tg.LAUNCHES)
    batch = get_sliced_prediction_batch(images, pair["cuda"], **SLICED_KW)
    batched = tg.LAUNCHES["gather_chw_batched"] - before["gather_chw_batched"]
    check(batched == 1 and tg.LAUNCHES["gather_chw"] == before["gather_chw"],
          f"SCRFD's batch of 4 launched the batched gather {batched} times")
    for i, (res, im) in enumerate(zip(batch, images)):
        single = get_sliced_prediction(im, pair["cuda"], **SLICED_KW)
        _compare(res.detections.to_numpy(), single.detections.to_numpy(), f"SCRFD batch image {i}", "batch vs single call")
    return pair


def scrfd_main_path_phase(torch):
    """Returns the launch counts of this main path."""
    phase("16 SCRFD main path: get_sliced_prediction, bfloat16, golden scrfd_2.5g (launch counts from 0)")
    from facedet_tpu_torch import get_sliced_prediction, get_sliced_prediction_batch
    from facedet_tpu_torch.engine.scrfd_wrapper import FaceAnalysis, ScrfdDetectionModel

    launches = _reset_launches()
    model = ScrfdDetectionModel(model_path=SCRFD_CKPT, image_size=SLICE, confidence_threshold=0.3)
    check(model.device.type == "cuda" and model.dtype == "bfloat16" and
          model.model.backbone.stem.weight.dtype == torch.bfloat16 and
          model.model.head.l0_gn0.weight.dtype == torch.float32,
          f"default ScrfdDetectionModel is {model.device}, {model.dtype}")
    images = [_photo(510 + i) for i in range(12)]
    times, found = _serve(model, images, SLICED_KW, "SCRFD bfloat16")
    ms = statistics.median(times)
    print(f"SCRFD get_sliced_prediction bfloat16, 1024x1536, 6+1 tiles of 640: median {ms:.3f} ms/image over "
          f"{len(times)} images (min {min(times):.3f}, max {max(times):.3f}); detections per image {found}")
    check(launches["gather_chw"] == len(images), f"{launches['gather_chw']} CHW gathers for {len(images)} images")
    _profile(torch, lambda: get_sliced_prediction(images[0], model, **SLICED_KW), ms, label="SCRFD bfloat16")
    batch = get_sliced_prediction_batch(images[:4], model, **SLICED_KW)
    check(len(batch) == 4 and launches["gather_chw_batched"] == 1, "SCRFD's bfloat16 batch of 4")
    counts = {k: launches[k] for k in ("gather_chw", "gather_chw_batched")}
    print(f"launches on the SCRFD main path: {counts}")

    fa = FaceAnalysis(name="scrfd_2.5g", model_path=SCRFD_CKPT)
    fa.prepare(det_size=(0, 0), det_thresh=0.3)
    check(fa.det_size == (640, 640) and fa._model.device.type == "cuda", f"FaceAnalysis.prepare: {fa.det_size}")
    faces = fa.get(images[0])
    check(len(faces) > 0 and all((f.bbox >= 0).all() and f.bbox[2] <= CANVAS[1] and f.bbox[3] <= CANVAS[0] and
                                 f.kps.shape == (5, 2) for f in faces), "FaceAnalysis.get")
    print(f"FaceAnalysis.get (one letterboxed pass at 640): {len(faces)} faces, best score {faces[0].det_score:.3f}")
    return counts


def rtdetr_phase(torch):
    """Returns the launch counts of RT-DETR's main path."""
    phase("17 RT-DETR: rtdetr-l, seeded init; float32 card against CPU, then the bfloat16 main path")
    import numpy as np

    from facedet_tpu_torch import get_sliced_prediction
    from facedet_tpu_torch.engine.rtdetr_wrapper import RtDetrDetectionModel
    from facedet_tpu_torch.ops.tiler import gather_tiles

    kw = dict(variant="rtdetr-l", seed=7, image_size=SLICE, confidence_threshold=0.5)
    cpu = RtDetrDetectionModel(dtype="float32", device="cpu", **kw)
    card = RtDetrDetectionModel(dtype="float32", device="cuda", **kw)
    cfg = card.cfg
    check((cfg.hidden_dim, cfg.num_queries, cfg.num_decoder_layers, cfg.num_heads, cfg.num_points) == (256, 300, 6, 8, 4),
          f"rtdetr-l is {cfg}")
    n_params = sum(p.numel() for p in card.model.parameters())
    for (name, a), (_, b) in zip(cpu.model.state_dict().items(), card.model.state_dict().items()):
        check(torch.equal(a, b.cpu()), f"the seeded init differs between the CPU and the card at {name}")
    image = _photo(520)
    canvas = torch.from_numpy(image).float() / 255.0
    offsets = torch.from_numpy(production_offsets()[:2].copy())
    tiles = gather_tiles(canvas, offsets, SLICE, SLICE).permute(0, 3, 1, 2).contiguous()  # [2,3,640,640] on the host
    from facedet_tpu_torch.engine.detector import _exact_float32

    with torch.inference_mode(), _exact_float32(True):
        t0 = time.perf_counter()
        want = cpu.model.forward_nchw(tiles)
        cpu_s = time.perf_counter() - t0
        got = card.model.forward_nchw(tiles.cuda())
        n_tokens = want["enc_logits"].shape[1]
        check(n_tokens == 8400 and tuple(got["top_idx"].shape) == (2, 300), f"{n_tokens} encoder tokens")
        score_w = want["enc_logits"].float().max(-1).values
        score_g = got["enc_logits"].float().max(-1).values.cpu()
        enc_err = float((score_w - score_g).abs().max())
        same = torch.equal(got["top_idx"].cpu(), want["top_idx"])
        ordered = torch.sort(score_w, dim=1, descending=True).values
        gap_at_cut = float((ordered[:, 299] - ordered[:, 300]).min())
        if not same:
            # where the selections differ, the scores at fault lie closer than the card and the CPU agree
            sel_w, sel_g = want["top_idx"], got["top_idx"].cpu()
            moved = sel_w != sel_g
            closest = float((torch.gather(score_w, 1, sel_w)[moved] - torch.gather(score_w, 1, sel_g)[moved]).abs().max())
            check(closest <= max(1e-5, 4 * enc_err),
                  f"the query selection differs by tokens whose scores lie {closest} apart (encoder scores agree to {enc_err})")
            print(f"query selection: top_idx differs at {int(moved.sum())} of 600 places, between tokens whose "
                  f"scores lie at most {closest:.3g} apart; gap at the cut {gap_at_cut:.3g}")
        print(f"encoder scores of 2x{n_tokens} tokens: card vs CPU max err {enc_err:.3g}; top_idx equal: {same}; "
              f"score gap at the cut (300th against 301st) {gap_at_cut:.3g}; CPU forward {cpu_s:.1f} s")
        given = card.model.forward_nchw(tiles.cuda(), top_idx=want["top_idx"].cuda())
    logit_err = float((given["logits"][-1].cpu() - want["logits"][-1]).abs().max())
    box_err = float((given["boxes"][-1].cpu() - want["boxes"][-1]).abs().max())
    check(logit_err <= 1e-3 and box_err <= 1e-3 and bool(torch.isfinite(given["logits"][-1]).all()),
          f"RT-DETR last layer, same selection: logits {logit_err}, boxes {box_err}")
    print(f"last decoder layer given the CPU's selection: logits max err {logit_err:.3g}, boxes (normalised cxcywh) "
          f"max err {box_err:.3g}; {n_params / 1e6:.1f} M parameters")
    det_w = cpu.tile_forward_nchw(tiles, 0.5)
    det_g = card.tile_forward_nchw(tiles.cuda(), 0.5)
    check(tuple(det_g.boxes.shape) == (2, 300, 4) and not bool(det_g.kpts.any()) and
          abs(int(det_g.valid.sum()) - int(det_w.valid.sum())) <= 6,
          f"tile_forward: {int(det_g.valid.sum())} valid on the card, {int(det_w.valid.sum())} on the CPU")
    del card, cpu

    print("launch counts set to 0; the bfloat16 main path starts")
    launches = _reset_launches()
    model = RtDetrDetectionModel(**kw)
    check(model.device.type == "cuda" and model.model.enc_score.weight.dtype == torch.bfloat16 and
          model.model.enc_norm.weight.dtype == torch.float32, "default RtDetrDetectionModel is not bfloat16 on the card")
    images = [_photo(521 + i) for i in range(12)]
    torch.cuda.reset_peak_memory_stats()
    times, found = _serve(model, images, SLICED_KW, "RT-DETR bfloat16")
    peak = torch.cuda.max_memory_allocated() / 1e9
    ms = statistics.median(times)
    print(f"RT-DETR get_sliced_prediction bfloat16, 1024x1536, 6+1 tiles of 640 (7 x 8400 encoder tokens, 7 x 300 "
          f"queries): median {ms:.3f} ms/image over {len(times)} images (min {min(times):.3f}, max {max(times):.3f}); "
          f"peak memory {peak:.2f} GB; detections per image {found} (random weights: the count says nothing)")
    check(launches["gather_chw"] == len(images), f"{launches['gather_chw']} CHW gathers for {len(images)} images")
    _profile(torch, lambda: get_sliced_prediction(images[0], model, **SLICED_KW), ms, label="RT-DETR bfloat16")
    # where the wall time goes: the detector alone on the 8-tile batch
    batch = torch.rand(8, 3, SLICE, SLICE, device="cuda").to(torch.bfloat16)
    walls = []
    for i in range(7):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.tile_forward_nchw(batch, 0.5)
        torch.cuda.synchronize()
        if i >= 2:
            walls.append((time.perf_counter() - t0) * 1e3)
    n_fwd = _kernel_launches(torch, lambda: model.tile_forward_nchw(batch, 0.5))
    print(f"tile_forward_nchw alone on 8 tiles of 640: median {statistics.median(walls):.3f} ms wall "
          f"(min {min(walls):.3f}, max {max(walls):.3f}), {n_fwd} kernel launches")
    # the 8,400-token selection alone, at the main path's shape: a stable
    # descending sort of [8, 8400] float32 scores cut to 300, and the two takes
    score = torch.randn(8, 8400, device="cuda")
    tokens = torch.randn(8, 8400, 256, device="cuda")
    boxes = torch.rand(8, 8400, 4, device="cuda")

    def select():
        idx = torch.sort(score, dim=1, descending=True, stable=True).indices[:, :300]
        return (torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4)),
                torch.gather(tokens, 1, idx[..., None].expand(-1, -1, 256)))

    print(f"query selection alone (stable sort of 8x8400 scores, cut to 300, two takes): "
          f"{event_ms(torch, select):.4f} ms per tile batch")
    from facedet_tpu_torch.ops.kernels import bn_act

    # the preset's convs are its own Conv-BatchNorm-ReLU blocks; the published
    # RT-DETR-l's are ConvBnAct, whose epilogue is the kernel
    published = published_rtdetr(torch)
    bn_act.LAUNCHES["bn_act"] = 0
    for im in images[:2]:
        det = get_sliced_prediction(im, published, **SLICED_KW).detections.to_numpy()
        check(np.isfinite(det["boxes"]).all(), "the published RT-DETR-l gave non-finite boxes")
    counts = {"gather_chw": launches["gather_chw"], "bn_act@rtdetr-l": bn_act.LAUNCHES["bn_act"]}
    check(counts["bn_act@rtdetr-l"] > 0, "the published RT-DETR-l's main path did not launch bn_act")
    print(f"launches on the RT-DETR main path: {counts} (bn_act: the published RT-DETR-l on two photos, eager "
          f"forwards and graph captures)")
    return counts


def onnx_phase(torch, scrfd_pair, models):
    phase("18 ONNX routes (float32, TF32 off): exported graphs against the native routes, on the card")
    from facedet_tpu_torch import get_sliced_prediction
    from facedet_tpu_torch.engine.onnx_wrapper import OnnxDetectionModel
    from facedet_tpu_torch.engine.scrfd_wrapper import ScrfdDetectionModel
    from facedet_tpu_torch.models import onnx_export
    from facedet_tpu_torch.ops.kernels import tile_gather as tg

    images = [_photo(530 + i) for i in range(5)]

    def timed(model, label):
        times, found = _serve(model, images, SLICED_KW, label)
        n = _kernel_launches(torch, lambda: get_sliced_prediction(images[0], model, **SLICED_KW))
        ms = statistics.median(times)
        print(f"{label}: median {ms:.2f} ms/image over {len(times)} images (min {min(times):.2f}, "
              f"max {max(times):.2f}), {n} kernel launches per image")
        return ms

    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as tmp:
        t0 = time.perf_counter()
        paths = {k: os.path.join(tmp, f"{k}.onnx") for k in ("scrfd_b1", "yolo11n_b1")}
        onnx_export.export_scrfd_onnx(scrfd_pair["cpu"].model, SLICE, paths["scrfd_b1"])
        onnx_export.export_yolo_onnx(models["cpu"].model, SLICE, paths["yolo11n_b1"])
        for k, path in paths.items():
            check(os.path.exists(path) and os.path.getsize(path) > 1_000_000, f"the exported graph {k} is missing")
        print(f"exported {[(k, round(os.path.getsize(v) / 1e6, 2)) for k, v in paths.items()]} (MB) from the port's "
              f"own modules in {time.perf_counter() - t0:.1f} s")
        kw = dict(variant="scrfd_2.5g", dtype="float32", image_size=SLICE, confidence_threshold=0.3)
        scrfd_onnx = ScrfdDetectionModel(model_path=paths["scrfd_b1"], **kw)
        yolo_onnx = OnnxDetectionModel(model_path=paths["yolo11n_b1"], num_keypoints=5, image_size=SLICE,
                                       confidence_threshold=models["cuda"].confidence_threshold)
    check(all(v.is_cuda for m in (scrfd_onnx, yolo_onnx) for v in m.variables["params"].values()),
          "an imported graph's weights are not on the card")
    before = tg.LAUNCHES["gather_chw"]
    want = get_sliced_prediction(images[0], scrfd_pair["cuda"], **SLICED_KW).detections.to_numpy()
    check(len(want["boxes"]) > 0, "the native SCRFD route found nothing")
    got = get_sliced_prediction(images[0], scrfd_onnx, **SLICED_KW).detections.to_numpy()
    _compare(got, want, "SCRFD .onnx (insightface layout)", ".onnx route vs .npz route")
    want = get_sliced_prediction(images[0], models["cuda"], **SLICED_KW).detections.to_numpy()
    got = get_sliced_prediction(images[0], yolo_onnx, **SLICED_KW).detections.to_numpy()
    check(len(want["boxes"]) > 0, "the native yolo11n route found nothing")
    _compare(got, want, "yolo11n .onnx (ultralytics head)", ".onnx route vs YoloV11PoseDetectionModel")
    check(tg.LAUNCHES["gather_chw"] == before + 4, "an ONNX route did not go through the CHW gather")
    timed(scrfd_pair["cuda"], "SCRFD native float32")
    timed(scrfd_onnx, "SCRFD .onnx, batch 1, a loop over tiles")
    timed(models["cuda"], "yolo11n native float32")
    timed(yolo_onnx, "yolo11n .onnx, batch 1, a loop over tiles")


EVAL_IMAGES = 8
TOPIQ_BATCH = 64
NIQE_ASSET = os.path.join(REPO, "facedet_tpu", "eval", "assets", "niqe_pristine.npz")
BRISQUE_ASSET = os.path.join(REPO, "facedet_tpu", "eval", "assets", "brisque_svr.npz")


def widerface_layout(root):
    """A seeded synthetic WIDERFACE layout: EVAL_IMAGES photo-like
    1024x1536 images of 12 faces each as ``images/<event>/<name>.jpg``, and
    ``gt.txt`` (x y w h and the six attribute columns; every third face is
    marked blurred, so both of the dual evaluator's degradation classes
    hold faces). ``gt2.txt`` holds the first two images; ``tuning`` is the
    tuner's dataset of the same two."""
    from facedet_tpu_torch.utils.synth import natural_background, synthetic_faces_with_boxes
    from facedet_tpu_torch.utils.viz import save_image

    blocks, tuning = [], []
    for k in range(EVAL_IMAGES):
        event, name = f"{k // 4}--Synthetic", f"{k // 4}_Synthetic_{k}"
        img, boxes = synthetic_faces_with_boxes(*CANVAS, seed=700 + k, n=12,
                                                background=natural_background(*CANVAS, seed=700 + k))
        path = os.path.join(root, "images", event, f"{name}.jpg")
        save_image(path, img, quality=95)
        xywh = [(x1, y1, x2 - x1, y2 - y1) for x1, y1, x2, y2 in boxes]
        blocks.append([f"{event}/{name}.jpg", str(len(xywh))] +
                      [f"{x:.2f} {y:.2f} {w:.2f} {h:.2f} {int(j % 3 == 0)} 0 0 0 0 0" for j, (x, y, w, h) in enumerate(xywh)])
        tuning.append({"file_name": path, "image_id": k, "gt": [[round(v, 2) for v in b] for b in xywh]})
    ev = {"root": root, "images": os.path.join(root, "images"), "gt": os.path.join(root, "gt.txt"),
          "gt2": os.path.join(root, "gt2.txt"), "tuning": tuning[:2]}
    for key, n in (("gt", EVAL_IMAGES), ("gt2", 2)):
        with open(ev[key], "w") as f:
            f.write("\n".join(line for block in blocks[:n] for line in block) + "\n")
    return ev


def topiq_flops(torch, model, h, w) -> tuple[float, float]:
    """FLOPs (two per multiply-add) of one h x w image through CFANet, in
    all and in the ResNet50 trunk, counted from the shapes one forward sees:
    every conv and linear, the attention projections and its two products."""
    from facedet_tpu_torch.models.topiq import MultiheadAttention

    flops = {"all": 0.0, "trunk": 0.0}
    trunk = {id(m) for m in model.backbone.modules()}

    def add(m, n):
        flops["all"] += n
        if id(m) in trunk:
            flops["trunk"] += n

    def conv(m, inp, out):
        add(m, 2.0 * out[0].numel() * m.in_channels // m.groups * m.kernel_size[0] * m.kernel_size[1])

    def linear(m, inp, out):
        add(m, 2.0 * out[0].numel() * m.in_features)

    def attention(m, inp, out):
        (_, nq, d), nk = inp[0].shape, inp[1].shape[1]
        add(m, 2.0 * d * d * (nq + 2 * nk) + 2 * 2.0 * nq * nk * d)  # q, k, v; q k^T and a v

    kinds = {torch.nn.Conv2d: conv, torch.nn.Linear: linear, MultiheadAttention: attention}
    hooks = [m.register_forward_hook(kinds[type(m)]) for m in model.modules() if type(m) in kinds]
    try:
        with torch.inference_mode():
            model.forward_nchw(torch.zeros(1, 3, h, w, device=next(model.parameters()).device))
    finally:
        for hk in hooks:
            hk.remove()
    return flops["all"], flops["trunk"]


def topiq_phase(torch):
    phase("20 TOPIQ CFANet at full width, seeded: float32 card against CPU, a batch of 64 in float32 and bfloat16")
    import dataclasses

    import numpy as np

    from facedet_tpu_torch.engine.detector import _exact_float32
    from facedet_tpu_torch.models.topiq import TopiqConfig, create_topiq, topiq_score

    cfg = TopiqConfig()
    check((cfg.embed_dim, cfg.num_heads, cfg.stage_channels, cfg.stage_depths) ==
          (256, 4, (256, 512, 1024, 2048), (3, 4, 6, 3)), f"TopiqConfig() is {cfg}")
    seed = lambda: torch.Generator().manual_seed(13)  # noqa: E731 - one seed, drawn on the host
    cpu = create_topiq(cfg, seed(), device="cpu")
    card = create_topiq(cfg, seed(), device="cuda")
    n_params = sum(p.numel() for p in card.parameters())
    photos = [_photo(600 + i) for i in range(4)]
    crops = [photos[i][100 + 50 * i : 324 + 50 * i, 200 + 90 * i : 424 + 90 * i] for i in range(3)]
    crops.append(photos[3][400:500, 700:800])  # 100x100: the scales pool to 16, 16, 49 and 16 tokens
    t0 = time.perf_counter()
    want = np.array([topiq_score(cpu, c) for c in crops])
    cpu_s = time.perf_counter() - t0
    got = np.array([topiq_score(card, c) for c in crops])
    err = float(np.abs(got - want).max())
    check(np.isfinite(got).all() and err <= 1e-4, f"TOPIQ float32 card vs CPU: {got} against {want}")
    print(f"TOPIQ float32 (TF32 off), {n_params / 1e6:.2f} M parameters: scores {np.round(got, 6).tolist()} on "
          f"3 crops of 224x224 and one of 100x100; card vs CPU max err {err:.3g}; CPU {cpu_s:.1f} s")

    batch = np.stack([p[y : y + 224, x : x + 224] for p in photos for y in range(0, 800, 200)
                      for x in range(0, 1300, 330)][:TOPIQ_BATCH])
    x = torch.from_numpy(batch).cuda().permute(0, 3, 1, 2).float().div(255.0).contiguous()
    flops, trunk_flops = topiq_flops(torch, card, 224, 224)
    print(f"FLOPs per 224x224 image: {flops / 1e9:.3f} G in all, {trunk_flops / 1e9:.3f} G in the ResNet50 trunk's convs")
    scores = {}
    for dtype, model in (("float32", card),
                         ("bfloat16", create_topiq(dataclasses.replace(cfg, dtype="bfloat16"), seed(), device="cuda"))):
        def run(model=model, dtype=dtype):
            with torch.inference_mode(), _exact_float32(dtype == "float32"):
                return model.forward_nchw(x)

        for _ in range(3):
            run()
        torch.cuda.synchronize()
        walls = []
        for _ in range(10):
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        ms = statistics.median(walls)
        torch.cuda.reset_peak_memory_stats()
        scores[dtype] = run().float().cpu().numpy()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 1e9
        rate = flops * TOPIQ_BATCH / ms / 1e9
        print(f"TOPIQ {dtype}, batch {TOPIQ_BATCH} at 224x224: median {ms:.3f} ms per batch over 10 (min {min(walls):.3f}, "
              f"max {max(walls):.3f}), {TOPIQ_BATCH / ms * 1e3:.1f} images/s, {rate:.1f} TFLOP/s "
              f"({100 * rate / (BF16_FLOPS_PER_S / 1e12):.1f}% of the 989 TFLOP/s bfloat16 peak), peak memory {peak:.3f} GB")
        _profile(torch, run, ms / TOPIQ_BATCH, n=3, images=TOPIQ_BATCH, label=f"TOPIQ {dtype}")
    check(all(np.isfinite(s).all() and s.shape == (TOPIQ_BATCH,) for s in scores.values()), "TOPIQ batch scores")
    delta = float(np.abs(scores["bfloat16"] - scores["float32"]).max())
    check(delta <= 0.1, f"TOPIQ bfloat16 against float32: |dscore| up to {delta}")
    print(f"TOPIQ bfloat16 against float32 on the batch: largest |dscore| {delta:.4g} (scores {scores['float32'].min():.4f} "
          f"to {scores['float32'].max():.4f})")


def _xyxy(a):
    import numpy as np

    return np.concatenate([a[:, :2], a[:, :2] + a[:, 2:4]], 1)


def official_eval_phase(torch, models, served, ev, cli_results):
    """Returns the evaluation detector (the CLI's) and the gather launches of
    the six modes."""
    phase("21 official WIDERFACE evaluator: card against CPU, then six modes with yolo11n (launch counts from 0)")
    import numpy as np

    from facedet_tpu_torch.apps.common import build_detector
    from facedet_tpu_torch.eval.widerface_official import OfficialWiderFaceEvaluator
    from facedet_tpu_torch.utils.config import DetectorConfig
    from facedet_tpu_torch.utils.viz import load_image

    # float32, TF32 off: the SAHI-uniform mode on two images, card against CPU
    runs = {}
    for side in ("cpu", "cuda"):
        e = OfficialWiderFaceEvaluator(models[side], images_path=ev["images"], gt_txt=ev["gt2"],
                                       inference_confidence=0.01)
        preds = e.run_inference_on_all_images()
        runs[side] = (preds, e.run(preds, save=False)["aps"]["all"])
    n = box_err = score_err = 0.0
    for event, images in runs["cpu"][0].items():
        for name, want in images.items():
            got = runs["cuda"][0][event][name]
            check(got.shape == want.shape, f"{event}/{name}: {len(got)} predictions on the card, {len(want)} on the CPU")
            n += len(got)
            if len(got):
                box_err = max(box_err, float(np.abs(_xyxy(got) - _xyxy(want)).max()))
                score_err = max(score_err, float(np.abs(got[:, 4] - want[:, 4]).max()))
    ap_err = abs(runs["cuda"][1] - runs["cpu"][1])
    check(n > 0 and box_err <= BOX_ATOL and score_err <= SCORE_ATOL and ap_err <= 0.005,
          f"evaluator card vs CPU: boxes {box_err}, scores {score_err}, AP {runs['cuda'][1]} against {runs['cpu'][1]}")
    print(f"SAHI uniform, float32, 2 images: {int(n)} predictions on each side, card vs CPU max errors boxes "
          f"{box_err:.3g} px, scores {score_err:.3g}; AP {runs['cuda'][1]:.6f} against {runs['cpu'][1]:.6f}")

    launches = _reset_launches()
    det = build_detector(DetectorConfig(family="yolov11", scale="n", model_path=CKPT, confidence_threshold=0.01,
                                        image_size=1024), device="cuda")  # what the eval CLIs build
    enh = served["RealESRGAN_x2plus"]
    modes = {
        "BASELINE": dict(use_sahi=False),
        "SAHI uniform 640/0.2": dict(),
        "SAHI adaptive": dict(slicing_strategy="adaptive"),
        "SAHI uniform, dct420s ingest": dict(ingest="dct420s"),
        "FULL-ENHANCE x2 -> SAHI": dict(enhancer=enh),
        "BOUNDED-ENHANCE x2 -> SAHI": dict(enhancer=enh, bounded_enhancement=True),
    }
    enhanced = []
    real_enhance = enh.enhance_array
    enh.enhance_array = lambda *a, **k: (enhanced.append(1), real_enhance(*a, **k))[1]
    warm = load_image(ev["tuning"][0]["file_name"])
    results = {}
    try:
        for label, kw in modes.items():
            e = OfficialWiderFaceEvaluator(det, images_path=ev["images"], gt_txt=ev["gt"], **kw)
            e.run_single_inference(warm)  # shapes and cuDNN plans, not timed
            del enhanced[:]
            r = e.run(save=False)
            check(e.timings["images"] == EVAL_IMAGES and 0.0 <= r["aps"]["all"] <= 1.0,
                  f"{label}: {e.timings['images']} images, AP {r['aps']['all']}")
            print(f"{label} [{r['mode']}]: AP {r['aps']['all']:.4f}, {r['images_per_second']:.2f} images/s "
                  f"over {EVAL_IMAGES} images; images enhanced {len(enhanced)}")
            results[label] = r
    finally:
        del enh.enhance_array
    check(results["SAHI uniform 640/0.2"]["aps"]["all"] > 0.05, "the SAHI-uniform mode matched no face")
    count = launches["gather_chw"]
    check(count > 0, "the evaluator's modes did not launch the CHW gather")
    cli = cli_results["eval_official"]
    want = results["SAHI uniform 640/0.2"]
    diff = abs(cli["aps"]["all"] - want["aps"]["all"])
    check(cli["mode"] == want["mode"] and diff <= 1e-6,
          f"eval_official CLI: AP {cli['aps']} ({cli['mode']}) against {want['aps']} in this process")
    print(f"eval_official CLI (phase 19, --device cuda): AP {cli['aps']['all']:.6f}, in this process "
          f"{want['aps']['all']:.6f}; launches of the CHW gather over the six modes: {count}")
    return det, count


def dual_tuning_phase(torch, det, ev, cli_results) -> int:
    """Returns the gather launches of the dual evaluator and the grid."""
    phase("22 dual evaluator and the SAHI tuning grid (launch counts from 0)")
    from facedet_tpu_torch.apps.eval_dual_cli import make_predict_fn
    from facedet_tpu_torch.eval.dual import DualWiderFaceEvaluator
    from facedet_tpu_torch.eval.subcategory import build_subcategory_gt
    from facedet_tpu_torch.eval.tuning import run_grid_search
    from facedet_tpu_torch.utils.viz import load_image

    launches = _reset_launches()
    built = build_subcategory_gt(ev["gt"])
    print(f"subcategory GT: {json.dumps(built['statistics']['per_category'])}")
    dual = DualWiderFaceEvaluator(make_predict_fn(det), built["data"], images_path=ev["images"])
    t0 = time.perf_counter()
    res = dual.run(save=False)
    rows = res["subcategory_results"] + res["difficulty_results"]
    check(len(rows) == 9 and len(dual.prediction_cache) == EVAL_IMAGES, f"{len(rows)} rows, {len(dual.prediction_cache)} images")
    for row in rows:
        print(f"{row['category']:>16}: AP {row['ap']:.4f}  P {row['precision']:.3f} R {row['recall']:.3f} "
              f"F1 {row['f1_score']:.3f} (gt {row['total_gt']}, pred {row['total_pred']})")
    print(f"dual evaluator: {EVAL_IMAGES} images inferred once for nine passes, {time.perf_counter() - t0:.2f} s")
    check(any(r["ap"] > 0 for r in rows), "the dual evaluator scored nothing")
    cli_rows = cli_results["eval_dual_cli"]["subcategory_results"] + cli_results["eval_dual_cli"]["difficulty_results"]
    diff = max(abs(a["ap"] - b["ap"]) for a, b in zip(rows, cli_rows))
    check([r["category"] for r in cli_rows] == [r["category"] for r in rows] and diff <= 1e-6,
          f"eval_dual_cli's APs differ from this process's by {diff}")
    print(f"eval_dual_cli (phase 19, --device cuda): the nine APs equal this process's (largest difference {diff:.3g})")

    # the tuner skips an image that raises (as the reference does): here none may
    grid = run_grid_search(det, ev["tuning"], load_image, grid_name="quick", save=False)
    errors = [r["errors"] for r in grid["results"]]
    check(grid["num_configs"] == 4 and errors == [0] * 4, f"tuning grid: errors {errors}")
    best = grid["best"]
    print(f"tuning grid 'quick' on 2 images: 4 configurations, errors {errors}; best slice {best['slice_size']} "
          f"overlap {best['overlap']} mAP {best['map']:.4f} mAP50 {best['map50']:.4f}, "
          f"{sum(r['seconds'] for r in grid['results']):.2f} s in all")
    count = launches["gather_chw"]
    check(count > 0, "the dual evaluator and the grid did not launch the CHW gather")
    return count


def iqa_phase(ev):
    phase("23 IQA: NIQE and BRISQUE on face crops, the committed artifacts, the native bbox_overlaps")
    import numpy as np

    from facedet_tpu_torch.eval import iqa
    from facedet_tpu_torch.eval.bbox_overlaps import bbox_overlaps, bbox_overlaps_numpy, native_library
    from facedet_tpu_torch.utils.native import BUILD_DIR
    from facedet_tpu_torch.utils.viz import load_image

    for path in (NIQE_ASSET, BRISQUE_ASSET):
        check(os.path.exists(path), f"missing {path}: the IQA metrics would fall back to a self-fit")
    with np.load(NIQE_ASSET) as f:
        mu, cov = iqa._default_model()
        check(np.array_equal(mu, f["mu"]) and np.array_equal(cov, f["cov"]), "NIQE did not load niqe_pristine.npz")
    with np.load(BRISQUE_ASSET) as f:
        svr = iqa._brisque_svr()
        check(svr is not None and np.array_equal(svr["alpha"], f["alpha"]), "BRISQUE did not load brisque_svr.npz")
    item = ev["tuning"][0]
    img = load_image(item["file_name"])
    t0 = time.perf_counter()
    for k, (x, y, w, h) in enumerate(item["gt"][:4]):
        crop = img[int(y) : int(y + h), int(x) : int(x + w)]
        s_niqe, s_brisque = iqa.niqe(crop), iqa.brisque(crop)
        check(np.isfinite(s_niqe) and np.isfinite(s_brisque), f"crop {k}: NIQE {s_niqe}, BRISQUE {s_brisque}")
        print(f"face crop {k} {crop.shape[1]}x{crop.shape[0]}: NIQE {s_niqe:.4f}, BRISQUE {s_brisque:.4f}, "
              f"TOPIQ proxy {iqa.topiq_face(crop):.4f}")
    print(f"IQA of 4 crops on the host: {time.perf_counter() - t0:.2f} s")

    lib = native_library()
    check(lib is not None and (BUILD_DIR / "libbbox_overlaps.so").exists(), "native/bbox_overlaps.cpp did not build")
    rng = np.random.default_rng(0)
    a = rng.uniform(0, 500, (300, 2))
    a = np.concatenate([a, a + rng.uniform(-5, 120, (300, 2))], 1)
    b = rng.uniform(0, 500, (40, 2))
    b = np.concatenate([b, b + rng.uniform(1, 120, (40, 2))], 1)
    err = float(np.abs(bbox_overlaps(a, b) - bbox_overlaps_numpy(a, b)).max())
    check(err <= 1e-12, f"native bbox_overlaps differs from numpy by {err}")
    print(f"native bbox_overlaps built into {BUILD_DIR}; 300x40 IoU matrix equal to numpy's within {err:.3g}")


TRAIN_SIZE, TRAIN_BATCH, TRAIN_FACES = 640, 8, 12  # the golden fine-tune's configuration
FIDELITY_SIZE, FIDELITY_BATCH = 320, 2
TRAIN_STEPS, TRAIN_WARMUP, STAGED_STEPS = 20, 3, 20
F32_FLOPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores, NVIDIA data sheet


def _train_batch(torch, size, b, seed, n=TRAIN_FACES):
    """(images [b, size, size, 3] float in [0, 1], boxes [b, n, 4], mask,
    kpts [b, n, 5, 3]) of seeded photo-like images; each face's five
    landmarks (eyes, nose, mouth corners) where synth draws them, inside its
    box."""
    import numpy as np

    from facedet_tpu_torch.utils.synth import natural_background, synthetic_faces_with_boxes

    lo, hi = max(24, size // 16), max(40, size // 5)
    images, boxes = zip(*(synthetic_faces_with_boxes(size, size, seed=seed + i, n=n, size=(lo, hi),
                                                     background=natural_background(size, size, seed=seed + i))
                          for i in range(b)))
    boxes = np.stack(boxes).astype(np.float32)
    s = (boxes[..., 2] - boxes[..., 0]) / 0.9
    cx, cy = (boxes[..., 0] + boxes[..., 2]) / 2, boxes[..., 1] + 0.75 * s
    offsets = np.array([[-0.17, -0.08], [0.17, -0.08], [0.0, 0.05], [-0.12, 0.26], [0.12, 0.26]], np.float32)
    kpts = np.ones(boxes.shape[:2] + (5, 3), np.float32)
    kpts[..., 0] = cx[..., None] + offsets[:, 0] * s[..., None]
    kpts[..., 1] = cy[..., None] + offsets[:, 1] * s[..., None]
    images = np.stack(images).astype(np.float32) / 255.0
    return [torch.from_numpy(a) for a in (images, boxes, np.ones(boxes.shape[:2], bool), kpts)]


def _golden_trainee(torch, family, device, dtype="float32"):
    """The golden yolo11n-pose or scrfd_2.5g as a trainer builds it: float32
    parameters; yolo11n-pose's config may compute in bfloat16."""
    import dataclasses

    from facedet_tpu_torch.models.from_jax import load_jax_variables, load_params_npz
    from facedet_tpu_torch.models.scrfd import SCRFD_VARIANTS, Scrfd
    from facedet_tpu_torch.models.yolov11 import YoloConfig, YoloV11

    if family == "yolo11n":
        model, path = YoloV11(YoloConfig(scale="n", dtype=dtype)), CKPT
    else:
        model, path = Scrfd(dataclasses.replace(SCRFD_VARIANTS["scrfd_2.5g"], dtype="float32")), SCRFD_CKPT
    load_jax_variables(model, load_params_npz(path))
    return model.to(device)


def _train_errors(runs):
    """Card against CPU of one training step, ``runs[device] = (loss parts,
    gradients, statistics)``: the parts' largest relative error, the
    gradients' largest error over each leaf's largest |g| (at least 1e-3 of
    the largest over all leaves), the statistics' largest error relative to
    max(|value|, 1), and the leaf of the largest gradient error."""
    (want_parts, want_g, want_s), (parts, grads, stats) = runs["cpu"], runs["cuda"]
    check(set(grads) == set(want_g) and set(stats) == set(want_s), "card and CPU differ in their leaves")
    part_err = max(abs(parts[k] - v) / max(abs(v), 1e-12) for k, v in want_parts.items())
    top = max(float(g.abs().max()) for g in want_g.values())
    grad_err, worst = max((float((grads[n] - g).abs().max()) / max(float(g.abs().max()), 1e-3 * top), n)
                          for n, g in want_g.items())
    stat_err = max(float(((stats[n] - s).abs() / s.abs().clamp(min=1.0)).max()) for n, s in want_s.items())
    return part_err, grad_err, stat_err, worst


def train_fidelity_phase(torch):
    phase(f"24 training fidelity (float32, TF32 off): one step of yolo11n and scrfd_2.5g, golden weights, "
          f"{FIDELITY_SIZE}x{FIDELITY_SIZE}, batch {FIDELITY_BATCH}, card against CPU")
    import numpy as np

    from facedet_tpu_torch.engine.detector import _exact_float32
    from facedet_tpu_torch.train.scrfd_train import scrfd_loss
    from facedet_tpu_torch.train.yolo_train import compute_loss

    batch = _train_batch(torch, FIDELITY_SIZE, FIDELITY_BATCH, seed=700)
    for family, loss in (("yolo11n", None), ("scrfd_2.5g", scrfd_loss)):
        runs = {}
        for dev in ("cpu", "cuda"):
            model = _golden_trainee(torch, family, dev)
            with _exact_float32(True):
                total, parts = compute_loss(model, *(x.to(dev) for x in batch), loss=loss)
                total.backward()
            runs[dev] = ({k: float(v.detach()) for k, v in parts.items()},
                         {n: p.grad.cpu() for n, p in model.named_parameters()},
                         {n: b.cpu() for n, b in model.named_buffers() if "running" in n})
        (want_parts, want_g, want_s), (parts, grads, stats) = runs["cpu"], runs["cuda"]
        part_err, grad_err, stat_err, _ = _train_errors(runs)
        print(f"{family} train step {FIDELITY_SIZE}x{FIDELITY_SIZE} batch {FIDELITY_BATCH}: loss parts "
              f"{ {k: round(v, 6) for k, v in want_parts.items()} }; card vs CPU: parts {part_err:.3g} relative, "
              f"gradients {grad_err:.3g} of each leaf's largest ({len(want_g)} leaves), running statistics "
              f"{stat_err:.3g} ({len(want_s)} buffers)")
        check(all(np.isfinite(v) for v in parts.values()), f"{family}: loss parts {parts}")
        check(part_err <= 1e-4, f"{family}: loss parts card vs CPU {part_err} relative")
        check(grad_err <= 1e-3, f"{family}: gradients card vs CPU {grad_err} of a leaf's largest")
        check(stat_err <= 1e-5, f"{family}: BatchNorm running statistics card vs CPU {stat_err}")


def train_flops(torch, model, images) -> float:
    """FLOPs (two per multiply-add) of one eval-mode forward of ``images``
    through the convs and the PSA attention products, counted from the
    shapes."""
    return shape_flops(torch, model, lambda: model.eval()(images))


def _time_steps(torch, run, n=TRAIN_STEPS, warmup=TRAIN_WARMUP):
    """Wall ms of each of ``n`` calls of ``run`` (synchronised), after
    ``warmup`` calls."""
    for _ in range(warmup):
        run()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def train_main_path_phase(torch):
    """The timings run before the profile window: a profiled process may
    launch more slowly afterwards."""
    phase(f"25 training main path: yolo11n-pose {TRAIN_SIZE}x{TRAIN_SIZE}, batch {TRAIN_BATCH}, float32, "
          f"AdamW (make_optimizer), golden weights")
    import numpy as np

    from facedet_tpu_torch.engine.detector import _exact_float32
    from facedet_tpu_torch.train.scrfd_train import make_scrfd_train_step
    from facedet_tpu_torch.train.yolo_train import make_optimizer, make_staged_train_loop, make_train_step

    batch = [x.cuda() for x in _train_batch(torch, TRAIN_SIZE, TRAIN_BATCH, seed=710)]
    model = _golden_trainee(torch, "yolo11n", "cuda")
    flops = 3 * train_flops(torch, model, batch[0])
    tx = make_optimizer(model.parameters(), lr=1e-4)
    step = make_train_step(model, tx)
    losses = []
    run = lambda: losses.append(step(*batch)[0])  # noqa: E731
    images_u8 = torch.stack([(batch[0] * 255).round().to(torch.uint8)] * 2)
    staged = [images_u8] + [torch.stack([x] * 2) for x in batch[1:]]
    with _exact_float32(True):
        torch.cuda.reset_peak_memory_stats()
        times = _time_steps(torch, run)
        peak = torch.cuda.max_memory_allocated() / 1e9
        make_staged_train_loop(model, tx, steps_per_dispatch=2, flip=True)(*staged)  # warm-up of the flip path
        loop = make_staged_train_loop(model, tx, steps_per_dispatch=STAGED_STEPS, flip=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mean = float(loop(*staged, start=1))
        staged_ms = (time.perf_counter() - t0) * 1e3 / STAGED_STEPS
    with _tf32(torch):
        tf32_times = _time_steps(torch, run)
    scrfd = _golden_trainee(torch, "scrfd_2.5g", "cuda")
    sstep = make_scrfd_train_step(scrfd, make_optimizer(scrfd.parameters(), lr=1e-4))
    ms = statistics.median(times)
    with _exact_float32(True):
        scrfd_times = _time_steps(torch, lambda: sstep(*batch))
        _step_profile(torch, run, ms, "yolo11n-pose", n=3, top=6)
        after = _time_steps(torch, run, n=10, warmup=0)
    losses = [float(x) for x in losses]
    check(all(np.isfinite(losses)) and np.isfinite(mean), f"training losses {losses}, staged {mean}")
    rate = flops / ms / 1e9
    print(f"make_train_step, yolo11n-pose {TRAIN_SIZE}x{TRAIN_SIZE} batch {TRAIN_BATCH} float32 (TF32 off): median "
          f"{ms:.3f} ms/step over {len(times)} (min {min(times):.3f}, max {max(times):.3f}), "
          f"{TRAIN_BATCH / ms * 1e3:.2f} images/s, peak memory {peak:.3f} GB, "
          f"{flops / 1e12:.4f} TFLOP per step (forward convs and attention x3) = {rate:.2f} TFLOP/s "
          f"({100 * rate / (F32_FLOPS_PER_S / 1e12):.1f}% of the 67 TFLOP/s float32 peak); loss {losses[0]:.4f} "
          f"-> {losses[-1]:.4f} over {len(losses)} steps")
    print(f"make_staged_train_loop, flip=True, {STAGED_STEPS} steps per dispatch (TF32 off): {staged_ms:.3f} ms/step, "
          f"mean loss {mean:.4f}")
    print(f"make_train_step with TF32 on (convs and matmuls): median {statistics.median(tf32_times):.3f} ms/step "
          f"(min {min(tf32_times):.3f}, max {max(tf32_times):.3f})")
    print(f"make_scrfd_train_step, scrfd_2.5g {TRAIN_SIZE}x{TRAIN_SIZE} batch {TRAIN_BATCH} float32 (TF32 off): median "
          f"{statistics.median(scrfd_times):.3f} ms/step (min {min(scrfd_times):.3f}, max {max(scrfd_times):.3f})")
    print(f"the yolo11n-pose step after the profile window: median {statistics.median(after):.3f} ms over "
          f"{len(after)} (min {min(after):.3f}, max {max(after):.3f})")


def learning_phase(torch, root):
    phase("26 learning proof and export: selftrain_demo --model yolo --steps 300 (96x96, batch 16), then "
          "YoloTrainer for 2 epochs and its last.npz through YoloV11PoseDetectionModel")
    import fnmatch

    import numpy as np
    from PIL import Image

    from facedet_tpu_torch import YoloV11PoseDetectionModel, get_sliced_prediction
    from facedet_tpu_torch.models.from_jax import load_params_npz
    from facedet_tpu_torch.models.yolov11 import YoloConfig
    from facedet_tpu_torch.tools import selftrain_demo
    from facedet_tpu_torch.train.yolo_trainer import YoloDataset, YoloTrainer
    from facedet_tpu_torch.utils.synth import synthetic_faces_with_boxes

    patterns = [ln.strip() for ln in open(os.path.join(REPO, ".chiprunignore")) if ln.strip()]
    for path in (CKPT, SCRFD_CKPT):
        rel = os.path.relpath(path, REPO)
        check(not any(fnmatch.fnmatch(rel, p) or rel.startswith(p.rstrip("/") + "/") for p in patterns),
              f".chiprunignore leaves {rel} out of the copy sent to the card")

    t0 = time.perf_counter()
    out = selftrain_demo.main(["--model", "yolo", "--steps", "300"])
    secs = time.perf_counter() - t0
    before, after = out["before"]["map50"], out["after"]["map50"]
    print(f"selftrain_demo yolo11n-pose, 300 steps of batch 16 at 96x96 from a seeded init: mAP50 {before:.4f} -> "
          f"{after:.4f} (mAP {out['after']['map']:.4f}) in {secs:.1f} s with both validations")
    check(after >= 0.5 and after > before, f"the demo did not learn: mAP50 {before} -> {after}")

    images, labels = os.path.join(root, "train", "images"), os.path.join(root, "train", "labels")
    os.makedirs(images)
    os.makedirs(labels)
    for i in range(8):
        img, boxes = synthetic_faces_with_boxes(320, 320, seed=720 + i, n=4, size=(40, 90))
        Image.fromarray(img).save(os.path.join(images, f"{i}.png"))
        with open(os.path.join(labels, f"{i}.txt"), "w") as f:
            f.writelines(f"0 {(b[0] + b[2]) / 640:.6f} {(b[1] + b[3]) / 640:.6f} {(b[2] - b[0]) / 320:.6f} "
                         f"{(b[3] - b[1]) / 320:.6f}\n" for b in boxes)
    run_dir = os.path.join(root, "run")
    trainer = YoloTrainer(YoloConfig(scale="n"), lr=1e-4, output_dir=run_dir, save_period=1, image_size=320,
                          variables=load_params_npz(CKPT))
    check(trainer.device.type == "cuda", f"YoloTrainer chose {trainer.device}")
    ds = YoloDataset(images, labels, image_size=320, max_boxes=16, augment=True, seed=0)
    t0 = time.perf_counter()
    result = trainer.fit(lambda epoch: ds.batches(4), num_epochs=2, verbose=False)
    fit_s = time.perf_counter() - t0
    check(result["epochs"] == 2 and sorted(os.listdir(run_dir)) ==
          ["best.npz", "config.json", "epoch1.npz", "epoch2.npz", "last.npz", "results.csv"],
          f"YoloTrainer.fit wrote {sorted(os.listdir(run_dir))}")
    image = _photo(730)
    kw = dict(scale="n", dtype="float32", image_size=320, confidence_threshold=0.25)
    from_file = YoloV11PoseDetectionModel(model_path=os.path.join(run_dir, "last.npz"), device="cuda", **kw)
    want = get_sliced_prediction(image, trainer.as_detection_model(), **SLICED_KW).detections.to_numpy()
    got = get_sliced_prediction(image, from_file, **SLICED_KW).detections.to_numpy()
    check(len(want["boxes"]) > 0, "the fine-tuned model found nothing on the synthetic photo")
    _compare(got, want, "last.npz against the trained model in memory", "file vs memory")
    print(f"YoloTrainer: 2 epochs of 2 batches of 4 at 320x320 (augment, mosaic) in {fit_s:.1f} s, losses "
          f"{[round(h['train_loss'], 4) for h in trainer.history]}")


DETR_GROUPS = 5  # CDN groups, selftrain_demo's default
# phase 27 holds rtdetr-tiny: the seeded rtdetr-l is chaotic in float32 (one ulp of input moves
# its gradients by a fifth of a leaf's largest), rtdetr-tiny at 256x256 is not
DETR_FIDELITY, DETR_FIDELITY_SIZE = "rtdetr-tiny", 256
# fixed gates (parts relative, gradients of each leaf's largest / error norm over norm,
# statistics), set between the float32 card's readings and the TF32 control's (PERF.md)
DETR_GATES = (1e-4, 1e-3, 1e-5)
GAN_GATES = (1e-4, 1e-3, 1e-5)
DETR_STEPS, DETR_STAGED, SR_STEPS = 10, 4, 10
DETR_DEMO_STEPS = 300
SR_HR, SR_BATCH = 128, 16  # tools/sr_golden_train.py's defaults


def _detr_batch(torch, size, b, seed):
    """``_train_batch``'s images with their boxes as normalised cxcywh."""
    from facedet_tpu_torch.train.rtdetr_train import xyxy_to_cxcywh

    images, boxes, mask, _ = _train_batch(torch, size, b, seed)
    return images, xyxy_to_cxcywh(boxes, float(size)), mask


def _cdn_noise(torch, b, m, seed):
    """Seeded CDN noise (``part`` uniform in [0, 1), ``sign`` +-1), the
    inputs that JAX draws from its key."""
    gen = torch.Generator().manual_seed(seed)
    shape = (b, DETR_GROUPS, 2, m, 4)
    return torch.rand(shape, generator=gen), (torch.randint(0, 2, shape, generator=gen) * 2 - 1).float()


def _sr_patches(torch, n, hr, seed):
    """(lr_u8, hr_u8) of ``n`` patches from seeded photos through the host
    degradation model (train/sr_train.build_sr_dataset), x2."""
    from facedet_tpu_torch.train.sr_train import build_sr_dataset

    photos = [_photo(seed + i, hw=(512, 768), n=12, size=(60, 160)) for i in range(2)]
    lr, hr_ = build_sr_dataset(photos, n, hr, 2, seed=seed)
    return torch.from_numpy(lr), torch.from_numpy(hr_)


def _golden_x2(torch, device):
    from facedet_tpu_torch.engine.enhancer import _golden_ckpt_path
    from facedet_tpu_torch.models.from_jax import load_rrdb_npz
    from facedet_tpu_torch.models.rrdbnet import MODEL_CATALOG, RRDBNet

    g = RRDBNet(MODEL_CATALOG["RealESRGAN_x2plus"])
    load_rrdb_npz(g, _golden_ckpt_path("RealESRGAN_x2plus"))
    return g.to(device)


def shape_flops(torch, model, run) -> float:
    """FLOPs (two per multiply-add) of the convs, linear layers and
    attention products (YOLO's PSA, RT-DETR's multi-head) of ``model`` in one
    ``run()`` under no_grad, counted from the shapes."""
    from facedet_tpu_torch.models.layers import PSAAttention
    from facedet_tpu_torch.models.rtdetr import MultiHeadAttention

    total = [0.0]

    def conv(m, inp, out):
        total[0] += 2.0 * out.numel() * m.in_channels // m.groups * m.kernel_size[0] * m.kernel_size[1]

    def linear(m, inp, out):
        total[0] += 2.0 * out.numel() * m.in_features

    def psa(m, inp, out):
        b, _, h, w = inp[0].shape
        total[0] += 2.0 * b * m.num_heads * (h * w) ** 2 * (m.key_dim + m.head_dim)

    def attention(m, inp, out):
        b, nq, d = inp[0].shape
        total[0] += 4.0 * b * nq * inp[1].shape[1] * d  # q k^T and the weighted sum

    kinds = ((torch.nn.Conv2d, conv), (torch.nn.Linear, linear), (PSAAttention, psa), (MultiHeadAttention, attention))
    hooks = [m.register_forward_hook(hook) for m in model.modules() for kind, hook in kinds if isinstance(m, kind)]
    try:
        with torch.no_grad():
            run()
    finally:
        for hk in hooks:
            hk.remove()
    return total[0]


def _step_profile(torch, run, ms, label, n=2, top=0):
    """Launches and device-busy ms per ``run()`` from the profiler, their
    share of the wall ``ms`` (TF32 as the caller set it), the groups above 2%
    of the device time and the ``top`` kernels."""
    from facedet_tpu_torch.utils.profiling import kernel_groups, profile_kernels

    kernels = profile_kernels(run, n=n)
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / n
    launches = sum(e.count for e in kernels) / n
    check(device_ms > 0, f"{label}: the profiler saw no device time")
    print(f"profile of {n} {label} steps: {launches:.0f} kernel launches per step, device busy {device_ms:.3f} ms/step "
          f"({100 * device_ms / ms:.1f}% of the median wall time)")
    for group, (ms_g, n_g) in kernel_groups(kernels, n).items():
        if ms_g > 0.02 * device_ms:
            print(f"  {ms_g:8.3f} ms/step {n_g:8.1f} launches  {group}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"  {e.self_device_time_total / 1e3 / n:8.3f} ms/step  {e.count / n:6.1f}x  {e.key[:90]}")
    return launches, device_ms


@contextlib.contextmanager
def _tf32(torch):
    """TF32 on for cuBLAS and cuDNN while open; the previous settings are
    restored on exit."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def detr_sr_fidelity_phase(torch):
    phase(f"27 training fidelity (float32, TF32 off), card against CPU: one CDN step of {DETR_FIDELITY} (seeded, "
          f"{DETR_FIDELITY_SIZE}x{DETR_FIDELITY_SIZE}, batch {FIDELITY_BATCH}, greedy matcher, the CPU's query selection) "
          f"and one G and D step of RealESRGAN_x2plus (golden) with PatchDiscriminator(64) and the perceptual term; "
          f"each beside a TF32 control")
    import copy

    import numpy as np

    from facedet_tpu_torch.engine.detector import _exact_float32
    from facedet_tpu_torch.models.rtdetr import RTDETR_VARIANTS, create_rtdetr
    from facedet_tpu_torch.train.perceptual import make_yolo_feature_loss
    from facedet_tpu_torch.train.rtdetr_train import layer_assignments, train_loss
    from facedet_tpu_torch.train.sr_gan import SpectralNormConv2d, create_discriminator, make_sr_gan_staged_loop

    images, boxes, mask = _detr_batch(torch, DETR_FIDELITY_SIZE, FIDELITY_BATCH, seed=740)
    part, sign = _cdn_noise(torch, FIDELITY_BATCH, boxes.shape[1], seed=741)
    # the CPU; the card in float32 and in TF32 (the control a gate must catch); the CPU with
    # the images moved by about one ulp, which reads how far rounding alone moves this model
    nudged = images * (1 + 6e-8 * torch.randn(images.shape, generator=torch.Generator().manual_seed(745)))
    exact = lambda: _exact_float32(True)  # noqa: E731
    runs, assigns, top_idx, matcher = {}, {}, None, "greedy"
    for key, dev, x, precision in (("cpu", "cpu", images, exact), ("cuda", "cuda", images, exact),
                                   ("tf32", "cuda", images, lambda: _tf32(torch)), ("nudged", "cpu", nudged, exact)):
        model = create_rtdetr(RTDETR_VARIANTS[DETR_FIDELITY], seed=7).to(dev)
        bx, mk = boxes.to(dev), mask.to(dev)
        with precision():
            total, parts, outs = train_loss(model, x.to(dev), bx, mk, DETR_GROUPS, part=part, sign=sign,
                                            matcher=matcher, top_idx=None if top_idx is None else top_idx.to(dev))
            total.backward()
        assigns[key] = [layer_assignments(lg.detach(), bb.detach(), bx, mk, "greedy").cpu()
                        for lg, bb in zip(outs["logits"], outs["boxes"])]
        if key == "cpu":  # the later runs take the CPU's query selection and matching
            top_idx = outs["top_idx"]
            matcher = lambda cost: next(given).to(cost.device)  # noqa: E731
        given = iter(assigns["cpu"])
        runs[key] = ({k: float(v.detach()) for k, v in parts.items()},
                     {n: p.grad.cpu() for n, p in model.named_parameters() if p.grad is not None},
                     {n: b.cpu() for n, b in model.named_buffers() if "running" in n})
    moved = {key: sum(int((a != b).sum()) for a, b in zip(assigns["cpu"], assigns[key]))
             for key in ("cuda", "tf32", "nudged")}
    readings = {key: _train_errors({"cpu": runs["cpu"], "cuda": runs[key]}) for key in ("cuda", "tf32", "nudged")}
    n_slots = sum(a.numel() for a in assigns["cpu"])
    show = lambda r: f"parts {r[0]:.3g} relative, gradients {r[1]:.3g} of each leaf's largest ({r[3]}), " \
                     f"running statistics {r[2]:.3g}"  # noqa: E731
    print(f"{DETR_FIDELITY} CDN step {DETR_FIDELITY_SIZE}x{DETR_FIDELITY_SIZE} batch {FIDELITY_BATCH}, {boxes.shape[1]} GT "
          f"per image, {DETR_GROUPS} groups, loss parts { {k: round(v, 6) for k, v in runs['cpu'][0].items()} } "
          f"({len(runs['cpu'][1])} leaves with a gradient, {len(runs['cpu'][2])} statistics): own greedy matching "
          f"against the CPU's at {n_slots} GT slots of {len(assigns['cpu'])} decoder layers moves {moved['cuda']} (card), "
          f"{moved['tf32']} (TF32 control), {moved['nudged']} (CPU with one-ulp-nudged images); given the CPU's selection "
          f"and matching, against the CPU: card {show(readings['cuda'])}; TF32 control {show(readings['tf32'])}; nudged "
          f"CPU {show(readings['nudged'])}; gates {DETR_GATES}")
    check(all(np.isfinite(v) for v in runs["cuda"][0].values()), f"{DETR_FIDELITY}: loss parts {runs['cuda'][0]}")
    check(moved["cuda"] == 0, f"{DETR_FIDELITY}: the card's greedy matching moved {moved['cuda']} GT slots")
    for what, err, gate in zip(("loss parts", "gradients", "BatchNorm running statistics"), readings["cuda"], DETR_GATES):
        check(err <= gate, f"{DETR_FIDELITY}: {what} card vs CPU {err}, gate {gate}")
    check(readings["tf32"][1] > DETR_GATES[1], f"{DETR_FIDELITY}: the TF32 control's gradients pass the gate")

    lr_u8, hr_u8 = _sr_patches(torch, 2, 64, seed=742)
    runs = {}
    for key, dev, precision in (("cpu", "cpu", exact), ("cuda", "cuda", exact), ("tf32", "cuda", lambda: _tf32(torch))):
        g = _golden_x2(torch, dev)
        d = create_discriminator(64, seed=744).to(dev)
        run = make_sr_gan_staged_loop(g, d, torch.optim.SGD(g.parameters(), lr=0.0), torch.optim.SGD(d.parameters(), lr=0.0),
                                      steps_per_dispatch=1, flip=False, percep_fn=make_yolo_feature_loss(device=dev))
        with precision():
            metrics = run(copy.deepcopy(g), lr_u8[None].to(dev), hr_u8[None].to(dev))
        runs[key] = ({k: float(v) for k, v in metrics.items()},
                     {f"{net}.{n}": p.grad.cpu() for net, m in (("G", g), ("D", d)) for n, p in m.named_parameters()},
                     {f"{n}.{leaf}": getattr(m, leaf).cpu() for n, m in d.named_modules()
                      if isinstance(m, SpectralNormConv2d) for leaf in ("u", "sigma")})

    def gan_errors(key):
        """Metrics (relative), per network the gradients' error norm over
        their norm, u and sigma, and the largest per-leaf error: some deep
        RRDB leaves hold gradients 1e-3 of the largest, summed from far
        larger terms, where the CPU's own float32 result lies 2% of the
        leaf's largest from float64, so the gate reads the norms."""
        part_err, grad_err, stat_err, worst = _train_errors({"cpu": runs["cpu"], "cuda": runs[key]})
        want_g, got_g = runs["cpu"][1], runs[key][1]
        norm = {net: (sum(float((got_g[n] - g).square().sum()) for n, g in want_g.items() if n.startswith(net)) /
                      sum(float(g.square().sum()) for n, g in want_g.items() if n.startswith(net))) ** 0.5
                for net in ("G", "D")}
        return part_err, norm, stat_err, f"{grad_err:.3g} at {worst}"

    card, control = gan_errors("cuda"), gan_errors("tf32")
    show = lambda r: f"metrics {r[0]:.3g} relative, gradients' error norm over their norm G {r[1]['G']:.3g} " \
                     f"D {r[1]['D']:.3g} (largest per leaf {r[3]}), u and sigma {r[2]:.3g}"  # noqa: E731
    print(f"RealESRGAN_x2plus GAN step, HR 64x64 batch 2, perceptual term on: metrics "
          f"{ {k: round(v, 6) for k, v in runs['cpu'][0].items()} } ({len(runs['cpu'][1])} leaves, "
          f"{len(runs['cpu'][2])} spectral-norm buffers); against the CPU: card {show(card)}; TF32 control "
          f"{show(control)}; gates {GAN_GATES}")
    check(all(np.isfinite(v) for v in runs["cuda"][0].values()) and runs["cuda"][0]["percep"] > 0,
          f"GAN step metrics {runs['cuda'][0]}")
    check(card[0] <= GAN_GATES[0], f"GAN step: metrics card vs CPU {card[0]} relative")
    check(max(card[1].values()) <= GAN_GATES[1], f"GAN step: gradients card vs CPU {card[1]} (error norm over norm)")
    check(card[2] <= GAN_GATES[2], f"GAN step: spectral-norm u and sigma card vs CPU {card[2]}")
    check(max(control[1].values()) > GAN_GATES[1], f"GAN step: the TF32 control's gradients {control[1]} pass the gate")


def detr_sr_main_path_phase(torch):
    """The timings run before each profile window."""
    phase(f"28 training main path: rtdetr-l {TRAIN_SIZE}x{TRAIN_SIZE} batch {TRAIN_BATCH}, CDN {DETR_GROUPS} groups, "
          f"float32, AdamW lr 1e-4, greedy matcher; RealESRGAN_x2plus HR {SR_HR} batch {SR_BATCH} (Adam, clip 5, EMA "
          f"0.999), then its GAN step with the perceptual term")
    import copy

    import numpy as np

    from facedet_tpu_torch.engine.detector import _exact_float32
    from facedet_tpu_torch.models.rtdetr import RTDETR_VARIANTS, create_rtdetr
    from facedet_tpu_torch.models.yolov11 import YoloConfig, YoloV11
    from facedet_tpu_torch.train.perceptual import DEFAULT_LAYERS, make_yolo_feature_loss
    from facedet_tpu_torch.train.rtdetr_train import (
        WarmupConstant,
        greedy_match,
        make_rtdetr_train_step,
        make_staged_rtdetr_loop,
    )
    from facedet_tpu_torch.train.sr_gan import create_discriminator, make_sr_gan_staged_loop
    from facedet_tpu_torch.train.sr_train import make_sr_staged_loop
    from facedet_tpu_torch.train.yolo_train import ClippedAdamW, WarmupCosineDecay

    batch = [x.cuda() for x in _detr_batch(torch, TRAIN_SIZE, TRAIN_BATCH, seed=750)]
    model = create_rtdetr(RTDETR_VARIANTS["rtdetr-l"], seed=7).cuda()
    flops = 3 * shape_flops(torch, model, lambda: model(batch[0]))
    tx = ClippedAdamW(model.parameters(), WarmupConstant(1e-4, 100), weight_decay=1e-4, max_norm=0.1)
    step = make_rtdetr_train_step(model, tx, dn_groups=DETR_GROUPS, seed=751)
    losses = []
    run = lambda: losses.append(step(*batch)[0])  # noqa: E731
    images_u8 = torch.stack([(batch[0] * 255).round().to(torch.uint8)] * 2)
    staged = [images_u8] + [torch.stack([x] * 2) for x in batch[1:]]
    with _exact_float32(True):
        torch.cuda.reset_peak_memory_stats()
        times = _time_steps(torch, run, n=DETR_STEPS, warmup=3)
        peak = torch.cuda.max_memory_allocated() / 1e9
        make_staged_rtdetr_loop(model, tx, steps_per_dispatch=2, seed=752)(*staged)  # warm-up of the flip path
        loop = make_staged_rtdetr_loop(model, tx, steps_per_dispatch=DETR_STAGED, seed=753)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mean = float(loop(*staged, start=1))
        staged_ms = (time.perf_counter() - t0) * 1e3 / DETR_STAGED
        ms = statistics.median(times)
        launches, device_ms = _step_profile(torch, run, ms, "rtdetr-l CDN")
        cost = torch.rand(TRAIN_BATCH, 300, TRAIN_FACES, device="cuda")
        match_ms = statistics.median(_time_steps(torch, lambda: greedy_match(cost), n=10))
        match_launches = _kernel_launches(torch, lambda: greedy_match(cost))
    losses = [float(x) for x in losses]
    check(all(np.isfinite(losses)) and np.isfinite(mean), f"rtdetr-l training losses {losses}, staged {mean}")
    rate = flops / ms / 1e9
    print(f"make_rtdetr_train_step, rtdetr-l {TRAIN_SIZE}x{TRAIN_SIZE} batch {TRAIN_BATCH}, {TRAIN_FACES} faces per image, "
          f"CDN {DETR_GROUPS} groups ({2 * DETR_GROUPS * TRAIN_FACES} denoising queries), float32 (TF32 off): median "
          f"{ms:.3f} ms/step over {len(times)} (min {min(times):.3f}, max {max(times):.3f}), {TRAIN_BATCH / ms * 1e3:.2f} "
          f"images/s, peak memory {peak:.3f} GB, {flops / 1e12:.4f} TFLOP per step (forward convs, linears and attention "
          f"x3, the matching queries only) = {rate:.2f} TFLOP/s ({100 * rate / (F32_FLOPS_PER_S / 1e12):.1f}% of the "
          f"67 TFLOP/s float32 peak); loss {losses[0]:.4f} -> {losses[-1]:.4f} over {len(losses)} steps")
    print(f"make_staged_rtdetr_loop, flip=True, {DETR_STAGED} steps per dispatch: {staged_ms:.3f} ms/step, mean loss "
          f"{mean:.4f}")
    print(f"greedy_match alone on [{TRAIN_BATCH}, 300, {TRAIN_FACES}] costs: {match_ms:.3f} ms, {match_launches} kernel "
          f"launches ({TRAIN_FACES} iterations; {2 * 6} calls per step: 6 decoder layers)")

    del model, tx, step, loop, staged, batch
    lr_u8, hr_u8 = _sr_patches(torch, 2 * SR_BATCH, SR_HR, seed=753)
    lr_u8 = lr_u8.reshape(2, SR_BATCH, *lr_u8.shape[1:]).cuda()
    hr_u8 = hr_u8.reshape(2, SR_BATCH, *hr_u8.shape[1:]).cuda()
    g = _golden_x2(torch, "cuda")
    ema = copy.deepcopy(g)
    tx = ClippedAdamW(g.parameters(), WarmupCosineDecay(2e-4, 200, 4000, 1e-5), weight_decay=0.0, max_norm=5.0)
    sr_flops = 3 * SR_BATCH * rrdb_conv_flops(g.cfg, SR_HR // 2, SR_HR // 2)
    d = create_discriminator(64, seed=754).cuda()
    percep = make_yolo_feature_loss(device="cuda")
    fake = torch.rand(SR_BATCH, SR_HR, SR_HR, 3, device="cuda")
    d_flops = shape_flops(torch, d, lambda: d(fake))
    backbone = YoloV11(YoloConfig(scale="n")).backbone.cuda()
    p_flops = shape_flops(torch, backbone, lambda: backbone.features(fake.permute(0, 3, 1, 2), DEFAULT_LAYERS))
    # G x3; D: forward and input gradient in the G step, two passes x3 in the D step; the
    # perceptual backbone: two forwards and the input gradient
    gan_flops = sr_flops + 8 * d_flops + 3 * p_flops
    gan_tx = [ClippedAdamW(m.parameters(), lambda c: 1e-4, weight_decay=0.0, max_norm=5.0) for m in (g, d)]
    gan = make_sr_gan_staged_loop(g, d, *gan_tx, steps_per_dispatch=1, flip=True, percep_fn=percep, seed=755)
    sr = make_sr_staged_loop(g, tx, steps_per_dispatch=1, flip=True, seed=756)
    with _exact_float32(True):
        torch.cuda.reset_peak_memory_stats()
        counter = iter(range(10**6))
        sr_times = _time_steps(torch, lambda: sr(ema, lr_u8, hr_u8, start=next(counter)), n=SR_STEPS, warmup=2)
        sr_peak = torch.cuda.max_memory_allocated() / 1e9
        sr_ms = statistics.median(sr_times)
        sr_launches, sr_device = _step_profile(torch, lambda: sr(ema, lr_u8, hr_u8, start=next(counter)), sr_ms,
                                               "RealESRGAN_x2plus staged")
        torch.cuda.reset_peak_memory_stats()
        metrics = []
        gan_times = _time_steps(torch, lambda: metrics.append(gan(ema, lr_u8, hr_u8, start=next(counter))),
                                n=SR_STEPS, warmup=2)
        gan_peak = torch.cuda.max_memory_allocated() / 1e9
        gan_ms = statistics.median(gan_times)
        gan_launches, gan_device = _step_profile(torch, lambda: gan(ema, lr_u8, hr_u8, start=next(counter)), gan_ms,
                                                 "GAN")
    last = {k: float(v) for k, v in metrics[-1].items()}
    check(all(np.isfinite(v) for v in last.values()), f"GAN metrics {last}")
    print(f"make_sr_staged_loop, RealESRGAN_x2plus (golden), HR {SR_HR} batch {SR_BATCH}, flip, EMA 0.999, float32 "
          f"(TF32 off): median {sr_ms:.3f} ms/step over {len(sr_times)} (min {min(sr_times):.3f}, max "
          f"{max(sr_times):.3f}), {SR_BATCH / sr_ms * 1e3:.2f} patches/s, peak memory {sr_peak:.3f} GB, "
          f"{sr_flops / 1e12:.4f} TFLOP per step (convs x3) = {sr_flops / sr_ms / 1e9:.2f} TFLOP/s")
    print(f"profiles: the SR step {sr_launches:.0f} launches, device busy {sr_device:.3f} ms "
          f"({100 * sr_device / sr_ms:.1f}%); the GAN step {gan_launches:.0f} launches, device busy {gan_device:.3f} ms "
          f"({100 * gan_device / gan_ms:.1f}%)")
    print(f"make_sr_gan_staged_loop, the same G with PatchDiscriminator(64) and the perceptual term: median "
          f"{gan_ms:.3f} ms/step over {len(gan_times)} (min {min(gan_times):.3f}, max {max(gan_times):.3f}), "
          f"{SR_BATCH / gan_ms * 1e3:.2f} patches/s, peak memory {gan_peak:.3f} GB, {gan_flops / 1e12:.4f} TFLOP per "
          f"step (G x3, D x8, the perceptual backbone x3) = {gan_flops / gan_ms / 1e9:.2f} TFLOP/s; last metrics {last}")


def detr_sr_learning_phase(torch, root):
    phase(f"29 learning proof: selftrain_demo --model rtdetr --steps {DETR_DEMO_STEPS} --lr 8e-4 (rtdetr-tiny, 96x96, CDN), "
          f"RtDetrTrainer for 2 epochs and its last.npz, a narrow SR run")
    import copy

    import numpy as np

    from facedet_tpu_torch.engine.rtdetr_wrapper import RtDetrDetectionModel
    from facedet_tpu_torch.models.rrdbnet import RRDBConfig, create_rrdbnet
    from facedet_tpu_torch.models.rtdetr import RTDETR_VARIANTS
    from facedet_tpu_torch.tools import selftrain_demo
    from facedet_tpu_torch.train.rtdetr_train import RtDetrTrainer, xyxy_to_cxcywh
    from facedet_tpu_torch.train.sr_train import make_sr_staged_loop
    from facedet_tpu_torch.train.yolo_train import ClippedAdamW

    t0 = time.perf_counter()
    out = selftrain_demo.main(["--model", "rtdetr", "--steps", str(DETR_DEMO_STEPS), "--lr", "8e-4"])
    secs = time.perf_counter() - t0
    before, after, losses = out["before"]["map50"], out["after"]["map50"], out["losses"]
    first, last = float(np.mean(losses[:20])), float(np.mean(losses[-20:]))
    print(f"selftrain_demo rtdetr-tiny, {DETR_DEMO_STEPS} steps of batch 16 at 96x96 from a seeded init, lr 8e-4, CDN "
          f"{DETR_GROUPS} groups: mAP50 {before:.4f} -> {after:.4f} (mAP {out['after']['map']:.4f}); mean loss of the "
          f"first 20 steps {first:.4f}, of the last 20 {last:.4f} ({100 * last / first:.1f}%); {secs:.1f} s with both "
          f"validations")
    check(after > before and last < 0.7 * first,
          f"the RT-DETR demo did not learn: mAP50 {before} -> {after}, loss {first} -> {last}")

    images, boxes, masks = (torch.from_numpy(a) for a in selftrain_demo.make_blob_dataset(16, 96, seed=760))
    cxcywh = xyxy_to_cxcywh(boxes, 96.0)
    batches = [tuple(a[i:i + 8] for a in (images, cxcywh, masks)) for i in (0, 8)]
    run_dir = os.path.join(root, "rtdetr_run")
    trainer = RtDetrTrainer(RTDETR_VARIANTS["rtdetr-tiny"], lr=4e-4, output_dir=run_dir, save_period=1, image_size=96,
                            warmup_steps=2)
    check(trainer.device.type == "cuda", f"RtDetrTrainer chose {trainer.device}")
    result = trainer.fit(lambda epoch: batches, num_epochs=2, verbose=False)
    check(result["epochs"] == 2 and sorted(os.listdir(run_dir)) ==
          ["best.npz", "epoch1.npz", "epoch2.npz", "last.npz", "results.csv", "results.json"],
          f"RtDetrTrainer.fit wrote {sorted(os.listdir(run_dir))}")
    tiles = torch.from_numpy(selftrain_demo.make_blob_dataset(2, 96, seed=761)[0]).cuda()
    kw = dict(variant="rtdetr-tiny", dtype="float32", image_size=96, confidence_threshold=0.05)
    from_file = RtDetrDetectionModel(model_path=os.path.join(run_dir, "last.npz"), device="cuda", **kw)
    want = trainer.as_detection_model(0.05).forward_tiles(tiles, 0.05)
    got = from_file.forward_tiles(tiles, 0.05)
    box_err = float((got.boxes - want.boxes).abs().max())
    score_err = float((got.scores - want.scores).abs().max())
    check(int(want.valid.sum()) > 0, "the trained RT-DETR found nothing at confidence 0.05")
    check(torch.equal(got.valid, want.valid) and box_err <= BOX_ATOL and score_err <= SCORE_ATOL,
          f"RtDetrTrainer last.npz against memory: boxes {box_err}, scores {score_err}")
    print(f"RtDetrTrainer last.npz against the trained model in memory on 2 tiles: {int(want.valid.sum())} detections "
          f"at conf 0.05, boxes max err {box_err:.3g} px, scores {score_err:.3g} (file vs memory)")
    print(f"RtDetrTrainer: 2 epochs of 2 batches of 8 at 96x96, losses {[round(h['train_loss'], 4) for h in trainer.history]}")

    net = create_rrdbnet(RRDBConfig(scale=2, num_block=1, num_feat=16, num_grow_ch=8),
                         torch.Generator().manual_seed(770)).cuda()
    hr_u8 = torch.from_numpy(np.random.default_rng(771).integers(0, 256, (1, 4, 16, 16, 3), dtype=np.uint8)).cuda()
    lr_u8 = hr_u8[:, :, ::2, ::2].contiguous()
    run = make_sr_staged_loop(net, ClippedAdamW(net.parameters(), lambda c: 2e-3, weight_decay=0.0, max_norm=5.0),
                              steps_per_dispatch=1, flip=False)
    ema = copy.deepcopy(net)
    sr_losses = [float(run(ema, lr_u8, hr_u8, start=i)) for i in range(40)]
    print(f"narrow SR net (1 block, 16 features), 40 steps on one batch from a seeded init: loss {sr_losses[0]:.4f} -> "
          f"{sr_losses[-1]:.4f}")
    check(sr_losses[-1] < 0.7 * sr_losses[0], f"the narrow SR run did not learn: {sr_losses[0]} -> {sr_losses[-1]}")


JAX_INT8_CONVS = 56  # the JAX package's quantize_detector on golden yolo11n (tests/test_torch_quantize.py)
INT8_TOPS = 1979e12  # H100 SXM dense int8, NVIDIA data sheet
VIDEO_FRAMES = 8


def conversion_phase(torch, root):
    phase("30 checkpoint conversion: an ultralytics-named yolo11n-pose and a basicsr-named x2plus, float32 (TF32 off)")
    import numpy as np

    from facedet_tpu_torch import YoloV11PoseDetectionModel, get_sliced_prediction
    from facedet_tpu_torch.engine.detector import _exact_float32
    from facedet_tpu_torch.models.convert import _unshuffle_permutation, convert_rrdbnet_checkpoint, convert_ultralytics_checkpoint
    from facedet_tpu_torch.models.from_jax import _load_strict
    from facedet_tpu_torch.models.rrdbnet import MODEL_CATALOG, RRDBNet, init_rrdbnet_
    from facedet_tpu_torch.models.yolov11 import YoloConfig, YoloV11

    sys.path.insert(0, os.path.join(REPO, "tests"))
    from torch_yolo_ref import TorchYolo11Pose, randomize_  # torch only: the ultralytics module tree

    cfg = YoloConfig(scale="n", num_classes=1, with_pose=True, dtype="float32")
    ref = randomize_(TorchYolo11Pose(cfg), seed=5).eval()
    sd = ref.state_dict()
    state, scale = convert_ultralytics_checkpoint(sd, cfg)
    check(scale == "n", f"the converter read the scale {scale!r} from a yolo11n-pose")
    model = YoloV11(cfg)
    _load_strict(model, state)
    model.set_dtypes().cuda().eval()
    ref.cuda()
    x = torch.rand((2, 3, SLICE, SLICE), generator=torch.Generator().manual_seed(9)).cuda()
    worst = 0.0
    with torch.inference_mode(), _exact_float32(True):
        want, got = ref(x), model.forward_nchw(x)
    for lvl, maps in enumerate(want):
        for name, w in zip(("box", "cls", "kpt"), maps):
            g = got[lvl][name].permute(0, 3, 1, 2)
            err = float(((g - w).abs() / (1e-4 + 1e-4 * w.abs())).max())
            worst = max(worst, float((g - w).abs().max()))
            check(err <= 1.0, f"converted yolo11n-pose {name} level {lvl}: {float((g - w).abs().max())} off the reference")
    print(f"convert_ultralytics_checkpoint: {len(state)} tensors, scale {scale}; the nine head maps at 2x{SLICE}^2 "
          f"within {worst:.3g} of the torch reference on the card (gate: atol 1e-4 + rtol 1e-4)")

    path = os.path.join(root, "yolo11n-pose.pt")
    torch.save({"state_dict": {k: v.cpu() for k, v in sd.items()}}, path)
    det = YoloV11PoseDetectionModel(model_path=path, scale="n", dtype="float32", device="cuda", image_size=SLICE)
    check(torch.equal(det.model.backbone.c2psa.m0.attn.qkv.conv.weight.cpu(),
                      sd["model.10.m.0.attn.qkv.conv.weight"].cpu()),
          "YoloV11PoseDetectionModel(model_path=.pt) did not load the checkpoint's tensors")
    image = _photo(600)
    res = get_sliced_prediction(image, det, **SLICED_KW).detections.to_numpy()
    check(np.isfinite(res["boxes"]).all() and np.isfinite(res["scores"]).all(), "the .pt detector gave non-finite output")
    print(f"YoloV11PoseDetectionModel(model_path=.pt) -> get_sliced_prediction on 1024x1536: {len(res['boxes'])} "
          f"detections (random weights)")

    xcfg = MODEL_CATALOG["RealESRGAN_x2plus"]
    net = RRDBNet(xcfg)
    init_rrdbnet_(net, torch.Generator().manual_seed(3))
    own = net.state_dict()
    basicsr = {}
    for k, v in own.items():  # the basicsr names and unshuffle order of the same net
        basicsr[f"body.{k[4:].split('.', 1)[0]}.{k.split('.', 1)[1]}" if k.startswith("body") else k] = v
    first = torch.empty_like(own["conv_first.weight"])
    first[:, _unshuffle_permutation(xcfg.num_in_ch, 2)] = own["conv_first.weight"]
    basicsr["conv_first.weight"] = first
    back = convert_rrdbnet_checkpoint(basicsr, xcfg)
    check(set(back) == set(own) and all(torch.equal(back[k], own[k]) for k in own),
          "convert_rrdbnet_checkpoint did not give the net's own state back from its basicsr names")
    twin = RRDBNet(xcfg)
    _load_strict(twin, back)
    lr = torch.rand((1, 3, 64, 64), generator=torch.Generator().manual_seed(4)).cuda()
    with torch.inference_mode():
        check(torch.equal(twin.cuda().eval().forward_nchw(lr), net.cuda().eval().forward_nchw(lr)),
              "the converted x2plus differs from the original on the card")
    print(f"convert_rrdbnet_checkpoint: x2plus ({len(own)} tensors, 23 blocks) from basicsr names and "
          f"F.pixel_unshuffle order back to the port's, bit for bit, and its forward on the card equal")


def _match_rate(a, b, iou=0.5):
    """The share of the rows of ``a`` that one row of ``b`` covers at ``iou``."""
    if not len(a):
        return 1.0
    if not len(b):
        return 0.0
    return float((_iou(a, b).max(1) >= iou).mean())


def _counted(into, run):
    """``run()`` with the launch counts from 0; what it launched is added to
    ``into`` (a dict of kernel names), so runs around it count nowhere."""
    launches = _reset_launches()
    out = run()
    for k in into:
        into[k] += launches[k]
    return out


def _no_launches():
    return {"gather_chw": 0, "gather_chw_batched": 0}


def int8_phase(torch, models):
    """Returns the launch counts of the int8 paths."""
    phase("31 int8 serving: golden yolo11n quantized; float32 card against CPU, bfloat16 single image and stream")
    import numpy as np

    from facedet_tpu_torch import YoloV11PoseDetectionModel, get_sliced_prediction, predict_stream_batched
    from facedet_tpu_torch.eval.gates import int8_gate, section2_gate
    from facedet_tpu_torch.models import quantize as Q
    from facedet_tpu_torch.models.from_jax import load_jax_variables, to_jax_variables
    from facedet_tpu_torch.models.layers import Int8ConvBnAct

    kw = dict(model_path=CKPT, scale="n", image_size=SLICE)
    card = YoloV11PoseDetectionModel(dtype="float32", device="cuda", **kw)
    t0 = time.perf_counter()
    n = Q.quantize_detector(card)
    print(f"quantize_detector on the card (4 natural tiles of {SLICE}^2, float32): {n} quantized convs in "
          f"{time.perf_counter() - t0:.2f} s; the JAX package's count for the same model: {JAX_INT8_CONVS}")
    check(n == JAX_INT8_CONVS, f"{n} quantized convs, the JAX package quantizes {JAX_INT8_CONVS}")
    int8_tree = to_jax_variables(card.model.state_dict())
    cpu = YoloV11PoseDetectionModel(dtype="float32", device="cpu", **kw)
    load_jax_variables(cpu.model, int8_tree)  # the same int8 buffers on both sides

    # each int8 layer given the CPU's input: the same levels, the same accumulators
    image = _photo(610)
    tiles = torch.from_numpy(np.stack([image[0:SLICE, 0:SLICE], image[384:1024, 896:1536]]).astype(np.float32) / 255)
    inputs = {}
    hooks = [m.register_forward_hook(lambda mod, i, o, name=name: inputs.__setitem__(name, (i[0], o)))
             for name, m in cpu.model.named_modules() if isinstance(m, Int8ConvBnAct)]
    with torch.inference_mode():
        cpu.model.forward_nchw(tiles.permute(0, 3, 1, 2))
    for h in hooks:
        h.remove()
    differ, worst = 0, 0.0
    with torch.inference_mode():
        for name, (x, want) in inputs.items():
            layer = card.model.get_submodule(name)
            got = layer(x.cuda()).cpu()
            levels = [torch.clamp(torch.round(t.float() / m.ascale), -127, 127).cpu()
                      for t, m in ((x.cuda(), layer), (x, cpu.model.get_submodule(name)))]
            differ += int((levels[0] != levels[1]).sum())
            worst = max(worst, float((got - want).abs().max() / want.abs().max()))
    check(len(inputs) == n and differ == 0 and worst <= 1e-5,
          f"int8 layers given the CPU's inputs: {differ} levels differ, outputs {worst} of the largest off")
    print(f"each of the {n} int8 layers given the CPU's inputs (2 tiles of {SLICE}^2): 0 activation levels differ, "
          f"outputs within {worst:.3g} of the layer's largest")

    # the whole detector, float32, TF32 off: card against CPU, beside two controls;
    # launches are counted over the int8 runs on the card alone (``own``)
    own = {"card": _no_launches(), "single": _no_launches(), "stream": _no_launches()}
    want = get_sliced_prediction(image, cpu, **SLICED_KW).detections.to_numpy()
    got = _counted(own["card"], lambda: get_sliced_prediction(image, card, **SLICED_KW)).detections.to_numpy()
    check(len(want["boxes"]) > 0 and np.isfinite(got["boxes"]).all(), "int8 float32: no or non-finite detections")
    held, err = section2_gate(got, want)
    passed, worst_iou, worst_ds = int8_gate(got, want)
    print(f"int8 get_sliced_prediction float32, card against CPU: {len(got['boxes'])} against {len(want['boxes'])} "
          f"detections; PERF.md §2's gates {'held' if held else 'FAILED'} {err}; int8 gate (counts, IoU >= 0.85, "
          f"|dscore| <= 0.05): worst IoU {worst_iou:.4f}, |dscore| {worst_ds:.4g}")
    canvas = torch.from_numpy(image).float() / 255.0
    base = get_sliced_prediction(canvas, cpu, **SLICED_KW).detections.to_numpy()
    nudged = get_sliced_prediction(torch.nextafter(canvas, torch.tensor(2.0)), cpu, **SLICED_KW).detections.to_numpy()
    nudge_held, nudge_err = section2_gate(nudged, base)
    print(f"control, the CPU against itself with the image one ulp up: §2's gates {'held' if nudge_held else 'FAILED'} "
          f"{nudge_err}; int8 gate {int8_gate(nudged, base)[1:]}")
    float_det = get_sliced_prediction(image, models["cuda"], **SLICED_KW).detections.to_numpy()
    float_passed, f_iou, f_ds = int8_gate(float_det, want)
    print(f"control, the float32 detector (not quantized) on the card against the CPU's int8: int8 gate "
          f"{'passed' if float_passed else 'failed'} ({len(float_det['boxes'])} detections, IoU {f_iou:.4f}, "
          f"|dscore| {f_ds:.4g})")
    check(held or passed, f"int8 card against CPU fails both §2's gates {err} and the int8 gate "
                          f"(IoU {worst_iou}, |dscore| {worst_ds})")
    check(not float_passed, "the int8 gate passes the float32 detector: it cannot tell int8 from float")

    # bfloat16, the single-image configuration: int8 beside float, in turns
    serving = models["serving"]
    q_serving = YoloV11PoseDetectionModel(device="cuda", **kw)
    check(Q.quantize_detector(q_serving) == n, "the bfloat16 detector quantized another count")
    images = [_photo(620 + s) for s in range(8)]
    times = {"bfloat16": [], "int8": []}
    single = {"bfloat16": _no_launches(), "int8": own["single"]}
    for _ in range(2):
        for label, model in (("bfloat16", serving), ("int8", q_serving)):
            times[label] += _counted(single[label], lambda: _serve(model, images, SLICED_KW,  # noqa: B023
                                                                    f"{label} single image"))[0]  # noqa: B023
    per_image = {k: statistics.median(v) for k, v in times.items()}
    for label, ms in per_image.items():
        print(f"get_sliced_prediction {label}, 1024x1536, 6+1 tiles of {SLICE}: median {ms:.3f} ms/image over "
              f"{len(times[label])} images (min {min(times[label]):.3f}, max {max(times[label]):.3f}); CHW gather "
              f"launches {single[label]['gather_chw'] / (2 * len(images)):.2f} per image")
    for label, model in (("bfloat16", serving), ("int8", q_serving)):
        _profile(torch, lambda: get_sliced_prediction(images[0], model, **SLICED_KW), per_image[label],  # noqa: B023
                 label=f"single image {label}")
    from torch.profiler import ProfilerActivity, profile

    from facedet_tpu_torch.engine.detector import ForwardGraphs

    def no_capture(pre, tiles):
        raise RuntimeError("counted eagerly")

    # a host-only window: it counts aten:: ops, which a lost device record
    # cannot shorten, so it needs none of profile_kernels' markers; the
    # forwards run eagerly, for a CUDA graph's replay runs no aten op and no
    # hook. The hooks record the shape each int8 layer's GEMM takes.
    shapes = []
    hooks = [m.register_forward_hook(lambda mod, i, o: shapes.append((o.shape[0] * o.shape[2] * o.shape[3], mod)))
             for m in q_serving.model.modules() if isinstance(m, Int8ConvBnAct)]
    graphs, q_serving.forward_graphs = q_serving.forward_graphs, ForwardGraphs(capture=no_capture)
    try:
        with torch.inference_mode(), profile(activities=[ProfilerActivity.CPU]) as prof:
            get_sliced_prediction(images[0], q_serving, **SLICED_KW)
    finally:
        q_serving.forward_graphs = graphs
        for h in hooks:
            h.remove()
    ops = {e.key: e.count for e in prof.key_averages() if e.key in ("aten::_int_mm", "aten::convolution")}
    float_convs = sum(1 for m in q_serving.model.modules() if isinstance(m, torch.nn.Conv2d))
    print(f"int8 image: {ops} ({n} int8 layers, {float_convs} float convs, 2 forwards: the tiles and the full view)")
    check(ops.get("aten::_int_mm") == 2 * n and ops.get("aten::convolution") == 2 * float_convs,
          f"the int8 detector ran {ops}, not {2 * n} int8 GEMMs and {2 * float_convs} float convs")

    # the GEMMs alone: each int8 layer's _int_mm at the shape one image gives it
    check(len(shapes) == 2 * n, f"the int8 layers' hooks saw {len(shapes)} GEMMs, not {2 * n}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    gemm_ms = ops_total = 0.0
    for rows, layer in shapes:
        w = layer.gemm_weight[0]
        a = torch.randint(-127, 128, (max(rows, 17), w.shape[1]), generator=gen, device="cuda", dtype=torch.int8)
        gemm_ms += event_ms(torch, lambda: torch._int_mm(a, w.t()), reps=10)  # noqa: B023
        ops_total += 2.0 * rows * w.shape[1] * w.shape[0]
    print(f"the {len(shapes)} int8 GEMMs of one image alone: {gemm_ms:.3f} ms, {ops_total / 1e9:.2f} GOP, "
          f"{ops_total / gemm_ms / 1e9:.1f} TOPS, {100 * ops_total / (gemm_ms / 1e3) / INT8_TOPS:.2f}% of the "
          f"{INT8_TOPS / 1e12:.0f} TOPS int8 peak")

    # detection agreement, int8 against float bfloat16
    recall, precision, found = [], [], [0, 0]
    for im in images:
        f = get_sliced_prediction(im, serving, **SLICED_KW).detections.to_numpy()["boxes"]
        q = get_sliced_prediction(im, q_serving, **SLICED_KW).detections.to_numpy()["boxes"]
        recall.append(_match_rate(f, q))
        precision.append(_match_rate(q, f))
        found[0] += len(f)
        found[1] += len(q)
    print(f"int8 against float bfloat16 on {len(images)} photos at IoU 0.5: recall {np.mean(recall):.4f}, precision "
          f"{np.mean(precision):.4f} ({found[1]} int8 and {found[0]} float detections)")

    # the serving configuration: batch 64, window 3, dct420s, int8 against bfloat16 in turns
    coded = [_coded_photo(300 + s)[1] for s in range(8)]

    def stream(model, batches):
        t0 = time.perf_counter()
        k = sum(raw.boxes.shape[0] for raw in predict_stream_batched(
            (coded[i % len(coded)] for i in range(SERVING_BATCH * batches)), model, batch_size=SERVING_BATCH, window=3,
            raw=True, input_format="dct420s", **SERVING_KW))
        check(k == SERVING_BATCH * batches, f"the stream answered {k} images")
        return SERVING_BATCH * batches / (time.perf_counter() - t0)

    rates = {"bfloat16": [], "int8": []}
    for model in (serving, q_serving):
        stream(model, 1)  # warm-up
    for _ in range(2):
        for label, model in (("bfloat16", serving), ("int8", q_serving)):
            run = lambda: stream(model, 3)  # noqa: B023, E731
            rates[label].append(_counted(own["stream"], run) if label == "int8" else run())
    for label, r in rates.items():
        print(f"serving {label}: {statistics.median(r):.2f} images/s (passes of 3 batches of {SERVING_BATCH}: "
              f"{', '.join(f'{x:.2f}' for x in r)})")
    print(f"int8 against bfloat16: {statistics.median(rates['int8']) / statistics.median(rates['bfloat16']):.3f}x "
          f"the images per second, {per_image['int8'] / per_image['bfloat16']:.3f}x the ms per image")
    print(f"launches of the int8 runs alone: the float32 card detector on 1 image {own['card']}, the bfloat16 "
          f"single image on {2 * len(images)} images {own['single']}, the stream on {2 * 3 * SERVING_BATCH} images "
          f"{own['stream']}")
    check(own["card"]["gather_chw"] > 0 and own["single"]["gather_chw"] > 0,
          f"an int8 single-image run did not launch the CHW gather: {own}")
    check(own["stream"]["gather_chw_batched"] > 0, f"the int8 stream did not launch the batched gather: {own['stream']}")
    return {k: sum(c[k] for c in own.values()) for k in _no_launches()}


def video_phase(torch, models, root):
    """Returns the launch counts of the video paths."""
    phase(f"32 video: an MJPEG AVI of {VIDEO_FRAMES} frames of 1024x1536 through predict() (rgb, dct420) and "
          f"FaceDetector.detect_video")
    import numpy as np

    from facedet_tpu_torch import get_sliced_prediction, predict
    from facedet_tpu_torch.data.video import read_video_frames, video_info, write_video
    from facedet_tpu_torch.data import native_loader
    from facedet_tpu_torch.engine import predict as P
    from facedet_tpu_torch.engine.rtdetr_wrapper import FaceDetector

    path = os.path.join(root, "clip.avi")
    check(write_video(path, (_photo(700 + s) for s in range(VIDEO_FRAMES)), fps=10.0) == VIDEO_FRAMES,
          "write_video wrote another frame count")
    info = video_info(path)
    check((info["width"], info["height"], info["num_frames"]) == (CANVAS[1], CANVAS[0], VIDEO_FRAMES), f"video_info {info}")
    # launches are counted over predict() and detect_video alone (``own``), not the comparisons
    own = {"rgb": _no_launches(), "dct420": _no_launches(), "detect_video": _no_launches()}
    kw = dict(slice_height=SLICE, slice_width=SLICE, verbose=0)
    for ingest in ("rgb", "dct420"):
        out = _counted(own[ingest], lambda: predict(  # noqa: B023
            detection_model=models["cuda"], source=path, project=os.path.join(root, "runs"), name=ingest,
            ingest=ingest, **kw))  # noqa: B023
        check(out["num_frames"] == VIDEO_FRAMES, f"predict() on the video ({ingest}): {out['num_frames']} frames")
        annotated = os.path.join(out["export_dir"], "clip_detections.avi")
        check(os.path.exists(annotated) and video_info(annotated)["num_frames"] == VIDEO_FRAMES,
              f"predict() ({ingest}) wrote no annotated AVI of {VIDEO_FRAMES} frames")
        with open(os.path.join(out["export_dir"], "result.json")) as f:
            coco = json.load(f)
        check({d["image_id"] for d in coco} == set(range(VIDEO_FRAMES)), f"the COCO json ({ingest}) misses a frame")
        t0 = time.perf_counter()
        frames = list(read_video_frames(path, ingest=ingest))
        read_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for frame in frames[:2]:
            P._display_image(frame)
        display_ms = 1e3 * (time.perf_counter() - t0) / 2
        for i, frame in enumerate(frames):
            want = get_sliced_prediction(frame, models["cuda"], input_format=ingest, slice_height=SLICE,
                                         slice_width=SLICE).to_coco_predictions(image_id=i)
            mine = [d for d in coco if d["image_id"] == i]
            check(len(mine) == len(want), f"frame {i} ({ingest}): {len(mine)} detections, its own call {len(want)}")
            if want:
                box = float(np.abs(np.array([d["bbox"] for d in mine]) - np.array([d["bbox"] for d in want])).max())
                score = float(np.abs(np.array([d["score"] for d in mine]) - np.array([d["score"] for d in want])).max())
                check(box <= BOX_ATOL and score <= SCORE_ATOL, f"frame {i} ({ingest}): boxes {box}, scores {score}")
        print(f"predict() on the AVI, ingest={ingest}, float32: {out['fps_processed']:.2f} frames/s with the annotated "
              f"AVI written; {len(coco)} detections, each frame's equal to get_sliced_prediction on the decoded frame; "
              f"on the host per frame: the reader {1e3 * read_s / VIDEO_FRAMES:.1f} ms (native jpeg reader "
              f"{'built' if native_loader._load_native() is not None else 'not built: PIL and a host encode'}), "
              f"the display image {display_ms:.1f} ms")
    fd = FaceDetector(variant="rtdetr-l", conf=0.5, image_size=SLICE, device="cuda")
    res = _counted(own["detect_video"], lambda: fd.detect_video(path, os.path.join(root, "rtdetr.avi"), verbose=False))
    check(res["frames"] == VIDEO_FRAMES and video_info(os.path.join(root, "rtdetr.avi"))["num_frames"] == VIDEO_FRAMES,
          f"detect_video: {res}")
    print(f"FaceDetector.detect_video (rtdetr-l seeded, bfloat16): {res['frames'] / res['seconds']:.2f} frames/s, "
          f"{res['faces']} boxes over {res['frames']} frames")
    try:
        list(fd.detect_webcam(device=os.path.join(root, "no-camera")))
    except RuntimeError as e:
        check("webcam" in str(e), f"detect_webcam raised {e}")
        print(f"detect_webcam without a camera: RuntimeError ({e})")
    else:
        check(False, "detect_webcam without a camera did not raise")
    print(f"launches of the video runs alone: predict() rgb {own['rgb']}, dct420 {own['dct420']}, detect_video "
          f"{own['detect_video']} ({VIDEO_FRAMES} frames each)")
    check(own["rgb"]["gather_chw"] > 0 and own["dct420"]["gather_chw"] > 0,
          f"predict() on the video did not launch the CHW gather: {own}")
    return {k: sum(c[k] for c in own.values()) for k in _no_launches()}


def onnx_export_phase(torch):
    """Returns the CHW gather launches of the exported graph's run."""
    phase("33 ONNX export: golden scrfd_2.5g at 640x640 through export_torch_to_onnx, re-parsed and re-saved, "
          "run on the card against the native route")
    from facedet_tpu_torch import get_sliced_prediction
    from facedet_tpu_torch.engine.scrfd_wrapper import ScrfdDetectionModel
    from facedet_tpu_torch.models import onnx_export
    from facedet_tpu_torch.models.onnx_import import parse_onnx

    kw = dict(variant="scrfd_2.5g", dtype="float32", image_size=SLICE, confidence_threshold=0.3)
    cpu = ScrfdDetectionModel(model_path=SCRFD_CKPT, device="cpu", **kw)
    native = ScrfdDetectionModel(model_path=SCRFD_CKPT, device="cuda", **kw)
    names = [f"{k}_{s}" for k in ("score", "bbox", "kps") for s in (8, 16, 32)]
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as tmp:
        path = os.path.join(tmp, "scrfd_2.5g.onnx")
        t0 = time.perf_counter()
        graph = onnx_export.export_scrfd_onnx(cpu.model, SLICE, path)
        export_s = time.perf_counter() - t0
        reparsed = parse_onnx(path)
        check(len(reparsed.nodes) > 300 and len(reparsed.initializers) > 200,
              f"the exported SCRFD holds {len(reparsed.nodes)} nodes and {len(reparsed.initializers)} initializers")
        check(reparsed.input_names == ["input.1"] and reparsed.input_shapes["input.1"] == [1, 3, SLICE, SLICE]
              and reparsed.output_names == names, "the exported SCRFD's names or input shape")
        diff = _graph_difference(reparsed, graph)
        check(not diff, f"the file does not re-parse to the graph export_scrfd_onnx returned: {diff}")
        again = os.path.join(tmp, "resaved.onnx")
        onnx_export.save_onnx(reparsed, again)
        diff = _graph_difference(parse_onnx(again), reparsed)
        check(not diff, f"save_onnx(parse_onnx(path)) re-parses to another graph: {diff}")
        print(f"export_scrfd_onnx at {SLICE}x{SLICE}: {len(reparsed.nodes)} nodes, {len(reparsed.initializers)} "
              f"initializers, {os.path.getsize(path) / 1e6:.2f} MB in {export_s:.1f} s; save_onnx(parse_onnx(path)) "
              f"re-parses to the same graph ({os.path.getsize(again)} bytes, the file "
              f"{'equal' if open(again, 'rb').read() == open(path, 'rb').read() else 'different'} byte for byte)")
        onnx_model = ScrfdDetectionModel(model_path=path, device="cuda", **kw)
    image = _photo(560)
    want = get_sliced_prediction(image, native, **SLICED_KW).detections.to_numpy()
    check(len(want["boxes"]) > 0, "the native SCRFD found nothing")
    own = _no_launches()
    got = _counted(own, lambda: get_sliced_prediction(image, onnx_model, **SLICED_KW)).detections.to_numpy()
    _compare(got, want, "SCRFD exported through export_torch_to_onnx", ".onnx route vs native, on the card")
    check(own["gather_chw"] == 1, f"the exported graph's run launched {own}")
    return own


def _graph_difference(a, b) -> str:
    """The first difference between two OnnxGraphs, "" when they are equal."""
    import numpy as np

    def same(x, y):
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            return isinstance(x, np.ndarray) and isinstance(y, np.ndarray) and x.dtype == y.dtype \
                and np.array_equal(x, y, equal_nan=x.dtype.kind == "f")
        return x == y or (x != x and y != y)

    for field in ("name", "input_names", "output_names", "input_shapes"):
        if getattr(a, field) != getattr(b, field):
            return f"{field}: {getattr(a, field)} against {getattr(b, field)}"
    if len(a.nodes) != len(b.nodes):
        return f"{len(a.nodes)} nodes against {len(b.nodes)}"
    for x, y in zip(a.nodes, b.nodes):
        if (x.op_type, x.inputs, x.outputs, x.name) != (y.op_type, y.inputs, y.outputs, y.name) \
                or x.attrs.keys() != y.attrs.keys() or not all(same(x.attrs[k], y.attrs[k]) for k in x.attrs):
            return f"node {x} against {y}"
    if a.initializers.keys() != b.initializers.keys():
        return f"initializers {sorted(set(a.initializers) ^ set(b.initializers))[:5]}"
    for k, v in a.initializers.items():
        if not same(v, b.initializers[k]):
            return f"initializer {k}: {v.dtype}{v.shape} against {b.initializers[k].dtype}{b.initializers[k].shape}"
    return ""


@contextlib.contextmanager
def _world_of_one(torch):
    """An in-process NCCL group of one rank on cuda:0 and a (1, 1) mesh; no
    fallback to another backend: if NCCL does not start, the phase fails."""
    import torch.distributed as dist

    from facedet_tpu_torch.parallel import create_mesh

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1, device_id=torch.device("cuda", 0))
    try:
        check(dist.get_backend() == "nccl", f"the process group runs {dist.get_backend()}")
        yield create_mesh(1)
    finally:
        dist.destroy_process_group()


def multidevice_phase(torch, models, mesh):
    """Returns the launch counts of the mesh, round-robin and multidevice runs."""
    phase("34 multi-device inference at world 1 over NCCL: get_sliced_prediction(mesh=), "
          "predict_stream_batched(devices=), predict_stream_multidevice")
    import numpy as np

    from facedet_tpu_torch import get_sliced_prediction, predict_stream_batched
    from facedet_tpu_torch.parallel.eval_parallel import predict_stream_multidevice

    print(f"mesh {mesh.mesh_dim_names} of shape {tuple(mesh.mesh.shape)} on {mesh.device_type}; world 1 is the only "
          f"size one card holds, so no tile is sent anywhere")
    model = models["cuda"]
    image = _photo(570)
    own = {"mesh": _no_launches(), "stream": _no_launches(), "multidevice": _no_launches()}
    want = get_sliced_prediction(image, model, **SLICED_KW).detections.to_numpy()
    check(len(want["boxes"]) > 0, "the golden yolo11n found nothing")
    got = _counted(own["mesh"], lambda: get_sliced_prediction(image, model, mesh=mesh, **SLICED_KW))
    _compare(got.detections.to_numpy(), want, "get_sliced_prediction(mesh=create_mesh(1)) float32",
             "mesh vs no mesh, on the card")
    check(own["mesh"]["gather_chw"] == 1, f"the mesh run launched {own['mesh']}")
    ms = {"plain": [], "mesh": []}
    for _ in range(4):  # alternating blocks: the host's speed drifts within a call
        for label, kw in (("plain", {}), ("mesh", {"mesh": mesh})):
            times = []
            for _ in range(6):
                t0 = time.perf_counter()
                get_sliced_prediction(image, model, return_image=False, **SLICED_KW, **kw)
                times.append((time.perf_counter() - t0) * 1e3)
            ms[label].append(round(statistics.median(times[1:]), 3))
    print("get_sliced_prediction float32 1024x1536, ms per image (median of 5) in four alternating blocks: "
          + ", ".join(f"{k} {v}" for k, v in ms.items())
          + f"; mesh / plain of the block medians {statistics.median(ms['mesh']) / statistics.median(ms['plain']):.3f}")

    serving = models["serving"]
    pool = [_coded_photo(300 + s)[1] for s in range(8)]
    n = SERVING_BATCH * 2

    def stream(devices):
        t0 = time.perf_counter()
        out = list(predict_stream_batched((pool[i % len(pool)] for i in range(n)), serving, batch_size=SERVING_BATCH,
                                          window=3, raw=True, input_format="dct420s", devices=devices, **SERVING_KW))
        return n / (time.perf_counter() - t0), out

    two = ["cuda:0", "cuda:0"]
    stream(None)  # warm-up
    rates = {"devices=None": [], "devices=[cuda:0, cuda:0]": []}
    for turn in range(2):
        rate, single = stream(None)
        rates["devices=None"].append(rate)
        rate, multi = _counted(own["stream"], lambda: stream(two)) if turn == 0 else stream(two)
        rates["devices=[cuda:0, cuda:0]"].append(rate)
    check(len(multi) == len(single) == 2, f"{len(multi)} and {len(single)} batches")
    for b, (m, s) in enumerate(zip(multi, single)):
        check(torch.equal(m.valid, s.valid), f"batch {b}: the round-robin stream keeps other rows")
        v = s.valid
        ds = float((m.scores[v] - s.scores[v]).abs().max()) if v.any() else 0.0
        db = float((m.boxes[v] - s.boxes[v]).abs().max()) if v.any() else 0.0
        check(ds <= 1e-5 and db <= 1e-3, f"batch {b}: round-robin vs one device scores {ds}, boxes {db}")
    check(own["stream"]["gather_chw_batched"] > 0, f"the round-robin stream launched {own['stream']}")
    print(f"predict_stream_batched dct420s batch {SERVING_BATCH} window 3 bfloat16 (two entries keep the window at "
          f"max(3, 2 + 1)), {n} images per pass: images/s " + ", ".join(f"{k} {[round(r, 2) for r in v]}" for k, v in rates.items())
          + f"; {int(sum(int(x.valid.sum()) for x in multi))} detections equal in order and value")

    images = [_photo(580 + i) for i in range(8)]
    outs = _counted(own["multidevice"], lambda: list(predict_stream_multidevice(
        images, model, devices=two, raw=True, **SLICED_KW)))
    check(len(outs) == len(images), f"predict_stream_multidevice answered {len(outs)} of {len(images)} images")
    for i, (img, out) in enumerate(zip(images, outs)):
        single = get_sliced_prediction(img, model, **SLICED_KW).detections.to_numpy()
        _compare(out.to_numpy(), single, f"multidevice image {i}", "round-robin vs a single call")
    check(own["multidevice"]["gather_chw"] == len(images), f"predict_stream_multidevice launched {own['multidevice']}")
    print(f"launches of the multi-device runs alone: {own}")
    return {k: sum(c[k] for c in own.values()) for k in _no_launches()}


def sharded_train_phase(torch, mesh):
    phase(f"35 sharded training at world 1: make_sharded_train_step, yolo11n-pose {TRAIN_SIZE}x{TRAIN_SIZE}, batch "
          f"{TRAIN_BATCH}, float32 (TF32 off), against make_train_step from the same state")
    import numpy as np
    from torch.distributed.tensor import DTensor

    from facedet_tpu_torch.engine.detector import _exact_float32
    from facedet_tpu_torch.models.layers import FlaxBatchNorm2d, GroupBatchNorm2d
    from facedet_tpu_torch.train.yolo_train import (
        make_optimizer,
        make_sharded_staged_train_loop,
        make_sharded_train_step,
        make_train_step,
    )

    batch = [x.cuda() for x in _train_batch(torch, TRAIN_SIZE, TRAIN_BATCH, seed=740)]
    sgd = lambda ps: torch.optim.SGD(ps, lr=1e-2)  # noqa: E731
    plain = _golden_trainee(torch, "yolo11n", "cuda")
    before = {n: p.detach().clone() for n, p in plain.named_parameters()}
    sharded = _golden_trainee(torch, "yolo11n", "cuda")
    step, shard_state = make_sharded_train_step(sharded, sgd, mesh)
    shard_state()
    check(not any(isinstance(p, DTensor) for p in sharded.parameters()),
          "at world 1 the plan replicates every parameter; FSDP holds one")
    runs = {}
    with _exact_float32(True):
        for label, run in (("plain", make_train_step(plain, sgd(list(plain.parameters())))), ("sharded", step)):
            total, parts = run(*batch)
            model = plain if label == "plain" else sharded
            runs[label] = ({k: float(v) for k, v in parts.items()},
                           {n: (p.detach() - before[n]).cpu() for n, p in model.named_parameters()},
                           {n: b.cpu() for n, b in model.named_buffers() if "running" in n})
    part_err, upd_err, stat_err, worst = _train_errors({"cpu": runs["plain"], "cuda": runs["sharded"]})
    print(f"one SGD step, sharded against plain: loss parts {part_err:.3g} relative, parameter updates "
          f"{upd_err:.3g} of each leaf's largest ({worst}), running statistics {stat_err:.3g}")
    check(all(np.isfinite(v) for v in runs["sharded"][0].values()), f"sharded loss parts {runs['sharded'][0]}")
    check(part_err <= 1e-4, f"sharded loss parts {part_err} relative")
    check(upd_err <= 1e-3, f"sharded parameter updates {upd_err} of a leaf's largest")
    check(stat_err <= 1e-5, f"sharded BatchNorm statistics {stat_err}")

    adamw = lambda ps: make_optimizer(ps, lr=1e-4)  # noqa: E731
    plain_step = make_train_step(plain, adamw(list(plain.parameters())))
    step, shard_state = make_sharded_train_step(_golden_trainee(torch, "yolo11n", "cuda"), adamw, mesh)
    shard_state()
    # at world 1 sync_batch_statistics_ leaves the BatchNorms alone (the one
    # rank holds the global batch); here each all-reduces over the one-rank
    # dp group anyway, to read what those collectives cost per step
    bn_model = _golden_trainee(torch, "yolo11n", "cuda")
    bn_step, shard_state = make_sharded_train_step(bn_model, adamw, mesh)
    shard_state()
    bns = [m for m in bn_model.modules() if isinstance(m, FlaxBatchNorm2d)]
    for m in bns:
        m.__class__, m.group = GroupBatchNorm2d, mesh.get_group("dp")
    variants = (("plain", plain_step), ("sharded", step), ("sharded, BatchNorm all-reduce", bn_step))
    ms, launches = {}, {}
    with _exact_float32(True):
        for label, run in variants + tuple((f"{k} again", r) for k, r in variants):
            ms[label] = statistics.median(_time_steps(torch, lambda: run(*batch), n=10))  # noqa: B023
        for label, run in variants:
            launches[label] = _step_profile(torch, lambda: run(*batch), ms[label], f"AdamW {label}")[0]  # noqa: B023
        loop, shard_state = make_sharded_staged_train_loop(_golden_trainee(torch, "yolo11n", "cuda"), adamw, mesh,
                                                           steps_per_dispatch=2, flip=True)
        shard_state()
        images_u8 = torch.stack([(batch[0] * 255).round().to(torch.uint8)] * 2)
        mean = float(loop(images_u8, *(torch.stack([x] * 2) for x in batch[1:])))
    check(np.isfinite(mean), f"the sharded staged loop's mean loss {mean}")
    print("AdamW step, median of 10 after 3, ms: " + ", ".join(f"{k} {v:.3f}" for k, v in ms.items())
          + f"; kernel launches per step: {launches} ({len(bns)} BatchNorms); make_sharded_staged_train_loop, "
          f"2 steps with flip: mean loss {mean:.4f}")


# phases 36-39: the golden research loop on a synthetic reference tree
GOLDEN_IMAGES, GOLDEN_FACES = 6, 12  # photos of CANVAS, faces of 50 to 140 px each
GF_STEPS, GF_STAGED, GF_SPD, GF_PROFILED = 200, 16, 50, 5  # yolo11n-pose, 640x640, batch 8, float32
SR_L1_STEPS, SR_GAN_STEPS, SR_SPD, SR_CROPS = 100, 20, 20, 16


def goldens_phase(root):
    """Builds the tree; returns its root and the recovered goldens and
    keypoints files."""
    phase(f"36 goldens recovery (host): reference_goldens and golden_keypoints on a synthetic reference tree of "
          f"{GOLDEN_IMAGES} photos of {CANVAS[0]}x{CANVAS[1]}, {GOLDEN_FACES} faces each")
    import numpy as np

    from facedet_tpu_torch.tools.golden_keypoints import recover_all
    from facedet_tpu_torch.tools.reference_goldens import extract_goldens
    from facedet_tpu_torch.utils.synth import synthetic_reference_tree

    tree = os.path.join(root, "reference")
    t0 = time.perf_counter()
    truth = synthetic_reference_tree(tree, n_images=GOLDEN_IMAGES, hw=CANVAS, n_faces=GOLDEN_FACES,
                                     size=(50, 140), seed=36)
    t1 = time.perf_counter()
    goldens = extract_goldens(tree)
    t2 = time.perf_counter()
    check(sorted(goldens["images"]) == sorted(truth), f"recovered images {sorted(goldens['images'])}")
    worst_iou = 1.0
    for key, rec in goldens["images"].items():
        faces = {f["face_index"]: f for f in rec["faces"]}
        check(sorted(faces) == list(range(GOLDEN_FACES)), f"{key}: faces {sorted(faces)} recovered")
        for i, box in enumerate(truth[key]["boxes"]):
            iou = float(_iou(np.array([faces[i]["bbox"]], float), box[None].astype(float))[0, 0])
            worst_iou = min(worst_iou, iou)
            check(iou >= 0.9 and faces[i]["conf_lo"] == faces[i]["conf_hi"] == truth[key]["conf"][i],
                  f"{key} face {i}: IoU {iou}, conf {faces[i]['conf_hi']} against {truth[key]['conf'][i]}")
    kps = recover_all(goldens, tree)
    worst_px = 0.0
    for key, rec in kps["images"].items():
        for f in rec["faces"]:
            k = np.asarray(f["kpts"])
            check((k[:, 2] == 1).all(), f"{key} face {f['face_index']}: a landmark not found")
            worst_px = max(worst_px, float(np.abs(k[:, :2] - truth[key]["kpts"][f["face_index"]]).max()))
    check(worst_px <= 3.0, f"a recovered landmark lies {worst_px} px from its dot")
    ref = {"root": tree, "goldens": os.path.join(tree, "goldens.json"), "keypoints": os.path.join(tree, "keypoints.json")}
    for path, data in ((ref["goldens"], goldens), (ref["keypoints"], kps)):
        with open(path, "w") as f:
            json.dump(data, f)
    n = GOLDEN_IMAGES * GOLDEN_FACES
    print(f"tree written in {t1 - t0:.2f} s; extract_goldens {t2 - t1:.2f} s: {n} of {n} faces at IoU >= "
          f"{worst_iou:.3f} with their confidences; recover_all: {kps['n_keypoints_recovered']} landmarks, "
          f"the farthest {worst_px:.2f} px from its dot")
    return ref


def _ms_per_step(history) -> float:
    """Wall ms per step between the first and the last logged dispatch (the
    staging and the first dispatch's warm-up left out)."""
    (s0, _l0, t0), (s1, _l1, t1) = history[0], history[-1]
    return 1e3 * (t1 - t0) / (s1 - s0)


def _split_line(report) -> str:
    fmt = lambda v: "n/a" if v is None else f"{v:.3f}"  # noqa: E731
    return ", ".join(f"{s} recall {fmt(report[s]['recall'])} precision {fmt(report[s]['precision'])}"
                     for s in ("train_split", "held_out_split"))


@contextlib.contextmanager
def _profile_dispatch(torch, module, name, which, steps):
    """While open, dispatch ``which`` (from 0) of the staged loops that
    ``module.name(model, tx, steps_per_dispatch=...)`` makes runs as
    configured, unprofiled; then a loop of ``steps`` steps a dispatch on the
    same model and optimizer runs once on the same batches under the
    profiler (device activity only, a guarded window). Yields a dict that
    then holds its kernel ``launches`` and device-busy ``device_ms`` per
    step. The model's state, the optimizer's and the schedule's and the
    gradients are put back after it (after a window taken again too), so
    what the loop returns, trains and saves is the configured run's."""
    import copy
    import inspect

    from facedet_tpu_torch.utils.profiling import profile_kernels

    real = getattr(module, name)
    seen = {}
    count = itertools.count()

    def factory(*a, **k):
        run = real(*a, **k)
        bound = inspect.signature(real).bind(*a, **k)
        bound.apply_defaults()
        model, tx = bound.arguments["model"], bound.arguments["tx"]

        def wrapped(*args, **kw):
            result = run(*args, **kw)
            if next(count) != which:
                return result
            saved = ({key: v.clone() for key, v in model.state_dict().items()},
                     copy.deepcopy(tx.optimizer.state_dict()), tx.scheduler.state_dict(),
                     [None if p.grad is None else p.grad.clone() for p in tx.params])
            short = real(**{**bound.arguments, "steps_per_dispatch": steps})
            # flips given, so the configured loop's generator draws no more
            flips = torch.rand((steps, args[0].shape[1]), generator=torch.Generator().manual_seed(which)) < 0.5
            torch.cuda.synchronize()
            kernels = profile_kernels(lambda: short(*args, **{**kw, "flips": flips}))
            seen["launches"] = sum(e.count for e in kernels) / steps
            seen["device_ms"] = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
            model.load_state_dict(saved[0])
            tx.optimizer.load_state_dict(saved[1])
            tx.scheduler.load_state_dict(saved[2])
            for p, g in zip(tx.params, saved[3]):
                p.grad = g
            return result

        return wrapped

    setattr(module, name, factory)
    try:
        yield seen
    finally:
        setattr(module, name, real)
    check(seen.get("device_ms", 0) > 0, f"the profiler saw no device time in dispatch {which} of {name}")


def golden_finetune_phase(torch, ref, root):
    """Returns the gather launches of the four runs (parity_on_split's)."""
    phase(f"37 golden fine-tune: golden_finetune.main, yolo11n-pose {TRAIN_SIZE}x{TRAIN_SIZE} batch {TRAIN_BATCH} "
          f"float32 staged ({GF_STEPS} steps), scrfd_2.5g, rtdetr-l with the golden teacher, 2-fold CV "
          f"(launch counts from 0)")
    import numpy as np

    from facedet_tpu_torch.engine.detector import YoloV11PoseDetectionModel
    from facedet_tpu_torch.engine.rtdetr_wrapper import RtDetrDetectionModel
    from facedet_tpu_torch.engine.scrfd_wrapper import ScrfdDetectionModel
    from facedet_tpu_torch.tools import golden_finetune as gf
    from facedet_tpu_torch.train import yolo_train

    data = ["--goldens", ref["goldens"], "--ref-dir", ref["root"], "--keypoints", ref["keypoints"], "--device", "cuda",
            "--batch", str(TRAIN_BATCH), "--size", str(TRAIN_SIZE)]
    runs = {
        "yolo": ["--steps", str(GF_STEPS), "--staged", str(GF_STAGED), "--steps-per-dispatch", str(GF_SPD)],
        "scrfd": ["--model", "scrfd", "--variant", "scrfd_2.5g", "--steps", "40", "--staged", "8",
                  "--steps-per-dispatch", "20"],
        "rtdetr": ["--model", "rtdetr", "--variant", "rtdetr-l", "--teacher", CKPT, "--steps", "30", "--staged", "8",
                   "--steps-per-dispatch", "15"],
        "cv": ["--cv", "2", "--steps", "20", "--staged", "4", "--steps-per-dispatch", "10"],
    }
    launches = _no_launches()
    reports = {}
    for label, argv in runs.items():
        t0 = time.perf_counter()
        run = lambda: gf.main(argv + data + ["--out-dir", os.path.join(root, f"gf_{label}")])  # noqa: B023, E731
        if label == "yolo":
            with _profile_dispatch(torch, yolo_train, "make_staged_train_loop", GF_STEPS // GF_SPD - 1,
                                   GF_PROFILED) as profiled:
                reports[label] = _counted(launches, run)
        else:
            reports[label] = _counted(launches, run)
        print(f"{label}: golden_finetune.main in {time.perf_counter() - t0:.1f} s")

    rep = reports["yolo"]
    losses = [h[1] for h in rep["loss_history"]]
    check(all(np.isfinite(losses)) and losses[-1] < losses[0], f"yolo mean loss per dispatch {losses}")
    # the checkpoint through the .npz route gives the same parity
    det = YoloV11PoseDetectionModel(model_path=rep["checkpoint"], scale="n", dtype="float32",
                                    confidence_threshold=0.25, image_size=TRAIN_SIZE, device="cuda")
    records = gf.load_golden_dataset(ref["goldens"], ref["root"], ref["keypoints"])
    train_recs, _held = gf.split_records(records)
    with open(ref["goldens"]) as f:
        goldens = json.load(f)
    again = gf.parity_on_split(det, goldens, train_recs, ref["root"], 0.35, 0.5)
    check((again["recall"], again["precision"]) == (rep["train_split"]["recall"], rep["train_split"]["precision"]),
          f"the loaded checkpoint: {again['recall']}, {again['precision']} against {rep['train_split']}")
    # ms per step over dispatches 2-3 (the last one's time holds the
    # profiled short dispatch), launches and device busy from that one
    ms = _ms_per_step(rep["loss_history"][:-1])
    print(f"yolo11n-pose: mean loss per dispatch of {GF_SPD} steps {[round(v, 4) for v in losses]}; {ms:.3f} ms/step "
          f"({TRAIN_BATCH * 1e3 / ms:.1f} images/s) over dispatches 2-{len(losses) - 1}; a dispatch of "
          f"{GF_PROFILED} more steps under the profiler, the state put back: {profiled['launches']:.0f} kernel "
          f"launches and device busy {profiled['device_ms']:.3f} ms per "
          f"step ({100 * profiled['device_ms'] / ms:.1f}% of the ms/step); {_split_line(rep)}")
    for label, det_cls, kw in (("scrfd", ScrfdDetectionModel, dict(variant="scrfd_2.5g")),
                               ("rtdetr", RtDetrDetectionModel, dict(variant="rtdetr-l"))):
        r = reports[label]
        losses = [h[1] for h in r["loss_history"]]
        check(all(np.isfinite(losses)), f"{label} losses {losses}")
        det_cls(model_path=r["checkpoint"], dtype="float32", image_size=TRAIN_SIZE, device="cuda", **kw)
        print(f"{label}: mean loss per dispatch {[round(v, 4) for v in losses]}, {_ms_per_step(r['loss_history']):.3f} "
              f"ms/step; checkpoint loads; {_split_line(r)}")
    cv = reports["cv"]
    check(len(cv["folds"]) == 2 and cv["cv_chosen_steps"] in cv["eval_points"], f"CV report {cv['aggregate']}")
    YoloV11PoseDetectionModel(model_path=cv["final_checkpoint"], scale="n", dtype="float32", device="cuda")
    print(f"2-fold CV: eval points {cv['eval_points']}, chosen {cv['cv_chosen_steps']}, aggregate "
          f"{json.dumps(cv['aggregate'])}; the final checkpoint loads")
    check(launches["gather_chw"] > 0, "parity_on_split did not launch the CHW gather")
    print(f"launches of the four runs (parity_on_split's sliced passes): {launches}")
    return launches


def golden_eval_phase(torch, ref, root):
    """Returns the gather launches of the bfloat16 runs."""
    phase("38 golden evaluation with the committed yolo11n: golden_official_eval (standard, sahi), golden_dual_eval "
          "(four modes, --tune), golden_conf_sweep; float32 card against CPU on 2 images, then bfloat16 "
          "(launch counts from 0)")
    import types

    import numpy as np

    from facedet_tpu_torch.engine.detector import YoloV11PoseDetectionModel
    from facedet_tpu_torch.eval.widerface_official import OfficialWiderFaceEvaluator
    from facedet_tpu_torch.tools import golden_conf_sweep as gcs
    from facedet_tpu_torch.tools import golden_dual_eval as gde
    from facedet_tpu_torch.tools import golden_official_eval as goe

    with open(ref["goldens"]) as f:
        goldens = json.load(f)
    two = {"images": {k: goldens["images"][k] for k in sorted(goldens["images"])[:2]}}
    names = sorted(two["images"])
    out = lambda *p: os.path.join(root, "golden_eval", *p)  # noqa: E731

    def fidelity(side):
        """The tools' parts on a float32 detector (the tools build the
        bfloat16 one): the official protocol's APs in both modes, the dual
        evaluator's baseline and SAHI modes, the sweep's rows' counts."""
        det = YoloV11PoseDetectionModel(model_path=CKPT, scale="n", dtype="float32", bn_dtype="float32",
                                        confidence_threshold=0.25, image_size=640, device=side)
        images_path, gt_txt = goe.build_widerface_layout(two, ref["root"], out(side, "official"))
        official = {}
        for mode in ("standard", "sahi"):
            official[mode] = OfficialWiderFaceEvaluator(
                det, images_path, gt_txt=gt_txt, use_sahi=(mode == "sahi"),
                sahi_config={"slice_height": 640, "slice_width": 640, "overlap_ratio": 0.25},
                output_dir=out(side, "official", mode)).run()["aps"]
        dual_args = types.SimpleNamespace(ref_dir=ref["root"], work_dir=out(side, "dual"), min_conf=0.2,
                                          modes="baseline,sahi", weights=CKPT, commit=False)
        dual = gde.run_dual(dual_args, det, two)["modes"]
        dets = gcs.collect_detections(det, names, two, ref["root"])
        rows = [gcs.score_split(dets, names, two, c) for c in np.arange(0.20, 0.801, 0.025)]
        return official, dual, [(r["matched"], r["golden_faces"], r["predicted"]) for r in rows]

    (coff, cdual, crows), (goff, gdual, grows) = fidelity("cpu"), fidelity("cuda")
    ap_err = max(abs(goff[m][k] - v) for m in coff for k, v in coff[m].items())
    for mode in ("baseline", "sahi"):
        for key in ("subcategory_results", "difficulty_results"):
            for a, b in zip(gdual[mode][key], cdual[mode][key]):
                ap_err = max(ap_err, abs(a["ap"] - b["ap"]))
    check(ap_err <= 0.005, f"golden evaluation APs card vs CPU differ by {ap_err}")
    check(grows == crows, "the conf sweep's rows differ card vs CPU")
    print(f"float32, 2 images, card vs CPU: official and dual APs within {ap_err:.3g}; the sweep's "
          f"{len(grows)} rows equal in counts; official sahi AP {goff['sahi']['all']:.4f}")

    launches = _no_launches()
    data = ["--goldens", ref["goldens"], "--ref-dir", ref["root"], "--device", "cuda"]
    seconds = {}

    def timed(label, run):
        t0 = time.perf_counter()
        res = _counted(launches, run)
        seconds[label] = time.perf_counter() - t0
        return res

    off = timed("golden_official_eval", lambda: goe.main(data + ["--work-dir", out("official")]))
    dual = timed("golden_dual_eval --tune", lambda: gde.main(data + ["--tune", "--work-dir", out("dual")]))
    sweep = timed("golden_conf_sweep", lambda: gcs.main(data + ["--weights", CKPT, "--out", out("sweep.json")]))
    for mode, r in off["modes"].items():
        check(0.0 <= r["aps"]["all"] <= 1.0, f"official {mode}: AP {r['aps']}")
        print(f"official {mode}: AP {r['aps']['all']:.4f}, {r['images_per_second']:.2f} images/s")
    check(off["modes"]["sahi"]["aps"]["all"] > 0.5, "the golden yolo11n matched few synthetic faces through SAHI")
    for mode, res in dual["dual"]["modes"].items():
        rows = {r["category"]: round(r["ap"], 4) for r in res["difficulty_results"]}
        print(f"dual {mode}: easy/medium/hard APs {rows}")
    errors = [r["errors"] for r in dual["tuning"]["results"]]
    check(len(dual["dual"]["modes"]) == 4 and errors == [0] * 4, f"dual modes {list(dual['dual']['modes'])}, errors {errors}")
    check(sweep["chosen"] is not None, "the sweep chose no operating point")
    print(f"tuning grid 'quick': errors {errors}, best {dual['tuning']['best']['slice_size']}; sweep chosen conf "
          f"{sweep['chosen']['conf']}: held-out {sweep['chosen']['held_out']}")
    n = GOLDEN_IMAGES
    print("bfloat16 seconds per tool: " + ", ".join(f"{k} {v:.2f} s" for k, v in seconds.items())
          + f"; images per second over {n} images: official (2 modes) {2 * n / seconds['golden_official_eval']:.2f}, "
          f"dual (4 modes + 4 grid configurations) {8 * n / seconds['golden_dual_eval --tune']:.2f}, sweep "
          f"{n / seconds['golden_conf_sweep']:.2f}")
    check(launches["gather_chw"] > 0, "the golden evaluation did not launch the CHW gather")
    print(f"launches of the bfloat16 runs: {launches}")
    return launches


def sr_golden_phase(torch, ref, root):
    """Returns the gather launches of process_single_image."""
    phase(f"39 SR golden loop and UI: sr_golden_train x2plus ({SR_HR} HR, batch {SR_BATCH}) {SR_L1_STEPS} L1 + "
          f"{SR_GAN_STEPS} GAN steps, sr_cascade_eval both arms, iqa_train.main, process_single_image "
          f"(launch counts from 0), FaceVisualizer")
    import importlib.util

    import numpy as np

    from facedet_tpu_torch.apps.streamlit_app import process_single_image
    from facedet_tpu_torch.engine.detector import YoloV11PoseDetectionModel
    from facedet_tpu_torch.eval import iqa_train
    from facedet_tpu_torch.tools import sr_cascade_eval as sce
    from facedet_tpu_torch.tools import sr_golden_train as sgt
    from facedet_tpu_torch.utils.viz import load_image
    from facedet_tpu_torch.utils.viz_mpl import FaceVisualizer

    out = lambda *p: os.path.join(root, "sr_golden", *p)  # noqa: E731
    data = ["--goldens", ref["goldens"], "--ref-dir", ref["root"], "--device", "cuda"]
    t0 = time.perf_counter()
    rep = sgt.main(data + ["--steps", str(SR_L1_STEPS), "--staged", str(SR_SPD), "--batch", str(SR_BATCH),
                           "--hr-size", str(SR_HR), "--patches", "512", "--gan-steps", str(SR_GAN_STEPS),
                           "--gan-percep-weight", "0.1", "--max-crops", str(SR_CROPS), "--out", out("x2.npz"),
                           "--report", out("sr_report.json")])
    losses = [h[1] for h in rep["loss_history"]]
    check(all(np.isfinite(losses)) and losses[-1] < losses[0], f"SR L1 loss per call {losses}")
    check(all(np.isfinite(v) for v in rep["gan"]["final"].values()), f"GAN metrics {rep['gan']['final']}")
    fid = rep["fidelity_holdout"]
    check(all(np.isfinite(r["psnr_restored"]) for r in fid), f"fidelity {fid}")
    ov = rep["iqa_face_crops"]["overall"]
    print(f"sr_golden_train.main in {time.perf_counter() - t0:.1f} s: L1 loss per call {[round(v, 4) for v in losses]} "
          f"({_ms_per_step(rep['loss_history']):.3f} ms/step), GAN {rep['gan']['final']} in {rep['gan']['seconds']} s; "
          f"held-out PSNR restored / bicubic " + ", ".join(f"{r['psnr_restored']:.2f}/{r['psnr_bicubic']:.2f}" for r in fid)
          + f" dB; IQA on {ov['n']} crops: NIQE {ov['niqe_orig']:.3f}->{ov['niqe_enhanced']:.3f}, BRISQUE "
          f"{ov['brisque_orig']:.3f}->{ov['brisque_enhanced']:.3f}, TOPIQ {ov['topiq_face_orig']:.3f}->"
          f"{ov['topiq_face_enhanced']:.3f}")
    for arm in ("cascade", "x2resize"):
        t0 = time.perf_counter()
        casc = sce.main(data + ["--arm", arm, "--weights", out("x2.npz"), "--max-crops", str(SR_CROPS),
                                "--report", out(f"{arm}.json")])
        rows = casc["fidelity_holdout"]
        check(len(rows) == 3 and all(np.isfinite(r["psnr_restored"]) for r in rows), f"{arm}: {rows}")
        print(f"sr_cascade_eval --arm {arm} in {time.perf_counter() - t0:.1f} s: PSNR restored / bicubic "
              + ", ".join(f"{r['psnr_restored']:.2f}/{r['psnr_bicubic']:.2f}" for r in rows)
              + f" dB; IQA overall {casc['iqa_face_crops']['overall']}")
    t0 = time.perf_counter()
    fit = iqa_train.main(["--out-dir", out("iqa"), "--ref-dir", ref["root"], "--goldens", ref["goldens"]])
    check(fit["niqe_photos"] == GOLDEN_IMAGES, f"iqa_train fitted NIQE on {fit['niqe_photos']} photos")
    print(f"iqa_train.main in {time.perf_counter() - t0:.1f} s: NIQE on the {fit['niqe_photos']} golden photos, "
          f"BRISQUE regressor rmse {fit['rmse']:.2f} over {fit['n']}")

    det = YoloV11PoseDetectionModel(model_path=CKPT, scale="n", image_size=SLICE, device="cuda")
    names = sorted(json.load(open(ref["goldens"]))["images"])
    img = load_image(os.path.join(ref["root"], names[0], "temp_sahi_input.jpg"))
    launches = _no_launches()
    process_single_image(img, det, enable_sahi=True, confidence=0.25, with_iqa=False)  # cuDNN plans
    t0 = time.perf_counter()
    res = _counted(launches, lambda: process_single_image(img, det, enable_sahi=True, confidence=0.25,
                                                          output_dir=out("ui")))
    check(res["num_faces"] > 0 and len(res["crop_paths"]) == res["num_faces"] and res["annotated"].shape == img.shape,
          f"process_single_image: {res['num_faces']} faces, {len(res['crop_paths'])} crops")
    print(f"process_single_image (SAHI, bfloat16, IQA on): {res['num_faces']} faces in "
          f"{time.perf_counter() - t0:.2f} s (detection {res['timings']['detection'] * 1e3:.1f} ms); launches {launches}")
    vis = FaceVisualizer()
    preds = res["result"].object_prediction_list
    saved = vis.save_face_crops(img, preds, out("mpl_crops"))
    check(len(saved) == len(preds), f"FaceVisualizer saved {len(saved)} of {len(preds)} crops")
    if importlib.util.find_spec("matplotlib") is None:
        print("matplotlib is not installed on this machine: FaceVisualizer.draw_detections not driven "
              "(save_face_crops and create_detection_summary were)")
    else:
        drawn = vis.draw_detections(img, preds)
        check(drawn.shape[2] == 3 and drawn.shape[0] > 0, f"FaceVisualizer drew {drawn.shape}")
        print(f"FaceVisualizer.draw_detections: {drawn.shape}; {len(saved)} crops saved")
    vis.create_detection_summary({"num_faces": len(preds), "detections": []})
    check(launches["gather_chw"] > 0, "process_single_image did not launch the CHW gather")
    return launches


# phases 40-45: the bfloat16 sharded step, the profile tools and the probes
# tests/test_torch_parallel_train_bf16.py's gates for a bfloat16 step, derived
# from the port's single-process bfloat16 step against JAX's: the loss and
# the parts relative, the gradient as the norm of the difference over the
# norm, over all leaves (bfloat16 rounding moves a gradient by a third of
# its norm: JAX against itself one float32 ulp of input apart)
BF16_LOSS_GATE, BF16_PART_GATE, BF16_GRAD_GATE = 5e-3, 5e-2, 0.8
STAGE_NOISE_REL, STAGE_NOISE_MS = 0.05, 0.05  # phase 41: a cumulative row may fall by this much


def sharded_bf16_phase(torch, mesh):
    phase(f"40 sharded training with a bfloat16 config at world 1: make_sharded_train_step, yolo11n-pose "
          f"{TRAIN_SIZE}x{TRAIN_SIZE}, batch {TRAIN_BATCH}, against make_train_step's bfloat16 step")
    import numpy as np

    from facedet_tpu_torch.train.yolo_train import make_optimizer, make_sharded_train_step, make_train_step

    batch = [x.cuda() for x in _train_batch(torch, TRAIN_SIZE, TRAIN_BATCH, seed=740)]
    lr = 1e-2
    sgd = lambda ps: torch.optim.SGD(ps, lr=lr)  # noqa: E731
    plain = _golden_trainee(torch, "yolo11n", "cuda", "bfloat16")
    before = {n: p.detach().clone() for n, p in plain.named_parameters()}
    sharded = _golden_trainee(torch, "yolo11n", "cuda", "bfloat16")
    step, shard_state = make_sharded_train_step(sharded, sgd, mesh)
    shard_state()
    runs = {}
    for label, run, model in (("plain", make_train_step(plain, sgd(list(plain.parameters()))), plain),
                              ("sharded", step, sharded)):
        total, parts = run(*batch)
        runs[label] = (float(total), {k: float(v) for k, v in parts.items()},
                       {n: (p.detach() - before[n]) / -lr for n, p in model.named_parameters()})
    check(all(p.dtype == torch.float32 for p in sharded.parameters()), "the sharded step's parameters left float32")
    (loss0, parts0, g0), (loss1, parts1, g1) = runs["plain"], runs["sharded"]
    loss_err = abs(loss1 - loss0) / abs(loss0)
    part_err = max(abs(parts1[k] - v) / abs(v) for k, v in parts0.items() if v)
    num = sum(float((g1[n] - g).double().square().sum()) for n, g in g0.items())
    grad_err = (num / sum(float(g.double().square().sum()) for g in g0.values())) ** 0.5
    print(f"one SGD step (lr {lr}), sharded against plain, bfloat16 config: loss {loss_err:.3g} relative, parts "
          f"{part_err:.3g}, gradient (the update over lr) {grad_err:.3g} of its norm")
    check(np.isfinite(loss1) and loss_err <= BF16_LOSS_GATE, f"loss {loss1} vs {loss0}")
    check(part_err <= BF16_PART_GATE, f"loss parts {part_err} relative")
    check(grad_err <= BF16_GRAD_GATE, f"gradient {grad_err} of its norm")

    adamw = lambda ps: make_optimizer(ps, lr=1e-4)  # noqa: E731
    model = _golden_trainee(torch, "yolo11n", "cuda", "bfloat16")
    variants = {"plain": make_train_step(model, adamw(list(model.parameters())))}
    variants["sharded"], shard_state = make_sharded_train_step(_golden_trainee(torch, "yolo11n", "cuda", "bfloat16"),
                                                               adamw, mesh)
    shard_state()
    times = {label: [] for label in variants}
    for label in ("plain", "sharded", "sharded", "plain"):  # in turns: the host's speed drifts
        times[label] += _time_steps(torch, lambda: variants[label](*batch), n=10)  # noqa: B023
    ms = {label: statistics.median(t) for label, t in times.items()}
    out = {}
    for label, run in variants.items():
        launches, device_ms = _step_profile(torch, lambda: run(*batch), ms[label], f"bfloat16 AdamW {label}")  # noqa: B023
        out[label] = {"ms": ms[label], "launches": launches, "device_ms": device_ms, "busy": device_ms / ms[label]}
    print("bfloat16 AdamW step, median of 20 (two runs of 10 after 3, in turns): " + "; ".join(
        f"{k} {v['ms']:.3f} ms, {v['launches']:.0f} launches, device {v['device_ms']:.3f} ms, busy "
        f"{100 * v['busy']:.1f}%" for k, v in out.items()))
    return out


def profile_stages_phase(torch):
    """Returns the batched gather's launches in the tool's run."""
    phase("41 tools/profile_stages.main(): yolo11s-pose (seeded), bfloat16, batch 8 of 1024x1536 dct420s "
          "(launch counts from 0)")
    from facedet_tpu_torch.engine.predict import _on_device, batch_core
    from facedet_tpu_torch.ops.jpeg_dct import encode_dct420
    from facedet_tpu_torch.tools import profile_stages as ps
    from facedet_tpu_torch.utils.profiling import device_time, format_row, per_unit
    from facedet_tpu_torch.utils.synth import bench_image

    launches = _no_launches()
    res = _counted(launches, ps.main)
    rows = res["rows"]
    prev = 0.0
    for stage in ps.STAGES:
        cur = rows[stage]["device_ms"]
        check(cur is not None and cur > 0, f"{stage}: no device time")
        check(cur >= prev * (1 - STAGE_NOISE_REL) - STAGE_NOISE_MS,
              f"cumulative device ms fell at {stage}: {cur:.3f} after {prev:.3f}")
        prev = cur
    check(launches["gather_chw_batched"] > 0, f"profile_stages launched no batched gather: {launches}")
    # batch_core itself on the same wire, the model built as the tool builds it
    from facedet_tpu_torch.engine.detector import YoloV11PoseDetectionModel

    model = YoloV11PoseDetectionModel(scale="s", dtype="bfloat16", confidence_threshold=0.25, image_size=640,
                                      max_detections_per_tile=300, device="cuda")
    planes = encode_dct420(bench_image(1024, 1536), quality=90)
    plan, wire, consts = ps.stage_inputs(model, [planes] * 8, **ps.SERVING)
    with torch.inference_mode(), _on_device(model.device):
        direct = per_unit(device_time(lambda: batch_core(model, plan, wire, consts), device="cuda"), 8)
    print(format_row("batch_core (direct)", direct, "img"))
    full = rows["full"]["device_ms"]
    check(abs(full - direct["device_ms"]) <= 0.15 * direct["device_ms"],
          f"the full row's {full:.3f} device ms/img against batch_core's {direct['device_ms']:.3f}")
    print(f"the full row against batch_core: {full:.3f} against {direct['device_ms']:.3f} device ms/img; "
          f"batched gather launches in the tool's run {launches['gather_chw_batched']}")
    return launches


def profile_layers_modules_phase(torch):
    phase("42 tools/profile_layers.main(): yolo11s-pose (seeded), bfloat16, 42 tiles of 640x640")
    import numpy as np

    from facedet_tpu_torch.engine.detector import YoloV11PoseDetectionModel
    from facedet_tpu_torch.tools import profile_layers as pl
    from facedet_tpu_torch.tools import profile_modules as pm
    from facedet_tpu_torch.utils.profiling import device_time, format_row, per_unit

    res = pl.main()
    check(all(r["device_ms"] > 0 for r in res["rows"].values()), "a layer prefix saw no device time")
    model = YoloV11PoseDetectionModel(scale="s", dtype="bfloat16", confidence_threshold=0.25, image_size=640,
                                      max_detections_per_tile=300, device="cuda").model
    x = torch.from_numpy(np.random.default_rng(0).random((42, 640, 640, 3), np.float32)).permute(0, 3, 1, 2).cuda()
    with torch.inference_mode():
        direct = per_unit(device_time(model.forward_nchw, x), 42)
    print(format_row("forward_nchw (direct)", direct, "tile"))
    last = res["rows"][pl.STEPS[-1]]["device_ms"]
    check(abs(last - direct["device_ms"]) <= 0.15 * direct["device_ms"],
          f"the last prefix's {last:.4f} device ms/tile against forward_nchw's {direct['device_ms']:.4f}")
    phase("43 tools/profile_modules.main(): yolo11s-pose sections (seeded), bfloat16, 48 tiles of 640x640")
    mods = pm.main()
    check(all(r["device_ms"] > 0 for r in mods["rows"].values()), "a module saw no device time")
    return res, mods


def profile_sr_layers_phase(torch):
    phase("44 tools/profile_sr_layers.main(): RRDB layers at 512x768, bfloat16")
    from facedet_tpu_torch.tools import profile_sr_layers as psl

    res = psl.main()
    for label, row in res["rows"].items():
        check(row["device_ms"] > 0, f"{label}: no device time")
        if row["peak_share"] is not None:
            check(row["peak_share"] < 1.0, f"{label}: {row['tflops']:.1f} TFLOP/s is over the peak: a wrong count")
    rows = res["rows"]
    print(f"RDB: concat {rows['rdb_concat']['device_ms']:.3f} ms, sum of convs {rows['rdb_sum']['device_ms']:.3f}, "
          f"elementwise {rows['elementwise']['device_ms']:.3f}; 69 RDBs {res['body_69_rdb_ms']:.1f} ms")
    return res


def probes_phase(torch):
    """Returns the gather launches of the probes."""
    phase("45 the six probes at their defaults: rgb stage, idct layout, unpack fusion, stream window, SR tiling, "
          "SR end to end (fifteen turns; launch counts from 0)")
    from facedet_tpu_torch.tools import (
        probe_idct_layout,
        probe_rgb_stage,
        probe_sr_e2e,
        probe_sr_tiling,
        probe_stream_window,
        probe_unpack_fusion,
    )

    launches = _no_launches()
    rgb = probe_rgb_stage.main()
    d = rgb["max_abs_vs_current"]
    check(d["planar_fma"] <= 0.02, f"planar_fma against current {d['planar_fma']} (bfloat16)")
    check(d["nearest_fma"] > 0.05, f"nearest_fma against current {d['nearest_fma']}: not fidelity-changing?")
    idct = probe_idct_layout.main()
    d = idct["max_abs_vs_current"]
    check(d["separable"] <= 1e-2 and d["bf16_matmul"] <= 4.0, f"idct variants against the production decode {d}")
    unpack = probe_unpack_fusion.main()
    check(all(unpack["planes_equal"].values()), f"unpack variants' planes {unpack['planes_equal']}")
    window = _counted(launches, probe_stream_window.main)
    check(window["same_results"], "the stream windows' results differ")
    tiling = _counted(launches, probe_sr_tiling.main)
    check(tiling["vs_whole"]["planned"]["max"] <= 1 / 255, f"planned against whole {tiling['vs_whole']['planned']}")
    check(tiling["vs_whole"]["legacy4x420"]["max"] < 1.0, f"legacy against whole {tiling['vs_whole']['legacy4x420']}")
    e2e = _counted(launches, lambda: probe_sr_e2e.main(["--n", "15"]))
    check(e2e["same_bytes"], "the staged SR cycle wrote other bytes than enhance_to_jpeg")
    # the staged cycles against the end-to-end ones over fifteen turns: where no
    # native JPEG writer is built the cycle is mostly host work, whose speed
    # varies from one cycle to the next by a tenth and more
    check(abs(e2e["staged_over_e2e"] - 1.0) <= 0.1,
          f"the SR stages add up to {e2e['staged_over_e2e']:.4f} of the end-to-end cycle over the turns "
          f"{e2e['cycles_ms']} (medians {e2e['sum_ms']:.1f} ms against {e2e['e2e_ms']:.1f})")
    check(launches["gather_chw"] > 0, f"the SR probes launched no CHW gather: {launches}")
    print(f"probes: stream windows img/s {window['images_per_s']}; SR stages {e2e['stages_ms']}; launches {launches}")
    return launches


INT8_PEAK_OPS = 1979e12  # H100 SXM dense int8, NVIDIA data sheet
BF16_PARITY_GATE = 0.05  # |recall| and |precision| of bfloat16 against float32: 3 faces of phase 36's 72


def int8_conv_phase(torch, smi):
    phase("46 probe_int8_conv at the JAX tool's three shapes: a raw 3x3 conv in bfloat16 against int8, the int8 "
          "im2col and GEMM apart")
    import numpy as np
    import torch.nn.functional as F

    from facedet_tpu_torch.engine.detector import _exact_float32
    from facedet_tpu_torch.tools import probe_int8_conv as pic

    rng = np.random.default_rng(46)
    with torch.inference_mode():
        for b, h, w, cin, cout in pic.SHAPES:
            xf, kf, xi, ki = pic.make_inputs(rng, 1, h, w, cin, cout)  # one tile of the shape
            got = pic.conv_int8(*pic.int8_operands(xi, ki, "cuda"), cout).cpu()
            want = pic.conv_int8(*pic.int8_operands(xi, ki, "cpu"), cout)
            check(got.dtype == torch.int32 and torch.equal(got, want),
                  f"int8 conv [{h}x{w}x{cin}->{cout}]: the card's int32 output is not the CPU's")
            xb, kb = pic.bf16_operands(xf, kf, "cuda")
            bf = pic.conv_bf16(xb, kb).float()
            with _exact_float32(True):  # TF32 off
                ref = F.conv2d(xb.float(), kb.float(), padding=1)
            # half an ulp of the bfloat16 result, plus the float32 sums' order
            err = (bf - ref).abs()
            bound = 2**-8 * ref.abs() + 2**-12 * ref.abs().max()
            check(bool((err <= bound).all()), f"bf16 conv [{h}x{w}x{cin}->{cout}]: {float(err.max())} from float32 "
                  f"(bound {float(bound.max())})")
            print(f"[1x{h}x{w}x{cin}->{cout}]: int8 exact against the CPU; bfloat16 within {float(err.max()):.4g} "
                  f"of float32 (largest |ref| {float(ref.abs().max()):.4g})")
    res = pic.main()
    for tag, rows in res["rows"].items():
        t = res["tops"][tag]
        print(f"{tag}: bf16 {rows['bf16']['device_ms']:.4f} ms {t['bf16']:.1f} TFLOP/s "
              f"({100 * t['bf16'] * 1e12 / BF16_FLOPS_PER_S:.1f}% of 989); int8 {rows['int8']['device_ms']:.4f} ms "
              f"{t['int8']:.1f} TOP/s ({100 * t['int8'] * 1e12 / INT8_PEAK_OPS:.1f}% of 1,979; im2col "
              f"{rows['im2col']['device_ms']:.4f} ms, GEMM {rows['gemm']['device_ms']:.4f} ms, {t['gemm']:.1f} TOP/s "
              f"{100 * t['gemm'] * 1e12 / INT8_PEAK_OPS:.1f}%); int8 / bf16 device time "
              f"{rows['int8']['device_ms'] / rows['bf16']['device_ms']:.2f} on {smi}")
    return res


def int8_yolo_phase(torch, ref):
    """Returns the gather launches of the probe and the float32 parity run."""
    phase("47 probe_int8_yolo on the golden yolo11n and phase 36's synthetic tree: parity bfloat16 and int8, "
          "tile_forward_nchw on 42 tiles (launch counts from 0)")
    from facedet_tpu_torch import YoloV11PoseDetectionModel
    from facedet_tpu_torch.tools import golden_finetune as gf
    from facedet_tpu_torch.tools import probe_int8_yolo as piy

    launches = _no_launches()
    scored = []
    real = gf.parity_on_split

    def recorded(*a, **k):
        out = real(*a, **k)
        scored.append(len(out["images"]))
        return out

    gf.parity_on_split = recorded
    try:
        rep = _counted(launches, lambda: piy.main(["--goldens", ref["goldens"], "--ref-dir", ref["root"],
                                                   "--keypoints", ref["keypoints"]]))
    finally:
        gf.parity_on_split = real
    check(rep["quantized_convs"] == JAX_INT8_CONVS,
          f"{rep['quantized_convs']} quantized convs, the JAX package quantizes {JAX_INT8_CONVS}")
    check(scored == [GOLDEN_IMAGES, GOLDEN_IMAGES], f"the two parity arms scored {scored} of {GOLDEN_IMAGES} images")
    det32 = YoloV11PoseDetectionModel(model_path=CKPT, scale="n", dtype="float32", confidence_threshold=0.25,
                                      image_size=SLICE, device="cuda")
    with open(ref["goldens"]) as f:
        goldens = json.load(f)
    records = gf.load_golden_dataset(ref["goldens"], ref["root"], ref["keypoints"], min_conf=0.2)
    r32 = _counted(launches, lambda: real(det32, goldens, records, ref["root"], 0.35, 0.5))
    bf, q = rep["parity"]["bf16"], rep["parity"]["int8"]
    for key in ("recall", "precision"):
        check(abs(bf[key] - r32[key]) <= BF16_PARITY_GATE,
              f"bfloat16 {key} {bf[key]:.4f} against float32 {r32[key]:.4f} (gate {BF16_PARITY_GATE})")
    d = rep["device"]
    check(d["bf16_ms_per_batch"] and d["int8_ms_per_batch"], f"no device time in {d}")
    print(f"parity (conf 0.35, IoU 0.5): float32 recall {r32['recall']:.4f} precision {r32['precision']:.4f}; "
          f"bfloat16 {bf['recall']:.4f} {bf['precision']:.4f}; int8 {q['recall']:.4f} {q['precision']:.4f} "
          f"(no float gate: ROADMAP.md §3 item 3); tile_forward_nchw on {d['tiles']} tiles: bfloat16 "
          f"{d['bf16_ms_per_batch']} device ms ({d['bf16_wall_ms_per_batch']} wall), int8 {d['int8_ms_per_batch']} "
          f"({d['int8_wall_ms_per_batch']}), speedup {d['speedup']}; launches {launches}")
    return launches


def upload_phase(torch):
    phase("48 probe_upload_pack at its defaults: 64 images of 1024x1536 in dct420s, six uploads against one wire "
          "from pageable memory")
    from facedet_tpu_torch.tools import probe_upload_pack as pup

    launches = _reset_launches()
    res = pup.main()
    check(res["memory"] == "pageable" and all(res["readback_equal"].values()),
          f"an arm's uploaded bytes read back other than the host's: {res['readback_equal']}")
    check(not any(launches.values()), f"the upload probe launched a gather: {launches}")
    print(f"medians (s per batch of 64, wire {res['wire_bytes'] / 1e6:.2f} MB): "
          f"{json.dumps(res['median_s'])}; the serving path's pinned one-wire upload: phase 8")
    return res


def api_phase(torch):
    """Returns the HWC gather launches of ``pad_image`` then ``gather_tiles``."""
    phase("49 the public API ported last, on the card against the CPU: boxes, Detections.from_arrays, "
          "batched_empty, pad_image into the HWC gather, attach_keypoints_to_predictions, create_yolo")
    import numpy as np

    from facedet_tpu_torch.core import boxes as B
    from facedet_tpu_torch.core.detections import Detections, batched_empty
    from facedet_tpu_torch.engine.detector import attach_keypoints_to_predictions
    from facedet_tpu_torch.engine.prediction import ObjectPrediction
    from facedet_tpu_torch.models.yolov11 import YoloConfig, create_yolo
    from facedet_tpu_torch.ops.tiler import gather_tiles, pad_image

    rng = np.random.default_rng(49)
    xy = rng.uniform(0, 1400, (64, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + rng.uniform(1, 120, (64, 2)).astype(np.float32)], 1)
    other = boxes[::-1].copy()
    shifts = rng.uniform(0, 900, (2, 64)).astype(np.float32)  # one (x, y) shift per box
    sides = {}
    for dev in ("cuda", "cpu"):
        b, o = torch.from_numpy(boxes).to(dev), torch.from_numpy(other).to(dev)
        sx, sy = torch.from_numpy(shifts).to(dev)
        sides[dev] = {name: getattr(B, name)(b) for name in
                      ("xyxy_to_xywh", "xywh_to_xyxy", "xyxy_to_cxcywh", "cxcywh_to_xyxy")}
        sides[dev].update(shift=B.shift_boxes(b, 12.5, -3.0), shift_each=B.shift_boxes(b, sx, sy),
                          scale=B.scale_boxes(b, 0.5), union=B.union_boxes(b, o))
        det = Detections.from_arrays(b, b[:, 0], capacity=100)
        sides[dev].update({f"from_arrays.{f}": getattr(det, f) for f in ("boxes", "scores", "classes", "kpts", "valid")})
        empty = batched_empty(4, 300, device=dev)
        sides[dev].update({f"batched_empty.{f}": getattr(empty, f) for f in ("boxes", "kpts", "valid")})
    for name, got in sides["cuda"].items():
        check(got.device.type == "cuda" and torch.equal(got.cpu(), sides["cpu"][name]),
              f"{name}: the card's result is not the CPU's")
    image = rng.random((CANVAS[0] - 24, CANVAS[1] - 36, 3)).astype(np.float32)
    offsets = torch.from_numpy(production_offsets())
    launches = _reset_launches()
    tiles = gather_tiles(pad_image(torch.from_numpy(image).cuda(), *CANVAS), offsets.cuda(), SLICE, SLICE).cpu()
    hwc = launches["gather_hwc"]
    want = gather_tiles(pad_image(torch.from_numpy(image), *CANVAS), offsets, SLICE, SLICE)
    check(hwc == 1 and torch.equal(tiles, want), f"pad_image into the HWC gather: {hwc} launches, equal "
          f"{torch.equal(tiles, want)}")
    cache = {tuple(round(float(v), 1) for v in row): rng.random((5, 3)) for row in boxes[:32]}
    kpts = {}
    for dev in ("cuda", "cpu"):
        b = torch.from_numpy(boxes).to(dev)  # as cached (the exact key), then moved (the IoU scan)
        rows = torch.cat([b, B.shift_boxes(b, 0.3, -0.2)]).cpu().tolist()
        preds = attach_keypoints_to_predictions([ObjectPrediction(r, 0.9) for r in rows], cache)
        kpts[dev] = [p.keypoints for p in preds]
    check(all((a is None and b is None) or (a is not None and b is not None and np.array_equal(a, b))
              for a, b in zip(kpts["cuda"], kpts["cpu"])) and sum(k is not None for k in kpts["cuda"]) >= 64,
          "attach_keypoints_to_predictions: the card's boxes got other keypoints than the CPU's")
    cfg = YoloConfig(scale="n")
    on_card, on_cpu = create_yolo(cfg, seed=49).state_dict(), create_yolo(cfg, seed=49, device="cpu").state_dict()
    check(on_card.keys() == on_cpu.keys() and all(torch.equal(on_card[k].cpu(), on_cpu[k]) for k in on_cpu),
          "create_yolo on the card holds other weights than on the CPU")
    print(f"{len(sides['cuda'])} results equal card against CPU; pad_image {image.shape[:2]} -> {CANVAS} then "
          f"gather_tiles: {hwc} HWC launch, tiles equal; {sum(k is not None for k in kpts['cuda'])} of "
          f"{2 * len(boxes)} predictions given keypoints on both; create_yolo's {len(on_cpu)} tensors equal")
    return {"gather_hwc": hwc}


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
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    eval_root = tempfile.mkdtemp(dir=os.path.join(REPO, "build"))
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
        f32 = sr_fidelity_phase(torch)
        served, enh_launches = sr_main_path_phase(torch, f32)
        counts["gather_chw@2048x3072"] = pipeline_v2_phase(torch, models, f32, served)
        pipeline_v1_phase(torch, models, f32, served)
        enh_counts = dict(enh_launches)  # read before a later phase sets the counts to 0
        check(enh_counts["gather_chw"] > 0, "the enhancement main path did not launch the CHW gather")
        print(f"launches on the enhancement main path: {enh_counts} (window gathers of tiled_sr and "
              f"the detections of pipelines v1 and v2; the v2 canvas: {counts['gather_chw@2048x3072']})")
        check(all(os.path.exists(p) for p in (CKPT, NIQE_ASSET, BRISQUE_ASSET)),
              "a committed asset of the evaluation phases is missing from the checkout")
        ev = widerface_layout(eval_root)
        cli_results = cli_phase(ev)
        scrfd_pair = scrfd_fidelity_phase(torch)
        family_counts = {"scrfd": scrfd_main_path_phase(torch), "rtdetr": rtdetr_phase(torch)}
        onnx_phase(torch, scrfd_pair, models)
        topiq_phase(torch)
        det, official_launches = official_eval_phase(torch, models, served, ev, cli_results)
        family_counts["evaluation"] = {"gather_chw": official_launches + dual_tuning_phase(torch, det, ev, cli_results)}
        iqa_phase(ev)
        train_fidelity_phase(torch)
        train_main_path_phase(torch)
        learning_phase(torch, eval_root)
        detr_sr_fidelity_phase(torch)
        detr_sr_main_path_phase(torch)
        detr_sr_learning_phase(torch, eval_root)
        conversion_phase(torch, eval_root)
        family_counts["int8"] = int8_phase(torch, models)
        family_counts["video"] = video_phase(torch, models, eval_root)
        family_counts["onnx export"] = onnx_export_phase(torch)
        with _world_of_one(torch) as mesh:
            family_counts["multi-device"] = multidevice_phase(torch, models, mesh)
            sharded_train_phase(torch, mesh)
        ref = goldens_phase(eval_root)
        family_counts["golden fine-tune"] = golden_finetune_phase(torch, ref, eval_root)
        family_counts["golden evaluation"] = golden_eval_phase(torch, ref, eval_root)
        family_counts["golden SR and UI"] = sr_golden_phase(torch, ref, eval_root)
        with _world_of_one(torch) as mesh:
            sharded_bf16_phase(torch, mesh)
        counts["gather_chw_batched"] += profile_stages_phase(torch)["gather_chw_batched"]
        profile_layers_modules_phase(torch)
        profile_sr_layers_phase(torch)
        family_counts["probes"] = probes_phase(torch)
        int8_conv_phase(torch, smi)
        family_counts["int8 probe"] = int8_yolo_phase(torch, ref)
        upload_phase(torch)
        counts["gather_hwc"] += api_phase(torch)["gather_hwc"]
        for family, c in family_counts.items():
            check(c["gather_chw"] > 0, f"the {family} main path did not launch the CHW gather")
            for name, n in c.items():
                counts[name] = counts.get(name, 0) + n
        print(f"launches on the evaluation paths (phases 21, 22): {family_counts['evaluation']}; int8 (phase 31): "
              f"{family_counts['int8']}; video (phase 32): {family_counts['video']}; ONNX export (phase 33): "
              f"{family_counts['onnx export']}; multi-device (phase 34): {family_counts['multi-device']}; golden "
              f"fine-tune (phase 37): {family_counts['golden fine-tune']}; golden evaluation (phase 38): "
              f"{family_counts['golden evaluation']}; golden SR and UI (phase 39): {family_counts['golden SR and UI']}; "
              f"probes (phase 45): {family_counts['probes']}; int8 probe (phase 47): {family_counts['int8 probe']}")
        check(family_counts["scrfd"]["gather_chw_batched"] > 0, "SCRFD's batch did not launch the batched gather")
        check(family_counts["multi-device"]["gather_chw_batched"] > 0,
              "the round-robin stream did not launch the batched gather")
        for k in KERNELS:
            check(counts[k["name"]] > 0, f"{k['name']} was not launched on its main path")
        check("jax" not in sys.modules and "facedet_tpu" not in sys.modules, "jax or facedet_tpu was imported")
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(eval_root, ignore_errors=True)
    phase()
    report = [{**k, "launches": counts[k["name"]], **timings[k["name"]]} for k in KERNELS]
    print(f"seconds by phase: {json.dumps(PHASE_SECONDS)}")
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": report}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
