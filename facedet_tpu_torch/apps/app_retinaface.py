"""Raw SCRFD/RetinaFace direct detection CLI, no slicing (counterpart of
facedet_tpu/apps/app_retinaface.py): ``FaceAnalysis`` detection on each
input image, written as ``<name>_retinaface.jpg``.

    python -m facedet_tpu_torch.apps.app_retinaface --input imgs/ --output out/ \\
        --model-path facedet_tpu/eval/assets/scrfd_2_5g_golden.npz --device cuda
"""
from __future__ import annotations

import os


def main(argv=None):
    import numpy as np

    from facedet_tpu_torch.apps.common import base_parser, list_inputs
    from facedet_tpu_torch.engine.prediction import ObjectPrediction
    from facedet_tpu_torch.engine.scrfd_wrapper import FaceAnalysis
    from facedet_tpu_torch.utils.viz import draw_detections_on_image, load_image, save_image

    ap = base_parser("Raw SCRFD/RetinaFace direct detection (PyTorch)")
    ap.add_argument("--det-size", type=int, default=640)
    ap.add_argument("--det-thresh", type=float, default=0.5)
    args = ap.parse_args(argv)

    inputs = list_inputs(args.input)
    fa = FaceAnalysis(name="scrfd_2.5g", model_path=args.model_path, device=args.device)
    fa.prepare(ctx_id=0, det_size=(args.det_size, args.det_size), det_thresh=args.det_thresh)
    counts = {}
    for path in inputs:
        img = load_image(path)
        faces = fa.get(img)
        preds = [
            ObjectPrediction(
                bbox=f.bbox,
                score=f.det_score,
                keypoints=np.concatenate([f.kps, np.ones((len(f.kps), 1))], -1),
            )
            for f in faces
        ]
        name = os.path.splitext(os.path.basename(path))[0]
        save_image(os.path.join(args.output, f"{name}_retinaface.jpg"), draw_detections_on_image(img, preds))
        print(f"{name}: {len(faces)} faces")
        counts[name] = len(faces)
    return counts


if __name__ == "__main__":
    main()
