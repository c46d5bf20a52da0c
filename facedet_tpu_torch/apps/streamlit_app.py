"""SmallFace-SuperDetect — interactive UI.

Reference: pipeline_v4_yolo/1_Inference.py (695 LoC Streamlit page): sidebar
upload + confidence slider + SAHI/Enhance toggles (:545-570), cached model
loaders (:94-126), IQA scores with before/after delta indicators (:128-270),
``process_single_image`` orchestrator (:463-532), fixed grid-search optima
slice 640 / overlap 0.25 / IOS 0.5 / imgsz 1024 (:34,:563-566), result tabs
detail/crops/quality (:646-679).

``process_single_image`` here is a pure importable function (tested without
streamlit); the UI is gated on streamlit availability. The reference's temp-
JPEG round-trip between stages (:328-341) is gone — arrays flow directly.

Counterpart of facedet_tpu/apps/streamlit_app.py over the port's sliced
pipeline, drawing helpers and IQA; the detector and enhancer given run on
their own devices. ``run_ui`` needs streamlit, which raises ImportError
where it is not installed.
"""
from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np

# grid-search optima fixed in the reference app (1_Inference.py:34,563-566)
OPTIMAL_SLICE = 640
OPTIMAL_OVERLAP = 0.25
OPTIMAL_METRIC = "IOS"
OPTIMAL_THRESHOLD = 0.5
OPTIMAL_IMGSZ = 1024

__all__ = ["perform_sahi_detection", "perform_standard_detection", "process_single_image", "run_ui"]


def perform_sahi_detection(image, detection_model, conf: float):
    """Reference 1_Inference.py:324-344 (without the temp-JPEG round trip)."""
    from facedet_tpu_torch.engine.predict import get_sliced_prediction

    old = detection_model.confidence_threshold
    detection_model.confidence_threshold = conf
    try:
        return get_sliced_prediction(
            image,
            detection_model,
            slice_height=OPTIMAL_SLICE,
            slice_width=OPTIMAL_SLICE,
            overlap_height_ratio=OPTIMAL_OVERLAP,
            overlap_width_ratio=OPTIMAL_OVERLAP,
            postprocess_type="GREEDYNMM",
            postprocess_match_metric=OPTIMAL_METRIC,
            postprocess_match_threshold=OPTIMAL_THRESHOLD,
            postprocess_class_agnostic=True,
        )
    finally:
        detection_model.confidence_threshold = old


def perform_standard_detection(image, detection_model, conf: float):
    """Reference 1_Inference.py:346-461 — manual full-image pass wrapped into
    a PredictionResult."""
    from facedet_tpu_torch.engine.predict import get_prediction

    old = detection_model.confidence_threshold
    detection_model.confidence_threshold = conf
    try:
        return get_prediction(image, detection_model)
    finally:
        detection_model.confidence_threshold = old


def process_single_image(
    image: np.ndarray,
    detection_model,
    enhancer=None,
    enable_sahi: bool = True,
    enable_enhancer: bool = False,
    confidence: float = 0.5,
    output_dir: Optional[str] = None,
    with_iqa: bool = True,
) -> dict:
    """Full interactive pipeline (reference 1_Inference.py:463-532). Returns a
    dict with the result, timings, IQA before/after and crop quality."""
    from facedet_tpu_torch.utils.viz import draw_detections_on_image, save_face_crops

    out: dict = {"timings": {}}
    t0 = time.perf_counter()
    if with_iqa:
        from facedet_tpu_torch.eval.iqa import calculate_iqa_scores

        out["iqa_original"] = calculate_iqa_scores(image)
    work = image
    if enable_enhancer and enhancer is not None:
        work, dt = enhancer.enhance_image(image)
        out["timings"]["enhance"] = dt
        if with_iqa:
            from facedet_tpu_torch.eval.iqa import calculate_iqa_scores

            out["iqa_enhanced"] = calculate_iqa_scores(work)
            out["iqa_delta"] = {
                k: out["iqa_enhanced"][k] - out["iqa_original"][k]
                for k in out["iqa_original"]
            }
    t1 = time.perf_counter()
    if enable_sahi:
        result = perform_sahi_detection(work, detection_model, confidence)
    else:
        result = perform_standard_detection(work, detection_model, confidence)
    out["timings"]["detection"] = time.perf_counter() - t1
    out["result"] = result
    out["num_faces"] = len(result.object_prediction_list)
    out["annotated"] = draw_detections_on_image(work, result.object_prediction_list)
    out["annotated_clean"] = draw_detections_on_image(
        work, result.object_prediction_list, with_keypoints=False, with_labels=False
    )
    if output_dir:
        crops_dir = os.path.join(output_dir, "crops")
        out["crop_paths"] = save_face_crops(
            work, result.object_prediction_list, crops_dir
        )
        if with_iqa:
            from facedet_tpu_torch.eval.iqa import calculate_face_crop_quality

            out["crop_quality"] = calculate_face_crop_quality(crops_dir)
    out["timings"]["total"] = time.perf_counter() - t0
    return out


def run_ui():  # pragma: no cover - requires streamlit runtime
    """Streamlit page (reference 1_Inference.py:536-695)."""
    import streamlit as st

    from facedet_tpu_torch.apps.common import build_detector, build_enhancer
    from facedet_tpu_torch.utils.config import DetectorConfig, EnhancerConfig

    st.set_page_config(page_title="SmallFace-SuperDetect", layout="wide")
    st.title("SmallFace-SuperDetect")

    @st.cache_resource
    def load_detector():
        return build_detector(DetectorConfig(image_size=OPTIMAL_IMGSZ))

    @st.cache_resource
    def load_enhancer():
        return build_enhancer(EnhancerConfig(outscale=2.0, model_name="RealESRGAN_x2plus"))

    with st.sidebar:
        uploaded = st.file_uploader("Upload image", type=["jpg", "jpeg", "png"])
        conf = st.slider("Confidence", 0.1, 0.9, 0.5, 0.05)
        enable_sahi = st.checkbox("SAHI sliced inference", value=True)
        enable_enh = st.checkbox("Real-ESRGAN enhancement", value=False)
        run = st.button("Detect")

    if uploaded and run:
        from PIL import Image

        image = np.asarray(Image.open(uploaded).convert("RGB"))
        with st.spinner("Processing..."):
            out = process_single_image(
                image,
                load_detector(),
                enhancer=load_enhancer() if enable_enh else None,
                enable_sahi=enable_sahi,
                enable_enhancer=enable_enh,
                confidence=conf,
                output_dir="temp_streamlit",
            )
        st.success(f"{out['num_faces']} faces in {out['timings']['total']:.2f}s")
        tab1, tab2, tab3 = st.tabs(["Detections", "Crops", "Quality"])
        with tab1:
            st.image(out["annotated"])
        with tab2:
            for p in out.get("crop_paths", []):
                st.image(p, width=160)
        with tab3:
            st.json(
                {
                    "original": out.get("iqa_original"),
                    "enhanced": out.get("iqa_enhanced"),
                    "delta": out.get("iqa_delta"),
                    "crops": out.get("crop_quality"),
                }
            )


if __name__ == "__main__":
    try:
        import streamlit  # noqa: F401

        run_ui()
    except ImportError:
        print("streamlit is not installed; use process_single_image() programmatically")
