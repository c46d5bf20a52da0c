"""Training of YOLOv11-pose, SCRFD, RT-DETR and the Real-ESRGAN enhancer
(counterpart of facedet_tpu/train/)."""
from facedet_tpu_torch.train.checkpoint import CheckpointManager
from facedet_tpu_torch.train.rtdetr_train import RtDetrTrainer, rtdetr_loss
from facedet_tpu_torch.train.scrfd_train import make_scrfd_staged_loop, make_scrfd_train_step, scrfd_loss
from facedet_tpu_torch.train.yolo_train import (
    make_optimizer,
    make_sharded_staged_train_loop,
    make_sharded_train_step,
    make_staged_train_loop,
    make_train_step,
    yolo_loss,
)
from facedet_tpu_torch.train.yolo_trainer import YoloDataset, YoloTrainer

__all__ = [
    "CheckpointManager",
    "make_optimizer",
    "make_scrfd_staged_loop",
    "make_scrfd_train_step",
    "make_sharded_staged_train_loop",
    "make_sharded_train_step",
    "make_staged_train_loop",
    "make_train_step",
    "rtdetr_loss",
    "RtDetrTrainer",
    "scrfd_loss",
    "yolo_loss",
    "YoloDataset",
    "YoloTrainer",
]
