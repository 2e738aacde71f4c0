"""unicorn_torch — the PyTorch/CUDA port of unicorn_tpu for NVIDIA Hopper.

The JAX package `unicorn_tpu` is the reference; this package imports none of
it (nor jax/flax) and keeps its own copies of the host-side code it needs.
Plain tensor code is PyTorch; every Pallas kernel of the ported path is a
hand-written CUDA kernel under `csrc/`, built with nvcc on first use.

Ported so far (slice 1, MOT detect-and-track; slice 2, SOT; slice 3, the
uni-stage training step):
  models/   ConvNeXt-Tiny trunk, YOLO PAFPN, unified head, the deformable
            interaction with its bottleneck, position embedding and
            embedding upsample, `Unicorn`
  ops/      kernel wrappers (dw7x7, deformable-attention sampling,
            correlation label propagation for serving and for training),
            correlation helpers, fixed-shape NMS, device letterbox
  losses/   SimOTA + YOLOX losses, the unified SOT+MOT loss
  core/     schedules, TrainState (AdamW/SGD, accumulation, EMA), the det
            and uni train steps
  tracker/  host ByteTrack (Kalman, Hungarian matching)
  drivers/  `MOTDriver` (ByteTrack path), `SOTDriver`
  exp/      `ExpTrack` model/training/test fields and training factories,
            `unicorn_track_tiny`
  convert   flax param tree <-> reference-named state_dict
"""

from .device import resolve_device

__all__ = ["resolve_device"]
