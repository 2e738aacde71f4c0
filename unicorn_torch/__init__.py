"""unicorn_torch — the PyTorch/CUDA port of unicorn_tpu for NVIDIA Hopper.

The JAX package `unicorn_tpu` is the reference; this package imports none of
it (nor jax/flax) and keeps its own copies of the host-side code it needs.
Plain tensor code is PyTorch; every Pallas kernel of the ported path is a
hand-written CUDA kernel under `csrc/`, built with nvcc on first use.

Ported so far (slice 1, MOT detect-and-track; slice 2, SOT; slice 3, the
uni-stage training step; slice 4, the fused block op and streaming MOT;
slice 10, the JAX tests' CSPDarknet model and instance segmentation;
then VOS, MOT / MOTS omni serving and the mask-stage training steps):
  models/   ConvNeXt-Tiny and CSPDarknet trunks, YOLO PAFPN, unified head
            (with the CondInst controllers), the "deform", "full" and
            "conv" interactions with the bottleneck, position embedding and
            embedding upsample, the CondInst mask branch, `Unicorn`,
            `YOLOXDet`
  ops/      kernel wrappers (dw7x7, fused ConvNeXt block,
            deformable-attention sampling, correlation label propagation
            for serving and for training), correlation helpers, the
            dynamic mask convolution and its upsamplers, fixed-shape NMS,
            device letterbox
  losses/   SimOTA + YOLOX losses, the unified SOT+MOT loss, the mask
            stage's CondInst, BoxInst and VOS losses
  core/     schedules, TrainState (AdamW/SGD, accumulation, EMA, frozen
            parameters), the det, uni, inst and VOS + MOTS train steps
  tracker/  host ByteTrack (Kalman, Hungarian matching), device ByteTrack
  drivers/  `MOTDriver` (ByteTrack path), `SOTDriver`,
            `StreamingMOTPipeline`, `make_inst_forward`, `VOSDriver`,
            `MOTOmniDriver`
  exp/      `ExpTrack`, `ExpTrackMask`, `ExpDet`, `ExpDetMask` and the
            copies of unicorn_track_tiny, unicorn_track_tiny_mask and
            unicorn_inst_convnext_tiny_800x1280
  convert   flax param tree <-> reference-named state_dict
"""

from .device import resolve_device

__all__ = ["resolve_device"]
