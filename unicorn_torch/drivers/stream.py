"""Streaming MOT with everything on the device (port of
unicorn_tpu/drivers/stream.py).

Video frames stream through backbone -> head -> decode -> NMS -> ByteTrack
association with the tracker state resident on the device as a `TrackState`
(tracker/device_tracker.py). `push_frame` and `run_chunk` return device
tensors and fetch nothing; the caller fetches track outputs when it wants
them, a chunk at a time.

The JAX version compiles a chunk into one program (`lax.scan`); here a chunk
is a Python loop over eager calls. Inside a frame the only host
synchronisations are the reads of the auction's loop condition (one before
each block of rounds, tracker/device_tracker.py `auction_assign`).
"""
from __future__ import annotations

import numpy as np
import torch

from ..csrc.native import pack_frames_s2d4
from ..device import resolve_device
from ..models.heads import decode_for_inference
from ..models.unicorn import Unicorn
from ..ops.nms import postprocess_device
from ..tracker.device_tracker import init_state, tracker_step


def pack_frames_plain(frames: np.ndarray) -> np.ndarray:
    """Host-side 4x4 space-to-depth in numpy: (N, H, W, C) -> (N, H/4, W/4,
    16 * C), any dtype; the plain form of csrc/pack.cpp."""
    n, h, w, c = frames.shape
    if h % 4 or w % 4:
        raise ValueError(f"pack_frames_np needs H, W divisible by 4 "
                         f"(letterboxed input), got {h}x{w}")
    xp = frames.reshape(n, h // 4, 4, w // 4, 4, c)
    return np.ascontiguousarray(xp.transpose(0, 1, 3, 2, 4, 5)).reshape(
        n, h // 4, w // 4, 16 * c)


def pack_frames_np(frames: np.ndarray) -> np.ndarray:
    """Host-side 4x4 space-to-depth: (N, H, W, 3) -> (N, H/4, W/4, 48), the
    ingest format the ConvNeXt stem consumes as one matmul. Patch-major
    (dy, dx, c) order, as models.convnext.space_to_depth_4x4. uint8 frames
    go through the native packer (csrc/pack.cpp, bit-equal to the numpy
    form; a packer that cannot be built raises), frames of another dtype
    through `pack_frames_plain`."""
    if frames.dtype == np.uint8 and frames.ndim == 4:
        return pack_frames_s2d4(frames)
    return pack_frames_plain(frames)


class StreamingMOTPipeline:
    """Detector and device tracker behind `push_frame` and `run_chunk`. The
    two stages, `detect` and `associate`, are public so that a caller can
    time them."""

    def __init__(self, model: Unicorn, input_size=(800, 1280),
                 num_classes: int = 1, conf_thre: float = 0.1,
                 nms_thre: float = 0.8, max_dets: int = 64,
                 max_tracks: int = 128, track_thresh: float = 0.6,
                 match_thresh: float = 0.9, chunk: int = 8,
                 n_cand: int = 128, frame_batch: int = 1,
                 track_buffer: int = 30, compiler_options="auto",
                 approx_topk: bool = True, n_streams: int = 1,
                 pipelined: bool = False, unroll: int = 1, device="cuda"):
        """The JAX pipeline's arguments, without `params` (the module holds
        its parameters) and with `device`.

        frame_batch F > 1 batches the (frame-independent) detector forward
        over F consecutive frames of a chunk while the tracker still
        consumes frames causally one by one; a chunk's length must divide by
        F. n_streams S > 1 runs S independent streams through one detector
        batch and one batched tracker step per tick.

        Frames are NHWC on the device, either raw (N, H, W, 3) or
        host-packed (N, H/4, W/4, 48) by `pack_frames_np`; float or uint8.

        `compiler_options`, `unroll` and `approx_topk` are kept so that
        callers of the JAX pipeline carry over; they change nothing here:
        the first two steer the XLA compilation of the chunk program, and
        `approx_topk` selects `jax.lax.approx_max_k`, where the port always
        takes the exact top-k. `pipelined=True` is not yet ported."""
        self.n_streams = int(n_streams)
        self.frame_batch = int(frame_batch)
        if self.n_streams > 1 and (pipelined or self.frame_batch != 1):
            raise ValueError(
                "n_streams > 1 supports neither pipelined=True nor "
                "frame_batch > 1 (the multi-stream chunk step already "
                "batches the detector across streams)")
        if pipelined:
            raise NotImplementedError(
                "StreamingMOTPipeline(pipelined=True) is not yet ported")
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.input_size = tuple(input_size)
        self.max_tracks = max_tracks
        self.chunk = chunk
        self._detect_kw = dict(
            num_classes=num_classes, conf_thre=conf_thre, nms_thre=nms_thre,
            class_agnostic=(num_classes == 1), n_cand=n_cand,
            max_out=max_dets, cluster_iters=8)
        self._track_kw = dict(track_thresh=track_thresh,
                              match_thresh=match_thresh,
                              max_time_lost=track_buffer)
        self.reset()

    def reset(self):
        self.ts = init_state(self.max_tracks, self.n_streams, self.device)

    def detect(self, frames):
        """frames (F, H, W, C) NHWC -> (dets5 (F, D, 5), valid (F, D))."""
        raw, _ = self.model.forward_whole(frames.permute(0, 3, 1, 2))
        dec = decode_for_inference(raw, (8, 16, 32), mode="mot")
        dets, valid = postprocess_device(dec, **self._detect_kw)
        dets5 = torch.cat([dets[..., :4],
                           (dets[..., 4] * dets[..., 5])[..., None]], -1)
        return dets5.float(), valid

    def associate(self, dets5, valid):
        """One tracker step for every stream: dets5 (S, D, 5), valid (S, D)
        -> packed (S, T, 7) [x1, y1, x2, y2, score, id, valid]."""
        self.ts, out, out_valid = tracker_step(self.ts, dets5, valid,
                                               **self._track_kw)
        return torch.cat([out, out_valid[..., None].to(out.dtype)], -1)

    @torch.inference_mode()
    def push_frame(self, frame_device):
        """One frame (1, H, W, C) already on the device. Returns the packed
        output (T, 7) [x1, y1, x2, y2, score, id, valid] on the device,
        without fetching."""
        if self.n_streams != 1:
            raise ValueError("push_frame takes one stream; use run_chunk "
                             "with n_streams > 1")
        return self.associate(*self.detect(frame_device))[0]

    @torch.inference_mode()
    def run_chunk(self, frames_device):
        """frames (N, H, W, C) on the device -> (N, T, 7) on the device;
        with n_streams = S > 1, frames (S, N, H, W, C) -> (S, N, T, 7)."""
        if self.n_streams > 1:
            S, N = frames_device.shape[:2]
            if S != self.n_streams:
                raise ValueError(f"run_chunk: {S} streams given, "
                                 f"{self.n_streams} expected")
            outs = [self.associate(*self.detect(frames_device[:, t]))
                    for t in range(N)]
            return torch.stack(outs, 1)
        N, F = frames_device.shape[0], self.frame_batch
        if N % F:
            raise ValueError(f"chunk {N} not divisible by frame_batch {F}")
        outs = []
        for t in range(0, N, F):
            dets5, valid = self.detect(frames_device[t:t + F])
            for f in range(F):   # causal association, one frame at a time
                outs.append(self.associate(dets5[f:f + 1], valid[f:f + 1])[0])
        return torch.stack(outs)


class MultiStreamMOT:
    """S independent streams sharded over a mesh of cards, one tracker state
    each. Not yet ported: it belongs to the multi-GPU work."""

    def __init__(self, *args, **kw):
        raise NotImplementedError("MultiStreamMOT is not yet ported")
