"""Drivers of the port: MOT with the host tracker, SOT, and streaming MOT
with the tracker on the device."""
from .mot import MOTDriver
from .sot import SOTDriver
from .stream import MultiStreamMOT, StreamingMOTPipeline, pack_frames_np

__all__ = ["MOTDriver", "SOTDriver", "MultiStreamMOT",
           "StreamingMOTPipeline", "pack_frames_np"]
