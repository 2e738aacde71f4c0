"""Drivers of the port: MOT with the host tracker, SOT, streaming MOT with
the tracker on the device, and instance segmentation."""
from .inst import InstForward, make_inst_forward
from .mot import MOTDriver
from .sot import SOTDriver
from .stream import MultiStreamMOT, StreamingMOTPipeline, pack_frames_np

__all__ = ["InstForward", "make_inst_forward", "MOTDriver", "SOTDriver",
           "MultiStreamMOT", "StreamingMOTPipeline", "pack_frames_np"]
