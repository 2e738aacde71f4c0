"""Drivers of the port: MOT with the host tracker (ByteTrack, and the omni
path with QDTrack or DeepSORT, with or without masks), SOT, streaming MOT
with the tracker on the device, and instance segmentation."""
from .inst import InstForward, make_inst_forward
from .mot import MOTDriver, MOTOmniDriver
from .sot import SOTDriver
from .stream import MultiStreamMOT, StreamingMOTPipeline, pack_frames_np

__all__ = ["InstForward", "make_inst_forward", "MOTDriver", "MOTOmniDriver",
           "SOTDriver", "MultiStreamMOT", "StreamingMOTPipeline",
           "pack_frames_np"]
