"""MOT driver of the port (ByteTrack path)."""
