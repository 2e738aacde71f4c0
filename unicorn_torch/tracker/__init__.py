"""Online trackers of the port (numpy copies of the JAX package's host
trackers)."""
from .byte_tracker import ByteTracker, TrackView
from .kalman import KalmanFilter

__all__ = ["ByteTracker", "TrackView", "KalmanFilter"]
