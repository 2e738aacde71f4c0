"""Online trackers of the port: numpy copies of the JAX package's host
trackers, and the on-device ByteTrack (batched tensor code)."""
from .byte_tracker import ByteTracker, TrackView
from .device_tracker import (TrackState, auction_assign, greedy_assign,
                             init_state, tracker_step)
from .kalman import KalmanFilter

__all__ = ["ByteTracker", "TrackView", "KalmanFilter", "TrackState",
           "auction_assign", "greedy_assign", "init_state", "tracker_step"]
