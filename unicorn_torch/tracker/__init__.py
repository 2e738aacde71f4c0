"""Online trackers of the port: numpy copies of the JAX package's host
trackers (ByteTrack, QDTrack, SORT, DeepSORT, MOTDT), and the on-device
ByteTrack (batched tensor code)."""
from .byte_tracker import ByteTracker, TrackView
from .device_tracker import (TrackState, auction_assign, greedy_assign,
                             init_state, tracker_step, tracker_step_plain)
from .kalman import KalmanFilter
from .legacy import DeepSort, OnlineTracker, Sort
from .qd_tracker import QuasiDenseEmbedTracker

__all__ = ["ByteTracker", "TrackView", "KalmanFilter", "TrackState",
           "auction_assign", "greedy_assign", "init_state", "tracker_step",
           "tracker_step_plain",
           "QuasiDenseEmbedTracker", "Sort", "DeepSort", "OnlineTracker"]
