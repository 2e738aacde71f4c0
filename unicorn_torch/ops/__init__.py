"""Ops of the port: the dw7x7 kernel wrapper, fixed-shape NMS, device letterbox."""
