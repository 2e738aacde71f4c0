"""Command-line tools of the port (numpy and json; no JAX, no OpenCV)."""
