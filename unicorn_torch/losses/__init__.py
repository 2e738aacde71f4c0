"""Training losses of the port (SimOTA + YOLOX, the unified SOT+MOT loss)."""
