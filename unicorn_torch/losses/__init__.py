"""Training losses of the port (SimOTA + YOLOX, the unified SOT+MOT loss,
the mask stage's CondInst, BoxInst and VOS losses)."""
