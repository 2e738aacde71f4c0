"""Host-side data path of the port: letterbox, augmentations and train
transforms (numpy, no OpenCV), the omni meta-datasets and the prefetching
batch loaders (port of unicorn_tpu/data)."""
