"""Host-side data path of the port: the image reader (image_io, no OpenCV
or PIL), the datasets, letterbox, augmentations and train transforms
(numpy), the omni meta-datasets and the prefetching batch loaders (port
of unicorn_tpu/data)."""
