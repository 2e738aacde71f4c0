"""Evaluation of the port: so far the COCO run-length mask codec
(`rle`), which the on-disk datasets decode their masks with."""
