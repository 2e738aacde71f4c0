"""Datasets of the port: the omni meta-datasets over in-memory or on-disk
sub-datasets that implement `pull_item_omni`."""
