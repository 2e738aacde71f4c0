"""Datasets of the port: the omni meta-datasets over sub-datasets that
implement `pull_item_omni`, and the on-disk datasets of the reference's
mixes (COCO, LaSOT / GOT-10k / TrackingNet / COCO-SOT, MOT, YouTube-VOS /
DAVIS / saliency / COCO and MOTS-Challenge masks, BDD100K, VOC)."""
