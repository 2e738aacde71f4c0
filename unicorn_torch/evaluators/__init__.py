"""Evaluators of the port (unicorn_tpu/evaluators): COCO mAP, instance
segmentation, MOT (ByteTrack / SORT, QDTrack / DeepSORT / MOTDT, MOTS),
BDD100K, VOC; CLEAR-MOT / HOTA / MOTS metrics; the COCO RLE codec."""
from .bdd_evaluator import BDDEvaluator
from .coco_evaluator import COCOEvaluator
from .coco_inst_evaluator import COCOInstEvaluator
from .coco_map import COCOMeanAP
from .mot_evaluator import MOTEvaluator
from .mot_metrics import MOTAccumulator, aggregate_metrics
from .voc_evaluator import VOCEvaluator

__all__ = ["COCOEvaluator", "COCOInstEvaluator", "MOTEvaluator",
           "BDDEvaluator", "VOCEvaluator", "COCOMeanAP", "MOTAccumulator",
           "aggregate_metrics"]
