"""Omni meta-datasets: weighted sampling over sub-datasets and the
alternating task schedule (port of unicorn_tpu/data/datasets/omni.py).

Every sub-dataset exposes `pull_item_omni(seq_id, num_frames, *, rng)`
returning `num_frames` frames of (HWC uint8 image, (N, 5 | 6) [xyxy,
cls(, tid)]), with (H, W, N) masks as a third element in the mask stage.
Every draw, here and inside the sub-datasets' pull_item_omni, takes the
caller's generator (`rng`, a random.Random; the loader's), where the JAX
package draws from the process-global `random`, in the same order.
"""
from __future__ import annotations

import random
from typing import Sequence


class OmniDataset:
    """Weighted sampling over sub-datasets with a fixed samples_per_epoch."""

    def __init__(self, datasets: Sequence, p_datasets=None,
                 samples_per_epoch: int = 200000, num_frames: int = 2):
        self.datasets = list(datasets)
        if p_datasets is None:
            p_datasets = [len(d) for d in self.datasets]
        total = sum(p_datasets)
        self.p_datasets = [p / total for p in p_datasets]
        self.samples_per_epoch = samples_per_epoch
        self.num_frames = num_frames

    def __len__(self):
        return self.samples_per_epoch

    def sample_spec(self, index, rng: random.Random):
        """Draw (sub-dataset, seq_id) without loading anything. The loader
        calls this under its sampling lock and load_spec outside it, so
        that loading runs in parallel across workers while the draws stay
        in one order."""
        ds = rng.choices(self.datasets, self.p_datasets)[0]
        return ds, rng.randint(0, len(ds) - 1)

    def load_spec(self, spec, rng: random.Random):
        """The frames of a drawn spec; the sub-dataset's own draws (the
        second frame of a pair) come from `rng`."""
        ds, seq_id = spec
        return ds.pull_item_omni(seq_id, self.num_frames, rng=rng)

    def pull_item(self, index, rng: random.Random):
        return self.load_spec(self.sample_spec(index, rng), rng)


class OmniDatasetPlus:
    """Task-level meta dataset: joint or alternating SOT <-> MOT sampling.
    task_id 1 = SOT / VOS, 2 = MOT / MOTS. A missing group is an ablation
    (SOT-only or MOT-only): every sample then comes from the other."""

    def __init__(self, sot_dataset=None, mot_dataset=None,
                 samples_per_epoch: int = 200000, mode: str = "alter",
                 mot_weight: float = 0.5):
        if mode not in ("joint", "alter"):
            raise ValueError(f"mode must be 'joint' or 'alter', got {mode!r}")
        self.sot_dataset = sot_dataset
        self.mot_dataset = mot_dataset
        self.samples_per_epoch = samples_per_epoch
        self.mode = mode
        self.mot_weight = mot_weight
        self.cur_task = 1  # alternating state, driven by the loader

    def __len__(self):
        return self.samples_per_epoch

    def alter_task(self):
        """Flip the active task (the loader calls it every alter_step
        batches)."""
        self.cur_task = 2 if self.cur_task == 1 else 1

    def sample_spec(self, index, rng: random.Random):
        """The task and sub-dataset draws only (see
        OmniDataset.sample_spec)."""
        if self.sot_dataset is None:       # MOT-only ablation
            task = 2
        elif self.mot_dataset is None:     # SOT-only ablation
            task = 1
        elif self.mode == "joint":
            task = 2 if rng.random() < self.mot_weight else 1
        else:
            task = self.cur_task
        ds = self.sot_dataset if task == 1 else self.mot_dataset
        inner = ds.sample_spec(index, rng) if hasattr(ds, "sample_spec") \
            else None
        return ds, inner, task

    def load_spec(self, spec, rng: random.Random):
        ds, inner, task = spec
        frames = ds.load_spec(inner, rng) if inner is not None \
            else ds.pull_item(0, rng)
        return frames, task

    def pull_item(self, index, rng: random.Random):
        return self.load_spec(self.sample_spec(index, rng), rng)
