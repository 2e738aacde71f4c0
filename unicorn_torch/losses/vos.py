"""Instance-pair matching of the VOS/MOTS losses (port of
unicorn_tpu/losses/vos.py `match_instance_pairs`, which `build_mhs_labels`
needs; the rest of that module waits for the mask stack)."""
from __future__ import annotations

import torch


def match_instance_pairs(targets, max_pairs: int):
    """targets (B, 2, M, 6) -> (idx0 (B, K), idx1 (B, K), valid (B, K)): the
    first K (frame 0, frame 1) index pairs with equal nonzero track ids.

    Rows without a slot are all written into one scratch column, which is
    cut off; only that column depends on the order of the writes."""
    tid0 = targets[:, 0, :, 5]
    tid1 = targets[:, 1, :, 5]
    match = ((tid0[:, :, None] == tid1[:, None, :])
             & (tid0[:, :, None] != 0) & (tid1[:, None, :] != 0))   # (B, M, M)
    has = match.any(2)                              # the row has a match
    j_first = match.int().argmax(2)                 # its first matching column
    rank = has.int().cumsum(1) - 1
    valid = has & (rank < max_pairs)
    B, M = has.shape
    rows = torch.arange(M, device=targets.device).expand(B, M)
    slot = torch.where(valid, rank, torch.full_like(rank, max_pairs)).long()

    def scatter(src):
        buf = torch.zeros((B, max_pairs + 1), dtype=src.dtype,
                          device=targets.device)
        return buf.scatter_(1, slot, src)[:, :max_pairs]

    return scatter(rows), scatter(j_first), scatter(valid)
