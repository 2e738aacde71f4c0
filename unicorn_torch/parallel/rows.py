"""One frame split over processes by rows: the row plan, the collectives
that move rows between the ranks, and the hooks that let the model's ops
that look across rows run on one rank's block of rows.

JAX shards a frame's H axis over an "sp" mesh axis and lets XLA's SPMD
partitioner insert the halo exchanges (unicorn_tpu/parallel/spatial.py).
Here each rank of a torch.distributed group holds a contiguous block of
whole 32-row units of the frame (32 is the deepest stride, so every
level's rows split exactly and no strided window straddles two ranks), and
the ops exchange what they need themselves:

  * a convolution or max pool of k > 1 rows takes the rows its window
    reads from the ranks above and below (`halo`), and runs without
    padding in H; at the frame's edges the rows are its padding;
  * GroupNorm takes its statistics over the whole frame (`group_norm`);
  * the dw7x7 kernel runs on the rank's rows plus 3 halo rows each side,
    and the 3 rows at each end are cropped;
  * a Swin block takes, after its first LayerNorm, every row of each
    window band that meets its rows (`take_rows`): up to window - 1 rows
    on each side, from as many ranks as they span, and, for the shifted
    windows' band that wraps round the frame, the frame's last rows and
    its first ones; the window, the shift and the bottom pad follow the
    whole frame's height (models/swin.py).

Every exchange is one all-reduce (SUM) of a zero-filled buffer with one
slot per rank, run on an int32 view of the bytes: adding zeros keeps every
bit, and all_reduce is the collective that gloo takes on CUDA tensors as
well as on CPU ones, and NCCL on cards of their own.

The hooks are on only inside `row_sharded(plan)`; outside it every op runs
as it does on one card. This module imports only torch: models/blocks.py
imports it.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch
import torch.distributed as dist

UNIT = 32   # rows of the deepest stride: the frame splits in whole units

_active = {"plan": None}


def split_units(H: int, n_ranks: int, unit: int = UNIT) -> tuple:
    """Units of `unit` rows per rank: the H / unit units as even as
    possible, the first ranks taking one more. Raises when H is not a
    whole number of units or a rank would get none."""
    if H % unit:
        raise ValueError(f"row plan: H={H} is not a multiple of the deepest "
                         f"stride {unit}")
    n = H // unit
    if n < n_ranks:
        raise ValueError(f"row plan: H={H} has {n} units of {unit} rows, "
                         f"fewer than the {n_ranks} ranks")
    per, extra = divmod(n, n_ranks)
    return tuple(per + (r < extra) for r in range(n_ranks))


@dataclass(frozen=True)
class RowPlan:
    """Which units of the frame each rank holds, and this rank's place in
    the group (`group` None with one rank and no process group)."""

    units: tuple
    rank: int
    group: object = None

    @property
    def world(self) -> int:
        return len(self.units)

    def bounds(self, h_local: int) -> list:
        """(start, stop) rows of every rank on a map whose block on this
        rank has h_local rows."""
        q = h_local // self.units[self.rank]
        if q * self.units[self.rank] != h_local:
            raise ValueError(f"row plan: a map of {h_local} rows does not "
                             f"split into this rank's "
                             f"{self.units[self.rank]} units")
        out, start = [], 0
        for u in self.units:
            out.append((start, start + u * q))
            start += u * q
        return out


@contextlib.contextmanager
def row_sharded(plan: RowPlan):
    """Inside, the ops of models/ run on this rank's rows of `plan`."""
    prev = _active["plan"]
    _active["plan"] = plan
    try:
        yield plan
    finally:
        _active["plan"] = prev


def active() -> RowPlan | None:
    """The plan of the enclosing `row_sharded`, else None."""
    return _active["plan"]


def all_reduce(t: torch.Tensor, ranks: RowPlan) -> torch.Tensor:
    """Sum `t` in place over the plan's ranks; nothing to sum with one rank
    and no group. A collective the backend refuses raises."""
    if ranks.group is None:
        if ranks.world != 1:
            raise RuntimeError("several ranks and no process group")
        return t
    dist.all_reduce(t, group=ranks.group)
    return t


def exchange(local: torch.Tensor, ranks: RowPlan) -> torch.Tensor:
    """Every rank's `local` (one shape and dtype on all ranks) stacked in
    rank order, (world, *local.shape), bit for bit: each rank writes its
    bytes into its slot of a zero buffer, and the buffer is summed over
    the ranks as int32."""
    flat = local.contiguous().reshape(-1).view(torch.uint8)
    n = flat.numel()
    buf = torch.zeros(ranks.world, -(-n // 4) * 4, dtype=torch.uint8,
                      device=local.device)
    buf[ranks.rank, :n] = flat
    all_reduce(buf.view(torch.int32), ranks)
    return buf[:, :n].contiguous().view(local.dtype).reshape(
        ranks.world, *local.shape)


def edge_strips(x: torch.Tensor, h: int) -> torch.Tensor:
    """This rank's first and last min(h, rows) rows of x (N, C, rows, W),
    rows first: (2, h, N, W, C); the first strip zero-padded after its
    rows, the last before them."""
    xr = x.permute(2, 0, 3, 1)
    m = min(h, xr.shape[0])
    strips = xr.new_zeros((2, h) + tuple(xr.shape[1:]))
    strips[0, :m] = xr[:m]
    strips[1, h - m:] = xr[xr.shape[0] - m:]
    return strips


def _strip_row(g: int, bounds: list, h: int) -> int:
    """The index of frame row g, which another rank owns, among the rows of
    every rank's edge strips (world, 2, h, ...) flattened: a row within h
    rows of its owner's end is among the owner's last h rows, else one
    within h rows of its start among its first h. A deeper row raises."""
    r = next(i for i, (s, e) in enumerate(bounds) if s <= g < e)
    s, e = bounds[r]
    if e - g <= h:
        return (2 * r + 1) * h + g - (e - h)
    if g - s < h:
        return 2 * r * h + g - s
    raise ValueError(f"row plan: row {g} lies deeper than {h} rows inside "
                     f"rank {r}'s block [{s}, {e})")


def assemble(x, strips, plan: RowPlan, above: int, below: int, fill):
    """x (N, C, rows, W) with `above` rows before and `below` after it, taken
    from every rank's edge strips (world, 2, h, N, W, C); rows outside the
    frame are `fill`. A row above the block lies within h rows of the
    boundary, so it is among its owner's last h rows (or that owner's whole
    block); a row below is among its owner's first h rows."""
    bounds = plan.bounds(x.shape[2])
    start, stop = bounds[plan.rank]
    H = bounds[-1][1]
    h = strips.shape[2]
    fill_row = plan.world * 2 * h
    idx = [_strip_row(g, bounds, h) if 0 <= g < H else fill_row
           for g in list(range(start - above, start))
           + list(range(stop, stop + below))]
    rows = torch.cat([strips.reshape(-1, *strips.shape[3:]),
                      strips.new_full((1,) + tuple(strips.shape[3:]), fill)])
    rows = rows[torch.tensor(idx, dtype=torch.long, device=rows.device)]
    xn = x.permute(0, 2, 3, 1)
    out = torch.cat([rows[:above].permute(1, 0, 2, 3), xn,
                     rows[above:].permute(1, 0, 2, 3)], 1)
    return out.permute(0, 3, 1, 2)


def take_rows(x, strips, plan: RowPlan, index, fill=0.0) -> torch.Tensor:
    """The frame's rows `index`, in that order, rows first: (len(index), N,
    W, C), from x (N, C, rows, W), this rank's block, and every rank's edge
    strips (world, 2, h, N, W, C). A row of this rank's is x's, another
    rank's comes from its owner's strips (within h rows of the owner's
    edge), and a row outside the frame [0, H) is `fill`."""
    bounds = plan.bounds(x.shape[2])
    start, stop = bounds[plan.rank]
    H = bounds[-1][1]
    h = strips.shape[2]
    own = plan.world * 2 * h
    fill_row = own + stop - start
    idx = [fill_row if not 0 <= g < H else own + g - start
           if start <= g < stop else _strip_row(g, bounds, h) for g in index]
    table = torch.cat([strips.reshape(-1, *strips.shape[3:]),
                       x.permute(2, 0, 3, 1),
                       strips.new_full((1,) + tuple(strips.shape[3:]), fill)])
    return table[torch.tensor(idx, dtype=torch.long, device=table.device)]


def halo(x: torch.Tensor, above: int, below: int, fill=0.0,
         plan: RowPlan | None = None, gather=None) -> torch.Tensor:
    """x (N, C, rows, W), this rank's block of a map, with `above` rows from
    the ranks above and `below` from the ranks below (`fill` beyond the
    frame's edges), as a channels_last NCHW tensor. `gather` replaces the
    exchange of the edge strips (default `exchange` over the plan)."""
    plan = plan or active()
    strips = edge_strips(x, max(above, below))
    strips = gather(strips) if gather is not None else exchange(strips, plan)
    return assemble(x, strips, plan, above, below, fill)


def window_rows(k: int, s: int, pad_top: int) -> tuple:
    """(above, below) halo rows of a k-row window at stride s whose map is
    padded by pad_top rows at its top: output row o reads input rows
    o*s - pad_top ... o*s - pad_top + k - 1, and a block's first output
    row is its first input row / s."""
    return pad_top, max(0, k - s - pad_top)


def group_norm(x, groups: int, weight, bias, eps: float,
               plan: RowPlan | None = None) -> torch.Tensor:
    """F.group_norm over the whole frame of x (N, C, rows, W) in fp32: the
    per-(sample, group) sums and counts summed over the ranks, then the
    sums of squared deviations from the frame's mean (biased variance).
    x is read in its own dtype; `x - mean` is fp32."""
    plan = plan or active()
    N, C, h, W = x.shape
    xg = x.reshape(N, groups, C // groups, h, W)
    s1 = xg.sum((2, 3, 4), dtype=torch.float32)
    stats = torch.stack([s1, torch.full_like(s1, (C // groups) * h * W)])
    all_reduce(stats, plan)
    mean = (stats[0] / stats[1])[..., None, None, None]
    d = xg - mean
    s2 = (d * d).sum((2, 3, 4))
    all_reduce(s2, plan)
    y = d * torch.rsqrt(s2 / stats[1] + eps)[..., None, None, None]
    return (y.reshape(N, C, h, W) * weight[:, None, None]
            + bias[:, None, None])


def gather_rows(tensors, plan: RowPlan | None = None) -> list:
    """Each (N, C, rows, W) block -> the full-height map in rank order, on
    every rank; all tensors in one exchange. Each rank writes a tensor's
    rows at a fixed offset sized for the largest block any rank holds."""
    plan = plan or active()
    per_row = [t[:, :, :1].numel() * t.element_size() for t in tensors]
    bounds = [plan.bounds(t.shape[2]) for t in tensors]
    sizes = [max(e - s for s, e in b) * p for b, p in zip(bounds, per_row)]
    offsets = [sum(sizes[:i]) for i in range(len(sizes))]
    local = torch.zeros(sum(sizes), dtype=torch.uint8,
                        device=tensors[0].device)
    for t, off in zip(tensors, offsets):
        b = t.permute(2, 0, 3, 1).contiguous().reshape(-1).view(torch.uint8)
        local[off:off + b.numel()] = b
    every = exchange(local, plan)              # (world, bytes)
    out = []
    for t, b, p, off in zip(tensors, bounds, per_row, offsets):
        N, C, _, W = t.shape
        blocks = [every[r, off:off + (e - s) * p].contiguous()
                  .view(t.dtype).reshape(e - s, N, W, C)
                  for r, (s, e) in enumerate(b)]
        out.append(torch.cat(blocks).permute(1, 3, 0, 2))
    return out


def gather_dim0(t: torch.Tensor, ranks: RowPlan) -> torch.Tensor:
    """Equal-sized per-rank (n, ...) blocks -> (world * n, ...) in rank
    order, on every rank (a plan of one unit a rank)."""
    return exchange(t, ranks).reshape(-1, *t.shape[1:])
