"""Model export for deployment (the port's tools/export_model.py; the JAX
package serializes StableHLO through jax.export, the reference traces
TorchScript): torch.export of the detection forward, saved as a .pt2 file.

  python -m unicorn_torch.tools.export_model -n unicorn_track_tiny \
      [-c ckpt] --out unicorn_tiny.pt2 [--mode whole|decode] [--device cpu]

--mode whole exports Unicorn.forward_whole's raw head outputs (a list of
per-level dicts), decode adds decode_for_inference (B, A, 5 + classes),
for (1, 3, *test_size) float32 images (a channels_last NCHW view, as the
drivers give them) on the chosen device, the model in the exp's dtype.
The hand-written dw7x7 kernel stays in the program as the registered op
`unicorn_torch::dwconv7x7` (one node a call), so the loaded program
launches it on the card. Reload with

  import unicorn_torch.ops.dwconv7x7   # registers the op
  prog = torch.export.load(path).module()

-f / -n / -c as tools/eval.py.
"""
import argparse
import os
import time

import torch
from torch import nn

from ..device import resolve_device
from ..exp.base import get_exp
from ..models.heads import decode_for_inference
from ..ops import dwconv7x7  # noqa: F401  (registers the op)
from .common import load_model


class ExportForward(nn.Module):
    """forward_whole's raw head outputs, or their decode."""

    def __init__(self, model, decode: bool):
        super().__init__()
        self.model = model
        self.decode = decode

    def forward(self, images):
        raw, _ = self.model.forward_whole(images)
        if self.decode:
            return decode_for_inference(raw, (8, 16, 32), mode="mot")
        return raw


def dw_nodes(program) -> int:
    """The unicorn_torch::dwconv7x7 nodes of an exported program's graph."""
    return sum(1 for n in program.graph.nodes
               if n.op == "call_function"
               and n.target is torch.ops.unicorn_torch.dwconv7x7.default)


def main(argv=None):
    """Returns (the ExportedProgram, its example input)."""
    p = argparse.ArgumentParser("unicorn_torch export_model")
    p.add_argument("-f", "--exp_file", default=None)
    p.add_argument("-n", "--name", default=None)
    p.add_argument("-c", "--ckpt", default=None)
    p.add_argument("--out", required=True)
    p.add_argument("--mode", default="whole", choices=["whole", "decode"])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    exp = get_exp(args.exp_file, args.name)
    device = resolve_device(args.device)
    t0 = time.perf_counter()
    module = ExportForward(load_model(exp, args.ckpt).to(device),
                           args.mode == "decode")
    example = torch.zeros((1, *exp.test_size, 3), dtype=torch.float32,
                          device=device).permute(0, 3, 1, 2)
    with torch.no_grad():
        program = torch.export.export(module, (example,))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    torch.export.save(program, args.out)
    print(f"exported {args.mode} ({dw_nodes(program)} unicorn_torch."
          f"dwconv7x7 nodes) in {time.perf_counter() - t0:.1f} s: "
          f"{os.path.getsize(args.out) / 1e6:.1f} MB to {args.out}")
    print("reload with: import unicorn_torch.ops.dwconv7x7; "
          "torch.export.load(path).module()(images)")
    return program, example


if __name__ == "__main__":
    main()
