"""Ops of the port: the dw7x7 and fused ConvNeXt block kernel wrappers, MSDA,
correlation, the CondInst dynamic convolution, fixed-shape NMS, device
letterbox.

Only names that do not shadow a sub-module are exported here: `dwconv7x7` and
`convnext_block` are both a module and the function in it, and
`from unicorn_torch.ops import convnext_block` has to go on meaning the
module (chip_smoke.py and the tests read the launch counts there), so the
two entry points are imported from their modules:
`from unicorn_torch.ops.convnext_block import convnext_block`."""
from .convnext_block import (block_params, convnext_block_cuda,
                             convnext_block_plain, convnext_block_ref)
from .dwconv7x7 import dwconv7x7_cuda, dwconv7x7_plain

__all__ = ["block_params", "convnext_block_cuda", "convnext_block_plain",
           "convnext_block_ref", "dwconv7x7_cuda", "dwconv7x7_plain"]
