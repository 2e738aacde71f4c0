"""One whole ConvNeXt block as an op, NHWC: the hand-written CUDA kernel
(csrc/convnext_block.cu), its plain PyTorch version and the reference
composition.

Port of `convnext_block` (unicorn_tpu/ops/pallas_convnext.py:388), its kernel
`convnext_block_pallas` (:54) and its reference `convnext_block_ref` (:22).
As in the JAX package no model calls the op: `models.blocks.ConvNeXtBlock`
composes the block from the dw7x7 kernel, LayerNorm and two linear layers,
and this op is its fused alternative.

    y = x + gamma * (W2 . gelu(W1 . LN(dwconv7x7(x) + b_dw) + b1) + b2)

`x` is (B,H,W,C); `p` is a dict under the port's parameter names,
    {"dwconv": {"weight" (C,1,7,7), "bias" (C,)},
     "norm": {"weight" (C,), "bias" (C,)},
     "pwconv1": {"weight" (4C,C), "bias" (4C,)},
     "pwconv2": {"weight" (C,4C), "bias" (C,)}, "gamma" (C,)},
which `block_params` takes from a ConvNeXtBlock module and
`convert.convnext_block_params` from the flax sub-tree.

Three forms, which differ in where they round when x is bf16:
- `convnext_block_ref`: the composition, equal to the ConvNeXtBlock module:
  every parameter is rounded to x.dtype, and so are the conv output, the
  LayerNorm output, each linear layer's output, the GELU and gamma * y.
- the kernel and `convnext_block_plain`, as the TPU kernel's body: the dw
  taps and bias, the LayerNorm scale and bias, b1, b2 and gamma stay fp32;
  only W1 and W2 are rounded; the 49-tap fp32 sum goes into LayerNorm
  unrounded; yn is rounded once; product 1 + b1 and the GELU are fp32, then
  one rounding; product 2 + b2, x gamma, + the residual are fp32, then one
  rounding. The variance is the two-pass form mean((acc - mu)^2) in both (the
  TPU body takes E[x^2] - mu^2).
In fp32 the three agree to summation order.

`convnext_block(x, p, exact_gelu, method)`: "auto" launches the kernel for a
CUDA tensor and takes the plain version only for a tensor on the CPU;
"pallas" (the JAX package's name for the kernel route) is the kernel and
raises for a CPU tensor; "ref" is the composition. There is no fall-back: a
CUDA tensor the kernel does not take raises.

Gradients: "auto" and "pallas" go through an autograd Function whose forward
is the kernel (the plain version on the CPU) and whose backward is autograd
of `convnext_block_ref` on the saved (x, p), as the JAX package's custom VJP
(`_make_vjp`, pallas_convnext.py:400) recomputes through its reference: that
package has no backward kernel for this op, so the port has none either. The
backward running the composition is the op's definition, not a fall-back
from a kernel.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from .dwconv7x7 import dwconv7x7_plain, plain_backward

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_VEC = {torch.float32: 4, torch.bfloat16: 8}  # channels per 16-byte vector

# the leaves of p in the order the autograd Function takes them
LEAVES = (("dwconv", "weight"), ("dwconv", "bias"), ("norm", "weight"),
          ("norm", "bias"), ("pwconv1", "weight"), ("pwconv1", "bias"),
          ("pwconv2", "weight"), ("pwconv2", "bias"), ("gamma",))

# op calls that launched the kernels since the count was last set to 0 (read
# by chip_smoke.py); one call launches the two (fused route) or three
# (split route) kernels of one block
launches = 0


def block_params(block) -> dict:
    """The parameter dict `p` of a models.blocks.ConvNeXtBlock (its own
    tensors, not copies). A block without layer scale gets gamma = 1."""
    gamma = block.gamma
    if gamma is None:
        gamma = torch.ones_like(block.norm.weight)
    return {
        "dwconv": {"weight": block.dwconv.weight, "bias": block.dwconv.bias},
        "norm": {"weight": block.norm.weight, "bias": block.norm.bias},
        "pwconv1": {"weight": block.pwconv1.weight,
                    "bias": block.pwconv1.bias},
        "pwconv2": {"weight": block.pwconv2.weight,
                    "bias": block.pwconv2.bias},
        "gamma": gamma,
    }


def flatten_params(p: dict) -> tuple:
    """p -> its nine tensors in the order of LEAVES."""
    return tuple(p[k[0]] if len(k) == 1 else p[k[0]][k[1]] for k in LEAVES)


def unflatten_params(leaves) -> dict:
    p: dict = {}
    for k, t in zip(LEAVES, leaves):
        if len(k) == 1:
            p[k[0]] = t
        else:
            p.setdefault(k[0], {})[k[1]] = t
    return p


def _check(x: torch.Tensor, leaves) -> int:
    """Shapes of x (B,H,W,C) and the nine leaves; returns C."""
    if x.dim() != 4:
        raise ValueError(f"convnext_block: x must be (B,H,W,C), got "
                         f"{tuple(x.shape)}")
    C = x.shape[-1]
    want = ((C, 1, 7, 7), (C,), (C,), (C,), (4 * C, C), (4 * C,), (C, 4 * C),
            (C,), (C,))
    for k, t, shape in zip(LEAVES, leaves, want):
        if tuple(t.shape) != shape:
            raise ValueError(f"convnext_block: p[{']['.join(map(repr, k))}] "
                             f"is {tuple(t.shape)}, expected {shape}")
    return C


def _gelu(t: torch.Tensor, exact_gelu: bool) -> torch.Tensor:
    return F.gelu(t, approximate="none" if exact_gelu else "tanh")


def _taps(w_dw: torch.Tensor) -> torch.Tensor:
    """(C,1,7,7) -> (7,7,C)."""
    C = w_dw.shape[0]
    return w_dw.reshape(C, 49).t().reshape(7, 7, C)


def convnext_block_ref(x: torch.Tensor, p: dict, exact_gelu: bool = False,
                       eps: float = 1e-6) -> torch.Tensor:
    """The reference composition, equal to models.blocks.ConvNeXtBlock with
    the same parameters: computes in x.dtype with an fp32 LayerNorm. The dw
    conv is `dwconv7x7_plain` on either device, so this form is plain
    PyTorch throughout and differentiable."""
    dt = x.dtype
    leaves = flatten_params(p)
    _check(x, leaves)
    w_dw, b_dw, ln_s, ln_b, w1, b1, w2, b2, gamma = leaves
    y = dwconv7x7_plain(x, _taps(w_dw), b_dw)
    y = F.layer_norm(y.float(), (x.shape[-1],), ln_s, ln_b, eps).to(dt)
    y = _gelu(F.linear(y, w1.to(dt), b1.to(dt)), exact_gelu)
    y = F.linear(y, w2.to(dt), b2.to(dt))
    return x + y * gamma.to(dt)


def plain_hidden(x: torch.Tensor, p: dict, exact_gelu: bool = False,
                 eps: float = 1e-6) -> torch.Tensor:
    """The hidden map h (B,H,W,4C) of the plain version, in x.dtype: dw7x7
    with fp32 taps, two-pass LayerNorm on the unrounded fp32 sum, yn rounded
    once, product 1 + b1 and the GELU in fp32, one rounding."""
    dt = x.dtype
    leaves = [t.float() for t in flatten_params(p)]
    C = _check(x, leaves)
    w_dw, b_dw, ln_s, ln_b, w1, b1 = leaves[:6]
    acc = F.conv2d(x.float().permute(0, 3, 1, 2), w_dw, b_dw, padding=3,
                   groups=C).permute(0, 2, 3, 1)
    mu = acc.mean(-1, keepdim=True)
    d = acc - mu
    var = (d * d).mean(-1, keepdim=True)
    yn = (d * torch.rsqrt(var + eps) * ln_s + ln_b).to(dt)
    h = F.linear(yn.float(), w1.to(dt).float()) + b1
    return _gelu(h, exact_gelu).to(dt)


def convnext_block_plain(x: torch.Tensor, p: dict, exact_gelu: bool = False,
                         eps: float = 1e-6) -> torch.Tensor:
    """Plain PyTorch version of the kernel, with the kernel's places of
    rounding (module docstring). On the card TF32 must be off for both
    cuDNN and matmuls for the sums to be fp32."""
    dt = x.dtype
    h = plain_hidden(x, p, exact_gelu, eps)
    w2, b2, gamma = (t.float() for t in flatten_params(p)[6:])
    y = F.linear(h.float(), w2.to(dt).float()) + b2
    return (x.float() + y * gamma).to(dt)


MAX_SMEM = 232448        # shared memory a block may take on the card
PIECE_BYTES = 64 * 128   # a 64 x 64 bf16 weight piece (one TMA box)
F_STAGES = 3             # fp32: cp.async slots of K chunks of 32
# the plan's choices, in the order the C entry reads them
PLAN_KEYS = ("route", "m1", "n1", "stages1", "m2", "n2", "stages2")
# bf16, chosen from plan sweeps on the card (PERF.md §6): the widest C
# the fused route takes (at C = 256 its 128 accumulator registers a thread
# spill, and the split route is faster), the most ring stages of the first
# product (4 to 16 time the same), and the ring stages of the split
# route's second product (small blocks, several an SM)
FUSED_MAX_C = 192
MAX_STAGES = 8
P2_STAGES = 4


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


# Shared memory of a block, as the C entry sizes each launch from the plan
# (csrc/convnext_block.cu mlp_smem, p2_smem, f32_smem): shown here so that
# the plan can choose stages that fit and the CPU tests can hold it.
def _mlp_smem(m: int, C: int, stages: int, fused: bool) -> int:
    """bf16 first product: the A tile (ceil(C/64) chunks of m rows x 128
    bytes) and on the fused route the residual tile beside it, the ring of
    weight pieces and its two barriers a stage, the residual's barrier, and
    the 1024-byte alignment of the swizzled tiles."""
    return (1024 + (2 if fused else 1) * _cdiv(C, 64) * m * 128
            + stages * (PIECE_BYTES + 16) + 16)


def _p2_smem(m: int, n: int, stages: int) -> int:
    """bf16 second product (split route): stages of m rows of h and n rows
    of W2 (64 K columns each), two barriers a stage, the residual tile that
    stages the output (m x n bf16) and its barrier."""
    return (1024 + stages * ((m + n) * 128 + 16) + (m // 64) * n * 128
            + 16)


def _f32_smem(m: int, n: int, ln: bool) -> int:
    """fp32 products: F_STAGES slots of (m + n) rows x 36 floats, and the
    rows' mean and rstd for the first product."""
    return F_STAGES * (m + n) * 36 * 4 + (2 * m * 4 if ln else 0)


def plan(B: int, H: int, W: int, C: int, dtype, n_sm: int,
         route: str | None = None, *, m1: int | None = None,
         n1: int | None = None, m2: int | None = None,
         n2: int | None = None, stages2: int | None = None,
         waves: int = 1) -> dict:
    """How the kernels run one block on x (B,H,W,C) of `dtype` on a card of
    n_sm SMs, as the C entry takes it (`ints`, in the order PLAN_KEYS).

    bf16: the "fused" route (C <= FUSED_MAX_C) keeps h on the chip: one
    kernel of 128-pixel tiles walks all 4C hidden units, product 2's
    accumulator (C/2 fp32 registers a thread) in registers. It is taken
    where its ceil(P/128) blocks give every SM at least half a block's work;
    else, and for wider C, the "split" route: product 1 writes h, on tiles
    of m1 = 128 pixels (64 where 128 rows of A do not fit beside two ring
    stages) x groups of hidden chunks of 64, as many groups as keep the grid
    to `waves` waves of blocks (each group normalises its rows again), then
    product 2 on blocks of 128 x 128 outputs where they fill the card, else
    64 x 64. fp32 is always split: product 1's column tile n1 (128 or 64) is
    the one that pads 4C least, 128 on a tie, with 128 rows where that
    fills the card, else 64; product 2 takes 64 columns (8 x 4 register
    tiles, two blocks an SM) and 128 rows where that gives every SM two
    blocks, else 64.

    `route` forces a route; m1, n1 (fp32), m2, n2 (fp32; bf16 blocks are
    m2 x m2), stages2 (bf16) and waves override the plan's own choices (the
    plan sweeps use them). Raises ValueError for a shape or plan no kernel
    takes."""
    if dtype not in _DTYPE_CODE:
        raise ValueError(f"convnext_block plan: dtype {dtype} not supported")
    if min(B, H, W, C) <= 0 or C % _VEC[dtype]:
        raise ValueError(f"convnext_block plan: no kernel for "
                         f"{(B, H, W, C)} {dtype}")
    if route not in (None, "fused", "split"):
        raise ValueError(f"convnext_block plan: unknown route {route!r}")
    P = B * H * W
    nch = _cdiv(4 * C, 64)
    if dtype == torch.float32:
        if route == "fused":
            raise ValueError("convnext_block plan: fp32 has no fused route")
        if n1 is None:
            n1 = 64 if _cdiv(4 * C, 64) * 64 < _cdiv(4 * C, 128) * 128 else 128
        if m1 is None:
            m1 = 128 if _cdiv(P, 128) * _cdiv(4 * C, n1) >= n_sm else 64
        n2 = n2 or 64
        if m2 is None:
            m2 = 128 if _cdiv(P, 128) * _cdiv(C, n2) >= 2 * n_sm else 64
        p = dict(route="split", m1=m1, n1=n1, stages1=F_STAGES, m2=m2,
                 n2=n2, stages2=F_STAGES, smem1=_f32_smem(m1, n1, True),
                 smem2=_f32_smem(m2, n2, False),
                 grid1=(_cdiv(P, m1), _cdiv(4 * C, n1)),
                 grid2=(_cdiv(P, m2), _cdiv(C, n2)), acc_regs=n2 // 2)
    else:
        if route is None:
            route = ("fused" if C <= FUSED_MAX_C and 2 * _cdiv(P, 128) >= n_sm
                     else "split")
        if route == "fused":
            if C > FUSED_MAX_C:
                raise ValueError(f"convnext_block plan: the fused route "
                                 f"takes C <= {FUSED_MAX_C}, got {C}")
            stages = MAX_STAGES
            while _mlp_smem(128, C, stages, True) > MAX_SMEM:
                stages -= 1
            p = dict(route="fused", m1=128, n1=64 * nch, stages1=stages,
                     m2=0, n2=0, stages2=0,
                     smem1=_mlp_smem(128, C, stages, True), smem2=0,
                     grid1=(_cdiv(P, 128), 1), grid2=None,
                     acc_regs=16 * _cdiv(C, 32) + 32 + 16)
        else:
            if m1 is None:
                fits = [m for m in (128, 64)
                        if _mlp_smem(m, C, 2, False) <= MAX_SMEM]
                if not fits:
                    raise ValueError(f"convnext_block plan: C={C} is too "
                                     "wide for a 64-row A tile in shared "
                                     "memory")
                m1 = fits[0]
            stages1 = MAX_STAGES
            while stages1 > 2 and _mlp_smem(m1, C, stages1, False) > MAX_SMEM:
                stages1 -= 1
            # the most groups of hidden chunks that keep the first product
            # to `waves` waves of blocks (each group normalises its rows
            # again)
            tiles = _cdiv(P, m1)
            chunks = next((c for c in range(1, nch + 1)
                           if tiles * _cdiv(nch, c) <= waves * n_sm), nch)
            # 128 x 128 blocks where they fill the card, else 64 x 64
            if m2 is None:
                m2 = 128 if _cdiv(P, 128) * _cdiv(C, 128) >= n_sm else 64
            stages2 = stages2 or P2_STAGES
            p = dict(route="split", m1=m1, n1=64 * chunks, stages1=stages1,
                     m2=m2, n2=m2, stages2=stages2,
                     smem1=_mlp_smem(m1, C, stages1, False),
                     smem2=_p2_smem(m2, m2, stages2),
                     grid1=(tiles, _cdiv(nch, chunks)),
                     grid2=(_cdiv(P, m2), _cdiv(C, m2)),
                     acc_regs=max(32 + 16, m2 // 2))
    if max(p["smem1"], p["smem2"]) > MAX_SMEM:
        raise ValueError(f"convnext_block plan: {p['smem1']} / {p['smem2']} "
                         f"bytes of shared memory exceed {MAX_SMEM}")
    p["launches"] = 2 if p["route"] == "fused" else 3
    p["ints"] = tuple(1 if k == "route" and p[k] == "split" else
                      0 if k == "route" else p[k] for k in PLAN_KEYS)
    return p


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    from ..csrc import build

    lib = build.load("convnext_block")
    lib.convnext_block_forward.argtypes = (
        [ctypes.c_void_p] * 13 + [ctypes.c_int] * 6
        + [ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p])
    lib.convnext_block_forward.restype = ctypes.c_int
    lib.convnext_block_error_string.argtypes = [ctypes.c_int]
    lib.convnext_block_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _n_sm(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def device_plan(x: torch.Tensor, route: str | None = None, **kw) -> dict:
    """`plan` for x on its card."""
    B, H, W, C = x.shape
    return plan(B, H, W, C, x.dtype, _n_sm(x.device.index or 0), route, **kw)


def prepare(x: torch.Tensor, p: dict):
    """What `launch` takes beside x, made from p for x's dtype and device:
    (taps (7,7,C), b_dw, ln_s, ln_b, W1 (4C,C) in x.dtype, b1, W2 (C,4C) in
    x.dtype, b2, gamma), all contiguous, the others fp32."""
    leaves = flatten_params(p)
    _check(x, leaves)
    w_dw, b_dw, ln_s, ln_b, w1, b1, w2, b2, gamma = leaves

    def f32(t):
        return t.detach().to(x.device, torch.float32).contiguous()

    def rounded(t):
        return t.detach().to(x.device, x.dtype).contiguous()

    return (f32(_taps(w_dw)), f32(b_dw), f32(ln_s), f32(ln_b), rounded(w1),
            f32(b1), rounded(w2), f32(b2), f32(gamma))


def scratch(x: torch.Tensor, pl: dict):
    """The kernels' scratch for x (B,H,W,C) under the plan pl: the fp32 dw
    sums, and on the split route the 4C-wide hidden map (None on the fused
    route, which keeps it on the chip)."""
    B, H, W, C = x.shape
    sums = torch.empty(B, H, W, C, device=x.device, dtype=torch.float32)
    if pl["route"] == "fused":
        return sums, None
    return sums, torch.empty(B, H, W, 4 * C, device=x.device, dtype=x.dtype)


def launch(x: torch.Tensor, prepared, buffers, y: torch.Tensor,
           exact_gelu: bool, pl: dict, eps: float = 1e-6) -> None:
    """One block into y on PyTorch's current stream, on arguments from
    `prepare` and `scratch` and the plan pl: x, y (B,H,W,C) contiguous CUDA
    tensors. Raises if the C entry refuses the plan or a launch fails."""
    global launches
    tensors = (x, *prepared, *buffers, y)
    for t in tensors:
        if t is not None and t.data_ptr() % 16:
            raise ValueError("convnext_block_cuda: tensors must be 16-byte "
                             "aligned")
    B, H, W, C = x.shape
    lib = _lib()
    ints = (ctypes.c_int * len(PLAN_KEYS))(*pl["ints"])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.convnext_block_forward(
        *(None if t is None else t.data_ptr() for t in tensors), B, H, W, C,
        _DTYPE_CODE[x.dtype], int(bool(exact_gelu)), float(eps), ints,
        stream)
    if err:
        raise RuntimeError(
            f"convnext_block launch failed: {err} "
            f"({lib.convnext_block_error_string(err).decode()}) at "
            f"{(B, H, W, C)} {x.dtype}, plan {pl['ints']}")
    launches += 1


def convnext_block_cuda(x: torch.Tensor, p: dict, exact_gelu: bool = False,
                        eps: float = 1e-6) -> torch.Tensor:
    """The CUDA kernels on PyTorch's current stream, on the route `plan`
    picks. x must be a contiguous (B,H,W,C) CUDA tensor of
    float32 or bfloat16 with C a multiple of the 16-byte vector (4 fp32, 8
    bf16 channels); a shape no plan takes raises."""
    if not x.is_cuda:
        raise ValueError("convnext_block_cuda: x is not a CUDA tensor")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"convnext_block_cuda: dtype {x.dtype} not supported")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError("convnext_block_cuda: x must be a contiguous "
                         f"(B,H,W,C) tensor, got shape {tuple(x.shape)} "
                         f"strides {x.stride()}")
    if x.shape[-1] % _VEC[x.dtype]:
        raise ValueError(f"convnext_block_cuda: C={x.shape[-1]} is not a "
                         f"multiple of {_VEC[x.dtype]} for {x.dtype}")
    pl = device_plan(x)
    y = torch.empty_like(x)
    launch(x, prepare(x, p), scratch(x, pl), y, exact_gelu, pl, eps)
    return y


class _ConvNeXtBlock(torch.autograd.Function):
    """forward = the kernel (the plain version for a CPU tensor); backward =
    autograd of convnext_block_ref on the saved x and the nine leaves."""

    @staticmethod
    def forward(ctx, exact_gelu, x, *leaves):
        ctx.exact_gelu = exact_gelu
        ctx.save_for_backward(x, *leaves)
        fwd = convnext_block_cuda if x.is_cuda else convnext_block_plain
        return fwd(x, unflatten_params(leaves), exact_gelu)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        exact_gelu = ctx.exact_gelu

        def ref(x, *leaves):
            return convnext_block_ref(x, unflatten_params(leaves), exact_gelu)

        return (None, *plain_backward(ref, ctx.saved_tensors,
                                      ctx.needs_input_grad[1:], grad_out))


def convnext_block(x: torch.Tensor, p: dict, exact_gelu: bool = False,
                   method: str = "auto") -> torch.Tensor:
    """One ConvNeXt block on x (B,H,W,C) with the parameters p. method
    "auto": the kernel on a CUDA tensor, the plain version on a CPU tensor;
    "pallas": the kernel, raises for a CPU tensor; "ref": the composition.
    "auto" and "pallas" are differentiable through the composition."""
    if method == "ref":
        return convnext_block_ref(x, p, exact_gelu)
    if method not in ("auto", "pallas"):
        raise ValueError(f"convnext_block: unknown method {method!r}")
    if not x.is_cuda:
        if method == "pallas":
            raise ValueError("convnext_block: method 'pallas' is the CUDA "
                             f"kernel and x is on {x.device}")
        if x.device.type != "cpu":
            raise ValueError(f"convnext_block: no kernel for device "
                             f"{x.device}")
    return _ConvNeXtBlock.apply(exact_gelu, x, *flatten_params(p))
