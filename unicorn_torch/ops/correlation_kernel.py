"""Fused correlation softmax + label propagation: the hand-written CUDA
kernel (csrc/correlation.cu) and its plain PyTorch version.

Port of `correlation_propagate_pallas` / `_corr_kernel`
(unicorn_tpu/ops/pallas_correlation.py:72, :24) and of the dispatch
`correlation_propagate_auto` (:138):

    out[b, k, j] = sum_i v[b, k, i] * softmax_i(e0[b, i] . e1[b, j])

without the N x N scores ever reaching device memory. With `bf16_dots` the
embeddings are rounded to bf16 and a score is the fp32 sum of exact bf16
products; without it the products are fp32. Max, exp, denominator, the
v * p sum and the output are fp32 in both settings.

`correlation_propagate_auto` launches the kernel for a CUDA tensor and takes
the plain streaming version only for a tensor on the CPU; a CUDA tensor the
kernel does not take raises. It is the serving kernel and is forward only.

Training goes through `correlation_propagate_train`, the port of
`correlation_propagate_train` / `correlation_propagate_pallas_vjp` (:425,
:277): an autograd Function over three more hand-written kernels
(csrc/correlation_train.cu), all with fp32 products:

    correlation_fwd_lse   `_corr_fwd_lse_kernel` (:156): the same forward plus
                          lse[b, 0, j] = log sum_i exp(e0[b, i] . e1[b, j])
    correlation_bwd_i     `_corr_bwd_i_kernel` (:191): dE0 and dV
    correlation_bwd_j     `_corr_bwd_j_kernel` (:231): dE1

Each has a plain streaming PyTorch version of the same signature beside it
(`*_plain`), which the tests and chip_smoke.py hold it against.

The kernels take at most K_MAX label maps and C a multiple of 16 (serving)
or 4 (training). Like the JAX wrappers, the entry points take any K and C up
to C_MAX / C_MAX_TRAIN: the embeddings are zero-padded to the kernel's
multiple of channels (zero channels leave every score unchanged) and the
label maps go in groups of at most K_MAX, one kernel call a group
(`propagate_grouped`, `fwd_lse_grouped`, `bwd_grouped`, which take the
per-group op as an argument, so that the tests run them on the plain
versions).
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from torch.autograd.function import once_differentiable

from ..utils.profiling import span
from .correlation import correlation_propagate

K_MAX = 16      # label maps per kernel call (1 for SOT; objects for VOS)
C_MAX = 192     # embedding width the kernel's shared-memory tiles allow
C_MAX_TRAIN = 128   # embedding width of the training kernels' register tiles

# kernel launches since the count was last set to 0 (read by chip_smoke.py):
# the serving kernel, and the three training kernels by name
launches = 0
train_launches = {"fwd_lse": 0, "bwd_i": 0, "bwd_j": 0}


def _check_shapes(e0, e1, v):
    if e0.dim() != 3 or e1.shape != e0.shape or v.dim() != 3 or \
            v.shape[0] != e0.shape[0] or v.shape[2] != e0.shape[1]:
        raise ValueError(
            "correlation_propagate: expected e0, e1 (B,N,C) and v (B,K,N); "
            f"got {tuple(e0.shape)}, {tuple(e1.shape)}, {tuple(v.shape)}")


def correlation_propagate_plain(e0, e1, v, bf16_dots: bool = False):
    """Plain PyTorch version with the kernel's arithmetic: e0, e1 rounded to
    bf16 when asked (their products are then exact in fp32), then the
    streaming fp32 softmax. On the card,
    `torch.backends.cuda.matmul.allow_tf32` must be False."""
    _check_shapes(e0, e1, v)
    e0, e1 = e0.float(), e1.float()
    if bf16_dots:
        e0, e1 = e0.bfloat16().float(), e1.bfloat16().float()
    return correlation_propagate(e0, e1, v)


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    from ..csrc import build

    lib = build.load("correlation")
    lib.correlation_forward.argtypes = ([ctypes.c_void_p] * 5
                                        + [ctypes.c_int] * 5
                                        + [ctypes.c_void_p])
    lib.correlation_forward.restype = ctypes.c_int
    lib.correlation_workspace_bytes.argtypes = [ctypes.c_int] * 5
    lib.correlation_workspace_bytes.restype = ctypes.c_size_t
    lib.correlation_error_string.argtypes = [ctypes.c_int]
    lib.correlation_error_string.restype = ctypes.c_char_p
    return lib


def launch(e0, e1, v, out, bf16_dots: bool) -> None:
    """One call of the kernel into out (B,K,N), on arguments that
    correlation_propagate_cuda has checked. With bf16_dots it is two
    launches, counted as one: the prep kernel writes the padded bf16
    embeddings and fp32 labels into a workspace allocated here, then the
    wgmma kernel reads them."""
    global launches
    B, N, C = e0.shape
    K = v.shape[1]
    lib = _lib()
    nbytes = lib.correlation_workspace_bytes(B, N, C, K, int(bf16_dots))
    ws = (torch.empty(nbytes, dtype=torch.uint8, device=e0.device)
          if nbytes else None)
    stream = torch.cuda.current_stream(e0.device).cuda_stream
    err = lib.correlation_forward(e0.data_ptr(), e1.data_ptr(), v.data_ptr(),
                                  out.data_ptr(),
                                  ws.data_ptr() if ws is not None else None,
                                  B, N, C, K, int(bf16_dots), stream)
    if err:
        raise RuntimeError(
            f"correlation launch failed: {err} "
            f"({lib.correlation_error_string(err).decode()}) at B={B} N={N} "
            f"C={C} K={K} bf16_dots={bf16_dots}")
    launches += 1


def _check_cuda(fn: str, ref, **tensors) -> None:
    """Every named tensor is a contiguous, 16-byte aligned float32 tensor on
    ref's CUDA device, or this raises."""
    if not ref.is_cuda:
        raise ValueError(f"{fn}: {next(iter(tensors))} is not a CUDA tensor "
                         f"({ref.device})")
    for name, t in tensors.items():
        if not t.is_cuda or t.device != ref.device:
            raise ValueError(f"{fn}: {name} is not on e0's CUDA device "
                             f"({t.device})")
        if t.dtype != torch.float32:
            raise TypeError(f"{fn}: {name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} is not contiguous (shape "
                             f"{tuple(t.shape)}, strides {t.stride()})")
        if t.data_ptr() % 16:
            raise ValueError(f"{fn}: {name} must be 16-byte aligned")


def _check_k(fn: str, K: int) -> None:
    if not 0 < K <= K_MAX:
        raise ValueError(f"{fn}: K={K} label maps; the kernel takes 1 to "
                         f"{K_MAX}")


def _pad_channels(e, multiple: int):
    """e (B,N,C) zero-padded to a multiple of `multiple` channels."""
    pad = -e.shape[2] % multiple
    return F.pad(e, (0, pad)) if pad else e


def _cat_k(outs):
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def propagate_grouped(op, e0, e1, v, group: int = K_MAX):
    """op(e0, e1, v_g) -> (B, K_g, N) on e0, e1 zero-padded to a multiple of
    16 channels, once for each group of at most `group` label maps. Each
    group's output is an exact slice of the whole, so the outputs are
    concatenated along K."""
    e0, e1 = _pad_channels(e0, 16), _pad_channels(e1, 16)
    return _cat_k([op(e0, e1, vg.contiguous())
                   for vg in v.split(group, dim=1)])


def correlation_propagate_cuda(e0, e1, v, bf16_dots: bool = True):
    """The CUDA kernel on PyTorch's current stream. e0, e1 (B,N,C) and v
    (B,K,N): contiguous float32 CUDA tensors, any N >= 1, C up to C_MAX, any
    K: one kernel call for each group of at most K_MAX label maps. Returns
    (B,K,N) float32."""
    _check_shapes(e0, e1, v)
    _check_cuda("correlation_propagate_cuda", e0, e0=e0, e1=e1, v=v)
    if any(t.requires_grad for t in (e0, e1, v)) and torch.is_grad_enabled():
        raise NotImplementedError(
            "correlation_propagate_cuda is the serving kernel (bf16 dots, "
            "forward only); training goes through correlation_propagate_train")
    B, N, C = e0.shape
    if not 0 < C <= C_MAX:
        raise ValueError(f"correlation_propagate_cuda: C={C} channels; the "
                         f"kernel takes 1 to {C_MAX}")

    def one(a, b, vg):
        out = torch.empty((B, vg.shape[1], N), dtype=torch.float32,
                          device=a.device)
        if out.numel():
            launch(a, b, vg, out, bf16_dots)
        return out
    with span("op.correlation"):
        return propagate_grouped(one, e0, e1, v)


def correlation_propagate_auto(e0, e1, v):
    """Dispatch: on a CUDA tensor the kernel with bf16 dots, whatever N; on
    a CPU tensor the streaming fp32 version."""
    if e0.is_cuda:
        return correlation_propagate_cuda(e0, e1, v, bf16_dots=True)
    if e0.device.type != "cpu":
        raise ValueError(f"correlation_propagate_auto: no kernel for device "
                         f"{e0.device}")
    _check_shapes(e0, e1, v)
    return correlation_propagate(e0, e1, v)


# ---------------------------------------------------------------------------
# training: forward with logsumexp, the two backward passes, the Function
# ---------------------------------------------------------------------------

def _check_bwd_shapes(e0, e1, v, lse, dout, c):
    _check_shapes(e0, e1, v)
    B, N, _ = e0.shape
    if tuple(lse.shape) != (B, 1, N) or tuple(c.shape) != (B, 1, N) or \
            dout.shape != v.shape:
        raise ValueError(
            "correlation backward: expected lse, c (B,1,N) and dout like v; "
            f"got {tuple(lse.shape)}, {tuple(c.shape)}, {tuple(dout.shape)} "
            f"for e0 {tuple(e0.shape)}, v {tuple(v.shape)}")


def correlation_fwd_lse_plain(e0, e1, v, chunk: int = 1024):
    """Plain PyTorch version of the forward-with-logsumexp kernel, streaming
    over chunks of target columns: e0, e1 (B,N,C), v (B,K,N) -> (out (B,K,N),
    lse (B,1,N)), fp32. On the card,
    `torch.backends.cuda.matmul.allow_tf32` must be False."""
    _check_shapes(e0, e1, v)
    e0, v = e0.float(), v.float()
    outs, lses = [], []
    for e1_c in e1.float().split(chunk, dim=1):
        s = torch.einsum("bmc,bnc->bmn", e1_c, e0)       # targets by sources
        lse_c = torch.logsumexp(s, dim=2)
        p = torch.exp(s - lse_c[:, :, None])
        outs.append(torch.einsum("bkn,bmn->bkm", v, p))
        lses.append(lse_c[:, None, :])
    return torch.cat(outs, dim=2), torch.cat(lses, dim=2)


def _bwd_chunks(e0, e1, v, lse, dout, c, chunk):
    """Per chunk of target columns: (its slice, e1 chunk (B,m,C), dO chunk
    (B,K,m), P (B,m,N), dS (B,m,N)), as the backward kernels form them."""
    _check_bwd_shapes(e0, e1, v, lse, dout, c)
    e0, e1, v = e0.float(), e1.float(), v.float()
    N = e0.shape[1]
    for j0 in range(0, N, chunk):
        sl = slice(j0, min(j0 + chunk, N))
        e1_c, do_c = e1[:, sl], dout[:, :, sl].float()
        s = torch.einsum("bmc,bnc->bmn", e1_c, e0)
        p = torch.exp(s - lse[:, 0, sl, None])
        dp = torch.einsum("bkn,bkm->bmn", v, do_c)
        yield sl, e1_c, do_c, p, p * (dp - c[:, 0, sl, None])


def correlation_bwd_i_plain(e0, e1, v, lse, dout, c, chunk: int = 1024):
    """Plain PyTorch version of the source-side backward kernel: (dE0
    (B,N,C), dV (B,K,N)) from the forward's inputs, its lse (B,1,N), the
    output gradient dout (B,K,N) and c = sum_k out * dout (B,1,N)."""
    de0 = torch.zeros_like(e0, dtype=torch.float32)
    dv = torch.zeros_like(v, dtype=torch.float32)
    for _, e1_c, do_c, p, ds in _bwd_chunks(e0, e1, v, lse, dout, c, chunk):
        de0 += torch.einsum("bmn,bmc->bnc", ds, e1_c)
        dv += torch.einsum("bkm,bmn->bkn", do_c, p)
    return de0, dv


def correlation_bwd_j_plain(e0, e1, v, lse, dout, c, chunk: int = 1024):
    """Plain PyTorch version of the target-side backward kernel: dE1
    (B,N,C), arguments as correlation_bwd_i_plain."""
    e0f = e0.float()
    return torch.cat([torch.einsum("bmn,bnc->bmc", ds, e0f) for *_, ds in
                      _bwd_chunks(e0, e1, v, lse, dout, c, chunk)], dim=1)


@functools.cache
def _train_lib() -> ctypes.CDLL:
    """The built training-kernel library with its C signatures declared."""
    from ..csrc import build

    lib = build.load("correlation_train")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.correlation_fwd_lse.argtypes = [ptr] * 5 + [i32] * 4 + [ptr]
    lib.correlation_bwd_i.argtypes = [ptr] * 8 + [i32] * 4 + [ptr]
    lib.correlation_bwd_j.argtypes = [ptr] * 7 + [i32] * 4 + [ptr]
    for fn in (lib.correlation_fwd_lse, lib.correlation_bwd_i,
               lib.correlation_bwd_j):
        fn.restype = i32
    lib.correlation_train_error_string.argtypes = [i32]
    lib.correlation_train_error_string.restype = ctypes.c_char_p
    return lib


def launch_train(name: str, *tensors) -> None:
    """One launch of the training kernel `name` ("fwd_lse", "bwd_i",
    "bwd_j") on checked arguments: `tensors` are the C function's pointer
    arguments in its order, which starts e0 (B,N,C), e1, v (B,K,N)."""
    e0 = tensors[0]
    B, N, C = e0.shape
    K = tensors[2].shape[1]
    lib = _train_lib()
    stream = torch.cuda.current_stream(e0.device).cuda_stream
    err = getattr(lib, f"correlation_{name}")(
        *(t.data_ptr() for t in tensors), B, N, C, K, stream)
    if err:
        raise RuntimeError(
            f"correlation_{name} launch failed: {err} "
            f"({lib.correlation_train_error_string(err).decode()}) at B={B} "
            f"N={N} C={C} K={K}")
    train_launches[name] += 1


def _check_train(fn: str, **tensors) -> None:
    _check_cuda(fn, tensors["e0"], **tensors)
    C, K = tensors["e0"].shape[2], tensors["v"].shape[1]
    if C % 4 or not 0 < C <= C_MAX_TRAIN:
        raise ValueError(f"{fn}: C={C} must be a multiple of 4, at most "
                         f"{C_MAX_TRAIN}")
    _check_k(fn, K)


def correlation_fwd_lse_cuda(e0, e1, v):
    """The forward-with-logsumexp kernel on PyTorch's current stream. e0, e1
    (B,N,C) and v (B,K,N): contiguous float32 CUDA tensors, any N >= 1, C a
    multiple of 4 up to C_MAX_TRAIN, K up to K_MAX. Returns (out (B,K,N),
    lse (B,1,N)) float32."""
    _check_shapes(e0, e1, v)
    _check_train("correlation_fwd_lse_cuda", e0=e0, e1=e1, v=v)
    B, N, _ = e0.shape
    out = torch.empty_like(v)
    lse = torch.empty((B, 1, N), dtype=torch.float32, device=e0.device)
    if out.numel():
        launch_train("fwd_lse", e0, e1, v, out, lse)
    return out, lse


def correlation_bwd_i_cuda(e0, e1, v, lse, dout, c):
    """The source-side backward kernel: (dE0 (B,N,C), dV (B,K,N)). Arguments
    as correlation_bwd_i_plain, contiguous float32 CUDA tensors."""
    _check_bwd_shapes(e0, e1, v, lse, dout, c)
    _check_train("correlation_bwd_i_cuda", e0=e0, e1=e1, v=v, lse=lse,
                 dout=dout, c=c)
    de0, dv = torch.empty_like(e0), torch.empty_like(v)
    if de0.numel():
        launch_train("bwd_i", e0, e1, v, lse, dout, c, de0, dv)
    return de0, dv


def correlation_bwd_j_cuda(e0, e1, v, lse, dout, c):
    """The target-side backward kernel: dE1 (B,N,C). Arguments as
    correlation_bwd_j_plain, contiguous float32 CUDA tensors."""
    _check_bwd_shapes(e0, e1, v, lse, dout, c)
    _check_train("correlation_bwd_j_cuda", e0=e0, e1=e1, v=v, lse=lse,
                 dout=dout, c=c)
    de1 = torch.empty_like(e1)
    if de1.numel():
        launch_train("bwd_j", e0, e1, v, lse, dout, c, de1)
    return de1


TRAIN_KERNELS = (correlation_fwd_lse_cuda, correlation_bwd_i_cuda,
                 correlation_bwd_j_cuda)


def fwd_lse_grouped(fwd, e0, e1, v, group: int = K_MAX):
    """fwd(e0, e1, v_g) -> (out_g, lse) once for each group of at most
    `group` label maps: out concatenated along K; lse does not depend on v,
    so the first group's is kept."""
    outs, lse = [], None
    for vg in v.split(group, dim=1):
        out, lse_g = fwd(e0, e1, vg.contiguous())
        outs.append(out)
        lse = lse_g if lse is None else lse
    return _cat_k(outs), lse


def bwd_grouped(bwd_i, bwd_j, e0, e1, v, out, lse, dout, group: int = K_MAX):
    """(dE0, dE1, dV) from bwd_i and bwd_j, once for each group of at most
    `group` label maps. dS = P (sum_k v_k dO_k - sum_k out_k dO_k) is linear
    in the (v, dO, out) triples, so dE0 and dE1 are the sums of the groups'
    gradients and dV is the groups' slices concatenated; each group takes
    its own c_g = sum over k in g of out_k dO_k (the full c in every group
    would subtract it once per group)."""
    de0 = de1 = None
    dvs = []
    for vg, dg, og in zip(v.split(group, dim=1), dout.split(group, dim=1),
                          out.split(group, dim=1)):
        vg, dg = vg.contiguous(), dg.contiguous()
        c = (og * dg).sum(dim=1, keepdim=True)
        de0_g, dv = bwd_i(e0, e1, vg, lse, dg, c)
        de1_g = bwd_j(e0, e1, vg, lse, dg, c)
        de0 = de0_g if de0 is None else de0 + de0_g
        de1 = de1_g if de1 is None else de1 + de1_g
        dvs.append(dv)
    return de0, de1, _cat_k(dvs)


class _CorrelationTrain(torch.autograd.Function):
    """forward = the fwd-lse op over groups of label maps, on embeddings
    zero-padded to a multiple of 4 channels, saving (e0, e1, v, out, lse) as
    `_corr_vjp_fwd` does; backward = the two backward ops over the same
    groups (`_corr_vjp_bwd`), the padded channels of dE0 and dE1 sliced off.
    `ops` = (fwd_lse, bwd_i, bwd_j): the kernels, or the plain versions."""

    @staticmethod
    def forward(ctx, e0, e1, v, ops, group):
        with span("op.correlation_train"):
            e0p, e1p = _pad_channels(e0, 4), _pad_channels(e1, 4)
            out, lse = fwd_lse_grouped(ops[0], e0p, e1p, v, group)
        ctx.save_for_backward(e0p, e1p, v, out, lse)
        ctx.ops, ctx.group, ctx.channels = ops, group, e0.shape[2]
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        e0, e1, v, out, lse = ctx.saved_tensors
        with span("op.correlation_train.bwd"):
            de0, de1, dv = bwd_grouped(*ctx.ops[1:], e0, e1, v, out, lse,
                                       dout.float().contiguous(), ctx.group)
        C = ctx.channels
        return de0[..., :C], de1[..., :C], dv, None, None


def propagate_train_grouped(e0, e1, v, ops=TRAIN_KERNELS, group: int = K_MAX):
    """The training Function with per-group ops `ops` (fwd_lse, bwd_i,
    bwd_j) over groups of at most `group` label maps."""
    _check_shapes(e0, e1, v)
    return _CorrelationTrain.apply(e0, e1, v, ops, group)


def correlation_propagate_train(e0, e1, v):
    """Differentiable label propagation for training, fp32 throughout: on a
    CUDA tensor the three training kernels (any N >= 1, any K, C up to
    C_MAX_TRAIN; an input they do not take raises), on a CPU tensor the
    plain streaming version under ordinary autograd."""
    if e0.is_cuda:
        return propagate_train_grouped(e0, e1, v)
    if e0.device.type != "cpu":
        raise ValueError(f"correlation_propagate_train: no kernel for device "
                         f"{e0.device}")
    _check_shapes(e0, e1, v)
    return correlation_propagate(e0, e1, v)
