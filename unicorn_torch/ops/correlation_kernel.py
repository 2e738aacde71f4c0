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
kernel does not take raises. Forward only.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .correlation import correlation_propagate

K_MAX = 16      # label maps per call (1 for SOT; the object count for VOS)
C_MAX = 192     # embedding width the kernel's shared-memory tiles allow

# kernel launches since the count was last set to 0 (read by chip_smoke.py)
launches = 0


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
    lib.correlation_forward.argtypes = ([ctypes.c_void_p] * 4
                                        + [ctypes.c_int] * 5
                                        + [ctypes.c_void_p])
    lib.correlation_forward.restype = ctypes.c_int
    lib.correlation_error_string.argtypes = [ctypes.c_int]
    lib.correlation_error_string.restype = ctypes.c_char_p
    return lib


def launch(e0, e1, v, out, bf16_dots: bool) -> None:
    """One launch of the kernel into out (B,K,N), on arguments that
    correlation_propagate_cuda has checked."""
    global launches
    B, N, C = e0.shape
    K = v.shape[1]
    lib = _lib()
    stream = torch.cuda.current_stream(e0.device).cuda_stream
    err = lib.correlation_forward(e0.data_ptr(), e1.data_ptr(), v.data_ptr(),
                                  out.data_ptr(), B, N, C, K, int(bf16_dots),
                                  stream)
    if err:
        raise RuntimeError(
            f"correlation launch failed: {err} "
            f"({lib.correlation_error_string(err).decode()}) at B={B} N={N} "
            f"C={C} K={K} bf16_dots={bf16_dots}")
    launches += 1


def correlation_propagate_cuda(e0, e1, v, bf16_dots: bool = True):
    """The CUDA kernel on PyTorch's current stream. e0, e1 (B,N,C) and v
    (B,K,N): contiguous float32 CUDA tensors, any N >= 1, C a multiple of 16
    up to C_MAX, K up to K_MAX. Returns (B,K,N) float32."""
    _check_shapes(e0, e1, v)
    for name, t in (("e0", e0), ("e1", e1), ("v", v)):
        if not t.is_cuda or t.device != e0.device:
            raise ValueError(f"correlation_propagate_cuda: {name} is not on "
                             f"e0's CUDA device ({t.device})")
        if t.dtype != torch.float32:
            raise TypeError(f"correlation_propagate_cuda: {name} must be "
                            f"float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"correlation_propagate_cuda: {name} is not "
                             f"contiguous (shape {tuple(t.shape)}, strides "
                             f"{t.stride()})")
        if t.data_ptr() % 16:
            raise ValueError(f"correlation_propagate_cuda: {name} must be "
                             "16-byte aligned")
        if t.requires_grad and torch.is_grad_enabled():
            raise NotImplementedError(
                "correlation_propagate_cuda has no backward yet; run under "
                "torch.no_grad() or detach the inputs")
    B, N, C = e0.shape
    K = v.shape[1]
    if C % 16 or not 0 < C <= C_MAX:
        raise ValueError(f"correlation_propagate_cuda: C={C} must be a "
                         f"multiple of 16, at most {C_MAX}")
    if not 0 < K <= K_MAX:
        raise ValueError(f"correlation_propagate_cuda: K={K} label maps; the "
                         f"kernel takes 1 to {K_MAX}")
    out = torch.empty((B, K, N), dtype=torch.float32, device=e0.device)
    if out.numel():
        launch(e0, e1, v, out, bf16_dots)
    return out


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
