"""The yardstick's counts against the repo's own: the kernels' bytes and
operations against chip_smoke.py's arithmetic at its shapes (the one
stated change: dw7x7's bf16 operations go against the bf16 peak, not the
fp32 one), and the model's FLOPs against the port's `count_flops`."""
from __future__ import annotations

import sys

import pytest
import torch

from benchmark import flops, harness, peaks, roofline, weights

H100 = peaks.peaks_for("NVIDIA H100 80GB HBM3")


@pytest.fixture(scope="module")
def smoke():
    sys.path.insert(0, harness.ROOT)
    import chip_smoke
    return chip_smoke


def _exp(name):
    return harness.load_json(f"{harness.BENCH}/configs/{name}.json")[
        "exp_fields"]


def test_peaks_are_chip_smokes(smoke):
    assert smoke.peaks_for("NVIDIA H100 80GB HBM3")[1] == (
        H100["bytes_per_s"], H100["fp32_flops"], H100["bf16_flops"])


def test_dw7x7_calls_and_bounds(smoke):
    from unicorn_torch.ops.dwconv7x7 import PATH_SHAPES

    calls = roofline.dw7x7_calls(_exp("unicorn_track_tiny"), 1, "serve")
    assert [((H, W, C), n) for (_, H, W, C), n in calls] == list(PATH_SHAPES)
    bw, fp32 = H100["bytes_per_s"], H100["fp32_flops"]
    # chip_smoke.py kernels_dw7x7: bytes (2 numel + 50 C) x 2, operations
    # 2 x 49 x numel, against the fp32 peak
    want = sum(n * smoke.roofline((2 * H * W * C + 50 * C) * 2,
                                  2 * 49 * H * W * C, bw, fp32)[0] / 1e3
               for (H, W, C), n in PATH_SHAPES) / sum(n for _, n in
                                                     PATH_SHAPES)
    same_peak = dict(H100, bf16_flops=fp32)
    assert roofline.dw7x7_bound_per_launch(calls, same_peak) == \
        pytest.approx(want, rel=1e-12)
    # at the bf16 peak every launch is bound by its bytes
    assert roofline.dw7x7_bound_per_launch(calls, H100) < want
    train = roofline.dw7x7_calls(_exp("unicorn_track_large"), 2, "train")
    assert sum(n for _, n in train) == 90   # 36 blocks x 2 (remat) + 18


def test_correlation_train_bounds(smoke):
    e = _exp("unicorn_track_large")
    B, N, C, K = smoke.TRAIN_SHAPE
    assert (2, (800 // 8) * (1280 // 8), e["embed_dim"], 1) == (B, N, C, K)
    bw, fp32 = H100["bytes_per_s"], H100["fp32_flops"]
    # chip_smoke.py kernels_correlation_train's `work` at TRAIN_SHAPE
    nb_in = (2 * B * N * C + B * K * N) * 4
    nb_bwd = nb_in + (B * N + B * K * N + B * N) * 4
    want = {"fwd_lse": (nb_in + (B * K * N + B * N) * 4,
                        2 * B * N * N * (C + K)),
            "bwd_i": (nb_bwd + (B * N * C + B * K * N) * 4,
                      2 * B * N * N * (2 * C + 2 * K)),
            "bwd_j": (nb_bwd + B * N * C * 4, 2 * B * N * N * (2 * C + K))}
    got = roofline.correlation_train_bounds(e, 2, H100)
    for k, (nb, fl) in want.items():
        assert got[k] == pytest.approx(
            smoke.roofline(nb, fl, bw, fp32)[0] / 1e3, rel=1e-12)


def test_model_flops_match_the_ports_count():
    from unicorn_torch.utils.model_utils import count_flops

    cfg = harness.load_json(f"{harness.BENCH}/configs/unicorn_track_tiny.json")
    cfg["exp_fields"].update(input_size=[64, 96], test_size=[64, 96],
                             bf16=False, serve_interact_bf16=False)
    exp = harness.program_exp(cfg)
    m = weights.load_seeded(harness.program_model(exp, "cpu", True), 1,
                            6.0).eval()
    ported = count_flops(m.forward_whole, torch.zeros(1, 3, 64, 96))
    assert flops.serve_flops_per_frame(cfg) == pytest.approx(ported,
                                                             rel=1e-3)
