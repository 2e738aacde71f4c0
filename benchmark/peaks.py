"""Published peaks of the cards the benchmark knows: NVIDIA data sheets,
dense rates without sparsity, at the full power limit. A share of a peak is
stated against these, with the card's power limit printed beside it."""
from __future__ import annotations

# card name fragment: (HBM bytes/s, fp32 FLOP/s outside the tensor cores,
# bf16 FLOP/s of the tensor cores); the first fragment found in the name wins
PEAKS = (
    ("H100 PCIe", (2.0e12, 51e12, 756e12)),
    ("H100 NVL", (3.9e12, 60e12, 835e12)),
    ("H100", (3.35e12, 67e12, 989e12)),     # SXM5, "NVIDIA H100 80GB HBM3"
)


def peaks_for(card_name: str) -> dict:
    """{"bytes_per_s", "fp32_flops", "bf16_flops"} of the card, or a
    RuntimeError for a card the table lacks (no share is made up)."""
    for key, (bw, fp32, bf16) in PEAKS:
        if key in card_name:
            return {"bytes_per_s": bw, "fp32_flops": fp32, "bf16_flops": bf16}
    raise RuntimeError(f"no published peaks for card {card_name!r}")
