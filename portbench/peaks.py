"""Peak rates of the cards the benchmark knows: a frozen copy of
``chip_smoke.py``'s ``BANDWIDTH`` table (device memory bytes/s by card
name, NVIDIA data sheets) and its lookup."""

BANDWIDTH = (
    ("H200", 4.8e12),
    ("H100 NVL", 3.9e12),
    ("H100 PCIe", 2.0e12),
    ("H100", 3.35e12),  # SXM (HBM3)
)


def bandwidth_for(name: str) -> float | None:
    """Device memory bytes/s of the card ``name``; None for a card the
    table lacks (a roofline share is then not reported)."""
    for key, bw in BANDWIDTH:
        if key in name:
            return bw
    return None
