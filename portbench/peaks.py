"""Published peaks the benchmark's roofline shares divide by (NVIDIA's
data sheet, H100 SXM5 80 GB, at its 700 W limit)."""

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12, "power_limit_w": 700.0},
}


def for_card(name: str) -> dict:
    """The peaks of the card ``torch.cuda.get_device_name`` names; an
    unknown card has none, and shares against it are not reported."""
    return PEAKS.get(name, {})
