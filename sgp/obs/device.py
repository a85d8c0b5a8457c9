"""Peak rates of the accelerators this program is measured on, keyed by
the ``device_kind`` string JAX reports.

Roofline shares and MFU divide measured times by these peaks, so a
device missing from the table is an error, never a default.
"""
from __future__ import annotations

# NVIDIA H100 Tensor Core GPU data sheet, SXM5 part: dense rates (no
# sparsity) at the full 700 W power limit
_H100_SXM = {
    "bf16_flops": 989e12,       # tensor cores, bf16/fp16 inputs
    "tf32_flops": 495e12,       # tensor cores, f32 at default precision
    "fp32_flops": 67e12,        # CUDA cores, f32 at precision "highest"
    "hbm_bytes_s": 3.35e12,
    "hbm_bytes": 80e9,
    "source": "NVIDIA H100 data sheet, SXM5, dense",
}

PEAKS = {
    "NVIDIA H100 80GB HBM3": _H100_SXM,
}


def device_peaks(device_kind: str) -> dict:
    """The data-sheet peaks of ``device_kind``; raises ``KeyError`` for a
    device not in :data:`PEAKS`."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(
            f"no peak rates for device kind {device_kind!r}; add its "
            f"data-sheet row to sgp/obs/device.py") from None
