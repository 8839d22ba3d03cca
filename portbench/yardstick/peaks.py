"""Published peaks of the cards the benchmark measures, copied from the
vendor's data sheet so that the yardstick cannot move with the program.

NVIDIA H100 SXM5 80 GB (data sheet, at the full 700 W power limit): 3.35
TB/s of HBM3, 67 TFLOP/s in float32 outside the tensor cores.
"""

from __future__ import annotations

PEAKS = {
    "H100": {"hbm_bytes_per_s": 3.35e12, "f32_flop_per_s": 67e12},
}


def peaks_for(device_name: str):
    """The peaks of the card whose name (torch.cuda.get_device_name) holds
    a key of PEAKS, or None: a share of an unknown card's peak is not
    reported."""
    for key, peaks in PEAKS.items():
        if key.lower() in device_name.lower():
            return peaks
    return None
