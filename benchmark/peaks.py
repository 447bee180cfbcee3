"""The H100's published peaks and the card line printed beside every
number (frozen from speedy_tpu_torch/bench_transform.py at commit 8f72ba0:
``HBM_BYTES_PER_S``, ``PEAK_FLOPS``, ``card_line``).

NVIDIA's data sheet, SXM part, at the full power limit of 700 W: 3.35 TB/s
of HBM3, and 67 TFLOP/s in float32 outside the tensor cores (the path
cuBLAS's SGEMM takes with TF32 off, as the program runs) and in float64 on
the tensor cores (DMMA). A card set below 700 W runs slower under load, so
the card's power limit is printed beside every share of a peak.
"""
from __future__ import annotations

import subprocess

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"fp32": 67e12, "fp64": 67e12}


def card_line() -> str:
    """``name, power.limit`` of the first card, as nvidia-smi prints it
    (empty where nvidia-smi cannot be run)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return ""
    lines = out.stdout.strip().splitlines()
    return lines[0] if lines else ""
