"""The card a run measured on, for every report that prints a number.

A card may be set below its maximum power limit and then runs slower under
load, so the card's name and power limit go beside every measurement.
"""

from __future__ import annotations

import subprocess


def card_info() -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` for
    the first card (e.g. "NVIDIA H200, 700.00 W"), or "no nvidia-smi" where
    the tool is missing (CPU-only machines)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout
    except (OSError, subprocess.SubprocessError):
        return "no nvidia-smi"
    lines = [line.strip() for line in out.splitlines() if line.strip()]
    return lines[0] if lines else "no nvidia-smi"
