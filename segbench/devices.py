"""The card: synchronising, memory peaks, and its name and power limit.

On a CPU device (the tests' small runs) the device calls do nothing.
"""

from __future__ import annotations

import subprocess
import sys
import time

import torch


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def reset_peak(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def peak_bytes(device: torch.device) -> int:
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


def free(device: torch.device) -> None:
    """Return the caching allocator's free blocks to the card."""
    if device.type == "cuda":
        torch.cuda.empty_cache()


def power_limit_w():
    """The first card's power limit in watts as ``nvidia-smi`` reads it
    (None where it cannot)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=60, check=True).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


class Phases:
    """Prints how long each phase of a set-up took, on standard error, the
    device synchronised at each mark."""

    def __init__(self, device: torch.device):
        self.device = device
        self.t = time.perf_counter()

    def mark(self, phase: str) -> None:
        synchronize(self.device)
        now = time.perf_counter()
        print(f"segbench: set-up {phase} {now - self.t:.3f} s", file=sys.stderr)
        self.t = now
