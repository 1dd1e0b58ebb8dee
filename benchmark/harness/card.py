"""The card's name, power limit, clocks and power beside the window, and
the kernels' launch counters."""

from __future__ import annotations

import subprocess

import torch


def card_line(index: int = 0) -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


class Sampler:
    """nvidia-smi sampling SM clock (MHz) and power draw (W) once a second
    in one background process, from start() to stop()."""

    def __init__(self, index: int = 0):
        self.index = index
        self.proc = None
        self.samples: list[tuple[float, float]] = []

    def start(self) -> None:
        self.proc = subprocess.Popen(
            ["nvidia-smi", "-i", str(self.index), "--query-gpu=clocks.sm,power.draw",
             "--format=csv,noheader,nounits", "-lms", "1000"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)

    def stop(self) -> None:
        if self.proc is None:
            return
        self.proc.terminate()
        out, _ = self.proc.communicate(timeout=30)
        self.proc = None
        for line in out.splitlines():
            parts = [p.strip() for p in line.split(",")]
            try:
                self.samples.append((float(parts[0]), float(parts[1])))
            except (ValueError, IndexError):
                continue

    def summary(self) -> str:
        if not self.samples:
            return "no samples"
        clocks = sorted(s[0] for s in self.samples)
        power = sorted(s[1] for s in self.samples)
        return (f"{len(self.samples)} samples: SM clock {clocks[0]:.0f}-{clocks[-1]:.0f} MHz, "
                f"power {power[0]:.1f}-{power[-1]:.1f} W")


def read_launches() -> dict:
    """Every hand-written kernel's launches in this process, by the TPU
    kernel each stands in for, or by its own name where it replaces none
    ("CCE-fwd", "CCE-bwd": the indexed losses) (the port's counters)."""
    from palette_and_histo_gan_tpu_torch.ops import (augment_kernel, histogram_kernel,
                                                      indexed_loss, moments, palette_kernel)

    counters = ((augment_kernel.launches, {"packed": "K1", "rgba": "K2"}),
                (histogram_kernel.launches, {}), (palette_kernel.launches, {}),
                (moments.launches, {}), (indexed_loss.launches, {}))
    return {names.get(k, k): n for counts, names in counters for k, n in counts.items()}


def device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else str(device)
