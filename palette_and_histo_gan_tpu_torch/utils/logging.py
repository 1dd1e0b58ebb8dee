"""TensorBoard logging on the host.

The train chunk returns its metrics; this module writes them with
tensorboardX, keeping the reference's conventions:
  - scalar names generator/{total,adversarial,l1,histogram,segmentation}_loss,
    discriminator/{total,real,fake}_loss, fid/{train,test},
    l1-evaluation/{train,test};
  - the reference's quantized scalar step (step // update_steps) through
    `quantize_step`;
  - the custom-scalars layout that groups the FID and L1 charts;
  - the log folder <temp>/logs/<architecture>/<model>/<timestamp>.

Without tensorboardX it writes JSON lines instead.
"""

from __future__ import annotations

import datetime
import json
import os
from typing import Mapping


class MetricsWriter:
    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._tb = None
        self._jsonl = None
        try:
            from tensorboardX import SummaryWriter

            self._tb = SummaryWriter(log_dir)
            self._add_layout()
        except Exception:
            self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")

    def _add_layout(self):
        """Custom-scalars layout: FID and L1 train/test multiline charts."""
        try:
            layout = {
                "Fréchet Inception Distance": {
                    "FID for train and test": ["Multiline", [r"fid/.*"]],
                },
                "L1 Evaluation": {
                    "L1 for train and test": ["Multiline", [r"l1-evaluation/.*"]],
                },
            }
            self._tb.add_custom_scalars(layout)
        except Exception:
            pass

    def scalars(self, metrics: Mapping[str, float], step: int) -> None:
        if self._tb is not None:
            for name, value in metrics.items():
                self._tb.add_scalar(name, float(value), step)
        else:
            rec = {"step": int(step)}
            rec.update({k: float(v) for k, v in metrics.items()})
            self._jsonl.write(json.dumps(rec) + "\n")
            self._jsonl.flush()

    def image(self, name: str, image_hwc_uint8, step: int) -> None:
        if self._tb is not None:
            self._tb.add_image(name, image_hwc_uint8, step, dataformats="HWC")

    def flush(self) -> None:
        if self._tb is not None:
            self._tb.flush()
        elif self._jsonl is not None:
            self._jsonl.flush()

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
        if self._jsonl is not None:
            self._jsonl.close()


def make_writer(config) -> tuple[MetricsWriter, str]:
    """Writer at <temp>/logs/<arch>/<model>/<timestamp>."""
    now_string = datetime.datetime.now().strftime("%Y%m%d-%H%M%S")
    log_dir = os.path.join(
        config.temp_folder, "logs", config.architecture_name, config.model, now_string
    )
    return MetricsWriter(log_dir), now_string


def quantize_step(step: int, update_steps: int) -> int:
    """The reference logs train scalars at step // update_steps."""
    return int(step) // int(update_steps)
