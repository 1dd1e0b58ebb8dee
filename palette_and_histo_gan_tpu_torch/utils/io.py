"""Filesystem helpers and time formatting for the training log
(palette_and_histo_gan_tpu/utils/io.py)."""

from __future__ import annotations

import os
import shutil


def ensure_folder_structure(*folders: str) -> str:
    """Create the nested folders, relative to the working directory unless
    absolute, and return the path."""
    path = os.path.join(os.getcwd(), *folders)
    os.makedirs(path, exist_ok=True)
    return path


def delete_folder(path: str) -> None:
    """rm -rf, ignoring errors."""
    shutil.rmtree(path, ignore_errors=True)


def seconds_to_human_readable(time: float) -> str:
    """'[D day(s), ][HHh:]MMm:SSs', as the reference prints it."""
    days = time // 86400
    hours = time // 3600 % 24
    minutes = time // 60 % 60
    seconds = time % 60

    time_string = ""
    if days > 0:
        time_string += f"{days:.0f} day{'s' if days > 1 else ''}, "
    if hours > 0 or days > 0:
        time_string += f"{hours:02.0f}h:"
    time_string += f"{minutes:02.0f}m:{seconds:02.0f}s"
    return time_string
