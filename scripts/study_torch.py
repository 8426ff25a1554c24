"""Helpers shared by the port's study scripts (``scripts/*_torch.py``).

* :func:`parse_seeds`: ``"0,1,2"`` or ``"0-15"`` (or a mix) as a list;
* :func:`open_device`: the torch device a script runs on, refusing
  ``cuda`` without a card (``--device cpu`` runs the CPU tests' sizes);
* :func:`record_path`: an output path, refusing any that would overwrite a
  reference record (a file under ``results/`` whose name lacks ``_torch``);
* :func:`card_fields`: the ``device`` and ``power_limit`` keys of a record.
"""

from __future__ import annotations

import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))

from scale1m_torch import card_fields  # noqa: E402,F401


def parse_seeds(text: str) -> list[int]:
    """Comma-separated seeds, each a number or an inclusive range ``a-b``."""
    seeds = []
    for part in (p.strip() for p in text.split(",") if p.strip()):
        lo, _, hi = part.partition("-")
        seeds += list(range(int(lo), int(hi) + 1)) if hi else [int(lo)]
    return seeds


def open_device(torch, name: str):
    """``torch.device(name)``; exits non-zero for a CUDA device when none is
    available, and never falls back to the CPU."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        sys.exit(f"--device {name}: no CUDA device is available "
                 f"(--device cpu runs the CPU tests' sizes)")
    return device


def record_path(path: str) -> str:
    """``path`` if writing there overwrites no reference record; exits
    non-zero otherwise.  A reference record is an existing file whose name
    lacks ``_torch``: the port's records all carry it."""
    if os.path.exists(path) and "_torch" not in os.path.basename(path):
        sys.exit(f"refusing to overwrite {path}: it is not a record of the port "
                 f"(its name lacks _torch)")
    return path


def write_record(path: str, record: dict) -> None:
    """``record`` as indented JSON at ``path`` (:func:`record_path` checked)."""
    record_path(path)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as fh:
        json.dump(record, fh, indent=1)
    print(f"wrote {path}", flush=True)
