"""Append-only refinement ledger of the port (LEDGER_TORCH.json).

The counterpart of ipde_tpu.utils.ledger: each study's block is keyed by
"<study>@<device>", the card's name (``torch.cuda.get_device_name``) or
``cpu``, and rows are merged by the study's key fields: re-running one size
refreshes its row and keeps the others.  Every row carries the ``device``
and ``power_limit`` that ``nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader`` reports (``cpu`` and None on the host), because a
card may be set below its maximum power and then runs slower.  The port
never writes ipde_tpu's LEDGER_TPU.json.
"""

from __future__ import annotations

import json
import os
import subprocess
import time

import torch


def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def card(device=None):
    """(name, power limit) of the card ``device`` (None: the first CUDA
    card) as nvidia-smi reports them, or ("cpu", None) for the host."""
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    if dev.type != "cuda":
        return "cpu", None
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", f"--id={dev.index or 0}"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    name, limit = (v.strip() for v in out.strip().splitlines()[0].split(","))
    return name, limit


def record(study: str, rows: list, key_fields: tuple, path: str = None,
           device=None):
    """Merge ``rows`` into LEDGER_TORCH.json (or ``path``) under
    "<study>@<card name>" (``@cpu`` on the host; ``device`` None: the first
    CUDA card).  Rows whose key_fields tuple matches an existing row
    replace it; all other existing rows are kept.  Each row gets
    ``device`` and ``power_limit``.  Returns the merged block."""
    name, limit = card(device)
    rows = [dict(r, device=name, power_limit=limit) for r in rows]
    path = path or os.path.join(_repo_root(), "LEDGER_TORCH.json")
    ledger = {}
    if os.path.exists(path):
        with open(path) as fh:
            ledger = json.load(fh)
    block_key = f"{study}@{name}"
    key = lambda r: tuple(r.get(k) for k in key_fields)  # noqa: E731
    new_keys = {key(r) for r in rows}
    merged = [r for r in ledger.get(block_key, {}).get("rows", [])
              if key(r) not in new_keys] + rows
    merged.sort(key=lambda r: tuple((v is None, v) for v in key(r)))
    ledger[block_key] = {"rows": merged, "device": name,
                         "date": time.strftime("%Y-%m-%d")}
    tmp = path + f".tmp{os.getpid()}"
    with open(tmp, "w") as fh:
        json.dump(ledger, fh, indent=1)
    os.replace(tmp, path)
    return ledger[block_key]
