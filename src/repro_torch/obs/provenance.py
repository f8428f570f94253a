"""Run provenance: the environment fingerprint stamped into every recorded
trace (counterpart of ``repro.obs.provenance``, with the port's own
fields).  Every lookup is guarded: a missing git binary, a checkout
outside git or a host without CUDA degrades to ``"unknown"`` / 0, never
an exception."""
from __future__ import annotations

import os
import subprocess
import time


def _git_sha() -> str:
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=5)
        if out.returncode == 0:
            return out.stdout.strip()
    except Exception:
        pass
    return "unknown"


def provenance() -> dict:
    """Environment fingerprint: torch and CUDA versions, backend (``cuda``
    when a card is visible, else ``cpu``), device kind and count, git SHA,
    wall-clock timestamp."""
    rec = {
        "torch_version": "unknown",
        "cuda_version": None,
        "backend": "unknown",
        "device_kind": "unknown",
        "device_count": 0,
        "git_sha": _git_sha(),
        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
    }
    try:
        import torch
        rec["torch_version"] = torch.__version__
        rec["cuda_version"] = torch.version.cuda
        if torch.cuda.is_available():
            rec["backend"] = "cuda"
            rec["device_count"] = torch.cuda.device_count()
            rec["device_kind"] = torch.cuda.get_device_name(0)
        else:
            rec["backend"] = "cpu"
            rec["device_kind"] = "cpu"
            rec["device_count"] = 1
    except Exception:
        pass
    return rec


__all__ = ["provenance"]
