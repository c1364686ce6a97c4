"""Runtime environment report (counterpart of
``datamining_recblr_tpu/utils/env.py``): the backend, the devices, the
card's name and power limit as ``nvidia-smi`` reads them, the software
versions and the device memory, peak and total."""

from __future__ import annotations

import platform
import subprocess

import torch


def _smi() -> list[str]:
    """``nvidia-smi --query-gpu=name,power.limit`` lines, [] without one."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return []
    return [line.strip() for line in out.splitlines() if line.strip()]


def environment_report(device=None) -> dict:
    """{backend, device_count, devices, nvidia_smi, python, torch, cuda,
    memory: [{device, peak_bytes_in_use, bytes_limit}]}; ``backend`` is
    "cuda" when a card is visible, else "cpu"."""
    cuda = torch.cuda.is_available()
    count = torch.cuda.device_count() if cuda else 0
    report = {
        "backend": "cuda" if cuda else "cpu",
        "device_count": count if cuda else 1,
        "devices": ([torch.cuda.get_device_name(i) for i in range(count)] if cuda
                    else [platform.processor() or "cpu"]),
        "nvidia_smi": _smi() if cuda else [],
        "python": platform.python_version(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "memory": [],
    }
    for i in range(count):
        _, total = torch.cuda.mem_get_info(i)
        report["memory"].append({"device": f"cuda:{i}",
                                 "peak_bytes_in_use": torch.cuda.max_memory_allocated(i),
                                 "bytes_limit": total})
    return report


def format_environment(report: dict | None = None) -> str:
    report = report or environment_report()
    lines = [f"backend={report['backend']} devices={report['device_count']} "
             f"torch={report['torch']} cuda={report['cuda']} python={report['python']}"]
    lines += [f"  nvidia-smi: {line}" for line in report.get("nvidia_smi", [])]
    for m in report.get("memory", []):
        lines.append(f"  {m['device']}: peak {m['peak_bytes_in_use'] / 2**30:.2f} GiB / "
                     f"{m['bytes_limit'] / 2**30:.2f} GiB")
    return "\n".join(lines)
