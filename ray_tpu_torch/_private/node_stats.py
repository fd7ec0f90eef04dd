"""Per-node physical stats sampling.

Reference: the per-node dashboard agent's reporter module
(`dashboard/agent.py` hosting `reporter_agent.py` — psutil stats pushed
to the head over `reporter.proto`). This runtime is single-language and
the node process already maintains a push channel to the head (the
resource-report loop), so the agent's reporting role rides that channel
instead of a separate process: `sample_node_stats()` piggybacks on every
resource report, and the head keeps the latest sample per node for the
state API / dashboard.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict


def sample_node_stats() -> Dict[str, Any]:
    try:
        import psutil
    except ImportError:  # pragma: no cover
        return {"ts": time.time()}

    try:
        vm = psutil.virtual_memory()
        disk = psutil.disk_usage("/")
        la = os.getloadavg()
        return {
            "ts": time.time(),
            "cpu_percent": psutil.cpu_percent(interval=None),
            "cpu_count": psutil.cpu_count(),
            "load_avg": la,
            "mem_total": vm.total,
            "mem_available": vm.available,
            "mem_percent": vm.percent,
            "disk_total": disk.total,
            "disk_free": disk.free,
            "disk_percent": disk.percent,
            "pid_count": len(psutil.pids()),
        }
    except Exception:  # pragma: no cover — never break the report loop
        return {"ts": time.time()}
