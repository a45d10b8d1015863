"""Anonymous usage reporting (disabled by default).

Capability counterpart of the reference's greptimedb-telemetry crate
(GreptimeDB's src/common/greptimedb-telemetry/src/lib.rs:29-34): a
persisted random install uuid + a small JSON payload (version, os,
arch, mode, node counts) POSTed to a configurable endpoint every
`interval_s`. Nothing is sent unless explicitly enabled.
"""

from __future__ import annotations

import json
import os
import platform
import threading

import uuid

from greptimedb_tpu_torch.version import __version__

from greptimedb_tpu_torch import concurrency

UUID_FILE_NAME = ".greptimedb-telemetry-uuid"


def install_uuid(data_home: str) -> str:
    """Stable random id persisted in the data home (never derived from
    any host identity)."""
    path = os.path.join(data_home, UUID_FILE_NAME)
    try:
        with open(path) as f:
            val = f.read().strip()
        if val:
            return val
    except OSError:
        pass
    val = str(uuid.uuid4())
    os.makedirs(data_home, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(val)
    os.replace(tmp, path)
    return val


def build_payload(data_home: str, *, mode: str = "standalone",
                  nodes: int = 1) -> dict:
    return {
        "uuid": install_uuid(data_home),
        "version": __version__,
        "os": platform.system().lower(),
        "arch": platform.machine(),
        "mode": mode,
        "nodes": nodes,
    }


class TelemetryTask:
    """Background reporter. `endpoint` is an http(s) URL; a report that
    fails is dropped silently (reporting must never affect the node)."""

    def __init__(self, data_home: str, *, endpoint: str,
                 interval_s: float = 1800.0, mode: str = "standalone",
                 nodes: int = 1):
        self.data_home = data_home
        self.endpoint = endpoint
        self.interval_s = max(1.0, float(interval_s))
        self.mode = mode
        self.nodes = nodes
        self.reports_sent = 0
        self._stop = concurrency.Event()
        self._thread: threading.Thread | None = None

    def start(self):
        self._thread = concurrency.Thread(
            target=self._loop, daemon=True, name="telemetry-report"
        )
        self._thread.start()
        return self

    def report_once(self) -> bool:
        import urllib.request

        try:
            # payload build included: install_uuid touches the data home
            # and an unwritable disk must not kill the reporter thread
            body = json.dumps(build_payload(
                self.data_home, mode=self.mode, nodes=self.nodes
            )).encode()
            req = urllib.request.Request(
                self.endpoint, data=body,
                headers={"Content-Type": "application/json"},
            )
            with urllib.request.urlopen(req, timeout=10):
                pass
            self.reports_sent += 1
            return True
        except Exception:
            return False

    def _loop(self):
        # first report shortly after start, like the reference
        if not self._stop.wait(5.0):
            self.report_once()
        while not self._stop.wait(self.interval_s):
            self.report_once()

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
