"""Region manifest: versioned action log + periodic checkpoints (the JAX
package's storage/manifest.py, JSON as there).

State tracked per region: SST list, flushed WAL entry id, series-registry
snapshot, truncation marker, schema version.
"""

from __future__ import annotations

import json
import logging
from dataclasses import dataclass, field

from greptimedb_tpu_torch.storage.object_store import ObjectStore
from greptimedb_tpu_torch.storage.sst import SstMeta

_log = logging.getLogger("greptimedb_tpu_torch.storage.manifest")


@dataclass
class ManifestState:
    ssts: list[SstMeta] = field(default_factory=list)
    flushed_entry_id: int = -1
    truncated_entry_id: int = -1
    series_snapshot: dict | None = None
    schema: dict | None = None
    committed_sequence: int = 0

    def to_json(self) -> dict:
        return {
            "ssts": [s.to_json() for s in self.ssts],
            "flushed_entry_id": self.flushed_entry_id,
            "truncated_entry_id": self.truncated_entry_id,
            "series_snapshot": self.series_snapshot,
            "schema": self.schema,
            "committed_sequence": self.committed_sequence,
        }

    @staticmethod
    def from_json(d: dict) -> "ManifestState":
        return ManifestState(
            ssts=[SstMeta.from_json(s) for s in d.get("ssts", [])],
            flushed_entry_id=d.get("flushed_entry_id", -1),
            truncated_entry_id=d.get("truncated_entry_id", -1),
            series_snapshot=d.get("series_snapshot"),
            schema=d.get("schema"),
            committed_sequence=d.get("committed_sequence", 0),
        )


def apply_action(state: ManifestState, action: dict) -> None:
    kind = action["kind"]
    if kind == "flush":
        state.ssts.extend(SstMeta.from_json(s) for s in action["add_ssts"])
        state.flushed_entry_id = action["flushed_entry_id"]
        state.committed_sequence = action.get(
            "committed_sequence", state.committed_sequence
        )
        if action.get("series_snapshot") is not None:
            state.series_snapshot = action["series_snapshot"]
    elif kind == "compact":
        removed = set(action["remove_files"])
        state.ssts = [s for s in state.ssts if s.file_id not in removed]
        state.ssts.extend(SstMeta.from_json(s) for s in action["add_ssts"])
    elif kind == "truncate":
        state.ssts = []
        state.truncated_entry_id = action["truncated_entry_id"]
        state.series_snapshot = action.get("series_snapshot",
                                           state.series_snapshot)
    elif kind == "alter":
        state.schema = action["schema"]
    elif kind == "edit":
        # generic edit: replace any field
        for k, v in action.get("set", {}).items():
            setattr(state, k, v)
    else:
        raise ValueError(f"unknown manifest action: {kind}")


class RegionManifest:
    """Action files <prefix>/<version>.json; checkpoint at
    <prefix>/_checkpoint.json covering versions <= its `version`.

    Recovery loads the latest checkpoint and replays only the edit
    suffix above it; a torn/corrupt checkpoint object degrades to a
    full replay of the retained edit files with a warning instead of a
    crash. Concurrency contract: every commit (flush/compact/truncate/
    alter) and explicit checkpoint() runs under the owning region's
    lock — the manifest commit lock — which linearizes checkpoint
    writes against edit appends; the manifest itself adds no second
    lock."""

    def __init__(self, store: ObjectStore, prefix: str,
                 *, checkpoint_distance: int | None = None):
        from greptimedb_tpu_torch.storage.recovery import (
            DEFAULT_CHECKPOINT_INTERVAL,
        )

        self.store = store
        self.prefix = prefix.rstrip("/")
        self.checkpoint_distance = (
            DEFAULT_CHECKPOINT_INTERVAL if checkpoint_distance is None
            else int(checkpoint_distance)
        )
        self.state = ManifestState()
        self.version = -1
        self._ckpt_version = -1
        self._load()

    def _path(self, version: int) -> str:
        return f"{self.prefix}/{version:012d}.json"

    @property
    def _ckpt_path(self) -> str:
        return f"{self.prefix}/_checkpoint.json"

    def _load(self):
        if self.store.exists(self._ckpt_path):
            try:
                obj = json.loads(self.store.read(self._ckpt_path))
                state = ManifestState.from_json(obj["state"])
                version = int(obj["version"])
            except Exception as e:  # noqa: BLE001 - torn checkpoint
                # fall back to replaying every retained edit file from
                # scratch; edits the checkpoint had already absorbed
                # (and trimmed) are unrecoverable, but a readable
                # suffix beats refusing to open the region
                _log.warning(
                    "torn manifest checkpoint %s (%s); falling back to "
                    "full edit replay", self._ckpt_path, e,
                )
            else:
                self.state = state
                self.version = self._ckpt_version = version
        edits = []
        for meta in self.store.list(self.prefix + "/"):
            name = meta.path.rsplit("/", 1)[-1]
            if not name.endswith(".json") or name.startswith("_"):
                continue
            edits.append((int(name[:-5]), meta.path))
        # replay in VERSION order explicitly — every ObjectStore.list
        # sorts by path today, but a later out-of-order listing would
        # silently skip lower versions through the guard below
        for v, path in sorted(edits):
            if v <= self.version:
                continue
            action = json.loads(self.store.read(path))
            apply_action(self.state, action)
            self.version = v

    def commit(self, action: dict) -> int:
        """Persist one action and apply it; maybe checkpoint."""
        v = self.version + 1
        self.store.write(self._path(v), json.dumps(action).encode())
        apply_action(self.state, action)
        self.version = v
        if v - self._ckpt_version >= self.checkpoint_distance:
            self.checkpoint()
        return v

    def checkpoint(self):
        self.store.write(
            self._ckpt_path,
            json.dumps({"version": self.version,
                        "state": self.state.to_json()}).encode(),
        )
        # drop covered action files
        for meta in self.store.list(self.prefix + "/"):
            name = meta.path.rsplit("/", 1)[-1]
            if name.endswith(".json") and not name.startswith("_"):
                if int(name[:-5]) <= self.version:
                    self.store.delete(meta.path)
        self._ckpt_version = self.version
