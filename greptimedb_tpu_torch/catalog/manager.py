"""Catalog: database -> table name -> Table (the subset of the JAX
package's CatalogManager that the PromQL engine reads: `table` and
`maybe_table`). Tables are registered as built; DDL, persistence and
drops belong to the instance slice."""

from __future__ import annotations

import threading

from greptimedb_tpu_torch.errors import TableNotFoundError


class CatalogManager:
    def __init__(self):
        self._databases: dict[str, dict[str, object]] = {}
        self._lock = threading.Lock()

    def register(self, table, database: str | None = None):
        """Add `table` under `database` (default: the table's own) and
        return it; a second table of the same name replaces the first."""
        db = database if database is not None else table.database
        with self._lock:
            self._databases.setdefault(db, {})[table.name] = table
        return table

    def table(self, database: str, name: str):
        with self._lock:
            try:
                return self._databases[database][name]
            except KeyError:
                raise TableNotFoundError(
                    f"table not found: {database}.{name}") from None

    def maybe_table(self, database: str, name: str):
        with self._lock:
            return self._databases.get(database, {}).get(name)
