"""Host-side expression helpers of the query layer (the subset of the JAX
package's query/expr.py that the PromQL path reads)."""

from __future__ import annotations

import functools
import re


@functools.lru_cache(maxsize=1024)
def compile_matcher(pattern: str, flags: int = 0) -> re.Pattern:
    """Memoized regex compile for tag matchers: dashboards repeat the same
    =~ patterns every poll. Compiled patterns are immutable, so sharing is
    safe."""
    return re.compile(pattern, flags)
