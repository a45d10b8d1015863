"""Secondary tag-index dataplane (a copy of the JAX package's index/).

- tag_index: per-registry inverted index — tag-value -> sid postings
  over the dictionary-coded label plane, version-validated, with a
  memoized per-matcher-set sid cache. `match_sids(registry, matchers)`
  is the one entry point every scan path routes through.
- device_plane: the label plane kept resident on the card so PromQL
  matcher masks are computed there (ok-tables move, series don't).
"""

from greptimedb_tpu_torch.index.tag_index import (  # noqa: F401
    TagIndex,
    configure,
    device_plane_enabled,
    enabled,
    index_for,
    match_mask,
    match_sids,
    matcher_key,
)
from greptimedb_tpu_torch.index import device_plane  # noqa: F401
