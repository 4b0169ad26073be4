from calitas_tpu_torch.search.hits import (
    ReferenceHit,
    HitBuilder,
    sort_hits,
    remove_overlaps,
    dedup_and_sort,
)

__all__ = [
    "ReferenceHit",
    "HitBuilder",
    "sort_hits",
    "remove_overlaps",
    "dedup_and_sort",
]
