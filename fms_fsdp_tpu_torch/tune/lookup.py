"""Static tile resolution for the paged decode.

Counterpart of ``fms_fsdp_tpu/tune/lookup.py::resolve_paged_decode`` with
the defaults of ``tune/candidates.py:348``. It reads no table: the TPU
table's entries are tiles for another chip, and the port's tuner comes
later (ROADMAP.md A.13).
"""

from typing import Optional, Tuple

PAGED_DEFAULT_PAGE_SIZE = 64


def resolve_paged_decode(max_seq: int,
                         requested_page_size: Optional[int] = None,
                         ) -> Tuple[int, int, str]:
    """(page_size, block_kv, how) for the serving engine's page pool,
    resolved once at engine build. A requested page size is kept and must
    divide ``max_seq``; otherwise the default of 64 is halved until it
    divides ``max_seq``. ``block_kv`` is the page size."""
    if requested_page_size:
        if max_seq % requested_page_size != 0:
            raise ValueError(
                f"ServeConfig.page_size={requested_page_size} does not divide "
                f"max_seq_len={max_seq}; pick a dividing page size or leave "
                f"it 0 for the default"
            )
        return requested_page_size, requested_page_size, "pinned"
    ps = PAGED_DEFAULT_PAGE_SIZE
    while max_seq % ps != 0 and ps > 1:
        ps //= 2
    return ps, ps, "off"
