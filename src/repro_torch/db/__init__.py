"""Relational substrate the TRAIN path reads: slotted pages, heap files and
the buffer pool (counterpart of ``repro.db``'s storage modules)."""
from repro_torch.db.bufferpool import BufferPool
from repro_torch.db.heap import HeapFile, write_table, write_token_table
from repro_torch.db.page import PageLayout, build_pages, page_header, parse_page

__all__ = [
    "PageLayout", "build_pages", "parse_page", "page_header",
    "HeapFile", "write_table", "write_token_table", "BufferPool",
]
