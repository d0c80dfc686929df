"""Relational substrate: slotted pages, heap files, buffer pool, catalog,
query layer — fronted by the ``Database``/``Session`` API (counterpart of
``repro.db``).

``connect(catalog) -> Session`` is the documented entry point for running
SQL (``session.sql``, ``session.submit``); ``repro_torch.db.query``'s
``parse``/``execute`` stay public as the typed lower layer. ``connect`` and
``Database`` take ``device=None``, meaning the card.
"""
from repro_torch.db.bufferpool import BufferPool
from repro_torch.db.catalog import Catalog
from repro_torch.db.heap import HeapFile, write_table, write_token_table
from repro_torch.db.page import PageLayout, build_pages, page_header, parse_page
from repro_torch.db.session import Database, QueryHandle, Session, connect

__all__ = [
    "PageLayout", "build_pages", "parse_page", "page_header",
    "HeapFile", "write_table", "write_token_table", "BufferPool", "Catalog",
    "Database", "Session", "QueryHandle", "connect",
]
