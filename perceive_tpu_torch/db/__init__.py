"""SQLite store of the port: a copy of the JAX package's ``db`` (schema,
migrations, sources, tags), byte-compatible with it, so that a database
written by either package opens in the other, and the reference importer
(``import_reference``) behind the CLI's ``import-db``."""

from .database import ITEM_COLUMNS, Database, deserialize_item_row, json_ids
from .import_reference import import_reference_db
from .sources_db import add_source, get_source, list_sources, update_source, update_source_status
from .tags import ensure_tag, items_with_tag, list_tags, tag_item, untag_item

__all__ = [
    "Database",
    "import_reference_db",
    "ITEM_COLUMNS",
    "deserialize_item_row",
    "json_ids",
    "list_sources",
    "get_source",
    "add_source",
    "update_source",
    "update_source_status",
    "ensure_tag",
    "items_with_tag",
    "list_tags",
    "tag_item",
    "untag_item",
]
