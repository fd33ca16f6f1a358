from .builder import build_index, scan_folder
from .comments import (
    add_image_comment,
    get_image_comments,
    load_comments,
    save_comments,
)
from .ivf import IVFIndex
from .search import exact_search_batch
from .store import IndexReader, IndexWriter, exists, index_dir, load_progress

__all__ = [
    "build_index",
    "scan_folder",
    "add_image_comment",
    "get_image_comments",
    "load_comments",
    "save_comments",
    "exact_search_batch",
    "IVFIndex",
    "IndexReader",
    "IndexWriter",
    "exists",
    "index_dir",
    "load_progress",
]
