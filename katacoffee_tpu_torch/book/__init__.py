"""Opening book: the port of `katacoffee_tpu/book/`, a symmetry-reduced
position graph built from batched searches on the GPU."""

from katacoffee_tpu_torch.book.book import Book, BookNode, build_book

__all__ = ["Book", "BookNode", "build_book"]
