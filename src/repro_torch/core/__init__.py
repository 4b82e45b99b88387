"""IVF index, prefetch buffer, transfer engine and hybrid search."""
