"""Data-side pieces of the port (the offline chunk-KV store)."""
