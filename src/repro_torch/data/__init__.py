"""Data-side pieces of the port: the synthetic token stream for training
(exported here) and the offline chunk-KV store (``data.chunk_kv``)."""

from repro_torch.data.pipeline import DataConfig, TokenStream

__all__ = ["DataConfig", "TokenStream"]
