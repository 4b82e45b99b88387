"""Engine, retrieval policies, decode runner and paged KV cache."""
