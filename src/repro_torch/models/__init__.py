"""Plain global-causal GQA decoder (Llama-3 family)."""
