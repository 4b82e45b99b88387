"""Token sampling for the decode loop."""

from __future__ import annotations

from typing import Optional

import torch


def sample(logits: torch.Tensor, generator: Optional[torch.Generator] = None, *,
           temperature: float = 0.0, top_k: int = 0) -> torch.Tensor:
    """logits [..., V] -> token ids [...] int32. temperature 0 = greedy
    (``argmax``, first index on ties); otherwise a categorical draw from
    ``generator`` over the top-``top_k`` logits (0 = all)."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits.float() / temperature
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if generator is None:
        raise ValueError("temperature sampling needs a torch.Generator")
    probs = torch.softmax(logits, dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    tok = torch.multinomial(flat, 1, generator=generator)
    return tok.reshape(probs.shape[:-1]).to(torch.int32)
