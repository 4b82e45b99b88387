"""The cases of the port's tensor-parallel CPU tests, JAX-free, so the
rank processes, the test module and the reference child build the same
configs, weights and inputs from the same seeds.

``config(arch, tweak)`` is the reduced config of ``arch`` with a tweak
that moves the layout: ``"v514"`` a vocabulary of 514 (splits over 2
ranks, replicated over 4), ``"e6"`` 6 experts (replicated over 4, so
``mlp`` takes ``model``), ``"c05"`` a capacity factor of 0.5 (one slot
an expert for a decode step's 4 tokens, so a dispatch group cut along
the data shards drops other tokens than the whole batch's group),
``"d130"`` a width of 130 (``embed`` splits over 2 data shards, and the
divisibility pass keeps it whole over 4).
``weights`` are the port's ``init_params`` (a seeded CPU generator) as
the reference's numpy tree; ``inputs`` the steps' tokens, positions, a
random dense cache, its int8 form (values and bf16-exact scales) and
page slab, a shuffled block table and a prefill prompt (an image prefix
for a vision model), all from ``np.random.default_rng``;
``train_batch`` a train step's global batch.

``digests`` runs the three steps unsharded (``tp`` left out, so it runs
on any version of the port) and gives the SHA-256 of every output's
bytes: ``tests/data/tp_none_digests.json`` holds the digests the port
gave before tensor parallelism existed.
"""

from __future__ import annotations

import dataclasses
import hashlib
from pathlib import Path
from typing import Dict, Tuple

import numpy as np

DIGESTS = Path(__file__).resolve().parent / "data" / "tp_none_digests.json"
ARCHS = ("llama3-8b", "granite-moe-3b-a800m", "arctic-480b", "granite-20b",
         "nemotron-4-15b", "internvl2-1b", "musicgen-large")
TWEAKS = {"": {}, "v514": {"vocab_size": 514}, "e6": {"num_experts": 6},
          "c05": {"capacity_factor": 0.5}, "d130": {"d_model": 130}}
B, S_MAX, PS, MB, S_PROMPT = 4, 16, 4, 4, 8
POS = (3, 9, 15, 0)
LENGTHS = (0, 3, 6, 13)


def tweak(cfg, name: str):
    """``cfg`` with the tweak ``name`` (``TWEAKS``); works on either
    package's ``ArchConfig``."""
    kw = dict(TWEAKS[name])
    moe = {k: kw.pop(k) for k in ("num_experts", "capacity_factor") if k in kw}
    if moe:
        return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe))
    return dataclasses.replace(cfg, **kw)


def config(arch: str, name: str = ""):
    from repro_torch.configs import get_arch
    return tweak(get_arch(arch).reduced(), name)


def weights(cfg, seed: int = 0) -> Dict[str, np.ndarray]:
    """{reference path "a/b/c": fp32 array} of the port's ``init_params``
    drawn from a CPU generator seeded ``seed``."""
    import torch

    from repro_torch.models import transformer as tf
    model = tf.init_params(cfg, torch.Generator().manual_seed(seed),
                           device="cpu", dtype=torch.float32)
    paths = {**tf._JAX_PATHS, **tf._FAMILY_PATHS}
    return {"/".join(paths[n]): p.detach().numpy().copy()
            for n, p in model.named_parameters()}


def tree(flat: Dict[str, np.ndarray]) -> dict:
    """A flat {path: array} as the nested tree ``from_jax_params`` takes."""
    out: dict = {}
    for path, v in flat.items():
        node = out
        keys = path.split("/")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = v
    return out


def inputs(cfg, seed: int = 1) -> Dict[str, np.ndarray]:
    """The steps' inputs: ``token``/``pos`` of a decode step, a dense
    cache ``k``/``v`` [L, B, S_MAX, KVH, Dh] and a slab
    ``k_slab``/``v_slab`` [L, NP, PS, KVH, Dh] of unit normals, a
    shuffled ``block_table`` and ``lengths``, a prompt ``tokens`` [B,
    S_PROMPT] and, for a vision model, ``image_embeds``."""
    from repro_torch.models import transformer as tf
    rng = np.random.default_rng(seed)
    L, KVH, Dh = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim
    nc = tf.codebooks(cfg)
    tok = lambda shape: rng.integers(0, cfg.vocab_size, shape + (
        (nc,) if nc else ())).astype(np.int32)
    NP = B * MB + 2
    kv = (L, B, S_MAX, KVH, Dh)
    out = {"token": tok((B,)), "pos": np.array(POS, np.int32),
           "k": rng.standard_normal(kv).astype(np.float32),
           "v": rng.standard_normal(kv).astype(np.float32),
           "k_slab": rng.standard_normal((L, NP, PS, KVH, Dh)).astype(np.float32),
           "v_slab": rng.standard_normal((L, NP, PS, KVH, Dh)).astype(np.float32),
           "block_table": rng.permutation(NP)[:B * MB].reshape(B, MB)
           .astype(np.int32),
           "lengths": np.array(LENGTHS, np.int32),
           "tokens": tok((B, S_PROMPT))}
    fe = cfg.frontend
    if fe is not None and fe.kind == "vit_stub":
        out["image_embeds"] = rng.standard_normal(
            (B, fe.num_prefix_embeddings, fe.embed_dim)).astype(np.float32)
    for n in ("k", "v"):        # an int8 cache: drawn after the rest
        out[f"{n}_q"] = rng.integers(-127, 128, kv).astype(np.int8)
        out[f"{n}_scale"] = _bf16(rng.uniform(0.005, 0.03, kv[:-1]))
    return out


def _bf16(a: np.ndarray) -> np.ndarray:
    """fp32 ``a`` rounded to the nearest bf16 value (so a bf16 scale
    holds it exactly)."""
    import torch
    return torch.from_numpy(np.asarray(a, np.float32)).to(
        torch.bfloat16).float().numpy()


TRAIN_B, TRAIN_S = 4, 16


def train_batch(cfg, step: int, seed: int = 7) -> Dict[str, np.ndarray]:
    """Step ``step``'s global batch: "tokens" and "labels" [TRAIN_B,
    TRAIN_S] (an audio model's [..., codebooks]) uniform over the
    vocabulary, and a vision model's "image_embeds"."""
    from repro_torch.models import transformer as tf
    rng = np.random.default_rng((seed, step))
    nc = tf.codebooks(cfg)
    shape = (TRAIN_B, TRAIN_S) + ((nc,) if nc else ())
    out = {k: rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
           for k in ("tokens", "labels")}
    fe = cfg.frontend
    if fe is not None and fe.kind == "vit_stub":
        out["image_embeds"] = rng.standard_normal(
            (TRAIN_B, fe.num_prefix_embeddings, fe.embed_dim)).astype(np.float32)
    return out


def run_steps(model, inp: Dict[str, np.ndarray], dtype, device="cpu", **tp
              ) -> Dict[str, np.ndarray]:
    """``serve_step``, ``serve_step_paged`` and ``prefill`` of ``model``
    on ``inp`` (caches in ``dtype``, every input on ``device``); ``tp``
    (``tp=...``) passed on to each step.  Returns {"dense/logits", "dense/k", "dense/v",
    "paged/logits", "paged/k", "paged/v", "prefill/logits",
    "prefill/k", "prefill/v"} as numpy (bf16 as fp32)."""
    import torch

    from repro_torch.models import transformer as tf
    t = lambda a, dt=None: torch.from_numpy(np.array(a)).to(
        dt) if dt is not None else torch.from_numpy(np.array(a))
    if device != "cpu":
        t = lambda a, dt=None, t=t: t(a, dt).to(device)
    out = {}
    with torch.no_grad():
        cache = {"k": t(inp["k"], dtype), "v": t(inp["v"], dtype)}
        logits, cache = tf.serve_step(model, cache, {"token": t(inp["token"]),
                                                     "pos": t(inp["pos"])}, **tp)
        out.update({"dense/logits": logits, "dense/k": cache["k"],
                    "dense/v": cache["v"]})
        logits, ks, vs = tf.serve_step_paged(
            model, t(inp["k_slab"], dtype), t(inp["v_slab"], dtype),
            t(inp["block_table"]), t(inp["lengths"]),
            {"token": t(inp["token"])}, **tp)
        out.update({"paged/logits": logits, "paged/k": ks, "paged/v": vs})
        pin = {"tokens": t(inp["tokens"])}
        if "image_embeds" in inp:
            pin["image_embeds"] = t(inp["image_embeds"], dtype)
        logits, cache = tf.prefill(model, pin, attn_chunk=4, **tp)
        out.update({"prefill/logits": logits, "prefill/k": cache["k"],
                    "prefill/v": cache["v"]})
    return {k: v.float().cpu().numpy() for k, v in out.items()}


def digest_cases() -> Tuple[Tuple[str, str], ...]:
    """(arch, dtype name) of the unsharded digests."""
    return tuple((a, d) for a in ARCHS for d in ("float32", "bfloat16"))


def digests() -> Dict[str, str]:
    """{"arch/dtype/output": SHA-256 of its bytes} of ``run_steps`` with
    no ``tp``, under one intra-op thread."""
    import torch

    from repro_torch.models import transformer as tf
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = {}
        for arch, dname in digest_cases():
            cfg = config(arch)
            dtype = getattr(torch, dname)
            model = tf.from_jax_params(tree(weights(cfg)), cfg, device="cpu",
                                       dtype=dtype)
            for k, v in run_steps(model, inputs(cfg), dtype).items():
                out[f"{arch}/{dname}/{k}"] = hashlib.sha256(
                    np.ascontiguousarray(v).tobytes()).hexdigest()
        return out
    finally:
        torch.set_num_threads(threads)


if __name__ == "__main__":
    import json
    import sys
    with open(sys.argv[1], "w") as f:
        json.dump(digests(), f, indent=1, sort_keys=True)
