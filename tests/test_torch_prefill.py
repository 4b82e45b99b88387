"""The port's full-sequence forward and prefill against the JAX package's,
on the CPU.

The same weights (the reference's ``init_params``, carried across with
``from_jax_params``) and the same numpy tokens go through the reference's
``transformer.prefill`` / ``forward`` / ``layers.chunked_attention`` and
the port's.  Tolerances: fp32 within rtol=atol=1e-4 (sums in another
order); bf16 within 3e-2 of the logits' (or the cache's) scale, the
tolerance the reference's own tests allow between its bf16 kernels and
its oracles (``tests/test_kernels.py:77``), since the two frameworks
round the bf16 products at other places.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import get_arch as jget_arch
from repro.models import layers as jlayers
from repro.models import transformer as jtf
from repro_torch.configs import get_arch as tget_arch
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttf

BF16_SCALE_TOL = 3e-2


def _models(dtype, layers=3):
    """The reduced Llama-3 config cut to ``layers`` layers, the
    reference's params in ``dtype`` and the port's model over the same
    numbers."""
    jc = dataclasses.replace(jget_arch("llama3-8b").reduced(),
                             num_layers=layers)
    tc = dataclasses.replace(tget_arch("llama3-8b").reduced(),
                             num_layers=layers)
    params = jtf.init_params(jc, jax.random.PRNGKey(0), dtype=dtype)
    model = ttf.from_jax_params(
        jax.tree.map(lambda a: np.asarray(a, np.float32), params), tc,
        device="cpu", dtype=torch.bfloat16 if dtype == jnp.bfloat16
        else torch.float32)
    return jc, params, model


@pytest.fixture(scope="module")
def fp32():
    return _models(jnp.float32)


@pytest.fixture(scope="module")
def bf16():
    return _models(jnp.bfloat16)


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _scale_close(got, want, what):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    err = np.abs(got - want).max()
    assert err <= BF16_SCALE_TOL * np.abs(want).max(), \
        f"{what}: max err {err} against scale {np.abs(want).max()}"


@pytest.mark.parametrize("B,Sq,KVH,G,Dh,chunk,q_chunk,dtype", [
    (2, 24, 2, 2, 32, 1024, 256, np.float32),     # one tile each way
    (1, 40, 1, 4, 16, 8, 16, np.float32),         # tiled over q and KV
    (2, 30, 2, 1, 32, 7, 9, np.float32),          # ragged tile sizes
    (2, 24, 2, 2, 32, 8, 8, "bf16"),              # bf16 K/V and P
])
def test_chunked_attention_matches_reference(B, Sq, KVH, G, Dh, chunk,
                                             q_chunk, dtype):
    """Causal tiled attention with the online softmax, against the
    reference's ``chunked_attention`` on the same inputs and tiles."""
    rng = np.random.default_rng(Sq)
    q = rng.standard_normal((B, Sq, KVH, G, Dh)).astype(np.float32)
    k = rng.standard_normal((B, Sq, KVH, Dh)).astype(np.float32)
    v = rng.standard_normal((B, Sq, KVH, Dh)).astype(np.float32)
    pos = np.arange(Sq, dtype=np.int32)
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if dtype == "bf16"
                else (jnp.float32, torch.float32))
    want = jlayers.chunked_attention(
        *(jnp.asarray(x, jdt) for x in (q, k, v)), q_positions=jnp.asarray(pos),
        kv_positions=jnp.asarray(pos), window=None, softcap_val=None,
        chunk=chunk, q_chunk=q_chunk)
    got = tlayers.chunked_attention(
        *(torch.from_numpy(x).to(tdt) for x in (q, k, v)),
        q_positions=torch.from_numpy(pos), kv_positions=torch.from_numpy(pos),
        chunk=chunk, q_chunk=q_chunk)
    assert got.dtype == tdt and tuple(got.shape) == want.shape
    tol = 1e-2 if dtype == "bf16" else 1e-5
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("B,S", [(1, 21), (2, 8), (3, 33)])
def test_prefill_matches_reference_fp32(fp32, B, S):
    """Last-token logits and the {"k", "v"} [L, B, S, KVH, Dh] cache."""
    cfg, params, model = fp32
    toks = _tokens(cfg, B, S, seed=S)
    jl, jc = jtf.prefill(params, {"tokens": jnp.asarray(toks)}, cfg)
    tl, tc = ttf.prefill(model, {"tokens": torch.from_numpy(toks)})
    assert tuple(tl.shape) == (B, cfg.vocab_size)
    for name in ("k", "v"):
        assert tuple(tc[name].shape) == jc[name].shape == (
            cfg.num_layers, B, S, cfg.num_kv_heads, cfg.resolved_head_dim)
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)


def test_prefill_matches_reference_bf16(bf16):
    cfg, params, model = bf16
    toks = _tokens(cfg, 2, 19, seed=4)
    jl, jc = jtf.prefill(params, {"tokens": jnp.asarray(toks)}, cfg)
    tl, tc = ttf.prefill(model, {"tokens": torch.from_numpy(toks)})
    assert tl.dtype == torch.bfloat16 and tc["k"].dtype == torch.bfloat16
    _scale_close(tl.float().numpy(), jl, "logits")
    for name in ("k", "v"):
        _scale_close(tc[name].float().numpy(), jc[name], name)


def test_forward_hidden_matches_reference(fp32):
    """``forward`` without a cache: the normed hidden states of every
    position, and no cache."""
    cfg, params, model = fp32
    toks = _tokens(cfg, 2, 12, seed=9)
    jx, _, jcache = jtf.forward(params, jnp.asarray(toks), cfg)
    tx, aux, tcache = ttf.forward(model, torch.from_numpy(toks))
    assert jcache is None and tcache is None and float(aux) == 0.0
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-4,
                               atol=1e-4)


def test_prefill_tiles_do_not_change_the_result(fp32):
    """A KV tile smaller than the prompt (the online softmax across
    tiles) gives the one-tile prefill's numbers."""
    cfg, _, model = fp32
    toks = torch.from_numpy(_tokens(cfg, 2, 30, seed=5))
    l1, c1 = ttf.prefill(model, {"tokens": toks})
    l2, c2 = ttf.prefill(model, {"tokens": toks}, attn_chunk=7)
    np.testing.assert_allclose(l2.numpy(), l1.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(c2["v"].numpy(), c1["v"].numpy(), rtol=1e-5,
                               atol=1e-5)


def test_prefill_then_decode_continues_the_prompt(fp32):
    """The prefill cache written into a dense ``init_cache`` and one
    ``serve_step`` at the next position give the logits of a prefill
    over the prompt plus that token (fp32)."""
    cfg, _, model = fp32
    toks = _tokens(cfg, 2, 11, seed=6)
    _, cache = ttf.prefill(model, {"tokens": torch.from_numpy(toks[:, :-1])})
    dense = ttf.init_cache(cfg, 2, 16, dtype=torch.float32, device="cpu")
    dense["k"][:, :, :10] = cache["k"]
    dense["v"][:, :, :10] = cache["v"]
    step, _ = ttf.serve_step(model, dense, {
        "token": torch.from_numpy(toks[:, -1]),
        "pos": torch.full((2,), 10, dtype=torch.int32)})
    want, _ = ttf.prefill(model, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(step.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-4)
