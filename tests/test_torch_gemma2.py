"""The port's gemma2 pieces against the JAX package's, on the CPU: the
int8 KV quantization, the ring cache (``ring_from_full``,
``attn_decode_ring``), the int8 decode attention, the windowed and
softcapped ``chunked_attention``, the split cache, and the reduced
gemma2's decode over a ring that wraps twice, with and without
``kv_quant``.

Weights are the reference's ``init_params(cfg, PRNGKey(0), float32)``
carried across with ``from_jax_params``; inputs are numpy draws.
Tolerances: the quantization and the ring layout are exact; the ring and
windowed attention within 1e-5 in fp32 (sums in another order); the
int8 attention within 1e-5 of the reference's pieces in fp32 (its
``quantize_heads``, ``dequantize_heads`` and ``_decode_attention`` over
the dequantized cache) and within 3e-3 of the output's scale of its
``attn_decode_quant``, which rounds the scaled q and the probabilities
to bf16 because its dequantized cache is bf16 (the port's kernel keeps
them fp32, as every port decode kernel does); decode logits within 2e-3
in fp32 (``kv_quant`` off), 3e-3 of their scale with ``kv_quant`` on
for a step or two after a prefill and 1e-2 over 24 steps from an empty
cache (the same bf16 rounding in the reference, which also moves an
int8 value on a rounding edge by one, and the steps compound it; the
reference's own int8 test allows 0.5 absolute), and 3e-2 of their scale with
a bf16 cache (the tolerance ``tests/test_kernels.py:77`` allows between
the reference's own bf16 kernel and its oracle).
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import get_arch as jget_arch
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import transformer as jtf
from repro_torch.configs import get_arch as tget_arch
from repro_torch.kernels import ref as tref
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttf

ARCH = "gemma2-27b"
BF16_SCALE_TOL = 3e-2
QUANT_SCALE_TOL = 3e-3
QUANT_STEPS_TOL = 1e-2


@functools.lru_cache(maxsize=None)
def _world():
    jc, tc = jget_arch(ARCH).reduced(), tget_arch(ARCH).reduced()
    params = jtf.init_params(jc, jax.random.PRNGKey(0), dtype=jnp.float32)
    model = ttf.from_jax_params(jax.tree.map(np.asarray, params), tc,
                                device="cpu")
    return jc, tc, params, model


def _layer(params, l):
    return jax.tree.map(lambda a: a[l], params["layers"])


def _scale_close(got, want, tol, what):
    want = np.asarray(want, np.float32)
    err = np.abs(np.asarray(got, np.float32) - want).max()
    assert err <= tol * np.abs(want).max(), \
        f"{what}: max err {err} against scale {np.abs(want).max()}"


def test_reduced_config_is_two_local_global_pairs():
    jc, tc, _, _ = _world()
    assert (tc.num_layers, tc.sliding_window, tc.attn_logit_softcap,
            tc.final_logit_softcap, tc.tie_embeddings) == (4, 8, 50.0, 30.0, True)
    assert ttf.layer_windows(tc) == np.asarray(jtf.layer_windows(jc)).tolist() \
        == [8, 0, 8, 0]


@pytest.mark.parametrize("shape", [(5, 7, 2, 32), (2, 3, 1, 8, 4, 16)])
def test_quantize_heads_matches_reference(shape):
    """Equal int8 values and bf16 scales, and equal dequantized values,
    on normal draws with an all-zero row (the 1e-8 floor) and exact
    halves (round half to even)."""
    rng = np.random.default_rng(sum(shape))
    x = (rng.standard_normal(shape) * 3).astype(np.float32)
    x[(0,) * (len(shape) - 1)] = 0.0
    x[..., 0] = np.round(x[..., 0]) + 0.5
    jq, js = jattn.quantize_heads(jnp.asarray(x))
    tq, ts = tattn.quantize_heads(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.bfloat16
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.float().numpy(),
                                  np.asarray(js, np.float32))
    np.testing.assert_array_equal(
        tattn.dequantize_heads(tq, ts).float().numpy(),
        np.asarray(jattn.dequantize_heads(jq, js), np.float32))
    np.testing.assert_array_equal(
        tref.dequantize_ref(tq, ts).float().numpy(),
        np.asarray(jattn.dequantize_heads(jq, js), np.float32))


@pytest.mark.parametrize("S", [5, 8, 21])
def test_ring_from_full_is_exact(S):
    """S below, at and past the window W = 8: the last min(W, S)
    positions, position p at slot p % W, zero slots past S."""
    W = 8
    x = np.random.default_rng(S).standard_normal((2, 3, S, 2, 4)).astype(
        np.float32)
    got = tattn.ring_from_full(torch.from_numpy(x), W).numpy()
    np.testing.assert_array_equal(got, np.asarray(jattn.ring_from_full(
        jnp.asarray(x), W)))
    assert got.shape[-3] == W
    for p in range(max(0, S - W), S):
        np.testing.assert_array_equal(got[..., p % W, :, :], x[..., p, :, :])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attn_decode_ring_matches_reference_and_windowed_full_cache(dtype):
    """The ring step at positions below W - 1, at it and wrapped past
    2W: the output and the written ring against the reference's
    ``attn_decode_ring`` (fp32 within 1e-5; bf16 within 3e-2 of the
    scale), and against ``flash_decode_ref`` over the full cache with
    window W, the positions the ring holds (fp32 within 1e-5)."""
    jc, tc, params, model = _world()
    W, B, KVH, Dh = 8, 4, jc.num_kv_heads, jc.resolved_head_dim
    rng = np.random.default_rng(11)
    pos = np.array([3, 7, 17, 30], np.int32)
    S = int(pos.max()) + 1
    full_k = rng.standard_normal((B, S, KVH, Dh)).astype(np.float32)
    full_v = rng.standard_normal((B, S, KVH, Dh)).astype(np.float32)
    # the ring as decode leaves it: slot s holds position p - ((p - s) % W)
    ring_k = np.zeros((B, W, KVH, Dh), np.float32)
    ring_v = np.zeros_like(ring_k)
    for b, p in enumerate(pos):
        for s in range(W):
            q = p - ((p - s) % W)
            if q >= 0:
                ring_k[b, s], ring_v[b, s] = full_k[b, q], full_v[b, q]
    x = rng.standard_normal((B, jc.d_model)).astype(np.float32)
    lp = _layer(params, 0)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jout, jk, jv = jattn.attn_decode_ring(
        lp["attn"], jnp.asarray(x)[:, None], jc,
        cache_k=jnp.asarray(ring_k, jdt), cache_v=jnp.asarray(ring_v, jdt),
        pos=jnp.asarray(pos), window=W)
    tk = torch.from_numpy(ring_k.copy()).to(tdt)
    tv = torch.from_numpy(ring_v.copy()).to(tdt)
    tp = torch.from_numpy(pos)
    tout = tattn.attn_decode_ring(model.layer(0), torch.from_numpy(x), tc,
                                  tk, tv, tp, torch.arange(B), tp.long() % W,
                                  torch.clamp(tp, max=W - 1))
    if dtype == "float32":
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout)[:, 0],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6,
                                   atol=1e-6)
    else:
        _scale_close(tout.float().numpy(), jout[:, 0], BF16_SCALE_TOL, "out")
        _scale_close(tk.float().numpy(), jk, BF16_SCALE_TOL, "ring k")
        return
    # the kernel's plain version over the ring against the windowed full
    # cache holding the same new K/V at pos
    q, k, v = tattn.project_qkv(model.layer(0), torch.from_numpy(x), tc,
                                tp[:, None])
    fk, fv = torch.from_numpy(full_k), torch.from_numpy(full_v)
    fk[torch.arange(B), tp.long()] = k
    fv[torch.arange(B), tp.long()] = v
    want = tref.flash_decode_ref(q, fk, fv, tp, window=W, softcap=50.0)
    got = tref.flash_decode_ref(q, tk, tv, torch.clamp(tp, max=W - 1),
                                softcap=50.0)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


def test_attn_decode_quant_matches_reference():
    """The int8 step on a global layer: the written int8 cache and bf16
    scales equal the reference's; the output within 1e-5 of the
    reference's pieces in fp32 and within 3e-3 of the scale of its
    ``attn_decode_quant`` (which rounds q and P to bf16)."""
    jc, tc, params, model = _world()
    B, S, KVH, Dh = 3, 24, jc.num_kv_heads, jc.resolved_head_dim
    H, G = jc.num_heads, jc.num_heads // KVH
    rng = np.random.default_rng(5)
    kv = rng.standard_normal((2, B, S, KVH, Dh)).astype(np.float32)
    x = rng.standard_normal((B, jc.d_model)).astype(np.float32)
    pos = np.array([0, 9, 23], np.int32)
    kq, ks = jattn.quantize_heads(jnp.asarray(kv[0]))
    vq, vs = jattn.quantize_heads(jnp.asarray(kv[1]))
    lp = _layer(params, 1)["attn"]
    jout, jck, jcv, jks, jvs = jattn.attn_decode_quant(
        lp, jnp.asarray(x)[:, None], jc, cache_k=kq, cache_v=vq, k_scale=ks,
        v_scale=vs, pos=jnp.asarray(pos), window=0)
    tk, tks = tattn.quantize_heads(torch.from_numpy(kv[0]))
    tv, tvs = tattn.quantize_heads(torch.from_numpy(kv[1]))
    tp = torch.from_numpy(pos)
    tout = tattn.attn_decode_quant(model.layer(1), torch.from_numpy(x), tc,
                                   tk, tv, tks, tvs, tp, torch.arange(B),
                                   tp.long())
    for got, want in ((tk, jck), (tv, jcv), (tks, jks), (tvs, jvs)):
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))
    # the reference's pieces in fp32: q projected and rotated, attention
    # over its dequantized cache (bf16 values held in fp32)
    q = jnp.einsum("bd,dhk->bhk", jnp.asarray(x), lp["wq"])[:, None]
    q = jlayers.apply_rope(q, jnp.asarray(pos)[:, None], theta=jc.rope_theta)
    kd = jattn.dequantize_heads(jck, jks).astype(jnp.float32)
    vd = jattn.dequantize_heads(jcv, jvs).astype(jnp.float32)
    o = jattn._decode_attention(q.reshape(B, 1, KVH, G, Dh), kd, vd,
                                pos=jnp.asarray(pos), window=0,
                                softcap_val=jc.attn_logit_softcap, chunk=S)
    want = jnp.einsum("bhk,hkd->bd", o.reshape(B, H, Dh), lp["wo"])
    np.testing.assert_allclose(tout.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    _scale_close(tout.numpy(), jout[:, 0], QUANT_SCALE_TOL, "attn_decode_quant")


@pytest.mark.parametrize("window,cap", [(8, 50.0), (5, None), (0, 50.0)])
def test_chunked_attention_window_and_softcap(window, cap):
    """Windowed and softcapped prefill attention in tiles smaller than
    the window and the sequence, fp32 within 1e-5; with a
    ``kv_valid_len`` mask too."""
    rng = np.random.default_rng(window + 3)
    B, S, KVH, G, Dh = 2, 20, 2, 2, 16
    q = rng.standard_normal((B, S, KVH, G, Dh)).astype(np.float32) * 3
    k = rng.standard_normal((B, S, KVH, Dh)).astype(np.float32) * 3
    v = rng.standard_normal((B, S, KVH, Dh)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)
    valid = np.array([20, 13], np.int32)
    for kv_valid in (None, valid):
        want = jlayers.chunked_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            q_positions=jnp.asarray(pos), kv_positions=jnp.asarray(pos),
            window=window, softcap_val=cap, chunk=5, q_chunk=4,
            kv_valid_len=None if kv_valid is None else jnp.asarray(kv_valid))
        got = tlayers.chunked_attention(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            q_positions=torch.from_numpy(pos), kv_positions=torch.from_numpy(pos),
            window=window, softcap_val=cap, chunk=5, q_chunk=4,
            kv_valid_len=None if kv_valid is None else torch.from_numpy(kv_valid))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("kv_quant", [False, True])
def test_init_cache_is_the_reference_layout(kv_quant):
    """The split cache: the same keys, shapes and dtypes as the
    reference's, the rings at min(W, max_len) slots."""
    jc, tc, _, _ = _world()
    for max_len in (5, 30):
        want = jax.eval_shape(lambda: jtf.init_cache(
            jc, 3, max_len, jnp.bfloat16, kv_quant=kv_quant))
        got = ttf.init_cache(tc, 3, max_len, torch.bfloat16, device="cpu",
                             kv_quant=kv_quant)
        assert sorted(got) == sorted(want)
        for name, t in got.items():
            assert tuple(t.shape) == want[name].shape, name
            assert str(t.dtype).split(".")[-1] == str(want[name].dtype), name


def _decode_from_zero(kv_quant, dtype, steps):
    """``steps`` greedy-free steps from an empty split cache at pos 0
    (rows at pos 0, 0 and 3, the ring wrapping twice): both packages'
    logits each step, and their final caches."""
    jc, tc, params, model = _world()
    B, S = 3, steps + 4
    rng = np.random.default_rng(21)
    toks = rng.integers(0, jc.vocab_size, (steps, B)).astype(np.int32)
    jcache = jtf.init_cache(jc, B, S, getattr(jnp, dtype), kv_quant=kv_quant)
    tcache = ttf.init_cache(tc, B, S, getattr(torch, dtype), device="cpu",
                            kv_quant=kv_quant)
    step = jax.jit(lambda c, i: jtf.serve_step(params, c, i, jc,
                                               kv_quant=kv_quant))
    pos = np.array([0, 0, 3], np.int32)
    out = []
    for t in range(steps):
        inp = {"token": toks[t], "pos": pos}
        jl, jcache = step(jcache, {k: jnp.asarray(v) for k, v in inp.items()})
        tl, tcache = ttf.serve_step(model, tcache, {k: torch.from_numpy(v)
                                                    for k, v in inp.items()},
                                    kv_quant=kv_quant)
        out.append((np.asarray(jl), tl.float().numpy()))
        pos = pos + 1
    return out, jcache, tcache


@pytest.mark.parametrize("kv_quant", [False, True])
def test_serve_step_wraps_the_ring_twice_fp32(kv_quant):
    """3W = 24 steps from pos 0 over the split cache (the local rings
    wrap twice): every step's logits within 2e-3 (``kv_quant`` off) or
    1e-2 of their scale (on), and the final caches alike."""
    out, jcache, tcache = _decode_from_zero(kv_quant, "float32", 24)
    for t, (jl, tl) in enumerate(out):
        if kv_quant:
            _scale_close(tl, jl, QUANT_STEPS_TOL, f"step {t}")
        else:
            np.testing.assert_allclose(tl, jl, rtol=2e-3, atol=2e-3,
                                       err_msg=f"step {t}")
    for name, t in tcache.items():
        if t.dtype == torch.int8:
            # the K/V quantized at each step follow the two hidden states,
            # which the reference's bf16 rounding moves apart: an int8 value
            # near a rounding edge lands one step away (2.5% of them here)
            d = np.abs(t.numpy().astype(np.int32)
                       - np.asarray(jcache[name]).astype(np.int32))
            assert d.max() <= 1 and (d == 0).mean() > 0.95, name
        else:
            _scale_close(t.float().numpy(), jcache[name],
                         QUANT_STEPS_TOL if kv_quant else 2e-3, name)


def test_serve_step_bf16_cache_within_the_bf16_tolerance():
    out, _, _ = _decode_from_zero(False, "bfloat16", 20)
    for t, (jl, tl) in enumerate(out):
        _scale_close(tl, jl, BF16_SCALE_TOL, f"step {t}")


@pytest.mark.parametrize("kv_quant", [False, True])
def test_decode_after_prefill_matches_reference(kv_quant):
    """The reference's ``test_gemma2_ring_cache_respects_window`` and
    ``test_int8_kv_decode_parity`` on the port: a 20-token prefill (past
    2W), its split cache copied into a fresh ``init_cache`` (quantized
    with ``quantize_heads`` where int8), then 2 steps: logits against
    the reference's same steps (2e-3 fp32; 3e-3 of the scale with
    ``kv_quant``) and against the port's own teacher-forced ``forward``
    (2e-3 without ``kv_quant``)."""
    jc, tc, params, model = _world()
    B, S = 2, 20
    toks = np.random.default_rng(5).integers(0, jc.vocab_size, (B, S + 2)
                                             ).astype(np.int32)
    jl, jpc = jtf.prefill(params, {"tokens": jnp.asarray(toks[:, :S])}, jc)
    tl, tpc = ttf.prefill(model, {"tokens": torch.from_numpy(toks[:, :S])})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-4, atol=2e-4)
    assert sorted(tpc) == sorted(jpc)
    for name in tpc:
        np.testing.assert_allclose(tpc[name].numpy(), np.asarray(jpc[name]),
                                   rtol=2e-4, atol=2e-4, err_msg=name)
    x, _, _ = ttf.forward(model, torch.from_numpy(toks))
    full = ttf.unembed(model, x).numpy()
    jcache = jtf.init_cache(jc, B, S + 2, jnp.float32, kv_quant=kv_quant)
    tcache = ttf.init_cache(tc, B, S + 2, torch.float32, device="cpu",
                            kv_quant=kv_quant)
    for name, src in tpc.items():
        sl = tuple(slice(0, d) for d in src.shape)
        if tcache[name].dtype == torch.int8:
            q, sc = tattn.quantize_heads(src)
            tcache[name][sl] = q
            tcache[name + "_scale"][sl[:-1]] = sc
            jq, jsc = jattn.quantize_heads(jpc[name])
            jcache[name] = jcache[name].at[sl].set(jq)
            jcache[name + "_scale"] = jcache[name + "_scale"].at[sl[:-1]].set(jsc)
        else:
            tcache[name][sl] = src
            jcache[name] = jcache[name].at[sl].set(jpc[name])
    for t in range(2):
        inp = {"token": toks[:, S + t], "pos": np.full((B,), S + t, np.int32)}
        jl, jcache = jtf.serve_step(params, jcache, {k: jnp.asarray(v) for k, v
                                                     in inp.items()}, jc,
                                    kv_quant=kv_quant)
        tl, tcache = ttf.serve_step(model, tcache, {k: torch.from_numpy(v)
                                                    for k, v in inp.items()},
                                    kv_quant=kv_quant)
        if kv_quant:
            _scale_close(tl.numpy(), jl, QUANT_SCALE_TOL, f"step {t}")
            assert (tl.numpy().argmax(-1) == full[:, S + t].argmax(-1)).all()
        else:
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-3,
                                       atol=2e-3, err_msg=f"step {t}")
            np.testing.assert_allclose(tl.numpy(), full[:, S + t], rtol=2e-3,
                                       atol=2e-3, err_msg=f"step {t}")


def test_tied_embedding_is_scaled_and_unembeds_through_embed():
    """Embeddings scaled by sqrt(d) in their own dtype, logits through
    ``embed.T`` capped at 30, both as the reference's."""
    jc, tc, params, model = _world()
    toks = np.array([[1, 7, 500]], np.int32)
    np.testing.assert_array_equal(
        ttf.embed_tokens(model, torch.from_numpy(toks)).numpy(),
        np.asarray(jtf.embed_tokens(params, jnp.asarray(toks), jc)))
    x = np.random.default_rng(2).standard_normal((3, jc.d_model)).astype(
        np.float32) * 4
    got = ttf.unembed(model, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jtf.unembed(params, jnp.asarray(x),
                                                           jc)),
                               rtol=1e-5, atol=1e-5)
    assert np.abs(got).max() <= 30.0 and "unembed" not in ttf.param_shapes(tc)
