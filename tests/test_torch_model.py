"""The PyTorch port's decoder against the JAX package's, on the CPU.

Reduced Llama-3 parameters come from the reference's own
``tf.init_params(cfg, PRNGKey(0), dtype=float32)`` and are carried into
the port with ``from_jax_params``; both then decode the same token
stream over the same paged KV, and over the same dense cache.  Logits
must agree within 1e-4 over 8 steps (fp32 products summed in another
order), and the written KV within 1e-5; a bf16 dense cache within 3e-2
(see the test).
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
from repro.serving.sampler import sample as jsample
from repro_torch.configs import get_arch as tget_arch
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttf
from repro_torch.serving.sampler import sample as tsample


def _cfgs(kv_heads=None):
    jc, tc = jget_arch("llama3-8b").reduced(), tget_arch("llama3-8b").reduced()
    if kv_heads is not None:
        jc = dataclasses.replace(jc, num_kv_heads=kv_heads)
        tc = dataclasses.replace(tc, num_kv_heads=kv_heads)
    return jc, tc


def test_llama3_8b_config_is_the_reference_one():
    j, t = jget_arch("llama3-8b"), tget_arch("llama3-8b")
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert t.param_count() == j.param_count()
    assert (t.num_layers, t.d_model, t.num_heads, t.num_kv_heads,
            t.resolved_head_dim, t.d_ff, t.vocab_size) == (
        32, 4096, 32, 8, 128, 14_336, 128_256)


def test_rms_norm_rope_mlp_match():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 4, 32)).astype(np.float32)
    pos = rng.integers(0, 300, (3, 5)).astype(np.int32)
    scale = rng.standard_normal(32).astype(np.float32)
    np.testing.assert_allclose(
        tlayers.rms_norm(torch.from_numpy(x), torch.from_numpy(scale)).numpy(),
        np.asarray(jlayers.rms_norm(jnp.asarray(x), jnp.asarray(scale))),
        rtol=1e-5, atol=1e-6)
    for theta in (10_000.0, 500_000.0):
        np.testing.assert_allclose(
            tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                               theta=theta).numpy(),
            np.asarray(jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                          theta=theta)),
            rtol=1e-5, atol=1e-5)
    p = {n: rng.standard_normal(s).astype(np.float32) * 0.1 for n, s in
         (("w_up", (32, 48)), ("w_gate", (32, 48)), ("w_down", (48, 32)))}
    h = x[:, 0, 0]
    np.testing.assert_allclose(
        tlayers.mlp_forward({k: torch.from_numpy(v) for k, v in p.items()},
                            torch.from_numpy(h), "silu", True).numpy(),
        np.asarray(jlayers.mlp_forward({k: jnp.asarray(v) for k, v in p.items()},
                                       jnp.asarray(h), "silu", True)),
        rtol=1e-5, atol=1e-6)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


# jitted as the reference's DecodeRunner runs it (one compile, not eager ops)
_JSTEP = jax.jit(jtf.serve_step_paged, static_argnums=(6,),
                 static_argnames=("kernel_mode",))


@pytest.mark.parametrize("kv_heads", [None, 2])
@pytest.mark.parametrize("mode", ["ref", "kernel_interpret"])
def test_serve_step_paged_logits_match_over_8_steps(kv_heads, mode):
    jc, tc = _cfgs(kv_heads)
    params = jtf.init_params(jc, jax.random.PRNGKey(0), dtype=jnp.float32)
    model = ttf.from_jax_params(_np_tree(params), tc, device="cpu")
    rng = np.random.default_rng(1)
    B, ps, MB = 3, 4, 4
    L, KVH, Dh = jc.num_layers, jc.num_kv_heads, jc.resolved_head_dim
    NP = B * MB + 2
    slab = rng.standard_normal((2, L, NP, ps, KVH, Dh)).astype(np.float32)
    bt = rng.permutation(NP)[:B * MB].reshape(B, MB).astype(np.int32)
    lens = np.array([0, 3, 6], np.int32)           # ragged starts
    jk, jv = jnp.asarray(slab[0]), jnp.asarray(slab[1])
    tk, tv = torch.from_numpy(slab[0].copy()), torch.from_numpy(slab[1].copy())
    for step in range(8):
        tok = rng.integers(0, jc.vocab_size, B).astype(np.int32)
        jl, jk, jv = _JSTEP(params, jk, jv, jnp.asarray(bt), jnp.asarray(lens),
                            {"token": jnp.asarray(tok)}, jc, kernel_mode=mode)
        tl, tk, tv = ttf.serve_step_paged(model, tk, tv, torch.from_numpy(bt),
                                          torch.from_numpy(lens),
                                          {"token": torch.from_numpy(tok)})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4, err_msg=f"step {step}")
        lens = lens + 1
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-5)


_JDENSE = jax.jit(jtf.serve_step, static_argnums=(3,))


@pytest.mark.parametrize("kv_heads", [None, 2])
@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16"])
def test_serve_step_logits_match_over_8_steps(kv_heads, kv_dtype):
    """The dense step: ragged per-row positions over a random starting
    cache (stale entries past pos must stay masked), fp32 weights.

    fp32 cache: logits within 1e-4, written KV within 1e-5.  bf16 cache:
    the reference's jnp attention rounds the scaled q and the softmax
    probabilities to bf16 before its two products, the port's kernel
    keeps them in fp32; the reduced model carries that rounding to the
    logits and to the K/V later layers write, so both must agree within
    3e-2 of their scale (largest magnitude)."""
    jc, tc = _cfgs(kv_heads)
    params = jtf.init_params(jc, jax.random.PRNGKey(0), dtype=jnp.float32)
    model = ttf.from_jax_params(_np_tree(params), tc, device="cpu")
    rng = np.random.default_rng(2)
    B, S = 3, 24
    shape = (jc.num_layers, B, S, jc.num_kv_heads, jc.resolved_head_dim)
    kv = rng.standard_normal((2,) + shape).astype(np.float32)
    jdt, tdt = getattr(jnp, kv_dtype), getattr(torch, kv_dtype)
    jcache = {"k": jnp.asarray(kv[0], jdt), "v": jnp.asarray(kv[1], jdt)}
    tcache = {"k": torch.from_numpy(kv[0].copy()).to(tdt),
              "v": torch.from_numpy(kv[1].copy()).to(tdt)}
    pos = np.array([0, 5, 13], np.int32)            # ragged positions
    for step in range(8):
        tok = rng.integers(0, jc.vocab_size, B).astype(np.int32)
        jl, jcache = _JDENSE(params, jcache, {"token": jnp.asarray(tok),
                                              "pos": jnp.asarray(pos)}, jc)
        tl, tcache = ttf.serve_step(model, tcache,
                                    {"token": torch.from_numpy(tok),
                                     "pos": torch.from_numpy(pos)})
        jl = np.asarray(jl)
        tol = 1e-4 if kv_dtype == "float32" else 3e-2 * np.abs(jl).max()
        np.testing.assert_allclose(tl.numpy(), jl, rtol=1e-4, atol=tol,
                                   err_msg=f"step {step}")
        pos = pos + 1
    for name in ("k", "v"):
        assert tcache[name].dtype == tdt
        want = np.asarray(jcache[name], np.float32)
        tol = 1e-5 if kv_dtype == "float32" else 3e-2 * np.abs(want).max()
        np.testing.assert_allclose(tcache[name].float().numpy(), want,
                                   rtol=1e-5, atol=tol)


@pytest.mark.parametrize("kv_heads", [None, 2])
@pytest.mark.parametrize("kv_dtype,tol", [("float32", 1e-4),
                                          ("bfloat16", 3e-2)])
def test_attn_decode_matches_reference(kv_heads, kv_dtype, tol):
    """One layer's dense decode attention (``attention.attn_decode``)
    against the reference's ``attn_decode``: output and written cache,
    at tests/test_kernels.py's tolerances (1e-4 fp32, 3e-2 bf16)."""
    from repro.models import attention as jattn
    from repro_torch.models import attention as tattn
    jc, tc = _cfgs(kv_heads)
    params = jtf.init_params(jc, jax.random.PRNGKey(0), dtype=jnp.float32)
    jlp = jax.tree.map(lambda a: a[0], params["layers"]["attn"])
    model = ttf.from_jax_params(_np_tree(params), tc, device="cpu")
    rng = np.random.default_rng(5)
    B, S = 3, 20
    x = rng.standard_normal((B, 1, jc.d_model)).astype(np.float32)
    shape = (B, S, jc.num_kv_heads, jc.resolved_head_dim)
    kv = rng.standard_normal((2,) + shape).astype(np.float32)
    pos = np.array([0, 7, 19], np.int32)
    jdt, tdt = getattr(jnp, kv_dtype), getattr(torch, kv_dtype)
    jo, jk, jv = jattn.attn_decode(jlp, jnp.asarray(x), jc,
                                   cache_k=jnp.asarray(kv[0], jdt),
                                   cache_v=jnp.asarray(kv[1], jdt),
                                   pos=jnp.asarray(pos))
    tk = torch.from_numpy(kv[0].copy()).to(tdt)
    tv = torch.from_numpy(kv[1].copy()).to(tdt)
    tp = torch.from_numpy(pos)
    to = tattn.attn_decode(model.layer(0), torch.from_numpy(x[:, 0]), tc, tk,
                           tv, tp, torch.arange(B), tp.long())
    np.testing.assert_allclose(to.numpy(), np.asarray(jo)[:, 0], rtol=tol,
                               atol=tol)
    for got, want in ((tk, jk), (tv, jv)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), rtol=tol,
                                   atol=tol)


@pytest.mark.parametrize("kv_heads", [None, 2])
def test_init_cache_matches_reference(kv_heads):
    jc, tc = _cfgs(kv_heads)
    for jdt, tdt in ((jnp.bfloat16, torch.bfloat16),
                     (jnp.float32, torch.float32)):
        want = jtf.init_cache(jc, 3, 40, jdt)
        got = ttf.init_cache(tc, 3, 40, tdt, device="cpu")
        assert sorted(got) == sorted(want)
        for name, t in got.items():
            assert tuple(t.shape) == want[name].shape
            assert str(t.dtype).removeprefix("torch.") == want[name].dtype.name
            assert not t.any()


def test_from_jax_params_keeps_stacked_layout():
    jc, tc = _cfgs()
    params = _np_tree(jtf.init_params(jc, jax.random.PRNGKey(0),
                                      dtype=jnp.float32))
    model = ttf.from_jax_params(params, tc, device="cpu")
    np.testing.assert_array_equal(model.wq.numpy(), params["layers"]["attn"]["wq"])
    np.testing.assert_array_equal(model.w_down[1].numpy(),
                                  params["layers"]["mlp"]["w_down"][1])
    assert not any(p.requires_grad for p in model.parameters())


def test_init_params_is_seeded_and_scaled():
    _, tc = _cfgs()
    a = ttf.init_params(tc, torch.Generator().manual_seed(0), device="cpu")
    b = ttf.init_params(tc, torch.Generator().manual_seed(0), device="cpu")
    assert a.wq.dtype == torch.bfloat16 and a.device == torch.device("cpu")
    assert torch.equal(a.wq, b.wq) and torch.equal(a.embed, b.embed)
    assert torch.all(a.attn_norm == 1)
    # truncated normal at 1/sqrt(fan_in): |w| <= 2/sqrt(d)
    assert a.wq.float().abs().max() <= 2 / tc.d_model ** 0.5 + 1e-3
    assert a.embed.float().abs().max() <= 0.04 + 1e-3


def test_init_params_default_device_needs_a_card(monkeypatch):
    _, tc = _cfgs()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        ttf.init_params(tc, torch.Generator())


def test_unsupported_arch_is_refused():
    """An RWKV6 block in a config that also declares attention (GQA) is
    not a config the port implements, and is refused (RWKV6 itself is
    attention-free; a sliding window is ported since gemma2)."""
    from repro_torch.configs.base import SSMConfig
    jc, tc = _cfgs()
    with pytest.raises(ValueError):
        ttf.check_supported(dataclasses.replace(tc, ssm=SSMConfig(kind="rwkv6")))


def test_greedy_sample_matches_including_ties():
    logits = np.array([[0.1, 0.7, 0.7, 0.2], [3.0, -1.0, 3.0, 3.0]], np.float32)
    np.testing.assert_array_equal(tsample(torch.from_numpy(logits)).numpy(),
                                  np.asarray(jsample(jnp.asarray(logits))))


def test_topk_sampling_draws_from_the_top_k_only():
    logits = torch.tensor([[5.0, 4.0, -9.0, 3.0]] * 64)
    tok = tsample(logits, torch.Generator().manual_seed(0), temperature=1.0,
                  top_k=2)
    assert set(tok.tolist()) <= {0, 1}
