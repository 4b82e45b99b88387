"""The port's multi-head latent attention (minicpm3) against the JAX
package's, on the CPU: the latents, the expanded prefill attention
(``mla_forward``), the absorbed decode (``mla_decode``, its attention
through ``kernels.ops.mla_decode``'s plain version), the latent cache,
and the reduced minicpm3's decode.

Weights are the reference's ``init_params(cfg, PRNGKey(0), float32)``
carried across with ``from_jax_params``; inputs are numpy draws.  The
reference computes the absorbed attention in fp32 from the cache cast
to fp32, as the port does, so the module-level tolerance is 1e-5 in
fp32 (sums in another order) for a bf16 cache too; ``forward`` and
``prefill`` within 2e-4 and the decode steps within 2e-3, as the other
families' tests.
"""

import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import get_arch as jget_arch
from repro.models import mla as jmla
from repro.models import transformer as jtf
from repro_torch.configs import get_arch as tget_arch
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import mla as tmla
from repro_torch.models import transformer as ttf

ARCH = "minicpm3-4b"


@functools.lru_cache(maxsize=None)
def _world():
    jc, tc = jget_arch(ARCH).reduced(), tget_arch(ARCH).reduced()
    params = jtf.init_params(jc, jax.random.PRNGKey(0), dtype=jnp.float32)
    model = ttf.from_jax_params(jax.tree.map(np.asarray, params), tc,
                                device="cpu")
    return jc, tc, params, model


def _layer(params, l):
    return jax.tree.map(lambda a: a[l], params["layers"])["attn"]


def test_reduced_and_full_shapes():
    """The kernel's two (R, Dr) shapes: minicpm3's (256, 32) with 40
    heads, its reduced config's (32, 16) with 4; the MLA parameters at
    their reference shapes."""
    for cfg, want in ((tget_arch(ARCH), (40, 256, 32, 96)),
                      (tget_arch(ARCH).reduced(), (4, 32, 16, 32))):
        m = cfg.mla
        assert (cfg.num_heads, m.kv_lora_rank, m.qk_rope_head_dim,
                m.qk_nope_head_dim + m.qk_rope_head_dim) == want
    jc, tc, params, model = _world()
    for name, shape in tmla.mla_param_shapes(tc).items():
        assert tuple(getattr(model, name).shape[1:]) == shape
        assert params["layers"]["attn"][name].shape[1:] == shape


def test_latents_and_mla_forward_match_reference():
    jc, tc, params, model = _world()
    rng = np.random.default_rng(4)
    B, S = 2, 11
    x = rng.standard_normal((B, S, jc.d_model)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)
    lp = _layer(params, 2)
    want = jmla._latents(lp, jnp.asarray(x), jc, jnp.asarray(pos))
    got = tmla._latents(model.layer(2), torch.from_numpy(x), tc,
                        torch.from_numpy(pos))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
    jout, (jc_kv, jk_pe) = jmla.mla_forward(lp, jnp.asarray(x), jc,
                                            positions=jnp.asarray(pos),
                                            attn_chunk=4)
    tout, (tc_kv, tk_pe) = tmla.mla_forward(model.layer(2), torch.from_numpy(x),
                                            tc, positions=torch.from_numpy(pos),
                                            attn_chunk=4)
    for g, w in ((tout, jout), (tc_kv, jc_kv), (tk_pe, jk_pe)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_decode_matches_reference(dtype):
    """The absorbed step from a random latent cache at ragged positions
    (0 and past half the cache): the output against the reference's
    ``mla_decode`` within 1e-5 (fp32 attention over the cache in either
    dtype), the written cache within 1e-5 (fp32) or one bf16 step."""
    jc, tc, params, model = _world()
    m = jc.mla
    rng = np.random.default_rng(9)
    B, S = 3, 19
    ckv = rng.standard_normal((B, S, m.kv_lora_rank)).astype(np.float32)
    kpe = rng.standard_normal((B, S, m.qk_rope_head_dim)).astype(np.float32)
    x = rng.standard_normal((B, jc.d_model)).astype(np.float32)
    pos = np.array([0, 12, 18], np.int32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jout, jckv, jkpe = jmla.mla_decode(
        _layer(params, 1), jnp.asarray(x)[:, None], jc,
        cache_ckv=jnp.asarray(ckv, jdt), cache_kpe=jnp.asarray(kpe, jdt),
        pos=jnp.asarray(pos))
    tckv = torch.from_numpy(ckv).to(tdt)
    tkpe = torch.from_numpy(kpe).to(tdt)
    tp = torch.from_numpy(pos)
    tout = tmla.mla_decode(model.layer(1), torch.from_numpy(x), tc, tckv,
                           tkpe, tp, torch.arange(B), tp.long())
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout)[:, 0], rtol=1e-5,
                               atol=1e-5)
    # the new latents' fp32 sums in another order: within 1e-5, or one
    # bf16 step where that moves a value across a rounding edge
    tol = 1e-5 if dtype == "float32" else 2 ** -7
    for got, want in ((tckv, jckv), (tkpe, jkpe)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), rtol=tol,
                                   atol=tol)


@pytest.mark.parametrize("R,Dr,H", [(32, 16, 4), (256, 32, 40)])
def test_mla_decode_plain_version_is_the_reference_attention(R, Dr, H):
    """``kernels.ops.mla_decode`` on CPU tensors (the plain version)
    against the reference's absorbed attention written out in jnp, at
    the reduced and the full shapes, positions 0 to S - 1."""
    rng = np.random.default_rng(R)
    B, S = 4, 40
    q_abs = rng.standard_normal((B, H, R)).astype(np.float32)
    q_pe = rng.standard_normal((B, H, Dr)).astype(np.float32)
    ckv = rng.standard_normal((B, S, R)).astype(np.float32)
    kpe = rng.standard_normal((B, S, Dr)).astype(np.float32)
    pos = np.array([0, 1, 23, 39], np.int32)
    scale = 1.0 / math.sqrt(96)
    s = (jnp.einsum("bhr,btr->bht", q_abs, ckv)
         + jnp.einsum("bhk,btk->bht", q_pe, kpe)) * scale
    s = jnp.where(jnp.arange(S)[None, None, :] <= pos[:, None, None], s,
                  -jnp.inf)
    want = jnp.einsum("bht,btr->bhr", jax.nn.softmax(s, axis=-1), ckv)
    got = tops.mla_decode(*(torch.from_numpy(a) for a in
                            (q_abs, q_pe, ckv, kpe, pos)), scale)
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, H, R)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(
        got.numpy(), tref.mla_decode_ref(*(torch.from_numpy(a) for a in
                                           (q_abs, q_pe, ckv, kpe, pos)),
                                         scale).numpy())


def test_init_cache_is_the_reference_layout():
    jc, tc, _, _ = _world()
    for kv_quant in (False, True):           # MLA keeps its latent cache
        want = jax.eval_shape(lambda: jtf.init_cache(jc, 2, 9, jnp.bfloat16,
                                                     kv_quant=kv_quant))
        got = ttf.init_cache(tc, 2, 9, torch.bfloat16, device="cpu",
                             kv_quant=kv_quant)
        assert sorted(got) == sorted(want) == ["ckv", "kpe"]
        for name, t in got.items():
            assert tuple(t.shape) == want[name].shape
            assert t.dtype == torch.bfloat16


def test_decode_steps_and_after_prefill_match_reference():
    """8 steps from an empty latent cache (rows at pos 0, 0 and 5), then
    the reference's decode-after-prefill check: a 20-token prefill, its
    cache copied into ``init_cache``, 2 steps against the reference's
    and against the port's teacher-forced ``forward``.  fp32 logits
    within 2e-3, prefill's within 2e-4."""
    jc, tc, params, model = _world()
    rng = np.random.default_rng(13)
    B, S = 3, 16
    jcache = jtf.init_cache(jc, B, S, jnp.float32)
    tcache = ttf.init_cache(tc, B, S, torch.float32, device="cpu")
    pos = np.array([0, 0, 5], np.int32)
    for t in range(8):
        tok = rng.integers(0, jc.vocab_size, (B,)).astype(np.int32)
        jl, jcache = jtf.serve_step(params, jcache, {"token": jnp.asarray(tok),
                                                     "pos": jnp.asarray(pos)}, jc)
        tl, tcache = ttf.serve_step(model, tcache, {"token": torch.from_numpy(tok),
                                                    "pos": torch.from_numpy(pos)})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-3,
                                   atol=2e-3, err_msg=f"step {t}")
        pos = pos + 1
    for name in ("ckv", "kpe"):
        np.testing.assert_allclose(tcache[name].numpy(), np.asarray(jcache[name]),
                                   rtol=2e-3, atol=2e-3, err_msg=name)

    B, S = 2, 20
    toks = rng.integers(0, jc.vocab_size, (B, S + 2)).astype(np.int32)
    jl, jpc = jtf.prefill(params, {"tokens": jnp.asarray(toks[:, :S])}, jc)
    tl, tpc = ttf.prefill(model, {"tokens": torch.from_numpy(toks[:, :S])})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-4, atol=2e-4)
    full = ttf.unembed(model, ttf.forward(model, torch.from_numpy(toks))[0])
    jcache = jtf.init_cache(jc, B, S + 2, jnp.float32)
    tcache = ttf.init_cache(tc, B, S + 2, torch.float32, device="cpu")
    for name in ("ckv", "kpe"):
        np.testing.assert_allclose(tpc[name].numpy(), np.asarray(jpc[name]),
                                   rtol=2e-4, atol=2e-4, err_msg=name)
        tcache[name][:, :, :S] = tpc[name]
        jcache[name] = jcache[name].at[:, :, :S].set(jpc[name])
    for t in range(2):
        inp = {"token": toks[:, S + t], "pos": np.full((B,), S + t, np.int32)}
        jl, jcache = jtf.serve_step(params, jcache, {k: jnp.asarray(v) for k, v
                                                     in inp.items()}, jc)
        tl, tcache = ttf.serve_step(model, tcache, {k: torch.from_numpy(v)
                                                    for k, v in inp.items()})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-3,
                                   atol=2e-3, err_msg=f"step {t}")
        np.testing.assert_allclose(tl.numpy(), full[:, S + t].numpy(),
                                   rtol=2e-3, atol=2e-3, err_msg=f"step {t}")
