"""The PyTorch port's decoder against the JAX package's, on the CPU.

Reduced Llama-3 parameters come from the reference's own
``tf.init_params(cfg, PRNGKey(0), dtype=float32)`` and are carried into
the port with ``from_jax_params``; both then decode the same token
stream over the same paged KV.  Logits must agree within 1e-4 over 8
steps (fp32 products summed in another order).
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
    jc, tc = _cfgs()
    with pytest.raises(ValueError):
        ttf.check_supported(dataclasses.replace(tc, sliding_window=8))


def test_greedy_sample_matches_including_ties():
    logits = np.array([[0.1, 0.7, 0.7, 0.2], [3.0, -1.0, 3.0, 3.0]], np.float32)
    np.testing.assert_array_equal(tsample(torch.from_numpy(logits)).numpy(),
                                  np.asarray(jsample(jnp.asarray(logits))))


def test_topk_sampling_draws_from_the_top_k_only():
    logits = torch.tensor([[5.0, 4.0, -9.0, 3.0]] * 64)
    tok = tsample(logits, torch.Generator().manual_seed(0), temperature=1.0,
                  top_k=2)
    assert set(tok.tolist()) <= {0, 1}
