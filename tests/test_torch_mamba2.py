"""The port's Mamba2 (``repro_torch.models.mamba2``) and zamba2's
shared block against the JAX package's on the CPU: the block's
functions in fp32, the chunked SSD against the port's own token-by-token
step, zamba2's seeded init at the reference's scales, and a reduced
zamba2 with heads of 80 (the full config's Dh) whose decode reaches
kernel 4's plain version at Dh = 80.

Weights come from the reference's ``tf.init_params(cfg, PRNGKey(0),
dtype=float32)`` of the reduced zamba2-2.7b (d 128, d_in 256, heads of
16 channels, state 16, chunks of 16, two groups of two blocks), carried
across with ``from_jax_params``; inputs and states are numpy draws from
a seed.  Tolerances: the conv and its state within 1e-5 (the same fp32
products in the same order); the SSD forward, its step and the chunked
form against the recurrence within 2e-4 (fp32 sums in another order),
the reference's own ``tests/test_ssm_parity.py`` bound; the Dh = 80
model's prefill within 2e-4 and its decode steps within 2e-3, the
bounds ``tests/test_torch_families.py`` holds the other families to.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import get_arch as jget_arch
from repro.models import mamba2 as jmamba
from repro.models import transformer as jtf
from repro_torch.configs import get_arch as tget_arch
from repro_torch.kernels import flash_decode as tfd
from repro_torch.kernels import ref as tref
from repro_torch.models import mamba2 as tmamba
from repro_torch.models import transformer as ttf

TOL = 2e-4


@functools.lru_cache(maxsize=None)
def _world(head_dim=None):
    jc, tc = (jget_arch("zamba2-2.7b").reduced(),
              tget_arch("zamba2-2.7b").reduced())
    if head_dim is not None:
        jc = dataclasses.replace(jc, head_dim=head_dim)
        tc = dataclasses.replace(tc, head_dim=head_dim)
    params = jtf.init_params(jc, jax.random.PRNGKey(0), dtype=jnp.float32)
    model = ttf.from_jax_params(jax.tree.map(np.asarray, params), tc,
                                device="cpu")
    return jc, tc, params, model


def _block(g=1, i=0):
    """(reference cfg, port cfg, the reference's Mamba2 tree of block i
    of group g, the port's same block)."""
    jc, tc, params, model = _world()
    per = jc.shared_attn_every
    return (jc, tc, jax.tree.map(lambda a: a[g, i], params["layers"]["mamba"]),
            model.layer(g * per + i))


def _draw(rng, *shape, scale=0.5):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _close(got, want, tol=TOL, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=what)


def _states(jc, rng, B):
    d_in, H, P, N = jmamba.mamba2_dims(jc)
    return (_draw(rng, B, jc.ssm.conv_width - 1, d_in + 2 * N),
            _draw(rng, B, H, P, N, scale=0.3))


def test_dims_and_block_shapes_are_the_reference_ones():
    jc, tc, jp, tp = _block()
    assert tmamba.mamba2_dims(tc) == jmamba.mamba2_dims(jc)
    shapes = tmamba.mamba2_param_shapes(tc)
    assert sorted(shapes) == sorted(jp) == sorted(tmamba.PARAMS)
    for name, shape in shapes.items():
        assert shape == jp[name].shape == tuple(tp[name].shape), name


@pytest.mark.parametrize("S", [9, 1])
def test_conv_matches_reference(S):
    """The causal depthwise conv and its state (the last cw - 1 inputs)
    from a nonzero conv input, over S positions (S = 1: the state takes
    conv_in's tail)."""
    jc, tc, jp, tp = _block()
    rng = np.random.default_rng(S)
    d_in, H, P, N = jmamba.mamba2_dims(jc)
    xbc = _draw(rng, 2, S, d_in + 2 * N)
    conv_in, _ = _states(jc, rng, 2)
    want = jmamba._conv(jp, jnp.asarray(xbc), jnp.asarray(conv_in))
    got = tmamba._conv(tp, torch.from_numpy(xbc), torch.from_numpy(conv_in))
    _close(got[0].numpy(), want[0], 1e-5, "out")
    _close(got[1].numpy(), want[1], 0, "conv out")


@pytest.mark.parametrize("S", [48, 20])
def test_forward_matches_reference(S):
    """S = 48: three chunks of 16, the state carried across them; S = 20:
    one chunk of 20 (the reference's fallback).  From a nonzero conv
    input and state."""
    jc, tc, jp, tp = _block()
    rng = np.random.default_rng(S)
    x = _draw(rng, 2, S, jc.d_model)
    conv_in, state = _states(jc, rng, 2)
    want = jmamba.mamba2_forward(jp, jnp.asarray(x), jc,
                                 conv_in=jnp.asarray(conv_in),
                                 state_in=jnp.asarray(state))
    got = tmamba.mamba2_forward(tp, torch.from_numpy(x), tc,
                                conv_in=torch.from_numpy(conv_in),
                                state_in=torch.from_numpy(state))
    for g, w, what in zip(got, want, ("y", "conv", "state")):
        assert tuple(g.shape) == w.shape, what
        _close(g.numpy(), w, what=what)
    assert got[2].dtype == torch.float32


def test_step_matches_reference():
    jc, tc, jp, tp = _block(0, 1)
    rng = np.random.default_rng(4)
    x = _draw(rng, 3, jc.d_model)
    conv_in, state = _states(jc, rng, 3)
    want = jmamba.mamba2_step(jp, jnp.asarray(x), jc,
                              conv_in=jnp.asarray(conv_in),
                              state_in=jnp.asarray(state))
    got = tmamba.mamba2_step(tp, torch.from_numpy(x), tc,
                             conv_in=torch.from_numpy(conv_in),
                             state_in=torch.from_numpy(state))
    for g, w, what in zip(got, want, ("y", "conv", "state")):
        _close(g.numpy(), w, what=what)


@pytest.mark.parametrize("S", [48, 20])
def test_chunked_forward_is_the_recurrence(S):
    """Within the port: the chunked SSD equals the token-by-token
    ``mamba2_step`` from the same conv input and state (the counterpart
    of the reference's ``tests/test_ssm_parity.py``, at its
    tolerances)."""
    jc, tc, jp, tp = _block()
    rng = np.random.default_rng(20 + S)
    x = torch.from_numpy(_draw(rng, 2, S, tc.d_model))
    conv0, st0 = (torch.from_numpy(a) for a in _states(tc, rng, 2))
    y, conv_c, st_c = tmamba.mamba2_forward(tp, x, tc, conv_in=conv0,
                                            state_in=st0)
    ys, conv, st = [], conv0, st0
    for t in range(S):
        yt, conv, st = tmamba.mamba2_step(tp, x[:, t], tc, conv_in=conv,
                                          state_in=st)
        ys.append(yt)
    _close(y.numpy(), torch.stack(ys, 1).numpy(), what="y")
    _close(st_c.numpy(), st.numpy(), what="state")
    _close(conv_c.numpy(), conv.numpy(), 1e-5, "conv")


def test_shared_block_merges_the_group_lora():
    """Group g's attention weights are the shared ones plus its LoRA
    delta, ``wq + qa @ qb`` reshaped to [d, H, Dh] and ``wv + va @ vb``
    to [d, KVH, Dh], as the reference merges them; wk and wo are
    shared as they are."""
    jc, tc, params, model = _world()
    d, H, KVH, Dh = (jc.d_model, jc.num_heads, jc.num_kv_heads,
                     jc.resolved_head_dim)
    for g in range(ttf.zamba2_groups(tc)[0]):
        ap, mp = ttf.shared_block(model, g)
        lo = jax.tree.map(lambda a: np.asarray(a[g]), params["lora"])
        sh = jax.tree.map(np.asarray, params["shared"])
        _close(ap["wq"].numpy(), sh["attn"]["wq"] + (lo["qa"] @ lo["qb"])
               .reshape(d, H, Dh), 1e-6, "wq")
        _close(ap["wv"].numpy(), sh["attn"]["wv"] + (lo["va"] @ lo["vb"])
               .reshape(d, KVH, Dh), 1e-6, "wv")
        assert ap["wk"] is model.shared_wk and ap["wo"] is model.shared_wo
        assert sorted(mp) == sorted(sh["mlp"])


def test_cache_is_the_reference_layout():
    """``cache_shapes`` is the reference's ``init_cache`` key for key and
    dtype for dtype (the SSD state fp32 beside a bf16 cache), and
    ``kv_quant`` changes nothing for this family."""
    jc, tc, _, _ = _world()
    want = jax.eval_shape(lambda: jtf.init_cache(jc, 3, 10, jnp.bfloat16))
    for kv_quant in (False, True):
        got = ttf.cache_shapes(tc, 3, 10, torch.bfloat16, kv_quant=kv_quant)
        assert sorted(got) == sorted(want) == ["conv", "shared_k",
                                               "shared_v", "ssd"]
        for name, (shape, dt) in got.items():
            assert shape == want[name].shape, name
            assert str(dt).split(".")[-1] == str(want[name].dtype), name


def test_init_params_keeps_the_reference_scales():
    """Seeded, and each tensor at the reference's scale: the Mamba2
    block's explicit ones (0.5 for the conv, A and dt bias, 1.0 for the
    D skip), 0.01 for the LoRA B matrices, else 1/sqrt(fan_in) of the
    per-block or per-group shape ([G, per, ...] and [G, ...] stacks
    left out); norms ones, the conv bias zeros."""
    cfg = tget_arch("zamba2-2.7b").reduced()
    a = ttf.init_params(cfg, torch.Generator().manual_seed(0), device="cpu",
                        dtype=torch.float32)
    b = ttf.init_params(cfg, torch.Generator().manual_seed(0), device="cpu",
                        dtype=torch.float32)
    scales = {**tmamba.INIT_SCALES, "lora_qb": 0.01, "lora_vb": 0.01}
    for name, p in a.named_parameters():
        assert torch.equal(p, getattr(b, name)), name
        if name.endswith("norm"):
            assert torch.all(p == 1), name
            continue
        if name == "conv_b":
            assert torch.all(p == 0), name
            continue
        k = (2 if name in ttf._LAYER_PARAMS else
             1 if name.startswith("lora_") else 0)
        scale = (0.02 if name == "embed" else
                 scales.get(name, 1 / p.shape[k] ** 0.5))
        assert p.abs().max() <= 2 * scale + 1e-6, name
        assert 0.8 * scale < p.std() < scale, name     # N(0, 1) cut at 2


_JDENSE = jax.jit(jtf.serve_step, static_argnums=(3,))


def test_dh80_zamba2_matches_reference(monkeypatch):
    """A reduced zamba2 with the full config's heads of 80: prefill's
    logits and cache within 2e-4, then 8 ``serve_step`` steps from a
    random fp32 cache at ragged positions within 2e-3, the shared
    attention through the plain version of kernel 4 at Dh = 80 against
    the reference's ``attn_decode``."""
    jc, tc, params, model = _world(80)
    assert tc.resolved_head_dim == 80
    rng = np.random.default_rng(80)
    toks = rng.integers(0, jc.vocab_size, (2, 20)).astype(np.int32)
    jl, jcache = jtf.prefill(params, {"tokens": jnp.asarray(toks)}, jc)
    tl, tcache = ttf.prefill(model, {"tokens": torch.from_numpy(toks)})
    _close(tl.numpy(), jl, what="prefill logits")
    assert tcache["shared_k"].shape[-1] == 80
    for name in jcache:
        _close(tcache[name].numpy(), jcache[name], what=name)
    B, S = 3, 24
    shapes = jax.eval_shape(lambda: jtf.init_cache(jc, B, S, jnp.float32))
    kv = {n: rng.standard_normal(shapes[n].shape).astype(np.float32)
          for n in sorted(shapes)}
    jcache = {n: jnp.asarray(a) for n, a in kv.items()}
    tcache = {n: torch.from_numpy(a.copy()) for n, a in kv.items()}
    pos = np.array([0, 5, 13], np.int32)
    calls = []

    def spy(q, *a, **kw):
        calls.append(q.shape[-1])
        return tref.flash_decode_ref(q, *a, **kw)
    monkeypatch.setattr(tfd, "flash_decode_ref", spy)
    for step in range(8):
        tok = rng.integers(0, jc.vocab_size, (B,)).astype(np.int32)
        jl, jcache = _JDENSE(params, jcache, {"token": jnp.asarray(tok),
                                              "pos": jnp.asarray(pos)}, jc)
        tl, tcache = ttf.serve_step(model, tcache,
                                    {"token": torch.from_numpy(tok),
                                     "pos": torch.from_numpy(pos)})
        _close(tl.numpy(), jl, 2e-3, f"step {step}")
        pos = pos + 1
    assert calls == [80] * (8 * ttf.zamba2_groups(tc)[0])
    for name in jcache:
        _close(tcache[name].numpy(), jcache[name], 2e-3, name)


def test_paged_decode_is_refused():
    """zamba2's shared block is GQA, but the family decodes over its
    dense cache only (the reference's ``supports_paged_decode``): the
    paged step refuses it before touching a slab."""
    jc, tc, _, model = _world()
    with pytest.raises(ValueError, match="dense cache"):
        ttf.serve_step_paged(model, None, None, None, None,
                             {"token": torch.zeros(1, dtype=torch.int32)})
