"""The port's RWKV6 (``repro_torch.models.rwkv6``) against the JAX
package's on the CPU, function by function, in fp32; the chunked time
mix against the port's own token-by-token recurrence; and the model's
seeded init at the reference's scales.

Weights come from the reference's ``tf.init_params(cfg, PRNGKey(0),
dtype=float32)`` of the reduced rwkv6-3b (d 128, heads of 16 channels,
chunks of 16), carried across with ``from_jax_params``; inputs and
states are numpy draws from a seed.  Tolerances: 1e-5 for the token
shift mixing and the decay (the same fp32 ops; past a clip edge the
decay is one value everywhere), 2e-4 for the time mix, its step and the channel mix
(fp32 sums of up to 48 positions in another order), the bound the
reference's own ``tests/test_ssm_parity.py`` holds its chunked form to.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import get_arch as jget_arch
from repro.models import rwkv6 as jrwkv
from repro.models import transformer as jtf
from repro_torch.configs import get_arch as tget_arch
from repro_torch.models import rwkv6 as trwkv
from repro_torch.models import transformer as ttf

TOL = 2e-4


@functools.lru_cache(maxsize=None)
def _world():
    jc, tc = jget_arch("rwkv6-3b").reduced(), tget_arch("rwkv6-3b").reduced()
    params = jtf.init_params(jc, jax.random.PRNGKey(0), dtype=jnp.float32)
    model = ttf.from_jax_params(jax.tree.map(np.asarray, params), tc,
                                device="cpu")
    return jc, tc, params, model


def _layer(l=1):
    """(reference cfg, port cfg, the reference's time-mix tree of layer
    l, the port's layer l)."""
    jc, tc, params, model = _world()
    return (jc, tc, jax.tree.map(lambda a: a[l], params["layers"]["tm"]),
            model.layer(l))


def _draw(rng, *shape, scale=0.5):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _close(got, want, tol=TOL, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=what)


def test_ddlerp_matches_reference():
    jc, tc, jp, tp = _layer()
    rng = np.random.default_rng(0)
    x, xp = _draw(rng, 2, 7, jc.d_model), _draw(rng, 2, 7, jc.d_model)
    want = jrwkv._ddlerp(jp, jnp.asarray(x), jnp.asarray(xp))
    got = trwkv._ddlerp(tp, torch.from_numpy(x), torch.from_numpy(xp))
    assert len(got) == len(want) == 5
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g.numpy(), w, 1e-5, f"target {i}")


@pytest.mark.parametrize("w0", [None, 10.0, -10.0])
def test_decay_matches_reference_and_clips(w0):
    """The decay from the layer's w0, and from a w0 far past either clip
    edge: every log-decay then one value, -exp(2.079) or -exp(-6) (to
    the last bits of each package's fp32 exp)."""
    jc, tc, jp, tp = _layer()
    if w0 is not None:
        jp = dict(jp, w0=jnp.full(jp["w0"].shape, w0, jnp.float32))
        tp = dict(tp, w0=torch.full(tp["w0"].shape, w0))
    rng = np.random.default_rng(1)
    xw = _draw(rng, 3, 5, jc.d_model)
    want = np.asarray(jrwkv._decay(jp, jnp.asarray(xw)))
    got = trwkv._decay(tp, torch.from_numpy(xw))
    assert got.dtype == torch.float32
    _close(got.numpy(), want, 1e-5)
    if w0 is not None:     # one value, the clip edge's, everywhere
        edge = -np.exp(2.079 if w0 > 0 else -6.0)
        for a in (got.numpy(), want):
            assert np.all(a == a.flat[0]), a
            np.testing.assert_allclose(a.flat[0], edge, rtol=1e-6)


def _states(jc, rng, B):
    d, K = jc.d_model, jc.ssm.head_dim
    return _draw(rng, B, d), _draw(rng, B, d // K, K, K, scale=0.3)


@pytest.mark.parametrize("S", [48, 20])
def test_time_mix_matches_reference(S):
    """S = 48: three chunks of 16, the state carried across them; S = 20:
    16 does not divide it, one chunk of 20 (the reference's fallback).
    From a nonzero shift and state."""
    jc, tc, jp, tp = _layer()
    rng = np.random.default_rng(S)
    B = 2
    x = _draw(rng, B, S, jc.d_model)
    shift, state = _states(jc, rng, B)
    want = jrwkv.rwkv6_time_mix(jp, jnp.asarray(x), jc,
                                shift_in=jnp.asarray(shift),
                                state_in=jnp.asarray(state))
    got = trwkv.rwkv6_time_mix(tp, torch.from_numpy(x), tc,
                               shift_in=torch.from_numpy(shift),
                               state_in=torch.from_numpy(state))
    for g, w, what in zip(got, want, ("y", "shift", "state")):
        assert tuple(g.shape) == w.shape, what
        _close(g.numpy(), w, what=what)
    assert got[2].dtype == torch.float32


def test_time_mix_step_matches_reference():
    jc, tc, jp, tp = _layer(2)
    rng = np.random.default_rng(5)
    x = _draw(rng, 3, jc.d_model)
    shift, state = _states(jc, rng, 3)
    want = jrwkv.rwkv6_time_mix_step(jp, jnp.asarray(x), jc,
                                     shift_in=jnp.asarray(shift),
                                     state_in=jnp.asarray(state))
    got = trwkv.rwkv6_time_mix_step(tp, torch.from_numpy(x), tc,
                                    shift_in=torch.from_numpy(shift),
                                    state_in=torch.from_numpy(state))
    for g, w, what in zip(got, want, ("y", "shift", "state")):
        _close(g.numpy(), w, what=what)


@pytest.mark.parametrize("shape", [(2, 9), (3,)])
def test_channel_mix_matches_reference(shape):
    """On [B, S, d] (the shift from before the sequence) and on one
    token [B, d]."""
    jc, tc, jp, tp = _layer()
    rng = np.random.default_rng(len(shape))
    x = _draw(rng, *shape, jc.d_model)
    shift = _draw(rng, shape[0], jc.d_model)
    want = jrwkv.rwkv6_channel_mix(jp, jnp.asarray(x), jnp.asarray(shift))
    got = trwkv.rwkv6_channel_mix(tp, torch.from_numpy(x),
                                  torch.from_numpy(shift))
    _close(got[0].numpy(), want[0], what="y")
    _close(got[1].numpy(), want[1], 0, what="shift out")


@pytest.mark.parametrize("S", [48, 20])
def test_chunked_time_mix_is_the_recurrence(S):
    """Within the port: the chunked time mix equals the token-by-token
    ``rwkv6_time_mix_step`` from the same shift and state (the
    counterpart of the reference's ``tests/test_ssm_parity.py``, at its
    tolerance)."""
    jc, tc, jp, tp = _layer()
    rng = np.random.default_rng(10 + S)
    B = 2
    x = torch.from_numpy(_draw(rng, B, S, tc.d_model))
    shift, state = (torch.from_numpy(a) for a in _states(tc, rng, B))
    y, sh_c, st_c = trwkv.rwkv6_time_mix(tp, x, tc, shift_in=shift,
                                         state_in=state)
    ys, sh, st = [], shift, state
    for t in range(S):
        yt, sh, st = trwkv.rwkv6_time_mix_step(tp, x[:, t], tc, shift_in=sh,
                                               state_in=st)
        ys.append(yt)
    _close(y.numpy(), torch.stack(ys, 1).numpy(), what="y")
    _close(st_c.numpy(), st.numpy(), what="state")
    assert torch.equal(sh_c, sh)


def test_model_cache_is_fp32_wkv_and_model_dtype_shifts():
    """``cache_shapes`` is the reference's ``init_cache`` key for key and
    dtype for dtype (the wkv state fp32 beside a bf16 cache), and
    ``kv_quant`` changes nothing for this family."""
    jc, tc, _, _ = _world()
    want = jax.eval_shape(lambda: jtf.init_cache(jc, 3, 10, jnp.bfloat16))
    for kv_quant in (False, True):
        got = ttf.cache_shapes(tc, 3, 10, torch.bfloat16, kv_quant=kv_quant)
        assert sorted(got) == sorted(want) == ["shift1", "shift2", "wkv"]
        for name, (shape, dt) in got.items():
            assert shape == want[name].shape, name
            assert str(dt).split(".")[-1] == str(want[name].dtype), name


def test_init_params_keeps_the_reference_scales():
    """Seeded, and each tensor at the reference's ``rwkv6_params`` scale:
    its explicit one (0.1 for the mixes, 0.01 for the LoRA B matrices,
    0.5 for w0, 0.3 for the bonus) or 1/sqrt(fan_in) of the per-layer
    shape; the norms (gn_scale among them) ones."""
    cfg = tget_arch("rwkv6-3b").reduced()
    a = ttf.init_params(cfg, torch.Generator().manual_seed(0), device="cpu",
                        dtype=torch.float32)
    b = ttf.init_params(cfg, torch.Generator().manual_seed(0), device="cpu",
                        dtype=torch.float32)
    for name, p in a.named_parameters():
        assert torch.equal(p, getattr(b, name)), name
        if name.endswith("norm") or name == "gn_scale":
            assert torch.all(p == 1), name
            continue
        per = p.shape[1:] if name in ttf._LAYER_PARAMS else p.shape
        scale = (0.02 if name == "embed" else
                 trwkv.INIT_SCALES.get(name, 1 / per[0] ** 0.5))
        assert p.abs().max() <= 2 * scale + 1e-6, name
        assert 0.8 * scale < p.std() < scale, name     # N(0, 1) cut at 2
