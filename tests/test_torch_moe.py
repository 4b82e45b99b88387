"""The port's MoE layer (``models/moe.py``) against the JAX package's, on
the CPU.

Parameters come from the reference's own ``moe_params`` (fp32 unless a
case says bf16) and the inputs from numpy seeds; both packages run the
same layer.  The selected experts and the kept (token, expert) pairs
must be equal, the kept set recomputed from the reference's routing
lines (``src/repro/models/moe.py:59-78``: router product, fp32 softmax,
``lax.top_k``, exclusive cumsum in row order, ``pos < C``); in fp32 the
aux loss within 1e-5 and the outputs within 1e-5 of their scale (their
largest magnitude: the reference's init scales the [E, d, F] expert
weights by fan-in E, so outputs reach O(100), and fp32 sums taken in
another order differ by about 1e-7 of that).  In bf16 the
experts' products round at other places in the two frameworks, so the
output is held within 3e-2 of its scale (``tests/test_kernels.py:77``),
on inputs whose router logits are exact in bf16 (small integers over
8), so that both packages route alike and ties are common.
"""

import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import get_arch as jget_arch
from repro.models import moe as jmoe
from repro.models.layers import InitMaker
from repro_torch.configs import get_arch as tget_arch
from repro_torch.models import moe as tmoe

BF16_SCALE_TOL = 3e-2


def _cfgs(arch, **moe):
    """The reduced config of ``arch`` in both packages, its MoE fields
    replaced by ``moe``."""
    out = []
    for get in (jget_arch, tget_arch):
        c = get(arch).reduced()
        out.append(dataclasses.replace(c, moe=dataclasses.replace(c.moe, **moe)))
    return out


def _params(jc, dtype=jnp.float32, seed=0):
    """The reference's ``moe_params`` and the same numbers under the
    port's names (the dense residual flattened to dense_w_*)."""
    p = jmoe.moe_params(InitMaker(jax.random.PRNGKey(seed), dtype=dtype), jc)
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    tp = {k: torch.tensor(np.asarray(v, np.float32)).to(tdt)
          for k, v in p.items() if k != "dense"}
    for k, v in p.get("dense", {}).items():
        tp["dense_" + k] = torch.tensor(np.asarray(v, np.float32)).to(tdt)
    return p, tp


def _jrouting(p, x, cfg):
    """The reference's selected experts [G, Tg, K] and kept mask [G, Tg,
    E], by its own routing lines (``moe.py:59-78``)."""
    mo = cfg.moe
    B, S, d = x.shape
    E, K, T = mo.num_experts, mo.top_k, B * S
    Tg = min(mo.group_size, T)
    while T % Tg:
        Tg -= 1
    C = min(max(1, math.ceil(Tg * K * mo.capacity_factor / E)), Tg)
    xg = x.reshape(T // Tg, Tg, d)
    logits = jnp.einsum("gtd,de->gte", xg, p["router"]).astype(jnp.float32)
    _, top_e = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), K)
    sel_any = jnp.max(jax.nn.one_hot(top_e, E, dtype=jnp.float32), axis=2)
    pos_in_e = jnp.cumsum(sel_any, axis=1) - sel_any
    return np.asarray(top_e), np.asarray(sel_any * (pos_in_e < C)) > 0


def _kept(r: tmoe.Routing, E: int) -> np.ndarray:
    """The port's kept (token, expert) mask [G, Tg, E]."""
    kept = torch.zeros(r.experts.shape[:2] + (E,), dtype=torch.bool)
    kept.scatter_(-1, r.experts, r.keep)
    return kept.numpy()


def _check(jc, tc, p, tp, x, dtype):
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    jx, tx = jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)
    want, jaux = jmoe.moe_forward(p, jx, jc)
    got, taux = tmoe.moe_forward(tp, tx, tc)
    top_e, keep = _jrouting(p, jx, jc)
    r = tmoe.route(tp["router"], tx, tc)
    np.testing.assert_array_equal(r.experts.numpy(), top_e)
    np.testing.assert_array_equal(_kept(r, tc.moe.num_experts), keep)
    assert got.dtype == tdt and tuple(got.shape) == x.shape
    want = np.asarray(want, np.float32)
    err = np.abs(got.float().numpy() - want).max()
    tol = BF16_SCALE_TOL if dtype == "bf16" else 1e-5
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5, atol=1e-6)
    return keep


@pytest.mark.parametrize("arch,moe,shape", [
    # granite-moe's 40 experts top-8 at a narrow width: C = 4 of 16
    # tokens, some experts over capacity
    ("granite-moe-3b-a800m", dict(num_experts=40, top_k=8), (2, 8)),
    # its reduced config (4 experts top-2), one group of 24 tokens
    ("granite-moe-3b-a800m", {}, (3, 8)),
    # group_size < T: 3 groups of 8; and 10, whose largest divisor of 24
    # at most 10 is 8
    ("granite-moe-3b-a800m", dict(group_size=8), (3, 8)),
    ("granite-moe-3b-a800m", dict(num_experts=40, top_k=8, group_size=10),
     (4, 6)),
    # a decode step: T = B = 4, C = 1, so the row order decides
    ("granite-moe-3b-a800m", dict(num_experts=40, top_k=8), (4, 1)),
    # arctic: 128 experts top-2 beside the dense residual MLP
    ("arctic-480b", {}, (2, 8)),
    ("arctic-480b", dict(num_experts=128, top_k=2), (4, 1)),
])
def test_moe_forward_matches_reference_fp32(arch, moe, shape):
    jc, tc = _cfgs(arch, **moe)
    p, tp = _params(jc)
    x = np.random.default_rng(sum(shape)).standard_normal(
        shape + (jc.d_model,)).astype(np.float32)
    keep = _check(jc, tc, p, tp, x, "fp32")
    C = tmoe.capacity(tmoe.group_shape(x.size // jc.d_model, tc)[1], tc)
    assert keep.sum(axis=1).max() <= C


def test_moe_drops_tokens_past_capacity():
    """The default capacity drops: some picks lose their expert (in row
    order, the later tokens), and a token keeps its other experts."""
    jc, tc = _cfgs("granite-moe-3b-a800m", num_experts=40, top_k=8)
    p, tp = _params(jc)
    x = np.random.default_rng(4).standard_normal((4, 1, jc.d_model)).astype(
        np.float32)
    keep = _check(jc, tc, p, tp, x, "fp32")
    r = tmoe.route(tp["router"], torch.from_numpy(x), tc)
    assert r.capacity == 1
    assert (~r.keep).any() and r.keep.any(dim=-1).all()
    assert keep.sum(axis=1).max() == 1          # one token an expert
    assert r.keep[0, 0].all()                   # the first row keeps all 8


def _exact_inputs(jc, shape, seed, tie_to=None):
    """x in {-1, 0, 1} and router entries in {-2..2}/8: every router
    logit is a multiple of 1/8 below 32 in size, exact in bf16 and in
    any summation order, so both packages see the same logits.  With
    ``tie_to`` = (e, f), expert f's router column copies expert e's:
    their logits tie on every token."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-1, 2, shape + (jc.d_model,)).astype(np.float32)
    router = rng.integers(-2, 3, (jc.d_model, jc.moe.num_experts)) / 8.0
    if tie_to is not None:
        router[:, tie_to[1]] = router[:, tie_to[0]]
    return x, router.astype(np.float32)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("arch,moe,tie_to", [
    ("granite-moe-3b-a800m", dict(num_experts=40, top_k=8), (3, 1)),
    ("granite-moe-3b-a800m", dict(num_experts=40, top_k=8), None),
    ("arctic-480b", dict(num_experts=128, top_k=2), (70, 9)),
])
def test_moe_router_ties_break_to_the_lower_expert(arch, moe, tie_to, dtype):
    """Router logits that tie (exactly, in bf16 and fp32): the selection
    is ``lax.top_k``'s, the lower expert index first, and the kept set
    and outputs follow."""
    jc, tc = _cfgs(arch, **moe)
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    p, tp = _params(jc, dtype=jdt)
    x, router = _exact_inputs(jc, (3, 4), seed=len(dtype), tie_to=tie_to)
    p = dict(p, router=jnp.asarray(router, jdt))
    tp = dict(tp, router=torch.from_numpy(router).to(tp["w_up"].dtype))
    _check(jc, tc, p, tp, x, dtype)
    r = tmoe.route(tp["router"], torch.from_numpy(x).to(tp["router"].dtype),
                   tc)
    probs = r.probs.gather(-1, r.experts)
    ties = (probs[..., 1:] == probs[..., :-1])
    assert ties.any(), "the inputs should tie"
    # among equal probabilities, experts go in increasing order
    assert (r.experts[..., 1:] > r.experts[..., :-1])[ties].all()
    if tie_to is not None:          # the higher twin only beside the lower
        lo, hi = (r.experts == e for e in sorted(tie_to))
        assert not (hi.any(-1) & ~lo.any(-1)).any()


@pytest.mark.parametrize("T,group_size,E,K,cf", [
    (24, 512, 40, 8, 1.25), (24, 8, 40, 8, 1.25), (24, 10, 4, 2, 1.25),
    (4, 512, 40, 8, 1.25), (4, 512, 128, 2, 1.25), (7, 3, 4, 2, 1.25),
    (512, 512, 40, 8, 1.25), (24, 512, 4, 2, 2.0),
])
def test_group_and_capacity_match_the_reference_rule(T, group_size, E, K, cf):
    """Tg: the largest divisor of T at most group_size; C = min(Tg, max(1,
    ceil(Tg * K * cf / E)))."""
    _, tc = _cfgs("granite-moe-3b-a800m", num_experts=E, top_k=K,
                  group_size=group_size, capacity_factor=cf)
    G, Tg = tmoe.group_shape(T, tc)
    want_tg = min(group_size, T)
    while T % want_tg:
        want_tg -= 1
    assert (G, Tg) == (T // want_tg, want_tg)
    assert tmoe.capacity(Tg, tc) == min(want_tg, max(1, math.ceil(
        want_tg * K * cf / E)))
