"""The port's other global-causal GQA families against the JAX package's,
on the CPU: granite-moe and arctic (MoE, arctic with its dense
residual), granite-20b (MQA, plain GELU MLP), nemotron (partial rotary,
squared-ReLU MLP), internvl2 (a ViT prefix through ``vit_proj``) and
musicgen (four EnCodec codebooks summed in, logits [..., 4, V]).

Each ``.reduced()`` config's parameters come from the reference's own
``tf.init_params(cfg, PRNGKey(0), dtype=float32)``, carried across with
``from_jax_params``; tokens and image embeddings are numpy draws.
Tolerances: ``forward`` and ``prefill`` within 2e-4 (fp32 sums in
another order, through four layers and an MoE); the decode steps over 8
tokens within 2e-3 in fp32, and within 3e-2 of the logits' scale with a
bf16 cache (the reference's jnp decode attention rounds the scaled q and
the probabilities to bf16 where the port's kernels keep fp32, the
tolerance ``tests/test_kernels.py:77`` allows between its own bf16
kernel and oracle; an MoE router can flip a near-tied expert under that
rounding, see ``_Routes``); the paged step against the reference's in ``ref``
and ``kernel_interpret`` mode within 2e-3.  The reference's own
decode-after-prefill check (``tests/test_models.py:85-133``, MoE
capacity raised to the group so no token drops) holds within 2e-3.
"""

import contextlib
import dataclasses
import functools
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import get_arch as jget_arch
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro.serving import decode as jdecode
from repro_torch.configs import get_arch as tget_arch
from repro_torch.configs import list_archs
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttf
from repro_torch.obs.clock import EventClock
from repro_torch.serving import decode as tdecode

ARCHS = ["granite-moe-3b-a800m", "arctic-480b", "granite-20b",
         "nemotron-4-15b", "internvl2-1b", "musicgen-large"]
BF16_SCALE_TOL = 3e-2


def _no_drop(cfg):
    """MoE capacity raised to the group (C = Tg): no token drops, so a
    full forward and one-token steps dispatch alike."""
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))


@functools.lru_cache(maxsize=None)
def _world(arch, no_drop=False):
    """(reference cfg, port cfg, reference params, port model) of the
    reduced ``arch`` in fp32, the same numbers in both."""
    jc, tc = jget_arch(arch).reduced(), tget_arch(arch).reduced()
    if no_drop:
        jc, tc = _no_drop(jc), _no_drop(tc)
    params = jtf.init_params(jc, jax.random.PRNGKey(0), dtype=jnp.float32)
    model = ttf.from_jax_params(jax.tree.map(np.asarray, params), tc,
                                device="cpu")
    return jc, tc, params, model


def _tokens(cfg, shape, rng):
    nc = ttf.codebooks(cfg)
    return rng.integers(0, cfg.vocab_size,
                        shape + ((nc,) if nc else ())).astype(np.int32)


def _image(cfg, B, rng):
    fe = cfg.frontend
    if fe is None or fe.kind != "vit_stub":
        return None
    return rng.standard_normal((B, fe.num_prefix_embeddings,
                                fe.embed_dim)).astype(np.float32)


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _scale_close(got, want, tol, what):
    want = np.asarray(want, np.float32)
    err = np.abs(np.asarray(got, np.float32) - want).max()
    assert err <= tol * np.abs(want).max(), \
        f"{what}: max err {err} against scale {np.abs(want).max()}"


@pytest.mark.parametrize("arch", ARCHS)
def test_config_is_the_reference_one(arch):
    j, t = jget_arch(arch), tget_arch(arch)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert t.param_count() == j.param_count()
    assert dataclasses.asdict(j.reduced()) == dataclasses.asdict(t.reduced())
    ttf.check_supported(t)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_shapes_are_the_reference_tree(arch):
    """Every leaf of the reference's ``init_params`` tree has a port
    parameter of its shape, and no port parameter is left over."""
    jc, tc, params, model = _world(arch)
    leaves = {jax.tree_util.keystr(k): v.shape for k, v in
              jax.tree_util.tree_flatten_with_path(params)[0]}
    paths = {**ttf._JAX_PATHS, **ttf._FAMILY_PATHS}
    shapes = ttf.param_shapes(tc)
    assert len(shapes) == len(leaves)
    for name, shape in shapes.items():
        key = "".join(f"['{p}']" for p in paths[name])
        assert leaves[key] == shape, name
        assert tuple(getattr(model, name).shape) == shape


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_prefill_match_reference_fp32(arch):
    """Hidden states, the MoE aux loss, prefill's last-token logits and
    its {"k", "v"} cache, with internvl2's image prefix and musicgen's
    codebook tokens."""
    jc, tc, params, model = _world(arch)
    rng = np.random.default_rng(len(arch))
    B, S = 2, 12
    toks, img = _tokens(jc, (B, S), rng), _image(jc, B, rng)
    jx, jaux, _ = jtf.forward(params, jnp.asarray(toks), jc,
                              image_embeds=_j(img))
    tx, taux, _ = ttf.forward(model, _t(toks), image_embeds=_t(img))
    P = 0 if img is None else img.shape[1]
    assert tuple(tx.shape) == (B, P + S, jc.d_model)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=2e-4, atol=1e-6)
    assert (float(taux) > 0) == (jc.moe is not None)
    inputs = {"tokens": toks} if img is None else {"tokens": toks,
                                                   "image_embeds": img}
    jl, jcache = jtf.prefill(params, {k: jnp.asarray(v)
                                      for k, v in inputs.items()}, jc)
    tl, tcache = ttf.prefill(model, {k: _t(v) for k, v in inputs.items()})
    assert tuple(tl.shape) == jl.shape
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-4,
                               atol=2e-4)
    for name in ("k", "v"):
        assert tuple(tcache[name].shape) == jcache[name].shape
        np.testing.assert_allclose(tcache[name].numpy(),
                                   np.asarray(jcache[name]), rtol=2e-4,
                                   atol=2e-4, err_msg=name)


_JDENSE = jax.jit(jtf.serve_step, static_argnums=(3,))
# the largest gap between two router probabilities that the bf16
# rounding of the reference's decode attention may swap: it moves an MoE
# layer's input by up to ~5e-2 here, and a probability p by about p times
# that
TIE_GAP = 2e-2


class _Routes:
    """Both packages' MoE selections, layer by layer (the reference's run
    eagerly, under ``jax.disable_jit``, so its routing can be read)."""

    def __init__(self, monkeypatch):
        self.j, self.t = [], []
        jfwd, tfwd = jmoe.moe_forward, tmoe.moe_forward

        def jrec(p, x, cfg):
            logits = jnp.einsum("...d,de->...e", x, p["router"])
            probs = jax.nn.softmax(logits.astype(jnp.float32), axis=-1)
            self.j.append(np.asarray(jax.lax.top_k(probs, cfg.moe.top_k)[1])
                          .reshape(-1, cfg.moe.top_k))
            return jfwd(p, x, cfg)

        def trec(p, x, cfg):
            r = tmoe.route(p["router"], x, cfg)
            self.t.append((r.experts.reshape(-1, cfg.moe.top_k).numpy(),
                           r.probs.reshape(-1, r.probs.shape[-1]).numpy()))
            return tfwd(p, x, cfg)

        monkeypatch.setattr(jmoe, "moe_forward", jrec)
        monkeypatch.setattr(tmoe, "moe_forward", trec)

    def flip(self):
        """The first layer whose selections differ, as (the port's
        probabilities of that token's two differing experts), or None;
        the records are cleared."""
        out = None
        for je, (te, tp) in zip(self.j, self.t):
            rows = np.nonzero((np.sort(je, -1) != np.sort(te, -1)).any(-1))[0]
            if len(rows):
                b = rows[0]
                ej = np.setdiff1d(je[b], te[b])[0]
                et = np.setdiff1d(te[b], je[b])[0]
                out = (tp[b, ej], tp[b, et])
                break
        self.j.clear()
        self.t.clear()
        return out


@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_step_matches_reference_over_8_steps(arch, kv_dtype,
                                                   monkeypatch):
    """The dense step from a random cache at ragged positions: logits
    within 2e-3 (fp32 cache) or 3e-2 of their scale (bf16 cache), and the
    written cache likewise.

    With a bf16 cache an MoE router may pick another of two near-tied
    experts than the reference's (their probabilities within TIE_GAP of
    each other, granite-moe's at step 2 here): the steps before it must
    agree, the swap must be a near tie, and the comparison ends there, as
    the two then write other K/V."""
    jc, tc, params, model = _world(arch)
    routes = (_Routes(monkeypatch) if jc.moe is not None
              and kv_dtype == "bfloat16" else None)
    rng = np.random.default_rng(7)
    B, S = 3, 24
    shape = (jc.num_layers, B, S, jc.num_kv_heads, jc.resolved_head_dim)
    kv = rng.standard_normal((2,) + shape).astype(np.float32)
    jdt, tdt = getattr(jnp, kv_dtype), getattr(torch, kv_dtype)
    jcache = {"k": jnp.asarray(kv[0], jdt), "v": jnp.asarray(kv[1], jdt)}
    tcache = {"k": torch.from_numpy(kv[0].copy()).to(tdt),
              "v": torch.from_numpy(kv[1].copy()).to(tdt)}
    pos = np.array([0, 5, 13], np.int32)
    tol = 2e-3 if kv_dtype == "float32" else BF16_SCALE_TOL
    step_fn = _JDENSE if routes is None else jtf.serve_step
    with contextlib.nullcontext() if routes is None else jax.disable_jit():
        for step in range(8):
            tok = _tokens(jc, (B,), rng)
            jl, jcache = step_fn(params, jcache, {"token": jnp.asarray(tok),
                                                  "pos": jnp.asarray(pos)}, jc)
            tl, tcache = ttf.serve_step(model, tcache, {"token": _t(tok),
                                                        "pos": _t(pos)})
            assert tuple(tl.shape) == jl.shape
            flip = routes and routes.flip()
            if flip:
                assert step > 0 and abs(flip[0] - flip[1]) < TIE_GAP, flip
                return
            if kv_dtype == "float32":
                np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                           rtol=tol, atol=tol,
                                           err_msg=f"step {step}")
            else:
                _scale_close(tl.numpy(), jl, tol, f"step {step}")
            pos = pos + 1
    for name in ("k", "v"):
        _scale_close(tcache[name].float().numpy(), jcache[name], tol, name)


_JPAGED = jax.jit(jtf.serve_step_paged, static_argnums=(6,),
                  static_argnames=("kernel_mode",))


@pytest.mark.parametrize("mode", ["ref", "kernel_interpret"])
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_step_paged_matches_reference(arch, mode):
    """The paged step over a shuffled block table with ragged starts, 8
    steps: logits and the written slabs within 2e-3."""
    jc, tc, params, model = _world(arch)
    rng = np.random.default_rng(1)
    B, ps, MB = 3, 4, 4
    L, KVH, Dh = jc.num_layers, jc.num_kv_heads, jc.resolved_head_dim
    NP = B * MB + 2
    slab = rng.standard_normal((2, L, NP, ps, KVH, Dh)).astype(np.float32)
    bt = rng.permutation(NP)[:B * MB].reshape(B, MB).astype(np.int32)
    lens = np.array([0, 3, 6], np.int32)
    jk, jv = jnp.asarray(slab[0]), jnp.asarray(slab[1])
    tk, tv = torch.from_numpy(slab[0].copy()), torch.from_numpy(slab[1].copy())
    for step in range(8):
        tok = _tokens(jc, (B,), rng)
        jl, jk, jv = _JPAGED(params, jk, jv, jnp.asarray(bt), jnp.asarray(lens),
                             {"token": jnp.asarray(tok)}, jc, kernel_mode=mode)
        tl, tk, tv = ttf.serve_step_paged(model, tk, tv, _t(bt), _t(lens),
                                          {"token": _t(tok)})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-3,
                                   atol=2e-3, err_msg=f"step {step}")
        lens = lens + 1
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_after_prefill_matches_forward(arch):
    """The reference's own check, on the port: greedy steps after
    ``prefill`` equal the teacher-forced ``forward`` (prefill's logits
    within 2e-4, each step's within 2e-3); MoE capacity raised to the
    group, where dropping cannot differ between the two."""
    jc, tc, params, model = _world(arch, no_drop=True)
    rng = np.random.default_rng(3)
    B, S, extra = 2, 24, 4
    toks, img = _tokens(tc, (B, S + extra), rng), _image(tc, B, rng)
    P = 0 if img is None else img.shape[1]
    x, _, _ = ttf.forward(model, _t(toks), image_embeds=_t(img))
    full = ttf.unembed(model, x)[:, P:]                  # [B, S+extra, ...]
    inputs = {"tokens": _t(toks[:, :S])}
    if img is not None:
        inputs["image_embeds"] = _t(img)
    logits, cache = ttf.prefill(model, inputs)
    np.testing.assert_allclose(logits.numpy(), full[:, S - 1].numpy(),
                               rtol=2e-4, atol=2e-4)
    dense = ttf.init_cache(tc, B, P + S + extra, torch.float32, device="cpu")
    for name in ("k", "v"):
        dense[name][:, :, :P + S] = cache[name]
    for t in range(extra):
        pos = torch.full((B,), P + S + t, dtype=torch.int32)
        lg, dense = ttf.serve_step(model, dense, {"token": _t(toks[:, S + t]),
                                                  "pos": pos})
        np.testing.assert_allclose(lg.numpy(), full[:, S + t].numpy(),
                                   rtol=2e-3, atol=2e-3, err_msg=f"step {t}")


def _gate_variants():
    """Every config the port registers, and variants the gate refuses: a
    sliding window, gemma2's local/global pattern, MLA."""
    out = []
    for name in list_archs():
        out.append((name, {}))
        out.append((name, {"sliding_window": 8}))
        out.append((name, {"local_global_pattern": True, "sliding_window": 8}))
        out.append((name, {"attn_kind": "mla"}))
    return out


@pytest.mark.parametrize("arch,change", _gate_variants())
def test_supports_paged_decode_is_the_reference_rule(arch, change):
    jc = dataclasses.replace(jget_arch(arch), **change)
    tc = dataclasses.replace(tget_arch(arch), **change)
    assert tdecode.supports_paged_decode(tc) == jdecode.supports_paged_decode(jc)
    assert tdecode.supports_paged_decode(tc) == (not change)


def _fake_server(paged):
    cfg = SimpleNamespace(paged_decode=paged, chunk_kv=False, chunk_kv_docs=0)
    return SimpleNamespace(wall=EventClock(),
                           engines=[SimpleNamespace(cfg=cfg, pool=None)])


@pytest.mark.parametrize("arch", ["llama3-8b", "granite-moe-3b-a800m"])
def test_attach_ands_the_engine_flag_with_the_gate(arch):
    """``attach`` decodes paged only where the engine asks for it and the
    arch can (the reference's ``paged and supports_paged_decode``); an
    arch the gate refuses gets dense buckets under ``paged_decode=True``."""
    model = ttf.init_params(tget_arch(arch).reduced(),
                            torch.Generator().manual_seed(0), device="cpu",
                            dtype=torch.float32)
    for paged, window, want in ((True, None, True), (False, None, False),
                                (True, 8, False)):
        runner = tdecode.DecodeRunner(model)
        if window:                 # the arch as the gate refuses it
            runner.cfg = dataclasses.replace(runner.cfg, sliding_window=window)
        runner.attach(_fake_server(paged))
        assert runner.paged == want
        assert (runner.kv(0).slab is not None) == want


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "arctic-480b",
                                  "internvl2-1b", "musicgen-large"])
def test_init_params_keeps_the_reference_fan_in(arch):
    """Seeded, and each tensor within 2/sqrt(fan_in) of zero and spread
    like it, fan_in the per-layer shape's first dim as the reference's
    ``InitMaker`` takes it: E for the [E, d, F] expert weights, the
    codebooks for musicgen's [4, d, V] unembedding; embeddings 0.02."""
    cfg = tget_arch(arch).reduced()
    a = ttf.init_params(cfg, torch.Generator().manual_seed(0), device="cpu",
                        dtype=torch.float32)
    b = ttf.init_params(cfg, torch.Generator().manual_seed(0), device="cpu",
                        dtype=torch.float32)
    for name, p in a.named_parameters():
        assert torch.equal(p, getattr(b, name)), name
        if name.endswith("norm"):
            assert torch.all(p == 1), name
            continue
        per = p.shape[1:] if name in ttf._LAYER_PARAMS else p.shape
        scale = 0.02 if name == "embed" else 1 / per[0] ** 0.5
        assert p.abs().max() <= 2 * scale + 1e-6, name
        assert 0.8 * scale < p.std() < scale, name     # N(0, 1) cut at 2
