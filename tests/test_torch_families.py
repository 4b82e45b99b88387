"""The port's other attention families against the JAX package's, on
the CPU: granite-moe and arctic (MoE, arctic with its dense residual),
granite-20b (MQA, plain GELU MLP), nemotron (partial rotary,
squared-ReLU MLP), internvl2 (a ViT prefix through ``vit_proj``),
musicgen (four EnCodec codebooks summed in, logits [..., 4, V]), and the
dense-decode families gemma2 (local/global layers over a split cache,
softcaps, tied embeddings), minicpm3 (MLA's latent cache) and the
recurrent rwkv6 (RWKV6's shifts and wkv state) and zamba2 (Mamba2
blocks around a shared attention block with per-group LoRA deltas),
which take every test but the paged one, and a CPU serve each against
the reference's server.

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
# the families that decode over a dense cache only (no paged decode, as
# the reference's supports_paged_decode): gemma2's split cache, MLA's
# latents and the recurrent families' states
DENSE_ONLY = ["gemma2-27b", "minicpm3-4b", "rwkv6-3b", "zamba2-2.7b"]
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


@pytest.mark.parametrize("arch", ARCHS + DENSE_ONLY)
def test_config_is_the_reference_one(arch):
    j, t = jget_arch(arch), tget_arch(arch)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert t.param_count() == j.param_count()
    assert dataclasses.asdict(j.reduced()) == dataclasses.asdict(t.reduced())
    ttf.check_supported(t)


@pytest.mark.parametrize("arch", ARCHS + DENSE_ONLY)
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


@pytest.mark.parametrize("arch", ARCHS + DENSE_ONLY)
def test_forward_and_prefill_match_reference_fp32(arch):
    """Hidden states, the MoE aux loss, prefill's last-token logits and
    its cache ({"k", "v"}, gemma2's split rings and global layers, MLA's
    latents), with internvl2's image prefix and musicgen's codebook
    tokens."""
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
    assert sorted(tcache) == sorted(jcache)
    for name in jcache:
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
@pytest.mark.parametrize("arch", ARCHS + DENSE_ONLY)
def test_serve_step_matches_reference_over_8_steps(arch, kv_dtype,
                                                   monkeypatch):
    """The dense step from a random cache (every tensor of the
    reference's ``init_cache``: gemma2's rings wrap) at ragged positions:
    logits within 2e-3 (fp32 cache) or 3e-2 of their scale (bf16 cache),
    and the written cache likewise.

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
    jdt, tdt = getattr(jnp, kv_dtype), getattr(torch, kv_dtype)
    shapes = jax.eval_shape(lambda: jtf.init_cache(jc, B, S, jdt))
    kv = {name: rng.standard_normal(shapes[name].shape).astype(np.float32)
          for name in sorted(shapes)}
    jcache = {name: jnp.asarray(a, jdt) for name, a in kv.items()}
    tcache = {name: torch.from_numpy(a.copy()).to(tdt)
              for name, a in kv.items()}
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
    # gemma2's bf16 K/V written after 8 steps: the reference rounds the
    # scaled q and the probabilities to bf16 (its ring rounds q * scale in
    # bf16 too), and softcapped scores of up to ~20 turn q's 2^-9 into a
    # few percent of a probability; its layer-3 V drifts 3.1% of the
    # scale by step 2 here, 0.25% (one bf16 step) when the port's plain
    # version rounds as the reference does, so the difference is that
    # rounding alone.  Logits keep the 3e-2 above.
    cache_tol = (5e-2 if arch == "gemma2-27b" and kv_dtype == "bfloat16"
                 else tol)
    for name in jcache:
        _scale_close(tcache[name].float().numpy(), jcache[name], cache_tol,
                     name)


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


@pytest.mark.parametrize("arch", ARCHS + DENSE_ONLY)
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
    for name, src in cache.items():   # gemma2's rings are whole already
        dense[name][tuple(slice(0, n) for n in src.shape)] = src
    for t in range(extra):
        pos = torch.full((B,), P + S + t, dtype=torch.int32)
        lg, dense = ttf.serve_step(model, dense, {"token": _t(toks[:, S + t]),
                                                  "pos": pos})
        np.testing.assert_allclose(lg.numpy(), full[:, S + t].numpy(),
                                   rtol=2e-3, atol=2e-3, err_msg=f"step {t}")


def _gate_variants():
    """Every config the port registers, and variants the gate refuses: a
    sliding window, gemma2's local/global pattern, MLA.  The configs that
    decode over a dense cache only come last, so the other cases keep
    their ids."""
    out = []
    for name in sorted(list_archs(), key=lambda n: n in DENSE_ONLY):
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
    assert tdecode.supports_paged_decode(tc) == (not change
                                                 and arch not in DENSE_ONLY)


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


@functools.lru_cache(maxsize=None)
def _index():
    """A tiny datastore and its IVF index in both packages."""
    import repro.core as jcore
    from repro_torch.core import datastore as tds
    from repro_torch.core import ivf as tivf
    js = jcore.synthetic_datastore(3000, dim=32, seed=3)
    ts = tds.synthetic_datastore(3000, dim=32, seed=3)
    ji = jcore.build_ivf(js, 16, page_size=32, kmeans_iters=4, seed=1,
                         train_sample=2000)
    ti = tivf.build_ivf(ts, 16, page_size=32, kmeans_iters=4, seed=1,
                        train_sample=2000, device="cpu")
    rng = np.random.default_rng(0)
    q = js.embeddings[rng.choice(js.num_vectors, 6)]
    q = q + 0.1 * rng.standard_normal(q.shape).astype(np.float32)
    return ji, ti, q / np.linalg.norm(q, axis=-1, keepdims=True)


@pytest.mark.parametrize("arch", DENSE_ONLY)
def test_dense_family_server_matches_reference(arch):
    """The reduced config served end to end on the CPU by the port's
    ``TeleRAGServer`` and ``DecodeRunner`` against the reference's, over
    the same fp32 weights, on the event clock: both runners take the
    dense path under ``paged_decode=True`` (the reference's
    ``supports_paged_decode``), and the requests get the same doc ids,
    telemetry within 1e-6, the same recorder stream (the kv ledger's
    bytes are ``KVCacheManager.nbytes`` of the split or latent cache,
    to the byte), a clean replay through the reference's checker, and
    the same greedy tokens."""
    import repro.analysis as janalysis
    from repro.core.budget import H100 as JH100
    from repro.serving import api as japi
    from repro.serving.engine import EngineConfig as JConfig
    from repro_torch.serving import api as tapi
    from repro_torch.serving.engine import EngineConfig as TConfig
    ji, ti, q = _index()
    jc, tc, params, model = _world(arch)
    cfg = dict(nprobe=4, top_k=3, buffer_pages=40, lookahead_rank=8, chips=1,
               cache_enabled=True, seed=5, pool_pages=40 + 64)
    runner = dict(max_len=32, max_steps=4, page_size=4, slab_seqs=8)
    jrun = jdecode.DecodeRunner(params, jc, **runner)
    trun = tdecode.DecodeRunner(model, **runner)
    ref = japi.TeleRAGServer(ji, JConfig(kernel_mode="ref", hw=JH100, **cfg), 1,
                             jc, micro_batch=2, include_tail=True,
                             decode_hook=jrun, continuous=True)
    port = tapi.TeleRAGServer(ti, TConfig(**cfg), 1, tc, micro_batch=2,
                              include_tail=True, decode_hook=trun,
                              continuous=True)
    jrun.attach(ref)
    trun.attach(port)
    assert not jrun.paged and not trun.paged
    jresp = ref.serve([japi.RagRequest(q=x, pipeline="irg") for x in q])
    tresp = port.serve([tapi.RagRequest(q=x, pipeline="irg") for x in q])
    assert len(tresp) == len(jresp) == len(q)
    for a, b in zip(jresp, tresp):
        assert [d.tolist() for d in b.doc_ids] == [d.tolist() for d in a.doc_ids]
        for f in ("arrival_t", "admit_t", "complete_t", "latency_s"):
            assert abs(getattr(a, f) - getattr(b, f)) <= 1e-6, f
    jt, tt = (dataclasses.asdict(s.telemetry()) for s in (ref, port))

    def close(a, b, path):
        if isinstance(a, dict):
            assert sorted(a) == sorted(b), path
            for k in a:
                close(a[k], b[k], f"{path}.{k}")
        elif isinstance(a, (list, tuple)):
            assert len(a) == len(b), path
            for i, (x, y) in enumerate(zip(a, b)):
                close(x, y, f"{path}[{i}]")
        elif isinstance(a, float):
            assert a == b or abs(a - b) <= 1e-6, f"{path}: {a} vs {b}"
        else:
            assert a == b, f"{path}: {a!r} vs {b!r}"
    close(jt, tt, "telemetry")
    for a, b in zip(jresp, tresp):
        close(dataclasses.asdict(a)["rounds"], dataclasses.asdict(b)["rounds"],
              f"request {a.request_id} rounds")
    assert port.telemetry().summary() == ref.telemetry().summary()
    assert trun.stats == {k: jrun.stats[k] for k in trun.stats}
    assert trun.stats["dense_waves"] > 0
    assert trun.kv(0).nbytes(2, 32) == jrun._kv[0].nbytes(2, 32)
    ids = {}

    def stream(rec):
        out = []
        for e in rec.events:
            d = dataclasses.asdict(e)
            if d.get("lease_id", -1) != -1:
                d["lease_id"] = ids.setdefault(d["lease_id"], len(ids))
            out.append(d)
        return out
    assert stream(port.recorder) == stream(ref.recorder)
    rep = janalysis.check_recorder(port.recorder)
    assert not rep.violations and rep.checked_events > 0
    assert trun.generated == jrun.generated


@pytest.mark.parametrize("arch", DENSE_ONLY)
def test_launch_serve_runs_dense_family_on_cpu(arch):
    """``python -m repro_torch.launch.serve --arch ARCH --reduced`` on the
    CPU at a tiny size: served with dense decode (the engine asks for
    paged, the arch cannot), tokens decoded, retrieval equal to the
    exact host search up to the bf16 pages."""
    from repro_torch.launch import serve as tserve
    out = tserve.main(["--arch", arch, "--device", "cpu", "--reduced",
                       "--vectors", "3000", "--dim", "32", "--clusters", "16",
                       "--train-sample", "2000", "--page-size", "32",
                       "--nprobe", "4", "--buffer-pages", "64", "--requests",
                       "4", "--batch", "2", "--max-steps", "4", "--quiet"])
    assert out["arch"] == tget_arch(arch).reduced().name
    assert out["decode"] == "dense" and out["requests"] == 4
    assert out["decode_tokens"] > 0 and out["rounds_with_hits"] >= 1
    assert out["retrieval_gap"] < 1e-2
