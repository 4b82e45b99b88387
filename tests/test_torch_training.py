"""The port's single-card training against the JAX package's, on the CPU.

Inputs come from numpy seeds; the model is ``get_arch("llama3-8b")
.reduced()`` with the reference's ``init_params`` weights cast to fp32
(carried across by ``transformer.from_jax_params``).  Tolerances, all
fp32 unless named:

* ``cross_entropy_loss``: rtol 1e-6 (the same logsumexp on the same
  values);
* ``loss_fn``: the loss within rtol 1e-5, every parameter's gradient
  within 1e-4 of its max-abs (sums in another order; measured below
  6e-6), with and without remat and with a loss mask;
* ``schedule``: rtol 1e-6 over 0..total; ``global_norm`` rtol 1e-5
  (fp32 sums over pieces, in another order);
* one ``adamw_update``: fp32 moments and parameters within rtol 1e-5
  (atol 1e-7); bf16 moments and parameters within one bf16 ulp;
* three ``make_train_step`` steps: losses within rtol 1e-5, grad norms
  within rtol 1e-4, parameters within 2e-4 absolute (lr 1e-3; measured
  below 4e-5);
* ``accum_steps=4`` against the full batch, as
  ``tests/test_training.py`` holds the reference (loss rel 2e-2,
  parameters rtol 5e-2 atol 5e-3), and against the reference's own
  accumulated step (loss rtol 1e-5);
* ``TokenStream`` batches, checkpoints in either direction and an
  interrupted ``launch/train`` run: exactly equal.
"""

import dataclasses
import json
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro import training as jtr
from repro.configs import get_arch as jget_arch
from repro.data import DataConfig as JDataConfig
from repro.data import TokenStream as JTokenStream
from repro.models import layers as jlayers
from repro.models import transformer as jtf
from repro_torch import training as ttr
from repro_torch.configs import get_arch as tget_arch
from repro_torch.data import DataConfig, TokenStream
from repro_torch.launch import train as ttrain
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttf
from repro_torch.training import optimizer as topt

ARCH = "llama3-8b"


@pytest.fixture(scope="module")
def world():
    jc, tc = jget_arch(ARCH).reduced(), tget_arch(ARCH).reduced()
    params = jax.tree.map(lambda a: a.astype(jnp.float32),
                          jtf.init_params(jc, jax.random.PRNGKey(0)))
    return jc, tc, params, jax.tree.map(np.asarray, params)


def _model(world, dtype=None):
    return ttf.from_jax_params(world[3], world[1], device="cpu",
                               dtype=dtype).set_trainable()


def _at(tree, name):
    for key in ttf._JAX_PATHS[name]:
        tree = tree[key]
    return np.asarray(tree, np.float32)


def _batch(cfg, B=2, S=16, seed=3, mask=False):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if mask:
        out["loss_mask"] = (rng.random((B, S)) < 0.7).astype(np.float32)
    return out


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# The loss and its gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mask", [False, True], ids=["mean", "masked"])
def test_cross_entropy_loss_matches_reference(mask):
    rng = np.random.default_rng(1)
    logits = (3 * rng.standard_normal((2, 5, 97))).astype(np.float32)
    labels = rng.integers(0, 97, (2, 5)).astype(np.int32)
    m = (rng.random((2, 5)) < 0.5).astype(np.float32) if mask else None
    want = jlayers.cross_entropy_loss(
        jnp.asarray(logits), jnp.asarray(labels),
        None if m is None else jnp.asarray(m))
    got = tlayers.cross_entropy_loss(
        torch.from_numpy(logits), torch.from_numpy(labels),
        None if m is None else torch.from_numpy(m))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize("remat,mask", [(False, False), (True, False),
                                        (True, True)],
                         ids=["plain", "remat", "remat-masked"])
def test_loss_and_grads_match_reference(world, remat, mask):
    jc, tc, params, _ = world
    batch = _batch(tc, mask=mask)
    kw = dict(attn_chunk=8, remat=remat, remat_group=2, loss_chunk=4)
    (jloss, jaux), jgrads = jax.value_and_grad(
        lambda p: jtf.loss_fn(p, _jax(batch), jc, **kw), has_aux=True)(params)
    model = _model(world)
    loss, aux = ttf.loss_fn(model, _torch(batch), **kw)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    for k in ("ce", "aux", "tokens"):
        np.testing.assert_allclose(aux[k].item(), float(jaux[k]), rtol=1e-5,
                                   atol=1e-7)
    for name, p in model.named_parameters():
        want = _at(jgrads, name)
        err = np.abs(p.grad.numpy() - want).max() / np.abs(want).max()
        assert err <= 1e-4, (name, err)


def test_remat_keeps_values_and_leaves_serving_gradient_free(world):
    """remat changes what backward keeps, not the values; the stacked
    parameters' gradients land in ``p.grad`` and the per-layer leaves
    keep none; a model not made trainable builds no graph."""
    batch = _torch(_batch(world[1]))
    grads = []
    for remat in (False, True):
        model = _model(world)
        loss, _ = ttf.loss_fn(model, batch, attn_chunk=8, remat=remat,
                              loss_chunk=4)
        loss.backward()
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()})
    for name in grads[0]:
        torch.testing.assert_close(grads[1][name], grads[0][name],
                                   rtol=1e-5, atol=1e-7)
    model = ttf.from_jax_params(world[3], world[1], device="cpu")
    assert not any(p.requires_grad for p in model.parameters())
    x, _, _ = ttf.forward(model, batch["tokens"], remat=True)
    assert not x.requires_grad
    assert all(v._base is not None for v in model.layers()[0].values())


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_stacked_parameters_stay_in_the_autograd_graph(world, remat):
    """``torch.autograd.grad`` over every parameter (the stacked layer
    weights too) gives exactly what ``backward`` leaves in ``p.grad``:
    the layers' ``unbind`` keeps each stacked parameter in the graph."""
    batch = _torch(_batch(world[1]))
    kw = dict(attn_chunk=8, remat=remat, remat_group=2, loss_chunk=4)
    model = _model(world)
    names, params = zip(*model.named_parameters())
    loss, _ = ttf.loss_fn(model, batch, **kw)
    grads = torch.autograd.grad(loss, params)
    loss, _ = ttf.loss_fn(model, batch, **kw)
    loss.backward()
    for name, p, g in zip(names, params, grads):
        assert g.shape == p.shape and torch.equal(g, p.grad), name


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def test_schedule_matches_reference():
    for warm, total in ((10, 100), (1, 7), (0, 10)):
        cfg = dict(lr=1e-3, warmup_steps=warm, total_steps=total,
                   min_lr_frac=0.1)
        jcfg, tcfg = jtr.OptConfig(**cfg), ttr.OptConfig(**cfg)
        steps = np.arange(total + 2, dtype=np.int32)
        want = np.asarray(jax.vmap(lambda s: jtr.schedule(s, jcfg))(
            jnp.asarray(steps)))
        got = np.array([ttr.schedule(torch.tensor(int(s), dtype=torch.int32),
                                     tcfg).item() for s in steps])
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)
    tcfg = ttr.OptConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    assert ttr.schedule(0, tcfg).item() == 0.0
    assert ttr.schedule(10, tcfg).item() == pytest.approx(1e-3)
    assert ttr.schedule(100, tcfg).item() == pytest.approx(1e-4)


def _bf16_ulp(x):
    """One bf16 ulp at each element of ``x`` (fp32 values)."""
    return np.spacing(np.abs(x).astype(np.float32)) * 2.0 ** 16


@pytest.mark.parametrize("piece", [None, 64], ids=["whole", "pieces"])
@pytest.mark.parametrize("gscale", [1e-3, 1.0], ids=["unclipped", "clipped"])
@pytest.mark.parametrize("moment", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(moment, gscale, piece, monkeypatch):
    """One update from a state two steps in: the new parameters, moments,
    step, lr and gradient norm.  ``piece`` shrinks the update's pieces so
    a stacked [L, ...] tensor updates slice by slice."""
    if piece is not None:
        monkeypatch.setattr(topt, "PIECE", piece)
    dt = np.float32 if moment == "float32" else jnp.bfloat16
    rng = np.random.default_rng(7)
    shapes = {"embed": (40, 8), "w_up": (3, 8, 24), "attn_norm": (3, 8)}
    arr = lambda s, scale=1.0: np.asarray(
        jnp.asarray(scale * rng.standard_normal(s), jnp.float32).astype(dt))
    p = {n: arr(s, 0.2) for n, s in shapes.items()}
    g = {n: arr(s, gscale) for n, s in shapes.items()}
    m = {n: arr(s, 0.01 * gscale) for n, s in shapes.items()}
    v = {n: np.abs(arr(s, 1e-4 * gscale ** 2)) for n, s in shapes.items()}
    cfg = dict(lr=1e-2, warmup_steps=1, total_steps=10, weight_decay=0.1,
               moment_dtype=moment)
    jp, jstate, jm = jtr.adamw_update(
        jax.tree.map(jnp.asarray, p), jax.tree.map(jnp.asarray, g),
        {"m": jax.tree.map(jnp.asarray, m), "v": jax.tree.map(jnp.asarray, v),
         "step": jnp.asarray(2, jnp.int32)}, jtr.OptConfig(**cfg))
    t = lambda tree: {n: torch.from_numpy(np.array(a, np.float32)).to(
        torch.float32 if dt is np.float32 else torch.bfloat16)
        for n, a in tree.items()}
    tp, tstate = t(p), {"m": t(m), "v": t(v),
                        "step": torch.tensor(2, dtype=torch.int32)}
    _, tstate, tm = ttr.adamw_update(tp, t(g), tstate, ttr.OptConfig(**cfg))
    assert tstate["step"].item() == 3
    np.testing.assert_allclose(tm["lr"].item(), float(jm["lr"]), rtol=1e-6)
    np.testing.assert_allclose(tm["grad_norm"].item(), float(jm["grad_norm"]),
                               rtol=1e-5)
    for got, want in ((tp, jp), (tstate["m"], jstate["m"]),
                      (tstate["v"], jstate["v"])):
        for n in shapes:
            a = got[n].float().numpy()
            b = np.asarray(want[n], np.float32)
            assert got[n].dtype == (torch.float32 if dt is np.float32
                                    else torch.bfloat16)
            if moment == "float32":
                np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)
            else:
                assert (np.abs(a - b) <= _bf16_ulp(np.maximum(
                    np.abs(a), np.abs(b)))).all(), n


def test_bf16_moments_and_global_norm(world):
    model = _model(world)
    state = ttr.init_opt_state(dict(model.named_parameters()),
                               ttr.OptConfig(moment_dtype="bfloat16"))
    assert all(t.dtype == torch.bfloat16
               for tree in (state["m"], state["v"]) for t in tree.values())
    assert state["step"].dtype == torch.int32 and state["step"].item() == 0
    tensors = [p.detach() for p in model.parameters()]
    want = float(jtr.global_norm([jnp.asarray(t.numpy()) for t in tensors]))
    np.testing.assert_allclose(ttr.global_norm(tensors).item(), want,
                               rtol=1e-5)


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------


def _opt(**kw):
    cfg = dict(lr=1e-3, warmup_steps=1, total_steps=10, **kw)
    return jtr.OptConfig(**cfg), ttr.OptConfig(**cfg)


@pytest.mark.parametrize("moment", ["float32", "bfloat16"])
def test_three_train_steps_match_reference(world, moment):
    jc, tc, params, _ = world
    jo, to = _opt(moment_dtype=moment)
    kw = dict(attn_chunk=8, loss_chunk=8, remat_group=2)
    jstep = jax.jit(jtr.make_train_step(jc, jo, **kw))
    tstep = ttr.make_train_step(tc, to, **kw)
    jp, jstate = params, jtr.init_opt_state(params, jo)
    model = _model(world)
    tstate = ttr.init_opt_state(dict(model.named_parameters()), to)
    data = TokenStream(tc, DataConfig(global_batch=4, seq_len=16, seed=3))
    for _ in range(3):
        batch = data.next_batch()
        jp, jstate, jm = jstep(jp, jstate, _jax(batch))
        model, tstate, tm = tstep(model, tstate, _torch(batch))
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(tm["grad_norm"].item(),
                                   float(jm["grad_norm"]), rtol=1e-4)
        np.testing.assert_allclose(tm["lr"].item(), float(jm["lr"]),
                                   rtol=1e-6)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), _at(jp, name),
                                   atol=2e-4, rtol=0, err_msg=name)


def test_grad_accumulation_matches_full_batch(world):
    jc, tc, params, _ = world
    jo, to = _opt()
    kw = dict(attn_chunk=16, loss_chunk=16)
    batch = TokenStream(tc, DataConfig(global_batch=8, seq_len=16,
                                       seed=3)).next_batch()
    out = []
    for accum in (1, 4):
        model = _model(world)
        state = ttr.init_opt_state(dict(model.named_parameters()), to)
        model, _, m = ttr.make_train_step(tc, to, accum_steps=accum, **kw)(
            model, state, _torch(batch))
        out.append((model, m))
    (m1, s1), (m4, s4) = out
    assert s1["loss"].item() == pytest.approx(s4["loss"].item(), rel=2e-2)
    assert s4["tokens"].item() == s1["tokens"].item() == 8 * 16
    for (n, a), b in zip(m1.named_parameters(), m4.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=5e-2, atol=5e-3, err_msg=n)
    _, _, jm = jax.jit(jtr.make_train_step(jc, jo, accum_steps=4, **kw))(
        params, jtr.init_opt_state(params, jo), _jax(batch))
    np.testing.assert_allclose(s4["loss"].item(), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(s4["ce"].item(), float(jm["ce"]), rtol=1e-5)


# ---------------------------------------------------------------------------
# The token stream
# ---------------------------------------------------------------------------


def test_token_stream_matches_reference():
    jc, tc = jget_arch(ARCH).reduced(), tget_arch(ARCH).reduced()
    for seed in (0, 7):
        ref = JTokenStream(jc, JDataConfig(global_batch=3, seq_len=11,
                                           seed=seed))
        port = TokenStream(tc, DataConfig(global_batch=3, seq_len=11,
                                          seed=seed))
        for _ in range(3):
            a, b = ref.next_batch(), port.next_batch()
            assert sorted(a) == sorted(b) == ["labels", "tokens"]
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
            assert port.cursor() == ref.cursor()
        port2 = TokenStream(tc, DataConfig(global_batch=3, seq_len=11,
                                           seed=seed))
        port2.restore(ref.cursor())
        np.testing.assert_array_equal(port2.next_batch()["tokens"],
                                      ref.next_batch()["tokens"])


def test_exact_resume_reproduces_stream():
    cfg = tget_arch(ARCH).reduced()
    d1 = TokenStream(cfg, DataConfig(global_batch=2, seq_len=8, seed=7))
    for _ in range(3):
        d1.next_batch()
    cur = d1.cursor()
    b_next = d1.next_batch()
    d2 = TokenStream(cfg, DataConfig(global_batch=2, seq_len=8, seed=7))
    d2.restore(cur)
    np.testing.assert_array_equal(d2.next_batch()["tokens"],
                                  b_next["tokens"])
    d3 = TokenStream(cfg, DataConfig(global_batch=2, seq_len=8, seed=8))
    with pytest.raises(ValueError, match="seed"):
        d3.restore(cur)


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------


def _states(world, seed=5):
    """The same training state in both packages: bf16 weights and fp32
    moments, every leaf distinct, the step at 4 and a data cursor."""
    jc, tc, params, _ = world
    rng = np.random.default_rng(seed)
    rand = lambda a, s: jnp.asarray(s * rng.standard_normal(a.shape),
                                    jnp.float32)
    jparams = jax.tree.map(lambda a: rand(a, 0.1).astype(jnp.bfloat16),
                           params)
    jopt = {"m": jax.tree.map(lambda a: rand(a, 1e-2), params),
            "v": jax.tree.map(lambda a: jnp.abs(rand(a, 1e-4)), params),
            "step": jnp.asarray(4, jnp.int32)}
    cursor = {"step": 4, "seed": 0}
    np_tree = jax.tree.map(lambda a: np.asarray(a, np.float32), jparams)
    model = ttf.from_jax_params(np_tree, tc, device="cpu",
                                dtype=torch.bfloat16).set_trainable()
    tree = lambda t: {n: torch.from_numpy(_at(t, n).copy())
                      for n in ttf._JAX_PATHS}
    topt_state = {"m": tree(jopt["m"]), "v": tree(jopt["v"]),
                  "step": torch.tensor(4, dtype=torch.int32)}
    return ({"params": jparams, "opt": jopt, "data": cursor},
            {"params": model, "opt": topt_state, "data": dict(cursor)})


def _assert_port_state_equals(state, jstate):
    model = state["params"]
    assert isinstance(model, ttf.Transformer)
    assert all(p.requires_grad for p in model.parameters())
    for name, p in model.named_parameters():
        assert p.dtype == torch.bfloat16
        np.testing.assert_array_equal(p.detach().float().numpy(),
                                      _at(jstate["params"], name))
    for k in ("m", "v"):
        for name, t in state["opt"][k].items():
            np.testing.assert_array_equal(t.numpy(), _at(jstate["opt"][k],
                                                         name))
    assert state["opt"]["step"].dtype == torch.int32
    assert state["opt"]["step"].item() == int(jstate["opt"]["step"])
    assert state["data"] == jstate["data"]


def test_reference_checkpoint_restores_in_the_port(world, tmp_path):
    jstate, tstate = _states(world)
    jtr.save_checkpoint(str(tmp_path), 4, jstate)
    blank = _states(world, seed=6)[1]
    step, state = ttr.restore_checkpoint(str(tmp_path), blank)
    assert step == 4
    _assert_port_state_equals(state, jstate)


def test_port_checkpoint_restores_in_the_reference(world, tmp_path):
    jstate, tstate = _states(world)
    ttr.save_checkpoint(str(tmp_path), 4, tstate)
    blank = _states(world, seed=6)[0]
    step, state = jtr.restore_checkpoint(str(tmp_path), blank)
    assert step == 4
    assert state["data"] == jstate["data"]
    for a, b in zip(jax.tree.leaves((state["params"], state["opt"])),
                    jax.tree.leaves((jstate["params"], jstate["opt"]))):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))
    # the manifests name the same leaves, in the same order and dtypes
    jtr.save_checkpoint(str(tmp_path / "ref"), 4, jstate)
    read = lambda d: json.load(open(os.path.join(d, "step_00000004",
                                                 "manifest.json")))
    a, b = read(str(tmp_path)), read(str(tmp_path / "ref"))
    for name in ("params", "opt"):
        assert a["trees"][name]["leaves"] == b["trees"][name]["leaves"]
    assert a["trees"]["data"] == b["trees"]["data"]


def test_port_checkpoint_round_trip_and_key_check(world, tmp_path):
    _, tstate = _states(world)
    ttr.save_checkpoint(str(tmp_path), 4, tstate)
    jstate = _states(world)[0]
    step, state = ttr.restore_checkpoint(str(tmp_path), _states(world, 6)[1])
    _assert_port_state_equals(state, jstate)
    # a template whose leaves differ from the checkpoint's is refused
    bad = _states(world, 6)[1]
    del bad["opt"]["m"]["wq"]
    with pytest.raises(ValueError, match="m/layers/attn/wq"):
        ttr.restore_checkpoint(str(tmp_path), bad)


def test_restore_copies_into_the_template_in_place(world, tmp_path):
    """Restore writes into the template's own tensors (no second copy of
    the state) and hands the template back; a leaf whose shape differs
    from the checkpoint's is refused."""
    jstate, tstate = _states(world)
    ttr.save_checkpoint(str(tmp_path), 4, tstate)
    blank = _states(world, 6)[1]
    ptrs = {n: p.data_ptr() for n, p in blank["params"].named_parameters()}
    m_wq = blank["opt"]["m"]["wq"]
    step, state = ttr.restore_checkpoint(str(tmp_path), blank)
    assert state["params"] is blank["params"] and state["opt"] is blank["opt"]
    assert {n: p.data_ptr() for n, p in
            state["params"].named_parameters()} == ptrs
    assert state["opt"]["m"]["wq"] is m_wq
    _assert_port_state_equals(state, jstate)
    bad = _states(world, 6)[1]
    bad["opt"]["m"]["wq"] = bad["opt"]["m"]["wq"][:1]
    with pytest.raises(ValueError, match="m/layers/attn/wq"):
        ttr.restore_checkpoint(str(tmp_path), bad)


def test_checkpoint_crash_tolerance(world, tmp_path):
    model = _model(world)
    d = str(tmp_path)
    ttr.save_checkpoint(d, 5, {"params": model,
                               "cursor": {"step": 5, "seed": 0}})
    ttr.save_checkpoint(d, 9, {"params": model,
                               "cursor": {"step": 9, "seed": 0}})
    os.makedirs(os.path.join(d, "step_00000012.tmp"))   # crash mid-write
    assert ttr.latest_step(d) == 9
    step, state = ttr.restore_checkpoint(
        d, {"params": model, "cursor": {"step": 0, "seed": 0}})
    assert step == 9 and state["cursor"]["step"] == 9
    step5, _ = ttr.restore_checkpoint(
        d, {"params": model, "cursor": {"step": 0, "seed": 0}}, step=5)
    assert step5 == 5
    shutil.rmtree(os.path.join(d, "step_00000009"))     # LATEST dangles
    assert ttr.latest_step(d) is None


def test_checkpoint_gc_keeps_latest(world, tmp_path):
    model = _model(world)
    d = str(tmp_path)
    os.makedirs(os.path.join(d, "step_00000003.tmp"))
    for s in (1, 2, 3, 4, 5):
        ttr.save_checkpoint(d, s, {"params": model}, keep=2)
    dirs = sorted(x for x in os.listdir(d) if x.startswith("step_"))
    assert dirs == ["step_00000004", "step_00000005"]


# ---------------------------------------------------------------------------
# The launcher (launch/train.py)
# ---------------------------------------------------------------------------


def _checkpoint_arrays(d, step):
    path = os.path.join(d, f"step_{step:08d}")
    manifest = json.load(open(os.path.join(path, "manifest.json")))
    return manifest, {f: np.load(os.path.join(path, f))
                      for f in os.listdir(path) if f.endswith(".npy")}


def test_train_main_resumes_exactly(tmp_path):
    """An uninterrupted 4-step run against one that stops after the
    step-2 checkpoint and resumes: the step-4 checkpoints (weights,
    moments, step, data cursor) are equal to the bit, and the logged
    metrics of steps 3-4 too."""
    args = ["--preset", "smoke", "--steps", "4", "--batch", "2", "--seq",
            "8", "--ckpt-every", "2", "--log-every", "1", "--device", "cpu"]
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    hist = ttrain.main(args + ["--ckpt-dir", a])
    assert [h["step"] for h in hist] == [1, 2, 3, 4]
    assert all(np.isfinite(h["loss"]) and h["tokens_per_s"] > 0 for h in hist)
    assert sorted(os.listdir(a)) == ["LATEST", "step_00000002",
                                     "step_00000004"]
    os.makedirs(b)
    shutil.copytree(os.path.join(a, "step_00000002"),
                    os.path.join(b, "step_00000002"))
    with open(os.path.join(b, "LATEST"), "w") as f:
        f.write("step_00000002")
    resumed = ttrain.main(args + ["--ckpt-dir", b,
                                  "--metrics-out", str(tmp_path / "m.json")])
    drop = lambda rows: [{k: v for k, v in r.items()
                          if k not in ("ms", "tokens_per_s")} for r in rows]
    assert drop(resumed) == drop(hist[2:])
    assert json.load(open(tmp_path / "m.json")) == resumed
    (ma, xa), (mb, xb) = _checkpoint_arrays(a, 4), _checkpoint_arrays(b, 4)
    assert ma == mb and ma["trees"]["data"]["value"] == {"step": 4, "seed": 0}
    assert sorted(xa) == sorted(xb)
    for f in xa:
        np.testing.assert_array_equal(xa[f], xb[f], err_msg=f)
    # resuming at the end trains nothing and commits nothing new
    assert ttrain.main(args + ["--ckpt-dir", b]) == []


def test_train_main_repeat_batch_falls_and_resumes_exactly(tmp_path):
    """``--repeat-batch`` trains every step on one batch and leaves the
    data cursor where it was, so the loss falls and a resume from the
    step-2 checkpoint repeats the same batch: steps 3-4 and the step-4
    checkpoints equal to the bit."""
    args = ["--preset", "smoke", "--steps", "4", "--batch", "2", "--seq",
            "8", "--ckpt-every", "2", "--log-every", "1", "--warmup", "1",
            "--lr", "3e-3", "--repeat-batch", "--device", "cpu"]
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    hist = ttrain.main(args + ["--ckpt-dir", a])
    losses = [h["loss"] for h in hist]
    assert losses[-1] < losses[0] and all(h["ms"] > 0 for h in hist)
    os.makedirs(b)
    shutil.copytree(os.path.join(a, "step_00000002"),
                    os.path.join(b, "step_00000002"))
    with open(os.path.join(b, "LATEST"), "w") as f:
        f.write("step_00000002")
    resumed = ttrain.main(args + ["--ckpt-dir", b])
    keep = lambda rows: [{k: r[k] for k in ("step", "loss", "lr",
                                            "grad_norm")} for r in rows]
    assert keep(resumed) == keep(hist[2:])
    (ma, xa), (mb, xb) = _checkpoint_arrays(a, 4), _checkpoint_arrays(b, 4)
    assert ma == mb and ma["trees"]["data"]["value"] == {"step": 0, "seed": 0}
    for f in xa:
        np.testing.assert_array_equal(xa[f], xb[f], err_msg=f)


def test_moment_dtype_fits_the_card(monkeypatch):
    """fp32 moments where bf16 weights and gradients with fp32 moments
    take at most 85% of the card's memory, else bf16: the ``full``
    Llama-3-8B (8.03 B parameters, 96 GB) gets bf16 on an 80 GB card,
    ``100m`` fp32; the CPU fp32."""
    full = ttrain.preset_config(tget_arch(ARCH), "full")
    small = ttrain.preset_config(tget_arch(ARCH), "100m")
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: type("P", (), {"total_memory": 85e9}))
    card = torch.device("cuda", 0)
    assert ttrain.moment_dtype(full, card) == "bfloat16"
    assert ttrain.moment_dtype(small, card) == "float32"
    assert ttrain.moment_dtype(full, torch.device("cpu")) == "float32"


def test_presets_and_default_device(monkeypatch):
    cfg = tget_arch(ARCH)
    small = ttrain.preset_config(cfg, "100m")
    jsmall = __import__("repro.launch.train", fromlist=["x"]).preset_config(
        jget_arch(ARCH), "100m")
    assert dataclasses.asdict(small) == dataclasses.asdict(jsmall)
    assert ttrain.preset_config(cfg, "full") is cfg
    assert ttrain.preset_config(cfg, "smoke") == cfg.reduced()
    with pytest.raises(KeyError):
        ttrain.preset_config(cfg, "huge")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        ttrain.main(["--preset", "smoke", "--steps", "1"])
