"""Every family's checkpoints, batches and launcher against the JAX
package's, on the CPU.

* Checkpoints of all 11 registered archs (reduced): a port checkpoint
  restored by the reference (which matches leaves by their order) and a
  reference checkpoint restored by the port (by key) are exactly equal,
  and both packages' manifests name the same leaves in the same order:
  every family parameter (the MoE router, MLA's projections, RWKV6's
  and Mamba2's, zamba2's shared block and LoRA deltas) at its reference
  path, in the weights and in the AdamW moments keyed by parameter name.
* ``TokenStream`` batches of musicgen (codebook tokens and labels [B, S,
  4]) and internvl2 (fp32 ``image_embeds`` [B, P, e]) equal the
  reference's, and resume from a cursor.
* ``check_trainable``, ``init_training`` and one ``make_train_step``
  take every registered arch; ``launch/train``'s moment check counts
  each arch's own parameters.
* ``launch/train.main --preset smoke`` for zamba2, musicgen and
  internvl2: a run stopped after the step-2 checkpoint and resumed gives
  the uninterrupted run's metrics and step-4 checkpoint, exactly.
"""

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
from repro.models import transformer as jtf
from repro_torch import training as ttr
from repro_torch.configs import get_arch as tget_arch
from repro_torch.configs import list_archs
from repro_torch.data import DataConfig, TokenStream
from repro_torch.launch import train as ttrain
from repro_torch.models import transformer as ttf
from repro_torch.training import checkpoint as tckpt

ARCHS = list_archs()
PATHS = {**ttf._JAX_PATHS, **ttf._FAMILY_PATHS}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this file's small ops: the suite runs one
    worker a core, and every worker's pool spinning on all cores made
    these files 3x slower together."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _at(tree, name):
    for key in PATHS[name]:
        tree = tree[key]
    return np.asarray(tree, np.float32)


def _states(arch, seed):
    """The same training state in both packages: bf16 weights and fp32
    moments, every leaf distinct, the step at 4 and a data cursor."""
    jc, tc = jget_arch(arch).reduced(), tget_arch(arch).reduced()
    params = jtf.init_params(jc, jax.random.PRNGKey(0), dtype=jnp.float32)
    rng = np.random.default_rng(seed)
    rand = lambda a, s: jnp.asarray(s * rng.standard_normal(a.shape),
                                    jnp.float32)
    jparams = jax.tree.map(lambda a: rand(a, 0.1).astype(jnp.bfloat16),
                           params)
    jopt = {"m": jax.tree.map(lambda a: rand(a, 1e-2), params),
            "v": jax.tree.map(lambda a: jnp.abs(rand(a, 1e-4)), params),
            "step": jnp.asarray(4, jnp.int32)}
    cursor = {"step": 4, "seed": 0}
    model = ttf.from_jax_params(
        jax.tree.map(lambda a: np.asarray(a, np.float32), jparams), tc,
        device="cpu", dtype=torch.bfloat16).set_trainable()
    tree = lambda t: {n: torch.tensor(_at(t, n))
                      for n, _ in model.named_parameters()}
    topt = {"m": tree(jopt["m"]), "v": tree(jopt["v"]),
            "step": torch.tensor(4, dtype=torch.int32)}
    return ({"params": jparams, "opt": jopt, "data": cursor},
            {"params": model, "opt": topt, "data": dict(cursor)})


@pytest.mark.parametrize("arch", ARCHS)
def test_port_checkpoint_restores_in_the_reference(arch, tmp_path):
    jstate, tstate = _states(arch, 5)
    ttr.save_checkpoint(str(tmp_path / "port"), 4, tstate)
    step, state = jtr.restore_checkpoint(str(tmp_path / "port"),
                                         _states(arch, 6)[0])
    assert step == 4 and state["data"] == jstate["data"]
    got = jax.tree.leaves_with_path((state["params"], state["opt"]))
    want = jax.tree.leaves((jstate["params"], jstate["opt"]))
    for (path, a), b in zip(got, want):
        assert a.dtype == b.dtype, path
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32),
                                      err_msg=jax.tree_util.keystr(path))
    jtr.save_checkpoint(str(tmp_path / "ref"), 4, jstate)
    read = lambda d: json.load(open(os.path.join(d, "step_00000004",
                                                 "manifest.json")))
    a, b = read(str(tmp_path / "port")), read(str(tmp_path / "ref"))
    for name in ("params", "opt"):
        assert a["trees"][name]["leaves"] == b["trees"][name]["leaves"]


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_checkpoint_restores_in_the_port(arch, tmp_path):
    jstate, _ = _states(arch, 5)
    jtr.save_checkpoint(str(tmp_path), 4, jstate)
    step, state = ttr.restore_checkpoint(str(tmp_path), _states(arch, 6)[1])
    assert step == 4 and state["data"] == jstate["data"]
    for name, p in state["params"].named_parameters():
        assert p.dtype == torch.bfloat16
        np.testing.assert_array_equal(p.detach().float().numpy(),
                                      _at(jstate["params"], name),
                                      err_msg=name)
    for k in ("m", "v"):
        for name, t in state["opt"][k].items():
            np.testing.assert_array_equal(t.numpy(), _at(jstate["opt"][k],
                                                         name), err_msg=name)
    assert state["opt"]["step"].item() == 4


def test_two_leaves_at_one_reference_path_are_refused(tmp_path):
    """No two port parameter names map to one reference path, and a tree
    that puts two leaves at one path (``lora_qa`` beside its path
    spelled out) cannot be written: the reference, reading by order,
    would take them for one."""
    assert len(tckpt._PATHS) == len(set(tckpt._PATHS.values()))
    t = torch.zeros(2)
    with pytest.raises(ValueError, match="lora/qa"):
        ttr.save_checkpoint(str(tmp_path), 1, {"opt": {
            "lora_qa": t, "lora": {"qa": t}}})


@pytest.mark.parametrize("arch", ["musicgen-large", "internvl2-1b"])
def test_token_stream_front_ends_match_reference(arch):
    jc, tc = jget_arch(arch).reduced(), tget_arch(arch).reduced()
    ref = JTokenStream(jc, JDataConfig(global_batch=3, seq_len=11, seed=7))
    port = TokenStream(tc, DataConfig(global_batch=3, seq_len=11, seed=7))
    for _ in range(3):
        a, b = ref.next_batch(), port.next_batch()
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    fe = tc.frontend
    if arch == "musicgen-large":
        assert b["labels"].shape == (3, 11, fe.num_codebooks)
    else:
        assert b["image_embeds"].shape == (3, fe.num_prefix_embeddings,
                                           fe.embed_dim)
        assert b["image_embeds"].dtype == np.float32
    again = TokenStream(tc, DataConfig(global_batch=3, seq_len=11, seed=7))
    again.restore(ref.cursor())
    a, b = ref.next_batch(), again.next_batch()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_every_registered_arch_trains(arch):
    """The gate takes the arch, ``init_training`` builds it and one step
    on a ``TokenStream`` batch gives a finite loss and moves every
    parameter."""
    from repro_torch.training.train_loop import check_trainable
    cfg = tget_arch(arch).reduced()
    check_trainable(cfg)
    opt = ttr.OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    model, state = ttr.init_training(cfg, opt, torch.Generator().manual_seed(0),
                                     device="cpu", dtype=torch.float32)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    batch = TokenStream(cfg, DataConfig(global_batch=2, seq_len=16,
                                        seed=0)).next_batch()
    model, state, m = ttr.make_train_step(cfg, opt, attn_chunk=8,
                                          loss_chunk=8)(
        model, state, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert np.isfinite(m["loss"].item()) and m["grad_norm"].item() > 0
    for n, p in model.named_parameters():
        assert not torch.equal(p.detach(), before[n]), n


def test_moment_dtype_counts_each_arch_at_full_width(monkeypatch):
    """fp32 moments for every arch whose bf16 weights and gradients with
    fp32 moments (12 bytes a parameter) fit 85% of an 80 GB card:
    minicpm3, granite-moe, rwkv6, musicgen, zamba2, internvl2 and gemma2
    cut to 4 layers; bf16 for Llama-3-8B, gemma2, granite-20b, nemotron
    and arctic.  The count is the port's own parameters, zamba2's shared
    block and LoRA deltas and musicgen's codebook tables included."""
    import dataclasses
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: type("P", (), {"total_memory": 80e9}))
    card = torch.device("cuda", 0)
    fits = {"minicpm3-4b", "granite-moe-3b-a800m", "rwkv6-3b",
            "musicgen-large", "zamba2-2.7b", "internvl2-1b"}
    for arch in ARCHS:
        cfg = tget_arch(arch)
        want = "float32" if arch in fits else "bfloat16"
        assert ttrain.moment_dtype(cfg, card) == want, arch
    gemma4 = dataclasses.replace(tget_arch("gemma2-27b"), num_layers=4)
    assert ttrain.moment_dtype(gemma4, card) == "float32"
    assert ttrain.param_count(tget_arch("zamba2-2.7b")) == 2_434_466_720


def _checkpoint_arrays(d, step):
    path = os.path.join(d, f"step_{step:08d}")
    manifest = json.load(open(os.path.join(path, "manifest.json")))
    return manifest, {f: np.load(os.path.join(path, f))
                      for f in os.listdir(path) if f.endswith(".npy")}


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "musicgen-large",
                                  "internvl2-1b"])
def test_train_main_resumes_exactly(arch, tmp_path):
    args = ["--preset", "smoke", "--arch", arch, "--steps", "4", "--batch",
            "2", "--seq", "8", "--ckpt-every", "2", "--log-every", "1",
            "--device", "cpu"]
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    hist = ttrain.main(args + ["--ckpt-dir", a])
    assert [h["step"] for h in hist] == [1, 2, 3, 4]
    assert all(np.isfinite(h["loss"]) for h in hist)
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
    assert ma == mb and ma["trees"]["data"]["value"] == {"step": 4, "seed": 0}
    assert sorted(xa) == sorted(xb)
    for f in xa:
        np.testing.assert_array_equal(xa[f], xb[f], err_msg=f)
