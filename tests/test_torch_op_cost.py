"""The port's meta-tensor cost counter (``repro_torch.launch.op_cost``)
against the reference's ``hlo_cost.jaxpr_cost``, on the CPU.

* The reference's own cases (``tests/test_roofline_cost.py``): 7 chained
  matmuls count exactly 7·2·8·128·128 FLOPs and 7·4·(8·128 + 128·128 +
  8·128) bytes; a checkpointed nested loop under backward counts
  between 2x and 5x its forward.  The peak of live storage on a chain
  whose peak is known.
* Every reduced arch's loss-and-gradient step with remat, ``prefill`` and
  ``serve_step`` against the reference's ``jaxpr_cost`` of the same
  entry points on inputs of the same shapes (B 2, S 16, attention and
  loss chunks of 8, remat groups of 2).  The reference's count is
  broken down by primitive (its ``_walk`` rules, summing to
  ``jaxpr_cost`` exactly).  FLOPs and bytes must agree within 1%, save
  the gaps named in ``GAPS`` by the op that causes them, each with its
  stated bound:
    - ``serve`` bytes: the reference slices each layer's whole cache out
      of its scan carry (``dynamic_slice``) and writes it back
      (``dynamic_update_slice``, ``src/repro/models/transformer.py:
      679-731``); the port indexes the layer as a view and writes only
      the new token.  Those two primitives' bytes are taken out of the
      reference's count exactly, and the rest must agree;
    - the others stand in ``GAPS`` below, each measured against its
      cause where the cause can be switched off (checkpoint early stop).
* The meta branches of ``flash_decode``, ``flash_decode_quant`` and
  ``mla_decode``: the kernel's output shape and dtype, no launch, and the
  counted work equal to its formula.
"""

import collections
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from repro.configs import get_arch as jget_arch
from repro.launch import hlo_cost
from repro.models import transformer as jtf
from repro_torch.configs import get_arch as tget_arch
from repro_torch.configs import list_archs
from repro_torch.kernels import flash_decode as tfd
from repro_torch.kernels import mla_decode as tmla
from repro_torch.launch import op_cost
from repro_torch.models import transformer as ttf

B, S = 2, 16
KW = dict(attn_chunk=8, remat_group=2, loss_chunk=8)
ENTRIES = ("train", "prefill", "serve")
TOL = 0.01

# (arch, entry, "flops" | "bytes") -> (bound on |port / reference - 1|,
# the op that causes the gap).  Every other comparison is held to TOL.
_EARLY = ("torch.utils.checkpoint's early stop: the recompute of a remat "
          "group ends at the last tensor its backward saved, so the "
          "group's tail (its last down projection) is not recomputed; "
          "jax.checkpoint recomputes it")
_NESTED = ("the reference checkpoints each attention q-chunk inside the "
           "remat group (src/repro/models/layers.py:237), so backward "
           "computes the scores and P·V a third time; the port's "
           "chunked_attention keeps them through the group's recompute")
_FP32_ATTN = ("layers.chunked_attention contracts fp32 copies of K, V and "
              "P (models/layers.py:123,141); the reference contracts bf16 "
              "K, V and P with fp32 accumulation")
_MOE = ("the reference dispatches and combines MoE tokens by one-hot "
        "einsums [G, Tg, E, C] (dot_general FLOPs and bytes); the port "
        "writes and reads capacity slots by index (models/moe.py)")
_MLA = ("the reference's absorbed MLA decode contracts fp32 copies of the "
        "bf16 latent cache, ckv twice (src/repro/models/mla.py:116-126); "
        "mla_decode's count reads the bf16 cache once")
_RWKV = ("rwkv6_time_mix's chunked WKV form contracts other intermediate "
         "shapes than the reference's (models/rwkv6.py)")
_MAMBA = ("mamba2_forward's chunked SSD contracts other intermediates in "
          "fp32 than the reference's (models/mamba2.py)")
_CONV = ("the reference's Mamba2 step convolves by an einsum "
         "(src/repro/models/mamba2.py:142, a dot_general); the port's by "
         "elementwise products, which count nothing")
_STATE = ("the port writes each layer's new recurrent state into the cache "
          "in place (copy_ into a slice, counted as a scatter); the "
          "reference returns it from its scan, which counts nothing")
_ATTN = ("llama3-8b", "granite-20b", "nemotron-4-15b", "internvl2-1b",
         "musicgen-large", "gemma2-27b", "minicpm3-4b")
GAPS = {
    # attention families: remat and fp32 attention operands
    **{(a, "train", "flops"): (0.05, _EARLY + "; " + _NESTED) for a in _ATTN},
    **{(a, "train", "bytes"): (0.09, _EARLY + "; " + _NESTED + "; "
                               + _FP32_ATTN) for a in _ATTN},
    **{(a, "prefill", "bytes"): (0.06, _FP32_ATTN) for a in _ATTN
       if a != "gemma2-27b"},          # gemma2: within TOL at S = 16
    ("minicpm3-4b", "serve", "bytes"): (0.06, _MLA),
    # MoE: one-hot dispatch einsums
    **{(a, "train", k): (0.25, _MOE) for a in ("granite-moe-3b-a800m",
                                                "arctic-480b")
       for k in ("flops", "bytes")},
    **{(a, "prefill", "flops"): (0.25, _MOE) for a in (
        "granite-moe-3b-a800m", "arctic-480b")},
    ("granite-moe-3b-a800m", "serve", "flops"): (0.02, _MOE),
    # the recurrent families
    ("rwkv6-3b", "train", "flops"): (0.02, _EARLY + "; " + _RWKV),
    ("rwkv6-3b", "train", "bytes"): (0.45, _RWKV),
    ("rwkv6-3b", "prefill", "bytes"): (0.45, _RWKV),
    ("rwkv6-3b", "serve", "bytes"): (0.08, _STATE),
    ("zamba2-2.7b", "train", "flops"): (0.03, _EARLY),
    ("zamba2-2.7b", "train", "bytes"): (0.2, _MAMBA + "; " + _EARLY),
    ("zamba2-2.7b", "prefill", "bytes"): (0.18, _MAMBA),
    ("zamba2-2.7b", "serve", "flops"): (0.02, _CONV),
    ("zamba2-2.7b", "serve", "bytes"): (0.08, _STATE),
}
# with torch's checkpoint early stop off, the train FLOPs gap of these
# archs is the reference's nested q-chunk checkpoint alone (zamba2: none)
EARLY_OFF = {"llama3-8b": (0.02, _NESTED), "granite-20b": (0.02, _NESTED),
             "zamba2-2.7b": (TOL, "")}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- the reference's own cases ------------------------------------------------

def test_op_cost_counts_every_loop_trip():
    w = torch.empty((128, 128), device="meta")
    x = torch.empty((8, 128), device="meta")

    def f(w, x):
        for _ in range(7):
            x = torch.tanh(x @ w)
        return x

    c = op_cost.op_cost(f, w, x)
    assert c["flops"] == 7 * 2 * 8 * 128 * 128
    assert c["bytes"] == 7 * 4 * (8 * 128 + 128 * 128 + 8 * 128)


def test_op_cost_through_backward_and_checkpointed_nested_loop():
    w = torch.empty((64, 64), device="meta", requires_grad=True)
    x = torch.empty((4, 64), device="meta")

    def layer(c):
        for _ in range(3):
            c = torch.tanh(c @ w)
        return c

    def g(w, x):
        for _ in range(5):
            x = checkpoint(layer, x, use_reentrant=False)
        x.sum().backward()

    c = op_cost.op_cost(g, w, x)
    fwd = 15 * 2 * 4 * 64 * 64
    assert 2 * fwd <= c["flops"] <= 5 * fwd


def test_peak_tracks_live_storage():
    """args 64 KiB + 4 KiB; (x @ w) lives while (x @ w) @ w is made, and
    is freed before the third product: the peak is args + two 4 KiB
    products."""
    w = torch.empty((128, 128), device="meta")
    x = torch.empty((8, 128), device="meta")

    def f(w, x):
        y = (x @ w) @ w
        return y @ w

    c = op_cost.op_cost(f, w, x)
    assert c["peak_bytes"] == 4 * (128 * 128 + 8 * 128) + 2 * 4 * 8 * 128


@pytest.mark.parametrize("arch", ["rwkv6-3b", "granite-moe-3b-a800m",
                                  "zamba2-2.7b"])
def test_remembered_meta_outputs_count_the_same(arch, monkeypatch):
    """The mode's remembered outputs (``_run``) give the counts and the
    peak that running every meta kernel gives."""
    once = _port(arch, "train")
    again = _port(arch, "train")                 # every op remembered
    monkeypatch.setattr(op_cost, "_run", lambda f, a, k: f(*a, **k))
    assert once == again == _port(arch, "train")


def test_copy_into_a_slice_counts_as_a_scatter():
    big = torch.empty((4, 16), device="meta")
    row = torch.empty((16,), device="meta")
    c = op_cost.op_cost(lambda b, r: b[2].copy_(r), big, row)
    assert c["bytes"] == 2 * 4 * 16
    assert op_cost.op_cost(lambda b: b.copy_(torch.zeros_like(b)),
                           big)["bytes"] == 0          # a whole tensor: none


# --- the entry points against the reference -----------------------------------

def _walk(jaxpr, mult, acc):
    """The reference's ``hlo_cost._walk`` rules, by primitive."""
    for eqn in jaxpr.eqns:
        prim = eqn.primitive.name
        if prim == "dot_general":
            f, b = hlo_cost._dot_flops_bytes(eqn)
            acc["flops"] += mult * f
            acc["dot_general"] += mult * b
            continue
        if prim in ("gather", "dynamic_slice", "take"):
            out = eqn.outvars[0].aval
            acc[prim] += mult * float(np.prod(out.shape)) * out.dtype.itemsize
        elif prim in ("scatter", "scatter-add", "scatter_add",
                      "dynamic_update_slice"):
            upd = eqn.invars[-1].aval if eqn.invars else eqn.outvars[0].aval
            acc[prim] += mult * 2 * float(np.prod(upd.shape)) \
                * upd.dtype.itemsize
        sub = mult * float(eqn.params.get("length", 1)) if prim == "scan" \
            else mult
        for k, v in eqn.params.items():
            if k == "update_jaxpr":
                continue
            for s in hlo_cost._subjaxprs(v):
                _walk(s, sub, acc)


def _shapes(cfg):
    fe = cfg.frontend
    audio = fe is not None and fe.kind == "encodec_stub"
    vlm = fe is not None and fe.kind == "vit_stub"
    tok = (B, S, fe.num_codebooks) if audio else (B, S)
    img = (B, fe.num_prefix_embeddings, fe.embed_dim) if vlm else None
    return tok, img, (B, fe.num_codebooks) if audio else (B,)


@functools.lru_cache(maxsize=None)
def _reference(arch, entry):
    """(by-primitive breakdown, jaxpr_cost) of the reference's entry."""
    jc = jget_arch(arch).reduced()
    tok, img, tok1 = _shapes(jc)
    params = jax.eval_shape(lambda: jtf.init_params(jc, jax.random.PRNGKey(0)))
    sds = jax.ShapeDtypeStruct
    batch = {"tokens": sds(tok, jnp.int32)}
    if img:
        batch["image_embeds"] = sds(img, jnp.bfloat16)
    if entry == "train":
        batch["labels"] = sds(tok, jnp.int32)
        fn = lambda p, b: jax.grad(lambda p: jtf.loss_fn(
            p, b, jc, remat=True, **KW)[0])(p)
        args = (params, batch)
    elif entry == "prefill":
        fn = lambda p, b: jtf.prefill(p, b, jc, attn_chunk=KW["attn_chunk"])
        args = (params, batch)
    else:
        cache = jax.eval_shape(lambda: jtf.init_cache(jc, B, S))
        inputs = {"token": sds(tok1, jnp.int32), "pos": sds((B,), jnp.int32)}
        fn = lambda p, c, i: jtf.serve_step(p, c, i, jc)
        args = (params, cache, inputs)
    acc = collections.defaultdict(float)
    _walk(jax.make_jaxpr(fn)(*args).jaxpr, 1.0, acc)
    return acc, hlo_cost.jaxpr_cost(fn, *args)


def _port(arch, entry):
    """(op_cost, counter) of the port's entry on meta tensors."""
    tc = tget_arch(arch).reduced()
    tok, img, tok1 = _shapes(tc)
    meta = lambda s, dt: torch.empty(s, dtype=dt, device="meta")
    batch = {"tokens": meta(tok, torch.int32)}
    if img:
        batch["image_embeds"] = meta(img, torch.bfloat16)
    model = op_cost.meta_model(tc, trainable=entry == "train")
    if entry == "train":
        batch["labels"] = meta(tok, torch.int32)
        fn = lambda m, b: ttf.loss_fn(m, b, remat=True, **KW)[0].backward()
        args = (model, batch)
    elif entry == "prefill":
        fn = lambda m, b: ttf.prefill(m, b, attn_chunk=KW["attn_chunk"])
        args = (model, batch)
    else:
        cache = {n: meta(s, dt) for n, (s, dt) in
                 ttf.cache_shapes(tc, B, S).items()}
        inputs = {"token": meta(tok1, torch.int32), "pos": meta((B,), torch.int32)}
        fn = ttf.serve_step
        args = (model, cache, inputs)
    with torch.set_grad_enabled(entry == "train"):
        return op_cost.op_cost(fn, *args)


def _gap(got, want):
    return abs(got / want - 1.0)


@pytest.mark.parametrize("entry", ENTRIES)
@pytest.mark.parametrize("arch", list_archs())
def test_entry_cost_matches_reference(arch, entry):
    acc, total = _reference(arch, entry)
    bytes_ref = sum(v for k, v in acc.items() if k != "flops")
    assert acc["flops"] == total["flops"] and np.isclose(bytes_ref,
                                                         total["bytes"])
    if entry == "serve":        # the reference's scan-carry slice/write-back
        bytes_ref -= acc["dynamic_slice"] + acc["dynamic_update_slice"]
    got = _port(arch, entry)
    for key, want in (("flops", acc["flops"]), ("bytes", bytes_ref)):
        bound, why = GAPS.get((arch, entry, key), (TOL, ""))
        gap = _gap(got[key], want)
        assert gap <= bound, (arch, entry, key, gap, why)
        # a named gap must be one: above TOL, or the table is stale
        if why:
            assert gap > TOL, (arch, entry, key, gap, "gap gone: drop it")


@pytest.mark.parametrize("arch", sorted(EARLY_OFF))
def test_train_flops_gap_without_checkpoint_early_stop(arch):
    """With torch's checkpoint early stop off, each group's recompute
    runs whole, as the reference's does: what stays of the train FLOPs
    gap is the cause named in EARLY_OFF."""
    acc, _ = _reference(arch, "train")
    with set_checkpoint_early_stop(False):
        got = _port(arch, "train")
    bound, why = EARLY_OFF[arch]
    assert _gap(got["flops"], acc["flops"]) <= bound, why


# --- the kernels' meta branches ----------------------------------------------

def _launches():
    return (tfd.flash_decode.launches, tfd.flash_decode_quant.launches,
            tmla.mla_decode.launches)


def test_meta_branches_count_their_formula_and_launch_nothing():
    meta = lambda *s, dt=torch.bfloat16: torch.empty(s, dtype=dt, device="meta")
    Bq, Sk, KVH, G, Dh = 3, 40, 2, 4, 64
    q, k, v = meta(Bq, KVH, G, Dh), meta(Bq, Sk, KVH, Dh), meta(Bq, Sk, KVH, Dh)
    pos = meta(Bq, dt=torch.int32)
    before = _launches()
    c = op_cost.OpCounter()
    with c:
        out = tfd.flash_decode(q, k, v, pos, window=8, softcap=30.0)
    assert out.shape == (Bq, KVH, G, Dh) and out.dtype == torch.float32
    assert out.device.type == "meta"
    assert c.flops == 4 * Bq * KVH * G * Sk * Dh
    assert c.bytes == 2 * q.numel() + 2 * 2 * k.numel() + 4 * q.numel()
    assert (c.flops, c.bytes) == tfd.decode_work(q, k, v)

    k8, v8 = meta(Bq, Sk, KVH, Dh, dt=torch.int8), meta(Bq, Sk, KVH, Dh,
                                                       dt=torch.int8)
    ks, vs = meta(Bq, Sk, KVH), meta(Bq, Sk, KVH)
    c = op_cost.OpCounter()
    with c:
        out = tfd.flash_decode_quant(q, k8, v8, ks, vs, pos)
    assert out.shape == (Bq, KVH, G, Dh) and out.dtype == torch.float32
    assert c.flops == 4 * Bq * KVH * G * Sk * Dh
    assert c.bytes == (2 * q.numel() + 2 * k8.numel() + 2 * 2 * ks.numel()
                       + 4 * q.numel())

    H, R, Dr = 5, 32, 16
    qa, qp = meta(Bq, H, R, dt=torch.float32), meta(Bq, H, Dr, dt=torch.float32)
    ckv, kpe = meta(Bq, Sk, R), meta(Bq, Sk, Dr)
    c = op_cost.OpCounter()
    with c:
        out = tmla.mla_decode(qa, qp, ckv, kpe, pos, 0.1)
    assert out.shape == (Bq, H, R) and out.dtype == torch.float32
    assert c.flops == 2 * Bq * H * Sk * (2 * R + Dr)
    assert c.bytes == (4 * qa.numel() + 4 * qp.numel() + 2 * ckv.numel()
                       + 2 * kpe.numel() + 4 * qa.numel())
    assert _launches() == before
    # outside a counter the branch still returns and launches nothing
    assert tfd.flash_decode(q, k, v, pos).shape == q.shape
    assert _launches() == before


def test_cpu_results_unchanged_by_a_meta_trace():
    """Dispatch on CPU tensors is the plain version's, before and after
    the wrappers run on meta tensors."""
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=g)
    q, k, v = r(2, 2, 3, 32), r(2, 20, 2, 32), r(2, 20, 2, 32)
    pos = torch.tensor([19, 7], dtype=torch.int32)
    first = tfd.flash_decode(q, k, v, pos)
    with op_cost.OpCounter():
        tfd.flash_decode(q.to("meta"), k.to("meta"), v.to("meta"),
                         pos.to("meta"))
    assert torch.equal(tfd.flash_decode(q, k, v, pos), first)
