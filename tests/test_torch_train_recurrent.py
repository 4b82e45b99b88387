"""What remat and the per-chunk checkpoints change in training, on the
CPU: only what backward keeps, never a value.

* rwkv6 and zamba2: ``loss_fn`` with remat (RWKV6's layers in groups,
  each zamba2 group under one checkpoint, the LoRA deltas merged again in
  backward) and without the per-chunk checkpoint of ``rwkv6_time_mix``
  and ``mamba2_forward``: the loss and every gradient equal to the bit
  to the plain run's (2 x 64 tokens, four chunks of 16).
* The bytes autograd keeps outside checkpoints
  (``torch.autograd.graph.saved_tensors_hooks``): fewer with the
  per-chunk checkpoint, fewer again with remat.
* With gradients off (a model not made trainable, or ``no_grad``), the
  forward and ``prefill`` take no checkpoint: the serving path is the
  plain one.
* MoE under remat in bf16: backward's recompute routes every layer as
  the forward did (the same experts, gates and capacity slots), and the
  loss and gradients equal the plain run's to the bit.
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_arch
from repro_torch.data import DataConfig, TokenStream
from repro_torch.models import mamba2, moe, rwkv6
from repro_torch.models import transformer as ttf

RECURRENT = {"rwkv6-3b": rwkv6, "zamba2-2.7b": mamba2}
KW = dict(attn_chunk=16, remat_group=2, loss_chunk=16)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this file's small ops: the suite runs one
    worker a core, and every worker's pool spinning on all cores made
    these files 3x slower together."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(arch, dtype=torch.float32, seq=64):
    cfg = get_arch(arch).reduced()
    model = ttf.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu", dtype=dtype).set_trainable()
    batch = TokenStream(cfg, DataConfig(global_batch=2, seq_len=seq,
                                        seed=3)).next_batch()
    return model, {k: torch.from_numpy(v) for k, v in batch.items()}


def _run(model, batch, remat):
    """(loss, {name: gradient}, bytes autograd saved outside checkpoints)
    of one ``loss_fn`` and its backward."""
    saved = [0]

    def pack(t):
        saved[0] += t.numel() * t.element_size()
        return t

    for p in model.parameters():
        p.grad = None
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss, _ = ttf.loss_fn(model, batch, remat=remat, **KW)
    loss.backward()
    return (loss.detach(), {n: p.grad.clone()
                            for n, p in model.named_parameters()}, saved[0])


def _no_chunk_checkpoint(monkeypatch, module):
    monkeypatch.setattr(module, "checkpoint", lambda fn, *a, **kw: fn(*a))


@pytest.mark.parametrize("arch", list(RECURRENT))
def test_recurrent_remat_and_chunk_checkpoints_keep_the_bits(arch,
                                                             monkeypatch):
    model, batch = _setup(arch)
    calls = []
    shared = ttf.shared_block
    monkeypatch.setattr(ttf, "shared_block",
                        lambda m, g: calls.append(g) or shared(m, g))
    loss, grads, chunked = _run(model, batch, remat=False)
    loss_r, grads_r, grouped = _run(model, batch, remat=True)
    with monkeypatch.context() as m:
        _no_chunk_checkpoint(m, RECURRENT[arch])
        loss_p, grads_p, plain = _run(model, batch, remat=False)
    for other, g in ((loss_r, grads_r), (loss_p, grads_p)):
        assert torch.equal(other, loss)
        for name in grads:
            assert torch.equal(g[name], grads[name]), name
    assert grouped < chunked < plain, (grouped, chunked, plain)
    if arch == "zamba2-2.7b":       # each group's LoRA merged again in backward
        G, _ = ttf.zamba2_groups(model.cfg)
        assert calls == [*range(G)] + [*range(G)] + [*range(G - 1, -1, -1)] \
            + [*range(G)]


@pytest.mark.parametrize("arch", list(RECURRENT))
def test_chunk_checkpoint_keeps_fewer_bytes_for_the_time_and_ssd_mix(
        arch, monkeypatch):
    """The per-chunk checkpoint alone, on one time mix (RWKV6) or one
    Mamba2 block: the same output and state bits, and backward keeps
    none of the chunks' [B, C, C, ...] decay tensors."""
    model, batch = _setup(arch)
    cfg = model.cfg
    lp = model.layer(0)
    x = ttf.embed_tokens(model, batch["tokens"])
    B, d = x.shape[0], cfg.d_model
    if arch == "rwkv6-3b":
        K = cfg.ssm.head_dim
        fn = lambda: rwkv6.rwkv6_time_mix(
            lp, x, cfg, shift_in=torch.zeros(B, d),
            state_in=torch.zeros(B, d // K, K, K))
    else:
        d_in, H, P, N = mamba2.mamba2_dims(cfg)
        fn = lambda: mamba2.mamba2_forward(
            lp, x, cfg, conv_in=torch.zeros(B, cfg.ssm.conv_width - 1,
                                            d_in + 2 * N),
            state_in=torch.zeros(B, H, P, N))
    out = {}
    for on in (True, False):
        saved = [0]

        def pack(t):
            saved[0] += t.numel() * t.element_size()
            return t

        with monkeypatch.context() as m:
            if not on:
                _no_chunk_checkpoint(m, RECURRENT[arch])
            with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
                y, _, state = fn()
        out[on] = (y.detach(), state.detach(), saved[0])
    assert torch.equal(out[True][0], out[False][0])
    assert torch.equal(out[True][1], out[False][1])
    C = cfg.ssm.chunk_size
    assert x.shape[1] // C == 4
    # without it, each chunk keeps at least one [B, C, C, H] fp32 tensor
    H = (d // cfg.ssm.head_dim if arch == "rwkv6-3b"
         else mamba2.mamba2_dims(cfg)[1])
    assert out[False][2] - out[True][2] >= 4 * B * C * C * H * 4


@pytest.mark.parametrize("arch", list(RECURRENT))
def test_gradient_free_paths_take_no_checkpoint(arch, monkeypatch):
    """Serving's weights take no gradient and ``no_grad`` builds no
    graph: ``forward`` and ``prefill`` run the chunks without
    ``torch.utils.checkpoint``, the parent's code path."""
    model, batch = _setup(arch)

    def refuse(*a, **kw):
        raise AssertionError("checkpoint on a gradient-free path")

    for module in (RECURRENT[arch], ttf):
        monkeypatch.setattr(module, "checkpoint", refuse)
    with torch.no_grad():
        ttf.forward(model, batch["tokens"], remat=False)
    model.set_trainable(False)
    ttf.forward(model, batch["tokens"], remat=False)
    ttf.prefill(model, {"tokens": batch["tokens"]})
    with torch.no_grad():
        ttf.forward(model.set_trainable(), batch["tokens"], remat=False)


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "arctic-480b"])
def test_moe_recompute_routes_as_the_forward_did(arch, monkeypatch):
    """bf16 under remat: each layer is routed twice (forward, then
    backward's recompute), with the same experts, gates and capacity
    slots; the loss and gradients equal the plain run's to the bit."""
    model, batch = _setup(arch, dtype=torch.bfloat16, seq=32)
    routes = {}
    real = moe.route

    def record(router, x, cfg):
        r = real(router, x, cfg)
        routes.setdefault(router.data_ptr(), []).append(r)
        return r

    monkeypatch.setattr(moe, "route", record)
    loss_r, grads_r, _ = _run(model, batch, remat=True)
    assert len(routes) == model.cfg.num_layers
    for calls in routes.values():
        assert len(calls) == 2
        a, b = calls
        assert torch.equal(a.experts, b.experts)
        assert torch.equal(a.weights, b.weights)
        assert torch.equal(a.slot, b.slot) and a.capacity == b.capacity
    routes.clear()
    loss, grads, _ = _run(model, batch, remat=False)
    assert all(len(calls) == 1 for calls in routes.values())
    assert torch.equal(loss_r, loss)
    for name in grads:
        assert torch.equal(grads_r[name], grads[name]), name
