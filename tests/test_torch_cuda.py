"""The port's hand-written CUDA kernels against their plain versions, on a
card.  Every test is marked ``cuda`` and skips inside its body when
``torch.cuda.is_available()`` is False.  The file imports neither JAX nor
the JAX package, so it runs on a card host that has neither:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: the decode kernel's fp32 output from bf16 K/V is summed in
another order than the plain version's (atol=rtol=2e-3); the retrieval
kernel must give equal ids and scores within rtol=1e-4 on tie-free data.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_arch
from repro_torch.kernels import flash_decode as tfd
from repro_torch.kernels import probe_topk as tpt
from repro_torch.kernels import ref as tref
from repro_torch.models import transformer as ttf


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _paged_inputs(B, KVH, G, Dh, ps, MB, seed):
    """Ragged block tables over a slab bigger than needed: non-contiguous
    slots, partial last blocks and -1 tails."""
    rng = np.random.default_rng(seed)
    NP = B * MB + 4
    q = rng.standard_normal((B, KVH, G, Dh)).astype(np.float32)
    kp = rng.standard_normal((NP, ps, KVH, Dh)).astype(np.float32)
    vp = rng.standard_normal((NP, ps, KVH, Dh)).astype(np.float32)
    bt = rng.permutation(NP)[:B * MB].reshape(B, MB).astype(np.int32)
    lengths = rng.integers(1, MB * ps + 1, B).astype(np.int32)
    for b in range(B):
        bt[b, -(-int(lengths[b]) // ps):] = -1
    return q, kp, vp, bt, lengths


def _retrieval_inputs(B, d, Nc, P, ps, seed):
    """Tie-free gaussian data, a padded page tail, unsearchable slots and
    invalid centroids."""
    rng = np.random.default_rng(seed)
    qs = rng.standard_normal((B, d)).astype(np.float32)
    cents = rng.standard_normal((Nc, d)).astype(np.float32)
    pages = rng.standard_normal((P, ps, d)).astype(np.float32)
    pids = rng.permutation(P * ps).reshape(P, ps).astype(np.int32)
    pids[0, ps // 2:] = -1
    pc = rng.integers(-1, Nc, P).astype(np.int32)
    valid = rng.random(Nc) > 0.1
    return qs, cents, valid, pages, pids, pc


@pytest.mark.cuda
@pytest.mark.parametrize("B,KVH,G,Dh,ps,MB,window,q_dtype,kv_dtype", [
    (4, 8, 4, 128, 16, 8, 0, torch.bfloat16, torch.bfloat16),   # serve shapes
    (3, 2, 1, 32, 2, 5, 3, torch.bfloat16, torch.bfloat16),     # ps 2, window
    (2, 2, 8, 64, 5, 4, 0, torch.float32, torch.float32),
    (2, 1, 3, 128, 7, 3, 9, torch.float32, torch.bfloat16),
])
def test_flash_decode_paged_kernel_matches_plain(B, KVH, G, Dh, ps, MB, window,
                                                 q_dtype, kv_dtype):
    dev = _card()
    q, kp, vp, bt, lens = (torch.from_numpy(a).to(dev) for a in
                           _paged_inputs(B, KVH, G, Dh, ps, MB, 7))
    q, kp, vp = q.to(q_dtype), kp.to(kv_dtype), vp.to(kv_dtype)
    before = tfd.flash_decode_paged.launches
    got = tfd.flash_decode_paged(q, kp, vp, bt, lens, window=window)
    want = tref.flash_decode_paged_ref(q, kp, vp, bt, lens, window)
    torch.cuda.synchronize()
    assert tfd.flash_decode_paged.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (B, KVH, G, Dh)
    torch.testing.assert_close(got, want, atol=2e-3, rtol=2e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("B,d,Nc,P,ps,nprobe,k", [
    (4, 64, 24, 18, 8, 7, 5), (6, 128, 32, 24, 4, 16, 8),
    (2, 60, 20, 9, 8, 20, 3), (9, 64, 40, 30, 16, 10, 4),
    (4, 768, 1024, 512, 128, 64, 3)])
def test_probe_topk_kernel_matches_plain(B, d, Nc, P, ps, nprobe, k):
    dev = _card()
    qs, cents, valid, pages, pids, pc = (
        torch.from_numpy(a).to(dev)
        for a in _retrieval_inputs(B, d, Nc, P, ps, B * 31 + Nc))
    pages = pages.to(torch.bfloat16)
    before = tpt.probe_topk_fused.launches
    gs, gi = tpt.probe_topk_fused(qs, cents, valid, pages, pids, pc,
                                  nprobe=nprobe, k=k)
    ws, wi = tref.probe_and_topk_ref(qs, cents, valid, pages, pids, pc,
                                     nprobe, k)
    torch.cuda.synchronize()
    assert tpt.probe_topk_fused.launches == before + 1
    assert torch.equal(gi, wi)
    torch.testing.assert_close(gs, ws, rtol=1e-4, atol=1e-6)


@pytest.mark.cuda
def test_cuda_wrappers_raise_instead_of_falling_back():
    dev = _card()
    q, kp, vp, bt, lens = (torch.from_numpy(a).to(dev) for a in
                           _paged_inputs(2, 2, 2, 48, 4, 3, 0))
    before = tfd.flash_decode_paged.launches
    with pytest.raises(ValueError, match="Dh"):          # Dh 48 not taken
        tfd.flash_decode_paged(q, kp, vp, bt, lens)
    with pytest.raises(ValueError, match="int32"):
        tfd.flash_decode_paged(q[..., :32].contiguous(), kp[..., :32].contiguous(),
                               vp[..., :32].contiguous(), bt.long(), lens)
    with pytest.raises(ValueError, match="q/kv"):       # bf16 q over fp32 K/V
        tfd.flash_decode_paged(q[..., :32].to(torch.bfloat16),
                               kp[..., :32].contiguous(),
                               vp[..., :32].contiguous(), bt, lens)
    assert tfd.flash_decode_paged.launches == before


@pytest.mark.cuda
def test_serve_step_paged_on_card_matches_cpu():
    """A reduced Llama-3 decode step through the kernel on the card agrees
    with the same step through the plain version on the CPU (fp32)."""
    dev = _card()
    cfg = dataclasses.replace(get_arch("llama3-8b").reduced(), num_kv_heads=2)
    model = ttf.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu", dtype=torch.float32)
    rng = np.random.default_rng(3)
    B, ps, MB = 3, 4, 4
    NP = B * MB + 2
    shape = (cfg.num_layers, NP, ps, cfg.num_kv_heads, cfg.resolved_head_dim)
    k0 = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    v0 = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    bt = torch.from_numpy(rng.permutation(NP)[:B * MB].reshape(B, MB)
                          .astype(np.int32))
    lens = torch.tensor([0, 3, 6], dtype=torch.int32)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, B).astype(np.int32))
    want, wk, _ = ttf.serve_step_paged(model, k0.clone(), v0.clone(), bt, lens,
                                       {"token": tok})
    model_d = ttf.Transformer(cfg, {n: p.detach().to(dev)
                                    for n, p in model.named_parameters()})
    before = tfd.flash_decode_paged.launches
    got, gk, _ = ttf.serve_step_paged(model_d, k0.to(dev), v0.to(dev),
                                      bt.to(dev), lens.to(dev),
                                      {"token": tok.to(dev)})
    torch.cuda.synchronize()
    assert tfd.flash_decode_paged.launches == before + cfg.num_layers
    torch.testing.assert_close(gk.cpu(), wk, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(got.cpu(), want, atol=2e-3, rtol=2e-3)
