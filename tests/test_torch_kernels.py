"""The PyTorch port's kernels against the JAX package's.

On the CPU the port's wrappers run their plain versions; these are held
against the reference's Pallas kernels (interpret mode) and jnp oracles
on the same numpy inputs, at rtol=atol=1e-5 in fp32 (the two frameworks
sum in other orders).  ``test_torch_cuda.py`` holds the hand-written CUDA
kernels against these plain versions on a card.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.kernels import ops as jops
from repro_torch.kernels import _build
from repro_torch.kernels import flash_decode as tfd
from repro_torch.kernels import ops as tops
from repro_torch.kernels import probe_topk as tpt
from repro_torch.kernels import ref as tref


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


@pytest.mark.parametrize("B,KVH,G,Dh,ps,MB,window", [
    (3, 2, 4, 32, 16, 5, 0),
    (3, 2, 4, 32, 16, 5, 20),
    (1, 1, 8, 64, 8, 3, 0),      # MQA
    (2, 4, 1, 64, 32, 2, 10),
    (3, 2, 1, 32, 2, 5, 3),      # page size 2, sliding window
])
@pytest.mark.parametrize("mode", ["ref", "kernel_interpret"])
def test_flash_decode_paged_plain_matches_jax(B, KVH, G, Dh, ps, MB, window,
                                               mode):
    q, kp, vp, bt, lens = _paged_inputs(B, KVH, G, Dh, ps, MB,
                                        B * 100 + ps + window)
    want = jops.flash_decode_paged(jnp.asarray(q), jnp.asarray(kp),
                                   jnp.asarray(vp), jnp.asarray(bt),
                                   jnp.asarray(lens), window=window, mode=mode)
    got = tops.flash_decode_paged(torch.from_numpy(q), torch.from_numpy(kp),
                                  torch.from_numpy(vp), torch.from_numpy(bt),
                                  torch.from_numpy(lens), window=window)
    assert got.dtype == torch.float32 and got.shape == (B, KVH, G, Dh)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def _retrieval_inputs(B, d, Nc, P, ps, seed):
    rng = np.random.default_rng(seed)
    qs = rng.standard_normal((B, d)).astype(np.float32)
    cents = rng.standard_normal((Nc, d)).astype(np.float32)
    pages = rng.standard_normal((P, ps, d)).astype(np.float32)
    pids = rng.permutation(P * ps).reshape(P, ps).astype(np.int32)
    pids[0, ps // 2:] = -1                               # padded page tail
    pc = rng.integers(-1, Nc, P).astype(np.int32)        # -1 = unsearchable
    valid = rng.random(Nc) > 0.1
    return qs, cents, valid, pages, pids, pc


@pytest.mark.parametrize("B,d,Nc,P,ps,nprobe,k", [
    (4, 64, 24, 18, 8, 7, 5),
    (1, 32, 16, 6, 16, 3, 4),
    (6, 128, 32, 24, 4, 16, 8),
    (2, 60, 20, 9, 8, 40, 3),    # nprobe beyond Nc: every valid cluster
])
@pytest.mark.parametrize("mode", ["ref", "kernel_interpret"])
def test_probe_and_topk_plain_matches_jax(B, d, Nc, P, ps, nprobe, k, mode):
    """Tie-free gaussian inputs: equal ids, scores within 1e-5."""
    qs, cents, valid, pages, pids, pc = _retrieval_inputs(B, d, Nc, P, ps,
                                                          B * 31 + Nc)
    ws, wi = jops.probe_and_topk(
        jnp.asarray(qs), jnp.asarray(cents), jnp.asarray(pages),
        jnp.asarray(pids), jnp.asarray(pc), nprobe=nprobe, k=k,
        valid=jnp.asarray(valid), cent_tile=8, page_tile=2, mode=mode)
    gs, gi = tops.probe_and_topk(
        torch.from_numpy(qs), torch.from_numpy(cents), torch.from_numpy(pages),
        torch.from_numpy(pids), torch.from_numpy(pc), nprobe=nprobe, k=k,
        valid=torch.from_numpy(valid))
    assert gi.dtype == torch.int32
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("B,S,KVH,G,Dh,window", [
    (2, 24, 2, 4, 32, 0), (3, 16, 1, 2, 64, 5)])
def test_dense_flash_decode_ref_matches_jax(B, S, KVH, G, Dh, window):
    from repro.kernels import ref as jref
    rng = np.random.default_rng(S + window)
    q = rng.standard_normal((B, KVH, G, Dh)).astype(np.float32)
    k = rng.standard_normal((B, S, KVH, Dh)).astype(np.float32)
    v = rng.standard_normal((B, S, KVH, Dh)).astype(np.float32)
    pos = rng.integers(0, S, B).astype(np.int32)
    want = jref.flash_decode_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 jnp.asarray(pos), window)
    got = tref.flash_decode_ref(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), torch.from_numpy(pos), window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_cpu_tensors_run_the_plain_version_without_a_launch():
    q, kp, vp, bt, lens = _paged_inputs(2, 2, 2, 32, 4, 3, 0)
    before = (tfd.flash_decode_paged.launches, tpt.probe_topk_fused.launches)
    tops.flash_decode_paged(*map(torch.from_numpy, (q, kp, vp, bt, lens)))
    qs, cents, valid, pages, pids, pc = _retrieval_inputs(2, 16, 8, 4, 4, 0)
    tops.probe_and_topk(*map(torch.from_numpy, (qs, cents, pages, pids, pc)),
                        nprobe=3, k=2, valid=torch.from_numpy(valid))
    assert (tfd.flash_decode_paged.launches,
            tpt.probe_topk_fused.launches) == before


def test_other_devices_raise_instead_of_falling_back():
    """Dispatch goes by device alone: a tensor on neither the CPU nor a
    card is refused, never quietly computed by the plain version."""
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        tops.flash_decode_paged(
            torch.empty((1, 1, 1, 32), **meta), torch.empty((2, 4, 1, 32), **meta),
            torch.empty((2, 4, 1, 32), **meta),
            torch.empty((1, 2), dtype=torch.int32, **meta),
            torch.empty((1,), dtype=torch.int32, **meta))
    with pytest.raises(ValueError, match="cpu or cuda"):
        tpt.probe_topk_fused(
            torch.empty((1, 8), **meta), torch.empty((4, 8), **meta),
            torch.empty((4,), dtype=torch.bool, **meta),
            torch.empty((2, 4, 8), **meta),
            torch.empty((2, 4), dtype=torch.int32, **meta),
            torch.empty((2,), dtype=torch.int32, **meta), nprobe=1, k=1)


def test_wrappers_check_shapes():
    with pytest.raises(ValueError):
        tops.flash_decode_paged(torch.zeros(1, 2, 1, 32), torch.zeros(3, 4, 1, 32),
                                torch.zeros(3, 4, 1, 32),
                                torch.zeros(1, 2, dtype=torch.int32),
                                torch.ones(1, dtype=torch.int32))
    with pytest.raises(ValueError):
        tops.probe_and_topk(torch.zeros(1, 8), torch.zeros(4, 6),
                            torch.zeros(2, 4, 8),
                            torch.zeros(2, 4, dtype=torch.int32),
                            torch.zeros(2, dtype=torch.int32), nprobe=1, k=1)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(_build.KernelBuildError):
        _build.nvcc_path()


def test_build_command_targets_sm90a_from_repo_sources():
    lib = _build.library_path("flash_decode_paged")
    assert lib.parent == _build.BUILD_DIR
    assert "arch=compute_90a,code=sm_90a" in _build.ARCH_FLAGS
    with pytest.raises(_build.KernelBuildError):
        _build.library_path("no_such_kernel")

