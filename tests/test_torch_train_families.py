"""gemma2's, minicpm3's and the recurrent families' training loss and
gradients in the port against the JAX package's, on the CPU: gemma2
(local/global layers, attention and final softcaps, the tied embedding
taking its gradient from both ends), minicpm3 (MLA), rwkv6 (the chunked
WKV recurrence, in groups of layers under remat) and zamba2 (Mamba2
blocks around the shared block, its LoRA deltas merged in each group).
At 32 tokens the recurrences run two chunks of 16.

Weights, batch and tolerances as ``test_torch_train_loss.py`` states
them: the reference's ``init_params`` weights in fp32, the
``TokenStream``'s batch (seed 3, 2 x 32 tokens), the loss within rtol
1e-5 and every gradient within 1e-4 of its max-abs, with and without
remat.  rwkv6's ``mu`` comes closest (9.2e-5): against a float64 run of
the port, the reference's fp32 gradient is off by 9.8e-5 of the
max-abs and the port's by 2.7e-5 (the decay's exp amplifies fp32
rounding).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import get_arch as jget_arch
from repro.models import transformer as jtf
from repro_torch.configs import get_arch as tget_arch
from repro_torch.data import DataConfig, TokenStream
from repro_torch.models import transformer as ttf

ARCHS = ["gemma2-27b", "minicpm3-4b", "rwkv6-3b", "zamba2-2.7b"]
PATHS = {**ttf._JAX_PATHS, **ttf._FAMILY_PATHS}
KW = dict(attn_chunk=8, remat_group=2, loss_chunk=8)


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


def check_loss_and_grads(arch, remat):
    """The port's ``loss_fn`` and its gradients against the reference's
    ``loss_fn`` and ``jax.grad`` for the reduced ``arch``; every
    parameter takes a non-zero gradient."""
    jc, tc = jget_arch(arch).reduced(), tget_arch(arch).reduced()
    params = jtf.init_params(jc, jax.random.PRNGKey(0), dtype=jnp.float32)
    batch = TokenStream(tc, DataConfig(global_batch=2, seq_len=32,
                                       seed=3)).next_batch()
    kw = dict(KW, remat=remat)
    (jloss, jaux), jgrads = jax.value_and_grad(
        lambda p: jtf.loss_fn(p, {k: jnp.asarray(v) for k, v in batch.items()},
                              jc, **kw), has_aux=True)(params)
    model = ttf.from_jax_params(jax.tree.map(np.asarray, params), tc,
                                device="cpu").set_trainable()
    loss, aux = ttf.loss_fn(model, {k: torch.from_numpy(v)
                                    for k, v in batch.items()}, **kw)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    for k in ("ce", "aux", "tokens"):
        np.testing.assert_allclose(aux[k].item(), float(jaux[k]), rtol=1e-5,
                                   atol=1e-7)
    for name, p in model.named_parameters():
        want = _at(jgrads, name)
        assert np.abs(want).max() > 0 and p.grad.abs().max() > 0, name
        err = np.abs(p.grad.numpy() - want).max() / np.abs(want).max()
        assert err <= 1e-4, (name, err)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch, remat):
    check_loss_and_grads(arch, remat)
