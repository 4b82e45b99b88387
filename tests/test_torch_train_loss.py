"""The text-only global-causal GQA families' training loss and gradients
in the port against the JAX package's, on the CPU: llama3, granite-moe
and arctic (MoE, arctic with its dense residual, the aux loss inside the
loss), granite-20b (MQA, plain GELU MLP) and nemotron (partial rotary,
squared ReLU).  internvl2 and musicgen are in
``test_torch_train_frontends.py``; gemma2, minicpm3 and the recurrent
families in ``test_torch_train_families.py``.

Each ``.reduced()`` config's weights come from the reference's
``init_params(cfg, PRNGKey(0), dtype=float32)``, carried across by
``from_jax_params``; the batch is the ``TokenStream``'s (seed 3, 2 x 32
tokens), the same arrays in both packages.  Tolerances, as ``tests/test_torch_training.py`` states them:
the loss (and ce, aux, tokens) within rtol 1e-5, every parameter's
gradient within 1e-4 of its max-abs (fp32 sums in another order;
measured below 2e-5 here), with and without remat.
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

ARCHS = ["llama3-8b", "granite-moe-3b-a800m", "arctic-480b", "granite-20b",
         "nemotron-4-15b"]
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
