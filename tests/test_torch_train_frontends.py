"""The front-end families' training loss and gradients in the port
against the JAX package's, on the CPU: internvl2 (an image prefix of
``image_embeds`` through ``vit_proj``, its positions cut from the loss)
and musicgen (codebook tokens and labels [B, S, 4], the NLL's mean over
the codebooks before the mask).

Weights, batch and tolerances as ``test_torch_train_loss.py`` states
them: the reference's ``init_params`` weights in fp32, the
``TokenStream``'s batch (seed 3, 2 x 32 tokens, 8 prefix embeddings),
the loss within rtol 1e-5 and every gradient within 1e-4 of its max-abs,
with and without remat.
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

ARCHS = ["internvl2-1b", "musicgen-large"]
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


def _batch(tc, mask=False):
    batch = TokenStream(tc, DataConfig(global_batch=2, seq_len=32,
                                       seed=3)).next_batch()
    if mask:
        rng = np.random.default_rng(4)
        batch["loss_mask"] = (rng.random((2, 32)) < 0.7).astype(np.float32)
    return batch


def check_loss_and_grads(arch, remat, mask=False):
    """The port's ``loss_fn`` and its gradients against the reference's
    ``loss_fn`` and ``jax.grad`` for the reduced ``arch``; every
    parameter takes a non-zero gradient."""
    jc, tc = jget_arch(arch).reduced(), tget_arch(arch).reduced()
    params = jtf.init_params(jc, jax.random.PRNGKey(0), dtype=jnp.float32)
    batch = _batch(tc, mask)
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
    return batch, aux


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch, remat):
    check_loss_and_grads(arch, remat)


@pytest.mark.parametrize("arch", ["internvl2-1b", "musicgen-large"])
def test_front_end_losses_under_a_mask_match_reference(arch):
    """A loss mask [B, S] over the text positions (internvl2's prefix cut
    first) and over every codebook of a position (musicgen)."""
    batch, aux = check_loss_and_grads(arch, True, mask=True)
    assert aux["tokens"].item() == batch["loss_mask"].sum()


def test_image_prefix_is_cut_from_the_loss():
    """internvl2's loss covers its S text positions only: the same as
    the NLL of the logits at positions P..P+S-1 of ``forward``, and
    ``vit_proj`` takes a gradient through the prefix."""
    tc = tget_arch("internvl2-1b").reduced()
    model = ttf.init_params(tc, torch.Generator().manual_seed(0),
                            device="cpu", dtype=torch.float32).set_trainable()
    batch = {k: torch.from_numpy(v) for k, v in _batch(tc).items()}
    loss, aux = ttf.loss_fn(model, batch, **dict(KW, remat=False))
    P = batch["image_embeds"].shape[1]
    x, _, _ = ttf.forward(model, batch["tokens"],
                          image_embeds=batch["image_embeds"])
    assert x.shape[1] == P + batch["tokens"].shape[1]
    logits = ttf.unembed(model, x[:, P:]).float()
    want = torch.nn.functional.cross_entropy(
        logits.flatten(0, 1), batch["labels"].long().flatten())
    torch.testing.assert_close(loss, want, rtol=1e-5, atol=0)
    assert aux["tokens"].item() == batch["labels"].numel()
    loss.backward()
    assert model.vit_proj.grad.abs().max() > 0


def test_codebook_nll_is_averaged_over_codebooks():
    """musicgen's loss is the token mean of each position's mean NLL
    over its 4 codebooks, labels [B, S, 4]."""
    tc = tget_arch("musicgen-large").reduced()
    model = ttf.init_params(tc, torch.Generator().manual_seed(0),
                            device="cpu", dtype=torch.float32)
    batch = {k: torch.from_numpy(v) for k, v in _batch(tc).items()}
    assert batch["labels"].shape == (2, 32, 4)
    loss, aux = ttf.loss_fn(model, batch, **dict(KW, remat=False))
    x, _, _ = ttf.forward(model, batch["tokens"])
    logits = ttf.unembed(model, x).float()                # [B, S, 4, V]
    want = torch.nn.functional.cross_entropy(
        logits.flatten(0, 2), batch["labels"].long().flatten())
    torch.testing.assert_close(loss, want, rtol=1e-5, atol=0)
    assert aux["tokens"].item() == 2 * 32
