"""Three ``make_train_step`` steps of one arch of each family kind in
the port against the reference's jitted step, on the CPU: gemma2
(local/global, softcaps, tied embeddings), minicpm3 (MLA), granite-moe
(MoE, its aux loss in the loss), musicgen (codebooks), internvl2 (an
image prefix), rwkv6 and zamba2 (the recurrences, remat in groups); and
internvl2's and musicgen's ``accum_steps=2`` step, whose microbatches
slice the image embeddings and the codebook labels along the batch.

Weights from the reference's ``init_params`` in fp32, batches from the
``TokenStream`` (seed 3, 4 x 16 tokens, fp32 moments, lr 1e-3).
Each of the three steps starts from the reference's weights and AdamW
moments, so fp32 noise cannot compound from step to step.  Tolerances,
as ``tests/test_torch_training.py`` states them: losses within rtol
1e-5, grad norms within rtol 1e-4, the learning rate within rtol 1e-6,
every parameter after the step within 2e-4 absolute, but for the
elements whose gradient is not 0 but lies within the gradients' own
tolerance (1e-4 of their max-abs) of it: there Adam's step is about +-lr whichever
way the noise points (three steps of rwkv6 and zamba2 taken in a row
move such elements 1.1e-3-2.4e-3 apart, a float64 run siding with
either package).  Such elements are 0.2-1.5% of those the three steps
update, but 16% for musicgen, whose reduced model starts at a loss of
30 and so gives most unembedding columns a gradient below 1e-4 of the
gold tokens'; the test holds that they stay under 20%.  The accumulated
step's loss and ce within rtol 1e-5.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro import training as jtr
from repro.configs import get_arch as jget_arch
from repro.models import transformer as jtf
from repro_torch import training as ttr
from repro_torch.configs import get_arch as tget_arch
from repro_torch.data import DataConfig, TokenStream
from repro_torch.models import transformer as ttf

PATHS = {**ttf._JAX_PATHS, **ttf._FAMILY_PATHS}
KW = dict(attn_chunk=8, loss_chunk=8, remat_group=2)


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


def _world(arch):
    jc, tc = jget_arch(arch).reduced(), tget_arch(arch).reduced()
    params = jtf.init_params(jc, jax.random.PRNGKey(0), dtype=jnp.float32)
    model = ttf.from_jax_params(jax.tree.map(np.asarray, params), tc,
                                device="cpu").set_trainable()
    cfg = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    return jc, tc, params, model, jtr.OptConfig(**cfg), ttr.OptConfig(**cfg)


def _both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


@pytest.mark.parametrize("arch", ["gemma2-27b", "minicpm3-4b",
                                  "granite-moe-3b-a800m", "musicgen-large",
                                  "internvl2-1b", "rwkv6-3b", "zamba2-2.7b"])
def test_three_train_steps_match_reference(arch):
    """Each step from the reference's weights and moments before it:
    the same loss, aux loss, grad norm and learning rate, and the same
    weights after it, but where fp32 noise decides the sign of an Adam
    step (an element whose gradient is not 0 but within the gradients'
    tolerance, 1e-4 of their max-abs, of it moves by about +-lr either
    way)."""
    jc, tc, jp, model, jo, to = _world(arch)
    jstep = jax.jit(jtr.make_train_step(jc, jo, **KW))
    tstep = ttr.make_train_step(tc, to, **KW)
    jstate = jtr.init_opt_state(jp, jo)
    params = dict(model.named_parameters())
    tstate = ttr.init_opt_state(params, to)
    data = TokenStream(tc, DataConfig(global_batch=4, seq_len=16, seed=3))
    noisy = 0
    for _ in range(3):
        with torch.no_grad():
            for name, p in params.items():
                p.copy_(torch.tensor(_at(jp, name)))
                for k in ("m", "v"):
                    tstate[k][name].copy_(torch.tensor(_at(jstate[k], name)))
            tstate["step"].fill_(int(jstate["step"]))
        jb, tb = _both(data.next_batch())
        jp, jstate, jm = jstep(jp, jstate, jb)
        model, tstate, tm = tstep(model, tstate, tb)
        for k, rtol in (("loss", 1e-5), ("aux", 1e-5), ("grad_norm", 1e-4),
                        ("lr", 1e-6)):
            np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=rtol,
                                       atol=1e-7, err_msg=k)
        for name, p in params.items():
            g = p.grad.abs()
            sure = ((g == 0) | (g >= 1e-4 * g.max())).numpy()
            noisy += int((~sure).sum())
            np.testing.assert_allclose(p.detach().numpy()[sure],
                                       _at(jp, name)[sure], atol=2e-4,
                                       rtol=0, err_msg=name)
    n = sum(p.numel() for p in params.values())
    assert noisy < 3 * n // 5, (noisy, 3 * n)        # under 20% of 3 n


@pytest.mark.parametrize("arch", ["internvl2-1b", "musicgen-large"])
def test_accumulated_front_end_step_matches_reference(arch):
    jc, tc, jp, model, jo, to = _world(arch)
    batch = TokenStream(tc, DataConfig(global_batch=4, seq_len=16,
                                       seed=3)).next_batch()
    jb, tb = _both(batch)
    _, _, jm = jax.jit(jtr.make_train_step(jc, jo, accum_steps=2, **KW))(
        jp, jtr.init_opt_state(jp, jo), jb)
    _, _, tm = ttr.make_train_step(tc, to, accum_steps=2, **KW)(
        model, ttr.init_opt_state(dict(model.named_parameters()), to), tb)
    for k in ("loss", "ce"):
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    assert tm["tokens"].item() == float(jm["tokens"]) == 4 * 16
