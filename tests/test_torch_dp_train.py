"""The port's data-parallel train step (``make_manual_dp_train_step``) at
2 gloo ranks against the reference's at 2 CPU devices, compressed and
not, on the reduced Llama-3 and rwkv6-3b.

A reference child an arch (JAX with 4 host devices,
``torch_dist_reference``) runs each case's 2 steps from the reference's ``init_params`` (fp32,
PRNGKey(0)) on ``TokenStream`` batches (seed 3, a global batch of 4 x 16
tokens, fp32 moments, lr 1e-3); then one spawn of 2 ranks
(``torch_dist_ranks``) runs the port's, the same numpy weights through
``from_jax_params``, each step from the reference's state before it
(weights, moments, step and each rank's error feedback), so fp32 noise
cannot compound.  Tolerances, ``tests/test_torch_train_steps.py``'s:
the loss within rtol 1e-5, the grad norm 1e-4, the learning rate 1e-6,
every parameter within 2e-4 absolute, but for the elements whose fp32
noise decides the step:

* averaged gradients: an element whose gradient is not 0 but within
  the gradients' tolerance (1e-4 of their max-abs) of it, where Adam's
  step is about +-lr whichever way the noise points;
* compressed: an element whose int8 value rounds the other way on some
  rank (its ``g / scale`` within fp32 noise of a half), which moves that
  rank's error feedback by a whole scale and the average by scale / 2;
  under 0.1% of the elements.  Elsewhere the error feedback is within
  the gradients' tolerance, 1e-4 of the leaf's max-abs (127 scales).

Both ranks hold the same parameters to the bit after every step.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch.configs import get_arch as tget_arch  # noqa: E402
from repro_torch.data import DataConfig, TokenStream  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402

import torch_dist_ranks  # noqa: E402
import torch_dist_reference  # noqa: E402

PATHS = {**ttf._JAX_PATHS, **ttf._FAMILY_PATHS}
ARCHS = ("llama3-8b", "rwkv6-3b")
CASES = [(a, c) for a in ARCHS for c in (False, True)]
STEPS = 2
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
KW = dict(attn_chunk=8)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("dp")
    arrays, batch_keys = {}, {}
    for arch in ARCHS:
        params = jtf.init_params(jget_arch(arch).reduced(),
                                 jax.random.PRNGKey(0), dtype=jnp.float32)
        arrays.update({k: np.asarray(v) for k, v in torch_dist_reference._flat(
            params, f"init/{arch}").items()})
        data = TokenStream(tget_arch(arch).reduced(),
                           DataConfig(global_batch=4, seq_len=16, seed=3))
        for s in range(STEPS):
            batch = data.next_batch()
            batch_keys[arch] = sorted(batch)
            arrays.update({f"batch/{arch}/{s}/{k}": v for k, v in batch.items()})
    meta = {"cases": CASES, "steps": STEPS, "opt": OPT, "kw": KW, "world": 2,
            "batch_keys": batch_keys, "reference": str(d / "ref.npz")}
    np.savez(d / "in.npz", meta=np.array(json.dumps(meta)), **arrays)
    ref = torch_dist_reference.run("dp_train", d / "in.npz", d / "ref.npz",
                                   parts=ARCHS)
    return ref, torch_dist_ranks.run("dp_train", 2, d / "in.npz", d)


@pytest.mark.parametrize("step", range(STEPS))
@pytest.mark.parametrize("arch,compress", CASES)
def test_dp_step_matches_reference(runs, arch, compress, step):
    ref, ranks = runs
    at = f"{arch}/{int(compress)}/{step}"
    for k, rtol in (("loss", 1e-5), ("grad_norm", 1e-4), ("lr", 1e-6)):
        for r in ranks:
            np.testing.assert_allclose(r[f"{at}/{k}"], ref[f"{at}/{k}"],
                                       rtol=rtol, atol=1e-7, err_msg=k)
    assert all(bool(r[f"{at}/same_as_rank0"]) for r in ranks)
    flips = total = 0
    for name in ttf.param_shapes(tget_arch(arch).reduced()):
        path = "/".join(PATHS[name])
        want = ref[f"{at}/params/{path}"]
        got = ranks[0][f"{at}/params/{name}"]
        if compress:
            want_e = ref[f"{at}/err/{path}"]                # [W, ...]
            got_e = np.stack([r[f"{at}/err/{name}"] for r in ranks])
            scale = max(2 * np.abs(want_e).max(), 1e-30)    # |e| <= scale / 2
            moved = np.abs(got_e - want_e) > scale / 4
            sure = ~moved.any(axis=0)
            flips += int((~sure).sum())
            np.testing.assert_allclose(got_e[:, sure], want_e[:, sure], rtol=0,
                                       atol=1e-4 * 127 * scale, err_msg=name)
        else:
            g = np.abs(ranks[0][f"{at}/grad/{name}"])
            sure = (g == 0) | (g >= 1e-4 * g.max())
            assert not ranks[0][f"{at}/err/{name}"].any()   # passed through
        total += want.size
        np.testing.assert_allclose(got[sure], want[sure], rtol=0, atol=2e-4,
                                   err_msg=name)
    assert flips <= total // 1000, (flips, total)
