"""The exactness arguments behind two kernels' arithmetic, checked on the
CPU in plain PyTorch: ``csrc/mla_decode.cu`` splits each fp32 query and
probability into three bf16 pieces for the tensor cores, and
``csrc/decode_attn.cuh`` dequantizes an int8 value through a magic float
and one FFMA.  The card tests (``tests/test_torch_cuda.py``) hold the
kernels themselves to their plain versions."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.ref import dequantize_ref

_MASK = np.uint32(0xFFFF0000)


def _split3(x: np.ndarray):
    """The kernel's split3: pieces by truncation, differences in fp32."""
    p1 = (x.view(np.uint32) & _MASK).view(np.float32)
    r1 = (x - p1).astype(np.float32)
    p2 = (r1.view(np.uint32) & _MASK).view(np.float32)
    p3 = (r1 - p2).astype(np.float32)
    return p1, p2, p3


def _bf16_scales() -> torch.Tensor:
    """Every positive bf16 value in [1e-8, 1e4], as bf16."""
    s = torch.arange(0, 0x7F80, dtype=torch.int32).to(torch.int16).view(torch.bfloat16)
    return s[(s.float() >= 1e-8) & (s.float() <= 1e4)]


@pytest.mark.parametrize("scale", [1.0, 1e-3, 1e3, 1e-30, 1e30])
def test_split3_pieces_are_bf16_and_sum_to_the_fp32_value(scale):
    """x = x1 + x2 + x3 exactly, each piece a bf16 value (its low 16 bits
    zero), so a piece times a bf16 value is exact in fp32 and the three
    products sum to x times it; where x3 would be subnormal (|x| below
    about 2^-110) the kernel's bf16 x3 drops less than 2^-133."""
    rng = np.random.default_rng(7)
    x = (rng.standard_normal(100_000) * scale).astype(np.float32)
    x = np.concatenate([x, np.float32([0.0, -0.0, 1.0, -1.0, 3.4e38, 1.2e-38,
                                        np.nextafter(np.float32(1), np.float32(2))])])
    p1, p2, p3 = _split3(x)
    normal = np.abs(x) >= 2.0 ** -100
    for p in (p1, p2, p3):
        assert not (p[normal].view(np.uint32) & np.uint32(0xFFFF)).any()
    whole = p1.astype(np.float64) + p2 + p3
    assert np.array_equal(whole, x.astype(np.float64))
    p3b = (p3.view(np.uint32) & _MASK).view(np.float32)     # as the kernel packs it
    kept = p1.astype(np.float64) + p2 + p3b
    assert np.abs(kept - x.astype(np.float64)).max() < 2.0 ** -133
    k = torch.randn(x.shape[0]).to(torch.bfloat16).float().numpy().astype(np.float64)
    for p in (p1, p2, p3b):
        prod = p.astype(np.float64) * k
        ok = (np.abs(prod) >= 2.0 ** -126) & (np.abs(prod) <= 3.4e38)   # fp32's normals
        assert np.array_equal(prod[ok].astype(np.float32).astype(np.float64), prod[ok])


def test_magic_float_dequantizing_equals_dequantize_ref():
    """Every int8 value in [-127, 127] times every bf16 scale in [1e-8,
    1e4]: the float 2^23 + x + 128 (a byte permute of x ^ 0x80) times s
    plus -(2^23 + 128) s, both terms exact in fp32, is x s exactly in one
    FFMA, and that rounded to bf16 is dequantize_ref's value."""
    s = _bf16_scales()
    x = torch.arange(-127, 128, dtype=torch.int8)
    want = dequantize_ref(x[None, :].expand(len(s), -1), s).float()
    sf = s.float().numpy().astype(np.float64)[:, None]
    big = ((x.numpy().astype(np.int32) + 128).astype(np.uint32)
           | np.uint32(0x4B000000)).view(np.float32).astype(np.float64)[None, :]
    nc = (np.float32(-8388736.0) * s.float().numpy()).astype(np.float64)[:, None]
    assert np.array_equal(nc, -8388736.0 * sf)          # -(2^23 + 128) s exact
    prod = big * sf + nc                                 # the FFMA, exactly
    assert np.array_equal(prod, x.numpy().astype(np.float64)[None, :] * sf)
    got = torch.from_numpy(prod.astype(np.float32)).to(torch.bfloat16).float()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
