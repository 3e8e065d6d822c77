"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips (with the reason) on a host without a GPU —
decided inside the fixture, never at import.  Run on the card with

    python -m pytest tests/test_torch_cuda.py

Tolerances: f32 inputs agree to summation order (1e-4); bf16 outputs to
about two bf16 ulps at |x| ~ 1 (2e-2).
"""

import pytest

torch = pytest.importorskip("torch")

from llm_instance_gateway_tpu_torch.ops import decode_attention as dec  # noqa: E402
from llm_instance_gateway_tpu_torch.ops import flash_attention as fl  # noqa: E402

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels compile for sm_90a)")
    return torch.device("cuda")


def randn(gen, *shape, dtype):
    return torch.randn(*shape, generator=gen, device=gen.device).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,h,k,hd", [
    (16, 32, 8, 128), (100, 8, 2, 64), (257, 8, 1, 256), (1024, 32, 8, 128)])
def test_flash_matches_plain_version(dev, dtype, s, h, k, hd):
    gen = torch.Generator(device=dev).manual_seed(s)
    q = randn(gen, 2, s, h, hd, dtype=dtype)
    kk = randn(gen, 2, s, k, hd, dtype=dtype)
    v = randn(gen, 2, s, k, hd, dtype=dtype)
    before = fl.launches
    got = fl.flash_attention(q, kk, v)
    torch.cuda.synchronize()
    assert fl.launches == before + 1
    want = fl.flash_attention_reference(q, kk, v)
    assert (got.float() - want.float()).abs().max().item() < TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,k,hd", [(32, 8, 128), (8, 8, 64), (8, 1, 256)])
def test_decode_matches_plain_version(dev, dtype, h, k, hd):
    gen = torch.Generator(device=dev).manual_seed(hd)
    b, s_max = 6, 300
    q = randn(gen, b, h, hd, dtype=dtype)
    kc = randn(gen, b, s_max, k, hd, dtype=dtype)
    vc = randn(gen, b, s_max, k, hd, dtype=dtype)
    lengths = torch.tensor([0, 1, 63, 64, 65, 300], dtype=torch.int32,
                           device=dev)
    before = dec.launches
    got = dec.decode_attention(q, kc, vc, lengths)
    torch.cuda.synchronize()
    assert dec.launches == before + 1
    want = dec.decode_attention_reference(q, kc, vc, lengths)
    assert (got.float() - want.float()).abs().max().item() < TOL[dtype]
    assert not got[0].any()


def test_unsupported_shapes_raise_on_the_card(dev):
    q = torch.zeros(1, 16, 4, 96, device=dev)
    with pytest.raises(ValueError, match="head_dim"):
        fl.flash_attention(q, q[:, :, :2].contiguous(), q[:, :, :2].contiguous())
    q = torch.zeros(2, 32, 128, device=dev)
    cache = torch.zeros(2, 64, 2, 128, device=dev)  # 16 q heads per KV head
    with pytest.raises(ValueError, match="query heads per KV head"):
        dec.decode_attention(q, cache, cache,
                             torch.ones(2, dtype=torch.int32, device=dev))
    cache = torch.zeros(2, 64, 8, 128, device=dev)
    with pytest.raises(ValueError, match="dtype"):
        dec.decode_attention(q.half(), cache.half(), cache.half(),
                             torch.ones(2, dtype=torch.int32, device=dev))
