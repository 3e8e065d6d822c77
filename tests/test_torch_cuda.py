"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips (with the reason) on a host without a GPU —
decided inside the fixture, never at import.  Run on the card with

    python -m pytest tests/test_torch_cuda.py

Tolerances are per output vector (the hd values of one query head): its
largest error over its largest |value| in the plain version, since the
outputs shrink as 1/sqrt(keys) on long rows, where a flat absolute limit
would pass a skipped K/V tile.  f32 agrees to summation order (1e-4);
bf16 to 4 ulps at 2^-8 (2^-6), one ulp being the output's own rounding.
The flat absolute limits (f32 1e-4, bf16 2e-2) stay as a ceiling.

bf16 flash and chunk attention run on the tensor cores (wgmma fed by TMA,
128-row query tiles, 128-key tiles, 64 at hd 256); f32 runs on the FMA
kernel.  The shapes below cover the tensor-core kernel's edges: a single
key, one key past a tile, ragged tiles that border the next batch row,
starts off the tile grid, a one-token chunk, pads past S_max, every head
dim.

Lane and paged decode are split-S (a block per KV head, row and split of
``split_plan``'s length, then a combine pass), over bf16/f32 storage and
over int8 storage with f32 scales (the tile dequantized in shared memory);
their cases cross many splits at Llama-3-8B's grouping, with lengths at
the split boundaries, at the plan's split length and at explicit ones.
"""

import math

import pytest

torch = pytest.importorskip("torch")

from llm_instance_gateway_tpu_torch.ops import chunk_attention as ch  # noqa: E402
from llm_instance_gateway_tpu_torch.ops import decode_attention as dec  # noqa: E402
from llm_instance_gateway_tpu_torch.ops import flash_attention as fl  # noqa: E402
from llm_instance_gateway_tpu_torch.ops import (  # noqa: E402
    paged_decode_attention as pd,
)

pytestmark = pytest.mark.cuda

SCALED_TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -6}
ABS_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def assert_close(got, want, dtype):
    """Each output vector's largest error over its largest |value| within
    SCALED_TOL, and every error within ABS_TOL."""
    g, w = got.float(), want.float()
    num = (g - w).abs().amax(-1)
    scaled = (num / w.abs().amax(-1).clamp_min(1e-30)).max().item()
    assert scaled < SCALED_TOL[dtype], scaled
    assert num.max().item() < ABS_TOL[dtype]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels compile for sm_90a)")
    return torch.device("cuda")


def randn(gen, *shape, dtype):
    return torch.randn(*shape, generator=gen, device=gen.device).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,h,k,hd", [
    (16, 32, 8, 128), (100, 8, 2, 64), (257, 8, 1, 256), (1024, 32, 8, 128),
    (1, 8, 2, 128), (129, 8, 2, 128), (129, 8, 2, 64), (200, 8, 2, 256)])
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
    assert_close(got, want, dtype)


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
    assert_close(got, want, dtype)
    assert not got[0].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,s_max,start,h,k,hd", [
    (1024, 8192, 0, 8, 2, 128), (1024, 8192, 5120, 8, 2, 128),
    (64, 8192, 640, 32, 8, 128), (100, 300, 37, 8, 1, 64),
    (64, 96, 80, 4, 2, 256),  # pad queries run past S_max
    (200, 1000, 77, 8, 2, 128),  # start off the 64 and 128 grids
    (1, 8192, 5000, 32, 8, 128), (1, 300, 0, 8, 2, 64),  # one-token chunks
    (128, 300, 250, 8, 2, 128),  # pads past S_max at hd 128
    (300, 2000, 700, 8, 1, 64), (256, 1000, 300, 8, 2, 256)])
def test_chunk_matches_plain_version(dev, dtype, c, s_max, start, h, k, hd):
    gen = torch.Generator(device=dev).manual_seed(c + start)
    q = randn(gen, 1, c, h, hd, dtype=dtype)
    kc = randn(gen, 1, s_max, k, hd, dtype=dtype)
    vc = randn(gen, 1, s_max, k, hd, dtype=dtype)
    before = ch.launches
    got = ch.chunk_attention(q, kc, vc, start)
    torch.cuda.synchronize()
    assert ch.launches == before + 1
    want = ch.chunk_attention_reference(q, kc, vc, start)
    assert_close(got, want, dtype)


@pytest.mark.parametrize("hd", [64, 128, 256])
def test_tensor_core_and_fma_kernels_side_by_side(dev, hd):
    """Flash bf16, then chunk bf16, then flash f32 in one process: the two
    headers' launchers (flash_tile_sm90.cuh and flash_tile.cuh, both in
    each library) keep their own state."""
    gen = torch.Generator(device=dev).manual_seed(hd + 2)
    for run, dtype in (("flash", torch.bfloat16), ("chunk", torch.bfloat16),
                       ("flash", torch.float32)):
        q = randn(gen, 2, 150, 8, hd, dtype=dtype)
        if run == "flash":
            kk = randn(gen, 2, 150, 2, hd, dtype=dtype)
            v = randn(gen, 2, 150, 2, hd, dtype=dtype)
            got = fl.flash_attention(q, kk, v)
            want = fl.flash_attention_reference(q, kk, v)
        else:
            kk = randn(gen, 2, 700, 2, hd, dtype=dtype)
            v = randn(gen, 2, 700, 2, hd, dtype=dtype)
            got = ch.chunk_attention(q, kk, v, 333)
            want = ch.chunk_attention_reference(q, kk, v, 333)
        torch.cuda.synchronize()
        assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("page,h,k,hd", [(16, 8, 2, 64), (64, 32, 8, 128)])
def test_paged_decode_matches_plain_version(dev, dtype, page, h, k, hd):
    gen = torch.Generator(device=dev).manual_seed(page + hd)
    b, m = 6, 8
    n_blocks = b * m
    q = randn(gen, b, h, hd, dtype=dtype)
    kp = randn(gen, n_blocks + 1, page, k, hd, dtype=dtype)
    vp = randn(gen, n_blocks + 1, page, k, hd, dtype=dtype)
    perm = torch.randperm(n_blocks, generator=torch.Generator().manual_seed(0))
    tables = (perm + 1).reshape(b, m).to(torch.int32)
    tables[1, 1:] = 0  # the trash block past a short row's end
    tables = tables.to(dev)
    lengths = torch.tensor([0, 1, page + page // 2, 3 * page, m * page - 1,
                            m * page], dtype=torch.int32, device=dev)
    before = pd.launches
    got = pd.paged_decode_attention(q, kp, vp, tables, lengths)
    torch.cuda.synchronize()
    assert pd.launches == before + 1
    want = pd.paged_decode_attention_reference(q, kp, vp, tables, lengths)
    assert_close(got, want, dtype)
    assert not got[0].any()


def test_unsupported_paged_inputs_raise_on_the_card(dev):
    """A block size off the 16 grid raises for bf16/f32 and int8 pools
    alike; an int8 pool's scales must be f32 of the pool's shape."""
    q = torch.zeros(2, 8, 128, device=dev)
    pool = torch.zeros(5, 24, 2, 128, device=dev)  # block 24: not 16k
    tables = torch.zeros(2, 2, dtype=torch.int32, device=dev)
    lengths = torch.ones(2, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="multiple of 16"):
        pd.paged_decode_attention(q, pool, pool, tables, lengths)
    scales = torch.ones(5, 24, 2, device=dev)
    with pytest.raises(ValueError, match="multiple of 16"):
        pd.paged_decode_attention(q, pool.to(torch.int8), pool.to(torch.int8),
                                  tables, lengths, scales, scales)
    pool = torch.zeros(5, 16, 2, 128, dtype=torch.int8, device=dev)
    with pytest.raises(ValueError, match="scales"):
        pd.paged_decode_attention(q, pool, pool, tables, lengths,
                                  scales[:, :16].half(), scales[:, :16].half())


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


def split_boundary_lengths(split_len, s_max, extra):
    """Lengths at the split length's edges (L-1, L, L+1), a full row, a 0
    row and ``extra``, clipped to S_max, int32."""
    return [min(n, s_max) for n in
            (0, split_len - 1, split_len, split_len + 1, s_max, 1, *extra)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_split_at_llama3_8b_grouping(dev, dtype):
    """The lane serve's shape (B=8, S_max=1024, H=32, K=8, hd 128) with
    lengths at the plan's split boundaries: rows cross many splits."""
    gen = torch.Generator(device=dev).manual_seed(80)
    b, s_max, h, k, hd = 8, 1024, 32, 8, 128
    split_len, n_split = dec.split_plan(b, k, s_max,
                                        dec.tile_positions(hd, dtype),
                                        dec.sm_count(dev))
    assert n_split >= 8
    q = randn(gen, b, h, hd, dtype=dtype)
    kc = randn(gen, b, s_max, k, hd, dtype=dtype)
    vc = randn(gen, b, s_max, k, hd, dtype=dtype)
    lengths = torch.tensor(split_boundary_lengths(
        split_len, s_max, (3 * split_len + 7, 2 * split_len)),
        dtype=torch.int32, device=dev)
    before = dec.launches
    got = dec.decode_attention(q, kc, vc, lengths)
    torch.cuda.synchronize()
    assert dec.launches == before + 1
    want = dec.decode_attention_reference(q, kc, vc, lengths)
    assert_close(got, want, dtype)
    assert not got[0].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("page", [16, 64])
def test_paged_split_at_llama3_8b_grouping(dev, dtype, page):
    """The paged serve's shape (B=8, S_max=8192, H=32, K=8, hd 128), P=16
    and 64, shuffled tables with the trash block past each row's end, and
    lengths at the plan's split boundaries."""
    gen = torch.Generator(device=dev).manual_seed(81 + page)
    b, s_max, h, k, hd = 8, 8192, 32, 8, 128
    m = s_max // page
    split_len, n_split = dec.split_plan(b, k, s_max,
                                        dec.tile_positions(hd, dtype),
                                        dec.sm_count(dev), page)
    assert n_split >= 16 and split_len % page == 0
    q = randn(gen, b, h, hd, dtype=dtype)
    kp = randn(gen, b * m + 1, page, k, hd, dtype=dtype)
    vp = randn(gen, b * m + 1, page, k, hd, dtype=dtype)
    perm = torch.randperm(b * m, generator=torch.Generator().manual_seed(page))
    tables = (perm + 1).reshape(b, m).to(torch.int32)
    lengths = split_boundary_lengths(split_len, s_max,
                                     (6000, 3 * split_len + 5))
    for i, n in enumerate(lengths):
        tables[i, -(-n // page):] = 0  # past the row's end: the trash block
    tables = tables.to(dev)
    lengths = torch.tensor(lengths, dtype=torch.int32, device=dev)
    before = pd.launches
    got = pd.paged_decode_attention(q, kp, vp, tables, lengths)
    torch.cuda.synchronize()
    assert pd.launches == before + 1
    want = pd.paged_decode_attention_reference(q, kp, vp, tables, lengths)
    assert_close(got, want, dtype)
    assert not got[0].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [64, 256])
def test_decode_split_other_head_dims(dev, dtype, hd):
    """hd 64 and 256 at H=8, K=2 over many splits: the lane kernel at one
    tile, a few tiles and the plan's split length, the pool at P=16."""
    gen = torch.Generator(device=dev).manual_seed(82 + hd)
    b, s_max, h, k, page = 6, 2048, 8, 2, 16
    tile = dec.tile_positions(hd, dtype)
    q = randn(gen, b, h, hd, dtype=dtype)
    kc = randn(gen, b, s_max, k, hd, dtype=dtype)
    vc = randn(gen, b, s_max, k, hd, dtype=dtype)
    lengths = torch.tensor([0, 1, tile - 1, 3 * tile + 1, 1500, s_max],
                           dtype=torch.int32, device=dev)
    want = dec.decode_attention_reference(q, kc, vc, lengths)
    for split_len in (tile, 3 * tile, None):
        got = dec.decode_attention_split(q, kc, vc, lengths, split_len)
        torch.cuda.synchronize()
        assert_close(got, want, dtype)
        assert not got[0].any()
    # The same rows as a pool: block i of row r is physical block
    # r * m + i + 1, so the pool's plain version is the lanes' one.
    m = s_max // page
    kp = torch.cat([kc[:1, :page] * 0, kc.reshape(b * m, page, k, hd)])
    vp = torch.cat([vc[:1, :page] * 0, vc.reshape(b * m, page, k, hd)])
    tables = (torch.arange(b * m, device=dev) + 1).reshape(b, m)
    got = pd.paged_decode_attention(q, kp, vp, tables.to(torch.int32),
                                    lengths)
    torch.cuda.synchronize()
    assert_close(got, want, dtype)


def test_int8_kernels_after_the_split_kernels(dev):
    """bf16 split kernels (lanes, pool), then the int8 lane and pool
    kernels, in one process: the shared header's bf16 and int8 instances
    side by side, each call counted once on its own counter."""
    gen = torch.Generator(device=dev).manual_seed(83)
    b, s_max, h, k, hd, page = 4, 1024, 32, 8, 128, 64
    bf16 = torch.bfloat16
    lengths = torch.tensor([0, 300, 1023, 1024], dtype=torch.int32,
                           device=dev)
    q = randn(gen, b, h, hd, dtype=bf16)
    kf = torch.randn(b, s_max, k, hd, generator=gen, device=dev)
    vf = torch.randn(b, s_max, k, hd, generator=gen, device=dev)
    m = s_max // page
    tables = (torch.arange(b * m, device=dev, dtype=torch.int32)
              + 1).reshape(b, m)

    def pool(x):  # row r's block i at physical block r * m + i + 1
        return torch.cat([x[:1, :page] * 0,
                          x.reshape(b * m, page, k, *x.shape[3:])])

    kc, vc = kf.to(bf16), vf.to(bf16)
    assert_close(dec.decode_attention(q, kc, vc, lengths),
                 dec.decode_attention_reference(q, kc, vc, lengths), bf16)
    assert_close(pd.paged_decode_attention(q, pool(kc), pool(vc), tables,
                                           lengths),
                 dec.decode_attention_reference(q, kc, vc, lengths), bf16)
    (kq, ks), (vq, vs) = quantize(kf), quantize(vf)
    before = (dec.launches, dec.quant_launches, pd.launches,
              pd.quant_launches)
    got = dec.decode_attention(q, kq, vq, lengths, ks, vs)
    got_pool = pd.paged_decode_attention(q, pool(kq), pool(vq), tables,
                                         lengths, pool(ks), pool(vs))
    torch.cuda.synchronize()
    assert (dec.launches, dec.quant_launches, pd.launches,
            pd.quant_launches) == (before[0], before[1] + 1, before[2],
                                   before[3] + 1)
    want = dec.decode_attention_quant_reference(q, kq, vq, ks, vs, lengths)
    assert_close(got, want, bf16)
    assert_close(got_pool, want, bf16)
    assert not got[0].any() and not got_pool[0].any()


def test_split_len_off_the_tile_grid_raises(dev):
    q = torch.zeros(2, 8, 128, device=dev, dtype=torch.bfloat16)
    cache = torch.zeros(2, 256, 2, 128, device=dev, dtype=torch.bfloat16)
    lengths = torch.ones(2, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="split_len"):
        dec.decode_attention_split(q, cache, cache, lengths, 48)
    pool = torch.zeros(5, 64, 2, 128, device=dev, dtype=torch.bfloat16)
    tables = torch.zeros(2, 4, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="split_len"):
        pd.paged_decode_attention_split(q, pool, pool, tables, lengths, 32)


def quantize(x):
    """[..., hd] -> (int8, f32 scale [...]), per-vector max-abs (the
    serving path's ``_kv_quantize``)."""
    from llm_instance_gateway_tpu_torch.models.transformer import _kv_quantize

    return _kv_quantize(x)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,k,hd", [(32, 8, 128), (8, 2, 64), (8, 1, 256)])
def test_decode_quant_matches_plain_version(dev, dtype, h, k, hd):
    """The int8 lane kernel after the flash and bf16 kernels in one
    process (the shared headers keep internal linkage)."""
    gen = torch.Generator(device=dev).manual_seed(hd + 1)
    b, s_max = 6, 300
    q = randn(gen, b, h, hd, dtype=dtype)
    kq, ks = quantize(randn(gen, b, s_max, k, hd, dtype=torch.float32))
    vq, vs = quantize(randn(gen, b, s_max, k, hd, dtype=torch.float32))
    lengths = torch.tensor([0, 1, 63, 64, 65, 300], dtype=torch.int32,
                           device=dev)
    before = (dec.launches, dec.quant_launches)
    got = dec.decode_attention(q, kq, vq, lengths, ks, vs)
    torch.cuda.synchronize()
    assert (dec.launches, dec.quant_launches) == (before[0], before[1] + 1)
    want = dec.decode_attention_quant_reference(q, kq, vq, ks, vs, lengths)
    assert_close(got, want, dtype)
    assert not got[0].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("page,h,k,hd", [(16, 8, 2, 64), (64, 32, 8, 128)])
def test_paged_decode_quant_matches_plain_version(dev, dtype, page, h, k, hd):
    gen = torch.Generator(device=dev).manual_seed(page + hd + 1)
    b, m = 6, 8
    n_blocks = b * m
    q = randn(gen, b, h, hd, dtype=dtype)
    kq, ks = quantize(randn(gen, n_blocks + 1, page, k, hd,
                            dtype=torch.float32))
    vq, vs = quantize(randn(gen, n_blocks + 1, page, k, hd,
                            dtype=torch.float32))
    perm = torch.randperm(n_blocks, generator=torch.Generator().manual_seed(1))
    tables = (perm + 1).reshape(b, m).to(torch.int32)
    tables[1, 1:] = 0  # the trash block past a short row's end
    tables = tables.to(dev)
    lengths = torch.tensor([0, 1, page + page // 2, 3 * page, m * page - 1,
                            m * page], dtype=torch.int32, device=dev)
    before = (pd.launches, pd.quant_launches)
    got = pd.paged_decode_attention(q, kq, vq, tables, lengths, ks, vs)
    torch.cuda.synchronize()
    assert (pd.launches, pd.quant_launches) == (before[0], before[1] + 1)
    want = pd.paged_decode_attention_quant_reference(q, kq, vq, tables,
                                                     lengths, ks, vs)
    assert_close(got, want, dtype)
    assert not got[0].any()


def quant_lanes(gen, b, s_max, k, hd):
    """Seeded int8 lanes and their f32 scales, quantized as the serving
    path does."""
    (kq, ks), (vq, vs) = (quantize(randn(gen, b, s_max, k, hd,
                                         dtype=torch.float32))
                          for _ in range(2))
    return kq, vq, ks, vs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_quant_split_at_llama3_8b_grouping(dev, dtype):
    """The int8 lane serve's shape (B=8, S_max=1024, H=32, K=8, hd 128) at
    the plan's split length, one tile and the whole row, with lengths at
    the plan's split boundaries."""
    gen = torch.Generator(device=dev).manual_seed(90)
    b, s_max, h, k, hd = 8, 1024, 32, 8, 128
    tile = dec.tile_positions(hd, dtype)
    split_len, n_split = dec.split_plan(b, k, s_max, tile, dec.sm_count(dev))
    assert n_split >= 8
    q = randn(gen, b, h, hd, dtype=dtype)
    kq, vq, ks, vs = quant_lanes(gen, b, s_max, k, hd)
    lengths = torch.tensor(split_boundary_lengths(
        split_len, s_max, (3 * split_len + 7, 2 * split_len)),
        dtype=torch.int32, device=dev)
    want = dec.decode_attention_quant_reference(q, kq, vq, ks, vs, lengths)
    before = (dec.launches, dec.quant_launches)
    got = dec.decode_attention(q, kq, vq, lengths, ks, vs)
    torch.cuda.synchronize()
    assert (dec.launches, dec.quant_launches) == (before[0], before[1] + 1)
    assert_close(got, want, dtype)
    assert not got[0].any()
    for n in (tile, s_max):
        got = dec.decode_attention_split(q, kq, vq, lengths, n, ks, vs)
        torch.cuda.synchronize()
        assert_close(got, want, dtype)
        assert not got[0].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("page", [16, 64])
def test_paged_quant_split_at_llama3_8b_grouping(dev, dtype, page):
    """The int8 paged serve's shape (B=8, S_max=8192, H=32, K=8, hd 128),
    P=16 and 64, shuffled tables with the trash block past each row's end
    (its values and scales garbage), at the plan's split length and at
    the smallest aligned one."""
    gen = torch.Generator(device=dev).manual_seed(91 + page)
    b, s_max, h, k, hd = 8, 8192, 32, 8, 128
    m = s_max // page
    tile = dec.tile_positions(hd, dtype)
    split_len, n_split = dec.split_plan(b, k, s_max, tile, dec.sm_count(dev),
                                        page)
    assert n_split >= 16 and split_len % page == 0
    q = randn(gen, b, h, hd, dtype=dtype)
    kq, vq, ks, vs = quant_lanes(gen, b * m + 1, page, k, hd)
    for pool, sc in ((kq, ks), (vq, vs)):
        pool[0] = 127  # the trash block
        sc[0] = 1e3
    perm = torch.randperm(b * m, generator=torch.Generator().manual_seed(page))
    tables = (perm + 1).reshape(b, m).to(torch.int32)
    lengths = split_boundary_lengths(split_len, s_max,
                                     (6000, 3 * split_len + 5))
    for i, n in enumerate(lengths):
        tables[i, -(-n // page):] = 0  # past the row's end: the trash block
    tables = tables.to(dev)
    lengths = torch.tensor(lengths, dtype=torch.int32, device=dev)
    want = pd.paged_decode_attention_quant_reference(q, kq, vq, tables,
                                                     lengths, ks, vs)
    before = (pd.launches, pd.quant_launches)
    got = pd.paged_decode_attention(q, kq, vq, tables, lengths, ks, vs)
    torch.cuda.synchronize()
    assert (pd.launches, pd.quant_launches) == (before[0], before[1] + 1)
    assert_close(got, want, dtype)
    assert not got[0].any()
    got = pd.paged_decode_attention_split(q, kq, vq, tables, lengths,
                                          math.lcm(tile, page), ks, vs)
    torch.cuda.synchronize()
    assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [64, 256])
def test_decode_quant_split_other_head_dims(dev, dtype, hd):
    """int8 at hd 64 and 256, H=8, K=2, over many splits: the lane kernel
    at one tile, a few tiles and the plan's split length, the pool at
    P=16."""
    gen = torch.Generator(device=dev).manual_seed(92 + hd)
    b, s_max, h, k, page = 6, 2048, 8, 2, 16
    tile = dec.tile_positions(hd, dtype)
    q = randn(gen, b, h, hd, dtype=dtype)
    kq, vq, ks, vs = quant_lanes(gen, b, s_max, k, hd)
    lengths = torch.tensor([0, 1, tile - 1, 3 * tile + 1, 1500, s_max],
                           dtype=torch.int32, device=dev)
    want = dec.decode_attention_quant_reference(q, kq, vq, ks, vs, lengths)
    for split_len in (tile, 3 * tile, None):
        got = dec.decode_attention_split(q, kq, vq, lengths, split_len, ks,
                                         vs)
        torch.cuda.synchronize()
        assert_close(got, want, dtype)
        assert not got[0].any()
    # The same rows as a pool: block i of row r is physical block
    # r * m + i + 1, so the pool's plain version is the lanes' one.
    m = s_max // page

    def pool(x):
        return torch.cat([x[:1, :page] * 0,
                          x.reshape(b * m, page, k, *x.shape[3:])])

    tables = (torch.arange(b * m, device=dev, dtype=torch.int32)
              + 1).reshape(b, m)
    got = pd.paged_decode_attention(q, pool(kq), pool(vq), tables, lengths,
                                    pool(ks), pool(vs))
    torch.cuda.synchronize()
    assert_close(got, want, dtype)


def test_int8_split_len_off_the_grid_raises(dev):
    """An int8 split length is counted in tiles of q's dtype (64 positions
    at bf16 hd 128, 32 at f32) and, for the pool, in whole blocks."""
    lengths = torch.ones(2, dtype=torch.int32, device=dev)
    cache = torch.zeros(2, 256, 2, 128, device=dev, dtype=torch.int8)
    scales = torch.ones(2, 256, 2, device=dev)
    for dtype, off in ((torch.bfloat16, 32), (torch.float32, 48)):
        q = torch.zeros(2, 8, 128, device=dev, dtype=dtype)
        with pytest.raises(ValueError, match="split_len"):
            dec.decode_attention_split(q, cache, cache, lengths, off, scales,
                                       scales)
    q = torch.zeros(2, 8, 128, device=dev, dtype=torch.float32)
    pool = torch.zeros(5, 48, 2, 128, device=dev, dtype=torch.int8)
    pool_scales = torch.ones(5, 48, 2, device=dev)
    tables = torch.zeros(2, 4, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="split_len"):  # lcm(32, 48) = 96
        pd.paged_decode_attention_split(q, pool, pool, tables, lengths, 48,
                                        pool_scales, pool_scales)


# ---------------------------------------------------------------------------
# The engine's fused decode block as a CUDA graph (server/decode_graphs.py)
# ---------------------------------------------------------------------------


def _narrow_cfg():
    """Llama-3-8B's head layout (hd 128, 4 query heads per KV head) at a
    small width and depth."""
    import dataclasses

    from llm_instance_gateway_tpu_torch.models.configs import LLAMA3_8B

    return dataclasses.replace(LLAMA3_8B, name="llama3-8b-narrow",
                               d_model=512, n_layers=2, n_heads=8,
                               n_kv_heads=2, head_dim=128, d_ff=1024,
                               vocab_size=320, max_lora_slots=2,
                               max_lora_rank=8)


@pytest.fixture(scope="module")
def narrow():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels compile for sm_90a)")
    from llm_instance_gateway_tpu_torch.models import transformer

    cfg = _narrow_cfg()
    return {dtype: (cfg, transformer.init_params(cfg, seed=5, dtype=dtype,
                                                 device="cuda"))
            for dtype in (torch.bfloat16, torch.float32)}


def _draft_cfg():
    """A one-layer draft with the narrow model's vocabulary, at head dims
    the kernels take (hd 64, 4 query heads per KV head)."""
    import dataclasses

    return dataclasses.replace(_narrow_cfg(), name="narrow-draft",
                               d_model=256, n_layers=1, n_heads=4,
                               n_kv_heads=1, head_dim=64, d_ff=512)


def _engine(narrow, graphs=True, dtype=torch.bfloat16, lora=None,
            draft=None, **cfg):
    """An engine over the narrow model; with ``speculative_k``, ``draft``
    "small" (a seeded one-layer draft) or "perfect" (the target's own
    params)."""
    from llm_instance_gateway_tpu_torch.models import transformer
    from llm_instance_gateway_tpu_torch.server.engine import (
        Engine,
        EngineConfig,
    )

    model_cfg, params = narrow[dtype]
    base = dict(decode_slots=4, max_seq_len=256, prefill_buckets=(16, 64),
                decode_steps_per_sync=4)
    base.update(cfg)
    kw = {}
    if draft == "perfect":
        kw = dict(draft_params=params, draft_cfg=model_cfg)
    elif draft == "small":
        kw = dict(draft_params=transformer.init_params(
            _draft_cfg(), seed=9, dtype=dtype, device="cuda"),
            draft_cfg=_draft_cfg())
    return Engine(model_cfg, params, EngineConfig(**base), lora_manager=lora,
                  eos_id=None, dtype=dtype, device="cuda", cuda_graphs=graphs,
                  **kw)


def _jobs(seeded=False, temperature=0.0):
    from llm_instance_gateway_tpu_torch.server.engine import SamplingParams

    sp = SamplingParams(temperature=temperature, top_k=50,
                        seed=77 if seeded else None)
    return [([256] + [65 + (7 * i + j) % 200 for j in range(n)], m, sp)
            for i, (n, m) in enumerate(((5, 20), (40, 14), (12, 9),
                                        (60, 18), (3, 11)))]


def _serve(eng, jobs, adapter=None):
    from llm_instance_gateway_tpu_torch.server.engine import Request

    eng.start()
    try:
        reqs = [eng.submit(Request(prompt_tokens=p, max_new_tokens=m,
                                   sampling=sp, adapter=adapter))
                for p, m, sp in jobs]
        for r in reqs:
            assert r.done.wait(300) and r.error is None, r.error
        return [r.output_tokens for r in reqs]
    finally:
        eng.stop()


@pytest.mark.parametrize("seeded", [False, True], ids=["greedy", "seeded"])
@pytest.mark.parametrize("kv", [None, "int8"], ids=["bf16-kv", "int8-kv"])
@pytest.mark.parametrize("paged", [False, True], ids=["lanes", "paged"])
def test_graph_replay_matches_eager_block(narrow, paged, kv, seeded):
    """The same requests through the eager block and through its graph
    replays: the same tokens (the same kernels in the same order), with
    five requests over four slots (a slot reused under a live graph)."""
    extra = dict(kv_cache_quant=kv, adaptive_steps=8)
    if paged:
        extra.update(paged_kv_block=16)
    jobs = _jobs(seeded, temperature=0.8 if seeded else 0.0)
    eager = _serve(_engine(narrow, graphs=False, **extra), jobs)
    eng = _engine(narrow, **extra)
    replayed = _serve(eng, jobs)
    assert replayed == eager
    assert eng._graphs.replays > 0
    assert all(seeded_key == seeded and not penalized
               for _, seeded_key, penalized in eng._graphs.shapes)


def test_pipelined_grouped_graph_engine_matches_eager(narrow):
    """f32: a pipelined, grouped engine replaying graphs gives the eager
    sync engine's greedy streams."""
    jobs = _jobs()
    eager = _serve(_engine(narrow, graphs=False, dtype=torch.float32), jobs)
    for paged in (False, True):
        extra = dict(paged_kv_block=16) if paged else {}
        eng = _engine(narrow, dtype=torch.float32, prefill_batch=4,
                      pipeline_decode=True, **extra)
        assert _serve(eng, jobs) == eager
        assert eng._graphs.replays > 0


def test_adapter_swap_between_replays_takes_effect(narrow):
    """An adapter loaded, unloaded and another loaded between replays of
    one graph is read by the next replay (the slots are written in place):
    the graph's engine gives the eager engine's tokens at every stage."""
    import numpy as np

    from llm_instance_gateway_tpu_torch.models import lora as lora_lib
    from llm_instance_gateway_tpu_torch.server.lora_manager import LoRAManager

    cfg = narrow[torch.bfloat16][0]

    def weights(seed):
        rng = np.random.default_rng(seed)
        return {t: {"a": rng.standard_normal((cfg.n_layers, di, 8)) * 0.3,
                    "b": rng.standard_normal((cfg.n_layers, 8, do)) * 0.3}
                for t, (di, do) in lora_lib.target_dims(cfg).items()}

    jobs = _jobs()[:2]
    streams = {}
    for graphs in (False, True):
        lora = LoRAManager(cfg, dtype=torch.bfloat16, device="cuda")
        eng = _engine(narrow, graphs=graphs, lora=lora)
        eng.start()
        try:
            out = []
            for step in ("base", "a", "unload", "b"):
                if step == "a":
                    lora.load("ad", weights=weights(1), alpha=16.0, rank=8)
                elif step == "unload":
                    assert lora.unload("ad")
                elif step == "b":
                    lora.load("ad", weights=weights(2), alpha=16.0, rank=8)
                adapter = "ad" if step in ("a", "b") else None
                out.append(_serve_running(eng, jobs, adapter))
        finally:
            eng.stop()
        streams[graphs] = out
        if graphs:
            assert len(eng._graphs.shapes) == 1  # one graph, replayed
    assert streams[True] == streams[False]
    base, a, unloaded, b = streams[True]
    assert a != base and b != a and unloaded == base


def _serve_queued(eng, jobs, adapters=None):
    """``_serve`` with every request submitted BEFORE ``start()`` (the
    reference's rule in ``parallel/multihost_check.py``): one admission
    order, so the dispatch sequence does not follow the host's timing.
    ``adapters`` names each job's adapter (None: the base model)."""
    from llm_instance_gateway_tpu_torch.server.engine import Request

    adapters = adapters or [None] * len(jobs)
    reqs = [eng.submit(Request(prompt_tokens=p, max_new_tokens=m,
                               sampling=sp, adapter=a))
            for (p, m, sp), a in zip(jobs, adapters)]
    eng.start()
    try:
        for r in reqs:
            assert r.done.wait(300) and r.error is None, r.error
        return [r.output_tokens for r in reqs]
    finally:
        eng.stop()


def _serve_running(eng, jobs, adapter=None):
    from llm_instance_gateway_tpu_torch.server.engine import Request

    reqs = [eng.submit(Request(prompt_tokens=p, max_new_tokens=m,
                               sampling=sp, adapter=adapter))
            for p, m, sp in jobs]
    for r in reqs:
        assert r.done.wait(300) and r.error is None, r.error
    return [r.output_tokens for r in reqs]


def test_table_grown_between_replays_is_read(narrow):
    """A paged row crosses many 16-token blocks while one graph replays:
    each replay reads the table the host grew in place, so the stream
    equals the eager one's."""
    jobs = [([256, 70, 71, 72], 120, _jobs()[0][2])]
    extra = dict(paged_kv_block=16, max_seq_len=256, decode_slots=2)
    eager = _serve(_engine(narrow, graphs=False, **extra), jobs)
    eng = _engine(narrow, **extra)
    assert _serve(eng, jobs) == eager
    assert eng._graphs.shapes == [(4, False, False)]
    assert len(eager[0]) == 120


def test_replays_draw_new_noise(dev):
    """The generator registered with a graph advances on every replay, so
    two replays of one block draw different uniforms."""
    from llm_instance_gateway_tpu_torch.server import decode_graphs

    gen = torch.Generator(device=dev).manual_seed(3)

    def block(n_steps, seeded):
        return torch.rand((n_steps, 64), generator=gen, device=dev)

    graphs = decode_graphs.DecodeGraphs(gen, dev)
    graphs.warm_up(block)
    first = graphs.run(block, 2, False).clone()
    second = graphs.run(block, 2, False).clone()
    assert not torch.equal(first, second)
    assert graphs.shapes == [(2, False)] and graphs.replays == 2


def test_sampled_rows_draw_new_noise_per_replay(narrow):
    """On the engine: an unseeded sampled request repeated draws different
    tokens, while a seeded one repeats its tokens exactly."""
    from llm_instance_gateway_tpu_torch.server.engine import SamplingParams

    prompt = [256, 80, 81, 82]
    free = SamplingParams(temperature=1.5)
    seeded = SamplingParams(temperature=1.5, seed=9)
    eng = _engine(narrow, decode_slots=1)
    eng.start()
    try:
        frees = [_serve_running(eng, [(prompt, 16, free)])[0]
                 for _ in range(3)]
        seeds = [_serve_running(eng, [(prompt, 16, seeded)])[0]
                 for _ in range(2)]
    finally:
        eng.stop()
    assert len({tuple(f) for f in frees}) > 1
    assert seeds[0] == seeds[1]


def test_launch_counts_exact_under_replay(narrow):
    """Captures count nothing; each replay adds its graph's launches: the
    lane kernel at n_layers per decode step, flash at n_layers per
    prefill, nothing else."""
    from llm_instance_gateway_tpu_torch.server import decode_graphs

    cfg = narrow[torch.bfloat16][0]
    eng = _engine(narrow, adaptive_steps=8)
    jobs = _jobs()
    snap0 = eng.metrics_snapshot()
    eng.start()  # the warm-up step runs here, before the window
    try:
        counters = decode_graphs._COUNTERS
        for mod, attr in counters.values():
            setattr(mod, attr, 0)
        _serve_running(eng, jobs)
        counts = decode_graphs.launch_counts()
    finally:
        eng.stop()
    steps = int(eng.metrics_snapshot()["dispatch_steps_hist"]["sum"]
                - snap0["dispatch_steps_hist"]["sum"])
    want = dict.fromkeys(counters, 0)
    want["flash_prefill"] = len(jobs) * cfg.n_layers  # one program each
    want["decode_attention"] = steps * cfg.n_layers   # lane decode
    assert counts == want
    assert len(eng._graphs.shapes) > 1 and eng._graphs.replays > 0


def test_capture_failure_raises(dev):
    """A block that reads a device value back cannot be captured: the
    capture raises (no eager fallback) and the launch counters are as
    they were."""
    from llm_instance_gateway_tpu_torch.server import decode_graphs

    x = torch.ones(4, device=dev)

    def block(n_steps, seeded):
        return x * float((x * n_steps).sum())  # a host sync

    gen = torch.Generator(device=dev).manual_seed(0)
    graphs = decode_graphs.DecodeGraphs(gen, dev)
    graphs.warm_up(block)
    before = decode_graphs.launch_counts()
    with pytest.raises(RuntimeError):
        graphs.run(block, 2, False)
    assert decode_graphs.launch_counts() == before


# ---------------------------------------------------------------------------
# The speculative block and the penalized decode block as CUDA graphs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("draft", ["small", "perfect"])
@pytest.mark.parametrize("loop", ["sync", "pipelined", "paged-pipelined"])
def test_spec_graph_replay_matches_eager_spec_block(narrow, loop, draft):
    """f32: the spec block's graph replays give the eager spec block's
    tokens and cycle counts, and the plain engine's greedy tokens; five
    requests over four slots, a graph per (n_cycles, k, seeded).  Every
    request is queued before ``start()``, so the cycle counts compare
    one admission order."""
    extra = dict(speculative_k=3, adaptive_steps=0, decode_steps_per_sync=4,
                 draft=draft)
    if loop != "sync":
        extra["pipeline_decode"] = True
    if loop.startswith("paged"):
        extra["paged_kv_block"] = 16
    jobs = _jobs()
    eager_eng = _engine(narrow, graphs=False, dtype=torch.float32, **extra)
    eager = _serve_queued(eager_eng, jobs)
    eng = _engine(narrow, dtype=torch.float32, **extra)
    replayed = _serve_queued(eng, jobs)
    plain = _serve_queued(_engine(narrow, graphs=False, dtype=torch.float32,
                                  adaptive_steps=0, decode_steps_per_sync=4),
                          jobs)
    assert replayed == eager == plain
    assert ((eng.spec_cycles, eng.spec_emitted)
            == (eager_eng.spec_cycles, eager_eng.spec_emitted))
    assert eng._graphs.spec_shapes and all(
        k == 3 and not seeded for _, k, seeded in eng._graphs.spec_shapes)
    if draft == "perfect":
        assert eng.spec_emitted > 2 * eng.spec_cycles


@pytest.mark.parametrize("pipelined", [False, True],
                         ids=["sync", "pipelined"])
def test_penalized_graph_matches_eager_block(narrow, pipelined):
    """Penalized, biased and plain rows together: the penalized graph's
    tokens are the eager block's, under its own key."""
    from llm_instance_gateway_tpu_torch.server.engine import SamplingParams

    sps = [SamplingParams(presence_penalty=1.5, frequency_penalty=0.7),
           SamplingParams(),
           SamplingParams(frequency_penalty=2.0,
                          logit_bias={70: 100.0, 71: -100.0}),
           SamplingParams(presence_penalty=-0.5, temperature=0.9, seed=3)]
    jobs = [(p, m, sp) for (p, m, _), sp in zip(_jobs(), sps)]
    extra = dict(pipeline_decode=pipelined, adaptive_steps=0,
                 decode_steps_per_sync=4)
    eager = _serve(_engine(narrow, graphs=False, dtype=torch.float32,
                           **extra), jobs)
    eng = _engine(narrow, dtype=torch.float32, **extra)
    assert _serve(eng, jobs) == eager
    assert (4, True, True) in eng._graphs.shapes
    assert set(eager[2][:3]) == {70}
    assert "counts" in eng._dev


def test_spec_launch_counts_exact_under_replay(narrow):
    """Captures count nothing, each spec replay adds its graph's launches
    (the draft's lane decode at n_layers x (K-1) per cycle), flash counts
    the target's prefill and the draft's admission per request."""
    from llm_instance_gateway_tpu_torch.server import decode_graphs

    cfg, dcfg, k = narrow[torch.bfloat16][0], _draft_cfg(), 3
    eng = _engine(narrow, draft="small", speculative_k=k, adaptive_steps=0,
                  decode_steps_per_sync=4)
    jobs = _jobs()
    eng.start()
    try:
        for mod, attr in decode_graphs._COUNTERS.values():
            setattr(mod, attr, 0)
        cycles0 = eng.spec_cycles
        _serve_running(eng, jobs)
        counts = decode_graphs.launch_counts()
        cycles = eng.spec_cycles - cycles0
        plain = int(eng.metrics_snapshot()["dispatch_steps_hist"]["sum"])
    finally:
        eng.stop()
    want = dict.fromkeys(decode_graphs._COUNTERS, 0)
    want["flash_prefill"] = len(jobs) * (cfg.n_layers + dcfg.n_layers)
    want["decode_attention"] = (cycles * dcfg.n_layers * (k - 1)
                                + plain * cfg.n_layers)
    assert counts == want
    assert cycles > 0 and eng._graphs.spec_shapes


def test_spec_capture_failure_raises(dev):
    """A spec block that reads a device value back cannot be captured:
    the capture raises under the spec kind, nothing is kept, and the
    decode kind's key of the same numbers is another graph."""
    from llm_instance_gateway_tpu_torch.server import decode_graphs

    x = torch.ones(4, device=dev)

    def block(n_cycles, k, seeded):
        return x * float((x * n_cycles).sum())  # a host sync

    gen = torch.Generator(device=dev).manual_seed(0)
    graphs = decode_graphs.DecodeGraphs(gen, dev)
    graphs.warm_up(block, 1, 1, True)
    with pytest.raises(RuntimeError):
        graphs.run(block, 2, 1, False, kind="spec")
    assert graphs.spec_shapes == [] and graphs.replays == 0


def test_capture_keeps_only_its_threads_launches(dev):
    """Another engine's thread launching while a graph is captured (a
    prefill replica beside a decode replica in one process) keeps its
    launch counted once and out of the graph's launches."""
    import threading

    from llm_instance_gateway_tpu_torch.server import decode_graphs

    gen = torch.Generator(device=dev).manual_seed(0)
    q = randn(gen, 1, 16, 4, 64, dtype=torch.bfloat16)
    k = randn(gen, 1, 16, 1, 64, dtype=torch.bfloat16)
    mid_capture, resume = threading.Event(), threading.Event()

    def block(n_steps, seeded):
        mid_capture.set()
        assert resume.wait(60)
        return q * n_steps

    graphs = decode_graphs.DecodeGraphs(gen, dev)
    graphs.warm_up(lambda n_steps, seeded: q * n_steps)
    fl.flash_attention(q, k, k)  # the library loads outside the window
    before = decode_graphs.launch_counts()
    capture = threading.Thread(target=graphs.run, args=(block, 2, False))
    capture.start()
    assert mid_capture.wait(60)
    fl.flash_attention(q, k, k)  # this thread, while the other captures
    resume.set()
    capture.join(60)
    torch.cuda.synchronize()
    after = decode_graphs.launch_counts()
    assert after == {**before, "flash_prefill": before["flash_prefill"] + 1}
    assert graphs._graphs[("decode", 2, False)][2] == dict.fromkeys(after,
                                                                     0)
    graphs.run(block, 2, False)  # a replay adds the graph's none
    assert decode_graphs.launch_counts() == after


def test_int8_quantizers_divide_as_the_reference(dev):
    """On the card the int8 quantizers' scales equal a true f32 division
    (numpy's, as the reference divides) bitwise, and the KV round trip the
    int8 handoff relies on (dequantize, quantize again) gives the same
    values — a Python-scalar divisor would multiply by its reciprocal
    instead."""
    import numpy as np

    from llm_instance_gateway_tpu_torch.models.transformer import _kv_quantize
    from llm_instance_gateway_tpu_torch.ops.quant import quantize_weight

    x = np.random.default_rng(3).standard_normal((8192, 128)).astype(
        np.float32)
    want = np.maximum(np.abs(x).max(-1) / np.float32(127.0),
                      np.float32(1e-8))
    xt = torch.from_numpy(x).to(dev)
    q, s = _kv_quantize(xt)
    np.testing.assert_array_equal(s.cpu().numpy(), want)
    q2, s2 = _kv_quantize(q.float() * s[:, None])
    assert torch.equal(q2, q) and torch.equal(s2, s)
    w = quantize_weight(xt)
    np.testing.assert_array_equal(
        w["s"].cpu().numpy(),
        np.maximum(np.abs(x).max(-2) / np.float32(127.0), np.float32(1e-8)))


# ---------------------------------------------------------------------------
# The other families: their head layouts in every kernel, and the MoE MLP
# ---------------------------------------------------------------------------

# Qwen2.5-7B's 28:4 (a group of 7) at hd 128 and Gemma-7B's 16:16 (MHA)
# at hd 256; Gemma-2B's 8:1 at hd 256 and Mixtral's 32:8 are above.
FAMILY_LAYOUTS = [(28, 4, 128), (16, 16, 256)]


def _check_flash_and_chunk(dev, dtype, h, k, hd, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    for s in (1, 129, 300):
        q = randn(gen, 2, s, h, hd, dtype=dtype)
        kk = randn(gen, 2, s, k, hd, dtype=dtype)
        v = randn(gen, 2, s, k, hd, dtype=dtype)
        assert_close(fl.flash_attention(q, kk, v),
                     fl.flash_attention_reference(q, kk, v), dtype)
    for c, s_max, start in ((200, 1000, 77), (64, 96, 80), (1, 300, 0)):
        q = randn(gen, 1, c, h, hd, dtype=dtype)
        kc = randn(gen, 1, s_max, k, hd, dtype=dtype)
        vc = randn(gen, 1, s_max, k, hd, dtype=dtype)
        assert_close(ch.chunk_attention(q, kc, vc, start),
                     ch.chunk_attention_reference(q, kc, vc, start), dtype)


def _check_lane_decode(dev, dtype, h, k, hd, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    b, s_max = 6, 1100
    q = randn(gen, b, h, hd, dtype=dtype)
    kc = randn(gen, b, s_max, k, hd, dtype=torch.float32)
    vc = randn(gen, b, s_max, k, hd, dtype=torch.float32)
    lengths = torch.tensor([0, 1, 63, 511, 1024, 1100], dtype=torch.int32,
                           device=dev)
    got = dec.decode_attention(q, kc.to(dtype), vc.to(dtype), lengths)
    assert_close(got, dec.decode_attention_reference(
        q, kc.to(dtype), vc.to(dtype), lengths), dtype)
    (kq, ks), (vq, vs) = quantize(kc), quantize(vc)
    got = dec.decode_attention(q, kq, vq, lengths, ks, vs)
    assert_close(got, dec.decode_attention_quant_reference(
        q, kq, vq, ks, vs, lengths), dtype)
    assert not got[0].any()


def _check_paged_decode(dev, dtype, h, k, hd, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    page, b, m = 64, 6, 8
    n_blocks = b * m
    q = randn(gen, b, h, hd, dtype=dtype)
    kp = randn(gen, n_blocks + 1, page, k, hd, dtype=torch.float32)
    vp = randn(gen, n_blocks + 1, page, k, hd, dtype=torch.float32)
    perm = torch.randperm(n_blocks, generator=torch.Generator().manual_seed(2))
    tables = (perm + 1).reshape(b, m).to(torch.int32)
    tables[1, 1:] = 0
    tables = tables.to(dev)
    lengths = torch.tensor([0, 1, 96, 3 * page, m * page - 1, m * page],
                           dtype=torch.int32, device=dev)
    got = pd.paged_decode_attention(q, kp.to(dtype), vp.to(dtype), tables,
                                    lengths)
    assert_close(got, pd.paged_decode_attention_reference(
        q, kp.to(dtype), vp.to(dtype), tables, lengths), dtype)
    (kq, ks), (vq, vs) = quantize(kp), quantize(vp)
    got = pd.paged_decode_attention(q, kq, vq, tables, lengths, ks, vs)
    assert_close(got, pd.paged_decode_attention_quant_reference(
        q, kq, vq, tables, lengths, ks, vs), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,k,hd", FAMILY_LAYOUTS)
def test_family_layout_flash_and_chunk(dev, dtype, h, k, hd):
    _check_flash_and_chunk(dev, dtype, h, k, hd, h + hd)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,k,hd", FAMILY_LAYOUTS)
def test_family_layout_lane_decode(dev, dtype, h, k, hd):
    _check_lane_decode(dev, dtype, h, k, hd, h + hd + 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,k,hd", FAMILY_LAYOUTS)
def test_family_layout_paged_decode(dev, dtype, h, k, hd):
    _check_paged_decode(dev, dtype, h, k, hd, h + hd + 2)


# One shard's heads under ``--mesh tensor=N`` (``parallel/sharding``): the
# kernels run once per shard on these local layouts.  Llama-3-8B / Mixtral
# 32:8 at t=2 and 4 (16:4, 8:2); Gemma-2B 8:1 at t=2 and 4 (4:1 and 2:1,
# the KV head replicated); Gemma-7B 16:16 at t=2 (8:8); Qwen2.5-7B 28:4 at
# t=2 and 4 (14:2, 7:1).
MESH_LAYOUTS = [(16, 4, 128), (8, 2, 128), (4, 1, 256), (2, 1, 256),
                (8, 8, 256), (14, 2, 128), (7, 1, 128)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,k,hd", MESH_LAYOUTS)
def test_mesh_layout_flash_and_chunk(dev, dtype, h, k, hd):
    _check_flash_and_chunk(dev, dtype, h, k, hd, 3 * h + hd)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,k,hd", MESH_LAYOUTS)
def test_mesh_layout_lane_decode(dev, dtype, h, k, hd):
    _check_lane_decode(dev, dtype, h, k, hd, 3 * h + hd + 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,k,hd", MESH_LAYOUTS)
def test_mesh_layout_paged_decode(dev, dtype, h, k, hd):
    _check_paged_decode(dev, dtype, h, k, hd, 3 * h + hd + 2)


@pytest.fixture(scope="module")
def mixtral_layer():
    """One layer of Mixtral-8x7B's MoE MLP at full width (d 4096, d_ff
    14336, 8 experts, top-2), f32, on the card and on the CPU, dense and
    int8."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels compile for sm_90a)")
    from llm_instance_gateway_tpu_torch.models.configs import MIXTRAL_8X7B
    from llm_instance_gateway_tpu_torch.ops.quant import quantize_weight

    cfg = MIXTRAL_8X7B
    gen = torch.Generator(device="cuda").manual_seed(11)
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    lp = {"router": randn(gen, d, e, dtype=torch.float32) / d ** 0.5,
          "w_gate": randn(gen, e, d, f, dtype=torch.float32) / d ** 0.5,
          "w_up": randn(gen, e, d, f, dtype=torch.float32) / d ** 0.5,
          "w_down": randn(gen, e, f, d, dtype=torch.float32) / f ** 0.5}
    qlp = {k: (v if k == "router" else quantize_weight(v))
           for k, v in lp.items()}

    def cpu(tree):
        return {k: ({p: t.cpu() for p, t in v.items()}
                    if isinstance(v, dict) else v.cpu())
                for k, v in tree.items()}

    return cfg, {"dense": (lp, cpu(lp)), "int8": (qlp, cpu(qlp))}


def _skewed(lp):
    """Every token routed to experts 0 and 1: capacity overflows."""
    router = torch.zeros_like(lp["router"])
    router[:, 0], router[:, 1] = 0.5, 0.4
    return dict(lp, router=router)


@pytest.mark.parametrize("weights", ["dense", "int8"])
@pytest.mark.parametrize("t,skew", [(8, False), (16, False), (64, False),
                                    (64, True)])
def test_moe_mlp_card_against_cpu(mixtral_layer, weights, t, skew):
    """The MoE MLP at Mixtral's layout (dense at t=8, grouped with the
    device-side exact fallback at 16 and 64, a forced overflow) on the
    card against the same function on the CPU, f32."""
    from llm_instance_gateway_tpu_torch.models import transformer

    cfg, trees = mixtral_layer
    gpu, cpu = trees[weights]
    if skew:
        gpu, cpu = _skewed(gpu), _skewed(cpu)
    x = torch.randn(t, cfg.d_model, generator=torch.Generator().manual_seed(t))
    got = transformer._moe_mlp(cfg, gpu, x.cuda()).cpu()
    want = transformer._moe_mlp(cfg, cpu, x)
    err = (got - want).abs().max().item()
    assert err <= 1e-4 * want.abs().max().item(), err
    if skew:
        dense = transformer._moe_dense(cfg, gpu, x.cuda()).cpu()
        assert torch.equal(got, dense)


def test_moe_overflow_inside_a_replayed_graph_is_dense(mixtral_layer):
    """The grouped dispatch captured as a CUDA graph (as the decode block
    holds it), replayed on balanced inputs and then on a forced overflow
    written into the same buffers: the first replay equals the eager
    result, the overflow's equals the dense mix (within f32 summation
    order: the GEMMs a capture records need not be the eager call's) and
    lies far from the dropping result the grouped tiles alone give."""
    import dataclasses

    from llm_instance_gateway_tpu_torch.models import transformer

    cfg, trees = mixtral_layer
    lp = dict(trees["dense"][0])
    router = lp["router"].clone()
    lp["router"] = router
    x = torch.randn(16, cfg.d_model, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(3))
    eager = transformer._moe_grouped(cfg, lp, x)
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        with torch.cuda.graph(graph):
            out = transformer._moe_grouped(cfg, lp, x)
    torch.cuda.current_stream().wait_stream(stream)
    graph.replay()
    assert torch.equal(out, eager)
    router.copy_(_skewed(lp)["router"])
    graph.replay()
    dense = transformer._moe_dense(cfg, lp, x)
    scale = dense.abs().max().item()
    assert (out - dense).abs().max().item() <= 1e-5 * scale
    dropped = transformer._moe_grouped(
        dataclasses.replace(cfg, moe_exact_fallback=False), lp, x)
    assert (dropped - dense).abs().max().item() > 1e-2 * scale


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("name", ["llama3-tiny", "mixtral-tiny", "qwen-tiny",
                                  "gemma-tiny"])
def test_checkpoint_load_on_the_card_equals_the_cpu_load(dev, tmp_path, name,
                                                         quantize):
    """An HF directory (sharded) loaded onto the card, dense or int8 a
    layer at a time, is the CPU's load bit for bit."""
    from llm_instance_gateway_tpu_torch.models.configs import CONFIGS
    from llm_instance_gateway_tpu_torch.models.convert import (
        load_serving_checkpoint,
        save_hf_checkpoint,
    )
    from llm_instance_gateway_tpu_torch.models.transformer import init_params

    cfg = CONFIGS[name]
    params = init_params(cfg, seed=5, dtype=torch.float32, device="cpu")
    path = str(tmp_path / name)
    save_hf_checkpoint(cfg, params, path, shard_bytes=200_000)
    _, cpu = load_serving_checkpoint(path, torch.bfloat16, "cpu", quantize)
    _, gpu = load_serving_checkpoint(path, torch.bfloat16, dev, quantize)
    want = dict(_leaves(cpu))
    got = dict(_leaves(gpu))
    assert set(got) == set(want)
    for key, leaf in want.items():
        assert got[key].device.type == "cuda", key
        assert got[key].dtype == leaf.dtype, key
        assert torch.equal(got[key].cpu(), leaf), key


# -- the flash backward kernel (training) ------------------------------------

def assert_grad_close(got, want, dtype):
    """``assert_close`` for a gradient: each vector's error over the larger
    of its own largest |value| and 1/16 of the tensor's, or of 1 (the
    inputs' scale) if that is larger — a vector that cancels to ~0 in
    exact arithmetic comes out at rounding size on both sides: dq of query
    0, whose one probability is 1, and all of dq at S = 1 — and the flat
    ceiling scaled by the tensor's largest |value| (gradients are not
    bounded by max |v| as attention outputs are)."""
    g, w = got.float(), want.float()
    num = (g - w).abs().amax(-1)
    top = w.abs().max().clamp_min(1.0)
    den = torch.maximum(w.abs().amax(-1), top / 16)
    assert (num / den).max().item() < SCALED_TOL[dtype]
    assert num.max().item() < ABS_TOL[dtype] * max(1.0, top.item())


BWD_CASES = [(g, hd, s) for g in (1, 4, 8) for hd in (64, 128, 256)
             for s in (1, 17, 127, 128, 129)] + [(8, 128, 1023)]


def _bwd_inputs(dev, dtype, b, s, h, kv, hd, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = randn(gen, b, s, h, hd, dtype=dtype)
    k = randn(gen, b, s, kv, hd, dtype=dtype)
    v = randn(gen, b, s, kv, hd, dtype=dtype)
    dout = randn(gen, b, s, h, hd, dtype=dtype)
    with torch.no_grad():
        out = fl.flash_attention(q, k, v)
    return q, k, v, out, dout


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,hd,s", BWD_CASES)
def test_flash_backward_matches_plain_version(dev, dtype, g, hd, s):
    args = _bwd_inputs(dev, dtype, 2, s, 8, 8 // g, hd, seed=s * 7 + hd + g)
    before = fl.backward_launches
    got = fl.flash_attention_backward(*args)
    torch.cuda.synchronize()
    assert fl.backward_launches == before + 1
    want = fl.flash_attention_backward_reference(*args)
    for gt, w in zip(got, want):
        assert gt.dtype == dtype and gt.shape == w.shape
        assert_grad_close(gt, w, dtype)


def test_flash_backward_is_bitwise_reproducible(dev):
    """No atomics: two runs give the same bits (Llama-3-8B's grouping,
    ragged tiles)."""
    args = _bwd_inputs(dev, torch.bfloat16, 2, 300, 32, 8, 128, seed=3)
    first = fl.flash_attention_backward(*args)
    second = fl.flash_attention_backward(*args)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_flash_autograd_runs_the_backward_kernel(dev):
    """``flash_attention`` under grad: one forward and one backward launch,
    the gradients the backward wrapper's on the same inputs."""
    q, k, v, _, dout = _bwd_inputs(dev, torch.bfloat16, 1, 130, 8, 2, 128, 9)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    f0, b0 = fl.launches, fl.backward_launches
    out = fl.flash_attention(*leaves)
    out.backward(dout)
    torch.cuda.synchronize()
    assert (fl.launches - f0, fl.backward_launches - b0) == (1, 1)
    want = fl.flash_attention_backward(q, k, v, out.detach(), dout)
    for t, w in zip(leaves, want):
        assert torch.equal(t.grad, w)


@pytest.mark.parametrize("s,h,k,hd", [(300, 32, 8, 128), (129, 8, 2, 64),
                                      (1023, 8, 1, 256)])
def test_training_forward_writes_out_and_lse(dev, s, h, k, hd):
    """``flash_forward_lse``: out bitwise the serving kernel's, lse each
    row's base-2 log-sum-exp of its masked scaled f32 logits within 1e-5
    of torch.logsumexp's (relative, with a floor of 1: row 0's lse is its
    one logit, which may lie near 0), one launch counted in ``launches``."""
    q, kk, v, _, _ = _bwd_inputs(dev, torch.bfloat16, 2, s, h, k, hd, seed=s)
    f0 = fl.launches
    out, lse = fl.flash_forward_lse(q, kk, v)
    torch.cuda.synchronize()
    assert fl.launches == f0 + 1
    assert torch.equal(out, fl.flash_prefill_kernel(q, kk, v))
    qg = q.float().reshape(2, s, k, h // k, hd) / math.sqrt(hd)
    logits = torch.einsum("bikgh,bjkh->bkgij", qg, kk.float())
    causal = torch.tril(torch.ones((s, s), dtype=torch.bool, device=dev))
    want = torch.logsumexp(torch.where(causal, logits, fl.NEG_INF),
                           -1).reshape(2, h, s)
    assert lse.shape == (2, h, s) and lse.dtype == torch.float32
    err = (lse * math.log(2) - want).abs() / want.abs().clamp_min(1.0)
    assert err.max().item() < 1e-5


@pytest.mark.parametrize("g,hd", [(4, 128), (8, 256), (1, 64)])
def test_flash_backward_with_the_forwards_lse(dev, g, hd):
    """The backward with the training forward's lse equals the same call
    without it, which computes the lse first (bitwise: the same kernel)."""
    q, kk, v, _, dout = _bwd_inputs(dev, torch.bfloat16, 2, 257, 8, 8 // g,
                                    hd, seed=g + hd)
    out, lse = fl.flash_forward_lse(q, kk, v)
    b0 = fl.backward_launches
    got = fl.flash_attention_backward(q, kk, v, out, dout, lse=lse)
    want = fl.flash_attention_backward(q, kk, v, out, dout)
    torch.cuda.synchronize()
    assert fl.backward_launches == b0 + 2
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_group_split_at_gemma_2b_layout(dev):
    """Gemma-2B's layout (B=1, S=1023, 8:1, hd 256): the plan splits the one
    KV head's group; the result is within the check of the plain version
    with and without the split, and two runs give the same bits."""
    args = _bwd_inputs(dev, torch.bfloat16, 1, 1023, 8, 1, 256, seed=21)
    splits = fl.split_plan(1, 1023, 8, 1, 256, fl._sm_count(args[0].device))
    assert splits > 1
    want = fl.flash_attention_backward_reference(*args)
    first = fl.flash_attention_backward(*args)
    second = fl.flash_attention_backward(*args)
    unsplit = fl.flash_attention_backward(*args, splits=1)
    torch.cuda.synchronize()
    for a, b, c, w in zip(first, second, unsplit, want):
        assert torch.equal(a, b)
        assert_grad_close(a, w, torch.bfloat16)
        assert_grad_close(c, w, torch.bfloat16)


def test_flash_backward_refuses_bad_lse_and_splits(dev):
    q, kk, v, out, dout = _bwd_inputs(dev, torch.bfloat16, 1, 64, 8, 2,
                                      128, 1)
    lse = torch.zeros(1, 8, 64, device=dev)
    with pytest.raises(ValueError, match="lse"):
        fl.flash_attention_backward(q, kk, v, out, dout, lse=lse[:, :4])
    for splits in (3, 0):
        with pytest.raises(ValueError, match="splits"):
            fl.flash_attention_backward(q, kk, v, out, dout, splits=splits)
    f32 = _bwd_inputs(dev, torch.float32, 1, 64, 8, 2, 128, 1)
    with pytest.raises(ValueError, match="lse"):
        fl.flash_attention_backward(*f32, lse=lse)
    with pytest.raises(ValueError, match="bf16"):
        fl.flash_forward_lse(*f32[:3])


def test_raw_flash_launch_refuses_grad_inputs(dev):
    q, k, v, _, _ = _bwd_inputs(dev, torch.bfloat16, 1, 16, 8, 2, 128, 1)
    with pytest.raises(RuntimeError, match="requires grad"):
        fl.flash_prefill_kernel(q.requires_grad_(True), k, v)
    with pytest.raises(ValueError, match="head_dim"):
        fl.flash_attention_backward(*_bwd_inputs(
            dev, torch.float32, 1, 16, 4, 2, 32, 1))


def _flat_grads(fn, tree):
    """(loss, path -> gradient) over the tree's floating leaves."""
    leaves = {}

    def walk(t, prefix):
        for key, v in t.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{key}/")
            elif v.is_floating_point():
                leaves[f"{prefix}{key}"] = v.requires_grad_(True)

    walk(tree, "")
    loss = fn(tree)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.item(), {p: g.cpu() for p, g in zip(leaves, grads)}


@pytest.mark.parametrize("kind", ["full", "lora"])
def test_train_gradients_card_against_cpu(dev, kind):
    """The regression test for a cut graph: a narrow f32 model's loss and
    every gradient leaf on the card (forward and backward kernels) equal
    the CPU's (plain versions) within 1e-4 of each leaf's largest |value|
    (summation order, TF32 off) — wq/wk/wv and their LoRA leaves, which a
    cut at attention would leave at zero, among them."""
    from llm_instance_gateway_tpu_torch.models import lora, transformer
    from llm_instance_gateway_tpu_torch.training import train

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _narrow_cfg()
    cpu_params = transformer.init_params(cfg, seed=5, dtype=torch.float32,
                                         device="cpu")
    gen = torch.Generator().manual_seed(8)
    tokens = torch.randint(1, cfg.vocab_size, (2, 130), generator=gen)
    positions = torch.arange(130).repeat(2, 1)
    tokens[1, 77:], positions[1, 77:] = 0, 0
    results = {}
    for device in ("cpu", "cuda"):
        params = {k: ({n: t.detach().to(device) for n, t in v.items()}
                      if isinstance(v, dict) else v.detach().to(device))
                  for k, v in cpu_params.items()}
        args = (tokens.to(device), positions.to(device))
        if kind == "full":
            fn = (lambda p, a=args: train.causal_lm_loss(cfg, p, *a))
            tree = params
        else:
            bufs = lora.init_lora_buffers(cfg, torch.float32, device)
            bgen = torch.Generator().manual_seed(9)  # the same on both
            for t in lora.TARGETS:
                for ab in ("a", "b"):
                    bufs[f"{t}_{ab}"].copy_(torch.randn(
                        bufs[f"{t}_{ab}"].shape, generator=bgen) * 0.05)
            bufs["scale"].fill_(2.0)
            slots = torch.tensor([0, 1], device=device)
            fn = (lambda b, p=params, a=args, s=slots: train.causal_lm_loss(
                cfg, p, *a, lora_bufs=b, slot_ids=s))
            tree = bufs
        f0, b0 = fl.launches, fl.backward_launches
        results[device] = _flat_grads(fn, tree)
        if device == "cuda":
            torch.cuda.synchronize()
            assert fl.launches - f0 == cfg.n_layers
            assert fl.backward_launches - b0 == cfg.n_layers
    (want_loss, want), (got_loss, got) = results["cpu"], results["cuda"]
    assert abs(got_loss - want_loss) < 1e-5
    assert set(got) == set(want)
    for path, w in want.items():
        err = (got[path] - w).abs().max().item()
        assert err <= 1e-4 * max(w.abs().max().item(), 1e-6), (path, err)
    attn = (("layers/wq", "layers/wk", "layers/wv") if kind == "full" else
            ("q_a", "q_b", "k_a", "k_b", "v_a", "v_b"))
    for path in attn:
        assert got[path].abs().max() > 0, path


# ---------------------------------------------------------------------------
# Tensor parallelism on one card (--mesh tensor=2, both shards on cuda:0)
# ---------------------------------------------------------------------------


def _mesh_engine(narrow, t, dtype, graphs=True, devices=None, lora=None,
                 draft=None, params=None, axes=None, model_cfg=None, **cfg):
    """An engine over the narrow model at ``tensor=t`` (or the mesh of
    ``axes``), its shards on ``devices`` (default: all on cuda:0);
    ``draft`` as ``_engine``'s, ``params`` (with ``model_cfg``) in place
    of the narrow tree."""
    from llm_instance_gateway_tpu_torch.models import transformer
    from llm_instance_gateway_tpu_torch.parallel.mesh import (
        MeshConfig,
        make_mesh,
    )
    from llm_instance_gateway_tpu_torch.server.engine import (
        Engine,
        EngineConfig,
    )

    narrow_cfg, narrow_params = narrow[dtype]
    model_cfg = model_cfg or narrow_cfg
    base = dict(decode_slots=4, max_seq_len=256, prefill_buckets=(16, 64),
                decode_steps_per_sync=4)
    base.update(cfg)
    mesh_cfg = MeshConfig(**(axes or dict(tensor=t)))
    mesh = (make_mesh(mesh_cfg, devices or ["cuda:0"] * mesh_cfg.total)
            if mesh_cfg.total > 1 else None)
    kw = {}
    if draft == "small":
        kw = dict(draft_params=transformer.init_params(
            _draft_cfg(), seed=9, dtype=dtype, device="cuda"),
            draft_cfg=_draft_cfg())
    return Engine(model_cfg, narrow_params if params is None else params,
                  EngineConfig(**base), lora_manager=lora, eos_id=None,
                  dtype=dtype, device="cuda", mesh=mesh, cuda_graphs=graphs,
                  **kw)


@pytest.mark.parametrize("paged", [False, True], ids=["lanes", "paged"])
def test_tensor2_on_one_card_matches_tensor1_f32(narrow, paged):
    """At f32 the shards' reduction order is the only difference: greedy
    tokens equal tensor=1's, the graphed blocks replaying the shard loop,
    and each kernel launches once per shard per layer."""
    kw = dict(paged_kv_block=16, prefix_cache=True) if paged else {}
    want = _serve(_mesh_engine(narrow, 1, torch.float32, **kw), _jobs())
    eng = _mesh_engine(narrow, 2, torch.float32, **kw)
    f0 = fl.launches
    got = _serve(eng, _jobs())
    assert got == want
    assert eng._graphs.replays > 0
    n_layers = narrow[torch.float32][0].n_layers
    assert fl.launches - f0 == 2 * n_layers * len(_jobs())


def test_tensor2_graph_replay_matches_eager_bf16(narrow):
    got = _serve(_mesh_engine(narrow, 2, torch.bfloat16), _jobs())
    want = _serve(_mesh_engine(narrow, 2, torch.bfloat16, graphs=False),
                  _jobs())
    assert got == want


# ---------------------------------------------------------------------------
# Tensor parallelism across cards (shards on cuda:0 and cuda:1: the
# partials summed by single-process NCCL, the blocks eager)
# ---------------------------------------------------------------------------


def _cards(n: int) -> list:
    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} CUDA GPUs (mesh shards on distinct cards)")
    return [f"cuda:{i}" for i in range(n)]


def _narrow_moe_cfg():
    import dataclasses

    from llm_instance_gateway_tpu_torch.models.configs import MIXTRAL_8X7B

    return dataclasses.replace(MIXTRAL_8X7B, name="mixtral-narrow",
                               d_model=512, n_layers=2, n_heads=8,
                               n_kv_heads=2, head_dim=128, d_ff=512,
                               vocab_size=320, max_lora_slots=2,
                               max_lora_rank=8)


def _lora_weights(cfg, seed):
    import numpy as np

    from llm_instance_gateway_tpu_torch.models import lora as lora_lib

    rng = np.random.default_rng(seed)
    return {t: {"a": rng.standard_normal((cfg.n_layers, di, 8)) * 0.3,
                "b": rng.standard_normal((cfg.n_layers, 8, do)) * 0.3}
            for t, (di, do) in lora_lib.target_dims(cfg).items()}


@pytest.mark.parametrize("quant", [False, True], ids=["dense", "int8"])
@pytest.mark.parametrize("model", ["narrow", "moe"])
def test_sharded_forward_across_cards_equals_one_card(model, quant):
    """tensor=2 over two cards against tensor=2 on one card, f32 (int8
    weights and an int8 KV cache under ``int8``): prefill logits and KV,
    a lane decode step and a paged decode step, with LoRA slots.  A sum of
    two partials is the same sum whether NCCL or one device adds it, so
    the results are bitwise equal."""
    from llm_instance_gateway_tpu_torch.models import lora as lora_lib
    from llm_instance_gateway_tpu_torch.models import paged as paged_lib
    from llm_instance_gateway_tpu_torch.models import transformer
    from llm_instance_gateway_tpu_torch.ops.quant import quantize_params
    from llm_instance_gateway_tpu_torch.parallel import mesh, sharding

    cards = _cards(2)
    cfg = _narrow_moe_cfg() if model == "moe" else _narrow_cfg()
    f32 = torch.float32
    params = transformer.init_params(cfg, seed=3, dtype=f32, device="cuda")
    if quant:
        params = quantize_params(params)
    bufs = lora_lib.init_lora_buffers(cfg, dtype=f32, device="cuda")
    lora_lib.write_adapter(bufs, cfg, 0, _lora_weights(cfg, 1), 16.0, 8)
    b, s, lens = 3, 40, [40, 17, 29]
    gen = torch.Generator(device="cuda").manual_seed(11)
    tokens = torch.randint(0, cfg.vocab_size, (b, s), device="cuda",
                           generator=gen)
    positions = torch.arange(s, device="cuda")[None].expand(b, s)
    slot_ids = torch.tensor([0, -1, 0], dtype=torch.int32, device="cuda")
    step_tok = tokens[:, -1].clone()
    step_pos = torch.tensor(lens, device="cuda")
    outs = {}
    for where, devices in (("one card", ["cuda:0"] * 2), ("cards", cards)):
        tp = sharding.TensorParallel(cfg, mesh.make_mesh(
            mesh.MeshConfig(tensor=2), devices))
        sp, sl = sharding.shard_params(params, tp), sharding.shard_lora(
            bufs, tp)
        with torch.no_grad():
            logits, k, v = transformer.prefill(cfg, sp, tokens, positions,
                                               sl, slot_ids)
            got = [logits, k, v]
            for paged in (False, True):
                def make(c, d, paged=paged):
                    if paged:
                        return paged_lib.init_paged_cache(
                            c, b, 64, 12, 16, dtype=f32, device=d,
                            quantized=quant)
                    return transformer.init_decode_cache(
                        c, b, 64, dtype=f32, device=d, quantized=quant)
                cache = sharding.shard_cache(make, tp)
                for row in range(b):
                    kr, vr = k[:, row:row + 1], v[:, row:row + 1]
                    if paged:
                        blocks = [1 + 4 * row, 2 + 4 * row, 3 + 4 * row]
                        paged_lib.insert_prefill_paged(
                            cache, kr, vr, row, blocks, blocks + [0],
                            lens[row])
                    else:
                        transformer.insert_prefill(cache, kr, vr, row,
                                                   lens[row])
                step = (paged_lib.decode_step_paged if paged
                        else transformer.decode_step)
                got.append(step(cfg, sp, cache, step_tok, step_pos, sl,
                                slot_ids)[0])
                got.extend(c["k"] for c, _ in sharding.kv_parts(cache))
        outs[where] = [x.float().cpu() for x in got]
    for i, (a, w) in enumerate(zip(outs["cards"], outs["one card"])):
        assert a.shape == w.shape, i
        assert torch.equal(a, w), (i, (a - w).abs().max().item())
    assert outs["cards"][0].abs().max() > 0


@pytest.mark.parametrize("mode", ["lanes_lora", "paged_prefix", "spec",
                                  "grouped_pipelined", "int8"])
def test_tensor2_across_cards_matches_tensor1_f32(narrow, mode):
    """The engine with its two shards on two cards (eager blocks) serves
    tensor=1's greedy tokens at f32 in every serving mode, flash
    launching once per shard per layer."""
    from llm_instance_gateway_tpu_torch.ops.quant import quantize_params
    from llm_instance_gateway_tpu_torch.server.lora_manager import LoRAManager

    cards = _cards(2)
    cfg, f32_params = narrow[torch.float32]
    kw, jobs, adapter = {}, _jobs(), None
    if mode == "paged_prefix":
        kw = dict(paged_kv_block=16, prefix_cache=True, stream_lanes=2,
                  prefill_buckets=(16, 32))
        jobs = jobs + [(jobs[3][0] + [7, 8], 9, jobs[0][2])]
    elif mode == "spec":
        kw = dict(speculative_k=3, draft="small")
    elif mode == "grouped_pipelined":
        kw = dict(prefill_batch=3, pipeline_decode=True)
    elif mode == "int8":
        kw = dict(params=quantize_params(f32_params), kv_cache_quant="int8")
    streams, flash = {}, {}
    for t, devices in ((1, None), (2, cards)):
        lora = None
        if mode == "lanes_lora":
            lora = LoRAManager(cfg, dtype=torch.float32, device="cuda")
            lora.load("cards", weights=_lora_weights(cfg, 4), alpha=16.0,
                      rank=8)
            adapter = "cards"
        eng = _mesh_engine(narrow, t, torch.float32, graphs=t == 1,
                           devices=devices, lora=lora, **kw)
        if t == 2:
            assert not eng.tp.one_device and eng._graphs is None
            parts = list(eng.params)
            assert [p["layers"]["wo"]["q"].device if mode == "int8" else
                    p["layers"]["wo"].device for p in parts] == [
                torch.device(c) for c in cards]
        f0 = fl.launches
        streams[t] = _serve(eng, jobs, adapter=adapter)
        flash[t] = fl.launches - f0
    assert streams[2] == streams[1]
    # One flash program per request here; elsewhere grouping, prefix
    # reuse and the draft's prefills depend on admission timing.
    if mode in ("lanes_lora", "int8"):
        assert flash[2] == 2 * flash[1] == 2 * cfg.n_layers * len(jobs)


def test_hop_into_tensor2_across_cards_f32(narrow):
    """A tensor=1 prefill's handoff attached to a paged engine whose two
    shards sit on two cards: its heads scatter to the cards, and the
    tokens equal the collocated tensor=1 engine's."""
    from llm_instance_gateway_tpu_torch.server import kv_transfer
    from llm_instance_gateway_tpu_torch.server.engine import Request

    cards = _cards(2)
    prompt, n_new = _jobs()[3][0], 12
    pre = _mesh_engine(narrow, 1, torch.float32, role="prefill")
    dec = _mesh_engine(narrow, 2, torch.float32, graphs=False,
                       devices=cards, paged_kv_block=16, prefix_cache=True)
    pre.start()
    dec.start()
    try:
        wire = pre.prefill_only(Request(prompt_tokens=prompt,
                                        max_new_tokens=n_new)).to_bytes()
        req = dec.attach_prefilled(kv_transfer.PrefillHandoff.from_bytes(wire))
        assert req.done.wait(300) and req.error is None, req.error
    finally:
        pre.stop()
        dec.stop()
    want = _serve(_mesh_engine(narrow, 1, torch.float32),
                  [(prompt, n_new, _jobs()[0][2])])[0]
    assert req.output_tokens == want


def test_server_mesh_over_the_hosts_cards():
    """``--mesh tensor=N --no-cuda-graphs`` on a host with N cards (its
    shards on all of them by default) serves Gemma-2B, one KV head
    replicated on each card; without ``--no-cuda-graphs`` the server
    refuses by name."""
    from llm_instance_gateway_tpu_torch.server import api_http
    from llm_instance_gateway_tpu_torch.server.engine import Request

    _cards(2)
    n = torch.cuda.device_count()
    argv = ["--model", "gemma-2b", "--host", "127.0.0.1", "--port", "0",
            "--max-seq-len", "256", "--decode-slots", "2",
            "--prefill-buckets", "16", "64", "--mesh", f"tensor={n}"]
    with pytest.raises(ValueError, match="CUDA graphs across cards"):
        api_http.make_server(argv)
    httpd, eng, _ = api_http.make_server(argv + ["--no-cuda-graphs"])
    try:
        assert [str(d) for d in eng.mesh.devices] == [
            f"cuda:{i}" for i in range(n)]
        assert eng._graphs is None and not eng.tp.kv_split
        req = eng.generate(Request(prompt_tokens=[2, 9, 17, 33],
                                   max_new_tokens=6))
        assert req.error is None and len(req.output_tokens) == 6
    finally:
        httpd.server_close()
        eng.stop()


# ---------------------------------------------------------------------------
# The sequence and expert axes: one card (views) and across cards
# ---------------------------------------------------------------------------

_LONG = [256] + [65 + (11 * j) % 200 for j in range(149)]  # beyond 64


@pytest.mark.parametrize("paged", [False, True], ids=["lanes", "paged"])
def test_ring_on_one_card_matches_sequence1_f32(narrow, paged):
    """``sequence=2`` on cuda:0 (views): a 150-token prompt runs one ring
    program (padded to 192, no flash, no chunk) and the greedy tokens of
    sequence=1's chunk stream, at f32; the graphed decode after it."""
    from llm_instance_gateway_tpu_torch.ops import chunk_attention

    kw = dict(paged_kv_block=16, prefix_cache=True) if paged else {}
    jobs = [(_LONG, 12, _jobs()[0][2])] + _jobs()[:2]
    want = _serve_queued(_mesh_engine(narrow, 1, torch.float32, **kw), jobs)
    eng = _mesh_engine(narrow, 1, torch.float32, axes=dict(sequence=2),
                       **kw)
    ring, calls = eng._ring, []
    eng._ring = lambda *a, **k: calls.append(1) or ring(*a, **k)
    f0, c0 = fl.launches, chunk_attention.launches
    assert _serve_queued(eng, jobs) == want
    assert calls == [1] and chunk_attention.launches == c0
    n_layers = narrow[torch.float32][0].n_layers
    assert fl.launches - f0 == n_layers * 2  # the two bucketed prompts


@pytest.mark.parametrize("n", [2, 4])
def test_ring_prefill_across_cards_equals_one_card(narrow, n):
    """``make_sharded_prefill`` at ``sequence=n`` with block j on card j
    (the K/V rotated by copies) against the same mesh on one card: the
    logits and the KV bitwise equal, at f32 with LoRA rows."""
    from llm_instance_gateway_tpu_torch.models import lora as lora_lib
    from llm_instance_gateway_tpu_torch.parallel import (
        long_context,
        mesh,
        sharding,
    )

    cards = _cards(n)
    cfg, params = narrow[torch.float32]
    bufs = lora_lib.init_lora_buffers(cfg, dtype=torch.float32,
                                      device="cuda")
    lora_lib.write_adapter(bufs, cfg, 0, _lora_weights(cfg, 2), 16.0, 8)
    gen = torch.Generator(device="cuda").manual_seed(7)
    tokens = torch.randint(0, cfg.vocab_size, (2, 64 * n), device="cuda",
                           generator=gen)
    positions = torch.arange(64 * n, device="cuda")[None].expand(2, -1)
    slots = torch.tensor([0, -1], dtype=torch.int32, device="cuda")
    outs = {}
    for where, devices in (("one card", ["cuda:0"] * n), ("cards", cards)):
        m = mesh.make_mesh(mesh.MeshConfig(sequence=n), devices)
        grid = sharding.TensorParallel(cfg, m)
        with torch.no_grad():
            got = long_context.make_sharded_prefill(cfg, m)(
                sharding.shard_params(params, grid),
                *long_context.shard_inputs(m, tokens, positions),
                lora_bufs=sharding.shard_lora(bufs, grid), slot_ids=slots)
        outs[where] = [x.cpu() for x in got]
    for a, w in zip(outs["cards"], outs["one card"]):
        assert torch.equal(a, w), (a - w).abs().max().item()


@pytest.mark.parametrize("n", [2, 4])
def test_ring_engine_across_cards_matches_sequence1_f32(narrow, n):
    """An eager engine over ``sequence=n`` cards serves the long prompt
    through the ring with sequence=1's tokens (paged, prefix cache)."""
    cards = _cards(n)
    kw = dict(paged_kv_block=16, prefix_cache=True)
    jobs = [(_LONG, 12, _jobs()[0][2])] + _jobs()[:2]
    want = _serve_queued(_mesh_engine(narrow, 1, torch.float32, **kw), jobs)
    eng = _mesh_engine(narrow, 1, torch.float32, graphs=False,
                       devices=cards, axes=dict(sequence=n), **kw)
    assert not eng.tp.one_device and eng._ring_usable(len(_LONG))
    assert _serve_queued(eng, jobs) == want


def _narrow_moe(dtype=torch.float32):
    from llm_instance_gateway_tpu_torch.models import transformer

    cfg = _narrow_moe_cfg()
    return cfg, transformer.init_params(cfg, seed=3, dtype=dtype,
                                        device="cuda")


@pytest.mark.parametrize("n", [2, 4])
def test_expert_forward_across_cards_equals_one_card(n):
    """The narrow Mixtral at ``expert=n`` over n cards against the same
    mesh on one card, f32: prefill logits and KV, and a lane decode step.
    At n=2 the sum of two partials is the same sum on one card or over
    NCCL (bitwise); at n=4 NCCL may add four partials in another order,
    so the forward agrees to f32 rounding (1e-5 of the largest |logit|)."""
    from llm_instance_gateway_tpu_torch.models import transformer
    from llm_instance_gateway_tpu_torch.parallel import mesh, sharding

    cards = _cards(n)
    cfg, params = _narrow_moe()
    gen = torch.Generator(device="cuda").manual_seed(13)
    b, s = 2, 48
    tokens = torch.randint(0, cfg.vocab_size, (b, s), device="cuda",
                           generator=gen)
    positions = torch.arange(s, device="cuda")[None].expand(b, s)
    outs = {}
    for where, devices in (("one card", ["cuda:0"] * n), ("cards", cards)):
        grid = sharding.TensorParallel(cfg, mesh.make_mesh(
            mesh.MeshConfig(expert=n), devices))
        sp = sharding.shard_params(params, grid)
        with torch.no_grad():
            logits, k, v = transformer.prefill(cfg, sp, tokens, positions)
            cache = sharding.shard_cache(
                lambda c, d: transformer.init_decode_cache(
                    c, b, 64, dtype=torch.float32, device=d), grid)
            for row in range(b):
                transformer.insert_prefill(cache, k[:, row:row + 1],
                                           v[:, row:row + 1], row, s)
            step, _ = transformer.decode_step(
                cfg, sp, cache, tokens[:, -1].clone(),
                torch.full((b,), s, device="cuda"))
        outs[where] = [x.cpu() for x in (logits, k, v, step)]
    for a, w in zip(outs["cards"], outs["one card"]):
        if n == 2:
            assert torch.equal(a, w), (a - w).abs().max().item()
        else:
            err = (a - w).abs().max().item()
            assert err <= 1e-5 * max(1.0, w.abs().max().item()), err


@pytest.mark.parametrize("n", [2, 4])
def test_expert_engine_across_cards_matches_expert1_f32(narrow, n):
    """An eager engine over ``expert=n`` cards serves the narrow Mixtral's
    greedy tokens of expert=1, sixteen slots (the grouped decode with its
    exact fallback selected on the device)."""
    cards = _cards(n)
    cfg, params = _narrow_moe()
    kw = dict(model_cfg=cfg, params=params, decode_slots=16)
    jobs = _jobs()
    want = _serve_queued(_mesh_engine(narrow, 1, torch.float32, **kw), jobs)
    eng = _mesh_engine(narrow, 1, torch.float32, graphs=False,
                       devices=cards, axes=dict(expert=n), **kw)
    assert eng.tp.moe and eng.tp.local_experts == cfg.n_experts // n
    assert _serve_queued(eng, jobs) == want


# ---------------------------------------------------------------------------
# The data, fsdp and pipe axes: on one card (views) and across cards
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("axes", [dict(data=2), dict(data=2, tensor=2)],
                         ids=["d2", "d2t2"])
def test_data2_on_one_card_matches_data1_f32(narrow, axes):
    """Each data group decodes its rows: greedy tokens equal data=1's with
    the graphed blocks replaying both groups' loops, the lane kernel once
    per group (and tensor shard) per layer and step."""
    want = _serve_queued(_mesh_engine(narrow, 1, torch.float32), _jobs())
    eng = _mesh_engine(narrow, 1, torch.float32, axes=axes)
    eng.start()  # the warm-up step runs here, before the window
    try:
        d0 = dec.launches
        got = _serve_running(eng, _jobs())
    finally:
        eng.stop()
    assert got == want and eng._graphs.replays > 0
    steps = int(eng.metrics_snapshot()["dispatch_steps_hist"]["sum"])
    n_layers = narrow[torch.float32][0].n_layers
    assert dec.launches - d0 == steps * n_layers * 2 * axes.get("tensor", 1)


@pytest.mark.parametrize("paged", [False, True], ids=["lanes", "paged"])
def test_fsdp2_on_one_card_matches_fsdp1(narrow, paged):
    """fsdp=2 gathers the same values in the same shapes: greedy tokens
    equal fsdp=1's in bf16, the gathers replaying inside the graphs."""
    kw = dict(paged_kv_block=16, prefix_cache=True) if paged else {}
    want = _serve_queued(_mesh_engine(narrow, 1, torch.bfloat16, **kw),
                         _jobs())
    eng = _mesh_engine(narrow, 1, torch.bfloat16, axes=dict(fsdp=2), **kw)
    assert _serve_queued(eng, _jobs()) == want and eng._graphs.replays > 0


def test_pipeline_step_on_one_card_launches_per_live_pair(narrow):
    """A pipelined bf16 train step (pipe=2, M=2, both stages on cuda:0):
    the training forward and the backward kernel launch exactly L x M
    times, and the loss equals the unpipelined step's within bf16."""
    from llm_instance_gateway_tpu_torch.models import transformer
    from llm_instance_gateway_tpu_torch.parallel import mesh, pipeline
    from llm_instance_gateway_tpu_torch.training import train

    cfg = narrow[torch.bfloat16][0]
    gen = torch.Generator(device="cuda").manual_seed(3)
    tokens = torch.randint(0, cfg.vocab_size, (2, 129), device="cuda",
                           generator=gen)
    positions = torch.arange(129, device="cuda")[None].expand(2, 129)
    m = mesh.make_mesh(mesh.MeshConfig(pipe=2), ["cuda:0", "cuda:0"])
    staged = pipeline.stage_param_specs(cfg, pipeline.stage_params(
        cfg, transformer.init_params(cfg, seed=5, device="cuda"), 2), m)
    opt = train.make_optimizer(staged, lr=1e-3)
    f0, b0 = fl.launches, fl.backward_launches
    _, _, loss = pipeline.make_pipeline_train_step(cfg, opt, 2, 2, m)(
        staged, None, tokens, positions)
    torch.cuda.synchronize()
    assert fl.launches - f0 == cfg.n_layers * 2
    assert fl.backward_launches - b0 == cfg.n_layers * 2
    plain = transformer.init_params(cfg, seed=5, device="cuda")
    _, _, want = train.make_full_train_step(cfg, train.make_optimizer(
        plain, lr=1e-3))(plain, None, tokens, positions)
    assert abs(loss.item() - want.item()) <= 1e-2 * abs(want.item())


def test_data2_across_cards_matches_data1_f32(narrow):
    """``data=2`` over two cards (eager): each group's rows on its card,
    greedy tokens equal to data=1's, an adapter row and a chunk stream
    included."""
    from llm_instance_gateway_tpu_torch.parallel import sharding
    from llm_instance_gateway_tpu_torch.server.lora_manager import LoRAManager

    cards = _cards(2)
    cfg = narrow[torch.float32][0]
    jobs = _jobs() + [(_LONG, 8, _jobs()[0][2])]
    out = {}
    for axes, devices in ((None, None), (dict(data=2), cards)):
        lora = LoRAManager(cfg, dtype=torch.float32, device="cuda")
        lora.load("cards", weights=_lora_weights(cfg, 4), alpha=16.0, rank=8)
        eng = _mesh_engine(narrow, 1, torch.float32, graphs=axes is None,
                           devices=devices, axes=axes, lora=lora,
                           stream_lanes=2)
        if axes:
            assert [sharding.parts(c)[0]["k"].device
                    for c in eng.cache.data] == [
                torch.device(c) for c in cards]
        out[str(axes)] = _serve_queued(eng, jobs,
                                       ["cards", None] * 3)
    assert out["{'data': 2}"] == out["None"]


@pytest.mark.parametrize("n,paged", [(2, False), (4, False), (2, True)],
                         ids=["f2-lanes", "f4-lanes", "f2-paged"])
def test_fsdp_across_cards_matches_one_card_f32(narrow, n, paged):
    """``fsdp=n`` over n cards (eager; each layer's pieces gathered by one
    NCCL all-gather, issued a layer ahead on a side stream): the forward
    bitwise fsdp=1's, and the engine's greedy tokens equal."""
    from llm_instance_gateway_tpu_torch.models import transformer
    from llm_instance_gateway_tpu_torch.parallel import mesh, sharding

    cards = _cards(n)
    cfg, params = narrow[torch.float32]
    grid = sharding.TensorParallel(cfg, mesh.make_mesh(
        mesh.MeshConfig(fsdp=n), cards))
    sp = sharding.shard_params(params, grid)
    assert [p.device for p in sp[0]["layers"]["wq"].pieces] == [
        torch.device(c) for c in cards]
    tokens = torch.randint(0, cfg.vocab_size, (2, 40), device="cuda")
    positions = torch.arange(40, device="cuda")[None].expand(2, 40)
    with torch.no_grad():
        got = transformer.prefill(cfg, sp, tokens, positions)[0]
        want = transformer.prefill(cfg, params, tokens, positions)[0]
    assert torch.equal(got, want)
    kw = dict(paged_kv_block=16, prefix_cache=True) if paged else {}
    ref = _serve_queued(_mesh_engine(narrow, 1, torch.float32, **kw),
                        _jobs())
    eng = _mesh_engine(narrow, 1, torch.float32, graphs=False, devices=cards,
                       axes=dict(fsdp=n), **kw)
    assert _serve_queued(eng, _jobs()) == ref


def test_pipe4_full_8b_steps_across_cards():
    """Ten full-parameter AdamW steps of the whole 32-layer Llama-3-8B at
    ``pipe=4``, one stage a card (M=4 microbatches of one 1024-token row):
    the loss falls, each step launches flash and the backward exactly L x
    M times; prints (``[pipe4]``) peak memory per card, step walls and
    the profiled step's device ms per card."""
    import json
    import time

    from torch.profiler import ProfilerActivity, profile

    from llm_instance_gateway_tpu_torch.models import transformer
    from llm_instance_gateway_tpu_torch.models.configs import LLAMA3_8B
    from llm_instance_gateway_tpu_torch.parallel import mesh, pipeline
    from llm_instance_gateway_tpu_torch.training import train

    cards = _cards(4)
    cfg, m_micro, s = LLAMA3_8B, 4, 1024
    m = mesh.make_mesh(mesh.MeshConfig(pipe=4), cards)
    params = transformer.init_params(cfg, seed=17, device="cuda:0")
    staged = pipeline.stage_param_specs(
        cfg, pipeline.stage_params(cfg, params, 4), m)
    del params
    torch.cuda.empty_cache()
    for c in cards:
        torch.cuda.reset_peak_memory_stats(c)
    gen = torch.Generator(device="cuda").manual_seed(18)
    tokens = torch.randint(0, cfg.vocab_size, (m_micro, s), device="cuda:0",
                           generator=gen)
    positions = torch.arange(s, device="cuda:0")[None].expand(m_micro, s)
    opt = train.make_optimizer(staged, lr=1e-4)
    step = pipeline.make_pipeline_train_step(cfg, opt, 4, m_micro, m)
    losses, walls = [], []
    for i in range(10):
        f0, b0 = fl.launches, fl.backward_launches
        t0 = time.perf_counter()
        if i == 9:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                staged, _, loss = step(staged, None, tokens, positions)
                for c in cards:
                    torch.cuda.synchronize(c)
        else:
            staged, _, loss = step(staged, None, tokens, positions)
        losses.append(loss.item())
        for c in cards:
            torch.cuda.synchronize(c)
        walls.append(time.perf_counter() - t0)
        assert fl.launches - f0 == cfg.n_layers * m_micro
        assert fl.backward_launches - b0 == cfg.n_layers * m_micro
    device_ms = {}
    for ev in prof.events():
        # Kernels only: a range on the device's timeline (the optimizer's
        # step) spans kernels counted on their own.
        if (ev.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(ev, "is_user_annotation", False)):
            key = f"cuda:{ev.device_index}"
            device_ms[key] = device_ms.get(key, 0.0) + (
                ev.self_device_time_total / 1e3)
    out = {"losses": losses, "step_wall_s": walls,
           "profiled_step_device_ms_per_card": device_ms,
           "peak_mem_gb_per_card": {
               c: torch.cuda.max_memory_allocated(c) / 1e9 for c in cards},
           "cards": [torch.cuda.get_device_name(i) for i in range(4)]}
    print("[pipe4] " + json.dumps(out), flush=True)
    assert all(math.isfinite(x) for x in losses)
    assert losses[-1] < losses[0]


# ---------------------------------------------------------------------------
# one process a card (parallel/mesh.initialize_distributed, NCCL)
# ---------------------------------------------------------------------------

# Each of n processes holds one card (cuda:{rank}) and its shard; the
# collectives between them run over NCCL (parallel/collectives.py).
PROCESSES_WORKER = r"""
import dataclasses, json, math, os, sys, time
sys.path.insert(0, os.environ["GRAFT_REPO"])
import torch
from llm_instance_gateway_tpu_torch.models import lora, transformer
from llm_instance_gateway_tpu_torch.models.configs import LLAMA3_8B
from llm_instance_gateway_tpu_torch.ops import flash_attention as fl
from llm_instance_gateway_tpu_torch.parallel import multihost_check, sharding
from llm_instance_gateway_tpu_torch.parallel.mesh import (
    initialize_distributed, make_mesh, parse_axes, world)
from llm_instance_gateway_tpu_torch.server.engine import (
    Engine, EngineConfig, Request, SamplingParams)
from llm_instance_gateway_tpu_torch.training import train

initialize_distributed()
rank, size = world()
dev = torch.device("cuda", rank)
torch.cuda.set_device(dev)
case = os.environ["GRAFT_CASE"]
mesh = make_mesh(parse_axes(os.environ["GRAFT_MESH"]), [str(dev)])
out = {"rank": rank, "card": torch.cuda.get_device_name(dev),
       "backend": sorted({g.backend for g in mesh.groups.values()})}
if case == "serve":
    cfg = dataclasses.replace(LLAMA3_8B, **json.loads(os.environ["GRAFT_CFG"]))
    eng = Engine(cfg, multihost_check.load_tree(os.environ["GRAFT_WEIGHTS"],
                                                dev),
                 EngineConfig(decode_slots=4, max_seq_len=256,
                              prefill_buckets=(16, 64),
                              decode_steps_per_sync=4),
                 eos_id=None, dtype=torch.float32, device=dev, mesh=mesh,
                 cuda_graphs=False)
    reqs = [Request(prompt_tokens=p, max_new_tokens=m,
                    sampling=SamplingParams(temperature=0.0))
            for p, m in json.loads(os.environ["GRAFT_JOBS"])]
    rings = []
    if eng._ring is not None:
        ring = eng._ring
        eng._ring = lambda *a, **kw: rings.append(1) or ring(*a, **kw)
    for r in reqs:
        eng.submit(r)
    eng.start()
    try:
        for r in reqs:
            assert r.done.wait(300) and r.error is None, r.error
    finally:
        eng.stop()
    out["tokens"] = [list(r.output_tokens) for r in reqs]
    out["ring_programs"] = len(rings)
elif case == "ring8b":  # Llama-3-8B's ring prefill of a 6001-token prompt
    from llm_instance_gateway_tpu_torch.parallel import collectives, long_context
    from torch.profiler import ProfilerActivity, profile
    cfg = LLAMA3_8B
    tp = sharding.TensorParallel(cfg, mesh)
    full = transformer.init_params(cfg, seed=17, device=dev)
    params = sharding.shard_params(full, tp)
    del full
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(18)
    n, padded = 6001, 6144
    tokens = torch.zeros((1, padded), dtype=torch.long, device=dev)
    tokens[0, :n] = torch.randint(1, cfg.vocab_size, (n,), device=dev,
                                  generator=gen)
    blocks = long_context.shard_inputs(
        mesh, tokens, torch.arange(padded, device=dev)[None])
    fn = long_context.make_sharded_prefill(cfg, mesh)

    def ring():
        with torch.no_grad():
            logits = fn(params, *blocks)[0]
            return long_context.logits_row(params, logits, n - 1)

    ring()
    torch.distributed.barrier()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    row = ring()
    torch.cuda.synchronize(dev)
    out["wall_ms"] = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ring()
        torch.cuda.synchronize(dev)
    us = sum(getattr(e, "self_device_time_total", 0.0)
             for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    out["device_ms"] = us / 1e3 if us else "not measured"
    gathered = []
    plain = collectives._all_gather
    collectives._all_gather = lambda x, a, g: (
        lambda y: gathered.append(y.numel() * y.element_size()) or y)(
        plain(x, a, g))
    ring()
    collectives._all_gather = plain
    out["exchange_gathered_bytes"] = sum(gathered)
    out["row_finite"] = bool(torch.isfinite(row).all())
    out["argmax"] = int(row[0, :cfg.vocab_size].argmax())
elif case == "moe":  # ten LoRA steps on Mixtral-8x7B at full depth
    from llm_instance_gateway_tpu_torch.models.configs import MIXTRAL_8X7B
    cfg = MIXTRAL_8X7B
    tp = sharding.TensorParallel(cfg, mesh)
    # A process's shard built a layer at a time (the whole bf16 tree is
    # ~93 GB): each layer drawn whole from its own seed, sharded, and
    # copied into this process's stacks.
    one_cfg = dataclasses.replace(cfg, n_layers=1)
    one_tp = sharding.TensorParallel(one_cfg, mesh)
    tree = None
    for i in range(cfg.n_layers):
        layer = sharding.shard_params(transformer.init_params(
            one_cfg, seed=100 + i, device=dev), one_tp)[0]
        if tree is None:
            tree = {k: v for k, v in layer.items() if k != "layers"}
            tree["layers"] = {k: torch.empty((cfg.n_layers,) + v.shape[1:],
                                             dtype=v.dtype, device=dev)
                              for k, v in layer["layers"].items()}
        for k, v in layer["layers"].items():
            tree["layers"][k][i] = v[0]
        del layer
        torch.cuda.empty_cache()
    params = sharding.Shards([tree], tp)
    out["param_gb"] = sum(v.numel() * v.element_size() for v in (
        list(tree["layers"].values())
        + [v for k, v in tree.items() if k != "layers"])) / 1e9
    gen = torch.Generator(device=dev).manual_seed(18)
else:  # ten Llama-3-8B steps: "lora" (rank 8) or "full"
    cfg = LLAMA3_8B
    tp = sharding.TensorParallel(cfg, mesh)
    full = transformer.init_params(cfg, seed=17, device=dev)
    params = sharding.shard_params(full, tp)
    del full
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(18)
if case in ("lora", "full", "moe"):
    tokens = torch.randint(0, cfg.vocab_size, (2, 1024), device=dev,
                           generator=gen)
    positions = torch.arange(1024, device=dev).repeat(2, 1)
    if case in ("lora", "moe"):
        bufs = lora.init_lora_buffers(cfg, torch.bfloat16, dev)
        for t, (d_in, _d_out) in lora.target_dims(cfg).items():
            bufs[f"{t}_a"][:, 0, :, :8] = (torch.randn(
                (cfg.n_layers, d_in, 8), device=dev, generator=gen)
                / math.sqrt(d_in)).to(torch.bfloat16)
        bufs["scale"][0] = 2.0
        bufs = sharding.shard_lora(bufs, tp)
        opt = train.make_optimizer(bufs, lr=1e-3)
        step = train.make_lora_train_step(cfg, opt)
        slots = torch.zeros(2, dtype=torch.int32, device=dev)

        def run():
            return step(params, bufs, opt.state, tokens, positions, slots)[2]
    else:
        opt = train.make_optimizer(params, lr=1e-4)
        step = train.make_full_train_step(cfg, opt)

        def run():
            return step(params, opt.state, tokens, positions)[2]
    torch.cuda.reset_peak_memory_stats(dev)
    losses, walls = [], []
    f0, b0 = fl.launches, fl.backward_launches
    for _ in range(10):
        t0 = time.perf_counter()
        losses.append(run().item())
        torch.cuda.synchronize(dev)
        walls.append(time.perf_counter() - t0)
    out.update(losses=losses, step_wall_s=walls,
               peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
               flash_launches=fl.launches - f0,
               backward_launches=fl.backward_launches - b0)
print("[processes] " + json.dumps(out), flush=True)
"""


def _processes(n: int, case: str, axes: str, env=None) -> list:
    """The worker's result per process, ``n`` processes one card each."""
    import json

    from llm_instance_gateway_tpu_torch.parallel import multihost_check

    outs = multihost_check.run_processes(
        PROCESSES_WORKER, n, n_local=1, timeout_s=600,
        env={"GRAFT_CASE": case, "GRAFT_MESH": axes, **(env or {})})
    return [json.loads(line.split(" ", 1)[1])
            for line in multihost_check.ok_lines(outs, "[processes] ")]


@pytest.mark.parametrize("axes", ["tensor=4", "fsdp=2,tensor=2",
                                  "sequence=2", "tensor=2,sequence=2"])
def test_processes_serve_as_one_process_across_cards(narrow, tmp_path, axes):
    """One process a card (four, or two at sequence=2), NCCL between them,
    the narrow f32 model with four KV heads (so tensor=4 splits them) at
    ``axes``: every process reads back the greedy tokens of the
    one-process engine that drives the same mesh over the cards; over
    ``sequence`` a prompt beyond the largest bucket runs one ring program
    a process, its K/V exchanged between the cards."""
    import dataclasses
    import json

    from llm_instance_gateway_tpu_torch.models import transformer
    from llm_instance_gateway_tpu_torch.parallel import mesh, multihost_check

    mesh_cfg = mesh.parse_axes(axes)
    cards = _cards(mesh_cfg.total)
    cfg = dataclasses.replace(narrow[torch.float32][0], n_kv_heads=4)
    params = transformer.init_params(cfg, seed=6, dtype=torch.float32,
                                     device="cuda")
    weights = str(tmp_path / "weights.npz")
    multihost_check.save_tree(weights, params)
    jobs = _jobs()
    if mesh_cfg.sequence > 1:
        jobs = [(_LONG, 12, jobs[0][2])] + jobs
    ref = _serve_queued(_mesh_engine(
        narrow, 1, torch.float32, graphs=False, devices=cards,
        params=params, model_cfg=cfg,
        axes={k: int(v) for k, v in dataclasses.asdict(
            mesh.parse_axes(axes)).items() if int(v) > 1}), jobs)
    fields = {k: getattr(cfg, k) for k in (
        "name", "d_model", "n_layers", "n_heads", "n_kv_heads", "head_dim",
        "d_ff", "vocab_size", "max_lora_slots", "max_lora_rank")}
    res = _processes(mesh_cfg.total, "serve", axes, {
        "GRAFT_CFG": json.dumps(fields), "GRAFT_WEIGHTS": weights,
        "GRAFT_JOBS": json.dumps([[p, m] for p, m, _ in jobs])})
    assert all(r["backend"] == ["nccl"] for r in res), res
    for r in res:
        assert r["tokens"] == [list(t) for t in ref], (r["rank"], axes)
        assert r["ring_programs"] == int(mesh_cfg.sequence > 1), r


@pytest.mark.parametrize("case,axes", [("lora", "data=2,tensor=2"),
                                       ("full", "fsdp=4"),
                                       ("lora", "data=2,sequence=2"),
                                       ("moe", "expert=4")])
def test_processes_8b_steps_across_cards(case, axes):
    """Ten steps (two 1024-token rows, bf16) across four processes, one
    card each: the rank-8 LoRA step of Llama-3-8B at data=2,tensor=2 and
    at data=2,sequence=2 (each process 512 positions of a row, the ring's
    K/V exchanged), the full-parameter step of the whole 32-layer model at
    fsdp=4 (it does not fit one card), and the LoRA step of Mixtral-8x7B
    at full depth over expert=4 (two experts a card, each process's
    shard built a layer at a time).  The loss falls and is the same on
    every process; flash and its backward launch once per layer per step
    on each, none on the sequence route (the ring's attention is torch
    ops); prints (``[processes4]``) losses, step walls and peak memory
    per card."""
    import json

    from llm_instance_gateway_tpu_torch.models.configs import LLAMA3_8B

    _cards(4)
    res = _processes(4, case, axes)
    print("[processes4] " + json.dumps({"case": case, "axes": axes,
                                        "ranks": res}), flush=True)
    losses = [r["losses"] for r in res]
    assert all(x == losses[0] for x in losses), losses
    assert all(math.isfinite(x) for x in losses[0])
    assert losses[0][-1] < losses[0][0], losses[0]
    per_step = 0 if "sequence" in axes else LLAMA3_8B.n_layers
    for r in res:
        assert r["backend"] == ["nccl"]
        assert r["flash_launches"] == 10 * per_step
        assert r["backward_launches"] == 10 * per_step


def test_processes_ring_8b_sequence4_across_cards():
    """Llama-3-8B's ring prefill of a 6001-token prompt (padded to 6144)
    at sequence=4, one process a card (1536 positions each, the K/V
    exchanged over NCCL): the last real position's logits the same on
    every card; prints (``[processes4]``) the ring's wall and device ms
    and the exchange's gathered bytes per card."""
    import json

    _cards(4)
    res = _processes(4, "ring8b", "sequence=4")
    print("[processes4] " + json.dumps({"case": "ring8b",
                                        "axes": "sequence=4",
                                        "ranks": res}), flush=True)
    assert all(r["backend"] == ["nccl"] and r["row_finite"] for r in res)
    assert len({r["argmax"] for r in res}) == 1, res
