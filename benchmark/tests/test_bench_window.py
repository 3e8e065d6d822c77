"""The reduction from what a window saw to metrics: percentiles over every
request, rates over the whole window, and the operation and byte counts
against hand-computed ones at small shapes."""
import pytest

from benchmark import roofline, spec
from benchmark.client import Record
from benchmark.trace import Trace
from benchmark.window import Window, nearest_rank

M = {"d": 8, "f": 16, "L": 2, "H": 2, "K": 1, "hd": 4, "V": 10, "E": 0,
     "k_experts": 0}


def read(name, w):
    return spec.metric_reader(name)(w)


def rec(i, due, first=None, done=None, emit=(), prompt=4, error=None,
        prefix=-1, adapter=-1, start=None):
    r = Record(index=i, prefix=prefix, shared=0, prompt=[1] * prompt,
               adapter=adapter, greedy=True, max_new_tokens=len(emit),
               due=due, error=error)
    r.t_first_token = first or 0.0
    r.t_prefill_start = start or (first or 0.0)
    r.t_done = done or 0.0
    r.emit = list(emit)
    r.tokens = [0] * len(emit)
    r.finished = done is not None and error is None
    return r


def test_nearest_rank():
    vals = list(range(1, 11))
    assert nearest_rank(vals, 0.9) == 9
    assert nearest_rank(vals, 0.5) == 5
    assert nearest_rank([3.0], 0.9) == 3.0


def test_ttft_counts_every_request_and_failures():
    recs = [rec(i, 100.0 + i, first=100.0 + i + 0.1 * (i + 1))
            for i in range(9)]
    recs.append(rec(9, 109.0, error="refused"))
    w = Window(t0=100.0, seconds=10.0, records=recs, m=M, loop="open",
               deadline=130.0)
    # Nine answered 0.1 .. 0.9 s after due; the refused one waited 21 s:
    # the 90th percentile of ten is the ninth, 0.9 s.
    assert read("ttft_p90_ms", w) == pytest.approx(900.0)
    recs[0].error = "refused"
    assert read("ttft_p90_ms", w) == pytest.approx(21000.0)


def test_tpot_and_rate_over_the_window():
    a = rec(0, 100.0, first=100.5, done=101.5, emit=[100.5, 101.0, 101.5])
    b = rec(1, 100.0, first=100.2, done=109.0, emit=[100.2, 109.0, 111.0])
    w = Window(t0=100.0, seconds=10.0, records=[a, b], m=M, loop="open",
               deadline=120.0)
    assert read("tpot_p90_ms", w) == pytest.approx(4400.0)
    # Five of the six tokens fall inside [100, 110).
    assert read("output_tok_per_s", w) == pytest.approx(0.5)


def test_mfu_counts_prefill_and_decode():
    body = M["L"] * (2 * 8 * 8 + 2 * 8 * 4 + 3 * 8 * 16)
    assert roofline.body_params_per_token(M) == body
    # A prompt of 4 (no reuse) and its tokens 1 and 2 (contexts 5 and 6).
    r = rec(0, 100.0, first=100.1, emit=[100.1, 100.2, 100.3])
    w = Window(t0=100.0, seconds=1.0, records=[r], m=M, loop="closed",
               deadline=101.0)
    attn = 4 * M["L"] * M["H"] * M["hd"]
    pre = 2 * body * 4 + 2 * 8 * 10 + attn * (1 + 2 + 3 + 4)
    dec = 2 * (2 * (body + 8 * 10)) + attn * (5 + 6)
    assert w.model_flops(100.0, 101.0) == pytest.approx(pre + dec)
    assert read("mfu.batch", w) == pytest.approx(
        (pre + dec) / roofline.BF16_FLOPS * 100)


def test_moe_counts_two_experts():
    m = dict(M, E=4, k_experts=2)
    attn = 2 * 8 * 8 + 2 * 8 * 4
    assert roofline.body_params_per_token(m) == \
        2 * (attn + 2 * 3 * 8 * 16 + 8 * 4)


def test_decode_roofline_and_idle_from_the_trace():
    r = rec(0, 100.0, first=100.0, emit=[100.0, 100.5, 101.5, 102.5],
            prompt=10)
    tr = Trace(a=101.0, b=103.0, kernels=[
        ("void decode_tile::split_kernel<bf16, bf16, 4, true>()", 101.2,
         0.5),
        ("void decode_tile::combine_kernel<bf16, 4>()", 102.0, 0.25),
        ("gemm", 101.7, 0.4), ("gemm", 102.9, 0.5)])
    w = Window(t0=100.0, seconds=4.0, records=[r], m=M, loop="closed",
               deadline=104.0, trace=tr)
    # Tokens 2 and 3 (contexts 12 and 13) fall in the slice.
    need = roofline.kv_bytes(M, 12) + roofline.kv_bytes(M, 13)
    assert need == 2 * 2 * 1 * 4 * 2 * 25
    assert read("decode_attn_roofline", w) == pytest.approx(
        need / roofline.HBM_BYTES_PER_S / 0.75 * 100)
    # Busy: [101.2, 101.7] + [101.7, 102.1] + [102.0 .. 102.25 inside]
    # + [102.9, 103.0] = 0.5 + 0.4 + 0.15 + 0.1.
    assert tr.busy_s() == pytest.approx(1.15)
    assert read("device_idle.batch", w) == pytest.approx(
        (2.0 - 1.15) / 2.0 * 100)
    assert read("decode_attn_roofline", Window(
        t0=100.0, seconds=4.0, records=[r], m=M, loop="closed",
        deadline=104.0)) is None


def test_decode_blocks_from_dispatch_records():
    w = Window(t0=0.0, seconds=1.0, records=[], m=M, loop="closed",
               deadline=1.0)
    # (seq, phase, wall, gap, kind, active, slots, n_steps, churn)
    w.dispatches = [(1, "decode", 0.08, 0, "", 4, 8, 8, 0),
                    (2, "prefill", 0.5, 0, "", 1, 8, 100, 0),
                    (3, "decode", 0.02, 0, "", 2, 8, 2, 0)]
    assert read("decode_step_ms.batch", w) == pytest.approx(100.0 / 10)
    assert read("decode_rows_mean", w) == pytest.approx((32 + 4) / 10)


def test_prefix_hit_share():
    r = rec(0, 100.0, first=100.5, start=100.1, prompt=100)
    w = Window(t0=100.0, seconds=1.0, records=[r], m=M, loop="open",
               deadline=101.0, snap0={"prefix_reused_tokens": 10},
               snap1={"prefix_reused_tokens": 74})
    assert read("prefix_hit_share", w) == pytest.approx(64.0)
