"""The capacity twin's calibration over the torch engine, held to the JAX
package's ``sim/calibrate.py``.

- Same times, same constants: both packages' ``_time_call`` patched with
  one deterministic queue of times, the port's ``calibrate_from_engine``
  (over a tiny CPU torch engine) and the reference's (over a stand-in
  carrying only the engine fields it reads: with ``_time_call`` patched
  its closures never run, so no JAX program compiles) return the same six
  constants, to 1e-12.
- Real times on a tiny CPU engine: positive constants that construct the
  reference's ``LatencyModel``, and an engine that serves on afterwards.
- The artifact the port's ``main`` writes loads through the reference's
  ``load_calibration`` unchanged.
"""

import dataclasses
import json
import types

import numpy as np
import pytest

from llm_instance_gateway_tpu.sim import calibrate as jcal
from llm_instance_gateway_tpu.sim.core import LatencyModel

torch = pytest.importorskip("torch")

from llm_instance_gateway_tpu_torch.models import transformer  # noqa: E402
from llm_instance_gateway_tpu_torch.models.configs import TINY_TEST  # noqa: E402
from llm_instance_gateway_tpu_torch.server import engine as teng  # noqa: E402
from llm_instance_gateway_tpu_torch.sim import calibrate as tcal  # noqa: E402

KEYS = ("prefill_min_s", "prefill_base_s", "prefill_per_token_s",
        "decode_base_s", "decode_per_kv_token_s", "decode_per_seq_s")


def tiny_engine(**overrides):
    ecfg = dict(decode_slots=4, max_seq_len=512,
                prefill_buckets=(32, 64, 128, 256, 384),
                decode_steps_per_sync=2)
    ecfg.update(overrides)
    params = transformer.init_params(TINY_TEST, seed=0, dtype=torch.float32,
                                     device="cpu")
    return teng.Engine(TINY_TEST, params, teng.EngineConfig(**ecfg),
                       dtype=torch.float32, device="cpu")


def stand_in(engine):
    """The fields the reference's ``calibrate_from_engine`` reads outside
    its timed closures."""
    return types.SimpleNamespace(model_cfg=engine.model_cfg, cfg=engine.cfg,
                                 params=None, cache=None)


def queue_timer(times):
    it = iter(list(times))

    def fake(fn, n=5):
        return next(it)

    return fake


@pytest.mark.parametrize("case", [
    # (engine overrides, prefill lengths, decode fills, times)
    ({}, (64, 128, 256, 384), (32, 128, 256, 448),
     [0.011, 0.0135, 0.019, 0.0251, 0.0041, 0.0046, 0.0052, 0.0061]),
    ({"max_seq_len": 200, "prefill_buckets": (16, 64, 128)},
     (64, 128, 256, 384), (32, 128, 256, 448),
     [0.02, 0.01, 0.003, 0.0029]),  # falling lines hit the clamps
    ({"prefill_buckets": (16, 32)}, (64, 128), (32,),
     [0.007, 0.004]),  # one bucket, one fill: the fallbacks
])
def test_same_times_same_constants(monkeypatch, case):
    overrides, lengths, fills, times = case
    engine = tiny_engine(**overrides)
    monkeypatch.setattr(tcal, "_time_call", queue_timer(times))
    got = tcal.calibrate_from_engine(engine, lengths, fills, repeats=3)
    monkeypatch.setattr(jcal, "_time_call", queue_timer(times))
    want = jcal.calibrate_from_engine(stand_in(engine), lengths, fills,
                                      repeats=3)
    assert tuple(got) == KEYS
    for k in KEYS:
        assert abs(got[k] - getattr(want, k)) <= 1e-12, k


def test_fit_is_the_reference_arithmetic():
    rng = np.random.default_rng(0)
    pre = [(t, 1e-3 + 2e-6 * t + rng.uniform(0, 1e-4))
           for t in (64, 128, 256, 384)]
    dec = [(4.0 * f, 4e-3 + 3e-8 * 4 * f + rng.uniform(0, 1e-5))
           for f in (32, 128, 256, 448)]
    got = tcal.fit(pre, dec, 4)
    c1, c0 = np.polyfit([x for x, _ in pre], [y for _, y in pre], 1)
    c4, c3 = np.polyfit([x for x, _ in dec], [y for _, y in dec], 1)
    assert got["prefill_base_s"] == max(float(c0), 1e-4)
    assert got["prefill_per_token_s"] == max(float(c1), 1e-7)
    assert got["decode_base_s"] == max(float(c3), 1e-5) / 2
    assert got["decode_per_seq_s"] == max(float(c3), 1e-5) / 2 / 4
    assert got["decode_per_kv_token_s"] == max(float(c4), 0.0)
    assert got["prefill_min_s"] == min(y for _, y in pre)


def test_real_times_on_a_tiny_engine():
    engine = tiny_engine(prefill_buckets=(32, 64, 128), max_seq_len=256)
    got = tcal.calibrate_from_engine(engine, (32, 64, 128), (32, 128),
                                     repeats=2)
    assert all(got[k] > 0 for k in KEYS if k != "decode_per_kv_token_s")
    assert got["decode_per_kv_token_s"] >= 0
    model = LatencyModel(**got)
    assert model.prefill_s(64) > 0 and model.decode_s(1000, 4) > 0
    # The carry is back as it was: no row decodes, and the engine serves.
    assert not engine._slot_remaining.any()
    assert not engine._dev["remaining"].any()
    engine.start()
    try:
        req = engine.generate(teng.Request(prompt_tokens=[1, 2, 3],
                                           max_new_tokens=4))
    finally:
        engine.stop()
    assert req.error is None and len(req.output_tokens) == 4


def test_reference_loads_the_ports_artifact(tmp_path, monkeypatch):
    monkeypatch.setattr(tcal, "_time_call", queue_timer(
        [0.011, 0.0135, 0.019, 0.0041, 0.0046, 0.0052]))
    out = tmp_path / "calibration.json"
    tcal.main(["--device", "cpu", "--out", str(out)])
    model, art = jcal.load_calibration(str(out))
    assert art["format"] == jcal.CALIBRATION_FORMAT
    assert art["source"] == "engine:bench-cpu"
    assert art["residuals"] == {"windows": 0,
                                "note": "engine-timed fit, no residuals"}
    assert list(tcal.model_to_dict(art["model"])) == list(jcal._MODEL_ROUND)
    # The reference's rounding and serialization, byte for byte.
    ref_model = LatencyModel(**{k: art["model"][k] for k in KEYS})
    ref_path = tmp_path / "reference.json"
    jcal.write_calibration(str(ref_path), jcal.calibration_artifact(
        ref_model, art["residuals"], art["source"]))
    assert out.read_bytes() == ref_path.read_bytes()
    assert dataclasses.asdict(model) == dataclasses.asdict(
        jcal.model_from_dict(json.loads(out.read_text())["model"]))
