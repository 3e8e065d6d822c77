"""``--no-kv-ledger`` on the torch port's server: the reference's flag and
help text, ``EngineConfig.kv_ledger=False``, ``/debug/kv`` 404 and no
ledger family on ``/metrics`` — the ``tpu:kv_*`` families a JAX pod
renders with its ledger off."""

import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import pytest

from llm_instance_gateway_tpu.models import transformer as jtf
from llm_instance_gateway_tpu.models.configs import TINY_TEST as JAX_TINY
from llm_instance_gateway_tpu.server import engine as jeng
from llm_instance_gateway_tpu.server import metrics as jmetrics

torch = pytest.importorskip("torch")

from llm_instance_gateway_tpu_torch.server import api_http  # noqa: E402

PAGED = ["--paged-kv-block", "16", "--prefix-cache"]


def _families(text):
    return {ln.split()[2] for ln in text.splitlines()
            if ln.startswith("# TYPE tpu:kv_")}


def _jax_families(kv_ledger):
    params = jtf.init_params(JAX_TINY, jax.random.PRNGKey(0), jnp.float32)
    eng = jeng.Engine(JAX_TINY, params, jeng.EngineConfig(
        decode_slots=2, max_seq_len=128, prefill_buckets=(16, 32),
        paged_kv_block=16, prefix_cache=True, kv_ledger=kv_ledger),
        dtype=jnp.float32)
    snap = eng.metrics_snapshot()
    snap["model_name"] = "llama3-tiny"
    return _families(jmetrics.render(snap))


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=60) as f:
            return f.status, f.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


@pytest.mark.parametrize("ledger", [True, False], ids=["ledger", "no-ledger"])
def test_flag_turns_the_ledger_off_as_on_a_jax_pod(ledger):
    argv = ["--device", "cpu", "--dtype", "float32", "--host", "127.0.0.1",
            "--port", "0", "--max-seq-len", "128", *PAGED]
    httpd, engine, _ = api_http.make_server(
        argv + ([] if ledger else ["--no-kv-ledger"]))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        url = "http://127.0.0.1:%d" % httpd.server_address[1]
        assert engine.cfg.kv_ledger is ledger
        status, body = _get(url + "/debug/kv")
        assert status == (200 if ledger else 404)
        if not ledger:
            assert "kv ledger is disabled" in json.loads(body)["error"][
                "message"]
        _, text = _get(url + "/metrics")
        got = _families(text)
        assert got == _jax_families(ledger)
        assert ("tpu:kv_blocks" in got) is ledger
    finally:
        httpd.shutdown()
        httpd.server_close()
        engine.stop()


def test_help_text_is_the_reference_s():
    action = next(a for a in api_http.build_parser()._actions
                  if a.dest == "no_kv_ledger")
    assert action.help == ("disable the KV block-lifecycle ledger "
                           "(tpu:kv_* families + /debug/kv; the A/B "
                           "for the kv_ledger_ratio bench)")
