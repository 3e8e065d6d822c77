"""The LoRA residency ladder of the torch port (slot -> host -> disk) held
to the JAX package's ``LoRAManager`` on the CPU.

One sequence of load / demote / prefetch / evict / promote / unload goes
through both managers (the reference's checkpoints are Orbax, the port's
``.npz``, holding the same numpy-seeded weights): the residency snapshot,
tiers, ranks, transition counters and load counts must be equal after
every step, and the refusals the same (a busy demote, a full slot table, a
disabled host tier).  Over HTTP, the three ladder endpoints answer as the
reference's, the exposition carries the ladder's families, and an adapter
request's greedy text is unchanged after demote -> promote and evict ->
reload, against the JAX server.
"""

import asyncio
import dataclasses
import json
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer

from llm_instance_gateway_tpu.models import lora as jlora
from llm_instance_gateway_tpu.models import transformer as jtf
from llm_instance_gateway_tpu.models.configs import TINY_TEST as JAX_TINY
from llm_instance_gateway_tpu.server import api_http as japi
from llm_instance_gateway_tpu.server import engine as jeng
from llm_instance_gateway_tpu.server import lora_manager as jlm
from llm_instance_gateway_tpu.server.tokenizer import ByteTokenizer as JBytes
from llm_instance_gateway_tpu.utils import prom_parse

torch = pytest.importorskip("torch")

from llm_instance_gateway_tpu_torch.models.configs import TINY_TEST  # noqa: E402
from llm_instance_gateway_tpu_torch.models.weights import params_from_numpy  # noqa: E402
from llm_instance_gateway_tpu_torch.server import api_http as tapi  # noqa: E402
from llm_instance_gateway_tpu_torch.server import engine as teng  # noqa: E402
from llm_instance_gateway_tpu_torch.server import lora_manager as tlm  # noqa: E402
from llm_instance_gateway_tpu_torch.server.tokenizer import ByteTokenizer  # noqa: E402

JCFG = dataclasses.replace(JAX_TINY, max_lora_slots=2)
TCFG = dataclasses.replace(TINY_TEST, max_lora_slots=2)
ENGINE = dict(decode_slots=2, max_seq_len=64, prefill_buckets=(8, 16, 32))


def weights(seed, rank=2):
    rng = np.random.RandomState(seed)
    return {t: {"a": rng.randn(JCFG.n_layers, di, rank).astype(np.float32)
                * 0.3,
                "b": rng.randn(JCFG.n_layers, rank, do).astype(np.float32)
                * 0.3}
            for t, (di, do) in jlora.target_dims(JCFG).items()}


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """name -> (Orbax dir, .npz path), the same weights in each."""
    root = tmp_path_factory.mktemp("adapters")
    out = {}
    for i, name in enumerate(("ad-a", "ad-c", "ad-d", "ad-e")):
        w, rank = weights(10 + i, rank=2 + i % 2), 2 + i % 2
        jpath = str(root / f"{name}.orbax")
        tpath = str(root / f"{name}.npz")
        jlm.save_adapter(jpath, w, alpha=4.0, rank=rank)
        tlm.save_adapter(tpath, w, alpha=4.0, rank=rank)
        out[name] = (jpath, tpath)
    return out


def _state(m):
    transitions, loads = m.residency_counters()
    return (m.residency_snapshot(), m.adapter_tiers(), m.adapter_ranks(),
            m.running_adapters(), transitions,
            {t: sc[1] for t, sc in loads.items()})


def _outcome(fn):
    try:
        return ("ok", fn())
    except jlm.AdapterError as e:
        return (type(e).__name__, str(e))
    except tlm.AdapterError as e:
        return (type(e).__name__, str(e))


def _info(result):
    """A load's AdapterInfo as comparable fields."""
    if isinstance(result, (jlm.AdapterInfo, tlm.AdapterInfo)):
        return (result.name, result.slot, result.rank, result.alpha)
    return result


def test_ladder_sequence_equals_the_reference(checkpoints):
    ref = jlm.LoRAManager(JCFG, dtype=jnp.float32, host_cache_slots=2)
    port = tlm.LoRAManager(TCFG, dtype=torch.float32, device="cpu",
                           host_cache_slots=2)

    def path(m, name):
        return checkpoints[name][0 if m is ref else 1]

    steps = [
        ("load a from disk", lambda m: m.load("ad-a",
                                               checkpoint_path=path(m, "ad-a"))),
        ("load b inline", lambda m: m.load("ad-b", weights=weights(1),
                                           alpha=8.0, rank=2)),
        ("load a again (resident)", lambda m: m.load("ad-a")),
        ("demote a", lambda m: m.demote("ad-a")),
        ("demote a again", lambda m: m.demote("ad-a")),
        ("prefetch c", lambda m: m.prefetch("ad-c", path(m, "ad-c"))),
        ("prefetch c again", lambda m: m.prefetch("ad-c", path(m, "ad-c"))),
        ("prefetch b (slot)", lambda m: m.prefetch("ad-b", path(m, "ad-c"))),
        ("prefetch d: a spills to disk",
         lambda m: m.prefetch("ad-d", path(m, "ad-d"))),
        ("promote c", lambda m: m.load("ad-c")),
        ("load e: no free slot",
         lambda m: m.load("ad-e", checkpoint_path=path(m, "ad-e"))),
        ("busy demote b", lambda m: (m.acquire("ad-b"), m.demote("ad-b"))),
        ("release b", lambda m: m.release("ad-b")),
        ("busy unload b", lambda m: (m.acquire("ad-b"), m.unload("ad-b"))),
        ("release b again", lambda m: m.release("ad-b")),
        ("demote b", lambda m: m.demote("ad-b")),
        ("evict d", lambda m: m.evict_host("ad-d")),
        ("evict d again", lambda m: m.evict_host("ad-d")),
        ("evict c (slot)", lambda m: m.evict_host("ad-c")),
        ("unload b (host)", lambda m: m.unload("ad-b")),
        ("demote c", lambda m: m.demote("ad-c")),
        ("load c from another path: the host copy is stale",
         lambda m: m.load("ad-c", checkpoint_path=path(m, "ad-e"))),
        ("unload c", lambda m: m.unload("ad-c")),
        ("unload c again", lambda m: m.unload("ad-c")),
        ("bad name", lambda m: m.prefetch("no/slash", path(m, "ad-a"))),
        ("load a from disk again",
         lambda m: m.load("ad-a", checkpoint_path=path(m, "ad-a"))),
    ]
    for what, fn in steps:
        want = _outcome(lambda: fn(ref))
        got = _outcome(lambda: fn(port))
        assert _info(got[1]) == _info(want[1]) or (
            got[0] == want[0] == "ok" and what.startswith("busy")), what
        assert got[0] == want[0], (what, got, want)
        assert _state(port) == _state(ref), what
        # Tier conservation: each name in exactly one tier.
        snap = port.residency_snapshot()
        assert not set(snap["slot"]) & set(snap["host"]), what


def test_promotion_writes_the_host_copy_bit_for_bit(checkpoints):
    """demote -> promote leaves the slot buffers as the first load wrote
    them (the slot may move; its contents do not)."""
    port = tlm.LoRAManager(TCFG, dtype=torch.float32, device="cpu")
    info = port.load("ad-a", checkpoint_path=checkpoints["ad-a"][1])
    before = {k: (v[:, info.slot] if v.dim() > 1 else v[info.slot]).clone()
              for k, v in port.buffers.items()}
    addresses = {k: v.data_ptr() for k, v in port.buffers.items()}
    assert port.demote("ad-a")
    assert all(float(v[:, info.slot].abs().sum()) == 0.0
               for k, v in port.buffers.items() if v.dim() > 1)
    port.load("ad-b", weights=weights(1), alpha=8.0, rank=2)  # takes a slot
    again = port.load("ad-a")
    _, loads = port.residency_counters()
    assert loads["host"][1] == 1 and loads["disk"][1] == 1
    for k, v in port.buffers.items():
        got = v[:, again.slot] if v.dim() > 1 else v[again.slot]
        assert torch.equal(got, before[k]), k
        assert v.data_ptr() == addresses[k]  # written in place


@pytest.mark.parametrize("verb", ["demote", "prefetch"])
def test_disabled_host_tier_refuses_as_the_reference(checkpoints, verb):
    ref = jlm.LoRAManager(JCFG, dtype=jnp.float32, host_cache_slots=0)
    port = tlm.LoRAManager(TCFG, dtype=torch.float32, device="cpu",
                           host_cache_slots=0)
    for m, p in ((ref, checkpoints["ad-a"][0]), (port, checkpoints["ad-a"][1])):
        m.load("ad-a", checkpoint_path=p)
    outcomes = [_outcome(lambda m=m, p=p: getattr(m, verb)(
        "ad-a" if verb == "demote" else "ad-c", *(() if verb == "demote"
                                                  else (p,))))
        for m, p in ((ref, checkpoints["ad-c"][0]),
                     (port, checkpoints["ad-c"][1]))]
    assert outcomes[0] == outcomes[1] and outcomes[0][0] == "AdapterError"
    assert _state(port) == _state(ref)


# -- over HTTP, against the JAX server ---------------------------------------


@pytest.fixture(scope="module")
def servers():
    jw = jtf.init_params(JCFG, jax.random.PRNGKey(0), jnp.float32)
    jman = jlm.LoRAManager(JCFG, dtype=jnp.float32, host_cache_slots=2)
    jengine = jeng.Engine(JCFG, jw, jeng.EngineConfig(**ENGINE),
                          lora_manager=jman, eos_id=None, dtype=jnp.float32)
    jengine.start()
    tman = tlm.LoRAManager(TCFG, dtype=torch.float32, device="cpu",
                           host_cache_slots=2)
    tengine = teng.Engine(TCFG, params_from_numpy(
        jax.tree.map(np.asarray, jw), "cpu"), teng.EngineConfig(**ENGINE),
        lora_manager=tman, eos_id=None, dtype=torch.float32, device="cpu")
    tengine.start()
    tserver = tapi.ModelServer(tengine, ByteTokenizer(), "llama3-tiny", tman)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), tapi.make_handler(tserver))
    httpd.daemon_threads = True
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    yield (japi.ModelServer(jengine, JBytes(), "llama3-tiny", jman),
           "http://127.0.0.1:%d" % httpd.server_address[1])
    httpd.shutdown()
    httpd.server_close()
    jengine.stop()
    tengine.stop()


def jax_call(server, path, body=None):
    async def run():
        client = TestClient(TestServer(server.build_app()))
        await client.start_server()
        try:
            resp = await (client.post(path, json=body) if body is not None
                          else client.get(path))
            return resp.status, await resp.read()
        finally:
            await client.close()

    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(run())
    finally:
        loop.close()


def port_call(url, path, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url + path, data=data, headers={
        "Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as f:
            return f.status, f.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _json(raw):
    try:
        return json.loads(raw)
    except ValueError:
        return raw.decode()


def test_ladder_endpoints_answer_as_the_reference(servers, checkpoints):
    jserver, url = servers
    ad = "ad-a"
    greedy = {"prompt": "residency", "max_tokens": 8, "model": ad}

    def call(path, body=None, jbody=None):
        want = jax_call(jserver, path, body if jbody is None else jbody)
        got = port_call(url, path, body)
        return want, got

    def same(path, body=None, jbody=None):
        (js, jraw), (ts, traw) = call(path, body, jbody)
        jw, tw = _json(jraw), _json(traw)
        assert ts == js, (path, body, jw, tw)
        if js == 200 and path.startswith("/v1/") and "lora" in path:
            assert tw == jw, (path, tw, jw)
        elif js != 200:
            assert tw["error"]["message"] == jw["error"]["message"]
        return tw

    def load_body(name, verb="load"):
        return ({"lora_name": name, "lora_path": checkpoints[name][1]},
                {"lora_name": name, "lora_path": checkpoints[name][0]})

    def text():
        out = same("/v1/completions", greedy)
        return out["choices"][0]["text"]

    same("/v1/load_lora_adapter", *load_body(ad))
    loaded = text()
    assert loaded != same("/v1/completions", dict(greedy, model=None))[
        "choices"][0]["text"]
    same("/v1/demote_lora_adapter", {"lora_name": ad})
    same("/v1/completions", greedy)  # 404: not served from the host tier
    same("/v1/demote_lora_adapter", {"lora_name": ad})  # 404 now
    same("/v1/prefetch_lora_adapter", *load_body(ad))  # already resident
    same("/v1/load_lora_adapter", *load_body(ad))  # promotion from host
    assert text() == loaded
    same("/v1/evict_lora_adapter", {"lora_name": ad})  # 404: slot-resident
    same("/v1/demote_lora_adapter", {"lora_name": ad})
    same("/v1/evict_lora_adapter", {"lora_name": ad})
    same("/v1/prefetch_lora_adapter", *load_body(ad))
    same("/v1/load_lora_adapter", *load_body(ad))
    assert text() == loaded
    same("/v1/prefetch_lora_adapter", *load_body("ad-c"))
    for bad in ({}, {"lora_name": "x"}, {"lora_path": "/x"},
                {"lora_name": "llama3-tiny", "lora_path": "/x"}):
        same("/v1/prefetch_lora_adapter", bad)
    same("/v1/demote_lora_adapter", {})
    same("/v1/evict_lora_adapter", {})

    def families(raw):
        fams = prom_parse.parse_text(raw.decode())
        return (
            {s.labels["tier"]: s.labels["adapters"]
             for s in fams["tpu:adapter_residency_info"]},
            {s.labels["tier"]: s.value
             for s in fams["tpu:adapter_loads_total"]},
            {(s.labels["from"], s.labels["to"]): s.value
             for s in fams["tpu:adapter_tier_transitions_total"]},
            {s.labels["tier"]: s.value
             for s in fams["tpu:adapter_load_seconds_total"]})

    got = families(port_call(url, "/metrics")[1])
    want = families(jax_call(jserver, "/metrics")[1])
    assert got[:3] == want[:3]
    assert got[0] == {"slot": ad, "host": "ad-c"}
    assert got[1] == {"host": 2.0, "disk": 3.0}
    assert got[3]["host"] > 0 and got[3]["disk"] > 0
    _, usage = port_call(url, "/debug/usage")
    assert json.loads(usage)["residency"] == {"slot": [ad],
                                              "host": ["ad-c"]}


def test_cli_host_cache_slots_reaches_the_manager():
    args = tapi.build_parser().parse_args([])
    assert args.host_cache_slots == 8
    httpd, engine, _ = tapi.make_server([
        "--device", "cpu", "--dtype", "float32", "--host", "127.0.0.1",
        "--port", "0", "--max-seq-len", "64", "--host-cache-slots", "3"])
    try:
        assert engine.lora.host_cache_slots == 3
    finally:
        httpd.server_close()
        engine.stop()
