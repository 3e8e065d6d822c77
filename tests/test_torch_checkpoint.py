"""Checkpoints in the torch port: the safetensors reader, the JAX
package's Orbax trees (adapters and serving checkpoints, read through
tensorstore without JAX), and the server's ``--checkpoint`` /
``--draft-checkpoint`` on the CPU.

- The port's safetensors reader against files the ``safetensors``
  package writes, every dtype; the port's writer read back by the
  package; a sharded index; the malformed files refused with their name.
- An adapter written by the reference's ``save_adapter`` (Orbax) loads
  through the port's ``load_adapter_checkpoint`` and over
  ``/v1/load_lora_adapter``: its slot equals the reference
  ``LoRAManager``'s slot for the same directory, and greedy text through
  it equals the JAX server's.
- A checkpoint written by the reference's ``save_hf_as_orbax`` (and bare
  Orbax params trees, f32 and int8) loads with leaves equal to the
  reference's ``load_serving_checkpoint``.
- Without ``tensorstore`` both routes refuse, naming it, and the HTTP
  load answers 500 with that message.
- ``make_server --checkpoint`` (an HF directory and an Orbax one) serves
  the greedy tokens of ``params=`` with the same tree, under the
  checkpoint's name and the preset alias; the vocabulary check runs
  against the checkpoint's architecture; ``--quantize int8`` loads the
  quantized tree; ``--speculative 2 --draft-checkpoint`` gives the
  in-memory draft's tokens and spec cycles; an unreadable checkpoint
  raises.
"""

import asyncio
import dataclasses
import json
import os
import struct
import sys
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer

from llm_instance_gateway_tpu.models import convert as jconvert
from llm_instance_gateway_tpu.models import lora as jlora
from llm_instance_gateway_tpu.models import transformer as jtf
from llm_instance_gateway_tpu.models.configs import TINY_TEST as JAX_TINY
from llm_instance_gateway_tpu.ops.quant import quantize_params as jquantize
from llm_instance_gateway_tpu.server import api_http as japi
from llm_instance_gateway_tpu.server import engine as jeng
from llm_instance_gateway_tpu.server import lora_manager as jlm
from llm_instance_gateway_tpu.server.tokenizer import ByteTokenizer as JBytes

torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")
safetensors_torch = pytest.importorskip("safetensors.torch")
ocp = pytest.importorskip("orbax.checkpoint")

from llm_instance_gateway_tpu_torch.models import orbax_tree  # noqa: E402
from llm_instance_gateway_tpu_torch.models import safetensors as st  # noqa: E402
from llm_instance_gateway_tpu_torch.models import transformer as ttf  # noqa: E402
from llm_instance_gateway_tpu_torch.models.configs import TINY_TEST  # noqa: E402
from llm_instance_gateway_tpu_torch.models.convert import (  # noqa: E402
    load_serving_checkpoint,
    save_hf_checkpoint,
)
from llm_instance_gateway_tpu_torch.models.weights import params_from_numpy  # noqa: E402
from llm_instance_gateway_tpu_torch.ops.quant import quantize_params  # noqa: E402
from llm_instance_gateway_tpu_torch.server import api_http as tapi  # noqa: E402
from llm_instance_gateway_tpu_torch.server import engine as teng  # noqa: E402
from llm_instance_gateway_tpu_torch.server import lora_manager as tlm  # noqa: E402
from llm_instance_gateway_tpu_torch.server.tokenizer import ByteTokenizer  # noqa: E402

JCFG = dataclasses.replace(JAX_TINY, max_lora_slots=2)
TCFG = dataclasses.replace(TINY_TEST, max_lora_slots=2)
ENGINE = dict(decode_slots=2, max_seq_len=64, prefill_buckets=(8, 16, 32))
SERVER = ["--device", "cpu", "--dtype", "float32", "--model", "llama3-tiny",
          "--host", "127.0.0.1", "--port", "0", "--max-seq-len", "64",
          "--decode-slots", "2", "--prefill-buckets", "8", "16", "32"]
PROMPTS = ["checkpoint", "the quick brown fox", "x"]


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: tree}


def _np(x):
    """A leaf as numpy; bf16 as its 16-bit words."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.uint16).numpy()
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype.name == "bfloat16" else x


def assert_trees_equal(got, want):
    got, want = _flat(got), _flat(want)
    assert set(got) == set(want)
    for key in want:
        g, w = _np(got[key]), _np(want[key])
        assert g.dtype == w.dtype and g.shape == w.shape, key
        np.testing.assert_array_equal(g, w, err_msg=str(key))


# -- the safetensors reader ---------------------------------------------------

DTYPES = [torch.bfloat16, torch.float16, torch.float32, torch.int8,
          torch.int32, torch.int64, torch.uint8, torch.bool]


def _sample(dtype, shape, seed):
    gen = torch.Generator().manual_seed(seed)
    if dtype.is_floating_point:
        return torch.randn(shape, generator=gen).to(dtype)
    if dtype == torch.bool:
        return torch.randint(0, 2, shape, generator=gen).bool()
    info = torch.iinfo(dtype)
    return torch.randint(max(info.min, -2**31), min(info.max, 2**31 - 1),
                         shape, generator=gen, dtype=torch.int64).to(dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_reader_matches_the_safetensors_package(dtype, tmp_path):
    tensors = {"a": _sample(dtype, (3, 5), 0), "b.c": _sample(dtype, (7,), 1),
               "scalar": _sample(dtype, (), 2),
               "empty": _sample(dtype, (0, 4), 3)}
    path = str(tmp_path / "x.safetensors")
    safetensors_torch.save_file(tensors, path, metadata={"format": "pt"})
    got = st.load_file(path)
    assert set(got) == set(tensors)
    for name, t in tensors.items():
        assert got[name].dtype == dtype and got[name].shape == t.shape
        assert torch.equal(got[name], t), name


def test_writer_is_read_by_the_safetensors_package(tmp_path):
    tensors = {f"t{i}": _sample(dtype, (4, 3), i)
               for i, dtype in enumerate(DTYPES)}
    tensors["transposed"] = _sample(torch.bfloat16, (6, 2), 9).t()
    path = str(tmp_path / "y.safetensors")
    n = st.save_file(tensors, path, {"format": "pt"})
    assert n == os.path.getsize(path)
    back = safetensors_torch.load_file(path)
    for name, t in tensors.items():
        assert torch.equal(back[name], t), name
    with open(path, "rb") as f:
        (header_len,) = struct.unpack("<Q", f.read(8))
    assert (8 + header_len) % 8 == 0


def test_sharded_index_is_followed(tmp_path):
    shards = {"model-00001-of-00002.safetensors":
              {"x": _sample(torch.float32, (2, 2), 0)},
              "model-00002-of-00002.safetensors":
              {"y": _sample(torch.bfloat16, (3,), 1),
               "z": _sample(torch.int8, (1, 3), 2)}}
    weight_map = {}
    for fname, tensors in shards.items():
        safetensors_torch.save_file(tensors, str(tmp_path / fname))
        weight_map.update({name: fname for name in tensors})
    with open(tmp_path / st.INDEX_FILE, "w") as f:
        json.dump({"metadata": {}, "weight_map": weight_map}, f)
    assert st.is_checkpoint(str(tmp_path))
    got = st.load_checkpoint(str(tmp_path))
    for tensors in shards.values():
        for name, t in tensors.items():
            assert torch.equal(got[name], t)
    weight_map["w"] = "model-00001-of-00002.safetensors"
    with open(tmp_path / st.INDEX_FILE, "w") as f:
        json.dump({"weight_map": weight_map}, f)
    with pytest.raises(st.SafetensorsError, match="no tensor 'w'"):
        st.load_checkpoint(str(tmp_path))


def _raw_file(path, header, data=b"", header_len=None):
    blob = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob) if header_len is None
                            else header_len))
        f.write(blob)
        f.write(data)


@pytest.mark.parametrize("case,match", [
    ("header_too_long", "exceeds the file"),
    ("out_of_range", "out of range"),
    ("overlap", "overlap"),
    ("size_mismatch", "needs 16"),
    ("unknown_dtype", "unknown dtype"),
])
def test_malformed_files_are_refused(case, match, tmp_path):
    path = str(tmp_path / f"{case}.safetensors")
    f32 = {"dtype": "F32", "shape": [2, 2]}
    if case == "header_too_long":
        _raw_file(path, {"a": {**f32, "data_offsets": [0, 16]}}, bytes(16),
                  header_len=10**6)
    elif case == "out_of_range":
        _raw_file(path, {"a": {**f32, "data_offsets": [8, 24]}}, bytes(16))
    elif case == "overlap":
        _raw_file(path, {"a": {**f32, "data_offsets": [0, 16]},
                         "b": {**f32, "data_offsets": [8, 24]}}, bytes(24))
    elif case == "size_mismatch":
        _raw_file(path, {"a": {**f32, "data_offsets": [0, 12]}}, bytes(16))
    else:
        _raw_file(path, {"a": {"dtype": "F8_E4M3", "shape": [2],
                               "data_offsets": [0, 2]}}, bytes(2))
    with pytest.raises(st.SafetensorsError, match=match) as err:
        st.load_file(path)
    assert path in str(err.value)


# -- F4: the reference's Orbax adapters ---------------------------------------


def adapter_weights(seed, rank=3):
    rng = np.random.RandomState(seed)
    return {t: {"a": rng.randn(JCFG.n_layers, di, rank).astype(np.float32)
                * 0.3,
                "b": rng.randn(JCFG.n_layers, rank, do).astype(np.float32)
                * 0.3}
            for t, (di, do) in jlora.target_dims(JCFG).items()}


@pytest.fixture(scope="module")
def orbax_adapter(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("f4") / "ad-orbax")
    jlm.save_adapter(path, adapter_weights(5), alpha=6.0, rank=3)
    return path


def test_orbax_adapter_loads_as_the_reference_reads_it(orbax_adapter):
    want_w, want_alpha, want_rank = jlm.load_adapter_checkpoint(orbax_adapter)
    got_w, alpha, rank = tlm.load_adapter_checkpoint(orbax_adapter)
    assert (alpha, rank) == (float(want_alpha), int(want_rank)) == (6.0, 3)
    assert_trees_equal(got_w, want_w)
    assert all(v.dtype == np.float32 for tv in got_w.values()
               for v in tv.values())


def test_orbax_adapter_fills_the_reference_slot(orbax_adapter):
    ref = jlm.LoRAManager(JCFG, dtype=jnp.float32)
    port = tlm.LoRAManager(TCFG, dtype=torch.float32, device="cpu")
    ref.load("ad", checkpoint_path=orbax_adapter)
    info = port.load("ad", checkpoint_path=orbax_adapter)
    assert info.source == orbax_adapter and info.rank == 3
    assert set(port.buffers) == set(ref.buffers)
    for key, buf in ref.buffers.items():
        np.testing.assert_array_equal(port.buffers[key].numpy(),
                                      np.asarray(buf), err_msg=key)


@pytest.fixture(scope="module")
def servers():
    """(JAX ModelServer, port URL, port engine) over the same weights."""
    jw = jtf.init_params(JCFG, jax.random.PRNGKey(0), jnp.float32)
    jman = jlm.LoRAManager(JCFG, dtype=jnp.float32)
    jengine = jeng.Engine(JCFG, jw, jeng.EngineConfig(**ENGINE),
                          lora_manager=jman, eos_id=None, dtype=jnp.float32)
    jengine.start()
    tman = tlm.LoRAManager(TCFG, dtype=torch.float32, device="cpu")
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
            return f.status, json.loads(f.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_orbax_adapter_over_http_serves_the_reference_tokens(servers,
                                                             orbax_adapter):
    """The body the sidecar posts to a JAX pod loads on a torch pod, and
    greedy text through the adapter is the JAX server's."""
    jserver, url = servers
    body = {"lora_name": "ad-f4", "lora_path": orbax_adapter}
    status, raw = jax_call(jserver, "/v1/load_lora_adapter", body)
    assert status == 200
    assert port_call(url, "/v1/load_lora_adapter", body) == (
        200, json.loads(raw))
    for prompt in PROMPTS:
        req = {"prompt": prompt, "max_tokens": 8, "temperature": 0,
               "model": "ad-f4"}
        status, raw = jax_call(jserver, "/v1/completions", req)
        got_status, got = port_call(url, "/v1/completions", req)
        assert got_status == status == 200
        assert got["choices"][0]["text"] == json.loads(raw)["choices"][0][
            "text"]
        assert got["usage"] == json.loads(raw)["usage"]


# -- F4: the reference's Orbax serving checkpoints ----------------------------


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    """An HF directory of llama3-tiny's architecture (vocab 320, so the
    byte tokenizer fits), written by the port from seeded weights, and
    the tree it was written from."""
    cfg = TINY_TEST
    params = ttf.init_params(cfg, seed=7, dtype=torch.float32, device="cpu")
    params["embed"][cfg.vocab_size:] = 0
    params["lm_head"][:, cfg.vocab_size:] = 0
    path = str(tmp_path_factory.mktemp("hf") / "tiny-hf")
    save_hf_checkpoint(cfg, params, path, shard_bytes=400_000)
    return path, params


@pytest.fixture(scope="module")
def orbax_dir(hf_dir, tmp_path_factory):
    """The same weights through the reference's route: HF -> transformers
    model -> ``save_hf_as_orbax`` (f32)."""
    model = transformers.AutoModelForCausalLM.from_pretrained(
        hf_dir[0], dtype=torch.float32)
    path = str(tmp_path_factory.mktemp("orbax") / "tiny-orbax")
    jconvert.save_hf_as_orbax(model, path, dtype=jnp.float32)
    return path


def test_save_hf_as_orbax_checkpoint_equals_the_reference_load(orbax_dir,
                                                               hf_dir):
    want_cfg, want = jconvert.load_serving_checkpoint(orbax_dir)
    cfg, got = load_serving_checkpoint(orbax_dir, torch.float32, "cpu")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(want_cfg)
    assert_trees_equal(got, jax.tree.map(np.asarray, want))
    # ... and equal to the HF directory it was converted from.
    hf_cfg, hf_params = load_serving_checkpoint(hf_dir[0], torch.float32,
                                                "cpu")
    assert_trees_equal(got, hf_params)


@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_bare_orbax_tree_equals_the_reference_load(kind, tmp_path):
    """A bare params tree (no model_config.json: no cfg), bf16 leaves
    kept bit for bit, or an int8 tree whose {q, s} leaves keep int8 and
    their f32 scales while the rest is cast."""
    jw = jtf.init_params(JCFG, jax.random.PRNGKey(3), jnp.bfloat16)
    if kind == "int8":
        jw = jquantize(jw)
    path = str(tmp_path / "bare")
    ocp.PyTreeCheckpointer().save(path, jw)
    want_cfg, want = jconvert.load_serving_checkpoint(path)
    cfg, got = load_serving_checkpoint(path, torch.bfloat16, "cpu")
    assert cfg is None and want_cfg is None
    assert_trees_equal(got, jax.tree.map(np.asarray, want))
    if kind == "int8":
        assert got["layers"]["wq"]["q"].dtype == torch.int8
        assert got["lm_head"]["s"].dtype == torch.float32


def test_orbax_int8_load_matches_quantize_params(orbax_dir):
    _, dense = load_serving_checkpoint(orbax_dir, torch.bfloat16, "cpu")
    _, int8 = load_serving_checkpoint(orbax_dir, torch.bfloat16, "cpu",
                                      quantize=True)
    assert_trees_equal(int8, quantize_params(dense))


def test_neither_form_is_refused_naming_both(tmp_path):
    with pytest.raises(FileNotFoundError, match="HF directory.*Orbax tree"):
        load_serving_checkpoint(str(tmp_path), torch.float32, "cpu")


# -- without tensorstore -------------------------------------------------------


def test_without_tensorstore_both_routes_refuse(monkeypatch, orbax_adapter,
                                                orbax_dir, servers):
    monkeypatch.setitem(sys.modules, "tensorstore", None)
    with pytest.raises(orbax_tree.OrbaxTreeError, match="needs the "
                       "tensorstore package") as err:
        tlm.load_adapter_checkpoint(orbax_adapter)
    assert orbax_adapter in str(err.value)
    with pytest.raises(orbax_tree.OrbaxTreeError, match="tensorstore"):
        load_serving_checkpoint(orbax_dir, torch.float32, "cpu")
    _, url = servers
    status, body = port_call(url, "/v1/load_lora_adapter", {
        "lora_name": "ad-nots", "lora_path": orbax_adapter})
    assert status == 500
    msg = body["error"]["message"]
    assert msg.startswith("failed to load adapter: ") and "tensorstore" in msg
    served = [m["id"] for m in port_call(url, "/v1/models")[1]["data"]]
    assert "ad-nots" not in served


# -- make_server --------------------------------------------------------------


def _serve(argv, **kw):
    httpd, engine, args = tapi.make_server(SERVER + argv, **kw)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, engine, "http://127.0.0.1:%d" % httpd.server_address[1]


def _stop(httpd, engine):
    httpd.shutdown()
    httpd.server_close()
    engine.stop()


def _greedy(url, model=None, n=10):
    out = []
    for prompt in PROMPTS:
        body = {"prompt": prompt, "max_tokens": n, "temperature": 0}
        if model:
            body["model"] = model
        status, got = port_call(url, "/v1/completions", body)
        assert status == 200, got
        out.append(got["choices"][0]["text"])
    return out


@pytest.fixture(scope="module")
def reference_text(hf_dir):
    """Greedy text of ``params=`` with the tree the HF dir was written
    from."""
    httpd, engine, url = _serve([], params=hf_dir[1])
    try:
        return _greedy(url)
    finally:
        _stop(httpd, engine)


@pytest.mark.parametrize("route", ["hf", "orbax"])
def test_checkpoint_serves_the_params_tokens(route, hf_dir, orbax_dir,
                                             reference_text):
    path = hf_dir[0] if route == "hf" else orbax_dir
    httpd, engine, url = _serve(["--checkpoint", path])
    try:
        assert_trees_equal(engine.params, hf_dir[1])
        assert _greedy(url) == reference_text
        # The checkpoint's name and the preset alias both answer.
        assert _greedy(url, model="llama3-tiny") == reference_text
        served = path if route == "hf" else jconvert.config_from_hf(
            transformers.AutoConfig.from_pretrained(hf_dir[0])).name
        assert _greedy(url, model=served) == reference_text
        status, models = port_call(url, "/v1/models")
        assert models["data"][0]["id"] == served
        for name in (served, "llama3-tiny"):
            status, body = port_call(url, "/v1/load_lora_adapter", {
                "lora_name": name, "lora_path": "/nope"})
            assert status == 409, body
        status, _ = port_call(url, "/v1/completions", {
            "prompt": "x", "max_tokens": 2, "model": "ghost"})
        assert status == 404
    finally:
        _stop(httpd, engine)


def test_vocab_check_runs_against_the_checkpoint(tmp_path):
    """llama3-tiny's preset holds the byte tokenizer's 259 ids; a
    checkpoint of vocab 128 does not, and the server refuses it."""
    cfg = dataclasses.replace(TINY_TEST, vocab_size=128)
    params = ttf.init_params(cfg, seed=1, dtype=torch.float32, device="cpu")
    save_hf_checkpoint(cfg, params, str(tmp_path / "small"))
    with pytest.raises(SystemExit, match="tokenizer vocab 259 exceeds model "
                       "vocab 128"):
        tapi.make_server(SERVER + ["--checkpoint", str(tmp_path / "small")])


def test_unreadable_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="not a serving checkpoint"):
        tapi.make_server(SERVER + ["--checkpoint", str(tmp_path)])
    with pytest.raises(ValueError, match="params= and --checkpoint"):
        tapi.make_server(SERVER + ["--checkpoint", str(tmp_path)],
                         params={})
    with pytest.raises(SystemExit):
        tapi.make_server(SERVER + ["--draft-checkpoint", str(tmp_path)])


def test_quantize_loads_the_int8_tree(hf_dir, reference_text):
    quant = quantize_params(hf_dir[1])
    httpd, engine, url = _serve(["--checkpoint", hf_dir[0], "--quantize",
                                 "int8"])
    try:
        assert_trees_equal(engine.params, quant)
        got = _greedy(url)
    finally:
        _stop(httpd, engine)
    httpd, engine, url = _serve(["--quantize", "int8"], params=quant)
    try:
        assert _greedy(url) == got
    finally:
        _stop(httpd, engine)


def test_draft_checkpoint_equals_the_in_memory_draft(hf_dir, reference_text):
    spec = ["--speculative", "2", "--draft-model", "llama3-tiny"]
    runs = []
    for argv, kw in ((["--checkpoint", hf_dir[0], "--draft-checkpoint",
                       hf_dir[0]], {}),
                     ([], {"params": hf_dir[1], "draft_params": hf_dir[1]})):
        httpd, engine, url = _serve(spec + argv, **kw)
        try:
            assert_trees_equal(engine.draft_params, hf_dir[1])
            runs.append((_greedy(url), engine.spec_cycles,
                         engine.spec_emitted))
        finally:
            _stop(httpd, engine)
    assert runs[0] == runs[1]
    assert runs[0][0] == reference_text  # greedy: the target's own tokens
    assert runs[0][1] > 0
