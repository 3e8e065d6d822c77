"""The port's ``HFTokenizer`` and chat templates held to the JAX
package's (the template cases of ``tests/test_openai_surface.py``'s
``TestChatTemplate``, against the port's server).

Tokenizer directories are built here, as the reference's test builds
them (a byte-level BPE over printable ASCII with ``<s>``, ``</s>``,
``<unk>``), and saved with ``save_pretrained``; nothing is downloaded.
"""

import json
import sys
import threading
import urllib.error
import urllib.request

import pytest

from llm_instance_gateway_tpu.server import api_http as japi
from llm_instance_gateway_tpu.server.tokenizer import HFTokenizer as JHF

torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")

from llm_instance_gateway_tpu_torch.server import api_http as tapi  # noqa: E402
from llm_instance_gateway_tpu_torch.server.tokenizer import (  # noqa: E402
    ByteTokenizer,
    HFTokenizer,
    load_tokenizer,
)

TEMPLATE = ("{% for m in messages %}<{{ m.role }}>{{ m.content }}"
            "{% endfor %}{% if add_generation_prompt %}<assistant>"
            "{% endif %}")
NO_SYSTEM = ("{% for m in messages %}"
             "{% if m.role == 'system' %}"
             "{{ raise_exception('no system role') }}{% endif %}"
             "{{ m.content }}{% endfor %}")
SERVER = ["--device", "cpu", "--dtype", "float32", "--model", "llama3-tiny",
          "--host", "127.0.0.1", "--port", "0", "--max-seq-len", "64",
          "--decode-slots", "2", "--prefill-buckets", "8", "16", "32"]


def hf_tokenizer_dir(tmp_path, template, specials=True, name=None):
    """A tokenizer directory made as the reference test makes one
    (test_openai_surface.py:403-418);
    ``specials=False`` leaves out BOS and EOS."""
    from tokenizers import Tokenizer, models

    vocab = {chr(i): i - 32 for i in range(32, 127)}
    vocab |= {"<s>": 95, "</s>": 96, "<unk>": 97}
    tok = Tokenizer(models.BPE(vocab=vocab, merges=[], unk_token="<unk>"))
    kw = {"bos_token": "<s>", "eos_token": "</s>"} if specials else {}
    fast = transformers.PreTrainedTokenizerFast(
        tokenizer_object=tok, unk_token="<unk>", **kw)
    if template:
        fast.chat_template = template
    d = str(tmp_path / (name or ("tmpl" if template else "plain")))
    fast.save_pretrained(d)
    return d


def _serve(argv):
    httpd, engine, _ = tapi.make_server(SERVER + argv)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, engine, "http://127.0.0.1:%d" % httpd.server_address[1]


def _post(url, path, body):
    req = urllib.request.Request(url + path, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as f:
            return f.status, f.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_template_applied(tmp_path):
    """The template renders as the reference's, and a chat request on a
    server started with ``--tokenizer`` encodes it with add_bos=False."""
    d = hf_tokenizer_dir(tmp_path, TEMPLATE)
    tok = HFTokenizer(d)
    msgs = [{"role": "system", "content": "be terse"},
            {"role": "user", "content": "hi"}]
    want = "<system>be terse<user>hi<assistant>"
    assert tok.apply_chat_template(msgs) == want == JHF(d).apply_chat_template(
        msgs)
    httpd, engine, url = _serve(["--tokenizer", d])
    try:
        assert engine.eos_id == 96
        submitted = []
        submit = engine.submit

        def record(req, *a, **kw):
            submitted.append(req)
            return submit(req, *a, **kw)
        engine.submit = record
        status, raw = _post(url, "/v1/chat/completions", {
            "messages": msgs, "max_tokens": 3, "temperature": 0})
        assert status == 200, raw
        ids = tok.encode(want, add_bos=False)
        assert ids[0] != tok.bos_id
        assert [list(r.prompt_tokens) for r in submitted] == [ids]
        assert json.loads(raw)["usage"]["prompt_tokens"] == len(ids)
    finally:
        httpd.shutdown()
        httpd.server_close()
        engine.stop()


def test_no_template_falls_back(tmp_path):
    d = hf_tokenizer_dir(tmp_path, None)
    assert HFTokenizer(d).apply_chat_template(
        [{"role": "user", "content": "x"}]) is None
    msgs = [{"role": "user", "content": "hello"}]
    for tok in (HFTokenizer(d), ByteTokenizer()):
        server = tapi.ModelServer(None, tok, "m")
        assert server._chat_prompt(msgs) == ("user: hello\nassistant:", True)


def test_server_uses_template(tmp_path):
    d = hf_tokenizer_dir(tmp_path, "{% for m in messages %}[{{ m.content }}]"
                                   "{% endfor %}")
    msgs = [{"role": "user", "content": "q"}]
    server = tapi.ModelServer(None, HFTokenizer(d), "m")
    assert server._chat_prompt(msgs) == ("[q]", False)
    assert server._chat_prompt(msgs) == japi.ModelServer(
        engine=None, tokenizer=JHF(d), model_name="m")._chat_prompt(msgs)


def test_template_error_maps_to_400(tmp_path):
    """A template that refuses the messages: ValueError in
    ``_chat_prompt``, 400 with the reference's text on
    ``/v1/chat/completions`` and on ``/v1/prefill``."""
    d = hf_tokenizer_dir(tmp_path, NO_SYSTEM)
    msgs = [{"role": "system", "content": "x"}]
    with pytest.raises(ValueError, match="chat template"):
        tapi.ModelServer(None, HFTokenizer(d), "m")._chat_prompt(msgs)
    with pytest.raises(ValueError) as ref:
        japi.ModelServer(engine=None, tokenizer=JHF(d),
                         model_name="m")._chat_prompt(msgs)
    httpd, engine, url = _serve(["--tokenizer", d])
    try:
        for path in ("/v1/chat/completions", "/v1/prefill"):
            status, raw = _post(url, path, {"messages": msgs,
                                            "max_tokens": 2})
            assert status == 400, (path, raw)
            assert json.loads(raw)["error"]["message"] == str(ref.value)
        status, _ = _post(url, "/v1/chat/completions", {
            "messages": [{"role": "user", "content": "ok"}],
            "max_tokens": 2})
        assert status == 200
    finally:
        httpd.shutdown()
        httpd.server_close()
        engine.stop()


def test_missing_specials_stay_none(tmp_path):
    """No BOS and no EOS: both None (never id 0), no BOS prepended, the
    pad id falls back to 0; encode and decode as the reference's."""
    d = hf_tokenizer_dir(tmp_path, None, specials=False, name="bare")
    tok, ref = HFTokenizer(d), JHF(d)
    assert tok.bos_id is None and tok.eos_id is None and tok.pad_id == 0
    assert (tok.bos_id, tok.eos_id, tok.pad_id, tok.vocab_size) == (
        ref.bos_id, ref.eos_id, ref.pad_id, ref.vocab_size)
    assert tok.encode("hi there") == ref.encode("hi there") \
        == tok.encode("hi there", add_bos=False)
    d2 = hf_tokenizer_dir(tmp_path, None, name="full")
    tok, ref = HFTokenizer(d2), JHF(d2)
    assert tok.encode("hi") == ref.encode("hi") == [95, 72, 73]
    text = tok.decode([95, 72, 73, 96])
    assert text == ref.decode([95, 72, 73, 96])
    assert "<s>" not in text and "</s>" not in text  # specials skipped
    assert isinstance(load_tokenizer(d2), HFTokenizer)
    assert isinstance(load_tokenizer(None), ByteTokenizer)


def test_without_transformers_the_flag_exits(tmp_path, monkeypatch):
    d = hf_tokenizer_dir(tmp_path, TEMPLATE)
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError, match="needs the transformers package"):
        HFTokenizer(d)
    with pytest.raises(SystemExit, match="--tokenizer: .*transformers"):
        tapi.make_server(SERVER + ["--tokenizer", d])
