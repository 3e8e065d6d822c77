"""Tokenizers for the model server (port of ``server/tokenizer.py``).

The default is a self-contained byte-level tokenizer (UTF-8 bytes +
specials), so the server runs hermetically.  ``HFTokenizer`` wraps a
local ``transformers`` tokenizer directory (``--tokenizer``) with its chat
template.  ``transformers`` is imported when one is built, never at
module level: where it is not installed (the host that serves the port
on the card has none), building one raises, naming it, and nothing falls
back to the byte tokenizer.
"""

from __future__ import annotations

BOS_ID = 256
EOS_ID = 257
PAD_ID = 258
BYTE_VOCAB = 259


class ByteTokenizer:
    """UTF-8 byte tokenizer: ids 0..255 are bytes, then BOS/EOS/PAD."""

    vocab_size = BYTE_VOCAB
    bos_id = BOS_ID
    eos_id = EOS_ID
    pad_id = PAD_ID

    def encode(self, text: str, add_bos: bool = True) -> list[int]:
        ids = list(text.encode("utf-8"))
        return [BOS_ID] + ids if add_bos else ids

    def decode(self, ids: list[int]) -> str:
        data = bytes(i for i in ids if 0 <= i < 256)
        return data.decode("utf-8", errors="replace")


class HFTokenizer:
    """Local HuggingFace tokenizer wrapper (no network access)."""

    def __init__(self, path: str):
        try:
            from transformers import AutoTokenizer  # local files only
        except ImportError as e:
            raise ImportError(
                f"tokenizer {path}: an HF tokenizer needs the transformers "
                "package, which is not installed here") from e

        self._tok = AutoTokenizer.from_pretrained(path, local_files_only=True)
        self.vocab_size = self._tok.vocab_size
        # Explicit None checks: `or 0` would turn a missing special token
        # into id 0, which the engine would then stop on (eos) or prepend
        # to every prompt (bos).  The engine takes eos_id=None.
        self.bos_id = self._tok.bos_token_id  # may be None: no BOS prepended
        self.eos_id = self._tok.eos_token_id  # may be None: length-capped only
        self.pad_id = (
            self._tok.pad_token_id if self._tok.pad_token_id is not None
            else (self.eos_id if self.eos_id is not None else 0)
        )

    def encode(self, text: str, add_bos: bool = True) -> list[int]:
        ids = self._tok.encode(text, add_special_tokens=False)
        if add_bos and self.bos_id is not None:
            return [self.bos_id] + ids
        return ids

    def decode(self, ids: list[int]) -> str:
        return self._tok.decode(ids, skip_special_tokens=True)

    def apply_chat_template(self, messages: list[dict]) -> str | None:
        """The model's own chat template over OpenAI-shaped messages (with
        the generation prompt appended), or None when the tokenizer ships
        no template: the server then uses the role-prefix transcript."""
        if not getattr(self._tok, "chat_template", None):
            return None
        return self._tok.apply_chat_template(
            messages, tokenize=False, add_generation_prompt=True)


def load_tokenizer(path: str | None = None):
    return HFTokenizer(path) if path else ByteTokenizer()
