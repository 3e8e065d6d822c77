"""Byte-level tokenizer (the port's own copy of the reference's).

Self-contained UTF-8 bytes + specials, so the server runs hermetically.
The reference's ``HFTokenizer`` is not ported yet: ``transformers`` is not
installed where the port runs on the card.
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


def load_tokenizer(path: str | None = None):
    if path:
        raise NotImplementedError(
            "local HF tokenizers are not ported yet (ROADMAP Queue 1, model "
            "families); the port serves the byte tokenizer")
    return ByteTokenizer()
