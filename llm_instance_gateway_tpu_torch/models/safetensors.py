"""Reader and writer of the safetensors format, in torch alone.

The host that serves the port on the card has no ``safetensors`` package,
so the port keeps its own copy of the format: an 8-byte little-endian
header length, a JSON header ``{name: {"dtype", "shape", "data_offsets"}}``
(plus an optional ``"__metadata__"`` of strings), then the tensors' raw
little-endian bytes, each at its ``data_offsets`` from the end of the
header.

``load_file`` maps the file (``mmap``) and gives each tensor as
``torch.frombuffer`` over the map: nothing is read until a tensor is
used, and the loader (``models/convert.py``) copies each one straight to
its device, so the host never holds a copy of the tree.  The map is
read-only: ``torch.frombuffer`` warns about that (the warning is silenced
here), and nothing may write through these tensors.  ``load_checkpoint``
follows ``model.safetensors.index.json``'s ``weight_map`` across shards.

Malformed files are refused with the file's name: a header longer than
the file, ``data_offsets`` out of range or overlapping, a byte count that
does not match dtype x shape, and an unknown dtype.  ``save_file`` is the
inverse (the tests and ``chip_smoke.py`` write checkpoints with it).
"""

from __future__ import annotations

import json
import math
import mmap
import os
import struct
import warnings

import torch

DTYPES = {
    "BF16": torch.bfloat16,
    "F16": torch.float16,
    "F32": torch.float32,
    "I8": torch.int8,
    "I32": torch.int32,
    "I64": torch.int64,
    "U8": torch.uint8,
    "BOOL": torch.bool,
}
_NAMES = {v: k for k, v in DTYPES.items()}
# A header beyond this is refused before it is read (the format's own cap).
MAX_HEADER_BYTES = 100 * 1024 * 1024
INDEX_FILE = "model.safetensors.index.json"
SINGLE_FILE = "model.safetensors"


class SafetensorsError(ValueError):
    """A malformed safetensors file (the message names it)."""


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def read_header(path: str) -> tuple[dict, int, int]:
    """(tensor entries, data start, file size) of one file, validated;
    ``__metadata__`` is dropped from the entries."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) < 8:
            raise SafetensorsError(f"{path}: shorter than the 8-byte header "
                                   "length")
        (n,) = struct.unpack("<Q", head)
        if n > min(size - 8, MAX_HEADER_BYTES):
            raise SafetensorsError(f"{path}: header length {n} exceeds the "
                                   f"file ({size} bytes)")
        try:
            header = json.loads(f.read(n))
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise SafetensorsError(f"{path}: header is not JSON: {e}") from e
    if not isinstance(header, dict):
        raise SafetensorsError(f"{path}: header is not a JSON object")
    header.pop("__metadata__", None)
    start = 8 + n
    spans = []
    for name, entry in header.items():
        dtype = DTYPES.get(entry.get("dtype"))
        if dtype is None:
            raise SafetensorsError(f"{path}: tensor {name!r} has unknown "
                                   f"dtype {entry.get('dtype')!r}")
        begin, end = entry["data_offsets"]
        if not 0 <= begin <= end <= size - start:
            raise SafetensorsError(
                f"{path}: tensor {name!r} data_offsets [{begin}, {end}] out "
                f"of range (data is {size - start} bytes)")
        want = math.prod(entry["shape"]) * _itemsize(dtype)
        if end - begin != want:
            raise SafetensorsError(
                f"{path}: tensor {name!r} holds {end - begin} bytes, "
                f"{entry['dtype']} x {entry['shape']} needs {want}")
        spans.append((begin, end, name))
    spans.sort()
    for (_, end_a, a), (begin_b, _, b) in zip(spans, spans[1:]):
        if begin_b < end_a:
            raise SafetensorsError(f"{path}: tensors {a!r} and {b!r} "
                                   "overlap")
    return header, start, size


def load_file(path: str) -> dict[str, torch.Tensor]:
    """Name -> CPU tensor over a read-only map of the file (never written
    through; copy it to where it is used)."""
    header, start, size = read_header(path)
    out: dict[str, torch.Tensor] = {}
    mm = None
    if size > start:
        with open(path, "rb") as f:
            mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
    for name, entry in header.items():
        dtype = DTYPES[entry["dtype"]]
        shape = tuple(entry["shape"])
        begin, end = entry["data_offsets"]
        if begin == end:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message=".*not writable.*")
            t = torch.frombuffer(mm, dtype=dtype,
                                 count=(end - begin) // _itemsize(dtype),
                                 offset=start + begin)
        out[name] = t.view(shape)
    return out


def is_checkpoint(directory: str) -> bool:
    """Whether ``directory`` holds ``model.safetensors`` or an index."""
    return any(os.path.isfile(os.path.join(directory, name))
               for name in (SINGLE_FILE, INDEX_FILE))


def load_checkpoint(directory: str) -> dict[str, torch.Tensor]:
    """Every tensor of an HF directory, across the index's shards (each
    name read from the shard the ``weight_map`` gives it)."""
    index = os.path.join(directory, INDEX_FILE)
    if not os.path.exists(index):
        return load_file(os.path.join(directory, SINGLE_FILE))
    with open(index) as f:
        weight_map = json.load(f)["weight_map"]
    shards = {name: load_file(os.path.join(directory, name))
              for name in sorted(set(weight_map.values()))}
    out = {}
    for name, shard in weight_map.items():
        if name not in shards[shard]:
            raise SafetensorsError(f"{os.path.join(directory, shard)}: no "
                                   f"tensor {name!r}, which {index} maps "
                                   "there")
        out[name] = shards[shard][name]
    return out


def tensor_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def save_file(tensors: dict, path: str, metadata: dict | None = None) -> int:
    """Write ``tensors`` (name -> tensor, on any device, any layout) as one
    safetensors file; returns the bytes written.  Each tensor is copied to
    the host one at a time."""
    header: dict = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    offset = 0
    for name, t in tensors.items():
        if t.dtype not in _NAMES:
            raise SafetensorsError(f"{path}: tensor {name!r} has dtype "
                                   f"{t.dtype}, which the format's reader "
                                   "here does not take")
        n = tensor_bytes(t)
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)  # the data starts 8-byte aligned
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for t in tensors.values():
            if t.numel():
                host = t.detach().contiguous().cpu().reshape(-1)
                f.write(memoryview(host.view(torch.uint8).numpy()))
    return 8 + len(blob) + offset
