"""Reader of the JAX package's Orbax trees, without JAX.

The JAX package writes LoRA adapters (``server/lora_manager.save_adapter``)
and serving checkpoints (``models/convert.save_hf_as_orbax``) with Orbax's
``PyTreeCheckpointer``: an OCDBT key-value store (zstd-compressed, so no
reader is written by hand here) holding one zarr array per leaf, and a
plain-JSON ``_METADATA`` whose ``tree_metadata`` names every leaf by its
key path.  ``tensorstore`` reads the store on its own, so this module
needs neither JAX nor Orbax:

- the tree's structure comes from ``_METADATA``'s key paths (a leaf such
  as ``("layers", "wq")`` is the one array ``layers.wq``: the keys are
  joined with ``.``, never guessed);
- each leaf opens as a ``zarr`` array in the ``ocdbt`` kvstore at
  ``file://<dir>``, and a stacked leaf is read one layer at a time
  (``Leaf.read(i)``), so a 30 GB expert stack never sits on the host
  whole;
- bfloat16 leaves cross to torch through a ``uint16`` view.

``tensorstore`` is imported inside ``open_tree``.  Where it is missing
(the host that serves the port on the card has none), reading a tree
raises ``OrbaxTreeError`` naming the directory and the package: there is
no fallback.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

METADATA = "_METADATA"


class OrbaxTreeError(RuntimeError):
    """An Orbax tree that cannot be read here (the message says why)."""


def is_orbax_tree(path: str) -> bool:
    return os.path.isfile(os.path.join(path, METADATA))


def _tensor(arr) -> torch.Tensor:
    """A numpy array (tensorstore's bfloat16 included) -> CPU tensor, bits
    kept."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class Leaf:
    """One array of the tree: ``shape``, and ``read()`` (the whole leaf)
    or ``read(i)`` (its ``i``-th slice along the first axis), each a CPU
    tensor."""

    def __init__(self, store, name: str):
        self._store = store
        self.name = name
        self.shape = tuple(int(n) for n in store.shape)

    def read(self, index: int | None = None) -> torch.Tensor:
        view = self._store if index is None else self._store[index]
        return _tensor(view.read().result())


def open_tree(path: str) -> dict:
    """The tree at ``path`` as nested dicts of ``Leaf`` (nothing read
    yet)."""
    meta_file = os.path.join(path, METADATA)
    if not os.path.isfile(meta_file):
        raise OrbaxTreeError(f"{path}: no {METADATA}, so not an Orbax tree")
    try:
        import tensorstore as ts
    except ImportError as e:
        raise OrbaxTreeError(
            f"{path} is an Orbax tree; reading one needs the tensorstore "
            "package, which is not installed here") from e
    with open(meta_file) as f:
        meta = json.load(f)
    array_format = "zarr3" if meta.get("use_zarr3") else "zarr"
    base = "file://" + os.path.abspath(path)
    tree: dict = {}
    for entry in meta["tree_metadata"].values():
        keys = [k["key"] for k in entry["key_metadata"]]
        if any(k.get("key_type") != 2 for k in entry["key_metadata"]):
            raise OrbaxTreeError(f"{path}: leaf {keys} is not under dict "
                                 "keys (only nested dicts are read)")
        name = ".".join(keys)
        try:
            store = ts.open({"driver": array_format,
                             "kvstore": {"driver": "ocdbt", "base": base,
                                         "path": name}},
                            open=True).result()
        except Exception as e:
            raise OrbaxTreeError(f"{path}: leaf {name!r} cannot be opened: "
                                 f"{e}") from e
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = Leaf(store, name)
    return tree


def read_tree(path: str) -> dict:
    """The whole tree as nested dicts of CPU tensors (small trees:
    adapters)."""
    def walk(node):
        if isinstance(node, Leaf):
            return node.read()
        return {k: walk(v) for k, v in node.items()}
    return walk(open_tree(path))
