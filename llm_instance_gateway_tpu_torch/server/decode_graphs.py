"""CUDA graphs of the engine's fused blocks: the decode block and the
speculative block.

The reference compiles each block once per shape
(``jax.jit(_decode_impl, static_argnames=("n_steps", "penalized"))``, and
``_spec_block_impl`` per ``(n_cycles, k_steps)``) and the TPU then runs one
program per dispatch.  Here the counterpart is a CUDA graph of the block,
captured once per key and replayed: the decode block per ``(n_steps,
seeded, penalized)``, the spec block per ``(n_cycles, k, seeded)``.  The
eager block issues thousands of small launches per step from Python, a
replay issues one.

A graph reads and writes fixed addresses, so everything the block touches
keeps its address for the graph's life: the engine's static carry and slot
buffers (the penalty counts and the draft's catch-up triple included), both
caches (tables and lengths written in place), the params and the LoRA
buffers (slots written in place).  Rules on the card:

- capture happens on the engine thread, once per key, after one eager
  warm-up of each block with every row inactive (it loads the kernel
  libraries and runs their one-time setup, creates the thread's cuBLAS
  handle, and changes no state a later row reads);
- every key of both blocks shares one memory pool: one block replays at a
  time, and the engine copies a block's output to the host before the
  next replay;
- the engine's ``torch.Generator`` is registered with each graph, so
  sampled rows draw new noise on every replay;
- a failed capture or replay raises; there is no eager fallback on the card.

Launch accounting: the kernel wrappers count a launch where they launch,
which under capture records a launch that has not run.  A capture takes
back what its own thread's wrappers counted (``_build.thread_launches``:
another engine in the process may launch meanwhile) and keeps it as the
graph's launches; each replay adds them.
"""

from __future__ import annotations

import gc
import time

import torch

from llm_instance_gateway_tpu_torch.ops import (
    _build,
    chunk_attention,
    decode_attention,
    flash_attention,
    paged_decode_attention,
)

# Kernel library (the name its launches are tallied under per thread,
# ``_build.thread_launches``) -> its wrapper's counter (module, attribute).
_COUNTERS = {
    "flash_prefill": (flash_attention, "launches"),
    "decode_attention": (decode_attention, "launches"),
    "decode_attention_quant": (decode_attention, "quant_launches"),
    "chunk_attention": (chunk_attention, "launches"),
    "paged_decode_attention": (paged_decode_attention, "launches"),
    "paged_decode_attention_quant": (paged_decode_attention,
                                     "quant_launches"),
    "flash_backward": (flash_attention, "backward_launches"),
}


def launch_counts() -> dict[str, int]:
    """Every kernel wrapper's launch counter, by library."""
    return {lib: getattr(mod, attr) for lib, (mod, attr) in _COUNTERS.items()}


def add_launches(delta: dict[str, int]) -> None:
    for lib, d in delta.items():
        if d:
            mod, attr = _COUNTERS[lib]
            setattr(mod, attr, getattr(mod, attr) + d)


class DecodeGraphs:
    """The captured blocks of one engine.  ``block(*key)`` runs a fused
    block on the engine's static buffers and returns its output pack; it
    must be callable eagerly (warm-up) and under capture.  ``kind`` names
    the block ("decode" or "spec"), so the two blocks' keys never meet.
    A block is passed per call, not kept: an engine holding its graphs is
    then no reference cycle, and is freed (graphs, pool and caches) as
    soon as it is dropped."""

    def __init__(self, generator: torch.Generator, device: torch.device):
        self._gen = generator
        self._device = device
        self._stream = torch.cuda.Stream(device)
        self._pool = None
        # (kind, *key) -> (graph, static output, launches per replay)
        self._graphs: dict[tuple, tuple] = {}
        self.replays = 0
        # host seconds spent capturing, per (kind, *key)
        self.capture_s_by_key: dict[tuple, float] = {}

    @property
    def capture_s(self) -> float:
        return sum(self.capture_s_by_key.values())

    def _keys(self, kind: str) -> list[tuple]:
        return sorted(k[1:] for k in self._graphs if k[0] == kind)

    @property
    def shapes(self) -> list[tuple]:
        """The decode block's captured keys ``(n_steps, seeded,
        penalized)``."""
        return self._keys("decode")

    @property
    def spec_shapes(self) -> list[tuple]:
        """The spec block's captured keys ``(n_cycles, k, seeded)``."""
        return self._keys("spec")

    def warm_up(self, block, *key) -> None:
        """One eager run of ``block(*key)`` (default ``(1, True)``) on the
        capture stream; the caller guarantees that every row is inactive,
        so the cache and the carry stay as they were."""
        current = torch.cuda.current_stream(self._device)
        self._stream.wait_stream(current)
        with torch.cuda.stream(self._stream):
            block(*(key or (1, True)))
        current.wait_stream(self._stream)
        torch.cuda.synchronize(self._device)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()

    def run(self, block, *key, kind: str = "decode"):
        """Replay the graph of ``block(*key)`` (captured on first use);
        returns the static output, valid until the next replay."""
        if self._pool is None:
            raise RuntimeError("DecodeGraphs.run before warm_up")
        gkey = (kind, *key)
        entry = self._graphs.get(gkey)
        if entry is None:
            entry = self._graphs[gkey] = self._capture(block, gkey)
        graph, out, launches = entry
        graph.replay()
        add_launches(launches)
        self.replays += 1
        return out

    def _capture(self, block, gkey: tuple) -> tuple:
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self._gen)
        before = _build.thread_launches()
        # No garbage collection mid-capture: what it frees (device or
        # pinned host memory) is bookkept with CUDA calls the capture's
        # thread may not make.
        gc_was_enabled = gc.isenabled()
        gc.disable()
        try:
            # thread_local: the server's other threads (adapter loads,
            # scrapes) may call the CUDA runtime during a capture.
            with torch.cuda.graph(graph, pool=self._pool,
                                  stream=self._stream,
                                  capture_error_mode="thread_local"):
                out = block(*gkey[1:])
        finally:
            if gc_was_enabled:
                gc.enable()
            after = _build.thread_launches()
            mine = {lib: after.get(lib, 0) - before.get(lib, 0)
                    for lib in _COUNTERS}
            add_launches({lib: -n for lib, n in mine.items()})
            self.capture_s_by_key[gkey] = time.perf_counter() - t0
        return graph, out, mine
