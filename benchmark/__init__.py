"""The benchmark of ``llm_instance_gateway_tpu_torch`` on NVIDIA GPUs.

One run serves one cell of ``BENCHMARK.json`` (a model configuration under
a traffic mix) through the engine ``api_http.make_server`` builds:

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything a cell needs is found by name: the configuration in
``benchmark/configs/<config>.json``, the traffic mix in
``benchmark/traffic/<mix>.json`` (parameters read by the one generator,
``benchmark/generator.py``) and each per-layer metric's reader in
``benchmark/metrics/<metric>.py``.  The plain reference that decides
``correct`` is ``benchmark/reference.py``; it imports nothing of the port.
"""
