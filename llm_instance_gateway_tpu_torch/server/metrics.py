"""Prometheus exposition for the model server — the gateway's scrape contract.

The port's own copy of the reference's ``server/metrics.py``: the same
``tpu:*`` family names and label sets, so the unchanged gateway
(``gateway/metrics_client.py``) scrapes a torch pod exactly like a JAX
pod.  Only the families the port's engine produces are rendered.
"""

from __future__ import annotations

import time

from llm_instance_gateway_tpu_torch.server.kv_ledger import render_kv
from llm_instance_gateway_tpu_torch.server.profiler import render_profile
from llm_instance_gateway_tpu_torch.server.usage import render_usage
from llm_instance_gateway_tpu_torch.tracing import escape_label, render_histogram

PHASE_FAMILIES = (
    ("prefill", "tpu:prefill_seconds"),
    ("handoff", "tpu:handoff_seconds"),
    ("decode_step", "tpu:decode_step_seconds"),
)


def render(snapshot: dict, extra: dict | None = None) -> str:
    """Render an ``Engine.metrics_snapshot()`` dict to exposition text."""
    lines = [
        "# TYPE tpu:prefill_queue_size gauge",
        f"tpu:prefill_queue_size {snapshot['prefill_queue_size']}",
        "# TYPE tpu:decode_queue_size gauge",
        f"tpu:decode_queue_size {snapshot['decode_queue_size']}",
        "# TYPE tpu:num_requests_running gauge",
        f"tpu:num_requests_running {snapshot['num_requests_running']}",
        "# TYPE tpu:num_requests_waiting gauge",
        f"tpu:num_requests_waiting {snapshot['num_requests_waiting']}",
        "# TYPE tpu:kv_cache_usage_perc gauge",
        f"tpu:kv_cache_usage_perc {snapshot['kv_cache_usage_perc']:.6f}",
        "# TYPE tpu:kv_tokens_capacity gauge",
        f"tpu:kv_tokens_capacity {snapshot['kv_tokens_capacity']}",
        "# TYPE tpu:kv_tokens_free gauge",
        f"tpu:kv_tokens_free {snapshot['kv_tokens_free']}",
        "# TYPE tpu:kv_parked_tokens gauge",
        f"tpu:kv_parked_tokens {snapshot.get('kv_parked_tokens', 0)}",
        "# TYPE tpu:decode_tokens_per_sec gauge",
        f"tpu:decode_tokens_per_sec {snapshot['decode_tokens_per_sec']:.3f}",
        "# TYPE tpu:lora_requests_info gauge",
        'tpu:lora_requests_info{running_lora_adapters="%s",'
        'waiting_lora_adapters="%s",max_lora="%d",adapter_ranks="%s",'
        'resident_tiers="%s"} %f'
        % (
            escape_label(",".join(snapshot.get("running_lora_adapters", []))),
            escape_label(",".join(snapshot.get("waiting_lora_adapters", []))),
            snapshot.get("max_lora", 0),
            escape_label(",".join(
                f"{name}:{rank}" for name, rank in sorted(
                    snapshot.get("adapter_ranks", {}).items()))),
            escape_label(",".join(
                f"{name}:{tier}"
                for tier, names in sorted(
                    (snapshot.get("residency") or {}).items())
                for name in names)),
            time.time(),
        ),
    ]
    if "residency" in snapshot:
        lines.append("# TYPE tpu:adapter_residency_info gauge")
        now = time.time()
        for tier in sorted(snapshot["residency"]):
            names = snapshot["residency"][tier]
            lines.append(
                'tpu:adapter_residency_info{tier="%s",adapters="%s"} %f'
                % (escape_label(tier), escape_label(",".join(names)), now))
        transitions = snapshot.get("tier_transitions") or {}
        lines.append("# TYPE tpu:adapter_tier_transitions_total counter")
        if transitions:
            for (frm, to) in sorted(transitions):
                lines.append(
                    'tpu:adapter_tier_transitions_total{from="%s",to="%s"} %d'
                    % (escape_label(frm), escape_label(to),
                       transitions[(frm, to)]))
        else:
            lines.append("tpu:adapter_tier_transitions_total 0")
        load_seconds = snapshot.get("adapter_load_seconds") or {}
        lines.append("# TYPE tpu:adapter_load_seconds_total counter")
        lines.append("# TYPE tpu:adapter_loads_total counter")
        for tier in sorted(load_seconds):
            total_s, count = load_seconds[tier]
            lines.append('tpu:adapter_load_seconds_total{tier="%s"} %.6f'
                         % (escape_label(tier), total_s))
            lines.append('tpu:adapter_loads_total{tier="%s"} %d'
                         % (escape_label(tier), count))
    if snapshot.get("pool_role"):
        lines += [
            "# TYPE tpu:pool_role gauge",
            'tpu:pool_role{role="%s"} 1' % escape_label(snapshot["pool_role"]),
        ]
    if "prefix_reused_tokens" in snapshot:
        lines += [
            "# TYPE tpu:prefix_reused_tokens counter",
            f"tpu:prefix_reused_tokens {snapshot['prefix_reused_tokens']}",
        ]
    if "spec_cycles" in snapshot:
        lines += [
            "# TYPE tpu:spec_cycles counter",
            f"tpu:spec_cycles {snapshot['spec_cycles']}",
            "# TYPE tpu:spec_tokens_per_cycle gauge",
            f"tpu:spec_tokens_per_cycle {snapshot['spec_tokens_per_cycle']}",
        ]
    if "stream_lanes" in snapshot:
        lines += [
            "# TYPE tpu:stream_lanes gauge",
            f"tpu:stream_lanes {snapshot['stream_lanes']}",
            "# TYPE tpu:stream_lanes_active gauge",
            f"tpu:stream_lanes_active {snapshot.get('stream_lanes_active', 0)}",
        ]
    if snapshot.get("dispatch_steps_hist"):
        lines += render_histogram("tpu:dispatch_steps",
                                  snapshot["dispatch_steps_hist"], {})
    phase_hist = snapshot.get("phase_hist") or {}
    if phase_hist:
        labels = {"model": snapshot.get("model_name", ""),
                  "role": snapshot.get("pool_role", "") or "collocated"}
        for key, family in PHASE_FAMILIES:
            if key in phase_hist:
                lines += render_histogram(family, phase_hist[key], labels)
    if snapshot.get("usage"):
        lines += render_usage(snapshot["usage"], snapshot.get("model_name", ""))
    if snapshot.get("kv_ledger"):
        lines += render_kv(snapshot["kv_ledger"])
    if snapshot.get("profile"):
        lines += render_profile(snapshot["profile"])
    for name, value in (extra or {}).items():
        lines.append(f"# TYPE {name} gauge")
        lines.append(f"{name} {value}")
    return "\n".join(lines) + "\n"
