"""Find the knee of an open-loop cell: one engine, set up once, driven at
each of a few rates in turn, each for ``--seconds``, with a line per rate:

    python3 -m benchmark.sweep --workload <name> --seed <n> --seconds <s> --rates 2 3 4 5

The knee is the highest rate whose backlog does not grow over the window:
requests due in its last third wait for admission no longer than those of
its first third (medians, with 0.25 s of slack).  A cell's mix then fixes
its rate at about 0.8 x the knee.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

from benchmark import generator, run, spec
from benchmark.window import nearest_rank


def summary(served, w: dict, rate: float, seconds: float) -> dict:
    win = run.make_window(served, w, seconds, 0.0)
    due = sorted(win.due(), key=lambda r: r.due)
    third = max(1, len(due) // 3)

    def wait(rs):
        return statistics.median(
            (r.t_prefill_start or win.deadline) - r.due for r in rs)
    first, last = wait(due[:third]), wait(due[-third:])
    done = [r.t_done for r in due if r.finished]
    unfinished = sum(1 for r in due if not r.finished)
    return {
        "rate_rps": rate, "requests": len(due), "unfinished": unfinished,
        "ttft_p90_ms": nearest_rank([win.ttft_s(r) for r in due], 0.9) * 1e3,
        "ttft_p50_ms": nearest_rank([win.ttft_s(r) for r in due], 0.5) * 1e3,
        "tpot_p90_ms": spec.metric_reader("tpot_p90_ms")(win),
        "queue_wait_first_third_s": first, "queue_wait_last_third_s": last,
        "drain_s": (max(done) - win.t1) if done else None,
        "growing": bool(last > first + 0.25),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.sweep")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--drain", type=float, default=20.0)
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    run._caches(spec.ROOT)
    served = run.Served(cell, args.seed, spec.ROOT)
    for k, rate in enumerate(args.rates):
        mix = dict(served.mix, rate_rps=rate, drain_s=args.drain)
        planned = generator.requests(mix, args.seed + k + 1, args.seconds,
                                     served.m["V"])
        w = served.window(planned, args.seconds, False, mix)
        print(json.dumps(summary(served, w, rate, args.seconds)), flush=True)
        run._idle(served.engine, run.IDLE_WAIT_S)
        time.sleep(1.0)
    served.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
