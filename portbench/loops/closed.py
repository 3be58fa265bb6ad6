"""Closed loop: one caller hands the program a whole batch and waits for its
results in host memory before it sends the next. Batches run, one at
least, while the window's time is not up; the window ends when the last
batch that started in it has returned.

End-to-end metrics: ops_per_s, the operations of every batch over the
window's seconds, and latency_p95_ms, the 95th percentile of every
operation's latency, which in a closed loop is its batch's time.
"""

import time

from portbench.harness import percentile


def run(cell):
    latencies, ops, i = [], [], 0
    start = end = time.perf_counter()
    while not i or end - start < cell.seconds:
        t0 = end
        done = cell.batch(i)
        end = time.perf_counter()
        latencies.append(end - t0)
        ops.append(done)
        i += 1
    window = end - start
    return {"attempted": sum(ops), "failed": 0,
            "metrics": {"ops_per_s": sum(ops) / window,
                        "latency_p95_ms": 1e3 * percentile(latencies, ops,
                                                           95)}}
