"""The host's waits on the device a call: ``cudaStreamSynchronize``,
``cudaDeviceSynchronize`` and ``cudaEventSynchronize`` events whose middle
falls inside a call wholly inside the traced window, over those calls (a
call: an interval of the union of the entry spans,
``program_idle_share.ENTRY``); the largest over the ranks. Each wait
drains the launch queue, so the device idles for at least the host's time
to issue the next work."""

import os

from portbench.harness import _module

_rule = _module(os.path.join(os.path.dirname(__file__),
                             "program_idle_share.py"),
                "portbench_metric_program_idle_share")

WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize")


def read(run):
    if not run.trace:
        return None
    found = []
    for t in run.trace:
        calls = [iv for iv in _rule.spans(t, lambda n: n in _rule.ENTRY)
                 if 0.0 < iv[0] and iv[1] < t["window_s"]]
        if not calls:
            continue
        waits = sum(1 for s, e, n in t["host"]
                    if n in WAITS and _rule.inside(calls, (s + e) / 2))
        found.append(waits / len(calls))
    return max(found) if found else None
