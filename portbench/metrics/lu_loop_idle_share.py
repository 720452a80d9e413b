"""The device's idle time inside the blocked LU's block steps, as a share
of the traced window, in %: rank 0's idle gaps whose middle falls inside a
``marlin.lu.step`` span. The rule is ``program_idle_share.idle_in``'s."""

import os

from portbench.harness import _module

_rule = _module(os.path.join(os.path.dirname(__file__),
                             "program_idle_share.py"),
                "portbench_metric_program_idle_share")


def read(run):
    return _rule.share(run, lambda n: n == "marlin.lu.step", ranks=[0])
