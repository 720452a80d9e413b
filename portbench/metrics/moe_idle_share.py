"""The device's idle time inside the DeepSeekMoE layers, as a share of the
traced window, in %: the idle gaps whose middle falls inside a
``marlin.moe.*`` span (route, dispatch with its host read of the experts'
counts, experts, combine); the idlest card's. The rule is
``program_idle_share.idle_in``'s."""

import os

from portbench.harness import _module

_rule = _module(os.path.join(os.path.dirname(__file__),
                             "program_idle_share.py"),
                "portbench_metric_program_idle_share")


def read(run):
    return _rule.share(run, lambda n: n.startswith("marlin.moe."))
