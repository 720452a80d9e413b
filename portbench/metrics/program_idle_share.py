"""The device's idle time inside the program's calls, as a share of the
traced window, in %: the idle gaps whose middle falls inside an entry span
(``marlin.multiply``, ``marlin.lu_decompose``, ``marlin.lr``, recorded by
the program under the profiler); the idlest card's. The rest of
``idle_share`` lies outside the calls: the harness's loop and syncs.

The rule the span readers share (:func:`idle_in`): a rank's idle gaps are
the complement of the union of its device events over the window, and a
gap belongs to a set of spans when its middle lies inside the union of
that rank's host events of those names, the rule by which the harness
names its breakdown's gaps."""

from bisect import bisect_right

from portbench.harness import _union

ENTRY = ("marlin.multiply", "marlin.lu_decompose", "marlin.lr")


def spans(trace, match):
    """The disjoint, sorted union of ``trace``'s host events whose name
    ``match`` accepts."""
    return _union((s, e) for s, e, n in trace["host"] if match(n))


def inside(union, t) -> bool:
    """Whether ``t`` lies in one of the ``union``'s intervals."""
    i = bisect_right(union, [t, float("inf")]) - 1
    return i >= 0 and union[i][0] <= t <= union[i][1]


def idle_in(trace, match):
    """Seconds of ``trace``'s idle gaps whose middle lies inside a host
    event that ``match`` accepts by name; None where there is no such
    event."""
    within = spans(trace, match)
    if not within:
        return None
    busy = _union((s, e) for s, e, _ in trace["device"])
    edges = [0.0] + [x for iv in busy for x in iv] + [trace["window_s"]]
    return sum(e - s for s, e in zip(edges[::2], edges[1::2])
               if e > s and inside(within, (s + e) / 2))


def share(run, match, ranks=None):
    """``idle_in`` over the window, in %: the largest over the ranks
    (``ranks``: their indices, default all); None untraced or where no
    rank has a span ``match`` accepts."""
    if not run.trace:
        return None
    found = []
    for r in (range(len(run.trace)) if ranks is None else ranks):
        t = run.trace[r]
        idle = idle_in(t, match)
        if idle is not None:
            found.append(100.0 * (idle / t["window_s"]))
    return max(found) if found else None


def read(run):
    return share(run, lambda n: n in ENTRY)
