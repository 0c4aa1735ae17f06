"""flow_sweeps_per_round: relaxation sweeps (the program's ``flow.sweeps``
counter, one blocking read each) per flow estimate of a moving round
(calls of its ``flow.estimate`` span)."""

from benchmark.program_counters import install, snapshot, total  # noqa: F401


def read(run):
    snap = snapshot()
    rounds = None if snap is None else snap["spans"].get("flow.estimate", {}).get("calls", 0)
    return total(snap, "flow.sweeps") / rounds if rounds else None
