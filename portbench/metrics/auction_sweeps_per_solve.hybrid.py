"""auction_sweeps_per_solve.hybrid: K2's sweeps per problem solved in the
captured train step: the step's device counters ``auction_sweeps`` (summed
over the batch and both solves) over ``auction_problems`` (the batch size
per solve), the last replay's at each collect in the untraced window,
weighted by the replays it covers. None where the program keeps no such
counters."""

from portbench.program_records import collects


def read(run):
    found = [a for a in collects(run, "train step") if "auction_sweeps" in a.get("counts", {})]
    problems = sum(a["replays"] * a["counts"].get("auction_problems", 0) for a in found)
    if not problems:
        return None
    return sum(a["replays"] * a["counts"]["auction_sweeps"] for a in found) / problems
