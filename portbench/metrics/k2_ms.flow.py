"""k2_ms.flow: device ms per replay of the captured flow step spent in K2's
launches, both solves (mark ``k2``): the last replay's time at each collect
in the untraced window, weighted by the replays it covers
(``portbench.program_records``)."""

from portbench.program_records import mark_ms


def read(run):
    return mark_ms(run, "flow step", ('k2',))
