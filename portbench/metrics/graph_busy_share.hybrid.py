"""graph_busy_share.hybrid: the device time of every captured step replayed
in the untraced window (each collect's replays times its last replay's
whole-step ms, the mark ``graph``) over the window, in percent
(``portbench.program_records``)."""

from portbench.program_records import graph_busy_share


def read(run):
    return graph_busy_share(run)
