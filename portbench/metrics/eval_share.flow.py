"""eval_share.flow: the program's ``flow.eval`` spans in the untraced window
over the window, in percent: the host copies and ``eval_fn`` at each flow's
start and interval ends (``portbench.program_records``)."""

from portbench.program_records import span_share


def read(run):
    return span_share(run, "flow.eval")
