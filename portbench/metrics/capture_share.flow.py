"""capture_share.flow: the program's ``flow.capture`` spans in the untraced
window over the window, in percent: each flow's warm-up step and capture
(``portbench.program_records``)."""

from portbench.program_records import span_share


def read(run):
    return span_share(run, "flow.capture")
