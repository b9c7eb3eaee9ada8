"""phi_build_share.flow: the program's ``flow.build`` spans in the untraced
window over the window, in percent: building each flow's state: phi's
construction and power iterations, the points and their optimiser
(``portbench.program_records``)."""

from portbench.program_records import span_share


def read(run):
    return span_share(run, "flow.build")
