"""phi_update_ms.train: device ms per replay of the captured train step spent
in phi's inner update: the objective's backward, Adam and the power
iteration (mark ``phi_update``): the last replay's time at each collect in
the untraced window, weighted by the replays it covers
(``portbench.program_records``)."""

from portbench.program_records import mark_ms


def read(run):
    return mark_ms(run, "train step", ('phi_update',))
