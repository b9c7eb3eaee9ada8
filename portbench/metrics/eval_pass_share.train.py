"""eval_pass_share.train: the program's ``train.eval_pass`` spans in the
untraced window over the window, in percent: the validation passes
(``Trainer.eval_one_epoch``) (``portbench.program_records``)."""

from portbench.program_records import span_share


def read(run):
    return span_share(run, "train.eval_pass")
