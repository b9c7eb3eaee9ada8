"""batch_ms_per_step.train: host ms per train step spent drawing each batch and
taking this rank's rows (the ``train.pass`` spans' ``batch_s`` over their
``steps``, in the untraced window; ``portbench.program_records``)."""

from portbench.program_records import pass_ms_per_step


def read(run):
    return pass_ms_per_step(run, "batch_s")
