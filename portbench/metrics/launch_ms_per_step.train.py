"""launch_ms_per_step.train: host ms per train step spent inside the step
graph's call: the copies into its static inputs and the replay's launch (the
``train.pass`` spans' ``launch_s`` over their ``steps``, in the untraced
window; ``portbench.program_records``)."""

from portbench.program_records import pass_ms_per_step


def read(run):
    return pass_ms_per_step(run, "launch_s")
