"""train_clouds_per_s: training clouds stepped over the whole window's
seconds; validation passes and epoch boundaries count in the window."""


def read(run):
    clouds = run.counts.get("train_clouds")
    return None if clouds is None else clouds / run.window_s
