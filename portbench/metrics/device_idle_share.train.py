"""device_idle_share.train: 1 - busy / the traced part's length, in
percent. Busy is the union of the graph replays' spans and the eager
device work, from the profiler's trace (``portbench.tracing``); nothing
where the profiler kept no node of the graphs launched."""

COUNT = "train_steps"


def read(run):
    summary = run.trace_summary
    if (summary is None or summary["busy_s"] is None or not run.counts.get(COUNT)
            or summary["window_s"] <= 0):
        return None
    return 100.0 * (1.0 - summary["busy_s"] / summary["window_s"])
