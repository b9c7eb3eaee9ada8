"""outside_steps_share.flow: the window less the flows' timed intervals
(``FlowResult.interval_seconds``), over the window, in percent: warm-up
steps, captures and host copies."""


def read(run):
    steps = run.spans.get("flow_intervals")
    return None if steps is None else 100.0 * (1.0 - steps / run.window_s)
