"""flow_ms_per_iter: the whole window's milliseconds over the flow
iterations completed; captures, warm-up steps and host copies count."""


def read(run):
    iterations = run.counts.get("flow_iterations")
    return None if not iterations else 1e3 * run.window_s / iterations
