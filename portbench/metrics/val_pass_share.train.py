"""val_pass_share.train: the host spans around ``eval_one_epoch`` over the
window, in percent (each pass ends in a host read of its sums)."""


def read(run):
    spent = run.spans.get("eval_one_epoch")
    return None if spent is None else 100.0 * spent / run.window_s
