"""warm_prices_ms.hybrid: device ms per replay of the captured train step
spent in the cold solve's annealed-Sinkhorn warm-up of the auction's prices
(mark ``warm_prices``): the last replay's time at each collect in the
untraced window, weighted by the replays it covers
(``portbench.program_records``)."""

from portbench.program_records import mark_ms


def read(run):
    return mark_ms(run, "train step", ('warm_prices',))
