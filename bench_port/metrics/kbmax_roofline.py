"""K-bmax's share of its roofline (%): the least time of each launch's corpus, mask and query reads or its products, summed, over the launches' device time, in the traced sub-window."""

from bench_port.harness import readers


def read(records):
    return readers.roofline_pct(records, "K-bmax")
