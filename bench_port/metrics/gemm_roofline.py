"""K-gemm's share of its roofline (%) in the ingest cell's traced sub-window."""

from bench_port.harness import readers


def read(records):
    return readers.roofline_pct(records, "K-gemm")
