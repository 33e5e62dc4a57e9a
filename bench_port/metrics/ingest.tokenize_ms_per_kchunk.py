"""Time in the runtime.tokenize spans under the ingest.text spans that ended in the traced sub-window, per thousand chunks those spans indexed (ms)."""

from bench_port.harness import spans


def read(records):
    return spans.ms_per_kchunk(records, "runtime.tokenize", "ingest.text")
