"""Time inside embed_text_batch per thousand chunks embedded, for the calls that ended in the traced sub-window (ms)."""

from bench_port.harness import readers


def read(records):
    return readers.ms_per_kchunk(records, ("ingest.embed",))
