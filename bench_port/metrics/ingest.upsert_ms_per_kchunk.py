"""Time inside the index upsert and the catalogue write per thousand chunks upserted, for the calls that ended in the traced sub-window (ms)."""

from bench_port.harness import readers


def read(records):
    return readers.ms_per_kchunk(records, ("ingest.upsert", "ingest.catalogue"))
