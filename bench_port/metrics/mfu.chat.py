"""The coalesced retrieval steps' share of the card's peak (%): their least time at real tokens over the time a step ran."""

from bench_port.harness import readers


def read(records):
    return readers.mfu_chat(records)
