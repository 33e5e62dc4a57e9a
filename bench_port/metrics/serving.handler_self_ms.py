"""Median self time of the POST /chat_pro requests that ended in the traced sub-window (ms): each http.request span's duration less what its child spans cover, so the auth, body, JSON and socket write."""

from bench_port.harness import spans


def read(records):
    return spans.handler_self_ms(records)
