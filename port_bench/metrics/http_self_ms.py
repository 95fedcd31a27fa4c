"""Median over the window's ``/generate`` requests answered 200 of the
server's own time, from the program's spans: the request's ``http.request``
(its head read to its response's last byte written, on the event loop)
less its ``http.await`` (the job's submit to its result back on the loop)."""

from port_bench.program_spans import self_ms


def read(run):
    return self_ms(run, "http.request", "http.await", path="/generate")
