"""Load clients.

- ``closed_loop``: copied from ``yet_another_mobilenet_series_tpu_torch/bench/serve_bench.py``
  ``_drive_concurrent`` (closed-loop clients: each sends, waits for the answer, sends again),
  changed to run for a fixed window instead of a fixed count, to send each client's own
  sequence of requests, and to keep every request's send and answer times;
- ``open_loop``: the pattern of ``serve_bench.py`` ``_chaos_round``: arrivals fire on their
  schedule whatever the completions, each request timed from when it was due to when its future
  resolved (stamped by a done-callback), and how late the generator sent it kept beside. No cell
  uses it yet; it is here for an online cell.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Sequence


@dataclass
class Record:
    client: int
    index: int  # the request's place in its client's sequence
    request: Any
    sent: float  # perf_counter seconds
    done: float
    answer: Any = None
    error: str | None = None


def closed_loop(send: Callable[[int, Any], Any], sequences: Sequence[Sequence[Any]], seconds: float,
                keep: Callable[[int, int], bool] = lambda c, i: False) -> tuple[list[Record], float, float]:
    """Client c sends ``sequences[c]`` in order (cycling) through ``send(c, request)``, each
    request after the previous one's answer, until ``seconds`` have passed since the start.
    Returns the records of every request sent (the answer kept where ``keep(c, i)``), the start
    and the window's end. A request in flight at the end still completes and is recorded."""
    lock = threading.Lock()
    records: list[Record] = []
    start = time.perf_counter()
    end = start + seconds

    def client(c: int):
        seq = sequences[c]
        i = 0
        while time.perf_counter() < end:
            req = seq[i % len(seq)]
            t0 = time.perf_counter()
            try:
                answer, error = send(c, req), None
            except Exception as e:  # noqa: BLE001 — a failed request is counted, not fatal
                answer, error = None, f"{type(e).__name__}: {e}"
            t1 = time.perf_counter()
            rec = Record(c, i, req, t0, t1, answer if keep(c, i) else None, error)
            with lock:
                records.append(rec)
            i += 1

    threads = [threading.Thread(target=client, args=(c,), name=f"bench-client-{c}") for c in range(len(sequences))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return records, start, end


@dataclass
class Arrival:
    index: int
    request: Any
    due: float
    sent: float
    done: float | None = None
    error: str | None = None


def open_loop(submit: Callable[[Any], Any], requests: Sequence[Any], gaps_s: Sequence[float],
              result_timeout_s: float = 60.0) -> tuple[list[Arrival], float]:
    """Send ``requests[i]`` when due (the start plus the first i+1 gaps), whatever the
    completions; ``submit`` returns a future. Each request's latency runs from ``due`` to when
    its future resolved; ``sent - due`` is how late the generator ran. Returns the arrivals and
    the start; one still pending ``result_timeout_s`` after the last send keeps ``done`` None."""
    arrivals: list[Arrival] = []
    futures = []
    start = time.perf_counter()
    due = start
    for i, (req, gap) in enumerate(zip(requests, gaps_s)):
        due += gap
        delay = due - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        a = Arrival(i, req, due, time.perf_counter())
        arrivals.append(a)
        try:
            fut = submit(req)
        except Exception as e:  # noqa: BLE001 — a rejection at arrival
            a.error = f"{type(e).__name__}: {e}"
            continue
        fut.add_done_callback(lambda f, a=a: setattr(a, "done", time.perf_counter()))
        futures.append((a, fut))
    for a, fut in futures:
        try:
            fut.result(timeout=result_timeout_s)
        except Exception as e:  # noqa: BLE001 — a failed or late request is recorded
            a.error = f"{type(e).__name__}: {e}"
    return arrivals, start
