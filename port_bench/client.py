"""The load generator: a process of its own, so that its interpreter does
not compete with the server's dispatch thread for the GIL.

Run by the harness as ``python3 port_bench/client.py``; it imports the
standard library, numpy and the benchmark's traffic and vocabulary modules,
never torch. It speaks JSON lines over its standard input and output:

1. reads ``{"traffic", "seed", "seconds", "rate", "vocab_seed"}``, makes the run's
   schedule (``traffic.schedule``) and prints ``{"ready": true}``;
2. reads ``{"port", "t0"}`` (the server's port; the window's opening,
   ``time.monotonic()``, which both processes read from the same clock)
   and sends ``POST /generate``
   over a fresh loopback connection per request: in an open loop each at
   its due time, in a closed loop as each caller's bursts complete, until
   the window closes; then waits for every request sent, at most
   ``GRACE_S`` past the close;
3. prints ``{"records": [...]}``: per request its index, due, sent and done
   times, status, the ``X-Seed`` header and the body's length;
4. reads ``{"want": [indices]}`` and prints ``{"pngs": {index: base64}}``.
"""

from __future__ import annotations

import base64
import http.client
import json
import os
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor, wait
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from port_bench import traffic, vocab  # noqa: E402

GRACE_S = 60.0
TIMEOUT_S = 300.0
MAX_IN_FLIGHT = 256  # requests the generator keeps open at once


def _say(obj) -> None:
    sys.stdout.write(json.dumps(obj) + "\n")
    sys.stdout.flush()


def _read() -> dict:
    line = sys.stdin.readline()
    if not line:
        raise SystemExit(0)
    return json.loads(line)


class Client:
    def __init__(self, port: int, mix: dict):
        self.port = port
        self.mix = mix
        self.records = {}
        self.bodies = {}
        self.lock = threading.Lock()

    def send(self, req: traffic.Request, due: float) -> None:
        rec = {"index": req.index, "seed": req.seed, "due": due, "sent": time.monotonic(),
               "status": None}
        with self.lock:
            self.records[req.index] = rec
        body = json.dumps(req.body(self.mix)).encode()
        conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=TIMEOUT_S)
        try:
            conn.request("POST", "/generate", body=body,
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            data = resp.read()
            rec.update(done=time.monotonic(), status=resp.status,
                       x_seed=resp.getheader("X-Seed"), nbytes=len(data))
            if resp.status == 200:
                with self.lock:
                    self.bodies[req.index] = data
        except (OSError, http.client.HTTPException) as e:
            rec.update(done=time.monotonic(), error=repr(e))
        finally:
            conn.close()

    def open_loop(self, reqs, t0: float, pool: ThreadPoolExecutor) -> list:
        futures = []
        for req in reqs:
            due = t0 + req.due_s
            delay = due - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            futures.append(pool.submit(self.send, req, due))
        return futures

    def closed_loop(self, reqs, t0: float, end: float, pool: ThreadPoolExecutor) -> list:
        futures, lock = [], threading.Lock()
        bursts = {}
        for r in reqs:
            bursts.setdefault(r.client, {}).setdefault(r.burst, []).append(r)

        def caller(mine):
            for b in sorted(mine):
                now = time.monotonic()
                if now >= end:
                    return
                fs = [pool.submit(self.send, r, now) for r in mine[b]]
                with lock:
                    futures.extend(fs)
                wait(fs)

        while time.monotonic() < t0:
            time.sleep(min(0.001, max(t0 - time.monotonic(), 0)))
        threads = [threading.Thread(target=caller, args=(mine,)) for mine in bursts.values()]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return futures


def main() -> int:
    job = _read()
    mix = job["traffic"]
    # the words of the served vocabulary (made from the seed the system was built with)
    words, _, _ = vocab.make(traffic.stream(job.get("vocab_seed", job["seed"]), "vocab"))
    reqs = traffic.schedule(mix, job["seed"], job["seconds"], words, rate=job.get("rate"))
    _say({"ready": True, "requests": len(reqs)})
    go = _read()
    client, t0 = Client(go["port"], mix), go["t0"]
    end = t0 + job["seconds"]
    pool = ThreadPoolExecutor(max_workers=MAX_IN_FLIGHT)
    if mix["loop"] == "open":
        futures = client.open_loop(reqs, t0, pool)
    else:
        futures = client.closed_loop(reqs, t0, end, pool)
    wait(futures, timeout=max(end + GRACE_S - time.monotonic(), 0.0))
    with client.lock:
        records = sorted((dict(r) for r in client.records.values()), key=lambda r: r["index"])
    _say({"records": records})
    want = _read()["want"]
    with client.lock:
        _say({"pngs": {str(i): base64.b64encode(client.bodies[i]).decode()
                       for i in want if i in client.bodies}})
    return 0


if __name__ == "__main__":
    code = main()
    sys.stdout.flush()
    # a request still out after the grace period is never answered: its
    # thread is left behind, not waited for
    os._exit(code)
