"""The load generator: controllers as threads of a process of its own,
each over its own JSON-lines TCP connection to the planning server, with
the protocol of the port's ``bench_serve.py`` client (a ping, one untimed
replan, then timed replans). Standard library only: it takes no interpreter
lock, memory or card time from the server's process.

Reads its plan as one JSON object on standard input::

    {"port": p, "loop": "closed" | "open", "seconds": s,
     "obs": [[obs of controller c's k-th request, ...], ...],
     "due": [[due time of request k >= 1, ...], ...] | null}

Connects the controllers one after another (the server makes their
sessions in that order), sends every controller's untimed replan (request
0) at once, prints ``ready <t0>`` and runs the window from t0. Closed loop:
each controller sends its next request when its reply comes, while the
clock is short of t0 + s. Open loop: request k falls due at t0 + due[k-1];
one that falls due while its controller waits is sent when the reply
comes, and is timed from its due time either way. Prints one JSON object
at the end: per request [controller, k, due, sent, received, ok], the raw
replies by "c k", and the lateness of sends whose controller was free.
"""

import json
import socket
import sys
import threading
import time

TIMEOUT_S = 120.0


def _rpc(f, req):
    f.write((json.dumps(req) + "\n").encode())
    f.flush()
    line = f.readline()
    if not line:
        raise ConnectionError("the server closed the connection")
    return line.decode()


def main():
    plan = json.loads(sys.stdin.read())
    port, loop, seconds = plan["port"], plan["loop"], float(plan["seconds"])
    obs, due = plan["obs"], plan["due"]
    n = len(obs)
    socks, files = [], []
    for c in range(n):
        s = socket.create_connection(("127.0.0.1", port), timeout=TIMEOUT_S)
        f = s.makefile("rwb")
        _rpc(f, {"ping": True})
        socks.append(s)
        files.append(f)
    records = [[] for _ in range(n)]
    replies = [{} for _ in range(n)]
    late = [[] for _ in range(n)]
    errors = []

    def ask(c, k):
        line = _rpc(files[c], {"obs": obs[c][k], "plan": True})
        replies[c][k] = line
        return '"error"' not in line

    def warm(c):
        try:
            ask(c, 0)
        except (OSError, ValueError) as e:
            errors.append(f"controller {c} warm-up: {e!r}")

    threads = [threading.Thread(target=warm, args=(c,)) for c in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(TIMEOUT_S)
    if errors or any(t.is_alive() for t in threads):
        print(json.dumps({"error": errors or ["warm-up timed out"]}),
              flush=True)
        return 1
    t0 = time.perf_counter()
    print(f"ready {t0!r}", flush=True)

    def closed(c):
        k = 1
        while time.perf_counter() < t0 + seconds and k < len(obs[c]):
            sent = time.perf_counter()
            try:
                ok = ask(c, k)
            except (OSError, ValueError):
                records[c].append([c, k, sent, sent, None, False])
                return
            records[c].append([c, k, sent, sent, time.perf_counter(), ok])
            k += 1

    def opened(c):
        free_at = t0
        for k, d in enumerate(due[c], start=1):
            target = t0 + d
            now = time.perf_counter()
            if now < target:
                time.sleep(target - now)
            sent = time.perf_counter()
            if free_at <= target:
                late[c].append(sent - target)
            try:
                ok = ask(c, k)
            except (OSError, ValueError):
                for j in range(k, len(due[c]) + 1):
                    records[c].append([c, j, t0 + due[c][j - 1], None,
                                       None, False])
                return
            free_at = time.perf_counter()
            records[c].append([c, k, target, sent, free_at, ok])

    run = closed if loop == "closed" else opened
    threads = [threading.Thread(target=run, args=(c,)) for c in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for f, s in zip(files, socks):
        f.close()
        s.close()
    out = {
        "t0": t0,
        "records": [r for rs in records for r in rs],
        "replies": {f"{c} {k}": line for c in range(n)
                    for k, line in replies[c].items()},
        "lateness_s": sorted(x for ls in late for x in ls),
    }
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
