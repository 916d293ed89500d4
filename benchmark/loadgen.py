"""Open-loop HTTP load generator, run in a process of its own so that its
threads never take the server's interpreter lock.

    python3 loadgen.py --port P --spec spec.json --out result.json

``spec.json`` holds the schedule the benchmark drew from its seed: each
request's due time (seconds after the start), body file and whether it asks
for the heatmap, and which requests' responses to keep for the check. The
generator loads the bodies, prints ``ready``, waits for a line on standard
input, then sends each request at its due time from a thread of its own,
whatever the server's state (open loop). Each request is timed from when it
was due to when its whole response was read. After the last request is
due it waits for every response, at most ``drain_s`` seconds, and writes
the records to ``--out``.
"""

from __future__ import annotations

import argparse
import http.client
import json
import sys
import threading
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--port", type=int, required=True)
    p.add_argument("--spec", required=True)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    with open(args.spec) as f:
        spec = json.load(f)
    bodies = []
    for path in spec["bodies"]:
        with open(path, "rb") as f:
            bodies.append(f.read())
    due, body_of, heat = spec["due"], spec["body"], spec["heatmap"]
    keep = set(spec["keep"])
    n = len(due)
    records = [None] * n
    print("ready", flush=True)
    sys.stdin.readline()

    def send(i: int, t_due: float) -> None:
        rec = {"due": t_due - t0, "status": 0, "late": time.perf_counter() - t_due}
        try:
            conn = http.client.HTTPConnection("127.0.0.1", args.port, timeout=spec["timeout_s"])
            path = "/predict?heatmap=1" if heat[i] else "/predict"
            conn.request("POST", path, body=bodies[body_of[i]],
                         headers={"Content-Type": "application/octet-stream"})
            resp = conn.getresponse()
            data = resp.read()
            rec["status"] = resp.status
            conn.close()
            if i in keep:
                rec["response"] = json.loads(data)
        except (OSError, http.client.HTTPException, ValueError) as exc:
            rec["error"] = repr(exc)
        rec["done"] = time.perf_counter() - t0
        records[i] = rec

    threads = []
    t0 = time.perf_counter()
    for i, offset in enumerate(due):
        t_due = t0 + offset
        wait = t_due - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        th = threading.Thread(target=send, args=(i, t_due), daemon=True)
        th.start()
        threads.append(th)
    limit = time.perf_counter() + spec["drain_s"]
    for th in threads:
        th.join(max(0.0, limit - time.perf_counter()))
    with open(args.out, "w") as f:
        json.dump({"records": records}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
