"""parallel_http: GET many URLs at once through the port's HTTP client
and fibers, reporting each URL's status, size and latency (the port of
tools/parallel_http.py; the reference's tools/parallel_http).

    python3 -m brpc_tpu_torch.tools.parallel_http \
        http://127.0.0.1:8000/status http://127.0.0.1:8000/vars \
        --concurrency 32
    python3 -m brpc_tpu_torch.tools.parallel_http --from-file urls.txt

``--concurrency`` fibers take the URLs in turn, each with a keep-alive
connection of its own to every host it meets (one connection would
answer a host's URLs one at a time, HTTP/1.1's order), and park on
``request_async`` instead of holding a worker thread. ``--json`` prints
one JSON line instead of the table. The exit code is 1 unless every
URL answered.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time
import urllib.parse


def fetch_all(urls, concurrency: int = 16, timeout_s: float = 5.0):
    """``[(status, body bytes, ms, error or None)]`` in the URLs' order
    (a URL still unanswered at the end: None)."""
    from brpc_tpu_torch.fiber import CountdownEvent, global_control
    from brpc_tpu_torch.protocol.http_client import HttpClient
    results = [None] * len(urls)
    next_i = iter(range(len(urls)))
    lock = threading.Lock()
    nworkers = max(1, min(concurrency, len(urls)))
    done = CountdownEvent(nworkers)

    async def worker():
        clients = {}
        try:
            while True:
                with lock:
                    i = next(next_i, None)
                if i is None:
                    return
                url = urls[i]
                u = urllib.parse.urlsplit(url if "://" in url
                                          else "http://" + url)
                path = (u.path or "/") + (f"?{u.query}" if u.query else "")
                t0 = time.monotonic()
                try:
                    key = (u.hostname, u.port or 80)
                    cl = clients.get(key)
                    if cl is None:
                        cl = clients[key] = HttpClient(
                            f"tcp://{key[0]}:{key[1]}", timeout_s=timeout_s)
                    status, _, body = await cl.request_async("GET", path)
                    results[i] = (status, len(body),
                                  (time.monotonic() - t0) * 1e3, None)
                except Exception as e:  # boundary: one URL's failure
                    results[i] = (0, 0, (time.monotonic() - t0) * 1e3, e)
        finally:
            for cl in clients.values():
                cl.close()
            done.signal()

    control = global_control()
    for _ in range(nworkers):
        control.spawn(worker, name="parallel_http")
    done.wait_pthread(timeout_s * len(urls) + 10)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("urls", nargs="*")
    ap.add_argument("--from-file", default=None,
                    help="a file with one URL a line")
    ap.add_argument("--concurrency", type=int, default=16)
    ap.add_argument("--timeout-s", type=float, default=5.0)
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    urls = list(args.urls)
    if args.from_file:
        with open(args.from_file) as f:
            urls += [ln.strip() for ln in f
                     if ln.strip() and not ln.startswith("#")]
    if not urls:
        ap.error("no URLs given")
    results = fetch_all(urls, args.concurrency, args.timeout_s)
    nok = sum(1 for r in results if r is not None and r[3] is None)
    if args.json:
        print(json.dumps({"urls": len(urls), "ok": nok, "results": [
            {"url": u, "status": r[0], "bytes": r[1],
             "ms": round(r[2], 3),
             "error": None if r[3] is None else str(r[3])}
            if r is not None else {"url": u, "status": None}
            for u, r in zip(urls, results)]}), flush=True)
    else:
        for url, r in zip(urls, results):
            if r is None:
                print(f"PENDING {url}")
            elif r[3] is not None:
                print(f"FAIL    {url}  {type(r[3]).__name__}: {r[3]}")
            else:
                print(f"{r[0]:3d}     {url}  {r[1]}B  {r[2]:.1f}ms")
        print(f"\n{nok}/{len(urls)} succeeded", flush=True)
    return 0 if nok == len(urls) else 1


if __name__ == "__main__":
    import os
    rc = main()
    sys.stdout.flush()
    os._exit(rc)    # skip the runtime threads' teardown
