"""CUDA IPC probe: does a machine let two processes share device
memory, and what does it cost? A check to run before ``ici://``'s lane
is trusted on a new machine.

    python3 -m brpc_tpu_torch.transport.ipc_probe     # on a card

The parent process shares three tensors through torch's own route
(``UntypedStorage._share_cuda_``; one filled on a side stream behind a
device-side sleep) and the handle of an interprocess event; a child
process opens them (``_new_shared_cuda``), waits on the event and copies
them, timing each open, the event's open and the copy, and checks the
values; the parent then reads what the shares left allocated. One JSON
line, the child's inside it. ``ici://`` itself does not use torch's
route (``transport/cuda_ipc.py`` says why).
"""
import json
import subprocess
import sys
import time

import torch


def hx(b):
    return b.hex() if isinstance(b, (bytes, bytearray)) else b


def parent():
    dev = torch.device("cuda", 0)
    out = {"torch": torch.__version__, "cuda": torch.version.cuda,
           "card": subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                   "--format=csv,noheader"],
                                  capture_output=True, text=True).stdout.strip()}
    base0 = torch.cuda.memory_allocated(dev)
    a = torch.arange(1 << 20, dtype=torch.float32, device=dev)
    b = torch.arange(16, dtype=torch.float32, device=dev) + 5
    side = torch.cuda.Stream(dev)
    with torch.cuda.stream(side):
        torch.cuda._sleep(int(2e8))
        c = torch.full((1 << 20,), 7.0, device=dev)
        ev = torch.cuda.Event(interprocess=True)
        ev.record(side)
    t0 = time.perf_counter()
    recs = []
    for t in (a, b, c):
        r = t.untyped_storage()._share_cuda_()
        recs.append([hx(x) for x in r])
    out["share_ms"] = (time.perf_counter() - t0) * 1e3
    out["rec_types"] = [type(x).__name__ for x in a.untyped_storage()._share_cuda_()]
    out["rec_lens"] = [len(x) if isinstance(x, (bytes, bytearray)) else x
                       for x in a.untyped_storage()._share_cuda_()]
    out["same_handle_a_b"] = recs[0][1] == recs[1][1]
    out["offsets"] = [r[3] for r in recs]
    evh = ev.ipc_handle()
    out["event_handle_len"] = len(evh)
    msg = {"recs": recs, "event": evh.hex(), "n": [1 << 20, 16, 1 << 20]}
    p = subprocess.Popen([sys.executable, __file__, "child"],
                         stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True)
    so, se = p.communicate(json.dumps(msg) + "\n", timeout=120)
    out["child_rc"] = p.returncode
    out["child_err"] = se[-3000:]
    try:
        out["child"] = json.loads(so.strip().splitlines()[-1])
    except (ValueError, IndexError):   # no JSON line: show the output
        out["child_out"] = so[-2000:]
    out["alloc_before_drop"] = torch.cuda.memory_allocated(dev) - base0
    del a, b, c
    torch.cuda.synchronize(dev)
    out["alloc_after_drop"] = torch.cuda.memory_allocated(dev) - base0
    torch.cuda.ipc_collect()
    out["alloc_after_collect"] = torch.cuda.memory_allocated(dev) - base0
    # loop: share and drop, no consumer: what stays
    for _ in range(10):
        x = torch.empty(1 << 18, device=dev)
        x.untyped_storage()._share_cuda_()
        del x
    torch.cuda.ipc_collect()
    out["alloc_after_unconsumed_shares"] = torch.cuda.memory_allocated(dev) - base0
    print(json.dumps(out), flush=True)


def child():
    dev = torch.device("cuda", 0)
    msg = json.loads(sys.stdin.readline())
    torch.cuda.init()
    torch.zeros(1, device=dev)
    out = {}
    def unhex(r):
        d, h, size, off, rch, rco, evh, sync = r
        return (d, bytes.fromhex(h), size, off, bytes.fromhex(rch), rco,
                bytes.fromhex(evh), sync)
    views = []
    times = []
    for r, n in zip(msg["recs"], msg["n"]):
        args = unhex(r)
        t0 = time.perf_counter()
        st = torch.UntypedStorage._new_shared_cuda(*args)
        times.append((time.perf_counter() - t0) * 1e3)
        t = torch.empty((0,), dtype=torch.float32, device=dev).set_(
            st, 0, (n,), (1,))
        views.append(t)
    out["open_ms"] = times
    t0 = time.perf_counter()
    ev = torch.cuda.Event.from_ipc_handle(dev, bytes.fromhex(msg["event"]))
    out["event_open_ms"] = (time.perf_counter() - t0) * 1e3
    cur = torch.cuda.current_stream(dev)
    cur.wait_event(ev)
    t0 = time.perf_counter()
    dst = [torch.empty_like(v) for v in views]
    for d_, v in zip(dst, views):
        d_.copy_(v, non_blocking=True)
    done = torch.cuda.Event()
    done.record(cur)
    out["enqueue_ms"] = (time.perf_counter() - t0) * 1e3
    done.synchronize()
    out["copy_wall_ms"] = (time.perf_counter() - t0) * 1e3
    out["a_ok"] = bool(torch.equal(dst[0], torch.arange(1 << 20, dtype=torch.float32, device=dev)))
    out["b_ok"] = bool(torch.equal(dst[1], torch.arange(16, dtype=torch.float32, device=dev) + 5))
    out["c_ok"] = bool((dst[2] == 7).all())
    # reopen timing: drop all views, then reopen a
    del views, dst
    torch.cuda.synchronize(dev)
    re = []
    for _ in range(5):
        args = unhex(msg["recs"][0])
        t0 = time.perf_counter()
        st = torch.UntypedStorage._new_shared_cuda(*args[:4], b"", 0, args[6], False)
        re.append((time.perf_counter() - t0) * 1e3)
        del st
        torch.cuda.synchronize(dev)
    out["reopen_ms"] = re
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["child"]:
        child()
    else:
        parent()
