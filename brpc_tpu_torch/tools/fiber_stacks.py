"""The fiber stacks of a running server (the port of
tools/fiber_stacks.py; the reference's tools/gdb_bthread_stack.py walks
TaskMeta contexts under gdb instead):

    python3 -m brpc_tpu_torch.tools.fiber_stacks http://HOST:PORT
        reads /fibers?stacks=1 from the target's builtin pages and
        prints the report (from any machine);

    python3 -m brpc_tpu_torch.tools.fiber_stacks PID
        sends SIGUSR2; the target prints its fiber stacks to its own
        stderr (``Server.start`` installs the handler on the main
        thread; a server started on another thread has none).

No debugger either way: a suspended fiber's continuation hangs off its
coroutine's frames, which Python itself can walk (``fiber/stacks.py``).
"""

from __future__ import annotations

import os
import signal
import sys


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__)
        return 2
    target = sys.argv[1]
    if target.isdigit():
        pid = int(target)
        try:
            os.kill(pid, signal.SIGUSR2)
        except ProcessLookupError:
            print(f"no such process: {pid}", file=sys.stderr)
            return 1
        except PermissionError:
            print(f"not permitted to signal {pid}", file=sys.stderr)
            return 1
        print(f"SIGUSR2 sent to {pid}: fiber stacks go to ITS stderr "
              f"(handler installed by Server.start; if nothing appears "
              f"the target has no handler — use the http:// mode)")
        return 0
    if target.startswith("http://"):
        from urllib.request import ProxyHandler, build_opener
        url = target.rstrip("/") + "/fibers?stacks=1"
        # straight to the target, whatever proxy the environment names
        with build_opener(ProxyHandler({})).open(url, timeout=10) as r:
            sys.stdout.write(r.read().decode("utf-8", "replace"))
        return 0
    print(f"target must be a PID or http://host:port, got {target!r}",
          file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
