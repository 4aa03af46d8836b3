"""stream_ab: phase 4's stream client against a Generate server of each
tree, in turns, for the scan lane's share of the token frames.

    python3 -m brpc_tpu_torch.rpc.stream_ab PARENT_TREE TREE TREE PARENT_TREE

For each tree given (a directory holding ``brpc_tpu_torch`` and
``chip_smoke.py``, e.g. a ``git archive`` of a commit), in the order
given: a default Generate server of that tree in a process of its own
(on cuda:0), then six runs of that tree's ``chip_smoke.py --client
stream PORT`` (16 streams of 32 tokens, each run a fresh process). One
JSON line a tree: each run's ``stream_fast_frames`` (the token, done and
close frames the client took on the scan lane; 16 x 34 = 544 when every
frame did) and the burst's wall seconds. A frame that arrives in one read
with the stream's "accepted" response, which the scan defers, goes the
classic way: a client whose dispatcher was held back at its first reads
shows fewer.
"""

import json
import subprocess
import sys

RUNS = 6

SERVER = r'''
import sys
sys.path.insert(0, sys.argv[1])
from brpc_tpu_torch.rpc import Server
from brpc_tpu_torch.serving import add_generate_service
s = Server()
add_generate_service(s)
print(s.start("tcp://127.0.0.1:0").port, flush=True)
sys.stdin.readline()
s.stop()
s.join(10)
'''


def main(trees) -> int:
    for tree in trees:
        srv = subprocess.Popen([sys.executable, "-c", SERVER, tree],
                               stdin=subprocess.PIPE,
                               stdout=subprocess.PIPE, text=True)
        port = int(srv.stdout.readline())
        counts, walls = [], []
        for _ in range(RUNS):
            out = subprocess.run([sys.executable, f"{tree}/chip_smoke.py",
                                  "--client", "stream", str(port)],
                                 capture_output=True, text=True,
                                 timeout=300)
            doc = json.loads([ln for ln in out.stdout.splitlines()
                              if ln.startswith("{")][-1])
            counts.append(doc["native"]["stream_fast_frames"])
            walls.append(round(doc["wall_s"], 3))
        srv.stdin.write("\n")
        srv.stdin.flush()
        srv.wait(60)
        print(json.dumps({"tree": tree, "stream_fast_frames": counts,
                          "wall_s": walls}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
