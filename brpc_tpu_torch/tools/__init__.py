"""Command-line tools of the port, each run as ``python3 -m
brpc_tpu_torch.tools.<tool>``: ``shard_server`` (a shard group behind one
SO_REUSEPORT port), ``rpc_press`` (an open-loop synthetic press),
``rpc_replay`` (an open-loop replay of a captured corpus), ``rpc_view``
(a corpus and incident-artifact inspector) and ``incident_replay`` (an
incident artifact replayed against a fresh server), the ports of the
repo's ``tools/`` of the same names; and ``spawn_util`` (start a tool
process and read the ports it announces)."""
