"""Command-line tools of the port: ``shard_server`` (a shard group behind
one SO_REUSEPORT port, the port of tools/shard_server.py) and
``spawn_util`` (start a tool process and read the ports it announces)."""
