"""Command-line tools of the port, each run as ``python3 -m
brpc_tpu_torch.tools.<tool>``: ``shard_server`` (a shard group behind one
SO_REUSEPORT port), ``rpc_press`` (an open-loop synthetic press),
``rpc_replay`` (an open-loop replay of a captured corpus), ``rpc_view``
(a corpus and incident-artifact inspector), ``incident_replay`` (an
incident artifact replayed against a fresh server), ``trace`` (one tree
a call from many processes' span stores) with ``chain_server`` (a hop of
a traced chain), ``bench_echo_server``, ``qps_client`` and ``soak`` (an
echo server, a qps load from worker processes, a leak soak),
``fiber_stacks`` and ``cluster_top`` (a live server's fiber stacks, a
merged view of many nodes), the smokes (``timeline_smoke``,
``flight_smoke``, ``traffic_smoke``, ``incident_smoke``, ``perf_smoke``,
``fabric_smoke``, ``serving_obs_smoke``, ``serving_smoke``,
``device_obs_smoke``, ``device_perf_smoke``, ``ici_smoke``,
``ring_smoke``) and ``preflight`` (the card's preflight and the gates
that run them), the ports of the repo's ``tools/`` of the same names;
``pipeline_runner`` (the pipelined client loop they share),
``smoke_util`` (what the smokes share) and ``spawn_util`` (start a tool
process and read the ports it announces)."""
