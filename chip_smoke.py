#!/usr/bin/env python3
"""Smoke run of brpc_tpu_torch on one NVIDIA card.

    python3 chip_smoke.py          # from the root of a checkout

Phases, one JSON line each:

1. card and build: the card's name and power limit (nvidia-smi), torch
   and CUDA versions, and the build of the three CUDA libraries from the
   checkout's sources (nvcc, sm_90a, one process each, started together):
   ``flash_decode``, ``flash_attn_fwd_tc`` and ``flash_attn_fwd``, with
   each one's build time and ptxas lines, and the count of HGMMA (wgmma)
   instructions in ``flash_attn_fwd_tc``'s SASS, which must not be 0;
2. kernel check: every kernel against its plain PyTorch version, both on
   the card, at the serving shape, split decode caches (lengths
   0/1/4096/3000; one sequence at the most blocks a sequence takes;
   lengths that leave most of the grid's blocks idle; every length at
   the capacity; two streams running 100 split decodes each, interleaved,
   every result equal to the first and within the bound, so the
   kernel's counters go back to 0; a larger batch right after a smaller
   one on a fresh stream, so the workspace grows), and long, ragged and
   sq != sk shapes, in fp32, fp16 and bf16: fp32 within FP32_TOL,
   fp16/bf16 element by element within ``_rounding_bound`` (the error
   the kernel's own roundings explain), and four controls, a split
   decode with one block's partial dropped and bf16 (d 64, d 32) and
   fp32 attention with their last 64 keys dropped, that these bounds
   must reject; each case names the kernel ``_plan`` chose and checks
   that it was the one launched, once: a decode is one ``flash_decode``
   launch, split or not. ``flash_attn_fwd_tc`` takes every 16-bit head
   dim: it is held at one tile (sq 64 x sk 64 at d 16 and 32), inside
   one tile (sq 16 x sk 40) and at ragged, causal and sq != sk shapes.
   ``flash_attn_fwd`` is also held at its 64-row block's edges (sq < 64,
   sq and sk off the tile sizes, head dims 16/32/128, causal with sq !=
   sk), in bf16 at d 32 and fp16 at d 16 through ``_launch_tile`` (the
   ``ms_simt`` of phase 5), and with a per-head device ``q_offset``
   (lengths 0, 1, L and between, ``q_offset_add`` -1);
3. serving (the main path): a port Server on tcp://127.0.0.1:0 with the
   default GenerateService on cuda:0 answers a burst of 16 unary
   Generate calls from 8 client threads; every token list must equal the
   plain CPU path's ``TinyDecoder.generate``, and ``flash_decode``'s
   launch count, zeroed just before the server starts and read just
   after the burst, must equal the engine's decode steps plus its
   warm-up step. The same burst then runs warm, and once more under the
   profiler for the device's busy share and its time by kernel. Decode
   runs on the server's fiber workers (the engine is a WorkerModule):
   in every burst the steps counted by worker group must sum to the
   burst's decode steps, and no ``serving-decode`` thread,
   ``rpc-handler`` pool, or reader, writer or accept thread may exist.
   The transport reads on one event dispatcher: while a client process
   holds 8 connections open (``--client hold``), the server's process
   must have no thread per connection and the threads it had with none
   open, give or take the fixed ones (``FIXED_THREADS``); each burst
   reports the steps by
   group, the worker threads used, the decode lock's misses, the
   control's concurrency, ``os.cpu_count()`` and the scheduler's
   ``saturation_snapshot()``;
   then the two other paths, each with the counts zeroed just before and
   read just after: long-context attention (``flash_attention`` at 8
   heads x 2048 x 64, bf16 and fp32, and x 32 bf16, causal and not) and
   a long-cache decode step (``decode_attention`` at B 4, L 4096, d 128,
   bf16, split: one ``flash_decode`` launch);
4. streaming (the main path since the stream and HTTP transports): a
   fresh default server on cuda:0, launch counts zeroed before each part
   and read after it, each part's ``flash_decode`` launches equal to its
   decode steps (plus the warm-up in the first) and no other kernel: (a)
   the burst with every call attaching a Stream, cold then warm, every
   token list and ``d`` frame equal to the CPU plain path; (b) the same
   burst over HTTP chunked transfer (``http.client``), footer
   ``completed n=32``; (c) one 120-token stream whose first token lands
   before half its last token's time, an HTTP peer that dies after its
   first chunk, whose slot must be freed within 5 s before a following
   request completes, and one stream burst under the profiler. Client-side
   time to first token and gaps between tokens, per transport, and the
   bursts' tokens/s; the fiber fields and checks of phase 3 for every
   burst, and each decode step's time with the prompts it admitted
   (prefilled) and the host time of its prefills and its model step:
   the median and p99 of steps that admitted none and of steps that
   admitted some, the phase's first steps, and each worker thread's
   first step, to show whether a worker's first step costs more than
   its kind's median;
5. kernel times: device times of each kernel, its plain version and one
   PyTorch call (``scaled_dot_product_attention``, a yardstick the port
   never calls), from CUDA events and from the profiler, beside the bound
   from bytes and operations; the launch floor (``torch.cuda._sleep(0)``
   timed the same way); each decode case also with the L2 cold (a 128 MB
   write before each launch, events around the launch alone, median of
   50), and a split decode with every length at the capacity, L2 cold,
   beside its byte bound; and, in the same run, the CUDA-core tile
   kernel (``flash_attn_fwd`` through ``_launch_tile``) on the same
   inputs as ``ms_simt`` where another kernel serves the call (decode,
   and every 16-bit row); ``flash_attn_fwd_tc`` at 8 x 2048 x 16 fp16,
   x 32, x 64 and x 128 bf16 and 32 x 2048 x 64 bf16, ``flash_attn_fwd``
   at 8 x 2048 x 64 and x 128 fp32, causal and not. Each long case also
   gives, on its kernel_times line only, ``mufu_ms``: its exponentials
   at the special-function rate, worked out and not measured.

After phase 4, the phase ``observability``: a fresh default server on
cuda:0 with the ``rpcz_enabled`` flag on; one warm burst of each kind
(stream, HTTP, unary; phase 4's sizes) from client processes that trace
too (``--client KIND PORT --rpcz``), then the pages ``/rpcz``,
``/serving``, ``/status``, ``/vars`` and ``/brpc_metrics``. Every
tpu_std call has one client span and one server span of its trace whose
parent is the client span; every call has one serving span, whose four
stages sum to its latency; ``/serving`` counts every call; ``/vars``
lists the fiber variables and ``fiber_wake``; every Prometheus line
parses; tokens equal the CPU plain path's; ``flash_decode`` runs once a
decode step and no other kernel runs. It prints, per transport, the
median and p99 of each call's stages on the wall clock that both
processes share (``STAGES``: client issue -> server arrival -> handler
-> admitted -> prefilled -> first token -> the client's first frame)
and their sum beside the client's TTFT, then the warm stream burst in
turns with ``serving_stats_enabled`` and ``rpcz_enabled`` off and on.

After ``observability``, the phase ``device_lane``: tensors in RPCs on
the three device lanes, each part with the launch counts zeroed just
before and read just after it. (a) A port Server on
``cuda://smoke:1#device=0`` with ``Perf.Echo`` (response tensors = request
tensors) answers fp32 tensors of 4 B to 4 MiB in x4 steps (the sizes of
examples/tpu_performance/main.py), 3 warm-up and 30 timed calls each:
every echo equal and the same memory (``data_ptr``), p50/p99 us and
GB/s (2 x bytes per echo). (b) The same sweep from a client process
(``--client device_lane PORT``) to a ``cudad://127.0.0.1:0#device=0``
server: the handler sees ``cuda:0`` tensors, every echo equal; with the
dispatcher's ``dispatcher_stall_ms_max_10s`` and, at 1 and 4 MiB, the
time of each batch landing on the card (in parse, on the dispatcher)
and of each response's host copy (on a fiber worker). (c) One send of a
tensor filled on a fresh stream behind a device sleep: the handler must
read the filled values. (d) ``Attend`` on both lanes, 4 calls at once,
each on a connection of its own (on one connection a request is read
only after the handler of the one before has finished):
q [4, 128], K/V [4, 4096, 128] bf16 and lengths 0/1/4096/3000 ride the
lane, the async handler waits until all 4 calls have arrived (parked
on a Future, so that the 4 parks below overlap however far apart the
requests came in), runs ``decode_attention``, parks on a CUDA event
(``device_ready``) and returns O as a response tensor; each call
launches ``flash_decode`` once (a split decode, merged in the kernel)
and nothing else, O is within ``_rounding_bound`` of the plain version
computed from the client's tensors, every handler resumed on a fiber
worker after its event completed, and the poller's waiter threads never
outnumbered the calls in flight; a thread waiting in
``Event.synchronize`` must not hold the interpreter lock. (e) A stream
of 16 tensor frames of 64 KiB from the server beside unary device calls
on the same connection, on both lanes: every frame and every response
pairs with its own tensor.
(f) The sweep on ``ici://127.0.0.1:0#device=0`` from a client process
run with ``BRPC_TPU_TORCH_ICI_REQUIRE_PULL=1`` (``--client ici``, a
session of steps, the next on the server's go): lane ``cuda-ipc`` on
both sides (one card: a same-device CUDA IPC hand-off between two
processes, not a link), every echo equal, the handler's tensors on
``cuda:0``, no kernel launched, no staged batch and every cell balanced
on both sides, the first call timed apart, a send filled on a side
stream read whole, then ICI_CYCLES connect/echo/close cycles after
which both processes' allocated bytes on the card and their mappings
of the peer's memory are back where they were; with the server's takes
(on the dispatcher), its IPC opens and closes, and the dispatcher's
longest tick. (g) ``Attend`` as in (d), its 4 calls from the ici client
process. (h) With rpcz on, a short sweep (SHORT_SWEEP_BYTES) on each
lane, the server's spans read from ``/rpcz`` of an admin server in this
process and the client's from its line: each lane's write side (stage,
wire, ack) and receive side (``device-recv``) beside its echo p50; on
``ici://`` every device span's stage + wire + ack equals its latency
and its stage is at most its size's slowest echo; ``/device`` has a
cell for every lane, ``transfer_lane: up``, the recv pool and the leak
pane; then ``device_stats_enabled`` off and on in turns on ``ici://``
at 64 KiB.

After ``device_lane``, the phase ``combo``: combo channels, the async
client and mesh collectives on the card, each part with the launch
counts zeroed just before and read just after it. (a) BASELINE's
"ParallelChannel 8-shard tensor allreduce", shaped as
examples/parallel_allreduce/main.py: 8 port servers on
``cuda://combo-<i>:1#device=0`` serve ``Reduce.Sum`` (the sum of the
shard on the card, returned as a response tensor); a ParallelChannel
whose mapper gives sub i row i of a [8, dim/8] fp32 request on cuda:0,
and whose merger sums the responses on the card, at dim 2^16 and 2^20
(256 KiB and 4 MiB), three ways: ``call_sync``, ``call(done=)`` and
``call_async`` awaited in a fiber; every sum within FP32_TOL (relative)
of the host's, p50/p99 ms of each; no kernel launched. (b) The same
calls through a ParallelChannel lowered by ``attach_collective`` onto a
``CollectiveChannel`` (merge "sum") over ``make_rpc_mesh(1, 8,
devices=[cuda:0] * 8)``: ``collective_fused`` up by one a call,
``collective_fallbacks`` 0, the same sums, p50/p99. (c) Nested async
calls: an async handler fans ``Attend`` out by head (PR 10's case: q [4,
128], K/V [4, 4096, 128] bf16, lengths 0/1/4096/3000) through a
PartitionChannel of 4 ``cuda://`` servers and awaits ``call_async``:
each partition call launches ``flash_decode`` once (a split decode,
merged in the kernel) and nothing else, the
merged O is within ``_rounding_bound`` of the plain version, every
sub-call's meta ``timeout_ms`` is at most the handler's remaining budget,
and a handler whose budget is spent gets ERPCTIMEDOUT from a nested call
that reaches no server. (d) ``ring_attention`` and ``ulysses_attention``
on an 8-shard mesh on cuda:0 at 8 heads x 2048 x 64 fp32, causal and
not, within FP32_TOL of ``flash_attention`` (which launches
``flash_attn_fwd``), with the wall ms of each beside that call's.

Phase cluster (the cluster client, overload control, auth and
compression): three
GenerateService replicas, each a port Server on tcp with its own engine
on cuda:0 at phase 3's width, behind one ``ClusterChannel`` ("la", a
retry budget), launch counts zeroed before each part and read after it,
``flash_decode``'s equal to the replicas' decode steps and warm-ups,
every token list equal to the CPU plain path's, no call failed. (a) 48
unary Generate calls from 8 threads: each replica serves; beside them
phase 3's burst (a Channel a thread) at one replica, and calls one at a
time through the ClusterChannel and a plain Channel in turns (the
cluster layer's cost: the pick, the stats, the feedback), with each
replica's tokens a step. (b) Replica 0 restarted with
``max_concurrency=2`` and 2 waiting, 16 threads: it sheds
(``server_limit_shed`` or the engine's sheds), calls retry elsewhere
(``retried_count``), the retry budget keeps its tokens, and the
balancer takes no latency sample from a reject. (c) Replica 1 killed
(its connections dropped, then stopped) 150 ms into a burst: the calls
it held retry elsewhere (``tried_servers``), the health checker marks it
dead, ``/backends`` and the breaker snapshot show it; the time from the
kill to the last retried call's end; then it restarts on its port, is
revived, and serves. (d) The ``Attend`` of phase device_lane (a split
decode, one launch) on two ``cuda://`` servers, one 50 ms slow,
through a ClusterChannel ("rr", ``backup_request_ms=5``): every call
first sent to the slow server used a backup and was answered by the
fast one, each ``done`` ran once, the late answers were dropped, no
attempt is left in flight and the backend cells count each call once,
O within ``_rounding_bound``, p50 within 10 ms of the fast server's
called directly. (e) Replica 2 restarted with a ``TokenAuthenticator``;
a second ClusterChannel sends the token and every request with
``compress_type`` 3 (snappy): every token list right, replica 2 serves,
every request reaches its handler compressed (the server's
``cntl.compress_type``) and every response comes back so (its meta's
``compress_type``); a ClusterChannel with a wrong token to replica 2
gets ERPCAUTH on every call, none retried. p50/p99 of every part.

Phase incident (trend rings, the anomaly watchdog, the flight
recorder, capture and incidents), after cluster, at phase 3's width:
launch counts zeroed before each part and read after it,
``flash_decode``'s equal to the part's decode steps and warm-ups, every
token list equal to the CPU plain path's. (a) Phase 3's burst on a
default server with the rings on and the recorder at 20 Hz: the
one-second ring of ``/timeline?name=server_processed`` sums to the
calls served, ``/vars?series=serving_ttft_p99_us`` has buckets, and
``/hotspots?mode=continuous`` gives busy samples to
``rpc:GenerateService.Generate``; the busy share by label and the top
folded stacks. (b) An on-demand ``/hotspots`` profile at 1 ms while 32
fresh Channels of this process each make their first unary Generate
call, one after another (one profile holds both sides of the
connection): the first calls' p50/p99 beside 8 later calls on one
Channel, and the profile's top 15 self and cumulative frames. (c) A
server at ``max_concurrency=2`` with ``anomaly_watch_filter=
server_limit_shed``, 3 warm-up and 3 close ticks, incident capture on
into a temporary ``incident_dir`` and a 3-tick window: calm calls over
the warm-up ticks (the bvar sampler's own, once a second), then 24
concurrent Generate calls: incident #1 opens on ``server_limit_shed``,
4 calls made inside the window are captured, the artifact appears on
``/incidents`` and downloads byte for byte, the port's reader finds in
it the incident document and the in-window requests with their
prompts, rpcz spans carry ``incident #1``, a continuous-profile window
is labelled, the incident closes, and ``/census`` lists every
registered provider; the times from the first shed to the open and from
the close to the artifact. (d) Phase 3's burst in turns, 3 pairs: the
recorder at 20 Hz with the rings on against both off, then capture at
rate 1.0 against capture off; p50/p99 and tokens/s of each.

Phase native (the native host core and the lanes on it), after
incident, at phase 3's width: (a) the core's build: ``g++ --version``,
the Python.h path, each output's cold and cached build seconds, and the
process's own core loaded (a build or load failure fails the smoke, so
no lane quietly runs its Python path); (b) phase 3's burst with no
deadline in the request meta, warm (after one such burst): every request through the turbo lane's
slim body, every sync call plucked by ``pluck_scan``, every response
through ``process_response_fast``; p50/p99, tokens/s, arrival ->
handler, syscalls a message; (c) phase 4's stream and HTTP bursts from
a client process: the client's stream frames through
``process_stream_frame_fast``, the server's heads through the native
parse; (d) phase 3's burst (a deadline in every request: the classic
lane on the server) and (b)'s deadline-less one, each against a server
child with the native lanes and one with ``BRPC_TPU_TORCH_NO_NATIVE=1``
(the client process likewise), N P P N, one round, then the two
mixed pairings: medians of p50 (and of a channel's first and later
calls), p99, tokens/s, server CPU ms and syscalls a call; (e) a ``native="echo"`` method at 4 B, 64 B, 1 KiB and
4 KiB, 1,000 pipelined calls each, against the same handler without the
native kind, in turns: p50, calls/s and the calls ``serve_drain``
served; (f) phase device_lane's 4 MiB ``cudad://`` echo in child
processes with and without ``mallopt`` (T U). Launch counts
zeroed before each decoding part and read after it, ``flash_decode``'s
equal to the decode steps and warm-ups; every token list equal to the
CPU plain path's.

Phase shards (Generate served by forked shards behind one SO_REUSEPORT
port), after native: the group is ``python3 -m
brpc_tpu_torch.tools.shard_server --generate`` run from a copy of the
package whose ``_build/`` is empty, in a process of its own (this one
has CUDA up, and a process that made a CUDA call cannot give a forked
child a working one). (a) 2 shards from the cold build (the supervisor
builds the native core and flash_decode before it forks; no restart),
phase 3's burst over 4 connections a shard: tokens equal the CPU plain
path's, each shard's flash_decode launches (its ``/vars?shard=i``)
equal its decode steps plus its warm-up, the merged ``/serving``
tokens equal the tokens received, merged ``/vars`` counters the sum of
the shards'; (b) SIGKILL one shard mid-burst: no call on a survivor's
connection fails, the victim's succeed on retry or fail with a
transport error, and a new pid warms up, serves and launches; (c)
SIGSTOP a shard: replaced after the heartbeat timeout; (d) SIGTERM to
the supervisor: no process left and the card memory back
(``torch.cuda.mem_get_info``); (e) ``--client shards_control``: a
process with CUDA initialised is refused, and whether a forked child
can use CUDA after ``device_count`` and after ``is_available``; (f)
tokens/s and client TTFT at 1, 2 and 4 shards, from one client process
and from four (``--client unary`` started at one instant by
``CHIP_SMOKE_START_AT``, each after a burst of its own).

Phase ring (the ring lane, connection types, ssl:// and the socket
pages), after shards. The lane flag (``BRPC_TPU_FLAG_EVENT_RING_LANE``)
is read when a process builds its dispatcher, so each lane's Generate
server on cuda:0 is a process of its own (``--client ring_server``):
ring and selector, on tcp and on ssl, started together. (a) The kernel
release, ``Ring()``'s backend, ``Ring(2)``'s verdict (ok or the
errno), ``Ring(1)``, and ``openssl version`` (missing: the smoke
fails). (b) On the ring server: phase 3's unary burst from a client
process on the ring with the batch backend (every sync call plucked
behind the fence, the fence's waits reported), the stream burst from a
client process on the ring, the HTTP burst; every token list, ``d``
frame and footer equal to the CPU plain path's; each burst's
flash_decode launches equal to its decode steps, and the server's total
(its ``/vars``) equal to its decode steps plus the warm-up; its
``ring_ticks`` and ``ring_completions`` > 0, its dispatcher a
``RingDispatcher`` (one started as another fails the smoke), no
``event_dispatcher`` or per-connection thread; ``ring_flushed_frames /
ring_flush_batches``. (g) During the stream burst ``/sockets``, ``/ids``
and ``/connections`` (with its read-side bytes and idle class) answer.
(c) Phase 3's burst from this process against the ring and the selector
servers in turns, RING_ROUNDS rounds, the order reversed every other
round: tokens/s, TTFT p50/p99, the server's syscalls a message and CPU
a call; then tools/ring_smoke.py's echo shape (8 connections, 32 calls
in flight on each, 4 bytes, 3 windows of 4,000 calls) in a child
process a lane: batch, selector, and uring where ``Ring(2)`` works.
(d) Connection types, Generate over tcp on a server of this process, 8
threads of 2 calls: 8 shared Channels make 1 connection, 8 with
``share_connections=False`` make 8, one ``pooled`` Channel at most 8,
one ``short`` Channel 16; accepted and open connections, tokens/s, p50,
answers and launches checked. (e) Phase 3's burst over ssl:// to the
ring and the selector servers, and a plaintext client refused. (f) A
2-shard ``--generate`` group with the flag in its environment: 32 calls
answered as the plain path, each shard's ``ring_ticks`` > 0, a
SIGKILLed shard back with a ring of its own, no process left after
SIGTERM.

Phase h2 (HPACK, HTTP/2 and gRPC, and the HTTP/1.1 client), after
replay. A default Generate server on cuda:0 in this process: (a) phase
3's burst as unary gRPC Generate calls on 4 ``GrpcChannel``s, cold
then warm (the server answers them on the unary path, through
``flash_decode``), the calls counted under their method on ``/status``; (b) the burst through
the port's ``HttpClient`` (the chunked body read with ``on_chunk``) and
over plain h2 (``Http2Client``); (c) 1 MiB and 4 MiB gRPC echoes on an
echo server, with the WINDOW_UPDATE frames each moved, and a 50 ms
timeout against a handler that sleeps 200 ms (DEADLINE_EXCEEDED); (d) a
server with a token Authenticator: no credential answers
UNAUTHENTICATED with no handler run, the token OK; (f) ``rpc_press
--protocol http``, 400 calls at 400 qps over two workers, every call OK
and the count the server's; then (e) one turn of 256 gRPC Generate
calls over tcp:// and one over ssl:// to servers in child processes
(``--client ring_server``), held connections, the server's CPU a call
(TLS's at RING_SSL_CPU_RATIO times tcp's or more fails, with the
busiest threads). Every token list equal to the CPU plain path's; every
server's flash_decode launches equal to its decode steps plus its
warm-up.

Phase protocols (the request attachment, hulu_pbrpc and sofa_pbrpc,
thrift, redis and memcache, and the /status and /device leftovers),
after h2. One Server on cuda:0 with the default Generate service, a
thrift service, a redis service and ``Bench.Echo`` on one tcp port:
(a) phase 3's burst as unary Generate over hulu_pbrpc, then sofa_pbrpc,
each cold and then warm, streamed over hulu_pbrpc, and unary over
hulu_pbrpc from a client process on the ring's batch backend
(``--client unary_hulu``); ``/connections`` names each variant's
connection; (b) ``Bench.Echo`` returns its request attachment at 4 B,
64 KiB and 4 MiB over tpu_std, hulu and sofa, and one Generate carries a
request attachment; (c) thrift Echo and Add, 1,000 ``call_async``s from
fibers on one client (each call's time to finish in that burst), a
oneway call, an unknown method and 200 calls one at a time (p50 and p99
a call), while a Generate burst is in flight; (d) redis the same way: a
1,000-command SET/GET pipeline in FIFO order, INCR, an unknown command,
8 threads on one shared client; (e) memcache against a mock memcached
the smoke starts (every operation, SASL good and bad, a pipelined get);
(f) ``/status``'s batching and coalescing gauges and a
``saturation_timeline`` link, ``/device``'s probe pane after
``ipc_probe --out`` with ``device_probe_path`` set, ``/protobufs``; (g)
a server with ``auth_token`` refuses a thrift call with no handler run,
answers hulu with the token and refuses it without. Every token list
equal to the CPU plain path's; the server's flash_decode launches,
zeroed before it starts and read after (g), equal its decode steps plus
its warm-up, and no other kernel runs.

Phase legacy (the nshead family, mongo and esp), after protocols.
``nshead_service`` is one handler a server, so each of nova_pbrpc,
public_pbrpc and nshead+mcpack gets a Server on cuda:0 of its own, with
the default Generate service on one tcp port, in turn: (a) phase 3's
burst over the flavour, a client a thread, cold and then warm, and
``/connections`` naming the nshead connection; on the nova server also
one call with the snappy flag, (b) mongo beside a nova burst in flight
(``hello`` over OP_QUERY answered with OP_REPLY, a registered command
over OP_MSG, 1,000 commands back to back on one connection answered in
order, an unknown command's code 59; a command's p50 alone beside the
burst's time to finish), (c) esp the same way (1,000 ``call_async``s
from fibers matched by ``msg_id``, 8 threads on one shared client), and
a plain nshead call, which gets the adaptor's answer. (d) ubrpc on a
short Echo server: an echo, an unknown method (1002), a malformed body
(2001). (e) A server with ``auth_token``: a nova call and an esp call
refused, the connection dropped and no handler run,
``server_auth_refused`` counting both; a mongo command answered. Every
token list equal to the CPU plain path's; each Generate server's
flash_decode launches, zeroed before it starts and read after its part,
equal its decode steps plus its warm-up, and no other kernel runs; no
nshead or esp client socket is left open.

Phase media (RTMP beside Generate), after legacy. One Server on cuda:0
serves Generate over tpu_std and an RTMP relay (``rtmp_service``) on one
tcp port: (a) a publisher (digest handshake) sends onMetaData, the AVC
and AAC sequence headers, 300 video frames of 4-64 KiB and 300 audio
frames of 64-512 B (seed 20260803, 33 and 23 ms apart) and one aggregate
of 8 sub-messages; two players join before the publish, one after frame
100 with the plain handshake and one after it in the AMF3 envelope;
every player gets every message from its join in order (the late ones
the cached metadata and sequence headers first, the aggregate as 8
messages with rebased timestamps), and its messages mux to FLV and TS
with the sha256s of the publisher's from that point; ``/connections``
names the five RTMP connections; (b) phase 3's burst beside (a) and then
alone, every answer equal to the CPU plain path's, wall and p50 of both;
(c) a Generate server without ``rtmp_service`` gets a C0C1, answers
nothing and still serves Generate; on a server with ``auth_token`` RTMP
is answered, and a refusing ``on_publish`` and a taken name get
``NetStream.Publish.BadName``; (d) each Generate server's flash_decode
launches equal its steps plus its warm-up, and no other kernel runs; no
RTMP client socket and no relay entry of a closed socket is left.

Phase sanitize (the native core under ASan and UBSan), after media. The
parent builds the core's two ``.san`` outputs
(``BRPC_TPU_TORCH_SANITIZE=address,undefined``) and flash_decode, so no
compiler runs under the preload, then runs two children with
``sanitizer_env()``: ``--client sanitize`` (a Generate server on cuda:0:
phase 3's burst with no deadline on the turbo and pluck lanes, 64 sync
calls on a held connection, 500 pipelined calls to the C echo, an
HTTP/1.1 burst through the native head parse, then the chaos CLI's
mixed storm over tcp at seed 7) and ``--client ring_echo batch`` (the
ring lane's batch backend). Each must exit 0 with no sanitizer report
(the first 40 lines of one are printed), and map only the ``.san``
outputs; every lane's counter moves; the answers equal the CPU plain
path's; flash_decode's launches equal the child's steps plus its
warm-up.

Phase lint (graftlint on the card's machine), after sanitize, each part
in a child process: (a) ``python3 -m brpc_tpu_torch.analysis
brpc_tpu_torch --format=json`` exits 0 with no active finding and
checks more than 0 native walker cases (its waived findings by rule,
the files read and its wall time are printed); (b) a Generate server on
cuda:0 under ``BRPC_TPU_TORCH_LOCK_DEBUG=strict`` (seed 7) takes phase
3's burst as streams and then as unary calls: no lock-order violation
(each one's two holders printed), instrumented ranked acquisitions above
0, answers equal to the CPU plain path's, flash_decode launches equal
to the child's steps plus its warm-up; the same child with the variable
unset gives the bursts' wall, tokens/s and p50 to compare; (c) ``python3
-m brpc_tpu_torch.analysis.racelane --smoke``: the seeded inversion is
detected the same way twice, the positive control races, the guarded
counter and the fiber pool's teardown hold, the batcher storm raises
nothing.

Phase tools (the trace, load and cluster tools), after lint, each tool
run as ``python3 -m brpc_tpu_torch.tools.<tool>`` in a child: (a) a
2-shard Generate group (``shard_server --shards 2 --generate``) with
rpcz on in every process and this process as the traced client: phase
3's burst streamed and unary, then ``trace`` over the client's store and
the group's: one tree a call (the client span here, the server and
serving spans in one shard's pid, both shards seen), its Perfetto
export valid, each critical path within its caller's wall, each shard's
flash_decode launches equal to its steps plus its warm-up; (b) client
-> A -> B over two ``chain_server`` children, 16 four-span trees over
three pids, then ``trace --smoke``; (c) ``qps_client`` workers and
``run_pipelined`` against ``bench_echo_server``, ``soak --seconds 20``
and ``soak --idle-conns 2000``; (d) ``cluster_top --smoke`` with its
overhead gate, then two Generate servers behind a ClusterChannel of
this process, scraped by ``cluster_top --once --json``: the merged rows
count the burst's calls, the serving rows its tokens, the timeline
trends are there; (e) ``fiber_stacks`` over HTTP against one of them
mid-burst names a suspended fiber, and by SIGUSR2 puts a report on the
other's stderr; both servers' launches equal their steps plus warm-up.

Phase smokes (the port's smokes and ``tools.preflight``), after tools:
(a) a Generate server on cuda:0 (``shard_server --shards 1
--generate``, its pidfile in a directory of its own) and a decoy stray
named by a pidfile in the directory ``python3 -m
brpc_tpu_torch.tools.preflight`` reads: the preflight's default mode
kills the stray alone and names the server among the processes that
hold the card; (b) through ``tools.preflight``'s gate functions,
``gate_serving_smoke`` (a 2-shard Generate group under a mixed client
set: every request completed, evicted or shed, TTFT below the full
generation's, the merged ``/serving`` accounting for the set),
``gate_serving_obs``, ``gate_device_obs`` and ``gate_device_perf``
(against the card-measured floors), then ``tools.ici_smoke``: its
two-process pass on the card over cuda-ipc and its CPU pass; (c) each
shard's flash_decode launches, from its own dump, equal to its steps
plus its warm-up. The host-only smokes run in ``preflight --gate``.

Phase pod (the pod across rank processes, ``tools/pod_smoke.py``), after
smokes: (a) four rank processes on cuda:0 over gloo (``init_pod`` over
``tcp://``, a ``PodMesh`` at 1x4 and 2x2) run every collective, ring hop
and sequence-parallel attention of a pod, each rank's result held to its
piece of the same operation on the single-process 4-shard mesh of
cuda:0: to the bit for data movement, within FP32_TOL for the
reductions and for attention at 8 heads x 2048 x 64 fp32; (b) in the
same ranks a ``CollectiveChannel.call`` whose service function is
``flash_attention`` on the rank's 8 heads of 32 x 2048 x 64 bf16,
merged with ``all_gather``, against ``flash_attention`` on the whole
input in this process, within the kernel check's rounding bound; each
rank's flash_attn_fwd_tc launches (at least one) go to the kernels
line under ``pod``; (c) a one-rank world, on which ``init_pod`` picks
NCCL, runs (a)'s operations through NCCL; (d) each operation's median
ms over 20 calls for both backends, one line each with the card.

``python3 chip_smoke.py --phase streaming`` (or ``--phase
observability``, ``--phase device_lane``, ``--phase combo``, ``--phase
cluster``, ``--phase incident``, ``--phase native``, ``--phase
shards``, ``--phase ring``, ``--phase replay``, ``--phase h2``,
``--phase protocols``, ``--phase legacy``, ``--phase media``, ``--phase
sanitize``, ``--phase lint``, ``--phase tools``, ``--phase smokes``,
``--phase pod``) runs that phase alone
(after the card line), so that two trees' serving can be compared in
one call: run each tree's script in turns.

The last lines are the card line, the kernels line and the result line
``{"ok": true, "device": {...}}``. Any failure exits non-zero without the
result line. Without CUDA, or without the package beside it, it fails.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

# H100 SXM published peaks (NVIDIA data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"fp32": 67e12, "bf16": 989e12, "fp16": 989e12}
# H100 SXM special-function (exp2) rate: 3.9e12/s (Shah et al. 2024,
# the FlashAttention-3 paper); attention takes one exponential a score
MUFU_PER_S = 3.9e12
FP32_TOL = 1e-4        # fp16/bf16: _rounding_bound, element by element
N_CLIENTS = 8
N_REQUESTS = 16
MAX_TOKENS = 32


def _prompts():
    return [f"request {i:02d}: {'the quick brown fox '[: 3 + i]}"
            for i in range(N_REQUESTS)]


def _fa_module():
    # the ops package exports the flash_attention function under the
    # submodule's name, so the module is fetched by its full name
    import importlib
    return importlib.import_module("brpc_tpu_torch.ops.flash_attention")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def progress(what: str) -> None:
    """A line on stderr as a part starts: where a hang sits."""
    print(f"chip_smoke: {time.strftime('%H:%M:%S')} {what}",
          file=sys.stderr, flush=True)


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters: int, warmup: int = 5):
    """(device ms per call, host ms per call). The device time comes from
    CUDA events around ``iters`` back-to-back calls queued behind a
    device-side sleep, so that the host's enqueue cost (Python, ctypes)
    is hidden and the events see the launches run one after another."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    host_s = (time.perf_counter() - t0) / warmup
    # at most 2 GHz: a slower clock only sleeps longer, which is safe
    cycles = int(min(2.0, host_s * iters * 1.5 + 0.002) * 2e9)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(cycles)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, host_s * 1e3


FLUSH_BYTES = 128 << 20    # written before each L2-cold launch


def cold_time_ms(fn, flush, iters: int = 50) -> float:
    """Median device ms of one call with the L2 cold: before each call a
    write of ``flush`` (``FLUSH_BYTES``) evicts the cache's 50 MB and a
    device-side sleep lets the host enqueue the call; CUDA events around
    the call alone."""
    import statistics

    import torch
    pairs = []
    for i in range(iters):
        flush.fill_(float(i))
        torch.cuda._sleep(200_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def profiled_device_ms(fn, iters: int) -> float:
    """Device time per call from the profiler: the summed durations of the
    device activities (kernels, copies) that ``iters`` calls ran, so a
    host-side stall between launches does not count."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(e.time_range.end - e.time_range.start for e in prof.events()
                if "CUDA" in str(getattr(e, "device_type", "")))
    return total / 1e3 / iters


# ------------------------------------------------------------- phase 1

KERNELS = {
    # kernel -> (library, source)
    "flash_decode": ("flash_decode", "brpc_tpu_torch/ops/csrc/flash_decode.cu"),
    "flash_attn_fwd_tc": ("flash_attention_tc",
                          "brpc_tpu_torch/ops/csrc/flash_attention_tc.cu"),
    "flash_attn_fwd": ("flash_attention",
                       "brpc_tpu_torch/ops/csrc/flash_attention.cu"),
}
REPLACES = "brpc_tpu/ops/flash_attention.py:104"


def _sass_count(lib_path: str, opcode: str) -> int:
    from brpc_tpu_torch.ops import _build
    cuobjdump = Path(_build.nvcc_path()).parent / "cuobjdump"
    out = subprocess.run([str(cuobjdump), "-sass", lib_path],
                         capture_output=True, text=True, timeout=300)
    check(out.returncode == 0, f"cuobjdump failed: {out.stderr[-500:]}")
    return sum(opcode in line for line in out.stdout.splitlines())


def phase_build():
    import torch

    from brpc_tpu_torch.ops import _build

    t0 = time.monotonic()
    _build.build_all()
    wall = time.monotonic() - t0
    for name, (source, fns) in _build.LIBRARIES.items():
        info = _build.build_info[name]
        emit({"phase": "build", "library": name, "functions": sorted(fns),
              "source": f"brpc_tpu_torch/ops/csrc/{source}",
              "build_s": info["build_s"], "cached": info["cached"],
              "ptxas": info["ptxas"].splitlines()})
    hgmma = _sass_count(_build.build_info["flash_attention_tc"]["path"],
                        "HGMMA")
    emit({"phase": "build", "wall_s": wall, "parallel": True,
          "flash_attn_fwd_tc_hgmma_sass_lines": hgmma,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    check(hgmma > 0, "flash_attn_fwd_tc's SASS has no HGMMA instruction")


# ------------------------------------------------------------- phase 2

def _rand(rng, shape, dtype, dev):
    import torch
    return torch.from_numpy(rng.randn(*shape).astype("float32")).to(
        dev).to(dtype)


def _launched(fa, before):
    """The kernels whose launch counts grew since ``before``."""
    return sorted(n for n, c in fa.launches.items() if c > before[n])


def phase_kernel_check(dev):
    """Each case: a kernel (through the public wrapper) against the plain
    version on the same inputs, on the card. fp32 cases hold the largest
    difference to FP32_TOL; fp16/bf16 cases hold every element to
    ``_rounding_bound``, the error the kernel's own roundings explain, and
    controls show that bound rejects a dropped block and a dropped K
    tile. Returns the serving-shape and split-decode inputs (for phase 5)
    and the largest error seen by each kernel."""
    import numpy as np
    import torch

    fa = _fa_module()

    rng = np.random.RandomState(20260803)
    results = []
    errs = {name: 0.0 for name in KERNELS}

    def record(case, kernels, got, want, bound):
        """``bound``: FP32_TOL, or a tensor of per-element limits."""
        diff = (got.float() - want.float()).abs()
        err = float(diff.max())
        if isinstance(bound, float):
            ok = bool(np.isfinite(err) and err <= bound)
            extra = {"tol": bound}
        else:
            worst = float((diff / bound).max())
            ok = bool(np.isfinite(worst) and worst <= 1.0)
            extra = {"worst_over_bound": worst,
                     "bound_at_worst": float(bound.flatten()[
                         int((diff / bound).argmax())])}
        results.append(ok)
        for name in kernels:
            errs[name] = max(errs[name], err)
        emit({"phase": "kernel_check", "case": case, "kernels": kernels,
              "max_abs_err": err, **extra, "ok": ok})
        return err

    def control(case, wrong, want, bound):
        """A deliberately wrong answer the check must reject."""
        worst = float(((wrong - want).abs() / bound).max())
        emit({"phase": "kernel_check", "case": f"control: {case}",
              "worst_over_bound": worst, "rejected": worst > 1.0})
        results.append(worst > 1.0)

    def decode_want(q, k, v, lengths):
        """The plain version of a decode step and the bound its kernel is
        held to."""
        d = q.shape[-1]
        want = fa._flash_plain(q[:, None].float(), k.float(), v.float(),
                               d ** -0.5, True, 64,
                               q_offset=lengths - 1)[:, 0]
        return want, (FP32_TOL if q.dtype == torch.float32
                      else fa._rounding_bound(want, q.dtype))

    def decode_case(name, b, L, d, dtype, lengths):
        lengths = torch.tensor(lengths, dtype=torch.int32, device=dev)
        q = _rand(rng, (b, d), dtype, dev)
        k = _rand(rng, (b, L, d), dtype, dev)
        v = _rand(rng, (b, L, d), dtype, dev)
        plan = fa._plan("decode", dev, dtype, d, bh=b, sk=L)
        before = dict(fa.launches)
        got = fa.decode_attention(q, k, v, lengths, block_k=64)
        launched = _launched(fa, before)
        n = fa.launches["flash_decode"] - before["flash_decode"]
        want, bound = decode_want(q, k, v, lengths)
        # one launch a decode, split or not: the merge is in the kernel
        check(launched == ["flash_decode"] and n == 1,
              f"{name}: launched {launched} ({n} flash_decode), want one "
              f"flash_decode")
        err = record(f"{name} (splits {plan.splits})", launched, got, want,
                     bound)
        check(got.dtype == dtype and not got[lengths == 0].any().item(),
              f"{name}: a length-0 slot must give zeros in q's dtype")
        return (q, k, v, lengths, plan), err, want, bound

    # the serving shape: 8 slots, 160-row fp32 cache, d 32: one block a
    # sequence, no workspace
    decode_inputs, errs["serving_decode"], _, _ = decode_case(
        "decode B8 L160 d32 fp32 lengths 0/1/160", 8, 160, 32, torch.float32,
        [0, 1, 160, 37, 80, 5, 159, 100])
    check(decode_inputs[4].splits == 1, "the serving shape must not split")
    # a long cache over few sequences: split over blocks, merged in the
    # kernel by the last block of each sequence
    split_inputs, errs["split_decode"], want, bound = decode_case(
        "decode B4 L4096 d128 bf16 lengths 0/1/4096/3000", 4, 4096, 128,
        torch.bfloat16, [0, 1, 4096, 3000])
    q, k, v, lengths, plan = split_inputs
    check(plan.splits > 1, "the long cache must split")
    m, l, o = fa._decode_partials_plain(q, k, v, lengths, 128 ** -0.5,
                                        plan.splits)
    l[:, plan.splits // 2] = 0.0
    control(f"split decode without block {plan.splits // 2} of "
            f"{plan.splits}",
            fa._decode_combine_plain(m, l, o, torch.float32), want, bound)
    # the most blocks a sequence takes (one long sequence), all live
    big = decode_case("decode B1 L16384 d128 bf16 length 16300", 1, 16384,
                      128, torch.bfloat16, [16300])
    check(big[0][4].splits == fa.DECODE_MAX_SPLITS,
          f"B1 L16384 planned {big[0][4].splits} blocks, not "
          f"{fa.DECODE_MAX_SPLITS}")
    # lengths that use 1, 2 or 3 of a sequence's blocks (below
    # DECODE_MIN_ROWS, just past it, and past twice it)
    decode_case("decode B4 L4096 d128 bf16 lengths 5/127/129/300", 4, 4096,
                128, torch.bfloat16, [5, 127, 129, 300])
    decode_case("decode B6 L2048 d64 fp16 lengths 0/2/128/129/1/2048", 6,
                2048, 64, torch.float16, [0, 2, 128, 129, 1, 2048])
    # every length at the capacity, fp32 and bf16
    decode_case("decode B4 L4096 d128 bf16 every length 4096", 4, 4096, 128,
                torch.bfloat16, [4096] * 4)
    decode_case("decode B2 L1000 d32 fp32 every length 1000", 2, 1000, 32,
                torch.float32, [1000, 1000])

    # two streams, 100 split decodes each, interleaved: each stream has a
    # workspace of its own, and the last block of a sequence sets its
    # ticket back to 0, so every result equals the first and the plain
    inputs = [(_rand(rng, (4, 128), torch.bfloat16, dev),
               _rand(rng, (4, 4096, 128), torch.bfloat16, dev),
               _rand(rng, (4, 4096, 128), torch.bfloat16, dev),
               torch.tensor(lens, dtype=torch.int32, device=dev))
              for lens in ([0, 1, 4096, 3000], [4096, 2500, 700, 33])]
    streams = [torch.cuda.Stream(dev), torch.cuda.Stream(dev)]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream(dev))
    outs = [[], []]
    before = fa.launches["flash_decode"]
    for _ in range(100):
        for i, st in enumerate(streams):
            with torch.cuda.stream(st):
                outs[i].append(fa.decode_attention(*inputs[i]))
    torch.cuda.synchronize(dev)
    check(fa.launches["flash_decode"] - before == 200,
          "two streams: 200 decodes must be 200 launches")
    for i in range(2):
        want2, bound2 = decode_want(*inputs[i])
        record(f"two streams x 100 split decodes, stream {i} (the last)",
               ["flash_decode"], outs[i][-1], want2, bound2)
        same = all(torch.equal(x, outs[i][0]) for x in outs[i])
        emit({"phase": "kernel_check", "case": f"two streams: stream {i}'s "
              f"100 results equal", "ok": same})
        results.append(same)
        worst = max(float(((x.float() - want2).abs() / bound2).max())
                    for x in outs[i])
        check(worst <= 1.0, f"two streams: stream {i} left the bound "
                            f"({worst})")
    # a larger batch right after a smaller one on a fresh stream: the
    # workspace is made for the first, then made anew, zeroed, for the
    # second
    st = torch.cuda.Stream(dev)
    st.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(st):
        for b in (2, 8):
            lens = torch.tensor([4096, 3000, 1, 0, 2048, 4095, 64, 4096][:b],
                                dtype=torch.int32, device=dev)
            x = [_rand(rng, (b, 128), torch.bfloat16, dev),
                 _rand(rng, (b, 4096, 128), torch.bfloat16, dev),
                 _rand(rng, (b, 4096, 128), torch.bfloat16, dev), lens]
            ws = fa._workspaces.get((dev.index, st.cuda_stream))
            got = fa.decode_attention(*x)
            st.synchronize()
            want2, bound2 = decode_want(*x)
            record(f"workspace growth: B{b} L4096 d128 bf16 after "
                   f"{'nothing' if ws is None else ws[1].numel()}",
                   ["flash_decode"], got, want2, bound2)
    ws = fa._workspaces[(dev.index, st.cuda_stream)]
    plan8 = fa._plan("decode", dev, torch.bfloat16, 128, bh=8, sk=4096)
    check(ws[1].numel() >= 8 and ws[0].numel() >= 8 * plan8.splits * 130,
          "the workspace did not grow for B8")
    check(not ws[1].any().item(), "a ticket was left set after the merge")

    # flash_attn_fwd with a per-head device q_offset, as decode_attention
    # used it before flash_decode: row r of head b at lengths[b] - 1 + r
    for name, (bh, sq, sk, d), lens in (
            ("q_offset sq1 sk160 d32 fp32 lengths 0/1/160",
             (8, 1, 160, 32), [0, 1, 160, 37, 80, 5, 159, 100]),
            ("q_offset sq100 sk300 d64 fp32 lengths 0/1/300",
             (8, 100, 300, 64), [0, 1, 300, 37, 150, 299, 64, 200])):
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        q = _rand(rng, (bh, sq, d), torch.float32, dev)
        k = _rand(rng, (bh, sk, d), torch.float32, dev)
        v = _rand(rng, (bh, sk, d), torch.float32, dev)
        before = dict(fa.launches)
        got = fa._launch_tile("flash_attn_fwd", q, k, v, d ** -0.5, True,
                              q_offset=lengths, q_offset_add=-1)
        launched = _launched(fa, before)
        check(launched == ["flash_attn_fwd"], f"{name}: launched {launched}")
        want = fa._flash_plain(q, k, v, d ** -0.5, True, 64,
                               q_offset=lengths - 1)
        record(name, launched, got, want, FP32_TOL)
        check(not got[lengths == 0, 0].any().item(),
              f"{name}: row 0 of a length-0 head must be zeros")

    cases = [
        # (name, shape q, sk, dtype, causal, block_k)
        ("8x2048x64 fp32", (8, 2048, 64), 2048, torch.float32, False, 128),
        ("8x2048x64 fp32 causal", (8, 2048, 64), 2048, torch.float32, True,
         128),
        ("8x2048x64 bf16", (8, 2048, 64), 2048, torch.bfloat16, False, 128),
        ("8x2048x64 bf16 causal", (8, 2048, 64), 2048, torch.bfloat16, True,
         128),
        ("8x2048x64 fp16 causal", (8, 2048, 64), 2048, torch.float16, True,
         128),
        ("ragged 4x1000x64 block 128 causal", (4, 1000, 64), 1000,
         torch.float32, True, 128),
        ("sq16 sk40 d32 causal", (2, 16, 32), 40, torch.float32, True, 128),
        ("2x300x16 fp32 causal", (2, 300, 16), 300, torch.float32, True,
         128),
        ("2x300x128 bf16", (2, 300, 128), 300, torch.bfloat16, False, 128),
        ("sq16 sk40 d64 bf16 causal", (16, 16, 64), 40, torch.bfloat16,
         True, 128),
        ("ragged 2x1000x128 fp16 causal", (2, 1000, 128), 1000,
         torch.float16, True, 128),
        # flash_attn_fwd at its tile edges: 64-row blocks, 64-key tiles
        # (32 at d 128)
        ("sq50 sk50 d64 fp32", (3, 50, 64), 50, torch.float32, False, 64),
        ("sq130 sk97 d64 fp32 causal", (2, 130, 64), 97, torch.float32,
         True, 64),
        ("sq70 sk200 d128 fp32 causal", (2, 70, 128), 200, torch.float32,
         True, 64),
        ("sq200 sk161 d128 fp32", (2, 200, 128), 161, torch.float32, False,
         64),
        ("sq100 sk77 d32 fp32 causal", (3, 100, 32), 77, torch.float32, True,
         64),
        ("sq65 sk129 d16 fp32", (2, 65, 16), 129, torch.float32, False, 64),
        # 16-bit inputs at head dim 16/32 (flash_attn_fwd_tc; flash_attn_fwd
        # is held on them below, through _launch_tile)
        ("4x257x32 bf16", (4, 257, 32), 257, torch.bfloat16, False, 64),
        ("4x257x32 bf16 causal", (4, 257, 32), 257, torch.bfloat16, True,
         64),
        ("3x190x16 fp16", (3, 190, 16), 190, torch.float16, False, 64),
        ("3x190x16 fp16 causal", (3, 190, 16), 190, torch.float16, True, 64),
        # one tile, and the ragged edge inside one tile, at d 16/32
        ("sq64 sk64 d16 bf16", (2, 64, 16), 64, torch.bfloat16, False, 64),
        ("sq64 sk64 d32 fp16 causal", (2, 64, 32), 64, torch.float16, True,
         64),
        ("sq16 sk40 d32 bf16 causal", (3, 16, 32), 40, torch.bfloat16, True,
         64),
        ("8x2048x32 bf16", (8, 2048, 32), 2048, torch.bfloat16, False, 128),
    ]
    simt_16bit = ("4x257x32 bf16", "4x257x32 bf16 causal", "3x190x16 fp16",
                  "3x190x16 fp16 causal")
    for name, qshape, sk, dtype, causal, block_k in cases:
        kshape = qshape[:-2] + (sk, qshape[-1])
        q = _rand(rng, qshape, dtype, dev)
        k = _rand(rng, kshape, dtype, dev)
        v = _rand(rng, kshape, dtype, dev)
        scale = qshape[-1] ** -0.5
        plan = fa._plan("attention", dev, dtype, qshape[-1])
        before = dict(fa.launches)
        got = fa.flash_attention(q, k, v, causal=causal, block_k=block_k)
        launched = _launched(fa, before)
        check(launched == [plan.kernel],
              f"{name}: launched {launched}, planned {plan.kernel}")
        check(got.dtype == dtype and got.shape == q.shape,
              f"{name}: output {got.dtype} {tuple(got.shape)}")
        qf, kf, vf = q.float(), k.float(), v.float()
        want = fa._flash_plain(qf, kf, vf, scale, causal, block_k)
        if dtype == torch.float32:
            bound = FP32_TOL
        else:
            # flash_attn_fwd_tc rounds P before P V; the SIMT kernel not
            pv_abs = (fa._flash_plain(qf, kf, vf.abs(), scale, causal,
                                      block_k)
                      if plan.kernel == "flash_attn_fwd_tc" else None)
            bound = fa._rounding_bound(want, dtype, pv_abs)
        record(name, launched, got, want, bound)
        if name in simt_16bit:
            # flash_attn_fwd on the same inputs: it rounds only its output
            before = dict(fa.launches)
            got = fa._launch_tile("flash_attn_fwd", q, k, v, scale, causal)
            launched = _launched(fa, before)
            check(launched == ["flash_attn_fwd"],
                  f"{name} via _launch_tile: launched {launched}")
            record(f"{name} via _launch_tile", launched, got, want,
                   fa._rounding_bound(want, dtype))
        if name in ("8x2048x64 bf16", "8x2048x32 bf16", "8x2048x64 fp32"):
            control(f"{name} without its last 64 keys",
                    fa._flash_plain(qf, kf[:, :-64], vf[:, :-64], scale,
                                    causal, block_k), want, bound)
    torch.cuda.synchronize()
    check(all(results), "a kernel disagrees with its plain version, or a "
                        "control passed the check")
    return decode_inputs[:4], split_inputs, errs


# ------------------------------------------------------------- phase 3

def _real_us() -> int:
    """The wall clock in microseconds: the axis that spans of two
    processes share (``base_real_us``)."""
    return time.time_ns() // 1000


def _burst(port: int, prompts, max_tokens: int, calls=None,
           timeout_ms=120000, waves=None, scheme: str = "tcp",
           protocol: str = "tpu_std"):
    """N_CLIENTS threads, one Channel each, the prompts dealt round-robin;
    returns ({prompt: tokens}, [(prompt, errno, text)], wall seconds,
    [client ms per call: the first token comes with the last], []).
    ``calls``: a list that gets each call's trace id and its wall-clock
    issue and response times. ``timeout_ms`` None: no deadline in the
    request meta, which the turbo lane's scanner would defer. ``waves``:
    a list that gets each latency's call number on its channel (0: the
    call that opened the connection). ``scheme`` ``ssl``: over TLS.
    ``protocol``: the Channels' (hulu_pbrpc, sofa_pbrpc)."""
    from brpc_tpu_torch.rpc import Channel, ChannelOptions

    results, errors, latency = {}, [], []

    def client(idx):
        # a connection a thread, as since phase 3 began
        ch = Channel(f"{scheme}://127.0.0.1:{port}",
                     ChannelOptions(timeout_ms=timeout_ms,
                                    share_connections=False,
                                    protocol=protocol))
        try:
            for seq, p in enumerate(prompts[idx::N_CLIENTS]):
                t0, issue = time.perf_counter(), _real_us()
                c = ch.call_sync("GenerateService", "Generate",
                                 json.dumps({"prompt": p,
                                             "max_tokens": max_tokens}
                                            ).encode())
                if c.failed():
                    errors.append((p, c.error_code, c.error_text))
                else:
                    latency.append((time.perf_counter() - t0) * 1e3)
                    if waves is not None:
                        waves.append(seq)
                    results[p] = json.loads(c.response)["tokens"]
                    if calls is not None:
                        calls.append({"prompt": p, "seq": seq,
                                      "trace_id": c.trace_id,
                                      "issue_real_us": issue,
                                      "first_real_us": _real_us()})
        finally:
            ch.close()

    return results, errors, _run_clients(client), latency, []


def _check_burst(name, results, errors, oracle):
    check(not errors, f"{name}: failed calls: {errors[:3]}")
    check(len(results) == len(oracle), f"{name}: {len(results)} responses")
    wrong = [p for p in oracle if results[p] != oracle[p]]
    check(not wrong, f"{name}: tokens differ from the CPU plain path for "
                     f"{wrong}")


def _median(xs):
    s = sorted(xs)
    return s[len(s) // 2] if s else None


def _p99(xs):
    s = sorted(xs)
    return s[min(len(s) - 1, int(0.99 * len(s)))] if s else None


# threads that exist once per process however many connections are open
# (the dispatcher is ring_dispatcher in a process on the ring lane)
FIXED_THREADS = {"event_dispatcher", "ring_dispatcher", "fiber_timer",
                 "bvar_sampler"}


def _per_connection_threads(names) -> list:
    return [n for n in names if n.endswith(("-reader", "-writer"))
            or n == "tcp-accept"]


def _check_no_decode_thread() -> None:
    """No decode thread, no handler pool, and no thread per connection
    (the transport reads on the one event dispatcher)."""
    names = [t.name for t in threading.enumerate()]
    check("serving-decode" not in names and
          not any(n.startswith("rpc-handler") for n in names),
          f"a decode thread or handler pool exists: {sorted(names)}")
    check(not _per_connection_threads(names),
          f"a reader, writer or accept thread exists: {sorted(names)}")


def _check_no_thread_per_connection(server, port: int) -> dict:
    """A client process opens N_CLIENTS connections to ``server`` and
    holds them open (``--client hold``); meanwhile this process, the
    server's, must have no reader, writer or accept thread, and the same
    threads as with no client connected, give or take the fixed ones."""
    from collections import Counter
    idle = Counter(t.name for t in threading.enumerate())
    proc = subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--client", "hold",
         str(port)], stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    line = proc.stdout.readline()       # "" once the client has died
    if line.strip():
        held = json.loads(line)["connections"]
        open_now = len(server.connections())
        names = Counter(t.name for t in threading.enumerate())
    try:
        _, err = proc.communicate("\n", timeout=60)
    except subprocess.TimeoutExpired:
        proc.kill()
        _, err = proc.communicate()
    check(line.strip() != "" and proc.returncode == 0,
          f"hold client exited {proc.returncode}: {err[-2000:]}")
    check(open_now >= held == N_CLIENTS,
          f"{open_now} server connections while the client held {held}")
    check(not _per_connection_threads(names),
          f"per-connection threads with {held} connections open: "
          f"{sorted(names)}")
    extra = names - idle
    check(set(extra) <= FIXED_THREADS,
          f"{held} connections open added threads {dict(extra)}")
    return {"connections": open_now, "threads_idle": sum(idle.values()),
            "threads_held": sum(names.values()), "added": dict(extra)}


class _FiberBurst:
    """Reads the fiber fields of one burst: steps by worker group (their
    sum must equal the burst's decode steps), the engine's worker
    threads and decode-lock misses, and the scheduler's counters over
    the burst (the snapshot taken at the start opens the interval)."""

    def __init__(self, server, gs):
        self.server, self.gs = server, gs
        self.groups0 = dict(gs.batcher.steps_by_group)
        self.steps0 = gs.batcher.decode_steps
        self.contended0 = gs.engine.contended
        server.control.saturation_snapshot()

    def finish(self, name: str) -> dict:
        gs = self.gs
        groups = {g: n - self.groups0.get(g, 0)
                  for g, n in sorted(gs.batcher.steps_by_group.items())
                  if n - self.groups0.get(g, 0)}
        steps = gs.batcher.decode_steps - self.steps0
        check(sum(groups.values()) == steps > 0,
              f"{name}: steps by worker group {groups} do not sum to the "
              f"burst's {steps} decode steps")
        _check_no_decode_thread()
        return {"steps_by_group": groups,
                "worker_threads_used": len(gs.engine.threads_seen),
                "decode_lock_contended": gs.engine.contended
                - self.contended0,
                "concurrency": self.server.control.concurrency,
                "cpu_count": os.cpu_count(),
                "saturation": self.server.control.saturation_snapshot()}


def _device_profile(events, window_us: float):
    """Device busy share and kernel time by name from profiler events:
    the union of device intervals over the host window."""
    spans, by_name = [], {}
    for e in events:
        if "CUDA" not in str(getattr(e, "device_type", "")):
            continue
        tr = e.time_range
        spans.append((tr.start, tr.end))
        by_name[e.name] = by_name.get(e.name, 0.0) + (tr.end - tr.start)
    spans.sort()
    busy, cur_s, cur_e = 0.0, None, None
    for s0, e0 in spans:
        if cur_e is None or s0 > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s0, e0
        else:
            cur_e = max(cur_e, e0)
    if cur_e is not None:
        busy += cur_e - cur_s
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"device_events": len(spans),
            "device_busy_us": busy if spans else None,
            "device_busy_share": busy / window_us if spans else None,
            "top_device_us": [[n[:90], t] for n, t in top]}


def phase_serving():
    import torch
    from torch.profiler import ProfilerActivity, profile

    fa = _fa_module()
    from brpc_tpu_torch.rpc import Server
    from brpc_tpu_torch.serving import (TinyDecoder, TinyDecoderConfig,
                                        add_generate_service)

    prompts = _prompts()
    cpu_model = TinyDecoder(TinyDecoderConfig(), device="cpu")
    oracle = {p: cpu_model.generate(list(p.encode()), MAX_TOKENS)
              for p in prompts}

    # the main path: counts to zero, server start (its warm-up step
    # launches flash_decode once), one burst, counts read just after
    fa.reset_launches()
    server = Server()
    gs = add_generate_service(server)           # defaults, on cuda:0
    check(str(gs.device) == "cuda:0", f"service device {gs.device}")
    ep = server.start("tcp://127.0.0.1:0")
    try:
        fb = _FiberBurst(server, gs)
        results, errors, wall = _burst(ep.port, prompts, MAX_TOKENS)[:3]
        torch.cuda.synchronize()
        launches = dict(fa.launches)
        fibers1 = fb.finish("burst 1")
        steps = gs.batcher.decode_steps
        warm = gs.engine.warmup_steps
        hist = dict(gs.batcher.batch_hist)
        ttft_first = gs.ttft_samples()
        _check_burst("burst 1", results, errors, oracle)
        # the serving shape takes one flash_decode launch a step (one
        # block a sequence)
        check(launches["flash_decode"] == steps + warm and
              sum(launches.values()) == launches["flash_decode"],
              f"kernel launches {launches} != decode steps {steps} + "
              f"warm-up {warm} of flash_decode alone")
        check(launches["flash_decode"] > 0, "flash_decode was never launched")
        held = _check_no_thread_per_connection(server, ep.port)
        # the same burst again, warm, then once more under the profiler
        fb = _FiberBurst(server, gs)
        results2, errors2, wall2 = _burst(ep.port, prompts, MAX_TOKENS)[:3]
        _check_burst("burst 2", results2, errors2, oracle)
        fibers2 = fb.finish("burst 2")
        ttft_warm = gs.ttft_samples()[len(ttft_first):]
        steps2 = gs.batcher.decode_steps - steps
        fb = _FiberBurst(server, gs)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            results3, errors3, _ = _burst(ep.port, prompts, MAX_TOKENS)[:3]
            torch.cuda.synchronize()
            window_us = (time.perf_counter() - t0) * 1e6
        _check_burst("burst 3 (profiled)", results3, errors3, oracle)
        fb.finish("burst 3 (profiled)")
    finally:
        server.stop()
        server.join(10)
    tokens = sum(len(t) for t in results.values())
    out = {"phase": "serving", "requests": N_REQUESTS, "clients": N_CLIENTS,
           "tokens": tokens, "wall_s": wall, "tokens_per_s": tokens / wall,
           "ttft_p50_ms": _median(ttft_first), "ttft_p99_ms": _p99(ttft_first),
           "decode_steps": steps, "warmup_steps": warm,
           "kernel_launches": launches,
           "batch_size_hist": hist, "tokens_equal_cpu_plain": True,
           "warm_wall_s": wall2, "warm_tokens_per_s": tokens / wall2,
           "warm_ttft_p50_ms": _median(ttft_warm),
           "warm_ttft_p99_ms": _p99(ttft_warm), "warm_decode_steps": steps2,
           "warm_ms_per_step": wall2 * 1e3 / steps2,
           "fibers": fibers1, "warm_fibers": fibers2,
           "held_connections": held}
    emit(out)
    trace = {"phase": "serving_trace", "window_us": window_us}
    trace.update(_device_profile(prof.events(), window_us))
    emit(trace)
    return out


# ------------------------------------------------------------- phase 4

def _stream_burst(port: int, prompts, max_tokens: int, calls=None,
                  protocol: str = "tpu_std"):
    """The burst of ``_burst`` with every call streaming its tokens back
    (``stream_options``). Returns ({prompt: tokens}, [errors], wall s,
    [client ms to the first token], [ms between tokens]); ``calls`` as
    in ``_burst``, the first token frame's arrival as the response;
    ``protocol`` the Channels'."""
    from brpc_tpu_torch.rpc import Channel, ChannelOptions, StreamOptions

    results, errors, ttft, gaps = {}, [], [], []
    want_done = b'd{"n": %d, "status": "completed"}' % max_tokens

    def one(ch, p, seq):
        toks, times, verdict, first_real = [], [], [], []
        done = threading.Event()

        def on_received(stream, msg):
            if msg.payload[:1] == b"t":
                if not toks:
                    first_real.append(_real_us())
                toks.append(msg.payload[1])
                times.append(time.perf_counter())
            else:
                verdict.append(msg.payload)
                done.set()

        t0, issue = time.perf_counter(), _real_us()
        c = ch.call_sync("GenerateService", "Generate",
                         json.dumps({"prompt": p, "max_tokens": max_tokens}
                                    ).encode(),
                         stream_options=StreamOptions(
                             on_received=on_received))
        if c.failed():
            errors.append((p, c.error_code, c.error_text))
            return
        try:
            if not done.wait(120) or verdict != [want_done]:
                errors.append((p, "verdict", verdict))
                return
        finally:
            c.stream.close()
        results[p] = toks
        ttft.append((times[0] - t0) * 1e3)
        gaps.extend((b - a) * 1e3 for a, b in zip(times, times[1:]))
        if calls is not None:
            calls.append({"prompt": p, "seq": seq, "trace_id": c.trace_id,
                          "issue_real_us": issue,
                          "first_real_us": first_real[0]})

    def client(idx):
        ch = Channel(f"tcp://127.0.0.1:{port}",
                     ChannelOptions(timeout_ms=120000,
                                    share_connections=False,
                                    protocol=protocol))
        try:
            for seq, p in enumerate(prompts[idx::N_CLIENTS]):
                one(ch, p, seq)
        finally:
            ch.close()

    wall = _run_clients(client)
    return results, errors, wall, ttft, gaps


def _http_generate(conn, prompt: str, max_tokens: int, call=None):
    """One chunked Generate over ``conn``: (tokens, footer, client ms to
    the first token byte, [ms between token bytes]). ``call``: a dict
    that gets the connection's local address and the wall-clock issue
    and first-byte times."""
    t0, issue = time.perf_counter(), _real_us()
    conn.request("POST", "/GenerateService/Generate",
                 body=json.dumps({"prompt": prompt,
                                  "max_tokens": max_tokens}))
    resp = conn.getresponse()
    check(resp.status == 200 and
          resp.getheader("Transfer-Encoding") == "chunked",
          f"HTTP Generate answered {resp.status}")
    data, times, first_real = b"", [], None
    while True:
        part = resp.read1(65536)        # one chunk's data at most
        if not part:
            break
        now = time.perf_counter()
        if first_real is None:
            first_real = _real_us()
        data += part
        times.extend([now] * len(part))
    payload, _, footer = data.rpartition(b"\n#")
    times = times[:len(payload)]
    gaps = [(b - a) * 1e3 for a, b in zip(times, times[1:])]
    if call is not None:
        host, port = conn.sock.getsockname()[:2]
        call.update(local=f"{host}:{port}", issue_real_us=issue,
                    first_real_us=first_real)
    return (list(payload), footer,
            (times[0] - t0) * 1e3 if times else None, gaps)


def _http_burst(port: int, prompts, max_tokens: int, calls=None):
    """The burst over HTTP/1.1 chunked transfer, one keep-alive
    connection a client thread; ``calls`` as in ``_burst``, with each
    call's connection (local address) and its order on it."""
    import http.client

    results, errors, ttft, gaps = {}, [], [], []
    want_footer = b"completed n=%d" % max_tokens

    def client(idx):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        try:
            for seq, p in enumerate(prompts[idx::N_CLIENTS]):
                call = {"prompt": p, "seq": seq}
                toks, footer, first, g = _http_generate(conn, p, max_tokens,
                                                        call)
                if footer != want_footer:
                    errors.append((p, footer))
                    continue
                results[p] = toks
                ttft.append(first)
                gaps.extend(g)
                if calls is not None:
                    calls.append(call)
        finally:
            conn.close()

    wall = _run_clients(client)
    return results, errors, wall, ttft, gaps


def _run_clients(client) -> float:
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(N_CLIENTS)]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    check(not any(t.is_alive() for t in threads), "clients hung")
    return time.monotonic() - t0


def _burst_nodl(port: int, prompts, max_tokens: int, calls=None,
                waves=None):
    return _burst(port, prompts, max_tokens, calls, timeout_ms=None,
                  waves=waves)


def _burst_hulu(port: int, prompts, max_tokens: int, calls=None,
                waves=None):
    return _burst(port, prompts, max_tokens, calls, waves=waves,
                  protocol="hulu_pbrpc")


BURSTS = {"stream": _stream_burst, "http": _http_burst, "unary": _burst,
          "unary_nodl": _burst_nodl, "unary_hulu": _burst_hulu}


def client_main(kind: str, port: int, traced: bool = False) -> int:
    """``python3 chip_smoke.py --client KIND PORT [--rpcz]``: one burst of
    KIND (stream, http or unary) against the server on PORT, from a
    process of its own, so that the clients do not share the server's
    interpreter lock; prints its result as one JSON line. ``--rpcz``
    turns rpcz on in this process and adds each call's record and the
    process's finished client spans to the line. KIND ``cost``: the
    turns of the observability phase's flag costs instead."""
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    if kind == "cost":
        emit({"runs": _cost_turns(port)})
        return 0
    if kind == "hold":
        return _hold_connections(port)
    if kind == "native_server":
        return _native_server_session()
    if kind == "malloc_turn":
        return _malloc_turn()
    if kind == "shards_control":
        return _cuda_control()
    if kind == "sanitize":
        return _sanitize_child()
    if kind == "lint_serve":
        return _lint_serve_child()
    backend = os.environ.get("CHIP_SMOKE_RING_BACKEND")
    if backend:
        _install_ring(int(backend))
    calls = None
    if traced:
        from brpc_tpu_torch.butil.flags import set_flag
        check(set_flag("rpcz_enabled", True), "cannot turn rpcz on")
        calls = []
    waves = [] if kind.startswith("unary") else None
    kw = {} if waves is None else {"waves": waves}
    start_at = os.environ.get("CHIP_SMOKE_START_AT")
    if start_at:
        return _timed_bursts(kind, port,
                             [float(x) for x in start_at.split(",")])
    cpu0 = time.process_time()
    res, errs, wall, ttft, gaps = BURSTS[kind](port, _prompts(), MAX_TOKENS,
                                               calls=calls, **kw)
    doc = {"results": res, "errors": errs, "wall_s": wall, "ttft_ms": ttft,
           "gaps_ms": gaps, "cpu_s": time.process_time() - cpu0,
           "native": _native_counters(), "waves": waves,
           "lane": _lane(), "ring": _ring_counters()}
    if traced:
        from brpc_tpu_torch.rpc.span import global_collector
        doc["calls"] = calls
        doc["spans"] = [s.to_dict() for s in global_collector.recent(4096)]
    emit(doc)
    return 0


def _timed_bursts(kind: str, port: int, instants) -> int:
    """``CHIP_SMOKE_START_AT=t0[,t1...]`` (phase shards): one untimed burst
    (imports, the native core, first uses), then one burst at each of
    the wall-clock instants, so that several client processes burst
    together; one JSON line with each timed burst."""
    BURSTS[kind](port, _prompts(), MAX_TOKENS)
    warm_end = time.time()
    runs = []
    for t0 in instants:
        time.sleep(max(0.0, t0 - time.time()))
        late = time.time() - t0
        cpu0 = time.process_time()
        res, errs, wall, ttft, _ = BURSTS[kind](port, _prompts(), MAX_TOKENS)
        runs.append({"results": res, "errors": errs, "wall_s": wall,
                     "ttft_ms": ttft, "cpu_s": time.process_time() - cpu0,
                     "start_late_s": late})
    emit({"runs": runs, "warm_end": warm_end})
    return 0


def _hold_connections(port: int) -> int:
    """``--client hold PORT``: N_CLIENTS channels, one answered call on
    each (an unknown service: no decode step), a JSON line, then the
    connections stay open until a line comes on stdin."""
    from brpc_tpu_torch.rpc import Channel, ChannelOptions
    channels = [Channel(f"tcp://127.0.0.1:{port}",
                        ChannelOptions(timeout_ms=30000,
                                       share_connections=False))
                for _ in range(N_CLIENTS)]
    try:
        for ch in channels:
            c = ch.call_sync("NoSuchService", "Hold", b"")
            check(c.error_code == 1001, f"hold call: {c.error_code} "
                                        f"{c.error_text}")
        emit({"connections": len(channels)})
        sys.stdin.readline()
    finally:
        for ch in channels:
            ch.close()
    return 0


def _client_process(args, timeout_s: float = 300, env=None) -> dict:
    out = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), "--client", *args],
        capture_output=True, text=True, timeout=timeout_s,
        env=None if env is None else dict(os.environ, **env))
    check(out.returncode == 0,
          f"{args[0]} client process failed: {out.stderr[-2000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def _client_process_burst(kind: str, port: int):
    doc = _client_process([kind, str(port)])
    return (doc["results"], doc["errors"], doc["wall_s"], doc["ttft_ms"],
            doc["gaps_ms"])


def _burst_line(res, wall, ttft, gaps) -> dict:
    tokens = sum(len(t) for t in res.values())
    return {"wall_s": wall, "tokens_per_s": tokens / wall,
            "ttft_p50_ms": _median(ttft), "ttft_p99_ms": _p99(ttft),
            "gap_p50_ms": _median(gaps), "gap_p99_ms": _p99(gaps)}


def phase_streaming():
    """The stream and HTTP paths of Generate, each part with the launch
    counts zeroed just before and read just after: (a) the burst with
    every call streaming, cold then warm; (b) the same burst over HTTP
    chunked transfer; (c) one 120-token stream whose first token must
    land before half its last token's time, a dead HTTP peer whose slot
    must be freed, a stream burst under the profiler, and two bursts to
    compare with: unary calls, and streams from this process. The bursts
    of (a), (b) and the unary and profiled ones run in a client process
    of their own (``--client``)."""
    import http.client
    import socket

    import torch
    from torch.profiler import ProfilerActivity, profile

    fa = _fa_module()
    from brpc_tpu_torch.rpc import Channel, ChannelOptions, StreamOptions
    from brpc_tpu_torch.rpc import Server
    from brpc_tpu_torch.serving import (TinyDecoder, TinyDecoderConfig,
                                        add_generate_service)

    phase_t0 = time.monotonic()
    prompts = _prompts()
    cpu_model = TinyDecoder(TinyDecoderConfig(), device="cpu")
    oracle = {p: cpu_model.generate(list(p.encode()), MAX_TOKENS)
              for p in prompts}
    long_prompt = "one longer stream"
    long_want = cpu_model.generate(list(long_prompt.encode()), 120)
    out = {"phase": "streaming", "requests": N_REQUESTS,
           "clients": N_CLIENTS, "max_tokens": MAX_TOKENS}
    parts = {}

    def counted(name, steps_before, warmup=0):
        torch.cuda.synchronize()
        launches = dict(fa.launches)
        steps = gs.batcher.decode_steps - steps_before
        check(launches["flash_decode"] == steps + warmup > 0 and
              sum(launches.values()) == launches["flash_decode"],
              f"{name}: kernel launches {launches} != decode steps "
              f"{steps} + warm-up {warmup} of flash_decode alone")
        parts[name] = {"flash_decode": launches["flash_decode"],
                       "decode_steps": steps, "warmup_steps": warmup}

    def bursts(kind, labels, burst=None):
        for label in labels:
            n0, steps0 = len(gs.ttft_samples()), gs.batcher.decode_steps
            fb = _FiberBurst(server, gs)
            res, errs, wall, ttft, gaps = (
                burst(ep.port, prompts, MAX_TOKENS) if burst
                else _client_process_burst(kind, ep.port))
            _check_burst(f"{kind} burst ({label})", res, errs, oracle)
            line = _burst_line(res, wall, ttft, gaps)
            # the server's own TTFT (request made to first token decoded)
            # and the batch it kept: what the transport does not explain
            server_ttft = gs.ttft_samples()[n0:]
            steps = gs.batcher.decode_steps - steps0
            line.update(server_ttft_p50_ms=_median(server_ttft),
                        server_ttft_p99_ms=_p99(server_ttft),
                        decode_steps=steps,
                        tokens_per_step=N_REQUESTS * MAX_TOKENS / steps,
                        **fb.finish(f"{kind} burst ({label})"))
            out[f"{kind}_{label}"] = line

    fa.reset_launches()
    server = Server()
    gs = add_generate_service(server)           # defaults, on cuda:0
    check(str(gs.device) == "cuda:0", f"service device {gs.device}")
    ep = server.start("tcp://127.0.0.1:0")
    _check_no_decode_thread()
    # every decode step timed on the worker that runs it, with the
    # prompts it admitted and the host time of its prefills and of the
    # model's decode step (steps are serialized, so the counters'
    # differences across a step are that step's own)
    step_ms, acc = [], {"prefills": 0, "prefill_s": 0.0, "decode_s": 0.0}
    model = gs.batcher.model
    real_step, real_prefill = gs.batcher.step, model.prefill
    real_decode = model.decode_step

    def counted_prefill(tokens):
        t0 = time.perf_counter()
        out = real_prefill(tokens)
        acc["prefills"] += 1
        acc["prefill_s"] += time.perf_counter() - t0
        return out

    def timed_decode(*args):
        t0 = time.perf_counter()
        out = real_decode(*args)
        acc["decode_s"] += time.perf_counter() - t0
        return out

    def timed_step(group_index=None):
        a0, t0 = dict(acc), time.perf_counter()
        did = real_step(group_index)
        if did:
            step_ms.append((threading.get_ident(),
                            (time.perf_counter() - t0) * 1e3,
                            acc["prefills"] - a0["prefills"],
                            (acc["prefill_s"] - a0["prefill_s"]) * 1e3,
                            (acc["decode_s"] - a0["decode_s"]) * 1e3))
        return did

    model.prefill, model.decode_step = counted_prefill, timed_decode
    gs.batcher.step = timed_step
    try:
        bursts("stream", ("cold", "warm"))                  # (a)
        counted("stream", 0, gs.engine.warmup_steps)
        fa.reset_launches()
        steps0 = gs.batcher.decode_steps
        bursts("http", ("cold", "warm"))                    # (b)
        counted("http", steps0)

        fa.reset_launches()
        steps0 = gs.batcher.decode_steps
        # (c) one longer stream: tokens leave as they decode
        ch = Channel(f"tcp://127.0.0.1:{ep.port}",
                     ChannelOptions(timeout_ms=60000))
        toks, times, done = [], [], threading.Event()

        def on_received(stream, msg):
            if msg.payload[:1] == b"t":
                toks.append(msg.payload[1])
                times.append(time.perf_counter())
            else:
                done.set()

        t0 = time.perf_counter()
        c = ch.call_sync("GenerateService", "Generate",
                         json.dumps({"prompt": long_prompt,
                                     "max_tokens": 120}).encode(),
                         stream_options=StreamOptions(
                             on_received=on_received))
        check(not c.failed() and done.wait(60),
              f"long stream failed: {c.error_text}")
        c.stream.close()
        ch.close()
        check(toks == long_want, "long stream: tokens differ from the CPU "
                                 "plain path")
        first_ms, last_ms = (times[0] - t0) * 1e3, (times[-1] - t0) * 1e3
        check(first_ms < 0.5 * last_ms,
              f"long stream: first token at {first_ms} ms, last at "
              f"{last_ms} ms")
        out["long_stream"] = {"tokens": len(toks), "first_token_ms": first_ms,
                              "last_token_ms": last_ms}

        # (c) a dead HTTP peer: its slot must be freed
        sock = socket.create_connection(("127.0.0.1", ep.port), timeout=30)
        body = json.dumps({"prompt": "a peer that dies",
                           "max_tokens": 120}).encode()
        sock.sendall(b"POST /GenerateService/Generate HTTP/1.1\r\n"
                     b"Content-Length: %d\r\n\r\n%s" % (len(body), body))
        got = b""
        while b"\r\n\r\n" not in got or \
                got.index(b"\r\n\r\n") + 4 >= len(got):
            part = sock.recv(4096)
            check(bool(part), "dead peer: no first chunk")
            got += part
        canceled0 = gs.batcher.canceled
        sock.close()
        t0 = time.monotonic()
        while gs.batcher.running_count() and time.monotonic() - t0 < 5:
            time.sleep(0.002)
        freed_s = time.monotonic() - t0
        check(gs.batcher.running_count() == 0,
              "dead HTTP peer: its slot was not freed within 5 s")
        check(gs.batcher.canceled == canceled0 + 1,
              "dead HTTP peer: its sequence was not cancelled")
        conn = http.client.HTTPConnection("127.0.0.1", ep.port, timeout=60)
        toks, footer, _, _ = _http_generate(conn, prompts[0], MAX_TOKENS)
        conn.close()
        check(footer == b"completed n=%d" % MAX_TOKENS
              and toks == oracle[prompts[0]],
              "the request after the dead peer did not complete")
        out["dead_http_peer"] = {"slot_freed_s": freed_s}

        # (c) a stream burst under the profiler, then the comparisons
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            bursts("stream", ("profiled",))
            torch.cuda.synchronize()
        # the burst's own wall, as its client process timed it: the
        # server is idle before and after, the process start-up is not
        # the burst's
        window_us = out["stream_profiled"]["wall_s"] * 1e6
        bursts("unary", ("warm",))
        bursts("stream", ("in_process",), _stream_burst)
        counted("long stream, dead peer, profiled and compared bursts",
                steps0)
    finally:
        server.stop()
        server.join(10)
    trace = {"phase": "streaming_trace", "window_us": window_us}
    trace.update(_device_profile(prof.events(), window_us))
    def step_doc(ms, admitted, prefill_ms, decode_ms):
        return {"ms": ms, "admitted": admitted, "prefill_host_ms": prefill_ms,
                "decode_host_ms": decode_ms}

    first, seen = [], set()
    for tid, *rest in step_ms:
        if tid not in seen:
            seen.add(tid)
            first.append(step_doc(*rest))
    plain = [ms for _, ms, a, _, _ in step_ms if not a]
    admit = [ms for _, ms, a, _, _ in step_ms if a]
    out["steps"] = {
        "first_of_phase": [step_doc(*s[1:]) for s in step_ms[:3]],
        "first_per_thread": first,
        "no_admission": {"count": len(plain), "ms_p50": _median(plain),
                         "ms_p99": _p99(plain)},
        "admission": {"count": len(admit), "ms_p50": _median(admit),
                      "ms_p99": _p99(admit),
                      "prompts": sum(s[2] for s in step_ms)}}
    out["launches"] = parts
    out["tokens_equal_cpu_plain"] = True
    out["stream_profiled"]["device_busy_share"] = trace["device_busy_share"]
    out["phase_s"] = time.monotonic() - phase_t0
    emit(out)
    emit(trace)
    return out


# ------------------------------------------------------ observability

# the stitched timeline of one call, in order; consecutive stamps on the
# wall clock of both processes, so the stages sum to the client's TTFT
STAGES = ("way_in", "received_to_handler", "handler_to_admitted",
          "admitted_to_prefilled", "prefilled_to_first_token", "way_out")
COST_FLAGS = ("serving_stats_enabled", "rpcz_enabled")
COST_TURNS = 3


def _http_page(port: int, path: str, method: str = "GET"):
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request(method, path, body=b"" if method == "POST" else None)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _set_flags(port: int, **flags) -> None:
    """Set flags on the server at ``port`` (``POST /flags/<name>``);
    ``rpcz_enabled`` in this process too, whose client spans it rules."""
    from brpc_tpu_torch.butil.flags import set_flag
    for name, value in flags.items():
        status, body = _http_page(
            port, f"/flags/{name}?setvalue={str(value).lower()}", "POST")
        check(status == 200, f"server refused flag {name}: {body!r}")
        if name == "rpcz_enabled":
            check(set_flag(name, value), f"cannot set flag {name}")


def _cost_turns(port: int) -> list:
    """The warm stream burst in turns, off and on, COST_TURNS times for
    each of COST_FLAGS, the order of a pair alternating (off first in
    even turns), so that neither setting always runs second; rpcz stays
    off while serving_stats is measured, and serving_stats on while rpcz
    is (a serving span needs it)."""
    runs = []
    for name in COST_FLAGS:
        for turn in range(COST_TURNS):
            for on in ((False, True) if turn % 2 == 0 else (True, False)):
                flags = {"serving_stats_enabled": True,
                         "rpcz_enabled": False}
                flags[name] = on
                _set_flags(port, **flags)
                res, errs, wall, ttft, _ = _stream_burst(port, _prompts(),
                                                         MAX_TOKENS)
                runs.append({"flag": name, "on": on, "turn": turn,
                             "results": res, "errors": errs, "wall_s": wall,
                             "client_ttft_p50_ms": _median(ttft)})
    _set_flags(port, serving_stats_enabled=True, rpcz_enabled=False)
    return runs


def _stitch(kind: str, calls, client_spans, server_spans, first_token):
    """Each call's stages (STAGES, microseconds on the wall clock) from
    its client record, its client span (tpu_std), its server span
    (tpu_std) and its serving span, checked for one of each per call;
    ``first_token``: {serving span id: the tracker's first-token stamp,
    monotonic ns}. An HTTP call has no client or server span: it is
    matched to its serving span by its connection and its order there,
    and its handler start is the serving span's start."""
    by_trace = {}
    for s in server_spans:
        by_trace.setdefault(s["trace_id"], []).append(s)
    mine = {s["trace_id"]: s for s in client_spans}
    check(len(mine) == len(client_spans),
          f"{kind}: two client spans share a trace")
    http_serving = {}
    if kind == "http":
        for s in server_spans:
            if s["side"] == "serving" and not int(s["parent_span_id"], 16):
                http_serving.setdefault(s["remote_side"], []).append(s)
        for v in http_serving.values():
            v.sort(key=lambda s: s["start_us"])
    rows = []
    for c in calls:
        if kind == "http":
            server = None
            conn = http_serving.get(f"tcp://{c['local']}", [])
            check(c["seq"] < len(conn),
                  f"http call {c['prompt']!r}: no serving span")
            serving = conn[c["seq"]]
            check(len(by_trace[serving["trace_id"]]) == 1,
                  f"http call {c['prompt']!r}: more than one span")
        else:
            tid = f"{c['trace_id']:016x}"
            cs = mine.get(tid)
            check(cs is not None, f"{kind} call {c['prompt']!r}: no client "
                                  "span")
            spans = by_trace.get(tid, [])
            sides = sorted(s["side"] for s in spans)
            check(sides == ["server", "serving"],
                  f"{kind} trace {tid}: server-side spans {sides}")
            server = next(s for s in spans if s["side"] == "server")
            serving = next(s for s in spans if s["side"] == "serving")
            check(server["parent_span_id"] == cs["span_id"]
                  and serving["parent_span_id"] == server["span_id"],
                  f"{kind} trace {tid}: parent links broken")
        stages = [serving[k] for k in ("queue_us", "prefill_us",
                                       "decode_us", "emit_us")]
        check(abs(sum(stages) - serving["latency_us"]) <= len(stages),
              f"{kind}: serving stages {stages} do not sum to "
              f"{serving['latency_us']}")
        off = serving["base_real_us"] - serving["start_us"]
        first = first_token.get(serving["span_id"])
        check(bool(first), f"{kind}: no first-token stamp for a call")
        wall = {
            "issue": c["issue_real_us"],
            "handler": (server["handler_start_us"] if server
                        else serving["start_us"]) + off,
            "admitted": serving["write_done_us"] + off,
            "prefilled": serving["first_byte_us"] + off,
            "first_token": first // 1000 + off,
            "client_first": c["first_real_us"],
        }
        if server is not None:
            wall["received"] = server["received_us"] + (
                server["base_real_us"] - server["start_us"])
        # an HTTP call has no arrival stamp: its way in runs to the
        # handler, and received -> handler is not known
        wall.setdefault("received", wall["handler"])
        order = ["issue", "received", "handler", "admitted", "prefilled",
                 "first_token", "client_first"]
        row = {stage: wall[b] - wall[a]
               for stage, a, b in zip(STAGES, order, order[1:])}
        if server is None:
            row["received_to_handler"] = None
        row["sum"] = sum(v for v in row.values() if v is not None)
        row["client_ttft"] = wall["client_first"] - wall["issue"]
        # a client's first call on its connection opens it (the Channel
        # and http.client connect on first use)
        row["first_on_connection"] = c["seq"] == 0
        rows.append(row)
    return rows


def _timeline_line(kind: str, rows) -> dict:
    out = {"transport": kind, "calls": len(rows), "unit": "us"}
    for stage in STAGES + ("sum", "client_ttft"):
        xs = [r[stage] for r in rows if r[stage] is not None]
        out[stage] = ({"p50": _median(xs), "p99": _p99(xs)} if xs
                      else None)
    for first in (True, False):
        xs = [r for r in rows if r["first_on_connection"] == first]
        key = "first_call_on_connection" if first else "later_calls"
        out[key] = {"calls": len(xs), **{
            stage: _median([r[stage] for r in xs])
            for stage in ("way_in", "client_ttft")}}
    return out


def phase_observability():
    """rpcz spans, serving stats and the builtin pages on the main path:
    a fresh default server on cuda:0 with rpcz on, one warm burst of
    each kind (stream, HTTP, unary) from client processes that trace
    too, the pages, the stitched stage timeline of every call across
    the two processes, and the cost of ``serving_stats_enabled`` and
    ``rpcz_enabled`` in turns."""
    import torch

    fa = _fa_module()
    from brpc_tpu_torch.butil.flags import set_flag
    from brpc_tpu_torch.rpc import Server
    from brpc_tpu_torch.serving import (TinyDecoder, TinyDecoderConfig,
                                        add_generate_service)
    from brpc_tpu_torch.serving import serving_stats

    phase_t0 = time.monotonic()
    prompts = _prompts()
    cpu_model = TinyDecoder(TinyDecoderConfig(), device="cpu")
    oracle = {p: cpu_model.generate(list(p.encode()), MAX_TOKENS)
              for p in prompts}
    # the trackers' first-token stamps, which no span carries
    trackers = []
    real_open = serving_stats.open_generation

    def kept_open(*args, **kwargs):
        tr = real_open(*args, **kwargs)
        if tr is not None and tr.span is not None:
            trackers.append(tr)
        return tr

    fa.reset_launches()
    check(set_flag("rpcz_enabled", False), "cannot set rpcz_enabled")
    server = Server()
    gs = add_generate_service(server)           # defaults, on cuda:0
    check(str(gs.device) == "cuda:0", f"service device {gs.device}")
    ep = server.start("tcp://127.0.0.1:0")
    serving_stats.open_generation = kept_open
    out = {"phase": "observability", "requests": N_REQUESTS,
           "clients": N_CLIENTS, "max_tokens": MAX_TOKENS}
    try:
        # warm the server untraced, then trace one burst of each kind
        res, errs = _client_process_burst("stream", ep.port)[:2]
        _check_burst("observability warm-up", res, errs, oracle)

        def cell_requests():
            doc = json.loads(_http_page(ep.port, "/serving")[1])
            cell = doc["stats"]["methods"].get("GenerateService.Generate")
            return cell["requests"] if cell else 0

        requests0 = cell_requests()
        check(set_flag("rpcz_enabled", True), "cannot set rpcz_enabled")
        traced = {}
        for kind in ("stream", "http", "unary"):
            doc = _client_process([kind, str(ep.port), "--rpcz"])
            _check_burst(f"traced {kind} burst", doc["results"],
                         doc["errors"], oracle)
            check(len(doc["calls"]) == N_REQUESTS,
                  f"{kind}: {len(doc['calls'])} call records")
            traced[kind] = doc
        check(set_flag("rpcz_enabled", False), "cannot set rpcz_enabled")

        pages = {}
        for path in ("/rpcz?n=4096", "/serving", "/status", "/vars",
                     "/brpc_metrics"):
            status, body = _http_page(ep.port, path)
            check(status == 200, f"{path} answered {status}")
            pages[path.split("?")[0]] = body
        server_spans = json.loads(pages["/rpcz"])
        first_token = {f"{t.span.span_id:016x}": t.t_first_token
                       for t in trackers}
        timeline = {}
        for kind, doc in traced.items():
            rows = _stitch(kind, doc["calls"], doc["spans"], server_spans,
                           first_token)
            timeline[kind] = _timeline_line(kind, rows)
        n_tpu_std = sum(1 for s in server_spans if s["side"] == "server")
        check(n_tpu_std == 2 * N_REQUESTS,
              f"{n_tpu_std} server spans for {2 * N_REQUESTS} tpu_std calls")
        check(sum(1 for s in server_spans if s["side"] == "serving")
              == 3 * N_REQUESTS, "serving spans do not match the calls")
        served = cell_requests() - requests0
        check(served == 3 * N_REQUESTS,
              f"/serving counted {served} of {3 * N_REQUESTS} calls")
        var_names = [ln.split(" : ")[0]
                     for ln in pages["/vars"].decode().splitlines()]
        check("fiber_wake" in var_names and
              {"fiber_count", "fiber_created", "fiber_worker_count",
               "fiber_switch_count", "fiber_steal_count",
               "fiber_runqueue_depth", "fiber_runqueue_peak_10s",
               "fiber_worker_busy_fraction"} <= set(var_names),
              f"/vars lacks the fiber variables: {var_names}")
        _check_prometheus(pages["/brpc_metrics"].decode())
        status_doc = json.loads(pages["/status"])
        check("GenerateService.Generate" in status_doc["method_status"],
              "/status has no Generate latency window")

        # the flags' costs, in turns, from one client process; each
        # request's server stamps split its TTFT into the wait for
        # admission and admission -> first token
        steps0 = gs.batcher.decode_steps
        submitted = []
        real_submit = gs.batcher.submit

        def kept_submit(req):
            submitted.append(req)
            return real_submit(req)

        gs.batcher.submit = kept_submit
        try:
            runs = _client_process(["cost", str(ep.port)], 600)["runs"]
        finally:
            gs.batcher.submit = real_submit
        check(len(submitted) == len(runs) * N_REQUESTS,
              "cost runs: server requests do not match the calls")
        cost = []
        for i, r in enumerate(runs):
            _check_burst(f"cost run {r['flag']}={r['on']}", r["results"],
                         r["errors"], oracle)
            tokens = sum(len(t) for t in r["results"].values())
            mine = submitted[i * N_REQUESTS:(i + 1) * N_REQUESTS]
            ms = lambda a, b: _median(  # noqa: E731
                [(getattr(q, b) - getattr(q, a)) / 1e6 for q in mine])
            cost.append({"flag": r["flag"], "on": r["on"],
                         "turn": r["turn"], "wall_s": r["wall_s"],
                         "tokens_per_s": tokens / r["wall_s"],
                         "client_ttft_p50_ms": r["client_ttft_p50_ms"],
                         "server_ttft_p50_ms": ms("created_ns",
                                                  "first_token_ns"),
                         "queue_p50_ms": ms("created_ns", "admitted_ns"),
                         "admitted_to_first_p50_ms": ms("admitted_ns",
                                                        "first_token_ns")})
        torch.cuda.synchronize()
        launches = dict(fa.launches)
        steps = gs.batcher.decode_steps
        warm = gs.engine.warmup_steps
        check(launches["flash_decode"] == steps + warm > 0 and
              sum(launches.values()) == launches["flash_decode"],
              f"observability: kernel launches {launches} != decode steps "
              f"{steps} + warm-up {warm} of flash_decode alone")
        out["cost_decode_steps"] = steps - steps0
    finally:
        serving_stats.open_generation = real_open
        set_flag("rpcz_enabled", False)
        server.stop()
        server.join(10)
    for kind, line in timeline.items():
        emit({"phase": "observability_timeline", **line})
    for name in COST_FLAGS:
        rows = [c for c in cost if c["flag"] == name]
        emit({"phase": "observability_cost", "flag": name, "runs": rows,
              **{f"{'on' if on else 'off'}_{k}_median": _median(
                  [c[k] for c in rows if c["on"] == on])
                 for on in (False, True)
                 for k in ("tokens_per_s", "server_ttft_p50_ms",
                           "queue_p50_ms", "admitted_to_first_p50_ms")}})
    out.update(launches={"flash_decode": launches["flash_decode"],
                         "decode_steps": steps, "warmup_steps": warm},
               served_calls=served, server_spans=len(server_spans),
               tokens_equal_cpu_plain=True,
               phase_s=time.monotonic() - phase_t0)
    emit(out)
    return out


def _check_prometheus(text: str) -> None:
    """Every sample line reads ``name{labels} value``."""
    import re
    sample = re.compile(
        r'^[A-Za-z_:][A-Za-z0-9_:]*(\{[A-Za-z_][A-Za-z0-9_]*="(?:[^"\\]|'
        r'\\.)*"(,[A-Za-z_][A-Za-z0-9_]*="(?:[^"\\]|\\.)*")*\})? '
        r'[-+]?(\d+(\.\d*)?|\.\d+)([eE][-+]?\d+)?$')
    lines = [ln for ln in text.splitlines() if ln and not ln.startswith("#")]
    bad = [ln for ln in lines if not sample.match(ln)]
    check(lines and not bad, f"/brpc_metrics lines that do not parse: "
                             f"{bad[:5]}")


# ------------------------------------------------------ phase device_lane

# the north-star sweep (examples/tpu_performance/main.py:48-78): 4 B to
# 4 MiB in x4 steps
SWEEP_BYTES = [4 << (2 * i) for i in range(11)]
SWEEP_WARMUP = 3
SWEEP_CALLS = 30
ATTEND_CALLS = 4
# device-side sleep queued behind each Attend's kernels (~0.1 s at
# 2 GHz), so that its event is still pending when the handler parks
ATTEND_PARK_CYCLES = int(2e8)
# the longest an Attend part's handlers wait at its gate for one another
ATTEND_GATE_S = 30.0
STREAM_FRAMES = 16
STREAM_FRAME_BYTES = 64 << 10
# parts (f)-(h): ici://
ICI_CYCLES = 100
ICI_CYCLE_BYTES = 64 << 10
SHORT_SWEEP_BYTES = [4, 64 << 10, 4 << 20]
SHORT_SWEEP_CALLS = 10
DEVICE_COST_BYTES = 64 << 10
DEVICE_COST_CALLS = 60
# the client process's switch: a batch that would go staged fails
ICI_REQUIRE_PULL = {"BRPC_TPU_TORCH_ICI_REQUIRE_PULL": "1"}
ICI_LANES = ("local-d2d", "cuda-ipc", "staged")


def _device_spec(dev) -> str:
    """The ``#device=`` extra that names ``dev``."""
    return "cpu" if dev.type == "cpu" else str(dev.index or 0)


def _device_event(dev):
    """A CUDA event recorded on the current stream of ``dev``."""
    import torch
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(dev))
    return ev


def _sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _sweep(ch, dev, check_zero_copy: bool, sizes=SWEEP_BYTES,
           calls: int = SWEEP_CALLS) -> list:
    """Echo fp32 tensors of every size in ``sizes``: SWEEP_WARMUP calls,
    then ``calls`` timed ones. Rows of p50/p99 us and GB/s (2 x bytes
    per echo, as the example counts)."""
    import torch
    rows = []
    for nbytes in sizes:
        n = nbytes // 4
        times = []
        for i in range(SWEEP_WARMUP + calls):
            x = torch.arange(n, dtype=torch.float32, device=dev) + i
            _sync(dev)
            t0 = time.perf_counter()
            c = ch.call_sync("Perf", "Echo", b"",
                             request_device_arrays=[x])
            dt = time.perf_counter() - t0
            check(not c.failed(), f"echo {nbytes} B: {c.error_code} "
                                  f"{c.error_text}")
            (y,) = c.response_device_arrays
            check(y.device == x.device and y.dtype == x.dtype
                  and torch.equal(y, x), f"echo {nbytes} B: not equal")
            if check_zero_copy:
                check(y.data_ptr() == x.data_ptr(),
                      f"echo {nbytes} B: the hand-off copied")
            if i >= SWEEP_WARMUP:
                times.append(dt)
        p50 = _median(times)
        rows.append({"bytes": nbytes, "p50_us": p50 * 1e6,
                     "p99_us": _p99(times) * 1e6,
                     "gb_per_s": 2 * nbytes / p50 / 1e9})
    return rows


class _CopyTimes:
    """Times of the cudad conns' host copies in this process, by size:
    ``write`` (the whole lane write on the sender's thread), ``encode``
    (its part that copies to the host and builds the envelope) and
    ``take`` (the batch landing on the device, in parse: the dispatcher
    thread).
    Measurement only: the methods are wrapped for the phase and put
    back after it."""

    def __init__(self):
        from brpc_tpu_torch.transport import cudad
        self._mod = cudad
        self._cls = cudad.CudadConn
        self._orig = (self._cls.write_device_payload,
                      self._cls.take_device_payload,
                      cudad._encode_device_batch)
        self.rows = []

    def __enter__(self):
        write, take, encode = self._orig
        rows = self.rows

        def timed_encode(arrays):
            t0 = time.perf_counter()
            r = encode(arrays)
            rows.append(("encode", nb(arrays), time.perf_counter() - t0,
                         threading.current_thread().name))
            return r

        def nb(arrays):
            return sum(t.numel() * t.element_size() for t in arrays)

        def timed_write(conn, arrays):
            t0 = time.perf_counter()
            r = write(conn, arrays)
            rows.append(("write", nb(arrays), time.perf_counter() - t0,
                         threading.current_thread().name))
            return r

        def timed_take(conn):
            t0 = time.perf_counter()
            r = take(conn)
            if r is not None:
                rows.append(("take", nb(r), time.perf_counter() - t0,
                             threading.current_thread().name))
            return r
        self._cls.write_device_payload = timed_write
        self._cls.take_device_payload = timed_take
        self._mod._encode_device_batch = timed_encode
        return self

    def __exit__(self, *exc):
        (self._cls.write_device_payload, self._cls.take_device_payload,
         self._mod._encode_device_batch) = self._orig

    def summary(self, kind: str, nbytes: int) -> dict:
        ts = [r[2] for r in self.rows if r[0] == kind and r[1] == nbytes]
        threads = sorted({r[3] for r in self.rows
                          if r[0] == kind and r[1] == nbytes})
        return {"calls": len(ts), "p50_ms": _median(ts) and
                _median(ts) * 1e3, "max_ms": max(ts) * 1e3 if ts else None,
                "threads": threads}


def _device_lane_server(addr: str, dev, seen: dict):
    """A port Server with Perf.Echo (response = request tensors),
    Perf.Check (the side-stream read) and the async Perf.Attend
    (decode_attention on the delivered tensors, on a stream of its own
    behind which a device-side sleep keeps the event pending, parked on
    it through ``device_ready``), and Perf.Frames (a stream of
    tensors)."""
    import torch

    from brpc_tpu_torch.fiber import current_group, device_ready
    from brpc_tpu_torch.rpc import (Server, ServerOptions, Service,
                                    stream_accept)
    fa = _fa_module()
    svc = Service("Perf")

    @svc.method()
    def Echo(cntl, request):
        seen.setdefault("echo_devices", set()).update(
            str(t.device) for t in cntl.request_device_arrays)
        seen.setdefault("echo_lanes", set()).add(
            cntl._server_socket.conn.lane_kind)
        cntl.response_device_arrays = cntl.request_device_arrays
        return request

    @svc.method()
    async def Check(cntl, request):
        (x,) = cntl.request_device_arrays
        ok = (x == 7).all()
        await device_ready(_device_event(dev))
        return b"1" if bool(ok) else b"0"

    @svc.method()
    async def Attend(cntl, request):
        q, k, v, lengths = cntl.request_device_arrays
        # the part's calls park here (a Future: the callback path) until
        # its last call has arrived, so that their parks on the device
        # events below overlap however far apart the requests came in
        if not await device_ready(_arrive(seen)):
            raise RuntimeError(f"only {len(seen['arrivals'])} of "
                               f"{ATTEND_CALLS} Attend calls arrived in "
                               f"{ATTEND_GATE_S} s")
        if dev.type == "cuda":
            # a stream of the call's own, so one call's parked work
            # holds back neither another call nor a lane's host copy
            cur = torch.cuda.current_stream(dev)
            side = torch.cuda.Stream(dev)
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                for t in (q, k, v, lengths):
                    t.record_stream(side)
                o = fa.decode_attention(q, k, v, lengths)
                o.record_stream(cur)
                torch.cuda._sleep(ATTEND_PARK_CYCLES)
                ev = _device_event(dev)
        else:
            o = fa.decode_attention(q, k, v, lengths)
            ev = _device_event(dev)
        seen.setdefault("in_flight", []).append(1)
        seen["max_in_flight"] = max(seen.get("max_in_flight", 0),
                                    len(seen["in_flight"]))
        await device_ready(ev)
        seen["in_flight"].pop()
        seen.setdefault("attend_resumed", []).append(
            (bool(ev.query()), current_group() is not None,
             threading.current_thread().name))
        cntl.response_device_arrays = [o]
        return b"o"

    @svc.method()
    def Frames(cntl, request):
        st = stream_accept(cntl)
        n = STREAM_FRAME_BYTES // 4

        def send():
            for i in range(STREAM_FRAMES):
                t = torch.full((n,), float(i), device=dev)
                deadline = time.monotonic() + 10
                while not st.write_nowait(b"f%d" % i, device_arrays=[t]):
                    if time.monotonic() > deadline:
                        seen["frames_error"] = f"frame {i}: no credit"
                        return
                    time.sleep(0.0005)
                time.sleep(0.001)   # spread the frames among the calls
        threading.Thread(target=send, name="smoke_frames",
                         daemon=True).start()
        return b"ok"

    srv = Server(ServerOptions(enable_builtin_services=False))
    srv.add_service(svc)
    ep = srv.start(addr)
    return srv, ep


def _open_gate(seen: dict) -> None:
    """A fresh gate for an Attend part: a Future set True by the part's
    ATTEND_CALLS-th arrival, or False by a timer if they do not all come."""
    import concurrent.futures
    gate = concurrent.futures.Future()
    seen.update(gate=gate, arrivals=[], gate_lock=threading.Lock())

    def expire():
        with seen["gate_lock"]:
            if not gate.done():
                gate.set_result(False)
    timer = threading.Timer(ATTEND_GATE_S, expire)
    timer.daemon = True
    timer.start()
    seen["gate_timer"] = timer


def _arrive(seen: dict):
    """Count one Attend arrival at the part's gate and return the gate."""
    with seen["gate_lock"]:
        seen["arrivals"].append(time.monotonic())
        if len(seen["arrivals"]) == ATTEND_CALLS and not seen["gate"].done():
            seen["gate"].set_result(True)
    return seen["gate"]


def _attend(addr: str, dev, calls: int, rng) -> dict:
    """``calls`` concurrent Attend calls (q [4, 128], K/V [4, 4096, 128]
    bf16, lengths 0/1/4096/3000), each O held within ``_rounding_bound``
    of the plain version computed here from the client's own tensors.
    Each call has a connection of its own: on one connection the next
    request is read only when the handler of the last one has finished
    (in-place processing, as in brpc_tpu), so parked handlers of one
    connection do not overlap unless their requests came in one read."""
    import torch

    from brpc_tpu_torch.rpc import Channel, ChannelOptions
    fa = _fa_module()
    b, L, d = 4, 4096, 128
    lengths = torch.tensor([0, 1, 4096, 3000], dtype=torch.int32,
                           device=dev)
    inputs = []
    for _ in range(calls):
        q = _rand(rng, (b, d), torch.bfloat16, dev)
        k = _rand(rng, (b, L, d), torch.bfloat16, dev)
        v = _rand(rng, (b, L, d), torch.bfloat16, dev)
        inputs.append((q, k, v))
    _sync(dev)
    out = [None] * calls
    errs = []
    chans = [Channel(addr, ChannelOptions(timeout_ms=60000,
                                          share_connections=False))
             for _ in range(calls)]

    def one(i):
        try:
            q, k, v = inputs[i]
            c = chans[i].call_sync("Perf", "Attend", b"",
                                   request_device_arrays=[q, k, v, lengths])
            check(not c.failed(), f"Attend: {c.error_code} {c.error_text}")
            out[i] = c.response_device_arrays[0]
        except Exception as e:      # reported below, on the main thread
            errs.append(e)
    threads = [threading.Thread(target=one, args=(i,)) for i in
               range(calls)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    for c in chans:
        c.close()
    check(not errs, f"Attend failed: {errs[:1]}")
    worst = 0.0
    max_err = 0.0
    for (q, k, v), o in zip(inputs, out):
        want = fa._flash_plain(q[:, None].float(), k.float(), v.float(),
                               d ** -0.5, True, 64,
                               q_offset=lengths - 1)[:, 0]
        bound = fa._rounding_bound(want, torch.bfloat16)
        diff = (o.float() - want.float()).abs()
        check(o.shape == q.shape and o.dtype == q.dtype,
              f"Attend output {tuple(o.shape)} {o.dtype}")
        worst = max(worst, float((diff / bound).max()))
        max_err = max(max_err, float(diff.max()))
    check(worst <= 1.0, f"Attend: O off the plain version by "
                        f"{worst:.3f} x its rounding bound")
    return {"calls": calls, "worst_over_bound": worst,
            "max_abs_err": max_err,
            "request_bytes": sum(t.numel() * t.element_size()
                                 for t in (*inputs[0], lengths))}


def _frames_beside_unary(ch, dev) -> dict:
    """A stream of STREAM_FRAMES tensor frames from the server while
    unary device calls run on the same connection: every frame and every
    response must pair with its own tensor."""
    import torch

    from brpc_tpu_torch.rpc import StreamOptions
    frames = []
    done = threading.Event()

    def on_received(stream, msg):
        frames.append((msg.payload, msg.device_arrays))
        if len(frames) == STREAM_FRAMES:
            done.set()
    c = ch.call_sync("Perf", "Frames", b"", stream_options=StreamOptions(
        on_received=on_received))
    check(not c.failed(), f"Frames: {c.error_text}")
    unary = 0
    while unary < 4 or (not done.is_set() and unary < 400):
        x = torch.full((STREAM_FRAME_BYTES // 4,), -1.0 - unary,
                       device=dev)
        r = ch.call_sync("Perf", "Echo", b"", request_device_arrays=[x])
        check(not r.failed() and torch.equal(r.response_device_arrays[0],
                                             x),
              f"unary call {unary} beside the stream got another tensor")
        unary += 1
    check(done.wait(30), f"{len(frames)} of {STREAM_FRAMES} frames")
    for i, (payload, arrays) in enumerate(frames):
        check(payload == b"f%d" % i and len(arrays) == 1
              and bool((arrays[0] == float(i)).all()),
              f"stream frame {i} paired with another tensor")
    c.stream.close()
    return {"frames": len(frames), "unary_calls_beside": unary}


def _side_stream_send(ch, dev) -> bool:
    """Fill a tensor on a fresh stream behind a device-side sleep and
    send it at once, from that stream: the handler must read the filled
    values (the writer's event, waited on by the taker's stream)."""
    import torch
    side = torch.cuda.Stream(dev)
    with torch.cuda.stream(side):
        torch.cuda._sleep(int(2e8))             # ~0.1 s at 2 GHz
        x = torch.full((1 << 20,), 7.0, device=dev)
        c = ch.call_sync("Perf", "Check", b"", request_device_arrays=[x])
    check(not c.failed(), f"Check: {c.error_text}")
    return c.response == b"1"


def _gil_released_by_event_wait(dev) -> dict:
    """While a thread waits in ``Event.synchronize`` on ~0.2 s of device
    sleep, this thread keeps running: the longest gap between its loop
    turns shows whether the wait held the interpreter lock."""
    import torch
    torch.cuda._sleep(int(4e8))
    ev = _device_event(dev)
    t = threading.Thread(target=ev.synchronize, name="smoke_ev_wait")
    t0 = time.perf_counter()
    t.start()
    last = t0
    gap = 0.0
    while t.is_alive():
        now = time.perf_counter()
        gap = max(gap, now - last)
        last = now
    return {"wait_ms": (time.perf_counter() - t0) * 1e3,
            "max_gap_ms": gap * 1e3}


def _process_spans() -> list:
    """This process's client and device spans, as dicts."""
    from brpc_tpu_torch.rpc.span import global_collector
    return [s.to_dict() for s in global_collector.recent(4096)
            if s.side in ("client", "device")]


def _client_device(spec: str):
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from brpc_tpu_torch.butil.device import resolve_device
    return resolve_device("cpu" if spec == "cpu" else f"cuda:{spec}")


def _next_step() -> None:
    """A session client's wait for the server's go (a line on stdin)."""
    check(sys.stdin.readline() != "", "the server ended the session")


def _traced_short_sweep(addr: str, dev) -> dict:
    """SHORT_SWEEP_BYTES with rpcz on in this process, and its spans."""
    from brpc_tpu_torch.butil.flags import set_flag
    from brpc_tpu_torch.rpc import Channel, ChannelOptions
    from brpc_tpu_torch.rpc.span import global_collector
    check(set_flag("rpcz_enabled", True), "cannot turn rpcz on")
    global_collector.clear()
    ch = Channel(addr, ChannelOptions(timeout_ms=30000))
    try:
        rows = _sweep(ch, dev, False, SHORT_SWEEP_BYTES, SHORT_SWEEP_CALLS)
    finally:
        ch.close()
        set_flag("rpcz_enabled", False)
    return {"sweep": rows, "spans": _process_spans()}


def device_lane_client(port: int, spec: str) -> int:
    """``--client device_lane PORT [DEVICE]``: a session over
    ``cudad://127.0.0.1:PORT#device=DEVICE`` from a process of its own:
    the sweep (part b), then, on the server's go, SHORT_SWEEP_BYTES under
    rpcz (part h); a JSON line each."""
    dev = _client_device(spec)
    import torch

    from brpc_tpu_torch.rpc import Channel, ChannelOptions
    addr = f"cudad://127.0.0.1:{port}#device={spec}"
    ch = Channel(addr, ChannelOptions(timeout_ms=30000))
    try:
        rows = _sweep(ch, dev, check_zero_copy=False)
        emit({"sweep": rows, "lane": ch.device_lane_kind(),
              "peer_info": ch._socket.conn.peer_info,
              "torch": torch.__version__})
    finally:
        ch.close()
    _next_step()
    emit(_traced_short_sweep(addr, dev))
    return 0


def _device_cells(lanes=None) -> dict:
    """This process's device cells (``peer|lane`` -> value), of ``lanes``
    or all."""
    from brpc_tpu_torch.transport.device_stats import global_device_stats
    return {f"{peer}|{lane}": cell.get_value()
            for (peer, lane), cell in global_device_stats().rows()
            if lanes is None or lane in lanes}


def _wait_for_value(fn, want, timeout_s: float = 5.0) -> bool:
    deadline = time.monotonic() + timeout_s
    while fn() != want and time.monotonic() < deadline:
        time.sleep(0.01)
    return fn() == want


def _allocated(dev) -> int:
    """The card's allocated bytes once collectable tensors are gone (0
    on the host)."""
    import gc

    import torch
    gc.collect()
    return torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0


def _ici_cycles(addr: str, dev) -> dict:
    """ICI_CYCLES times: dial, echo one ICI_CYCLE_BYTES tensor, close.
    The card's allocated bytes must come back to where they were: the
    registry drops each batch on its ACK and a close acknowledges what
    its copies consumed, so nothing stays held."""
    import torch

    from brpc_tpu_torch.rpc import Channel, ChannelOptions
    x = torch.full((ICI_CYCLE_BYTES // 4,), 3.0, device=dev)
    _sync(dev)
    base = _allocated(dev)
    t0 = time.perf_counter()
    for i in range(ICI_CYCLES):
        ch = Channel(addr, ChannelOptions(timeout_ms=30000))
        c = ch.call_sync("Perf", "Echo", b"", request_device_arrays=[x])
        check(not c.failed() and torch.equal(c.response_device_arrays[0], x),
              f"cycle {i}: {c.error_code} {c.error_text}")
        del c
        ch.close()
    wall = time.perf_counter() - t0
    _wait_for_value(lambda: _allocated(dev), base, 10.0)
    after = _allocated(dev)
    check(after == base, f"{ICI_CYCLES} connect/echo/close cycles left "
                         f"{after - base} bytes allocated on the card")
    return {"cycles": ICI_CYCLES, "bytes": ICI_CYCLE_BYTES,
            "wall_ms_per_cycle": wall / ICI_CYCLES * 1e3,
            "allocated_before": base, "allocated_after": after}


def _device_cost_turns(ch, dev, admin_port: int) -> list:
    """Echoes of DEVICE_COST_BYTES with ``device_stats_enabled`` off and
    on in turns (COST_TURNS pairs, the order alternating), set here and
    on the server (its admin port's ``/flags``)."""
    import torch

    from brpc_tpu_torch.butil.flags import set_flag
    runs = []
    x = torch.ones(DEVICE_COST_BYTES // 4, device=dev)
    for turn in range(COST_TURNS):
        for on in ((False, True) if turn % 2 == 0 else (True, False)):
            status, body = _http_page(
                admin_port, f"/flags/device_stats_enabled?setvalue="
                f"{str(on).lower()}", "POST")
            check(status == 200, f"server refused the flag: {body!r}")
            check(set_flag("device_stats_enabled", on), "flag")
            times = []
            for i in range(SWEEP_WARMUP + DEVICE_COST_CALLS):
                t0 = time.perf_counter()
                c = ch.call_sync("Perf", "Echo", b"",
                                 request_device_arrays=[x])
                dt = time.perf_counter() - t0
                check(not c.failed(), f"cost echo: {c.error_text}")
                if i >= SWEEP_WARMUP:
                    times.append(dt)
            runs.append({"on": on, "turn": turn,
                         "p50_us": _median(times) * 1e6,
                         "p99_us": _p99(times) * 1e6})
    _http_page(admin_port, "/flags/device_stats_enabled?setvalue=true",
               "POST")
    set_flag("device_stats_enabled", True)
    return runs


def _mapped_check(dev) -> None:
    """A peer's allocations stay mapped only while a copy reads them."""
    if dev.type == "cuda":
        from brpc_tpu_torch.transport import cuda_ipc
        _sync(dev)
        check(_wait_for_value(cuda_ipc.mapped_count, 0),
              f"{cuda_ipc.mapped_count()} peer allocations still mapped")


def ici_client(port: int, spec: str, admin_port: int) -> int:
    """``--client ici PORT DEVICE ADMIN_PORT``: parts (f)-(h) over
    ``ici://127.0.0.1:PORT#device=DEVICE`` from a process of its own, a
    session of four steps, each a JSON line, the next on the server's go:
    (f) the first call timed apart, the sweep, a send filled on a side
    stream, ICI_CYCLES connect/echo/close cycles; (g) ATTEND_CALLS
    concurrent Attend calls; (h) SHORT_SWEEP_BYTES under rpcz, then
    ``device_stats_enabled`` off and on in turns. Each line carries this
    process's ici cells."""
    dev = _client_device(spec)
    import numpy as np
    import torch

    from brpc_tpu_torch.rpc import Channel, ChannelOptions
    addr = f"ici://127.0.0.1:{port}#device={spec}"
    doc = {"torch": torch.__version__}
    ch = Channel(addr, ChannelOptions(timeout_ms=30000))
    try:
        doc["lane"] = ch.device_lane_kind()
        doc["peer_info"] = ch._socket.conn.peer_info
        # the first call: the first IPC open on each side, timed apart
        x = torch.arange(1024, dtype=torch.float32, device=dev)
        _sync(dev)
        t0 = time.perf_counter()
        c = ch.call_sync("Perf", "Echo", b"", request_device_arrays=[x])
        doc["first_call_ms"] = (time.perf_counter() - t0) * 1e3
        check(not c.failed(), f"first ici echo: {c.error_code} "
                              f"{c.error_text}")
        check(torch.equal(c.response_device_arrays[0], x),
              f"first ici echo: {c.response_device_arrays[0][:8]} for "
              f"{x[:8]}")
        doc["sweep"] = _sweep(ch, dev, check_zero_copy=False)
        if dev.type == "cuda":
            doc["side_stream_filled"] = _side_stream_send(ch, dev)
    finally:
        ch.close()
    doc["cycles"] = _ici_cycles(addr, dev)
    _mapped_check(dev)
    doc["cells"] = _device_cells(ICI_LANES)
    emit(doc)
    _next_step()
    emit({"attend": _attend(addr, dev, ATTEND_CALLS,
                            np.random.RandomState(20261018)),
          "cells": _device_cells(ICI_LANES)})
    _next_step()
    emit(_traced_short_sweep(addr, dev))
    _next_step()
    ch = Channel(addr, ChannelOptions(timeout_ms=30000))
    try:
        runs = _device_cost_turns(ch, dev, admin_port)
    finally:
        ch.close()
    _mapped_check(dev)
    emit({"runs": runs, "cells": _device_cells(ICI_LANES)})
    return 0


class _Session:
    """A client process driven step by step: each step's JSON line is
    read from its stdout, the next step starts on a line to its stdin."""

    def __init__(self, args, env=None, timeout_s: float = 300):
        import queue
        self._timeout = timeout_s
        self._p = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--client",
             *args], stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True,
            env=None if env is None else dict(os.environ, **env))
        self._lines = queue.Queue()
        self._err = []
        threading.Thread(target=self._pump, args=(self._p.stdout,
                                                  self._lines),
                         daemon=True).start()
        threading.Thread(target=self._pump, args=(self._p.stderr,
                                                  self._err),
                         daemon=True).start()
        self.name = args[0]

    @staticmethod
    def _pump(f, sink) -> None:
        for line in f:
            (sink.put if hasattr(sink, "put") else sink.append)(line)
        if hasattr(sink, "put"):
            sink.put(None)

    def read(self) -> dict:
        """The step's JSON line (the last one it printed)."""
        import queue
        while True:
            try:
                line = self._lines.get(timeout=self._timeout)
            except queue.Empty:
                line = None
            if line is None:
                self.close()
                raise SmokeFailure(f"{self.name} client process failed: "
                                   f"{''.join(self._err)[-2000:]}")
            if line.startswith("{"):
                return json.loads(line)

    def step(self) -> dict:
        """Start the next step and read its line."""
        self._p.stdin.write("go\n")
        self._p.stdin.flush()
        return self.read()

    def close(self) -> None:
        try:
            self._p.stdin.close()
        except OSError:
            pass
        try:
            self._p.wait(30)
        except subprocess.TimeoutExpired:
            self._p.kill()
            self._p.wait()


class _IciTimes:
    """Times of this process's ici takes (in parse: the dispatcher) by
    size, and of each IPC open and close of a peer's allocation (the
    first open apart). Measurement only: wrapped for the part and put
    back after it."""

    def __init__(self):
        from brpc_tpu_torch.transport import cuda_ipc, ici
        self._ipc = cuda_ipc
        self._cls = ici.IciConn
        self._orig = (self._cls.take_device_payload, cuda_ipc.open_handle,
                      cuda_ipc.close_handle)
        self.takes = []
        self.opens = []
        self.closes = []

    def __enter__(self):
        take, open_handle, close_handle = self._orig
        takes, opens, closes = self.takes, self.opens, self.closes

        def timed_take(conn):
            t0 = time.perf_counter()
            r = take(conn)
            if r is not None:
                takes.append((sum(t.numel() * t.element_size() for t in r),
                              time.perf_counter() - t0,
                              threading.current_thread().name))
            return r

        def timed_open(handle, device_index):
            t0 = time.perf_counter()
            r = open_handle(handle, device_index)
            opens.append(time.perf_counter() - t0)
            return r

        def timed_close(base, device_index):
            t0 = time.perf_counter()
            close_handle(base, device_index)
            closes.append(time.perf_counter() - t0)
        self._cls.take_device_payload = timed_take
        self._ipc.open_handle = timed_open
        self._ipc.close_handle = timed_close
        return self

    def __exit__(self, *exc):
        (self._cls.take_device_payload, self._ipc.open_handle,
         self._ipc.close_handle) = self._orig

    def summary(self) -> dict:
        by_size = {}
        for n, dt, th in self.takes:
            by_size.setdefault(n, []).append(dt)
        later = self.opens[1:]
        return {
            "ipc_opens": len(self.opens),
            "first_open_ms": self.opens[0] * 1e3 if self.opens else None,
            "later_open_p50_ms": _median(later) * 1e3 if later else None,
            "later_open_max_ms": max(later) * 1e3 if later else None,
            "close_p50_ms": _median(self.closes) * 1e3
            if self.closes else None,
            "take_p50_ms_by_bytes": {str(n): _median(ts) * 1e3
                                     for n, ts in sorted(by_size.items())},
            "take_threads": sorted({th for _, _, th in self.takes})}


def _check_ici_cells(cells: dict, where: str, dev) -> None:
    """Each ici:// cell balanced; on a card, no staged batch (on the
    host, where the smoke is only rehearsed, the lane is staged)."""
    check(cells, f"{where}: no ici:// cell")
    for key, c in cells.items():
        if dev.type == "cuda":
            check(not key.endswith("|staged")
                  and c["staged_fallbacks"] == 0,
                  f"{where}: staged batches on {key}: {c}")
        check(c["transfers"] == c["completed"] + c["failed"],
              f"{where}: cell {key} does not balance: {c}")
        check(c["failed"] == 0, f"{where}: failed transfers on {key}")


def _settled_cells(lanes, timeout_s: float = 5.0) -> dict:
    """This process's cells of ``lanes`` once every transfer settled
    (the last batch of a connection is acknowledged by its close)."""
    deadline = time.monotonic() + timeout_s
    while True:
        cells = _device_cells(lanes)
        if all(c["transfers"] == c["completed"] + c["failed"]
               for c in cells.values()) or time.monotonic() > deadline:
            return cells
        time.sleep(0.02)


def _lane_spans(spans, lane: str) -> dict:
    """Medians of the device spans of ``lane`` by size: the write side
    (stage, wire, ack, latency) and the receive side (recv)."""
    rows = {}
    for d in spans:
        if d.get("side") != "device" or d.get("method") != lane:
            continue
        recv = not (d["write_done_us"] or d["first_byte_us"])
        r = rows.setdefault(str(d["request_size"]),
                            {"recv_us": [], "stage_us": [], "wire_us": [],
                             "ack_us": [], "latency_us": []})
        if recv:
            r["recv_us"].append(d["latency_us"])
        else:
            for k in ("stage_us", "wire_us", "ack_us", "latency_us"):
                r[k].append(d[k])
    return {n: {k + "_p50": _median(v) for k, v in r.items() if v}
            | {"sends": len(r["latency_us"]), "recvs": len(r["recv_us"])}
            for n, r in rows.items()}


class _LaneSpans:
    """Part (h)'s record: per lane, a short sweep under rpcz, the server
    spans read from ``/rpcz`` of the admin server right after it, and the
    client process's spans."""

    def __init__(self, admin_port: int):
        self.admin_port = admin_port
        self.lanes = {}

    def begin(self) -> None:
        from brpc_tpu_torch.butil.flags import set_flag
        from brpc_tpu_torch.rpc.span import global_collector
        check(set_flag("rpcz_enabled", True), "cannot turn rpcz on")
        global_collector.clear()

    def end(self, name: str, lane: str, doc: dict) -> None:
        """``doc``: the sweep's rows and the client's spans (None when
        the client ran in this process)."""
        from brpc_tpu_torch.butil.flags import set_flag
        status, body = _http_page(self.admin_port, "/rpcz?n=100000")
        set_flag("rpcz_enabled", False)
        check(status == 200, f"/rpcz: {status}")
        self.lanes[name] = {"lane": lane, "sweep": doc["sweep"],
                            "server_spans": json.loads(body),
                            "client_spans": doc.get("spans")}

    def report(self, dev) -> dict:
        """Each lane's write and receive sides against its echo p50; on
        ici:// every device span's stage + wire + ack equals its latency
        and its stage is at most its size's slowest echo; /device has a
        cell for every lane, the recv pool and the leaks."""
        out = {}
        for name, info in self.lanes.items():
            lane = info["lane"]
            mine = _lane_spans(info["server_spans"], lane)
            check(mine, f"{name}: no device span on the server")
            out[name] = {
                "lane": lane,
                "echo_p50_us": {str(r["bytes"]): r["p50_us"]
                                for r in info["sweep"]},
                "server_side": mine,
                "client_side": (_lane_spans(info["client_spans"], lane)
                                if info["client_spans"] is not None
                                else None)}
        ici = self.lanes["ici://"]
        slowest = {str(r["bytes"]): r["p99_us"] for r in ici["sweep"]}
        sends = [d for d in ici["server_spans"] + ici["client_spans"]
                 if d.get("side") == "device" and d.get("method")
                 == ici["lane"] and (d["write_done_us"]
                                     or d["first_byte_us"])]
        check(sends, "no ici:// device span")
        for d in sends:
            check(d["stage_us"] + d["wire_us"] + d["ack_us"]
                  == d["latency_us"], f"ici:// device span stages do not "
                                      f"sum to its latency: {d}")
            cap = slowest.get(str(d["request_size"]))
            check(cap is None or d["stage_us"] <= cap,
                  f"ici:// stage {d['stage_us']} us over the slowest echo "
                  f"{cap} us of its size")
        status, body = _http_page(self.admin_port, "/device")
        check(status == 200, f"/device: {status}")
        page = json.loads(body)
        cell_lanes = {k.rsplit("|", 1)[1] for k in page["cells"]}
        for info in self.lanes.values():
            check(info["lane"] in cell_lanes,
                  f"/device has no {info['lane']} cell: {cell_lanes}")
        if dev.type == "cuda":
            check(page["transfer_lane"] == "up",
                  f"/device transfer_lane {page['transfer_lane']}")
        check("recv_pool" in page and "leaks" in page,
              f"/device lacks the recv pool or the leaks: {sorted(page)}")
        return {"lanes": out,
                "device_page": {"cells": len(page["cells"]),
                                "lanes": sorted(cell_lanes),
                                "transfer_lane": page["transfer_lane"],
                                "recv_pool": page["recv_pool"],
                                "leaks": page["leaks"],
                                "totals": page["totals"],
                                "conns": len(page["conns"])}}


def _ici_parts(dev, spec: str, seen: dict, counted, parked,
               spans: _LaneSpans) -> dict:
    """Parts (f), (g) and ici:// of (h): one client process session (lane
    cuda-ipc on a card; the client fails any batch that would go
    staged)."""
    from brpc_tpu_torch.transport import event_dispatcher
    from brpc_tpu_torch.transport.ici import transfer_lane_status
    fa = _fa_module()
    env = ICI_REQUIRE_PULL if dev.type == "cuda" else None
    want_lane = "cuda-ipc" if dev.type == "cuda" else "staged"
    out = {}
    times = _IciTimes()
    with times:
        srv, ep = _device_lane_server(f"ici://127.0.0.1:0#device={spec}",
                                      dev, seen)
        session = None
        try:
            seen.pop("echo_devices", None)
            seen.pop("echo_lanes", None)
            _sync(dev)
            base = _allocated(dev)
            stalls0 = event_dispatcher.nstalls.get_value()
            progress("device_lane f_ici_sweep (client process)")
            fa.reset_launches()
            session = _Session(["ici", str(ep.port), spec,
                                str(spans.admin_port)], env, 600)
            doc = session.read()
            _sync(dev)
            out["launches_f"] = dict(fa.launches)
            check(not any(fa.launches.values()),
                  f"the ici sweep launched {fa.launches}")
            check(doc["lane"] == want_lane, f"client lane {doc['lane']}")
            check(seen.get("echo_lanes") == {want_lane},
                  f"server lanes {seen.get('echo_lanes')}")
            check(seen.get("echo_devices") == {str(dev)},
                  f"the handler saw tensors on {seen.get('echo_devices')}")
            if dev.type == "cuda":
                check(doc.get("side_stream_filled") is True,
                      "the ici side-stream send was read before it was "
                      "written")
                check(transfer_lane_status() == "up",
                      f"ici transfer lane {transfer_lane_status()}")
            server_cells = _settled_cells(ICI_LANES)
            _check_ici_cells(doc["cells"], "client process", dev)
            _check_ici_cells(server_cells, "server", dev)
            _wait_for_value(lambda: _allocated(dev), base, 10.0)
            after = _allocated(dev)
            check(after == base, f"the server holds {after - base} bytes "
                                 f"more on the card after the ici cycles")
            _mapped_check(dev)
            emit({"phase": "device_lane", "part": "f", "lane": "ici://",
                  "lane_kind": doc["lane"],
                  "note": "one card: a same-device CUDA IPC hand-off "
                          "between two processes, not a link",
                  "first_call_ms": doc["first_call_ms"],
                  "sweep": doc["sweep"],
                  "p50_us_ici_vs_cudad": {
                      str(r["bytes"]): [r["p50_us"], c["p50_us"]]
                      for r, c in zip(doc["sweep"],
                                      seen.get("cudad_sweep", []))},
                  "side_stream_filled": doc.get("side_stream_filled"),
                  "cycles": doc["cycles"],
                  "server_allocated": {"before": base, "after": after},
                  "server_takes": times.summary(),
                  "dispatcher_stall_ms_max_10s":
                      event_dispatcher.stall_ms_max_10s(),
                  "dispatcher_stalls": event_dispatcher.nstalls.get_value()
                  - stalls0,
                  "cells": {"client": doc["cells"],
                            "server": server_cells},
                  "transfer_lane": transfer_lane_status()})
            out["sweep"] = doc["sweep"]
            doc = parked("ici", counted, "g_attend_ici", session.step,
                         want={"flash_decode": ATTEND_CALLS})
            out["attend"] = doc["attend"]
            _check_ici_cells(doc["cells"], "attend client process", dev)
            progress("device_lane h_spans_ici (client process)")
            spans.begin()
            spans.end("ici://", want_lane, session.step())
            progress("device_lane h_device_stats_cost (client process)")
            doc = session.step()
            _check_ici_cells(doc["cells"], "cost client process", dev)
            out["cost"] = doc["runs"]
        finally:
            if session is not None:
                session.close()
            srv.stop()
            srv.join()
    _check_ici_cells(_settled_cells(ICI_LANES), "server", dev)
    return out


def phase_device_lane(dev):
    """Tensors in RPCs on the three device lanes: (a) the cuda:// sweep,
    zero-copy; (b) the cudad:// sweep from a client process, with the
    dispatcher's stall and the host copies' times; (c) one side-stream
    send; (d) Attend (decode_attention on delivered tensors, the handler
    parked on a CUDA event) on cuda:// and cudad://; (e) a stream of
    tensors beside unary calls on one connection, on both; (f) the
    sweep, a side-stream send and ICI_CYCLES connect/echo/close cycles on
    ici:// from a client process; (g) Attend over ici://; (h) a short
    sweep on each lane under rpcz, its device spans and /device, and
    ``device_stats_enabled``'s cost on ici://. Launch counts zeroed
    before each part, read after it."""
    import numpy as np
    import torch

    from brpc_tpu_torch.fiber import global_poller
    from brpc_tpu_torch.rpc import (Channel, ChannelOptions, Server,
                                    ServerOptions)
    from brpc_tpu_torch.transport import event_dispatcher
    fa = _fa_module()
    spec = _device_spec(dev)
    rng = np.random.RandomState(20261017)
    out = {"launches": {}, "stalls": {}}

    def counted(part, fn, *args, want=None, **kw):
        progress(f"device_lane {part}")
        stalls0 = event_dispatcher.nstalls.get_value()
        fa.reset_launches()
        r = fn(*args, **kw)
        _sync(dev)
        got = dict(fa.launches)
        out["launches"][part] = got
        # dispatcher ticks of dispatcher_stall_ms or more while the part ran
        out["stalls"][part] = event_dispatcher.nstalls.get_value() - stalls0
        want = want or {}
        check(all(got[k] == want.get(k, 0) for k in got),
              f"{part}: launched {got}, want {want}")
        return r

    poller = global_poller()
    park = {}

    def parked(lane, fn, *args, **kw):
        """Run an Attend part; every call must park on the waiter path,
        more than one at once, with no more waiter threads than calls
        in flight."""
        seen["max_in_flight"] = 0
        _open_gate(seen)
        poller.max_active_waiters = 0
        w0 = dict(poller.nwaits)
        try:
            r = fn(*args, **kw)
        finally:
            seen["gate_timer"].cancel()
        arrivals = seen["arrivals"]
        got = {"poller_waits": {k: poller.nwaits[k] - w0[k] for k in w0},
               "max_waiter_threads": poller.max_active_waiters,
               "max_calls_in_flight": seen["max_in_flight"],
               "arrival_spread_ms": (max(arrivals) - min(arrivals)) * 1e3}
        park[lane] = got
        check(got["poller_waits"]["waiter"] >= ATTEND_CALLS,
              f"{lane}: Attend did not park on the waiter path: {got}")
        check(got["max_calls_in_flight"] > 1,
              f"{lane}: Attend calls ran one at a time: {got}")
        check(0 < got["max_waiter_threads"] <= got["max_calls_in_flight"],
              f"{lane}: waiter threads against calls in flight: {got}")
        return r

    if dev.type == "cuda":
        # build and load flash_decode, and load Check's kernels, before
        # any handler launches them (the handler runs in place on the
        # dispatcher until it parks, and a kernel's first launch loads
        # its module, which can wait for the work on the card)
        z = torch.zeros(4, 64, 128, dtype=torch.bfloat16, device=dev)
        fa.decode_attention(z[:, 0].contiguous(), z, z, torch.full(
            (4,), 64, dtype=torch.int32, device=dev))
        bool((torch.full((1 << 20,), 7.0, device=dev) == 7).all())
    seen = {}
    # the pages (/rpcz, /device, /flags) of this process, for part (h)
    admin = Server(ServerOptions(enable_builtin_services=True))
    spans = _LaneSpans(admin.start("tcp://127.0.0.1:0").port)
    try:
        srv, ep = _device_lane_server(f"cuda://smoke:1#device={spec}", dev,
                                      seen)
        try:
            ch = Channel(str(ep), ChannelOptions(timeout_ms=60000))
            check(ch.device_lane_kind() == "loopback-d2d",
                  "cuda:// lane kind")
            rows = counted("a_cuda_sweep", _sweep, ch, dev, True)
            emit({"phase": "device_lane", "part": "a", "lane": "cuda://",
                  "zero_copy": True, "sweep": rows})
            if dev.type == "cuda":
                w0 = dict(poller.nwaits)
                ok = counted("c_side_stream", _side_stream_send, ch, dev)
                check(ok, "the side-stream send was read before it was "
                          "written")
                emit({"phase": "device_lane", "part": "c", "filled": ok,
                      "poller_waits": {k: poller.nwaits[k] - w0[k]
                                       for k in w0}})
            attend = {}
            attend["cuda"] = parked(
                "cuda", counted, "d_attend_cuda", _attend, str(ep), dev,
                ATTEND_CALLS, rng,
                want={"flash_decode": ATTEND_CALLS})
            streams = {"cuda": counted("e_streams_cuda",
                                       _frames_beside_unary, ch, dev)}
            progress("device_lane h_spans_cuda")
            spans.begin()
            spans.end("cuda://", "loopback-d2d",
                      {"sweep": _sweep(ch, dev, False, SHORT_SWEEP_BYTES,
                                       SHORT_SWEEP_CALLS)})
            ch.close()
        finally:
            srv.stop()
            srv.join()

        copies = _CopyTimes()
        with copies:
            srv, ep = _device_lane_server(
                f"cudad://127.0.0.1:0#device={spec}", dev, seen)
            session = None
            try:
                seen.pop("echo_devices", None)
                stalls0 = event_dispatcher.nstalls.get_value()
                progress("device_lane b_cudad_sweep (client process)")
                fa.reset_launches()
                session = _Session(["device_lane", str(ep.port), spec],
                                   timeout_s=600)
                doc = session.read()
                _sync(dev)
                out["launches"]["b_cudad_sweep"] = dict(fa.launches)
                check(not any(fa.launches.values()), "the sweep launched "
                                                     "a kernel")
                out["stalls"]["b_cudad_sweep"] = \
                    event_dispatcher.nstalls.get_value() - stalls0
                check(doc["lane"] == "staged-dcn", f"lane {doc['lane']}")
                check(seen.get("echo_devices") == {str(dev)},
                      f"the handler saw tensors on "
                      f"{seen.get('echo_devices')}")
                stall = event_dispatcher.stall_ms_max_10s()
                big = {str(n): {
                    "take_on_dispatcher": copies.summary("take", n),
                    "response_write": copies.summary("write", n),
                    "response_encode": copies.summary("encode", n)}
                    for n in (1 << 20, 4 << 20)}
                seen["cudad_sweep"] = doc["sweep"]
                emit({"phase": "device_lane", "part": "b",
                      "lane": "cudad://", "sweep": doc["sweep"],
                      "peer_info": doc["peer_info"],
                      "dispatcher_stall_ms_max_10s": stall,
                      "dispatcher_stalls":
                          event_dispatcher.nstalls.get_value() - stalls0,
                      "host_copies": big})
                progress("device_lane h_spans_cudad (client process)")
                spans.begin()
                spans.end("cudad://", "staged-dcn", session.step())
                session.close()
                session = None
                ch = Channel(str(ep), ChannelOptions(timeout_ms=60000))
                attend["cudad"] = parked(
                    "cudad", counted, "d_attend_cudad", _attend, str(ep),
                    dev, ATTEND_CALLS, rng,
                    want={"flash_decode": ATTEND_CALLS})
                streams["cudad"] = counted("e_streams_cudad",
                                           _frames_beside_unary, ch, dev)
                ch.close()
            finally:
                if session is not None:
                    session.close()
                srv.stop()
                srv.join()
        ici = _ici_parts(dev, spec, seen, counted, parked, spans)
        attend["ici"] = ici["attend"]
        emit({"phase": "device_lane", "part": "h", **spans.report(dev),
              "device_stats_cost_ici_64KiB": ici["cost"]})
    finally:
        admin.stop()
        admin.join()
    resumed = seen.get("attend_resumed", [])
    check(len(resumed) == 3 * ATTEND_CALLS
          and all(r[0] and r[1] for r in resumed),
          f"Attend handlers resumed off a worker or before the event: "
          f"{resumed}")
    check("frames_error" not in seen, seen.get("frames_error", ""))
    gil = _gil_released_by_event_wait(dev) if dev.type == "cuda" else None
    if gil is not None:
        check(gil["max_gap_ms"] < 20.0,
              f"Event.synchronize held the interpreter lock: {gil}")
    emit({"phase": "device_lane", "part": "d", "attend": attend,
          "resumed_threads": sorted({r[2] for r in resumed}),
          "park": park, "event_synchronize": gil})
    emit({"phase": "device_lane", "part": "e", "streams": streams})
    emit({"phase": "device_lane", "launches": out["launches"],
          "dispatcher_stalls_by_part": out["stalls"]})
    out["attend"] = attend
    out["ici_sweep"] = ici["sweep"]
    return out


# ------------------------------------------------------------- combo

COMBO_SHARDS = 8
# fp32 [8, dim/8] requests of 256 KiB and 4 MiB
COMBO_DIMS = (1 << 16, 1 << 20)
COMBO_CALLS = 20            # timed calls of each style and size
COMBO_WARMUP = 2
COMBO_ATTEND_CALLS = 5      # nested Attend calls, the first cold
RING_SHAPE = (8, 2048, 64)  # examples/long_context's heads x seq x dim
RING_ITERS = 5


def _combo_server(addr: str, service: str, methods: dict):
    """A port Server with ``service``'s ``methods``, started on ``addr``."""
    from brpc_tpu_torch.rpc import Server, ServerOptions, Service
    svc = Service(service)
    for name, fn in methods.items():
        svc.register_method(name, fn)
    srv = Server(ServerOptions(enable_builtin_services=False))
    srv.add_service(svc)
    return srv, str(srv.start(addr))


class _MetaTimeouts:
    """The request meta's ``timeout_ms`` of every request the port's
    servers in this process process, by service. Measurement only: the
    dispatch entry is wrapped for the part and put back after it."""

    def __init__(self):
        from brpc_tpu_torch.rpc import server_dispatch
        self._mod = server_dispatch
        self._orig = server_dispatch.process_request
        self.seen = []

    def __enter__(self):
        orig, seen = self._orig, self.seen

        def spy(proto, msg, socket):
            r = msg.meta.request
            seen.append((r.service_name, r.timeout_ms))
            return orig(proto, msg, socket)
        self._mod.process_request = spy
        return self

    def __exit__(self, *exc):
        self._mod.process_request = self._orig

    def of(self, service: str) -> list:
        return [t for s, t in self.seen if s == service]


def _reduce_style(pch, style: str, x, want: float, calls: int) -> dict:
    """``calls`` ParallelChannel calls of one style: ``sync``
    (``call_sync``), ``done`` (``call(done=)``, waited on an Event) or
    ``async`` (``call_async`` awaited in a fiber). Each result read back
    (a host sync) and held to the host's sum; p50/p99 of the wall ms."""
    from brpc_tpu_torch.fiber import spawn
    from brpc_tpu_torch.rpc import Controller

    def one():
        cntl = Controller()
        cntl.request_device_arrays = [x]
        if style == "sync":
            pch.call_sync("Reduce", "Sum", b"", cntl=cntl)
        elif style == "done":
            ev = threading.Event()
            pch.call("Reduce", "Sum", b"", cntl=cntl,
                     done=lambda c: ev.set())
            check(ev.wait(30), "Reduce: done never ran")
        else:
            async def in_fiber():
                return await pch.call_async("Reduce", "Sum", b"",
                                            cntl=cntl)
            f = spawn(in_fiber)
            check(f.join(30), "Reduce: the fiber never finished")
            check(f.value() is cntl, "Reduce: call_async's controller")
        check(not cntl.failed(), f"Reduce {style}: {cntl.error_code} "
                                 f"{cntl.error_text}")
        (total,) = cntl.response_device_arrays
        got = float(total.sum())
        check(abs(got - want) <= FP32_TOL * abs(want),
              f"Reduce {style}: sum {got} against the host's {want}")
        return cntl
    times = []
    for i in range(COMBO_WARMUP + calls):
        t0 = time.perf_counter()
        cntl = one()
        if i >= COMBO_WARMUP:
            times.append(time.perf_counter() - t0)
    return {"p50_ms": _median(times) * 1e3, "p99_ms": _p99(times) * 1e3,
            "calls": calls, "lowered": cntl.collective_lowered}


def _allreduce_parts(dev, rng, counted) -> dict:
    """(a) ParallelChannel 8-shard tensor allreduce on 8 cuda:// servers,
    three call styles; (b) the same calls with attach_collective."""
    import torch

    from brpc_tpu_torch.parallel import CollectiveChannel, make_rpc_mesh
    from brpc_tpu_torch.rpc import (CallMapper, Channel, ChannelOptions,
                                    ParallelChannel, ResponseMerger, SubCall)

    def Sum(cntl, request):
        (x,) = cntl.request_device_arrays
        cntl.response_device_arrays = [x.sum().reshape(1)]
        return b""
    spec = _device_spec(dev)
    made = [_combo_server(f"cuda://combo-{i}:1#device={spec}", "Reduce",
                          {"Sum": Sum}) for i in range(COMBO_SHARDS)]

    class RowMapper(CallMapper):
        def map(self, i, n, service, method, request, cntl):
            return SubCall(service, method, request,
                           device_arrays=[cntl.request_device_arrays[0][i]])

    class SumMerger(ResponseMerger):
        """Sums the sub-responses on the card as they come."""

        def __init__(self):
            self._lock = threading.Lock()

        def merge(self, final, i, sub):
            (t,) = sub.response_device_arrays
            with self._lock:
                acc = final.response_device_arrays
                final.response_device_arrays = [t if not acc else acc[0] + t]
    chans = []

    def channels():
        out = [Channel(addr, ChannelOptions(timeout_ms=10000))
               for _, addr in made]
        chans.extend(out)
        return out
    fanned = ParallelChannel(call_mapper=RowMapper(),
                             response_merger=SumMerger())
    for ch in channels():
        fanned.add_sub_channel(ch)
    lowered = ParallelChannel()
    for ch in channels():
        lowered.add_sub_channel(ch)
    mesh = make_rpc_mesh(1, COMBO_SHARDS, devices=[dev] * COMBO_SHARDS)
    lowered.attach_collective(CollectiveChannel(mesh, merge="sum"),
                              {("Reduce", "Sum"):
                               lambda s: s.sum().reshape(1)})
    out = {"a": {}, "b": {}}
    try:
        for dim in COMBO_DIMS:
            x = torch.from_numpy(rng.rand(COMBO_SHARDS, dim // COMBO_SHARDS)
                                 .astype("float32")).to(dev)
            want = float(x.double().sum())
            key = f"{dim * 4 >> 10}KiB"
            out["a"][key] = counted(
                f"a_{key}", lambda: {s: _reduce_style(fanned, s, x, want,
                                                      COMBO_CALLS)
                                     for s in ("sync", "done", "async")})
            before = (lowered.collective_fused, lowered.collective_fallbacks)
            b = counted(f"b_{key}", _reduce_style, lowered, "sync", x, want,
                        COMBO_CALLS)
            calls = COMBO_WARMUP + COMBO_CALLS
            check(b["lowered"] and lowered.collective_fused == before[0]
                  + calls and lowered.collective_fallbacks == 0,
                  f"attach_collective: fused {lowered.collective_fused}, "
                  f"fallbacks {lowered.collective_fallbacks} after {calls} "
                  f"calls")
            b["fused"] = lowered.collective_fused - before[0]
            b["fallbacks"] = lowered.collective_fallbacks
            out["b"][key] = b
    finally:
        for ch in chans:
            ch.close()
        for srv, _ in made:
            srv.stop()
            srv.join()
    return out


def _nested_attend(dev, rng, counted) -> dict:
    """(c) An async handler fans Attend out by head to 4 partition
    servers through a PartitionChannel, awaiting ``call_async``; the
    sub-calls' meta timeout against the handler's remaining budget; a
    handler whose budget is spent issues nothing."""
    import torch

    from brpc_tpu_torch.fiber import sleep
    from brpc_tpu_torch.rpc import (Channel, ChannelOptions, Controller,
                                    PartitionChannel, PartitionParser,
                                    SubCall, errno_codes as berr)
    fa = _fa_module()
    spec = _device_spec(dev)
    b, L, d = 4, 4096, 128

    def Attend(cntl, request):
        q, k, v, lengths = cntl.request_device_arrays
        cntl.response_device_arrays = [fa.decode_attention(q, k, v,
                                                           lengths)]
        return b"o"
    parts = [_combo_server(f"cuda://combo-part-{i}:1#device={spec}",
                           "Part", {"Attend": Attend}) for i in range(b)]

    class HeadParser(PartitionParser):
        def parse(self, i, n, service, method, request, cntl):
            return SubCall("Part", "Attend", request, device_arrays=[
                t[i:i + 1] for t in cntl.request_device_arrays])
    # the partitions' own timeout is longer than any parent's budget:
    # what reaches them is the parent's remaining budget
    chans = [Channel(addr, ChannelOptions(timeout_ms=600000))
             for _, addr in parts]
    pch = PartitionChannel(partition_parser=HeadParser())
    for ch in chans:
        ch.device_lane_kind()           # dial before any handler runs
        pch.add_partition(ch)
    seen = {"remaining": [], "spent": []}

    async def FrontAttend(cntl, request):
        seen["remaining"].append(cntl.remaining_ms())
        sub = Controller()
        sub.request_device_arrays = list(cntl.request_device_arrays)
        c = await pch.call_async("Part", "Attend", b"", cntl=sub)
        if c.failed():
            cntl.set_failed(c.error_code, c.error_text)
            return b""
        cntl.response_device_arrays = [
            torch.cat([a[0] for a in c.sub_device_arrays])]
        return b"o"

    async def Spent(cntl, request):
        await sleep(0.08)               # past the client's 40 ms
        one = chans[0].call("Part", "Attend", b"",
                            request_device_arrays=cntl.request_device_arrays)
        sub = Controller()
        sub.request_device_arrays = list(cntl.request_device_arrays)
        fan = pch.call("Part", "Attend", b"", cntl=sub)
        seen["spent"].append((one._finalized and fan._finalized,
                              one.error_code, fan.error_code,
                              [e[0] for e in fan.sub_errors if e],
                              one.latency_us()))
        return b""
    front, front_addr = _combo_server(
        f"cuda://combo-front:1#device={spec}", "Front",
        {"Attend": FrontAttend, "Spent": Spent})
    client = Channel(front_addr, ChannelOptions(timeout_ms=30000))
    lengths = torch.tensor([0, 1, 4096, 3000], dtype=torch.int32,
                           device=dev)
    out = {}
    try:
        inputs = [(_rand(rng, (b, d), torch.bfloat16, dev),
                   _rand(rng, (b, L, d), torch.bfloat16, dev),
                   _rand(rng, (b, L, d), torch.bfloat16, dev))
                  for _ in range(COMBO_ATTEND_CALLS)]
        _sync(dev)

        def calls():
            times, outs = [], []
            for q, k, v in inputs:
                t0 = time.perf_counter()
                c = client.call_sync("Front", "Attend", b"",
                                     request_device_arrays=[q, k, v,
                                                            lengths])
                check(not c.failed(), f"nested Attend: {c.error_code} "
                                      f"{c.error_text}")
                (o,) = c.response_device_arrays
                _sync(dev)
                times.append(time.perf_counter() - t0)
                outs.append(o)
            return times, outs
        with _MetaTimeouts() as meta:
            times, outs = counted(
                "c_nested_attend", calls,
                want={"flash_decode": b * COMBO_ATTEND_CALLS})
            sub_timeouts = meta.of("Part")
            n_before = len(sub_timeouts)
            c = Channel(front_addr, ChannelOptions(timeout_ms=40))
            r = c.call_sync("Front", "Spent", b"",
                            request_device_arrays=[*inputs[0], lengths])
            c.close()
            check(r.error_code == berr.ERPCTIMEDOUT,
                  f"Spent: the client got {r.error_code}")
            check(_wait_for_value(lambda: len(seen["spent"]), 1),
                  "Spent: the handler never ran its nested call")
            check(len(meta.of("Part")) == n_before,
                  "a nested call with its parent's budget spent reached "
                  "a partition")
        worst = max_err = 0.0
        for (q, k, v), o in zip(inputs, outs):
            want = fa._flash_plain(q[:, None].float(), k.float(), v.float(),
                                   d ** -0.5, True, 64,
                                   q_offset=lengths - 1)[:, 0]
            check(o.shape == q.shape and o.dtype == q.dtype,
                  f"nested Attend output {tuple(o.shape)} {o.dtype}")
            diff = (o.float() - want).abs()
            worst = max(worst, float((diff / fa._rounding_bound(
                want, torch.bfloat16)).max()))
            max_err = max(max_err, float(diff.max()))
        check(worst <= 1.0, f"nested Attend: O off the plain version by "
                            f"{worst:.3f} x its rounding bound")
        check(len(sub_timeouts) == b * COMBO_ATTEND_CALLS,
              f"{len(sub_timeouts)} partition calls seen")
        pairs = [(max(sub_timeouts[i * b:(i + 1) * b]), rem)
                 for i, rem in enumerate(seen["remaining"])]
        check(all(0 < t <= rem for t, rem in pairs),
              f"sub-call timeouts over the parent's remaining budget: "
              f"{pairs}")
        finalized, one, fan, sub_codes, spent_us = seen["spent"][0]
        check(finalized and one == berr.ERPCTIMEDOUT
              and fan == berr.ETOOMANYFAILS and sub_codes
              and set(sub_codes) == {berr.ERPCTIMEDOUT},
              f"Spent: {one}, fan-out {fan} {sub_codes}")
        out = {"calls": COMBO_ATTEND_CALLS, "worst_over_bound": worst,
               "max_abs_err": max_err, "first_ms": times[0] * 1e3,
               "p50_ms": _median(times[1:]) * 1e3,
               "sub_timeout_ms_vs_parent_remaining_ms": pairs,
               "spent_budget_us": spent_us}
    finally:
        client.close()
        for ch in chans:
            ch.close()
        for srv, _ in parts + [(front, front_addr)]:
            srv.stop()
            srv.join()
    return out


def _wall_ms(fn, iters: int) -> list:
    """Wall ms of each of ``iters`` calls after one warm-up, the device
    synchronised after each."""
    import torch
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def _sequence_parallel(dev, rng, counted) -> dict:
    """(d) Ring and Ulysses attention on an 8-shard mesh of ``dev`` at 8
    heads x 2048 x 64 fp32, causal and not, held to the port's
    flash_attention (flash_attn_fwd)."""
    import torch

    from brpc_tpu_torch.ops import ring_attention, ulysses_attention
    from brpc_tpu_torch.parallel import make_rpc_mesh
    fa = _fa_module()
    mesh = make_rpc_mesh(1, COMBO_SHARDS, devices=[dev] * COMBO_SHARDS)
    q, k, v = (_rand(rng, RING_SHAPE, torch.float32, dev) for _ in range(3))

    def check_all():
        res = {}
        for causal in (False, True):
            want = fa.flash_attention(q, k, v, causal=causal)
            for name, fn in (("ring", ring_attention),
                             ("ulysses", ulysses_attention)):
                got = fn(mesh, q, k, v, causal=causal)
                err = float((got - want).abs().max())
                check(got.shape == want.shape and err <= FP32_TOL,
                      f"{name} attention{' causal' if causal else ''}: "
                      f"{err} from flash_attention")
                res[f"{name}{'_causal' if causal else ''}_max_abs_err"] = err
        return res
    out = counted("d_sequence_parallel", check_all,
                  want={"flash_attn_fwd": 2})
    for causal in (False, True):
        tag = "_causal" if causal else ""
        for name, fn in (
                ("flash_attention",
                 lambda: fa.flash_attention(q, k, v, causal=causal)),
                ("ring", lambda: ring_attention(mesh, q, k, v,
                                                causal=causal)),
                ("ulysses", lambda: ulysses_attention(mesh, q, k, v,
                                                      causal=causal))):
            if dev.type == "cuda":
                out[f"{name}{tag}_wall_ms_p50"] = _median(
                    _wall_ms(fn, RING_ITERS))
        if dev.type == "cuda":
            out[f"flash_attention{tag}_ms"] = cuda_time_ms(
                lambda: fa.flash_attention(q, k, v, causal=causal), 20)[0]
    return out


def phase_combo(dev):
    """Combo channels and mesh collectives on the card: (a) the 8-shard
    tensor allreduce through a ParallelChannel, call_sync, call(done=)
    and call_async; (b) the same call lowered by attach_collective;
    (c) nested async calls through a PartitionChannel with inherited
    deadlines; (d) ring and Ulysses attention. Launch counts zeroed
    before each part, read after it."""
    import numpy as np

    fa = _fa_module()
    rng = np.random.RandomState(20261018)
    launches = {}

    def counted(part, fn, *args, want=None, **kw):
        progress(f"combo {part}")
        fa.reset_launches()
        r = fn(*args, **kw)
        _sync(dev)
        got = dict(fa.launches)
        launches[part] = got
        want = want or {}
        check(all(got[k] == want.get(k, 0) for k in got),
              f"combo {part}: launched {got}, want {want}")
        return r
    out = _allreduce_parts(dev, rng, counted)
    out["c"] = _nested_attend(dev, rng, counted)
    out["d"] = _sequence_parallel(dev, rng, counted)
    for part in "abcd":
        emit({"phase": "combo", "part": part, part: out[part]})
    emit({"phase": "combo", "launches": launches})
    out["launches"] = launches
    return out


# ------------------------------------------------------- phase cluster

CLUSTER_REPLICAS = 3
CLUSTER_CALLS = 48
CLUSTER_THREADS = 8
CLUSTER_SHED_THREADS = 16
CLUSTER_SEQ_CALLS = 8           # a turn of calls one at a time
CLUSTER_KILL_AFTER_S = 0.15
BACKUP_MS = 5
SLOW_DELAY_S = 0.05
BACKUP_CALLS = 20
CLUSTER_TOKEN = "cluster-secret"
AUTH_BAD_CALLS = 8
COMPRESS_SNAPPY = 3


def _cluster_prompts(n: int = CLUSTER_CALLS):
    return [f"replica {i:02d}: {'jumps over the lazy dog '[: 4 + i % 20]}"
            for i in range(n)]


class _Replica:
    """A GenerateService replica: a port Server on tcp with its own
    engine on the default device (cuda:0), restartable on its port.
    Every replica joins ``fleet``, whose decode steps the launch counts
    are held against, stopped ones too."""

    def __init__(self, fleet: list, port: int = 0, max_waiting=None,
                 **opts):
        from brpc_tpu_torch import serving
        from brpc_tpu_torch.rpc import Server, ServerOptions
        self.server = Server(ServerOptions(**opts))
        kw = {} if max_waiting is None else {"max_waiting": max_waiting}
        self.gs = serving.add_generate_service(self.server, **kw)
        check(str(self.gs.device) == "cuda:0",
              f"service device {self.gs.device}")
        ep = self.server.start(f"tcp://127.0.0.1:{port}")
        self.port = ep.port
        self.addr = f"tcp://127.0.0.1:{ep.port}"
        fleet.append(self)

    def steps(self) -> int:
        return self.gs.batcher.decode_steps + self.gs.engine.warmup_steps

    def kill(self) -> None:
        """A replica that dies: its connections drop first, so nothing it
        was doing answers, then it stops."""
        for s in self.server.connections():
            s.set_failed(ConnectionError("replica stopped"))
        self.server.stop()
        self.server.join(0)

    def stop(self) -> None:
        self.server.stop()
        self.server.join(10)


def _cluster_burst(ch, prompts, threads: int, calls=None):
    """``threads`` client threads share ``ch``, the prompts dealt
    round-robin; returns ({prompt: tokens}, [(prompt, errno, text)],
    wall s, [ms a call], [controllers])."""
    results, errors, latency, cntls = {}, [], [], []
    lock = threading.Lock()

    def client(idx):
        for p in prompts[idx::threads]:
            t0 = time.perf_counter()
            c = ch.call_sync("GenerateService", "Generate", json.dumps(
                {"prompt": p, "max_tokens": MAX_TOKENS}).encode())
            ms = (time.perf_counter() - t0) * 1e3
            with lock:
                cntls.append((p, c))
                if c.failed():
                    errors.append((p, c.error_code, c.error_text))
                else:
                    latency.append(ms)
                    results[p] = json.loads(c.response)["tokens"]
    ts = [threading.Thread(target=client, args=(i,)) for i in
          range(threads)]
    t0 = time.perf_counter()
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    return results, errors, time.perf_counter() - t0, latency, cntls


def _by_replica(cntls, replicas) -> dict:
    """Calls answered by each replica, by the port of the server whose
    response completed the call."""
    ports = {r.port: i for i, r in enumerate(replicas)}
    out = [0] * len(replicas)
    for _, c in cntls:
        if c.responded_server is not None:
            out[ports[c.responded_server.port]] += 1
    return out


def _mean_batch(gs, before: dict) -> float:
    """Tokens a decode step since ``before`` (a copy of batch_hist)."""
    hist = dict(gs.batcher.batch_hist)
    steps = sum(hist.values()) - sum(before.values())
    toks = sum(k * v for k, v in hist.items()) - sum(
        k * v for k, v in before.items())
    return toks / steps if steps else 0.0


def _p50_p99(xs) -> dict:
    return {"p50_ms": _median(xs), "p99_ms": _p99(xs), "n": len(xs)}


def _cluster_spread(replicas, ch, oracle, prompts) -> dict:
    """(a) The burst through the ClusterChannel, then phase 3's burst
    (a Channel a thread) at replica 0 alone, then calls one at a time,
    cluster and plain channel in turns."""
    from brpc_tpu_torch.rpc import Channel, ChannelOptions
    hists = [dict(r.gs.batcher.batch_hist) for r in replicas]
    res, errs, wall, lat, cntls = _cluster_burst(
        ch, prompts, CLUSTER_THREADS)
    _check_burst("cluster (a)", res, errs, oracle)
    served = _by_replica(cntls, replicas)
    check(all(n > 0 for n in served),
          f"cluster (a): calls by replica {served}")
    mean_batch = [_mean_batch(r.gs, h) for r, h in zip(replicas, hists)]
    h0 = dict(replicas[0].gs.batcher.batch_hist)
    res2, errs2, wall2, lat2 = _burst(replicas[0].port, prompts,
                                      MAX_TOKENS)[:4]
    _check_burst("cluster (a) plain", res2, errs2, oracle)
    plain_batch = _mean_batch(replicas[0].gs, h0)
    # the cluster layer's cost: one call at a time, the two channels in
    # turns (C P C P); the ClusterChannel's picks land anywhere
    plain = Channel(replicas[0].addr, ChannelOptions(timeout_ms=120000))
    seq = {"cluster": [], "plain": []}
    body = json.dumps({"prompt": prompts[0],
                       "max_tokens": MAX_TOKENS}).encode()
    try:
        for turn in ("cluster", "plain", "cluster", "plain"):
            c_ = ch if turn == "cluster" else plain
            for _ in range(CLUSTER_SEQ_CALLS):
                t0 = time.perf_counter()
                c = c_.call_sync("GenerateService", "Generate", body)
                check(not c.failed() and json.loads(c.response)[
                    "tokens"] == oracle[prompts[0]],
                      f"cluster (a) {turn}: {c.error_code} {c.error_text}")
                seq[turn].append((time.perf_counter() - t0) * 1e3)
    finally:
        plain.close()
    check(not any(c.current_try for _, c in cntls),
          "cluster (a): a call retried with every replica up")
    tokens = sum(len(t) for t in res.values())
    return {"calls": len(cntls), "by_replica": served, "wall_s": wall,
            "tokens_per_s": tokens / wall, **_p50_p99(lat),
            "tokens_per_step": mean_batch,
            "plain_burst": {"wall_s": wall2, "tokens_per_s": tokens / wall2,
                            "tokens_per_step": plain_batch,
                            **_p50_p99(lat2)},
            "one_at_a_time": {k: _p50_p99(v) for k, v in seq.items()},
            "cluster_cost_p50_ms": _median(seq["cluster"])
            - _median(seq["plain"])}


def _la_feedback_spy(ch, ep):
    """Latency samples ``ch``'s balancer takes for ``ep`` (measurement
    only: the balancer's method is wrapped for the part)."""
    lb = ch._lb
    seen = []
    orig = lb.feedback

    def spy(server, latency_us, failed):
        if server == ep:
            seen.append((latency_us, failed))
        return orig(server, latency_us, failed)
    lb.feedback = spy
    return seen, lambda: setattr(lb, "feedback", orig)


def _cluster_shed(replicas, ch, oracle, prompts) -> dict:
    """(b) Replica 0 restarted with max_concurrency 2 and 2 waiting: it
    sheds, the calls retry elsewhere, no call fails."""
    from brpc_tpu_torch.rpc import backend_stats as bs
    from brpc_tpu_torch.rpc import server_dispatch
    from brpc_tpu_torch.butil.endpoint import str2endpoint
    r0 = replicas[0]
    ep0 = str2endpoint(r0.addr)
    limit0 = server_dispatch.nlimit_shed.get_value()
    shed0 = r0.gs.batcher.shed
    rb = ch._retry_budget
    tokens0 = rb.tokens()
    cell = bs.global_stats().cell(ch.stats_name, bs.ep_key(ep0))
    row0 = cell.get_value()
    rejects0 = (ch._lb.decision_info(ep0) or {}).get("rejects", 0)
    seen, restore = _la_feedback_spy(ch, ep0)
    try:
        res, errs, wall, lat, cntls = _cluster_burst(
            ch, prompts, CLUSTER_SHED_THREADS)
    finally:
        restore()
    _check_burst("cluster (b)", res, errs, oracle)
    limit_shed = server_dispatch.nlimit_shed.get_value() - limit0
    engine_shed = replicas[0].gs.batcher.shed - shed0
    retried = sum(c.retried_count() for _, c in cntls)
    check(limit_shed > 0 or engine_shed > 0,
          "cluster (b): replica 0 shed nothing")
    check(retried > 0, "cluster (b): no call retried")
    row = cell.get_value()
    rejects = row["rejects"] - row0["rejects"]
    answered = sum(1 for _, c in cntls
                   if c.responded_server is not None
                   and c.responded_server.port == r0.port)
    la_rejects = ch._lb.decision_info(ep0).get("rejects", 0) - rejects0
    check(rb.tokens() == tokens0,
          f"cluster (b): retry tokens {tokens0} -> {rb.tokens()}")
    # rejects return la's slot and nothing else: its latency samples
    # for replica 0 are the calls replica 0 answered
    check(rejects > 0 and la_rejects == rejects and len(seen) == answered
          and not any(f for _, f in seen),
          f"cluster (b): {rejects} rejects in the cell, {la_rejects} in la,"
          f" {len(seen)} la samples for {answered} calls answered")
    return {"calls": len(cntls), "threads": CLUSTER_SHED_THREADS,
            "server_limit_shed": limit_shed, "engine_shed": engine_shed,
            "retried": retried, "rejects": rejects,
            "by_replica": _by_replica(cntls, replicas),
            "retry_tokens": [tokens0, rb.tokens()], "wall_s": wall,
            **_p50_p99(lat)}


def _http_json(port: int, path: str):
    return json.loads(_http_page(port, path)[1])


def _cluster_failover(replicas, fleet, ch, oracle, prompts) -> dict:
    """(c) Replica 1 killed while a burst is in flight; every call ends
    with the right tokens, the ones it held retried elsewhere; then it
    restarts on its port, is revived, and serves again."""
    from brpc_tpu_torch.rpc import backend_stats as bs
    from brpc_tpu_torch.rpc.circuit_breaker import all_breaker_snapshots
    r1 = replicas[1]
    kill_us = []

    def kill():
        kill_us.append(time.monotonic_ns() // 1000)
        r1.kill()
    timer = threading.Timer(CLUSTER_KILL_AFTER_S, kill)
    timer.start()
    res, errs, wall, lat, cntls = _cluster_burst(ch, prompts,
                                                 CLUSTER_THREADS)
    timer.join()
    _check_burst("cluster (c)", res, errs, oracle)
    moved = [c for _, c in cntls if c.tried_servers
             and c.tried_servers[0].port == r1.port and c.current_try]
    check(moved, "cluster (c): no call in flight on replica 1 retried")
    check(all(c.responded_server.port != r1.port for c in moved),
          "cluster (c): a retried call was answered by the dead replica")
    key = f"tcp://127.0.0.1:{r1.port}"
    dead = [e.port for e in ch._health.dead_set()]
    breaker = all_breaker_snapshots().get(key)
    page = _http_json(replicas[0].port, "/backends")
    row = page["channels"][ch.stats_name]["backends"][key]
    check(r1.port in dead and row["state"]["health_dead"],
          f"cluster (c): replica 1 not dead ({dead}, {row['state']})")
    check(breaker is not None and breaker["error_rate_long"] > 0,
          f"cluster (c): breaker {breaker}")
    failover_ms = (max(c.end_us for c in moved) - kill_us[0]) / 1e3
    # the restart: the health checker revives it, and it serves again
    t0 = time.perf_counter()
    replicas[1] = _Replica(fleet, r1.port)
    check(_wait_for_value(lambda: not ch._health.dead_set(), True, 10.0),
          "cluster (c): replica 1 never revived")
    revive_ms = (time.perf_counter() - t0) * 1e3
    res2, errs2, _, _, cntls2 = _cluster_burst(ch, prompts[:24],
                                               CLUSTER_THREADS)
    _check_burst("cluster (c) after", res2, errs2,
                 {p: oracle[p] for p in prompts[:24]})
    after = _by_replica(cntls2, replicas)
    check(after[1] > 0, f"cluster (c): calls by replica after {after}")
    return {"calls": len(cntls), "retried_from_dead": len(moved),
            "retried": sum(c.current_try for _, c in cntls),
            "failover_ms": failover_ms, "revive_ms": revive_ms,
            "breaker": breaker, "backends_row": {
                k: row[k] for k in ("attempts", "completed", "abandoned",
                                    "connect_errors", "errors")},
            "by_replica_after": after, "wall_s": wall, **_p50_p99(lat)}


class _HandlerSpy:
    """Wraps a replica's ``Generate`` handler (a coroutine function
    still) to read each request's codec and verified user on the
    server's controller: measurement only, for the part."""

    def __init__(self, replicas):
        self.seen = []
        self._methods = []
        for i, r in enumerate(replicas):
            m = r.server.find_method("GenerateService", "Generate")
            orig = m.handler

            async def spy(cntl, request, i=i, orig=orig):
                ctx = cntl.auth_context
                self.seen.append((i, cntl.compress_type,
                                  ctx.user if ctx is not None else None))
                return await orig(cntl, request)
            m.handler = spy
            self._methods.append((m, orig))

    def restore(self) -> None:
        for m, orig in self._methods:
            m.handler = orig


class _ResponseCodecs:
    """Each response's ``RpcMeta.compress_type``, read on the client as
    ``client_dispatch`` fills the controller (measurement only)."""

    def __init__(self):
        from brpc_tpu_torch.rpc import client_dispatch
        self._mod = client_dispatch
        self._orig = client_dispatch._fill_response
        self.seen = []

        def spy(cntl, msg, socket):
            self.seen.append(msg.meta.compress_type)
            return self._orig(cntl, msg, socket)
        client_dispatch._fill_response = spy

    def restore(self) -> None:
        self._mod._fill_response = self._orig


def _cluster_auth(replicas, oracle, prompts) -> dict:
    """(e) Replica 2 verifies a token; a ClusterChannel that sends it,
    with every request snappy-compressed, serves the burst; a channel
    with a wrong token gets ERPCAUTH on every call, none retried."""
    from brpc_tpu_torch.rpc import (ChannelOptions, ClusterChannel,
                                    Controller, errno_codes as berr)
    ch = ClusterChannel(
        "list://" + ",".join(r.addr for r in replicas), "la",
        ChannelOptions(timeout_ms=120000, retry_budget=True,
                       auth_token=CLUSTER_TOKEN, name="cluster-auth"))
    bad = ClusterChannel(f"list://{replicas[2].addr}", "rr",
                         ChannelOptions(timeout_ms=20000,
                                        auth_token="not-the-token",
                                        name="cluster-auth-bad"))
    handlers = _HandlerSpy(replicas)
    codecs = _ResponseCodecs()
    try:
        results, errors, latency, cntls = {}, [], [], []
        lock = threading.Lock()

        def client(idx):
            for p in prompts[idx::CLUSTER_THREADS]:
                c = Controller()
                c.compress_type = COMPRESS_SNAPPY
                t0 = time.perf_counter()
                c = ch.call_sync("GenerateService", "Generate", json.dumps(
                    {"prompt": p, "max_tokens": MAX_TOKENS}).encode(),
                    cntl=c)
                ms = (time.perf_counter() - t0) * 1e3
                with lock:
                    cntls.append((p, c))
                    if c.failed():
                        errors.append((p, c.error_code, c.error_text))
                    else:
                        latency.append(ms)
                        results[p] = json.loads(c.response)["tokens"]
        ts = [threading.Thread(target=client, args=(i,))
              for i in range(CLUSTER_THREADS)]
        t0 = time.perf_counter()
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        wall = time.perf_counter() - t0
        _check_burst("cluster (e)", results, errors, oracle)
        served = _by_replica(cntls, replicas)
        check(served[2] > 0, f"cluster (e): calls by replica {served}")
        body = json.dumps({"prompt": prompts[0],
                           "max_tokens": MAX_TOKENS}).encode()
        bad_rows, bad_ms = [], []
        for _ in range(AUTH_BAD_CALLS):
            t0 = time.perf_counter()
            c = bad.call_sync("GenerateService", "Generate", body)
            bad_ms.append((time.perf_counter() - t0) * 1e3)
            bad_rows.append((c.error_code, c.retried_count()))
    finally:
        handlers.restore()
        codecs.restore()
        ch.close()
        bad.close()
    check(all(r == (berr.ERPCAUTH, 0) for r in bad_rows),
          f"cluster (e): wrong-token calls {bad_rows}")
    seen = handlers.seen
    check(len(seen) >= len(cntls)
          and all(ct == COMPRESS_SNAPPY for _, ct, _ in seen),
          f"cluster (e): request codecs on the servers {seen}")
    check(all(user == "token-peer" for i, _, user in seen if i == 2),
          f"cluster (e): replica 2's verified users {seen}")
    check(len(codecs.seen) == len(cntls)
          and set(codecs.seen) == {COMPRESS_SNAPPY},
          f"cluster (e): response codecs {codecs.seen}")
    return {"calls": len(cntls), "by_replica": served, "wall_s": wall,
            "retried": sum(c.current_try for _, c in cntls),
            "requests_compressed": len(seen),
            "responses_compressed": len(codecs.seen),
            "replica2_authenticated": sum(1 for i, _, _ in seen if i == 2),
            "wrong_token": {"calls": len(bad_rows),
                            "erpcauth": sum(1 for r in bad_rows
                                            if r[0] == berr.ERPCAUTH),
                            "retried": sum(r[1] for r in bad_rows),
                            **_p50_p99(bad_ms)},
            **_p50_p99(latency)}


def _cluster_backup(dev, rng, counted) -> dict:
    """(d) Attend (a split decode, one launch) on two cuda:// servers,
    one 50 ms slow; rr with a 5 ms backup request."""
    import torch

    from brpc_tpu_torch.fiber import sleep
    from brpc_tpu_torch.rpc import (Channel, ChannelOptions, ClusterChannel,
                                    backend_stats as bs, client_dispatch)
    fa = _fa_module()
    spec = _device_spec(dev)
    b, L, d = 4, 4096, 128
    # each server's requests: arrived, answered, the last arrival
    seen = {"slow": [0, 0, 0.0], "fast": [0, 0, 0.0]}

    def attend(tag, delay):
        async def Attend(cntl, request):
            seen[tag][0] += 1
            seen[tag][2] = time.monotonic()
            if delay:
                await sleep(delay)
            q, k, v, lengths = cntl.request_device_arrays
            cntl.response_device_arrays = [fa.decode_attention(q, k, v,
                                                               lengths)]
            seen[tag][1] += 1
            return tag.encode()
        return Attend

    def settled() -> bool:
        """Every request answered, none for 0.2 s: the late backups
        have all run (and their answers were dropped)."""
        return all(a == f and time.monotonic() - t > 0.2
                   for a, f, t in seen.values())
    slow, slow_addr = _combo_server(f"cuda://cluster-slow:1#device={spec}",
                                    "Part", {"Attend": attend("slow",
                                                              SLOW_DELAY_S)})
    fast, fast_addr = _combo_server(f"cuda://cluster-fast:1#device={spec}",
                                    "Part", {"Attend": attend("fast", 0)})
    # rr's first pick is the list's second server: the first call goes
    # to the slow one
    ch = ClusterChannel(f"list://{fast_addr},{slow_addr}", "rr",
                        ChannelOptions(timeout_ms=30000,
                                       backup_request_ms=BACKUP_MS,
                                       name="cluster-backup"))
    direct = Channel(fast_addr, ChannelOptions(timeout_ms=30000))
    lengths = torch.tensor([0, 1, 4096, 3000], dtype=torch.int32,
                           device=dev)
    try:
        inputs = [(_rand(rng, (b, d), torch.bfloat16, dev),
                   _rand(rng, (b, L, d), torch.bfloat16, dev),
                   _rand(rng, (b, L, d), torch.bfloat16, dev))
                  for _ in range(4)]
        _sync(dev)

        def calls():
            rows, outs, fast_ms = [], [], []
            for i in range(BACKUP_CALLS):
                q, k, v = inputs[i % len(inputs)]
                done = []
                t0 = time.perf_counter()
                c = ch.call("Part", "Attend", b"", done=done.append,
                            request_device_arrays=[q, k, v, lengths])
                check(c.join(30), "cluster (d): a call never completed")
                (o,) = c.response_device_arrays
                _sync(dev)
                ms = (time.perf_counter() - t0) * 1e3
                check(not c.failed(), f"cluster (d): {c.error_code} "
                                      f"{c.error_text}")
                rows.append((c.tried_servers[0].host, c.used_backup,
                             c.response, ms, len(done)))
                outs.append((i % len(inputs), o))
                t0 = time.perf_counter()
                r = direct.call_sync("Part", "Attend", b"",
                                     request_device_arrays=[q, k, v,
                                                            lengths])
                _sync(dev)
                check(not r.failed(), "cluster (d): the direct call failed")
                fast_ms.append((time.perf_counter() - t0) * 1e3)
            check(_wait_for_value(settled, True, 10.0),
                  f"cluster (d): requests still running {seen}")
            return rows, outs, fast_ms, sum(v[1] for v in seen.values())
        rows, outs, fast_ms, _ = counted("d_backup", calls)
        slow_first = [r for r in rows if r[0] == "cluster-slow"]
        check(slow_first and all(r[1] and r[2] == b"fast"
                                 for r in slow_first),
              f"cluster (d): calls first sent to the slow server {slow_first}")
        check(all(r[4] == 1 for r in rows), "cluster (d): a done ran twice")
        cells = {k: bs.global_stats().cell("cluster-backup", k).get_value()
                 for k in (bs.ep_key(ch.servers()[0]),
                           bs.ep_key(ch.servers()[1]))}
        check(all(c["inflight"] == 0
                  and c["attempts"] == c["completed"] + c["abandoned"]
                  for c in cells.values()) and
              sum(c["completed"] for c in cells.values()) == len(rows),
              f"cluster (d): backend cells {cells}")
        check(not client_dispatch.inflight_attempts(),
              "cluster (d): attempts left in flight")
        worst = max_err = 0.0
        for idx, o in outs:
            q, k, v = inputs[idx]
            want = fa._flash_plain(q[:, None].float(), k.float(), v.float(),
                                   d ** -0.5, True, 64,
                                   q_offset=lengths - 1)[:, 0]
            diff = (o.float() - want).abs()
            worst = max(worst, float((diff / fa._rounding_bound(
                want, torch.bfloat16)).max()))
            max_err = max(max_err, float(diff.max()))
        check(worst <= 1.0, f"cluster (d): O off the plain version by "
                            f"{worst:.3f} x its rounding bound")
        lat = [r[3] for r in rows]
        p50, fast_p50 = _median(lat), _median(fast_ms)
        check(p50 <= fast_p50 + 2 * BACKUP_MS,
              f"cluster (d): p50 {p50:.2f} ms against the fast server's "
              f"{fast_p50:.2f}")
        return {"calls": len(rows), "slow_first": len(slow_first),
                "used_backup": sum(1 for r in rows if r[1]),
                "requests": {k: v[0] for k, v in seen.items()},
                "cells": {
                    k: {f: c[f] for f in ("attempts", "completed",
                                          "abandoned", "inflight")}
                    for k, c in cells.items()},
                "worst_over_bound": worst, "max_abs_err": max_err,
                **_p50_p99(lat), "fast_direct": _p50_p99(fast_ms)}
    finally:
        ch.close()
        direct.close()
        for srv in (slow, fast):
            srv.stop()
            srv.join()


def phase_cluster(dev):
    """The cluster client and overload control on the card: three
    GenerateService replicas behind one ClusterChannel ("la"): (a) the
    spread, (b) a shedding replica, (c) a replica killed and restarted;
    (d) backup requests on a tensor RPC; (e) a replica that verifies a
    token, snappy-compressed calls, and a wrong token refused. Launch
    counts zeroed before each part and read after it."""
    import numpy as np

    from brpc_tpu_torch.butil.endpoint import str2endpoint
    from brpc_tpu_torch.rpc import (ChannelOptions, ClusterChannel,
                                    TokenAuthenticator)
    from brpc_tpu_torch.serving import TinyDecoder, TinyDecoderConfig

    fa = _fa_module()
    prompts = _cluster_prompts()
    cpu_model = TinyDecoder(TinyDecoderConfig(), device="cpu")
    oracle = {p: cpu_model.generate(list(p.encode()), MAX_TOKENS)
              for p in prompts}
    launches = {}
    out = {}
    fleet, replicas = [], []
    ch = None

    def serving_part(part, fn, *args, **kw):
        """Counts zeroed just before, read just after: flash_decode once
        a decode step or warm-up of every replica, and nothing else."""
        progress(f"cluster {part}")
        fa.reset_launches()
        before = sum(r.steps() for r in fleet)
        r = fn(*args, **kw)
        _sync(dev)
        got = dict(fa.launches)
        steps = sum(r_.steps() for r_ in fleet) - before
        launches[part] = dict(got, steps=steps)
        check(got["flash_decode"] == steps > 0 and
              sum(got.values()) == got["flash_decode"],
              f"cluster {part}: launched {got}, {steps} decode steps and "
              f"warm-ups")
        return r

    def start():
        replicas.extend(_Replica(fleet) for _ in range(CLUSTER_REPLICAS))

    def restart(i, **opts):
        """Replica ``i`` stopped and started again on its port: the
        channel sees its socket fail, then the health checker revives
        it."""
        old = replicas[i]
        ep = str2endpoint(old.addr)
        old.stop()

        def gone():
            s = ch._sockets.get(ep)
            return s is None or s.failed
        check(_wait_for_value(gone, True, 10.0),
              f"cluster: the channel never saw replica {i} stop")
        replicas[i] = _Replica(fleet, old.port, **opts)
        check(_wait_for_value(lambda: not ch._health.dead_set(), True,
                              10.0), f"cluster: replica {i} not revived")

    try:
        # the replicas start inside the count: their warm-ups count
        serving_part("a_start", start)
        ch = ClusterChannel(
            "list://" + ",".join(r.addr for r in replicas), "la",
            ChannelOptions(timeout_ms=120000, retry_budget=True))
        out["a"] = serving_part("a_spread", _cluster_spread, replicas, ch,
                                oracle, prompts)
        serving_part("b_restart", restart, 0, max_concurrency=2,
                     max_waiting=2)
        out["b"] = serving_part("b_shed", _cluster_shed, replicas, ch,
                                oracle, prompts)
        serving_part("c_restart", restart, 0)
        out["c"] = serving_part("c_failover", _cluster_failover, replicas,
                                fleet, ch, oracle, prompts)
        serving_part("e_restart", restart, 2,
                     auth=TokenAuthenticator(CLUSTER_TOKEN))
        out["e"] = serving_part("e_auth", _cluster_auth, replicas, oracle,
                                prompts)
    finally:
        if ch is not None:
            ch.close()
        for r in replicas:
            r.stop()

    def counted(part, fn):
        progress(f"cluster {part}")
        fa.reset_launches()
        r = fn()
        _sync(dev)
        got = dict(fa.launches)
        launches[part] = got
        n = r[3]
        check(got["flash_decode"] == n and sum(got.values()) == n,
              f"cluster {part}: launched {got}, {n} Attend handlers")
        return r
    out["d"] = _cluster_backup(dev, np.random.RandomState(20261020),
                               counted)
    for part in "abcde":
        emit({"phase": "cluster", "part": part, part: out[part]})
    emit({"phase": "cluster", "launches": launches})
    out["launches"] = launches
    return out


# -------------------------------------------------------- phase incident

INCIDENT_A_BURSTS = 3           # (a): phase 3's burst, cold then warm
INCIDENT_FIRST_CALLS = 32       # (b): fresh Channels, one first call each
INCIDENT_PROFILE_S = 4.0        # (b): the on-demand profile's window
INCIDENT_LATER_CALLS = 8        # (b): later calls on one Channel
INCIDENT_BURST = 24             # (c): concurrent calls at max_concurrency 2
INCIDENT_IN_WINDOW = 4          # (c): calls made inside the capture window
INCIDENT_PAIRS = 3              # (d): turns of each setting against off
INCIDENT_FLAGS = {"anomaly_watch_filter": "server_limit_shed",
                  "anomaly_warmup_ticks": 3, "anomaly_close_ticks": 3,
                  "incident_capture_enabled": True,
                  "incident_window_ticks": 3, "rpcz_enabled": True}


def _generate_body(prompt: str) -> bytes:
    return json.dumps({"prompt": prompt, "max_tokens": MAX_TOKENS}).encode()


def _flags_set(values: dict) -> dict:
    """Set the port's flags; returns the old values, to restore."""
    from brpc_tpu_torch.butil.flags import flag, set_flag
    old = {k: flag(k) for k in values}
    for k, v in values.items():
        check(set_flag(k, v), f"cannot set flag {k}={v!r}")
    return old


def _ring(name: str) -> dict:
    from brpc_tpu_torch.bvar.series import global_series
    return global_series().dump_series(names=[name]).get(
        name, {"kind": None, "sec": [], "min": [], "live_sec": 0})


def _settled_tick(name: str) -> dict:
    """One series tick that stored, and ``name``'s ring after it: a tick
    by hand skips while the sampler's own runs, which then stores within
    a second."""
    from brpc_tpu_torch.bvar.series import series_sample_tick
    p0 = _ring_pushes(_ring(name))
    series_sample_tick()
    _wait_for_value(lambda: _ring_pushes(_ring(name)) > p0, True, 3.0)
    return _ring(name)


def _ring_pushes(ser: dict) -> int:
    """Buckets pushed into a ring so far (exact for its first hour): the
    seconds ring slides, so new buckets are counted, not found."""
    return len(ser["min"]) * 60 + ser["live_sec"]


def _folded_frames(folded: dict, top: int = 15) -> dict:
    """Top self and cumulative frames of folded stacks (``label;root;...;
    leaf``): self counts a stack's leaf, cumulative each frame once a
    stack."""
    from collections import Counter
    selfc, cum = Counter(), Counter()
    for stack, n in folded.items():
        frames = stack.split(";")[1:]
        if not frames:
            continue
        selfc[frames[-1]] += n
        for f in set(frames):
            cum[f] += n
    return {"self": selfc.most_common(top),
            "cumulative": cum.most_common(top)}


def _incident_rings_profile(port: int, prompts, oracle) -> dict:
    """(a) Phase 3's burst with the trend rings on and the recorder at its
    default rate: the one-second ring of ``server_processed`` sums to the
    calls served, ``serving_ttft_p99_us`` has a ring, and the continuous
    profile gives busy samples to the Generate method's label."""
    from brpc_tpu_torch.builtin import flight_recorder as fr
    from brpc_tpu_torch.butil.flags import flag
    from brpc_tpu_torch.bvar.series import series_enabled
    check(series_enabled() and flag("continuous_profiler_hz") == 20 and
          fr.global_recorder().running(),
          "incident a: the rings or the 20 Hz recorder are off")
    # the baseline of the burst: two ticks that stored since the start
    _settled_tick("server_processed")
    ring0 = _settled_tick("server_processed")
    fr.global_recorder().clear()
    lat, walls = [], []
    for k in range(INCIDENT_A_BURSTS):
        results, errors, wall, lat_k, _ = _burst(port, prompts, MAX_TOKENS)
        _check_burst(f"incident a {k}", results, errors, oracle)
        lat += lat_k
        walls.append(wall)
    time.sleep(0.3)                     # a few more samples at 20 Hz
    calls = INCIDENT_A_BURSTS * len(prompts)
    # until a tick that collected after the burst has stored
    t_end = time.monotonic() + 3.0
    while True:
        ring1 = _settled_tick("server_processed")
        new = _ring_pushes(ring1) - _ring_pushes(ring0)
        check(0 < new <= 60, f"incident a: {new} buckets over the burst")
        served = sum(v for _, v in ring1["sec"][-new:])
        if served == calls or time.monotonic() > t_end:
            break
    check(served == calls,
          f"incident a: server_processed's ring sums to {served}, "
          f"{calls} calls served")
    status, body = _http_page(port, "/vars?series=serving_ttft_p99_us")
    check(status == 200, f"incident a: /vars?series= answered {status}")
    ttft_ring = json.loads(body)["serving_ttft_p99_us"]
    check(ttft_ring["kind"] == "max" and ttft_ring["sec"],
          f"incident a: serving_ttft_p99_us ring {ttft_ring}")
    status, body = _http_page(port, "/timeline?name=server_processed")
    check(status == 200, f"incident a: /timeline answered {status}")
    tl = json.loads(body)["series"]["server_processed"]
    check(tl["kind"] == "delta" and ring1["sec"][-1] in tl["sec"],
          "incident a: /timeline's ring is not the collector's")
    status, body = _http_page(port,
                              "/hotspots?mode=continuous&format=json")
    check(status == 200, f"incident a: /hotspots answered {status}")
    prof = json.loads(body)
    labels = prof["labels"]
    gen = labels.get("rpc:GenerateService.Generate", 0)
    check(gen > 0, f"incident a: no busy sample labelled Generate: {labels}")
    nbusy = prof["nbusy"] or 1
    tokens = sum(len(t) for t in results.values())
    return {"calls": calls, "ring_sum": served,
            "ring_buckets": new, "burst_wall_s": walls,
            "ttft_p99_buckets": len(ttft_ring["sec"]),
            "tokens_per_s": [tokens / w for w in walls], **_p50_p99(lat),
            "samples": prof["nsamples"], "busy": prof["nbusy"],
            "span_s": prof["span_s"],
            "busy_share_by_label": {k: round(v / nbusy, 4) for k, v in
                                    sorted(labels.items(),
                                           key=lambda kv: -kv[1])},
            "top_folded": sorted(prof["folded"].items(),
                                 key=lambda kv: -kv[1])[:8]}


def _incident_way_in(port: int, prompts, oracle) -> dict:
    """(b) An on-demand /hotspots profile at 1 ms while INCIDENT_FIRST_CALLS
    fresh Channels in this process make their first unary Generate call,
    one after another: one profile holds both sides of the connection.
    Each first call's Channel construction is timed apart from its
    call."""
    from brpc_tpu_torch.builtin import flight_recorder as fr
    from brpc_tpu_torch.rpc import Channel, ChannelOptions
    seconds = INCIDENT_PROFILE_S
    got = {}

    def profile():
        got["page"] = _http_page(
            port, f"/hotspots?seconds={seconds}&interval_ms=1"
                  "&format=json")
    # the page's own client thread waits in a socket read the sampler
    # counts as busy: its samples are left out below
    th = threading.Thread(target=profile, name="hotspots_client")
    th.start()
    check(_wait_for_value(fr.global_recorder().profiling, True, 10.0),
          "incident b: the profile never started")
    first_ms, ctor_ms, t_calls = [], [], time.monotonic()
    for i in range(INCIDENT_FIRST_CALLS):
        p = prompts[i % len(prompts)]
        t0 = time.perf_counter()
        ch = Channel(f"tcp://127.0.0.1:{port}",
                     ChannelOptions(timeout_ms=120000,
                                    share_connections=False))
        ctor_ms.append((time.perf_counter() - t0) * 1e3)
        try:
            c = ch.call_sync("GenerateService", "Generate",
                             _generate_body(p))
            first_ms.append((time.perf_counter() - t0) * 1e3)
        finally:
            ch.close()
        check(not c.failed() and json.loads(c.response)["tokens"] ==
              oracle[p], f"incident b: first call {i}: {c.error_text}")
    calls_s = time.monotonic() - t_calls
    th.join(seconds + 60)
    check("page" in got and got["page"][0] == 200,
          f"incident b: /hotspots answered {got.get('page', (None,))[0]}")
    prof = json.loads(got["page"][1])
    folded = {k: v for k, v in prof["folded"].items()
              if not k.startswith("thread:hotspots_client;")}
    check(folded, "incident b: the profile has no busy sample")
    later = []
    ch = Channel(f"tcp://127.0.0.1:{port}",
                 ChannelOptions(timeout_ms=120000))
    try:
        for i in range(INCIDENT_LATER_CALLS + 1):
            p = prompts[i % len(prompts)]
            t0 = time.perf_counter()
            c = ch.call_sync("GenerateService", "Generate",
                             _generate_body(p))
            if i:                       # the first is this Channel's own
                later.append((time.perf_counter() - t0) * 1e3)
            check(not c.failed() and json.loads(c.response)["tokens"] ==
                  oracle[p], f"incident b: later call {i}")
    finally:
        ch.close()
    labels = {}
    for stack, n in folded.items():
        lbl = stack.split(";", 1)[0]
        labels[lbl] = labels.get(lbl, 0) + n
    # the stacks off the decode path: where the way in could spend host
    # time (the last frames of each)
    other = sorted(((n, ";".join(k.split(";")[-6:])) for k, n in
                    folded.items() if not k.startswith(
                        "rpc:GenerateService.Generate;")), reverse=True)
    return {"profile_s": seconds, "calls_s": calls_s,
            "calls_inside_profile": calls_s + 0.1 < seconds,
            "first_call_ms": _p50_p99(first_ms),
            "channel_ctor_ms": _p50_p99(ctor_ms),
            "later_call_ms": _p50_p99(later),
            "samples": prof["nsamples"],
            "busy_samples": sum(folded.values()),
            "busy_by_label": dict(sorted(labels.items(),
                                         key=lambda kv: -kv[1])[:10]),
            "idle_by_thread": dict(sorted(prof["idle_by_thread"].items(),
                                          key=lambda kv: -kv[1])[:12]),
            "top_other_stacks": other[:10],
            **_folded_frames(folded)}


def _incident_storm(prompts, oracle, window_oracle, gss: list) -> dict:
    """(c) A shed storm leaves an incident artifact: a server at
    max_concurrency 2, calm calls over the watchdog's warm-up ticks, then
    INCIDENT_BURST concurrent Generate calls; the watchdog opens incident
    #1 on server_limit_shed, calls inside the window are captured, the
    artifact is bundled, listed on /incidents and downloadable, and the
    incident closes after its calm ticks. The ticks are the bvar
    sampler's own, once a second. The server's engine joins ``gss``."""
    from brpc_tpu_torch.builtin import flight_recorder as fr
    from brpc_tpu_torch.butil import resource_census
    from brpc_tpu_torch.bvar.anomaly import global_watchdog
    from brpc_tpu_torch.incident.artifact import read_artifact
    from brpc_tpu_torch.incident.manager import global_manager
    from brpc_tpu_torch.rpc import (Channel, ChannelOptions, Server,
                                    ServerOptions)
    from brpc_tpu_torch.rpc import errno_codes as berr
    from brpc_tpu_torch.rpc.span import global_collector
    from brpc_tpu_torch.serving import add_generate_service
    from brpc_tpu_torch.traffic.capture import global_recorder
    wd, mgr = global_watchdog(), global_manager()
    wd.reset()
    server = Server(ServerOptions(max_concurrency=2))
    gs = add_generate_service(server)
    check(str(gs.device) == "cuda:0", f"service device {gs.device}")
    gss.append(gs)
    port = server.start("tcp://127.0.0.1:0").port
    out = {}
    try:
        ch = Channel(f"tcp://127.0.0.1:{port}",
                     ChannelOptions(timeout_ms=120000, max_retry=0))
        key = "server_limit_shed"

        def warm_ticks():
            st = wd._keys.get(key)
            return st.n if st is not None else 0
        # calm calls while the watchdog learns the key's baseline
        t0 = time.monotonic()
        i = 0
        while warm_ticks() < 4 and time.monotonic() - t0 < 15:
            p = prompts[i % len(prompts)]
            c = ch.call_sync("GenerateService", "Generate",
                             _generate_body(p))
            check(not c.failed() and json.loads(c.response)["tokens"] ==
                  oracle[p], f"incident c: calm call {i}")
            i += 1
        check(warm_ticks() >= 4 and not wd.incident_snapshot(),
              f"incident c: warm-up: {warm_ticks()} ticks, incidents "
              f"{wd.incident_snapshot()}")
        out["calm_calls"] = i
        shed_at = []

        def done(c):
            if c.error_code == berr.ELIMIT and not shed_at:
                shed_at.append(time.monotonic())
        storm = [(prompts[j % len(prompts)],
                  ch.call("GenerateService", "Generate",
                          _generate_body(prompts[j % len(prompts)]),
                          done=done))
                 for j in range(INCIDENT_BURST)]
        for _, c in storm:
            c.join()
        sheds = [c for _, c in storm if c.failed()]
        check(all(c.error_code == berr.ELIMIT for c in sheds) and sheds,
              f"incident c: {len(sheds)} sheds, codes "
              f"{sorted({c.error_code for c in sheds})}")
        for p, c in storm:
            check(c.failed() or json.loads(c.response)["tokens"] ==
                  oracle[p], f"incident c: storm tokens for {p!r}")
        check(_wait_for_value(mgr.window_open_now, 1, 10.0),
              "incident c: no capture window opened")
        opened_at = time.monotonic()
        # the window opens on the sampler's tick, and the recorder starts
        # just after it: calls count as in the window once it records
        rec = global_recorder()
        check(_wait_for_value(lambda: rec.incident_capturing() and
                              rec.capturing(), True, 5.0),
              "incident c: the recorder is not capturing the window")
        in_window = list(window_oracle)
        for p in in_window:
            c = ch.call_sync("GenerateService", "Generate",
                             _generate_body(p))
            check(not c.failed() and json.loads(c.response)["tokens"] ==
                  window_oracle[p], f"incident c: in-window call: "
                                    f"{c.error_text}")
        out["in_window_calls_inside"] = bool(mgr.window_open_now())
        incs = wd.incident_snapshot()
        check(len(incs) == 1 and incs[0]["id"] == 1 and
              incs[0]["keys"] == [key],
              f"incident c: incidents {incs}")

        def closed():
            s = wd.incident_snapshot()
            return bool(s) and s[0]["state"] == "closed"
        rows = []

        def artifact_listed():
            status, body = _http_page(port, "/incidents")
            check(status == 200, f"incident c: /incidents {status}")
            rows[:] = json.loads(body)["artifacts"]
            return bool(rows)
        closed_at = art_at = None
        t_end = time.monotonic() + 20
        while time.monotonic() < t_end and (closed_at is None or
                                            art_at is None):
            if closed_at is None and closed():
                closed_at = time.monotonic()
            if art_at is None and artifact_listed():
                art_at = time.monotonic()
            time.sleep(0.01)
        check(closed_at is not None, "incident c: incident #1 never "
                                     f"closed: {wd.incident_snapshot()}")
        check(art_at is not None, "incident c: no artifact on /incidents")
        check(len(rows) == 1, f"incident c: artifacts {rows}")
        path = rows[0]["path"]
        status, blob = _http_page(
            port, "/incidents?action=download&path=" + path)
        with open(path, "rb") as f:
            on_disk = f.read()
        check(status == 200 and blob == on_disk,
              f"incident c: download {status}, {len(blob)} bytes against "
              f"{len(on_disk)} on disk")
        art = read_artifact(path)
        meta = art["meta"]
        check(meta.get("id") == 1 and key in meta.get("keys", []) and
              meta.get("peak_key") == key,
              f"incident c: the incident document {meta}")
        captured = [json.loads(r.payload)["prompt"] for r in art["corpus"]]
        check(set(in_window) <= set(captured) and all(
            r.method_key == "GenerateService.Generate"
            for r in art["corpus"]),
              f"incident c: captured {captured}, wanted {in_window}")
        spans = [s for s in global_collector.recent(1024)
                 if any("incident #1" in t for _, t in s.annotations)]
        check(spans, "incident c: no rpcz span carries incident #1")
        labels = fr.global_recorder().merged()["labels"]
        marked = [k for k in labels if k.startswith("incident:#1")]
        check(marked, f"incident c: no profile window labelled: {labels}")
        status, body = _http_page(port, "/census")
        census = json.loads(body)
        names = resource_census.registered_names()
        check(status == 200 and set(names) <= set(census["subsystems"])
              and not any("error" in census["subsystems"][n]
                          for n in names),
              f"incident c: /census {census} against {names}")
        out.update({
            "sheds": len(sheds), "served": INCIDENT_BURST - len(sheds),
            "incident": wd.incident_snapshot()[0],
            "first_shed_to_open_s": opened_at - shed_at[0]
            if shed_at else None,
            "close_to_artifact_s": art_at - closed_at,
            "open_to_artifact_s": art_at - opened_at,
            "artifact_bytes": len(on_disk), "artifact_path": path,
            "snapshots": sorted(art["snapshots"]),
            "captured": len(captured), "in_window": len(in_window),
            "spans_marked": len(spans), "profile_labels": marked,
            "census": sorted(census["subsystems"]),
            "census_total_bytes": census["total_bytes"]})
        ch.close()
    finally:
        server.stop()
        server.join(10)
    return out


def _incident_costs(port: int, prompts, oracle, capture_dir: str) -> dict:
    """(d) Phase 3's burst in turns, INCIDENT_PAIRS pairs each, the order
    of a pair alternating: the recorder at 20 Hz with the rings on
    against both off; then capture at rate 1.0 against capture off."""
    from brpc_tpu_torch.traffic.capture import (global_recorder,
                                                start_capture, stop_capture)
    runs = []

    def burst(setting, on, turn):
        res, errs, wall, lat, _ = _burst(port, prompts, MAX_TOKENS)
        _check_burst(f"incident d {setting} {on}", res, errs, oracle)
        tokens = sum(len(t) for t in res.values())
        runs.append({"setting": setting, "on": on, "turn": turn,
                     "tokens_per_s": tokens / wall, **_p50_p99(lat)})
    for turn in range(INCIDENT_PAIRS):
        for on in ((False, True) if turn % 2 == 0 else (True, False)):
            _flags_set({"continuous_profiler_hz": 20 if on else 0,
                        "bvar_series_enabled": on})
            burst("recorder_and_rings", on, turn)
    _flags_set({"continuous_profiler_hz": 20, "bvar_series_enabled": True})
    for turn in range(INCIDENT_PAIRS):
        for on in ((False, True) if turn % 2 == 0 else (True, False)):
            if on:
                start_capture(dir=capture_dir, default_rate=1.0,
                              max_per_second=0)
            burst("capture", on, turn)
            if on:
                snap = stop_capture()
                check(snap["written"] == len(prompts),
                      f"incident d: capture wrote {snap['written']}")
    check(not global_recorder().capturing(), "incident d: capture left on")
    summary = {}
    for r in runs:
        k = f"{r['setting']}_{'on' if r['on'] else 'off'}"
        summary.setdefault(k, []).append(r)
    return {"runs": runs, "summary": {
        k: {"p50_ms_median": _median([r["p50_ms"] for r in v]),
            "p99_ms_median": _median([r["p99_ms"] for r in v]),
            "tokens_per_s_median": _median([r["tokens_per_s"] for r in v])}
        for k, v in sorted(summary.items())}}


def phase_incident(dev):
    """Trend rings, the anomaly watchdog, the flight recorder, capture and
    incidents on the card's Generate path, at phase 3's width: (a) the
    rings and the continuous profile over phase 3's burst, (b) an
    on-demand profile of first calls, (c) a shed storm's incident
    artifact, (d) the cost of the recorder, the rings and capture.
    Launch counts zeroed before each part and read after it:
    ``flash_decode``'s equal to the part's decode steps and warm-ups,
    and nothing else launched."""
    import tempfile

    # the modules that define the phase's flags
    import brpc_tpu_torch.builtin.flight_recorder  # noqa: F401
    import brpc_tpu_torch.incident.manager  # noqa: F401
    from brpc_tpu_torch.rpc import Server
    from brpc_tpu_torch.serving import (TinyDecoder, TinyDecoderConfig,
                                        add_generate_service)

    fa = _fa_module()
    phase_t0 = time.monotonic()
    prompts = _prompts()
    cpu_model = TinyDecoder(TinyDecoderConfig(), device="cpu")
    oracle = {p: cpu_model.generate(list(p.encode()), MAX_TOKENS)
              for p in prompts}
    window_oracle = {}                  # (c)'s calls inside the window
    for j in range(INCIDENT_IN_WINDOW):
        p = f"in-window {j}: {prompts[j]}"
        window_oracle[p] = cpu_model.generate(list(p.encode()), MAX_TOKENS)
    launches, out = {}, {}
    gss = []

    def counted(part, fn, *args):
        progress(f"incident {part}")
        fa.reset_launches()
        before = sum(g.batcher.decode_steps + g.engine.warmup_steps
                     for g in gss)
        r = fn(*args)
        _sync(dev)
        got = dict(fa.launches)
        steps = sum(g.batcher.decode_steps + g.engine.warmup_steps
                    for g in gss) - before
        launches[part] = dict(got, steps=steps)
        check(got["flash_decode"] == steps > 0 and
              sum(got.values()) == got["flash_decode"],
              f"incident {part}: launched {got}, {steps} decode steps and "
              f"warm-ups")
        return r

    tmp = tempfile.mkdtemp(prefix="incident-smoke-")
    old = _flags_set(dict(INCIDENT_FLAGS, incident_dir=tmp))
    server = None
    try:
        def start():
            nonlocal server
            server = Server()
            gss.append(add_generate_service(server))
            check(str(gss[-1].device) == "cuda:0",
                  f"service device {gss[-1].device}")
            return server.start("tcp://127.0.0.1:0").port
        port = counted("a_start", start)
        out["a"] = counted("a_rings_profile", _incident_rings_profile, port,
                           prompts, oracle)
        out["b"] = counted("b_way_in", _incident_way_in, port, prompts,
                           oracle)
        # the storm's server starts inside the count: its warm-up counts
        out["c"] = counted("c_storm", _incident_storm, prompts, oracle,
                           window_oracle, gss)
        out["d"] = counted("d_costs", _incident_costs, port, prompts,
                           oracle, os.path.join(tmp, "capture"))
    finally:
        if server is not None:
            server.stop()
            server.join(10)
        _flags_set(old)
    out["phase_s"] = time.monotonic() - phase_t0
    for part in "abcd":
        emit({"phase": "incident", "part": part, part: out[part]})
    emit({"phase": "incident", "launches": launches,
          "phase_s": out["phase_s"]})
    out["launches"] = launches
    return out


# ------------------------------------------------------------ phase native

NATIVE_ROUNDS = 1
ECHO_SIZES = (4, 64, 1024, 4096)
ECHO_CALLS = 1000
ECHO_WINDOW = 64
MALLOC_ECHO_BYTES = 4 << 20
MALLOC_ECHO_CALLS = 30
NO_NATIVE = {"BRPC_TPU_TORCH_NO_NATIVE": "1"}


def _native_counters() -> dict:
    """The native lanes' counters of this process."""
    from brpc_tpu_torch.protocol import http, tpu_std
    from brpc_tpu_torch.rpc import client_dispatch, server_dispatch, stream
    from brpc_tpu_torch.transport import socket as sk
    return {k: a.get_value() for k, a in (
        ("scan_records", tpu_std.nscan_records),
        ("turbo_requests", server_dispatch.nturbo_requests),
        ("turbo_fallbacks", server_dispatch.nturbo_fallbacks),
        ("client_fast_responses", client_dispatch.nfast_responses),
        ("client_chunk_drain", client_dispatch.nchunk_drained),
        ("pluck_fast", sk.npluck_fast),
        ("pluck_defers", sk.npluck_defer),
        ("pluck_scans", sk.npluck_scans),
        ("stream_fast_frames", stream.nfast_frames),
        ("http_native_heads", http.nnative_heads),
        ("serve_drain", server_dispatch.nserve_drain),
        ("serve_scan", server_dispatch.nserve_scan))}


def _delta(before: dict, after: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


def _native_build() -> dict:
    """(a): the compiler, Python.h, and each output's build seconds,
    cold (into an empty directory) and then cached; the process's own
    core must have loaded."""
    import sysconfig
    import tempfile

    import brpc_tpu_torch.native as native
    from brpc_tpu_torch.native import build, fastcore
    gxx = subprocess.run([build.CXX, "--version"], capture_output=True,
                         text=True)
    check(gxx.returncode == 0, f"{build.CXX} --version failed")
    header = Path(sysconfig.get_paths()["include"]) / "Python.h"
    check(header.is_file(), f"Python.h is missing ({header}): the fastcore "
                            "extension cannot be built on this machine")
    out = {"gxx": gxx.stdout.splitlines()[0], "python_h": str(header)}
    saved = build.BUILD_DIR
    with tempfile.TemporaryDirectory() as tmp:
        build.BUILD_DIR = Path(tmp)
        try:
            for name, fn in (("ctypes_library", build.build),
                             ("fastcore", build.build_fastcore)):
                t0 = time.monotonic()
                fn()
                cold = time.monotonic() - t0
                t0 = time.monotonic()
                fn()
                out[name] = {"cold_s": cold,
                             "cached_s": time.monotonic() - t0}
        finally:
            build.BUILD_DIR = saved
    check(native.lib() is not None,
          f"the native library did not load: {native.load_error}")
    check(fastcore.get() is not None,
          f"the fastcore extension did not load: {fastcore.load_error}")
    out["loaded"] = dict(build.build_info)
    return out


class _ArrivalSpy:
    """Wraps Generate's handler: arrival (the turbo scan's cut) -> the
    handler's start, a call."""

    def __init__(self, server):
        self.m = server.find_method("GenerateService", "Generate")
        self.real, self.ms = self.m.handler, []

        def spy(cntl, request):
            sock = cntl._server_socket
            cut = getattr(sock, "turbo_cut_ns", 0) if sock else 0
            if cut:
                self.ms.append((time.monotonic_ns() - cut) / 1e6)
            return self.real(cntl, request)
        # the method keeps its kind (is_coroutine): the spy returns the
        # handler's coroutine
        self.m.handler = spy

    def close(self) -> list:
        self.m.handler = self.real
        return self.ms


def _native_unary(port, prompts, oracle, server) -> dict:
    """(b): phase 3's burst with no deadline in the meta, in this
    process, warm: every request through the turbo lane's slim body,
    every sync call plucked natively."""
    from brpc_tpu_torch.transport import syscall_stats
    # a first burst warms the server up (a cold burst pays the serving
    # lane's start-up);
    # the second is measured
    res, errs = _burst(port, prompts, MAX_TOKENS, timeout_ms=None)[:2]
    _check_burst("native unary warm-up", res, errs, oracle)
    spy = _ArrivalSpy(server)
    c0, s0 = _native_counters(), syscall_stats.snapshot()
    try:
        res, errs, wall, lat, _ = _burst(port, prompts, MAX_TOKENS,
                                         timeout_ms=None)
    finally:
        arrival = spy.close()
    d = _delta(c0, _native_counters())
    sysc = syscall_stats.snapshot()
    _check_burst("native unary burst", res, errs, oracle)
    check(d["turbo_requests"] == N_REQUESTS and d["turbo_fallbacks"] == 0,
          f"turbo lane took {d['turbo_requests']} requests of "
          f"{N_REQUESTS} ({d['turbo_fallbacks']} fell back)")
    check(d["client_fast_responses"] == N_REQUESTS,
          f"the client's fast path took {d['client_fast_responses']} "
          f"responses of {N_REQUESTS}")
    check(d["pluck_fast"] == N_REQUESTS and d["pluck_scans"] > 0,
          f"{d['pluck_fast']} of {N_REQUESTS} sync calls plucked "
          f"natively ({d['pluck_scans']} pluck_scan calls)")
    tokens = sum(len(t) for t in res.values())
    return {"lanes": d, "wall_s": wall, "tokens_per_s": tokens / wall,
            "p50_ms": _median(lat), "p99_ms": _p99(lat),
            "arrival_to_handler_p50_ms": _median(arrival),
            "arrival_to_handler_p99_ms": _p99(arrival),
            "syscalls": _delta(s0, sysc),
            "syscalls_per_msg": syscall_stats.per_rpc(s0, sysc)}


def _native_stream_http(port, oracle) -> dict:
    """(c): phase 4's stream and HTTP bursts from a client process: the
    stream frames through ``process_stream_frame_fast`` there, the
    request heads through the native parse here."""
    out = {}
    for kind in ("stream", "http"):
        c0 = _native_counters()
        doc = _client_process([kind, str(port)])
        d = _delta(c0, _native_counters())
        _check_burst(f"native {kind} burst", doc["results"], doc["errors"],
                     oracle)
        line = _burst_line(doc["results"], doc["wall_s"], doc["ttft_ms"],
                           doc["gaps_ms"])
        line.update(server_lanes=d, client_lanes=doc["native"])
        if kind == "stream":
            # every token frame and the d frame, in the client process
            want = N_REQUESTS * (MAX_TOKENS + 1)
            check(doc["native"]["stream_fast_frames"] >= want,
                  f"{doc['native']['stream_fast_frames']} stream frames on "
                  f"the fast path, want at least {want}")
        else:
            check(d["http_native_heads"] == N_REQUESTS,
                  f"{d['http_native_heads']} of {N_REQUESTS} HTTP heads "
                  "parsed natively")
        out[kind] = line
    return out


def _native_server_session() -> int:
    """``--client native_server``: a default Generate server on cuda:0
    whose lanes follow this process's environment; prints its port, then
    a snapshot (CPU seconds, syscalls, decode steps, launches, lanes) on
    every line read from stdin, and stops at the end of stdin."""
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from brpc_tpu_torch.native import fastcore
    from brpc_tpu_torch.rpc import Server
    from brpc_tpu_torch.serving import add_generate_service
    from brpc_tpu_torch.transport import syscall_stats
    fa = _fa_module()
    fa.reset_launches()
    server = Server()
    gs = add_generate_service(server)
    ep = server.start("tcp://127.0.0.1:0")
    emit({"port": ep.port, "fastcore": fastcore.get() is not None})
    try:
        while sys.stdin.readline():
            import torch
            torch.cuda.synchronize()
            emit({"cpu_s": time.process_time(),
                  "sys": syscall_stats.snapshot(),
                  "steps": gs.batcher.decode_steps + gs.engine.warmup_steps,
                  "launches": dict(fa.launches),
                  "processed": server.nprocessed,
                  "lanes": _native_counters()})
    finally:
        server.stop()
        server.join(10)
    return 0


def _native_turns(oracle) -> dict:
    """(d): (b)'s burst against a server child with the native lanes and
    one with ``BRPC_TPU_TORCH_NO_NATIVE=1``, the client process taking
    the same setting, in the order N P P N, NATIVE_ROUNDS rounds; then a
    round of each side alone on the native lanes (server N client P,
    server P client N). Both kinds of burst: phase 3's own (``unary``,
    a deadline in every request, which the turbo scan defers to the
    classic lane) and one with no deadline (``unary_nodl``, the turbo
    lane's traffic). p50 over 16 calls sits between a channel's first
    call, which opens its connection, and its second: each row gives
    both waves' p50 too."""
    from brpc_tpu_torch.transport import syscall_stats
    envs = {"native": None, "pure": NO_NATIVE}
    sessions = {k: _Session(["native_server", "0"], env=e)
                for k, e in envs.items()}
    kinds = ("unary", "unary_nodl")
    runs = {kind: {k: [] for k in envs} for kind in kinds}
    mixed = {kind: {"server_native_client_pure": [],
                    "server_pure_client_native": []} for kind in kinds}
    try:
        hello = {k: s.read() for k, s in sessions.items()}
        check(hello["native"]["fastcore"] and not hello["pure"]["fastcore"],
              f"server children's lanes: {hello}")
        for k in envs:                  # warm-up: flash_decode, the engine
            doc = _client_process(["unary", str(hello[k]["port"])],
                                  env=envs[k])
            _check_burst(f"{k} warm-up", doc["results"], doc["errors"],
                         oracle)
        plan = []
        for kind in kinds:
            plan += [(kind, k, k) for _ in range(NATIVE_ROUNDS)
                     for k in ("native", "pure", "pure", "native")]
            plan += [(kind, "native", "pure"), (kind, "pure", "native"),
                     (kind, "pure", "native"), (kind, "native", "pure")]
        for kind, k, client in plan:
            a = sessions[k].step()
            doc = _client_process([kind, str(hello[k]["port"])],
                                  env=envs[client])
            b = sessions[k].step()
            _check_burst(f"{k} {kind} turn", doc["results"], doc["errors"],
                         oracle)
            steps = b["steps"] - a["steps"]
            fd = (b["launches"]["flash_decode"]
                  - a["launches"]["flash_decode"])
            check(fd == steps > 0, f"{k} turn: flash_decode {fd} != "
                                   f"{steps} decode steps")
            lanes = _delta(a["lanes"], b["lanes"])
            # a deadline defers every request from the turbo lane
            want = N_REQUESTS if k == "native" and kind == "unary_nodl" \
                else 0
            check(lanes["turbo_requests"] == want,
                  f"{k} {kind} turn: {lanes['turbo_requests']} turbo "
                  f"requests, want {want}")
            plucked = doc["native"]["pluck_fast"]
            check(plucked == (N_REQUESTS if client == "native" else 0),
                  f"{client} client: {plucked} calls plucked")
            calls = b["processed"] - a["processed"]
            tokens = sum(len(t) for t in doc["results"].values())
            lat, waves = doc["ttft_ms"], doc["waves"]
            row = runs[kind][k] if k == client else \
                mixed[kind][f"server_{k}_client_{client}"]
            row.append({
                "p50_ms": _median(lat),
                "p99_ms": _p99(lat),
                "first_p50_ms": _median([x for x, w in zip(lat, waves)
                                         if w == 0]),
                "later_p50_ms": _median([x for x, w in zip(lat, waves)
                                         if w > 0]),
                "tokens_per_s": tokens / doc["wall_s"],
                "server_cpu_ms_per_call":
                    (b["cpu_s"] - a["cpu_s"]) * 1e3 / calls,
                "client_cpu_ms_per_call": doc["cpu_s"] * 1e3 / calls,
                "server_syscalls_per_call": sum(
                    b["sys"][x] - a["sys"][x]
                    for x in ("recv", "writev", "accept")) / calls,
                "server_syscalls_per_msg":
                    syscall_stats.per_rpc(a["sys"], b["sys"]),
                "decode_steps": steps})
    finally:
        for sess in sessions.values():
            sess.close()
    keys = runs["unary"]["native"][0].keys()
    return {"order": "N P P N", "rounds": NATIVE_ROUNDS, "runs": runs,
            "medians": {kind: {k: {m: _median([r[m] for r in v])
                                   for m in keys}
                               for k, v in by.items()}
                        for kind, by in runs.items()},
            "mixed": mixed,
            "mixed_medians": {kind: {k: {m: _median([r[m] for r in v])
                                         for m in keys}
                                     for k, v in by.items()}
                              for kind, by in mixed.items()}}


def _echo_servers():
    """Echo.Echo served natively (serve_drain), and the same handler
    without the native kind."""
    from brpc_tpu_torch.rpc import Server, Service
    out = {}
    for lane, kind in (("native", "echo"), ("off", None)):
        svc = Service("Echo")
        svc.register_method("Echo", lambda cntl, req: req, native=kind)
        srv = Server()
        srv.add_service(svc)
        out[lane] = (srv, srv.start("tcp://127.0.0.1:0"))
    return out


def _pipelined_echo(ch, body: bytes, calls: int) -> dict:
    """``calls`` echoes with ECHO_WINDOW in flight on one connection."""
    window = threading.Semaphore(ECHO_WINDOW)
    lat, bad, done = [], [], threading.Event()
    left = [calls]
    lock = threading.Lock()

    def on_done(c, t0):
        lat.append((time.perf_counter() - t0) * 1e3)
        if c.failed() or c.response != body:
            bad.append((c.error_code, c.error_text))
        window.release()
        with lock:
            left[0] -= 1
            if not left[0]:
                done.set()

    t0 = time.perf_counter()
    for _ in range(calls):
        window.acquire()
        issued = time.perf_counter()
        ch.call("Echo", "Echo", body,
                done=lambda c, t=issued: on_done(c, t))
    check(done.wait(120), "echo calls hung")
    wall = time.perf_counter() - t0
    check(not bad, f"echo failed or differed: {bad[:3]}")
    return {"p50_ms": _median(lat), "p99_ms": _p99(lat),
            "calls_per_s": calls / wall}


def _native_echo() -> dict:
    """(e): 4 B to 4 KiB echoes, ECHO_CALLS each, pipelined, on the
    native echo lane and off it, in turns (N O O N); the calls
    ``serve_drain`` served."""
    import numpy as np
    from brpc_tpu_torch.rpc import Channel, ChannelOptions
    servers = _echo_servers()
    chans = {k: Channel(f"tcp://127.0.0.1:{ep.port}",
                        ChannelOptions(timeout_ms=None))
             for k, (_, ep) in servers.items()}
    rng = np.random.default_rng(20260803)
    out = {}
    try:
        for size in ECHO_SIZES:
            body = rng.integers(0, 256, size, dtype=np.uint8).tobytes()
            rows = {"native": [], "off": []}
            for lane in ("native", "off", "off", "native"):
                c0 = _native_counters()
                srv = servers[lane][0]
                n0 = srv.nprocessed
                r = _pipelined_echo(chans[lane], body, ECHO_CALLS)
                d = _delta(c0, _native_counters())
                check(srv.nprocessed - n0 == ECHO_CALLS,
                      f"echo {size} B {lane}: {srv.nprocessed - n0} served")
                r["serve_drain"] = d["serve_drain"]
                r["serve_scan"] = d["serve_scan"]
                if lane == "off":
                    check(d["serve_drain"] + d["serve_scan"] == 0,
                          "the plain echo went through a C loop")
                rows[lane].append(r)
            drained = sum(r["serve_drain"] for r in rows["native"])
            check(drained > 0, f"echo {size} B: serve_drain served nothing")
            out[f"{size}B"] = rows
    finally:
        for ch in chans.values():
            ch.close()
        for srv, _ in servers.values():
            srv.stop()
            srv.join(10)
    return out


def _malloc_turn() -> int:
    """``--client malloc_turn``: phase device_lane's 4 MiB ``cudad://``
    echo, server and client in this process, whose malloc follows its
    environment (``BRPC_TPU_TORCH_NO_MALLOPT``)."""
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import torch

    from brpc_tpu_torch.butil import malloc_tune
    from brpc_tpu_torch.rpc import Channel, ChannelOptions, Server, Service
    svc = Service("Perf")

    @svc.method()
    def Echo(cntl, request):
        cntl.response_device_arrays = cntl.request_device_arrays
        return request
    srv = Server()
    srv.add_service(svc)
    ep = srv.start("cudad://127.0.0.1:0#device=0")
    ch = Channel(str(ep), ChannelOptions(timeout_ms=30000))
    x = torch.randn(MALLOC_ECHO_BYTES // 4, device="cuda:0")
    lat = []
    try:
        for i in range(MALLOC_ECHO_CALLS + 3):
            t0 = time.perf_counter()
            c = ch.call_sync("Perf", "Echo", b"",
                             request_device_arrays=[x])
            check(not c.failed(), f"echo failed: {c.error_text}")
            y = c.response_device_arrays[0]
            torch.cuda.synchronize()
            if i >= 3:
                lat.append((time.perf_counter() - t0) * 1e3)
        check(torch.equal(y, x), "the 4 MiB echo differs")
    finally:
        ch.close()
        srv.stop()
        srv.join(10)
    emit({"mallopt": malloc_tune.applied(), "p50_ms": _median(lat),
          "p99_ms": _p99(lat), "calls": len(lat)})
    return 0


def _malloc_turns() -> dict:
    """The malloc A/B: the 4 MiB cudad:// echo with mallopt (T) and with
    glibc's defaults (U), T U (a turn is a process of its own,
    about 13 s, most of it the process's start)."""
    envs = {"tuned": None, "untuned": {"BRPC_TPU_TORCH_NO_MALLOPT": "1"}}
    runs = {k: [] for k in envs}
    for k in ("tuned", "untuned"):
        doc = _client_process(["malloc_turn", "0"], env=envs[k])
        check(doc["mallopt"] == (k == "tuned"),
              f"{k} turn ran with mallopt={doc['mallopt']}")
        runs[k].append(doc)
    return {"runs": runs, "p50_ms": {k: _median([r["p50_ms"] for r in v])
                                      for k, v in runs.items()}}


def phase_native(dev):
    """The native host core and the lanes on it, on the card's machine,
    at phase 3's width: (a) the build, (b) the unary burst through the
    turbo and pluck lanes, (c) stream and HTTP, (d) native against pure
    in turns, (e) the per-event echo, and the malloc A/B. Launch counts
    zeroed before each part that decodes and read after it."""
    from brpc_tpu_torch.rpc import Server
    from brpc_tpu_torch.serving import (TinyDecoder, TinyDecoderConfig,
                                        add_generate_service)
    fa = _fa_module()
    phase_t0 = time.monotonic()
    prompts = _prompts()
    cpu_model = TinyDecoder(TinyDecoderConfig(), device="cpu")
    oracle = {p: cpu_model.generate(list(p.encode()), MAX_TOKENS)
              for p in prompts}
    out, launches = {}, {}
    progress("native a_build")
    out["a"] = _native_build()
    emit({"phase": "native", "part": "a", "a": out["a"]})
    server = None
    gss = []

    def counted(part, fn, *args):
        progress(f"native {part}")
        fa.reset_launches()
        before = sum(g.batcher.decode_steps + g.engine.warmup_steps
                     for g in gss)
        r = fn(*args)
        _sync(dev)
        got = dict(fa.launches)
        steps = sum(g.batcher.decode_steps + g.engine.warmup_steps
                    for g in gss) - before
        launches[part] = dict(got, steps=steps)
        check(got["flash_decode"] == steps > 0 and
              sum(got.values()) == got["flash_decode"],
              f"native {part}: launched {got}, {steps} decode steps and "
              f"warm-ups")
        return r

    try:
        def start():
            nonlocal server
            server = Server()
            gss.append(add_generate_service(server))
            check(str(gss[-1].device) == "cuda:0",
                  f"service device {gss[-1].device}")
            return server.start("tcp://127.0.0.1:0").port
        port = counted("b_start", start)
        out["b"] = counted("b_unary", _native_unary, port, prompts, oracle,
                           server)
        emit({"phase": "native", "part": "b", "b": out["b"]})
        out["c"] = counted("c_stream_http", _native_stream_http, port,
                           oracle)
        emit({"phase": "native", "part": "c", "c": out["c"]})
    finally:
        if server is not None:
            server.stop()
            server.join(10)
    progress("native d_turns")
    out["d"] = _native_turns(oracle)
    emit({"phase": "native", "part": "d", "d": out["d"]})
    progress("native e_echo")
    out["e"] = _native_echo()
    emit({"phase": "native", "part": "e", "e": out["e"]})
    progress("native f_malloc")
    out["f"] = _malloc_turns()
    emit({"phase": "native", "part": "f", "f": out["f"]})
    out["phase_s"] = time.monotonic() - phase_t0
    emit({"phase": "native", "launches": launches,
          "phase_s": out["phase_s"]})
    out["launches"] = launches
    return out


# ------------------------------------------------------------ phase shards

SHARD_COUNTS = (1, 2, 4)
SHARD_CLIENT_PROCESSES = (1, 4)
SHARD_TURN_CALLS = 256          # Generate calls in a timed turn, all clients
SHARD_ROUNDS = 2                # turns a cell; the order flips each round
# parts a-c: the hang check's timeout, which part c waits out. It must
# outlast a shard's way to its first dump (its CUDA context and warm-up;
# ``ready_s`` in /shards): 0.8-1.5 s at 1, 2 and 4 shards on an NVIDIA
# H100 80GB HBM3 at 700 W. The timed groups keep the group's default.
SHARD_HEARTBEAT_S = 5.0
SHARD_KILL_CALLS = 32           # the burst a shard is killed in
SHARD_MEM_SLACK = 256 << 20     # card bytes a stopped group may leave
TRANSPORT_ERRNOS = (1009, 2003, 2005)   # EFAILEDSOCKET, ELOGOFF, ECLOSE


class _ShardGroup:
    """``python3 -m brpc_tpu_torch.tools.shard_server --generate``: a
    Generate group on cuda:0 behind one port, run from ``pkg_root`` (a
    directory holding the package). Its supervisor is a process of its
    own that makes no CUDA call; this one has CUDA up and must not
    fork. Every process of the group carries its shard directory on its
    command line, which is how a leftover is found."""

    def __init__(self, shards: int, pkg_root: str, work: str,
                 timed: bool = False, env=None):
        """``timed``: the group's defaults (dump interval, hang check)
        and a supervisor even for one shard (``--group``), so that every
        shard count runs the same code; else dumps every 0.1 s (the
        checks read them) and ``SHARD_HEARTBEAT_S``. ``env``: more
        environment for the group (phase ring's lane flag)."""
        from brpc_tpu_torch.tools.spawn_util import spawn_announcing_server
        import tempfile
        self.shards = shards
        self.dir = tempfile.mkdtemp(prefix=f"group{shards}-", dir=work)
        self.err_path = os.path.join(self.dir, "stderr")
        self.err = open(self.err_path, "w")
        env = dict(os.environ, PYTHONPATH=pkg_root, **(env or {}))
        t0 = time.monotonic()
        argv = ["-m", "brpc_tpu_torch.tools.shard_server", "--generate",
                "--shards", str(shards), "--shard-dir", self.dir]
        argv += ["--group"] if timed else [
            "--dump-interval", "0.1", "--heartbeat-timeout",
            str(SHARD_HEARTBEAT_S)]
        self.proc, got = spawn_announcing_server(
            argv, 240, keys=("ADMIN", "PORT") if timed or shards > 1
            else ("PORT",), env=env, stderr=self.err, cwd=pkg_root)
        check(got is not None, f"{shards}-shard group never came up: "
                               f"{self.stderr()}")
        self.up_s = time.monotonic() - t0
        self.port, self.admin = got["PORT"], got.get("ADMIN")
        self.chans = []

    def stderr(self) -> str:
        with open(self.err_path) as f:
            return f.read()[-3000:]

    def page(self, path: str):
        status, body = _http_page(self.admin, path)
        check(status == 200, f"{path}: {status} {body[:200]!r}")
        return json.loads(body) if body[:1] in (b"{", b"[") else body

    def var(self, name: str, shard=None) -> float:
        q = f"/vars?prefix={name}" + ("" if shard is None
                                      else f"&shard={shard}")
        for ln in self.page(q).decode().splitlines():
            n, _, v = ln.partition(" : ")
            if n == name:
                return json.loads(v)
        raise SmokeFailure(f"{name} missing from {q}")

    def running(self) -> list:
        return [s["pid"] for s in self.page("/shards")["group"]["shards"]
                if s["state"] == "running"]

    def restarts(self) -> int:
        return sum(s["restarts"]
                   for s in self.page("/shards")["group"]["shards"])

    def channel(self):
        from brpc_tpu_torch.rpc import Channel, ChannelOptions
        # a connection of its own: the kernel deals each to a shard
        ch = Channel(f"tcp://127.0.0.1:{self.port}",
                     ChannelOptions(timeout_ms=120000, max_retry=3,
                                    share_connections=False))
        self.chans.append(ch)
        return ch

    def pid_of(self, ch) -> int:
        c = ch.call_sync("Bench", "Pid", b"")
        check(not c.failed(), f"Pid: {c.error_text}")
        return int(c.response)

    def spread(self, per_shard: int, limit: int = 96) -> dict:
        """{pid: channels}, ``per_shard`` channels on every shard: the
        kernel hashes each new connection to a shard."""
        by_pid: dict = {}
        for _ in range(limit):
            if len(by_pid) == self.shards and all(
                    len(v) >= per_shard for v in by_pid.values()):
                break
            ch = self.channel()
            by_pid.setdefault(self.pid_of(ch), []).append(ch)
        check(len(by_pid) == self.shards and all(
            len(v) >= per_shard for v in by_pid.values()),
            f"connections reached {len(by_pid)} of {self.shards} shards")
        return {p: v[:per_shard] for p, v in by_pid.items()}

    def processes(self) -> list:
        found = []
        for d in os.listdir("/proc"):
            if not d.isdigit():
                continue
            try:
                with open(f"/proc/{d}/cmdline", "rb") as f:
                    cmd = f.read().decode("utf-8", "replace")
                with open(f"/proc/{d}/stat") as f:
                    state = f.read().rsplit(")", 1)[1].split()[0]
            except OSError:
                continue
            if self.dir in cmd and state != "Z":
                found.append(int(d))
        return found

    def stop(self) -> dict:
        """SIGTERM to the supervisor: (its exit code, seconds until no
        process of the group is left)."""
        import signal
        for ch in self.chans:
            ch.close()
        self.chans = []
        t0 = time.monotonic()
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
        try:
            rc = self.proc.wait(60)
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.wait(10)
            self.proc.stdout.close()
        while self.processes() and time.monotonic() - t0 < 30:
            time.sleep(0.05)
        left = self.processes()
        self.err.close()
        return {"rc": rc, "gone_s": time.monotonic() - t0, "left": left}


def _shard_generate(ch, prompt: str, streamed: bool = False, call=None):
    """One Generate of MAX_TOKENS on ``ch``: (tokens or None, errno,
    text). ``streamed``: the tokens come back as stream frames, then the
    ``d`` verdict. ``call``: a dict that gets the call's trace id (hex)
    and the caller's wall in us."""
    from brpc_tpu_torch.rpc import StreamOptions
    body = json.dumps({"prompt": prompt, "max_tokens": MAX_TOKENS}).encode()
    t0 = time.perf_counter()
    if streamed:
        toks, verdict, done = [], [], threading.Event()

        def on_received(stream, msg):
            if msg.payload[:1] == b"t":
                toks.append(msg.payload[1])
            else:
                verdict.append(msg.payload)
                done.set()
        c = ch.call_sync("GenerateService", "Generate", body,
                         stream_options=StreamOptions(
                             on_received=on_received))
        if not c.failed():
            try:
                ended = done.wait(120)
            finally:
                c.stream.close()
    else:
        c = ch.call_sync("GenerateService", "Generate", body)
    if call is not None:
        call.update(trace_id=f"{c.trace_id:016x}",
                    wall_us=(time.perf_counter() - t0) * 1e6)
    if c.failed():
        return None, c.error_code, c.error_text
    if not streamed:
        return json.loads(c.response)["tokens"], 0, ""
    if not ended or verdict != [b'd{"n": %d, "status": "completed"}'
                                % MAX_TOKENS]:
        return None, "verdict", verdict
    return toks, 0, ""


def _shard_burst(chans, prompts, streamed: bool = False, calls=None):
    """One thread a channel, the prompts dealt round-robin: ({prompt:
    tokens}, [(channel index, errno, text)], wall s). ``streamed``: every
    call streams its tokens; ``calls``: a list that gets each answered
    call's trace id, caller's wall and ``streamed``."""
    results, errors = {}, []

    def client(i):
        for p in prompts[i::len(chans)]:
            call = {"streamed": streamed}
            toks, code, text = _shard_generate(chans[i], p, streamed, call)
            if toks is None:
                errors.append((i, code, text))
            elif results.setdefault(p, toks) != toks:
                errors.append((i, -1, f"{p!r}: tokens differ between "
                                      f"two answers"))
            elif calls is not None:
                calls.append(call)
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(chans))]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    check(not any(t.is_alive() for t in threads), "shard burst hung")
    return results, errors, time.monotonic() - t0


def _shard_counts(g: _ShardGroup, i: int) -> dict:
    s = g.page(f"/serving?shard={i}")
    st = g.page(f"/status?shard={i}")
    return {"pid": st["pid"], "decode_steps": s["decode_steps"],
            "warmup_steps": s["engine"]["warmup_steps"],
            "tokens_out": s["tokens_out"],
            "flash_decode": g.var("flash_decode_launches", i)}


def _settled(fn, timeout_s: float = 10.0):
    """``fn()`` once it returns anything but None (dumps refresh every
    0.1 s), else None."""
    deadline = time.monotonic() + timeout_s
    v = fn()
    while v is None and time.monotonic() < deadline:
        time.sleep(0.1)
        v = fn()
    return v


def _shards_correct(g: _ShardGroup, oracle: dict) -> dict:
    """(a): phase 3's burst over 4 connections a shard; each shard's
    decode steps and flash_decode launches from its own dump; the merged
    views against the per-shard sums."""
    prompts = _prompts()
    by_pid = g.spread(N_CLIENTS // g.shards)
    chans = [c for v in by_pid.values() for c in v]
    res, errs, wall = _shard_burst(chans, prompts)
    check(not errs, f"shards burst: failed calls {errs[:3]}")
    wrong = [p for p in oracle if res.get(p) != oracle[p]]
    check(not wrong, f"shards burst: tokens differ from the CPU plain "
                     f"path for {wrong}")
    tokens = sum(len(t) for t in res.values())

    def views():
        per = [_shard_counts(g, i) for i in range(g.shards)]
        merged = g.page("/serving")
        ok = merged["tokens_out"] == tokens and \
            sum(s["tokens_out"] for s in per) == tokens
        return (per, merged) if ok else None
    got = _settled(views)
    check(got is not None, f"merged /serving tokens_out != {tokens}")
    per, merged = got
    for s in per:
        check(s["decode_steps"] > 0, f"shard {s['pid']} decoded nothing")
        check(s["flash_decode"] == s["decode_steps"] + s["warmup_steps"],
              f"shard {s['pid']}: {s['flash_decode']} flash_decode "
              f"launches != {s['decode_steps']} steps + "
              f"{s['warmup_steps']} warm-up")
    check({s["pid"] for s in per} == set(by_pid) == set(g.running()),
          f"/shards {g.running()} against the pids served {set(by_pid)}")
    sums = {}
    for name in ("server_processed", "flash_decode_launches",
                 "serving_tokens"):
        whole = g.var(name)
        parts = [g.var(name, i) for i in range(g.shards)]
        check(whole == sum(parts), f"merged {name} {whole} != {parts}")
        sums[name] = whole
    return {"tokens": tokens, "wall_s": wall,
            "tokens_per_s": tokens / wall, "shards": per,
            "merged_tokens_out": merged["tokens_out"], "merged_vars": sums,
            "restarts": g.restarts()}


def _shards_kill(g: _ShardGroup, oracle: dict) -> dict:
    """(b): SIGKILL one shard mid-burst: no call on a survivor's
    connection fails, the victim's succeed on retry or fail with a
    transport error; the shard comes back in a new pid that warms up,
    serves and launches flash_decode."""
    import signal
    prompts = [p for _ in range(SHARD_KILL_CALLS // N_REQUESTS)
               for p in _prompts()]
    by_pid = g.spread(N_CLIENTS // g.shards)
    victim = sorted(by_pid)[0]
    order = [(p, c) for p, v in sorted(by_pid.items()) for c in v]
    chans = [c for _, c in order]
    restarts0 = g.restarts()
    killer = threading.Timer(0.3, os.kill, (victim, signal.SIGKILL))
    t_kill = time.monotonic() + 0.3
    killer.start()
    res, errs, wall = _shard_burst(chans, prompts)
    killer.join()
    victim_idx = {i for i, (p, _) in enumerate(order) if p == victim}
    survivor_errs = [e for e in errs if e[0] not in victim_idx]
    check(not survivor_errs, f"calls on survivors failed: {survivor_errs}")
    bad = [e for e in errs if e[1] not in TRANSPORT_ERRNOS]
    check(not bad, f"victim's calls failed with {bad[:3]}")
    wrong = [p for p, t in res.items() if t != oracle[p]]
    check(not wrong, f"kill burst: tokens differ for {wrong}")
    progress("shards b: waiting for the restart")

    def back():
        pids = g.running()
        return pids if len(pids) == g.shards and victim not in pids \
            else None
    pids = _settled(back, 30)
    check(pids is not None, "the killed shard was not restarted")
    new = [p for p in pids if p not in by_pid][0]
    back_s = time.monotonic() - t_kill
    progress(f"shards b: shard {new} is up; its first call")
    # the new shard warms up (its first dump), serves and decodes
    idx = _settled(lambda: next((i for i in range(g.shards)
                                 if g.page(f"/status?shard={i}")["pid"]
                                 == new), None), 30)
    check(idx is not None, f"shard {new} never dumped")
    ch = None
    for _ in range(64):
        c = g.channel()
        if g.pid_of(c) == new:
            ch = c
            break
    check(ch is not None, f"no connection reached the new shard {new}")
    toks, code, text = _shard_generate(ch, prompts[0])
    check(toks == oracle[prompts[0]], f"new shard: {code} {text}")
    s = _settled(lambda: (lambda c: c if c["tokens_out"] >= MAX_TOKENS
                          else None)(_shard_counts(g, idx)))
    check(s is not None and s["flash_decode"] ==
          s["decode_steps"] + s["warmup_steps"] and s["warmup_steps"] == 1,
          f"new shard's launches {s}")
    return {"victim": victim, "new_pid": new, "errors": len(errs),
            "victim_errnos": sorted({e[1] for e in errs}),
            "calls": len(prompts), "wall_s": wall,
            "back_in_s": back_s, "restarts": g.restarts() - restarts0,
            "new_shard": s}


def _shards_hang(g: _ShardGroup) -> dict:
    """(c): SIGSTOP a shard: killed and replaced after the heartbeat
    timeout."""
    import signal
    hung = g.running()[0]
    os.kill(hung, signal.SIGSTOP)
    t0 = time.monotonic()
    pids = _settled(lambda: (lambda p: p if len(p) == g.shards and hung
                             not in p else None)(g.running()),
                    SHARD_HEARTBEAT_S + 30)
    check(pids is not None, f"hung shard {hung} was not replaced")
    took = time.monotonic() - t0
    check(took >= SHARD_HEARTBEAT_S * 0.9,
          f"hung shard replaced after {took:.2f} s, before the timeout")
    check(not os.path.exists(f"/proc/{hung}"), f"{hung} not reaped")
    return {"hung": hung, "replaced_after_s": took,
            "heartbeat_timeout_s": SHARD_HEARTBEAT_S}


def _cuda_control() -> int:
    """``--client shards_control``: whether a forked child can use CUDA:
    in a fresh process, after ``device_count`` (NVML), after
    ``is_available`` (the runtime's count). Then a Generate group from
    this process, whose runtime was asked: its shards must exit with
    ``EXIT_CUDA_BAD_FORK`` and the group fail, with no restart and
    nothing served. Then CUDA initialised: ``start`` must refuse."""
    import torch
    sys.path.insert(0, str(Path(__file__).resolve().parent))

    def child_cuda():
        r, w = os.pipe()
        pid = os.fork()
        if pid == 0:
            try:
                x = torch.ones(4, device="cuda:0")
                doc = {"ok": float(x.sum()) == 4.0, "error": ""}
            except BaseException as e:
                doc = {"ok": False,
                       "error": f"{type(e).__name__}: {e}"[:300]}
            os.write(w, json.dumps(doc).encode())
            os._exit(0)
        os.close(w)
        data = os.read(r, 65536)
        os.close(r)
        os.waitpid(pid, 0)
        return json.loads(data)
    probe = {"fresh": child_cuda()}
    torch.cuda.device_count()
    probe["after_device_count"] = child_cuda()
    torch.cuda.is_available()
    probe["after_is_available"] = child_cuda()
    from brpc_tpu_torch.rpc import Server
    from brpc_tpu_torch.rpc.shard_group import ShardGroupOptions
    from brpc_tpu_torch.serving import add_generate_service
    srv = Server()
    add_generate_service(srv)
    srv.start("tcp://127.0.0.1:0", num_shards=2,
              shard_options=ShardGroupOptions(restart_backoff_s=0.1,
                                              dump_interval_s=0.1))
    grp = srv._shard_group
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline and not grp.failed:
        time.sleep(0.05)
    st = grp.group_status()
    poisoned = {"failed": st["failed"],
                "restarts": [s["restarts"] for s in st["shards"]],
                "states": [s["state"] for s in st["shards"]],
                "dumps": len(grp.aggregator.read_dumps())}
    srv.stop()
    srv.join()
    probe["poisoned_group"] = poisoned
    torch.cuda.init()
    srv = Server()
    add_generate_service(srv)
    try:
        srv.start("tcp://127.0.0.1:0", num_shards=2)
    except RuntimeError as e:
        emit({"refused": True, "error": str(e), "probe": probe})
        return 0
    srv.stop()
    srv.join()
    emit({"refused": False, "probe": probe})
    return 0


def _shards_load_client(ports: str) -> int:
    """``--client shards_load P1,P2,...``: N_CLIENTS channels held open to
    each group's port, the shard pid each reached, one untimed burst on
    each group; a JSON line ``ready``. Then, for each line ``PORT CALLS``
    on stdin, CALLS Generate calls over that group's channels (a thread a
    channel, the prompts cycled), and a JSON line with the answers, the
    whole-call latencies (the first token comes with the last) and the
    wall-clock start and end. An empty line ends it."""
    from brpc_tpu_torch.rpc import Channel, ChannelOptions
    chans = {int(p): [Channel(f"tcp://127.0.0.1:{p}",
                              ChannelOptions(timeout_ms=120000,
                                             share_connections=False))
                      for _ in range(N_CLIENTS)] for p in ports.split(",")}
    prompts = _prompts()

    def turn(port: int, calls: int) -> dict:
        results, errors, lat, tokens = {}, [], [], []

        def client(i):
            for k in range(i, calls, N_CLIENTS):
                p = prompts[k % len(prompts)]
                t0 = time.perf_counter()
                toks, code, text = _shard_generate(chans[port][i], p)
                if toks is None:
                    errors.append((code, text))
                    continue
                lat.append((time.perf_counter() - t0) * 1e3)
                tokens.append(len(toks))
                if results.setdefault(p, toks) != toks:
                    errors.append((-1, f"{p!r}: tokens differ between two "
                                       f"answers"))
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(N_CLIENTS)]
        cpu0, start = time.process_time(), time.time()
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        check(not any(t.is_alive() for t in threads), "load client hung")
        return {"results": results, "errors": errors[:5],
                "n_errors": len(errors), "calls": len(lat),
                "tokens": sum(tokens), "ttft_ms": lat, "start": start,
                "end": time.time(), "cpu_s": time.process_time() - cpu0}
    try:
        spread = {}
        for port, cs in chans.items():
            pids = []
            for ch in cs:
                c = ch.call_sync("Bench", "Pid", b"")
                check(not c.failed(), f"Pid: {c.error_text}")
                pids.append(int(c.response))
            spread[port] = pids
        warm = {port: turn(port, N_REQUESTS)["n_errors"] for port in chans}
        emit({"ready": True, "spread": spread, "warm_errors": warm})
        for line in sys.stdin:
            if not line.strip():
                break
            port, calls = (int(x) for x in line.split())
            emit(turn(port, calls))
    finally:
        for cs in chans.values():
            for ch in cs:
                ch.close()
    return 0


class _LineReader:
    """JSON lines from a child's stdout, each under a time limit."""

    def __init__(self, proc):
        self.proc, self.buf = proc, b""

    def line(self, timeout_s: float) -> dict:
        import select
        fd = self.proc.stdout.fileno()
        deadline = time.monotonic() + timeout_s
        while True:
            ln, nl, rest = self.buf.partition(b"\n")
            if nl:
                self.buf = rest
                if ln.startswith(b"{"):
                    return json.loads(ln)
                continue
            left = deadline - time.monotonic()
            check(left > 0, "a load client gave no answer in time")
            if select.select([fd], [], [], left)[0]:
                chunk = os.read(fd, 1 << 20)
                check(bool(chunk), f"a load client exited "
                                   f"({self.proc.poll()})")
                self.buf += chunk


def _dump_cost(g: _ShardGroup) -> list:
    """Each shard's dump-loop counters: (dumps, CPU us, wall us)."""
    return [[g.var(n, i) for n in ("shard_dumps", "shard_dump_cpu_us",
                                   "shard_dump_wall_us")]
            for i in range(g.shards)]


def _shards_timing(pkg_root: str, work: str, oracle: dict) -> dict:
    """(f): Generate tokens/s and client TTFT (the whole unary call) at 1,
    2 and 4 shards, from one client process and from four. Every group
    runs the same code (``--group``: a supervisor even for one shard) at
    the group's default dump interval and hang check, and all three are
    up together. Four load clients (``--client shards_load``) hold
    N_CLIENTS connections to each group. A turn is SHARD_TURN_CALLS
    calls, from client 0 alone or split over all four; each round runs
    every cell once, the shard counts and client counts in reverse order
    every other round. Every answer is checked against the CPU plain
    path, and every group must end with no restart. The shards'
    dump-loop counters are read before and after the turns."""
    groups, clients = {}, []
    out = {"turn_calls": SHARD_TURN_CALLS, "rounds": SHARD_ROUNDS}
    err = open(os.path.join(work, "load-clients.stderr"), "w+")
    try:
        for n in SHARD_COUNTS:
            progress(f"shards f: a {n}-shard group")
            groups[n] = _ShardGroup(n, pkg_root, work, timed=True)
        shards_up = {}
        for n, g in groups.items():
            st = g.page("/shards")["group"]["shards"]
            check(g.restarts() == 0, f"{n}-shard group: restarts while it "
                                     f"came up: {st}")
            shards_up[n] = {"up_s": g.up_s,
                            "ready_s": [s["ready_s"] for s in st]}
        out["groups"] = shards_up
        ports = ",".join(str(groups[n].port) for n in SHARD_COUNTS)
        progress("shards f: load clients")
        for _ in range(max(SHARD_CLIENT_PROCESSES)):
            p = subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), "--client",
                 "shards_load", ports], stdin=subprocess.PIPE,
                stdout=subprocess.PIPE, stderr=err)
            clients.append((p, _LineReader(p)))
        ready = [rd.line(240) for _, rd in clients]
        check(all(d["ready"] and not any(d["warm_errors"].values())
                  for d in ready), f"load clients: {ready}")
        # {shards: {pid: channels}} over all four clients
        out["spread"] = {n: {} for n in SHARD_COUNTS}
        for d in ready:
            for n in SHARD_COUNTS:
                for pid in d["spread"][str(groups[n].port)]:
                    k = str(pid)
                    out["spread"][n][k] = out["spread"][n].get(k, 0) + 1
        cost0 = {n: _dump_cost(g) for n, g in groups.items()}
        t_cost0 = time.monotonic()
        turns = {(n, c): [] for n in SHARD_COUNTS
                 for c in SHARD_CLIENT_PROCESSES}
        for r in range(SHARD_ROUNDS):
            step = 1 if r % 2 == 0 else -1
            progress(f"shards f: round {r}")
            for n in SHARD_COUNTS[::step]:
                for c in SHARD_CLIENT_PROCESSES[::step]:
                    line = f"{groups[n].port} {SHARD_TURN_CALLS // c}\n"
                    for p, _ in clients[:c]:
                        p.stdin.write(line.encode())
                        p.stdin.flush()
                    docs = [rd.line(300) for _, rd in clients[:c]]
                    errs = [e for d in docs for e in d["errors"]]
                    check(not errs, f"{n} shards, {c} clients: {errs[:3]}")
                    wrong = [p for d in docs for p, t in d["results"].items()
                             if t != oracle[p]]
                    check(not wrong, f"{n} shards, {c} clients: tokens "
                                     f"differ from the CPU plain path for "
                                     f"{wrong[:3]}")
                    wall = max(d["end"] for d in docs) - \
                        min(d["start"] for d in docs)
                    tokens = sum(d["tokens"] for d in docs)
                    turns[(n, c)].append({
                        "round": r, "calls": sum(d["calls"] for d in docs),
                        "tokens": tokens, "wall_s": wall,
                        "tokens_per_s": tokens / wall,
                        "ttft_ms": [x for d in docs for x in d["ttft_ms"]],
                        "client_cpu_s": sum(d["cpu_s"] for d in docs)})
        span = time.monotonic() - t_cost0
        cost1 = {n: _dump_cost(g) for n, g in groups.items()}
        for n, g in groups.items():
            check(g.restarts() == 0, f"{n}-shard group: restarts during "
                                     f"the turns: "
                                     f"{g.page('/shards')['group']}")
        out["dump_cost"] = {}
        for n in SHARD_COUNTS:
            rows = []
            for a, b in zip(cost0[n], cost1[n]):
                dumps, cpu, wall = (y - x for x, y in zip(a, b))
                rows.append({"dumps_per_s": dumps / span,
                             "cpu_us_per_dump": cpu / dumps if dumps else
                             None, "wall_us_per_dump": wall / dumps
                             if dumps else None,
                             "cpu_share": cpu / 1e6 / span,
                             "wall_share": wall / 1e6 / span})
            out["dump_cost"][n] = rows
        out["window_s"] = span
        for (n, c), ts in turns.items():
            base = turns[(1, c)]
            ttft = [x for t in ts for x in t["ttft_ms"]]
            rates = [t["tokens_per_s"] for t in ts]
            out[f"{n}_shards_{c}_clients"] = {
                "calls": sum(t["calls"] for t in ts),
                "tokens": sum(t["tokens"] for t in ts),
                "tokens_per_s_turns": rates,
                "tokens_per_s_median": _median(rates),
                "vs_1_shard_same_round": [
                    t["tokens_per_s"] / b["tokens_per_s"]
                    for t, b in zip(ts, base)],
                "ttft_p50_ms": _median(ttft), "ttft_p99_ms": _p99(ttft),
                "client_cpu_s": sum(t["client_cpu_s"] for t in ts)}
    finally:
        for p, _ in clients:
            try:
                p.stdin.write(b"\n")
                p.stdin.close()
                p.wait(30)
            except Exception:
                pass
            if p.poll() is None:
                p.kill()
                p.wait(10)
            p.stdout.close()
        err.seek(0)
        tail = err.read()[-2000:]
        err.close()
        stops = {n: g.stop() for n, g in groups.items()}
    for n, d in stops.items():
        check(d["rc"] == 0 and not d["left"],
              f"{n}-shard group stop: {d} {groups[n].stderr()}")
    check(all(p.returncode == 0 for p, _ in clients),
          f"load clients: {[p.returncode for p, _ in clients]} {tail}")
    out["stop"] = stops
    return out


def phase_shards(dev):
    """Generate served by forked shards behind one SO_REUSEPORT port.
    The group runs from a copy of the package whose ``_build/`` is
    empty, so its supervisor builds the native core and flash_decode
    before it forks; the shards come up with no restart. Parts: (a) the
    burst, tokens, per-shard launches and the merged views; (b) SIGKILL
    mid-burst and the restart; (c) SIGSTOP and the hang check; (d)
    SIGTERM to the supervisor: no process left, the card memory back;
    (e) the control: a supervisor with CUDA up is refused, one that
    asked the runtime fails its group; (f) tokens/s and TTFT at 1, 2 and
    4 shards from one and four client processes (``_shards_timing``)."""
    import shutil
    import tempfile

    import torch

    from brpc_tpu_torch.serving import TinyDecoder, TinyDecoderConfig
    phase_t0 = time.monotonic()
    cpu_model = TinyDecoder(TinyDecoderConfig(), device="cpu")
    oracle = {p: cpu_model.generate(list(p.encode()), MAX_TOKENS)
              for p in _prompts()}
    work = tempfile.mkdtemp(prefix="chip-smoke-shards-")
    pkg_root = os.path.join(work, "pkg")
    here = Path(__file__).resolve().parent
    shutil.copytree(here / "brpc_tpu_torch",
                    os.path.join(pkg_root, "brpc_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    out = {"phase": "shards"}
    try:
        progress("shards a: a 2-shard group from a cold _build/")
        free0 = torch.cuda.mem_get_info(dev)[0]
        g = _ShardGroup(2, pkg_root, work)
        try:
            built = sorted(os.listdir(os.path.join(
                pkg_root, "brpc_tpu_torch", "_build")))
            check(any(n.startswith("libflash_decode-") for n in built),
                  f"the supervisor built no flash_decode: {built}")
            free1 = torch.cuda.mem_get_info(dev)[0]
            a = _shards_correct(g, oracle)
            check(a["restarts"] == 0,
                  f"a cold _build/ restarted {a['restarts']} shards")
            a.update(up_s=g.up_s, built_before_fork=built,
                     card_bytes_in_use=free0 - free1,
                     ready_s=[st["ready_s"] for st in
                              g.page("/shards")["group"]["shards"]])
            emit({"phase": "shards", "part": "a", "a": a})
            out["a"] = a
            progress("shards b: SIGKILL mid-burst")
            out["b"] = _shards_kill(g, oracle)
            emit({"phase": "shards", "part": "b", "b": out["b"]})
            progress("shards c: SIGSTOP")
            out["c"] = _shards_hang(g)
            emit({"phase": "shards", "part": "c", "c": out["c"]})
        finally:
            progress("shards d: SIGTERM")
            d = g.stop()
        freed = _settled(lambda: (lambda f: f if free0 - f
                                  < SHARD_MEM_SLACK else None)(
            torch.cuda.mem_get_info(dev)[0]), 15)
        d.update(free_before=free0, free_running=free1,
                 free_after=torch.cuda.mem_get_info(dev)[0])
        check(d["rc"] == 0, f"supervisor exited {d['rc']}: {g.stderr()}")
        check(not d["left"], f"processes left: {d['left']}")
        # past the drain budget (5 s) the supervisor SIGKILLs: a shard
        # that had not drained
        check(d["gone_s"] < 5.0, f"the group took {d['gone_s']:.2f} s to "
                                 f"stop: {g.stderr()}")
        check(freed is not None, f"the shards' card memory did not come "
                                 f"back: {d}")
        out["d"] = d
        emit({"phase": "shards", "part": "d", "d": d})
        progress("shards e: the CUDA control")
        env = {k: v for k, v in os.environ.items()
               if k != "PYTORCH_NVML_BASED_CUDA_CHECK"}
        ctl = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--client",
             "shards_control", "0"], capture_output=True, text=True,
            timeout=300, env=env)
        check(ctl.returncode == 0, f"shards_control: {ctl.stderr[-2000:]}")
        e = json.loads(ctl.stdout.strip().splitlines()[-1])
        check(e["refused"] and "CUDA" in e["error"],
              f"a supervisor with CUDA up was not refused: {e}")
        check(e["probe"]["fresh"]["ok"], f"a fresh fork: {e['probe']}")
        pg = e["probe"]["poisoned_group"]
        check(pg["dumps"] == 0 and pg["restarts"] == [0, 0] and
              "before the fork" in (pg["failed"] or "") and
              "made a CUDA call before the fork" in ctl.stderr,
              f"shards of a supervisor that asked the runtime: {pg}")
        e["poisoned_shard_error"] = next(
            (ln for ln in ctl.stderr.splitlines()
             if "made a CUDA call before the fork" in ln), "")
        out["e"] = e
        emit({"phase": "shards", "part": "e", "e": e})
        out["f"] = _shards_timing(pkg_root, work, oracle)
        emit({"phase": "shards", "part": "f", "f": out["f"]})
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out["phase_s"] = time.monotonic() - phase_t0
    out["launches"] = {"flash_decode":
                       out["a"]["merged_vars"]["flash_decode_launches"]}
    emit({"phase": "shards", "launches": out["launches"],
          "phase_s": out["phase_s"]})
    return out


# -------------------------------------------------------------- phase ring

RING_ENV = {"BRPC_TPU_FLAG_EVENT_RING_LANE": "1"}
SELECTOR_ENV = {"BRPC_TPU_FLAG_EVENT_RING_LANE": "0"}
RING_TURN_CALLS = 256           # (c)-(e): Generate calls in a timed turn
RING_ROUNDS = 2                 # (c)-(e): timed turns a case; the order flips
RING_SSL_CPU_RATIO = 10         # (e): most server CPU a TLS call may take,
                                # against a tcp call on its lane's server
RING_ECHO_CONNS = 8             # (c): tools/ring_smoke.py's echo shape
RING_ECHO_INFLIGHT = 32
RING_ECHO_CALLS = 4000
RING_ECHO_WINDOWS = 3
RING_ECHO_PAYLOAD = b"ring"
RING_BACKENDS = {"batch": 1, "uring": 2}
RING_PAGE_POLLS = 3             # (g): each page read at least this often


def _install_ring(backend: int) -> None:
    """Make this process's dispatcher a ring of the given backend (1
    batch, 2 uring) before any consumer builds one: the flag picks the
    auto backend only."""
    from brpc_tpu_torch.transport import event_dispatcher as ed, ring_lane
    check(ed.peek_dispatcher() is None, "a dispatcher already exists")
    ed._global = ring_lane.RingDispatcher(backend=backend)


def _lane() -> list:
    """[the dispatcher's class, its backend] of this process."""
    from brpc_tpu_torch.transport.event_dispatcher import global_dispatcher
    d = global_dispatcher()
    return [type(d).__name__, getattr(d, "backend", "selector")]


def _ring_counters() -> dict:
    from brpc_tpu_torch.transport import ring_lane
    return ring_lane.counters()


def _thread_cpu() -> dict:
    """CPU seconds of this process's threads, by name (the Python name
    where the thread is Python's, else the kernel's); {} where /proc has
    no task list."""
    names = {t.native_id: t.name for t in threading.enumerate()}
    tick = os.sysconf("SC_CLK_TCK")
    out = {}
    try:
        tids = os.listdir("/proc/self/task")
    except OSError:
        return out
    for tid in tids:
        try:
            with open(f"/proc/self/task/{tid}/stat") as f:
                st = f.read()
        except OSError:
            continue
        comm = st[st.index("(") + 1:st.rindex(")")]
        fields = st[st.rindex(")") + 2:].split()
        name = names.get(int(tid), comm)
        out[name] = out.get(name, 0.0) + \
            (int(fields[11]) + int(fields[12])) / tick
    return out


def _ring_server_session(scheme: str, cert: str = "", key: str = "") -> int:
    """``--client ring_server tcp|ssl [CERT KEY]``: a default Generate
    server on cuda:0 whose lane follows this process's environment;
    prints its port and lane, then a snapshot (CPU seconds, syscalls,
    decode steps, launches, the ring's counters, the threads) on every
    line read from stdin, and stops at the end of stdin."""
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import torch

    from brpc_tpu_torch.rpc import Server
    from brpc_tpu_torch.serving import add_generate_service
    from brpc_tpu_torch.transport import syscall_stats
    fa = _fa_module()
    fa.reset_launches()
    server = Server()
    gs = add_generate_service(server)
    addr = "tcp://127.0.0.1:0" if scheme == "tcp" else \
        f"ssl://127.0.0.1:0#cert={cert}&key={key}"
    ep = server.start(addr)
    emit({"port": ep.port, "lane": _lane(), "device": str(gs.device)})
    try:
        while sys.stdin.readline():
            torch.cuda.synchronize()
            emit({"cpu_s": time.process_time(),
                  "sys": syscall_stats.snapshot(),
                  "steps": gs.batcher.decode_steps + gs.engine.warmup_steps,
                  "launches": dict(fa.launches),
                  "processed": server.nprocessed,
                  "ring": _ring_counters(),
                  "threads": sorted(t.name for t in threading.enumerate()),
                  "thread_cpu": _thread_cpu()})
    finally:
        server.stop()
        server.join(10)
    return 0


def _ring_echo(lane: str) -> int:
    """``--client ring_echo selector|batch|uring``: tools/ring_smoke.py's
    echo shape in one process on that lane: RING_ECHO_CONNS connections
    of their own, RING_ECHO_INFLIGHT calls in flight on each, re-issued
    from the completions, a 4-byte payload; a warm window, then
    RING_ECHO_WINDOWS windows of RING_ECHO_CALLS calls: calls/s, p50 and
    p99, and syscalls a message. The handler is a coroutine that does
    not suspend, so it answers in place on the dispatcher, where the
    ring defers the response to its tick's flush."""
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    if lane != "selector":
        _install_ring(RING_BACKENDS[lane])
    from brpc_tpu_torch.rpc import Channel, ChannelOptions, Server, Service
    from brpc_tpu_torch.transport import syscall_stats
    svc = Service("Bench")

    @svc.method()
    async def PyEcho(cntl, request):
        return bytes(request)
    server = Server()
    server.add_service(svc)
    addr = f"tcp://127.0.0.1:{server.start('tcp://127.0.0.1:0').port}"
    chans = [Channel(addr, ChannelOptions(timeout_ms=10000,
                                          share_connections=False))
             for _ in range(RING_ECHO_CONNS)]
    for ch in chans:
        c = ch.call_sync("Bench", "PyEcho", b"warm")
        check(not c.failed(), f"echo warm-up: {c.error_text}")

    def window() -> dict:
        lat, done, lock = [], threading.Event(), threading.Lock()
        state = {"left": RING_ECHO_CALLS, "issued": 0, "errors": 0}

        def issue(ch):
            t0 = time.perf_counter_ns()

            def on_done(c):
                go = False
                with lock:
                    if c.failed() or c.response != RING_ECHO_PAYLOAD:
                        state["errors"] += 1
                    else:
                        lat.append((time.perf_counter_ns() - t0) / 1e3)
                    state["left"] -= 1
                    if not state["left"]:
                        done.set()
                    elif state["issued"] < RING_ECHO_CALLS:
                        state["issued"] += 1
                        go = True
                if go:
                    issue(ch)
            ch.call("Bench", "PyEcho", RING_ECHO_PAYLOAD, done=on_done)

        seed = min(RING_ECHO_CONNS * RING_ECHO_INFLIGHT, RING_ECHO_CALLS)
        state["issued"] = seed
        s0, t0 = syscall_stats.snapshot(), time.perf_counter()
        for i in range(seed):
            issue(chans[i % RING_ECHO_CONNS])
        check(done.wait(120), f"{lane} echo window hung")
        wall = time.perf_counter() - t0
        s1 = syscall_stats.snapshot()
        check(state["errors"] == 0, f"{lane} echo: {state['errors']} "
                                    f"failed or wrong")
        return {"qps": RING_ECHO_CALLS / wall, "p50_us": _median(lat),
                "p99_us": _p99(lat),
                "syscalls_per_rpc": syscall_stats.per_rpc(s0, s1)}

    try:
        window()
        r0 = _ring_counters()
        windows = [window() for _ in range(RING_ECHO_WINDOWS)]
        ring = _delta(r0, _ring_counters())
    finally:
        for ch in chans:
            ch.close()
        server.stop()
        server.join(10)
    emit({"lane": _lane(), "windows": windows, "ring": ring,
          "best_qps": max(w["qps"] for w in windows),
          "mapped": _loaded_native()})
    return 0


def _ring_probe() -> dict:
    """(a): the kernel, the auto backend, the forced-uring verdict, the
    forced batch backend, and ``openssl`` (part e makes its certificate
    with it)."""
    from brpc_tpu_torch.native import fastcore
    fc = fastcore.get()
    check(fc is not None and hasattr(fc, "Ring"),
          f"the native core has no Ring: {fastcore.load_error}")
    out = {"kernel": os.uname().release}
    r = fc.Ring()
    out["auto"] = r.backend_name()
    r.close()
    try:
        r = fc.Ring(RING_BACKENDS["uring"])
        out["forced_uring"] = "ok"
        r.close()
    except OSError as e:
        out["forced_uring"] = f"errno {e.errno} ({e.strerror})"
    r = fc.Ring(RING_BACKENDS["batch"])
    out["forced_batch"] = r.backend_name()
    r.close()
    check(out["forced_batch"] == "batch", f"Ring(1): {out}")
    try:
        ver = subprocess.run(["openssl", "version"], capture_output=True,
                             text=True, timeout=30)
    except FileNotFoundError:
        raise SmokeFailure("ring a: openssl is missing; part e needs it "
                           "to make its certificate") from None
    check(ver.returncode == 0, f"ring a: openssl version: {ver.stderr}")
    out["openssl"] = ver.stdout.strip()
    return out


def _session_lane(sess, want: str, what: str) -> dict:
    hello = sess.read()
    check(hello["device"] == "cuda:0", f"{what}: service device "
                                       f"{hello['device']}")
    check(hello["lane"][0] == want, f"{what}: the flag asked for the "
                                    f"{want} and the process runs "
                                    f"{hello['lane']}")
    return hello


def _snap_delta(a: dict, b: dict) -> dict:
    """What a server session did between two snapshots."""
    from brpc_tpu_torch.transport import syscall_stats
    calls = b["processed"] - a["processed"]
    return {"calls": calls, "steps": b["steps"] - a["steps"],
            "flash_decode": (b["launches"]["flash_decode"]
                             - a["launches"]["flash_decode"]),
            "launched": {k: v - a["launches"].get(k, 0)
                         for k, v in b["launches"].items()},
            "cpu_ms_per_call": (b["cpu_s"] - a["cpu_s"]) * 1e3
            / max(calls, 1),
            "syscalls_per_rpc": syscall_stats.per_rpc(a["sys"], b["sys"]),
            "ring": _delta(a["ring"], b["ring"]),
            # where the server's CPU went: the five busiest threads
            "thread_cpu_s": dict(sorted(
                ((k, round(v - a["thread_cpu"].get(k, 0.0), 3))
                 for k, v in b["thread_cpu"].items()),
                key=lambda kv: -kv[1])[:5])}


def _counted_turn(what: str, sess, fn, *args):
    """``fn(*args)`` between two snapshots of a server session: its
    flash_decode launches must equal its decode steps, and no other
    kernel may run."""
    a = sess.step()
    r = fn(*args)
    d = _snap_delta(a, sess.step())
    check(d["flash_decode"] == d["steps"] > 0 and
          sum(d["launched"].values()) == d["flash_decode"],
          f"{what}: launched {d['launched']}, {d['steps']} decode steps")
    return r, d


def _turn(chans, calls: int, oracle: dict, what: str) -> dict:
    """``calls`` Generate calls from N_CLIENTS threads, thread i on
    ``chans[i]``, the oracle's prompts in turn; every answer must equal
    the CPU plain path's. Tokens/s and the whole call's p50/p99."""
    prompts = list(oracle)
    lat, errors, tokens = [], [], []

    def client(i):
        for n in range(i, calls, N_CLIENTS):
            p = prompts[n % len(prompts)]
            t0 = time.perf_counter()
            c = chans[i].call_sync("GenerateService", "Generate",
                                   _generate_body(p))
            if c.failed():
                errors.append((p, c.error_code, c.error_text))
                continue
            lat.append((time.perf_counter() - t0) * 1e3)
            got = json.loads(c.response)["tokens"]
            if got != oracle[p]:
                errors.append((p, -1, "tokens differ from the CPU plain "
                                      "path"))
            tokens.append(len(got))
    wall = _run_clients(client)
    check(not errors, f"{what}: {len(errors)} of {calls} calls failed or "
                      f"wrong: {errors[:3]}")
    return {"calls": calls, "wall_s": wall,
            "tokens_per_s": sum(tokens) / wall, "p50_ms": _median(lat),
            "p99_ms": _p99(lat)}


def _poll_pages(port: int, stop: threading.Event, seen: dict) -> None:
    """(g): /sockets, /ids and /connections of the server at ``port``,
    read again and again until ``stop``; each answer's shape checked."""
    while not stop.is_set():
        for path in ("/sockets", "/ids", "/connections"):
            status, body = _http_page(port, path)
            if status != 200:
                seen.setdefault("errors", []).append((path, status))
                continue
            doc = json.loads(body)
            if path == "/connections":
                rows = doc["connections"]
                ok = rows and all({"read_bytes", "resident_bytes",
                                   "last_active_s", "idle_class"} <= set(r)
                                  for r in rows)
                seen["max_connections"] = max(seen.get("max_connections",
                                                       0), len(rows))
            elif path == "/sockets":
                ok = bool(doc) and all("write_queue" in r for r in doc)
                seen["max_sockets"] = max(seen.get("max_sockets", 0),
                                          len(doc))
            else:
                ok = "inflight_client_calls" in doc
            seen[path] = seen.get(path, 0) + (1 if ok else 0)
        stop.wait(0.05)


def _ring_generate(sess, port: int, oracle: dict) -> dict:
    """(b) and (g): the unary burst from a client process on the ring
    with the batch backend (its sync calls plucked, a connection's first
    behind the fence),
    the stream burst from a client process on the ring (auto backend)
    while the pages are read, the HTTP burst from this process; tokens,
    frames and footers equal the CPU plain path's, and the server's
    flash_decode launches equal its decode steps."""
    out = {}
    doc, d = _counted_turn("ring b unary", sess, _client_process,
                           ["unary", str(port)], 300,
                           dict(RING_ENV, CHIP_SMOKE_RING_BACKEND="1"))
    _check_burst("ring b unary", doc["results"], doc["errors"], oracle)
    check(doc["lane"] == ["RingDispatcher", "batch"],
          f"ring b: the unary client ran on {doc['lane']}")
    check(doc["native"]["pluck_fast"] == N_REQUESTS,
          f"ring b: {doc['native']['pluck_fast']} of {N_REQUESTS} sync "
          f"calls plucked behind the fence")
    # a claim fences only when it finds reads live: a thread's first call
    # on its connection does; after a plucked call the socket sticks
    # (reads left off), and the next claim takes no fence
    check(N_CLIENTS <= doc["ring"]["ring_read_barriers"] < N_REQUESTS,
          f"ring b: the fence ran {doc['ring']['ring_read_barriers']} "
          f"times")
    out["unary"] = dict(_burst_line(doc["results"], doc["wall_s"],
                                    doc["ttft_ms"], []),
                        server=d, client_ring=doc["ring"],
                        client_lane=doc["lane"])
    stop, seen = threading.Event(), {}
    poller = threading.Thread(target=_poll_pages, args=(port, stop, seen),
                              name="ring_pages")
    poller.start()
    try:
        doc, d = _counted_turn("ring b stream", sess, _client_process,
                               ["stream", str(port)], 300, RING_ENV)
    finally:
        stop.set()
        poller.join(30)
    _check_burst("ring b stream", doc["results"], doc["errors"], oracle)
    check(doc["lane"][0] == "RingDispatcher",
          f"ring b: the stream client ran on {doc['lane']}")
    out["stream"] = dict(_burst_line(doc["results"], doc["wall_s"],
                                     doc["ttft_ms"], doc["gaps_ms"]),
                         server=d, client_ring=doc["ring"],
                         client_lane=doc["lane"])
    check(not seen.get("errors") and all(
        seen.get(p, 0) >= RING_PAGE_POLLS
        for p in ("/sockets", "/ids", "/connections")),
        f"ring g: the pages during the stream burst: {seen}")
    out["pages"] = seen
    (res, errs, wall, ttft, gaps), d = _counted_turn(
        "ring b http", sess, _http_burst, port, _prompts(), MAX_TOKENS)
    _check_burst("ring b http", res, errs, oracle)
    out["http"] = dict(_burst_line(res, wall, ttft, gaps), server=d)
    return out


def _lane_turns(sessions: dict, oracle: dict) -> dict:
    """(c) and (e): the four servers (ring and selector, on tcp and on
    ssl) in turns, N_CLIENTS connections of its own to each from this
    process, held from the first call to the last. A server's first turn
    is its warm-up, N_REQUESTS calls on the new connections (a TLS
    connection's first call carries its handshake); then RING_ROUNDS
    rounds of RING_TURN_CALLS calls a server, the order reversed every
    other round. Each turn: tokens/s, the whole call's p50/p99, the
    server's syscalls a message and CPU a call, and its flash_decode
    launches equal to its decode steps. A TLS turn whose server CPU a
    call is RING_SSL_CPU_RATIO times the tcp turn's on the same lane in
    the same round fails, with both servers' busiest threads."""
    from brpc_tpu_torch.rpc import Channel, ChannelOptions
    chans = {k: [Channel(f"{'ssl' if k.startswith('ssl') else 'tcp'}"
                         f"://127.0.0.1:{port}",
                         ChannelOptions(timeout_ms=120000,
                                        share_connections=False))
                 for _ in range(N_CLIENTS)]
             for k, (_, port) in sessions.items()}
    order = list(sessions)
    plan = [("warm-up", order, N_REQUESTS)] + [
        (rnd, order if rnd % 2 == 0 else order[::-1], RING_TURN_CALLS)
        for rnd in range(RING_ROUNDS)]
    keys = ("tokens_per_s", "p50_ms", "p99_ms", "server_syscalls_per_rpc",
            "server_cpu_ms_per_call")
    runs = {k: [] for k in sessions}
    first = {}
    try:
        for rnd, turn_order, calls in plan:
            got = {}
            for k in turn_order:
                what = f"ring c {k} turn {rnd}"
                r, d = _counted_turn(what, sessions[k][0], _turn, chans[k],
                                     calls, oracle, what)
                got[k] = dict(r, server_syscalls_per_rpc=d[
                    "syscalls_per_rpc"], server_cpu_ms_per_call=d[
                    "cpu_ms_per_call"], server_ring=d["ring"],
                    server_threads_cpu_s=d["thread_cpu_s"])
            for lane in ("ring", "selector"):
                tls, tcp = got[f"ssl_{lane}"], got[lane]
                check(tls["server_cpu_ms_per_call"] <= RING_SSL_CPU_RATIO *
                      tcp["server_cpu_ms_per_call"],
                      f"ring e: turn {rnd}: the TLS server on the {lane} "
                      f"took {tls['server_cpu_ms_per_call']:.2f} ms CPU a "
                      f"call against tcp's "
                      f"{tcp['server_cpu_ms_per_call']:.2f}; TLS threads "
                      f"{tls['server_threads_cpu_s']}, tcp threads "
                      f"{tcp['server_threads_cpu_s']}")
            if rnd == "warm-up":
                first = got
                continue
            for k, r in got.items():
                runs[k].append(dict(r, round=rnd))
    finally:
        for v in chans.values():
            for ch in v:
                ch.close()

    def ratio(a, b):
        return [x["tokens_per_s"] / y["tokens_per_s"]
                for x, y in zip(runs[a], runs[b])]
    return {"turn_calls": RING_TURN_CALLS, "rounds": RING_ROUNDS,
            "order": order, "warm_up": first, "runs": runs,
            "medians": {k: {m: _median([r[m] for r in v]) for m in keys}
                        for k, v in runs.items()},
            "ring_over_selector": ratio("ring", "selector"),
            "ssl_over_tcp": {lane: ratio(f"ssl_{lane}", lane)
                             for lane in ("ring", "selector")}}


def _echo_turns(lanes) -> dict:
    """(c): the echo shape in a child process a lane."""
    out = {}
    for lane in lanes:
        doc = _client_process(["ring_echo", lane], 300)
        want = "EventDispatcher" if lane == "selector" else "RingDispatcher"
        check(doc["lane"][0] == want and (lane == "selector" or
                                          doc["lane"][1] == lane),
              f"ring c echo {lane}: ran on {doc['lane']}")
        if lane != "selector":
            check(doc["ring"]["ring_ticks"] > 0,
                  f"ring c echo {lane}: {doc['ring']}")
        out[lane] = doc
    return out


def _conn_types(dev, oracle: dict) -> dict:
    """(d): Generate over tcp on a default server of this process, four
    ways to connect N_CLIENTS client threads: N_CLIENTS shared Channels,
    N_CLIENTS with ``share_connections=False``, one ``pooled`` Channel
    and one ``short`` Channel. After an untimed warm-up, RING_ROUNDS
    rounds of RING_TURN_CALLS calls a case, the order reversed every
    other round, each turn on new Channels. Each turn: the connections
    the server accepted, the open rows of /connections
    (``connections_page``) at its end, tokens/s and p50 (the whole
    call), every answer equal to the plain path's, flash_decode launches
    equal to the decode steps."""
    from brpc_tpu_torch.builtin.services import connections_page
    from brpc_tpu_torch.rpc import Channel, ChannelOptions, Server
    from brpc_tpu_torch.serving import add_generate_service
    fa = _fa_module()
    server = Server()
    gs = add_generate_service(server)
    check(str(gs.device) == "cuda:0", f"service device {gs.device}")
    accepted = [0]
    on_new_conn = server._on_new_conn

    def counting(conn):
        accepted[0] += 1
        on_new_conn(conn)
    server._on_new_conn = counting      # the listener takes this one
    addr = f"tcp://127.0.0.1:{server.start('tcp://127.0.0.1:0').port}"
    cases = {
        "shared": lambda: [Channel(addr, ChannelOptions(timeout_ms=120000))
                           for _ in range(N_CLIENTS)],
        "own": lambda: [Channel(addr, ChannelOptions(
            timeout_ms=120000, share_connections=False))
            for _ in range(N_CLIENTS)],
        "pooled": lambda: [Channel(addr, ChannelOptions(
            timeout_ms=120000, connection_type="pooled"))] * N_CLIENTS,
        "short": lambda: [Channel(addr, ChannelOptions(
            timeout_ms=120000, connection_type="short"))] * N_CLIENTS,
    }
    # the connections a turn may make: (fewest, most)
    want = {"shared": (1, 1), "own": (N_CLIENTS, N_CLIENTS),
            "pooled": (1, N_CLIENTS),
            "short": (RING_TURN_CALLS, RING_TURN_CALLS)}
    names = list(cases)
    plan = [("warm-up", "own", N_REQUESTS)] + [
        (rnd, name, RING_TURN_CALLS) for rnd in range(RING_ROUNDS)
        for name in (names if rnd % 2 == 0 else names[::-1])]
    runs = {k: [] for k in cases}
    launched = 0
    try:
        for rnd, name, calls in plan:
            what = f"ring d {name} turn {rnd}"
            n0 = accepted[0]
            chans = cases[name]()
            for ch in set(chans):
                if ch.options.connection_type == "single":
                    # dial before the threads start: shared channels
                    # that dial at once each connect, and the map keeps
                    # one (brpc_tpu's socket map does the same)
                    ch.device_lane_kind()
            fa.reset_launches()
            steps0 = gs.batcher.decode_steps
            r = _turn(chans, calls, oracle, what)
            open_rows = sum(1 for row in connections_page(server)
                            ["connections"] if not row["failed"])
            for ch in set(chans):
                ch.close()
            _sync(dev)
            steps = gs.batcher.decode_steps - steps0
            check(fa.launches["flash_decode"] == steps > 0,
                  f"{what}: flash_decode {dict(fa.launches)}, {steps} "
                  f"steps")
            launched += steps
            if rnd == "warm-up":
                continue
            r.update(accepted=accepted[0] - n0, open_at_end=open_rows,
                     flash_decode=steps, round=rnd)
            lo, hi = want[name]
            check(lo <= r["accepted"] <= hi,
                  f"{what}: {r['accepted']} connections accepted")
            check(name == "short" or r["open_at_end"] == r["accepted"],
                  f"{what}: {open_rows} connections open at the end, "
                  f"{r['accepted']} accepted")
            runs[name].append(r)
    finally:
        server.stop()
        server.join(10)

    def over_own(name, key, op):
        return [op(x[key], y[key]) for x, y in zip(runs[name], runs["own"])]
    return {"turn_calls": RING_TURN_CALLS, "rounds": RING_ROUNDS,
            "order": names, "runs": runs,
            "accepted": {k: [r["accepted"] for r in v]
                         for k, v in runs.items()},
            "medians": {k: {m: _median([r[m] for r in v]) for m in
                            ("tokens_per_s", "p50_ms", "p99_ms")}
                        for k, v in runs.items()},
            "tokens_per_s_over_own": {
                k: over_own(k, "tokens_per_s", lambda a, b: a / b)
                for k in ("shared", "pooled", "short")},
            "p50_minus_own_ms": {
                k: over_own(k, "p50_ms", lambda a, b: a - b)
                for k in ("shared", "pooled", "short")},
            "flash_decode": launched}


def _plaintext_refused(sessions: dict) -> dict:
    """(e): a plaintext tpu_std call to each TLS server's port fails;
    its errno."""
    from brpc_tpu_torch.rpc import Channel, ChannelOptions
    out = {}
    for k, (_, port) in sessions.items():
        plain = Channel(f"tcp://127.0.0.1:{port}",
                        ChannelOptions(timeout_ms=2000, max_retry=0))
        try:
            c = plain.call_sync("GenerateService", "Generate",
                                _generate_body(_prompts()[0]))
        finally:
            plain.close()
        check(c.failed(), f"ring e {k}: a plaintext call was answered")
        out[k] = c.error_code
    return out


def _ring_shards(oracle: dict) -> dict:
    """(f): a 2-shard ``--generate`` group with the lane flag in its
    environment (its supervisor's dispatcher is a ring before it forks):
    32 calls over 4 connections a shard answered as the plain path,
    each shard's ring_ticks > 0, a SIGKILLed shard back on a ring of its
    own, and no process left after SIGTERM."""
    import shutil
    import tempfile
    work = tempfile.mkdtemp(prefix="chip-smoke-ring-shards-")
    here = str(Path(__file__).resolve().parent)
    g = _ShardGroup(2, here, work, env=RING_ENV)
    out = {"up_s": g.up_s}
    try:
        by_pid = g.spread(N_CLIENTS // g.shards)
        chans = [c for v in by_pid.values() for c in v]
        prompts = _prompts() * 2
        res, errs, wall = _shard_burst(chans, prompts)
        check(not errs, f"ring f: failed calls {errs[:3]}")
        wrong = [p for p in oracle if res.get(p) != oracle[p]]
        check(not wrong, f"ring f: tokens differ for {wrong}")
        out["calls"] = len(prompts)
        out["tokens_per_s"] = sum(len(t) for t in res.values()) * 2 / wall

        def ticks(i):
            return _settled(lambda: (lambda v: v if v > 0 else None)(
                g.var("ring_ticks", i)))
        out["ring_ticks"] = [ticks(i) for i in range(g.shards)]
        check(all(out["ring_ticks"]), f"ring f: {out['ring_ticks']}")
        def counts(i):
            # the pages come from a shard's dumps, written every 0.1 s:
            # read until its launches and steps come from one dump
            got = _settled(lambda: (lambda c: c if c["flash_decode"] ==
                                    c["decode_steps"] + c["warmup_steps"]
                                    else None)(_shard_counts(g, i)))
            check(got is not None, f"ring f: shard {i}'s launches "
                                   f"{_shard_counts(g, i)}")
            return got
        before = {s["pid"]: s for s in map(counts, range(g.shards))}
        kill = _shards_kill(g, oracle)
        idx = next(i for i in range(g.shards)
                   if g.page(f"/status?shard={i}")["pid"] == kill["new_pid"])
        out["kill"] = kill
        out["new_shard_ring_ticks"] = ticks(idx)
        check(out["new_shard_ring_ticks"],
              f"ring f: the new shard {kill['new_pid']} has no ring ticks")
        # the launches: the shards running now, and the victim's as read
        # before the kill (its last burst's are lost with it)
        after = [counts(i) for i in range(g.shards)]
        out["launches"] = {"before_kill": list(before.values()),
                           "after": after}
        out["flash_decode"] = sum(s["flash_decode"] for s in after) + \
            before[kill["victim"]]["flash_decode"]
    finally:
        d = g.stop()
        err = g.stderr()
        shutil.rmtree(work, ignore_errors=True)
    check(d["rc"] == 0 and not d["left"], f"ring f: stop {d}: {err}")
    out["stop"] = d
    return out


def phase_ring(dev):
    """The ring lane, connection types, ssl:// and the socket pages on the
    card's Generate path. The lane flag is read when a process builds its
    dispatcher, so each lane's server is a process of its own
    (``--client ring_server``); the four (ring and selector, tcp and
    ssl) start together at the phase's start. (a) the probe; (b) Generate
    on the ring lane (unary, stream, HTTP) with (g) the pages read during
    the stream burst; (c) and (e) the four servers in turns of
    RING_TURN_CALLS calls, and the echo shape a lane; (d) connection
    types on this process's server, in turns; (e) also a plaintext call
    to each TLS port, refused; (f) shards on the ring. Each part's
    flash_decode launches equal its decode steps, read from the server
    that decoded them."""
    import shutil
    import tempfile

    from brpc_tpu_torch.serving import TinyDecoder, TinyDecoderConfig
    phase_t0 = time.monotonic()
    cpu_model = TinyDecoder(TinyDecoderConfig(), device="cpu")
    oracle = {p: cpu_model.generate(list(p.encode()), MAX_TOKENS)
              for p in _prompts()}
    out = {"phase": "ring"}
    progress("ring a: probe")
    out["a"] = _ring_probe()
    emit({"phase": "ring", "part": "a", "a": out["a"]})
    certs = tempfile.mkdtemp(prefix="chip-smoke-ring-certs-")
    cert, key = os.path.join(certs, "cert.pem"), os.path.join(certs, "key.pem")
    made = subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
         "-keyout", key, "-out", cert, "-days", "2", "-subj",
         "/CN=localhost"], capture_output=True, text=True, timeout=60)
    check(made.returncode == 0, f"openssl req: {made.stderr[-1000:]}")
    specs = {"ring": (["tcp"], RING_ENV),
             "selector": (["tcp"], SELECTOR_ENV),
             "ssl_ring": (["ssl", cert, key], RING_ENV),
             "ssl_selector": (["ssl", cert, key], SELECTOR_ENV)}
    sessions = {k: _Session(["ring_server", *a], env=e)
                for k, (a, e) in specs.items()}
    launches = 0
    try:
        progress("ring d: connection types")
        out["d"] = _conn_types(dev, oracle)
        launches += out["d"]["flash_decode"]
        emit({"phase": "ring", "part": "d", "d": out["d"]})
        hello = {k: _session_lane(
            s, "RingDispatcher" if "ring" in k else "EventDispatcher", k)
            for k, s in sessions.items()}
        served = {k: (s, hello[k]["port"]) for k, s in sessions.items()}
        first = {k: s.step() for k, s in sessions.items()}
        progress("ring b: Generate on the ring lane")
        out["b"] = _ring_generate(sessions["ring"], hello["ring"]["port"],
                                  oracle)
        out["b"]["lane"] = hello["ring"]["lane"]
        emit({"phase": "ring", "part": "b", "b": out["b"]})
        progress("ring c, e: the lanes and ssl:// in turns")
        turns = _lane_turns(served, oracle)
        out["c"] = {"generate": {k: v for k, v in turns.items()
                                 if k != "ssl_over_tcp"}}
        lanes = ["batch", "selector"] + (
            ["uring"] if out["a"]["forced_uring"] == "ok" else [])
        out["c"]["echo"] = _echo_turns(lanes)
        emit({"phase": "ring", "part": "c", "c": out["c"]})
        out["e"] = {"ssl_over_tcp": turns["ssl_over_tcp"],
                    "plaintext_errno": _plaintext_refused(
                        {k: served[k] for k in ("ssl_ring",
                                                "ssl_selector")})}
        emit({"phase": "ring", "part": "e", "e": out["e"]})
        last = {k: s.step() for k, s in sessions.items()}
        for k in sessions:
            # every launch of a server, its warm-up's included: steps + 1
            check(last[k]["launches"]["flash_decode"] == last[k]["steps"]
                  and first[k]["steps"] == 1,
                  f"ring {k}: {last[k]['launches']} for {last[k]['steps']} "
                  f"steps (warm-up {first[k]['steps']})")
            launches += last[k]["launches"]["flash_decode"]
        status, body = _http_page(hello["ring"]["port"],
                                  "/vars?prefix=flash_decode_launches")
        # "name : value" and the value's sparkline
        check(status == 200 and body.decode().partition(" : ")[2].split()
              [:1] == [str(last["ring"]["launches"]["flash_decode"])],
              f"ring b: /vars flash_decode_launches {body[:80]!r}")
        check(last["ring"]["ring"]["ring_ticks"] > 0 and
              last["ring"]["ring"]["ring_completions"] > 0,
              f"ring b: the server's ring {last['ring']['ring']}")
        names = last["ring"]["threads"]
        check("ring_dispatcher" in names and "event_dispatcher" not in
              names and not _per_connection_threads(names),
              f"ring b: the server's threads {names}")
        out["b"]["server_ring"] = last["ring"]["ring"]
    finally:
        for s in sessions.values():
            s.close()
        shutil.rmtree(certs, ignore_errors=True)
    progress("ring f: shards on the ring")
    out["f"] = _ring_shards(oracle)
    launches += out["f"]["flash_decode"]
    emit({"phase": "ring", "part": "f", "f": out["f"]})
    out["phase_s"] = time.monotonic() - phase_t0
    out["launches"] = {"flash_decode": launches}
    emit({"phase": "ring", "launches": out["launches"],
          "phase_s": out["phase_s"]})
    return out


# ---------------------------------------------------------- phase replay

REPLAY_LOW_SHARE = 0.25         # (b): the low turn's share of phase 3's rps
REPLAY_LOW_S = 5.0              # (b): the low turn's length
REPLAY_HIGH_S = 3.0             # (b): the high turn (2x the rate)'s length
REPLAY_CHECKED = 16             # (b): records re-issued and checked
REPLAY_SEED = 20260803
PRESS_QPS = 400                 # (c): rpc_press's fixed rate, two workers
PRESS_CALLS = 400
PRESS_SIZES = "64:0.5,4096:0.3,30000:0.2"
CHAOS_DELAY_MS = 50             # (d): the delay on the burst's conn 1
CHAOS_DROP_AT = 40              # (d): the byte conn 3 is dropped at
CHAOS_DEADLINE_MS = 30000       # (d): the burst's deadline
STICKY_DEVICE = "cuda:0"        # (f): lane_ab's server's device


def _tiled(records, n: int):
    """``records`` repeated to ``n`` (a corpus of phase 3's 16 calls,
    replayed for seconds)."""
    return [records[i % len(records)] for i in range(n)]


def _write_corpus(path: str, records) -> None:
    from brpc_tpu_torch.traffic.corpus import CorpusWriter
    w = CorpusWriter(path)
    for r in records:
        w.write(r)
    w.close()


def _module_child(argv, what: str, timeout_s: float = 120, env=None,
                  want_rc=0) -> dict:
    """``python3 -m argv...`` from the directory holding the package: its
    exit code (``want_rc`` checked unless None), stdout, stderr and
    wall."""
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", *argv], capture_output=True, text=True,
        timeout=timeout_s, cwd=str(Path(__file__).resolve().parent),
        env=None if env is None else dict(os.environ, **env))
    wall = time.monotonic() - t0
    check(want_rc is None or proc.returncode == want_rc,
          f"{what}: {argv[0]} exited {proc.returncode}: "
          f"{(proc.stdout + proc.stderr)[-2000:]}")
    return {"rc": proc.returncode, "stdout": proc.stdout,
            "stderr": proc.stderr, "wall_s": wall}


def _last_json(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])


def _tool(argv, timeout_s: float = 120) -> dict:
    """``python3 -m brpc_tpu_torch.tools.<tool> ... --json`` from the
    directory holding the package; its last line."""
    return _last_json(_module_child(argv, argv[0], timeout_s)["stdout"])


def _replay_capture(port: int, oracle: dict, work: str) -> dict:
    """(a) Phase 3's unary burst captured at rate 1.0, and the corpus
    viewed with ``rpc_view``: a record a call, all
    ``GenerateService.Generate``; the burst's requests a second. A burst
    before it, uncaptured, pays the server's and this process's first
    uses (alone, the phase builds the native core in it), so that the
    rate is a warm burst's, as phase 3's second burst."""
    from brpc_tpu_torch.traffic import capture
    from brpc_tpu_torch.traffic.corpus import read_corpus
    cold = _burst(port, _prompts(), MAX_TOKENS)
    _check_burst("replay a (cold)", cold[0], cold[1], oracle)
    cdir = os.path.join(work, "capture")
    capture.start_capture(dir=cdir, default_rate=1.0, max_per_second=0)
    try:
        results, errors, wall = _burst(port, _prompts(), MAX_TOKENS)[:3]
    finally:
        capture.stop_capture()
    _check_burst("replay a", results, errors, oracle)
    records = read_corpus(cdir)
    view = _tool(["brpc_tpu_torch.tools.rpc_view", cdir, "--json"])
    check(len(records) == N_REQUESTS and view["records"] == N_REQUESTS and
          view["methods"] == {"GenerateService.Generate": N_REQUESTS},
          f"replay a: {len(records)} records, rpc_view {view}")
    prompts = sorted(json.loads(r.payload)["prompt"] for r in records)
    check(prompts == sorted(_prompts()), "replay a: the corpus's prompts")
    return {"records": records, "rps": N_REQUESTS / wall, "wall_s": wall,
            "cold_wall_s": cold[2], "view": view}


def _replay_turns(port: int, records, rps: float, oracle: dict,
                  work: str) -> dict:
    """(b) ``rpc_replay`` replays the corpus, open-loop at a constant
    qps, in two turns: low (REPLAY_LOW_SHARE of phase 3's rps, for
    REPLAY_LOW_S), then high (twice that, REPLAY_HIGH_S); then
    REPLAY_CHECKED records, chosen with a seed, re-issued through a sync
    Channel, their tokens held against the CPU plain path's."""
    import random

    from brpc_tpu_torch.rpc import Channel, ChannelOptions
    out = {"phase3_rps": rps}
    addr = f"tcp://127.0.0.1:{port}"
    for name, qps, secs in (("low", REPLAY_LOW_SHARE * rps, REPLAY_LOW_S),
                            ("high", 2 * REPLAY_LOW_SHARE * rps,
                             REPLAY_HIGH_S)):
        n = max(N_REQUESTS, int(round(qps * secs)))
        path = os.path.join(work, f"replay-{name}.brpccap")
        _write_corpus(path, _tiled(records, n))
        rep = _tool(["brpc_tpu_torch.tools.rpc_replay", path, addr,
                     "--mode", "qps", "--qps", repr(qps), "--conns", "4",
                     "--json"], timeout_s=secs + 120)
        check(rep["records"] == rep["issued"] == n and
              rep["ok"] + rep["fail"] == n and not rep["undrained"],
              f"replay b {name}: {n} records, report {rep}")
        if name == "low":
            check(rep["ok"] == n, f"replay b low: {rep['fail']} failed: "
                                  f"{rep['classes']}")
        cls = rep["classes"]["GenerateService.Generate|p0"]
        out[name] = {"qps": qps, "records": n, "issued": rep["issued"],
                     "ok": rep["ok"], "fail": rep["fail"],
                     "error_codes": cls["error_codes"],
                     "p50_ms": cls["p50_ms"], "p99_ms": cls["p99_ms"],
                     "behind_ms_max": rep["behind_ms_max"],
                     "fidelity_pct": rep["fidelity_pct"],
                     "elapsed_s": rep["elapsed_s"]}
    lo, hi = out["low"], out["high"]
    # reported, not checked: the high turn runs at half the closed-loop
    # rate, below where the server must shed or queue
    out["latency_or_sheds_rose"] = bool(
        hi["fail"] > lo["fail"] or (hi["p50_ms"] or 0) > (lo["p50_ms"] or 0))
    rng = random.Random(REPLAY_SEED)
    picked = rng.sample(range(len(records)), REPLAY_CHECKED)
    ch = Channel(addr, ChannelOptions(timeout_ms=120000,
                                      share_connections=False))
    try:
        for i in picked:
            p = json.loads(records[i].payload)["prompt"]
            c = ch.call_sync("GenerateService", "Generate",
                             records[i].payload)
            check(not c.failed() and
                  json.loads(c.response)["tokens"] == oracle[p],
                  f"replay b: record {i} ({p!r}): {c.error_text}")
    finally:
        ch.close()
    out["checked"] = len(picked)
    return out


def _press_echo(work: str) -> dict:
    """(c) ``rpc_press`` at PRESS_QPS with a size mix, two worker
    processes, at the port's echo method (``native="echo"``, served by
    the C echo loop): the merged counts equal the calls, and the server
    handled what the workers counted as answered."""
    from brpc_tpu_torch.rpc import Server, Service
    svc = Service("Bench")
    svc.register_method("Echo", lambda cntl, req: req, native="echo")
    server = Server()
    server.add_service(svc)
    port = server.start("tcp://127.0.0.1:0").port
    try:
        rep = _tool(["brpc_tpu_torch.tools.rpc_press",
                     f"tcp://127.0.0.1:{port}", "Bench", "Echo",
                     "--qps", str(PRESS_QPS), "--count", str(PRESS_CALLS),
                     "--size-mix", PRESS_SIZES, "--procs", "2", "--json"])
        served = server.method_status["Bench.Echo"].count()
    finally:
        server.stop()
        server.join(10)
    check(rep["workers"] == 2 and rep["dead_workers"] == 0 and
          rep["records"] == rep["issued"] == PRESS_CALLS and
          rep["ok"] + rep["fail"] == PRESS_CALLS and rep["ok"] == served,
          f"replay c: press {rep}, the server served {served}")
    return {k: rep[k] for k in ("workers", "records", "issued", "ok", "fail",
                                "behind_ms_max", "fidelity_pct",
                                "elapsed_s", "per_method")} | {
        "served": served, "classes": {
            k: {m: v[m] for m in ("ok", "fail", "p50_ms", "p99_ms")}
            for k, v in rep["classes"].items()}}


def _live_client_sockets() -> int:
    from brpc_tpu_torch.transport.socket import socket_census_rows
    return sum(1 for s, _, _ in socket_census_rows(0)
               if s.user_data.get("channel") is not None)


def _chaos_burst(port: int, oracle: dict) -> dict:
    """(d) A FaultPlan with a ``delay`` (conn 1) and a ``drop`` (conn 3)
    on tcp installed while phase 3's burst runs through plain Channels:
    the ``chaos_injected_*`` counters on /connections move as the plan
    says, every call ends (OK or an error code) inside its deadline, and
    after ``uninstall`` no socket, fiber, attempt or lease is left."""
    from brpc_tpu_torch import chaos
    from brpc_tpu_torch.chaos import Fault, FaultPlan
    from brpc_tpu_torch.fiber import global_control
    from brpc_tpu_torch.rpc import client_dispatch
    from brpc_tpu_torch.transport.socket_map import global_socket_map
    addr = f"tcp://127.0.0.1:{port}"

    def pane():
        status, body = _http_page(port, "/connections")
        check(status == 200, f"replay d: /connections {status}")
        return json.loads(body)["robustness"]
    before = pane()
    leases = global_socket_map().leases()
    socks = _live_client_sockets()
    fibers = global_control().nfibers.get_value()
    plan = (FaultPlan(seed=REPLAY_SEED)
            .at(addr, 1, Fault("delay", at_byte=5,
                               delay_ms=CHAOS_DELAY_MS))
            .at(addr, 3, Fault("drop", at_byte=CHAOS_DROP_AT)))
    chaos.install(plan)
    try:
        t0 = time.monotonic()
        results, errors, wall, lat = _burst(
            port, _prompts(), MAX_TOKENS, timeout_ms=CHAOS_DEADLINE_MS)[:4]
    finally:
        chaos.uninstall()
    check(chaos.installed_plan() is None, "replay d: the plan stayed")
    check(len(results) + len(errors) == N_REQUESTS and
          time.monotonic() - t0 < CHAOS_DEADLINE_MS / 1e3 + 5,
          f"replay d: {len(results)} answered, {len(errors)} failed, in "
          f"{time.monotonic() - t0:.1f} s")
    wrong = [p for p in results if results[p] != oracle[p]]
    check(not wrong, f"replay d: tokens differ for {wrong}")
    after = pane()
    moved = {k: after[k] - before.get(k, 0) for k in after
             if k.startswith("chaos_injected_")
             and after[k] != before.get(k, 0)}
    check(moved == {"chaos_injected_delay": 1, "chaos_injected_drop": 1},
          f"replay d: chaos counters moved {moved}, fired {plan.fired()}")
    check(_wait_for_value(lambda: (global_socket_map().leases(),
                                   _live_client_sockets(),
                                   client_dispatch.inflight_attempts()),
                          (leases, socks, 0), 10.0),
          f"replay d: left over: leases {global_socket_map().leases()} "
          f"(was {leases}), client sockets {_live_client_sockets()} (was "
          f"{socks}), attempts {client_dispatch.inflight_attempts()}")
    check(_wait_for_value(lambda: global_control().nfibers.get_value()
                          <= fibers, True, 10.0),
          f"replay d: fibers {global_control().nfibers.get_value()}, were "
          f"{fibers}")
    return {"answered": len(results), "failed": len(errors),
            "error_codes": sorted({e[1] for e in errors}),
            "wall_s": wall, "p50_ms": _median(lat), "p99_ms": _p99(lat),
            "fired": [list(f) for f in plan.fired()], "counters": moved}


def _storm_artifact(prompts, oracle, window_oracle, gss,
                    work: str) -> str:
    """An incident artifact from phase ``incident``'s shed storm (its
    part (c)), for ``--phase replay`` alone, written under ``work``;
    the artifact's path."""
    import brpc_tpu_torch.incident.manager  # noqa: F401  (its flags)
    tmp = os.path.join(work, "incident")
    os.makedirs(tmp)
    old = _flags_set(dict(INCIDENT_FLAGS, incident_dir=tmp))
    try:
        return _incident_storm(prompts, oracle, window_oracle, gss)[
            "artifact_path"]
    finally:
        _flags_set(old)


def _incident_replays(path: str, gss) -> dict:
    """(e) The artifact replayed by ``incident/replay.py`` against fresh
    Generate servers on the card, shaped as the incident's (its
    concurrency limit): under its pressure the watchdog fires again on
    the same key; without it, at 0.5x the load, it stays quiet. A shed
    storm's pressure is an open-loop press; no byte fault can make a
    server shed (``build_fault_plan`` gives none)."""
    from brpc_tpu_torch.incident.artifact import read_artifact
    from brpc_tpu_torch.incident.replay import (build_fault_plan,
                                                derive_repro,
                                                replay_incident)
    from brpc_tpu_torch.rpc import Server, ServerOptions
    from brpc_tpu_torch.serving import add_generate_service
    art = read_artifact(path)
    sat = (art["snapshots"].get("status") or {}).get("saturation") or {}
    limit = int(sat.get("concurrency_limit") or 2)
    shape = derive_repro(art["meta"])
    check(shape["press"] and build_fault_plan(
        shape, "tcp://127.0.0.1:1") is None,
          f"replay e: a shed storm's shape {shape}")
    servers = []

    def factory():
        server = Server(ServerOptions(max_concurrency=limit))
        gs = add_generate_service(server)
        check(str(gs.device) == "cuda:0", f"service device {gs.device}")
        gss.append(gs)
        servers.append(server)
        port = server.start("tcp://127.0.0.1:0").port
        return server, f"tcp://127.0.0.1:{port}"
    out = {"concurrency_limit": limit, "keys": art["meta"].get("keys"),
           "corpus_records": len(art["corpus"])}
    try:
        for name, use_plan in (("refire", True), ("quiet", False)):
            rep = replay_incident(path, use_plan=use_plan, seed=11,
                                  server_factory=factory)
            servers[-1].stop()
            servers[-1].join(10)
            want = use_plan
            check(rep["ok"] and rep["refired"] == want,
                  f"replay e {name}: refired {rep.get('refired')}, report "
                  f"{rep}")
            if want:
                check("server_limit_shed" in str(rep.get("matched_key")),
                      f"replay e: matched {rep.get('matched_key')}")
            else:
                check(rep["replay"]["fail"] == 0,
                      f"replay e quiet: {rep['replay']}")
            out[name] = {k: rep.get(k) for k in (
                "refired", "matched_key", "incidents_opened", "work_ms")}
            out[name]["replay"] = rep["replay"]
    finally:
        for server in servers:
            server.stop()
            server.join(10)
    return out


def _sticky_turns() -> dict:
    """(f) ``rpc/lane_ab.py --held``: phase 3's unary client on held
    connections, its process on the selector and on the ring's batch
    backend, two rounds: a steady sync call pauses and resumes no reads
    and fences no tick; first-call and later-call p50."""
    out = subprocess.run(
        [sys.executable, "-m", "brpc_tpu_torch.rpc.lane_ab", "--held",
         "--rounds", "2", "--device", STICKY_DEVICE], capture_output=True,
        text=True, timeout=400,
        cwd=str(Path(__file__).resolve().parent))
    check(out.returncode == 0, f"replay f: lane_ab --held: "
                               f"{(out.stdout + out.stderr)[-2000:]}")
    rows = [json.loads(ln) for ln in out.stdout.strip().splitlines()]
    turns = [r for r in rows if "turn" in r]
    check(len(turns) == 4, f"replay f: {len(turns)} turns")
    for t in turns:
        st = t["steady"]
        check(st["pause_read"] == st["resume_read"] == 0 and
              st["ring_barrier_waits"] == st["ring_read_barriers"] == 0 and
              st["plucked"] == t["later_calls"] > 0,
              f"replay f: {t['variant']} steady state {st}")
        if t["variant"] == "held_batch":
            check(t["lane"] == ["RingDispatcher", "batch"],
                  f"replay f: the batch client ran on {t['lane']}")
    return {"turns": turns, "medians": rows[-1]["medians"]}


def phase_replay(dev, artifact=None):
    """Capture, replay and press on the card's Generate path: (a) phase
    3's unary burst captured and viewed; (b) ``rpc_replay`` open-loop at
    a constant qps against a fresh Generate server, low then high, and
    records re-issued and held against the CPU plain path; (c)
    ``rpc_press`` with two workers; (d) chaos during phase 3's burst;
    (e) an incident artifact (phase ``incident``'s, else one made here
    by the same storm) replayed with and without its pressure; (f) the
    sticky pause in ``lane_ab --held`` turns. Launch counts zeroed
    before each Generate part and read after it: ``flash_decode``'s
    equal to the part's decode steps and warm-ups."""
    import shutil
    import tempfile

    from brpc_tpu_torch.rpc import Server
    from brpc_tpu_torch.serving import (TinyDecoder, TinyDecoderConfig,
                                        add_generate_service)
    fa = _fa_module()
    phase_t0 = time.monotonic()
    prompts = _prompts()
    cpu_model = TinyDecoder(TinyDecoderConfig(), device="cpu")
    oracle = {p: cpu_model.generate(list(p.encode()), MAX_TOKENS)
              for p in prompts}
    launches, out, gss = {}, {}, []

    def counted(part, fn, *args):
        progress(f"replay {part}")
        fa.reset_launches()
        before = sum(g.batcher.decode_steps + g.engine.warmup_steps
                     for g in gss)
        r = fn(*args)
        _sync(dev)
        got = dict(fa.launches)
        steps = sum(g.batcher.decode_steps + g.engine.warmup_steps
                    for g in gss) - before
        launches[part] = dict(got, steps=steps)
        check(got["flash_decode"] == steps > 0 and
              sum(got.values()) == got["flash_decode"],
              f"replay {part}: launched {got}, {steps} decode steps and "
              f"warm-ups")
        return r

    def start():
        server = Server()
        gss.append(add_generate_service(server))
        check(str(gss[-1].device) == "cuda:0",
              f"service device {gss[-1].device}")
        return server, server.start("tcp://127.0.0.1:0").port
    work = tempfile.mkdtemp(prefix="replay-smoke-")
    servers = []
    try:
        def part_a():
            server, port = start()
            servers.append(server)
            return _replay_capture(port, oracle, work)
        cap = counted("a_capture", part_a)
        servers[0].stop()
        servers[0].join(10)
        out["a"] = {k: cap[k] for k in ("rps", "wall_s", "cold_wall_s",
                                        "view")}
        emit({"phase": "replay", "part": "a", "a": out["a"]})

        def part_b():
            server, port = start()
            servers.append(server)
            return port, _replay_turns(port, cap["records"], cap["rps"],
                                       oracle, work)
        port_b, out["b"] = counted("b_replay", part_b)
        emit({"phase": "replay", "part": "b", "b": out["b"]})
        progress("replay c")
        out["c"] = _press_echo(work)
        emit({"phase": "replay", "part": "c", "c": out["c"]})
        out["d"] = counted("d_chaos", _chaos_burst, port_b, oracle)
        emit({"phase": "replay", "part": "d", "d": out["d"]})
        servers[1].stop()
        servers[1].join(10)
        if artifact is None:
            window_oracle = {
                p: cpu_model.generate(list(p.encode()), MAX_TOKENS)
                for p in (f"in-window {j}: {prompts[j]}"
                          for j in range(INCIDENT_IN_WINDOW))}
            artifact = counted("e_storm", _storm_artifact, prompts, oracle,
                               window_oracle, gss, work)
        out["e"] = counted("e_incident_replay", _incident_replays,
                           artifact, gss)
        emit({"phase": "replay", "part": "e", "e": out["e"]})
        progress("replay f")
        out["f"] = _sticky_turns()
        emit({"phase": "replay", "part": "f", "f": out["f"]})
    finally:
        for server in servers:
            server.stop()
            server.join(10)
        shutil.rmtree(work, ignore_errors=True)
    out["phase_s"] = time.monotonic() - phase_t0
    out["launches"] = launches
    emit({"phase": "replay", "launches": launches,
          "phase_s": out["phase_s"]})
    return out


# ------------------------------------------------------------- phase h2

H2_CHANNELS = 4                 # (a): gRPC channels the burst shares
H2_ECHO_SIZES = (1 << 20, 4 << 20)      # (c): gRPC echo payloads
H2_TIMEOUT_S = 0.05             # (c): the call's timeout,
H2_SLEEP_S = 0.2                # (c): against a handler that sleeps this
H2_TOKEN = "h2-secret"          # (d): the auth server's token
H2_TURN_CALLS = 256             # (e): gRPC Generate calls in a turn
H2_PRESS_QPS = 400              # (f): rpc_press --protocol http's rate,
H2_PRESS_CALLS = 400            # its calls, over two workers of
H2_PRESS_CONNS = 4              # this many connections each


def _grpc_burst(port: int, prompts, chans: int = H2_CHANNELS):
    """Phase 3's burst as unary gRPC Generate calls: N_CLIENTS threads
    on ``chans`` GrpcChannels (thread i on channel i % chans), the
    prompts dealt round-robin; as ``_burst``'s (results, errors, wall,
    client ms a call)."""
    from brpc_tpu_torch.protocol.h2 import GrpcChannel
    channels = [GrpcChannel(f"tcp://127.0.0.1:{port}")
                for _ in range(chans)]
    results, errors, latency = {}, [], []

    def client(idx):
        ch = channels[idx % chans]
        for p in prompts[idx::N_CLIENTS]:
            t0 = time.perf_counter()
            c = ch.call("/GenerateService/Generate", _generate_body(p),
                        timeout=120)
            if not c.ok():
                errors.append((p, c.status, c.message))
                continue
            latency.append((time.perf_counter() - t0) * 1e3)
            results[p] = json.loads(c.response)["tokens"]
    try:
        wall = _run_clients(client)
        # the server names the protocol each connection settled on
        rows = json.loads(_http_page(port, "/connections")[1])[
            "connections"]
    finally:
        for ch in channels:
            ch.close()
    return results, errors, wall, latency, sorted(r["protocol"]
                                                  for r in rows)


def _h2_client_bursts(port: int, prompts) -> dict:
    """(b): the burst over HTTP/1.1 through the port's HttpClient, the
    chunked body read with ``on_chunk``, and over plain h2
    (``Http2Client``, one answer a call); a connection a client thread
    for both."""
    from brpc_tpu_torch.protocol.h2 import Http2Client
    from brpc_tpu_torch.protocol.http_client import HttpClient
    out = {}
    want_footer = b"completed n=%d" % MAX_TOKENS
    for kind in ("http1_progressive", "h2_plain"):
        results, errors, latency, parts = {}, [], [], []

        def client(idx, kind=kind):
            addr = f"tcp://127.0.0.1:{port}"
            cl = HttpClient(addr, timeout_s=120) \
                if kind == "http1_progressive" else Http2Client(addr)
            try:
                for p in prompts[idx::N_CLIENTS]:
                    t0 = time.perf_counter()
                    if kind == "h2_plain":
                        r = cl.request("POST", "/GenerateService/Generate",
                                       body=_generate_body(p), timeout=120)
                        if r.status != 200:
                            errors.append((p, r.status, r.body[:200]))
                            continue
                        results[p] = json.loads(r.body)["tokens"]
                    else:
                        chunks = []
                        status, _, _ = cl.post(
                            "/GenerateService/Generate", _generate_body(p),
                            on_chunk=chunks.append)
                        toks, _, footer = b"".join(chunks).rpartition(b"\n#")
                        if status != 200 or footer != want_footer:
                            errors.append((p, status, footer))
                            continue
                        results[p] = list(toks)
                        parts.append(len(chunks))
                    latency.append((time.perf_counter() - t0) * 1e3)
            finally:
                cl.close()
        wall = _run_clients(client)
        out[kind] = (results, errors, wall, latency, parts)
    return out


def _h2_echo_server(auth: bool = False):
    """A server of this process with ``Bench.Echo`` and ``Bench.Sleep``
    (sleeps H2_SLEEP_S in its fiber, then echoes); ``auth``: behind a
    token Authenticator. (server, port, handler calls)."""
    from brpc_tpu_torch import fiber
    from brpc_tpu_torch.rpc import (Server, ServerOptions, Service,
                                    TokenAuthenticator)
    calls = []
    svc = Service("Bench")

    def Echo(cntl, request):
        calls.append(len(request))
        return bytes(request)

    async def Sleep(cntl, request):
        await fiber.sleep(H2_SLEEP_S)
        return bytes(request)
    svc.register_method("Echo", Echo)
    svc.register_method("Sleep", Sleep)
    server = Server(ServerOptions(
        auth=TokenAuthenticator(H2_TOKEN) if auth else None))
    server.add_service(svc)
    return server, server.start("tcp://127.0.0.1:0").port, calls


def _h2_flow_and_deadline() -> dict:
    """(c): 1 MiB and 4 MiB gRPC echoes through the flow-control windows
    on one channel, the WINDOW_UPDATE frames each sent and received, and
    a call with a H2_TIMEOUT_S timeout against a handler that sleeps
    H2_SLEEP_S: DEADLINE_EXCEEDED, answered at the deadline."""
    from brpc_tpu_torch.protocol import h2
    server, port, _ = _h2_echo_server()
    out = {}
    try:
        with h2.GrpcChannel(f"tcp://127.0.0.1:{port}") as ch:
            for size in H2_ECHO_SIZES:
                body = os.urandom(size)
                ch.call("/Bench/Echo", b"warm")
                s = ch._session
                sent0, recv0 = s.window_updates_sent, \
                    s.window_updates_received
                t0 = time.perf_counter()
                c = ch.call("/Bench/Echo", body, timeout=60)
                ms = (time.perf_counter() - t0) * 1e3
                check(c.ok() and c.response == body,
                      f"h2 c: {size} B echo: {c.status} {c.message}")
                out[f"echo_{size}"] = {
                    "ms": ms, "mb_per_s": 2 * size / ms / 1e3,
                    "window_updates_sent": s.window_updates_sent - sent0,
                    "window_updates_received": (s.window_updates_received
                                                - recv0)}
                check(out[f"echo_{size}"]["window_updates_sent"] > 0 and
                      out[f"echo_{size}"]["window_updates_received"] > 0,
                      f"h2 c: {size} B echo moved no window: "
                      f"{out[f'echo_{size}']}")
            t0 = time.perf_counter()
            c = ch.call("/Bench/Sleep", b"late", timeout=H2_TIMEOUT_S)
            ms = (time.perf_counter() - t0) * 1e3
            check(c.status == h2.GRPC_DEADLINE_EXCEEDED,
                  f"h2 c: a {H2_TIMEOUT_S} s timeout against a "
                  f"{H2_SLEEP_S} s handler answered {c.status} {c.message}")
            out["deadline"] = {"status": c.status, "message": c.message,
                               "ms": ms}
    finally:
        server.stop()
        server.join(10)
    return out


def _h2_auth() -> dict:
    """(d): a server with a token Authenticator: a gRPC call without the
    credential answers UNAUTHENTICATED and its handler does not run;
    with ``authorization: Bearer <token>`` it answers OK."""
    from brpc_tpu_torch.protocol import h2
    server, port, calls = _h2_echo_server(auth=True)
    try:
        with h2.GrpcChannel(f"tcp://127.0.0.1:{port}") as ch:
            refused = ch.call("/Bench/Echo", b"no credential")
            ran = len(calls)
        with h2.GrpcChannel(f"tcp://127.0.0.1:{port}") as ch:
            ok = ch.call("/Bench/Echo", b"token",
                         metadata=[("authorization", f"Bearer {H2_TOKEN}")])
    finally:
        server.stop()
        server.join(10)
    check(refused.status == h2.GRPC_UNAUTHENTICATED and ran == 0,
          f"h2 d: without the credential: status {refused.status}, "
          f"{ran} handler calls")
    check(ok.ok() and ok.response == b"token" and len(calls) == 1,
          f"h2 d: with the token: {ok.status} {ok.message}")
    return {"refused_status": refused.status,
            "refused_message": refused.message,
            "handler_calls_refused": ran, "token_status": ok.status}


def _grpc_turn(chans, calls: int, oracle: dict, what: str) -> dict:
    """``calls`` gRPC Generate calls from N_CLIENTS threads, thread i on
    ``chans[i]``, the oracle's prompts in turn; every answer equal to
    the CPU plain path's. Tokens/s, the call's p50/p99/max."""
    prompts = list(oracle)
    lat, errors, tokens = [], [], []

    def client(i):
        for n in range(i, calls, N_CLIENTS):
            p = prompts[n % len(prompts)]
            t0 = time.perf_counter()
            c = chans[i].call("/GenerateService/Generate", _generate_body(p),
                              timeout=120)
            if not c.ok():
                errors.append((p, c.status, c.message))
                continue
            lat.append((time.perf_counter() - t0) * 1e3)
            got = json.loads(c.response)["tokens"]
            if got != oracle[p]:
                errors.append((p, -1, "tokens differ from the CPU plain "
                                      "path"))
            tokens.append(len(got))
    wall = _run_clients(client)
    check(not errors, f"{what}: {len(errors)} of {calls} calls failed or "
                      f"wrong: {errors[:3]}")
    return {"calls": calls, "wall_s": wall,
            "tokens_per_s": sum(tokens) / wall, "p50_ms": _median(lat),
            "p99_ms": _p99(lat), "max_ms": max(lat)}


def _h2_tls_turns(oracle: dict) -> dict:
    """(e): a Generate server on cuda:0 a process (``--client ring_server
    tcp|ssl``, the selector lane), N_CLIENTS held GrpcChannels to each
    from this process; a warm-up of N_REQUESTS calls, then one turn of
    H2_TURN_CALLS gRPC calls a server. Each turn: tokens/s, p50/p99/max,
    the server's CPU a call and busiest threads, its flash_decode
    launches equal to its decode steps. TLS's CPU a call at
    RING_SSL_CPU_RATIO times tcp's or more fails, with both servers'
    busiest threads."""
    import shutil
    import tempfile

    from brpc_tpu_torch.protocol.h2 import GrpcChannel
    certs = tempfile.mkdtemp(prefix="chip-smoke-h2-certs-")
    cert, key = os.path.join(certs, "cert.pem"), os.path.join(certs, "key.pem")
    made = subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
         "-keyout", key, "-out", cert, "-days", "2", "-subj",
         "/CN=localhost"], capture_output=True, text=True, timeout=60)
    check(made.returncode == 0, f"h2 e: openssl req: {made.stderr[-1000:]}")
    sessions = {"tcp": _Session(["ring_server", "tcp"], env=SELECTOR_ENV),
                "ssl": _Session(["ring_server", "ssl", cert, key],
                                env=SELECTOR_ENV)}
    chans = {}
    out = {}
    try:
        hello = {k: _session_lane(s, "EventDispatcher", f"h2 e {k}")
                 for k, s in sessions.items()}
        first = {k: s.step() for k, s in sessions.items()}
        chans = {k: [GrpcChannel(f"{k}://127.0.0.1:{hello[k]['port']}")
                     for _ in range(N_CLIENTS)] for k in sessions}
        for k in sessions:
            _counted_turn(f"h2 e {k} warm-up", sessions[k], _grpc_turn,
                          chans[k], N_REQUESTS, oracle, f"h2 e {k} warm-up")
        for k in sessions:
            r, d = _counted_turn(f"h2 e {k}", sessions[k], _grpc_turn,
                                 chans[k], H2_TURN_CALLS, oracle,
                                 f"h2 e {k}")
            out[k] = dict(r, server_cpu_ms_per_call=d["cpu_ms_per_call"],
                          server_syscalls_per_rpc=d["syscalls_per_rpc"],
                          server_threads_cpu_s=d["thread_cpu_s"],
                          server_steps=d["steps"],
                          server_flash_decode=d["flash_decode"])
        last = {k: s.step() for k, s in sessions.items()}
    finally:
        for v in chans.values():
            for ch in v:
                ch.close()
        for s in sessions.values():
            s.close()
        shutil.rmtree(certs, ignore_errors=True)
    tls, tcp = out["ssl"], out["tcp"]
    check(tls["server_cpu_ms_per_call"] < RING_SSL_CPU_RATIO *
          tcp["server_cpu_ms_per_call"],
          f"h2 e: the TLS server took {tls['server_cpu_ms_per_call']:.2f} "
          f"ms CPU a gRPC call against tcp's "
          f"{tcp['server_cpu_ms_per_call']:.2f}; TLS threads "
          f"{tls['server_threads_cpu_s']}, tcp threads "
          f"{tcp['server_threads_cpu_s']}")
    launches = 0
    for k in sessions:
        # every launch of a server, its warm-up's included: steps + 1
        check(last[k]["launches"]["flash_decode"] == last[k]["steps"] and
              first[k]["steps"] == 1,
              f"h2 e {k}: {last[k]['launches']} for {last[k]['steps']} "
              f"steps (warm-up {first[k]['steps']})")
        launches += last[k]["launches"]["flash_decode"]
    out["ssl_over_tcp_cpu"] = (tls["server_cpu_ms_per_call"]
                               / tcp["server_cpu_ms_per_call"])
    out["flash_decode"] = launches
    return out


def _h2_press(port: int, served_before: int, server) -> dict:
    """(f): ``rpc_press --protocol http`` with two workers, H2_PRESS_CALLS
    calls at H2_PRESS_QPS against the Generate server's HTTP path: every
    call OK, and the merged count the server's."""
    rep = _tool(["brpc_tpu_torch.tools.rpc_press",
                 f"tcp://127.0.0.1:{port}", "GenerateService", "Generate",
                 "--protocol", "http", "--qps", str(H2_PRESS_QPS),
                 "--count", str(H2_PRESS_CALLS), "--conns",
                 str(H2_PRESS_CONNS), "--procs", "2", "--timeout-ms",
                 "60000", "--json"], timeout_s=300)
    served = server.method_status["GenerateService.Generate"].count() \
        - served_before
    check(rep["workers"] == 2 and rep["dead_workers"] == 0 and
          rep["records"] == rep["issued"] == rep["ok"] == H2_PRESS_CALLS
          and rep["ok"] == served,
          f"h2 f: press {rep}, the server served {served}")
    cls = rep["classes"]["GenerateService.Generate|p0"]
    return {"records": rep["records"], "ok": rep["ok"], "fail": rep["fail"],
            "served": served, "elapsed_s": rep["elapsed_s"],
            "achieved_qps": rep["ok"] / rep["elapsed_s"],
            "behind_ms_max": rep["behind_ms_max"],
            "p50_ms": cls["p50_ms"], "p99_ms": cls["p99_ms"]}


def phase_h2(dev):
    """Generate over gRPC, HTTP/2 and the port's HTTP/1.1 client on the
    card: (a) phase 3's burst as unary gRPC calls on H2_CHANNELS
    GrpcChannels, cold, then warm; (b) the burst over HTTP/1.1 with ``on_chunk`` reads
    and over plain h2; (c) 1 MiB and 4 MiB gRPC echoes through flow
    control and a timeout against a slower handler; (d) the gRPC auth
    gate; (e) gRPC turns over tcp:// and ssl:// against servers in child
    processes, CPU a call; (f) ``rpc_press --protocol http``. Every
    Generate answer equal to the CPU plain path's; this process's
    server's flash_decode launches (zeroed before it starts, read after
    (f)) equal to its decode steps plus its warm-up, as (e)'s servers'
    are."""
    from brpc_tpu_torch.protocol import h2 as h2mod
    from brpc_tpu_torch.rpc import Server
    from brpc_tpu_torch.serving import (TinyDecoder, TinyDecoderConfig,
                                        add_generate_service)
    fa = _fa_module()
    phase_t0 = time.monotonic()
    prompts = _prompts()
    cpu_model = TinyDecoder(TinyDecoderConfig(), device="cpu")
    oracle = {p: cpu_model.generate(list(p.encode()), MAX_TOKENS)
              for p in prompts}
    out = {"phase": "h2"}
    fa.reset_launches()
    server = Server()
    gs = add_generate_service(server)
    check(str(gs.device) == "cuda:0", f"service device {gs.device}")
    port = server.start("tcp://127.0.0.1:0").port
    try:
        progress("h2 a: gRPC burst")
        # a first burst pays this process's first uses (alone, the phase
        # builds the native core in it), so that the second is warm
        cold = _grpc_burst(port, prompts)
        _check_burst("h2 a (cold)", cold[0], cold[1], oracle)
        results, errors, wall, lat, protos = _grpc_burst(port, prompts)
        _check_burst("h2 a", results, errors, oracle)
        check(protos.count("h2") == H2_CHANNELS,
              f"h2 a: /connections names {protos}")
        out["a"] = {"cold_wall_s": cold[2], "wall_s": wall,
                    "p50_ms": _median(lat),
                    "p99_ms": _p99(lat), "channels": H2_CHANNELS,
                    "grpc_calls_on_status": server.method_status[
                        "GenerateService.Generate"].count()}
        check(out["a"]["grpc_calls_on_status"] == 2 * N_REQUESTS,
              f"h2 a: /status counts {out['a']['grpc_calls_on_status']} "
              f"Generate calls")
        emit({"phase": "h2", "part": "a", "a": out["a"],
              "connection_protocols": protos})
        progress("h2 b: HTTP/1.1 progressive and plain h2 bursts")
        out["b"] = {}
        for kind, (res, errs, wall, lat, parts) in _h2_client_bursts(
                port, prompts).items():
            _check_burst(f"h2 b {kind}", res, errs, oracle)
            out["b"][kind] = {"wall_s": wall, "p50_ms": _median(lat),
                              "p99_ms": _p99(lat)}
            if parts:
                # a body read progressively: every token its own part
                check(min(parts) > 1, f"h2 b: {kind} parts {parts[:4]}")
                out["b"][kind]["parts_min"] = min(parts)
        emit({"phase": "h2", "part": "b", "b": out["b"]})
        progress("h2 c: flow control and a deadline")
        out["c"] = _h2_flow_and_deadline()
        emit({"phase": "h2", "part": "c", "c": out["c"]})
        progress("h2 d: the gRPC auth gate")
        out["d"] = _h2_auth()
        emit({"phase": "h2", "part": "d", "d": out["d"]})
        progress("h2 f: rpc_press --protocol http")
        served = server.method_status["GenerateService.Generate"].count()
        out["f"] = _h2_press(port, served, server)
        emit({"phase": "h2", "part": "f", "f": out["f"]})
        _sync(dev)
        got = dict(fa.launches)
        steps = gs.batcher.decode_steps + gs.engine.warmup_steps
        check(got["flash_decode"] == steps > 0 and
              sum(got.values()) == got["flash_decode"],
              f"h2: launched {got}, {steps} decode steps and warm-ups")
        out["server"] = {"flash_decode": got["flash_decode"],
                         "steps": steps}
    finally:
        server.stop()
        server.join(10)
    check(h2mod.live_channels() == 0,
          f"h2: {h2mod.live_channels()} gRPC channels left open")
    progress("h2 e: gRPC over tcp:// and ssl:// in turns")
    out["e"] = _h2_tls_turns(oracle)
    emit({"phase": "h2", "part": "e", "e": out["e"]})
    out["phase_s"] = time.monotonic() - phase_t0
    out["launches"] = {"flash_decode": out["server"]["flash_decode"]
                       + out["e"]["flash_decode"]}
    emit({"phase": "h2", "launches": out["launches"],
          "server": out["server"], "phase_s": out["phase_s"]})
    return out


# ------------------------------------------------------- phase protocols

PROTO_VARIANTS = ("hulu_pbrpc", "sofa_pbrpc")
PROTO_ATT_SIZES = (4, 64 << 10, 4 << 20)   # (b): attachment echoes
PROTO_ATT_CALLS = 5                     # (b): timed echoes a size
PROTO_THRIFT_CALLS = 1000               # (c): pipelined call_async
PROTO_THRIFT_SERIAL = 200               # (c): one call at a time
PROTO_REDIS_CMDS = 1000                 # (d): the SET/GET pipeline
PROTO_REDIS_THREADS = 8                 # (d): threads on one client
PROTO_REDIS_THREAD_CMDS = 50            # (d): commands a thread
PROTO_TOKEN = "protocols-secret"        # (g): the auth server's token


def _thrift_service(calls: list):
    """Echo, Add and Notify (oneway) of phase protocols' thrift server;
    ``calls`` gets each handler run's method."""
    from brpc_tpu_torch.protocol import thrift as th
    svc = th.ThriftService()

    @svc.method("Echo")
    def echo(sock, args):
        calls.append("Echo")
        return {0: th.TVal(th.T_STRING, args[1].value)}

    @svc.method("Add")
    def add(sock, args):
        calls.append("Add")
        return th.TVal(th.T_I64, args[1].value + args[2].value)

    @svc.method("Notify")
    def notify(sock, args):
        calls.append("Notify")
    return svc


def _redis_service():
    from brpc_tpu_torch.protocol import redis as rd
    svc = rd.RedisService()
    store = {}
    lock = threading.Lock()

    @svc.command("SET")
    def set_(sock, args):
        with lock:
            store[args[1]] = args[2]
        return rd.RedisStatus("OK")

    @svc.command("GET")
    def get(sock, args):
        with lock:
            return store.get(args[1])

    @svc.command("INCR")
    def incr(sock, args):
        with lock:
            v = int(store.get(args[1], b"0")) + 1
            store[args[1]] = str(v).encode()
        return v
    return svc


def _bench_service():
    """``Bench.Echo``: the request's payload and attachment back."""
    from brpc_tpu_torch.rpc import Service
    svc = Service("Bench")

    def Echo(cntl, request):
        cntl.response_attachment.append(cntl.request_attachment.to_bytes())
        return bytes(request)
    svc.register_method("Echo", Echo)
    return svc


def _burst_in_flight(port: int, prompts, oracle: dict, what: str):
    """Phase 3's burst on a thread; the returned join checks it."""
    box = {}

    def run():
        box["r"] = _burst(port, prompts, MAX_TOKENS)
    t = threading.Thread(target=run, name=f"burst {what}")
    t.start()

    def join() -> dict:
        t.join(600)
        check(not t.is_alive() and "r" in box, f"{what}: burst hung")
        res, errs, wall, lat, _ = box["r"]
        _check_burst(f"{what} (burst beside)", res, errs, oracle)
        return {"wall_s": wall, "p50_ms": _median(lat)}
    return join


def _proto_bursts(port: int, prompts, oracle: dict) -> dict:
    """(a): phase 3's burst as unary Generate over each variant, cold
    then warm, streamed over hulu_pbrpc, and unary over hulu_pbrpc from
    a client process on the ring (batch backend); /connections names
    each variant's connection."""
    from brpc_tpu_torch.rpc import Channel, ChannelOptions
    out = {}
    for proto in PROTO_VARIANTS:
        for turn in ("cold", "warm"):
            res, errs, wall, lat, _ = _burst(port, prompts, MAX_TOKENS,
                                             protocol=proto)
            _check_burst(f"protocols a {proto} {turn}", res, errs, oracle)
            out[f"{proto}_{turn}"] = {"wall_s": wall, "p50_ms": _median(lat),
                                      "p99_ms": _p99(lat)}
    res, errs, wall, ttft, gaps = _stream_burst(port, prompts, MAX_TOKENS,
                                                protocol="hulu_pbrpc")
    _check_burst("protocols a hulu_pbrpc streamed", res, errs, oracle)
    out["hulu_pbrpc_stream"] = _burst_line(res, wall, ttft, gaps)
    doc = _client_process(["unary_hulu", str(port)],
                          env=dict(RING_ENV, CHIP_SMOKE_RING_BACKEND="1"))
    _check_burst("protocols a hulu_pbrpc on the ring", doc["results"],
                 doc["errors"], oracle)
    check(doc["lane"] == ["RingDispatcher", "batch"],
          f"protocols a: the ring client ran on {doc['lane']}")
    out["hulu_pbrpc_ring"] = {"wall_s": doc["wall_s"], "lane": doc["lane"],
                              "ring_read_barriers":
                                  doc["ring"]["ring_read_barriers"]}
    chans = [Channel(f"tcp://127.0.0.1:{port}", ChannelOptions(
        protocol=p, timeout_ms=30000, share_connections=False))
        for p in PROTO_VARIANTS]
    try:
        for ch in chans:
            check(not ch.call_sync("Bench", "Echo", b"n").failed(),
                  "protocols a: an echo to name the connection failed")
        rows = _http_json(port, "/connections")["connections"]
    finally:
        for ch in chans:
            ch.close()
    protos = sorted(r["protocol"] for r in rows)
    check(set(PROTO_VARIANTS) <= set(protos),
          f"protocols a: /connections names {protos}")
    out["connection_protocols"] = protos
    return out


def _proto_attachments(port: int, oracle: dict) -> dict:
    """(b): Bench.Echo returns its request attachment in its response
    attachment over tpu_std, hulu and sofa at 4 B, 64 KiB and 4 MiB;
    one Generate over hulu carries a request attachment."""
    from brpc_tpu_torch.rpc import Channel, ChannelOptions, Controller
    out = {}
    for proto in ("tpu_std",) + PROTO_VARIANTS:
        ch = Channel(f"tcp://127.0.0.1:{port}", ChannelOptions(
            protocol=proto, timeout_ms=60000, share_connections=False))
        try:
            for n in PROTO_ATT_SIZES:
                att = os.urandom(n)
                ms = []
                for _ in range(PROTO_ATT_CALLS):
                    c = Controller()
                    c.request_attachment.append(att)
                    t0 = time.perf_counter()
                    c = ch.call_sync("Bench", "Echo", b"att", cntl=c)
                    ms.append((time.perf_counter() - t0) * 1e3)
                    check(not c.failed() and c.response == b"att" and
                          c.response_attachment.to_bytes() == att,
                          f"protocols b: {proto} {n} B attachment: "
                          f"{c.error_code} {c.error_text}")
                out[f"{proto}_{n}"] = {"p50_ms": _median(ms),
                                       "max_ms": max(ms)}
        finally:
            ch.close()
    ch = Channel(f"tcp://127.0.0.1:{port}", ChannelOptions(
        protocol="hulu_pbrpc", timeout_ms=120000, share_connections=False))
    try:
        p = next(iter(oracle))
        c = Controller()
        c.request_attachment.append(b"\x00" * 4096)
        c = ch.call_sync("GenerateService", "Generate",
                         _generate_body(p), cntl=c)
        check(not c.failed() and json.loads(c.response)["tokens"]
              == oracle[p], f"protocols b: Generate with an attachment: "
                            f"{c.error_code} {c.error_text}")
    finally:
        ch.close()
    return out


def _proto_thrift(port: int, prompts, oracle: dict, calls: list) -> dict:
    """(c): thrift on the Generate server's port while a burst is in
    flight: Echo and Add, PROTO_THRIFT_CALLS ``call_async``s from fibers
    on one client, each answered with its own argument, a oneway call,
    an unknown method (UNKNOWN_METHOD). The burst's p50 and p99 are each
    call's time to finish among PROTO_THRIFT_CALLS issued at once (mostly
    its wait behind the connection's earlier calls); PROTO_THRIFT_SERIAL
    calls one after another on the same client give the p50 and p99 of
    one call."""
    from brpc_tpu_torch import fiber
    from brpc_tpu_torch.fiber.sync import CountdownEvent
    from brpc_tpu_torch.protocol import thrift as th
    join = _burst_in_flight(port, prompts, oracle, "protocols c")
    c = th.ThriftClient(f"127.0.0.1:{port}", timeout_s=60)
    try:
        out = c.call("Echo", {1: th.TVal(th.T_STRING, b"ping")})
        check(out[0].value == b"ping", f"protocols c: Echo {out}")
        out = c.call("Add", {1: th.TVal(th.T_I64, 40),
                             2: th.TVal(th.T_I64, 2)})
        check(out[0].value == 42, f"protocols c: Add {out}")
        n = PROTO_THRIFT_CALLS
        done = CountdownEvent(n)
        lat, bad = [], []

        async def one(i):
            t0 = time.perf_counter()
            try:
                r = await c.call_async("Add", {1: th.TVal(th.T_I64, i),
                                               2: th.TVal(th.T_I64, 7)})
                lat.append((time.perf_counter() - t0) * 1e3)
                if r[0].value != i + 7:
                    bad.append(i)
            except Exception as e:      # a failure is counted, then checked
                bad.append((i, repr(e)))
            finally:
                done.signal()
        t0 = time.perf_counter()
        for i in range(n):
            fiber.spawn(one, i)
        check(done.wait_pthread(120), "protocols c: call_async hung")
        wall = time.perf_counter() - t0
        check(not bad, f"protocols c: {len(bad)} bad answers: {bad[:3]}")
        c.call_oneway("Notify")
        try:
            c.call("Nope")
            check(False, "protocols c: an unknown method was answered")
        except th.ThriftError as e:
            check(e.type == th.EXC_UNKNOWN_METHOD,
                  f"protocols c: unknown method answered type {e.type}")
        check(_wait_for_value(lambda: calls.count("Notify"), 1),
              "protocols c: the oneway call never ran")
        serial = []
        for i in range(PROTO_THRIFT_SERIAL):
            t1 = time.perf_counter()
            r = c.call("Add", {1: th.TVal(th.T_I64, i),
                               2: th.TVal(th.T_I64, 5)})
            serial.append((time.perf_counter() - t1) * 1e3)
            check(r[0].value == i + 5, f"protocols c: serial Add {r}")
    finally:
        c.close()
    return {"calls": n, "wall_s": wall, "calls_per_s": n / wall,
            "finish_p50_ms": _median(lat), "finish_p99_ms": _p99(lat),
            "serial_calls": len(serial), "serial_p50_ms": _median(serial),
            "serial_p99_ms": _p99(serial), "burst_beside": join()}


def _proto_redis(port: int, prompts, oracle: dict) -> dict:
    """(d): RESP on the same port while a burst is in flight: a
    PROTO_REDIS_CMDS SET/GET pipeline answered in FIFO order, INCR, an
    unknown command (an error reply), PROTO_REDIS_THREADS threads on one
    shared client; p50 and p99 a command of the threads."""
    from brpc_tpu_torch.protocol import redis as rd
    join = _burst_in_flight(port, prompts, oracle, "protocols d")
    c = rd.RedisClient(f"127.0.0.1:{port}", timeout_s=60)
    try:
        n = PROTO_REDIS_CMDS
        cmds = [["SET", f"k{i}", f"v{i}"] if i % 2 == 0
                else ["GET", f"k{i - 1}"] for i in range(n)]
        t0 = time.perf_counter()
        got = c.pipeline(cmds)
        pipe_ms = (time.perf_counter() - t0) * 1e3
        want = [("OK" if i % 2 == 0 else f"v{i - 1}".encode())
                for i in range(n)]
        check(got == want, "protocols d: the pipeline's replies are out of "
                           "order or wrong")
        check([c.execute("INCR", "ctr") for _ in range(3)] == [1, 2, 3],
              "protocols d: INCR")
        try:
            c.execute("NOPE")
            check(False, "protocols d: an unknown command was answered")
        except rd.RedisError as e:
            check("unknown command" in str(e), f"protocols d: {e}")
        lat, errs = [], []

        def worker(i):
            try:
                for j in range(PROTO_REDIS_THREAD_CMDS):
                    t1 = time.perf_counter()
                    v = c.execute("INCR", f"t{i}")
                    lat.append((time.perf_counter() - t1) * 1e3)
                    if v != j + 1:
                        errs.append((i, j, v))
            except Exception as e:      # a failure is counted, then checked
                errs.append((i, repr(e)))
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(PROTO_REDIS_THREADS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        check(not errs and not any(t.is_alive() for t in threads),
              f"protocols d: shared client: {errs[:3]}")
    finally:
        c.close()
    return {"pipeline_cmds": n, "pipeline_ms": pipe_ms,
            "threads": PROTO_REDIS_THREADS, "p50_ms": _median(lat),
            "p99_ms": _p99(lat), "burst_beside": join()}


class _MockMemcached:
    """A memcached of the binary protocol on a thread of this process
    (the semantics of tests/test_memcache.py's mock): get, set, add,
    replace, cas, append, prepend, delete, incr, decr, version, noop,
    flush and SASL PLAIN against ``sasl_plain``."""

    def __init__(self, sasl_plain=None):
        import socketserver
        from brpc_tpu_torch.protocol import memcache as mc
        mock = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                buf, authed = b"", [False]
                while True:
                    try:
                        chunk = self.request.recv(65536)
                    except OSError:
                        return
                    if not chunk:
                        return
                    buf += chunk
                    while len(buf) >= mc.HEADER_SIZE:
                        (_m, op, kl, el, _d, _v, total, opaque,
                         cas) = mc._HDR.unpack_from(buf, 0)
                        if len(buf) < mc.HEADER_SIZE + total:
                            break
                        body = buf[mc.HEADER_SIZE:mc.HEADER_SIZE + total]
                        buf = buf[mc.HEADER_SIZE + total:]
                        self.request.sendall(mock.answer(
                            op, body[:el], body[el:el + kl], body[el + kl:],
                            opaque, cas, authed))

        self.mc = mc
        self.sasl_plain = sasl_plain
        self.data = {}
        self.cas_seq = 0
        self.lock = threading.Lock()
        self.server = socketserver.ThreadingTCPServer(("127.0.0.1", 0),
                                                      Handler)
        self.server.daemon_threads = True
        threading.Thread(target=self.server.serve_forever,
                         daemon=True).start()
        self.addr = "tcp://127.0.0.1:%d" % self.server.server_address[1]

    def close(self):
        self.server.shutdown()
        self.server.server_close()

    def answer(self, op, extras, key, value, opaque, cas, authed):
        import struct as st
        mc = self.mc

        def reply(status=mc.STATUS_OK, extras=b"", value=b"", cas=0):
            if status != mc.STATUS_OK and not value:
                value = b"error"
            return mc._HDR.pack(mc.MAGIC_RESPONSE, op, 0, len(extras), 0,
                                status, len(extras) + len(value), opaque,
                                cas) + extras + value
        with self.lock:
            if op == mc.OP_SASL_AUTH:
                if key != b"PLAIN" or (self.sasl_plain is not None
                                       and value != self.sasl_plain):
                    return reply(mc.STATUS_AUTH_ERROR, value=b"Auth failure")
                authed[0] = True
                return reply(value=b"Authenticated")
            if self.sasl_plain is not None and not authed[0]:
                return reply(mc.STATUS_AUTH_ERROR, value=b"Unauthenticated")
            d = self.data
            if op == mc.OP_GET:
                if key not in d:
                    return reply(mc.STATUS_KEY_NOT_FOUND)
                v, flags, kcas = d[key]
                return reply(extras=st.pack(">I", flags), value=v, cas=kcas)
            if op in (mc.OP_SET, mc.OP_ADD, mc.OP_REPLACE):
                flags, _ = st.unpack(">II", extras)
                if op == mc.OP_ADD and key in d:
                    return reply(mc.STATUS_KEY_EXISTS)
                if op == mc.OP_REPLACE and key not in d:
                    return reply(mc.STATUS_KEY_NOT_FOUND)
                if op == mc.OP_SET and cas and key in d and d[key][2] != cas:
                    return reply(mc.STATUS_KEY_EXISTS)
                self.cas_seq += 1
                d[key] = (value, flags, self.cas_seq)
                return reply(cas=self.cas_seq)
            if op in (mc.OP_APPEND, mc.OP_PREPEND):
                if key not in d:
                    return reply(mc.STATUS_ITEM_NOT_STORED)
                v, flags, _ = d[key]
                v = v + value if op == mc.OP_APPEND else value + v
                self.cas_seq += 1
                d[key] = (v, flags, self.cas_seq)
                return reply(cas=self.cas_seq)
            if op == mc.OP_DELETE:
                if key not in d:
                    return reply(mc.STATUS_KEY_NOT_FOUND)
                del d[key]
                return reply()
            if op in (mc.OP_INCREMENT, mc.OP_DECREMENT):
                delta, initial, _ = st.unpack(">QQI", extras)
                n = initial if key not in d else (
                    int(d[key][0]) + delta if op == mc.OP_INCREMENT
                    else max(0, int(d[key][0]) - delta))
                self.cas_seq += 1
                d[key] = (str(n).encode(), 0, self.cas_seq)
                return reply(value=st.pack(">Q", n), cas=self.cas_seq)
            if op == mc.OP_VERSION:
                return reply(value=b"1.6.0-mock")
            if op == mc.OP_FLUSH:
                d.clear()
                return reply()
            if op == mc.OP_NOOP:
                return reply()
            return reply(0x0081)


def _proto_memcache() -> dict:
    """(e): the memcache client against a mock memcached of this process:
    every operation, SASL PLAIN with good and bad credentials, a
    pipelined get; ms an operation."""
    from brpc_tpu_torch.protocol import memcache as mc
    out = {}
    m = _MockMemcached()
    c = mc.MemcacheClient(m.addr)
    try:
        t0 = time.perf_counter()
        cas = c.set("k", "v", flags=42)
        got = c.get("k")
        check(got is not None and got.value == b"v" and got.flags == 42
              and got.cas == cas, f"protocols e: get {got}")
        check(c.add("a", "1") > 0 and c.replace("a", "2") > 0,
              "protocols e: add/replace")
        try:
            c.set("k", "w", cas=cas + 1000)
            check(False, "protocols e: a stale cas was stored")
        except mc.MemcacheError as e:
            check(e.status == mc.STATUS_KEY_EXISTS, f"protocols e: cas {e}")
        check(c.incr("n", 5, initial=10) == 10 and c.incr("n", 5) == 15 and
              c.decr("n", 3) == 12, "protocols e: incr/decr")
        c.set("s", "mid")
        c.append("s", ">")
        c.prepend("s", "<")
        check(c.get("s").value == b"<mid>", "protocols e: append/prepend")
        check(c.version() == "1.6.0-mock", "protocols e: version")
        c.noop()
        check(c.delete("s") and c.get("s") is None, "protocols e: delete")
        for i in range(100):
            c.set(f"p{i}", f"v{i}")
        got = c.pipeline_get([f"p{i}" for i in range(100)] + ["nope"])
        check([g.value for g in got[:100]] == [f"v{i}".encode()
                                               for i in range(100)]
              and got[100] is None, "protocols e: pipelined get")
        c.flush_all()
        check(c.get("p0") is None, "protocols e: flush")
        out["sequence_ms"] = (time.perf_counter() - t0) * 1e3
    finally:
        c.close()
        m.close()
    m = _MockMemcached(sasl_plain=b"\x00bucket\x00sekrit")
    try:
        with mc.MemcacheClient(m.addr, username="bucket",
                               password="sekrit") as c:
            c.set("k", "v")
            check(c.get("k").value == b"v", "protocols e: SASL good")
        c = mc.MemcacheClient(m.addr, username="bucket", password="wrong")
        try:
            c.set("k", "v")
            check(False, "protocols e: bad SASL credentials were served")
        except mc.MemcacheError as e:
            check(e.status == mc.STATUS_AUTH_ERROR, f"protocols e: {e}")
        finally:
            c.close()
    finally:
        m.close()
    out["sasl"] = "good served, bad refused"
    return out


def _proto_pages(port: int) -> dict:
    """(f): /status's batching and coalescing gauges and a
    saturation_timeline link (the trend rings tick once a second); the
    probe pane of /device after ``ipc_probe --out`` with
    ``device_probe_path`` set; /protobufs."""
    import tempfile
    from brpc_tpu_torch.butil.flags import set_flag
    out = {}
    keys = ("dispatch_batch_size_avg_10s", "dispatch_batch_size_peak_10s",
            "socket_write_coalesced_frames")
    deadline = time.monotonic() + 10
    while True:
        st = _http_json(port, "/status")
        if st.get("saturation_timeline") or time.monotonic() > deadline:
            break
        time.sleep(0.25)
    check(all(k in st["saturation"] for k in keys),
          f"protocols f: /status saturation {sorted(st['saturation'])}")
    check(bool(st.get("saturation_timeline")),
          "protocols f: no saturation_timeline link")
    out["status"] = {k: st["saturation"][k] for k in keys}
    out["saturation_timeline"] = st["saturation_timeline"]
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "probe.json")
        t0 = time.monotonic()
        proc = subprocess.run(
            [sys.executable, "-m", "brpc_tpu_torch.transport.ipc_probe",
             "--out", path], cwd=str(Path(__file__).resolve().parent),
            capture_output=True, text=True, timeout=300)
        check(proc.returncode == 0,
              f"protocols f: ipc_probe --out: {proc.stderr[-2000:]}")
        out["ipc_probe_s"] = time.monotonic() - t0
        set_flag("device_probe_path", path)
        try:
            pane = _http_json(port, "/device").get("probe")
        finally:
            set_flag("device_probe_path", "")
    check(pane is not None and pane.get("lane_kind") == "cuda_ipc" and
          "lane_error" not in pane and "error" not in pane,
          f"protocols f: /device probe pane {pane}")
    out["probe"] = pane
    pb = _http_json(port, "/protobufs")
    check(pb.get("GenerateService.Generate") ==
          {"request": "bytes", "response": "bytes"},
          f"protocols f: /protobufs {sorted(pb)[:5]}")
    return out


def _proto_auth() -> dict:
    """(g): a server with ``auth_token`` and a thrift service refuses a
    thrift call (no handler run, ``server_auth_refused`` counted); a
    hulu call with the token is answered, one without it refused."""
    from brpc_tpu_torch.protocol import thrift as th
    from brpc_tpu_torch.rpc import (Channel, ChannelOptions, Server,
                                    ServerOptions)
    from brpc_tpu_torch.rpc import errno_codes as berr
    from brpc_tpu_torch.rpc.server import nauth_refused
    calls = []
    server = Server(ServerOptions(thrift_service=_thrift_service(calls),
                                  auth_token=PROTO_TOKEN))
    server.add_service(_bench_service())
    port = server.start("tcp://127.0.0.1:0").port
    before = nauth_refused.get_value()
    try:
        c = th.ThriftClient(f"127.0.0.1:{port}", timeout_s=30)
        try:
            c.call("Echo", {1: th.TVal(th.T_STRING, b"no credential")})
            refused = None
        except th.ThriftError as e:
            refused = str(e)
        finally:
            c.close()
        codes = {}
        for token in (PROTO_TOKEN, ""):
            ch = Channel(f"tcp://127.0.0.1:{port}", ChannelOptions(
                protocol="hulu_pbrpc", auth_token=token, timeout_ms=30000,
                share_connections=False))
            try:
                codes[bool(token)] = ch.call_sync("Bench", "Echo",
                                                  b"a").error_code
            finally:
                ch.close()
    finally:
        server.stop()
        server.join(10)
    check(refused is not None and not calls,
          f"protocols g: thrift without a credential: {refused}, "
          f"handler runs {calls}")
    check(nauth_refused.get_value() - before == 1,
          "protocols g: server_auth_refused did not count the refusal")
    check(codes == {True: 0, False: berr.ERPCAUTH},
          f"protocols g: hulu with and without the token: {codes}")
    return {"thrift_refused": refused, "hulu_codes": codes}


def phase_protocols(dev):
    """Generate over hulu_pbrpc and sofa_pbrpc, attachments, and thrift,
    redis and memcache on the card's server: one Server on cuda:0 with
    GenerateService, a thrift service, a redis service and Bench.Echo on
    one tcp port. (a) phase 3's burst over each variant, cold and warm,
    streamed over hulu, and over hulu from a client process on the ring;
    (b) attachment echoes at 4 B, 64 KiB and 4 MiB over tpu_std, hulu and
    sofa, and a Generate with a request attachment; (c) thrift and (d)
    redis beside a burst in flight; (e) memcache against a mock; (f) the
    pages; (g) the auth gate. flash_decode's launches, zeroed before the
    server starts and read after (g), equal its decode steps plus its
    warm-up, and no other kernel runs."""
    from brpc_tpu_torch.rpc import Server, ServerOptions
    from brpc_tpu_torch.serving import (TinyDecoder, TinyDecoderConfig,
                                        add_generate_service)
    fa = _fa_module()
    phase_t0 = time.monotonic()
    prompts = _prompts()
    cpu_model = TinyDecoder(TinyDecoderConfig(), device="cpu")
    oracle = {p: cpu_model.generate(list(p.encode()), MAX_TOKENS)
              for p in prompts}
    out = {"phase": "protocols"}
    thrift_calls = []
    fa.reset_launches()
    server = Server(ServerOptions(
        thrift_service=_thrift_service(thrift_calls),
        redis_service=_redis_service()))
    gs = add_generate_service(server)
    check(str(gs.device) == "cuda:0", f"service device {gs.device}")
    server.add_service(_bench_service())
    port = server.start("tcp://127.0.0.1:0").port
    try:
        progress("protocols a: Generate over hulu_pbrpc and sofa_pbrpc")
        out["a"] = _proto_bursts(port, prompts, oracle)
        emit({"phase": "protocols", "part": "a", "a": out["a"]})
        progress("protocols b: attachments")
        out["b"] = _proto_attachments(port, oracle)
        emit({"phase": "protocols", "part": "b", "b": out["b"]})
        progress("protocols c: thrift beside a burst")
        out["c"] = _proto_thrift(port, prompts, oracle, thrift_calls)
        emit({"phase": "protocols", "part": "c", "c": out["c"]})
        progress("protocols d: redis beside a burst")
        out["d"] = _proto_redis(port, prompts, oracle)
        emit({"phase": "protocols", "part": "d", "d": out["d"]})
        progress("protocols e: memcache against a mock")
        out["e"] = _proto_memcache()
        emit({"phase": "protocols", "part": "e", "e": out["e"]})
        progress("protocols f: /status, /device, /protobufs")
        out["f"] = _proto_pages(port)
        emit({"phase": "protocols", "part": "f", "f": out["f"]})
        progress("protocols g: the auth gate")
        out["g"] = _proto_auth()
        emit({"phase": "protocols", "part": "g", "g": out["g"]})
        _sync(dev)
        got = dict(fa.launches)
        steps = gs.batcher.decode_steps + gs.engine.warmup_steps
        check(got["flash_decode"] == steps > 0 and
              sum(got.values()) == got["flash_decode"],
              f"protocols: launched {got}, {steps} decode steps and "
              f"warm-ups")
        out["launches"] = {"flash_decode": got["flash_decode"]}
        out["steps"] = steps
    finally:
        server.stop()
        server.join(10)
    from brpc_tpu_torch.transport.pipelined import live_sockets
    check(live_sockets() == 0,
          f"protocols: {live_sockets()} pipelined client sockets left open")
    out["phase_s"] = time.monotonic() - phase_t0
    emit({"phase": "protocols", "launches": out["launches"],
          "steps": out["steps"], "phase_s": out["phase_s"]})
    return out


LEGACY_FLAVOURS = ("nova_pbrpc", "public_pbrpc", "nshead_mcpack")
LEGACY_MONGO_CMDS = 1000                # (b): commands back to back
LEGACY_MONGO_SERIAL = 200               # (b): one command at a time
LEGACY_ESP_CALLS = 1000                 # (c): call_async from fibers
LEGACY_ESP_SERIAL = 200                 # (c): one call at a time
LEGACY_ESP_THREADS = 8                  # (c): threads on one client
LEGACY_ESP_THREAD_CALLS = 50            # (c): calls a thread
LEGACY_TOKEN = "legacy-secret"          # (e): the auth server's token


def _legacy_adaptor(flavour: str, service):
    from brpc_tpu_torch.protocol import mcpack
    from brpc_tpu_torch.protocol import nshead_pbrpc as npb
    return {"nova_pbrpc": npb.nova_adaptor,
            "public_pbrpc": npb.public_pbrpc_adaptor,
            "nshead_mcpack": mcpack.nshead_mcpack_adaptor}[flavour](service)


def _legacy_client(flavour: str, port: int):
    """A client of ``flavour`` and its Generate call: (client, call(body)
    -> the answer's bytes)."""
    from brpc_tpu_torch.protocol import mcpack, nshead
    from brpc_tpu_torch.protocol import nshead_pbrpc as npb
    addr = f"127.0.0.1:{port}"
    if flavour == "nova_pbrpc":
        c = npb.NovaClient(addr, timeout_s=120)
        return c, lambda body: c.call_method(0, body)
    if flavour == "public_pbrpc":
        c = npb.PublicPbrpcClient(addr, timeout_s=120)
        return c, lambda body: c.call_method("GenerateService", 0, body)
    c = nshead.NsheadClient(addr, timeout_s=120)

    def call(body):
        doc = mcpack.decode(c.call(mcpack.encode(
            {"method": "Generate", "request": body})).body)
        if doc.get("error_code"):
            raise RuntimeError(f"nshead+mcpack error {doc}")
        return doc["response"]
    return c, call


def _legacy_burst(port: int, prompts, flavour: str):
    """Phase 3's burst over ``flavour``: N_CLIENTS threads, a client
    each (a connection's requests are answered in parse order, so a
    shared client would queue them behind each other's decode)."""
    results, errors, latency = {}, [], []

    def client(idx):
        c, call = _legacy_client(flavour, port)
        try:
            for p in prompts[idx::N_CLIENTS]:
                t0 = time.perf_counter()
                try:
                    doc = json.loads(bytes(call(_generate_body(p))))
                    latency.append((time.perf_counter() - t0) * 1e3)
                    results[p] = doc["tokens"]
                except Exception as e:  # a failure is counted, then checked
                    errors.append((p, repr(e)))
        finally:
            c.close()

    return results, errors, _run_clients(client), latency


def _legacy_in_flight(port: int, prompts, oracle: dict, what: str):
    """A nova burst on a thread; the returned join checks it and gives
    its time to finish."""
    box = {}

    def run():
        box["r"] = _legacy_burst(port, prompts, "nova_pbrpc")
    t = threading.Thread(target=run, name=f"burst {what}")
    t.start()

    def join() -> dict:
        t.join(600)
        check(not t.is_alive() and "r" in box, f"{what}: burst hung")
        res, errs, wall, lat = box["r"]
        _check_burst(f"{what} (nova burst beside)", res, errs, oracle)
        return {"burst_finish_s": wall, "burst_call_p50_ms": _median(lat)}
    return join


def _legacy_protocols(port: int) -> list:
    return sorted(r["protocol"] for r in
                  _http_json(port, "/connections")["connections"])


def _legacy_bursts(port: int, prompts, oracle: dict, flavour: str) -> dict:
    """(a): phase 3's burst over ``flavour``, cold then warm; a client
    left open names its connection on /connections."""
    out = {}
    for turn in ("cold", "warm"):
        res, errs, wall, lat = _legacy_burst(port, prompts, flavour)
        _check_burst(f"legacy a {flavour} {turn}", res, errs, oracle)
        out[turn] = {"wall_s": wall, "p50_ms": _median(lat),
                     "p99_ms": _p99(lat)}
    c, call = _legacy_client(flavour, port)
    try:
        p = prompts[0]
        check(json.loads(bytes(call(_generate_body(p))))["tokens"]
              == oracle[p], f"legacy a: {flavour} one call")
        protos = _legacy_protocols(port)
    finally:
        c.close()
    check("nshead" in protos,
          f"legacy a: /connections names {protos} for {flavour}")
    out["connection_protocols"] = protos
    return out


def _legacy_nova_extras(port: int, oracle: dict) -> dict:
    """(a) and (d) on the nova server: one call with the snappy flag, and
    a plain nshead call, which gets the adaptor's answer."""
    from brpc_tpu_torch.protocol import nshead
    from brpc_tpu_torch.protocol import nshead_pbrpc as npb
    p = next(iter(oracle))
    c = npb.NovaClient(f"127.0.0.1:{port}", timeout_s=120)
    try:
        doc = json.loads(c.call_method(0, _generate_body(p), snappy=True))
    finally:
        c.close()
    check(doc["tokens"] == oracle[p], "legacy a: a snappy nova call")
    c = nshead.NsheadClient(f"127.0.0.1:{port}", timeout_s=120)
    try:
        reply = c.call(nshead.NsheadMessage(_generate_body(p), reserved=0))
    finally:
        c.close()
    check(json.loads(reply.body)["tokens"] == oracle[p],
          "legacy d: a plain nshead call to the nova server")
    return {"snappy_call": "answered", "plain_nshead": "the adaptor's answer"}


def _legacy_mongo_service(calls: list):
    from brpc_tpu_torch.protocol import mongo
    svc = mongo.MongoServiceAdaptor()

    @svc.command("echo")
    def echo(sock, doc):
        calls.append("echo")
        return {"n": doc["echo"]}
    return svc


def _mongo_frame(s) -> bytes:
    import struct
    head = _recv_exact(s, 16)
    return head + _recv_exact(s, struct.unpack("<i", head[:4])[0] - 16)


def _recv_exact(s, n: int) -> bytes:
    out = b""
    while len(out) < n:
        chunk = s.recv(n - len(out))
        check(bool(chunk), "legacy: the connection closed mid-reply")
        out += chunk
    return out


def _legacy_mongo(port: int, prompts, oracle: dict) -> dict:
    """(b): mongo on the nova server's port while a nova burst is in
    flight: ``hello`` over OP_QUERY (answered with OP_REPLY), a
    registered command over OP_MSG, LEGACY_MONGO_CMDS commands written
    back to back on one connection (answered in order, each with its
    ``responseTo``), an unknown command (code 59). The pipeline's wall
    time is the time to answer them all; LEGACY_MONGO_SERIAL commands one
    at a time give the p50 of one command alone."""
    import socket as pysocket
    from brpc_tpu_torch.protocol import mongo
    join = _legacy_in_flight(port, prompts, oracle, "legacy b")
    s = pysocket.create_connection(("127.0.0.1", port), timeout=60)
    try:
        s.sendall(mongo.pack_query(1, "admin.$cmd", {"hello": 1}))
        _rid, to, op, doc = mongo.unpack_reply(_mongo_frame(s))
        check(op == mongo.OP_REPLY and to == 1 and
              doc.get("isWritablePrimary") is True,
              f"legacy b: hello over OP_QUERY {op} {doc}")
        s.sendall(mongo.pack_msg(2, 0, {"echo": 41}))
        _rid, to, op, doc = mongo.unpack_reply(_mongo_frame(s))
        check(op == mongo.OP_MSG and to == 2 and doc == {"n": 41, "ok": 1.0},
              f"legacy b: a registered command {doc}")
        protos = _legacy_protocols(port)
        n = LEGACY_MONGO_CMDS
        t0 = time.perf_counter()
        s.sendall(b"".join(mongo.pack_msg(100 + i, 0, {"echo": i})
                           for i in range(n)))
        for i in range(n):
            _rid, to, _op, doc = mongo.unpack_reply(_mongo_frame(s))
            check(to == 100 + i and doc.get("n") == i,
                  f"legacy b: command {i} answered as {to} {doc}")
        pipe_s = time.perf_counter() - t0
        s.sendall(mongo.pack_msg(3, 0, {"nosuchcmd": 1}))
        _rid, to, _op, doc = mongo.unpack_reply(_mongo_frame(s))
        check(to == 3 and doc.get("code") == 59,
              f"legacy b: an unknown command {doc}")
        serial = []
        for i in range(LEGACY_MONGO_SERIAL):
            t1 = time.perf_counter()
            s.sendall(mongo.pack_msg(5000 + i, 0, {"echo": i}))
            _rid, to, _op, doc = mongo.unpack_reply(_mongo_frame(s))
            serial.append((time.perf_counter() - t1) * 1e3)
            check(to == 5000 + i and doc.get("n") == i,
                  f"legacy b: serial command {i}")
    finally:
        s.close()
    check("mongo" in protos, f"legacy b: /connections names {protos}")
    return {"pipelined_commands": n, "pipeline_answer_all_s": pipe_s,
            "pipeline_commands_per_s": n / pipe_s,
            "serial_commands": len(serial),
            "one_command_alone_p50_ms": _median(serial),
            "one_command_alone_p99_ms": _p99(serial),
            "connection_protocols": protos, **join()}


def _legacy_esp_handler(calls: list):
    def handler(sock, msg):
        calls.append(msg.msg_id)
        return b"re-" + msg.body
    return handler


def _legacy_esp(port: int, prompts, oracle: dict) -> dict:
    """(c): esp on the same port while a nova burst is in flight:
    LEGACY_ESP_CALLS ``call_async``s from fibers on one client, each
    answered with its own body (matched by ``msg_id``); LEGACY_ESP_THREADS
    threads on one shared client; LEGACY_ESP_SERIAL calls one at a time
    (the p50 of one call alone)."""
    from brpc_tpu_torch import fiber
    from brpc_tpu_torch.fiber.sync import CountdownEvent
    from brpc_tpu_torch.protocol import esp
    join = _legacy_in_flight(port, prompts, oracle, "legacy c")
    c = esp.EspClient(f"127.0.0.1:{port}", stargate_id=7, timeout_s=60)
    try:
        n = LEGACY_ESP_CALLS
        done = CountdownEvent(n)
        lat, bad = [], []

        async def one(i):
            t0 = time.perf_counter()
            try:
                r = await c.call_async(to=1, body=f"q{i}".encode())
                lat.append((time.perf_counter() - t0) * 1e3)
                if r.body != f"re-q{i}".encode() or r.to != 7:
                    bad.append(i)
            except Exception as e:      # a failure is counted, then checked
                bad.append((i, repr(e)))
            finally:
                done.signal()
        t0 = time.perf_counter()
        for i in range(n):
            fiber.spawn(one, i)
        check(done.wait_pthread(120), "legacy c: call_async hung")
        wall = time.perf_counter() - t0
        check(not bad, f"legacy c: {len(bad)} bad answers: {bad[:3]}")
        protos = _legacy_protocols(port)
        errs = []

        def worker(i):
            try:
                for j in range(LEGACY_ESP_THREAD_CALLS):
                    body = f"t{i}.{j}".encode()
                    if c.call(to=1, body=body).body != b"re-" + body:
                        errs.append((i, j))
            except Exception as e:      # a failure is counted, then checked
                errs.append((i, repr(e)))
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(LEGACY_ESP_THREADS)]
        t1 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        threads_s = time.perf_counter() - t1
        check(not errs and not any(t.is_alive() for t in threads),
              f"legacy c: threads on one client: {errs[:3]}")
        serial = []
        for i in range(LEGACY_ESP_SERIAL):
            t2 = time.perf_counter()
            r = c.call(to=1, body=b"s")
            serial.append((time.perf_counter() - t2) * 1e3)
            check(r.body == b"re-s", "legacy c: a serial call")
    finally:
        c.close()
    check("esp" in protos, f"legacy c: /connections names {protos}")
    return {"calls": n, "answer_all_s": wall, "calls_per_s": n / wall,
            "finish_p50_ms": _median(lat), "finish_p99_ms": _p99(lat),
            "threads": LEGACY_ESP_THREADS,
            "thread_calls": LEGACY_ESP_THREADS * LEGACY_ESP_THREAD_CALLS,
            "threads_s": threads_s, "serial_calls": len(serial),
            "one_call_alone_p50_ms": _median(serial),
            "connection_protocols": protos, **join()}


def _legacy_echo_service(calls: list):
    """``Echo``: ubrpc's params map back, and the (e) server's nova
    echo; ``calls`` gets each run."""
    from brpc_tpu_torch.rpc import Service
    svc = Service("EchoService")

    def Echo(cntl, request):
        calls.append("Echo")
        return request if isinstance(request, dict) else bytes(request)
    svc.register_method("Echo", Echo)
    return svc


def _legacy_ubrpc() -> dict:
    """(d): a short server with an Echo service over ubrpc: an echo, an
    unknown method (1002), a malformed body (2001)."""
    from brpc_tpu_torch.protocol import mcpack, nshead
    from brpc_tpu_torch.protocol import nshead_pbrpc as npb
    from brpc_tpu_torch.rpc import Server, ServerOptions
    calls = []
    server = Server(ServerOptions(nshead_service=npb.ubrpc_adaptor(
        _legacy_echo_service(calls))))
    port = server.start("tcp://127.0.0.1:0").port
    c = npb.UbrpcClient(f"127.0.0.1:{port}", timeout_s=30)
    try:
        got = c.call_method("EchoService", "Echo", {"message": "hi"})
        check(got == {"message": "hi"}, f"legacy d: ubrpc echo {got}")
        try:
            c.call_method("EchoService", "Nope", {})
            check(False, "legacy d: an unknown method was answered")
        except ConnectionError as e:
            check("1002" in str(e), f"legacy d: unknown method: {e}")
        reply = c.call(nshead.NsheadMessage(b"garbage", version=1000))
        item = mcpack.decode(reply.body)["content"][0]
        check(item["error"]["code"] == 2001,
              f"legacy d: a malformed body answered {item}")
    finally:
        c.close()
        server.stop()
        server.join(10)
    return {"echo": "answered", "unknown_method": 1002,
            "malformed_body": 2001, "handler_runs": len(calls)}


def _legacy_auth() -> dict:
    """(e): a server with ``auth_token``: a nova call and an esp call are
    refused (the connection dropped, no handler run,
    ``server_auth_refused`` counting each); a mongo command is answered,
    as brpc_tpu's."""
    import socket as pysocket
    from brpc_tpu_torch.protocol import esp, mongo
    from brpc_tpu_torch.protocol import nshead_pbrpc as npb
    from brpc_tpu_torch.rpc import Server, ServerOptions
    from brpc_tpu_torch.rpc.server import nauth_refused
    calls, esp_calls, mongo_calls = [], [], []
    server = Server(ServerOptions(
        auth_token=LEGACY_TOKEN,
        nshead_service=npb.nova_adaptor(_legacy_echo_service(calls)),
        esp_service=_legacy_esp_handler(esp_calls),
        mongo_service_adaptor=_legacy_mongo_service(mongo_calls)))
    port = server.start("tcp://127.0.0.1:0").port
    before = nauth_refused.get_value()
    refused = {}
    try:
        c = npb.NovaClient(f"127.0.0.1:{port}", timeout_s=30)
        try:
            c.call_method(0, b"no credential")
        except Exception as e:          # the refusal: the connection drops
            refused["nova"] = repr(e)
        finally:
            c.close()
        c = esp.EspClient(f"127.0.0.1:{port}", timeout_s=30)
        try:
            c.call(to=1, body=b"no credential")
        except Exception as e:          # the refusal: the connection drops
            refused["esp"] = repr(e)
        finally:
            c.close()
        s = pysocket.create_connection(("127.0.0.1", port), timeout=30)
        try:
            s.sendall(mongo.pack_msg(1, 0, {"echo": 5}))
            _rid, to, _op, doc = mongo.unpack_reply(_mongo_frame(s))
        finally:
            s.close()
    finally:
        server.stop()
        server.join(10)
    check(set(refused) == {"nova", "esp"} and not calls and not esp_calls,
          f"legacy e: refused {refused}, handler runs {calls} {esp_calls}")
    check(nauth_refused.get_value() - before == 2,
          "legacy e: server_auth_refused did not count both refusals")
    check(to == 1 and doc == {"n": 5, "ok": 1.0} and mongo_calls,
          f"legacy e: the mongo command answered {doc}")
    return {"refused": refused, "auth_refused": 2, "mongo": "answered"}


def _legacy_server(flavour: str, fa, extra_opts: dict):
    """A Server on cuda:0 with the default Generate service served over
    ``flavour``, its launches zeroed before it starts."""
    from brpc_tpu_torch.rpc import Server, ServerOptions
    from brpc_tpu_torch.serving import add_generate_service
    fa.reset_launches()
    server = Server(ServerOptions(**extra_opts))
    gs = add_generate_service(server)
    check(str(gs.device) == "cuda:0", f"service device {gs.device}")
    server.options.nshead_service = _legacy_adaptor(
        flavour, server.services()["GenerateService"])
    return server, gs, server.start("tcp://127.0.0.1:0").port


def _legacy_launches(dev, fa, gs, what: str) -> int:
    _sync(dev)
    got = dict(fa.launches)
    steps = gs.batcher.decode_steps + gs.engine.warmup_steps
    check(got["flash_decode"] == steps > 0 and
          sum(got.values()) == got["flash_decode"],
          f"legacy {what}: launched {got}, {steps} decode steps and "
          f"warm-ups")
    return got["flash_decode"]


def phase_legacy(dev):
    """Generate over nova_pbrpc, public_pbrpc and nshead+mcpack, beside
    mongo and esp, and ubrpc and the auth gate. nshead_service is one
    handler a server, so each flavour gets a Server of its own on cuda:0
    with the default Generate service, one tcp port, in turn: (a) phase
    3's burst over the flavour, cold then warm, and /connections naming
    the connection; on the nova server also a snappy call, (b) mongo and
    (c) esp beside a nova burst in flight, and a plain nshead call. Then
    (d) ubrpc on a short Echo server and (e) the auth gate. Each Generate
    server's flash_decode launches, zeroed before it starts and read
    after its part, equal its decode steps plus its warm-up, and no other
    kernel runs; no nshead or esp client socket is left open."""
    from brpc_tpu_torch.protocol import esp
    from brpc_tpu_torch.serving import TinyDecoder, TinyDecoderConfig
    from brpc_tpu_torch.transport.pipelined import live_sockets
    fa = _fa_module()
    phase_t0 = time.monotonic()
    prompts = _prompts()
    cpu_model = TinyDecoder(TinyDecoderConfig(), device="cpu")
    oracle = {p: cpu_model.generate(list(p.encode()), MAX_TOKENS)
              for p in prompts}
    out = {"phase": "legacy", "a": {}, "launches": {}, "steps": {}}
    mongo_calls, esp_calls = [], []
    for flavour in LEGACY_FLAVOURS:
        extra = {} if flavour != "nova_pbrpc" else {
            "mongo_service_adaptor": _legacy_mongo_service(mongo_calls),
            "esp_service": _legacy_esp_handler(esp_calls)}
        server, gs, port = _legacy_server(flavour, fa, extra)
        try:
            progress(f"legacy a: Generate over {flavour}")
            out["a"][flavour] = _legacy_bursts(port, prompts, oracle,
                                               flavour)
            if flavour == "nova_pbrpc":
                out["a"][flavour].update(_legacy_nova_extras(port, oracle))
                progress("legacy b: mongo beside a nova burst")
                out["b"] = _legacy_mongo(port, prompts, oracle)
                emit({"phase": "legacy", "part": "b", "b": out["b"]})
                progress("legacy c: esp beside a nova burst")
                out["c"] = _legacy_esp(port, prompts, oracle)
                emit({"phase": "legacy", "part": "c", "c": out["c"]})
            out["launches"][flavour] = _legacy_launches(dev, fa, gs,
                                                        flavour)
            out["steps"][flavour] = (gs.batcher.decode_steps
                                     + gs.engine.warmup_steps)
        finally:
            server.stop()
            server.join(10)
        emit({"phase": "legacy", "part": "a", "flavour": flavour,
              "a": out["a"][flavour],
              "launches": out["launches"][flavour]})
    progress("legacy d: ubrpc")
    fa.reset_launches()
    out["d"] = _legacy_ubrpc()
    progress("legacy e: the auth gate")
    out["e"] = _legacy_auth()
    check(sum(fa.launches.values()) == 0,
          f"legacy d, e: kernels launched {dict(fa.launches)}")
    emit({"phase": "legacy", "part": "d", "d": out["d"], "e": out["e"]})
    check(live_sockets() == 0 and esp.live_sockets() == 0,
          f"legacy: {live_sockets()} pipelined and {esp.live_sockets()} "
          f"esp client sockets left open")
    out["phase_s"] = time.monotonic() - phase_t0
    emit({"phase": "legacy", "launches": out["launches"],
          "steps": out["steps"], "phase_s": out["phase_s"]})
    return out


# ------------------------------------------------------------- phase media

MEDIA_SEED = 20260803
MEDIA_FRAMES = 300              # (a): video frames, and as many audio ones
MEDIA_LATE_AT = 100             # (a): the late players join after this frame
MEDIA_AGG_AT = 200              # (a): the aggregate goes after this frame
MEDIA_AGG_SUBS = 8              # (a): its sub-messages
MEDIA_VIDEO_BYTES = (4 << 10, 64 << 10)
MEDIA_AUDIO_BYTES = (64, 512)
MEDIA_STREAM = "live/smoke"
MEDIA_TOKEN = "media-secret"    # (c): the auth server's token


def _media_script():
    """The publisher's messages, from MEDIA_SEED: onMetaData, the AVC and
    AAC sequence headers, then MEDIA_FRAMES video frames (33 ms apart,
    a keyframe every 30) and as many audio frames (23 ms apart) in
    timestamp order, an aggregate of MEDIA_AGG_SUBS sub-messages after
    frame MEDIA_AGG_AT. Each entry: (kind, msg_type, timestamp, payload,
    video frames sent before it); an aggregate's entry also carries the
    messages it splits into."""
    import numpy as np
    from brpc_tpu_torch.protocol import amf, rtmp
    rng = np.random.default_rng(MEDIA_SEED)

    def body(lo, hi):
        return rng.integers(0, 256, int(rng.integers(lo, hi + 1)),
                            dtype=np.uint8).tobytes()

    meta = amf.encode_values("onMetaData", amf.AmfEcmaArray({
        "width": 1280.0, "height": 720.0, "framerate": 30.0,
        "videocodecid": 7.0, "audiocodecid": 10.0}))
    script = [("meta", rtmp.MSG_DATA_AMF0, 0, meta, 0),
              ("seq", rtmp.MSG_VIDEO, 0, b"\x17\x00" + body(32, 64), 0),
              ("seq", rtmp.MSG_AUDIO, 0, b"\xaf\x00\x12\x10", 0)]
    frames = []
    for i in range(MEDIA_FRAMES):
        key = b"\x17\x01" if i % 30 == 0 else b"\x27\x01"
        frames.append((33 * i, 0, rtmp.MSG_VIDEO,
                       key + body(*MEDIA_VIDEO_BYTES)))
        frames.append((23 * i, 1, rtmp.MSG_AUDIO,
                       b"\xaf\x01" + body(*MEDIA_AUDIO_BYTES)))
    frames.sort(key=lambda f: (f[0], f[1]))
    video = 0
    for ts, _, kind, payload in frames:
        if kind == rtmp.MSG_VIDEO:
            video += 1
        script.append(("frame", kind, ts, payload, video))
        if kind == rtmp.MSG_VIDEO and video == MEDIA_AGG_AT:
            base = ts
            subs, split = b"", []
            for j in range(MEDIA_AGG_SUBS):
                t = rtmp.MSG_AUDIO if j % 2 else rtmp.MSG_VIDEO
                sub_ts = 1000 + 11 * j
                b = (b"\xaf\x01" if j % 2 else b"\x27\x01") + body(16, 256)
                subs += bytes([t]) + len(b).to_bytes(3, "big") + \
                    (sub_ts & 0xFFFFFF).to_bytes(3, "big") + \
                    bytes([sub_ts >> 24]) + b"\x00\x00\x00" + b + \
                    (11 + len(b)).to_bytes(4, "big")
                split.append((t, base + 11 * j, b))
            script.append(("aggregate", rtmp.MSG_AGGREGATE, base, subs,
                           video, split))
    return script


def _media_expected(entries):
    """[(msg_type, timestamp, payload)] a player gets of ``entries``: an
    aggregate as its split."""
    out = []
    for e in entries:
        if e[0] == "aggregate":
            out.extend(e[5])
        else:
            out.append((e[1], e[2], e[3]))
    return out


def _media_digests(msgs) -> dict:
    """sha256 of the messages muxed to FLV (``flv.pack_tag``) and to TS
    (``TsMuxer``: the video and audio payloads past their 2-byte FLV
    headers, the PTS at the timestamp)."""
    import hashlib
    from brpc_tpu_torch.protocol import flv, rtmp, ts
    tags = flv.file_header() + b"".join(
        flv.pack_tag(flv.FlvTag(t, stamp, p)) for t, stamp, p in msgs)
    mux = ts.TsMuxer()
    mux.write_tables()
    for t, stamp, p in msgs:
        if t == rtmp.MSG_VIDEO:
            mux.write_video(p[2:], stamp * 90)
        elif t == rtmp.MSG_AUDIO:
            mux.write_audio(p[2:], stamp * 90)
    return {"flv": hashlib.sha256(tags).hexdigest(),
            "ts": hashlib.sha256(mux.flush()).hexdigest(),
            "messages": len(msgs)}


class _MediaPlayer:
    """An RtmpClient playing MEDIA_STREAM: every media message it gets,
    with its arrival time."""

    def __init__(self, port: int, name: str, **kw):
        from brpc_tpu_torch.protocol import rtmp
        self.name = name
        self.client = rtmp.RtmpClient(f"tcp://127.0.0.1:{port}",
                                      timeout_s=30, **kw)
        self.got, self.at = [], []
        self.client.connect()
        self.sid = self.client.create_stream()

    def play(self) -> None:
        info = self.client.play(self.sid, MEDIA_STREAM,
                                on_media=self._on_media)
        check(info.get("code") == "NetStream.Play.Start",
              f"media a: {self.name} play answered {info}")

    def _on_media(self, msg) -> None:
        self.at.append(time.perf_counter())
        self.got.append(msg)

    def wait_for(self, n: int, timeout_s: float = 60.0) -> None:
        deadline = time.monotonic() + timeout_s
        while len(self.got) < n and time.monotonic() < deadline:
            time.sleep(0.002)
        check(len(self.got) >= n, f"media a: {self.name} got "
                                  f"{len(self.got)} of {n} messages")


def _media_relay(port: int, service) -> dict:
    """(a): one publisher (digest handshake) and four players, two early,
    one late with the plain handshake, one late in the AMF3 envelope."""
    from brpc_tpu_torch.protocol import rtmp
    script = _media_script()
    early = [_MediaPlayer(port, f"early{i}") for i in range(2)]
    for p in early:
        p.play()
    pub = rtmp.RtmpClient(f"tcp://127.0.0.1:{port}", timeout_s=30)
    late = []
    sent_at = []
    try:
        pub.connect()
        psid = pub.create_stream()
        info = pub.publish(psid, MEDIA_STREAM)
        check(info.get("code") == "NetStream.Publish.Start",
              f"media a: publish answered {info}")
        join_at = None
        t0 = time.perf_counter()
        for i, e in enumerate(script):
            pub._send_media(e[1], psid, e[2], e[3])
            sent_at.append(time.perf_counter())
            if join_at is None and e[0] == "frame" and \
                    e[1] == rtmp.MSG_VIDEO and e[4] == MEDIA_LATE_AT:
                # the relay has written all that came before, so the
                # late players' first live message is the next one
                want = len(_media_expected(script[:i + 1]))
                for p in early:
                    p.wait_for(want)
                join_at = i + 1
                late = [_MediaPlayer(port, "late_plain", handshake="plain"),
                        _MediaPlayer(port, "late_amf3", object_encoding=3)]
                for p in late:
                    p.play()
                protos = _legacy_protocols(port)
                check(protos.count("rtmp") == 5,
                      f"media a: /connections names {protos}")
        total = len(_media_expected(script))
        for p in early:
            p.wait_for(total)
        for p in late:
            p.wait_for(3 + len(_media_expected(script[join_at:])))
        wall = time.perf_counter() - t0
        check(service.publishers() == 1 and service.players() == 4,
              f"media a: {service.publishers()} publishers, "
              f"{service.players()} players")
        want = {"publisher": _media_digests(_media_expected(script))}
        cached = [(e[1], 0, e[3]) for e in script[:3]]
        late_want = cached + _media_expected(script[join_at:])
        want["publisher_from_join"] = _media_digests(late_want)
        players = {}
        for p in early + late:
            exp = _media_expected(script) if p in early else late_want
            got = [(m.msg_type, m.timestamp, m.payload) for m in p.got]
            check(len(got) == len(exp),
                  f"media a: {p.name} got {len(got)} messages, want "
                  f"{len(exp)}")
            bad = next((k for k, (a, b) in enumerate(zip(got, exp))
                        if a != b), None)
            if bad is not None:
                check(False, f"media a: {p.name}'s message {bad} differs: "
                             f"{got[bad][:2]} against {exp[bad][:2]}")
            check(all(m.stream_id == p.sid for m in p.got),
                  f"media a: {p.name} got another stream id")
            d = _media_digests(got)
            ref = want["publisher" if p in early else "publisher_from_join"]
            check(d == ref, f"media a: {p.name}'s digests {d} against {ref}")
            # the last frame's lag behind its send
            players[p.name] = dict(d, lag_last_ms=(p.at[-1] - sent_at[-1])
                                   * 1e3)
        agg = [(t, ts) for t, ts, _ in
               next(e for e in script if e[0] == "aggregate")[5]]
        return {"wall_s": wall, "messages_sent": len(script),
                "connection_protocols": protos,
                "bytes_sent": sum(len(e[3]) for e in script),
                "late_join_at": join_at, "aggregate_split": agg,
                "want": want, "players": players}
    finally:
        for p in early + late:
            p.client.close()
        pub.close()


def _media_gates(fa, dev, oracle) -> dict:
    """(c): a Generate server without ``rtmp_service`` gets a C0C1 and
    does not claim it, and still serves Generate; an ``on_publish`` that
    refuses and a second publisher on a taken name get the refusal's
    status; a server with ``auth_token`` answers RTMP."""
    import socket as pysocket
    from brpc_tpu_torch.protocol import rtmp
    from brpc_tpu_torch.rpc import Server, ServerOptions
    from brpc_tpu_torch.serving import add_generate_service
    out = {}
    fa.reset_launches()
    server = Server()
    gs = add_generate_service(server)
    check(str(gs.device) == "cuda:0", f"service device {gs.device}")
    port = server.start("tcp://127.0.0.1:0").port
    try:
        s = pysocket.create_connection(("127.0.0.1", port), timeout=5)
        try:
            c1, _ = rtmp._hs_build_block(rtmp._FP_KEY, 0,
                                         rtmp._CLIENT_VERSION)
            s.sendall(bytes([rtmp.RTMP_VERSION]) + c1)
            s.settimeout(0.5)
            try:
                got = s.recv(10)
            except TimeoutError:
                got = b""
        finally:
            s.close()
        check(got == b"", f"media c: a server without rtmp_service "
                          f"answered a C0C1 with {got!r}")
        res, errs, wall, lat, _ = _burst(port, _prompts()[:N_CLIENTS],
                                         MAX_TOKENS)
        _check_burst("media c (no rtmp_service)", res, errs,
                     {p: oracle[p] for p in _prompts()[:N_CLIENTS]})
        out["no_service"] = {"c0c1_answer": "none", "generate_wall_s": wall}
        _sync(dev)
        launched = dict(fa.launches)
        steps = gs.batcher.decode_steps + gs.engine.warmup_steps
        check(launched["flash_decode"] == steps > 0 and
              sum(launched.values()) == steps,
              f"media c: launched {launched}, {steps} steps and warm-ups")
        out["launches"] = launched["flash_decode"]
        out["steps"] = steps
    finally:
        server.stop()
        server.join(10)
    svc = rtmp.RtmpService(on_publish=lambda name, sock: name != "refused")
    fa.reset_launches()
    server = Server(ServerOptions(rtmp_service=svc, auth_token=MEDIA_TOKEN))
    port = server.start("tcp://127.0.0.1:0").port
    clients = [rtmp.RtmpClient(f"tcp://127.0.0.1:{port}", timeout_s=30)
               for _ in range(3)]
    refusals = {}
    try:
        for c in clients:
            info = c.connect()
            check(info.get("code") == "NetConnection.Connect.Success",
                  f"media c: the auth server answered connect {info}")
        check(clients[0].publish(clients[0].create_stream(), "taken")
              .get("code") == "NetStream.Publish.Start",
              "media c: the auth server refused a publish")
        for what, c, name in (("hook", clients[1], "refused"),
                              ("taken", clients[2], "taken")):
            try:
                c.publish(c.create_stream(), name)
                check(False, f"media c: the {what} publish was answered")
            except rtmp.RtmpError as e:
                check("NetStream.Publish.BadName" in str(e),
                      f"media c: {what}: {e}")
                refusals[what] = "NetStream.Publish.BadName"
    finally:
        for c in clients:
            c.close()
        server.stop()
        server.join(10)
    check(sum(fa.launches.values()) == 0,
          f"media c: the relay launched {dict(fa.launches)}")
    out["auth_server"] = {"connect": "NetConnection.Connect.Success",
                          "publish": "NetStream.Publish.Start"}
    out["refusals"] = refusals
    return out


def phase_media(dev):
    """RTMP's relay on Generate's server: (a) one publisher and four
    players on a Server on cuda:0 that also serves Generate over tpu_std
    on the same port, every player's FLV and TS digests equal the
    publisher's from its join; (b) phase 3's burst beside the relay and
    then alone, every answer equal to the CPU plain path's; (c) the
    gates; (d) the launches: each Generate server's flash_decode
    launches, zeroed before it starts, equal its steps plus its warm-up,
    and no other kernel runs."""
    from brpc_tpu_torch.protocol import rtmp
    from brpc_tpu_torch.rpc import Server, ServerOptions
    from brpc_tpu_torch.serving import (TinyDecoder, TinyDecoderConfig,
                                        add_generate_service)
    fa = _fa_module()
    phase_t0 = time.monotonic()
    prompts = _prompts()
    cpu_model = TinyDecoder(TinyDecoderConfig(), device="cpu")
    oracle = {p: cpu_model.generate(list(p.encode()), MAX_TOKENS)
              for p in prompts}
    out = {"phase": "media"}
    svc = rtmp.RtmpService()
    fa.reset_launches()
    server = Server(ServerOptions(rtmp_service=svc))
    gs = add_generate_service(server)
    check(str(gs.device) == "cuda:0", f"service device {gs.device}")
    port = server.start("tcp://127.0.0.1:0").port
    try:
        progress("media b: warm-up burst")
        res, errs, wall, lat, _ = _burst(port, prompts, MAX_TOKENS)
        _check_burst("media b warm-up", res, errs, oracle)
        progress("media a+b: the relay beside a Generate burst")
        box = {}

        def burst():
            box["r"] = _burst(port, prompts, MAX_TOKENS)
        t = threading.Thread(target=burst, name="media burst")
        t.start()
        out["a"] = _media_relay(port, svc)
        t.join(600)
        check(not t.is_alive() and "r" in box, "media b: the burst hung")
        res, errs, wall, lat, _ = box["r"]
        _check_burst("media b beside the relay", res, errs, oracle)
        out["b"] = {"with_relay": {"wall_s": wall, "p50_ms": _median(lat),
                                   "p99_ms": _p99(lat)}}
        emit({"phase": "media", "part": "a", "a": out["a"]})
        progress("media b: the burst alone")
        res, errs, wall, lat, _ = _burst(port, prompts, MAX_TOKENS)
        _check_burst("media b alone", res, errs, oracle)
        out["b"]["alone"] = {"wall_s": wall, "p50_ms": _median(lat),
                             "p99_ms": _p99(lat)}
        emit({"phase": "media", "part": "b", "b": out["b"]})
        _sync(dev)
        launched = dict(fa.launches)
        steps = gs.batcher.decode_steps + gs.engine.warmup_steps
        check(launched["flash_decode"] == steps > 0 and
              sum(launched.values()) == steps,
              f"media d: launched {launched}, {steps} steps and warm-ups")
        out["launches"] = {"relay_server": steps}
    finally:
        server.stop()
        server.join(10)
    check(svc.publishers() == 0 and svc.players() == 0,
          f"media: the stopped server left {svc.publishers()} publishers "
          f"and {svc.players()} players")
    progress("media c: the gates")
    out["c"] = _media_gates(fa, dev, oracle)
    out["launches"]["plain_server"] = out["c"]["launches"]
    check(rtmp.live_sockets() == 0 and rtmp.stale_entries() == 0,
          f"media: {rtmp.live_sockets()} RTMP client sockets and "
          f"{rtmp.stale_entries()} relay entries of closed sockets left")
    out["phase_s"] = time.monotonic() - phase_t0
    emit({"phase": "media", "part": "c", "c": out["c"],
          "launches": out["launches"], "phase_s": out["phase_s"]})
    return out


# ---------------------------------------------------------- phase sanitize

SANITIZE = ("address", "undefined")
SANITIZE_PLUCK_CALLS = 64       # sync calls on one held connection
SANITIZE_ECHO_CALLS = 500       # the C echo turn's pipelined calls
SANITIZE_CHILD_S = 240          # each child's time limit
SANITIZE_REPORTS = ("ERROR: AddressSanitizer", "runtime error:")


def _loaded_native() -> list:
    """The native core's shared objects this process has mapped."""
    with open("/proc/self/maps") as f:
        return sorted({line.split()[-1] for line in f
                       if "_brpc_fastcore-" in line
                       or "libbrpc_tpu_torch_native-" in line})


def _sanitize_child() -> int:
    """``--client sanitize``: under the sanitizers' preload, a Generate
    server on cuda:0 and its clients in this process: a Generate burst
    on the turbo and pluck lanes, SANITIZE_PLUCK_CALLS sync calls on one
    held connection, a turn of the C echo, an HTTP/1.1 burst through the
    native head parse, and the chaos CLI's mixed storm over tcp at seed
    7; one JSON line with the lanes' counters, the launches and steps,
    and the native core's files this process mapped."""
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import brpc_tpu_torch.native as native
    from brpc_tpu_torch.native import build, fastcore
    from brpc_tpu_torch.rpc import Channel, ChannelOptions, Server, Service
    from brpc_tpu_torch.serving import (TinyDecoder, TinyDecoderConfig,
                                        add_generate_service)
    from brpc_tpu_torch.tools import chaos as chaos_cli
    check(build.sanitize_mode() == SANITIZE,
          f"sanitize child: mode {build.sanitize_mode()}")
    check(native.lib() is not None and fastcore.get() is not None,
          "sanitize child: the native core did not load")
    fa = _fa_module()
    prompts = _prompts()
    cpu_model = TinyDecoder(TinyDecoderConfig(), device="cpu")
    oracle = {p: cpu_model.generate(list(p.encode()), MAX_TOKENS)
              for p in prompts}
    out = {}
    fa.reset_launches()
    server = Server()
    gs = add_generate_service(server)
    check(str(gs.device) == "cuda:0", f"service device {gs.device}")
    svc = Service("Echo")
    svc.register_method("Echo", lambda cntl, req: req, native="echo")
    svc.register_method("PyEcho", lambda cntl, req: req)
    server.add_service(svc)
    port = server.start("tcp://127.0.0.1:0").port
    c0 = _native_counters()
    try:
        t0 = time.monotonic()
        res, errs, wall, lat, _ = _burst(port, prompts, MAX_TOKENS,
                                         timeout_ms=None)
        _check_burst("sanitize: Generate over tpu_std", res, errs, oracle)
        out["generate"] = {"wall_s": wall, "p50_ms": _median(lat)}
        ch = Channel(f"tcp://127.0.0.1:{port}",
                     ChannelOptions(timeout_ms=30000,
                                    share_connections=False))
        try:
            for i in range(SANITIZE_PLUCK_CALLS):
                body = b"pluck %d " % i * (i + 1)
                c = ch.call_sync("Echo", "PyEcho", body)
                check(not c.failed() and c.response == body,
                      f"sanitize: held call {i}: {c.error_text}")
        finally:
            ch.close()
        ch = Channel(f"tcp://127.0.0.1:{port}",
                     ChannelOptions(timeout_ms=None,
                                    share_connections=False))
        try:
            out["c_echo"] = _pipelined_echo(ch, b"e" * 64,
                                            SANITIZE_ECHO_CALLS)
        finally:
            ch.close()
        res, errs, wall, ttft, _ = _http_burst(port, prompts, MAX_TOKENS)
        _check_burst("sanitize: Generate over HTTP/1.1", res, errs, oracle)
        out["http"] = {"wall_s": wall, "ttft_p50_ms": _median(ttft)}
        out["lanes_s"] = time.monotonic() - t0
    finally:
        server.stop()
        server.join(10)
    import torch
    torch.cuda.synchronize()
    out["lanes"] = _delta(c0, _native_counters())
    out["launches"] = dict(fa.launches)
    out["steps"] = gs.batcher.decode_steps + gs.engine.warmup_steps
    t0 = time.monotonic()
    out["chaos"] = chaos_cli.mixed_storm(7, "tcp")
    out["chaos_s"] = time.monotonic() - t0
    out["mapped"] = _loaded_native()
    emit(out)
    return 0


def _sanitized_run(args, env: dict) -> dict:
    """A child under the sanitizers: its JSON line, its stderr's
    sanitizer reports (their first 40 lines fail the phase)."""
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), "--client", *args],
        capture_output=True, text=True, timeout=SANITIZE_CHILD_S,
        env=dict(os.environ, **env))
    wall = time.monotonic() - t0
    report = [i for i, line in enumerate(proc.stderr.splitlines())
              if any(r in line for r in SANITIZE_REPORTS)]
    if report:
        lines = proc.stderr.splitlines()[report[0]:report[0] + 40]
        print("\n".join(lines), file=sys.stderr)
        check(False, f"sanitize {args[0]}: a sanitizer report "
                     f"({len(report)} lines name one)")
    check(proc.returncode == 0,
          f"sanitize {args[0]}: exit {proc.returncode}: "
          f"{proc.stderr[-3000:]}")
    doc = json.loads(proc.stdout.strip().splitlines()[-1])
    doc["child_s"] = wall
    return doc


def phase_sanitize(dev):
    """The native core under ASan and UBSan on the card's serving path:
    the parent builds the two ``.san`` outputs and flash_decode (no
    compiler runs under the preload), then runs two children with
    ``sanitizer_env()``: ``--client sanitize`` (Generate over tpu_std
    on the turbo and pluck lanes, sync calls on a held connection, the C
    echo, Generate over HTTP/1.1, the chaos CLI's mixed storm over tcp)
    and ``--client ring_echo batch`` (the ring lane's batch backend).
    Each must exit 0 with no sanitizer report, map only ``.san`` outputs
    of the core, and show each lane ran; the first child's answers equal
    the CPU plain path's and its flash_decode launches equal its steps
    plus its warm-up."""
    from brpc_tpu_torch.native import build
    from brpc_tpu_torch.ops import _build
    phase_t0 = time.monotonic()
    missing = build.sanitizer_toolchain_missing(SANITIZE)
    check(not missing, f"sanitize: the toolchain lacks {missing}")
    cxx = build.sanitizer_cxx(SANITIZE)
    out = {"phase": "sanitize", "cxx": build.CXX, "sanitizer_cxx": cxx,
           "runtimes": {t: build._runtime_lib(build._SAN_RUNTIMES[t], cxx)
                        for t in SANITIZE}}
    t0 = time.monotonic()
    paths = [str(build.build(SANITIZE)), str(build.build_fastcore(SANITIZE))]
    out["build_s"] = time.monotonic() - t0
    out["outputs"] = [Path(p).name for p in paths]
    check(all(p.endswith(".san.so") for p in paths),
          f"sanitize: outputs {paths}")
    _build.build("flash_decode")
    env = build.sanitizer_env(SANITIZE)
    out["env"] = {k: v for k, v in env.items() if k != "LD_PRELOAD"}
    out["preload"] = env.get("LD_PRELOAD", "").split()
    check(len(out["preload"]) == len(SANITIZE),
          f"sanitize: preload {out['preload']}")
    emit({"phase": "sanitize", "part": "build",
          "build": {k: out[k] for k in ("cxx", "sanitizer_cxx", "runtimes",
                                        "build_s", "outputs", "env",
                                        "preload")}})
    progress("sanitize: the serving child")
    doc = _sanitized_run(["sanitize", "0"], env)
    check(doc["mapped"] and all(p.endswith(".san.so") for p in doc["mapped"])
          and len(doc["mapped"]) == 2,
          f"sanitize: the child mapped {doc['mapped']}")
    lanes = doc["lanes"]
    for k in ("turbo_requests", "pluck_fast", "serve_drain",
              "http_native_heads", "client_fast_responses"):
        check(lanes[k] > 0, f"sanitize: lane {k} did not run: {lanes}")
    check(doc["launches"]["flash_decode"] == doc["steps"] > 0 and
          sum(doc["launches"].values()) == doc["steps"],
          f"sanitize: launched {doc['launches']}, {doc['steps']} steps and "
          f"warm-ups")
    check(doc["chaos"]["isolated_then_revived"] and not doc["chaos"]["leaks"],
          f"sanitize: the chaos storm {doc['chaos']}")
    out["serving"] = doc
    emit({"phase": "sanitize", "part": "serving", "serving": doc})
    progress("sanitize: the ring's batch backend")
    ring = _sanitized_run(["ring_echo", "batch"], env)
    check(ring["lane"] == ["RingDispatcher", "batch"],
          f"sanitize: the ring child ran on {ring['lane']}")
    check(ring["mapped"] and all(p.endswith(".san.so")
                                 for p in ring["mapped"]),
          f"sanitize: the ring child mapped {ring['mapped']}")
    check(sum(ring["ring"].values()) > 0,
          f"sanitize: the ring counted nothing: {ring['ring']}")
    out["ring"] = ring
    out["phase_s"] = time.monotonic() - phase_t0
    emit({"phase": "sanitize", "part": "ring", "ring": ring,
          "phase_s": out["phase_s"]})
    out["launches"] = doc["launches"]
    return out


# -------------------------------------------------------------- phase lint

LINT_SEED = 7                   # the racelane's schedule in (b) and (c)
LINT_CHILD_S = 300              # each child's time limit
_LOCK_ENV = ("BRPC_TPU_TORCH_LOCK_DEBUG", "BRPC_TPU_TORCH_LOCK_SEED")


def _lint_serve_child() -> int:
    """``--client lint_serve``: a Generate server on cuda:0 and its
    clients in this process, phase 3's burst as streams and then as
    unary calls (32 tokens a request); one JSON line with each burst's
    wall, tokens/s and p50, the flash_decode launches and the steps, and,
    when ``BRPC_TPU_TORCH_LOCK_DEBUG`` armed the racelane at the
    package's import, its violations and its instrumented locks'
    stats."""
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import brpc_tpu_torch  # noqa: F401  (the env hook arms here)
    from brpc_tpu_torch.analysis import racelane
    from brpc_tpu_torch.rpc import Server
    from brpc_tpu_torch.serving import (TinyDecoder, TinyDecoderConfig,
                                        add_generate_service)
    import torch
    armed = racelane.installed()
    fa = _fa_module()
    prompts = _prompts()
    cpu_model = TinyDecoder(TinyDecoderConfig(), device="cpu")
    oracle = {p: cpu_model.generate(list(p.encode()), MAX_TOKENS)
              for p in prompts}
    fa.reset_launches()
    server = Server()
    gs = add_generate_service(server)
    check(str(gs.device) == "cuda:0", f"service device {gs.device}")
    port = server.start("tcp://127.0.0.1:0").port
    out = {"armed": armed}
    try:
        res, errs, wall, ttft, _ = _stream_burst(port, prompts, MAX_TOKENS)
        _check_burst("lint: the stream burst", res, errs, oracle)
        out["stream"] = {"wall_s": wall, "ttft_p50_ms": _median(ttft),
                         "tokens_per_s": N_REQUESTS * MAX_TOKENS / wall}
        res, errs, wall, lat, _ = _burst(port, prompts, MAX_TOKENS)
        _check_burst("lint: the unary burst", res, errs, oracle)
        out["unary"] = {"wall_s": wall, "p50_ms": _median(lat),
                        "tokens_per_s": N_REQUESTS * MAX_TOKENS / wall}
    finally:
        server.stop()
        server.join(10)
    torch.cuda.synchronize()
    out["launches"] = dict(fa.launches)
    out["steps"] = gs.batcher.decode_steps
    out["warmup_steps"] = gs.engine.warmup_steps
    out["violations"] = racelane.violations()
    out["stats"] = racelane.stats() if armed else None
    emit(out)
    return 0


def _lint_child(args, env: dict, what: str) -> dict:
    """A child of the phase, with the racelane's variables as ``env``
    says and no other: its last stdout line as JSON."""
    full = {k: v for k, v in os.environ.items() if k not in _LOCK_ENV}
    full.update(env)
    t0 = time.monotonic()
    proc = subprocess.run(args, capture_output=True, text=True,
                          timeout=LINT_CHILD_S, env=full,
                          cwd=str(Path(__file__).resolve().parent))
    wall = time.monotonic() - t0
    check(proc.returncode == 0 and proc.stdout.strip(),
          f"lint {what}: exit {proc.returncode}: {proc.stderr[-3000:]}")
    try:
        doc = json.loads(proc.stdout)       # the racelane's indented report
    except ValueError:
        doc = json.loads(proc.stdout.strip().splitlines()[-1])
    doc["child_s"] = wall
    return doc


def phase_lint(dev):
    """graftlint on the card's machine, each part in a child process:
    (a) ``python3 -m brpc_tpu_torch.analysis brpc_tpu_torch
    --format=json`` exits 0 with no active finding (its waived findings
    by rule, files and walker cases, wall); (b) Generate on cuda:0 under
    ``BRPC_TPU_TORCH_LOCK_DEBUG=strict`` with seed LINT_SEED (phase 3's
    burst as streams, then unary), no lock-order violation (each one's
    two holders printed), ranked acquisitions above 0, and flash_decode
    launches equal to the child's steps plus its warm-up; the same child
    with the variable unset beside it; (c) ``python3 -m
    brpc_tpu_torch.analysis.racelane --smoke``: the positive control
    races, the fixed pairs hold, the batcher storm raises nothing."""
    from collections import Counter
    from brpc_tpu_torch.ops import _build
    phase_t0 = time.monotonic()
    out = {"phase": "lint"}
    progress("lint: (a) the checker")
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "brpc_tpu_torch.analysis", "brpc_tpu_torch",
         "--format=json"], capture_output=True, text=True,
        timeout=LINT_CHILD_S, cwd=str(Path(__file__).resolve().parent),
        env={k: v for k, v in os.environ.items() if k not in _LOCK_ENV})
    wall = time.monotonic() - t0
    check(proc.stdout.strip() != "",
          f"lint (a): no report, exit {proc.returncode}: "
          f"{proc.stderr[-3000:]}")
    rep = json.loads(proc.stdout.strip().splitlines()[-1])
    for f in rep["active"][:20]:
        print(f"lint (a): {f['path']}:{f['line']}: [{f['rule']}] "
              f"{f['message']}", file=sys.stderr)
    check(proc.returncode == 0 and not rep["active"],
          f"lint (a): exit {proc.returncode}, {len(rep['active'])} active "
          f"findings")
    out["a"] = {"rc": proc.returncode, "active": len(rep["active"]),
                "waived": len(rep["waived"]),
                "waived_by_rule": dict(sorted(Counter(
                    f["rule"] for f in rep["waived"]).items())),
                "files": rep["files"], "walker_cases": rep["walker_cases"],
                "wall_s": wall}
    check(rep["walker_cases"] > 0,
          f"lint (a): judge-defer checked no walker case: {out['a']}")
    emit({"phase": "lint", "part": "a", "a": out["a"]})
    progress("lint: (b) Generate under the lock-order assert")
    # built here, so that neither child's first burst pays a build
    from brpc_tpu_torch.native import build as native_build
    _build.build("flash_decode")
    native_build.build()
    native_build.build_fastcore()
    serve = [sys.executable, str(Path(__file__).resolve()), "--client",
             "lint_serve", "0"]
    runs = {"strict": _lint_child(
        serve, {"BRPC_TPU_TORCH_LOCK_DEBUG": "strict",
                "BRPC_TPU_TORCH_LOCK_SEED": str(LINT_SEED)}, "(b)")}
    runs["unset"] = _lint_child(serve, {}, "(b)")
    strict = runs["strict"]
    for v in strict["violations"]:
        print(f"lint (b): acquiring {v['acquiring']} (rank "
              f"{v['acquiring_rank']}) while holding {v['holding']} (rank "
              f"{v['holding_rank']}) on {v['thread']}", file=sys.stderr)
    check(strict["armed"] and not runs["unset"]["armed"],
          f"lint (b): armed strict={strict['armed']} "
          f"unset={runs['unset']['armed']}")
    check(not strict["violations"],
          f"lint (b): {len(strict['violations'])} lock-order violations")
    check(strict["stats"]["ranked_acquires"] > 0,
          f"lint (b): no ranked acquisition: {strict['stats']}")
    for mode, d in runs.items():
        n = d["launches"].get("flash_decode", 0)
        check(n == d["steps"] + d["warmup_steps"] > 0
              and sum(d["launches"].values()) == n,
              f"lint (b) {mode}: launched {d['launches']}, {d['steps']} "
              f"steps + {d['warmup_steps']} warm-up")
    out["b"] = runs
    emit({"phase": "lint", "part": "b", "b": runs})
    progress("lint: (c) the racelane smoke")
    smoke = _lint_child(
        [sys.executable, "-m", "brpc_tpu_torch.analysis.racelane",
         "--smoke"], {"BRPC_TPU_TORCH_LOCK_DEBUG": "1",
                      "BRPC_TPU_TORCH_LOCK_SEED": str(LINT_SEED)}, "(c)")
    pairs = smoke["field_races"]["pairs"]
    check(pairs["unguarded-counter"]["raced"],
          f"lint (c): the positive control did not race: "
          f"{pairs['unguarded-counter']}")
    for name in ("guarded-counter", "taskcontrol-stop-vs-start"):
        check(not pairs[name]["raced"] and pairs[name]["completed"],
              f"lint (c): {name} broke: {pairs[name]}")
    check(smoke["real_code_clean"],
          f"lint (c): the batcher storm: {smoke['real_code']}")
    check(smoke["ok"] and smoke["inversion_detected"]
          and smoke["inversion_deterministic"],
          f"lint (c): the smoke: {json.dumps(smoke)[:2000]}")
    out["c"] = {"ok": smoke["ok"], "child_s": smoke["child_s"],
                "inversion": smoke["seeded_inversion"][0]["first"],
                "real_code": smoke["real_code"]["stats"],
                "pairs": {k: {f: v[f] for f in ("raced", "completed",
                                                 "site_yields", "ok",
                                                 "evidence")}
                          for k, v in pairs.items()}}
    out["launches"] = {"flash_decode": sum(
        d["launches"].get("flash_decode", 0) for d in runs.values())}
    out["phase_s"] = time.monotonic() - phase_t0
    emit({"phase": "lint", "part": "c", "c": out["c"],
          "phase_s": out["phase_s"]})
    return out


TOOLS_CHILD_S = 240             # each tool child's time limit
TOOLS_CHAIN_CALLS = 16          # (b): client -> A -> B calls
TOOLS_QPS_PROCS = 4             # (c): qps_client's worker processes
TOOLS_QPS_S = 3.0               # (c): their window
TOOLS_QPS_CONNS = 2             # (c): connections a worker
TOOLS_PIPELINED_CALLS = 2000    # (c): run_pipelined's Echo calls
TOOLS_PIPELINED_INFLIGHT = 8
TOOLS_SOAK_S = 20               # (c): the mixed soak's window
TOOLS_IDLE_CONNS = 2000         # (c): the idle-connection soak
TOOLS_STACK_TRIES = 20          # (e): fiber_stacks reads mid-burst at most


class _Rpcz:
    """rpcz on in this process, its spans stored under ``dirpath``, for
    the ``with`` block; the flags as they were after it, the store
    flushed."""

    def __init__(self, dirpath: str):
        self.dir = dirpath

    def __enter__(self):
        from brpc_tpu_torch.butil.flags import flag, set_flag
        self.before = {f: flag(f) for f in ("rpcz_enabled", "rpcz_dir")}
        check(set_flag("rpcz_enabled", True) and
              set_flag("rpcz_dir", self.dir), "cannot turn rpcz on")
        return self

    def __exit__(self, *exc):
        from brpc_tpu_torch.butil.flags import set_flag
        from brpc_tpu_torch.rpc.span import global_store
        global_store.flush()
        for f, v in self.before.items():
            set_flag(f, v)


def _chain_of(node) -> list:
    """The spans from ``node`` down, each node having one child at most
    (else SmokeFailure)."""
    chain = []
    while True:
        chain.append(node.span)
        if not node.children:
            return chain
        check(len(node.children) == 1,
              f"tools: a branch under {node.span['side']} "
              f"{node.span['service']}.{node.span['method']}")
        node = node.children[0]


def _tools_shard_trace(here: Path, work: str, oracle: dict) -> dict:
    """(a): Generate through a traced 2-shard group: every call one tree
    whose root is this process's client span, its server and serving
    spans in a shard's pid; then ``trace --perfetto`` and ``--top``."""
    from brpc_tpu_torch.tools import trace
    group_dir = os.path.join(work, "group-rpcz")
    client_dir = os.path.join(work, "client-rpcz")
    t0 = time.monotonic()
    g = _ShardGroup(2, str(here), work, env={
        "BRPC_TPU_FLAG_RPCZ_ENABLED": "1",
        "BRPC_TPU_FLAG_RPCZ_DIR": group_dir})
    out = {"up_s": g.up_s}
    calls = []
    try:
        by_pid = g.spread(N_CLIENTS // g.shards)
        chans = [c for v in by_pid.values() for c in v]
        bursts = {}
        with _Rpcz(client_dir):
            for streamed in (True, False):
                kind = "stream" if streamed else "unary"
                res, errs, wall = _shard_burst(chans, _prompts(), streamed,
                                               calls)
                _check_burst(f"tools a: the {kind} burst", res, errs, oracle)
                bursts[kind] = {"wall_s": wall, "tokens_per_s":
                                N_REQUESTS * MAX_TOKENS / wall}
        out["bursts"] = bursts
        tokens = 2 * N_REQUESTS * MAX_TOKENS

        def counts():
            per = [_shard_counts(g, i) for i in range(g.shards)]
            return per if sum(s["tokens_out"] for s in per) == tokens \
                else None
        per = _settled(counts)
        check(per is not None, f"tools a: the shards' tokens_out != {tokens}")
        for s in per:
            check(s["flash_decode"] == s["decode_steps"] + s["warmup_steps"]
                  and s["decode_steps"] > 0,
                  f"tools a: shard {s['pid']}: {s['flash_decode']} "
                  f"flash_decode launches != {s['decode_steps']} steps + "
                  f"{s['warmup_steps']} warm-up")
        out["shards"] = per
        shard_pids = {s["pid"] for s in per}
        check(shard_pids == set(by_pid), f"tools a: {shard_pids} against "
                                         f"the pids served {set(by_pid)}")
    finally:
        stopped = g.stop()
    check(stopped["rc"] == 0 and not stopped["left"],
          f"tools a: SIGTERM to the group: {stopped}")
    out["group_s"] = time.monotonic() - t0
    # the tool over both stores, in children
    perfetto = os.path.join(work, "shard_trace.json")
    pf = _module_child(["brpc_tpu_torch.tools.trace", client_dir, group_dir,
                        "--perfetto", perfetto], "tools a: --perfetto")
    top = _module_child(["brpc_tpu_torch.tools.trace", client_dir, group_dir,
                         "--top", "5"], "tools a: --top")
    with open(perfetto) as f:
        slices = trace.validate_perfetto(json.load(f))
    spans = trace.load_spans([client_dir, group_dir])
    forest = trace.assemble(spans)
    me = os.getpid()
    seen_pids, slowest = set(), None
    for c in calls:
        roots = forest.get(c["trace_id"], [])
        check(len(roots) == 1, f"tools a: trace {c['trace_id']}: "
                               f"{len(roots)} roots")
        chain = _chain_of(roots[0])
        sides = [s["side"] for s in chain]
        check(sides == ["client", "server", "serving"],
              f"tools a: trace {c['trace_id']}: {sides}")
        check(chain[0]["pid"] == me and chain[1]["pid"] == chain[2]["pid"]
              and chain[1]["pid"] in shard_pids,
              f"tools a: trace {c['trace_id']}: pids "
              f"{[s['pid'] for s in chain]}, shards {shard_pids}")
        seen_pids.add(chain[1]["pid"])
        total, path = trace.critical_path(roots)
        check(0 < total <= c["wall_us"],
              f"tools a: trace {c['trace_id']}: critical path {total} us "
              f"over the caller's wall {c['wall_us']:.0f} us")
        if slowest is None or total > slowest["critical_path_us"]:
            slowest = {"trace_id": c["trace_id"], "streamed": c["streamed"],
                       "critical_path_us": total, "caller_wall_us":
                       c["wall_us"], "hops": [
                           {"side": n.span["side"], "pid": n.span["pid"],
                            "self_us": self_us} for n, self_us in path],
                       **trace.stage_attribution(path)}
    check(seen_pids == shard_pids,
          f"tools a: spans from {seen_pids}, shards {shard_pids}")
    check(slices >= len(spans), f"tools a: {slices} slices, "
                                f"{len(spans)} spans")
    head = pf["stdout"].strip().splitlines()[-1]
    check(head.startswith("wrote ") and f"({len(spans)} spans)" in head,
          f"tools a: --perfetto said {head!r}")
    top_lines = [ln for ln in top["stdout"].splitlines()
                 if ln.startswith("trace ")]
    check(len(top_lines) == 5, f"tools a: --top 5 gave {top_lines}")
    out.update(calls=len(calls), spans=len(spans), traces=len(forest),
               pids=len({s["pid"] for s in spans}),
               perfetto_slices=slices, slowest=slowest,
               top=top_lines, trace_s=pf["wall_s"] + top["wall_s"],
               launches=sum(s["flash_decode"] for s in per))
    return out


def _tools_chain(here: Path, work: str) -> dict:
    """(b): client -> A -> B over two chain_server children: one
    four-span tree a call, strictly nested, over three pids; then
    ``trace --smoke``."""
    import shutil

    from brpc_tpu_torch.rpc import Channel, ChannelOptions
    from brpc_tpu_torch.tools import trace
    from brpc_tpu_torch.tools.spawn_util import spawn_port_server
    t0 = time.monotonic()
    dirs = [os.path.join(work, f"chain-{n}") for n in "abc"]
    procs, ch = [], None
    try:
        port = None
        for d in (dirs[1], dirs[0]):         # B first, then A -> B
            argv = ["-m", "brpc_tpu_torch.tools.chain_server", "0",
                    "--rpcz-dir", d]
            if port is not None:
                argv += ["--next", f"tcp://127.0.0.1:{port}"]
            proc, port = spawn_port_server(argv, 60, cwd=str(here))
            check(port is not None, "tools b: a chain server never came up")
            procs.append(proc)
        traces = []
        with _Rpcz(dirs[2]):
            ch = Channel(f"tcp://127.0.0.1:{port}",
                         ChannelOptions(timeout_ms=10000))
            for i in range(TOOLS_CHAIN_CALLS):
                c = ch.call_sync("Chain", "Hop", b"ping%d" % i)
                check(not c.failed() and c.response == b"hop:leaf:ping%d" % i,
                      f"tools b: Hop {i}: {c.error_text} {c.response!r}")
                traces.append(f"{c.trace_id:016x}")
            ch.close()
            ch = None
        for p in procs:
            p.terminate()
        rcs = [p.wait(30) for p in procs]
        check(rcs == [0, 0], f"tools b: the chain servers exited {rcs}")
    finally:
        if ch is not None:
            ch.close()
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(10)
            p.stdout.close()
    spans = trace.load_spans(dirs)
    forest = trace.assemble(spans)
    for tid in traces:
        roots = forest.get(tid, [])
        check(len(roots) == 1, f"tools b: trace {tid}: {len(roots)} roots")
        chain = _chain_of(roots[0])
        check(len(chain) == 4 and len({s["pid"] for s in chain}) == 3,
              f"tools b: trace {tid}: "
              f"{[(s['side'], s['pid']) for s in chain]}")
        for parent, child in zip(chain, chain[1:]):
            check(child["parent_span_id"] == parent["span_id"],
                  f"tools b: trace {tid}: a parent link broken")
    out = {"calls": len(traces), "spans": len(spans),
           "chain_s": time.monotonic() - t0}
    smoke = _module_child(["brpc_tpu_torch.tools.trace", "--smoke"],
                          "tools b: --smoke")
    rep = _last_json(smoke["stdout"])
    check(rep.get("ok") is True and rep["chain_depth"] == 4,
          f"tools b: trace --smoke: {rep}")
    shutil.rmtree(rep["rpcz_dir"], ignore_errors=True)
    out["smoke"] = {k: v for k, v in rep.items() if k != "rpcz_dir"}
    out["smoke"]["wall_s"] = smoke["wall_s"]
    return out


def _tools_load(here: Path) -> dict:
    """(c): qps_client's workers and run_pipelined against a
    bench_echo_server child, then the soak and its idle mode."""
    from brpc_tpu_torch.rpc import Channel, ChannelOptions
    from brpc_tpu_torch.tools.pipeline_runner import run_pipelined
    from brpc_tpu_torch.tools.qps_client import drive_multiproc
    from brpc_tpu_torch.tools.spawn_util import spawn_port_server
    out = {}
    proc, port = spawn_port_server(
        ["-m", "brpc_tpu_torch.tools.bench_echo_server"], 60, cwd=str(here))
    check(port is not None, "tools c: bench_echo_server never came up")
    try:
        t0 = time.monotonic()
        q = drive_multiproc(port, nprocs=TOOLS_QPS_PROCS,
                            seconds=TOOLS_QPS_S, conns=TOOLS_QPS_CONNS)
        check(q["calls"] > 0 and q["failures"] == 0
              and q["dead_workers"] == 0, f"tools c: qps_client {q}")
        out["qps_client"] = dict(q, wall_s=time.monotonic() - t0)
        ch = Channel(f"tcp://127.0.0.1:{port}",
                     ChannelOptions(timeout_ms=5000,
                                    share_connections=False))
        try:
            check(ch.call_sync("Bench", "Echo", b"warm").response == b"warm",
                  "tools c: the warm Echo")

            def issue(on_done):
                def done(c):
                    on_done(RuntimeError(c.error_text) if c.failed()
                            or c.response != b"pipe" else None)
                ch.call("Bench", "Echo", b"pipe", done=done)
            try:
                wall = run_pipelined(TOOLS_PIPELINED_CALLS,
                                     TOOLS_PIPELINED_INFLIGHT, issue, 60.0)
            except RuntimeError as e:
                raise SmokeFailure(f"tools c: run_pipelined: {e}")
        finally:
            ch.close()
        out["pipelined"] = {"calls": TOOLS_PIPELINED_CALLS,
                            "inflight": TOOLS_PIPELINED_INFLIGHT,
                            "wall_s": wall,
                            "qps": TOOLS_PIPELINED_CALLS / wall}
    finally:
        proc.terminate()
        proc.wait(10)
        proc.stdout.close()
    soak = _module_child(["brpc_tpu_torch.tools.soak", "--seconds",
                          str(TOOLS_SOAK_S)], "tools c: soak",
                         timeout_s=TOOLS_SOAK_S + 120, want_rc=None)
    rep = _last_json(soak["stdout"])
    check(rep.get("ok") is True and soak["rc"] == 0
          and all(n > 0 for n in rep["calls"].values()),
          f"tools c: soak: {rep}")
    out["soak"] = dict(rep, wall_s=soak["wall_s"])
    idle = _module_child(["brpc_tpu_torch.tools.soak", "--idle-conns",
                          str(TOOLS_IDLE_CONNS)], "tools c: soak --idle-conns",
                         timeout_s=TOOLS_CHILD_S, want_rc=None)
    rep = _last_json(idle["stdout"])
    check(rep.get("ok") is True and idle["rc"] == 0,
          f"tools c: soak --idle-conns: {rep}")
    out["idle"] = dict(rep, wall_s=idle["wall_s"])
    return out


def _generate_server(here: Path, err):
    """``shard_server --shards 1 --generate``: one Generate server on
    cuda:0 with its builtin pages, in a child; (process, port)."""
    from brpc_tpu_torch.tools.spawn_util import spawn_announcing_server
    proc, got = spawn_announcing_server(
        ["-m", "brpc_tpu_torch.tools.shard_server", "--shards", "1",
         "--generate"], 240, env=dict(os.environ, PYTHONPATH=str(here)),
        stderr=err, cwd=str(here))
    check(got is not None, "tools d: a Generate server never came up")
    return proc, got["PORT"]


def _server_launches(port: int) -> dict:
    status, body = _http_page(port, "/vars?prefix=flash_decode_launches")
    check(status == 200, f"tools: /vars {status}")
    launches = int(body.decode().partition(" : ")[2].split()[0])
    s = json.loads(_http_page(port, "/serving")[1])
    return {"flash_decode": launches, "decode_steps": s["decode_steps"],
            "warmup_steps": s["engine"]["warmup_steps"],
            "tokens_out": s["tokens_out"]}


def _tools_cluster_and_stacks(here: Path, work: str, oracle: dict) -> dict:
    """(d) cluster_top --smoke, then two Generate servers behind a
    ClusterChannel from this process, scraped by cluster_top; (e)
    fiber_stacks against one mid-burst and by SIGUSR2 against the
    other."""
    from brpc_tpu_torch.rpc import (ChannelOptions, ClusterChannel, Server,
                                    ServerOptions)
    from brpc_tpu_torch.rpc import backend_stats
    out = {}
    smoke = _module_child(["brpc_tpu_torch.tools.cluster_top", "--smoke"],
                          "tools d: --smoke", timeout_s=TOOLS_CHILD_S,
                          want_rc=None)
    rep = _last_json(smoke["stdout"])
    print(f"chip_smoke: tools d: cluster_top --smoke {json.dumps(rep)}",
          file=sys.stderr, flush=True)
    check(rep.get("ok") is True and smoke["rc"] == 0,
          f"tools d: cluster_top --smoke: {rep}")
    out["smoke"] = dict(rep, wall_s=smoke["wall_s"])
    errs = [open(os.path.join(work, f"gen{i}.stderr"), "w+")
            for i in range(2)]
    servers = [None, None]

    def start(i):
        try:
            servers[i] = _generate_server(here, errs[i])
        except SmokeFailure as e:
            servers[i] = e
    t0 = time.monotonic()
    starters = [threading.Thread(target=start, args=(i,)) for i in range(2)]
    for t in starters:
        t.start()
    for t in starters:
        t.join(300)
    admin, ch = None, None
    try:
        for s in servers:
            check(isinstance(s, tuple), f"tools d: {s}")
        out["servers_up_s"] = time.monotonic() - t0
        ports = [p for _, p in servers]
        addrs = [f"tcp://127.0.0.1:{p}" for p in ports]
        admin = Server(ServerOptions(enable_builtin_services=True))
        admin_port = admin.start("tcp://127.0.0.1:0").port
        page = backend_stats.backends_page_payload()
        before = sum(row["completed"] for ch_ in page["channels"].values()
                     for k, row in ch_["backends"].items() if k in addrs)
        ch = ClusterChannel("list://" + ",".join(addrs), "rr",
                            ChannelOptions(timeout_ms=120000, max_retry=2,
                                           name="tools_cluster"))
        res, errors, wall, _, _ = _cluster_burst(ch, _prompts(), N_CLIENTS)
        _check_burst("tools d: the burst through the ClusterChannel", res,
                     errors, oracle)
        out["burst"] = {"wall_s": wall,
                        "tokens_per_s": N_REQUESTS * MAX_TOKENS / wall}
        nodes = [f"127.0.0.1:{p}" for p in [admin_port] + ports]
        top = _module_child(["brpc_tpu_torch.tools.cluster_top", *nodes,
                             "--once", "--json"], "tools d: --once --json")
        view = _last_json(top["stdout"])
        rows = {k: v for k, v in view["backends"].items() if k in addrs}
        check(view["nodes_up"] == 3 and len(rows) == 2 and
              sum(r["completed"] for r in rows.values()) - before ==
              N_REQUESTS, f"tools d: the merged rows {rows} "
                          f"(before: {before})")
        serving = {n: view["serving"].get(n) for n in nodes[1:]}
        check(all(serving.values()) and sum(
            s["tokens_out"] for s in serving.values()) ==
            N_REQUESTS * MAX_TOKENS, f"tools d: serving rows {serving}")
        check(all("qps" in (view["timeline"].get(n) or {})
                  for n in nodes[1:]),
              f"tools d: timeline trends {list(view['timeline'])}")
        out["view"] = {"rows": rows, "serving": serving,
                       "timeline": {n: {k: len(v) if isinstance(v, list)
                                        else v for k, v in tl.items()}
                                    for n, tl in view["timeline"].items()},
                       "wall_s": top["wall_s"]}
        # (e) the http:// mode while bursts run through the channel
        stop, mid = threading.Event(), []

        def bursts():
            while not stop.is_set():
                res, errors, _, _, _ = _cluster_burst(ch, _prompts(),
                                                      N_CLIENTS)
                mid.append((res, errors))
        t = threading.Thread(target=bursts, daemon=True)
        t.start()
        try:
            report = ""
            for tries in range(1, TOOLS_STACK_TRIES + 1):
                st = _module_child(["brpc_tpu_torch.tools.fiber_stacks",
                                    f"http://127.0.0.1:{ports[0]}"],
                                   "tools e: the http:// mode")
                report = st["stdout"]
                if "[SUSPENDED]" in report:
                    break
        finally:
            stop.set()
            t.join(300)
        check("[SUSPENDED]" in report, f"tools e: no suspended fiber in "
                                       f"{tries} reports: {report[-1500:]}")
        for res, errors in mid:
            _check_burst("tools e: a burst beside fiber_stacks", res,
                         errors, oracle)
        out["stacks_http"] = {"tries": tries, "bursts": len(mid),
                              "wall_s": st["wall_s"],
                              "fibers": report.splitlines()[0],
                              "suspended": report.count("[SUSPENDED]")}
        pid = servers[1][0].pid
        st = _module_child(["brpc_tpu_torch.tools.fiber_stacks", str(pid)],
                           "tools e: the PID mode")

        def reported():
            errs[1].seek(0)
            return "live fibers" in errs[1].read() or None
        check(_settled(reported) is not None,
              "tools e: no report on the server's stderr after SIGUSR2")
        out["stacks_pid"] = {"wall_s": st["wall_s"],
                             "said": st["stdout"].strip()[:80]}
        per = [_server_launches(p) for p in ports]
        for s in per:
            check(s["flash_decode"] == s["decode_steps"] + s["warmup_steps"]
                  and s["decode_steps"] > 0,
                  f"tools d: {s['flash_decode']} flash_decode launches != "
                  f"{s['decode_steps']} steps + {s['warmup_steps']} warm-up")
        out["servers"] = per
        out["launches"] = sum(s["flash_decode"] for s in per)
    finally:
        if ch is not None:
            ch.close()
        if admin is not None:
            admin.stop()
            admin.join(5)
        for s in servers:
            if isinstance(s, tuple):
                s[0].terminate()
        for s in servers:
            if isinstance(s, tuple):
                try:
                    s[0].wait(60)
                finally:
                    if s[0].poll() is None:
                        s[0].kill()
                        s[0].wait(10)
                    s[0].stdout.close()
        for f in errs:
            f.close()
    return out


def phase_tools(dev):
    """The trace, load and cluster tools on the card's machine, each run
    as ``python3 -m brpc_tpu_torch.tools.<tool>`` in a child: (a) phase
    3's burst, streamed and unary, through a 2-shard Generate group with
    rpcz on in every process, assembled by ``trace`` into one tree a
    call (this process's client span, the shard's server and serving
    spans), its Perfetto export validated, each critical path within its
    caller's wall, flash_decode launches equal to each shard's steps
    plus its warm-up; (b) client -> A -> B over two ``chain_server``
    children, and ``trace --smoke``; (c) ``qps_client`` workers and
    ``run_pipelined`` against ``bench_echo_server``, ``soak`` and its
    idle-connection mode; (d) ``cluster_top --smoke`` with the overhead
    gate, then two Generate servers behind a ClusterChannel of this
    process, scraped: the merged rows count the burst's calls and the
    serving rows its tokens; (e) ``fiber_stacks`` over HTTP mid-burst
    and by SIGUSR2."""
    import shutil
    import tempfile

    from brpc_tpu_torch.ops import _build
    from brpc_tpu_torch.serving import TinyDecoder, TinyDecoderConfig
    phase_t0 = time.monotonic()
    here = Path(__file__).resolve().parent
    _build.build("flash_decode")     # before the group's supervisor forks
    cpu_model = TinyDecoder(TinyDecoderConfig(), device="cpu")
    oracle = {p: cpu_model.generate(list(p.encode()), MAX_TOKENS)
              for p in _prompts()}
    work = tempfile.mkdtemp(prefix="chip-smoke-tools-")
    out = {"phase": "tools"}
    try:
        parts = (("a", "the shard trace",
                  lambda: _tools_shard_trace(here, work, oracle)),
                 ("b", "the chain and trace --smoke",
                  lambda: _tools_chain(here, work)),
                 ("c", "the load tools", lambda: _tools_load(here)),
                 ("d", "cluster_top and (e) fiber_stacks",
                  lambda: _tools_cluster_and_stacks(here, work, oracle)))
        for key, what, fn in parts:
            progress(f"tools: ({key}) {what}")
            t0 = time.monotonic()
            out[key] = fn()
            out[key]["part_s"] = time.monotonic() - t0
            emit({"phase": "tools", "part": key, key: out[key]})
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out["launches"] = {"flash_decode": out["a"]["launches"]
                       + out["d"]["launches"]}
    out["phase_s"] = time.monotonic() - phase_t0
    emit({"phase": "tools", "launches": out["launches"],
          "phase_s": out["phase_s"]})
    return out


SMOKES_STRAY_S = 600            # (a): the decoy stray's sleep
SMOKES_ICI_S = 600              # (b): ici_smoke's two passes


def _smokes_preflight(here: Path, work: str) -> dict:
    """(a) A Generate server on the card (its pidfile in a directory of
    its own) and a decoy stray named by a pidfile in the directory the
    preflight reads; ``tools.preflight``'s default mode in a child must
    kill the stray alone and name the server among the card's holders."""
    from brpc_tpu_torch.butil.pidfile import cmdline
    pid_dir = os.path.join(work, "pids")
    own_dir = os.path.join(work, "server_pids")
    os.makedirs(pid_dir)
    err = open(os.path.join(work, "smokes_server.err"), "w")
    from brpc_tpu_torch.tools.spawn_util import spawn_announcing_server
    server, got = spawn_announcing_server(
        ["-m", "brpc_tpu_torch.tools.shard_server", "--shards", "1",
         "--generate"], 240,
        env=dict(os.environ, PYTHONPATH=str(here),
                 BRPC_TPU_TORCH_PID_DIR=own_dir),
        stderr=err, cwd=str(here))
    check(got is not None, "smokes a: the Generate server never came up")
    stray = subprocess.Popen([sys.executable, "-c",
                              f"import time; time.sleep({SMOKES_STRAY_S})"])
    # reaped the moment it exits: a zombie child would look alive to the
    # preflight's /proc poll, which would then keep its pidfile
    reaper = threading.Thread(target=stray.wait, daemon=True)
    reaper.start()
    try:
        # the server holds the card once it has served a call
        from brpc_tpu_torch.rpc import Channel, ChannelOptions
        ch = Channel(f"tcp://127.0.0.1:{got['PORT']}",
                     ChannelOptions(timeout_ms=60000))
        try:
            toks, code, text = _shard_generate(ch, _prompts()[0])
        finally:
            ch.close()
        check(toks is not None, f"smokes a: Generate {code} {text}")
        with open(os.path.join(pid_dir, f"stray.{stray.pid}.pid"),
                  "w") as f:
            f.write(f"{stray.pid}\n{cmdline(stray.pid)}\n")
        run = _module_child(["brpc_tpu_torch.tools.preflight"],
                            "smokes a", env={"BRPC_TPU_TORCH_PID_DIR":
                                             pid_dir})
        report = json.loads(run["stdout"])
        killed = {a["pid"] for a in report["killed"]}
        holders = {h["pid"]: h for h in report["card_holders"]}
        check(killed == {stray.pid},
              f"smokes a: killed {report['killed']}, not the stray alone")
        reaper.join(10)
        check(stray.returncode is not None, "smokes a: the stray lives on")
        check(server.poll() is None, "smokes a: the server was killed")
        check(server.pid in holders,
              f"smokes a: {server.pid} not among the card's holders "
              f"{sorted(holders)}")
        check(not os.listdir(pid_dir), "smokes a: the stray's pidfile "
                                       "was left")
        return {"killed": report["killed"], "server_pid": server.pid,
                "server": holders[server.pid],
                "holders": len(holders), "preflight_s": run["wall_s"]}
    finally:
        if stray.poll() is None:
            stray.kill()
            stray.wait(10)
        server.terminate()
        server.wait(30)
        err.close()


def _smokes_gates() -> dict:
    """(b) The port's gate functions on the card: the serving smoke's
    2-shard group, the serving and device observatories, the device
    lane's ratios against the card-measured floors."""
    from brpc_tpu_torch.tools import preflight
    out = {}
    for name, fn in (("serving_smoke", preflight.gate_serving_smoke),
                     ("serving_obs", preflight.gate_serving_obs),
                     ("device_obs", preflight.gate_device_obs),
                     ("device_perf", preflight.gate_device_perf)):
        progress(f"smokes: (b) {name}")
        t0 = time.monotonic()
        got = fn()
        got["gate_s"] = time.monotonic() - t0
        out[name] = got
        emit({"phase": "smokes", "gate": name, name: got})
        check(got.get("ok") and not got.get("skipped"),
              f"smokes b: gate {name}: {got}")
    sv = out["serving_smoke"]
    check(sum(sv["outcomes"].values()) == 24,
          f"smokes b: verdicts {sv['outcomes']}")
    check(sv["ttft_p50_ms"] < sv["full_gen_p50_ms"],
          f"smokes b: TTFT {sv['ttft_p50_ms']} ms against "
          f"{sv['full_gen_p50_ms']} ms")
    m = sv["merged_serving"]
    check(m["completed"] + m["evicted"] + m["canceled"]
          >= sv["outcomes"]["completed"] + sv["outcomes"]["evicted"] - 1,
          f"smokes b: merged /serving {m}")
    return out


def _smokes_ici(work: str) -> dict:
    """(b) ``tools.ici_smoke``: the two-process pass on the card over
    cuda-ipc (the reference's pass against the TPU), and the CPU one."""
    path = os.path.join(work, "ici_smoke.json")
    run = _module_child(["brpc_tpu_torch.tools.ici_smoke", "--out", path],
                        "smokes b: ici_smoke", SMOKES_ICI_S)
    doc = json.load(open(path))
    check(doc["ok"] and doc["card"]["ok"]
          and doc["card"]["lane_kind"] == "cuda-ipc"
          and doc["cpu_fabric"]["lane_kind"] == "staged",
          f"smokes b: ici_smoke {doc}")
    doc["wall_s"] = run["wall_s"]
    return doc


def phase_smokes(dev):
    """The port's smokes and preflight on the card: (a) the preflight's
    default mode beside a Generate server on the card and a decoy stray
    named by a pidfile; (b) ``gate_serving_smoke`` (a 2-shard Generate
    group, each shard's flash_decode in its own process),
    ``gate_serving_obs``, ``gate_device_obs`` and ``gate_device_perf``
    through ``tools.preflight``'s own parsing, and ``ici_smoke``'s
    two-process pass over cuda-ipc; (c) each shard's flash_decode
    launches, from its own dump, equal to its steps plus its warm-up.
    The host-only smokes run in ``preflight --gate``, not here."""
    import shutil
    import tempfile

    from brpc_tpu_torch.ops import _build
    phase_t0 = time.monotonic()
    here = Path(__file__).resolve().parent
    _build.build("flash_decode")     # before the group's supervisor forks
    work = tempfile.mkdtemp(prefix="chip-smoke-smokes-")
    out = {"phase": "smokes"}
    try:
        progress("smokes: (a) the preflight beside a Generate server")
        t0 = time.monotonic()
        out["a"] = _smokes_preflight(here, work)
        out["a"]["part_s"] = time.monotonic() - t0
        emit({"phase": "smokes", "part": "a", "a": out["a"]})
        t0 = time.monotonic()
        out["b"] = _smokes_gates()
        progress("smokes: (b) ici_smoke")
        out["b"]["ici_smoke"] = _smokes_ici(work)
        out["b"]["part_s"] = time.monotonic() - t0
        emit({"phase": "smokes", "part": "b",
              "ici_smoke": out["b"]["ici_smoke"]})
    finally:
        shutil.rmtree(work, ignore_errors=True)
    shards = out["b"]["serving_smoke"]["shards"]
    for i, sh in enumerate(shards):
        check(sh["flash_decode"] == sh["decode_steps"] + sh["warmup_steps"],
              f"smokes c: shard {i} launched flash_decode "
              f"{sh['flash_decode']} times for {sh['decode_steps']} steps "
              f"+ {sh['warmup_steps']} warm-up")
    out["c"] = {"shards": shards}
    out["launches"] = {"flash_decode": sum(sh["flash_decode"]
                                           for sh in shards)}
    out["phase_s"] = time.monotonic() - phase_t0
    emit({"phase": "smokes", "c": out["c"], "launches": out["launches"],
          "phase_s": out["phase_s"]})
    return out


# ------------------------------------------------------------ phase pod

POD_RANKS = 4
POD_ITERS = 20
POD_TIMEOUT_S = 240


def _pod_check(run: dict, what: str, ranks: int, backend: str) -> dict:
    """Every rank of ``run`` (a ``pod_smoke.run_pod`` report) ran on
    ``backend``, and each operation equals the single-process mesh's: to
    the bit for data movement, within FP32_TOL for the reductions and
    attention. Returns the largest difference by operation."""
    from brpc_tpu_torch.tools.pod_smoke import OPS
    bad = [r.get("error", r) for r in run["ranks"] if not r.get("ok")]
    check(run["ok"] and len(run["ranks"]) == ranks, f"pod {what}: {bad}")
    errs = {}
    for rep in run["ranks"]:
        check(rep["backend"] == backend,
              f"pod {what}: rank {rep['rank']} ran on {rep['backend']}")
        for tag, shape in rep["shapes"].items():
            check(list(shape["ops"]) == list(OPS),
                  f"pod {what} {tag}: ran {list(shape['ops'])}")
            for name, got in shape["ops"].items():
                check(got["ok"] and got["max_abs_err"] <= FP32_TOL,
                      f"pod {what} {tag} rank {rep['rank']} {name}: {got}")
                errs[name] = max(errs.get(name, 0.0), got["max_abs_err"])
    return errs


def phase_pod(dev):
    """The pod across rank processes on the card (tools/pod_smoke.py):
    (a) four rank processes on cuda:0 over gloo (NCCL takes one card a
    rank) run every collective of a PodMesh at 1x4 and 2x2, each held to
    its piece of the same operation on the single-process 4-shard mesh
    of cuda:0, attention at 8 heads x 2048 x 64 fp32; (b) in the same
    ranks a CollectiveChannel.call whose service function is
    flash_attention on the rank's 8 heads of 32 x 2048 x 64 bf16, merged
    with all_gather, against flash_attention on the whole input here,
    and each rank's flash_attn_fwd_tc launches; (c) a one-rank world on
    which init_pod picks NCCL runs (a)'s operations through NCCL; (d)
    each operation's median ms over POD_ITERS calls for both backends."""
    import shutil
    import tempfile

    import torch

    from brpc_tpu_torch.ops import _build
    from brpc_tpu_torch.tools import pod_smoke
    fa = _fa_module()
    phase_t0 = time.monotonic()
    _build.build("flash_attention_tc")     # before the ranks load it
    card = card_line()
    work = tempfile.mkdtemp(prefix="chip-smoke-pod-")
    out = {"phase": "pod"}
    try:
        progress("pod: (a, b) four ranks over gloo on cuda:0")
        gloo = pod_smoke.run_pod(POD_RANKS, device=str(dev),
                                 backend="gloo", full=True,
                                 iters=POD_ITERS, kernel=True,
                                 out_dir=work, tol=FP32_TOL,
                                 timeout_s=POD_TIMEOUT_S)
        out["a"] = {"wall_s": gloo["wall_s"],
                    "max_abs_err": _pod_check(gloo, "a", POD_RANKS,
                                              "gloo"),
                    "grids": gloo["ranks"][0]["shapes"]}
        emit({"phase": "pod", "part": "a", "a": out["a"]})
        q, k, v = pod_smoke.kernel_inputs(dev)
        want = fa.flash_attention(q, k, v)
        bound = fa._rounding_bound(want.float(), want.dtype)
        ranks = []
        for rep in gloo["ranks"]:
            got = torch.load(os.path.join(work, f"kernel{rep['rank']}.pt"))
            got = got.to(dev)
            diff = (got.float() - want.float()).abs()
            worst = float((diff / bound).max())
            launched = rep["kernel"]["launches"]
            check(got.shape == want.shape and worst <= 1.0,
                  f"pod b: rank {rep['rank']}'s gathered flash_attention "
                  f"is {worst} of its bound from the whole input's")
            check(launched["flash_attn_fwd_tc"] >= 1
                  and launched["flash_attn_fwd"] == 0
                  and launched["flash_decode"] == 0,
                  f"pod b: rank {rep['rank']} launched {launched}")
            ranks.append({"rank": rep["rank"], "launches": launched,
                          "max_abs_err": float(diff.max()),
                          "worst_over_bound": worst})
        out["b"] = {"ranks": ranks}
        emit({"phase": "pod", "part": "b", "b": out["b"]})
        progress("pod: (c) a one-rank world over NCCL")
        nccl = pod_smoke.run_pod(1, device=str(dev), full=True,
                                 iters=POD_ITERS, tol=FP32_TOL,
                                 timeout_s=POD_TIMEOUT_S)
        out["c"] = {"wall_s": nccl["wall_s"],
                    "max_abs_err": _pod_check(nccl, "c", 1, "nccl")}
        emit({"phase": "pod", "part": "c", "c": out["c"]})
    finally:
        shutil.rmtree(work, ignore_errors=True)
    g_ms, n_ms = gloo["ranks"][0]["times_ms"], nccl["ranks"][0]["times_ms"]
    out["d"] = {name: {"gloo_4_ranks_1x4_ms": g_ms[name],
                       "nccl_1_rank_ms": n_ms[name]} for name in g_ms}
    for name, t in out["d"].items():
        emit({"phase": "pod", "part": "d", "op": name, **t,
              "iters": POD_ITERS, "card": card})
    out["launches"] = {"flash_attn_fwd_tc": sum(
        r["launches"]["flash_attn_fwd_tc"] for r in ranks)}
    out["phase_s"] = time.monotonic() - phase_t0
    emit({"phase": "pod", "launches": out["launches"],
          "phase_s": out["phase_s"]})
    return out


def phase_paths(dev, split_inputs):
    """The port's two other paths, each driven through its public entry
    point with every count zeroed just before and read just after:
    long-context attention (examples/long_context's 8 heads x 2048 x 64,
    bf16 to flash_attn_fwd_tc, fp32 to flash_attn_fwd, and 8 x 2048 x 32
    bf16 to flash_attn_fwd_tc, causal and not)
    and a decode step over a long cache (split, one launch)."""
    import numpy as np
    import torch

    fa = _fa_module()
    rng = np.random.RandomState(7)
    out = {}
    fa.reset_launches()
    for dtype, d in ((torch.bfloat16, 64), (torch.float32, 64),
                     (torch.bfloat16, 32)):
        x = [_rand(rng, (8, 2048, d), dtype, dev) for _ in range(3)]
        for causal in (False, True):
            o = fa.flash_attention(*x, causal=causal)
            check(o.shape == x[0].shape and bool(torch.isfinite(o).all()),
                  "long-context attention gave non-finite values")
    torch.cuda.synchronize()
    out["long_context"] = dict(fa.launches)
    check(out["long_context"]["flash_attn_fwd_tc"] == 4
          and out["long_context"]["flash_attn_fwd"] == 2,
          f"long-context path launched {out['long_context']}")

    q, k, v, lengths, plan = split_inputs
    fa.reset_launches()
    o = fa.decode_attention(q, k, v, lengths)
    torch.cuda.synchronize()
    out["long_cache_decode"] = dict(fa.launches)
    check(bool(torch.isfinite(o).all()), "long-cache decode: non-finite")
    check(out["long_cache_decode"]["flash_decode"] == 1
          and sum(out["long_cache_decode"].values()) == 1,
          f"long-cache decode launched {out['long_cache_decode']}")
    emit({"phase": "paths", **out, "long_cache_splits": plan.splits})
    return out


# ------------------------------------------------------------- phase 5

def _bound(nbytes: float, flops: float, kind: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _timed(kernel, plain, library, simt, iters):
    """Device ms per call of each function (CUDA events), in turns
    (kernel, the CUDA-core tile kernel through ``_launch_tile``, plain,
    library), and the profiler's device time per call of the kernel and
    the tile kernel. ``iters``: events iterations of (kernel, simt, plain,
    library); None skips a function."""
    out = {}
    for key, fn, n in (("ms", kernel, iters[0]), ("ms_simt", simt, iters[1]),
                       ("plain_ms", plain, iters[2]),
                       ("library_ms", library, iters[3])):
        out[key] = cuda_time_ms(fn, n)[0] if fn is not None else None
    out["call_ms"] = cuda_time_ms(kernel, 20)[1]
    out["ms_profiled"] = profiled_device_ms(kernel, 50)
    out["ms_simt_profiled"] = (profiled_device_ms(simt, 20)
                               if simt is not None else None)
    return out


def _decode_bound(q, k, lengths):
    """Bytes and FLOPs a decode step needs on this run's data: each valid
    cache row of K and V read once, q and the lengths read, out written."""
    d = k.shape[-1]
    rows = int(lengths.clamp(0, k.shape[1]).sum())
    nbytes = (2 * q.numel() + 2 * rows * d) * q.element_size() \
        + lengths.numel() * 4
    return nbytes, 4.0 * rows * d


def _kind(dtype):
    import torch
    return {torch.float32: "fp32", torch.float16: "fp16",
            torch.bfloat16: "bf16"}[dtype]


def phase_times(decode_inputs, split_inputs):
    import numpy as np
    import torch
    import torch.nn.functional as F

    fa = _fa_module()
    times = {}

    # an empty kernel back to back, timed as every kernel here: what one
    # launch costs at least
    times["launch_floor"] = {
        "ms": cuda_time_ms(lambda: torch.cuda._sleep(0), 500)[0],
        "what": "torch.cuda._sleep(0), CUDA events over 500 launches"}
    emit(dict(phase="kernel_times", case="launch floor",
              **times["launch_floor"]))
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32,
                        device=decode_inputs[0].device)

    def decode_times(name, q, k, v, lengths, iters, shape):
        b, L, d = k.shape
        scale = d ** -0.5
        nbytes, flops = _decode_bound(q, k, lengths)
        bound_ms, bound_by = _bound(nbytes, flops, _kind(q.dtype))
        mask = (torch.arange(L, device=q.device)[None, :]
                < lengths[:, None].long())[:, None, None, :]
        q4, k4, v4 = q[:, None, None, :], k[:, None], v[:, None]

        def kernel():
            return fa.decode_attention(q, k, v, lengths, block_k=64)

        def library():
            return F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask,
                                                  scale=scale)
        t = _timed(
            kernel,
            lambda: fa._flash_plain(q[:, None], k, v, scale, True, 64,
                                    q_offset=lengths - 1),
            library,
            lambda: fa._launch_tile("flash_attn_fwd", q[:, None], k, v,
                                    scale, True, q_offset=lengths,
                                    q_offset_add=-1),
            iters)
        t.update(shape=shape, bound_ms=bound_ms, bound_by=bound_by,
                 bytes=nbytes, flops=flops,
                 splits=fa._plan("decode", q.device, q.dtype, d, bh=b,
                                 sk=L).splits,
                 ms_l2_cold=cold_time_ms(kernel, flush),
                 library_ms_l2_cold=cold_time_ms(library, flush),
                 launch_floor_ms=times["launch_floor"]["ms"])
        emit(dict(phase="kernel_times", case=name, **t))
        return t

    q, k, v, lengths = decode_inputs
    # iteration counts keep each timed run under ~1000 queued launches:
    # past the device's launch queue the host blocks behind the sleep and
    # the events would time the host instead
    times["decode"] = decode_times(
        "decode", q, k, v, lengths, (500, 500, 15, 200),
        "q [8,32], k/v cache [8,160,32] fp32, lengths [8]")
    q, k, v, lengths, plan = split_inputs
    times["split_decode"] = decode_times(
        "split decode", q, k, v, lengths, (300, 30, 5, 100),
        "q [4,128], k/v cache [4,4096,128] bf16, lengths 0/1/4096/3000")
    # every row of the cache valid: the most bytes this cache can need
    full = torch.full_like(lengths, k.shape[1])
    times["full_decode"] = decode_times(
        "split decode, every length 4096", q, k, v, full, (300, 30, 5, 100),
        "q [4,128], k/v cache [4,4096,128] bf16, lengths 4096 x 4")
    del flush

    long_cases = []
    rng = np.random.RandomState(1)
    n = 2048
    # 8 heads: examples/long_context's shape, one wave of tc blocks or
    # less; 32 heads: several waves, where the causal tile order pays;
    # every 16-bit head dim goes to flash_attn_fwd_tc, fp32 to
    # flash_attn_fwd (d 128 its other tile shape)
    for heads, d, dtype in ((8, 64, torch.float32), (8, 64, torch.bfloat16),
                            (32, 64, torch.bfloat16),
                            (8, 128, torch.float32),
                            (8, 32, torch.bfloat16),
                            (8, 128, torch.bfloat16),
                            (8, 16, torch.float16)):
        kind = _kind(dtype)
        kernel = fa._plan("attention", q.device, dtype, d).kernel
        x = [_rand(rng, (heads, n, d), dtype, q.device) for _ in range(3)]
        for causal in (False, True):
            pairs = n * (n + 1) / 2 if causal else n * n
            flops = 4.0 * heads * pairs * d
            nbytes = 4 * heads * n * d * x[0].element_size()
            bms, bby = _bound(nbytes, flops, kind)
            # the CUDA-core tile kernel on inputs another kernel serves
            simt = None if kernel == "flash_attn_fwd" else (
                lambda: fa._launch_tile("flash_attn_fwd", *x, d ** -0.5,
                                        causal))
            t = _timed(
                lambda: fa.flash_attention(*x, causal=causal),
                lambda: fa._flash_plain(*x, d ** -0.5, causal, 128),
                lambda: F.scaled_dot_product_attention(
                    *[t[None] for t in x], is_causal=causal),
                simt, (50 if kernel == "flash_attn_fwd_tc" else 20, 20, 3,
                       20))
            t.update(case=f"{heads}x{n}x{d} {kind}"
                          f"{' causal' if causal else ''}",
                     kernel=kernel, bound_ms=bms, bound_by=bby,
                     bytes=nbytes, flops=flops,
                     mufu_ms=heads * pairs / MUFU_PER_S * 1e3)
            long_cases.append(t)
            emit(dict(phase="kernel_times", **t))
    for c in long_cases:
        if c["case"].endswith("causal"):
            base = next(x for x in long_cases
                        if x["case"] == c["case"][:-len(" causal")])
            c["causal_over_noncausal"] = c["ms"] / base["ms"]
    times["long"] = long_cases
    return times


def _row(name, path, launches, serving_launches, per_step, err, t, **kw):
    lib, source = KERNELS[name]
    return {"name": name, "route": "cuda", "source": source,
            "library": lib, "replaces": REPLACES, "path": path,
            "launches": launches, "serving_launches": serving_launches,
            "launches_per_decode_step": per_step, "max_abs_err": err,
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "ms_simt": t.get("ms_simt"), **kw}


def _measured_cases(long_cases, kernel):
    """The long cases ``kernel`` serves, for the kernels line: without
    ``mufu_ms``, a figure worked out from the exponentials' count and not
    measured (the ``kernel_times`` lines keep it)."""
    return [{k: v for k, v in c.items() if k != "mufu_ms"}
            for c in long_cases if c["kernel"] == kernel]


def main(only: str = "") -> int:
    """The whole smoke; ``only`` (``--phase streaming`` or ``--phase
    observability``): the card line and that phase alone (its kernel
    builds at the server's warm-up), to compare two trees' serving in
    one call."""
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: torch is missing: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke needs a card",
              file=sys.stderr)
        return 2
    # a hang shows every thread's stack and fails, inside the call's
    # time limit, instead of running out silently
    import faulthandler
    faulthandler.dump_traceback_later(1100, exit=True)
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    try:
        import brpc_tpu_torch  # noqa: F401
        from brpc_tpu_torch.butil.device import resolve_device
    except ImportError as e:
        print(f"chip_smoke: brpc_tpu_torch is not beside this script: {e}",
              file=sys.stderr)
        return 2
    try:
        card = card_line()
        dev = resolve_device()
        emit({"phase": "card", "nvidia_smi": card,
              "device": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count(),
              "torch": torch.__version__, "cuda": torch.version.cuda,
              "python": sys.version.split()[0]})
        if only == "device_lane":
            phase_device_lane(dev)
            return 0
        if only == "combo":
            from brpc_tpu_torch.ops import _build
            # alone, the phase builds its kernels first, so that no call
            # times out on a build
            _build.build_all()
            phase_combo(dev)
            return 0
        if only == "cluster":
            # alone, flash_decode builds at the first replica's warm-up
            phase_cluster(dev)
            return 0
        if only == "incident":
            # alone, flash_decode builds at the first server's warm-up
            phase_incident(dev)
            return 0
        if only == "native":
            # alone, the core builds at its first use and flash_decode at
            # the first server's warm-up
            phase_native(dev)
            return 0
        if only == "shards":
            # the group builds what it needs from a copy of the package
            phase_shards(dev)
            return 0
        if only == "ring":
            # alone, flash_decode builds at the first server's warm-up
            phase_ring(dev)
            return 0
        if only == "replay":
            # alone, flash_decode builds at the first server's warm-up,
            # and part (e) makes its artifact with phase incident's storm
            phase_replay(dev)
            return 0
        if only == "h2":
            # alone, flash_decode builds at the first server's warm-up
            phase_h2(dev)
            return 0
        if only == "protocols":
            # alone, flash_decode builds at the server's warm-up
            phase_protocols(dev)
            return 0
        if only == "legacy":
            # alone, flash_decode builds at the first server's warm-up
            phase_legacy(dev)
            return 0
        if only == "media":
            # alone, flash_decode builds at the first server's warm-up
            phase_media(dev)
            return 0
        if only == "sanitize":
            # the phase builds what its children load
            phase_sanitize(dev)
            return 0
        if only == "lint":
            # the phase builds flash_decode before its serving children
            phase_lint(dev)
            return 0
        if only == "tools":
            # the phase builds flash_decode before the group forks
            phase_tools(dev)
            return 0
        if only == "smokes":
            # the phase builds flash_decode before the group forks
            phase_smokes(dev)
            return 0
        if only == "pod":
            # the phase builds flash_attn_fwd_tc before the ranks start
            phase_pod(dev)
            return 0
        if only:
            {"streaming": phase_streaming,
             "observability": phase_observability}[only]()
            return 0
        progress("phase build")
        phase_build()
        progress("phase kernel_check")
        decode_inputs, split_inputs, errs = phase_kernel_check(dev)
        progress("phase serving")
        serving = phase_serving()
        progress("phase streaming")
        streaming = phase_streaming()
        progress("phase observability")
        observability = phase_observability()
        progress("phase device_lane")
        device_lane = phase_device_lane(dev)
        progress("phase combo")
        combo = phase_combo(dev)
        progress("phase cluster")
        cluster = phase_cluster(dev)
        progress("phase incident")
        incident = phase_incident(dev)
        progress("phase native")
        native = phase_native(dev)
        progress("phase shards")
        shards = phase_shards(dev)
        progress("phase ring")
        ring = phase_ring(dev)
        progress("phase replay")
        replay = phase_replay(dev, incident["c"]["artifact_path"])
        progress("phase h2")
        h2 = phase_h2(dev)
        progress("phase protocols")
        protocols = phase_protocols(dev)
        progress("phase legacy")
        legacy = phase_legacy(dev)
        progress("phase media")
        media = phase_media(dev)
        progress("phase sanitize")
        sanitize = phase_sanitize(dev)
        progress("phase lint")
        lint = phase_lint(dev)
        progress("phase tools")
        tools = phase_tools(dev)
        progress("phase smokes")
        smokes = phase_smokes(dev)
        progress("phase pod")
        pod = phase_pod(dev)
        progress("phase paths")
        paths = phase_paths(dev, split_inputs)
        progress("phase times")
        times = phase_times(decode_inputs, split_inputs)
        progress("done")
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    sl = serving["kernel_launches"]
    steps = serving["decode_steps"] + serving["warmup_steps"]
    by_path = {"unary": sl["flash_decode"]}
    by_path.update({name: p["flash_decode"]
                    for name, p in streaming["launches"].items()})
    by_path["observability"] = observability["launches"]["flash_decode"]
    dl = device_lane["launches"]
    by_path["device_lane_attend"] = (dl["d_attend_cuda"]["flash_decode"]
                                     + dl["d_attend_cudad"]["flash_decode"])
    by_path["device_lane_attend_ici"] = dl["g_attend_ici"]["flash_decode"]
    cl = combo["launches"]
    by_path["combo_nested_attend"] = cl["c_nested_attend"]["flash_decode"]
    ul = cluster["launches"]
    by_path["cluster_replicas"] = sum(
        v["flash_decode"] for k, v in ul.items() if k != "d_backup")
    by_path["cluster_backup_attend"] = ul["d_backup"]["flash_decode"]
    by_path["incident"] = sum(v["flash_decode"]
                              for v in incident["launches"].values())
    by_path["native"] = sum(v["flash_decode"]
                            for v in native["launches"].values())
    by_path["shards"] = shards["launches"]["flash_decode"]
    by_path["ring"] = ring["launches"]["flash_decode"]
    by_path["replay"] = sum(v["flash_decode"]
                            for v in replay["launches"].values())
    by_path["h2"] = h2["launches"]["flash_decode"]
    by_path["protocols"] = protocols["launches"]["flash_decode"]
    by_path["legacy"] = sum(legacy["launches"].values())
    by_path["media"] = sum(media["launches"].values())
    by_path["sanitize"] = sanitize["launches"]["flash_decode"]
    by_path["lint"] = lint["launches"]["flash_decode"]
    by_path["tools"] = tools["launches"]["flash_decode"]
    by_path["smokes"] = smokes["launches"]["flash_decode"]
    by_path["long_cache_decode"] = paths["long_cache_decode"]["flash_decode"]
    tc_by_path = {
        "long_context": paths["long_context"]["flash_attn_fwd_tc"],
        "pod": pod["launches"]["flash_attn_fwd_tc"]}
    fwd_by_path = {
        "long_context": paths["long_context"]["flash_attn_fwd"],
        "combo_sequence_parallel": cl["d_sequence_parallel"][
            "flash_attn_fwd"]}
    long_by = {c["case"]: c for c in times["long"]}
    tc, simt = long_by["8x2048x64 bf16"], long_by["8x2048x64 fp32"]
    kernels = [
        _row("flash_decode", "serving: unary, stream and HTTP; device "
             "lanes: Attend; combo: nested Attend; cluster: three "
             "replicas, backup Attend; incident: rings, profiles, a shed "
             "storm, costs; native: the turbo, pluck and scan lanes; "
             "shards: two forked Generate shards behind one port; ring: "
             "Generate on the ring lane, connection types, ssl://, shards "
             "on the ring; replay: a captured burst, open-loop replays, "
             "chaos, incident replays; h2: Generate over gRPC, plain h2 "
             "and HTTP/1.1 through the port's clients, gRPC over tcp and "
             "ssl, rpc_press over HTTP; protocols: Generate over "
             "hulu_pbrpc and sofa_pbrpc (unary, streamed, on the ring, "
             "with an attachment) beside thrift and redis on one port; "
             "legacy: Generate over nova_pbrpc, public_pbrpc and "
             "nshead+mcpack beside mongo and esp; media: Generate beside "
             "an RTMP relay on one port, and on a server that refuses "
             "RTMP; sanitize: Generate over tpu_std and HTTP/1.1 in a "
             "child under ASan and UBSan; lint: Generate streamed and "
             "unary in a child under the strict lock-order assert and in "
             "one without it; tools: Generate through a 2-shard group traced "
             "into one tree a call, and behind cluster_top's ClusterChannel "
             "with fiber_stacks mid-burst; smokes: the serving smoke's "
             "2-shard Generate group under preflight's gate; the "
             "long-cache decode",
             sum(by_path.values()), sl["flash_decode"],
             sl["flash_decode"] / steps, errs["serving_decode"],
             times["decode"], launches_by_path=by_path,
             shape=times["decode"]["shape"],
             launch_floor_ms=times["launch_floor"]["ms"],
             ms_l2_cold=times["decode"]["ms_l2_cold"],
             split_case=dict(times["split_decode"],
                             max_abs_err=errs["split_decode"]),
             full_cache_case=times["full_decode"]),
        _row("flash_attn_fwd_tc", "long-context attention; pod: the "
             "service function of a CollectiveChannel.call in each of four "
             "rank processes",
             sum(tc_by_path.values()),
             sl["flash_attn_fwd_tc"], sl["flash_attn_fwd_tc"] / steps,
             errs["flash_attn_fwd_tc"], tc, shape="8x2048x64 bf16",
             launches_by_path=tc_by_path,
             cases=_measured_cases(times["long"], "flash_attn_fwd_tc")),
        _row("flash_attn_fwd", "long-context attention; combo: the "
             "reference of ring and Ulysses attention",
             sum(fwd_by_path.values()),
             sl["flash_attn_fwd"], sl["flash_attn_fwd"] / steps,
             errs["flash_attn_fwd"], simt, shape="8x2048x64 fp32",
             launches_by_path=fwd_by_path,
             cases=_measured_cases(times["long"], "flash_attn_fwd")),
    ]
    print(card)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:3] == ["--client", "device_lane"]:
        sys.exit(device_lane_client(int(sys.argv[3]),
                                    (sys.argv[4:5] or ["0"])[0]))
    if sys.argv[1:3] == ["--client", "shards_load"]:
        sys.exit(_shards_load_client(sys.argv[3]))
    if sys.argv[1:3] == ["--client", "ring_server"]:
        sys.exit(_ring_server_session(*sys.argv[3:]))
    if sys.argv[1:3] == ["--client", "ring_echo"]:
        sys.exit(_ring_echo(sys.argv[3]))
    if sys.argv[1:3] == ["--client", "ici"]:
        sys.exit(ici_client(int(sys.argv[3]), sys.argv[4],
                            int(sys.argv[5])))
    if sys.argv[1:2] == ["--client"]:
        sys.exit(client_main(sys.argv[2], int(sys.argv[3]),
                             traced="--rpcz" in sys.argv[4:]))
    if sys.argv[1:2] == ["--phase"]:
        if sys.argv[2:3] not in (["streaming"], ["observability"],
                                 ["device_lane"], ["combo"], ["cluster"],
                                 ["incident"], ["native"], ["shards"],
                                 ["ring"], ["replay"], ["h2"],
                                 ["protocols"], ["legacy"], ["media"],
                                 ["sanitize"], ["lint"], ["tools"],
                                 ["smokes"], ["pod"]):
            sys.exit(f"chip_smoke: unknown phase {sys.argv[2:]}")
        sys.exit(main(only=sys.argv[2]))
    sys.exit(main())
